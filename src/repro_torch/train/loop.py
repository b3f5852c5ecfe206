"""Fault-tolerant training loop, in PyTorch (the reference is
``repro/train/loop.py``).

* checkpoint/restart: atomic checkpoints every ``ckpt_every`` steps and at
  the end; a job resumes from the newest, so a killed job loses at most
  ``ckpt_every`` steps;
* preemption: SIGTERM/SIGINT set a flag, and the loop checkpoints and
  exits cleanly at the next step boundary;
* data determinism: batches are a pure function of (seed, step), so a
  resumed job continues the same token stream;
* gradient accumulation: ``n_micro`` micro-batches bound activation
  memory; their gradients add into f32 buffers, then divide by
  ``n_micro``;
* straggler visibility: per-step wall time against an EMA watermark;
  steps slower than ``straggler_factor`` times it are logged;
* any device: checkpoints hold whole tensors on the host, and a resume
  puts them on this job's device, whichever device wrote them.

The model trains through ``models.train_loss`` (``common.attention`` on
every layer: no kernel has a backward) by ``torch.autograd``. The loss is
read back to the host once a step, as the reference's ``float(loss)``
is; nothing else in a step waits for the device.
"""
from __future__ import annotations

import json
import os
import pathlib
import signal
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import torch

from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import for_arch
from repro_torch.models import (RuntimeOptions, init_params, resolve_device,
                                train_loss)
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_schedule)
from repro_torch.tree import leaves, tree_map, tree_unflatten


@dataclass
class TrainConfig:
    steps: int = 100
    seq_len: int = 128
    global_batch: int = 8
    n_micro: int = 1
    ckpt_every: int = 25
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep: int = 3
    seed: int = 0
    log_every: int = 10
    straggler_factor: float = 2.0
    optimizer: AdamWConfig = field(default_factory=AdamWConfig)


def build_train_step(cfg: ArchConfig, opts: RuntimeOptions,
                     tcfg: TrainConfig):
    """``train_step(params, opt_state, batch) -> (loss, params, opt_state,
    metrics)``: the loss and gradients of ``batch`` (its leading axis cut
    into ``tcfg.n_micro`` micro-batches whose gradients add into f32
    buffers), then one AdamW update, in place. ``loss`` and the metrics
    stay 0-d device tensors. The caller's parameter tensors never require
    grad: autograd differentiates detached views of them."""
    ocfg = tcfg.optimizer
    n = tcfg.n_micro

    def grads_of(params, mb):
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, _ = train_loss(cfg, p, mb, opts)
        return loss.detach(), torch.autograd.grad(loss, leaves(p))

    def train_step(params, opt_state, batch):
        if n > 1:
            b = leaves(batch)[0].shape[0] // n
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in leaves(params)]
            loss = torch.zeros((), dtype=torch.float32,
                               device=acc[0].device)
            for i in range(n):
                mb = tree_map(lambda x: x[i * b:(i + 1) * b], batch)
                li, g = grads_of(params, mb)
                for a, gi in zip(acc, g):
                    a.add_(gi)
                del g
                loss = loss + li
            for a in acc:
                a.div_(n)
            grads, loss = acc, loss / n
        else:
            loss, grads = grads_of(params, batch)
        params, opt_state, om = adamw_update(
            ocfg, params, tree_unflatten(params, grads), opt_state)
        return loss, params, opt_state, om

    return train_step


def _meta(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def train(cfg: ArchConfig, tcfg: TrainConfig,
          opts: RuntimeOptions = RuntimeOptions(dtype="float32"),
          log_fn: Optional[Callable[[str], None]] = print, *,
          device="cuda") -> Dict:
    """Run (or resume) a training job on ``device``; returns {"last_step",
    "losses", "final_loss", "preempted"}."""
    device = resolve_device(device)
    ds = for_arch(cfg, tcfg.seq_len, tcfg.global_batch, tcfg.seed)
    step_fn = build_train_step(cfg, opts, tcfg)
    ckpt_dir = pathlib.Path(tcfg.ckpt_dir)

    params = init_params(cfg, torch.Generator(device=device)
                         .manual_seed(tcfg.seed), opts.dtype, device)
    start = 0
    if latest_step(ckpt_dir) is not None:
        # restore into shapes only: the fresh init is freed first
        like = tree_map(_meta, params)
        del params
        (params, opt_state), start = restore_checkpoint(
            ckpt_dir, (like, adamw_init(like)), device=device)
        if log_fn:
            log_fn(f"[train] resumed from step {start}")
    else:
        opt_state = adamw_init(params)

    preempted = {"flag": False}
    prev_handlers = {}

    def on_signal(signum, frame):
        preempted["flag"] = True
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev_handlers[sig] = signal.signal(sig, on_signal)
        except ValueError:
            pass  # not the main thread (tests)

    metrics_path = ckpt_dir / "metrics.jsonl"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    ema_step_time = None
    losses = []
    step = start
    try:
        for step in range(start, tcfg.steps):
            t0 = time.perf_counter()
            batch = {k: v.to(device) for k, v in ds.batch_at(step).items()}
            loss, params, opt_state, om = step_fn(params, opt_state, batch)
            loss = float(loss)
            dt = time.perf_counter() - t0
            ema_step_time = dt if ema_step_time is None else (
                0.9 * ema_step_time + 0.1 * dt)
            straggler = dt > tcfg.straggler_factor * ema_step_time
            losses.append(loss)
            if log_fn and (step % tcfg.log_every == 0 or straggler):
                # the step's rate from the host's clock of steps, not a read
                # of the device's
                lr = float(cosine_schedule(tcfg.optimizer, step + 1))
                log_fn(f"[train] step={step} loss={loss:.4f} "
                       f"dt={dt*1e3:.0f}ms lr={lr:.2e}"
                       f"{' STRAGGLER' if straggler else ''}")
            with metrics_path.open("a") as f:
                f.write(json.dumps({"step": step, "loss": loss,
                                    "dt_ms": dt * 1e3,
                                    "straggler": straggler}) + "\n")
            done = step + 1
            if done % tcfg.ckpt_every == 0 or done == tcfg.steps:
                save_checkpoint(ckpt_dir, done, (params, opt_state),
                                keep=tcfg.keep)
            if preempted["flag"]:
                save_checkpoint(ckpt_dir, done, (params, opt_state),
                                keep=tcfg.keep)
                if log_fn:
                    log_fn(f"[train] preempted at step {done}; "
                           "checkpoint written, exiting cleanly")
                break
    finally:
        for sig, h in prev_handlers.items():
            signal.signal(sig, h)
    return {"last_step": step + 1, "losses": losses,
            "final_loss": losses[-1] if losses else float("nan"),
            "preempted": preempted["flag"]}
