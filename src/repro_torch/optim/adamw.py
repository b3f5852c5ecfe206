"""AdamW with a cosine schedule and global-norm clipping, in PyTorch (the
reference is ``repro/optim/adamw.py``).

The state keeps the reference's layout, ``{"step", "m", "v", "master"}``,
over the model's own nested dict/list tree (not ``torch.optim``), so a
checkpoint of it crosses between the two packages: f32 first and second
moments and an f32 master copy of every parameter, a separate tensor even
for f32 parameters; bf16 parameters are round trips of their master.
Unlike the reference's functional update, ``adamw_update`` updates the
state and the parameters in place (no second copy of either exists at
any time) and returns the same trees.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from repro_torch.tree import leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def cosine_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The f32 learning rate at ``step`` (an int, or a 0-d tensor whose
    device holds the result): linear warmup, then a cosine decay to
    ``min_lr_ratio * lr`` at ``total_steps``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (a 0-d tensor on
    the leaves' device)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


def adamw_init(params) -> Dict:
    """Zero moments and an f32 master copy of ``params`` (a true copy: the
    master never aliases a parameter, whatever its dtype)."""
    first = leaves(params)[0]
    return {
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "master": tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                           params),
    }


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state) -> Tuple:
    """One AdamW step from ``grads`` (the params' tree; any float dtype),
    clipped to ``clip_norm`` by their global norm, decoupled weight decay
    on the master. Updates ``state`` and ``params`` in place (each
    parameter becomes its new master, cast to its dtype) and returns
    (params, state, {"lr", "grad_norm"}), the metrics as 0-d device
    tensors: nothing is read back to the host."""
    step = state["step"] + 1
    lr = cosine_schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9), 1.0)
    t = step.to(torch.float32)
    bc1 = 1 - cfg.b1 ** t
    bc2 = 1 - cfg.b2 ** t

    def upd(p, g, m, v, master):
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        mh = m / bc1
        vh = v / bc2
        master.sub_(lr * (mh / (torch.sqrt(vh) + cfg.eps)
                          + cfg.weight_decay * master))
        p.copy_(master)
    tree_map(upd, params, grads, state["m"], state["v"], state["master"])
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gnorm}
