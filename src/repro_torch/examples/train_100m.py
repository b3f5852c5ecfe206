"""End-to-end training on the port: a ~100M-parameter qwen-family model
for a few hundred steps on the synthetic pipeline, with checkpoint and
restart, as the reference's ``examples/train_100m.py``.

Run: PYTHONPATH=src python -m repro_torch.examples.train_100m
     [--steps 300] [--tiny] [--ckpt-dir DIR] [--fresh] [--device cuda|cpu]

``--tiny`` takes the reference's tiny model (0.7M parameters) with the
same plumbing. A rerun with the
same ``--ckpt-dir`` resumes from its newest checkpoint (``--fresh``
starts over). A checkpoint is written every 50 steps, as the
reference's, or every half of a run shorter than 100 steps, so that a
short run too can be restarted from its middle.
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile
from typing import Optional, Sequence

from repro_torch.configs import get_config
from repro_torch.configs.reduce import reduced
from repro_torch.models import RuntimeOptions
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, train


def example_config(tiny: bool):
    """The reference example's model: qwen2.5-3b cut to ~100M parameters
    (12 layers x d 512, a 16k vocabulary, GQA 8:2), or its reduced twin
    at d_model 128, 4 layers and a 2,048-token vocabulary."""
    base = get_config("qwen2.5-3b")
    if tiny:
        return reduced(base, d_model=128, n_layers=4, vocab=2048)
    return base.replace(n_layers=12, d_model=512, n_heads=8, n_kv_heads=2,
                        head_dim=64, d_ff=2048, vocab=16384,
                        max_context=1024)


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Train (or resume) on ``--device``; returns what it printed."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train100m"))
    ap.add_argument("--fresh", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    lines = []

    def say(line: str) -> None:
        print(line)
        lines.append(line)

    cfg = example_config(args.tiny)
    say(f"arch={cfg.name} params={cfg.n_params()/1e6:.1f}M")
    if args.fresh:
        shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    tcfg = TrainConfig(
        steps=args.steps, seq_len=256, global_batch=8, n_micro=2,
        ckpt_every=min(50, max(args.steps // 2, 1)), ckpt_dir=args.ckpt_dir,
        log_every=10,
        optimizer=AdamWConfig(lr=1e-3, warmup_steps=20,
                              total_steps=args.steps))
    out = train(cfg, tcfg, RuntimeOptions(dtype="float32"), say,
                device=args.device)
    if out["losses"]:
        say(f"done: loss {out['losses'][0]:.3f} -> {out['final_loss']:.3f} "
            f"over {out['last_step']} steps (resume-capable: rerun to "
            f"continue)")
    else:
        say(f"done: nothing to run (the checkpoint in {args.ckpt_dir} "
            f"already reaches step {args.steps})")
    return "\n".join(lines) + "\n"


if __name__ == "__main__":
    main()
