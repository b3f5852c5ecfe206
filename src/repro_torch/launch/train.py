"""Training CLI of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b \
        --reduced --steps 200 --seq-len 128 --batch 8 --ckpt-dir ck

Runs on the GPU by default (``--device cpu`` runs on the CPU); a full-size
config trains only where its f32 state fits one device (llama3.2-1b does
on an 80 GB card). ``--reduced`` shrinks to a same-family config that
trains anywhere. A second run with the same ``--ckpt-dir`` resumes from
its newest checkpoint.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config
from repro_torch.configs.reduce import reduced
from repro_torch.models import RuntimeOptions
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, train


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=TrainConfig.ckpt_dir)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model and optimizer state live "
                         "(default: the GPU)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg, d_model=args.d_model, n_layers=args.layers)
    tcfg = TrainConfig(
        steps=args.steps, seq_len=args.seq_len, global_batch=args.batch,
        n_micro=args.n_micro, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir,
        optimizer=AdamWConfig(lr=args.lr,
                              warmup_steps=max(args.steps // 20, 1),
                              total_steps=args.steps))
    out = train(cfg, tcfg, RuntimeOptions(dtype=args.dtype),
                device=args.device)
    print(f"[train] done: steps={out['last_step']} "
          f"loss {out['losses'][0]:.3f} -> {out['final_loss']:.3f}")


if __name__ == "__main__":
    main()
