"""End-to-end serving on the port: batched greedy decode with native vs
int8 KV, then ragged requests through ``serve_bucketed`` and through the
continuous engine over the paged KV pool (which must give the same
tokens), as the reference's ``examples/serve_batched.py`` prints them.

Run: PYTHONPATH=src python -m repro_torch.examples.serve_batched
     [--device cuda|cpu]

The model and traffic are the reference's: llama3.2-1b reduced to
d_model 256, 6 layers and a 4,096-token vocabulary, in f32, 8 prompts of
64 tokens and 64 new a prompt, except that the model's head width
is set to 64 on every device. The reduced twin's own width, 16, is one no
CUDA kernel of the port takes (``models.kernel_width_reason``), so the
card would refuse it; 64 keeps one config for both devices. The weights
come from the port's seeded init, the prompts from a numpy seed.
"""
from __future__ import annotations

import argparse
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.reduce import reduced
from repro_torch.models import RuntimeOptions, init_params
from repro_torch.serving import ServeEngine

MAX_LEN = 256
RAGGED = [[1, 2, 3]] * 2 + [[5, 6, 7, 8, 9, 10]] * 3


def example_config():
    """The reference example's reduced llama3.2-1b at head width 64."""
    return reduced(get_config("llama3.2-1b"), d_model=256, n_layers=6,
                   vocab=4096).replace(head_dim=64)


def prompts_for(cfg, batch: int, prompt_len: int):
    """(batch, prompt_len) prompt tokens in [1, vocab) from a numpy seed."""
    return np.random.default_rng(1).integers(
        1, cfg.vocab, size=(batch, prompt_len)).astype(np.int32)


def run(cfg, params, prompts, new_tokens: int, device,
        say: Callable[[str], None] = print) -> Dict[str, List]:
    """The example's three serves on ``device``: ``generate`` on
    ``prompts`` with native and int8 KV, then the ragged requests through
    ``serve_bucketed`` (8 new tokens) and through the continuous engine
    (pages of 16, 8 slots), which must agree. Returns each serve's
    tokens."""
    opts = RuntimeOptions(dtype="float32")
    out = {}
    for policy in ("native", "int8"):
        eng = ServeEngine(cfg, params, opts, device=device, kv_policy=policy,
                          max_len=MAX_LEN)
        outs = eng.generate(prompts, new_tokens)
        s = eng.stats
        out[policy] = outs
        say(f"kv={policy:7s} prefill={s.prefill_s*1e3:6.0f}ms "
            f"decode={s.decode_s*1e3:6.0f}ms TPS={s.tps:7.1f} "
            f"sample={outs[0][:8]}")

    say("\nragged requests via bucketing:")
    eng = ServeEngine(cfg, params, opts, device=device, max_len=MAX_LEN)
    outs = eng.serve_bucketed([r[:] for r in RAGGED], 8)
    out["bucketed"] = outs
    say(f"{len(outs)} responses, lens={[len(o) for o in outs]}, "
        f"aggregate TPS={eng.stats.tps:.1f}")

    say("\nsame ragged requests, continuous batching over the paged KV "
        "pool:")
    ceng = ServeEngine(cfg, params, opts, device=device, max_len=MAX_LEN,
                       scheduler="continuous", page_size=16, max_batch=8)
    couts = ceng.serve([r[:] for r in RAGGED], 8)
    out["continuous"] = couts
    if couts != outs:
        raise AssertionError("continuous batching changed the tokens: "
                             f"{couts} != {outs}")
    say(f"{len(couts)} responses, decode steps "
        f"{ceng.stats.decode_steps} (vs {eng.stats.decode_steps} static), "
        f"aggregate TPS={ceng.stats.tps:.1f}")
    return out


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Serve the example on ``--device``; returns what it printed."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    lines = []

    def say(line: str) -> None:
        print(line)
        lines.append(line)

    cfg = example_config()
    params = init_params(cfg, torch.Generator(device=args.device)
                         .manual_seed(0), "float32", args.device)
    run(cfg, params, prompts_for(cfg, 8, 64), 64, args.device, say)
    return "\n".join(lines) + "\n"


if __name__ == "__main__":
    main()
