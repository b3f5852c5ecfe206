"""Quickstart: the paper's analytical model in 30 lines, on the port.

Reproduces Table I (LLaVa-1.5-13B, prefill/decode 200/200) and shows the
STCO loop: pick a memory technology + placement -> predicted TPS. The
same lines as the reference's ``examples/quickstart.py``, through
``repro_torch.core`` (arithmetic on the CPU: no device).

Run: PYTHONPATH=src python -m repro_torch.examples.quickstart
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.configs import get_config
from repro_torch.core import (all_hbs, chiplet_qkv, hbs, lpddr6,
                              npu_hierarchy, qkv_in_ddr, run_inference,
                              sram_chiplet)


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Print Table I and the chiplet study; returns what it printed."""
    lines = []

    def say(line: str = "") -> None:
        print(line)
        lines.append(line)

    cfg = get_config("llava15-13b")
    say(f"model: {cfg.name}  params={cfg.n_params()/1e9:.1f}B  "
        f"KV/token={cfg.kv_bytes_per_token()/1e3:.0f} KB")

    say("\n--- paper Table I (HBS latency 10 us) ---")
    rows = [
        ("I   LPDDR6 + HBS@173GB/s, all in HBS", 173.0, 173.0, all_hbs()),
        ("II  LPDDR6 + HBS@520GB/s, all in HBS", 173.0, 520.0, all_hbs()),
        ("II' 3xDDR  + HBS@512GB/s, all in HBS", 520.0, 512.0, all_hbs()),
        ("III 3xDDR  + HBS@512GB/s, Q/K/V in DDR", 520.0, 512.0,
         qkv_in_ddr()),
    ]
    for label, ddr_bw, hbs_bw, place in rows:
        hier = npu_hierarchy(lpddr6(ddr_bw), hbs(hbs_bw, latency_us=10.0))
        rep = run_inference(cfg, hier, place, prefill_len=200,
                            decode_len=200)
        say(f"{label:42s} TPS={rep.tps:5.2f}  bottleneck={rep.bottleneck}")

    say("\n--- chiplet study (Llama-3.2-1B, 128/384) ---")
    small = get_config("llama3.2-1b")
    h = npu_hierarchy(lpddr6(173.0, latency_ns=500.0),
                      chiplet=sram_chiplet(512.0))
    rep = run_inference(small, h, chiplet_qkv(), 128, 384)
    say(f"chiplet-QKV @512GB/s: TPS={rep.tps:.1f} "
        f"(attention {rep.decode_group_share('attn')[1]*100:.0f}% of GEMM "
        f"time -> limited gain, paper takeaway IV)")
    return "\n".join(lines) + "\n"


if __name__ == "__main__":
    main()
