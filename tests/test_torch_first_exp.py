"""The first call of the plain versions in a fresh process, on the CPU.

The vector exp behind ``torch.exp`` on CPU float tensors (oneMKL's, in
PyTorch's MKL builds) can compute its first parallel call in a process to
about 1e-4 when two threads enter it together; every later call is
accurate to f32. Because a test process computes a plain version first
thing, that showed as rare f32 misses of the plain versions against the
Pallas kernels at 1e-5. The plain versions now enter the exp once on one
thread before their first call (``decode_attention._exp``). Each test here
computes a plain flash attention first thing in a fresh process, as the
earliest test of a test process does, and holds it against float64.

Run as a script to count over many fresh processes at once (which also
loads the machine, where the miss shows most):

    PYTHONPATH=src python tests/test_torch_first_exp.py --runs 200 \
        [--raw] [--env MKL_CBWR=COMPATIBLE]

``--raw`` calls ``torch.exp`` unguarded first, as the plain versions did;
``--env`` sets a variable in the fresh processes.
"""
import argparse
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

SRC = str(Path(__file__).resolve().parents[1] / "src")
TOL = 1e-5

# the child: the case seen to miss in a test process (B=1, S=256,
# H=Hkv=4, dh=128, causal, f32), its plain version first thing, then
# float64
CHILD = r"""
import sys
import numpy as np
import jax.numpy  # noqa: F401  (as the test modules import it)
import torch
torch.set_num_threads(2)
import repro_torch.kernels.decode_attention as tk
import repro_torch.kernels.flash_attention as tkf
rng = np.random.default_rng(260)
q, k, v = (rng.standard_normal((1, 256, 4, 128), dtype=np.float32)
           for _ in range(3))
if RAW:
    tk._exp = torch.exp
got = tkf.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
q64, k64, v64 = (torch.from_numpy(x).double() for x in (q, k, v))
s = torch.einsum("bshd,blhd->bhsl", q64, k64) / 128 ** 0.5
s = s.masked_fill(~torch.ones(256, 256, dtype=torch.bool).tril(), -torch.inf)
want = torch.einsum("bhsl,blhd->bshd", torch.softmax(s, -1), v64)
print(float((got.double() - want).abs().max()))
"""


def first_call_error(raw: bool = False, env=()) -> float:
    """Max error against float64 of a plain flash attention computed first
    thing in a fresh process (with the variables ``env`` set)."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu", **dict(env))
    out = subprocess.run([sys.executable, "-c", f"RAW = {raw}\n" + CHILD],
                         capture_output=True, text=True, env=env, check=True)
    return float(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("run", range(3))
def test_first_plain_call_in_a_process_is_exact(run):
    assert first_call_error() <= TOL


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=200)
    ap.add_argument("--jobs", type=int, default=6)
    ap.add_argument("--raw", action="store_true",
                    help="call torch.exp unguarded first, as before")
    ap.add_argument("--env", action="append", default=[],
                    help="KEY=VALUE for the fresh processes (repeatable)")
    args = ap.parse_args()
    env = [kv.split("=", 1) for kv in args.env]
    with ThreadPoolExecutor(args.jobs) as pool:
        errs = list(pool.map(lambda _: first_call_error(args.raw, env),
                             range(args.runs)))
    bad = [e for e in errs if e > TOL]
    print(f"{'raw' if args.raw else 'guarded'} {' '.join(args.env)}: "
          f"{len(bad)} of {len(errs)} "
          f"fresh processes off by more than {TOL:g} (max {max(errs):.3e}; "
          f"exact ones {min(errs):.3e})")


if __name__ == "__main__":
    main()
