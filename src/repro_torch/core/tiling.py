"""Analytic tiling search (paper Sec. II).

"GEMM/GEMV kernels are parallelized via tiling ... with tile sizes determined
by cache and memory capacities.  The memory access pattern ... is predictable
analytically.  Kernel latency is estimated by searching over candidate tiling
strategies at each memory hierarchy [level]."

For a blocked GEMM  C[M,N] += A[M,K] @ B[K,N]  staged through a buffer of
capacity ``C_bytes`` the boundary traffic under an output-stationary loop nest
with tiles (mt, nt, kt) is

    bytes(A) = M*K * ceil(N/nt)          (A re-streamed once per N-tile)
    bytes(B) = K*N * ceil(M/mt)          (B re-streamed once per M-tile)
    bytes(C) = M*N * (2*ceil(K/kt) - 1)  (partial-sum spills if kt < K)

subject to (mt*kt + kt*nt + mt*nt) * dtype <= C_bytes.  We search power-of-two
tile candidates (plus the exact dims) and return the traffic-minimising tiling.
GEMV (M==1) degenerates to compulsory traffic — the memory-wall regime the
paper targets.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Dict, Tuple


def _candidates(dim: int) -> Tuple[int, ...]:
    cands = {dim}
    p = 1
    while p < dim:
        cands.add(p)
        p *= 2
    return tuple(sorted(cands))


@dataclass(frozen=True)
class Tiling:
    mt: int
    nt: int
    kt: int
    traffic: Dict[str, float]      # role -> bytes crossing the boundary
    tile_bytes: Dict[str, float]   # role -> staged tile size (chunk unit)

    @property
    def total(self) -> float:
        return sum(self.traffic.values())


@functools.lru_cache(maxsize=200_000)
def gemm_tiling(M: int, N: int, K: int, dtype_bytes: int,
                capacity_bytes: float) -> Tiling:
    """Traffic-minimising tiling of one GEMM through one buffer level."""
    best = None
    cap_elems = max(capacity_bytes / dtype_bytes, 3.0)
    for mt in _candidates(M):
        if mt * 1 * 2 > cap_elems:   # even a k=1 sliver must fit
            break
        for nt in _candidates(N):
            if mt * nt > cap_elems:
                break
            # largest feasible kt given (mt, nt)
            kt_max = int((cap_elems - mt * nt) / max(mt + nt, 1))
            if kt_max < 1:
                continue
            kt = K if kt_max >= K else max(1, kt_max)
            a = M * K * math.ceil(N / nt)
            b = K * N * math.ceil(M / mt)
            c = M * N * (2 * math.ceil(K / kt) - 1)
            tot = (a + b + c) * dtype_bytes
            if best is None or tot < best[0]:
                best = (tot, mt, nt, kt, a, b, c)
    if best is None:  # degenerate capacity: stream element-wise
        a = M * K * N
        b = K * N * M
        c = 2 * M * N * K
        best = (float("inf"), 1, 1, 1, a, b, c)
    _, mt, nt, kt, a, b, c = best
    d = dtype_bytes
    return Tiling(
        mt=mt, nt=nt, kt=kt,
        traffic={"A": a * d, "B": b * d, "C": c * d},
        tile_bytes={"A": mt * kt * d, "B": kt * nt * d, "C": mt * nt * d},
    )


def elementwise_traffic(n_elems: int, dtype_bytes: int,
                        reads: int = 1, writes: int = 1) -> float:
    return float(n_elems) * dtype_bytes * (reads + writes)
