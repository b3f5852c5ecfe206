"""Virtual execution streams for the overlapped serve engine
(DESIGN.md SS16).

The continuous engine models its loop as two streams in the MaxText
offline-inference style: a *prefill worker* advancing admitted prompts by
chunks and a *decode worker* running fused K-step blocks over the running
batch, connected by a ready-queue (a request becomes decodable at the
virtual instant its last prefill chunk finishes). The host still issues
kernels one at a time — this is a CPU-rig simulation, like the SS13 tier
device — but each kernel's measured wall time is charged to ITS stream's
busy horizon, so prefill of the next admissions overlaps in virtual time
with the decode block in flight, and the serve makespan is
``max(stream.free)`` instead of the serialized sum. Everything downstream
(TTFT/ITL/TPS, the trace, the tier device's DMA horizons) reads this one
virtual clock, which starts at 0 per serve.

With ``overlap=False`` the engine binds BOTH roles to one stream: every
op serializes on a single horizon — the pre-SS16 loop — which is the
baseline the shard_sweep benchmark compares against.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class VirtualStream:
    """One in-order execution queue on the virtual clock.

    ``start(ready)`` is where the next op may begin: the stream is busy
    until ``free``, and the op's inputs exist only from ``ready`` (e.g. a
    decode block cannot start before some participant finished prefill on
    the OTHER stream). ``commit(t0, dur)`` retires the op, advancing the
    horizon; ``dur`` includes any absorbed fetch-wait stall so the stall
    stays inside the op's span."""
    name: str
    free: float = 0.0            # horizon: when the last op retires
    busy_s: float = 0.0          # summed op durations (utilization)

    def start(self, ready: float = 0.0) -> float:
        return max(self.free, ready)

    def commit(self, t0: float, dur: float) -> float:
        t1 = t0 + max(dur, 0.0)
        self.free = t1
        self.busy_s += t1 - t0
        return t1
