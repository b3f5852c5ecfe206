"""CUDA-graph capture of the serving blocks.

The reference compiles each serving block into one program with
``jax.jit`` (``repro/serving/engine.py``, ``repro/serving/draft.py``),
once per shape key. The port records each block once per key as a CUDA
graph and replays it, on three paths, each with a runner of its own:

* the continuous engine: the fused decode block (key ``("paged", B,
  n_steps)``), the prefill chunk (``((1, C), calibrate)``) and the verify
  pass (``("spec", B, n_tok)``), the keys the engine counts as compiles;
* the static engine: the fused greedy K-step block (``("dense", B, L,
  k_eff)``, L the wave's cache length) and the sampled path's one-token
  step (``("step", B, L)``); its prefill runs eagerly, once a wave;
* the model draft: its prefill chunk (``("chunk", C)``), catch-up pass
  (``("catchup", B, Cc)``) and propose block (``("propose", B,
  n_steps)``).

``BlockGraphs.run(key, fn, **inputs)``, on a key's first call, copies the
inputs into device buffers of the key's own and runs ``fn`` on them
eagerly: that is the block's result, and the warm-up of cuBLAS and of the
kernels' one-time attributes. ``capture_pending()``, called after the
block's host pull and outside its timed bracket, then records ``fn`` on
the same buffers into a graph with a private memory pool (a capture
records and does not execute, so the KV cache is written once). Every
later call of the key copies its inputs into the buffers and replays the
graph; its outputs are the graph's, overwritten by the key's next replay.
There is no fallback: a capture or a replay that fails raises.

The kernel entries' launch counters (``.launches`` and
``.launches_by_heads`` of ``kernels.entries()``) and the masked
attention's ``.calls`` live on the host: a capture moves them once and a
replay never. The runner restores them after a capture and adds that
capture's increments on every replay, so each count is what the eager
block would have made.
"""
from __future__ import annotations

import collections
import functools
import time
from typing import Callable, Dict, Hashable, Optional

import torch

from repro_torch.kernels import entries
from repro_torch.models import common


class CudaGraph:
    """``torch.cuda.CUDAGraph`` behind the runner's two calls:
    ``capture(fn)`` records ``fn()`` on a side stream into a private
    memory pool and returns its outputs; ``replay()`` launches the
    recording on the current stream. ``memory_bytes``: the allocator's
    growth across the capture (the graph's pool)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.graph = torch.cuda.CUDAGraph()
        self.memory_bytes = 0

    def capture(self, fn: Callable):
        # torch.cuda.graph waits for the device and empties the cache
        # before it captures (once a key, outside any block's bracket: like
        # the reference's compile, not a host sync of the serving path);
        # the pool's growth is read from inside the capture, after that
        before = []

        def body():
            before.append(torch.cuda.memory_reserved(self.device))
            return fn()
        with torch.cuda.device(self.device), torch.cuda.graph(self.graph):
            out = body()
        self.memory_bytes = (torch.cuda.memory_reserved(self.device)
                             - before[0])
        return out

    def replay(self) -> None:
        self.graph.replay()


# RuntimeOptions fields that, when set, put a host read or a collective
# inside a block: the mesh and sharding fields of the dry run and of
# sharded serving
_SHARDING_FIELDS = ("kv_shard", "residual_sharding", "moe_expert_sharding",
                    "moe_out_sharding", "zero3_gather", "seq_shard_attn",
                    "seq_shard_mesh", "moe_shard_map_mesh")


def capture_refusal(opts, *, device, shards: int) -> str:
    """Why an engine of these settings cannot capture its blocks (the
    continuous or the static engine's, and its model draft's: every path
    captures on the same conditions), or "" when it can: capture needs a
    CUDA device, one shard (gloo's ``all_gather`` in ``kernels.sharded``
    goes through the host), the capacity MoE dispatch (the ragged one
    reads its group offsets to the host, the shard-local one exchanges
    over the ranks) and no sharding or mesh in ``opts``."""
    if torch.device(device).type != "cuda":
        return f"device={device!r} is not a CUDA device"
    if shards != 1:
        return f"shards={shards} all-gathers through the host"
    if opts.moe_impl != "capacity":
        return (f"moe_impl={opts.moe_impl!r} syncs or communicates inside "
                f"a block")
    for name in _SHARDING_FIELDS:
        if getattr(opts, name):
            return f"RuntimeOptions.{name} is set"
    return ""


def run_block(runner, key, fn, device, **inputs):
    """The block ``fn(**inputs)`` (inputs: host arrays or tensors) of shape
    ``key``: through ``runner`` (a ``BlockGraphs``), or with None eagerly
    on copies of the inputs on ``device``."""
    if runner is None:
        return fn(**{n: torch.as_tensor(v, device=device)
                     for n, v in inputs.items()})
    return runner.run(key, fn, **inputs)


def capture_pending(runner) -> float:
    """``runner.capture_pending()`` (None: eager, nothing to capture);
    returns the capture's seconds, for a timed bracket that spans it."""
    if runner is None:
        return 0.0
    t = runner.capture_s
    runner.capture_pending()
    return runner.capture_s - t


def _counts() -> dict:
    """Every host launch counter: name -> (launches, by heads)."""
    snap = {name: (fn.launches, collections.Counter(fn.launches_by_heads))
            for name, fn in entries().items()}
    snap["attention"] = (common.attention.calls, collections.Counter())
    return snap


def _set_counts(snap: dict) -> None:
    for name, fn in entries().items():
        fn.launches = snap[name][0]
        fn.launches_by_heads.clear()
        fn.launches_by_heads.update(snap[name][1])
    common.attention.calls = snap["attention"][0]


def _add_counts(delta: dict) -> None:
    for name, fn in entries().items():
        fn.launches += delta[name][0]
        fn.launches_by_heads.update(delta[name][1])
    common.attention.calls += delta["attention"][0]


class _Block:
    """One key's static input buffers, and once captured its graph, its
    outputs and the counter increments of one run."""

    def __init__(self, inputs: Dict[str, torch.Tensor]):
        self.inputs = inputs
        self.graph = None
        self.outputs = None
        self.counts: Optional[dict] = None


class BlockGraphs:
    """One graph a shape key of an engine's captured blocks.

    ``new_graph()`` makes a graph object (``capture(fn)``, ``replay()``);
    the default is ``CudaGraph`` on ``device``. ``captures`` and
    ``capture_s`` count the captures and their seconds, ``memory_bytes``
    the graphs' pools."""

    def __init__(self, device, new_graph: Optional[Callable] = None):
        self.device = torch.device(device)
        self._new_graph = new_graph or functools.partial(CudaGraph,
                                                         self.device)
        self._blocks: Dict[Hashable, _Block] = {}
        self._pending = None
        self.captures = 0
        self.capture_s = 0.0
        self.memory_bytes = 0

    def __len__(self) -> int:
        return sum(b.graph is not None for b in self._blocks.values())

    def sibling(self) -> "BlockGraphs":
        """An empty runner on the same device and graph maker, for blocks
        whose graphs are kept and dropped apart from this one's."""
        return BlockGraphs(self.device, self._new_graph)

    def clear(self) -> None:
        """Drop every graph: the weights or the cache they were captured
        on have been replaced."""
        self._blocks.clear()
        self._pending = None

    def _buffer(self, value) -> torch.Tensor:
        return torch.as_tensor(value, device=self.device).clone()

    def run(self, key: Hashable, fn: Callable, **inputs):
        """The block ``fn(**inputs)`` of ``key``: run eagerly on the key's
        first call, replayed from its graph on every later one. ``inputs``:
        name -> host array or tensor, of one shape and dtype a key."""
        block = self._blocks.get(key)
        if block is None:
            if self._pending is not None:
                raise RuntimeError("a block ran before the last first "
                                   "call's capture_pending()")
            block = _Block({n: self._buffer(v) for n, v in inputs.items()})
            self._blocks[key] = block
            self._pending = (block, fn)
            return fn(**block.inputs)
        if block.graph is None:
            raise RuntimeError(f"block {key!r} was never captured")
        for name, value in inputs.items():
            buf, value = block.inputs[name], torch.as_tensor(value)
            if value.shape != buf.shape or value.dtype != buf.dtype:
                raise ValueError(f"block {key!r} input {name!r}: "
                                 f"{value.dtype} {tuple(value.shape)}, "
                                 f"captured as {buf.dtype} "
                                 f"{tuple(buf.shape)}")
            buf.copy_(value)
        block.graph.replay()
        _add_counts(block.counts)
        return block.outputs

    def capture_pending(self) -> None:
        """Capture the block whose first call ran last, if any, on its
        buffers; the counters are left as the first call set them."""
        if self._pending is None:
            return
        block, fn = self._pending
        self._pending = None
        t0 = time.perf_counter()
        before = _counts()
        try:
            graph = self._new_graph()
            block.outputs = graph.capture(lambda: fn(**block.inputs))
            after = _counts()
        finally:
            _set_counts(before)
        block.counts = {name: (after[name][0] - n, after[name][1] - heads)
                        for name, (n, heads) in before.items()}
        block.graph = graph
        self.captures += 1
        self.memory_bytes += getattr(graph, "memory_bytes", 0)
        self.capture_s += time.perf_counter() - t0
