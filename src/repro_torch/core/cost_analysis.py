"""Op-level cost extractor: the port's counterpart of the reference's
``core/hlo_analysis.py``.

The reference parses post-SPMD HLO text for a step's FLOPs, bytes and
collective bytes. Eager PyTorch has no HLO, so this module counts the same
three numbers over the aten ops a step really dispatches, while it runs:

    flops             ``torch.utils.flop_counter.FlopCounterMode`` (matrix
                      products and convolutions: 2 * M * N * K)
    bytes             each op's tensor operands plus its outputs. Eager
                      PyTorch fuses nothing, so every intermediate is
                      written and read back: an upper bound of XLA's
                      fusion-boundary bytes. As ``hlo_analysis`` counts a
                      dynamic-slice or a scatter, a gather (indexing,
                      ``index_select``, ``embedding``) counts the rows it
                      reads and writes and its indices, not its whole
                      source; an in-place update counts the update's bytes
                      read and written, not its whole target; views move
                      nothing.
    collective_bytes  the result bytes of the ``c10d`` ops the dispatcher
                      sees (``dist.all_gather`` reaches it as
                      ``c10d.allgather_``) and of the functional
                      collectives (``_c10d_functional.all_gather_into_
                      tensor`` and its kin, which a DTensor's
                      redistribution dispatches), as ``hlo_analysis``
                      counts collective result bytes.

All values are per process (a rank's own shapes). A DTensor op is counted
as the local ops it runs on this rank's shards, its redistributions'
collectives included: the counters step aside for DTensor's own dispatch
(``NotImplemented``) and see what it dispatches below, and the global-shape
metadata that DTensor's sharding propagation computes runs outside them.
The hand-written CUDA
kernels are ctypes launches that the dispatcher never sees, so the
extractor runs a step on the plain path: on CPU tensors (or meta tensors,
which move no data), where every wrapper takes its plain version. A CUDA
tensor reaching an op under it raises: it never switches a card run to
the plain versions, nor misses the kernels' work unseen.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Callable, Dict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode, _FlopCounterMode

aten = torch.ops.aten

# a reshape's result that its schema does not mark as a view: no copy
_VIEWS = {aten._unsafe_view.default}
# ops that read only the rows their indices name
_GATHERS = {aten.index.Tensor, aten.index_select.default,
            aten.embedding.default, aten.gather.default}
# collectives: the c10d dispatcher op -> the reference's collective kind
# (each returns its result tensors first, then its work handle)
_COLLECTIVES = {"allgather_": "all-gather", "_allgather_base_": "all-gather",
                "allreduce_": "all-reduce",
                "reduce_scatter_": "reduce-scatter",
                "_reduce_scatter_base_": "reduce-scatter",
                "alltoall_": "all-to-all"}
# the functional collectives (namespaces ``_c10d_functional`` and
# ``_c10d_functional_autograd``) -> the same kinds
_FUNCTIONAL = {"all_gather_into_tensor": "all-gather",
               "all_gather_into_tensor_coalesced": "all-gather",
               "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
               "all_reduce_coalesced": "all-reduce",
               "reduce_scatter_tensor": "reduce-scatter",
               "reduce_scatter_tensor_coalesced": "reduce-scatter",
               "all_to_all_single": "all-to-all"}
_FUNCTIONAL_NS = ("_c10d_functional", "_c10d_functional_autograd")


def _has_dtensor(types) -> bool:
    return any(issubclass(t, DTensor) for t in types)


@dataclass
class OpCosts:
    """``HloCosts``'s fields (so ``h100_roofline.terms_from_costs`` takes
    it), plus the FLOPs and the bytes of each aten op."""
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_counts: Dict[str, float] = field(default_factory=dict)
    flops_by_op: Dict[str, float] = field(default_factory=dict)
    bytes_by_op: Dict[str, float] = field(default_factory=dict)

    def add_bytes(self, op: str, n: float) -> None:
        self.bytes += n
        self.bytes_by_op[op] = self.bytes_by_op.get(op, 0.0) + n


def _nbytes(xs) -> float:
    return float(sum(t.numel() * t.element_size() for t in tree_leaves(xs)
                     if isinstance(t, torch.Tensor)))


def _aliasing(func) -> tuple:
    """(returns a view, writes its first argument in place)."""
    rets = [r.alias_info for r in func._schema.returns]
    view = bool(rets) and all(a is not None and not a.is_write for a in rets)
    args = func._schema.arguments
    inplace = bool(args) and args[0].alias_info is not None and \
        args[0].alias_info.is_write
    return view, inplace


class _ByteCounter(TorchDispatchMode):
    """Adds each dispatched op's bytes (and a collective's result bytes)
    into ``costs``."""

    def __init__(self, costs: OpCosts):
        super().__init__()
        self.costs = costs

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _has_dtensor(types):
            return NotImplemented        # count the local ops it runs
        kwargs = kwargs or {}
        leaves = [t for t in tree_leaves((args, kwargs))
                  if isinstance(t, torch.Tensor)]
        # device.type, not is_cuda: a fake tensor answers it without a
        # dispatch of its own
        if any(t.device.type == "cuda" for t in leaves):
            raise ValueError(
                f"cost_analysis counts the plain path: {func} got a CUDA "
                f"tensor, whose kernels the dispatcher never sees; run the "
                f"step on CPU or meta tensors")
        out = func(*args, **kwargs)
        c = self.costs
        op = str(func.overloadpacket)
        if func.namespace == "prim":
            return out                   # metadata (prim.device): no data
        if func.namespace in ("c10d",) + _FUNCTIONAL_NS:
            name = func._schema.name.split("::")[-1]
            kind = (_COLLECTIVES if func.namespace == "c10d"
                    else _FUNCTIONAL).get(name)
            if kind:
                # c10d ops return (results, work); functional ones results
                res = _nbytes(out[0] if func.namespace == "c10d" else out)
                c.collective_bytes += res
                c.collective_counts[kind] = (c.collective_counts.get(kind, 0)
                                             + res)
                # the result, written and read once (the output buffers it
                # is handed arrive as operands: not counted again)
                c.add_bytes(op, 2 * res)
            return out
        view, inplace = _aliasing(func)
        if view or func in _VIEWS:
            return out
        if func in _GATHERS:
            idx = _nbytes(args[1:]) if func is not aten.embedding.default \
                else _nbytes(args[1])
            c.add_bytes(op, 2 * _nbytes(out) + idx)
        elif inplace:
            # the update's bytes, read and written: not the whole target
            c.add_bytes(op, 2 * _nbytes((args[1:], kwargs)))
        else:
            c.add_bytes(op, _nbytes((args, kwargs)) + _nbytes(out))
        return out


class _LocalFlopMode(_FlopCounterMode):
    """``FlopCounterMode``'s mode, stepping aside for DTensor's dispatch so
    that it counts the local products at a rank's shapes."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _has_dtensor(types):
            return NotImplemented
        return super().__torch_dispatch__(func, types, args, kwargs)


class _LocalFlopCounter(FlopCounterMode):
    def __enter__(self):
        self.flop_counts.clear()
        self.mod_tracker.__enter__()
        self.mode = _LocalFlopMode(self)
        self.mode.__enter__()
        return self


@contextlib.contextmanager
def quiet_sharding_propagation():
    """DTensor's sharding propagation runs each new (op, placements) once
    on fake tensors of GLOBAL shapes to learn its output's metadata; inside
    this block it runs with every dispatch mode set aside, so no counter
    (nor a memory tracker) mistakes it for the step's work."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def quiet(self, op_schema):
        with _disable_current_modes():
            return orig(self, op_schema)
    ShardingPropagator._propagate_tensor_meta_non_cached = quiet
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


def analyze(fn: Callable, *args, **kwargs) -> OpCosts:
    """Run ``fn(*args, **kwargs)`` once and count the FLOPs, bytes and
    collective bytes of the aten ops it dispatches. Its tensors must lie
    on the CPU or the meta device (the plain path, see the module's
    docstring); DTensors are counted at this rank's local shapes."""
    costs = OpCosts()
    with quiet_sharding_propagation(), _LocalFlopCounter(display=False) as fc, \
            _ByteCounter(costs):
        fn(*args, **kwargs)
    for op, n in fc.get_flop_counts().get("Global", {}).items():
        costs.flops_by_op[str(op)] = float(n)
    costs.flops = float(fc.get_total_flops())
    return costs
