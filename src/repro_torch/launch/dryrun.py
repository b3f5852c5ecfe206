"""Multi-pod dry run and roofline extraction on the port (the reference
is ``repro/launch/dryrun.py``).

For every (architecture x input shape x mesh) cell the reference compiles
its step for 256 or 512 TPU chips that do not exist and reads XLA's
memory and cost analyses. The port builds the same step as a DTensor
program over a ``fake_process_group`` of 256 or 512 ranks in this one
process (``launch/mesh.py``), with parameters, optimizer state, cache and
inputs sharded by ``repro_torch.sharding``'s rules, and runs it ONCE under
``FakeTensorMode``: every tensor is a shape without data, every collective
returns at once, and no card is touched. While it runs:

    memory     ``argument_bytes``: the local shard bytes of every input on
               rank 0 (what XLA's ``argument_size_in_bytes`` counts);
               ``peak_bytes``: the most bytes live at once over the step
               (inputs included), from ``torch.distributed._tools.
               mem_tracker.MemTracker``, which follows storages as the
               step's local ops create and free them; ``temp_bytes`` =
               peak - argument; ``output_bytes``: the local bytes of what
               the step returns (the caches and optimizer state it
               updates in place included, as XLA counts donated outputs).
    hlo_costs  FLOPs, bytes and collective bytes of rank 0's local ops
               (``core/cost_analysis.py``), the redistributions DTensor
               plans included; ``roofline`` prices them on the H100
               (``core/h100_roofline.py``).

``lower_s`` is the seconds spent building the cell's sharded inputs and
``compile_s`` the seconds of the traced step, under the reference's names.
XLA's own ``cost_analysis()`` has no counterpart: ``xla_cost_analysis`` is
left out of the records.

A train step is the reference's: ``n_micro = max(1, local_batch // 4)``
micro-batches (``REPRO_MICROBATCH`` overrides), their gradients added into
f32 buffers, then ``adamw_update`` on ZeRO-1 optimizer state. Each rank's
micro-batch i is rows [i * b, (i + 1) * b) of its own batch shard, so no
micro-batch moves data between ranks. The micro-batches have one shape, so
the dry run traces one and counts its costs ``n_micro`` times, as the
reference's ``hlo_analysis`` counts a scanned body times its trip count.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
    ... [--multi-pod] [--variant tp|fsdp] [--force] [--tag T] [--remat block]
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import pathlib
import time
import traceback
from dataclasses import dataclass
from typing import Callable, List, Tuple

import torch
from torch.autograd.graph import _engine_run_backward
from torch._subclasses.fake_tensor import unset_fake_temporarily
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils._pytree import tree_map as pytree_map

from repro_torch.configs import ASSIGNED_ARCHS, PAPER_ARCHS, get_config
from repro_torch.core import cost_analysis
from repro_torch.core import h100_roofline as hr
from repro_torch.launch.mesh import (MeshShape, fake_process_group,
                                     mesh_over, production_shape)
from repro_torch.models import (SHAPES, RuntimeOptions, cell_runnable,
                                decode_step, init_cache, init_params,
                                input_specs, prefill, train_loss)
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.sharding.rules import (P, NamedSharding, cache_pspecs,
                                        data_pspecs, effective_batch_axes,
                                        mesh_axis_size, opt_state_pspec,
                                        param_pspecs, placements,
                                        spec_items, spec_tree_map)
from repro_torch.tree import leaves, tree_map, tree_unflatten

ART = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"
ARCHS = list(ASSIGNED_ARCHS) + list(PAPER_ARCHS)
# RuntimeOptions fields of the reference's CLI that the port does not have
REFUSED_FLAGS = ("--attn-impl", "--block-q", "--block-kv", "--flash-acc")
# mesh dims that split the batch: a rescue never replicates over them
BATCH_AXES = ("pod", "data")


def _sharded(t: torch.Tensor, mesh, spec):
    """A DTensor of ``t``'s global shape and dtype on ``mesh``, laid out by
    ``spec``, holding an uninitialized local shard of rank 0's shape
    (under ``FakeTensorMode``, a shape without data)."""
    from torch.distributed.tensor import DTensor, Shard
    pl = placements(spec, mesh)
    local = list(t.shape)
    for p, m in zip(pl, mesh.shape):     # rank 0 holds the first chunk
        if isinstance(p, Shard):
            local[p.dim] = -(-local[p.dim] // m)
    return DTensor.from_local(torch.empty(local, dtype=t.dtype), mesh, pl,
                              run_check=False, shape=t.shape,
                              stride=_contiguous_stride(t.shape))


def _shard_tree(tree, specs, mesh):
    return spec_tree_map(lambda s, t: _sharded(t, mesh, s), specs, tree)


def local_bytes(tree) -> int:
    """Bytes of the local shards of a tree's tensors (DTensors' local
    shards; a plain tensor whole)."""
    from torch.distributed.tensor import DTensor
    n = 0
    for t in leaves(tree):
        if isinstance(t, torch.Tensor):
            loc = t.to_local() if isinstance(t, DTensor) else t
            n += loc.numel() * loc.element_size()
    return n


def _local_rows(x, i: int, n: int):
    """Micro-batch ``i`` of ``n`` of a DTensor batch sharded on dim 0:
    rows [i * b, (i + 1) * b) of each rank's shard, kept on that rank."""
    from torch.distributed.tensor import DTensor
    loc = x.to_local()
    b = loc.shape[0] // n
    shape = (x.shape[0] // n,) + tuple(x.shape[1:])
    return DTensor.from_local(loc[i * b:(i + 1) * b], x.device_mesh,
                              x.placements, run_check=False, shape=shape,
                              stride=_contiguous_stride(shape))


@dataclass
class Cell:
    """A cell's step: ``args`` (the step's inputs, DTensors) and ``parts``,
    (name, fn, trips): the step is each fn run ``trips`` times in order
    (a train step: one micro-batch ``n_micro`` times, then the update);
    ``outputs()`` gives what the step returns once it has run."""
    args: tuple
    parts: List[Tuple[str, Callable[[], object], int]]
    outputs: Callable[[], object]
    n_micro: int = 1


def _nodata(spec: P) -> P:
    def clean(ax):
        if ax is None:
            return None
        axes = ax if isinstance(ax, tuple) else (ax,)
        kept = tuple(a for a in axes if a not in ("data", "pod"))
        return kept[0] if len(kept) == 1 else (kept or None)
    return P(*(clean(a) for a in spec))


def _zero3_entries(p_specs, mesh) -> tuple:
    """The reference's ZeRO-3 gather table: (path after "stack/", the
    stacked weight's per-layer spec without the data axes) for each
    data-sharded weight of a stack."""
    entries = []
    for path, spec in spec_items(p_specs):
        ps = "/".join(str(q) for q in path)
        if "stack" not in ps or len(spec) < 2:
            continue
        body = P(*tuple(spec)[1:])          # drop the stacked layer dim
        nd = _nodata(body)
        if nd != body:
            entries.append((ps.split("stack/", 1)[-1],
                            NamedSharding(mesh, nd)))
    return tuple(entries)


def build_cell(arch: str, shape: str, mesh, *, variant: str = "fsdp",
               opts: RuntimeOptions = None) -> Cell:
    """The cell's sharded inputs and step on ``mesh`` (a DeviceMesh over
    the fake process group). Call under ``FakeTensorMode``."""
    cfg = get_config(arch)
    sp = SHAPES[shape]
    opts = opts or RuntimeOptions()
    ba_eff = effective_batch_axes(mesh, sp.global_batch)
    ms = mesh_axis_size(mesh, "model")
    # the reference's layout at fake scale: generator draws are never made
    # under FakeTensorMode (nothing runs), so a CPU generator is enough
    params_g = init_params(cfg, torch.Generator(), opts.dtype, "cpu")
    p_specs = param_pspecs(cfg, params_g, mesh, mode=variant)
    over = {}
    # shard-local EP dispatch: tokens stay on their data shard, experts on
    # model shards, the combine is one all-reduce
    if (cfg.moe is not None and cfg.moe.n_experts % ms == 0
            and not os.environ.get("REPRO_NO_MOE_SHARD")):
        over.update(moe_impl="shard_map", moe_shard_map_mesh=mesh)
    if (sp.kind in ("train", "prefill") and variant == "fsdp"
            and not os.environ.get("REPRO_NO_ZERO3_GATHER")):
        entries = _zero3_entries(p_specs, mesh)
        if entries:
            over["zero3_gather"] = entries
    if (sp.kind == "decode" and cfg.mla is None
            and cfg.family in ("dense", "moe", "vlm")
            and cfg.n_kv_heads % ms != 0
            and not os.environ.get("REPRO_NO_SEQ_SHARD")):
        over.update(seq_shard_attn=True, seq_shard_mesh=mesh)
    # sequence parallelism of the residual stream (opt-in, as in the
    # reference)
    seq_dim_shard = (sp.kind in ("train", "prefill")
                     and sp.seq_len % ms == 0
                     and bool(os.environ.get("REPRO_SEQPAR")))
    res_spec = P(ba_eff, "model", None) if seq_dim_shard else \
        P(ba_eff, None, None)
    opts = dataclasses.replace(
        opts, residual_sharding=NamedSharding(mesh, res_spec), **over)
    params = _shard_tree(params_g, p_specs, mesh)
    del params_g
    d_specs = data_pspecs(cfg, mesh, sp.kind, sp.global_batch)
    inputs = input_specs(cfg, shape, opts)
    data = {k: _sharded(v, mesh, d_specs[k]) for k, v in inputs.items()
            if k in d_specs}

    if sp.kind == "train":
        return _train_cell(cfg, sp, mesh, opts, params, p_specs, data)

    # decode cache length: +slack, rounded to a multiple of 256 so the
    # length dim divides any mesh axis (seq-sharded caches)
    max_len = (sp.seq_len if sp.kind != "decode"
               else ((sp.seq_len + 8 + 255) // 256) * 256)
    cache_g = init_cache(cfg, sp.global_batch, max_len, opts, "cpu")
    c_specs = cache_pspecs(cfg, cache_g, mesh, sp.global_batch)
    cache = _shard_tree(cache_g, c_specs, mesh)
    del cache_g
    out = {}

    if sp.kind == "prefill":
        def prefill_step():
            out["logits"], out["cache"] = prefill(
                cfg, params, data["tokens"], cache, opts,
                prefix_emb=data.get("prefix_emb"))
        return Cell((params, data, cache), [("prefill", prefill_step, 1)],
                    lambda: (out["logits"], out["cache"]))

    pos = sp.seq_len            # the next token after a seq_len context

    def serve_step():
        out["logits"], out["cache"] = decode_step(cfg, params, data["token"],
                                                  pos, cache, opts)
    return Cell((params, data["token"], data["pos"], cache),
                [("decode", serve_step, 1)],
                lambda: (out["logits"], out["cache"]))


def _train_cell(cfg, sp, mesh, opts, params, p_specs, data) -> Cell:
    ocfg = AdamWConfig()
    opt_g = adamw_init(params)
    opt_specs = {
        "step": P(),
        "m": spec_tree_map(lambda ps, s: opt_state_pspec(ps, s.shape, mesh),
                           p_specs, opt_g["m"]),
        "v": spec_tree_map(lambda ps, s: opt_state_pspec(ps, s.shape, mesh),
                           p_specs, opt_g["v"]),
        "master": spec_tree_map(
            lambda ps, s: opt_state_pspec(ps, s.shape, mesh),
            p_specs, opt_g["master"]),
    }
    opt_state = _shard_tree(opt_g, opt_specs, mesh)
    del opt_g
    # gradient accumulation: bounds activation memory (per-micro local
    # batch ~4 sequences)
    dp = mesh_axis_size(mesh, "pod") * mesh_axis_size(mesh, "data")
    local_b = max(sp.global_batch // dp, 1)
    n_micro = int(os.environ.get("REPRO_MICROBATCH", "0")) or max(
        1, local_b // 4)
    st = {"i": 0}

    def micro():
        i = st["i"] % n_micro
        st["i"] += 1
        mb = {k: _local_rows(v, i, n_micro) for k, v in data.items()}
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, _ = train_loss(cfg, p, mb, opts)
        # the engine itself, not torch.autograd.grad: a torch function,
        # whose backward (and the remat recompute in it) would then run
        # with the step's TorchFunctionMode set aside
        g = _engine_run_backward((loss,), (torch.ones_like(loss),), False,
                                 False, tuple(leaves(p)),
                                 allow_unreachable=True,
                                 accumulate_grad=False)
        if "acc" not in st:
            st["acc"] = [torch.zeros_like(x, dtype=torch.float32)
                         for x in leaves(params)]
            st["loss"] = torch.zeros_like(loss, dtype=torch.float32)
        for a, gi in zip(st["acc"], g):
            a.add_(gi)
        st["loss"] = st["loss"] + loss.detach()

    def update():
        for a in st["acc"]:
            a.div_(n_micro)
        st["out"] = adamw_update(ocfg, params,
                                 tree_unflatten(params, st["acc"]), opt_state)
        st["loss"] = st["loss"] / n_micro

    return Cell((params, opt_state, data),
                [("micro", micro, n_micro), ("update", update, 1)],
                lambda: (st["loss"], st["out"][0], st["out"][1]),
                n_micro=n_micro)


_MATMULS = (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__,
            torch.Tensor.__rmatmul__)


class _Rules(TorchFunctionMode):
    """The dry run's rules for torch functions on DTensors, which the step
    runs under: ``torch.einsum`` by ``_local_einsum``; a gather along a
    sharded dim by ``_local_gather``, combined at once (``_combined``); a
    matrix product whose weight splits its contraction dim over a batch
    mesh dim takes the weight gathered there (``_weight_gathered``), as an
    embedding lookup takes its table (``_table_gathered``); a chunk keeps
    its input's layout (``_chunked``); and a plain tensor that meets a
    DTensor takes its layout (``_placed_like_dtensor``). DTensor's own
    choices weigh bytes moved only: it would gather the batch, or run
    SwiGLU whole on every rank and, in the backward pass, the weight
    gradient of the whole fused projection, N times the FLOPs. The model
    code is unchanged and no op is dropped."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _has_dtensor(args):
            if func is torch.einsum:
                return _local_einsum(*args)
            if func in (torch.gather, torch.Tensor.gather):
                return _combined(_local_gather(*args, **kwargs))
            if func in _MATMULS and len(args) == 2:
                args = _weight_gathered(*args)
            if func is torch.Tensor.__getitem__ and len(args) == 2:
                args = _table_gathered(*args)
            if func in (torch.chunk, torch.Tensor.chunk):
                return _chunked(*args, **kwargs)
            if func in _MIXED:
                args = _placed_like_dtensor(args)
        return func(*args, **kwargs)


_MIXED = (torch.stack, torch.cat, torch.where, torch.add, torch.mul,
          torch.sub, torch.div, torch.Tensor.add, torch.Tensor.mul,
          torch.Tensor.sub, torch.Tensor.div, torch.Tensor.__add__,
          torch.Tensor.__radd__, torch.Tensor.__mul__, torch.Tensor.__rmul__,
          torch.Tensor.__sub__, torch.Tensor.__rsub__,
          torch.Tensor.__truediv__, torch.Tensor.__rtruediv__)


def _placed_like_dtensor(args):
    """``args`` with each plain tensor (a zero state made at the global
    batch, say) that meets a DTensor in an elementwise op or a stack laid
    out as that DTensor is: split, by a local slice, on each of its dims
    (aligned from the right) that the DTensor splits and that has the
    DTensor's size there; replicated elsewhere, as GSPMD propagates a
    sharding into a constant. DTensor would replicate it whole, and follow
    it: a stack whose first tensor is a plain zero state gathers the whole
    global batch (Mamba-2's chunk states)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    ref = next(t for t in tree_leaves(args) if isinstance(t, DTensor))
    mesh = ref.device_mesh
    dims = [p.dim for p in ref.placements if isinstance(p, Shard)]
    if any(type(p) is not Shard for p in ref.placements
           if isinstance(p, Shard)) or len(dims) != len(set(dims)):
        return args

    def place(t):
        if isinstance(t, DTensor) or not isinstance(t, torch.Tensor) or \
                t.dim() == 0:
            return t
        off = ref.dim() - t.dim()
        pl, local = [], t
        for m, p in enumerate(ref.placements):
            d = p.dim - off if isinstance(p, Shard) else -1
            if d < 0 or t.shape[d] != ref.shape[p.dim]:
                pl.append(Replicate())
                continue
            k = -(-t.shape[d] // mesh.size(m))
            start = min(k * mesh.get_local_rank(m), t.shape[d])
            local = local.narrow(d, start, min(k, t.shape[d] - start))
            pl.append(Shard(d))
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())
    return pytree_map(place, args)


def _batch_dims(mesh) -> set:
    names = mesh.mesh_dim_names or ()
    return {i for i, n in enumerate(names) if n in BATCH_AXES}


def _table_gathered(table, index) -> tuple:
    """(table, index) of an embedding lookup ``table[index]`` with the
    table all-gathered over each batch mesh dim on which both split a dim
    (ZeRO-3's gather of the table, the index's rows staying split).
    DTensor would instead follow the table's split and gather the index:
    every rank would look up the whole global batch."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not (isinstance(table, DTensor) and isinstance(index, DTensor)) or \
            index.is_floating_point():
        return table, index
    pl, changed = list(table.placements), False
    for m in _batch_dims(table.device_mesh):
        if isinstance(pl[m], Shard) and \
                isinstance(index.placements[m], Shard):
            pl[m], changed = Replicate(), True
    if not changed:
        return table, index
    return table.redistribute(table.device_mesh, pl), index


def _weight_gathered(a, b) -> tuple:
    """(a, b) of ``a @ b`` with b all-gathered over each batch mesh dim on
    which b splits its contraction dim while a splits its rows: ZeRO-3's
    weight gather, as GSPMD keeps the batch split. DTensor, weighing bytes
    only, would gather a's rows instead and run the product on the whole
    batch on every rank (the loss head's f32 logits of the global batch,
    16.8 GB a rank at 16 x 16)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not (isinstance(a, DTensor) and isinstance(b, DTensor)) or \
            b.dim() < 2:
        return a, b
    pl, changed = list(b.placements), False
    for m in _batch_dims(b.device_mesh):
        pa, pb = a.placements[m], b.placements[m]
        if (isinstance(pb, Shard) and pb.dim == b.dim() - 2
                and isinstance(pa, Shard) and pa.dim != a.dim() - 1):
            pl[m], changed = Replicate(), True
    return (a, b.redistribute(b.device_mesh, pl)) if changed else (a, b)


def _has_dtensor(args) -> bool:
    from torch.distributed.tensor import DTensor
    return any(isinstance(t, DTensor) for t in tree_leaves(args))


def _local_einsum(eq: str, *operands):
    """The dry run's sharding rule for ``torch.einsum`` on DTensors (whose
    own dispatch decomposes it into views that flatten two sharded dims,
    which DTensor refuses, replicating GQA's heads): on each mesh dim, the
    index letter its operands are sharded on is split on every operand
    that has it (a replicated operand takes its local chunk, no
    communication) and the output is sharded on it, or ``Partial`` when
    it is contracted; operands sharded on different letters are
    replicated on that mesh dim first, but on a batch mesh dim the one
    letter that survives into the output keeps its split. The product
    then runs on the local shards, as GSPMD partitions a dot."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = tuple(operands[0])
    lhs, out = eq.replace(" ", "").split("->")
    specs = lhs.split(",")
    mesh = next(t.device_mesh for t in operands if isinstance(t, DTensor))
    ops = [t if isinstance(t, DTensor) else
           DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False) for t in operands]
    ops = [t.redistribute(mesh, [Replicate() if isinstance(p, Partial) else p
                                 for p in t.placements]) for t in ops]
    want = [list(t.placements) for t in ops]
    out_pl = []
    batch = _batch_dims(mesh)
    for m in range(mesh.ndim):
        letters = {spec[t.placements[m].dim] for spec, t in zip(specs, ops)
                   if isinstance(t.placements[m], Shard)}
        kept = [c for c in letters if c in out]
        if len(letters) > 1 and m in batch and len(kept) == 1:
            letters = set(kept)     # the batch split stays: gather the rest
        if len(letters) != 1:
            for w in want:
                w[m] = Replicate()
            out_pl.append(Replicate())
            continue
        (ch,) = letters
        for spec, w in zip(specs, want):
            w[m] = Shard(spec.index(ch)) if ch in spec else Replicate()
        out_pl.append(Shard(out.index(ch)) if ch in out else Partial())
    ops = [t.redistribute(mesh, w) for t, w in zip(ops, want)]
    local = torch.einsum(eq, *[t.to_local() for t in ops])
    size = {}
    for spec, t in zip(specs, ops):
        size.update(zip(spec, t.shape))
    shape = torch.Size(size[c] for c in out)
    return DTensor.from_local(local, mesh, out_pl, run_check=False,
                              shape=shape, stride=_like_stride(local, shape))


def _local_gather(x, dim: int, index):
    """The dry run's rule for ``torch.gather`` on DTensors: each rank
    gathers from its own shards under ``local_map`` (its slice of a split
    ``dim`` read through an offset index, a miss giving 0, the result a
    pending sum, ``Partial``), so the backward's scatter runs on the local
    shard too; DTensor's own backward makes a zero tensor of the input's
    GLOBAL shape on every rank (the loss head's f32 logits of the whole
    batch, 16.8 GB a rank at 16 x 16)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    dim = dim % x.dim()
    if not isinstance(index, DTensor):
        index = DTensor.from_local(index, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
    xp, ip, op, off = [], [], [], None
    for m, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim and off is None:
            xp.append(p)
            ip.append(Replicate())
            op.append(Partial())
            off = -(-x.shape[dim] // mesh.size(m)) * mesh.get_local_rank(m)
        elif (isinstance(p, Shard) and p.dim != dim
              and index.shape[p.dim] == x.shape[p.dim]):
            xp.append(p)
            ip.append(Shard(p.dim))
            op.append(Shard(p.dim))
        else:
            xp.append(Replicate())
            ip.append(Replicate())
            op.append(Replicate())
    off = off or 0

    def body(x_, i_):
        j = i_ - off
        hit = (j >= 0) & (j < x_.shape[dim])
        g = torch.gather(x_, dim, torch.where(hit, j, torch.zeros_like(j)))
        return torch.where(hit, g, torch.zeros_like(g))
    return local_map(body, out_placements=op, in_placements=(xp, ip),
                     device_mesh=mesh, redistribute_inputs=True)(x, index)


def _like_stride(local, shape) -> tuple:
    """Strides of a ``shape`` tensor laid out in ``local``'s dim order,
    computed, not allocated: ``MemTracker`` would count a global-shape
    meta tensor made for its strides as live bytes."""
    order = sorted(range(local.dim()), key=lambda d: -local.stride(d))
    st, acc = [0] * local.dim(), 1
    for d in reversed(order):
        st[d] = acc
        acc *= shape[d]
    return tuple(st)


def _contiguous_stride(shape) -> tuple:
    st, acc = [0] * len(shape), 1
    for d in reversed(range(len(shape))):
        st[d] = acc
        acc *= shape[d]
    return tuple(st)


def _combined(t):
    """``t`` with every pending sum (``Partial``) all-reduced. A gather
    along a sharded dim leaves DTensor's masked partial result (each
    rank's hits, zeros elsewhere), summed at once as GSPMD combines a
    gather from a sharded operand, before a view of it can trip DTensor's
    mask bookkeeping (its ``_MaskPartial`` mask does not follow a select
    of its result)."""
    from torch.distributed.tensor import Partial, Replicate
    pl = [Replicate() if isinstance(p, Partial) else p for p in t.placements]
    return t.redistribute(t.device_mesh, pl) if pl != list(t.placements) \
        else t


_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default)
# aten ops between two collections of cyclic garbage while a step is traced
# (``analyze_cell``)
GC_EVERY = 5000


class _ReplicateOnFailure(TorchDispatchMode):
    """The dry run's rules at the aten level, where the backward pass's ops
    arrive too. An ``mm`` or ``bmm`` takes an operand that is a pending sum
    (``Partial``: a row-parallel output, or its gradient) summed first, as
    GSPMD all-reduces it; DTensor would instead gather the other operand
    and run the product whole on every rank. Where DTensor has no sharding
    rule for an op at its inputs' placements (a view that would split a
    sharded dim unevenly, say k's (B, S, Hkv * dh) -> (B, S, Hkv, dh) with
    Hkv = 2 over 4 ranks; in the backward pass, an ``mm`` whose operand
    carries the strided shard a flattened (batch, length) view leaves), the
    op is retried with its DTensor inputs replicated over one more non-batch
    mesh dim at a time, the last first, as GSPMD replicates what it cannot
    split. ``hits`` counts each op so rescued (the records'
    ``replicated_at``), its inputs made contiguous (an uneven shard's
    redistribution leaves a strided slice that a local view cannot take).
    Entered above the counters, whose modes step aside for DTensor ops, so
    the redistributions and copies it adds and the local ops are counted;
    in-place ops are not retried (a replicated copy would take the
    write). Every ``GC_EVERY`` ops it collects cyclic garbage."""

    def __init__(self):
        super().__init__()
        self.hits = {}
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        self.ops += 1
        if self.ops % GC_EVERY == 0:
            gc.collect()
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        if func in _PRODUCTS:
            args = tuple(_combined(a) if isinstance(a, DTensor) else a
                         for a in args)
        try:
            return func(*args, **kwargs)
        except (RuntimeError, NotImplementedError, ValueError) as e:
            inplace = any(a.alias_info is not None and a.alias_info.is_write
                          for a in func._schema.arguments)
            if inplace or not _propagation_failed(e):
                raise
            err = e
        for args2, kwargs2 in _replicated_variants(args, kwargs):
            try:
                out = func(*args2, **kwargs2)
            except (RuntimeError, NotImplementedError, ValueError) as e:
                if not _propagation_failed(e):
                    raise
                continue
            name = str(func.overloadpacket)
            self.hits[name] = self.hits.get(name, 0) + 1
            return out
        raise err


def _chunked(t, chunks: int, dim: int = 0):
    """``t.chunk(chunks, dim)`` with each chunk laid out as ``t`` is (a
    local slice where its dims divide), as GSPMD keeps SwiGLU's gate and
    up halves of a column-parallel product split. DTensor would gather
    the chunked dim inside the op, where autograd does not see it, and
    leave every chunk replicated: what follows, and in the backward pass
    the weight gradient of the whole fused projection, would run whole on
    every rank. Here the gather is a redistribution that autograd
    records, so the gradient is cut back to ``t``'s shard."""
    from torch.distributed.tensor import Replicate, Shard
    d = dim % t.dim()
    pl = [Replicate() if isinstance(p, Shard) and p.dim == d else p
          for p in t.placements]
    whole = t.redistribute(t.device_mesh, pl) if pl != list(t.placements) \
        else t
    out = []
    for p in torch.chunk(whole, chunks, dim):
        ok = all(not isinstance(a, Shard) or p.shape[a.dim] % n == 0
                 for a, n in zip(t.placements, t.device_mesh.shape))
        out.append(p.redistribute(p.device_mesh, t.placements)
                   if ok and p.placements != t.placements else p)
    return tuple(out)


def _propagation_failed(e: Exception) -> bool:
    """DTensor has no rule for the op at these placements, or its local
    op cannot view the strided slice an uneven shard's redistribution
    leaves (whisper's 1,500 frames over 16 ranks)."""
    msg = str(e)
    return ("Sharding propagation failed" in msg
            or "does not have a sharding strategy registered" in msg
            or "Cannot view a tensor" in msg)


def _replicated_variants(args, kwargs):
    """(args, kwargs) with every DTensor's placements on its mesh's last k
    non-batch dims made ``Replicate``, for k = 1, 2, ...: the batch's
    ("pod", "data") split is never given up, as GSPMD keeps it."""
    from torch.distributed.tensor import DTensor, Replicate
    dts = [t for t in tree_leaves((args, kwargs)) if isinstance(t, DTensor)]
    if not dts:
        return
    mesh = dts[0].device_mesh
    names = mesh.mesh_dim_names or ()
    dims = [i for i in range(mesh.ndim)
            if i >= len(names) or names[i] not in BATCH_AXES]
    for k in range(1, len(dims) + 1):
        drop = set(dims[len(dims) - k:])

        def rep(t):
            if not isinstance(t, DTensor):
                return t
            pl = [Replicate() if i in drop else p
                  for i, p in enumerate(t.placements)]
            # a strided shard's redistribution indexes with the mesh's own
            # (real) coordinate tensor: out of the fake mode, whose local
            # tensors stay fake
            with unset_fake_temporarily():
                return t.redistribute(t.device_mesh, pl).contiguous()
        yield pytree_map(rep, args), pytree_map(rep, kwargs)


def analyze_cell(cell: Cell):
    """(costs, peak bytes, output bytes, ops replicated) of one step: each
    part traced once under the cost extractor, its counts times its trips;
    the peak over the traced parts by ``MemTracker`` (inputs tracked from
    the start)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    mt = MemTracker()
    mt.track_external(*leaves(cell.args))
    rescue = _ReplicateOnFailure()
    # tensors that only reference cycles hold (the non-reentrant
    # checkpoint's recompute, ``local_map``) are freed when the collector
    # runs: every GC_EVERY ops, not when CPython's counters say, which
    # would make the peak depend on the mesh (llava15-13b's train step
    # held a second layer's tiles on one mesh and not on the other)
    enabled = gc.isenabled()
    gc.disable()
    try:
        return _analyze(cell, mt, rescue)
    finally:
        if enabled:
            gc.enable()


def _analyze(cell, mt, rescue):
    from torch.distributed.tensor.experimental import implicit_replication
    total = cost_analysis.OpCosts()
    with cost_analysis.quiet_sharding_propagation(), implicit_replication(), \
            mt, _Rules():
        for _, fn, trips in cell.parts:
            # the rescue on top of the counters' modes: a mode that steps
            # aside hands a DTensor op to DTensor, not to the modes below
            c = cost_analysis.analyze(_under(rescue, fn))
            total.flops += trips * c.flops
            total.bytes += trips * c.bytes
            total.collective_bytes += trips * c.collective_bytes
            for k, v in c.collective_counts.items():
                total.collective_counts[k] = (total.collective_counts.get(k, 0)
                                              + trips * v)
            for k, v in c.flops_by_op.items():
                total.flops_by_op[k] = total.flops_by_op.get(k, 0) + trips * v
            for k, v in c.bytes_by_op.items():
                total.bytes_by_op[k] = total.bytes_by_op.get(k, 0) + trips * v
        out_bytes = local_bytes(cell.outputs())
    peak = sum(v["Total"] for v in
               mt.get_tracker_snapshot("peak").values())
    return total, peak, out_bytes, dict(rescue.hits)


def _under(mode, fn):
    def run():
        with mode:
            return fn()
    return run


def roofline_terms(costs, cfg, shape: str, n_dev: int = 256) -> dict:
    """Three-term roofline on the H100 (terms per rank; the ratio against
    the global FLOPs, ``n_dev`` times a rank's)."""
    sp = SHAPES[shape]
    t = hr.terms_from_costs(
        costs, n_dev=n_dev,
        model_flops=hr.model_flops_for(cfg, sp.kind, sp.seq_len,
                                       sp.global_batch))
    out = {
        "compute_s": t.compute_s, "memory_s": t.memory_s,
        "collective_s": t.collective_s,
        "bottleneck": t.bottleneck,
        "model_flops": t.model_flops,
        "hlo_flops_global": t.hlo_flops_global,
        "model_flops_ratio": t.model_flops_ratio,
        "step_time_lower_bound_s": t.step_lower_bound_s,
        "roofline_fraction": t.roofline_fraction,
    }
    if sp.kind == "decode":
        out["memory_floor_s"] = hr.decode_floor_seconds(
            cfg, sp.seq_len, sp.global_batch, n_dev)
    return out


def batch_flattened(shape: MeshShape) -> MeshShape:
    """The mesh the dry run's DTensors live on: the ("pod", "data") axes
    merged into one "data" axis of their product, in row-major order. The
    rules only ever split a dim over both at once (``batch_axes``), so each
    rank holds the same shard of every tensor as on the three-axis mesh
    (rank (p * data + d) * model + m either way; a test holds every spec
    to it), and no tensor dim is split over two mesh dims, whose DTensor
    layouts (``_StridedShard``) its rules cannot always carry through a
    view or a backward op: such an op would gather the whole global
    batch."""
    names, sizes = shape.mesh_dim_names, shape.shape
    if "pod" not in names:
        return shape
    i = names.index("pod")
    if names[i + 1:i + 2] != ("data",):
        raise ValueError(f"{names}: 'pod' must come just before 'data'")
    return MeshShape(names[:i] + names[i + 1:],
                     sizes[:i] + (sizes[i] * sizes[i + 1],) + sizes[i + 2:])


def mesh_name(shape) -> str:
    """The reference's record names: "pod16x16", "pod2x16x16"."""
    return "pod" + "x".join(str(s) for s in shape.shape)


def run_cell(arch: str, shape: str, *, multi_pod: bool = False,
             variant: str = "fsdp", force: bool = False,
             opts: RuntimeOptions = None, tag: str = "",
             mesh_shape=None, write: bool = True) -> dict:
    """One cell's record (written to ``ART``; an existing record is read
    back unless ``force``). ``mesh_shape`` (a ``launch.mesh.MeshShape``)
    replaces the production mesh: the tests' and the card's small
    meshes."""
    shp = mesh_shape or production_shape(multi_pod=multi_pod)
    name = mesh_name(shp)
    stem = f"{arch}.{shape}.{name}.{variant}{('.' + tag) if tag else ''}"
    out_path = ART / f"{stem}.json"
    if write and out_path.exists() and not force:
        return json.loads(out_path.read_text())
    cfg = get_config(arch)
    skip = cell_runnable(cfg, shape)
    rec = {"arch": arch, "shape": shape, "mesh": name, "variant": variant,
           "tag": tag}
    if skip:
        rec["skipped"] = skip
        return _write(rec, out_path, write)
    t0 = time.time()
    try:
        from torch._subclasses.fake_tensor import FakeTensorMode
        with fake_process_group(shp.size):
            # made outside the fake mode
            mesh = mesh_over(batch_flattened(shp))
            with FakeTensorMode(allow_non_fake_inputs=True):
                cell = build_cell(arch, shape, mesh, variant=variant,
                                  opts=opts)
                arg_bytes = local_bytes(cell.args)
                t_lower = time.time() - t0
                costs, peak, out_bytes, rescued = analyze_cell(cell)
                t_compile = time.time() - t0 - t_lower
                n_micro = cell.n_micro
                del cell
        rec.update({
            "lower_s": round(t_lower, 2),
            "compile_s": round(t_compile, 2),
            "devices": shp.size,
            "n_micro": n_micro,
            "replicated_at": rescued,
            "memory": {
                "argument_bytes": arg_bytes,
                "output_bytes": out_bytes,
                "temp_bytes": max(peak - arg_bytes, 0),
                "peak_bytes": max(peak, arg_bytes),
            },
            "hlo_costs": {
                "flops": costs.flops,
                "bytes": costs.bytes,
                "collective_bytes": costs.collective_bytes,
                "collective_breakdown": costs.collective_counts,
                "flops_by_op": costs.flops_by_op,
            },
            "roofline": roofline_terms(costs, cfg, shape, shp.size),
        })
    except Exception as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2500:]
    gc.collect()
    return _write(rec, out_path, write)


def _write(rec, path, write: bool) -> dict:
    if write:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="")
    ap.add_argument("--shape", default="")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--variant", default="fsdp", choices=["fsdp", "tp"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--remat", default="block")
    ap.add_argument("--cache-dtype", default="")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, one process each")
    for flag in REFUSED_FLAGS:
        ap.add_argument(flag, default=None)
    args = ap.parse_args(argv)
    _quiet_logs()
    for flag in REFUSED_FLAGS:
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            ap.error(f"{flag} is the reference's XLA/Pallas tiling knob; the "
                     f"port's RuntimeOptions has no such field (its kernels "
                     f"choose their own tiles)")
    opts = RuntimeOptions(remat=args.remat, cache_dtype=args.cache_dtype)
    archs = [args.arch] if args.arch else ARCHS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    # the slowest kinds of cell first, so that a pool's last cells are short
    slow_first = ("prefill_32k", "train_4k", "decode_32k", "long_500k")
    cells = sorted(((arch, shape, mp) for arch in archs for shape in shapes
                    for mp in meshes),
                   key=lambda c: slow_first.index(c[1])
                   if c[1] in slow_first else len(slow_first))
    t_all = time.time()
    kw = dict(variant=args.variant, force=args.force, opts=opts, tag=args.tag)
    if args.jobs > 1:
        import concurrent.futures as cf
        import multiprocessing as mp_
        with cf.ProcessPoolExecutor(args.jobs,
                                    mp_context=mp_.get_context("spawn"),
                                    max_tasks_per_child=1) as ex:
            futs = {ex.submit(_timed_cell, c, kw): c for c in cells}
            for f in cf.as_completed(futs):
                _report(*futs[f], args.variant, *f.result())
    else:
        for c in cells:
            _report(*c, args.variant, *_timed_cell(c, kw))
    print(f"[dryrun] {len(cells)} cells in {time.time() - t_all:.1f}s "
          f"({args.jobs} jobs)", flush=True)


def _quiet_logs() -> None:
    """DTensor warns at each multi-axis redistribution and the fake group
    at each all-to-all: the records hold what they cost."""
    import logging
    for name in ("torch.distributed", "torch._logging"):
        logging.getLogger(name).setLevel(logging.ERROR)


def _timed_cell(cell, kw):
    _quiet_logs()
    arch, shape, mp = cell
    t0 = time.time()
    return run_cell(arch, shape, multi_pod=mp, **kw), time.time() - t0


def _report(arch, shape, mp, variant, rec, secs) -> None:
    status = ("SKIP " + rec["skipped"][:40] if "skipped" in rec
              else ("ERR " + rec["error"][:80] if "error" in rec
                    else f"ok {rec['compile_s']:.0f}s "
                    f"peak={rec['memory']['peak_bytes']/2**30:.2f}GiB"
                    f" bott={rec['roofline']['bottleneck']}"))
    print(f"[{arch} x {shape} x {'2x16x16' if mp else '16x16'} x {variant}] "
          f"{status} ({secs:.0f}s)", flush=True)


if __name__ == "__main__":
    main()
