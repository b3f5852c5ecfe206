"""Feed-forward blocks: the dense FFN and the mixture-of-experts FFN (the
reference is ``repro/models/moe.py``).

``moe_ffn`` routes each token to its top-k experts by an f32 softmax
router and runs them through one of three dispatches:

* ``impl="capacity"`` (the default, as the reference's ``moe_impl``):
  every expert takes at most ``C = max(int(T * k * capacity_factor / E),
  1)`` token replicas, chosen by a stable sort of the flattened expert ids
  (the lower ``t * k + j`` keeps the slot); the expert products are two
  batched matmuls over ``(E, C, d)`` and a dropped replica contributes
  zero. No step reads a device value back to the host, so the fused
  decode blocks stay free of host syncs on the card.
* ``impl="ragged"``: the replicas sorted by expert, each expert's
  contiguous segment multiplied by its weights (``jax.lax.ragged_dot`` in
  the reference); nothing drops. On the card it reads the group offsets
  to the host once a layer.

* ``impl="shard_map"``: shard-local expert parallelism over the ranks of
  ``shard_map_mesh`` (a ``kernels.sharded.ShardGroup`` whose rank r holds
  experts ``[r * E/N, (r + 1) * E/N)``: ``init_params(experts=)``; or a
  ``DeviceMesh`` whose "model" dim splits the expert axis, in the dry
  run). Each rank routes its tokens, fills its experts' capacity slots
  (the capacity path's tables), runs them, combines by a local inverse
  gather and sums the ranks' (T, d) outputs with one all-reduce.

Arctic's parallel dense residual FFN and DeepSeek's shared experts are
added after the routed output, in that order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.sharded import ShardGroup, model_axis
from repro_torch.models import common as cm


def init_dense_ffn(generator: torch.Generator, cfg: ArchConfig, d_ff: int,
                   dtype, device):
    n_up = 2 * d_ff if cfg.gated_mlp else d_ff
    return {"up": cm.dense_init(generator, cfg.d_model, n_up, dtype, device),
            "down": cm.dense_init(generator, d_ff, cfg.d_model, dtype,
                                  device)}


def _normal_into(out, generator, scale: float):
    """Fill ``out`` (any dtype) with Normal(0, scale) drawn in f32 one
    leading slice at a time, so the only f32 temporary is one slice."""
    for sl in out.view(-1, *out.shape[-2:]):
        w = torch.randn(sl.shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        sl.copy_(w.mul_(scale))
    return out


def init_moe(generator: torch.Generator, cfg: ArchConfig, n_layers: int,
             dtype, device, experts: slice = None):
    """The ``moe`` subtree of ``n_layers`` layers, stacked on a leading
    layer axis as ``params["stack"]`` holds it: router ``{"w": (L, d, E)}``
    in f32, ``w_up`` (L, E, d, n_up) and ``w_down`` (L, E, dff, d) in
    ``dtype``, and the ``shared`` and ``residual`` dense FFNs where the
    config has them. Each leaf is allocated once at its stacked size and
    filled expert by expert (an expert's matrix is the largest f32 draw:
    at arctic-480b's width one layer's experts are 26.8 GB in bf16).

    ``experts`` (a slice of the expert axis) keeps only those experts of
    ``w_up``/``w_down``: what a rank of the expert-parallel path holds
    (``moe_ffn(impl="shard_map")``). Every expert is still drawn, in the
    same order, so the kept ones equal the same slice of a whole init."""
    m = cfg.moe
    d, E, dff = cfg.d_model, m.n_experts, m.d_ff_expert
    n_up = 2 * dff if cfg.gated_mlp else dff

    def draw(shape, scale, dt):
        out = torch.empty((n_layers, *shape), dtype=dt, device=device)
        return _normal_into(out, generator, scale)

    def draw_experts(shape, scale):
        if experts is None:
            return draw((E, *shape), scale, dtype)
        keep = range(E)[experts]
        out = torch.empty((n_layers, len(keep), *shape), dtype=dtype,
                          device=device)
        for layer in range(n_layers):
            for e in range(E):
                w = torch.randn(shape, generator=generator,
                                dtype=torch.float32, device=generator.device)
                if e in keep:
                    out[layer, keep.index(e)].copy_(w.mul_(scale))
        return out

    def ffn(d_ff):
        n = 2 * d_ff if cfg.gated_mlp else d_ff
        return {"up": {"w": draw((d, n), d ** -0.5, dtype)},
                "down": {"w": draw((d_ff, d), d_ff ** -0.5, dtype)}}
    p = {"router": {"w": draw((d, E), d ** -0.5, torch.float32)},
         "w_up": draw_experts((d, n_up), d ** -0.5),
         "w_down": draw_experts((dff, d), dff ** -0.5)}
    if m.n_shared:
        p["shared"] = ffn(dff * m.n_shared)
    if m.dense_residual:
        p["residual"] = ffn(m.d_ff_dense or cfg.d_ff)
    return p


def dense_ffn(p, x, gated: bool):
    return cm.dense(p["down"], _act(cm.dense(p["up"], x), gated))


def _act(h, gated: bool):
    if gated:
        gate, up = h.chunk(2, dim=-1)
        return cm.swiglu(gate, up)
    return F.gelu(h, approximate="tanh")   # jax.nn.gelu's default


def _counts(flat, E: int):
    """Replicas per expert, (E,) int64, without ``torch.bincount`` (which
    reads its input's max back to the host on the card)."""
    return torch.zeros((E,), dtype=torch.int64, device=flat.device) \
        .index_add_(0, flat, torch.ones_like(flat))


def _ragged_path(p, xf, expert_ids, gate_vals, m, gated: bool):
    """Sort the replicas by expert and multiply each expert's contiguous
    segment by its weights. On the card the segment offsets are read back
    to the host once (a sync a layer): not the serving default."""
    T, k = expert_ids.shape
    flat = expert_ids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    inv = torch.argsort(order)
    xs = xf.repeat_interleave(k, dim=0)[order]
    # repro: allow(traced-purity): ragged is not the serving default
    ends = torch.cumsum(_counts(flat, m.n_experts), 0).tolist()
    ys = torch.empty_like(xs)
    lo = 0
    for e, hi in enumerate(ends):
        if hi > lo:
            h = _act(xs[lo:hi] @ p["w_up"][e], gated)
            ys[lo:hi] = h @ p["w_down"][e]
        lo = hi
    ys = ys[inv].reshape(T, k, -1)
    return torch.einsum("tkd,tk->td", ys.float(), gate_vals)


def _slots(expert_ids, E: int, C: int):
    """The capacity dispatch's tables for expert ids (T, k): ``slot`` (E,
    C), the replica index ``t * k + j`` each slot holds (``T * k`` where
    empty), and ``slot_of`` (T*k,), each replica's row of the flattened
    (E * C) expert outputs (``E * C`` where it dropped). A stable sort of
    the flattened ids gives each expert's replicas in index order, and the
    first C keep their slots."""
    T, k = expert_ids.shape
    dev = expert_ids.device
    flat = expert_ids.reshape(-1)                             # (T*k,)
    order = torch.argsort(flat, stable=True)                  # slot -> T*k idx
    sorted_eid = flat[order]
    counts = _counts(flat, E)
    start_of = torch.cumsum(counts, 0) - counts
    rank = torch.arange(T * k, device=dev) - start_of[sorted_eid]
    # every dropped replica lands on the extra row E*C, which is cut off
    dest = torch.where(rank < C, sorted_eid * C + rank, E * C)
    slot = torch.full((E * C + 1,), T * k, dtype=torch.int64, device=dev)
    slot = slot.scatter_(0, dest, order)[:E * C].view(E, C)
    slot_of = torch.empty((T * k,), dtype=torch.int64, device=dev) \
        .scatter_(0, order, dest)
    return slot, slot_of


def _add_dense(p, out, xf, cfg: ArchConfig):
    """The routed output plus DeepSeek's shared experts and Arctic's dense
    residual FFN, where the config has them, in that order."""
    if cfg.moe.n_shared:
        out = out + dense_ffn(p["shared"], xf, cfg.gated_mlp)
    if cfg.moe.dense_residual:
        out = out + dense_ffn(p["residual"], xf, cfg.gated_mlp)
    return out


def _capacity_path(p, xf, expert_ids, gate_vals, m, gated: bool,
                   capacity_factor: float, expert_sharding=None,
                   out_sharding=None):
    """Capacity-dropped dispatch through batched expert products over
    (E, C, d), and the inverse-gather combine (each replica reads its slot
    row; a dropped replica reads the zero row)."""
    T, k = expert_ids.shape
    E = m.n_experts
    d = xf.shape[-1]
    C = max(int(T * k * capacity_factor / E), 1)
    slot, slot_of = _slots(expert_ids, E, C)
    xpad = torch.cat([xf, xf.new_zeros((1, d))], 0)
    tok_idx = torch.where(slot < T * k, slot // k, T)         # T = pad row
    xg = cm.constrain(xpad[tok_idx], expert_sharding)         # (E, C, d)
    h = _act(torch.bmm(xg, p["w_up"]), gated)                 # (E, C, n_up)
    yg = cm.constrain(torch.bmm(h, p["w_down"]), expert_sharding)
    ygpad = torch.cat([yg.reshape(E * C, d), yg.new_zeros((1, d))], 0)
    ys = cm.constrain(ygpad[slot_of], out_sharding).view(T, k, d)
    return cm.constrain(torch.einsum("tkd,tk->td", ys.float(), gate_vals),
                        out_sharding)


def _shard_map_path(p, xf, m, gated: bool, capacity_factor: float, group):
    """Shard-local EP dispatch (the reference's ``_shard_map_path``).

    Everything is local: each rank routes its own tokens (all of them on
    real ranks; its data shard in the dry run) through the experts it
    holds; the only collective is an all-reduce (sum) of the (T_l, d)
    combine over the expert ranks. Returns (out (T_l, d) f32, the
    load-balance and router-z aux losses of the rank's tokens)."""
    E, k = m.n_experts, m.top_k
    axis = model_axis(group)
    if E % axis.size:
        raise ValueError(f"{E} experts do not divide over {axis.size} ranks")
    E_loc = E // axis.size

    def body(xf_l, router_w, w_up_l, w_down_l):
        T_l, d = xf_l.shape
        C = max(int(T_l * k * capacity_factor / E), 1)
        logits, probs, gate_vals, expert_ids = _route(
            {"router": {"w": router_w}}, xf_l, k)
        slot, slot_of = _slots(expert_ids, E, C)
        lo = axis.index * E_loc
        slot_loc = slot[lo:lo + E_loc]                        # (E_loc, C)
        xpad = torch.cat([xf_l, xf_l.new_zeros((1, d))], 0)
        tok_idx = torch.where(slot_loc < T_l * k, slot_loc // k, T_l)
        h = _act(torch.bmm(xpad[tok_idx], w_up_l), gated)
        yg = torch.bmm(h, w_down_l)                           # (E_loc, C, d)
        # local inverse-gather combine: a replica whose slot is on another
        # rank (or dropped) reads the zero row
        e_of = slot_of // C
        local = (e_of >= lo) & (e_of < lo + E_loc)
        loc_idx = torch.where(local, slot_of - lo * C, E_loc * C)
        ygpad = torch.cat([yg.reshape(E_loc * C, d), yg.new_zeros((1, d))], 0)
        ys = ygpad[loc_idx].view(T_l, k, d)
        out = axis.reduce(torch.einsum("tkd,tk->td", ys.float(), gate_vals),
                          "sum")
        # aux stats of the rank's tokens (the same on every expert rank)
        me = probs.mean(dim=0)
        ce = _counts(expert_ids.reshape(-1), E).float() / (T_l * k)
        lb = E * torch.sum(me * ce)
        rz = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
        return out, lb, rz
    args = (xf, p["router"]["w"], p["w_up"], p["w_down"])
    if isinstance(group, ShardGroup):
        if p["w_up"].shape[0] != E_loc:
            raise ValueError(f"rank {group.rank} must hold {E_loc} of the {E} "
                             f"experts (init_params(experts=)), got "
                             f"{p['w_up'].shape[0]}")
        return body(*args)
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.sharding.rules import P, batch_axes, placements
    ba = batch_axes(group)
    tok = placements(P(ba, None), group)
    rep = placements(P(), group)
    ex = placements(P("model", None, None), group)
    fn = local_map(body, out_placements=(tok, rep, rep),
                   in_placements=(tok, placements(P(None, None), group), ex,
                                  ex),
                   device_mesh=group, redistribute_inputs=True)
    return fn(*args)


def _route(p, xf, k: int):
    """f32 router logits (T, E) and probabilities, and each token's top-k
    experts: gates (T, k) renormalised to sum 1, expert ids (T, k)."""
    logits = cm.dense(p["router"], xf.float())
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return logits, probs, gate_vals, expert_ids


def moe_ffn(p, x, cfg: ArchConfig, *, impl: str = "capacity",
            capacity_factor: float = 1.25, expert_sharding=None,
            out_sharding=None, shard_map_mesh=None):
    """x: (B, S, d) -> ((B, S, d), aux) with aux {"load_balance",
    "router_z"} (f32 scalars on x's device). ``impl`` is "capacity",
    "ragged" or "shard_map" (over the ranks of ``shard_map_mesh``, which
    it needs). ``expert_sharding``/``out_sharding`` (the dry run's
    ``sharding.NamedSharding``) constrain the capacity path's expert-major
    (E, C, d) tensors and its combine when they are DTensors."""
    if impl not in ("capacity", "ragged", "shard_map"):
        raise ValueError(f"impl must be 'capacity', 'ragged' or 'shard_map', "
                         f"got {impl!r}")
    if impl == "shard_map" and shard_map_mesh is None:
        raise ValueError("impl='shard_map' needs shard_map_mesh: the ranks "
                         "that hold the experts (a ShardGroup or a "
                         "DeviceMesh)")
    m = cfg.moe
    B, S, d = x.shape
    T, k = B * S, m.top_k
    xf = x.reshape(T, d)

    if impl == "shard_map":
        out, lb, rz = _shard_map_path(p, xf, m, cfg.gated_mlp,
                                      capacity_factor, shard_map_mesh)
        out = _add_dense(p, out.to(x.dtype), xf, cfg)
        return out.reshape(B, S, d), {"load_balance": lb, "router_z": rz}

    logits, probs, gate_vals, expert_ids = _route(p, xf, k)

    if impl == "ragged":
        out = _ragged_path(p, xf, expert_ids, gate_vals, m, cfg.gated_mlp)
    else:
        out = _capacity_path(p, xf, expert_ids, gate_vals, m, cfg.gated_mlp,
                             capacity_factor, expert_sharding, out_sharding)
    out = _add_dense(p, out.to(x.dtype), xf, cfg)

    # load-balance aux loss (Switch-style) and the router z-loss
    me = probs.mean(dim=0)
    ce = _counts(expert_ids.reshape(-1), m.n_experts).float() / (T * k)
    aux = {"load_balance": m.n_experts * torch.sum(me * ce),
           "router_z": torch.mean(torch.logsumexp(logits, dim=-1) ** 2)}
    return out.reshape(B, S, d), aux
