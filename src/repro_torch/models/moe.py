"""Feed-forward blocks: the dense FFN and the mixture-of-experts FFN (the
reference is ``repro/models/moe.py``).

``moe_ffn`` routes each token to its top-k experts by an f32 softmax
router and runs them through one of two dispatches:

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

Arctic's parallel dense residual FFN and DeepSeek's shared experts are
added after the routed output, in that order. The reference's
``impl="shard_map"`` (expert-parallel over a mesh) is ROADMAP.md queue A,
item 9.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
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
             dtype, device):
    """The ``moe`` subtree of ``n_layers`` layers, stacked on a leading
    layer axis as ``params["stack"]`` holds it: router ``{"w": (L, d, E)}``
    in f32, ``w_up`` (L, E, d, n_up) and ``w_down`` (L, E, dff, d) in
    ``dtype``, and the ``shared`` and ``residual`` dense FFNs where the
    config has them. Each leaf is allocated once at its stacked size and
    filled expert by expert (an expert's matrix is the largest f32 draw:
    at arctic-480b's width one layer's experts are 26.8 GB in bf16)."""
    m = cfg.moe
    d, E, dff = cfg.d_model, m.n_experts, m.d_ff_expert
    n_up = 2 * dff if cfg.gated_mlp else dff

    def draw(shape, scale, dt):
        out = torch.empty((n_layers, *shape), dtype=dt, device=device)
        return _normal_into(out, generator, scale)

    def ffn(d_ff):
        n = 2 * d_ff if cfg.gated_mlp else d_ff
        return {"up": {"w": draw((d, n), d ** -0.5, dtype)},
                "down": {"w": draw((d_ff, d), d_ff ** -0.5, dtype)}}
    p = {"router": {"w": draw((d, E), d ** -0.5, torch.float32)},
         "w_up": draw((E, d, n_up), d ** -0.5, dtype),
         "w_down": draw((E, dff, d), dff ** -0.5, dtype)}
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


def _capacity_path(p, xf, expert_ids, gate_vals, m, gated: bool,
                   capacity_factor: float):
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
    h = _act(torch.bmm(xpad[tok_idx], p["w_up"]), gated)      # (E, C, n_up)
    yg = torch.bmm(h, p["w_down"])                            # (E, C, d)
    ygpad = torch.cat([yg.reshape(E * C, d), yg.new_zeros((1, d))], 0)
    ys = ygpad[slot_of].view(T, k, d)
    return torch.einsum("tkd,tk->td", ys.float(), gate_vals)


def _route(p, xf, k: int):
    """f32 router logits (T, E) and probabilities, and each token's top-k
    experts: gates (T, k) renormalised to sum 1, expert ids (T, k)."""
    logits = cm.dense(p["router"], xf.float())
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return logits, probs, gate_vals, expert_ids


def moe_ffn(p, x, cfg: ArchConfig, *, impl: str = "capacity",
            capacity_factor: float = 1.25):
    """x: (B, S, d) -> ((B, S, d), aux) with aux {"load_balance",
    "router_z"} (f32 scalars on x's device). ``impl`` is "capacity" or
    "ragged"; the reference's "shard_map" is not ported."""
    if impl == "shard_map":
        raise NotImplementedError(
            "the shard-local expert-parallel MoE dispatch is not ported yet "
            "(ROADMAP.md queue A, item 9)")
    if impl not in ("capacity", "ragged"):
        raise ValueError(f"impl must be 'capacity' or 'ragged', got {impl!r}")
    m = cfg.moe
    B, S, d = x.shape
    T, k = B * S, m.top_k
    xf = x.reshape(T, d)

    logits, probs, gate_vals, expert_ids = _route(p, xf, k)

    if impl == "ragged":
        out = _ragged_path(p, xf, expert_ids, gate_vals, m, cfg.gated_mlp)
    else:
        out = _capacity_path(p, xf, expert_ids, gate_vals, m, cfg.gated_mlp,
                             capacity_factor)
    out = out.to(x.dtype)
    if m.n_shared:
        out = out + dense_ffn(p["shared"], xf, cfg.gated_mlp)
    if m.dense_residual:
        out = out + dense_ffn(p["residual"], xf, cfg.gated_mlp)

    # load-balance aux loss (Switch-style) and the router z-loss
    me = probs.mean(dim=0)
    ce = _counts(expert_ids.reshape(-1), m.n_experts).float() / (T * k)
    aux = {"load_balance": m.n_experts * torch.sum(me * ce),
           "router_z": torch.mean(torch.logsumexp(logits, dim=-1) ** 2)}
    return out.reshape(B, S, d), aux
