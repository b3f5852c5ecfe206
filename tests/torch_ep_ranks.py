"""What each rank of the sequence-sharded attention and expert-parallel MoE
tests runs (``test_torch_seq_shard.py``, ``test_torch_moe_ep.py``): the
ranks are spawned (``repro_torch.launch.ranks.run_ranks``), so their work
lives in this module, which imports no JAX, and reaches them by import
path."""
import numpy as np
import torch

import repro_torch.models as tm
from repro_torch.kernels.sharded import ShardGroup
from repro_torch.models import moe as tmoe
from repro_torch.models.seq_shard_attn import (decode_attn_seq_sharded,
                                               length_slice)


def expert_slice(tree, group: ShardGroup):
    """A params tree with every MoE subtree's ``w_up``/``w_down`` cut to
    this rank's contiguous block of experts (views), the rest as it is:
    what a rank of ``moe_ffn(impl="shard_map")`` holds, as the package's
    ``init_params(experts=)`` draws it. Stacked experts (L, E, ...) are
    cut on axis 1, one layer's (E, ...) on axis 0."""
    def cut(w):
        ax = w.dim() - 3
        E = w.shape[ax]
        if E % group.size:
            raise ValueError(f"{E} experts do not divide over {group.size} "
                             f"ranks")
        n = E // group.size
        return w.narrow(ax, group.rank * n, n)

    def walk(t, in_moe=False):
        if isinstance(t, dict):
            return {k: (cut(v) if in_moe and k in ("w_up", "w_down")
                        else walk(v, in_moe or k == "moe"))
                    for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, in_moe) for v in t]
        return t
    # a params tree, or one MoE subtree itself
    return walk(tree, "router" in tree and "w_up" in tree)


def seq_attn(rank, n, arrays, cases, scale):
    """``decode_attn_seq_sharded`` on this rank's length slice of the f32
    cache in ``arrays``, for each (pos, softcap, window) of ``cases``:
    [(out, the rank's ck and cv after the write)]."""
    group = ShardGroup.from_world(n, "cpu")
    a = {k: torch.from_numpy(v) for k, v in arrays.items()}
    L = a["ck"].shape[1] // n
    res = []
    for pos, softcap, window in cases:
        ck = a["ck"][:, rank * L:(rank + 1) * L].clone()
        cv = a["cv"][:, rank * L:(rank + 1) * L].clone()
        out, ck, cv = decode_attn_seq_sharded(a["q"], a["k"], a["v"], ck, cv,
                                              pos, group, scale=scale,
                                              softcap=softcap, window=window)
        res.append((out.numpy(), ck.numpy(), cv.numpy()))
    return res


def seq_decode(rank, n, cfg, np_params, tokens, max_len, n_new):
    """A replicated prefill of ``tokens`` (B, S), this rank's length slice
    of its cache, then ``n_new`` greedy decode steps with the sequence-
    sharded attention: (logits (n_new, B, V), the rank's final cache)."""
    group = ShardGroup.from_world(n, "cpu")
    params = tm.params_from_numpy(np_params, device="cpu")
    opts = tm.RuntimeOptions(dtype="float32")
    toks = torch.from_numpy(tokens)
    B, S = toks.shape
    cache = tm.init_cache(cfg, B, max_len, opts, "cpu")
    logits, cache = tm.prefill(cfg, params, toks, cache, opts)
    cache = length_slice(cache, group)
    sopts = tm.RuntimeOptions(dtype="float32", seq_shard_attn=True,
                              seq_shard_mesh=group)
    out = []
    tok = logits.argmax(-1).to(torch.int32)
    for j in range(n_new):
        logits, cache = tm.decode_step(cfg, params, tok, S + j, cache, sopts)
        out.append(logits.numpy())
        tok = logits.argmax(-1).to(torch.int32)
    return np.stack(out), {k: v.numpy() for k, v in cache["stack"].items()}


def moe_ep(rank, n, cases):
    """``moe_ffn(impl="shard_map")`` over this rank's E/N experts for each
    (cfg, numpy MoE params, x, capacity_factor) of ``cases``: [(y, the aux
    losses (load_balance, router_z))]."""
    group = ShardGroup.from_world(n, "cpu")
    res = []
    for cfg, np_params, x, capacity_factor in cases:
        p = expert_slice(tm.params_from_numpy(np_params, device="cpu"),
                         group)
        y, aux = tmoe.moe_ffn(p, torch.from_numpy(x), cfg, impl="shard_map",
                              capacity_factor=capacity_factor,
                              shard_map_mesh=group)
        res.append((y.numpy(), np.array([float(aux["load_balance"]),
                                         float(aux["router_z"])])))
    return res


def per_shard_attn(rank, mesh_shape, arrays, cases):
    """``models.common.per_shard`` on DTensors laid out over a ("data",
    "model") DeviceMesh of the gloo ranks: for each (q placements, k/v
    placements) of ``cases`` ("S<d>" a shard of tensor dim d, "R"), the
    masked attention (causal; sliding with a valid length) and the flash
    route, each output gathered whole."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels import flash_attention as flash
    from repro_torch.models import common as cm
    mesh = init_device_mesh("cpu", tuple(mesh_shape),
                            mesh_dim_names=("data", "model"))
    a = {k: torch.from_numpy(v) for k, v in arrays.items()}

    def place(t, spec):
        return distribute_tensor(t, mesh, [Shard(int(s[1:])) if s != "R"
                                           else Replicate() for s in spec])
    res = []
    for q_spec, kv_spec in cases:
        q = place(a["q"], q_spec)
        k, v = place(a["k"], kv_spec), place(a["v"], kv_spec)
        outs = [cm.per_shard(cm.attention, q, k, v, mask_kind="causal",
                             scale=0.25),
                cm.per_shard(cm.attention, q, k, v, mask_kind="sliding",
                             window=5, kv_valid=a["valid"], scale=0.25),
                cm.per_shard(flash.flash_attention, q, k, v, causal=True,
                             scale=0.25)]
        res.append([o.full_tensor().numpy() for o in outs])
    return res
