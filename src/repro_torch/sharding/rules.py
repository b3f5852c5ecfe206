"""Path-based sharding rules: DP / TP / EP / FSDP(ZeRO-3) over the
production mesh axes ("pod", "data", "model"), the reference's
``repro/sharding/rules.py`` rule for rule.

Conventions
-----------
* batch dims shard over ("pod","data") (all data-parallel axes).
* weight matrices: the "feature-out" dim shards over "model" (TP); with
  ``mode='fsdp'`` the other large dim additionally shards over
  ("pod","data") (ZeRO-3: the step all-gathers a layer's weights).
* MoE expert dim shards over "model" (EP).
* KV caches shard heads over "model" when divisible, else the LENGTH dim
  (sequence sharding: ``models/seq_shard_attn.py`` attends over it).
* Small vectors (norms, biases, router) replicate.

A spec is a ``P``: a tuple over a tensor's dims, each entry a mesh-axis
name, a tuple of names (the dim split over those axes together, the first
outermost) or ``None`` (replicated), as ``jax.sharding.PartitionSpec``.
``placements(spec, mesh)`` turns it into the DTensor placements of a
``torch.distributed.DeviceMesh`` (one per mesh dim). A mesh here is
anything with ``mesh_dim_names`` and ``shape`` (a ``DeviceMesh``, or
``launch.mesh.MeshShape`` where no process group exists).
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Tuple

from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs.base import ArchConfig


class P(tuple):
    """A partition spec: ``P(None, ("pod", "data"), "model")``."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} in mesh-dim order."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def mesh_axis_size(mesh, name: str) -> int:
    return axis_sizes(mesh).get(name, 1)


def batch_axes(mesh):
    names = axis_sizes(mesh)
    axes = tuple(a for a in ("pod", "data") if a in names)
    return axes if axes else None


def _dp_size(mesh) -> int:
    return mesh_axis_size(mesh, "pod") * mesh_axis_size(mesh, "data")


def placements(spec, mesh) -> tuple:
    """The DTensor placements (one per mesh dim) of ``spec``: mesh dim
    ``a`` is ``Shard(i)`` when tensor dim i names it, else ``Replicate()``.
    A dim split over several axes takes them in mesh-dim order (DTensor's
    order for repeated ``Shard(i)``: the first axis outermost), which is
    the spec's order; another order is refused."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise NotImplementedError(
                f"dim {i} of {spec} takes axes {axes} out of the mesh's "
                f"order {tuple(names)}")
        for p in pos:
            out[p] = Shard(i)
    return tuple(out)


@dataclass(frozen=True, eq=False)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``): what
    ``models.common.constrain`` redistributes a DTensor to."""
    mesh: object
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


# stacked-layer prefixes get a leading None (scan) dim
_STACK_RE = re.compile(
    r"(stack|head_layers\[\d+\]|mamba|site_proj|enc_stack|dec_stack)")


def _path_str(path) -> str:
    """The reference's pytree path string: dict keys as they are, list
    indices as ``[i]``, joined by "/"."""
    return "/".join(f"[{p}]" if isinstance(p, int) else str(p) for p in path)


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a nested dict/list tree, keeping its
    structure (a leaf is anything with a ``shape``)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def _weight_rule(path: str, shape, mesh, mode: str,
                 cfg: ArchConfig) -> Tuple:
    """Spec for the trailing (non-stack) dims of one parameter."""
    model_ok = lambda n: n % mesh_axis_size(mesh, "model") == 0
    dp = _dp_size(mesh)
    ba = batch_axes(mesh)

    def fsdp_dim(spec_list, skip):
        """shard the largest remaining None dim over the DP axes."""
        if mode != "fsdp" or ba is None:
            return spec_list
        best, best_n = None, 0
        for i, s in enumerate(spec_list):
            if s is None and i != skip and shape[i] % dp == 0 and shape[i] > best_n:
                best, best_n = i, shape[i]
        if best is not None and best_n >= 1024:
            spec_list[best] = ba
        return spec_list

    nd = len(shape)
    # ---- embeddings ----
    if path.endswith("embed/emb"):
        return tuple(fsdp_dim(["model" if model_ok(shape[0]) else None, None],
                              0))
    if "lm_head" in path and nd == 2:
        return tuple(fsdp_dim([None, "model" if model_ok(shape[1]) else None],
                              1))
    if "pos_dec" in path:
        return (None,) * nd
    # ---- MoE expert stacks: (E, in, out) ----
    if re.search(r"moe/w_(up|down)", path) or (
            "w_up" in path or "w_down" in path) and nd == 3:
        e_sh = "model" if model_ok(shape[0]) else None
        return tuple(fsdp_dim([e_sh, None, None], 0))
    # ---- MLA per-head stacks: (H, r, d) ----
    if re.search(r"(k_up|v_up)$", path) and nd == 3:
        return tuple(fsdp_dim(
            ["model" if model_ok(shape[0]) else None, None, None], 0))
    # ---- generic 2D dense weights ----
    if nd == 2 and path.endswith("/w"):
        if re.search(r"(wq|wk|wv|q_up|q_down|kv_down|up|in_proj|fc1|router)",
                     path):
            col = "model" if model_ok(shape[1]) else None
            return tuple(fsdp_dim([None, col], 1))
        if re.search(r"(wo|o_proj|down|out_proj|fc2|site_proj)", path):
            row = "model" if model_ok(shape[0]) else None
            return tuple(fsdp_dim([row, None], 0))
        col = "model" if model_ok(shape[1]) else None
        return tuple(fsdp_dim([None, col], 1))
    # ---- biases of column-parallel layers ----
    if nd == 1 and path.endswith("/b"):
        return ("model",) if model_ok(shape[0]) and shape[0] >= 1024 else (None,)
    if "conv_w" in path and nd == 2:
        return (None, "model" if model_ok(shape[1]) else None)
    if "conv_b" in path and nd == 1:
        return ("model",) if model_ok(shape[0]) else (None,)
    return (None,) * nd


def param_pspecs(cfg: ArchConfig, params, mesh, mode: str = "fsdp"):
    """A ``P`` tree mirroring the params tree (tensors of any device,
    ``meta`` included: only shapes are read)."""
    def rule(path, leaf):
        ps = _path_str(path)
        shape = tuple(leaf.shape)
        m = _STACK_RE.search(ps)
        lead = 0
        if m and m.group(1) != "site_proj" and "head_layers" not in m.group(1):
            lead = 1
        elif m and m.group(1) == "site_proj":
            lead = 1
        body = _weight_rule(ps, shape[lead:], mesh, mode, cfg)
        return P(*((None,) * lead + tuple(body)))
    return tree_map_with_path(rule, params)


def opt_state_pspec(pspec: P, shape, mesh) -> P:
    """ZeRO-1: moments/master copies inherit the param spec, further
    sharding the largest replicated dim over the DP axes when divisible."""
    dp = _dp_size(mesh)
    ba = batch_axes(mesh)
    if ba is None:
        return pspec
    spec = list(pspec) + [None] * (len(shape) - len(pspec))
    if any(s is not None and ("data" in (s if isinstance(s, tuple) else (s,)))
           for s in spec if s):
        return pspec  # already DP-sharded (fsdp param)
    best, best_n = None, 0
    for i, s in enumerate(spec):
        if s is None and shape[i] % dp == 0 and shape[i] > best_n:
            best, best_n = i, shape[i]
    if best is not None and best_n >= 256:
        spec[best] = ba
    return P(*spec)


def effective_batch_axes(mesh, global_batch: int):
    """Batch sharding axes, or None when the batch doesn't divide DP."""
    ba = batch_axes(mesh)
    if ba is None or global_batch % _dp_size(mesh) != 0:
        return None
    return ba


def data_pspecs(cfg: ArchConfig, mesh, kind: str,
                global_batch: int = 0) -> Dict[str, P]:
    """Input shardings for a shape cell."""
    ba = (effective_batch_axes(mesh, global_batch) if global_batch
          else batch_axes(mesh))
    if kind in ("train", "prefill"):
        d = {"tokens": P(ba, None)}
        if kind == "train":
            d["labels"] = P(ba, None)
        if cfg.family in ("vlm", "encdec"):
            d["prefix_emb"] = P(ba, None, None)
        return d
    return {"token": P(ba), "pos": P()}


def _len_or_head(mesh, n_heads: int, length: int):
    ms = mesh_axis_size(mesh, "model")
    if n_heads % ms == 0 and n_heads >= ms:
        return "heads"
    if length % ms == 0:
        return "length"
    return "none"


def paged_cache_pspecs(cache, mesh):
    """Shardings of the paged KV pool (n_layers, n_pages, page_size, Hkv,
    head_dim): the KV-head dim over "model" when divisible, everything else
    (the int8 scales included) replicated, as the reference's rule (the
    port's head-sharded serving holds these slices, ``kernels/sharded.py``)."""
    ms = mesh_axis_size(mesh, "model")

    def rule(path, leaf):
        shape = leaf.shape
        if len(shape) == 5 and shape[3] % ms == 0 and shape[3] >= ms:
            return P(None, None, None, "model", None)
        return P(*([None] * len(shape)))
    return tree_map_with_path(rule, cache)


def cache_pspecs(cfg: ArchConfig, cache, mesh, global_batch: int = 0):
    """KV-cache / SSM-state shardings: batch over DP; heads over "model"
    when divisible, else sequence-shard the cache length."""
    ba = (effective_batch_axes(mesh, global_batch) if global_batch
          else batch_axes(mesh))
    ms = mesh_axis_size(mesh, "model")

    def mdl(n):
        return "model" if (n % ms == 0 and n >= ms) else None

    def rule(path, leaf):
        ps = _path_str(path)
        shape = leaf.shape
        nd = len(shape)
        # --- SSM recurrent states (conv before the ssm catch-all: the
        # path is .../ssm_states/{conv,ssm}) ---------------------------
        if "conv" in ps:
            # (L,B,K,C) or zamba (sites,per,B,K,C)
            lead = nd - 3
            return P(*([None] * lead), ba, None, mdl(shape[-1]))
        if "ssm" in ps:
            # (L,B,nh,hd,N) or zamba (sites,per,B,nh,hd,N)
            lead = nd - 4
            return P(*([None] * lead), ba, mdl(shape[lead + 1]), None, None)
        # --- MLA latent caches ----------------------------------------
        if ps.endswith("/c") or "k_rope" in ps:
            if nd == 4:  # (L,B,Lmax,width): sequence-shard the cache
                return P(None, ba, mdl(shape[2]), None)
            return P(ba, mdl(shape[1]), None)      # head-layer (B,Lmax,w)
        # --- attention KV caches --------------------------------------
        if nd == 5:      # (L,B,Lmax,H,hd) / zamba (sites,B,Lmax,H,hd)
            if mdl(shape[3]):
                return P(None, ba, None, "model", None)
            return P(None, ba, mdl(shape[2]), None, None)
        if nd == 4:      # unstacked head-layer cache (B,Lmax,Hkv,hd)
            if mdl(shape[2]):
                return P(ba, None, "model", None)
            return P(ba, mdl(shape[1]), None, None)
        return P(*([None] * nd))
    return tree_map_with_path(rule, cache)


def spec_tree_map(fn, specs, tree):
    """``fn(spec, leaf)`` over a ``P`` tree and the tree it mirrors."""
    def walk(s, t):
        if isinstance(s, P):
            return fn(s, t)
        if isinstance(s, dict):
            return {k: walk(s[k], t[k]) for k in s}
        if isinstance(s, (list, tuple)):
            return type(s)(walk(a, b) for a, b in zip(s, t))
        return None
    return walk(specs, tree)


def spec_items(specs, path=()):
    """(path, spec) of every ``P`` of a spec tree, dict keys in order."""
    if isinstance(specs, P):
        yield path, specs
    elif isinstance(specs, dict):
        for k, v in specs.items():
            yield from spec_items(v, path + (k,))
    elif isinstance(specs, (list, tuple)):
        for i, v in enumerate(specs):
            yield from spec_items(v, path + (i,))
