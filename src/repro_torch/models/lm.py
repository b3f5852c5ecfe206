"""Decoder-only LM in PyTorch, over the paged KV pool (the continuous
engine's chunked prefill, fused K-step decode, speculative verify and
copy-on-write) and over a dense per-sequence cache (the static engine's
full-prompt prefill and decode).

The reference is ``repro/models/lm.py`` (its dense GQA/MHA decoders,
with local:global and prefix-LM masking, its VLM stream, its
mixture-of-experts stacks, whose layers hold a ``moe`` subtree in
place of ``mlp``: ``models/moe.py``, and its multi-head latent attention:
``models/mla.py``). Parameters keep its layout:
``params["stack"]`` carries a leading axis of the stacked layers and the
layer loop indexes it; layers of another shape before the stack
(DeepSeek-V2's dense first layer before its MoE stack) are a list,
``params["head_layers"]``, with their caches in ``cache["head"]``, on the
static path only. Unlike the reference, the
caches are updated in place: a prefill or decode step writes its KV into
the cache tensors it was given and returns the same cache dict.

Attention runs through ``kernels.decode_attention`` and
``kernels.flash_attention``: on a CUDA tensor the hand-written kernels, on
a CPU tensor their plain versions. On the static path, the layers the
reference attends through its XLA masked attention (prefix-LM prompts,
sliding-window and soft-capped layers) take ``common.attention`` instead,
on any device. Training (``train_loss``) takes ``common.attention`` on
every layer and device, as the reference trains through its XLA attention
(no kernel has a backward). With ``RuntimeOptions.kv_shard`` (head-sharded
serving) the paged pool holds this rank's KV heads only and the paged
attention runs on them through ``kernels.sharded``; the rest of the model
is replicated. With ``seq_shard_attn`` the static decode attends over a
length-sharded cache (``models/seq_shard_attn.py``); the dry run's
DTensor shardings (``residual_sharding``, ``zero3_gather``) are applied
where the reference constrains.

Public surface:
    init_params(cfg, generator, dtype, device)          -> params
    static_supported(cfg)                               -> reason or None
    kernel_width_reason(cfg, path)                      -> reason or None
    forward(cfg, params, tokens, opts, collect_kv=)     -> logits[, kvs]
    train_loss(cfg, params, batch, opts)                -> (loss, metrics)
    init_cache(cfg, batch, max_len, opts, device)       -> cache
    reset_cache(cache)             (any family's static cache, in place)
    prefill(cfg, params, tokens, cache, opts)           -> (logits, cache)
    decode_step(cfg, params, token, pos, cache, opts)   -> (logits, cache)
    init_paged_cache(cfg, n_pages, page_size, opts, device) -> cache
    prefill_paged_chunk(cfg, params, tokens, cache, page_table, start,
                        n_valid, opts, calibrate=)      -> (logits, cache)
    decode_step_paged(cfg, params, token, seq_lens, page_table, cache, opts)
    decode_steps_paged(cfg, params, tokens, seq_lens, page_table, cache,
                       n_steps, opts, eos_id=, pad_id=, temperature=,
                       top_k=, top_p=, keys=, done=, quota=)
    decode_verify_paged(cfg, params, tokens, seq_lens, n_fed, page_table,
                        cache, opts)                    -> (logits, cache)
    spec_decode_verify(cfg, params, tokens, draft_len, seq_lens, page_table,
                       cache, keys, opts, temperature=, top_k=, top_p=,
                       pad_id=)                         -> (out, n_acc, cache)
    copy_pages(cache, pairs)
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import decode_attention as kern
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import sharded as ksh
from repro_torch.models import common as cm
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import sampling as sampling_mod

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int8": torch.int8}


def torch_dtype(name) -> torch.dtype:
    """'bfloat16' -> torch.bfloat16 (a torch.dtype passes through)."""
    if isinstance(name, torch.dtype):
        return name
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; one of {sorted(_DTYPES)}")
    return _DTYPES[name]


@dataclass(frozen=True)
class RuntimeOptions:
    dtype: str = "bfloat16"
    moe_impl: str = "capacity"      # capacity | ragged
    cache_dtype: str = ""           # "" -> same as dtype; "int8" -> quantized
    capacity_factor: float = 1.25
    remat: str = "none"             # none | block  (activation checkpointing)
    # head-sharded paged serving (DESIGN.md SS16): a kernels.sharded
    # ShardGroup whose ranks each hold Hkv/N heads of the paged pool and
    # attend over them, all-gathering head outputs (bitwise identical to
    # the unsharded path). None: the whole pool on one device.
    kv_shard: object = None
    # The dry run's shardings (launch/dryrun.py), the reference's fields:
    # a sharding.NamedSharding for the (B, S, d) residual stream (each
    # layer's start redistributes a DTensor stream to it), and the MoE
    # capacity path's expert-major (E, C, d) and combine shardings.
    residual_sharding: object = None
    moe_expert_sharding: object = None
    moe_out_sharding: object = None
    # ZeRO-3 per-layer weight gathering: (param path suffix, sharding
    # without the data axes) pairs, applied to a layer's params as it starts
    zero3_gather: tuple = ()
    # sequence-sharded decode attention over a LENGTH-sharded dense cache
    # (models/seq_shard_attn.py): seq_shard_mesh is a kernels.sharded
    # ShardGroup (real ranks, each holding its length slice) or a
    # DeviceMesh whose "model" dim splits the length (the dry run)
    seq_shard_attn: bool = False
    seq_shard_mesh: object = None
    # shard-local expert-parallel MoE (moe_impl="shard_map"): a ShardGroup
    # whose ranks each hold E/N experts, or a DeviceMesh (the dry run)
    moe_shard_map_mesh: object = None

    @property
    def tdtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)


def resolve_device(device) -> torch.device:
    """The entry points run on the card unless the caller asks for the CPU;
    a CUDA device without CUDA is an error, never a silent CPU run."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the port runs on the GPU "
                           "by default; pass device='cpu' to run on the CPU")
    return device


# ------------------------------- params --------------------------------- #

def _init_layer(generator, cfg: ArchConfig, dtype, device, d_ff: int):
    """One layer's norms and attention (MLA where the config has it), and
    a dense FFN of ``d_ff`` unless ``d_ff`` is 0 (an MoE stack's layer:
    ``init_params`` adds the stacked ``moe`` subtree then)."""
    H, Hkv, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    b = cfg.qkv_bias

    def lin(d_in, d_out, bias=False):
        return cm.dense_init(generator, d_in, d_out, dtype, device, bias=bias)
    p = {
        "ln1": torch.zeros((d,), dtype=dtype, device=device),
        "ln2": torch.zeros((d,), dtype=dtype, device=device),
    }
    if cfg.mla is not None:
        p["attn"] = mla_mod.init_mla(generator, cfg, dtype, device)
    else:
        p["attn"] = {"wq": lin(d, H * hd, b), "wk": lin(d, Hkv * hd, b),
                     "wv": lin(d, Hkv * hd, b), "wo": lin(H * hd, d)}
    if d_ff:
        p["mlp"] = moe_mod.init_dense_ffn(generator, cfg, d_ff, dtype, device)
    return p


def _layer_split(cfg: ArchConfig):
    """(unstacked prefix layers, whether the stack is MoE)."""
    if cfg.moe is not None and cfg.moe.first_dense:
        return cfg.moe.first_dense, True
    return 0, cfg.moe is not None


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_params(cfg: ArchConfig, generator: torch.Generator, dtype="bfloat16",
                device="cuda", experts: slice = None):
    """Random weights from ``generator`` in the reference layout. The draws
    are PyTorch's, not JAX's: to share weights with the reference package,
    convert its params with ``models.convert.params_from_numpy``.
    ``experts``: an MoE stack keeps only that slice of its experts (an
    expert-parallel rank's share, ``moe.init_moe``)."""
    reason = static_supported(cfg)
    if reason:
        raise NotImplementedError(reason)
    device = resolve_device(device)
    dtype = torch_dtype(dtype)
    n_pre, stack_moe = _layer_split(cfg)
    n_stack = cfg.n_layers - n_pre
    params = {"embed": cm.embed_init(generator, cfg.vocab, cfg.d_model,
                                     dtype, device),
              "final_norm": torch.zeros((cfg.d_model,), dtype=dtype,
                                        device=device)}
    if n_pre:
        params["head_layers"] = [
            _init_layer(generator, cfg, dtype, device,
                        cfg.moe.d_ff_dense or cfg.d_ff)
            for _ in range(n_pre)]
    params["stack"] = _stack([
        _init_layer(generator, cfg, dtype, device,
                    0 if stack_moe else cfg.d_ff)
        for _ in range(n_stack)])
    if stack_moe:
        params["stack"]["moe"] = moe_mod.init_moe(generator, cfg, n_stack,
                                                  dtype, device, experts)
    if not cfg.tie_embeddings:
        params["lm_head"] = cm.dense_init(generator, cfg.d_model, cfg.vocab,
                                          dtype, device,
                                          scale=cfg.d_model ** -0.5)
    return params


def unstack(tree, depth: int = 1):
    """A stacked tree with each leaf cut into (nested) lists of its slices
    on the leading ``depth`` axes, by ``torch.unbind`` (views). ``_layer``
    indexes such a list as it indexes the stack, but in the backward pass
    one unbind stacks its slices' gradients once, where each indexed
    slice's backward writes a zero tensor the size of the whole stack (a
    layer's backward would write every stacked weight's size)."""
    if isinstance(tree, dict):
        return {k: unstack(v, depth) for k, v in tree.items()}
    parts = list(tree.unbind(0))
    return parts if depth == 1 else [unstack(x, depth - 1) for x in parts]


def _layer(tree, i: int):
    """Layer ``i``'s slice (views) of a stacked param or cache tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ------------------------------- layers --------------------------------- #

def _ffn_apply(p, x, cfg: ArchConfig, opts: RuntimeOptions, aux=None):
    """The layer's FFN: the MoE FFN or the dense one. The MoE FFN's aux
    losses are added into the dict ``aux`` when one is given (training),
    else dropped (serving has no use for them)."""
    if "moe" in p:
        y, a = moe_mod.moe_ffn(p["moe"], x, cfg, impl=opts.moe_impl,
                               capacity_factor=opts.capacity_factor,
                               expert_sharding=opts.moe_expert_sharding,
                               out_sharding=opts.moe_out_sharding,
                               shard_map_mesh=opts.moe_shard_map_mesh)
        if aux is not None:
            for name, val in a.items():
                aux[name] = aux[name] + val
        return y
    return moe_mod.dense_ffn(p["mlp"], x, cfg.gated_mlp)


def _logits(cfg, params, x):
    x = cm.rms_norm(x, params["final_norm"])
    if cfg.tie_embeddings:
        return x @ params["embed"]["emb"].T
    return cm.dense(params["lm_head"], x)


def _embed_tokens(cfg, params, tokens, prefix_emb=None):
    """Token embeddings (B, S, d), with ``prefix_emb`` (B, P, d), a stub
    frontend's output (VLM patches), prepended in the embeddings' dtype."""
    x = params["embed"]["emb"][tokens.long()]
    # gemma-style scale, rounded to the activation dtype first as the
    # reference does (a host scalar: no host-to-device copy per step)
    x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype))
    if prefix_emb is not None:
        x = torch.cat([prefix_emb.to(x.device, x.dtype), x], dim=1)
    return x


# ---------------------------- paged serving ----------------------------- #
# Page 0 of the pool is the null page: padded page-table entries and
# inactive or latched batch slots write and read it harmlessly (reads are
# masked by length, writes land on data nobody consumes).


def static_supported(cfg: ArchConfig) -> Optional[str]:
    """None when this module's static dense-cache path runs ``cfg`` (the
    dense, MoE and VLM decoders, MLA and unstacked prefix layers
    included); else why not."""
    if cfg.family not in ("dense", "moe", "vlm"):
        return (f"family {cfg.family!r} is not a decoder-only LM: "
                f"models.api.module_for gives its module")
    return None


def paged_supported(cfg: ArchConfig) -> Optional[str]:
    """None when the paged path runs ``cfg``; else why not: the
    reference's reasons, in its order, and soft-capping, which the
    reference's paged path would hand to kernels without a soft-cap."""
    if cfg.mla is not None:
        return "MLA latent cache is already compressed; paged path covers GQA"
    if cfg.family not in ("dense", "moe"):
        # the reference's rule: its VLM stream runs on the dense cache only
        return f"family {cfg.family!r} is not covered by the paged KV path"
    if _layer_split(cfg)[0]:
        return "unscanned prefix layers not supported by the paged cache"
    if cfg.sliding_window:
        return ("sliding-window layers need windowed page masking, which the "
                "reference's paged path lacks too")
    if cfg.enc_layers:
        return "cross-attention caches are not paged"
    if cfg.logit_softcap:
        return ("logit soft-capping is not in the paged kernels, and the "
                "reference's paged path would drop it")
    return None


def _kernel_layers(cfg: ArchConfig, path: str):
    """The kernels that ``path``'s layers reach on a CUDA device: "paged"
    (the paged decode, chunk prefill and spec verify, on every layer of a
    ``paged_supported`` config), "prefill" (flash on a causal layer without
    a soft-cap), "decode" (the dense decode on a layer with neither a
    window nor a soft-cap) or "static" (both). Masked, windowed,
    soft-capped and MLA layers reach none. Every kernel takes head widths
    64, 128, 256, 384, 512 and every multiple of 128 above 512
    (``kernels.head_dim_taken``), so a width is refused only where it is
    none of these (the reduced twins' 16, or 80, 96, 192, 576, 1000)."""
    if path == "paged":
        return ["paged decode / chunk prefill / spec verify"]
    if path not in ("prefill", "decode", "static"):
        raise ValueError(f"unknown path {path!r}")
    if cfg.mla is not None or cfg.logit_softcap:
        return []
    n_pre, _ = _layer_split(cfg)
    kinds = [0] * n_pre + _kind_array(cfg, n_pre, cfg.n_layers - n_pre)
    out = []
    prefix = cfg.prefix_bidirectional and cfg.prefix_len
    if path != "decode" and not prefix and 0 in kinds:
        out.append("flash attention")
    if path != "prefill" and 0 in kinds:
        out.append("dense decode")
    return out


def kernel_width_reason(cfg: ArchConfig, path: str) -> Optional[str]:
    """None when every kernel that ``path``'s layers reach on a CUDA device
    (see ``_kernel_layers``) takes ``cfg.head_dim``; else why not. Checked
    before any weights are drawn, so a config no kernel serves fails at
    construction rather than at its first launch. The CPU takes any width,
    and training reaches no kernel."""
    if (paged_supported if path == "paged" else static_supported)(cfg):
        return None                      # the path does not run cfg at all
    if kern.head_dim_taken(cfg.head_dim):
        return None
    bad = _kernel_layers(cfg, path)
    if not bad:
        return None
    takes = "; ".join(f"the {name} takes {kern.TAKEN_WIDTHS}"
                      for name in bad)
    return (f"{cfg.name}: head_dim {cfg.head_dim} reaches a CUDA kernel that "
            f"does not take it ({takes}); pass device='cpu' (--device cpu) "
            f"to run it on the CPU")


def _refuse_width(cfg: ArchConfig, path: str, device) -> None:
    """Raise ``NotImplementedError`` on a CUDA ``device`` when
    ``kernel_width_reason(cfg, path)`` gives a reason."""
    if torch.device(device).type == "cuda":
        reason = kernel_width_reason(cfg, path)
        if reason:
            raise NotImplementedError(reason)


def _local_kv_heads(cfg: ArchConfig, opts: RuntimeOptions) -> slice:
    """The pool's KV heads on this device: this rank's block of them under
    ``opts.kv_shard``, else all (a whole-axis slice: the same code)."""
    if opts.kv_shard is not None:
        return ksh.head_slice(opts.kv_shard, cfg.n_kv_heads)
    return slice(0, cfg.n_kv_heads)


def init_paged_cache(cfg: ArchConfig, n_pages: int, page_size: int,
                     opts: RuntimeOptions = RuntimeOptions(), device="cuda"):
    """Pooled KV pages: (n_layers, n_pages, page_size, Hkv, dh) per k/v;
    under ``opts.kv_shard`` this rank's (n_layers, n_pages, page_size,
    Hkv/N, dh) head slice.

    ``opts.cache_dtype='int8'`` stores int8 pages with per-(layer, kv-head)
    f32 scales ((n_layers, Hkv/N) on a shard), calibrated by the pool's
    first prefill chunk."""
    reason = paged_supported(cfg)
    if reason:
        raise NotImplementedError(f"paged KV cache: {reason}")
    device = resolve_device(device)
    _refuse_width(cfg, "paged", device)
    quant = opts.cache_dtype == "int8"
    dtype = torch_dtype(opts.cache_dtype or opts.dtype)
    hl = _local_kv_heads(cfg, opts)
    n_kv = hl.stop - hl.start
    shape = (cfg.n_layers, n_pages, page_size, n_kv, cfg.head_dim)
    c = {"k": torch.zeros(shape, dtype=dtype, device=device),
         "v": torch.zeros(shape, dtype=dtype, device=device)}
    if quant:
        c["k_scale"] = torch.ones((cfg.n_layers, n_kv),
                                  dtype=torch.float32, device=device)
        c["v_scale"] = torch.ones((cfg.n_layers, n_kv),
                                  dtype=torch.float32, device=device)
    return {"stack": c}


def reset_paged_cache(cache) -> None:
    """Return a pool of ``init_paged_cache`` to its fresh state in place
    (pages zero, int8 scales one), keeping its storage: what a captured
    block reads and writes stays where the capture found it."""
    st = cache["stack"]
    for name, t in st.items():
        t.fill_(1 if name.endswith("_scale") else 0)


def reset_cache(cache) -> None:
    """Return a static cache of any family's ``init_cache`` to its fresh
    state in place, keeping its storage (what a captured step reads and
    writes stays where its capture found it): the KV (its int8 scales
    one), MLA's latent and rope key, Mamba's conv and SSM states, Zamba's
    site KV and Whisper's self and cross KV all zero. Whisper's cross KV
    keeps the frame count its last prefill gave it."""
    if isinstance(cache, dict):
        for name, leaf in cache.items():
            if torch.is_tensor(leaf):
                leaf.fill_(1 if name.endswith("_scale") else 0)
            else:
                reset_cache(leaf)
    else:
        for leaf in cache:
            reset_cache(leaf)


def layer_dma_slices(cfg: ArchConfig) -> int:
    """DMA slice count for layer-overlapped page migration: the pool's
    leading axis is ``n_layers``, so a page's layer-``l`` slice is one
    contiguous region per pool tensor, consumed in layer order."""
    return max(int(cfg.n_layers), 1)


def page_layer_nbytes(cfg: ArchConfig, page_size: int,
                      dtype_bytes: int = 2) -> float:
    """Bytes of ONE layer's k+v slice of a page."""
    per_tok = 2 * cfg.n_kv_heads * cfg.head_dim * dtype_bytes
    return float(per_tok * page_size)


def _amax_scale(val, dims):
    """Per-kv-head symmetric int8 scale: amax/127 reduced over ``dims``."""
    return torch.clamp_min(val.float().abs().amax(dim=dims), 1e-6) / 127.0


def _quantize_with(val, scale):
    """val: (..., Hkv, dh); scale: (..., Hkv). torch.round, like
    jnp.round, rounds half to even."""
    return torch.clamp(torch.round(val.float() / scale[..., :, None]),
                       -127, 127)


def _kv_rows(page_table, positions, page_size: int):
    """Where a step writes its KV, the same for every layer: pool rows
    ``flat`` (B*C,) of the (P * ps) view for absolute ``positions`` (B, C)
    through ``page_table`` (positions past the table land on the null page,
    clipped explicitly: a gather past the table's end must not read out of
    bounds), and for each write the index of the last write to its row.

    Duplicate rows only ever lie on the null page, which no real row reads
    unmasked; but a step's padding rows (inactive and latched slots, pad
    positions) do read it, and under MoE capacity routing they compete
    with the real rows for expert slots. So each duplicate writes the
    value of its last occurrence, as a sequential scatter leaves it, and
    the pool is the same after every run, on the card too (a parallel
    scatter leaves an arbitrary writer)."""
    n_pp = page_table.shape[1]
    blk = positions // page_size
    pid = torch.gather(page_table, 1, blk.clamp(max=n_pp - 1).long())
    pid = torch.where(blk < n_pp, pid, 0)
    flat = (pid * page_size + positions % page_size).reshape(-1).long()
    idx = torch.arange(flat.shape[0], device=flat.device)
    last = torch.where(flat[:, None] == flat[None, :], idx, -1).amax(dim=1)
    return flat, last


def _write_kv(kp, vp, rows, k, v):
    """In-place scatter of ``k`` and ``v`` (N, Hkv, dh) into the pool rows
    ``rows`` of ``_kv_rows`` — the reference's ``.at[].set`` on a donated
    buffer."""
    flat, last = rows
    P, ps = kp.shape[:2]
    for pool, vals in ((kp, k), (vp, v)):
        pool.view(P * ps, *pool.shape[2:]).index_copy_(0, flat, vals[last])


def _project_qkv(p, x, cfg: ArchConfig, rope):
    """q, k, v of x (B, S, d); ``rope`` is the step's (cos, sin)."""
    B, S, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = cm.dense(p["wq"], x).reshape(B, S, H, hd)
    k = cm.dense(p["wk"], x).reshape(B, S, Hkv, hd)
    v = cm.dense(p["wv"], x).reshape(B, S, Hkv, hd)
    return cm.rotate(q, *rope), cm.rotate(k, *rope), v


def _attend_pool(cfg: ArchConfig, opts: RuntimeOptions, attend, q, kp, vp,
                 ksc, vsc, extras, *, q_head_axis: int):
    """``attend(q, kp, vp, ksc, vsc, *extras)`` over the paged pool: under
    ``opts.kv_shard`` on this rank's head slice with the head outputs
    all-gathered (``kernels.sharded.sharded_attend``, the reference's
    routing), else over the whole pool."""
    if opts.kv_shard is not None:
        return ksh.sharded_attend(opts.kv_shard, attend, q, kp, vp, ksc, vsc,
                                  extras, q_head_axis=q_head_axis)
    return attend(q, kp, vp, ksc, vsc, *extras)


def _paged_chunk_attn(p, x, cfg: ArchConfig, opts: RuntimeOptions,
                      cache_layer, positions, rope, page_table, rows, start,
                      n_valid, *, calibrate: bool, n_fed=None):
    """Chunk attention against pooled KV pages. x: (B, C, d).

    Scatters the chunk's KV into the pool rows ``rows`` (``_kv_rows`` of
    ``positions``) first,
    then attends causally (by absolute position) across every page the
    sequence owns — previously cached prefix pages included. ``n_fed``
    (B,) marks a speculative verify window (``start`` = seq_lens) and
    routes it to ``spec_verify_attention``; a prefill chunk, whose start
    is a (B,) tensor too, goes to ``chunk_prefill_attention``. On a head
    shard, q, k and v are projected for every head (replicated) and the
    pool and its scales hold this rank's heads only."""
    B, C, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _project_qkv(p, x, cfg, rope)
    hl = _local_kv_heads(cfg, opts)
    quant = "k_scale" in cache_layer
    kp, vp = cache_layer["k"], cache_layer["v"]

    if quant:
        if calibrate:
            # first chunk of the pool's life sets the frozen scales; keep
            # the chunk's right-padding out of them. Every head's scale,
            # then this device's slice of them
            ok = (positions < n_valid[:, None])[..., None, None]
            cache_layer["k_scale"].copy_(
                _amax_scale(torch.where(ok, k, 0), (0, 1, 3))[hl])
            cache_layer["v_scale"].copy_(
                _amax_scale(torch.where(ok, v, 0), (0, 1, 3))[hl])
        ksc, vsc = cache_layer["k_scale"], cache_layer["v_scale"]
        k_store = _quantize_with(k[:, :, hl], ksc[None, None]).to(torch.int8)
        v_store = _quantize_with(v[:, :, hl], vsc[None, None]).to(torch.int8)
    else:
        ksc = vsc = None
        k_store, v_store = k[:, :, hl].to(kp.dtype), v[:, :, hl].to(vp.dtype)

    # scatter the chunk's KV at absolute positions [start, start + C)
    _write_kv(kp, vp, rows, k_store.reshape(B * C, *k_store.shape[2:]),
              v_store.reshape(B * C, *v_store.shape[2:]))

    def attend(q_, kp_, vp_, ksc_, vsc_, pt, st, nv):
        # the kernels' splits follow the unsharded head count, so a shard
        # sums in the same order as the whole pool
        if n_fed is not None:
            return kern.spec_verify_attention(
                q_, kp_, vp_, pt, st, nv, scale=hd ** -0.5, k_scale=ksc_,
                v_scale=vsc_, split_kv_heads=Hkv)
        return kern.chunk_prefill_attention(
            q_, kp_, vp_, pt, st, nv, scale=hd ** -0.5, k_scale=ksc_,
            v_scale=vsc_, split_kv_heads=Hkv)
    out = _attend_pool(cfg, opts, attend, q, kp, vp, ksc, vsc,
                       (page_table, start,
                        n_valid if n_fed is None else n_fed), q_head_axis=2)
    return cm.dense(p["wo"], out.reshape(B, C, H * hd))


def prefill_paged_chunk(cfg: ArchConfig, params, tokens, cache, page_table,
                        start, n_valid,
                        opts: RuntimeOptions = RuntimeOptions(),
                        *, calibrate: bool = False):
    """One fixed-size prefill chunk against the paged pool.

    tokens: (B, C) int32, right-padded; page_table: (B, n_pages_per_seq)
    int32; start: absolute position of tokens[:, 0] (earlier positions
    already hold valid KV), a host int or a 0-d, (1,) or (B,) int32 tensor
    on the device (as the reference's traced scalar: a captured chunk
    reads it from its buffer); n_valid: (B,) int32 total valid tokens once
    this chunk lands. ``calibrate=True`` (first chunk only) sets the int8
    scales. Writes the chunk's KV into ``cache`` in place. Returns (logits
    (B, C, vocab), cache)."""
    B, C = tokens.shape
    x = _embed_tokens(cfg, params, tokens)
    # (B,) on the device once per chunk, not a host copy per layer
    if isinstance(start, torch.Tensor):
        start_b = (start.to(x.device, torch.int32).reshape(-1).expand(B)
                   .contiguous())
    else:
        start_b = torch.full((B,), start, dtype=torch.int32, device=x.device)
    positions = start_b[:, None] + torch.arange(C, dtype=torch.int32,
                                                device=x.device)
    rope = cm.rope_cos_sin(positions, cfg.head_dim)
    st = cache["stack"]
    rows = _kv_rows(page_table, positions, st["k"].shape[2])
    for i in range(cfg.n_layers):
        lp, cl = _layer(params["stack"], i), _layer(st, i)
        x = cm.constrain(x, opts.residual_sharding)
        x = x + _paged_chunk_attn(lp["attn"], cm.rms_norm(x, lp["ln1"]), cfg,
                                  opts, cl, positions, rope, page_table, rows,
                                  start_b, n_valid, calibrate=calibrate)
        x = x + _ffn_apply(lp, cm.rms_norm(x, lp["ln2"]), cfg, opts)
    return _logits(cfg, params, x), cache


def copy_pages(cache, pairs):
    """Apply queued copy-on-write page copies to the pool, in place.

    pairs: (N, 2) int32 (src, dst) physical page ids — the output of
    ``PagedKVManager.drain_copies``. Must run before the next KV write.
    Sources are read before any destination is written, as in the
    reference's functional update."""
    st = cache["stack"]
    src, dst = pairs[:, 0].long(), pairs[:, 1].long()
    for name in ("k", "v"):
        st[name].index_copy_(1, dst, st[name].index_select(1, src))
    return cache


def _paged_decode_attn(p, x, cfg: ArchConfig, opts: RuntimeOptions,
                       cache_layer, seq_lens, rope, page_table, rows):
    """Single-token attention against pooled KV pages. x: (B, 1, d); the
    new token's KV lands in the pool rows ``rows`` (``_kv_rows`` at
    ``seq_lens``: page ``page_table[b, len // ps]``, offset ``len % ps``;
    the null page for inactive slots, whose table rows are 0). On a head
    shard, only this rank's KV heads are written and attended."""
    B = x.shape[0]
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _project_qkv(p, x, cfg, rope)
    hl = _local_kv_heads(cfg, opts)
    quant = "k_scale" in cache_layer
    kp, vp = cache_layer["k"], cache_layer["v"]

    if quant:
        ksc, vsc = cache_layer["k_scale"], cache_layer["v_scale"]
        k_store = _quantize_with(k[:, 0, hl], ksc[None]).to(torch.int8)
        v_store = _quantize_with(v[:, 0, hl], vsc[None]).to(torch.int8)
    else:
        ksc = vsc = None
        k_store, v_store = k[:, 0, hl].to(kp.dtype), v[:, 0, hl].to(vp.dtype)

    _write_kv(kp, vp, rows, k_store, v_store)

    def attend(q_, kp_, vp_, ksc_, vsc_, pt, lens):
        return kern.paged_decode_attention(
            q_, kp_, vp_, pt, lens, scale=hd ** -0.5, k_scale=ksc_,
            v_scale=vsc_, split_kv_heads=Hkv)
    out = _attend_pool(cfg, opts, attend, q[:, 0], kp, vp, ksc, vsc,
                       (page_table, seq_lens + 1), q_head_axis=1)
    return cm.dense(p["wo"], out.reshape(B, 1, H * hd))


def decode_step_paged(cfg: ArchConfig, params, token, seq_lens, page_table,
                      cache, opts: RuntimeOptions = RuntimeOptions()):
    """One ragged decode step over the paged pool.

    token: (B,) int32 last sampled token per slot; seq_lens: (B,) int32
    tokens already cached (the new token lands at this position);
    page_table: (B, n_pages_per_seq) int32. Inactive slots (page-table rows
    all zero, seq_len 0) write to the null page and produce ignorable
    logits. Returns (logits (B, V), cache) with the pool updated in place."""
    x = _embed_tokens(cfg, params, token[:, None])
    rope = cm.rope_cos_sin(seq_lens[:, None], cfg.head_dim)
    st = cache["stack"]
    rows = _kv_rows(page_table, seq_lens[:, None], st["k"].shape[2])
    for i in range(cfg.n_layers):
        lp, cl = _layer(params["stack"], i), _layer(st, i)
        x = cm.constrain(x, opts.residual_sharding)
        x = x + _paged_decode_attn(lp["attn"], cm.rms_norm(x, lp["ln1"]), cfg,
                                   opts, cl, seq_lens, rope, page_table, rows)
        x = x + _ffn_apply(lp, cm.rms_norm(x, lp["ln2"]), cfg, opts)
    return _logits(cfg, params, x)[:, 0], cache


def decode_steps_paged(cfg: ArchConfig, params, tokens, seq_lens, page_table,
                       cache, n_steps: int,
                       opts: RuntimeOptions = RuntimeOptions(), *,
                       eos_id: Optional[int] = None, pad_id: int = 0,
                       temperature: float = 0.0, top_k: int = 0,
                       top_p: float = 1.0, keys=None, done=None, quota=None):
    """Fused K-step decode over the paged pool.

    ``n_steps`` micro-steps run as a Python loop of device work with no
    host sync inside: each step writes the carried token's KV at its slot's
    current length, attends, chooses the next token on device and advances
    per-slot lengths. Every KV position the loop writes must be page-backed
    up front (``PagedKVManager.reserve_ahead``).

    Sampling: greedy argmax at ``temperature <= 0``; otherwise
    temperature/top-k/top-p with per-slot keys ``keys`` — (B, 2) int64 from
    ``sampling.request_keys``, whose token index is that of the block's
    first token; micro-step j draws the noise of token index + j, so a
    request's draws depend only on its own identity and progress. (The
    reference returns advanced keys; here the caller re-derives them from
    the tokens emitted, so the return is always a pair.)

    tokens: (B,) last sampled token per slot; seq_lens: (B,) tokens whose
    KV already landed; done: (B,) bool slots that start inactive; quota:
    (B,) int32 max tokens each slot may emit (default ``n_steps``). A slot
    latches done after emitting ``eos_id`` or exhausting its quota; latched
    slots emit ``pad_id``, stop advancing, and their page-table rows are
    masked to the null page. Returns ((B, n_steps) int32 tokens, cache)."""
    B = tokens.shape[0]
    dev = tokens.device
    stochastic = temperature > 0.0
    if stochastic and keys is None:
        raise ValueError("stochastic fused decode needs per-slot keys "
                         "(keys=(B, 2) int64 from sampling.request_keys)")
    dn = (torch.zeros((B,), dtype=torch.bool, device=dev) if done is None
          else done.to(dev, torch.bool))
    quota = (torch.full((B,), n_steps, dtype=torch.int32, device=dev)
             if quota is None else quota.to(dev, torch.int32))
    tok = tokens.to(torch.int32)
    lens = seq_lens.to(torch.int32)
    n_emit = torch.zeros((B,), dtype=torch.int32, device=dev)
    pad = torch.full((B,), pad_id, dtype=torch.int32, device=dev)
    cols = []
    for j in range(n_steps):
        # latched slots write into (and read from) the null page only
        pt = torch.where(dn[:, None], 0, page_table)
        logits, cache = decode_step_paged(cfg, params, tok, lens, pt, cache,
                                          opts)
        if stochastic:
            noise = sampling_mod.gumbel(sampling_mod.advance(keys, j),
                                        logits.shape[-1])
            chosen = sampling_mod.sample(logits, noise,
                                         temperature=temperature,
                                         top_k=top_k, top_p=top_p)
        else:
            chosen = sampling_mod.sample_greedy(logits)
        nxt = torch.where(dn, pad, chosen)
        n_emit = n_emit + (~dn).to(torch.int32)
        new_dn = dn | (n_emit >= quota)
        if eos_id is not None:
            new_dn = new_dn | (~dn & (nxt == eos_id))
        lens = torch.where(dn, lens, lens + 1)   # this step's write landed
        cols.append(nxt)
        tok, dn = nxt, new_dn
    return torch.stack(cols, dim=1), cache


# ------------------------- speculative decoding ------------------------ #
# A draft (n-gram lookup or a small model) proposes up to K tokens; ONE
# paged multi-query verify pass scores the whole window against the target
# model; leftover/rejection sampling keeps the output distribution exactly
# the target's.


def decode_verify_paged(cfg: ArchConfig, params, tokens, seq_lens, n_fed,
                        page_table, cache,
                        opts: RuntimeOptions = RuntimeOptions()):
    """One paged multi-query pass over a (B, C) token window.

    tokens: (B, C) window ``[t_last, d_1 .. d_{C-1}]`` per slot — t_last
    is the last committed token (its KV has NOT landed; the pass writes
    it) followed by draft proposals; seq_lens: (B,) int32 tokens whose KV
    already landed (the window starts there); n_fed: (B,) int32 real
    window tokens per slot (1 <= n_fed <= C; shorter drafts right-pad).
    All C KV positions a slot may write must be page-backed
    (``reserve_ahead(draft_len + 1)``) or fall past the table (null page).

    Logits row j of slot b is the target distribution for the token AFTER
    window token j. Pad rows write KV beyond the fed window: never
    committed, overwritten before any read. Returns (logits (B, C, vocab),
    cache) with the pool updated in place."""
    B, C = tokens.shape
    x = _embed_tokens(cfg, params, tokens)
    seq_lens = seq_lens.to(torch.int32)
    n_fed = n_fed.to(torch.int32)
    n_valid = seq_lens + n_fed
    positions = seq_lens[:, None] + torch.arange(C, dtype=torch.int32,
                                                 device=x.device)
    rope = cm.rope_cos_sin(positions, cfg.head_dim)
    st = cache["stack"]
    rows = _kv_rows(page_table, positions, st["k"].shape[2])
    for i in range(cfg.n_layers):
        lp, cl = _layer(params["stack"], i), _layer(st, i)
        x = cm.constrain(x, opts.residual_sharding)
        x = x + _paged_chunk_attn(lp["attn"], cm.rms_norm(x, lp["ln1"]), cfg,
                                  opts, cl, positions, rope, page_table, rows,
                                  seq_lens, n_valid, calibrate=False,
                                  n_fed=n_fed)
        x = x + _ffn_apply(lp, cm.rms_norm(x, lp["ln2"]), cfg, opts)
    return _logits(cfg, params, x), cache


def spec_decode_verify(cfg: ArchConfig, params, tokens, draft_len, seq_lens,
                       page_table, cache, keys=None,
                       opts: RuntimeOptions = RuntimeOptions(), *,
                       temperature: float = 0.0, top_k: int = 0,
                       top_p: float = 1.0, pad_id: int = 0):
    """Verify a draft window and accept/reject in one device round.

    tokens: (B, C) fed window ``[t_last, d_1 .. d_{C-1}]``; draft_len:
    (B,) real proposals per slot (<= C-1; the pass feeds draft_len + 1
    tokens); keys: (B, 2) per-slot keys at the window's first token index
    (``sampling.request_keys``; unused at temperature 0). Emits ``n_acc +
    1`` tokens per active slot: the accepted draft prefix plus one
    corrected/bonus token. At temperature 0 the emitted stream is
    token-identical to non-speculative greedy decode.

    Returns (out (B, C) int32 [accepted drafts, correction, pads], n_acc
    (B,) int32, cache)."""
    draft_len = draft_len.to(torch.int32)
    logits, cache = decode_verify_paged(cfg, params, tokens, seq_lens,
                                        draft_len + 1, page_table, cache,
                                        opts)
    K = tokens.shape[1] - 1
    u = noise = None
    if temperature > 0.0:
        u = sampling_mod.accept_uniforms(keys, K)
        noise = sampling_mod.gumbel(keys, logits.shape[-1])
    out, n_acc = sampling_mod.spec_accept(
        logits, tokens[:, 1:].to(torch.int32), draft_len, u, noise,
        temperature=temperature, top_k=top_k, top_p=top_p, pad_id=pad_id)
    return out, n_acc, cache


# ------------------------- static dense-cache serving ------------------- #
# The static engine's path: one prefill of a whole equal-length prompt wave
# (every layer's KV written to a dense per-sequence cache as the layer
# finishes), then decode steps that all write and read at one shared
# position ``pos``. The attention of each layer follows the reference's
# routes: the flash kernel for a causal prompt without soft-capping and
# the dense decode kernel (kv_valid = pos + 1, the reference's causal
# attention at q_offset = pos) for a layer with neither a window nor a
# soft-cap; the general masked attention (``common.attention``) for the
# rest (prefix-LM prompts, sliding-window and soft-capped layers). MLA
# layers (``models/mla.py``) attend the prompt through the masked
# attention and decode in the latent space, as the reference does; their
# cache is the latent, whatever ``cache_dtype`` says.


def _kind_array(cfg: ArchConfig, start: int, n: int):
    """Per-layer attention kind of layers [start, start + n): 0 global
    (causal, or the prompt's prefix-LM mask), 1 local (sliding window;
    gemma3's layer i is global when i % 6 == 5)."""
    return [1 if cfg.attention_kind(start + i) == "local" else 0
            for i in range(n)]


def _layers(cfg: ArchConfig, params, cache=None):
    """(layer params, layer cache or None, kind) of every layer in order:
    the unstacked prefix layers (kind 0, as in the reference), then the
    stack's."""
    n_pre = len(params.get("head_layers", []))
    n_stack = cfg.n_layers - n_pre
    out = [(lp, None if cache is None else cache["head"][i], 0)
           for i, lp in enumerate(params.get("head_layers", []))]
    for i, kind in enumerate(_kind_array(cfg, n_pre, n_stack)):
        out.append((_layer(params["stack"], i),
                     None if cache is None else _layer(cache["stack"], i),
                     kind))
    return out


def _prompt_mask(cfg: ArchConfig, kind: int):
    """(mask kind, window, prefix_len) of a layer's prompt attention: a
    local layer's sliding window, else the prefix-LM mask over the first
    ``prefix_len`` positions when the config has one (with or without a
    ``prefix_emb``: without one, those are the first text tokens), else
    causal."""
    if kind:
        return "sliding", cfg.sliding_window, 0
    if cfg.prefix_bidirectional and cfg.prefix_len:
        return "prefix", 0, cfg.prefix_len
    return "causal", 0, 0


def _attn_apply(p, x, cfg: ArchConfig, rope, kind: int, *,
                train: bool = False):
    """Attention over the whole prompt x (B, S, d): the flash kernel where
    the reference's ``try_flash_attention`` would take its Pallas kernel
    (a causal mask, no soft-cap), else the general masked attention. The
    training forward (``train``) takes the masked attention on every layer,
    as the reference trains through its XLA attention: the flash kernel
    has no backward. Returns the block output and this layer's (k, v)
    (B, S, Hkv, dh), k rotated."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    q, k, v = _project_qkv(p, x, cfg, rope)
    mask, window, prefix_len = _prompt_mask(cfg, kind)
    if mask == "causal" and not cfg.logit_softcap and not train:
        out = cm.per_shard(flash.flash_attention, q, k, v, causal=True,
                           scale=1.0 / math.sqrt(hd))
    else:
        out = cm.attention(q, k, v, mask_kind=mask, window=window,
                           prefix_len=prefix_len, softcap=cfg.logit_softcap,
                           scale=1.0 / math.sqrt(hd))
    return cm.dense(p["wo"], out.reshape(B, S, H * hd)), (k, v)


def _block(lp, x, cfg: ArchConfig, rope, positions, opts: RuntimeOptions,
           kind: int, aux=None, *, train: bool = False):
    x = cm.constrain(x, opts.residual_sharding)
    lp = cm.constrain_tree(lp, opts.zero3_gather)
    xn = cm.rms_norm(x, lp["ln1"])
    if cfg.mla is not None:
        h, kv = mla_mod.mla_prefill_attn(lp["attn"], xn, cfg, positions)
    else:
        h, kv = _attn_apply(lp["attn"], xn, cfg, rope, kind, train=train)
    x = x + h
    return x + _ffn_apply(lp, cm.rms_norm(x, lp["ln2"]), cfg, opts, aux), kv


def _hidden(cfg: ArchConfig, params, tokens, opts: RuntimeOptions,
            prefix_emb=None, on_kv=None):
    """The final residual stream (B, P + S, d) of a full-prompt forward
    (``prefix_emb`` (B, P, d) prepended). Each layer's cache entry ((k, v),
    or an MLA layer's (c, k_rope)) goes to ``on_kv(i, a, b)`` as the layer
    finishes, so no more than one layer's KV is held beside the cache."""
    reason = static_supported(cfg)
    if reason:
        raise NotImplementedError(reason)
    x = _embed_tokens(cfg, params, tokens, prefix_emb)
    _refuse_width(cfg, "prefill", x.device)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    rope = (cm.rope_cos_sin(positions, cfg.head_dim) if cfg.mla is None
            else None)
    for i, (lp, _, kind) in enumerate(_layers(cfg, params)):
        x, (a, b) = _block(lp, x, cfg, rope, positions, opts, kind)
        if on_kv is not None:
            on_kv(i, a, b)
    return x


def _train_hidden(cfg: ArchConfig, params, tokens, opts: RuntimeOptions,
                  prefix_emb=None):
    """The training forward: (final residual stream normed (B, P + S, d),
    aux {"load_balance", "router_z"} summed over the MoE layers). Every
    prompt attention takes ``common.attention`` (``_attn_apply(train=
    True)``) on any device, and no tensor autograd saved is written in
    place. With ``opts.remat == "block"`` each layer of the stack runs
    under ``torch.utils.checkpoint`` (its activations recomputed in the
    backward pass), as the reference rematerializes its scanned stack and
    not the unstacked prefix layers."""
    reason = static_supported(cfg)
    if reason:
        raise NotImplementedError(reason)
    x = _embed_tokens(cfg, params, tokens, prefix_emb)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    rope = (cm.rope_cos_sin(positions, cfg.head_dim) if cfg.mla is None
            else None)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    aux = {"load_balance": zero, "router_z": zero}
    n_pre = len(params.get("head_layers", []))
    params = dict(params, stack=unstack(params["stack"]))

    def block(lp, x, kind):
        a = {"load_balance": zero, "router_z": zero}
        x, _ = _block(lp, x, cfg, rope, positions, opts, kind, a, train=True)
        return x, a
    for i, (lp, _, kind) in enumerate(_layers(cfg, params)):
        if i >= n_pre:
            x, a = remat(opts, block, lp, x, kind)
        else:
            x, a = block(lp, x, kind)
        aux = {name: aux[name] + a[name] for name in aux}
    return cm.rms_norm(x, params["final_norm"]), aux


def remat(opts: RuntimeOptions, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` (non-reentrant) when
    ``opts.remat == "block"``."""
    if opts.remat == "block":
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    if opts.remat != "none":
        raise ValueError(f"remat must be 'none' or 'block', got "
                         f"{opts.remat!r}")
    return fn(*args)


def train_loss(cfg: ArchConfig, params, batch, opts: RuntimeOptions =
               RuntimeOptions()):
    """batch: {"tokens": (B, S), "labels": (B, S)} (+ "prefix_emb" (B, P,
    d) for a VLM). Next-token cross-entropy over the text positions by
    ``common.chunked_xent`` (the (B, S, vocab) logits never exist), plus
    ``0.01 * load_balance + 1e-4 * router_z`` for an MoE stack. Returns
    (total, {"nll", "load_balance", "router_z"}), f32 scalars that autograd
    differentiates."""
    h, aux = _train_hidden(cfg, params, batch["tokens"], opts,
                           batch.get("prefix_emb"))
    labels = batch["labels"]
    pfx = (batch["prefix_emb"].shape[1]
           if batch.get("prefix_emb") is not None else 0)
    S = labels.shape[1]
    h_pred = h[:, pfx:pfx + S - 1]
    if cfg.tie_embeddings:
        loss = cm.chunked_xent(h_pred, params["embed"]["emb"],
                               labels[:, 1:], tied=True)
    else:
        loss = cm.chunked_xent(h_pred, params["lm_head"]["w"],
                               labels[:, 1:], tied=False)
    total = loss
    if cfg.moe is not None:
        total = total + 0.01 * aux["load_balance"] + 1e-4 * aux["router_z"]
    return total, {"nll": loss, **aux}


def forward(cfg: ArchConfig, params, tokens,
            opts: RuntimeOptions = RuntimeOptions(), prefix_emb=None, *,
            collect_kv: bool = False):
    """Full-sequence forward. tokens: (B, S) int32; prefix_emb: (B, P, d)
    stub frontend output (VLM patches), prepended, or None. Returns logits
    (B, P + S, vocab), or (logits, kvs) with ``collect_kv``: one pair a
    layer in order, (k, v) of (B, P + S, Hkv, dh) with k rotated, or an
    MLA layer's (c, k_rope) (the reference returns the prefix layers'
    pairs in a list and the stack's stacked on a leading layer axis)."""
    kvs = []
    x = _hidden(cfg, params, tokens, opts, prefix_emb,
                (lambda i, k, v: kvs.append((k, v))) if collect_kv else None)
    logits = _logits(cfg, params, x)
    return (logits, kvs) if collect_kv else logits


def _layer_cache(cfg: ArchConfig, opts: RuntimeOptions, batch: int,
                 max_len: int, device, n_layers=None):
    """One layer's dense cache, or with ``n_layers`` the stack's, on a
    leading layer axis: MLA's latent in the activation dtype (int8 does not
    apply: the latent is the compressed cache), else k and v (B, Lmax, Hkv,
    dh) in ``cache_dtype`` with per-kv-head f32 scales for int8."""
    if cfg.mla is not None:
        return mla_mod.init_mla_cache(cfg, batch, max_len, opts.tdtype,
                                      device, n_layers)
    lead = () if n_layers is None else (n_layers,)
    quant = opts.cache_dtype == "int8"
    dtype = torch_dtype(opts.cache_dtype or opts.dtype)
    shape = (*lead, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    c = {"k": torch.zeros(shape, dtype=dtype, device=device),
         "v": torch.zeros(shape, dtype=dtype, device=device)}
    if quant:
        for name in ("k_scale", "v_scale"):
            c[name] = torch.ones((*lead, cfg.n_kv_heads),
                                 dtype=torch.float32, device=device)
    return c


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               opts: RuntimeOptions = RuntimeOptions(), device="cuda"):
    """Dense KV cache: ``{"stack": ...}`` with (n_stacked, batch, max_len,
    Hkv, dh) per k/v, and ``"head"``, one layer's cache per unstacked
    prefix layer, where the config has them. MLA layers cache the latent
    ((.., batch, max_len, kv_lora_rank) and the rope key).

    ``opts.cache_dtype='int8'`` stores int8 with per-(layer, kv-head) f32
    scales, which each prefill sets afresh from its prompt (not for MLA,
    as in the reference)."""
    reason = static_supported(cfg)
    if reason:
        raise NotImplementedError(f"dense KV cache: {reason}")
    device = resolve_device(device)
    _refuse_width(cfg, "static", device)
    n_pre, _ = _layer_split(cfg)
    cache = {"stack": _layer_cache(cfg, opts, batch, max_len, device,
                                   cfg.n_layers - n_pre)}
    if n_pre:
        cache["head"] = [_layer_cache(cfg, opts, batch, max_len, device)
                         for _ in range(n_pre)]
    return cache


def prefill(cfg: ArchConfig, params, tokens, cache,
            opts: RuntimeOptions = RuntimeOptions(), prefix_emb=None):
    """Run the prompt (B, S) after ``prefix_emb`` (B, P, d) when given,
    write each layer's KV at positions [0, P + S) of the dense cache in
    place as the layer finishes (int8: quantized with fresh per-layer
    scales from this prompt; MLA: the latent and rope key), and return
    (last-position logits (B, vocab), cache)."""
    layer_caches = [cl for _, cl, _ in _layers(cfg, params, cache)]

    def write(i, k, v):
        cl = layer_caches[i]
        if "c" in cl:
            S = k.shape[1]
            cl["c"][:, :S] = k.to(cl["c"].dtype)
            cl["k_rope"][:, :S] = v.to(cl["k_rope"].dtype)
            return
        if "k_scale" in cl:
            ksc, vsc = _amax_scale(k, (0, 1, 3)), _amax_scale(v, (0, 1, 3))
            cl["k_scale"].copy_(ksc)
            cl["v_scale"].copy_(vsc)
            k, v = _quantize_with(k, ksc), _quantize_with(v, vsc)
        cm.update_cache(cl["k"], cl["v"], k, v, 0)
    x = _hidden(cfg, params, tokens, opts, prefix_emb, write)
    return _logits(cfg, params, x[:, -1]), cache


def _decode_attn(p, x, cfg: ArchConfig, opts: RuntimeOptions, cache_layer,
                 pos, rope, kv_valid, kind: int):
    """Single-token attention against the dense cache. x: (B, 1, d). The
    new KV lands at ``pos`` (a host int or a device int tensor) first (int8: quantized with the prefill's
    scales). A layer with neither a window nor a soft-cap takes the dense
    decode kernel, which reads positions < kv_valid (= pos + 1) and
    dequantizes int8 itself; a sliding or soft-capped layer takes the
    general masked attention at q_offset = pos over the cache dequantized
    in q's dtype, as the reference attends every layer.

    With ``opts.seq_shard_attn`` and a native cache, the reference's
    branch: the cache is LENGTH-sharded (this rank's contiguous range) and
    ``seq_shard_attn.decode_attn_seq_sharded`` writes the new KV on the
    rank in range and attends across the ranks; no kernel runs."""
    B = x.shape[0]
    H, hd = cfg.n_heads, cfg.head_dim
    q, k, v = _project_qkv(p, x, cfg, rope)
    window = cfg.sliding_window if kind else 0
    if opts.seq_shard_attn and "k_scale" not in cache_layer:
        from repro_torch.models.seq_shard_attn import decode_attn_seq_sharded
        out, _, _ = decode_attn_seq_sharded(
            q, k, v, cache_layer["k"], cache_layer["v"], pos,
            opts.seq_shard_mesh, scale=hd ** -0.5, softcap=cfg.logit_softcap,
            window=window)
        return cm.dense(p["wo"], out.reshape(B, 1, H * hd))
    ksc = vsc = None
    if "k_scale" in cache_layer:
        ksc, vsc = cache_layer["k_scale"], cache_layer["v_scale"]
        k, v = _quantize_with(k, ksc), _quantize_with(v, vsc)
    ck, cv = cm.update_cache(cache_layer["k"], cache_layer["v"], k, v, pos)
    if not window and not cfg.logit_softcap:
        out = kern.decode_attention(q[:, 0], ck, cv, kv_valid,
                                    scale=1.0 / math.sqrt(hd), k_scale=ksc,
                                    v_scale=vsc)
    else:
        ck, cv = ck.to(q.dtype), cv.to(q.dtype)
        if ksc is not None:
            ck = ck * ksc[None, None, :, None].to(q.dtype)
            cv = cv * vsc[None, None, :, None].to(q.dtype)
        out = cm.attention(q, ck, cv, mask_kind="sliding" if window
                           else "causal", window=window, q_offset=pos,
                           softcap=cfg.logit_softcap,
                           scale=1.0 / math.sqrt(hd))
    return cm.dense(p["wo"], out.reshape(B, 1, H * hd))


def _decode_block(lp, x, cfg: ArchConfig, cache_layer, pos, rope,
                  kv_valid, opts: RuntimeOptions, kind: int):
    x = cm.constrain(x, opts.residual_sharding)
    xn = cm.rms_norm(x, lp["ln1"])
    if cfg.mla is not None:
        x = x + mla_mod.mla_decode_attn(lp["attn"], xn, cfg, cache_layer,
                                        pos)
    else:
        x = x + _decode_attn(lp["attn"], xn, cfg, opts, cache_layer, pos,
                             rope, kv_valid, kind)
    return x + _ffn_apply(lp, cm.rms_norm(x, lp["ln2"]), cfg, opts)


def decode_step(cfg: ArchConfig, params, token, pos, cache,
                opts: RuntimeOptions = RuntimeOptions()):
    """One new token for every sequence of a static wave. token: (B,)
    int32 (its KV lands at ``pos``, shared by the wave: a host int, or a
    0-d or (1,) int32 tensor on the device, the reference's traced
    position, which a captured step reads from its buffer). Returns
    (logits (B, vocab), cache) with the cache updated in place."""
    B = token.shape[0]
    x = _embed_tokens(cfg, params, token[:, None])
    rope = kv_valid = None
    if cfg.mla is None:
        positions = cm.decode_positions(pos, B, x.device)
        rope = cm.rope_cos_sin(positions, cfg.head_dim)
        kv_valid = positions[:, 0] + 1
    for lp, cl, kind in _layers(cfg, params, cache):
        x = _decode_block(lp, x, cfg, cl, pos, rope, kv_valid, opts, kind)
    return _logits(cfg, params, x)[:, 0], cache
