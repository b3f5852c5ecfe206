"""Decoder-only LM over the paged KV pool, in PyTorch: the continuous
engine's chunked prefill, fused K-step greedy decode and copy-on-write.

The reference is ``repro/models/lm.py`` (its paged subset). Parameters keep
its layout: ``params["stack"]`` carries a leading ``n_layers`` axis and the
layer loop indexes it. Unlike the reference, the KV pool is updated in
place: a prefill chunk or decode step writes its KV into the pool tensors it
was given (``index_copy_``) and returns the same cache dict.

Attention runs through ``kernels.decode_attention``: on a CUDA tensor the
hand-written kernels, on a CPU tensor their plain versions.

Public surface:
    init_params(cfg, generator, dtype, device)          -> params
    init_paged_cache(cfg, n_pages, page_size, opts, device) -> cache
    prefill_paged_chunk(cfg, params, tokens, cache, page_table, start,
                        n_valid, opts, calibrate=)      -> (logits, cache)
    decode_step_paged(cfg, params, token, seq_lens, page_table, cache, opts)
    decode_steps_paged(cfg, params, tokens, seq_lens, page_table, cache,
                       n_steps, opts, eos_id=, pad_id=, done=, quota=)
    copy_pages(cache, pairs)
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import decode_attention as kern
from repro_torch.models import common as cm
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
    cache_dtype: str = ""           # "" -> same as dtype; "int8" -> quantized

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

def _init_layer(generator, cfg: ArchConfig, dtype, device):
    H, Hkv, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    b = cfg.qkv_bias

    def lin(d_in, d_out, bias=False):
        return cm.dense_init(generator, d_in, d_out, dtype, device, bias=bias)
    return {
        "ln1": torch.zeros((d,), dtype=dtype, device=device),
        "ln2": torch.zeros((d,), dtype=dtype, device=device),
        "attn": {"wq": lin(d, H * hd, b), "wk": lin(d, Hkv * hd, b),
                 "wv": lin(d, Hkv * hd, b), "wo": lin(H * hd, d)},
        "mlp": moe_mod.init_dense_ffn(generator, cfg, cfg.d_ff, dtype, device),
    }


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_params(cfg: ArchConfig, generator: torch.Generator, dtype="bfloat16",
                device="cuda"):
    """Random weights from ``generator`` in the reference layout. The draws
    are PyTorch's, not JAX's: to share weights with the reference package,
    convert its params with ``models.convert.params_from_numpy``."""
    reason = paged_supported(cfg)
    if reason:
        raise NotImplementedError(reason)
    device = resolve_device(device)
    dtype = torch_dtype(dtype)
    emb = torch.randn((cfg.vocab, cfg.d_model), generator=generator,
                      dtype=torch.float32, device=generator.device) * 0.02
    params = {"embed": {"emb": emb.to(device=device, dtype=dtype)},
              "final_norm": torch.zeros((cfg.d_model,), dtype=dtype,
                                        device=device)}
    params["stack"] = _stack([_init_layer(generator, cfg, dtype, device)
                              for _ in range(cfg.n_layers)])
    if not cfg.tie_embeddings:
        params["lm_head"] = cm.dense_init(generator, cfg.d_model, cfg.vocab,
                                          dtype, device,
                                          scale=cfg.d_model ** -0.5)
    return params


def _layer(tree, i: int):
    """Layer ``i``'s slice (views) of a stacked param or cache tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ------------------------------- layers --------------------------------- #

def _ffn_apply(p, x, cfg: ArchConfig):
    return moe_mod.dense_ffn(p["mlp"], x, cfg.gated_mlp)


def _logits(cfg, params, x):
    x = cm.rms_norm(x, params["final_norm"])
    if cfg.tie_embeddings:
        return x @ params["embed"]["emb"].T
    return cm.dense(params["lm_head"], x)


def _embed_tokens(cfg, params, tokens):
    x = params["embed"]["emb"][tokens.long()]
    # gemma-style scale, rounded to the activation dtype first as the
    # reference does (a host scalar: no host-to-device copy per step)
    return x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype))


# ---------------------------- paged serving ----------------------------- #
# Page 0 of the pool is the null page: padded page-table entries and
# inactive or latched batch slots write and read it harmlessly (reads are
# masked by length, writes land on data nobody consumes).


def paged_supported(cfg: ArchConfig) -> Optional[str]:
    """None when this slice of the port runs ``cfg``; else why not, naming
    the ROADMAP.md item that will port it."""
    if cfg.mla is not None:
        return ("MLA latent caches are not ported yet (ROADMAP.md queue A, "
                "item 10)")
    if cfg.moe is not None or cfg.family == "moe":
        return "the MoE FFN is not ported yet (ROADMAP.md queue A, item 7)"
    if cfg.family != "dense":
        return (f"family {cfg.family!r} is not ported yet (ROADMAP.md queue "
                f"A, item 10)")
    if cfg.sliding_window:
        return ("sliding-window layers need windowed page masking, which the "
                "reference's paged path lacks too")
    if cfg.logit_softcap:
        return ("logit soft-capping is not in the paged kernels (ROADMAP.md "
                "queue A, item 10)")
    return None


def init_paged_cache(cfg: ArchConfig, n_pages: int, page_size: int,
                     opts: RuntimeOptions = RuntimeOptions(), device="cuda"):
    """Pooled KV pages: (n_layers, n_pages, page_size, Hkv, dh) per k/v.

    ``opts.cache_dtype='int8'`` stores int8 pages with per-(layer, kv-head)
    f32 scales, calibrated by the pool's first prefill chunk."""
    reason = paged_supported(cfg)
    if reason:
        raise NotImplementedError(f"paged KV cache: {reason}")
    device = resolve_device(device)
    quant = opts.cache_dtype == "int8"
    dtype = torch_dtype(opts.cache_dtype or opts.dtype)
    shape = (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    c = {"k": torch.zeros(shape, dtype=dtype, device=device),
         "v": torch.zeros(shape, dtype=dtype, device=device)}
    if quant:
        c["k_scale"] = torch.ones((cfg.n_layers, cfg.n_kv_heads),
                                  dtype=torch.float32, device=device)
        c["v_scale"] = torch.ones((cfg.n_layers, cfg.n_kv_heads),
                                  dtype=torch.float32, device=device)
    return {"stack": c}


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


def _write_kv(pool, flat, vals):
    """In-place scatter of ``vals`` (N, Hkv, dh) into pool rows ``flat``
    (N,) of the (P * ps, Hkv, dh) view — the reference's ``.at[].set``
    on a donated buffer. Duplicate indices only ever target the null
    page, which nobody reads unmasked."""
    P, ps = pool.shape[:2]
    pool.view(P * ps, *pool.shape[2:]).index_copy_(0, flat.long(), vals)


def _project_qkv(p, x, cfg: ArchConfig, rope):
    """q, k, v of x (B, S, d); ``rope`` is the step's (cos, sin)."""
    B, S, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = cm.dense(p["wq"], x).reshape(B, S, H, hd)
    k = cm.dense(p["wk"], x).reshape(B, S, Hkv, hd)
    v = cm.dense(p["wv"], x).reshape(B, S, Hkv, hd)
    return cm.rotate(q, *rope), cm.rotate(k, *rope), v


def _paged_chunk_attn(p, x, cfg: ArchConfig, cache_layer, positions, rope,
                      page_table, start, n_valid, *, calibrate: bool):
    """Chunk-prefill attention against pooled KV pages. x: (B, C, d).

    Scatters the chunk's KV into the pages covering ``positions`` first,
    then attends causally (by absolute position) across every page the
    sequence owns — previously cached prefix pages included."""
    B, C, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    q, k, v = _project_qkv(p, x, cfg, rope)
    quant = "k_scale" in cache_layer
    kp, vp = cache_layer["k"], cache_layer["v"]
    ps = kp.shape[1]
    n_pp = page_table.shape[1]

    if quant:
        if calibrate:
            # first chunk of the pool's life sets the frozen scales; keep
            # the chunk's right-padding out of them
            ok = (positions < n_valid[:, None])[..., None, None]
            cache_layer["k_scale"].copy_(
                _amax_scale(torch.where(ok, k, 0), (0, 1, 3)))
            cache_layer["v_scale"].copy_(
                _amax_scale(torch.where(ok, v, 0), (0, 1, 3)))
        ksc, vsc = cache_layer["k_scale"], cache_layer["v_scale"]
        k_store = _quantize_with(k, ksc[None, None]).to(torch.int8)
        v_store = _quantize_with(v, vsc[None, None]).to(torch.int8)
    else:
        ksc = vsc = None
        k_store, v_store = k.to(kp.dtype), v.to(vp.dtype)

    # scatter the chunk's KV at absolute positions [start, start + C); pad
    # positions past the table land on the null page (clipped explicitly:
    # a gather past the table's end must not read out of bounds)
    blk = positions // ps
    pid = torch.gather(page_table, 1, blk.clamp(max=n_pp - 1).long())
    pid = torch.where(blk < n_pp, pid, 0)                          # (B, C)
    flat = (pid * ps + positions % ps).reshape(-1)
    _write_kv(kp, flat, k_store.reshape(B * C, *k_store.shape[2:]))
    _write_kv(vp, flat, v_store.reshape(B * C, *v_store.shape[2:]))

    out = kern.chunk_prefill_attention(q, kp, vp, page_table, start, n_valid,
                                       scale=hd ** -0.5, k_scale=ksc,
                                       v_scale=vsc)
    return cm.dense(p["wo"], out.reshape(B, C, H * hd))


def prefill_paged_chunk(cfg: ArchConfig, params, tokens, cache, page_table,
                        start, n_valid, opts: RuntimeOptions = RuntimeOptions(),
                        *, calibrate: bool = False):
    """One fixed-size prefill chunk against the paged pool.

    tokens: (B, C) int32, right-padded; page_table: (B, n_pages_per_seq)
    int32; start: int absolute position of tokens[:, 0] (earlier positions
    already hold valid KV); n_valid: (B,) int32 total valid tokens once this
    chunk lands. ``calibrate=True`` (first chunk only) sets the int8 scales.
    Writes the chunk's KV into ``cache`` in place. Returns (logits
    (B, C, vocab), cache)."""
    B, C = tokens.shape
    x = _embed_tokens(cfg, params, tokens)
    start = int(start)
    positions = (start + torch.arange(C, dtype=torch.int32,
                                      device=x.device))[None].expand(B, C)
    # (B,) on the device once per chunk, not a host copy per layer
    start_b = torch.full((B,), start, dtype=torch.int32, device=x.device)
    rope = cm.rope_cos_sin(positions, cfg.head_dim)
    st = cache["stack"]
    for i in range(cfg.n_layers):
        lp, cl = _layer(params["stack"], i), _layer(st, i)
        x = x + _paged_chunk_attn(lp["attn"], cm.rms_norm(x, lp["ln1"]), cfg,
                                  cl, positions, rope, page_table, start_b,
                                  n_valid, calibrate=calibrate)
        x = x + _ffn_apply(lp, cm.rms_norm(x, lp["ln2"]), cfg)
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


def _paged_decode_attn(p, x, cfg: ArchConfig, cache_layer, seq_lens, rope,
                       page_table):
    """Single-token attention against pooled KV pages. x: (B, 1, d)."""
    B = x.shape[0]
    H, hd = cfg.n_heads, cfg.head_dim
    q, k, v = _project_qkv(p, x, cfg, rope)
    quant = "k_scale" in cache_layer
    kp, vp = cache_layer["k"], cache_layer["v"]
    ps = kp.shape[1]
    n_pp = page_table.shape[1]

    if quant:
        ksc, vsc = cache_layer["k_scale"], cache_layer["v_scale"]
        k_store = _quantize_with(k[:, 0], ksc[None]).to(torch.int8)
        v_store = _quantize_with(v[:, 0], vsc[None]).to(torch.int8)
    else:
        ksc = vsc = None
        k_store, v_store = k[:, 0].to(kp.dtype), v[:, 0].to(vp.dtype)

    # write the new token's KV at (page_table[b, len // ps], len % ps); the
    # flat index collapses to the null page for inactive slots (pt == 0)
    blk = (seq_lens // ps)[:, None]
    pid = torch.gather(page_table, 1, blk.clamp(max=n_pp - 1).long())[:, 0]
    pid = torch.where(blk[:, 0] < n_pp, pid, 0)
    flat = pid * ps + seq_lens % ps                                 # (B,)
    _write_kv(kp, flat, k_store)
    _write_kv(vp, flat, v_store)

    out = kern.paged_decode_attention(q[:, 0], kp, vp, page_table,
                                      seq_lens + 1, scale=hd ** -0.5,
                                      k_scale=ksc, v_scale=vsc)
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
    for i in range(cfg.n_layers):
        lp, cl = _layer(params["stack"], i), _layer(st, i)
        x = x + _paged_decode_attn(lp["attn"], cm.rms_norm(x, lp["ln1"]), cfg,
                                   cl, seq_lens, rope, page_table)
        x = x + _ffn_apply(lp, cm.rms_norm(x, lp["ln2"]), cfg)
    return _logits(cfg, params, x)[:, 0], cache


def decode_steps_paged(cfg: ArchConfig, params, tokens, seq_lens, page_table,
                       cache, n_steps: int,
                       opts: RuntimeOptions = RuntimeOptions(), *,
                       eos_id: Optional[int] = None, pad_id: int = 0,
                       done=None, quota=None):
    """Fused K-step greedy decode over the paged pool.

    ``n_steps`` micro-steps run as a Python loop of device work with no
    host sync inside: each step writes the carried token's KV at its slot's
    current length, attends, takes the argmax on device and advances
    per-slot lengths. Every KV position the loop writes must be page-backed
    up front (``PagedKVManager.reserve_ahead``).

    tokens: (B,) last sampled token per slot; seq_lens: (B,) tokens whose
    KV already landed; done: (B,) bool slots that start inactive; quota:
    (B,) int32 max tokens each slot may emit (default ``n_steps``). A slot
    latches done after emitting ``eos_id`` or exhausting its quota; latched
    slots emit ``pad_id``, stop advancing, and their page-table rows are
    masked to the null page. Returns ((B, n_steps) int32 tokens, cache)."""
    B = tokens.shape[0]
    dev = tokens.device
    dn = (torch.zeros((B,), dtype=torch.bool, device=dev) if done is None
          else done.to(dev, torch.bool))
    quota = (torch.full((B,), n_steps, dtype=torch.int32, device=dev)
             if quota is None else quota.to(dev, torch.int32))
    tok = tokens.to(torch.int32)
    lens = seq_lens.to(torch.int32)
    n_emit = torch.zeros((B,), dtype=torch.int32, device=dev)
    pad = torch.full((B,), pad_id, dtype=torch.int32, device=dev)
    cols = []
    for _ in range(n_steps):
        # latched slots write into (and read from) the null page only
        pt = torch.where(dn[:, None], 0, page_table)
        logits, cache = decode_step_paged(cfg, params, tok, lens, pt, cache,
                                          opts)
        nxt = torch.where(dn, pad, sampling_mod.sample_greedy(logits))
        n_emit = n_emit + (~dn).to(torch.int32)
        new_dn = dn | (n_emit >= quota)
        if eos_id is not None:
            new_dn = new_dn | (~dn & (nxt == eos_id))
        lens = torch.where(dn, lens, lens + 1)   # this step's write landed
        cols.append(nxt)
        tok, dn = nxt, new_dn
    return torch.stack(cols, dim=1), cache
