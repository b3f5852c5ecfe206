"""Whisper-style encoder-decoder in PyTorch (the reference is
``repro/models/whisper.py``; arXiv:2212.04356): pre-LN LayerNorm blocks,
GELU MLPs, biased projections (no bias on the keys), sinusoidal encoder
positions and learned decoder positions. The conv frontend is a stub: the
caller hands the encoder its frame embeddings as ``prefix_emb`` (B,
source_len, d).

Every attention runs through the masked attention (head width 64: not a
flash width in the reference either): the encoder's full mask over the
frames, the decoder's causal self-attention and its full cross-attention
over the encoder output. Prefill encodes once and computes each decoder
layer's cross KV once; a decode step reads them from the cache. An int8
KV cache is refused: the reference casts the unscaled KV to int8.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import common as cm
from repro_torch.models import moe as moe_mod
from repro_torch.models.lm import (RuntimeOptions, _layer, _stack,
                                   resolve_device, torch_dtype, unstack)
from repro_torch.models.zamba import INT8_REFUSED


def _init_attn(generator, cfg: ArchConfig, d: int, dtype, device):
    H, hd = cfg.n_heads, cfg.head_dim

    def lin(d_in, d_out, bias):
        return cm.dense_init(generator, d_in, d_out, dtype, device, bias=bias)
    return {"wq": lin(d, H * hd, True), "wk": lin(d, H * hd, False),
            "wv": lin(d, H * hd, True), "wo": lin(H * hd, d, True)}


def _ln_init(d: int, dtype, device):
    return {"w": torch.ones((d,), dtype=dtype, device=device),
            "b": torch.zeros((d,), dtype=dtype, device=device)}


def _init_enc_layer(generator, cfg: ArchConfig, dtype, device):
    d = cfg.d_model
    return {"ln1": _ln_init(d, dtype, device),
            "attn": _init_attn(generator, cfg, d, dtype, device),
            "ln2": _ln_init(d, dtype, device),
            "mlp": moe_mod.init_dense_ffn(generator, cfg, cfg.d_ff, dtype,
                                          device)}


def _init_dec_layer(generator, cfg: ArchConfig, dtype, device):
    d = cfg.d_model
    return {"ln1": _ln_init(d, dtype, device),
            "self": _init_attn(generator, cfg, d, dtype, device),
            "ln_x": _ln_init(d, dtype, device),
            "cross": _init_attn(generator, cfg, d, dtype, device),
            "ln2": _ln_init(d, dtype, device),
            "mlp": moe_mod.init_dense_ffn(generator, cfg, cfg.d_ff, dtype,
                                          device)}


def init_params(cfg: ArchConfig, generator: torch.Generator, dtype="bfloat16",
                device="cuda"):
    device = resolve_device(device)
    dtype = torch_dtype(dtype)
    d = cfg.d_model
    emb = cm.embed_init(generator, cfg.vocab, d, dtype, device)
    pos_dec = torch.randn((cfg.max_context, d), generator=generator,
                          dtype=torch.float32, device=generator.device) * 0.01
    return {
        "embed": emb,
        "pos_dec": pos_dec.to(device=device, dtype=dtype),
        "enc_stack": _stack([_init_enc_layer(generator, cfg, dtype, device)
                             for _ in range(cfg.enc_layers)]),
        "dec_stack": _stack([_init_dec_layer(generator, cfg, dtype, device)
                             for _ in range(cfg.n_layers)]),
        "ln_enc": _ln_init(d, dtype, device),
        "ln_dec": _ln_init(d, dtype, device),
    }


def _ln(x, p):
    return cm.layer_norm(x, p["w"], p["b"])


def _kv(p, xkv, cfg: ArchConfig):
    B = xkv.shape[0]
    H, hd = cfg.n_heads, cfg.head_dim
    return (cm.dense(p["wk"], xkv).reshape(B, -1, H, hd),
            cm.dense(p["wv"], xkv).reshape(B, -1, H, hd))


def _mha(p, xq, cfg: ArchConfig, k, v, *, mask_kind: str, q_offset: int = 0):
    """Attention of xq's queries over k, v (B, L, H, hd) -> (B, S, d)."""
    B, S, _ = xq.shape
    H, hd = cfg.n_heads, cfg.head_dim
    q = cm.dense(p["wq"], xq).reshape(B, S, H, hd)
    out = cm.attention(q, k.to(q.dtype), v.to(q.dtype), mask_kind=mask_kind,
                       q_offset=q_offset)
    return cm.dense(p["wo"], out.reshape(B, S, H * hd))


def _frames(prefix_emb):
    if prefix_emb is None:
        raise ValueError("an encoder-decoder needs its frame embeddings: "
                         "pass prefix_emb (B, source_len, d_model)")
    return prefix_emb


def encode(cfg: ArchConfig, params, frames, opts: RuntimeOptions):
    """frames: (B, source_len, d) stub embeddings -> the encoder output."""
    dt = opts.tdtype
    x = frames.to(params["pos_dec"].device, dt) + cm.sinusoid(
        frames.shape[1], cfg.d_model, params["pos_dec"].device).to(dt)[None]
    for i in range(cfg.enc_layers):
        lp = _layer(params["enc_stack"], i)
        x = cm.constrain(x, opts.residual_sharding)
        hn = _ln(x, lp["ln1"])
        x = x + _mha(lp["attn"], hn, cfg, *_kv(lp["attn"], hn, cfg),
                     mask_kind="full")
        x = x + moe_mod.dense_ffn(lp["mlp"], _ln(x, lp["ln2"]), False)
    return _ln(x, params["ln_enc"])


def _dec_layer(lp, x, cfg: ArchConfig, self_kv, cross_kv, *, q_offset=0):
    """One decoder layer over x, given its self-attention keys/values (the
    prompt's, or the cache) and cross keys/values."""
    hn = _ln(x, lp["ln1"])
    x = x + _mha(lp["self"], hn, cfg, *self_kv, mask_kind="causal",
                 q_offset=q_offset)
    x = x + _mha(lp["cross"], _ln(x, lp["ln_x"]), cfg, *cross_kv,
                 mask_kind="full")
    return x + moe_mod.dense_ffn(lp["mlp"], _ln(x, lp["ln2"]), False)


def _dec_forward(cfg: ArchConfig, params, tokens, enc_out, on_layer=None,
                 residual_sharding=None):
    """The decoder over the prompt (B, S): its final normed hidden state.
    ``on_layer(i, (k, v), (ck, cv))`` receives each layer's self and
    cross keys and values; ``residual_sharding`` constrains the stream
    at each layer (``RuntimeOptions.residual_sharding``)."""
    S = tokens.shape[1]
    x = params["embed"]["emb"][tokens.long()] + params["pos_dec"][None, :S]
    for i in range(cfg.n_layers):
        lp = _layer(params["dec_stack"], i)
        x = cm.constrain(x, residual_sharding)
        self_kv = _kv(lp["self"], _ln(x, lp["ln1"]), cfg)
        cross_kv = _kv(lp["cross"], enc_out, cfg)
        if on_layer is not None:
            on_layer(i, self_kv, cross_kv)
        x = _dec_layer(lp, x, cfg, self_kv, cross_kv)
    return _ln(x, params["ln_dec"])


def _logits(params, x):
    return x @ params["embed"]["emb"].T


def forward(cfg: ArchConfig, params, tokens,
            opts: RuntimeOptions = RuntimeOptions(), prefix_emb=None):
    """Decoder logits (B, S, vocab) over the encoded frames
    ``prefix_emb``."""
    enc_out = encode(cfg, params, _frames(prefix_emb), opts)
    return _logits(params, _dec_forward(
        cfg, params, tokens, enc_out,
        residual_sharding=opts.residual_sharding))


def train_loss(cfg: ArchConfig, params, batch,
               opts: RuntimeOptions = RuntimeOptions()):
    """Next-token cross-entropy of the decoder over batch {"tokens",
    "labels"} (B, S) given the frames ``batch["prefix_emb"]``, tied to the
    embedding: (loss, {"nll": loss}). No remat: the reference's Whisper
    has none."""
    params = dict(params, enc_stack=unstack(params["enc_stack"]),
                  dec_stack=unstack(params["dec_stack"]))
    enc_out = encode(cfg, params, _frames(batch.get("prefix_emb")), opts)
    h = _dec_forward(cfg, params, batch["tokens"], enc_out,
                     residual_sharding=opts.residual_sharding)
    loss = cm.chunked_xent(h[:, :-1], params["embed"]["emb"],
                           batch["labels"][:, 1:], tied=True)
    return loss, {"nll": loss}


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               opts: RuntimeOptions = RuntimeOptions(), device="cuda"):
    """{"self": {"k", "v"} (L, B, max_len, H, hd), "cross": {"k", "v"}
    (L, B, source_len, H, hd)} in ``cache_dtype`` (int8 refused)."""
    if opts.cache_dtype == "int8":
        raise NotImplementedError(INT8_REFUSED.format(
            family=cfg.family, where="src/repro/models/whisper.py:161"))
    device = resolve_device(device)
    dtype = torch_dtype(opts.cache_dtype or opts.dtype)
    H, hd, L = cfg.n_heads, cfg.head_dim, cfg.n_layers

    def kv(n):
        return {name: torch.zeros((L, batch, n, H, hd), dtype=dtype,
                                  device=device) for name in ("k", "v")}
    return {"self": kv(max_len), "cross": kv(cfg.source_len)}


def prefill(cfg: ArchConfig, params, tokens, cache,
            opts: RuntimeOptions = RuntimeOptions(), prefix_emb=None):
    """Encode the frames ``prefix_emb`` once, write the prompt's self KV
    (positions [0, S)) into ``cache`` in place, set its cross KV to every
    decoder layer's keys and values of the encoder output (as many as
    there are frames, as in the reference), and return (last-position
    logits, cache)."""
    enc_out = encode(cfg, params, _frames(prefix_emb), opts)
    cross = []

    def write(i, self_kv, cross_kv):
        cm.update_cache(cache["self"]["k"][i], cache["self"]["v"][i],
                        *self_kv, 0)
        cross.append(cross_kv)
    x = _dec_forward(cfg, params, tokens, enc_out, write,
                     opts.residual_sharding)
    dt = cache["cross"]["k"].dtype
    cache["cross"] = {name: torch.stack([kv[j] for kv in cross]).to(dt)
                      for j, name in enumerate(("k", "v"))}
    return _logits(params, x[:, -1]), cache


def decode_step(cfg: ArchConfig, params, token, pos: int, cache,
                opts: RuntimeOptions = RuntimeOptions()):
    """One token a sequence: its self KV lands at the host position
    ``pos``, where it reads its learned position too (clamped to the
    table, as the reference's ``dynamic_slice`` clamps). Returns (logits
    (B, vocab), cache updated in place)."""
    pos_dec = params["pos_dec"]
    x = (params["embed"]["emb"][token.long()][:, None, :]
         + pos_dec[min(max(pos, 0), pos_dec.shape[0] - 1)][None, None])
    for i in range(cfg.n_layers):
        lp = _layer(params["dec_stack"], i)
        x = cm.constrain(x, opts.residual_sharding)
        k, v = _kv(lp["self"], _ln(x, lp["ln1"]), cfg)
        ck, cv = cm.update_cache(cache["self"]["k"][i], cache["self"]["v"][i],
                                 k, v, pos)
        x = _dec_layer(lp, x, cfg, (ck, cv),
                       (cache["cross"]["k"][i], cache["cross"]["v"][i]),
                       q_offset=pos)
    return _logits(params, _ln(x, params["ln_dec"]))[:, 0], cache
