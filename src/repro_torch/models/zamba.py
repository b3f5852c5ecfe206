"""Zamba2-style hybrid in PyTorch: a Mamba-2 backbone and one SHARED
attention + MLP block applied after every ``attn_every`` backbone blocks
(arXiv:2411.15242; the reference is ``repro/models/zamba.py``).

The shared block sees ``concat(hidden, initial embedding)`` (width 2d),
attends with rope, causally, through the masked attention (its head width,
80 at zamba2-2.7b's size, is not a flash width in the reference either),
and returns to the backbone through a per-site projection. The backbone's
weights and states keep the reference's (sites, per-site, ...) layout.
The static engine's cache holds every block's Mamba state and each site's
dense KV. Training (``train_loss``) runs the cache-free prompt path. An
int8 KV cache is refused: the reference casts the unscaled KV to int8.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import common as cm
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssd
from repro_torch.models.lm import (RuntimeOptions, _embed_tokens, _layer,
                                   _stack, remat, resolve_device,
                                   torch_dtype, unstack)

INT8_REFUSED = (
    "an int8 KV cache for {family!r}: the reference casts its unscaled KV "
    "to int8 ({where}), which truncates it; ROADMAP.md queue C records the "
    "fault")


def _layout(cfg: ArchConfig):
    """(sites, backbone blocks a site)."""
    per = cfg.attn_every or cfg.n_layers
    return cfg.n_layers // per, per


def _sites(tree, n_sites: int, per: int):
    """(n_sites * per, ...) leaves -> (n_sites, per, ...)."""
    if isinstance(tree, dict):
        return {k: _sites(v, n_sites, per) for k, v in tree.items()}
    return tree.reshape(n_sites, per, *tree.shape[1:])


def init_params(cfg: ArchConfig, generator: torch.Generator, dtype="bfloat16",
                device="cuda"):
    device = resolve_device(device)
    dtype = torch_dtype(dtype)
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    n_sites, per = _layout(cfg)

    def lin(d_in, d_out):
        return cm.dense_init(generator, d_in, d_out, dtype, device)
    mamba = _sites(_stack([ssd.init_mamba(generator, cfg, dtype, device)
                           for _ in range(cfg.n_layers)]), n_sites, per)
    shared = {
        "ln1": torch.zeros((2 * d,), dtype=dtype, device=device),
        "wq": lin(2 * d, H * hd), "wk": lin(2 * d, H * hd),
        "wv": lin(2 * d, H * hd), "wo": lin(H * hd, H * hd),
        "ln2": torch.zeros((H * hd,), dtype=dtype, device=device),
        "mlp": moe_mod.init_dense_ffn(generator, cfg.replace(d_model=H * hd),
                                      cfg.d_ff, dtype, device),
    }
    site_proj = _stack([lin(H * hd, d) for _ in range(n_sites)])
    return {"embed": cm.embed_init(generator, cfg.vocab, d, dtype, device),
            "mamba": mamba, "shared": shared, "site_proj": site_proj,
            "final_norm": torch.zeros((d,), dtype=dtype, device=device)}


def _shared_block(sp, x, emb0, cfg: ArchConfig, positions, cache=None,
                  pos=0):
    """x, emb0: (B, S, d) -> (delta (B, S, H*hd), (k, v)). With ``cache``
    (one site's {"k", "v"} (B, Lmax, H, hd)) the new KV lands at ``pos``
    (a host int or a 0-d or (1,) int32 device tensor) in place and the
    query attends the cache at q_offset ``pos``."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    u = cm.rms_norm(torch.cat([x, emb0], dim=-1), sp["ln1"])
    q = cm.apply_rope(cm.dense(sp["wq"], u).reshape(B, S, H, hd), positions)
    k = cm.apply_rope(cm.dense(sp["wk"], u).reshape(B, S, H, hd), positions)
    v = cm.dense(sp["wv"], u).reshape(B, S, H, hd)
    if cache is None:
        out = cm.attention(q, k, v, mask_kind="causal")
    else:
        ck, cv = cm.update_cache(cache["k"], cache["v"], k, v, pos)
        out = cm.attention(q, ck.to(q.dtype), cv.to(q.dtype),
                           mask_kind="causal", q_offset=pos)
    h = cm.dense(sp["wo"], out.reshape(B, S, H * hd))
    h = h + moe_mod.dense_ffn(sp["mlp"], cm.rms_norm(h, sp["ln2"]),
                              cfg.gated_mlp)
    return h, (k, v)


def _run(cfg: ArchConfig, params, tokens, cache=None,
         opts: RuntimeOptions = RuntimeOptions()):
    """The prompt's final residual stream (B, S, d); with ``cache`` each
    block's decode state and each site's KV land in it in place. Without
    one (forward, training) nothing is written in place, and with
    ``opts.remat == "block"`` each site (its backbone blocks, the shared
    block and its projection) runs under ``lm.remat``, as the reference
    rematerializes its site body."""
    x = _embed_tokens(cfg, params, tokens)
    emb0 = x
    B, S = tokens.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    n_sites, per = _layout(cfg)

    def site_body(s, x):
        x = cm.constrain(x, opts.residual_sharding)
        site = _layer(params["mamba"], s)
        for j in range(per):
            x = x + ssd.mamba_forward(_layer(site, j), x, cfg)
        delta, _ = _shared_block(params["shared"], x, emb0, cfg, positions)
        return x + cm.dense(_layer(params["site_proj"], s), delta)
    for s in range(n_sites):
        if cache is None:
            x = remat(opts, site_body, s, x)
            continue
        x = cm.constrain(x, opts.residual_sharding)
        site = _layer(params["mamba"], s)
        for j in range(per):
            y, state = ssd.mamba_forward(_layer(site, j), x, cfg,
                                         return_state=True)
            x = x + y
            for name, val in state.items():
                cache["mamba"][name][s, j].copy_(val)
        delta, (k, v) = _shared_block(params["shared"], x, emb0, cfg,
                                      positions)
        cm.update_cache(cache["attn"]["k"][s], cache["attn"]["v"][s], k, v, 0)
        x = x + cm.dense(_layer(params["site_proj"], s), delta)
    return x


def _logits(params, x):
    return cm.rms_norm(x, params["final_norm"]) @ params["embed"]["emb"].T


def forward(cfg: ArchConfig, params, tokens,
            opts: RuntimeOptions = RuntimeOptions(), prefix_emb=None):
    """Full-sequence logits (B, S, vocab); ``prefix_emb`` is ignored, as
    in the reference."""
    return _logits(params, _run(cfg, params, tokens, opts=opts))


def train_loss(cfg: ArchConfig, params, batch,
               opts: RuntimeOptions = RuntimeOptions()):
    """Next-token cross-entropy of batch {"tokens", "labels"} (B, S), tied
    to the embedding: (loss, {"nll": loss})."""
    params = dict(params, mamba=unstack(params["mamba"], 2),
                  site_proj=unstack(params["site_proj"]))
    h = cm.rms_norm(_run(cfg, params, batch["tokens"], opts=opts),
                    params["final_norm"])
    loss = cm.chunked_xent(h[:, :-1], params["embed"]["emb"],
                           batch["labels"][:, 1:], tied=True)
    return loss, {"nll": loss}


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               opts: RuntimeOptions = RuntimeOptions(), device="cuda"):
    """{"mamba": every block's state on (sites, per) axes, "attn": {"k",
    "v"} (sites, B, max_len, H, hd)} in ``cache_dtype`` (int8 refused)."""
    if opts.cache_dtype == "int8":
        raise NotImplementedError(INT8_REFUSED.format(
            family=cfg.family, where="src/repro/models/zamba.py:123"))
    device = resolve_device(device)
    n_sites, per = _layout(cfg)
    dtype = torch_dtype(opts.cache_dtype or opts.dtype)
    shape = (n_sites, batch, max_len, cfg.n_heads, cfg.head_dim)
    return {"mamba": ssd.init_mamba_state(cfg, batch, opts.tdtype, device,
                                          (n_sites, per)),
            "attn": {"k": torch.zeros(shape, dtype=dtype, device=device),
                     "v": torch.zeros(shape, dtype=dtype, device=device)}}


def prefill(cfg: ArchConfig, params, tokens, cache,
            opts: RuntimeOptions = RuntimeOptions(), prefix_emb=None):
    """Run the prompt, fill ``cache`` in place (states after the last
    position, each site's KV at [0, S)), return (last logits, cache)."""
    x = _run(cfg, params, tokens, cache)
    return _logits(params, x[:, -1]), cache


def decode_step(cfg: ArchConfig, params, token, pos, cache,
                opts: RuntimeOptions = RuntimeOptions()):
    """One token a sequence at ``pos``, a host int or a 0-d or (1,) int32
    tensor on the device. Returns (logits (B, vocab), cache advanced in
    place)."""
    B = token.shape[0]
    x = _embed_tokens(cfg, params, token[:, None])
    emb0 = x
    positions = cm.decode_positions(pos, B, x.device)
    n_sites, per = _layout(cfg)
    for s in range(n_sites):
        x = cm.constrain(x, opts.residual_sharding)
        site, states = _layer(params["mamba"], s), _layer(cache["mamba"], s)
        for j in range(per):
            y = ssd.mamba_decode(_layer(site, j), x[:, 0], _layer(states, j),
                                 cfg)
            x = x + y[:, None]
        delta, _ = _shared_block(params["shared"], x, emb0, cfg, positions,
                                 _layer(cache["attn"], s), pos)
        x = x + cm.dense(_layer(params["site_proj"], s), delta)
    return _logits(params, x)[:, 0], cache
