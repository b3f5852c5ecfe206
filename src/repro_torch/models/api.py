"""Uniform model API of the port: dispatch on ``ArchConfig.family`` and
the fused K-step decode over the dense cache (the reference is
``repro/models/api.py``).

The dense, mixture-of-experts and VLM decoder families run
(``models/lm.py``; a VLM is its decoder with a stub frontend's
``prefix_emb`` prepended, on the static engine); ``module_for`` raises
for the others, naming the ROADMAP.md item that will port them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm
from repro_torch.models import sampling
from repro_torch.models.lm import RuntimeOptions

_MODS = {"dense": lm, "moe": lm, "vlm": lm}


def module_for(cfg: ArchConfig):
    mod = _MODS.get(cfg.family)
    if mod is None:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md queue A, "
            f"item 10)")
    return mod


def forward(cfg: ArchConfig, params, tokens,
            opts: RuntimeOptions = RuntimeOptions(), prefix_emb=None, *,
            collect_kv: bool = False):
    """Full-sequence forward of ``cfg``'s family; ``prefix_emb`` (B, P, d),
    a stub frontend's output (VLM patches), is prepended to the token
    embeddings."""
    return module_for(cfg).forward(cfg, params, tokens, opts, prefix_emb,
                                   collect_kv=collect_kv)


def prefill(cfg: ArchConfig, params, tokens, cache,
            opts: RuntimeOptions = RuntimeOptions(), prefix_emb=None):
    """Run the prompt (after ``prefix_emb`` when given), fill the dense
    cache and return (last-position logits, cache)."""
    return module_for(cfg).prefill(cfg, params, tokens, cache, opts,
                                   prefix_emb=prefix_emb)


def decode_steps(cfg: ArchConfig, params, token, pos: int, cache,
                 n_steps: int, opts: RuntimeOptions = RuntimeOptions(), *,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
                 keys: Optional[torch.Tensor] = None):
    """Fused K-step decode over the dense cache.

    Runs ``module_for(cfg).decode_step`` ``n_steps`` times with the token
    chosen on the device between steps and no host sync inside, so the
    host pulls one (B, n_steps) token block instead of one token a step.
    token: (B,) int32 last chosen token; pos: host int, the position its
    KV lands at (micro-step j writes at pos + j). Greedy at temperature 0;
    otherwise temperature/top-k/top-p sampling with per-slot keys ``keys``
    ((B, 2) int64 from ``sampling.request_keys`` at the block's first
    token index; micro-step j draws the noise of token index + j). Returns
    ((B, n_steps) int32 tokens, cache), the cache updated in place."""
    mod = module_for(cfg)
    stochastic = temperature > 0.0
    if stochastic and keys is None:
        raise ValueError("stochastic fused decode needs per-slot keys "
                         "(keys=(B, 2) int64 from sampling.request_keys)")
    tok = token.to(torch.int32)
    cols = []
    for j in range(n_steps):
        logits, cache = mod.decode_step(cfg, params, tok, pos + j, cache,
                                        opts)
        if stochastic:
            noise = sampling.gumbel(sampling.advance(keys, j),
                                    logits.shape[-1])
            tok = sampling.sample(logits, noise, temperature=temperature,
                                  top_k=top_k, top_p=top_p)
        else:
            tok = sampling.sample_greedy(logits)
        cols.append(tok)
    return torch.stack(cols, dim=1), cache
