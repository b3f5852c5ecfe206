"""Uniform model API of the port: dispatch on ``ArchConfig.family`` and
the fused K-step decode over the dense cache (the reference is
``repro/models/api.py``).

Families: dense | moe | vlm -> ``models/lm.py`` (MLA and DeepSeek-V2's
dense prefix layer included; a VLM is its decoder with a stub frontend's
``prefix_emb`` prepended); ssm -> ``models/mamba_lm.py``; hybrid ->
``models/zamba.py``; encdec -> ``models/whisper.py`` (``prefix_emb`` is
its frame embeddings). Every family runs on the static dense-cache path;
only ``lm``'s dense and MoE decoders have the paged path.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm, mamba_lm, sampling, whisper, zamba
from repro_torch.models.lm import RuntimeOptions

_MODS = {"dense": lm, "moe": lm, "vlm": lm, "ssm": mamba_lm,
         "hybrid": zamba, "encdec": whisper}


def module_for(cfg: ArchConfig):
    return _MODS[cfg.family]


def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype="bfloat16", device="cuda", experts: slice = None):
    """Random weights of ``cfg``'s family from ``generator``, in the
    reference's layout (to share the reference's weights, convert them
    with ``models.convert.params_from_numpy``). ``experts``: an MoE
    stack keeps only that slice of its experts (an expert-parallel
    rank's share)."""
    if experts is not None:
        return module_for(cfg).init_params(cfg, generator, dtype, device,
                                           experts=experts)
    return module_for(cfg).init_params(cfg, generator, dtype, device)


def static_supported(cfg: ArchConfig) -> Optional[str]:
    """None when the static dense-cache path runs ``cfg``; else why not."""
    fn = getattr(module_for(cfg), "static_supported", None)
    return fn(cfg) if fn is not None else None


def paged_supported(cfg: ArchConfig) -> Optional[str]:
    """None when the paged path runs ``cfg``; else the reference's
    reason."""
    mod = module_for(cfg)
    if not hasattr(mod, "paged_supported"):
        return f"family {cfg.family!r} has no paged serving path"
    return mod.paged_supported(cfg)


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               opts: RuntimeOptions = RuntimeOptions(), device="cuda"):
    """The family's static cache for ``batch`` sequences of up to
    ``max_len`` positions."""
    return module_for(cfg).init_cache(cfg, batch, max_len, opts, device)


def decode_step(cfg: ArchConfig, params, token, pos, cache,
                opts: RuntimeOptions = RuntimeOptions()):
    """One token a sequence at ``pos``: a host int, or a 0-d or (1,) int32
    tensor on the device (the reference's traced position; bitwise the
    int's result). Returns (logits, cache updated in place)."""
    return module_for(cfg).decode_step(cfg, params, token, pos, cache, opts)


def forward(cfg: ArchConfig, params, tokens,
            opts: RuntimeOptions = RuntimeOptions(), prefix_emb=None, *,
            collect_kv: bool = False):
    """Full-sequence logits of ``cfg``'s family; ``prefix_emb`` (B, P, d),
    a stub frontend's output, is prepended to a decoder's token
    embeddings (VLM patches) or encoded (Whisper's frames).
    ``collect_kv`` (decoder-only LMs) also returns each layer's KV."""
    if collect_kv:
        return module_for(cfg).forward(cfg, params, tokens, opts, prefix_emb,
                                       collect_kv=True)
    return module_for(cfg).forward(cfg, params, tokens, opts, prefix_emb)


def train_loss(cfg: ArchConfig, params, batch,
               opts: RuntimeOptions = RuntimeOptions()):
    """(loss, metrics) of ``cfg``'s family on batch {"tokens", "labels"}
    (+ "prefix_emb": VLM patches or Whisper's frames), for autograd."""
    return module_for(cfg).train_loss(cfg, params, batch, opts)


def kernel_width_reason(cfg: ArchConfig, path: str) -> Optional[str]:
    """Why ``path`` ("paged", "prefill", "decode" or "static") cannot run
    ``cfg`` on a CUDA device (a head width its kernels do not take), or
    None. Only the decoder-only LMs reach a kernel."""
    fn = getattr(module_for(cfg), "kernel_width_reason", None)
    return fn(cfg, path) if fn is not None else None


def prefill(cfg: ArchConfig, params, tokens, cache,
            opts: RuntimeOptions = RuntimeOptions(), prefix_emb=None):
    """Run the prompt (after ``prefix_emb`` when given, or over Whisper's
    encoded frames), fill the cache and return (last-position logits,
    cache)."""
    return module_for(cfg).prefill(cfg, params, tokens, cache, opts,
                                   prefix_emb=prefix_emb)


def decode_steps(cfg: ArchConfig, params, token, pos, cache,
                 n_steps: int, opts: RuntimeOptions = RuntimeOptions(), *,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
                 keys: Optional[torch.Tensor] = None):
    """Fused K-step decode over the dense cache.

    Runs ``module_for(cfg).decode_step`` ``n_steps`` times with the token
    chosen on the device between steps and no host sync inside, so the
    host pulls one (B, n_steps) token block instead of one token a step.
    token: (B,) int32 last chosen token; pos: the position its KV lands
    at, a host int or a 0-d or (1,) int32 tensor on the device (micro-step
    j writes at pos + j, on the device for a tensor, so a captured block
    reads its position from its buffer). Greedy at temperature 0;
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


# --------------------------- input specs ------------------------------- #

@dataclass(frozen=True)
class ShapeSpec:
    """One cell of the assigned (arch x shape) grid."""
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def cell_runnable(cfg: ArchConfig, shape: str) -> Optional[str]:
    """None if the (arch, shape) cell runs; else the skip reason."""
    if shape == "long_500k" and not cfg.has_subquadratic_context:
        return ("full-attention KV at 500k ctx (sub-quadratic required; "
                "see DESIGN.md SS5)")
    return None


def input_specs(cfg: ArchConfig, shape: str,
                opts: RuntimeOptions = RuntimeOptions()) -> Dict:
    """Shape and dtype stand-ins (``meta`` tensors) for every model input
    of the cell.

    train: {"tokens","labels"[, "prefix_emb"]}
    prefill: {"tokens"[, "prefix_emb"]}
    decode: {"token", "pos"} (the cache and params are built by the
    launcher)."""
    sp = SHAPES[shape]
    B = sp.global_batch
    dt = opts.tdtype
    i32 = torch.int32
    S = sp.seq_len

    def spec(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")
    if sp.kind in ("train", "prefill"):
        text_len = S - (cfg.prefix_len or 0) if cfg.family == "vlm" else S
        d = {"tokens": spec((B, text_len), i32)}
        if sp.kind == "train":
            d["labels"] = spec((B, text_len), i32)
        if cfg.family == "vlm":
            d["prefix_emb"] = spec((B, cfg.prefix_len, cfg.d_model), dt)
        if cfg.family == "encdec":
            d["prefix_emb"] = spec((B, cfg.source_len, cfg.d_model), dt)
        return d
    return {"token": spec((B,), i32), "pos": spec((), i32)}
