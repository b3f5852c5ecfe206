"""Pure Mamba-2 LM (mamba2-130m) in PyTorch: an attention-free backbone
with an O(1) decode state (the reference is ``repro/models/mamba_lm.py``).

There is no KV cache: the static engine's cache is ``{"ssm_states":
{"conv", "ssm"}}``, one state a layer on a leading layer axis, its size
independent of the sequence length, and ``cache_dtype`` does not apply
(the reference ignores it too). The model has no paged path. Training
(``train_loss``) runs the prompt path, which writes nothing in place.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import common as cm
from repro_torch.models import ssd
from repro_torch.models.lm import (RuntimeOptions, _layer, _stack, remat,
                                   resolve_device, torch_dtype, unstack)


def init_params(cfg: ArchConfig, generator: torch.Generator, dtype="bfloat16",
                device="cuda"):
    device = resolve_device(device)
    dtype = torch_dtype(dtype)
    return {"embed": cm.embed_init(generator, cfg.vocab, cfg.d_model, dtype,
                                   device),
            "stack": _stack([ssd.init_mamba(generator, cfg, dtype, device)
                             for _ in range(cfg.n_layers)]),
            "final_norm": torch.zeros((cfg.d_model,), dtype=dtype,
                                      device=device)}


def _logits(params, x):
    return cm.rms_norm(x, params["final_norm"]) @ params["embed"]["emb"].T


def _run(cfg: ArchConfig, params, tokens, opts: RuntimeOptions):
    """The final residual stream (B, S, d), each layer under ``lm.remat``
    (``opts.remat == "block"``: recomputed in the backward pass)."""
    x = params["embed"]["emb"][tokens.long()]

    def body(lp, h):
        h = cm.constrain(h, opts.residual_sharding)
        return h + ssd.mamba_forward(lp, h, cfg)
    for i in range(cfg.n_layers):
        x = remat(opts, body, _layer(params["stack"], i), x)
    return x


def forward(cfg: ArchConfig, params, tokens,
            opts: RuntimeOptions = RuntimeOptions(), prefix_emb=None):
    """Full-sequence logits (B, S, vocab); ``prefix_emb`` is ignored, as
    in the reference."""
    return _logits(params, _run(cfg, params, tokens, opts))


def train_loss(cfg: ArchConfig, params, batch,
               opts: RuntimeOptions = RuntimeOptions()):
    """Next-token cross-entropy of batch {"tokens", "labels"} (B, S), tied
    to the embedding: (loss, {"nll": loss})."""
    params = dict(params, stack=unstack(params["stack"]))
    h = cm.rms_norm(_run(cfg, params, batch["tokens"], opts),
                    params["final_norm"])
    loss = cm.chunked_xent(h[:, :-1], params["embed"]["emb"],
                           batch["labels"][:, 1:], tied=True)
    return loss, {"nll": loss}


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               opts: RuntimeOptions = RuntimeOptions(), device="cuda"):
    """The decode states of every layer; ``max_len`` does not size them."""
    return {"ssm_states": ssd.init_mamba_state(
        cfg, batch, opts.tdtype, resolve_device(device), (cfg.n_layers,))}


def prefill(cfg: ArchConfig, params, tokens, cache,
            opts: RuntimeOptions = RuntimeOptions(), prefix_emb=None):
    """Run the prompt, write every layer's state after its last position
    into ``cache`` in place, and return (last-position logits, cache)."""
    x = params["embed"]["emb"][tokens.long()]
    st = cache["ssm_states"]
    for i in range(cfg.n_layers):
        x = cm.constrain(x, opts.residual_sharding)
        y, state = ssd.mamba_forward(_layer(params["stack"], i), x, cfg,
                                     return_state=True)
        x = x + y
        for name, val in state.items():
            st[name][i].copy_(val)
    return _logits(params, x[:, -1]), cache


def decode_step(cfg: ArchConfig, params, token, pos: int, cache,
                opts: RuntimeOptions = RuntimeOptions()):
    """One token a sequence; ``pos`` is unused (the state carries the
    position). Returns (logits (B, vocab), cache advanced in place)."""
    x = params["embed"]["emb"][token.long()]
    for i in range(cfg.n_layers):
        x = cm.constrain(x, opts.residual_sharding)
        x = x + ssd.mamba_decode(_layer(params["stack"], i), x,
                                 _layer(cache["ssm_states"], i), cfg)
    return _logits(params, x), cache
