"""On-device token choice: greedy, temperature/top-k/top-p sampling and
speculative accept/reject (the reference is ``repro/models/sampling.py``).

Each random decision is split from its draws: ``sample`` takes the Gumbel
noise of its categorical draw and ``spec_accept`` its acceptance uniforms
and Gumbel noise as tensors, so a test can hand both packages the same
noise and demand the same tokens. ``jax.random.categorical(key, lg)`` is
``argmax(lg + gumbel)``, which is what ``sample`` computes.

The draws themselves come from a counter-based generator computed on the
device: every value is a hash of ``(sample_seed, rid, token index, draw
index)``, with no host sync and no ``torch.Generator`` state shared
between batch slots. A request's randomness therefore depends only on its
own identity and progress, never on batch composition, and survives
recompute preemption bit for bit, as with the reference's
``fold_in(fold_in(key(seed), rid), emitted)`` keys. The stream differs
from JAX's threefry stream: stochastic outputs are held to the reference
in distribution, not token for token (greedy outputs are token for
token).

Per-slot keys are (B, 2) int64 rows ``[request key, token index]``: the
request key hashes ``(sample_seed, rid)`` and the token index is the
index, within the request's output, of the next token the slot samples.
Token ``t`` draws its Gumbel noise at draw indices ``0..V-1``; a verify
pass starting at token ``t`` draws acceptance uniform ``j`` at draw index
``ACCEPT_DRAW + j`` of token ``t``.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30

_M32 = 0xFFFFFFFF
_MUL = 0x45D9F3B          # < 2**27: a 32-bit value times it stays < 2**59
_GOLDEN = 0x9E3779B9
ACCEPT_DRAW = 1 << 31     # draw indices of acceptance uniforms start here


def sample_greedy(logits):
    """Greedy argmax over the last axis, int32. ``torch.argmax`` returns
    the first maximum, as ``np.argmax`` and ``jnp.argmax`` do — the
    fused-decode identity invariant."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


# ----------------------------- the draws -------------------------------- #

def _mix32(x):
    """A 32-bit integer hash of values in [0, 2**32) (int64 tensors or host
    ints): two multiply-xorshift rounds, each product below 2**59, so
    int64 never overflows."""
    x = (((x >> 16) ^ x) * _MUL) & _M32
    x = (((x >> 16) ^ x) * _MUL) & _M32
    return (x >> 16) ^ x


def _fold(h, x):
    """Fold the integer tensor ``x`` into the hash state ``h``."""
    return _mix32((((h ^ (x & _M32)) + _GOLDEN)) & _M32)


def request_keys(seed: int, rids, token_index):
    """(B, 2) int64 per-slot keys ``[hash(seed, rid), token_index]``.

    rids, token_index: (B,) integer tensors on the device of the draws."""
    rids = rids.to(torch.int64)
    h = _fold(torch.full_like(rids, _mix32(seed & _M32)), rids)
    return torch.stack([h, token_index.to(torch.int64)], dim=1)


def uniforms(keys, draw):
    """Uniforms in (0, 1), f32, one per (slot, draw index).

    keys: (B, 2) int64 from ``request_keys``; draw: (n,) int64 draw
    indices. Returns (B, n). 23 bits of the hash, centred in their bin, so
    every value lies in [2**-24, 1 - 2**-24] and is exact in f32."""
    h = _fold(keys[:, :1], keys[:, 1:])                     # (B, 1)
    bits = _mix32(_fold(h, draw[None, :]))                  # (B, n)
    return ((bits >> 9).to(torch.float32) + 0.5) * (2.0 ** -23)


def gumbel(keys, V: int):
    """(B, V) f32 standard Gumbel noise for the token at each slot's token
    index (draw indices 0..V-1)."""
    u = uniforms(keys, torch.arange(V, dtype=torch.int64,
                                    device=keys.device))
    return -torch.log(-torch.log(u))


def accept_uniforms(keys, K: int):
    """(B, K) acceptance uniforms of a verify pass that starts at each
    slot's token index (draw indices ACCEPT_DRAW + j)."""
    return uniforms(keys, ACCEPT_DRAW + torch.arange(
        K, dtype=torch.int64, device=keys.device))


def advance(keys, n):
    """Keys ``n`` tokens further on (n: int or (B,) tensor)."""
    return torch.stack([keys[:, 0], keys[:, 1] + n], dim=1)


# ---------------------------- the decisions ----------------------------- #

def filtered_logits(logits, *, temperature: float, top_k: int = 0,
                    top_p: float = 1.0):
    """Temperature-scale then top-k / top-p (nucleus) mask the logits.

    top_k <= 0 disables the k filter (ties at the k-th value are kept);
    top_p >= 1 disables the nucleus filter, which keeps the smallest
    prefix of probability-sorted tokens whose cumulative mass reaches
    ``top_p`` (the token that crosses it is kept; equal probabilities rank
    by token id, as the reference's stable ``jnp.argsort``). Masked
    entries are ``NEG_INF``."""
    if temperature <= 0.0:
        raise ValueError("filtered_logits needs temperature > 0; use "
                         "sample_greedy for temperature 0")
    s = logits.float() / temperature
    V = s.shape[-1]
    if top_k and top_k < V:
        kth = torch.topk(s, top_k, dim=-1).values[..., -1:]
        s = torch.where(s < kth, NEG_INF, s)
    if top_p < 1.0:
        probs = torch.softmax(s, dim=-1)
        sp = torch.sort(probs, dim=-1, descending=True).values
        csum = torch.cumsum(sp, dim=-1)
        # mass strictly before each sorted slot; keep while it is < top_p
        n_keep = ((csum - sp) < top_p).sum(dim=-1, keepdim=True)
        order = torch.argsort(-probs, dim=-1, stable=True)
        ranks = torch.argsort(order, dim=-1)                # rank per token
        s = torch.where(ranks < n_keep, s, NEG_INF)
    return s


def sample(logits, noise=None, *, temperature: float = 0.0, top_k: int = 0,
           top_p: float = 1.0):
    """One token per batch slot. logits: (B, V); noise: (B, V) Gumbel
    noise (``gumbel(keys, V)``). temperature <= 0 is greedy (noise
    unused)."""
    if temperature <= 0.0:
        return sample_greedy(logits)
    f = filtered_logits(logits, temperature=temperature, top_k=top_k,
                        top_p=top_p)
    return torch.argmax(f + noise, dim=-1).to(torch.int32)


def spec_accept(logits, draft, draft_len, u=None, noise=None, *,
                temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
                pad_id: int = 0):
    """Leftover/rejection sampling over one verify pass.

    logits: (B, C, V) — row j is the target distribution for the token
    AFTER window token j of ``[t_last, d_1 .. d_{C-1}]``; draft: (B, C-1)
    proposals (column j verifies against row j); draft_len: (B,) valid
    proposals per slot; u: (B, C-1) acceptance uniforms; noise: (B, V)
    Gumbel noise of the corrected/bonus draw (both unused at temperature
    0).

    Draft d_j is accepted with probability p_j(d_j) given every earlier
    proposal accepted (at temperature 0: ``d_j == argmax p_j``). The first
    rejection at r emits a token from p_r with d_r zeroed; full acceptance
    emits a bonus token from row ``draft_len``. Exactly ``n_acc + 1``
    tokens come out.

    Returns (out (B, C) int32 [accepted drafts, corrected/bonus, pads],
    n_acc (B,) int32)."""
    B, C, V = logits.shape
    K = C - 1
    dev = logits.device
    draft = draft.to(torch.int32)
    draft_len = draft_len.to(device=dev, dtype=torch.int32)
    live = torch.arange(K, device=dev)[None, :] < draft_len[:, None]

    if temperature <= 0.0:
        tgt = sample_greedy(logits)                          # (B, C)
        ok = (draft == tgt[:, :K]) & live
        n_acc = torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1)
        corr = torch.gather(tgt, 1, n_acc[:, None].long())[:, 0]
    else:
        f = filtered_logits(logits, temperature=temperature, top_k=top_k,
                            top_p=top_p)
        probs = torch.softmax(f, dim=-1)                     # (B, C, V)
        if K:
            p_d = torch.gather(probs[:, :K], 2,
                               draft[..., None].long())[..., 0]  # (B, K)
            ok = (u < p_d) & live
        else:
            ok = torch.zeros((B, 0), dtype=torch.bool, device=dev)
        n_acc = torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1)
        row_p = torch.gather(
            probs, 1, n_acc[:, None, None].long().expand(B, 1, V))[:, 0]
        rejected = n_acc < draft_len                         # vs full accept
        if K:
            d_rej = torch.gather(draft, 1, n_acc.clamp(max=K - 1)[:, None]
                                 .long())[:, 0]
            onehot = torch.nn.functional.one_hot(d_rej.long(), V).to(
                row_p.dtype)
            leftover = torch.where(rejected[:, None], row_p * (1.0 - onehot),
                                   row_p)
        else:
            leftover = row_p
        # the categorical draw is scale-invariant: no renormalization
        lg = torch.where(leftover > 0,
                         torch.log(torch.clamp_min(leftover, 1e-38)),
                         NEG_INF)
        corr = torch.argmax(lg + noise, dim=-1).to(torch.int32)

    n_acc = n_acc.to(torch.int32)
    jC = torch.arange(C, device=dev)[None, :]
    drafts_padded = torch.cat(
        [draft, torch.full((B, 1), pad_id, dtype=torch.int32, device=dev)],
        dim=1)
    out = torch.where(jC < n_acc[:, None], drafts_padded,
                      torch.where(jC == n_acc[:, None], corr[:, None],
                                  pad_id))
    return out.to(torch.int32), n_acc
