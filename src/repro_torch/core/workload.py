"""LLM inference task-graph derivation (paper Sec. II).

Builds the per-phase kernel list — the six GEMM families
{X.W_qkv, Q.K^T, Softmax(R).V, Z.W_o, O.W_mlp1, O_mlp1.W_mlp2} plus
element-wise ops — for every architecture family in the pool (dense GQA,
MoE, MLA, SSM/SSD, hybrid, enc-dec, VLM), with per-operand tensor classes so
placement policies (paper Sec. III) can route each class to a memory tier.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from repro_torch.configs.base import ArchConfig


# --------------------------- tensor classes --------------------------- #
class TC:
    """The paper's placement knobs: weights vs Q/K/V vs activations."""
    W_ATTN = "w_attn"      # attention projection weights
    W_MLP = "w_mlp"        # MLP weights
    W_MOE = "w_moe"        # expert weights (streamed top-k)
    W_EMB = "w_emb"        # embedding / LM-head table
    W_SSM = "w_ssm"        # SSM block weights
    QKV = "qkv"            # current-token Q/K/V + attention intermediates
    KV = "kv"              # KV cache (grows with context)
    ACT = "act"            # other intermediate activations
    STATE = "state"        # SSM recurrent state (constant size)

    WEIGHTS = (W_ATTN, W_MLP, W_MOE, W_EMB, W_SSM)
    ALL = WEIGHTS + (QKV, KV, ACT, STATE)


@dataclass(frozen=True)
class Operand:
    role: str              # 'A' | 'B' | 'C'
    tclass: str
    bytes: float           # logical tensor bytes (single pass)
    granularity: float = 0.0  # natural transfer chunk; 0 -> tensor bytes


@dataclass(frozen=True)
class Kernel:
    name: str
    group: str             # qkv_gen | attn | proj | mlp | moe | embed | ssm | elem
    kind: str              # gemm | elemwise
    M: int
    N: int
    K: int
    dtype_bytes: int
    operands: tuple
    batch: int = 1         # independent GEMM instances (e.g. B * kv_heads)
    flops: float = 0.0     # 0 -> derived 2*batch*M*N*K
    count: int = 1         # structural repetition (layers collapsed)

    def total_flops(self) -> float:
        f = self.flops if self.flops else 2.0 * self.batch * self.M * self.N * self.K
        return f * self.count

    @property
    def is_attention(self) -> bool:
        return self.group == "attn"


def _gemm(name, group, M, N, K, b, *, A=TC.ACT, B=TC.W_MLP, C=TC.ACT,
          batch=1, count=1, a_bytes=None, b_bytes=None, c_bytes=None,
          b_gran=0.0, flops=0.0) -> Kernel:
    ab = a_bytes if a_bytes is not None else batch * M * K * b
    bb = b_bytes if b_bytes is not None else batch * K * N * b
    cb = c_bytes if c_bytes is not None else batch * M * N * b
    ops = (Operand("A", A, ab), Operand("B", B, bb, granularity=b_gran),
           Operand("C", C, cb))
    return Kernel(name, group, "gemm", M, N, K, b, ops, batch=batch,
                  flops=flops, count=count)


def _elem(name, n_elems, b, *, tclass=TC.ACT, reads=1, writes=1,
          flops_per=4.0, count=1) -> Kernel:
    ops = (Operand("A", tclass, n_elems * b * reads),
           Operand("C", tclass, n_elems * b * writes))
    return Kernel(name, "elem", "elemwise", 1, 1, 1, b, ops,
                  flops=flops_per * n_elems, count=count)


# ===================================================================== #
# per-layer kernel builders                                             #
# ===================================================================== #

def _attention_kernels(cfg: ArchConfig, *, new_tokens: int, ctx: int,
                       batch: int, b: int, count: int, tag: str,
                       kv_len: Optional[int] = None,
                       kv_class: str = TC.KV, causal: bool = True,
                       d_in: Optional[int] = None) -> List[Kernel]:
    """Dense/GQA attention: QKV gen, scores, AV, output projection."""
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    d = d_in if d_in is not None else cfg.d_model
    S = new_tokens
    L = kv_len if kv_len is not None else ctx
    group_sz = max(H // max(Hkv, 1), 1)
    ks: List[Kernel] = []
    n_qkv = (H + 2 * Hkv) * hd
    ks.append(_gemm(f"{tag}qkv_gen", "qkv_gen", batch * S, n_qkv, d, b,
                    A=TC.ACT, B=TC.W_ATTN, C=TC.QKV, count=count))
    # causal prefill touches ~L/2 of the keys on average
    cf = 0.5 if (causal and S > 1 and L == S) else 1.0
    kv_gran = L * hd * b          # one head's K (or V) matrix
    # scores: per kv-head, Q block (group*S x hd) x K^T (hd x L)
    ks.append(_gemm(f"{tag}attn_qk", "attn", group_sz * S, L, hd, b,
                    batch=batch * max(Hkv, 1), A=TC.QKV, B=kv_class, C=TC.QKV,
                    b_gran=kv_gran, count=count,
                    flops=2.0 * batch * H * S * L * hd * cf,
                    c_bytes=batch * H * S * L * b * cf))
    ks.append(_elem(f"{tag}softmax", batch * H * S * L * cf, b, tclass=TC.QKV,
                    flops_per=5.0, count=count))
    ks.append(_gemm(f"{tag}attn_av", "attn", group_sz * S, hd, L, b,
                    batch=batch * max(Hkv, 1), A=TC.QKV, B=kv_class, C=TC.QKV,
                    b_gran=kv_gran, count=count,
                    flops=2.0 * batch * H * S * L * hd * cf,
                    a_bytes=batch * H * S * L * b * cf))
    ks.append(_gemm(f"{tag}o_proj", "proj", batch * S, d, H * hd, b,
                    A=TC.QKV, B=TC.W_ATTN, C=TC.ACT, count=count))
    return ks


def _mla_kernels(cfg: ArchConfig, *, new_tokens: int, ctx: int, batch: int,
                 b: int, count: int) -> List[Kernel]:
    """DeepSeek-V2 MLA with the absorbed decode path.

    The latent cache (kv_lora + rope_dim wide) is SHARED across heads, so the
    score/AV GEMMs put all H heads on the M axis — the tiling search then
    captures cross-head latent reuse (unlike per-head GQA batching)."""
    m = cfg.mla
    assert m is not None
    H, d = cfg.n_heads, cfg.d_model
    S, L = new_tokens, ctx
    r, rq, dr = m.kv_lora_rank, m.q_lora_rank, m.rope_head_dim
    dn, dv = m.qk_nope_head_dim, m.v_head_dim
    w = r + dr
    ks: List[Kernel] = []
    ks.append(_gemm("mla_q_down", "qkv_gen", batch * S, rq, d, b,
                    A=TC.ACT, B=TC.W_ATTN, C=TC.QKV, count=count))
    ks.append(_gemm("mla_q_up", "qkv_gen", batch * S, H * (dn + dr), rq, b,
                    A=TC.QKV, B=TC.W_ATTN, C=TC.QKV, count=count))
    ks.append(_gemm("mla_kv_down", "qkv_gen", batch * S, w, d, b,
                    A=TC.ACT, B=TC.W_ATTN, C=TC.KV, count=count))
    # absorb: q_nope @ W_uk  ->  query in latent space
    ks.append(_gemm("mla_q_absorb", "qkv_gen", batch * S * H, r, dn, b,
                    A=TC.QKV, B=TC.W_ATTN, C=TC.QKV, count=count,
                    b_bytes=dn * r * H * b))
    cf = 0.5 if (S > 1 and L == S) else 1.0
    gran = L * w * b
    ks.append(_gemm("mla_score", "attn", H * S, L, w, b, batch=batch,
                    A=TC.QKV, B=TC.KV, C=TC.QKV, b_gran=gran, count=count,
                    flops=2.0 * batch * H * S * L * w * cf,
                    c_bytes=batch * H * S * L * b * cf))
    ks.append(_elem("mla_softmax", batch * H * S * L * cf, b, tclass=TC.QKV,
                    flops_per=5.0, count=count))
    ks.append(_gemm("mla_av", "attn", H * S, r, L, b, batch=batch,
                    A=TC.QKV, B=TC.KV, C=TC.QKV, b_gran=gran, count=count,
                    flops=2.0 * batch * H * S * L * r * cf,
                    a_bytes=batch * H * S * L * b * cf))
    ks.append(_gemm("mla_v_up", "proj", batch * S * H, dv, r, b,
                    A=TC.QKV, B=TC.W_ATTN, C=TC.QKV, count=count,
                    b_bytes=r * dv * H * b))
    ks.append(_gemm("mla_o_proj", "proj", batch * S, d, H * dv, b,
                    A=TC.QKV, B=TC.W_ATTN, C=TC.ACT, count=count))
    return ks


def _ffn_kernels(cfg: ArchConfig, d_ff: int, *, tokens: int, b: int,
                 count: int, wclass: str = TC.W_MLP, tag: str = "",
                 weight_mult: float = 1.0, flop_tokens: Optional[int] = None
                 ) -> List[Kernel]:
    """MLP kernels. ``weight_mult`` scales weight traffic (distinct experts);
    ``flop_tokens`` scales FLOPs (tokens actually processed)."""
    d = cfg.d_model
    ft = flop_tokens if flop_tokens is not None else tokens
    ks = []
    n_up = 2 * d_ff if cfg.gated_mlp else d_ff
    ks.append(_gemm(f"{tag}mlp1", "mlp", tokens, n_up, d, b,
                    A=TC.ACT, B=wclass, C=TC.ACT, count=count,
                    b_bytes=d * n_up * b * weight_mult,
                    flops=2.0 * ft * n_up * d))
    if cfg.gated_mlp:
        ks.append(_elem(f"{tag}swiglu", tokens * d_ff, b, flops_per=6.0,
                        count=count))
    ks.append(_gemm(f"{tag}mlp2", "mlp", tokens, d, d_ff, b,
                    A=TC.ACT, B=wclass, C=TC.ACT, count=count,
                    b_bytes=d_ff * d * b * weight_mult,
                    flops=2.0 * ft * d * d_ff))
    return ks


def _moe_kernels(cfg: ArchConfig, *, tokens: int, b: int, count: int
                 ) -> List[Kernel]:
    m = cfg.moe
    assert m is not None
    d = cfg.d_model
    ks = [_gemm("router", "moe", tokens, m.n_experts, d, b,
                A=TC.ACT, B=TC.W_MOE, C=TC.ACT, count=count)]
    # expected number of DISTINCT experts whose weights must be streamed
    p_untouched = (1.0 - m.top_k / m.n_experts) ** tokens
    distinct = m.n_experts * (1.0 - p_untouched)
    ks += _ffn_kernels(cfg, m.d_ff_expert, tokens=tokens, b=b, count=count,
                       wclass=TC.W_MOE, tag="moe_", weight_mult=distinct,
                       flop_tokens=tokens * m.top_k)
    if m.n_shared:
        ks += _ffn_kernels(cfg, m.d_ff_expert * m.n_shared, tokens=tokens,
                           b=b, count=count, wclass=TC.W_MOE, tag="moe_shared_")
    if m.dense_residual:
        ks += _ffn_kernels(cfg, m.d_ff_dense or cfg.d_ff, tokens=tokens, b=b,
                           count=count, tag="residual_")
    return ks


def _ssm_kernels(cfg: ArchConfig, *, new_tokens: int, batch: int, b: int,
                 count: int) -> List[Kernel]:
    """Mamba-2 SSD block. Decode: O(1) state update; prefill: chunked scan."""
    s = cfg.ssm
    assert s is not None
    d = cfg.d_model
    di, nh, ng = s.d_inner(d), s.n_heads(d), s.n_groups
    N = s.state_dim
    T = batch * new_tokens
    n_in = 2 * di + 2 * ng * N + nh
    ks = [_gemm("ssm_in_proj", "ssm", T, n_in, d, b,
                A=TC.ACT, B=TC.W_SSM, C=TC.ACT, count=count)]
    ks.append(_elem("ssm_conv", T * (di + 2 * ng * N), b, flops_per=2 * s.conv_width,
                    count=count))
    # state update + output: per token, per head: dh x N outer products
    state_elems = batch * nh * s.head_dim * N
    ks.append(Kernel("ssm_scan", "ssm", "elemwise", 1, 1, 1, b,
                     (Operand("A", TC.STATE, state_elems * b * new_tokens),
                      Operand("C", TC.STATE, state_elems * b * new_tokens)),
                     flops=6.0 * T * nh * s.head_dim * N, count=count))
    ks.append(_gemm("ssm_out_proj", "ssm", T, d, di, b,
                    A=TC.ACT, B=TC.W_SSM, C=TC.ACT, count=count))
    return ks


# ===================================================================== #
# phase builders                                                        #
# ===================================================================== #

def _layer_plan(cfg: ArchConfig):
    """Collapse identical layers: yields (spec_kind, kwargs, count)."""
    if cfg.family == "ssm":
        return [("ssm", {}, cfg.n_layers)]
    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // max(cfg.attn_every, 1) if cfg.attn_every else 0
        return [("ssm", {}, cfg.n_layers), ("attn_shared", {}, n_attn)]
    plans = []
    if cfg.local_global_ratio and cfg.sliding_window:
        n_global = sum(1 for i in range(cfg.n_layers)
                       if cfg.attention_kind(i) == "global")
        plans.append(("attn", {"local": False}, n_global))
        plans.append(("attn", {"local": True}, cfg.n_layers - n_global))
    else:
        plans.append(("attn", {"local": bool(cfg.sliding_window)},
                      cfg.n_layers))
    if cfg.moe is not None:
        n_moe = cfg.n_layers - cfg.moe.first_dense
        if cfg.moe.first_dense:
            plans.append(("ffn_dense", {}, cfg.moe.first_dense))
        plans.append(("moe", {}, n_moe))
    else:
        plans.append(("ffn_dense", {}, cfg.n_layers))
    return plans


def _block_kernels(cfg: ArchConfig, kind: str, kw: dict, count: int, *,
                   new_tokens: int, ctx: int, batch: int, b: int
                   ) -> List[Kernel]:
    if kind == "ssm":
        return _ssm_kernels(cfg, new_tokens=new_tokens, batch=batch, b=b,
                            count=count)
    if kind == "attn_shared":
        ks = _attention_kernels(cfg, new_tokens=new_tokens, ctx=ctx,
                                batch=batch, b=b, count=count, tag="shared_")
        # zamba2: per-site projection back into the backbone width
        ks.append(_gemm("shared_site_proj", "proj", batch * new_tokens,
                        cfg.d_model, cfg.d_model, b, A=TC.ACT, B=TC.W_ATTN,
                        C=TC.ACT, count=count))
        return ks
    if kind == "attn":
        if cfg.mla is not None:
            ks = _mla_kernels(cfg, new_tokens=new_tokens, ctx=ctx,
                              batch=batch, b=b, count=count)
        else:
            kv_len = ctx
            if kw.get("local") and cfg.sliding_window:
                kv_len = min(ctx, cfg.sliding_window)
            ks = _attention_kernels(cfg, new_tokens=new_tokens, ctx=ctx,
                                    batch=batch, b=b, count=count, tag="",
                                    kv_len=kv_len)
        ks.append(_elem("norm_attn", batch * new_tokens * cfg.d_model, b,
                        flops_per=6.0, count=count))
        return ks
    if kind == "moe":
        return _moe_kernels(cfg, tokens=batch * new_tokens, b=b, count=count)
    if kind == "ffn_dense":
        d_ff = (cfg.moe.d_ff_dense if (cfg.moe and cfg.moe.d_ff_dense)
                else cfg.d_ff)
        ks = _ffn_kernels(cfg, d_ff, tokens=batch * new_tokens, b=b,
                          count=count)
        ks.append(_elem("norm_mlp", batch * new_tokens * cfg.d_model, b,
                        flops_per=6.0, count=count))
        return ks
    raise ValueError(kind)


def _encoder_kernels(cfg: ArchConfig, batch: int, b: int) -> List[Kernel]:
    """Enc-dec (whisper): encoder runs once per request at prefill."""
    S = cfg.source_len
    ks = _attention_kernels(cfg, new_tokens=S, ctx=S, batch=batch, b=b,
                            count=cfg.enc_layers, tag="enc_", causal=False)
    ks += _ffn_kernels(cfg, cfg.d_ff, tokens=batch * S, b=b,
                       count=cfg.enc_layers, tag="enc_")
    return ks


def _cross_attention_kernels(cfg: ArchConfig, *, new_tokens: int, batch: int,
                             b: int) -> List[Kernel]:
    return _attention_kernels(cfg, new_tokens=new_tokens, ctx=cfg.source_len,
                              batch=batch, b=b, count=cfg.n_layers,
                              tag="cross_", kv_len=cfg.source_len,
                              causal=False)


def lm_head_kernel(cfg: ArchConfig, tokens: int, b: int) -> Kernel:
    return _gemm("lm_head", "embed", tokens, cfg.vocab, cfg.d_model, b,
                 A=TC.ACT, B=TC.W_EMB, C=TC.ACT)


@dataclass
class Phase:
    name: str                 # 'prefill' | 'decode@<ctx>'
    kernels: List[Kernel]
    new_tokens: int
    ctx: int


def prefill_phase(cfg: ArchConfig, seq_len: int, batch: int = 1,
                  dtype_bytes: int = 2) -> Phase:
    b = dtype_bytes
    ks: List[Kernel] = []
    if cfg.enc_layers:
        ks += _encoder_kernels(cfg, batch, b)
    for kind, kw, count in _layer_plan(cfg):
        ks += _block_kernels(cfg, kind, kw, count, new_tokens=seq_len,
                             ctx=seq_len, batch=batch, b=b)
    if cfg.enc_layers:
        ks += _cross_attention_kernels(cfg, new_tokens=seq_len, batch=batch,
                                       b=b)
    ks.append(lm_head_kernel(cfg, batch, b))  # only last position sampled
    return Phase("prefill", ks, new_tokens=seq_len, ctx=seq_len)


def decode_phase(cfg: ArchConfig, ctx: int, batch: int = 1,
                 dtype_bytes: int = 2) -> Phase:
    """One decode step with a KV cache of length ``ctx``."""
    b = dtype_bytes
    ks: List[Kernel] = []
    for kind, kw, count in _layer_plan(cfg):
        ks += _block_kernels(cfg, kind, kw, count, new_tokens=1, ctx=ctx,
                             batch=batch, b=b)
    if cfg.enc_layers:
        ks += _cross_attention_kernels(cfg, new_tokens=1, batch=batch, b=b)
    ks.append(lm_head_kernel(cfg, batch, b))
    return Phase(f"decode@{ctx}", ks, new_tokens=1, ctx=ctx)


# --------------------------- footprints ------------------------------ #

def resident_bytes(cfg: ArchConfig, ctx: int, batch: int,
                   dtype_bytes: int = 2) -> dict:
    """Static residency per tensor class (for capacity-aware placement)."""
    weights = {TC.W_ATTN: 0.0, TC.W_MLP: 0.0, TC.W_MOE: 0.0,
               TC.W_SSM: 0.0, TC.W_EMB: 0.0}
    d = cfg.d_model
    for i in range(cfg.n_layers):
        if cfg.family in ("ssm", "hybrid"):
            weights[TC.W_SSM] += cfg._ssm_params()
        else:
            weights[TC.W_ATTN] += cfg._attn_params()
            if cfg.moe is not None and i >= cfg.moe.first_dense:
                m = cfg.moe
                weights[TC.W_MOE] += ((m.n_experts + m.n_shared)
                                      * cfg._ffn_params(m.d_ff_expert)
                                      + m.n_experts * d)
                if m.dense_residual:
                    weights[TC.W_MLP] += cfg._ffn_params(m.d_ff_dense or cfg.d_ff)
            else:
                dff = (cfg.moe.d_ff_dense if (cfg.moe and i < cfg.moe.first_dense
                                              and cfg.moe.d_ff_dense)
                       else cfg.d_ff)
                weights[TC.W_MLP] += cfg._ffn_params(dff)
    if cfg.family == "hybrid" and cfg.attn_every:
        weights[TC.W_ATTN] += cfg._attn_params() + d * d * (
            1 + cfg.n_layers // cfg.attn_every)
    if cfg.enc_layers:
        weights[TC.W_ATTN] += (cfg.enc_layers + cfg.n_layers) * cfg._attn_params()
        weights[TC.W_MLP] += cfg.enc_layers * cfg._ffn_params(cfg.d_ff)
    weights[TC.W_EMB] += cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
    fp = {k: v * dtype_bytes for k, v in weights.items()}
    fp[TC.KV] = float(cfg.kv_bytes_per_token(dtype_bytes)) * ctx * batch
    if cfg.enc_layers:
        fp[TC.KV] += (2 * cfg.n_layers * cfg.source_len * cfg.n_kv_heads
                      * cfg.head_dim * dtype_bytes * batch)
    if cfg.ssm is not None:
        s = cfg.ssm
        fp[TC.STATE] = (cfg.n_layers * s.n_heads(d) * s.head_dim * s.state_dim
                        * dtype_bytes * batch)
    else:
        fp[TC.STATE] = 0.0
    fp[TC.QKV] = 4.0 * d * batch * dtype_bytes * cfg.n_layers  # transient
    fp[TC.ACT] = 8.0 * d * batch * dtype_bytes * cfg.n_layers
    return fp
