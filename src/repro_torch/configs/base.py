"""Architecture configs: one ``ArchConfig`` describes a model family member
precisely enough to instantiate the port's PyTorch model
(``repro_torch.models``). This is the port's own copy of the reference
package's ``repro/configs``, so that the port imports nothing of it; the
two are kept identical.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration."""
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0            # always-active shared experts (DeepSeek-V2)
    dense_residual: bool = False  # parallel dense FFN next to MoE (Arctic)
    first_dense: int = 0          # first N layers use a dense FFN instead
    d_ff_dense: int = 0           # hidden dim of those dense layers / residual


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2)."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128

    @property
    def cache_width(self) -> int:
        # decode caches the compressed latent + the shared rope key
        return self.kv_lora_rank + self.rope_head_dim


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD block configuration."""
    state_dim: int
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 128

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # attention pattern
    sliding_window: int = 0     # >0: local layers use this window
    local_global_ratio: int = 0  # gemma3: N local layers per global layer
    qkv_bias: bool = False
    logit_softcap: float = 0.0
    gated_mlp: bool = True      # SwiGLU (3 mats) vs GELU MLP (2 mats)
    tie_embeddings: bool = False
    # hybrid (zamba2-style): shared attention block every `attn_every` blocks
    attn_every: int = 0
    # encoder-decoder / multimodal frontends (stubs feed embeddings directly)
    enc_layers: int = 0
    source_len: int = 0         # whisper frames / vlm patches
    prefix_len: int = 0         # vlm prefix (image) tokens in the LM stream
    prefix_bidirectional: bool = False  # paligemma prefix-LM masking
    max_context: int = 131072
    dtype: str = "bfloat16"
    notes: str = ""

    # ------------------------------------------------------------------ #
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def has_subquadratic_context(self) -> bool:
        """Can this arch run 500k-token decode without a full-attention KV?"""
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # -------------------------- parameter counts ---------------------- #
    def _attn_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        if self.mla is not None:
            m = self.mla
            q = d * m.q_lora_rank + m.q_lora_rank * self.n_heads * (
                m.qk_nope_head_dim + m.rope_head_dim)
            kv = d * (m.kv_lora_rank + m.rope_head_dim) + m.kv_lora_rank * (
                self.n_heads * (m.qk_nope_head_dim + m.v_head_dim))
            o = self.n_heads * m.v_head_dim * d
            return q + kv + o
        qo = d * self.n_heads * hd * 2
        kv = d * self.n_kv_heads * hd * 2
        bias = (self.n_heads + 2 * self.n_kv_heads) * hd if self.qkv_bias else 0
        return qo + kv + bias

    def _ffn_params(self, d_ff: int) -> int:
        n_mat = 3 if self.gated_mlp else 2
        return n_mat * self.d_model * d_ff

    def _ssm_params(self) -> int:
        assert self.ssm is not None
        s, d = self.ssm, self.d_model
        di, nh, ng = s.d_inner(d), s.n_heads(d), s.n_groups
        in_proj = d * (2 * di + 2 * ng * s.state_dim + nh)
        conv = s.conv_width * (di + 2 * ng * s.state_dim)
        out_proj = di * d
        extra = nh * 2 + di  # A_log, D, norm
        return in_proj + conv + out_proj + extra

    def layer_params(self, layer_idx: int) -> int:
        """Parameter count of one decoder layer (by index, for MoE periods)."""
        d = self.d_model
        norm = 2 * d
        if self.family == "ssm":
            return self._ssm_params() + norm
        if self.family == "hybrid":
            # mamba2 backbone layer; shared attention counted separately
            return self._ssm_params() + norm
        attn = self._attn_params()
        if self.moe is not None and layer_idx >= self.moe.first_dense:
            m = self.moe
            ffn = (m.n_experts + m.n_shared) * self._ffn_params(m.d_ff_expert)
            ffn += m.n_experts * d  # router
            if m.dense_residual:
                ffn += self._ffn_params(m.d_ff_dense or self.d_ff)
        elif self.moe is not None:
            ffn = self._ffn_params(self.moe.d_ff_dense or self.d_ff)
        else:
            ffn = self._ffn_params(self.d_ff)
        return attn + ffn + norm

    def n_params(self) -> int:
        emb = self.vocab * self.d_model
        head = 0 if self.tie_embeddings else self.vocab * self.d_model
        body = sum(self.layer_params(i) for i in range(self.n_layers))
        if self.family == "hybrid" and self.attn_every:
            n_attn = self.n_layers // self.attn_every
            # one SHARED attention block (+ its in-projection from 2*d concat)
            shared = self._attn_params() + self.d_model * self.d_model
            body += shared + n_attn * self.d_model * self.d_model  # per-site proj
        if self.enc_layers:
            enc = self.enc_layers * (self._attn_params()
                                     + self._ffn_params(self.d_ff)
                                     + 2 * self.d_model)
            cross = self.n_layers * self._attn_params()  # decoder cross-attn
            body += enc + cross
        return emb + head + body + 2 * self.d_model

    def layer_active_params(self, layer_idx: int) -> int:
        """Params touched per token (MoE: only routed top-k + shared)."""
        if self.moe is None or layer_idx < self.moe.first_dense:
            return self.layer_params(layer_idx)
        m = self.moe
        attn = self._attn_params()
        ffn = (m.top_k + m.n_shared) * self._ffn_params(m.d_ff_expert)
        ffn += m.n_experts * self.d_model
        if m.dense_residual:
            ffn += self._ffn_params(m.d_ff_dense or self.d_ff)
        return attn + ffn + 2 * self.d_model

    def n_active_params(self) -> int:
        emb = self.vocab * self.d_model
        head = 0 if self.tie_embeddings else self.vocab * self.d_model
        body = sum(self.layer_active_params(i) for i in range(self.n_layers))
        if self.family == "hybrid" and self.attn_every:
            n_attn = self.n_layers // self.attn_every
            body += (self._attn_params() + self.d_model * self.d_model
                     + n_attn * self.d_model * self.d_model)
        if self.enc_layers:
            body += self.enc_layers * (self._attn_params()
                                       + self._ffn_params(self.d_ff)
                                       + 2 * self.d_model)
            body += self.n_layers * self._attn_params()
        return emb + head + body + 2 * self.d_model

    # -------------------------- cache sizing -------------------------- #
    def kv_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        """KV-cache (or SSM-state-equivalent) bytes appended per token."""
        if self.family == "ssm":
            return 0  # constant state, nothing grows per token
        if self.mla is not None:
            per_layer = self.mla.cache_width
        else:
            per_layer = 2 * self.n_kv_heads * self.head_dim
        n_cache_layers = self.n_attention_layers()
        return per_layer * n_cache_layers * dtype_bytes

    def n_attention_layers(self) -> int:
        if self.family == "ssm":
            return 0
        if self.family == "hybrid" and self.attn_every:
            return self.n_layers // self.attn_every
        return self.n_layers

    def attention_kind(self, layer_idx: int) -> str:
        """'global' | 'local' for this layer index (gemma3 5:1 pattern)."""
        if self.local_global_ratio and self.sliding_window:
            period = self.local_global_ratio + 1
            return "global" if (layer_idx % period == period - 1) else "local"
        return "global" if not self.sliding_window else "local"
