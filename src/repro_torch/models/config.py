"""Model configuration for the assigned architectures: a copy of
``repro.models.config`` (pure data; the port imports nothing of ``repro``)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    d_shared: int = 0
    capacity_factor: float = 1.25
    dense_layers: Tuple[int, ...] = ()  # layer indices using a dense FFN
    d_dense: int = 0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora: int = 512
    q_lora: int = 1536
    rope_dim: int = 64
    nope_dim: int = 128
    v_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    kind: str                   # dense | moe | xlstm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    act: str = "swiglu"         # swiglu | squared_relu | gelu
    attn: str = "gqa"           # gqa | mla | mrope
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    # ssm / hybrid
    ssm_state: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    attn_every: int = 0         # zamba2: shared attention every k layers
    slstm_every: int = 0        # xlstm: sLSTM block every k layers
    # enc-dec
    enc_layers: int = 0
    # numerics / scale
    rope_theta: float = 1e4
    dtype: str = "bfloat16"
    remat: bool = True
    loss_chunk: int = 512       # CE computed in sequence chunks
    # sharding
    fsdp: bool = False          # additionally shard params over the data axis
    # sub-quadratic? (decides long_500k applicability)
    subquadratic: bool = False
    # notes for DESIGN.md / dry-run report
    source: str = ""

    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so the embedding shards evenly
        over the model axis (MaxText-style). Logits beyond ``vocab`` are
        masked in the loss."""
        return -(-self.vocab // 256) * 256

    def param_count(self) -> float:
        """Analytic parameter count (for 6ND MODEL_FLOPS)."""
        D, L, V = self.d_model, self.n_layers, self.vocab
        total = V * D  # embedding (tied head)
        if self.kind == "encdec":
            total += V * D  # decoder side embeds output proj
        per_layer = 0.0
        hd = self.hd
        if self.kind in ("dense", "moe", "encdec"):
            if self.attn == "mla":
                m = self.mla
                qk = m.nope_dim + m.rope_dim
                per_layer += D * m.q_lora + m.q_lora * self.n_heads * qk
                per_layer += D * (m.kv_lora + m.rope_dim)
                per_layer += m.kv_lora * self.n_heads * (m.nope_dim + m.v_dim)
                per_layer += self.n_heads * m.v_dim * D
            else:
                per_layer += D * self.n_heads * hd        # q
                per_layer += 2 * D * self.n_kv_heads * hd  # k, v
                per_layer += self.n_heads * hd * D         # o
            if self.moe is not None:
                mo = self.moe
                per_layer += D * mo.n_experts               # router
                mats = 3 if self.act == "swiglu" else 2
                per_layer += mo.n_experts * mats * D * mo.d_expert
                per_layer += mo.n_shared * mats * D * mo.d_shared
            else:
                mats = 3 if self.act == "swiglu" else 2
                per_layer += mats * D * self.d_ff
            total += L * per_layer
            if self.kind == "encdec":
                # encoder layers + decoder cross-attention
                enc = (2 * D * self.n_heads * hd + 2 * D * self.n_kv_heads * hd
                       + 2 * D * self.d_ff)
                total += self.enc_layers * enc
                total += L * 4 * D * self.n_heads * hd  # cross-attn q,k,v,o
        elif self.kind == "xlstm":
            d_in = self.ssm_expand * D
            # mLSTM blocks: q,k,v,o-gate in_projs + out
            total += L * (4 * D * d_in + d_in * D + 2 * D * self.n_heads)
        elif self.kind == "hybrid":
            d_in = self.ssm_expand * D
            per_m = (D * d_in * 2 + D * 2 * self.ssm_state + D * self.n_heads
                     + d_in * D)
            total += L * per_m
            n_attn = L // max(self.attn_every, 1)
            shared = (2 * D * self.n_heads * hd + 2 * D * self.n_kv_heads * hd
                      + 2 * D * self.d_ff)
            total += shared  # ONE shared block (zamba2's point)
        return float(total)

    def active_param_count(self) -> float:
        """Active params per token (MoE-aware) for 6·N_active·D FLOPs."""
        if self.moe is None:
            return self.param_count()
        D, L = self.d_model, self.n_layers
        mo = self.moe
        mats = 3 if self.act == "swiglu" else 2
        full_routed = L * mo.n_experts * mats * D * mo.d_expert
        active_routed = L * mo.top_k * mats * D * mo.d_expert
        return self.param_count() - full_routed + active_routed
