"""Model/config system: one dataclass, one file per architecture.

``ModelConfig`` is the reference's dataclass field for field, so a
config means the same model in both packages.  It covers every family
of the reference (dense GQA, MoE, hybrid Mamba+attn, pure SSM,
encoder-decoder, VLM backbone); the port registers and runs the dense
and MoE ones so far.  ``reduced()`` returns the smoke-test scale-down of
the same family.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "hybrid", "ssm", "encdec", "vlm"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family = "dense"
    n_layers: int = 12
    d_model: int = 1024
    n_heads: int = 16
    n_kv_heads: int = 16
    d_head: int = 64
    d_ff: int = 4096
    vocab_size: int = 32000

    # attention options
    qk_norm: bool = False
    qkv_bias: bool = False
    attn_impl: str = "fa2"          # paged rail "fa2"/"hfa"; dense impl
                                    # (kernels/ops.py IMPLS)
    attn_block: int = 128           # flash KV/Q block size
    serve_attn: str = "xla"         # xla | shardmap_merge (paper ACC merge)
    rope_theta: float = 10000.0
    pos_emb: str = "rope"            # rope | learned | sinusoidal
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm
    mlp_type: str = "swiglu"         # swiglu | gelu

    # MoE
    n_experts: int = 0
    moe_top_k: int = 2
    capacity_factor: float = 1.25
    moe_every: int = 1               # MoE FFN every k-th layer
    moe_group: int = 0               # dispatch group tokens; 0 = auto

    # hybrid (Jamba): attention every k-th layer, rest Mamba
    attn_every: int = 0              # 0 = all layers attention
    attn_offset: int = 4             # index of the attn layer in the period

    # Mamba/SSD
    m_expand: int = 2
    m_headdim: int = 64
    m_dstate: int = 128
    m_ngroups: int = 1
    m_conv: int = 4
    m_chunk: int = 128

    # enc-dec (Whisper)
    n_enc_layers: int = 0
    enc_seq: int = 1500              # precomputed frame embeddings (stub)

    # VLM
    n_patches: int = 0               # precomputed patch embeddings (stub)

    # training / numerics
    vocab_pad_multiple: int = 2048   # pad tables to 128 lanes x 16 shards
    max_seq: int = 4096
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    scan_layers: bool = True
    unroll_microbatches: bool = False  # cost-probe knob
    remat: str = "full"              # full | none
    # distribution knobs (consumed by launch/ + parallel/)
    optimizer: str = "adamw"         # adamw | adafactor
    microbatches: int = 1

    def layer_kinds(self) -> list[str]:
        """Per-layer mixer kind: 'attn' or 'mamba'."""
        if self.family == "ssm":
            return ["mamba"] * self.n_layers
        if self.family == "hybrid" and self.attn_every > 0:
            return ["attn" if (i % self.attn_every) == self.attn_offset
                    else "mamba" for i in range(self.n_layers)]
        return ["attn"] * self.n_layers

    def ffn_kinds(self) -> list[str]:
        """Per-layer FFN kind: 'dense' or 'moe' (or 'none' for pure SSM)."""
        if self.family == "ssm":
            return ["none"] * self.n_layers
        if self.n_experts > 0:
            return ["moe" if (i % self.moe_every) == (self.moe_every - 1)
                    else "dense" for i in range(self.n_layers)]
        return ["dense"] * self.n_layers

    @property
    def padded_vocab(self) -> int:
        """Embedding/head table size: vocab padded to a TP-friendly multiple
        (standard practice - unused tail ids are inert extra tokens)."""
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def d_inner(self) -> int:
        return self.m_expand * self.d_model

    @property
    def sub_quadratic(self) -> bool:
        """True if decode state does not grow quadratically (SSM/hybrid-lite).

        Used to gate the long_500k shape (see DESIGN.md).
        """
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        n_attn = sum(1 for k in self.layer_kinds() if k == "attn")
        n_mamba = self.n_layers - n_attn
        attn = n_attn * (d * (self.n_heads + 2 * self.n_kv_heads) * self.d_head
                         + self.n_heads * self.d_head * d)
        din = self.d_inner
        gn = self.m_ngroups * self.m_dstate
        h = din // self.m_headdim
        mamba = n_mamba * (2 * d * din + 2 * d * gn + d * h + din * d)
        dense_ffn = 3 * d * ff if self.mlp_type == "swiglu" else 2 * d * ff
        n_moe = sum(1 for k in self.ffn_kinds() if k == "moe")
        n_dense = sum(1 for k in self.ffn_kinds() if k == "dense")
        ffn = n_dense * dense_ffn + n_moe * self.n_experts * 3 * d * ff
        emb = v * d * (1 if self.tie_embeddings else 2)
        enc = self.n_enc_layers * (4 * d * d + 2 * d * ff)
        # enc-dec decoders add a cross-attention block per layer
        cross = (self.n_layers * 4 * d * d) if self.family == "encdec" else 0
        return attn + mamba + ffn + emb + enc + cross

    def active_param_count(self) -> int:
        """Params active per token (MoE: top_k experts instead of all)."""
        if self.n_experts == 0:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        n_moe = sum(1 for k in self.ffn_kinds() if k == "moe")
        full = self.param_count()
        moe_all = n_moe * self.n_experts * 3 * d * ff
        moe_active = n_moe * self.moe_top_k * 3 * d * ff
        return full - moe_all + moe_active

    def reduced(self) -> "ModelConfig":
        """Smoke-test config of the same family (CPU-runnable)."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 4 if self.family != "hybrid"
                         else max(self.attn_every, 4)),
            d_model=256,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads
            < self.n_heads else 4,
            d_head=64,
            d_ff=512 if self.d_ff else 0,
            vocab_size=512,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            moe_top_k=min(self.moe_top_k, 2),
            n_enc_layers=min(self.n_enc_layers, 2),
            enc_seq=64 if self.n_enc_layers else 0,
            n_patches=16 if self.n_patches else 0,
            m_dstate=32,
            m_headdim=32,
            m_chunk=16,
            vocab_pad_multiple=64,
            max_seq=128,
            param_dtype="float32",
            compute_dtype="float32",
            microbatches=1,
        )


REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    # Import config modules lazily so REGISTRY is populated.
    from repro_torch import configs as _c  # noqa: F401
    if name not in REGISTRY:
        raise KeyError(f"unknown arch '{name}'; have {sorted(REGISTRY)}")
    return REGISTRY[name]
