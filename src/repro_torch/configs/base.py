"""Architecture configuration of the language models.

Copy of ``ArchConfig`` from the reference package's ``configs/base.py``
(which imports no JAX, but the port imports nothing of the reference). Every
architecture is a frozen ``ArchConfig``; ``reduced()`` gives a miniature of
the same family for the CPU tests. The port runs every family: dense,
MoE, VLM and hybrid (``models/transformer.py``, with ``models/mamba.py``),
ssm (``models/xlstm.py``), audio (``models/encdec.py``) and the SRU
(``models/sru.py``).
Input shapes are ``ShapeConfig`` entries; ``models/registry.py::
input_specs`` turns an (arch, shape) cell into shapes and dtypes.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | vlm | audio | sru
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    expert_d_ff: int = 0             # per-expert hidden (qwen2-moe style); 0 -> d_ff

    # --- hybrid (jamba): one attention layer per `attn_period` layers ---
    attn_period: int = 0

    # --- SSM (mamba / jamba mamba layers) ---
    ssm_d_state: int = 16
    ssm_expand: int = 2
    ssm_d_conv: int = 4
    ssm_chunk: int = 256

    # --- xLSTM ---
    slstm_every: int = 2             # 1 sLSTM per N blocks (rest mLSTM)

    # --- encoder-decoder (audio) ---
    is_encdec: bool = False
    n_dec_layers: int = 0

    # --- multimodal stub frontend ---
    frontend: str = "none"          # none | patch | audio
    frontend_tokens: int = 0         # patches / frames prepended by the stub
    frontend_dim: int = 0            # raw embedding dim provided by the stub

    # --- misc ---
    head_dim_override: int = 0
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # full-attention archs must skip long_500k (sub-quadratic only)
    subquadratic: bool = False

    @property
    def padded_vocab(self) -> int:
        """Embedding tables are padded to a 256 multiple; logits over pad ids
        never win argmax in practice."""
        return -(-self.vocab_size // 256) * 256

    @property
    def head_dim(self) -> int:
        if self.head_dim_override:
            return self.head_dim_override
        return self.d_model // self.n_heads

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def moe_ff(self) -> int:
        return self.expert_d_ff or self.d_ff

    def n_params(self) -> int:
        """Analytic parameter count (embedding included)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        H, KV, hd = self.n_heads, self.n_kv_heads, self.head_dim
        attn = D * H * hd + 2 * D * KV * hd + H * hd * D
        dense_mlp = 3 * D * F

        def block_ffn():
            if self.n_experts:
                e = 3 * D * self.moe_ff
                return (D * self.n_experts + self.n_experts * e
                        + self.n_shared_experts * e)
            return dense_mlp

        if self.family == "hybrid":
            groups = L // self.attn_period
            n_mamba = L - groups
            di, N = self.ssm_d_inner, self.ssm_d_state
            mamba = (D * 2 * di + di * self.ssm_d_conv + di * 2 * N
                     + di * N + di + di * D)
            core = groups * attn + n_mamba * mamba + L * block_ffn()
        elif self.family == "ssm":
            di = self.ssm_d_inner
            blk = D * 3 * di + 2 * D * self.n_heads + di * D + dense_mlp
            core = L * blk
        elif self.family == "sru":
            core = 0  # models/sru.py counts the SRU's weights
        else:
            layers = L + (self.n_dec_layers if self.is_encdec else 0)
            x_attn = attn if self.is_encdec else 0
            core = layers * (attn + block_ffn()) + self.n_dec_layers * x_attn
        embed = V * D * (1 if self.tie_embeddings else 2)
        return core + embed

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top_k + shared experts)."""
        if not self.n_experts:
            return self.n_params()
        e = 3 * self.d_model * self.moe_ff
        dead = (self.n_experts - self.top_k) * e * self.n_layers
        return self.n_params() - dead

    def reduced(self) -> "ArchConfig":
        """Miniature same-family config for CPU tests."""
        return replace(
            self,
            n_layers=max(2, min(4, self.n_layers)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads < self.n_heads else 4,
            d_ff=128,
            vocab_size=256,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            n_shared_experts=min(self.n_shared_experts, 1),
            expert_d_ff=64 if self.expert_d_ff else 0,
            attn_period=2 if self.attn_period else 0,
            ssm_d_state=8,
            ssm_chunk=8,
            n_dec_layers=2 if self.is_encdec else 0,
            frontend_tokens=4 if self.frontend != "none" else 0,
            frontend_dim=64 if self.frontend != "none" else 0,
            head_dim_override=16 if self.head_dim_override else 0,
        )


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> Optional[str]:
    """None if the (arch, shape) cell runs; else the reason it is skipped."""
    if shape.name == "long_500k" and not arch.subquadratic:
        return ("full-attention arch: long_500k needs sub-quadratic "
                "attention")
    return None


def reduced_shape(shape: ShapeConfig) -> ShapeConfig:
    return ShapeConfig(shape.name, min(shape.seq_len, 32),
                       min(shape.global_batch, 2), shape.kind)
