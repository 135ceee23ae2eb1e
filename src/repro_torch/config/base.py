"""Config dataclasses of the port's LM stack.

A copy of the model half of :mod:`repro.config.base` (``ModelConfig`` and
its sub-configs, unchanged, so the two packages describe one architecture
by the same numbers), ``ShapeConfig`` and the ``SHAPES`` table (equal to
JAX's), and a :class:`RunConfig` holding what the serving and training
paths read.  Plain Python; imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    first_dense_layers: int = 0  # leading dense layers (deepseek-v2 uses 1)
    router_aux_weight: float = 0.001


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    expand: int = 2
    head_dim: int = 64
    conv_width: int = 4
    chunk: int = 64
    n_groups: int = 1
    attn_every: int = 6  # zamba2: shared attention block every k SSM layers


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64
    gate_lora: int = 32
    chunk: int = 32


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    sliding_window: Optional[int] = None
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    # modality frontend stubs (assignment: backbone only)
    n_prefix_embeds: int = 0  # vlm: precomputed patch embeddings prepended
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def attention_free(self) -> bool:
        return self.rwkv is not None

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k decode (assignment rule)."""
        return (
            self.rwkv is not None
            or self.ssm is not None
            or self.sliding_window is not None
        )

    def param_count(self) -> int:
        """Analytic parameter count (used for 6·N·D roofline bookkeeping)."""
        d, hd = self.d_model, self.resolved_head_dim
        n_q, n_kv = self.n_heads, self.n_kv_heads
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.rwkv is not None:
            # time-mix (r,k,v,w,g,o) + channel-mix, LoRA extras approximated
            per_layer = 6 * d * d + 2 * d * self.d_ff + 2 * d * self.rwkv.decay_lora
        elif self.ssm is not None:
            di = self.ssm.expand * d
            conv_dim = di + 2 * self.ssm.n_groups * self.ssm.d_state
            per_layer = d * (2 * di + 2 * self.ssm.n_groups * self.ssm.d_state
                             + di // self.ssm.head_dim) + di * d + conv_dim * self.ssm.conv_width
            n_attn = self.n_layers // self.ssm.attn_every
            attn = 2 * d * (n_q * hd) + 2 * d * (n_kv * hd) + 3 * d * self.d_ff
            return emb + per_layer * self.n_layers + attn + n_attn * 0
        elif self.mla is not None:
            m = self.mla
            per_layer = (
                d * m.q_lora_rank
                + m.q_lora_rank * n_q * (m.nope_head_dim + m.rope_head_dim)
                + d * (m.kv_lora_rank + m.rope_head_dim)
                + m.kv_lora_rank * n_q * (m.nope_head_dim + m.v_head_dim)
                + n_q * m.v_head_dim * d
            )
        else:
            per_layer = d * n_q * hd + 2 * d * n_kv * hd + n_q * hd * d
        if self.moe is not None:
            mo = self.moe
            moe_layers = self.n_layers - mo.first_dense_layers
            ffn = (
                moe_layers * mo.n_experts * 3 * d * mo.d_ff_expert
                + moe_layers * mo.n_shared_experts * 3 * d * mo.d_ff_shared
                + mo.first_dense_layers * 3 * d * self.d_ff
                + moe_layers * mo.n_experts * 0
            )
        elif self.rwkv is None and self.ssm is None:
            ffn = self.n_layers * 3 * d * self.d_ff
        else:
            ffn = 0 if self.ssm is not None else 0
        return emb + per_layer * self.n_layers + ffn

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top-k + shared only)."""
        if self.moe is None:
            return self.param_count()
        mo = self.moe
        full = self.param_count()
        moe_layers = self.n_layers - mo.first_dense_layers
        all_experts = moe_layers * mo.n_experts * 3 * self.d_model * mo.d_ff_expert
        active = moe_layers * mo.top_k * 3 * self.d_model * mo.d_ff_expert
        return full - all_experts + active


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: Literal["train", "prefill", "decode"]
    seq_len: int
    global_batch: int


#: The assignment's four shape cells (JAX's ``SHAPES``).
SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}

ATTENTION_IMPLS = ("flash", "dense", "chunked", "chunked_causal")


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Knobs orthogonal to the architecture: attention, remat, the
    optimizer, dtypes and MoE dispatch.

    ``attention_impl``: ``"flash"`` is the hand-written CUDA flash kernel
    (JAX's ``"pallas"``; on a CPU tensor its plain version runs; under
    autograd its backward recomputes through the ``"chunked_causal"``
    twin), ``"dense"`` the rectangular einsum reference, ``"chunked"`` and
    ``"chunked_causal"`` JAX's flash-style twins in torch ops (an online
    softmax over ``attention_chunk``-key blocks; the causal one skips the
    blocks no query of a row sees, by position).  ``"flash"`` stays the
    port's default; JAX's is ``"chunked_causal"``.  Single-token decode
    always takes the einsum decode path (MLA: the absorbed path), as in
    JAX.  ``remat_attention`` checkpoints each query row of the twins.

    ``remat``: ``"full"`` recomputes each block in the backward (the flash
    kernel's output excepted, :mod:`repro_torch.models.transformer`),
    ``"dots"`` keeps the matmul outputs and recomputes the rest,
    ``"none"`` keeps everything.  The optimizer fields, ``grad_compression``
    and ``microbatch`` are JAX's, with JAX's defaults
    (:mod:`repro_torch.train`), and so are the sharding toggles
    ``fsdp_axis``, ``seq_shard_decode`` and ``act_shard_model``
    (:func:`repro_torch.launch.specs.make_cell_rules` reads them).

    ``moe_groups`` and ``moe_dense_eval`` are JAX's MoE dispatch knobs
    (:func:`repro_torch.models.moe.moe_apply`), with JAX's defaults: one
    flat capacity buffer, and the dispatch (not every expert on every
    token).
    """

    attention_impl: Literal["flash", "dense", "chunked",
                            "chunked_causal"] = "flash"
    attention_chunk: int = 1024
    remat: Literal["none", "full", "dots"] = "full"
    remat_attention: bool = False
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    adam_b1: float = 0.9
    adam_b2: float = 0.95
    grad_compression: Literal["none", "int8"] = "none"
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # sharding toggles (JAX's): the weights' second axis, the long-decode
    # cache's sequence over the batch axes, the residual stream's
    # features over the model axis
    fsdp_axis: Optional[str] = "data"
    seq_shard_decode: bool = True
    act_shard_model: bool = False
    microbatch: Optional[int] = None  # gradient-accumulation steps
    moe_groups: Optional[int] = None  # GShard grouped dispatch (None = flat)
    moe_dense_eval: bool = False  # all experts on every token, no dispatch

    def __post_init__(self):
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(
                f"unknown attention impl {self.attention_impl!r}; the port "
                f"has {ATTENTION_IMPLS} ('flash' is JAX's 'pallas')")
        if self.attention_chunk < 1:
            raise ValueError(f"attention_chunk must be >= 1, got "
                             f"{self.attention_chunk}")
        if self.remat not in ("none", "full", "dots"):
            raise ValueError(f"unknown remat {self.remat!r}")
        if self.grad_compression not in ("none", "int8"):
            raise ValueError(f"unknown grad_compression "
                             f"{self.grad_compression!r}")
        if self.microbatch is not None and self.microbatch < 1:
            raise ValueError(f"microbatch must be >= 1 or None, got "
                             f"{self.microbatch}")
        if self.moe_groups is not None and self.moe_groups < 1:
            raise ValueError(f"moe_groups must be >= 1 or None, got "
                             f"{self.moe_groups}")
