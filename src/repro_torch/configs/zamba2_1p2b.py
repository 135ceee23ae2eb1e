"""zamba2-1.2b [hybrid]: Mamba2 backbone + weight-shared GQA attention blocks.

38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000, ssm_state=64
[arXiv:2411.15242; hf].  Shared attention invoked every 6th layer (6 sites;
real Zamba2 adds per-invocation LoRA, which the JAX package stubs too).
"""
from ..config.base import ModelConfig, SSMConfig
from ..config.registry import register


@register("zamba2-1.2b")
def full() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b", family="hybrid", n_layers=38, d_model=2048,
        n_heads=32, n_kv_heads=32, d_ff=8192, vocab_size=32000,
        ssm=SSMConfig(d_state=64, expand=2, head_dim=64, conv_width=4,
                      chunk=128, n_groups=1, attn_every=6),
        notes="Mamba2 + shared attn; long_500k eligible (hybrid).",
    )


@register("zamba2-1.2b:smoke")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b:smoke", family="hybrid", n_layers=7, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
        ssm=SSMConfig(d_state=16, expand=2, head_dim=16, conv_width=4,
                      chunk=16, n_groups=1, attn_every=3),
    )
