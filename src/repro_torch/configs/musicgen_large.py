"""musicgen-large [audio]: decoder-only over EnCodec tokens.

48L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=2048 [arXiv:2306.05284;
hf].  EnCodec quantizer + 4-codebook delay pattern STUBBED to a single
token stream (tokens ARE the input), as in the JAX package.
"""
from ..config.base import ModelConfig
from ..config.registry import register


@register("musicgen-large")
def full() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large", family="audio", n_layers=48, d_model=2048,
        n_heads=32, n_kv_heads=32, d_ff=8192, vocab_size=2048,
        notes="EnCodec frontend stub; full attention => long_500k skipped.",
    )


@register("musicgen-large:smoke")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large:smoke", family="audio", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=64,
    )
