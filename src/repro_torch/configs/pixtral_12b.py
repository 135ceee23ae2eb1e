"""pixtral-12b [vlm]: mistral-nemo decoder backbone; ViT frontend STUBBED.

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072
[hf:mistralai/Pixtral-12B-2409; unverified].  input_specs() supplies
precomputed patch embeddings (B, 1024, d) prepended to text tokens.
"""
from ..config.base import ModelConfig
from ..config.registry import register


@register("pixtral-12b")
def full() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b", family="vlm", n_layers=40, d_model=5120,
        n_heads=32, n_kv_heads=8, d_ff=14336, vocab_size=131072,
        head_dim=128, rope_theta=1_000_000.0, n_prefix_embeds=1024,
        notes="vision frontend stub: precomputed patch embeddings input.",
    )


@register("pixtral-12b:smoke")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b:smoke", family="vlm", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
        n_prefix_embeds=8,
    )
