"""qwen3-4b [dense]: 36L d_model=2560 32H (GQA kv=8) d_ff=9728
vocab=151936, qk-norm, head_dim 128 [hf:Qwen/Qwen3 family; hf]."""
from ..config.base import ModelConfig
from ..config.registry import register


@register("qwen3-4b")
def full() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b", family="dense", n_layers=36, d_model=2560,
        n_heads=32, n_kv_heads=8, d_ff=9728, vocab_size=151936,
        head_dim=128, qk_norm=True, rope_theta=1_000_000.0,
    )


@register("qwen3-4b:smoke")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b:smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
        qk_norm=True,
    )
