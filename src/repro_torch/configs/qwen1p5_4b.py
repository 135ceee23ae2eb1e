"""qwen1.5-4b [dense]: 40L d_model=2560 20H (GQA kv=20) d_ff=6912
vocab=151936, QKV bias [hf:Qwen/Qwen1.5-0.5B family; hf]."""
from ..config.base import ModelConfig
from ..config.registry import register


@register("qwen1.5-4b")
def full() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-4b", family="dense", n_layers=40, d_model=2560,
        n_heads=20, n_kv_heads=20, d_ff=6912, vocab_size=151936,
        qkv_bias=True, rope_theta=1_000_000.0,
        notes="20 heads % 16 != 0: head sharding via flat (H*hd) layout.",
    )


@register("qwen1.5-4b:smoke")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-4b:smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256, qkv_bias=True,
    )
