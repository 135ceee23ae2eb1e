"""deepseek-coder-33b [dense]: 62L d_model=7168 56H (GQA kv=8) d_ff=19200
vocab=32256, llama-arch [arXiv:2401.14196; hf]."""
from ..config.base import ModelConfig
from ..config.registry import register


@register("deepseek-coder-33b")
def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-33b", family="dense", n_layers=62, d_model=7168,
        n_heads=56, n_kv_heads=8, d_ff=19200, vocab_size=32256,
        head_dim=128, rope_theta=100_000.0,
        notes="56 heads % 16 != 0: head sharding via flat (H*hd) layout.",
    )


@register("deepseek-coder-33b:smoke")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-33b:smoke", family="dense", n_layers=2,
        d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
        head_dim=16,
    )
