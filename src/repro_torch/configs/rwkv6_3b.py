"""rwkv6-3b [ssm]: Finch — attention-free, data-dependent decay.

32L d_model=2560 d_ff=8960 vocab=65536 [arXiv:2404.05892; hf].
O(1) state per token => long_500k eligible.
"""
from ..config.base import ModelConfig, RWKVConfig
from ..config.registry import register


@register("rwkv6-3b")
def full() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b", family="ssm", n_layers=32, d_model=2560,
        n_heads=40, n_kv_heads=40, d_ff=8960, vocab_size=65536,
        rwkv=RWKVConfig(head_dim=64, decay_lora=64, chunk=32),
        notes="attention-free; census technique n/a to model math.",
    )


@register("rwkv6-3b:smoke")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b:smoke", family="ssm", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
        rwkv=RWKVConfig(head_dim=16, decay_lora=8, chunk=8),
    )
