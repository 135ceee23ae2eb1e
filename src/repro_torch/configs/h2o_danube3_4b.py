"""h2o-danube-3-4b [dense]: llama+mistral mix with sliding-window attention.

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000 [arXiv:2401.16818;
unverified].  Window 4096 => sub-quadratic, long_500k eligible.
"""
from ..config.base import ModelConfig
from ..config.registry import register


@register("h2o-danube-3-4b")
def full() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b", family="dense", n_layers=24, d_model=3840,
        n_heads=32, n_kv_heads=8, d_ff=10240, vocab_size=32000,
        head_dim=120, sliding_window=4096, rope_theta=500_000.0,
        notes="SWA window 4096; long_500k eligible.",
    )


@register("h2o-danube-3-4b:smoke")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b:smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
        sliding_window=16,
    )
