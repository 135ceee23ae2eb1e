"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) d_ff_exp=512
vocab=49155, MoE 40e top-8 [hf:ibm-granite; hf].

Assignment line also says "32 experts top-8"; we implement 40 experts
top-8 per the shape spec, as the JAX package does.  Tied embeddings, head
dim 64, G = 3.
"""
from ..config.base import MoEConfig, ModelConfig
from ..config.registry import register


@register("granite-moe-3b-a800m")
def full() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m", family="moe", n_layers=32, d_model=1536,
        n_heads=24, n_kv_heads=8, d_ff=512, vocab_size=49155,
        head_dim=64, tie_embeddings=True,
        moe=MoEConfig(n_experts=40, top_k=8, d_ff_expert=512,
                      capacity_factor=1.25),
    )


@register("granite-moe-3b-a800m:smoke")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m:smoke", family="moe", n_layers=2,
        d_model=64, n_heads=4, n_kv_heads=2, d_ff=32, vocab_size=255,
        head_dim=16, tie_embeddings=True,
        moe=MoEConfig(n_experts=5, top_k=2, d_ff_expert=32,
                      capacity_factor=2.0),
    )
