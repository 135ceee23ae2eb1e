"""deepseek-v2-236b [moe]: MLA (kv_lora=512) + 2 shared / 160 routed top-6.

60L d_model=5120 128H d_ff_expert=1536 vocab=102400 [arXiv:2405.04434; hf].
First layer dense (d_ff=12288 as published).  MLA's prefill runs the flash
kernel at qk head dim nope + rope = 192 (24 at smoke size).
"""
from ..config.base import MLAConfig, MoEConfig, ModelConfig
from ..config.registry import register


@register("deepseek-v2-236b")
def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b", family="moe", n_layers=60, d_model=5120,
        n_heads=128, n_kv_heads=128, d_ff=12288, vocab_size=102400,
        rope_theta=10_000.0,
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64,
                      nope_head_dim=128, v_head_dim=128),
        moe=MoEConfig(n_experts=160, top_k=6, d_ff_expert=1536,
                      n_shared_experts=2, d_ff_shared=1536,
                      capacity_factor=1.25, first_dense_layers=1),
    )


@register("deepseek-v2-236b:smoke")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b:smoke", family="moe", n_layers=3, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
        mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48, rope_head_dim=8,
                      nope_head_dim=16, v_head_dim=16),
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32,
                      n_shared_experts=1, d_ff_shared=32,
                      capacity_factor=2.0, first_dense_layers=1),
    )
