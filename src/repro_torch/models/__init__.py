"""The port's LM stack, every family of the JAX package (dense, vlm,
audio, MoE, MLA, the Mamba2 hybrid, RWKV6): params, layers, attention,
MoE and its expert-parallel form, the Mamba2 and RWKV6 blocks, the decoder
and the converter from the JAX package's flat params."""
