"""The port's LM stack, the attention families (dense, vlm, audio, MoE,
MLA): params, layers, attention, MoE and its expert-parallel form, the
decoder and the converter from the JAX package's flat params."""
