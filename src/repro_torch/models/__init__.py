"""The port's LM stack, dense GQA family: params, layers, attention, the
decoder and the converter from the JAX package's flat params."""
