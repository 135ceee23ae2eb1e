"""Shared cases of the port's training tests: every family at ``:smoke``,
JAX's weights with the leaves JAX initialises to 0 or 1 redrawn so that
their gradients count, a numpy-drawn batch, and both packages' loss and
gradients on them (JAX-keyed numpy)."""
import functools

import numpy as np
import torch

from repro_torch.config import RunConfig, get_config, list_configs
from repro_torch.models.convert import from_jax_params, to_jax_params
from repro_torch.train import make_grad_fn

ARCHS = list_configs()
B, T = 2, 32
# leaves JAX initialises to 0 or 1 -> the value they are drawn around
# (std 0.5); biases from N(0, 1), RWKV's token-shift mixes in [0, 1)
DRAWN = {"A_log": 0.0, "dt_bias": 0.0, "D": 1.0, "w0": 0.0, "u": 0.0,
         "ln_x": 1.0}
# port impl -> the JAX impl it is held to
HELD_TO = {"chunked_causal": "chunked_causal", "dense": "dense",
           "flash": "chunked_causal"}


@functools.lru_cache(maxsize=None)
def case(arch):
    """(port cfg, JAX cfg, numpy params, numpy batch) of one family."""
    import jax
    from repro.config import get_config as jax_get_config
    from repro.models import transformer as jtfm

    i = ARCHS.index(arch)
    jcfg = jax_get_config(arch, smoke=True)
    params = {k: np.asarray(v) for k, v in jtfm.init_model(
        jcfg, jax.random.PRNGKey(30 + i)).items()}
    rng = np.random.default_rng(40 + i)
    for k in sorted(params):
        name = k.split("/")[-1]
        if name in ("bq", "bk", "bv"):
            params[k] = rng.standard_normal(params[k].shape, dtype=np.float32)
        elif name in DRAWN:
            params[k] = (DRAWN[name] + rng.standard_normal(
                params[k].shape) * 0.5).astype(np.float32)
        elif name.startswith("mu_"):
            params[k] = rng.uniform(0, 1, params[k].shape).astype(np.float32)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (B, T + 1)).astype(
        np.int32)}
    if jcfg.n_prefix_embeds:
        batch["prefix_embeds"] = rng.standard_normal(
            (B, jcfg.n_prefix_embeds, jcfg.d_model), dtype=np.float32)
    return get_config(arch, smoke=True), jcfg, params, batch


@functools.lru_cache(maxsize=None)
def jax_value_and_grad(arch, impl):
    """JAX's loss and gradients (numpy) at ``impl``, chunk 16, no remat."""
    import jax
    import jax.numpy as jnp
    from repro.config import RunConfig as JaxRun
    from repro.train.train_step import make_loss_fn as jax_loss_fn

    _, jcfg, params, batch = case(arch)
    run = JaxRun(attention_impl=impl, attention_chunk=16, remat="none",
                 compute_dtype="float32")
    f = jax.jit(jax.value_and_grad(jax_loss_fn(jcfg, run), has_aux=True))
    (loss, _), grads = f({k: jnp.asarray(v) for k, v in params.items()},
                         {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


def port(arch, impl, remat="none", microbatch=None, batch=None):
    """The port's (loss, metrics, JAX-keyed numpy gradients)."""
    cfg, _, params, b = case(arch)
    run = RunConfig(attention_impl=impl, attention_chunk=16, remat=remat,
                    compute_dtype="float32")
    model = from_jax_params(cfg, params, run=run, device="cpu",
                            trainable=True)
    b = b if batch is None else batch
    loss, mets, grads = make_grad_fn(cfg, run, microbatch=microbatch)(
        model, {k: torch.from_numpy(v) for k, v in b.items()})
    return float(loss), mets, {k: v.numpy() for k, v in to_jax_params(
        model, grads).items()}


def scaled_errs(got, want, floor=1e-3):
    """Per leaf: max |got - want| over that leaf's largest |want| (at least
    ``floor`` times the largest of all leaves)."""
    top = max(float(np.abs(w).max()) for w in want.values())
    return {k: float(np.abs(got[k] - w).max())
            / max(float(np.abs(w).max()), floor * top)
            for k, w in want.items()}
