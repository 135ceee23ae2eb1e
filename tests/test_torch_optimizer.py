"""The port's AdamW, schedule, clipping, decay mask and int8 round trip
against the JAX package, every family at ``:smoke`` in f32.

* On the same parameters and gradients (JAX keys, numpy), three updates
  at ``learning_rate=1e-3, warmup=2``: parameters within 1e-5, Adam
  moments within 1e-4 of each leaf's largest magnitude.
* Three whole train steps on the same batches, each from JAX's state
  before it (so that one step's rounding does not compound): the loss
  within 1e-4, the moments within 1e-4 of each leaf's largest magnitude,
  the parameters within 1e-5 except where Adam divides a gradient element
  by its own magnitude (``g / (|g| + 1e-8)`` at the first step): an
  element whose gradient lies below the two packages' f32 rounding (~1e-6
  of the largest) may take the opposite sign and move by up to ``2 *
  lr``.  At most 1e-4 of the elements may differ so, each within ``2 *
  lr``.  (Chained over the 3 steps, those few elements move the later
  gradients: zamba2's moments then drift to 1.5e-4.)
* The decay mask read through ``jax_key_of`` equals JAX's on every key of
  every family; the int8 quantizer equals JAX's given JAX's own noise,
  and the port's noise is uniform on [-0.5, 0.5) by the rounding
  frequencies it gives.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch_train_cases import ARCHS, case

from repro_torch.config import RunConfig, get_config
from repro_torch.data import SyntheticTokens
from repro_torch.models import transformer as ttfm
from repro_torch.models.convert import (from_jax_params, from_jax_tree,
                                        jax_key_of, to_jax_params)
from repro_torch.train import (OptState, adamw_init, adamw_update,
                               make_train_step)
from repro_torch.train import optimizer as topt

LR, WARMUP, STEPS = 1e-3, 2, 3


def _scaled(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()) / max(
        float(np.abs(np.asarray(want)).max()), 1e-30)


@pytest.mark.parametrize("arch", ARCHS)
def test_decay_mask_matches_jax(arch):
    from repro.models import transformer as jtfm
    from repro.train import optimizer as jopt

    cfg = get_config(arch, smoke=True)
    keys = set(jtfm.model_defs(case(arch)[1]))
    assert keys == set(ttfm.model_defs(cfg))
    for k in keys:
        assert topt._decay_mask(k) == jopt._decay_mask(k), k
    with torch.device("meta"):
        model = ttfm.Transformer(cfg, RunConfig())
    names = [n for n, _ in model.named_parameters()]
    assert {jax_key_of(n) for n in names} == keys
    assert topt._NO_DECAY_SUBSTRINGS == jopt._NO_DECAY_SUBSTRINGS


def test_schedule_matches_jax():
    import jax.numpy as jnp
    from repro.train import optimizer as jopt

    for warmup, total in ((2, 3), (100, 10_000), (5, 25)):
        for step in (0, 1, 2, 3, 5, 17, 100, 5_000, 10_000, 20_000):
            want = float(jopt.cosine_schedule(jnp.int32(step), 3e-4,
                                              warmup=warmup, total=total))
            got = float(topt.cosine_schedule(step, 3e-4, warmup=warmup,
                                             total=total))
            assert abs(got - want) <= 1e-6 * 3e-4, (warmup, total, step)


def test_clip_matches_jax():
    import jax.numpy as jnp
    from repro.train import optimizer as jopt

    rng = np.random.default_rng(0)
    tree = {f"a{i}": rng.standard_normal((7, i + 1), dtype=np.float32)
            for i in range(5)}
    for max_norm in (0.5, 100.0):
        want, wnorm = jopt.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in tree.items()}, max_norm)
        got, norm = topt.clip_by_global_norm(
            {k: torch.from_numpy(v.copy()) for k, v in tree.items()},
            max_norm)
        assert abs(float(norm) - float(wnorm)) <= 1e-6 * float(wnorm)
        for k in tree:
            assert _scaled(got[k], want[k]) <= 1e-6


def _grads_draws(params, seed):
    rng = np.random.default_rng(seed)
    return [{k: (rng.standard_normal(v.shape) * 0.01).astype(np.float32)
             for k, v in params.items()} for _ in range(STEPS)]


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_matches_jax_on_the_same_grads(arch):
    import jax
    import jax.numpy as jnp
    from repro.config import RunConfig as JaxRun
    from repro.train import optimizer as jopt

    cfg, _, params, _ = case(arch)
    draws = _grads_draws(params, seed=ARCHS.index(arch))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jo = jopt.adamw_init(jp)
    jrun = JaxRun(learning_rate=LR)
    update = jax.jit(lambda p, g, o: jopt.adamw_update(p, g, o, jrun,
                                                       warmup=WARMUP))
    for g in draws:
        jp, jo, _ = update(jp, {k: jnp.asarray(v) for k, v in g.items()}, jo)
    model = from_jax_params(cfg, params, device="cpu", trainable=True)
    pdict = dict(model.named_parameters())
    opt = adamw_init(pdict)
    run = RunConfig(learning_rate=LR)
    for g in draws:
        opt, mets = adamw_update(pdict, from_jax_tree(model, g), opt, run,
                                 warmup=WARMUP)
    assert opt.step == STEPS and mets["lr"] == pytest.approx(
        float(jopt.cosine_schedule(jnp.int32(STEPS), LR, warmup=WARMUP)))
    got = to_jax_params(model)
    m, v = to_jax_params(model, opt.m), to_jax_params(model, opt.v)
    for k in params:
        assert float(np.abs(got[k].numpy() - np.asarray(jp[k])).max()) <= \
            1e-5, k
        assert _scaled(m[k], jo.m[k]) <= 1e-4, k
        assert _scaled(v[k], jo.v[k]) <= 1e-4, k


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_jax(arch):
    import jax
    import jax.numpy as jnp
    from repro.config import RunConfig as JaxRun
    from repro.train import adamw_init as jax_adamw_init
    from repro.train import make_train_step as jax_make_train_step

    cfg, jcfg, params, _ = case(arch)
    rng = np.random.default_rng(50 + ARCHS.index(arch))
    batches = []
    for _ in range(STEPS):
        b = {"tokens": rng.integers(0, cfg.vocab_size, (2, 17)).astype(
            np.int32)}
        if cfg.n_prefix_embeds:
            b["prefix_embeds"] = rng.standard_normal(
                (2, cfg.n_prefix_embeds, cfg.d_model), dtype=np.float32)
        batches.append(b)
    kw = dict(attention_impl="dense", remat="none", compute_dtype="float32",
              learning_rate=LR)
    jstep = jax.jit(jax_make_train_step(jcfg, JaxRun(**kw), warmup=WARMUP))
    run = RunConfig(**kw)
    model = from_jax_params(cfg, params, run=run, device="cpu",
                            trainable=True)
    pdict = dict(model.named_parameters())
    step = make_train_step(cfg, run, warmup=WARMUP)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jo = jax_adamw_init(jp)
    for i, b in enumerate(batches):
        # the port's step from JAX's state before step i
        with torch.no_grad():
            for name, val in from_jax_tree(model, jp).items():
                pdict[name].copy_(val)
        opt = OptState(step=i, m=from_jax_tree(model, jo.m),
                       v=from_jax_tree(model, jo.v))
        model, opt, mets = step(model, opt, {k: torch.from_numpy(v)
                                             for k, v in b.items()})
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()})
        assert abs(float(mets["loss"]) - float(jm["loss"])) <= 1e-4 * max(
            1.0, abs(float(jm["loss"])))
        assert mets["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
        for tree, want in ((opt.m, jo.m), (opt.v, jo.v)):
            tree = to_jax_params(model, tree)
            for k in params:
                assert _scaled(tree[k], want[k]) <= 1e-4, (i, k)
        got = to_jax_params(model)
        off, total = 0, 0
        for k in params:
            diff = np.abs(got[k].numpy() - np.asarray(jp[k]))
            assert float(diff.max()) <= 2 * float(jm["lr"]), (i, k)
            off += int((diff > 1e-5).sum())
            total += diff.size
        assert off <= 1e-4 * total, (i, off, total)


def _jax_noise(grads, key):
    """JAX's int8 noise, as ``compress_grads_int8`` draws it."""
    import jax

    return {k: np.asarray(jax.random.uniform(
        jax.random.fold_in(key, i), grads[k].shape, minval=-0.5, maxval=0.5))
        for i, k in enumerate(sorted(grads))}


def test_int8_matches_jax_with_the_same_noise():
    import jax
    import jax.numpy as jnp
    from repro.train import optimizer as jopt

    rng = np.random.default_rng(3)
    grads = {"b/x": rng.standard_normal((33, 9), dtype=np.float32),
             "a": (rng.standard_normal(70) * 1e-3).astype(np.float32),
             "zero": np.zeros(5, np.float32)}
    key = jax.random.fold_in(jax.random.PRNGKey(17), 4)
    want = jopt.compress_grads_int8({k: jnp.asarray(v)
                                     for k, v in grads.items()}, key)
    noise = _jax_noise(grads, key)
    got = topt.compress_grads_int8(
        {k: torch.from_numpy(v) for k, v in grads.items()},
        noise={k: torch.from_numpy(v) for k, v in noise.items()})
    for k in grads:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("frac", [0.1, 0.25, 0.5, 0.8])
def test_int8_noise_is_uniform(frac):
    """With scale 1 (one element at 127), ``frac`` rounds up exactly when
    the noise is >= 0.5 - frac: a uniform noise on [-0.5, 0.5) does so
    with probability ``frac`` (4 standard deviations over 200,000)."""
    n = 200_000
    g = torch.full((n + 1,), frac)
    g[-1] = 127.0
    gen = torch.Generator().manual_seed(0)
    q = topt.compress_grads_int8({"g": g}, gen)["g"][:-1]
    assert set(q.unique().tolist()) <= {0.0, 1.0}
    sd = (frac * (1 - frac) / n) ** 0.5
    assert abs(float(q.mean()) - frac) <= 4 * sd
    again = topt.compress_grads_int8({"g": g},
                                     torch.Generator().manual_seed(0))["g"]
    assert torch.equal(again[:-1], q)


@pytest.mark.parametrize("impl,compression,microbatch",
                         [("flash", "none", 2), ("chunked_causal", "int8",
                                                 None)])
def test_train_loop_learns(impl, compression, microbatch):
    """As the JAX package's own tests: 25 steps on the synthetic stream
    (vocab 64) bring the loss down."""
    cfg = dataclasses.replace(get_config("qwen3-4b", smoke=True),
                              vocab_size=64)
    run = RunConfig(attention_impl=impl, attention_chunk=16, remat="full",
                    learning_rate=1e-3, grad_compression=compression)
    model = from_jax_params(cfg, ttfm.init_model(
        cfg, torch.Generator().manual_seed(0)), run=run, device="cpu",
        trainable=True)
    opt = adamw_init(dict(model.named_parameters()))
    step = make_train_step(cfg, run, microbatch=microbatch, warmup=5)
    ds = SyntheticTokens(vocab_size=64, seq_len=32, global_batch=8)
    losses = []
    for i in range(25):
        model, opt, mets = step(model, opt, {"tokens": torch.from_numpy(
            ds.batch_at(i))})
        losses.append(float(mets["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.15, losses[::6]
