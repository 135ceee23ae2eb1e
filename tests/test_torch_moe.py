"""The port's MoE layer (:mod:`repro_torch.models.moe`) against the JAX
package's (:mod:`repro.models.moe`) at smoke size: the same numpy-drawn
weights and activations in float32 through both.

Held exactly: the capacity slot of every (token, slot) pair (a stable
sort, so the same pairs are dropped) and the keep masks, under hypothesis
over expert ids and capacities, and the dropped pairs at capacity factor
0.5.  Held within 1e-5: the layer's output in the flat dispatch, in
``groups=2`` and in ``dense_eval``; within 1e-6: the Switch loss.  No
bf16 comparison: a bf16 router flips near-tied top-k choices, so JAX's
own bf16 layer differs from its f32 one by whole expert outputs.  The
layer holds no kernel: its card run is ``chip_smoke.py``'s.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.config import get_config as jax_get_config
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro_torch.config import RunConfig, get_config
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import from_jax_params

ARCHS = ("deepseek-v2-236b", "granite-moe-3b-a800m")


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


def _setup(arch, cf=None, seed=0):
    """(port cfg, JAX cfg, the first MoE block's numpy params, the port's
    MoE module holding them, numpy x (4, 8, d))."""
    jcfg, cfg = jax_get_config(arch, smoke=True), get_config(arch, smoke=True)
    if cf is not None:
        jcfg, cfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=cf)) for c in (jcfg, cfg))
    params = {k: np.asarray(v) for k, v in jtfm.init_model(
        jcfg, jax.random.PRNGKey(seed)).items()}
    sub = {k[len("layers/"):]: v[0] for k, v in params.items()
           if k.startswith("layers/")}
    model = from_jax_params(cfg, params, run=RunConfig(
        compute_dtype="float32"), device="cpu")
    x = np.random.default_rng(seed + 1).standard_normal(
        (4, 8, cfg.d_model), dtype=np.float32)
    return cfg, jcfg, sub, model.layers[0].moe, x


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 9).flatmap(lambda e: st.tuples(
    st.just(e), st.lists(st.integers(0, e - 1), min_size=1, max_size=96),
    st.integers(1, 12))))
def test_positions_in_expert_and_keep_match_jax(case):
    """Every pair's slot in its expert's queue, and which pairs a capacity
    keeps, exactly as JAX's stable-sort positions."""
    n_experts, ids, cap = case
    want = np.asarray(jmoe._positions_in_expert(
        jnp.asarray(ids, jnp.int32), n_experts))
    got = tmoe.positions_in_expert(torch.tensor(ids, dtype=torch.int64))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy() < cap, want < cap)
    # grouped: each row sorted on its own, as JAX vmaps it
    rows = torch.tensor([ids, ids[::-1]], dtype=torch.int64)
    want_rows = np.asarray(jax.vmap(jmoe._positions_in_expert, (0, None))(
        jnp.asarray(rows.numpy(), jnp.int32), n_experts))
    np.testing.assert_array_equal(tmoe.positions_in_expert(rows).numpy(),
                                  want_rows)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ["flat", "groups2", "dense_eval"])
def test_moe_apply_matches_jax(arch, mode):
    cfg, jcfg, sub, moe, x = _setup(arch)
    kw = {"flat": {}, "groups2": dict(groups=2),
          "dense_eval": dict(dense_eval=True)}[mode]
    want, jaux = jmoe.moe_apply(jcfg, {k: jnp.asarray(v) for k, v in
                                       sub.items()}, "moe/", jnp.asarray(x),
                                **kw)
    with torch.inference_mode():
        got, aux = tmoe.moe_apply(moe, torch.from_numpy(x), **kw)
    assert got.shape == x.shape and got.dtype == torch.float32
    assert _err(got, want) <= 1e-5
    assert abs(float(aux) - float(jaux)) <= 1e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_drops_match_jax(arch):
    """At capacity factor 0.5 pairs are dropped: the same pairs as JAX's
    (the keep mask from the same routing), and the same output."""
    cfg, jcfg, sub, moe, x = _setup(arch, cf=0.5)
    jp = {k: jnp.asarray(v) for k, v in sub.items()}
    n, k = x.shape[0] * x.shape[1], cfg.moe.top_k
    cap = tmoe.capacity(n, cfg)
    assert cap == max(1, int(np.ceil(n * k / cfg.moe.n_experts * 0.5)))
    xf = x.reshape(n, -1)
    jprobs = jax.nn.softmax((jnp.asarray(xf) @ jp["moe/router"]), -1)
    _, jids = jax.lax.top_k(jprobs, k)
    jkeep = np.asarray(jmoe._positions_in_expert(
        jids.reshape(-1), cfg.moe.n_experts)) < cap
    _, _, ids = tmoe.route(torch.from_numpy(xf), moe.router, k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    keep = (tmoe.positions_in_expert(ids.reshape(-1)) < cap).numpy()
    np.testing.assert_array_equal(keep, jkeep)
    assert 0 < keep.sum() < keep.size  # some dropped, some kept
    want, jaux = jmoe.moe_apply(jcfg, jp, "moe/", jnp.asarray(x))
    with torch.inference_mode():
        got, aux = tmoe.moe_apply(moe, torch.from_numpy(x))
    assert _err(got, want) <= 1e-5
    assert abs(float(aux) - float(jaux)) <= 1e-6


def test_everything_dropped_leaves_the_shared_experts():
    """At a vanishing capacity factor every routed pair but the first of
    each expert drops; granite (no shared experts) still gives finite
    output, equal to JAX's."""
    cfg, jcfg, sub, moe, x = _setup("granite-moe-3b-a800m", cf=1e-6)
    want, _ = jmoe.moe_apply(jcfg, {k: jnp.asarray(v) for k, v in
                                    sub.items()}, "moe/", jnp.asarray(x))
    with torch.inference_mode():
        got, aux = tmoe.moe_apply(moe, torch.from_numpy(x))
    assert torch.isfinite(got).all() and np.isfinite(float(aux))
    assert _err(got, want) <= 1e-5


def test_groups_must_divide_the_tokens():
    _, _, _, moe, x = _setup("granite-moe-3b-a800m")
    with pytest.raises(ValueError, match="groups"):
        tmoe.moe_apply(moe, torch.from_numpy(x), groups=3)
    with pytest.raises(ValueError, match="moe_groups"):
        RunConfig(moe_groups=0)
