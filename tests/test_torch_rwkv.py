"""The port's RWKV6 block (``repro_torch.models.rwkv``) against the JAX
package's (``repro.models.rwkv``), and its chunked scan against the exact
recurrence.

Inputs are drawn with numpy and handed to both packages, in float32.
Tolerances: 1e-4 against JAX (f32 einsums summed in another order), 1e-5
on the cache leaves, 1e-3 chunked against recurrent
(``tests/test_recurrences.py``'s bound), exact for the token shift.  The
JAX package is imported inside the tests that compare with it, so the
CUDA case also runs on a machine with the card and no JAX:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_rwkv.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.config import get_config
from repro_torch.models import rwkv as trwkv
from repro_torch.models.convert import from_jax_params
from repro_torch.models.transformer import init_cache, model_defs

ARCH = "rwkv6-3b"


def _jax():
    """(jax.numpy, repro.models.rwkv)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.models import rwkv as jrwkv
    return jnp, jrwkv


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


def _wkv_inputs(B, T, H, D, seed, w_log=None):
    """float32 numpy r, k, v, w_log (negative), u, as
    ``tests/test_recurrences.py`` draws them."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, D), dtype=np.float32)
               for _ in range(3))
    if w_log is None:
        w_log = -np.exp(rng.standard_normal((B, T, H, D)) * 0.5)
    else:
        w_log = np.full((B, T, H, D), w_log)
    u = rng.standard_normal((H, D)) * 0.1
    return r, k, v, w_log.astype(np.float32), u.astype(np.float32)


def _state(B, H, D, seed):
    return np.random.default_rng(seed).standard_normal((B, H, D, D),
                                                       dtype=np.float32)


@pytest.mark.parametrize("with_prev", [False, True], ids=["zeros", "prev"])
def test_shift_matches_jax(with_prev):
    jnp, jrwkv = _jax()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 8), dtype=np.float32)
    prev = rng.standard_normal((2, 8), dtype=np.float32) if with_prev \
        else None
    want = jrwkv._shift(jnp.asarray(x),
                        None if prev is None else jnp.asarray(prev))
    got = trwkv._shift(torch.from_numpy(x),
                       None if prev is None else torch.from_numpy(prev))
    assert _err(got, want) == 0


@pytest.mark.parametrize("chunk", [4, 8, 16, 32])
@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "state"])
def test_wkv_chunked_matches_jax(chunk, with_state):
    jnp, jrwkv = _jax()
    arrays = _wkv_inputs(2, 32, 3, 8, seed=chunk)
    st = _state(2, 3, 8, seed=9) if with_state else None
    want_o, want_s = jrwkv.wkv_chunked(
        *map(jnp.asarray, arrays), chunk,
        None if st is None else jnp.asarray(st))
    got_o, got_s = trwkv.wkv_chunked(
        *map(torch.from_numpy, arrays), chunk,
        None if st is None else torch.from_numpy(st))
    assert got_o.dtype == got_s.dtype == torch.float32
    assert _err(got_o, want_o) <= 1e-4
    assert _err(got_s, want_s) <= 1e-4


@pytest.mark.parametrize("T", [1, 12])
@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "state"])
def test_wkv_recurrent_matches_jax(T, with_state):
    jnp, jrwkv = _jax()
    arrays = _wkv_inputs(2, T, 3, 8, seed=T)
    st = _state(2, 3, 8, seed=10) if with_state else None
    want_o, want_s = jrwkv.wkv_recurrent(
        *map(jnp.asarray, arrays), None if st is None else jnp.asarray(st))
    got_o, got_s = trwkv.wkv_recurrent(
        *map(torch.from_numpy, arrays),
        None if st is None else torch.from_numpy(st))
    assert _err(got_o, want_o) <= 1e-4
    assert _err(got_s, want_s) <= 1e-4


@pytest.mark.parametrize("chunk", [8, 16])
def test_wkv_chunked_matches_recurrent(chunk):
    t = list(map(torch.from_numpy, _wkv_inputs(2, 32, 3, 8, seed=2)))
    o, S = trwkv.wkv_chunked(*t, chunk)
    o_ref, S_ref = trwkv.wkv_recurrent(*t)
    assert float((o - o_ref).abs().max()) <= 1e-3
    assert float((S - S_ref).abs().max()) <= 1e-3


def test_wkv_extreme_decay_stays_finite():
    """w_log = -50 (near-total forgetting) over 16-step chunks: finite, and
    equal to the recurrence."""
    t = list(map(torch.from_numpy, _wkv_inputs(1, 64, 2, 8, seed=3,
                                               w_log=-50.0)))
    t[4] = torch.zeros_like(t[4])
    o, S = trwkv.wkv_chunked(*t, 16)
    assert bool(torch.isfinite(o).all() and torch.isfinite(S).all())
    o_ref, _ = trwkv.wkv_recurrent(*t)
    assert float((o - o_ref).abs().max()) <= 1e-3


@pytest.mark.parametrize("T,chunk", [(20, 8), (37, 16), (5, 4)])
def test_ragged_length_matches_the_recurrence(T, chunk):
    """A last chunk shorter than the others equals the recurrence; the JAX
    package reshapes T into whole chunks and cannot run these lengths."""
    jnp, jrwkv = _jax()
    arrays = _wkv_inputs(2, T, 3, 8, seed=T)
    with pytest.raises(TypeError, match="reshape"):
        jrwkv.wkv_chunked(*map(jnp.asarray, arrays), chunk)
    t = list(map(torch.from_numpy, arrays))
    st = torch.from_numpy(_state(2, 3, 8, seed=T))
    o, S = trwkv.wkv_chunked(*t, chunk, st)
    o_ref, S_ref = trwkv.wkv_recurrent(*t, st)
    assert o.shape == (2, T, 3, 8)
    assert float((o - o_ref).abs().max()) <= 1e-3
    assert float((S - S_ref).abs().max()) <= 1e-3


@pytest.fixture(scope="module")
def mix():
    """(port cfg, JAX cfg, numpy params of one RWKV block's ``mix/``
    table) at smoke size; the zero- and one-initialised mixes, w0, u and
    ln_x drawn so that they count."""
    _, jrwkv = _jax()
    from repro.config import get_config as jax_get_config
    cfg, jcfg = get_config(ARCH, smoke=True), jax_get_config(ARCH,
                                                             smoke=True)
    rng = np.random.default_rng(12)
    p = {}
    for k, d in jrwkv.rwkv_defs(jcfg).items():
        if k.startswith("mu_"):
            p[k] = rng.uniform(0, 1, d.shape)
        elif len(d.shape) == 1:
            p[k] = rng.standard_normal(d.shape) * 0.5 + (k == "ln_x")
        else:
            p[k] = rng.standard_normal(d.shape) / np.sqrt(d.shape[0])
    return cfg, jcfg, {k: v.astype(np.float32) for k, v in p.items()}


def _port_block(cfg, p):
    """The port's one-layer RWKV block holding ``p`` through the
    converter."""
    one = dataclasses.replace(cfg, n_layers=1)
    params = {k: np.zeros(d.shape, np.float32)
              for k, d in model_defs(one).items()}
    params.update({f"layers/mix/{k}": v[None] for k, v in p.items()})
    return from_jax_params(one, params, device="cpu").layers[0]


@pytest.mark.parametrize("T", [1, 16, 20])
@pytest.mark.parametrize("with_cache", [False, True], ids=["nocache",
                                                           "cache"])
def test_time_and_channel_mix_match_jax(mix, T, with_cache):
    """``TimeMix`` and ``ChannelMix`` against JAX's ``time_mix_apply`` and
    ``channel_mix_apply``: outputs, and with a cache of drawn leaves the
    new ``state``, ``x_tm`` and ``x_cm``, written in place.  T = 1 with a
    cache is the recurrent decode path; T = 20 is ragged for the chunk of
    8, so JAX runs it as one chunk (``chunk`` raised to T) and the port in
    three."""
    jnp, jrwkv = _jax()
    cfg, jcfg, p = mix
    if T == 20:
        jcfg = dataclasses.replace(jcfg, rwkv=dataclasses.replace(
            jcfg.rwkv, chunk=T))
    rng = np.random.default_rng(T)
    x = rng.standard_normal((2, T, cfg.d_model), dtype=np.float32)
    cache = jcache = None
    if with_cache:
        cache = {k: v[0] for k, v in init_cache(
            dataclasses.replace(cfg, n_layers=1), 2, 8, dtype=torch.float32,
            device="cpu").items()}
        for v in cache.values():
            v.copy_(torch.from_numpy(rng.standard_normal(
                tuple(v.shape), dtype=np.float32)))
        # copies: JAX may alias a numpy buffer and read it after the port
        # has written the cache in place
        jcache = {k: jnp.asarray(v.numpy().copy()) for k, v in cache.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    blk = _port_block(cfg, p)
    for name, japply, mod in (
            ("time", jrwkv.time_mix_apply, blk.time_mix),
            ("channel", jrwkv.channel_mix_apply, blk.channel_mix)):
        want, jnew = japply(jcfg, jp, "", jnp.asarray(x), jcache)
        with torch.inference_mode():
            got, new = mod(torch.from_numpy(x), cache)
        assert _err(got, want) <= 1e-4, name
        if with_cache:
            assert new is cache
            for k, v in jnew.items():
                assert _err(cache[k], v) <= 1e-5, (name, k)


@pytest.mark.cuda
def test_wkv_on_the_card_matches_the_recurrence(cuda_device):
    """rwkv6-3b's full-width scan (H 40, D 64, chunk 32) on the card at a
    ragged T against the recurrence on the card (f32, no TF32), within
    1e-3 scaled by the largest magnitude."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(ARCH)
    H, D = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim
    t = [torch.from_numpy(a).to(cuda_device)
         for a in _wkv_inputs(1, 300, H, D, seed=5)]
    o, S = trwkv.wkv_chunked(*t, cfg.rwkv.chunk)
    o_ref, S_ref = trwkv.wkv_recurrent(*t)
    for got, want in ((o, o_ref), (S, S_ref)):
        scale = max(float(want.abs().max()), 1.0)
        assert float((got - want).abs().max()) <= 1e-3 * scale
