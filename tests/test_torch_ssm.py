"""The port's Mamba2 block (``repro_torch.models.ssm``) against the JAX
package's (``repro.models.ssm``) and against the step-by-step recurrence.

Inputs are drawn with numpy and handed to both packages, in float32.
Tolerances: 1e-4 against JAX (f32 einsums summed in another order) and
against the recurrence (``tests/test_recurrences.py``'s SSD bound; of the
largest magnitude where outputs reach ~20 or more), 1e-5 on the cache
leaves, 1e-6 on the conv.  The JAX package is imported inside the tests that compare
with it, so the CUDA case also runs on a machine with the card and no JAX:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_ssm.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.config import get_config
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import from_jax_params
from repro_torch.models.transformer import init_cache, model_defs

ARCH = "zamba2-1.2b"


def _jax():
    """(jax.numpy, repro.models.ssm)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.models import ssm as jssm
    return jnp, jssm


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


def _scan_inputs(B, T, H, P, N, seed, dt_scale=1.0):
    """float32 numpy x, dt (softplus of a normal), a (negative), B, C."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, H, P), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, T, H)))).astype(
        np.float32) * dt_scale
    a = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    Bm = rng.standard_normal((B, T, N), dtype=np.float32)
    Cm = rng.standard_normal((B, T, N), dtype=np.float32)
    return x, dt, a, Bm, Cm


def _recurrence(x, dt, a, Bm, Cm, state0=None):
    """y and final state by :func:`ssd_step`, one token at a time."""
    B, T, H, P = x.shape
    S = (torch.zeros((B, H, P, Bm.shape[-1]), dtype=torch.float32,
                     device=x.device) if state0 is None else state0)
    ys = []
    for t in range(T):
        y, S = tssm.ssd_step(S, x[:, t], dt[:, t], a, Bm[:, t], Cm[:, t])
        ys.append(y)
    return torch.stack(ys, 1), S


@pytest.mark.parametrize("T", [1, 2, 12])
@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "state"])
def test_causal_conv_matches_jax(T, with_state):
    """Output and new state, with and without carried inputs; T = 1 and 2
    are shorter than the W - 1 = 3 carried rows."""
    jnp, jssm = _jax()
    rng = np.random.default_rng(T)
    x = rng.standard_normal((2, T, 8), dtype=np.float32)
    w = rng.standard_normal((4, 8), dtype=np.float32)
    st = rng.standard_normal((2, 3, 8), dtype=np.float32) if with_state \
        else None
    want, wstate = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                     None if st is None else jnp.asarray(st))
    got, gstate = tssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                    None if st is None
                                    else torch.from_numpy(st))
    assert got.shape == (2, T, 8) and gstate.shape == (2, 3, 8)
    assert _err(got, want) <= 1e-6
    assert _err(gstate, wstate) == 0


@pytest.mark.parametrize("chunk", [4, 8, 16, 32])
@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "state"])
def test_ssd_chunked_matches_jax(chunk, with_state):
    jnp, jssm = _jax()
    arrays = _scan_inputs(2, 32, 4, 8, 16, seed=chunk)
    st = (np.random.default_rng(7).standard_normal((2, 4, 8, 16),
                                                   dtype=np.float32)
          if with_state else None)
    want_y, want_s = jssm.ssd_chunked(*map(jnp.asarray, arrays), chunk,
                                      None if st is None else jnp.asarray(st))
    got_y, got_s = tssm.ssd_chunked(*map(torch.from_numpy, arrays), chunk,
                                    None if st is None
                                    else torch.from_numpy(st))
    assert got_y.dtype == got_s.dtype == torch.float32
    assert _err(got_y, want_y) <= 1e-4
    assert _err(got_s, want_s) <= 1e-4


@pytest.mark.parametrize("T,chunk", [(20, 16), (37, 8), (5, 4)])
def test_ragged_length_matches_the_recurrence(T, chunk):
    """A last chunk shorter than the others: output and state equal the
    step-by-step recurrence.  The JAX package reshapes T into whole chunks
    and cannot run these lengths."""
    jnp, jssm = _jax()
    arrays = _scan_inputs(2, T, 3, 4, 8, seed=T)
    with pytest.raises(TypeError, match="reshape"):
        jssm.ssd_chunked(*map(jnp.asarray, arrays), chunk)
    t = list(map(torch.from_numpy, arrays))
    got_y, got_s = tssm.ssd_chunked(*t, chunk)
    want_y, want_s = _recurrence(*t)
    assert got_y.shape == (2, T, 3, 4)
    assert float((got_y - want_y).abs().max()) <= 1e-4
    assert float((got_s - want_s).abs().max()) <= 1e-4


def test_saturating_decay_stays_finite():
    """dt up to ~100 with a = -1 over 128-step chunks: the segment sums
    above the diagonal reach thousands, and exp of them overflows; the
    scan stays finite and equal to the recurrence within 1e-4 of the
    largest magnitude (|y| reaches ~17 here)."""
    x, dt, _, Bm, Cm = _scan_inputs(1, 256, 2, 4, 8, seed=3, dt_scale=30.0)
    x, a = x / 30, -np.ones(2, np.float32)  # keeps y within ~20
    t = list(map(torch.from_numpy, (x, dt, a, Bm, Cm)))
    assert float(t[1].sum(1).max()) > 1000
    y, S = tssm.ssd_chunked(*t, 128)
    assert bool(torch.isfinite(y).all() and torch.isfinite(S).all())
    want_y, want_s = _recurrence(*t)
    for got, want in ((y, want_y), (S, want_s)):
        scale = max(float(want.abs().max()), 1.0)
        assert float((got - want).abs().max()) <= 1e-4 * scale


@pytest.fixture(scope="module")
def block():
    """(port cfg, JAX cfg, numpy params of one Mamba2 block) at smoke
    size; the zero- and one-initialised A_log, D, dt_bias and norm drawn
    so that they count."""
    _, jssm = _jax()
    from repro.config import get_config as jax_get_config
    cfg, jcfg = get_config(ARCH, smoke=True), jax_get_config(ARCH,
                                                             smoke=True)
    defs = jssm.ssm_defs(jcfg)
    rng = np.random.default_rng(11)
    p = {}
    for k, d in defs.items():
        std = d.scale if d.scale is not None else 1 / np.sqrt(
            d.shape[-2] if len(d.shape) > 1 else 1)
        p[k] = (rng.standard_normal(d.shape) * std).astype(np.float32)
    p["D"] += 1.0
    p["norm"] += 1.0
    return cfg, jcfg, p


def _port_mamba(cfg, p):
    """The port's Mamba2 module holding ``p`` through the converter (one
    Mamba block of a 1-layer hybrid's tail)."""
    one = dataclasses.replace(cfg, n_layers=1)
    defs = model_defs(one)
    params = {k: np.zeros(d.shape, np.float32) for k, d in defs.items()}
    params.update({f"tail0/ssm/{k}": v for k, v in p.items()})
    return from_jax_params(one, params, device="cpu").tail[0].ssm


@pytest.mark.parametrize("T", [1, 16, 24])
@pytest.mark.parametrize("with_cache", [False, True], ids=["nocache",
                                                           "cache"])
def test_mamba2_matches_jax(block, T, with_cache):
    """``Mamba2`` against JAX's ``ssm_apply``: output and (with a cache of
    drawn conv inputs and state) the new cache leaves, which the port
    writes in place; T = 1 with a cache is the one-step decode path.
    T = 24 is ragged for the chunk of 16, so JAX runs it as one chunk
    (``chunk`` raised to T) and the port in two."""
    jnp, jssm = _jax()
    cfg, jcfg, p = block
    if T == 24:
        jcfg = dataclasses.replace(jcfg, ssm=dataclasses.replace(
            jcfg.ssm, chunk=T))
    rng = np.random.default_rng(T)
    x = rng.standard_normal((2, T, cfg.d_model), dtype=np.float32)
    cache = jcache = None
    if with_cache:
        tree = init_cache(dataclasses.replace(cfg, n_layers=1), 2, 8,
                          dtype=torch.float32, device="cpu")["tail"][0]
        for v in tree.values():
            v.copy_(torch.from_numpy(rng.standard_normal(
                tuple(v.shape), dtype=np.float32)))
        # copies: JAX may alias a numpy buffer and read it after the port
        # has written the cache in place
        jcache = {k: jnp.asarray(v.numpy().copy()) for k, v in tree.items()}
        cache = tree
    want, jnew = jssm.ssm_apply(jcfg, {k: jnp.asarray(v) for k, v in
                                       p.items()}, "", jnp.asarray(x), jcache)
    m = _port_mamba(cfg, p)
    with torch.inference_mode():
        got, new = m(torch.from_numpy(x), cache)
    assert _err(got, want) <= 1e-4
    if with_cache:
        assert new is cache
        for k in ("conv_x", "conv_B", "conv_C", "state"):
            assert _err(cache[k], jnew[k]) <= 1e-5, k


@pytest.mark.cuda
def test_scans_on_the_card_match_the_recurrence(cuda_device):
    """zamba2-1.2b's full-width scan (H 64, P 64, N 64, chunk 128) on the
    card at a ragged T against the recurrence on the card (f32, no TF32),
    within 1e-3 scaled by the output's largest magnitude."""
    torch.backends.cuda.matmul.allow_tf32 = False
    s = get_config(ARCH).ssm
    H = s.expand * get_config(ARCH).d_model // s.head_dim
    arrays = _scan_inputs(1, 300, H, s.head_dim, s.d_state, seed=5)
    t = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    y, S = tssm.ssd_chunked(*t, s.chunk)
    want_y, want_s = _recurrence(*t)
    scale = float(want_y.abs().max())
    assert float((y - want_y).abs().max()) <= 1e-3 * max(scale, 1.0)
    assert float((S - want_s).abs().max()) <= 1e-3 * max(
        float(want_s.abs().max()), 1.0)
