"""The port's MLA block (:class:`repro_torch.models.attention.MLA`) against
the JAX package's ``mla_apply`` at deepseek-v2's smoke size (4 heads,
kv_lora 32, q_lora 48, nope 16 + rope 8: the attention core runs at head
dim 24, V padded from 16).

The same numpy-drawn weights and activations in float32 through both.
Held within 1e-4: the prefill without and with a cache (the port's
``"flash"`` against JAX's ``"chunked_causal"`` and ``"dense"``, the
port's ``"dense"`` against JAX's ``"dense"``), and the absorbed decode
step; the cache leaves within 1e-5, positions exactly.  The decode step
never runs the attention core (per-head K and V are never built), and a
prefill runs it once, at head dim nope + rope.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import RunConfig as JaxRun
from repro.config import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import transformer as jtfm
from repro_torch.config import RunConfig, get_config
from repro_torch.models import transformer as ttfm
from repro_torch.models.attention import MLACache
from repro_torch.models.convert import from_jax_params

ARCH = "deepseek-v2-236b"
B, T, MAX_SEQ = 2, 16, 24
HELD_TO = {"flash": ("chunked_causal", "dense"), "dense": ("dense",)}


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


@pytest.fixture(scope="module")
def setup():
    """(port cfg, JAX cfg, the first stacked block's numpy params, numpy
    params of the whole model)."""
    jcfg = jax_get_config(ARCH, smoke=True)
    params = {k: np.asarray(v) for k, v in jtfm.init_model(
        jcfg, jax.random.PRNGKey(5)).items()}
    sub = {k[len("layers/"):]: v[0] for k, v in params.items()
           if k.startswith("layers/")}
    return get_config(ARCH, smoke=True), jcfg, sub, params


def _block(setup, impl):
    cfg, _, _, params = setup
    m = from_jax_params(cfg, params, run=RunConfig(attention_impl=impl,
                                                   compute_dtype="float32"),
                        device="cpu")
    return m.layers[0].attn


def _jrun(impl):
    return JaxRun(attention_impl=impl, attention_chunk=8, remat="none",
                  compute_dtype="float32")


def _x(cfg, n, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, n, cfg.d_model), dtype=np.float32)


def _empty_caches(cfg):
    full = ttfm.init_cache(cfg, B, MAX_SEQ, dtype=torch.float32,
                           device="cpu")["layers"]
    tcache = MLACache(*(t[0] for t in full))
    return tcache, jattn.MLACache(*(jnp.asarray(t.numpy()) for t in tcache))


def _counting(core):
    calls = []
    core.register_forward_hook(
        lambda mod, args, out: calls.append((args[0].shape, args[2].shape)))
    return calls


def test_mla_defs_match_jax(setup):
    cfg, jcfg, _, _ = setup
    from repro_torch.models.attention import mla_defs
    assert {k: d.shape for k, d in mla_defs(cfg).items()} == {
        k: d.shape for k, d in jattn.mla_defs(jcfg).items()}


@pytest.mark.parametrize("impl", sorted(HELD_TO))
@pytest.mark.parametrize("with_cache", [False, True],
                         ids=["nocache", "cache"])
def test_mla_prefill_matches_jax(setup, impl, with_cache):
    cfg, jcfg, sub, _ = setup
    attn = _block(setup, impl)
    calls = _counting(attn.core)
    x = _x(cfg, T, seed=1)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    tcache = jcache = None
    if with_cache:
        tcache, jcache = _empty_caches(cfg)
    with torch.inference_mode():
        got, tnew = attn(torch.from_numpy(x), torch.from_numpy(pos), tcache,
                         0)
    m = cfg.mla
    qk = m.nope_head_dim + m.rope_head_dim
    S = MAX_SEQ if with_cache else T
    assert calls == [((B, T, cfg.n_heads, qk), (B, S, cfg.n_heads, qk))]
    for jimpl in HELD_TO[impl]:
        want, jnew = jattn.mla_apply(
            jcfg, _jrun(jimpl), {k: jnp.asarray(v) for k, v in sub.items()},
            "attn/", jnp.asarray(x), jnp.asarray(pos), jcache, 0)
        assert _err(got, want) <= 1e-4, jimpl
        if with_cache:
            for name, a, b in zip(MLACache._fields, tnew, jnew):
                if name == "pos":
                    np.testing.assert_array_equal(a.numpy(), np.asarray(b))
                else:
                    assert _err(a, b) <= 1e-5, name


@pytest.mark.parametrize("impl", sorted(HELD_TO))
def test_mla_absorbed_decode_matches_jax(setup, impl):
    """Prefill T tokens into the cache, then one token at position T: the
    absorbed path (f32 scores over the compressed cache), no call of the
    attention core, the cache written at slot T."""
    cfg, jcfg, sub, _ = setup
    attn = _block(setup, impl)
    x = _x(cfg, T + 1, seed=2)
    pos = np.tile(np.arange(T + 1, dtype=np.int32), (B, 1))
    tcache, jcache = _empty_caches(cfg)
    jp = {k: jnp.asarray(v) for k, v in sub.items()}
    jrun = _jrun(HELD_TO[impl][0])
    _, jcache = jattn.mla_apply(jcfg, jrun, jp, "attn/",
                                jnp.asarray(x[:, :T]),
                                jnp.asarray(pos[:, :T]), jcache, 0)
    want, jcache = jattn.mla_apply(jcfg, jrun, jp, "attn/",
                                   jnp.asarray(x[:, T:]),
                                   jnp.asarray(pos[:, T:]), jcache, T)
    with torch.inference_mode():
        attn(torch.from_numpy(x[:, :T]), torch.from_numpy(pos[:, :T]),
             tcache, 0)
        calls = _counting(attn.core)
        got, tcache = attn(torch.from_numpy(x[:, T:]),
                           torch.from_numpy(pos[:, T:]), tcache, T)
    assert calls == []
    assert got.shape == (B, 1, cfg.d_model)
    assert _err(got, want) <= 1e-4
    np.testing.assert_array_equal(tcache.pos.numpy(), np.asarray(jcache.pos))
    assert _err(tcache.ckv, jcache.ckv) <= 1e-5
    assert _err(tcache.krope, jcache.krope) <= 1e-5


def test_mla_decode_equals_prefill(setup):
    """The absorbed decode of the last token equals the last row of a
    prefill over all T + 1 tokens (the two paths compute one function)."""
    cfg, _, _, _ = setup
    attn = _block(setup, "flash")
    x = torch.from_numpy(_x(cfg, T + 1, seed=3))
    pos = torch.arange(T + 1, dtype=torch.int32).repeat(B, 1)
    tcache, _ = _empty_caches(cfg)
    with torch.inference_mode():
        full, _ = attn(x, pos)
        attn(x[:, :T], pos[:, :T], tcache, 0)
        last, _ = attn(x[:, T:], pos[:, T:], tcache, T)
    assert float((full[:, T:] - last).abs().max()) <= 1e-5


def test_mla_cache_overflow_raises(setup):
    cfg, _, _, _ = setup
    attn = _block(setup, "flash")
    tcache, _ = _empty_caches(cfg)
    x = torch.from_numpy(_x(cfg, T, seed=4))
    pos = torch.arange(T, dtype=torch.int32).repeat(B, 1)
    with pytest.raises(ValueError, match="overflow"):
        attn(x, pos, tcache, MAX_SEQ - T + 1)
