"""The port's serving path against the JAX package at smoke size: first
qwen3-4b (``qwen3-4b:smoke``: 2 layers, d 64, 4 heads, 2 KV heads, hd 16)
layer by layer, then every other architecture (dense, vlm, audio, MoE,
MLA, the zamba2 Mamba2 hybrid and RWKV6) end to end at its own ``:smoke``
config.

Both packages run the same weights (JAX's ``init_model``, handed over as
numpy through :func:`repro_torch.models.convert.from_jax_params`) on the
same numpy-drawn tokens, prefix embeddings and activations, in float32
unless a test says otherwise.  Tolerances: 1e-4 on logits (f32 einsums
summed in another order), 1e-5 on cache leaves, 1e-6 on the MoE loss,
1e-3 where decode is compared with the full forward (as
``tests/test_models.py`` does in JAX), 2e-2 in bf16 (the kernel tests');
tokens and cache positions exactly.  The port's ``"flash"`` runs the
kernel's plain version on the CPU; it is held to JAX's ``"dense"`` and
``"chunked_causal"`` (whose path is known: JAX's ``"pallas"`` falls back
to the XLA twin on any kernel error).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import RunConfig as JaxRun
from repro.config import get_config as jax_get_config
from repro.config import list_configs as jax_list_configs
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro.serve.decode import make_prefill_cache_step as jax_prefill
from repro.serve.decode import make_prefill_step as jax_prefill_step
from repro.serve.decode import make_serve_step as jax_serve
from repro_torch.config import RunConfig, get_config
from repro_torch.config import list_configs as port_list_configs
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttfm
from repro_torch.models.attention import AttnCache
from repro_torch.models.convert import from_jax_params
from repro_torch.models.params import count_params
from repro_torch.serve import (make_prefill_cache_step, make_prefill_step,
                               make_serve_step)

ARCH = "qwen3-4b"
# port impl -> JAX impl
IMPLS = {"flash": "pallas", "dense": "dense"}
B, T, MAX_SEQ = 2, 16, 32


@pytest.fixture(scope="module")
def cfg():
    return get_config(ARCH, smoke=True)


@pytest.fixture(scope="module")
def jax_params():
    jcfg = jax_get_config(ARCH, smoke=True)
    params = jtfm.init_model(jcfg, jax.random.PRNGKey(0))
    return {k: np.asarray(v) for k, v in params.items()}


def _runs(impl, dtype="float32"):
    return (RunConfig(attention_impl=impl, compute_dtype=dtype),
            JaxRun(attention_impl=IMPLS[impl], attention_chunk=8,
                   remat="none", compute_dtype=dtype))


def _model(cfg, jax_params, run):
    return from_jax_params(cfg, jax_params, run=run, device="cpu")


def _tokens(cfg, seed=0, n=T):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32)


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


def test_configs_match_jax(cfg):
    for smoke in (False, True):
        assert (dataclasses.asdict(get_config(ARCH, smoke=smoke))
                == dataclasses.asdict(jax_get_config(ARCH, smoke=smoke)))
    full = get_config(ARCH)
    assert (full.n_layers, full.d_model, full.vocab_size) == (36, 2560,
                                                               151936)


def test_port_registers_every_jax_arch():
    assert port_list_configs() == jax_list_configs()


def test_unknown_arch_raises_key_error():
    with pytest.raises(KeyError, match="qwen3-4b"):
        get_config("no-such-arch")


def test_model_defs_match_jax(cfg):
    want = jtfm.model_defs(jax_get_config(ARCH, smoke=True))
    got = ttfm.model_defs(cfg)
    assert {k: d.shape for k, d in got.items()} == {
        k: d.shape for k, d in want.items()}
    from repro.models.params import count_params as jax_count_params
    assert count_params(got) == jax_count_params(want)


def test_from_jax_params_round_trip(cfg, jax_params):
    """Every JAX leaf lands in the module, whole and unchanged, and the
    module holds nothing else."""
    m = _model(cfg, jax_params, RunConfig(compute_dtype="float32"))
    L = cfg.n_layers
    got = {"embed": m.embed.weight, "final_ln": m.final_ln,
           "unembed": m.unembed.weight.T}
    for name, mod in [("attn/wq", "attn.wq"), ("attn/wk", "attn.wk"),
                      ("attn/wv", "attn.wv"), ("attn/wo", "attn.wo"),
                      ("mlp/w_gate", "mlp.w_gate"), ("mlp/w_up", "mlp.w_up"),
                      ("mlp/w_down", "mlp.w_down")]:
        got["layers/" + name] = torch.stack(
            [m.get_submodule(f"layers.{i}.{mod}").weight.T for i in range(L)])
    for name in ("ln1", "ln2", "attn/q_norm", "attn/k_norm"):
        got["layers/" + name] = torch.stack(
            [m.get_parameter(f"layers.{i}.{name.replace('/', '.')}")
             for i in range(L)])
    assert set(got) == set(jax_params)
    for k, v in jax_params.items():
        assert tuple(got[k].shape) == v.shape, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert sum(p.numel() for p in m.parameters()) == sum(
        v.size for v in jax_params.values())
    assert not any(p.requires_grad for p in m.parameters())


def test_from_jax_params_rejects_a_wrong_table(cfg, jax_params):
    with pytest.raises(KeyError, match="missing"):
        from_jax_params(cfg, {k: v for k, v in jax_params.items()
                              if k != "final_ln"}, device="cpu")
    bad = dict(jax_params, final_ln=np.ones(3, np.float32))
    with pytest.raises(ValueError, match="final_ln"):
        from_jax_params(cfg, bad, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_rope_mlp_match_jax(cfg, jax_params, dtype):
    tol = 1e-5 if dtype == "float32" else 2e-2
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, T, cfg.d_model), dtype=np.float32)
    w = rng.standard_normal(cfg.d_model, dtype=np.float32)
    jx = jnp.asarray(x, dtype=dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    assert _err(tlayers.rms_norm(tx, torch.from_numpy(w), 1e-6).float(),
                jlayers.rms_norm(jx, jnp.asarray(w), 1e-6)) < tol

    hd = cfg.resolved_head_dim
    pos = rng.integers(0, 4096, (B, T)).astype(np.int32)
    jc, js = jlayers.rope_tables(jnp.asarray(pos), hd, cfg.rope_theta)
    tc, ts = tlayers.rope_tables(torch.from_numpy(pos), hd, cfg.rope_theta)
    assert _err(tc, jc) < 1e-5 and _err(ts, js) < 1e-5
    h = rng.standard_normal((B, T, cfg.n_heads, hd), dtype=np.float32)
    assert _err(tlayers.apply_rope(torch.from_numpy(h).to(tx.dtype), tc,
                                   ts).float(),
                jlayers.apply_rope(jnp.asarray(h, dtype=dtype), jc, js)) < tol

    m = _model(cfg, jax_params, RunConfig(compute_dtype=dtype))
    jp = {k[len("layers/"):]: jnp.asarray(v[0])
          for k, v in jax_params.items() if k.startswith("layers/")}
    want = jlayers.mlp_apply(jp, "mlp/", jx, jx.dtype)
    assert _err(m.layers[0].mlp(tx).float(), want) < (
        1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("impl", sorted(IMPLS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_cache", [False, True], ids=["nocache", "cache"])
def test_gqa_matches_jax(cfg, jax_params, impl, dtype, with_cache):
    """One layer's attention block: projections, qk-norm, RoPE, the cache
    write and the attention core, f32 at 1e-5 and bf16 at 2e-2."""
    run, jrun = _runs(impl, dtype)
    m = _model(cfg, jax_params, run)
    jcfg = jax_get_config(ARCH, smoke=True)
    jp = {k[len("layers/"):]: jnp.asarray(v[0], dtype=dtype)
          for k, v in jax_params.items() if k.startswith("layers/")}
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, T, cfg.d_model), dtype=np.float32)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    jx, tx = jnp.asarray(x, dtype=dtype), torch.from_numpy(x).to(
        getattr(torch, dtype))
    jcache = tcache = None
    if with_cache:
        full = ttfm.init_cache(cfg, B, MAX_SEQ, dtype=torch.float32,
                               device="cpu")["layers"]
        tcache = AttnCache(full.k[0], full.v[0], full.pos[0])
        jcache = jattn.AttnCache(*(jnp.asarray(t.numpy()) for t in tcache))
    want, jnew = jattn.gqa_apply(jcfg, jrun, jp, "attn/", jx,
                                 jnp.asarray(pos), jcache, 0)
    with torch.inference_mode():
        got, tnew = m.layers[0].attn(tx, torch.from_numpy(pos), tcache, 0)
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert got.dtype == tx.dtype
    assert _err(got.float(), want) < tol
    if with_cache:
        for a, b in zip(tnew, jnew):
            assert _err(a, b) < tol


def _jax_prefill_and_decode(jax_params, jrun, toks, steps):
    jcfg = jax_get_config(ARCH, smoke=True)
    params = {k: jnp.asarray(v) for k, v in jax_params.items()}
    cache = jax.tree.map(lambda a: a.astype(jnp.float32)
                         if a.dtype == jnp.bfloat16 else a,
                         jtfm.init_cache(jcfg, B, MAX_SEQ))
    logits, cache = jax.jit(jax_prefill(jcfg, jrun))(params,
                                                     jnp.asarray(toks), cache)
    prefill = (np.asarray(logits), jax.tree.map(np.asarray, cache["layers"]))
    serve = jax.jit(jax_serve(jcfg, jrun))
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    out = []
    for i in range(steps):
        tok, cache, lg = serve(params, cache, tok, jnp.int32(T + i))
        out.append((np.asarray(tok), np.asarray(lg)))
    return prefill, out


def _port_prefill_and_decode(cfg, jax_params, run, toks, steps):
    m = _model(cfg, jax_params, run)
    cache = ttfm.init_cache(cfg, B, MAX_SEQ, dtype=torch.float32,
                            device="cpu")
    logits, cache = make_prefill_cache_step(cfg, run)(
        m, torch.from_numpy(toks), cache)
    prefill = (logits.numpy(), [t.clone().numpy() for t in cache["layers"]])
    serve = make_serve_step(cfg, run)
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    out = []
    for i in range(steps):
        tok, cache, lg = serve(m, cache, tok, T + i)
        out.append((tok.numpy(), lg.numpy()))
    return prefill, out


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_prefill_and_decode_match_jax(cfg, jax_params, impl):
    """make_prefill_cache_step logits and filled cache, then 8 greedy
    make_serve_step steps: identical tokens, logits within 1e-4."""
    run, jrun = _runs(impl)
    toks = _tokens(cfg)
    (jl, jc), jsteps = _jax_prefill_and_decode(jax_params, jrun, toks, 8)
    (tl, tc), tsteps = _port_prefill_and_decode(cfg, jax_params, run, toks, 8)
    assert tl.shape == (B, T, cfg.vocab_size) and tl.dtype == np.float32
    assert _err(tl, jl) <= 1e-4
    for name, a, b in zip(("k", "v", "pos"), tc, jc):
        assert a.shape == b.shape, name
        assert _err(a, b) <= 1e-5, name
    np.testing.assert_array_equal(tc[2], jc.pos)
    for (ttok, tlg), (jtok, jlg) in zip(tsteps, jsteps):
        np.testing.assert_array_equal(ttok, jtok)
        assert _err(tlg, jlg) <= 1e-4


@pytest.mark.parametrize("impl", sorted(IMPLS))
@pytest.mark.parametrize("variant", [
    dict(qkv_bias=True), dict(tie_embeddings=True), dict(sliding_window=8),
], ids=["qkv_bias", "tied", "window"])
def test_dense_family_options_match_jax(impl, variant):
    """The dense-family switches other configs use (qwen1.5's qkv bias,
    granite's tied embeddings, h2o-danube3's sliding window) on the smoke
    shape: cacheless prefill logits within 1e-4 of JAX."""
    run, jrun = _runs(impl)
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True), **variant)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), **variant)
    params = {k: np.asarray(v) for k, v in
              jtfm.init_model(jcfg, jax.random.PRNGKey(3)).items()}
    if cfg.qkv_bias:  # JAX initialises biases to zero; make them count
        rng = np.random.default_rng(6)
        for b in ("bq", "bk", "bv"):
            key = "layers/attn/" + b
            params[key] = rng.standard_normal(params[key].shape,
                                              dtype=np.float32)
    toks = _tokens(cfg, seed=7)
    want = jax.jit(jax_prefill_step(jcfg, jrun))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(toks))
    got = make_prefill_step(cfg, run)(
        from_jax_params(cfg, params, run=run, device="cpu"),
        torch.from_numpy(toks))
    assert _err(got, want) <= 1e-4


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_decode_equals_full_forward(cfg, jax_params, impl):
    """Token-by-token decode through the cache gives the full forward's
    logits at every position (f32, 1e-3)."""
    run, _ = _runs(impl)
    m = _model(cfg, jax_params, run)
    toks = torch.from_numpy(_tokens(cfg, seed=3))
    full = make_prefill_step(cfg, run)(m, toks)
    cache = ttfm.init_cache(cfg, B, T, dtype=torch.float32, device="cpu")
    serve = make_serve_step(cfg, run)
    outs = []
    for t in range(T):
        _, cache, lg = serve(m, cache, toks[:, t:t + 1], t)
        outs.append(lg)
    assert float((full - torch.stack(outs, 1)).abs().max()) < 1e-3


def test_prefill_step_equals_prefill_cache_step(cfg, jax_params):
    run, _ = _runs("flash")
    m = _model(cfg, jax_params, run)
    toks = torch.from_numpy(_tokens(cfg, seed=4))
    cache = ttfm.init_cache(cfg, B, MAX_SEQ, dtype=torch.float32,
                            device="cpu")
    with_cache, _ = make_prefill_cache_step(cfg, run)(m, toks, cache)
    assert torch.allclose(make_prefill_step(cfg, run)(m, toks), with_cache,
                          atol=1e-5)


def test_sampling_follows_the_generator(cfg, jax_params):
    run, _ = _runs("flash")
    m = _model(cfg, jax_params, run)
    serve = make_serve_step(cfg, run, greedy=False)
    draws = []
    for _ in range(2):
        cache = ttfm.init_cache(cfg, B, MAX_SEQ, dtype=torch.float32,
                                device="cpu")
        gen = torch.Generator().manual_seed(5)
        tok = torch.zeros((B, 1), dtype=torch.int32)
        seq = []
        for i in range(4):
            tok, cache, _ = serve(m, cache, tok, i, gen)
            seq.append(tok)
        draws.append(torch.cat(seq, 1))
    assert torch.equal(draws[0], draws[1])
    assert draws[0].dtype == torch.int32
    assert ((draws[0] >= 0) & (draws[0] < cfg.vocab_size)).all()


def test_step_rejects_a_model_built_for_another_run(cfg, jax_params):
    m = _model(cfg, jax_params, RunConfig(attention_impl="dense"))
    with pytest.raises(ValueError, match="built for"):
        make_prefill_step(cfg, RunConfig(attention_impl="flash"))(
            m, torch.from_numpy(_tokens(cfg)))


def test_cache_overflow_raises(cfg, jax_params):
    run, _ = _runs("flash")
    m = _model(cfg, jax_params, run)
    cache = ttfm.init_cache(cfg, B, 8, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="overflow"):
        make_prefill_cache_step(cfg, run)(m, torch.from_numpy(_tokens(cfg)),
                                          cache)


def test_default_device_raises_without_cuda(cfg, jax_params):
    """``device=None`` means CUDA: with no card the entry points raise
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttfm.init_cache(cfg, B, MAX_SEQ)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        from_jax_params(cfg, jax_params)


# ----------------------------------------------------------------------------
# every other architecture, end to end at its :smoke config
# ----------------------------------------------------------------------------

FAMILIES = ("deepseek-coder-33b", "deepseek-v2-236b", "granite-moe-3b-a800m",
            "h2o-danube-3-4b", "musicgen-large", "pixtral-12b", "qwen1.5-4b",
            "rwkv6-3b", "zamba2-1.2b")
# recurrent leaves JAX initialises to 0 or 1 -> the value they are drawn
# around (std 0.5), so that they count; RWKV's token-shift mixes mu_* are
# drawn in [0, 1) and qwen1.5's qkv biases from N(0, 1)
DRAWN = {"A_log": 0.0, "dt_bias": 0.0, "D": 1.0, "w0": 0.0, "u": 0.0,
         "ln_x": 1.0}
MOE_FAMILIES = ("deepseek-v2-236b", "granite-moe-3b-a800m")
# port impl -> the JAX impls it is held to (both have a known path)
HELD_TO = {"flash": ("chunked_causal", "dense"), "dense": ("dense",)}


@pytest.fixture(scope="module")
def family():
    """arch -> (port cfg, JAX cfg, numpy params, numpy prefix or None);
    qwen1.5's qkv biases, the ``DRAWN`` leaves and RWKV's ``mu_*`` mixes
    drawn (JAX initialises them to 0 or 1)."""
    out = {}
    for i, arch in enumerate(FAMILIES):
        jcfg = jax_get_config(arch, smoke=True)
        params = {k: np.asarray(v) for k, v in jtfm.init_model(
            jcfg, jax.random.PRNGKey(10 + i)).items()}
        rng = np.random.default_rng(20 + i)
        for k in params:
            name = k.split("/")[-1]
            if name in ("bq", "bk", "bv"):
                params[k] = rng.standard_normal(params[k].shape,
                                                dtype=np.float32)
            elif name in DRAWN:
                params[k] = (DRAWN[name] + rng.standard_normal(
                    params[k].shape) * 0.5).astype(np.float32)
            elif name.startswith("mu_"):
                params[k] = rng.uniform(0, 1, params[k].shape).astype(
                    np.float32)
        prefix = None
        if jcfg.n_prefix_embeds:
            prefix = rng.standard_normal(
                (B, jcfg.n_prefix_embeds, jcfg.d_model), dtype=np.float32)
        out[arch] = (get_config(arch, smoke=True), jcfg, params, prefix)
    return out


def _jrun(impl):
    return JaxRun(attention_impl=impl, attention_chunk=8, remat="none",
                  compute_dtype="float32")


def _jparams(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


def _opt(x, to):
    return None if x is None else to(x)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_config_and_defs_match_jax(arch):
    for smoke in (False, True):
        assert (dataclasses.asdict(get_config(arch, smoke=smoke))
                == dataclasses.asdict(jax_get_config(arch, smoke=smoke)))
    for smoke in (False, True):
        want = jtfm.model_defs(jax_get_config(arch, smoke=smoke))
        got = ttfm.model_defs(get_config(arch, smoke=smoke))
        assert {k: d.shape for k, d in got.items()} == {
            k: d.shape for k, d in want.items()}


def _module_leaf(m, key):
    """The module's tensor for one JAX key, read back through the JAX
    layout: ``layers/`` stacks re-stacked, 2-D Linear weights transposed
    back, biases from ``.bias``, the router, the expert stacks and the
    conv taps as they are; RWKV's ``mix/`` leaves from ``time_mix`` or
    (``*_cm``) ``channel_mix``, the hybrid's from ``tail.{t}`` and
    ``shared``."""
    head, _, name = key.partition("/")
    if name.startswith("mix/"):
        name = ("channel_mix/" if name.endswith("_cm")
                else "time_mix/") + name[len("mix/"):]
    if head in ("embed", "final_ln"):
        return {"embed": m.embed.weight, "final_ln": m.final_ln}[head]
    if head == "unembed":
        return m.unembed.weight.T

    def leaf(prefix):
        path = prefix + "." + name.replace("/", ".")
        if name.split("/")[-1] in ("bq", "bk", "bv"):
            return m.get_parameter(path.replace(".b", ".w") + ".bias")
        try:
            return m.get_parameter(path)
        except AttributeError:
            return m.get_parameter(path + ".weight").T

    if head == "layers":
        return torch.stack([leaf(f"layers.{i}") for i in range(len(m.layers))])
    if head == "shared":
        return leaf("shared")
    kind = "dense" if head.startswith("dense") else "tail"
    return leaf(f"{kind}.{int(head[len(kind):])}")


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_from_jax_params_round_trip(family, arch):
    cfg, _, params, _ = family[arch]
    m = from_jax_params(cfg, params, run=RunConfig(compute_dtype="float32"),
                        device="cpu")
    for k, v in params.items():
        got = _module_leaf(m, k)
        assert tuple(got.shape) == v.shape, k
        np.testing.assert_array_equal(got.numpy(), v, err_msg=k)
    assert sum(p.numel() for p in m.parameters()) == sum(
        v.size for v in params.values())
    assert len(m.blocks()) == cfg.n_layers
    calls = m.attention_calls()
    if cfg.ssm is not None:  # one shared core, once per super-block
        assert len(calls) == ttfm.zamba_plan(cfg)[0] == 2
        assert all(c is m.shared.attn.core for c in calls)
    else:
        assert len(calls) == (0 if cfg.rwkv is not None else cfg.n_layers)


@pytest.mark.parametrize("impl", sorted(HELD_TO))
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_prefill_matches_jax(family, arch, impl):
    """Cacheless prefill logits (prefix embeddings included) within 1e-4 of
    JAX's "dense" and "chunked_causal"; the forward's MoE loss within
    1e-6 of JAX's."""
    cfg, jcfg, params, prefix = family[arch]
    run = RunConfig(attention_impl=impl, compute_dtype="float32")
    m = from_jax_params(cfg, params, run=run, device="cpu")
    toks = _tokens(cfg, seed=31)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    got = make_prefill_step(cfg, run)(m, torch.from_numpy(toks), None,
                                      _opt(prefix, torch.from_numpy))
    P = cfg.n_prefix_embeds
    assert got.shape == (B, P + T, cfg.vocab_size)
    with torch.inference_mode():
        _, _, aux = m(torch.from_numpy(toks), torch.from_numpy(pos),
                      prefix_embeds=_opt(prefix, torch.from_numpy))
    for jimpl in HELD_TO[impl]:
        jp = _jparams(params)
        want = jax_prefill_step(jcfg, _jrun(jimpl))(
            jp, jnp.asarray(toks), None, _opt(prefix, jnp.asarray))
        assert _err(got, want) <= 1e-4, jimpl
        _, _, jaux = jtfm.make_forward(jcfg, _jrun(jimpl))(
            jp, jnp.asarray(toks), jnp.asarray(pos),
            _opt(prefix, jnp.asarray))
        assert abs(float(aux) - float(jaux)) <= 1e-6, jimpl
    assert (float(aux) > 0) == (arch in MOE_FAMILIES)


def _port_leaves(tree, path=()):
    """{path: tensor} of a port cache tree (dicts, cache tuples, lists),
    the path a tuple of dict keys, field names and list indices."""
    if isinstance(tree, torch.Tensor):
        return {path: tree}
    items = (tree.items() if isinstance(tree, dict)
             else zip(tree._fields, tree) if hasattr(tree, "_fields")
             else enumerate(tree))
    out = {}
    for k, v in items:
        out.update(_port_leaves(v, path + (k,)))
    return out


def _jax_leaves(tree):
    """{path: array} of a JAX cache tree, keyed as :func:`_port_leaves`."""
    def key(p):
        return next(getattr(p, a) for a in ("key", "name", "idx")
                    if hasattr(p, a))

    return {tuple(map(key, path)): v
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _cache_leaves(cache):
    return {k: v.float().numpy() for k, v in _port_leaves(cache).items()}


def _jax_cache_leaves(cache):
    return {k: np.asarray(v, np.float32)
            for k, v in _jax_leaves(cache).items()}


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_init_cache_matches_jax(arch):
    """The empty cache tree leaf by leaf against JAX's ``init_cache`` (bf16
    by default): the same paths, shapes, dtypes and values (zeros, empty
    slots at ``SENTINEL``)."""
    want = _jax_leaves(jtfm.init_cache(jax_get_config(arch, smoke=True), B,
                                       MAX_SEQ))
    got = _port_leaves(ttfm.init_cache(get_config(arch, smoke=True), B,
                                       MAX_SEQ, device="cpu"))
    assert set(got) == set(want)
    for path, w in want.items():
        assert str(got[path].dtype) == f"torch.{w.dtype}", path
        assert tuple(got[path].shape) == w.shape, path
        np.testing.assert_array_equal(got[path].float().numpy(),
                                      np.asarray(w, np.float32),
                                      err_msg=str(path))


@pytest.mark.parametrize("impl", sorted(HELD_TO))
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_prefill_and_decode_match_jax(family, arch, impl):
    """Prefill into the cache, then 8 greedy decode steps, against JAX's
    (its "dense", or "chunked_causal" for the flash kernel): prefill
    logits within 1e-4, the cache tree leaf by leaf (positions exactly,
    k/v or MLA's ckv/krope within 1e-5), every step's tokens exactly and
    logits within 1e-4.  danube3's 16-slot window ring wraps during
    decode; pixtral's prefix fills the first slots; the hybrid's tree
    holds the Mamba2 conv inputs and states, the shared block's slots and
    the tail's, RWKV's the WKV states and the last normed rows.  The f32
    recurrent ``state`` leaves, sums whose magnitude reaches 3-15 here, are
    held within 1e-5 of their largest magnitude (1e-5 absolute would be
    ~5 ulps of f32)."""
    cfg, jcfg, params, prefix = family[arch]
    run = RunConfig(attention_impl=impl, compute_dtype="float32")
    jrun = _jrun(HELD_TO[impl][0])
    P, steps = cfg.n_prefix_embeds, 8
    toks = _tokens(cfg, seed=32)
    jp = _jparams(params)
    jcache = jax.tree.map(lambda a: a.astype(jnp.float32)
                          if a.dtype == jnp.bfloat16 else a,
                          jtfm.init_cache(jcfg, B, MAX_SEQ + P))
    jl, jcache = jax.jit(jax_prefill(jcfg, jrun))(
        jp, jnp.asarray(toks), jcache, _opt(prefix, jnp.asarray))
    m = from_jax_params(cfg, params, run=run, device="cpu")
    cache = ttfm.init_cache(cfg, B, MAX_SEQ + P, dtype=torch.float32,
                            device="cpu")
    tl, cache = make_prefill_cache_step(cfg, run)(
        m, torch.from_numpy(toks), cache, _opt(prefix, torch.from_numpy))
    assert _err(tl, jl) <= 1e-4

    def same_cache():
        want, got = _jax_cache_leaves(jcache), _cache_leaves(cache)
        assert set(got) == set(want)
        for key, w in want.items():
            assert got[key].shape == w.shape, key
            if key[-1] == "pos":
                np.testing.assert_array_equal(got[key], w, err_msg=str(key))
            elif key[-1] == "state":  # f32 sums reaching 3-15: relative
                assert _err(got[key], w) <= 1e-5 * max(
                    1.0, float(np.abs(w).max())), key
            else:
                assert _err(got[key], w) <= 1e-5, key

    same_cache()
    jserve, serve = jax.jit(jax_serve(jcfg, jrun)), make_serve_step(cfg, run)
    jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
    tok = tl[:, -1].argmax(-1).to(torch.int32)[:, None]
    for i in range(steps):
        jtok, jcache, jlg = jserve(jp, jcache, jtok, jnp.int32(P + T + i))
        tok, cache, lg = serve(m, cache, tok, P + T + i)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        assert _err(lg, jlg) <= 1e-4, i
    same_cache()


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_decode_equals_full_forward(family, arch):
    """Token-by-token decode through the cache (MLA: the absorbed path)
    gives the full forward's logits at every position (f32, 1e-3); with
    a prefix, the prefix is prefilled first and decode goes on from
    slot P.  MoE gets ample capacity, as in ``tests/test_models.py``: a
    capacity buffer drops other pairs for 2 tokens than for 32."""
    cfg, _, params, prefix = family[arch]
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=16.0))
    run = RunConfig(attention_impl="flash", compute_dtype="float32")
    m = from_jax_params(cfg, params, run=run, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, seed=33))
    pre = _opt(prefix, torch.from_numpy)
    P = cfg.n_prefix_embeds
    full = make_prefill_step(cfg, run)(m, toks, None, pre)[:, P:]
    cache = ttfm.init_cache(cfg, B, P + T, dtype=torch.float32,
                            device="cpu")
    serve = make_serve_step(cfg, run)
    outs = []
    start = 1 if P else 0
    if P:  # the prefix and the first token, then one token a step
        lg, cache = make_prefill_cache_step(cfg, run)(m, toks[:, :1], cache,
                                                       pre)
        outs.append(lg[:, -1])
    for t in range(start, T):
        _, cache, lg = serve(m, cache, toks[:, t:t + 1], P + t)
        outs.append(lg)
    assert float((full - torch.stack(outs, 1)).abs().max()) < 1e-3


@pytest.mark.parametrize("arch", MOE_FAMILIES)
@pytest.mark.parametrize("knobs", [dict(moe_groups=2),
                                   dict(moe_dense_eval=True)],
                         ids=["groups2", "dense_eval"])
def test_family_moe_run_knobs_match_jax(family, arch, knobs):
    """RunConfig's MoE knobs reach every MoE block: cacheless prefill under
    grouped dispatch and dense evaluation within 1e-4 of JAX's."""
    cfg, jcfg, params, _ = family[arch]
    run = RunConfig(attention_impl="dense", compute_dtype="float32", **knobs)
    jrun = JaxRun(attention_impl="dense", remat="none",
                  compute_dtype="float32", **knobs)
    toks = _tokens(cfg, seed=34)
    got = make_prefill_step(cfg, run)(
        from_jax_params(cfg, params, run=run, device="cpu"),
        torch.from_numpy(toks))
    want = jax_prefill_step(jcfg, jrun)(_jparams(params), jnp.asarray(toks))
    assert _err(got, want) <= 1e-4


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-1.2b"])
def test_recurrent_family_ragged_prompt(family, arch):
    """A prompt that is not a whole number of scan chunks (20 tokens: the
    smoke chunks are 8 and 16; the JAX package cannot prefill it): the
    prefill into the cache gives the logits of token-by-token decode, and
    decode goes on from it as from the decoded cache (f32, 1e-3)."""
    cfg, _, params, _ = family[arch]
    n = 20
    run = RunConfig(attention_impl="flash", compute_dtype="float32")
    m = from_jax_params(cfg, params, run=run, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, seed=35, n=n + 1))
    prefilled = ttfm.init_cache(cfg, B, n + 1, dtype=torch.float32,
                                device="cpu")
    lg, prefilled = make_prefill_cache_step(cfg, run)(m, toks[:, :n],
                                                      prefilled)
    cache = ttfm.init_cache(cfg, B, n + 1, dtype=torch.float32, device="cpu")
    serve = make_serve_step(cfg, run)
    steps = []
    for t in range(n):
        _, cache, step = serve(m, cache, toks[:, t:t + 1], t)
        steps.append(step)
    assert float((lg - torch.stack(steps, 1)).abs().max()) < 1e-3
    _, _, after_prefill = serve(m, prefilled, toks[:, n:], n)
    _, _, after_decode = serve(m, cache, toks[:, n:], n)
    assert float((after_prefill - after_decode).abs().max()) < 1e-3
