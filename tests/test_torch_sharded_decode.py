"""The port's cache-writing prefill and greedy decode under a ``("data",
"model")`` mesh of two ``gloo`` CPU ranks against the JAX package: every
architecture at ``:smoke`` in f32, one spawn for every case
(``torch_shard_cases.py``).

* Each architecture on ``(1, 2)`` and ``(2, 1)`` at B 2: the model placed
  by ``serve_rules`` (the batch on the data axis), the cache by
  ``init_cache(mesh=, rules=)``; ``make_prefill_cache_step`` over an
  8-token prompt (pixtral's prefix first), then 4 steps of
  ``make_serve_step``.  Against JAX's ``make_prefill_cache_step`` and
  ``make_serve_step`` on one device: the prefill's and every step's
  logits within 1e-4 of their largest magnitude, every greedy token
  equal; after the prefill and after the last step, each rank's local
  block of every cache leaf equals the block of JAX's leaf that JAX's
  ``cache_logical`` spec gives that rank (positions exactly, the rest
  within 1e-4 of the leaf's largest magnitude).  So MLA's compressed
  cache is split on its sequence over the model axis (``mla_seq``), the
  attention caches on their kv heads, Mamba2's conv inputs on ``ff``,
  and the recurrent states are whole over the model axis.
* ``seq_shard_decode`` at B 1 on ``(2, 1)``: the batch does not divide
  the data axis, so the attention caches' sequence is split over it
  (``kv_seq``): qwen3-4b and zamba2 (its shared block's cache), and
  h2o-danube3's 16-slot window ring, prefilled with 12 tokens and
  decoded 8 steps past its wrap, each write landing in the rank that
  holds its slot.
* The recurrent families' decode on ``(2, 1)``: each state write (the
  whole batch dim, split over data) issues no collective
  (``CommDebugMode``).
"""
import numpy as np
import pytest
import torch
from torch_shard_cases import (init_group, load_inputs, mesh_of,
                               save_result, scaled, spawn, spec_slice)
from torch_train_cases import case

from repro_torch.config import RunConfig, get_config, list_configs
from repro_torch.models.transformer import flat_cache

pytest.importorskip("jax")

ARCHS = list_configs()
#: label -> ((data, model) mesh shape, batch, prompt, decode steps, cache
#: slots before any prefix); "seq" and "ring" decode one request, so the
#: attention caches' sequence splits over the data axis
RUNS = {"m12": ((1, 2), 2, 8, 4, 16), "m21": ((2, 1), 2, 8, 4, 16),
        "seq": ((2, 1), 1, 8, 4, 16), "ring": ((2, 1), 1, 12, 8, 32)}
CASES = ([(a, "m12") for a in ARCHS] + [(a, "m21") for a in ARCHS]
         + [("qwen3-4b", "seq"), ("zamba2-1.2b", "seq"),
            ("h2o-danube-3-4b", "ring")])
#: the recurrent families' decode on (2, 1), the batch split over data:
#: their state writes keep each rank's rows
WRITE_CASES = [("rwkv6-3b", "m21"), ("zamba2-1.2b", "m21")]
KW = dict(attention_impl="flash", attention_chunk=8, remat="none",
          compute_dtype="float32")


def _inputs(arch, label):
    """(numpy params, prompt tokens, prefix or None) of one case."""
    _, _, params, batch = case(arch)
    B, T = RUNS[label][1:3]
    rng = np.random.default_rng(70 + ARCHS.index(arch))
    toks = rng.integers(0, get_config(arch, smoke=True).vocab_size,
                        (B, T)).astype(np.int32)
    prefix = batch.get("prefix_embeds")
    return params, toks, None if prefix is None else prefix[:B]


def _rank_main(rank, world, init_file, tmp):
    import torch.distributed as dist

    from repro_torch.launch.specs import serve_rules
    from repro_torch.models.convert import from_jax_params
    from repro_torch.models.transformer import init_cache
    from repro_torch.serve import make_prefill_cache_step, make_serve_step

    init_group(rank, world, init_file)
    try:
        inp = load_inputs(tmp)
        run = RunConfig(**KW)
        out = {}
        for arch, label in CASES:
            shape, B, T, steps, slots = RUNS[label]
            params, toks, prefix = inp[arch, label]
            cfg = get_config(arch, smoke=True)
            P = cfg.n_prefix_embeds
            mesh = mesh_of(shape)
            rules = serve_rules(cfg, run, mesh, B, slots + P)
            model = from_jax_params(cfg, params, run=run, device="cpu",
                                    mesh=mesh, rules=rules)
            cache = init_cache(cfg, B, slots + P, torch.float32, "cpu",
                               mesh=mesh, rules=rules)

            def blocks():
                return {k: v.to_local().numpy().copy()
                        for k, v in flat_cache(cache).items()}

            logits, cache = make_prefill_cache_step(cfg, run, mesh, rules)(
                model, torch.from_numpy(toks), cache,
                None if prefix is None else torch.from_numpy(prefix))
            res = {"prefill": logits.numpy(), "prefill_cache": blocks(),
                   "coord": dict(zip(mesh.mesh_dim_names,
                                     mesh.get_coordinate())),
                   "batch_shardable": rules.table["batch"] is not None,
                   "seq_shard": rules.table["kv_seq"] is not None,
                   "tokens": [], "logits": []}
            serve = make_serve_step(cfg, run, mesh, rules)
            tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            for i in range(steps):
                tok, cache, lg = serve(model, cache, tok, P + T + i)
                res["tokens"].append(tok.numpy())
                res["logits"].append(lg.numpy())
            res["cache"] = blocks()
            if (arch, label) in WRITE_CASES:
                res["write_comms"] = _recurrent_write_comms(
                    lambda: serve(model, cache, tok, P + T + steps))
            out[arch, label] = res
        save_result(tmp, rank, out)
    finally:
        dist.destroy_process_group()


def _recurrent_write_comms(step):
    """Run ``step`` with every recurrent cache write (Mamba2's and RWKV6's
    ``write_into``) under ``CommDebugMode``: a list with each write's
    ``{collective: count}``."""
    from unittest import mock

    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.models import rwkv, ssm
    from repro_torch.sharding.rules import write_into

    seen = []

    def counted(*args, **kw):
        with CommDebugMode() as comms:
            write_into(*args, **kw)
        seen.append({str(op): n for op, n in comms.get_comm_counts().items()
                     if n})

    with mock.patch.object(rwkv, "write_into", counted), \
            mock.patch.object(ssm, "write_into", counted):
        step()
    return seen


def _jax_run(arch, label):
    """JAX's prefill and decode of one case on one device (numpy)."""
    import jax
    import jax.numpy as jnp
    from repro.config import RunConfig as JaxRun
    from repro.models import transformer as jtfm
    from repro.serve.decode import make_prefill_cache_step as jax_prefill
    from repro.serve.decode import make_serve_step as jax_serve

    _, jcfg, params, _ = case(arch)
    _, toks, prefix = _inputs(arch, label)
    _, B, T, steps, slots = RUNS[label]
    P = jcfg.n_prefix_embeds
    jrun = JaxRun(**{**KW, "attention_impl": "chunked_causal"})
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    cache = jax.tree.map(lambda a: a.astype(jnp.float32)
                         if a.dtype == jnp.bfloat16 else a,
                         jtfm.init_cache(jcfg, B, slots + P))
    logits, cache = jax.jit(jax_prefill(jcfg, jrun))(
        jp, jnp.asarray(toks), cache,
        None if prefix is None else jnp.asarray(prefix))

    def leaves(c):
        return {k: np.asarray(v) for k, v in flat_cache(c).items()}

    res = {"prefill": np.asarray(logits), "prefill_cache": leaves(cache),
           "tokens": [], "logits": []}
    serve = jax.jit(jax_serve(jcfg, jrun))
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    for i in range(steps):
        tok, cache, lg = serve(jp, cache, tok, jnp.int32(P + T + i))
        res["tokens"].append(np.asarray(tok))
        res["logits"].append(np.asarray(lg))
    res["cache"] = leaves(cache)
    return res


def _jax_specs(arch, batch_shardable, seq_shard):
    """{leaf path: JAX's spec} of the cache by JAX's ``cache_logical`` and
    rules."""
    import jax
    from repro.models import transformer as jtfm
    from repro.sharding.rules import make_rules as jax_make_rules

    jcfg = case(arch)[1]
    rules = jax_make_rules(jax.make_mesh((1, 1), ("data", "model")),
                           batch_shardable=batch_shardable,
                           seq_shard_kv=seq_shard)
    logical = jtfm.cache_logical(jcfg, batch_shardable, seq_shard)
    # JAX's cache tree walked beside it: a logical leaf is itself a tuple
    return {k: tuple(rules.spec(lg)) for k, (_, lg) in flat_cache(
        jtfm.init_cache(jcfg, 1, 1), logical).items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    inputs = {(a, lb): _inputs(a, lb) for a, lb in CASES}
    want = {(a, lb): _jax_run(a, lb) for a, lb in CASES}
    res = spawn(_rank_main, 2, str(tmp_path_factory.mktemp("decode")),
                inputs)
    return want, res


@pytest.mark.parametrize("arch,label", CASES)
def test_sharded_prefill_and_decode_match_jax(ranks, arch, label):
    want, res = ranks
    w = want[arch, label]
    for r in res:
        got = r[arch, label]
        assert got["prefill"].shape == w["prefill"].shape
        assert scaled(got["prefill"], w["prefill"]) <= 1e-4
        for i, (tok, lg) in enumerate(zip(got["tokens"], got["logits"])):
            np.testing.assert_array_equal(tok, w["tokens"][i],
                                          err_msg=str(i))
            assert scaled(lg, w["logits"][i]) <= 1e-4, i


@pytest.mark.parametrize("arch,label", CASES)
def test_sharded_cache_blocks_are_jax_specs_slices(ranks, arch, label):
    want, res = ranks
    shape = RUNS[label][0]
    sizes = dict(zip(("data", "model"), shape))
    r0 = res[0][arch, label]
    specs = _jax_specs(arch, r0["batch_shardable"], r0["seq_shard"])
    if label in ("seq", "ring"):  # the sequence really is split
        assert r0["seq_shard"] and not r0["batch_shardable"]
    for r in res:
        got = r[arch, label]
        for when in ("prefill_cache", "cache"):
            assert set(got[when]) == set(specs)
            for path, spec in specs.items():
                w = spec_slice(want[arch, label][when][path], spec, sizes,
                               got["coord"])
                g = got[when][path]
                assert g.shape == w.shape, (when, path, spec)
                if path.endswith("/pos"):
                    np.testing.assert_array_equal(g, w,
                                                  err_msg=str((when, path)))
                else:
                    assert scaled(g, w) <= 1e-4, (when, path)


@pytest.mark.parametrize("arch,label", WRITE_CASES)
def test_recurrent_cache_writes_gather_nothing_over_data(ranks, arch,
                                                         label):
    """A decode step's recurrent state writes (the whole batch dim of a
    leaf split over the data axis) take the new state as the leaf is
    placed: no collective on ``(2, 1)``, whose model axis has one rank,
    so no all-gather of the batch's state over data."""
    for r in ranks[1]:
        seen = r[arch, label]["write_comms"]
        n_layers = get_config(arch, smoke=True).n_layers
        assert len(seen) >= n_layers, len(seen)
        assert all(c == {} for c in seen), [c for c in seen if c]
