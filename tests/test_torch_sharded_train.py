"""The port's sharded path on ``gloo`` CPU ranks against the JAX package
and the one-rank port: qwen3-4b ``:smoke`` in f32, two ranks, one spawn
for every case (``torch_shard_cases.py``).

* Meshes ``(1, 2)``, ``(2, 1)``, and both with ``act_shard_model`` (on
  ``(2, 1)`` the model axis of one rank replicates, so only ``(1, 2)``
  shards the residual stream's features); DTensor parameters placed by
  the rules, the flash core through ``local_map`` on each rank's heads,
  remat ``"full"``.  At each of two steps, from JAX's state before it,
  the loss within 1e-4 of its magnitude and each gradient within 1e-4 of
  that leaf's largest magnitude (floor 1e-3 of the largest leaf) of JAX's
  ``value_and_grad`` (``"chunked_causal"``) and of the one-rank port's;
  the step's moments within 1e-4 of each leaf's largest magnitude and its
  parameters by the one-card standard (within 1e-5, at most 1e-4 of the
  elements within 2 lr: Adam's sign flips of near-zero gradients).  One
  flash call per attention call a step, none in the backward.
* ``microbatch=2`` on ``(2, 1)`` against JAX's microbatched step;
  ``grad_compression="int8"`` on ``(2, 1)``: the round trip on shards
  placed by JAX's specs equals JAX's with JAX's noise (1e-6), and with
  the port's own noise (made on each rank's blocks) the unsharded round
  trip's exactly, on ``(1, 2)`` and ``(2, 1)``; a step
  equals the one-rank port's (the port's noise) and JAX's (JAX's noise),
  up to single int8 levels.
* A cacheless prefill's logits on ``(1, 2)`` within 1e-4 of JAX's.
* The other GQA dense families (qwen1.5, h2o-danube3's window,
  musicgen, pixtral's prefix, deepseek-coder) on ``(1, 2)`` and ``(2,
  1)``: loss and gradients against the one-rank port's (itself held to
  JAX's on the same case) by the same standard.
* Every family's parameters placed on ``(1, 2)`` and ``(2, 1)``: each
  rank's local shard of each port parameter equals the slice JAX's spec
  gives that rank of the JAX-layout array, through the port's mapping
  (stacks split, Linear weights transposed): exactly.
* MoE, MLA, the Mamba2 hybrid and RWKV6, and decode and the
  cache-writing prefill, run on ``(2, 1)`` and give the unsharded
  model's logits (``test_torch_sharded_families.py`` and
  ``test_torch_sharded_decode.py`` hold them to JAX).
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch_shard_cases import (MESHES, assert_step_matches, init_group,
                               load_inputs, mesh_of, save_result, scaled,
                               spawn, spec_slice)
from torch_train_cases import ARCHS, case, port, scaled_errs

from repro_torch.config import RunConfig, get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.convert import (jax_slot, from_jax_params,
                                        to_jax_params)
from repro_torch.sharding.rules import make_rules
from repro_torch.train import make_grad_fn, make_train_step
from repro_torch.train.checkpoint import restore_train_state
from repro_torch.train.optimizer import compress_grads_int8

pytest.importorskip("jax")

ARCH = "qwen3-4b"
LR, WARMUP, STEPS, B, T = 1e-3, 2, 2, 4, 16
KW = dict(attention_chunk=16, compute_dtype="float32", learning_rate=LR)
#: the other GQA dense families, which run under a mesh too
FAMILIES = ("qwen1.5-4b", "h2o-danube-3-4b", "musicgen-large",
            "pixtral-12b", "deepseek-coder-33b")
FORMER_REFUSALS = ("granite-moe-3b-a800m", "deepseek-v2-236b",
                   "zamba2-1.2b", "rwkv6-3b")


def _run(**kw):
    return RunConfig(attention_impl="flash", remat="full", **{**KW, **kw})


def _np(tree):
    """Copies: a whole unstacked leaf may share the live parameter's
    storage, which the next step updates in place."""
    return {k: v.numpy().copy() for k, v in tree.items()}


def _state_model(cfg, params, run, mesh=None):
    rules = None if mesh is None else make_rules(
        mesh, act_shard_model=run.act_shard_model)
    model = from_jax_params(cfg, params, run=run, device="cpu",
                            trainable=True, mesh=mesh, rules=rules)
    return model, rules


def _step_from(cfg, model, run, mesh, rules, state, i, batch, microbatch=None):
    """(loss, JAX-keyed grads, after-step params, m, v, lr, flash calls)
    of step ``i`` from ``state`` (JAX-keyed numpy params, m, v)."""
    opt = restore_train_state(model, state, i)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _, grads = make_grad_fn(cfg, run, mesh, rules,
                                  microbatch=microbatch)(model, tb)
    grads = _np(to_jax_params(model, grads))
    calls = []
    forward = fa._forward

    def counted(*args):
        calls.append(1)
        return forward(*args)

    fa._forward = counted
    try:
        step = make_train_step(cfg, run, mesh, rules, microbatch=microbatch,
                               warmup=WARMUP)
        model, opt, mets = step(model, opt, tb)
    finally:
        fa._forward = forward
    return {"loss": float(loss), "grads": grads,
            "params": _np(to_jax_params(model)),
            "m": _np(to_jax_params(model, opt.m)),
            "v": _np(to_jax_params(model, opt.v)),
            "lr": mets["lr"], "step_loss": float(mets["loss"]),
            "flash_calls": len(calls)}


def _local_shard_mismatches(mesh, arch_inputs):
    """Names of the port parameters whose local shard differs from the
    slice of the JAX-layout array that JAX's spec gives this rank."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    bad = []
    for arch, (params, specs) in arch_inputs.items():
        cfg = get_config(arch, smoke=True)
        model = from_jax_params(cfg, params, device="cpu", mesh=mesh)
        for name, p in model.named_parameters():
            key, idx, transposed = jax_slot(name)
            a = spec_slice(params[key], specs[key], sizes, coord)
            a = a[idx] if idx is not None else a
            a = a.T if transposed else a
            if not np.array_equal(p.to_local().numpy(), a):
                bad.append((arch, name))
    return bad


def _rank_main(rank, world, init_file, tmp):
    import torch.distributed as dist

    init_group(rank, world, init_file)
    try:
        inp = load_inputs(tmp)
        cfg = get_config(ARCH, smoke=True)
        out = {}
        for label, (shape, kw) in MESHES.items():
            mesh = mesh_of(shape)
            run = _run(**kw)
            model, rules = _state_model(cfg, inp["params"], run, mesh)
            out[label] = [_step_from(cfg, model, run, mesh, rules,
                                     inp["states"][i], i, inp["batches"][i])
                          for i in range(STEPS)]
        mesh = mesh_of((2, 1))
        run = _run()
        model, rules = _state_model(cfg, inp["params"], run, mesh)
        out["micro"] = _step_from(cfg, model, run, mesh, rules,
                                  inp["states"][0], 0, inp["batches"][0],
                                  microbatch=2)
        # the int8 round trip on JAX-keyed shards placed by JAX's specs,
        # with JAX's noise
        from repro_torch.train.elastic import reshard_tree

        specs = inp["placed"]["m21"][ARCH][1]
        grads = reshard_tree({k: torch.from_numpy(v) for k, v in
                              inp["int8_grads"].items()}, mesh, specs)
        noise = {k: torch.from_numpy(v) for k, v in
                 inp["int8_noise"].items()}
        out["int8_trip"] = {k: v.full_tensor().numpy() for k, v in
                            compress_grads_int8(grads, noise=noise).items()}
        # the port's own noise, made on each rank's blocks alone: the
        # placed round trip equals the whole one
        whole = {k: torch.from_numpy(v) for k, v in
                 inp["int8_grads"].items()}
        want8 = compress_grads_int8(whole, torch.Generator().manual_seed(5))
        out["int8_own"] = {}
        for label in ("m12", "m21"):
            placed = reshard_tree(whole, mesh_of(MESHES[label][0]),
                                  inp["placed"][label][ARCH][1])
            got8 = compress_grads_int8(placed,
                                       torch.Generator().manual_seed(5))
            out["int8_own"][label] = [k for k, v in got8.items()
                                      if not torch.equal(v.full_tensor(),
                                                         want8[k])]
        run8 = _run(grad_compression="int8")
        model, rules = _state_model(cfg, inp["params"], run8, mesh)
        out["int8_step"] = _step_from(cfg, model, run8, mesh, rules,
                                      inp["states"][0], 0, inp["batches"][0])
        # the same step with JAX's noise in the round trip
        from repro_torch.train import train_step as tstep

        orig = tstep.compress_grads_int8
        tstep.compress_grads_int8 = lambda tree, gen, slots: orig(
            tree, noise=noise, slots=slots)
        try:
            out["int8_step_jax_noise"] = _step_from(
                cfg, model, run8, mesh, rules, inp["states"][0], 0,
                inp["batches"][0])
        finally:
            tstep.compress_grads_int8 = orig
        # the cacheless prefill on (1, 2)
        from repro_torch.serve import make_prefill_step

        mesh12 = mesh_of((1, 2))
        runp = RunConfig(attention_impl="flash", remat="none", **KW)
        rules12 = make_rules(mesh12)
        pm = from_jax_params(cfg, inp["params"], run=runp, device="cpu",
                             mesh=mesh12, rules=rules12)
        out["prefill"] = make_prefill_step(cfg, runp, mesh12, rules12)(
            pm, torch.from_numpy(inp["batches"][0]["tokens"][:, :-1])
        ).numpy()
        out["shards"] = {
            label: _local_shard_mismatches(mesh_of(MESHES[label][0]),
                                           inp["placed"][label])
            for label in ("m12", "m21")}
        out["former_refusals"] = _former_refusal_errors(mesh)
        out["families"] = {}
        for label in ("m12", "m21"):
            fmesh = mesh_of(MESHES[label][0])
            for arch, (params, batch) in inp["families"].items():
                fcfg = get_config(arch, smoke=True)
                model, frules = _state_model(fcfg, params, _run(), fmesh)
                loss, _, grads = make_grad_fn(fcfg, _run(), fmesh, frules)(
                    model, {k: torch.from_numpy(v) for k, v in batch.items()})
                out["families"][label, arch] = (
                    float(loss), _np(to_jax_params(model, grads)))
        save_result(tmp, rank, out)
    finally:
        dist.destroy_process_group()


def _former_refusal_errors(mesh):
    """The families and serving steps that once raised under a mesh, run
    on ``mesh`` against the same model without one: ``{what: scaled
    error of the logits}`` (MoE, MLA, the Mamba2 hybrid and RWKV6 at a
    cacheless forward; qwen3-4b's cache-writing prefill and 2 decode
    steps, the largest over the steps, with the greedy tokens equal)."""
    from repro_torch.launch.specs import serve_rules
    from repro_torch.models.transformer import init_cache, init_model
    from repro_torch.serve import make_prefill_cache_step, make_serve_step

    errs = {}
    tokens = torch.randint(0, 200, (2, 8), generator=torch.Generator()
                           .manual_seed(1), dtype=torch.int32)
    pos = torch.arange(8, dtype=torch.int32).repeat(2, 1)
    run = RunConfig(compute_dtype="float32", remat="none")
    for arch in FORMER_REFUSALS:
        cfg = get_config(arch, smoke=True)
        params = init_model(cfg, torch.Generator().manual_seed(0))
        with torch.no_grad():
            got, want = (from_jax_params(cfg, params, run=run, device="cpu",
                                         mesh=m)(tokens, pos)[0]
                         for m in (mesh, None))
        errs[arch] = scaled(got.full_tensor().numpy(), want.numpy())
    cfg = get_config(ARCH, smoke=True)
    params = init_model(cfg, torch.Generator().manual_seed(0))
    steps = {}
    for m in (mesh, None):
        rules = None if m is None else serve_rules(cfg, run, m, 2, 16)
        model = from_jax_params(cfg, params, run=run, device="cpu", mesh=m,
                                rules=rules)
        cache = init_cache(cfg, 2, 16, torch.float32, "cpu", mesh=m,
                           rules=rules)
        logits, cache = make_prefill_cache_step(cfg, run, m, rules)(
            model, tokens, cache)
        out = [(logits.numpy(), None)]
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        for i in range(2):
            tok, cache, lg = make_serve_step(cfg, run, m, rules)(
                model, cache, tok, 8 + i)
            out.append((lg.numpy(), tok.numpy()))
        steps[m is None] = out
    errs["prefill_cache"] = scaled(steps[False][0][0], steps[True][0][0])
    errs["decode"] = max(
        scaled(g[0], w[0]) if np.array_equal(g[1], w[1]) else np.inf
        for g, w in zip(steps[False][1:], steps[True][1:]))
    return errs


def _jax_inputs():
    """The shared states, batches and JAX's results (numpy)."""
    import jax
    import jax.numpy as jnp
    from repro.config import RunConfig as JaxRun
    from repro.models import transformer as jtfm
    from repro.models.params import param_specs as jax_param_specs
    from repro.serve.decode import make_prefill_step as jax_prefill
    from repro.sharding.rules import make_rules as jax_make_rules
    from repro.train import adamw_init as jax_adamw_init
    from repro.train import make_train_step as jax_make_train_step
    from repro.train.optimizer import compress_grads_int8 as jax_int8
    from repro.train.train_step import make_loss_fn as jax_loss_fn

    cfg, jcfg, params, _ = case(ARCH)
    rng = np.random.default_rng(60)
    batches = [{"tokens": rng.integers(0, cfg.vocab_size, (B, T + 1))
                .astype(np.int32)} for _ in range(STEPS)]
    jrun = JaxRun(attention_impl="chunked_causal", remat="none", **KW)
    jstep = jax.jit(jax_make_train_step(jcfg, jrun, warmup=WARMUP))
    jmicro = jax.jit(jax_make_train_step(jcfg, jrun, warmup=WARMUP,
                                         microbatch=2))
    vg = jax.jit(jax.value_and_grad(jax_loss_fn(jcfg, jrun), has_aux=True))
    jint8 = jax.jit(jax_make_train_step(
        jcfg, dataclasses.replace(jrun, grad_compression="int8"),
        warmup=WARMUP))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jo = jax_adamw_init(jp)
    states, want = [], []
    for i, b in enumerate(batches):
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        states.append({"params": _jnp(jp), "m": _jnp(jo.m),
                       "v": _jnp(jo.v)})
        (loss, _), grads = vg(jp, jb)
        if i == 0:
            mp, mo, mm = jmicro(jp, jo, jb)
            micro = {"params": _jnp(mp), "m": _jnp(mo.m), "v": _jnp(mo.v),
                     "loss": float(mm["loss"]), "lr": float(mm["lr"])}
            ip, io, im = jint8(jp, jo, jb)
            int8 = {"params": _jnp(ip), "m": _jnp(io.m), "v": _jnp(io.v),
                    "step_loss": float(im["loss"]), "lr": float(im["lr"])}
        jp, jo, jm = jstep(jp, jo, jb)
        want.append({"loss": float(loss), "grads": _jnp(grads),
                     "params": _jnp(jp), "m": _jnp(jo.m), "v": _jnp(jo.v),
                     "lr": float(jm["lr"]), "step_loss": float(jm["loss"])})
    key = jax.random.fold_in(jax.random.PRNGKey(17), 0)
    noise = {k: np.asarray(jax.random.uniform(
        jax.random.fold_in(key, i), params[k].shape, minval=-0.5,
        maxval=0.5)) for i, k in enumerate(sorted(params))}
    logits = np.asarray(jax.jit(jax_prefill(jcfg, jrun))(
        {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(batches[0]["tokens"][:, :-1])))
    placed = {}
    for label, names in (("m12", ("data", "model")),
                         ("m21", ("data", "model"))):
        jmesh = jax.make_mesh((1, 1), names)
        placed[label] = {}
        for arch in ARCHS:
            acfg = case(arch)[1]
            aparams = case(arch)[2]
            specs = jax_param_specs(jtfm.model_defs(acfg),
                                    jax_make_rules(jmesh))
            placed[label][arch] = (aparams, {k: tuple(s)
                                             for k, s in specs.items()})
    inputs = {"params": params, "batches": batches, "states": states,
              "int8_noise": noise, "int8_grads": want[0]["grads"],
              "placed": placed,
              "families": {a: (case(a)[2], case(a)[3]) for a in FAMILIES}}
    return inputs, want, {"micro": micro, "int8": int8}, logits, key, \
        jax_int8


def _jnp(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    inputs, want, micro, logits, key, jax_int8 = _jax_inputs()
    res = spawn(_rank_main, 2, str(tmp_path_factory.mktemp("shard")),
                inputs)
    return inputs, want, micro, logits, key, jax_int8, res


@pytest.fixture(scope="module")
def one_rank(ranks):
    """The one-rank port's steps from the same states (no mesh)."""
    inputs = ranks[0]
    cfg = get_config(ARCH, smoke=True)
    out = {}
    for label, kw in (("plain", {}), ("int8", {"grad_compression": "int8"})):
        run = _run(**kw)
        model, _ = _state_model(cfg, inputs["params"], run)
        out[label] = [_step_from(cfg, model, run, None, None,
                                 inputs["states"][i], i,
                                 inputs["batches"][i])
                      for i in range(STEPS if label == "plain" else 1)]
    return out


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("label", sorted(MESHES))
def test_sharded_loss_and_grads_match_jax_and_one_rank(ranks, one_rank,
                                                       label, step):
    want = ranks[1][step]
    ref = one_rank["plain"][step]
    for r in ranks[-1]:  # every rank gathers the same whole gradients
        got = r[label][step]
        for other in (want, ref):
            assert abs(got["loss"] - other["loss"]) <= 1e-4 * max(
                1.0, abs(other["loss"]))
            errs = scaled_errs(got["grads"], other["grads"])
            worst = max(errs, key=errs.get)
            assert errs[worst] <= 1e-4, (worst, errs[worst])


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("label", sorted(MESHES))
def test_sharded_step_matches_jax_and_one_rank(ranks, one_rank, label,
                                               step):
    got = ranks[-1][0][label][step]
    for other in (ranks[1][step], one_rank["plain"][step]):
        assert got["lr"] == pytest.approx(other["lr"], rel=1e-6)
        assert abs(got["step_loss"] - other["step_loss"]) <= 1e-4 * max(
            1.0, abs(other["step_loss"]))
        for tree in ("m", "v"):
            for k, w in other[tree].items():
                assert scaled(got[tree][k], w) <= 1e-4, (tree, k)
        assert_step_matches(got["params"], other["params"], other["lr"],
                            (label, step))


@pytest.mark.parametrize("label", sorted(MESHES))
def test_one_flash_call_per_attention_call_a_sharded_step(ranks, label):
    n_calls = get_config(ARCH, smoke=True).n_layers
    for r in ranks[-1]:
        assert [s["flash_calls"] for s in r[label]] == [n_calls] * STEPS


def test_microbatch_on_21_matches_jax(ranks):
    got, want = ranks[-1][0]["micro"], ranks[2]["micro"]
    assert abs(got["step_loss"] - want["loss"]) <= 1e-4 * max(
        1.0, abs(want["loss"]))
    for tree in ("m", "v"):
        for k, w in want[tree].items():
            assert scaled(got[tree][k], w) <= 1e-4, (tree, k)
    assert_step_matches(got["params"], want["params"], want["lr"], "micro")


@pytest.mark.parametrize("label", ["m12", "m21"])
def test_int8_own_noise_on_shards_equals_the_whole_round_trip(ranks, label):
    for r in ranks[-1]:
        assert r["int8_own"][label] == []


def test_int8_round_trip_on_shards_matches_jax(ranks):
    import jax.numpy as jnp

    inputs, key, jax_int8 = ranks[0], ranks[4], ranks[5]
    want = jax_int8({k: jnp.asarray(v) for k, v in
                     inputs["int8_grads"].items()}, key)
    for r in ranks[-1]:
        assert set(r["int8_trip"]) == set(want)
        for k, w in want.items():
            assert scaled(r["int8_trip"][k], np.asarray(w)) <= 1e-6, k


@pytest.mark.parametrize("against", ["one_rank", "jax"])
def test_int8_step_on_21_matches(ranks, one_rank, against):
    """Against the one-rank port (the port's noise) and JAX's step (JAX's
    noise in the port's round trip): one scale per JAX key, as JAX's.
    The round trip is discontinuous: a gradient element within f32
    summation noise of a rounding boundary takes the neighbouring int8
    level on one side (one level is 1/127 of the leaf's largest
    gradient).  So the moments agree within 1e-4 of each leaf's largest
    magnitude except on at most 1e-3 of the elements, each within one
    level (m: 1/127 of the largest; v = g^2: 2/127)."""
    if against == "jax":
        got, other = ranks[-1][0]["int8_step_jax_noise"], ranks[2]["int8"]
    else:
        got, other = ranks[-1][0]["int8_step"], one_rank["int8"][0]
    assert abs(got["step_loss"] - other["step_loss"]) <= 1e-4
    off, total = 0, 0
    for tree, level in (("m", 1 / 127), ("v", 2 / 127)):
        for k, w in other[tree].items():
            diff = np.abs(got[tree][k] - w) / max(float(np.abs(w).max()),
                                                  1e-30)
            assert float(diff.max()) <= level + 1e-4, (tree, k)
            off += int((diff > 1e-4).sum())
            total += diff.size
    assert off <= 1e-3 * total, (off, total)
    assert_step_matches(got["params"], other["params"], other["lr"], "int8")


def test_sharded_prefill_on_12_matches_jax(ranks):
    want = ranks[3]
    for r in ranks[-1]:
        assert r["prefill"].shape == want.shape
        assert scaled(r["prefill"], want) <= 1e-4


@pytest.mark.parametrize("label", ["m12", "m21"])
def test_every_local_shard_is_jax_specs_slice(ranks, label):
    for r in ranks[-1]:
        assert r["shards"][label] == []


@pytest.mark.parametrize("what", [*FORMER_REFUSALS, "decode", "prefill_cache"])
def test_next_slice_raises_under_a_mesh(ranks, what):
    """The families and steps this test once saw refused under a mesh
    (MoE, MLA, the Mamba2 hybrid, RWKV6; decode and the cache-writing
    prefill) now run on ``(2, 1)`` and give the unsharded model's logits
    within 1e-4 of their largest magnitude (decode: the same greedy
    tokens).  ``test_torch_sharded_families.py`` and
    ``test_torch_sharded_decode.py`` hold them to JAX.  The name is the
    one the test had when it asserted the refusal."""
    for r in ranks[-1]:
        err = r["former_refusals"][what]
        assert err <= 1e-4, (f"{what} runs under a mesh but is {err} of "
                             f"its largest magnitude from the unsharded "
                             f"model")


@pytest.mark.parametrize("label", ["m12", "m21"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_gqa_families_match_one_rank_under_a_mesh(ranks, arch, label):
    """Each GQA dense family's loss and gradients on the mesh against the
    one-rank port's on the shared ``:smoke`` case (pixtral with its prefix
    embeddings, danube3 with its window), by the one-card standard; the
    one-rank port is held to JAX on the same case by
    ``test_torch_train_step.py``."""
    want_loss, _, want = port(arch, "flash")
    for r in ranks[-1]:
        loss, got = r["families"][label, arch]
        assert abs(loss - want_loss) <= 1e-4 * max(1.0, abs(want_loss))
        errs = scaled_errs(got, want)
        worst = max(errs, key=errs.get)
        assert errs[worst] <= 1e-4, (worst, errs[worst])
