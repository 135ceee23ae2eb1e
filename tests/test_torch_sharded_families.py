"""MoE, MLA, the Mamba2 hybrid and RWKV6 under a ``("data", "model")``
mesh of two ``gloo`` CPU ranks against the JAX package and the one-rank
port: granite-moe-3b-a800m, deepseek-v2-236b, zamba2-1.2b and rwkv6-3b at
``:smoke`` in f32, on the shared training cases of
``torch_train_cases.py``, one spawn for every case
(``torch_shard_cases.py``).

* On ``(1, 2)`` and ``(2, 1)``, parameters placed by ``make_rules(mesh)``
  (experts on the model axis, granite's 5 split 3 + 2): the cacheless
  prefill's logits within 1e-4 of their largest magnitude of JAX's and
  of the one-rank port's; the loss and every gradient of the training
  loss (remat ``"full"``) within 1e-4 (each leaf's largest magnitude,
  floor 1e-3 of the largest leaf); one train step's parameters by the
  one-card standard (``assert_step_matches``) against JAX's step and the
  one-rank port's.
* MoE's capacity, sort and drops are JAX's in every layout: on ``(2,
  1)`` with ``moe_groups`` None (every rank routes all tokens) and 2 (each
  data shard routes its own group), and on ``(1, 2)`` in ``"expert"`` and
  ``"tensor"`` mode (each rank a slice of every expert's ffn): logits
  within 1e-4 and the Switch aux loss within 1e-6 of JAX's forward with
  the same ``moe_groups``; the ``"tensor"`` mode's gradients as above;
  each rank's block of every MoE parameter is the slice JAX's spec gives
  it in that mode.
* One expert over the 2-rank model axis leaves rank 1 none: its part is
  0, and the logits and aux loss are JAX's.
* The scans and the MoE body see only their rank's own part: the shapes
  that ``ssd_chunked``, ``wkv_chunked`` and the routed body receive (each
  rank's heads, experts or ffn slice, and its batch rows where the batch
  is split).
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch_shard_cases import (assert_step_matches, init_group, load_inputs,
                               mesh_of, save_result, scaled, spawn,
                               spec_slice)
from torch_train_cases import case, jax_value_and_grad, scaled_errs

from repro_torch.config import RunConfig, get_config

pytest.importorskip("jax")

FAMILIES = ("deepseek-v2-236b", "granite-moe-3b-a800m", "rwkv6-3b",
            "zamba2-1.2b")
MOE = ("deepseek-v2-236b", "granite-moe-3b-a800m")
ONE_EXPERT = "granite-moe-3b-a800m"
LR, WARMUP = 1e-3, 2
KW = dict(attention_impl="flash", attention_chunk=16, remat="full",
          compute_dtype="float32", learning_rate=LR)
#: label -> (mesh shape, make_rules overrides, RunConfig overrides): the
#: MoE layouts
MOE_RUNS = {"m21_flat": ((2, 1), {}, {}),
            "m21_groups2": ((2, 1), {}, {"moe_groups": 2}),
            "m12_expert": ((1, 2), {}, {}),
            "m12_tensor": ((1, 2), {"expert_sharding": "tensor"}, {})}


def _batch(arch):
    return {k: torch.from_numpy(v) for k, v in case(arch)[3].items()}


def _record_shapes():
    """Wrap the scans and the routed MoE body (module globals, looked up
    at each call) to record the shapes they receive: ``{name: [shapes]}``
    (the routed body: x, then w_gate)."""
    from repro_torch.models import moe, rwkv, ssm

    seen = {"ssd": [], "wkv": [], "moe": []}

    def wrap(mod, name, key, pick):
        orig = getattr(mod, name)

        def recorded(*args, **kw):
            seen[key].append(pick(args))
            return orig(*args, **kw)

        setattr(mod, name, recorded)

    wrap(ssm, "ssd_chunked", "ssd", lambda a: tuple(a[0].shape))
    wrap(rwkv, "wkv_chunked", "wkv", lambda a: tuple(a[0].shape))
    wrap(moe, "_routed", "moe", lambda a: (tuple(a[6].shape),
                                            tuple(a[8].shape)))
    return seen


def _step(cfg, model, run, mesh, rules, batch):
    """(loss, JAX-keyed grads, the parameters and lr after one train step
    from ``model``'s state and zero moments)."""
    from repro_torch.models.convert import to_jax_params
    from repro_torch.train import adamw_init, make_grad_fn, make_train_step

    loss, _, grads = make_grad_fn(cfg, run, mesh, rules)(model, batch)
    grads = {k: v.numpy().copy() for k, v in to_jax_params(
        model, grads).items()}
    opt = adamw_init(dict(model.named_parameters()))
    model, _, mets = make_train_step(cfg, run, mesh, rules,
                                     warmup=WARMUP)(model, opt, batch)
    return {"loss": float(loss), "grads": grads, "lr": mets["lr"],
            "params": {k: v.numpy().copy()
                       for k, v in to_jax_params(model).items()}}


def _rank_main(rank, world, init_file, tmp):
    import torch.distributed as dist

    from repro_torch.models.convert import from_jax_params
    from repro_torch.serve import make_prefill_step
    from repro_torch.sharding.rules import make_rules

    init_group(rank, world, init_file)
    try:
        inp = load_inputs(tmp)
        seen = _record_shapes()
        out = {}
        for arch in FAMILIES:
            cfg = get_config(arch, smoke=True)
            params, batch = inp[arch]
            tb = {k: torch.from_numpy(v) for k, v in batch.items()}
            for label, shape in (("m12", (1, 2)), ("m21", (2, 1))):
                mesh, run = mesh_of(shape), RunConfig(**KW)
                rules = make_rules(mesh)
                model = from_jax_params(cfg, params, run=run, device="cpu",
                                        trainable=True, mesh=mesh,
                                        rules=rules)
                for v in seen.values():
                    v.clear()
                res = {"prefill": make_prefill_step(cfg, run, mesh, rules)(
                    model, tb["tokens"][:, :-1]).numpy()}
                res["shapes"] = {k: list(v) for k, v in seen.items()}
                res.update(_step(cfg, model, run, mesh, rules, tb))
                out[arch, label] = res
            if arch not in MOE:
                continue
            toks = tb["tokens"][:, :-1]
            pos = torch.arange(toks.shape[1], dtype=torch.int32).repeat(
                toks.shape[0], 1)
            for label, (shape, rkw, kw) in MOE_RUNS.items():
                mesh, run = mesh_of(shape), RunConfig(**{**KW, **kw})
                rules = make_rules(mesh, **rkw)
                model = from_jax_params(cfg, params, run=run, device="cpu",
                                        trainable=True, mesh=mesh,
                                        rules=rules)
                for v in seen.values():
                    v.clear()
                with torch.no_grad():
                    logits, _, aux = model(toks, pos)
                res = {"logits": logits.full_tensor().numpy(),
                       "aux": float(aux),
                       "shapes": list(seen["moe"]),
                       "coord": dict(zip(mesh.mesh_dim_names,
                                         mesh.get_coordinate())),
                       "blocks": {n: p.detach().to_local().numpy().copy()
                                  for n, p in model.named_parameters()
                                  if ".moe." in n}}
                if label == "m12_tensor":
                    res.update(_step(cfg, model, run, mesh, rules, tb))
                out[arch, label] = res
        # one expert on a 2-rank model axis: rank 1 holds none
        cfg, mesh = _one_expert(get_config(ONE_EXPERT, smoke=True)), \
            mesh_of((1, 2))
        params, toks = inp["one_expert"]
        model = from_jax_params(cfg, params, run=RunConfig(**KW),
                                device="cpu", mesh=mesh)
        for v in seen.values():
            v.clear()
        with torch.no_grad():
            logits, _, aux = model(torch.from_numpy(toks), torch.arange(
                toks.shape[1], dtype=torch.int32).repeat(toks.shape[0], 1))
        out["one_expert"] = {"logits": logits.full_tensor().numpy(),
                             "aux": float(aux), "shapes": list(seen["moe"])}
        save_result(tmp, rank, out)
    finally:
        dist.destroy_process_group()


def _one_expert(cfg):
    """``cfg`` with one expert routed top-1: split over a model axis of 2,
    the second rank holds no expert (as 40 over 16 leaves the last two)."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=1, top_k=1))


def _one_expert_jax():
    """(numpy params, tokens) of the one-expert case and JAX's logits and
    aux loss on them."""
    import jax
    import jax.numpy as jnp
    from repro.config import RunConfig as JaxRun
    from repro.models import transformer as jtfm

    jcfg = _one_expert(case(ONE_EXPERT)[1])
    params = {k: np.asarray(v) for k, v in jtfm.init_model(
        jcfg, jax.random.PRNGKey(7)).items()}
    toks = case(ONE_EXPERT)[3]["tokens"][:, :-1]
    pos = jnp.broadcast_to(jnp.arange(toks.shape[1], dtype=jnp.int32),
                           toks.shape)
    logits, _, aux = jtfm.make_forward(jcfg, JaxRun(**{
        **KW, "attention_impl": "chunked_causal", "remat": "none"}))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(toks),
        pos)
    return (params, toks), (np.asarray(logits), float(aux))


def _jax_results(arch):
    """JAX's prefill logits, one train step from the case's state, and
    its forward's logits and aux loss with ``moe_groups`` None and 2
    (numpy)."""
    import jax
    import jax.numpy as jnp
    from repro.config import RunConfig as JaxRun
    from repro.models import transformer as jtfm
    from repro.serve.decode import make_prefill_step as jax_prefill
    from repro.train import adamw_init as jax_adamw_init
    from repro.train import make_train_step as jax_make_train_step

    _, jcfg, params, batch = case(arch)
    jrun = JaxRun(**{**KW, "attention_impl": "chunked_causal",
                     "remat": "none"})
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    toks = jb["tokens"][:, :-1]
    out = {"prefill": np.asarray(jax.jit(jax_prefill(jcfg, jrun))(jp,
                                                                   toks))}
    new, _, mets = jax.jit(jax_make_train_step(jcfg, jrun, warmup=WARMUP))(
        jp, jax_adamw_init(jp), jb)
    out["params"] = {k: np.asarray(v) for k, v in new.items()}
    out["lr"] = float(mets["lr"])
    if jcfg.moe is not None:
        pos = jnp.broadcast_to(jnp.arange(toks.shape[1], dtype=jnp.int32),
                               toks.shape)
        for groups in (None, 2):
            logits, _, aux = jax.jit(jtfm.make_forward(
                jcfg, dataclasses.replace(jrun, moe_groups=groups)))(
                jp, toks, pos)
            out["forward", groups] = (np.asarray(logits), float(aux))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    inputs = {a: (case(a)[2], case(a)[3]) for a in FAMILIES}
    want = {a: _jax_results(a) for a in FAMILIES}
    inputs["one_expert"], want["one_expert"] = _one_expert_jax()
    res = spawn(_rank_main, 2, str(tmp_path_factory.mktemp("families")),
                inputs)
    return want, res


@pytest.fixture(scope="module")
def one_rank():
    """The one-rank port's prefill logits, loss, gradients and step on
    each case."""
    from repro_torch.models.convert import from_jax_params
    from repro_torch.serve import make_prefill_step

    out = {}
    for arch in FAMILIES:
        cfg, _, params, _ = case(arch)
        run, batch = RunConfig(**KW), _batch(arch)
        model = from_jax_params(cfg, params, run=run, device="cpu",
                                trainable=True)
        prefill = make_prefill_step(cfg, run)(model, batch["tokens"][:, :-1])
        out[arch] = {"prefill": prefill.numpy(),
                     **_step(cfg, model, run, None, None, batch)}
    return out


def _grads_match(got, want):
    assert abs(got["loss"] - want["loss"]) <= 1e-4 * max(
        1.0, abs(want["loss"]))
    errs = scaled_errs(got["grads"], want["grads"])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-4, (worst, errs[worst])


@pytest.mark.parametrize("label", ["m12", "m21"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_sharded_family_prefill_matches_jax_and_one_rank(ranks, one_rank,
                                                         arch, label):
    want, res = ranks
    for r in res:
        got = r[arch, label]["prefill"]
        for other in (want[arch]["prefill"], one_rank[arch]["prefill"]):
            assert got.shape == other.shape
            assert scaled(got, other) <= 1e-4


@pytest.mark.parametrize("label", ["m12", "m21"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_sharded_family_grads_match_jax_and_one_rank(ranks, one_rank, arch,
                                                     label):
    loss, grads = jax_value_and_grad(arch, "chunked_causal")
    for r in ranks[1]:
        got = r[arch, label]
        _grads_match(got, {"loss": loss, "grads": grads})
        _grads_match(got, one_rank[arch])


@pytest.mark.parametrize("label", ["m12", "m21"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_sharded_family_step_matches_jax_and_one_rank(ranks, one_rank, arch,
                                                      label):
    want, res = ranks
    got = res[0][arch, label]
    for other in (want[arch], one_rank[arch]):
        assert got["lr"] == pytest.approx(other["lr"], rel=1e-6)
        assert_step_matches(got["params"], other["params"], other["lr"],
                            (arch, label))


@pytest.mark.parametrize("label", sorted(MOE_RUNS))
@pytest.mark.parametrize("arch", MOE)
def test_moe_layouts_give_jax_slots_outputs_and_aux(ranks, arch, label):
    want, res = ranks
    groups = MOE_RUNS[label][2].get("moe_groups")
    w_logits, w_aux = want[arch]["forward", groups]
    for r in res:
        got = r[arch, label]
        assert scaled(got["logits"], w_logits) <= 1e-4
        assert abs(got["aux"] - w_aux) <= 1e-6
        assert got["aux"] > 0


@pytest.mark.parametrize("label", sorted(MOE_RUNS))
@pytest.mark.parametrize("arch", MOE)
def test_moe_shards_are_jax_specs_slices(ranks, arch, label):
    """Each rank's block of every MoE parameter (router, expert stacks,
    shared experts) equals the slice of the JAX-layout array that JAX's
    spec gives that rank under the same expert mode, through the port's
    mapping (stacks split, Linear weights transposed): exactly."""
    import jax
    from repro.models import transformer as jtfm
    from repro.models.params import param_specs as jax_param_specs
    from repro.sharding.rules import make_rules as jax_make_rules

    from repro_torch.models.convert import jax_slot

    shape, rkw, _ = MOE_RUNS[label]
    params = case(arch)[2]
    specs = jax_param_specs(jtfm.model_defs(case(arch)[1]), jax_make_rules(
        jax.make_mesh((1, 1), ("data", "model")), **rkw))
    sizes = dict(zip(("data", "model"), shape))
    for r in ranks[1]:
        got = r[arch, label]
        assert got["blocks"]
        for name, block in got["blocks"].items():
            key, idx, transposed = jax_slot(name)
            want = spec_slice(params[key], tuple(specs[key]), sizes,
                              got["coord"])
            want = want[idx] if idx is not None else want
            np.testing.assert_array_equal(
                block, want.T if transposed else want, err_msg=name)


def test_a_rank_without_experts_adds_nothing(ranks):
    """One expert over the 2-rank model axis in ``"expert"`` mode: rank 0
    holds it, rank 1 none (its routed body sees an empty stack); the
    logits and aux loss are JAX's."""
    want, res = ranks
    w_logits, w_aux = want["one_expert"]
    for rank, r in enumerate(res):
        got = r["one_expert"]
        assert scaled(got["logits"], w_logits) <= 1e-4
        assert abs(got["aux"] - w_aux) <= 1e-6
        assert {w[0] for _, w in got["shapes"]} == {1 - rank}


@pytest.mark.parametrize("arch", MOE)
def test_tensor_mode_grads_match_jax_and_one_rank(ranks, one_rank, arch):
    loss, grads = jax_value_and_grad(arch, "chunked_causal")
    for r in ranks[1]:
        got = r[arch, "m12_tensor"]
        _grads_match(got, {"loss": loss, "grads": grads})
        _grads_match(got, one_rank[arch])


def _moe_shapes(arch, label, rank):
    """The (x, w_gate) shapes rank ``rank``'s routed body receives."""
    cfg = get_config(arch, smoke=True)
    mo, (B, T1) = cfg.moe, case(arch)[3]["tokens"].shape
    E, d, f = mo.n_experts, cfg.d_model, mo.d_ff_expert
    x = (B, T1 - 1, d)
    if label == "m21_groups2":  # each data shard routes its own group
        x = (B // 2, T1 - 1, d)
    w = (E, d, f)
    if label in ("m12", "m12_expert"):  # experts split 3 + 2 / 4 + 4
        first = -(-E // 2)
        w = (first if rank == 0 else E - first, d, f)
    elif label == "m12_tensor":
        w = (E, d, f // 2)
    return x, w


@pytest.mark.parametrize("arch,label", [
    (a, lb) for a in FAMILIES for lb in ("m12", "m21")] + [
    (a, lb) for a in MOE for lb in sorted(MOE_RUNS)])
def test_scans_and_moe_body_see_their_own_part(ranks, arch, label):
    """Each rank's scan receives its own heads (and its batch rows where
    the batch is split), its routed MoE body its own experts or ffn
    slice."""
    cfg = get_config(arch, smoke=True)
    B, T1 = case(arch)[3]["tokens"].shape
    rows = B // 2 if label == "m21" else B
    heads = 2 if label == "m12" else 1
    for rank, r in enumerate(ranks[1]):
        shapes = r[arch, label]["shapes"]
        if label in MOE_RUNS:
            shapes = {"moe": shapes, "ssd": [], "wkv": []}
        if cfg.ssm is not None:
            s = cfg.ssm
            H = s.expand * cfg.d_model // s.head_dim
            assert set(shapes["ssd"]) == {(rows, T1 - 1, H // heads,
                                           s.head_dim)}
        if cfg.rwkv is not None:
            D = cfg.rwkv.head_dim
            assert set(shapes["wkv"]) == {(rows, T1 - 1,
                                           cfg.d_model // D // heads, D)}
        if cfg.moe is not None:
            assert set(shapes["moe"]) == {_moe_shapes(arch, label, rank)}
        assert any(shapes.values())
