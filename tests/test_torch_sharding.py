"""The port's logical-axis sharding rules against the JAX package's, with
no process group (the tables read only the mesh's axis names).

* ``param_specs`` of every family at ``:smoke`` equals JAX's
  ``param_specs(model_defs(cfg), make_rules(mesh, ...))`` as tuples of
  axis names, on the ``(1, 1)``, ``(2, 1)``, ``(1, 2)`` and ``{"pod": 2,
  "data": 1, "model": 2}`` meshes (JAX: a one-device mesh of those axis
  names), for every ``make_rules`` keyword.
* ``cache_logical`` equals JAX's for every family, batch-shardable or
  not, sequence-sharded or not.
* Each port parameter's placements are those of its JAX key's spec
  through the converter's mapping: a ``layers/`` slice drops the stack
  dim, a Linear weight (out, in) reverses JAX's (in, out).
"""
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.config import get_config, list_configs
from repro_torch.models import transformer as ttfm
from repro_torch.models.attention import head_shards
from repro_torch.models.convert import jax_slot, param_logical
from repro_torch.models.params import param_specs
from repro_torch.sharding.rules import (constrain, make_rules, placements,
                                        shard_shape, spec_placements)

jax = pytest.importorskip("jax")

ARCHS = list_configs()
MESHES = {"m11": {"data": 1, "model": 1}, "m21": {"data": 2, "model": 1},
          "m12": {"data": 1, "model": 2},
          "pod": {"pod": 2, "data": 1, "model": 2}}
KEYWORDS = [{}, {"fsdp_axis": None}, {"fsdp_axis": "model"},
            {"expert_sharding": "tensor"}, {"batch_shardable": False},
            {"seq_shard_kv": True}, {"vocab_shardable": False},
            {"act_shard_model": True}]


def _jax_mesh(shape: dict):
    return jax.make_mesh((1,) * len(shape), tuple(shape))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax(arch, mesh):
    from repro.config import get_config as jax_get_config
    from repro.models import transformer as jtfm
    from repro.models.params import param_specs as jax_param_specs
    from repro.sharding.rules import make_rules as jax_make_rules

    shape = MESHES[mesh]
    jmesh = _jax_mesh(shape)
    defs = ttfm.model_defs(get_config(arch, smoke=True))
    jdefs = jtfm.model_defs(jax_get_config(arch, smoke=True))
    for kw in KEYWORDS:
        got = param_specs(defs, make_rules(shape, **kw))
        want = jax_param_specs(jdefs, jax_make_rules(jmesh, **kw))
        assert got == {k: tuple(s) for k, s in want.items()}, kw
        # the whole rule table, every logical name
        assert make_rules(shape, **kw).table == jax_make_rules(
            jmesh, **kw).table


def _as_tuples(tree):
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_tuples(v) for v in tree]
    if hasattr(tree, "_fields"):
        return (type(tree).__name__, tree._fields,
                tuple(getattr(tree, f) for f in tree._fields))
    return tree


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_logical_matches_jax(arch):
    from repro.config import get_config as jax_get_config
    from repro.models import transformer as jtfm

    cfg, jcfg = get_config(arch, smoke=True), jax_get_config(arch,
                                                              smoke=True)
    for b in (True, False):
        for s in (True, False):
            assert _as_tuples(ttfm.cache_logical(cfg, b, s)) == _as_tuples(
                jtfm.cache_logical(jcfg, b, s)), (b, s)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_port_placements_follow_the_converters_mapping(arch, mesh):
    shape = MESHES[mesh]
    cfg = get_config(arch, smoke=True)
    rules = make_rules(shape)
    jspecs = param_specs(ttfm.model_defs(cfg), rules)
    names = tuple(shape)
    for name, logical in param_logical(cfg).items():
        key, idx, transposed = jax_slot(name)
        spec = jspecs[key][1:] if idx is not None else jspecs[key]
        spec = tuple(reversed(spec)) if transposed else spec
        assert placements(shape, rules, logical) == spec_placements(
            names, spec), name


def test_qwen3_wq_is_column_sharded_and_heads_stay_whole():
    cfg = get_config("qwen3-4b")
    logical = param_logical(cfg)
    shape = {"data": 2, "model": 2}
    rules = make_rules(shape)
    assert placements(shape, rules, logical["layers.0.attn.wq.weight"]) == [
        Shard(1), Shard(0)]  # data: in-features, model: out-features
    assert placements(shape, rules, logical["layers.0.attn.q_norm"]) == [
        Replicate(), Replicate()]
    # heads_flat 4,096 and kv_flat 1,024 split on whole heads: model 2
    # gives rank 0 q heads 0-15 and kv heads 0-3 (one GQA group each)
    hd = cfg.resolved_head_dim
    assert shard_shape((cfg.n_heads * hd, cfg.d_model), shape,
                       rules.spec(("heads_flat", "embed"))) == (
        16 * hd, cfg.d_model // 2)
    assert shard_shape((cfg.n_kv_heads * hd,), shape,
                       rules.spec(("kv_flat",))) == (4 * hd,)
    assert head_shards(shape, cfg.n_heads, cfg.n_kv_heads) == 2
    with pytest.raises(ValueError, match="do not split evenly"):
        head_shards({"data": 1, "model": 16}, cfg.n_heads, cfg.n_kv_heads)


def test_constrain_is_a_noop_off_mesh():
    x = torch.ones(2, 3)
    rules = make_rules({"data": 1, "model": 1})
    assert constrain(x, None, rules, ("batch", None)) is x
    assert constrain(x, {"data": 1, "model": 1}, rules, ("batch", None)) is x
