"""The port's expert-parallel MoE
(:mod:`repro_torch.models.moe_expert_parallel`) against the JAX package's
``moe_apply``, as ``tests/test_distributed.py::test_expert_parallel_a2a_moe``
checks JAX's ``shard_map`` version.

Ranks are ``gloo`` processes on the CPU (``torch.multiprocessing.spawn``,
a ``file://`` store), one spawn per world size running every case of that
world and pickling each rank's outputs and counts for the tests to read:

* W = 2, a 1-D ``("model",)`` mesh: 4 experts a rank, each rank routing
  half of the tokens; the rank holding only its own expert slices;
* W = 2, a (2, 1) ``("data", "model")`` mesh: one model rank per data
  shard, so each rank's dispatch is the flat one over its shard, drops
  included (capacity factor 0.5);
* W = 4, a (2, 2) ``("data", "model")`` mesh.

deepseek-v2's smoke MoE (8 experts, top 2) without its shared expert (the
expert-parallel layer has none, as in JAX), capacity factor 64 where
nothing may drop.  Held within 1e-4 (f32): the output of every rank
against JAX's ``moe_apply`` on its data shard; every rank of a model group
the same output.  Counted on every rank: 2 ``all_to_all_single``, 1
``all_gather_into_tensor``, 0 ``all_reduce`` per layer, by the module's
counter and by the process group's own calls.
"""
import dataclasses
import datetime
import os
import pickle

import numpy as np
import pytest
import torch

from repro_torch.config import get_config

ARCH = "deepseek-v2-236b"
TIMEOUT_S = 60
# label -> (world, mesh shape, mesh dim names, capacity factor, local)
CASES = {
    "model2": (2, (2,), ("model",), 64.0, True),
    "data2_model1": (2, (2, 1), ("data", "model"), 0.5, False),
    "data2_model2": (4, (2, 2), ("data", "model"), 64.0, False),
}
COLLECTIVES = ("all_to_all_single", "all_gather_into_tensor", "all_reduce")


def _cfg(cf):
    cfg = get_config(ARCH, smoke=True)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf, n_shared_experts=0, d_ff_shared=0))


def _inputs(cfg):
    """numpy MoE weights (JAX keys under ``moe/``) and x (4, 8, d)."""
    rng = np.random.default_rng(7)
    mo, d = cfg.moe, cfg.d_model
    shapes = {"router": (d, mo.n_experts),
              "w_gate": (mo.n_experts, d, mo.d_ff_expert),
              "w_up": (mo.n_experts, d, mo.d_ff_expert),
              "w_down": (mo.n_experts, mo.d_ff_expert, d)}
    p = {"moe/" + k: (rng.standard_normal(s, dtype=np.float32)
                      / np.sqrt(s[-2])) for k, s in shapes.items()}
    return p, rng.standard_normal((4, 8, d), dtype=np.float32)


def _rank_main(rank, world, init_file, out_dir):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.models import moe_expert_parallel as ep

    torch.set_num_threads(1)  # the ranks share the test worker's cores
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    calls = {name: 0 for name in COLLECTIVES}

    def counted(name):
        fn = getattr(dist, name)

        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    for name in COLLECTIVES:
        setattr(dist, name, counted(name))
    out = {}
    try:
        for label, (w, shape, names, cf, local) in CASES.items():
            if w != world:
                continue
            mesh = DeviceMesh("cpu", torch.arange(world).reshape(shape),
                              mesh_dim_names=names)
            cfg = _cfg(cf)
            p, x = _inputs(cfg)
            p = {k: torch.from_numpy(v) for k, v in p.items()}
            n_data = shape[0] if "data" in names else 1
            d_rank = mesh.get_local_rank("data") if "data" in names else 0
            x_loc = torch.from_numpy(np.split(x, n_data)[d_rank])
            apply = ep.make_expert_parallel_moe(cfg, mesh)
            if local:
                e_loc = cfg.moe.n_experts // mesh["model"].size()
                m_rank = mesh.get_local_rank("model")
                p = {k: v if k.endswith("router")
                     else v[m_rank * e_loc:(m_rank + 1) * e_loc].clone()
                     for k, v in p.items()}
            before = dict(calls)
            module_before = dict(ep.COLLECTIVES)
            y = apply(p, "moe/", x_loc)
            out[label] = dict(
                y=y.numpy(), data_rank=d_rank,
                calls={k: calls[k] - before[k] for k in COLLECTIVES},
                counted={k: ep.COLLECTIVES[k] - module_before.get(k, 0)
                         for k in ("all_to_all", "all_gather")})
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _spawn(world, tmp) -> list:
    import torch.multiprocessing as mp

    os.makedirs(tmp, exist_ok=True)
    mp.spawn(_rank_main, args=(world, os.path.join(tmp, "pg"), tmp),
             nprocs=world, join=True)
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``{label: [rank 0's results, rank 1's, ...]}``."""
    out = {}
    for world in sorted({c[0] for c in CASES.values()}):
        res = _spawn(world, str(tmp_path_factory.mktemp(f"ep_w{world}")))
        for label in CASES:
            if CASES[label][0] == world:
                out[label] = [r[label] for r in res]
    return out


@pytest.mark.parametrize("label", sorted(CASES))
def test_expert_parallel_matches_moe_apply(ranks, label):
    jnp = pytest.importorskip("jax.numpy")
    from repro.models import moe as jmoe

    _, shape, names, cf, _ = CASES[label]
    cfg = _cfg(cf)
    p, x = _inputs(cfg)
    n_data = shape[0] if "data" in names else 1
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    for rank in ranks[label]:
        x_loc = np.split(x, n_data)[rank["data_rank"]]
        want, _ = jmoe.moe_apply(cfg, jp, "moe/", jnp.asarray(x_loc))
        assert rank["y"].shape == x_loc.shape
        err = float(np.abs(rank["y"] - np.asarray(want)).max())
        assert err <= 1e-4, (label, err)


@pytest.mark.parametrize("label", sorted(CASES))
def test_expert_parallel_collectives(ranks, label):
    """Two all-to-alls and one all-gather a layer on every rank, no
    all-reduce; every rank of a model group returns the same output."""
    for rank in ranks[label]:
        assert rank["calls"] == {"all_to_all_single": 2,
                                 "all_gather_into_tensor": 1,
                                 "all_reduce": 0}
        assert rank["counted"] == {"all_to_all": 2, "all_gather": 1}
    by_data = {}
    for rank in ranks[label]:
        by_data.setdefault(rank["data_rank"], []).append(rank["y"])
    for ys in by_data.values():
        for y in ys[1:]:
            np.testing.assert_array_equal(y, ys[0])


def test_expert_parallel_matches_the_ports_flat_dispatch(ranks):
    """One model rank per data shard: the rank's capacity is the flat
    dispatch's, so the output (drops included) is the port's own
    ``moe_apply`` on the shard."""
    from repro_torch.models import moe as tmoe

    cfg = _cfg(CASES["data2_model1"][3])
    p, x = _inputs(cfg)
    moe = tmoe.MoE(cfg)
    for name, param in moe.named_parameters():
        param.data = torch.from_numpy(p["moe/" + name])
    with torch.inference_mode():
        for rank in ranks["data2_model1"]:
            want, _ = tmoe.moe_apply(moe, torch.from_numpy(
                np.split(x, 2)[rank["data_rank"]]))
            assert float(np.abs(rank["y"] - want.numpy()).max()) <= 1e-6


def test_experts_must_split_over_the_model_ranks():
    from repro_torch.models.moe_expert_parallel import \
        make_expert_parallel_moe

    class Mesh:  # a 3-rank model dimension (only its size is read)
        def __getitem__(self, name):
            return self

        def size(self):
            return 3

    with pytest.raises(ValueError, match="experts"):
        make_expert_parallel_moe(_cfg(64.0), Mesh())
