"""Elastic resharding and the sharded launcher's checkpoints, on two
``gloo`` CPU ranks (one spawn, ``torch_shard_cases.py``).

* ``reshard_tree``: qwen3-4b ``:smoke``'s JAX-keyed parameters placed on
  ``(2, 1)`` by JAX's specs, then moved onto ``(1, 2)`` (another mesh:
  through the whole tensors), equal the originals leaf for leaf, placed
  by the new specs; a move on one mesh redistributes; nested trees and
  cache tuples keep their structure.
* ``launch/train.py --model-parallel 2`` (a ``(1, 2)`` mesh; f32
  compute) writes its checkpoints once; a run with ``--model-parallel
  0`` (``(2, 1)``) resumes from the newest and its next step agrees with
  the uninterrupted ``(1, 2)`` run's by the one-card standard: moments
  within 1e-4 of each leaf's largest magnitude, parameters within 1e-5
  but for at most 1e-4 of the elements, each within 2 lr.
* Each checkpoint directory holds one file per leaf of each tree and no
  temporary directory, and JAX's ``CheckpointManager`` reads it.
* ``CheckpointManager.restore(mesh=, specs=)`` (each rank reading its
  own blocks) gives on both meshes DTensors placed by the specs whose
  whole tensors equal the files exactly; ``restore_train_state`` from
  them (each parameter's block straight from the key's local block)
  gives the parameters and moments that the whole host trees give.
* ``launch/train.py --model-parallel 2`` takes every family: granite,
  deepseek-v2, zamba2 and rwkv6 train two steps on ``(1, 2)``.
* The mesh's check that every rank hashes strings alike: a value equal
  on both ranks passes, the rank's own number does not.
* ``init_module`` (drawn a layer's slice at a time, each rank keeping its
  blocks) equals ``from_jax_params(init_model(...))`` from the same seed,
  block for block, on both meshes and without one.
"""
import os

import numpy as np
import pytest
import torch
from torch_shard_cases import (assert_step_matches, init_group, load_inputs,
                               mesh_of, save_result, scaled, spawn)

from repro_torch.config import get_config
from repro_torch.models import transformer as ttfm
from repro_torch.models.attention import AttnCache
from repro_torch.models.params import param_specs
from repro_torch.sharding.rules import make_rules, spec_placements
from repro_torch.train import CheckpointManager

LR_WARMUP = 2  # the launcher's warmup at --steps 3: max(2, 3 // 10)
#: the families that run under a mesh since MoE, MLA and the recurrent
#: scans were sharded: two launcher steps each on (1, 2)
FAMILIES = ("granite-moe-3b-a800m", "deepseek-v2-236b", "zamba2-1.2b",
            "rwkv6-3b")
TRAIN = ["--smoke", "--device", "cpu", "--seq", "16", "--batch", "4",
         "--ckpt-every", "1"]


def _launcher(ckpt, steps, mp, arch="qwen3-4b"):
    """The launcher with f32 compute (its bf16 default rounds otherwise on
    each mesh, past the f32 standard)."""
    import functools

    from repro_torch.config import RunConfig
    from repro_torch.launch import train as launch

    launch.RunConfig = functools.partial(RunConfig, compute_dtype="float32")
    try:
        launch.main([*TRAIN, "--arch", arch, "--ckpt-dir", ckpt, "--steps",
                     str(steps), "--model-parallel", str(mp)])
    finally:
        launch.RunConfig = RunConfig


def _rank_main(rank, world, init_file, tmp):
    import contextlib
    import io

    import torch.distributed as dist

    from torch.distributed.tensor import Replicate

    from repro_torch.train.elastic import reshard_tree

    init_group(rank, world, init_file)
    try:
        inp = load_inputs(tmp)
        out = {}
        m21, m12 = mesh_of((2, 1)), mesh_of((1, 2))
        tree = {k: torch.from_numpy(v) for k, v in inp["params"].items()}
        on21 = reshard_tree(tree, m21, inp["specs21"])
        on12 = reshard_tree(on21, m12, inp["specs12"])
        out["moved"] = {k: (list(map(str, v.placements)),
                            v.full_tensor().numpy()) for k, v in
                        on12.items()}
        out["want_placements"] = {  # the data axis of one rank replicates
            k: list(map(str, [Replicate(), spec_placements(
                ("data", "model"), s)[1]]))
            for k, s in inp["specs12"].items()}
        back = reshard_tree(on12, m12, inp["specs21"])  # the same mesh
        out["same_mesh"] = all(v.device_mesh is m12 for v in back.values())
        cache = {"layers": AttnCache(torch.zeros(2, 4, 8, 16),
                                     torch.ones(2, 4, 8, 16),
                                     torch.zeros(2, 4, 8, dtype=torch.int32))}
        spec = {"layers": AttnCache((None, "data", None, "model"),
                                    (None, "data", None, "model"),
                                    (None, "data", None))}
        placed = reshard_tree(cache, m21, spec)
        out["cache"] = (type(placed["layers"]).__name__,
                        placed["layers"].v.full_tensor().sum().item())
        # the launcher: (1, 2) for 2 steps, resumed on (2, 1) for a third;
        # the uninterrupted (1, 2) run for 3
        resumed, straight = (os.path.join(tmp, d) for d in ("a", "b"))
        logs = {}
        for label, (ckpt, steps, mp) in {"first": (resumed, 2, 2),
                                         "resume": (resumed, 3, 0),
                                         "straight": (straight, 3, 2)
                                         }.items():
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                _launcher(ckpt, steps, mp)
            logs[label] = buf.getvalue()
        out["logs"] = logs
        out["families"] = {}
        for arch in FAMILIES:  # every family takes --model-parallel 2
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                _launcher(os.path.join(tmp, arch), 2, 2, arch)
            out["families"][arch] = buf.getvalue()
        out["restored"] = _placed_restores(resumed, {"m21": m21,
                                                     "m12": m12})
        out["init"] = {label: _init_mismatches(mesh) for label, mesh in
                       (("m21", m21), ("m12", m12))}
        from repro_torch.launch.mesh import (check_same_hash_seed,
                                             same_on_every_rank)

        check_same_hash_seed()  # the ranks were spawned with one seed
        out["same"] = (same_on_every_rank(7), same_on_every_rank(rank))
        save_result(tmp, rank, out)
    finally:
        dist.destroy_process_group()


def _placed_restores(ckpt, meshes):
    """Per mesh: whether each restored leaf is placed by its spec and is
    the file's array, and whether ``restore_train_state`` from the placed
    trees equals it from the whole host trees."""
    from repro_torch.config import RunConfig
    from repro_torch.models.convert import init_module, to_jax_params
    from repro_torch.sharding.rules import mesh_placements
    from repro_torch.train import restore_train_state

    cfg = get_config("qwen3-4b", smoke=True)
    mgr = CheckpointManager(ckpt)
    whole = mgr.restore(3, device="cpu")[0]
    out = {}
    for label, mesh in meshes.items():
        rules = make_rules(mesh)
        specs = param_specs(ttfm.model_defs(cfg), rules)
        trees = mgr.restore(3, mesh=mesh, specs=dict.fromkeys(whole, specs))[0]
        leaves = all(
            list(v.placements) == mesh_placements(mesh, specs[k])
            and torch.equal(v.full_tensor(), whole[t][k])
            for t, tree in trees.items() for k, v in tree.items())
        models = []
        for src in (trees, whole):
            model = init_module(cfg, torch.Generator().manual_seed(9),
                                run=RunConfig(), trainable=True, mesh=mesh,
                                rules=rules)
            opt = restore_train_state(model, src, 3)
            models.append({n: to_jax_params(model, tree) for n, tree in
                           (("params", None), ("m", opt.m), ("v", opt.v))})
        same = all(torch.equal(models[0][t][k], v)
                   for t, tree in models[1].items() for k, v in tree.items())
        out[label] = (leaves, same)
    return out


def _init_mismatches(mesh):
    """The parameters whose local block from ``init_module`` differs from
    ``from_jax_params(init_model(...))``'s from the same seed."""
    from repro_torch.models.convert import from_jax_params, init_module

    cfg = get_config("qwen3-4b", smoke=True)
    want = from_jax_params(cfg, ttfm.init_model(
        cfg, torch.Generator().manual_seed(4)), device="cpu",
        trainable=True, mesh=mesh)
    got = init_module(cfg, torch.Generator().manual_seed(4), trainable=True,
                      mesh=mesh)
    w = dict(want.named_parameters())
    return [n for n, p in got.named_parameters()
            if list(p.placements) != list(w[n].placements)
            or not torch.equal(p.to_local(), w[n].to_local())]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cfg = get_config("qwen3-4b", smoke=True)
    gen = torch.Generator().manual_seed(3)
    params = {k: v.numpy() for k, v in ttfm.init_model(cfg, gen).items()}
    defs = ttfm.model_defs(cfg)
    specs = {label: param_specs(defs, make_rules(shape)) for label, shape in
             (("specs21", {"data": 2, "model": 1}),
              ("specs12", {"data": 1, "model": 2}))}
    tmp = str(tmp_path_factory.mktemp("elastic"))
    res = spawn(_rank_main, 2, tmp, {"params": params, **specs})
    return params, specs, tmp, res


def test_reshard_tree_moves_across_meshes_leaf_for_leaf(ranks):
    params, _, _, res = ranks
    for r in res:
        assert set(r["moved"]) == set(params)
        for k, (pl, full) in r["moved"].items():
            np.testing.assert_array_equal(full, params[k])
            assert pl == r["want_placements"][k], k
        assert r["same_mesh"]
        assert r["cache"] == ("AttnCache", 2 * 4 * 8 * 16)


def test_model_parallel_launcher_runs_on_the_mesh(ranks):
    for r in ranks[-1]:
        logs = r["logs"]
        assert "mesh={'data': 1, 'model': 2}" in logs["first"]
        assert "resume from step 2 onto {'data': 2, 'model': 1}" in \
            logs["resume"]
        assert "done" in logs["resume"] and "done" in logs["straight"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_model_parallel_launcher_takes_every_family(ranks, arch):
    """MoE, MLA, the Mamba2 hybrid and RWKV6 train two steps through the
    launcher on a (1, 2) mesh, with finite losses."""
    import math
    import re

    for r in ranks[-1]:
        log = r["families"][arch]
        assert "mesh={'data': 1, 'model': 2}" in log and "done" in log
        losses = [float(x) for x in re.findall(r"loss=(\S+)", log)]
        assert losses and all(math.isfinite(x) for x in losses)


def _restore(tmp, d, step):
    return CheckpointManager(os.path.join(tmp, d)).restore(step,
                                                           device="cpu")[0]


def test_resume_on_another_mesh_matches_the_uninterrupted_run(ranks):
    from repro_torch.train.optimizer import cosine_schedule

    tmp = ranks[2]
    before = _restore(tmp, "a", 2), _restore(tmp, "b", 2)
    for tree in ("params", "m", "v"):  # the shared state of step 2
        for k, v in before[0][tree].items():
            assert torch.equal(v, before[1][tree][k]), (tree, k)
    got, want = _restore(tmp, "a", 3), _restore(tmp, "b", 3)
    for tree in ("m", "v"):
        for k, w in want[tree].items():
            assert scaled(got[tree][k].numpy(), w.numpy()) <= 1e-4, (tree, k)
    lr = float(cosine_schedule(3, 3e-4, warmup=LR_WARMUP, total=3))
    assert_step_matches({k: v.numpy() for k, v in got["params"].items()},
                        {k: v.numpy() for k, v in want["params"].items()},
                        lr, "resume")


def test_checkpoint_written_once_and_jax_reads_it(ranks):
    pytest.importorskip("jax")
    from repro.train import CheckpointManager as JaxManager

    params, _, tmp, _ = ranks
    for d in ("a", "b"):
        root = os.path.join(tmp, d)
        assert sorted(os.listdir(root)) == ["step_0000000002",
                                            "step_0000000003"]
        step_dir = os.path.join(root, "step_0000000003")
        for tree in ("params", "m", "v"):
            files = sorted(os.listdir(os.path.join(step_dir, tree)))
            assert files == sorted(k.replace("/", "__") + ".npy"
                                   for k in params)
        trees, meta = JaxManager(root).restore(3)
        assert meta == {"step": 3}
        ours = _restore(tmp, d, 3)
        for tree in ("params", "m", "v"):
            for k, v in ours[tree].items():
                np.testing.assert_array_equal(np.asarray(trees[tree][k]),
                                              v.numpy())


@pytest.mark.parametrize("label", ["m21", "m12"])
def test_restore_places_each_ranks_blocks_from_the_files(ranks, label):
    for r in ranks[-1]:
        leaves, same = r["restored"][label]
        assert leaves, "a restored leaf is misplaced or differs from its file"
        assert same, "the placed trees restore other values than the whole"


@pytest.mark.parametrize("label", ["m21", "m12", "none"])
def test_init_module_equals_from_jax_params_of_init_model(ranks, label):
    if label != "none":
        for r in ranks[-1]:
            assert r["init"][label] == []
        return
    from repro_torch.models.convert import from_jax_params, init_module

    cfg = get_config("qwen3-4b", smoke=True)
    want = from_jax_params(cfg, ttfm.init_model(
        cfg, torch.Generator().manual_seed(4)), device="cpu")
    got = init_module(cfg, torch.Generator().manual_seed(4))
    w = dict(want.named_parameters())
    for n, p in got.named_parameters():
        assert torch.equal(p, w[n]), n


def test_ranks_compare_a_value(ranks):
    for r in ranks[-1]:
        assert r["same"] == (True, False)
