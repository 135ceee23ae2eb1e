"""The port's launch dry runs against the JAX package's formulas, on the
CPU with no process group.

* ``roofline_terms`` and ``model_flops`` equal JAX's with JAX's TPU
  constants swapped for the port's H100 ones.
* ``census_dryrun`` on eatSR at ``--scale-down 64`` over the production
  mesh's 256 ranks: the task rows equal JAX's ``pack_tasks`` on the same
  graph arrays, and ``imbalance`` and ``lane_utilization`` equal JAX's
  definitions (JAX's ``GraphMeta`` tile width, its chunk rule).
* ``build_cell`` skips exactly the cells JAX's ``applicable`` skips; a
  meta-device dry run's parameter bytes are ``count_params x 4`` on one
  rank and, where every sharded dim divides evenly, each leaf's bytes
  over its shard count on the production mesh.
* ``sweep`` runs every (arch x shape x mesh shape) cell into a temporary
  directory with no failure, and ``report`` renders it.
"""
import json
import math
import os

import numpy as np
import pytest

from repro_torch.config import SHAPES, get_config
from repro_torch.launch import census_dryrun, dryrun, report, roofline, sweep
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import SkipCell, applicable, build_cell
from repro_torch.models import transformer as ttfm
from repro_torch.models.params import count_params

jax = pytest.importorskip("jax")


def test_roofline_terms_and_model_flops_match_jax(monkeypatch):
    from repro.launch import roofline as jr

    monkeypatch.setattr(jr, "PEAK_FLOPS", roofline.PEAK_FLOPS)
    monkeypatch.setattr(jr, "HBM_BW", roofline.HBM_BW)
    monkeypatch.setattr(jr, "ICI_BW", roofline.NVLINK_BW)
    for args in ((989e12, 3.35e12 * 2, 450e9 * 3), (1e15, 1e9, 0.0),
                 (0.0, 0.0, 7e9)):
        assert roofline.roofline_terms(*args) == jr.roofline_terms(*args)
    for kind in ("train", "prefill", "decode"):
        meta = {"active_params": 3.7e9, "kind": kind, "global_batch": 8,
                "seq_len": 4096}
        assert roofline.model_flops(meta) == jr.model_flops(meta)
    assert roofline.INT32_OPS == 132 * 64 * 1.98e9


def test_census_dryrun_matches_jax_packing():
    from repro.core import balance as jbalance
    from repro.core import generators as jgen
    from repro.engine.config import CensusConfig as JaxConfig
    from repro.engine.plan import GraphMeta as JaxMeta

    rec = census_dryrun.run("eatSR", scale_down=64)
    g, tmp = census_dryrun.build_graph("eatSR", 64)
    assert tmp is None
    jg = jgen.paper_profile("eatSR", scale_down=64)
    n_ranks = math.prod(make_production_mesh().values())
    assert rec["ranks"]["n"] == n_ranks == 256
    from repro_torch.core import balance

    got = balance.pack_tasks(g, n_ranks, pad_multiple=256)
    want = jbalance.pack_tasks(jg, n_ranks, pad_multiple=256)
    for f in ("u", "v", "valid"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert rec["imbalance"] == pytest.approx(want.imbalance, rel=1e-12)
    assert rec["ranks"]["dyads"] == want.valid.sum(1).tolist()
    # JAX's lane utilization: valid candidate lanes over padded lanes
    K = JaxMeta.from_graph(jg).k
    jcfg = JaxConfig(backend="distributed", batch=256)
    meta = JaxMeta.from_graph(jg)
    cap = -(-max(1, meta.m_nbr_bucket // 2) // 256) * 256
    chunk = min(jcfg.resolve_chunk(), cap)
    chunk_l = max(256, -(-max(1, chunk // n_ranks) // 256) * 256)
    deg = np.asarray(jg.arrays.nbr_deg)
    u, v = np.asarray(want.u)[want.valid], np.asarray(want.v)[want.valid]
    L = want.u.shape[1]
    util = float((deg[u] + deg[v]).sum()) / float(
        n_ranks * (-(-L // chunk_l) * chunk_l) * 2 * K)
    assert (rec["K"], rec["chunk_l"]) == (K, chunk_l)
    assert rec["lane_utilization"] == pytest.approx(util, rel=1e-12)
    b = rec["census_csr_bound"]
    assert b["bound_s"] == max(b["bytes_s"], b["operations_s"]) > 0


def test_census_dryrun_cli_writes_one_record(tmp_path, capsys):
    rec = census_dryrun.main(["--dataset", "slashdot", "--scale-down", "256",
                              "--out", str(tmp_path), "--tag", "t"])
    files = os.listdir(tmp_path)
    assert files == [f"census_slashdot_sorted_snake_K{rec['K']}_t.json"]
    with open(tmp_path / files[0]) as f:
        assert json.load(f)["imbalance"] == rec["imbalance"]
    assert "lane_utilization" in capsys.readouterr().out


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_build_cell_skips_what_jax_skips(shape):
    from repro.config import get_config as jax_get_config
    from repro.launch.specs import applicable as jax_applicable

    for arch in sweep.ARCHS:
        want, _ = jax_applicable(jax_get_config(arch), SHAPES[shape])
        assert applicable(get_config(arch), SHAPES[shape])[0] == want
        if want:
            build_cell(arch, shape, make_production_mesh())
        else:
            with pytest.raises(SkipCell):
                build_cell(arch, shape, make_production_mesh())


def test_dryrun_parameter_bytes():
    cfg = get_config("qwen3-4b")
    defs = ttfm.model_defs(cfg)
    cell = build_cell("qwen3-4b", "train_4k", {"data": 1, "model": 1})
    memory, _ = dryrun.analyze(cell)
    assert memory["params"] == count_params(defs) * 4
    assert memory["m"] == memory["v"] == memory["grads"] == memory["params"]
    # the production mesh: every sharded dim of qwen3-4b divides by 16
    mesh = make_production_mesh()
    cell = build_cell("qwen3-4b", "prefill_32k", mesh)
    want = 0
    for k, d in defs.items():
        spec = cell.specs["params"][k]
        splits = math.prod(mesh[a] for e in spec if e
                           for a in ((e,) if isinstance(e, str) else e))
        for n, e in zip(d.shape, spec):
            assert e is None or n % mesh[e] == 0
        want += math.prod(d.shape) * 2 // splits
    memory, rf = dryrun.analyze(cell)
    assert memory["params"] == want
    assert rf["model_flops_total"] == roofline.model_flops(cell.meta)
    assert rf["n_chips"] == 256 and rf["bottleneck"] in (
        "compute_s", "memory_s", "collective_s")


def test_sweep_and_report(tmp_path, capsys):
    counts = sweep.main(["--out", str(tmp_path)])
    assert (counts["ok"], counts["skip"], counts["fail"]) == (66, 14, 0)
    assert len(os.listdir(tmp_path)) == 80
    again = sweep.main(["--out", str(tmp_path), "--archs", "qwen3-4b"])
    assert again["ok"] + again["skip"] == 8  # cached
    capsys.readouterr()
    report.main(["--dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "### Roofline (single-pod, per H100)" in out
    assert "| qwen3-4b | train_4k | ok |" in out
    assert "| qwen3-4b | long_500k | skip" in out
    rec = dryrun.main(["--arch", "zamba2-1.2b", "--shape", "long_500k",
                       "--out", str(tmp_path / "one"), "--set",
                       "act_shard_model=true"])
    assert rec == 0
