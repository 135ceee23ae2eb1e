"""BENCHMARK.json against the contract's shape, and every configuration,
traffic mix and metric found by name."""
import importlib
import json
import re

import pytest

from perfbench import answers, harness, loops, ops
from perfbench.tests.helpers import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_entry_keys():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("perfbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_finds_its_files_by_name(cell):
    w, = [w for w in BENCH["workloads"] if w["name"] == cell]
    cfg = harness.load_config(BENCH, w["config"])
    assert {"graph", "source", "assumed", "reduced", "published"} <= set(cfg)
    traffic = harness.load_traffic(w["traffic"])
    assert (ROOT / "perfbench" / "loops" / f"{traffic['loop']}.py").is_file()
    assert callable(harness.loop(traffic["loop"]))
    for m in traffic.get("mix", [{"ops": traffic.get("ops",
                                                     ["triad_census"])}]):
        for name in m["ops"]:  # every op the traffic asks has a check
            mod = answers.op(name)
            assert NAME.match(mod.NUMBER) and mod.LIMIT == 0
    e2e = harness.cell_metrics(BENCH["end_to_end"], cell)
    layer = harness.cell_metrics(BENCH["per_layer"], cell)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert layer
    moved = {m["name"] for m in e2e}
    for m in layer:  # a per-layer metric moves a metric its cell reports
        assert m["moves"] in moved
    for m in e2e + layer:
        assert callable(harness.reader(m["name"]))


def test_every_metric_family_has_a_reader_file():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        family = m["name"].split(".")[0]
        assert (ROOT / "perfbench" / "metrics" / f"{family}.py").is_file()
        importlib.import_module(f"perfbench.metrics.{family}")


def test_a_new_traffic_file_is_found_by_name(tmp_path, monkeypatch):
    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "burst.json").write_text(
        json.dumps({"loop": "census", "pool": 2}))
    monkeypatch.setattr(harness, "HERE", tmp_path)
    assert harness.load_traffic("burst") == {"loop": "census", "pool": 2}


def test_a_new_loop_file_is_found_by_name(tmp_path, monkeypatch):
    (tmp_path / "burst.py").write_text("def run(*a, **k):\n    return 7\n")
    monkeypatch.setattr(loops, "__path__", [*loops.__path__, str(tmp_path)])
    assert harness.loop("burst")() == 7


def test_a_new_op_file_is_found_by_name(tmp_path, monkeypatch):
    (tmp_path / "edge_count.py").write_text(
        "NUMBER, LIMIT = 'edges_off', 0\n"
        "def program_values(r):\n    return [r]\n"
        "def reference_values(n, src, dst, acc=None):\n"
        "    return [int(src.numel())]\n")
    monkeypatch.setattr(ops, "__path__", [*ops.__path__, str(tmp_path)])
    import torch

    arcs = [(torch.tensor([0, 1]), torch.tensor([1, 2]))]
    got = answers.check([{"graph": 0, "result": {"edge_count": 3}}], 3,
                        arcs, device="cpu")
    assert got["edges_off"] == {"value": 1, "limit": 0}


def test_metric_lists_of_cells():
    ms = [{"name": "a"}, {"name": "b", "workloads": ["x.y"]}]
    assert [m["name"] for m in harness.cell_metrics(ms, "x.y")] == ["a", "b"]
    assert [m["name"] for m in harness.cell_metrics(ms, "z.w")] == ["a"]
