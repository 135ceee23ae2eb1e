"""The ``examples/*_torch.py`` twins run end to end on the CPU at a small
size (``main([..., "--device", "cpu"])``), and what they print and return
is exact: every census against ``brute_force_census`` of its graph, the
greedy tokens of ``serve_decode_torch`` against a replay through
``make_serve_step``."""
import importlib.util
import os

import numpy as np
import pytest
import torch

from repro_torch.core import brute_force_census

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _exact(g, counts):
    np.testing.assert_array_equal(np.asarray(counts),
                                  brute_force_census(g).counts)
    n = g.n
    assert int(np.asarray(counts).sum()) == n * (n - 1) * (n - 2) // 6


@pytest.mark.parametrize("backend", ["xla", "pallas", "tiles"])
def test_multi_analytic(backend, capsys):
    out = _example("multi_analytic_torch").main(
        ["--scale", "6", "--backend", backend, "--device", "cpu"])
    _exact(out["graph"], out["results"]["triad_census"].counts)
    text = capsys.readouterr().out
    assert "fused 4-op pass" in text and "transitivity=" in text


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_census_service_fleet(backend, capsys):
    out = _example("census_service_fleet_torch").main(
        ["--fleet", "7", "--max-batch", "3", "--backend", backend,
         "--device", "cpu"])
    done = out["completions"]
    assert sorted(done) == list(range(7))
    for rid, c in done.items():
        res = c.result["triad_census"] if isinstance(c.result, dict) \
            else c.result
        _exact(out["fleet"][rid], res.counts)
    assert "requests in" in capsys.readouterr().out


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_evolving_graph(backend, capsys):
    out = _example("evolving_graph_torch").main(
        ["--scale", "6", "--mutations", "3", "--backend", backend,
         "--device", "cpu"])
    _exact(out["graph"], out["census"].counts)
    assert "poll == exact census" in capsys.readouterr().out


def test_triad_census_sna(capsys):
    out = _example("triad_census_sna_torch").main(
        ["--dataset", "slashdot", "--scale-down", "2048", "--device", "cpu"])
    _exact(out["graph"], out["census"].counts)
    text = capsys.readouterr().out
    assert "ranks=1" in text and "closed/connected ratio" in text


@pytest.mark.parametrize("arch", ["qwen3-4b", "rwkv6-3b"])
def test_serve_decode(arch, capsys):
    from repro_torch.models.transformer import init_cache
    from repro_torch.serve import make_prefill_cache_step, make_serve_step

    out = _example("serve_decode_torch").main(
        ["--arch", arch, "--batch", "2", "--prompt-len", "8", "--new", "5",
         "--device", "cpu"])
    cfg, run, model = out["cfg"], out["run"], out["model"]
    cache = init_cache(cfg, 2, 13, device="cpu")
    logits, cache = make_prefill_cache_step(cfg, run)(model, out["prompts"],
                                                      cache)
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    want = [tok]
    step = make_serve_step(cfg, run)
    for i in range(4):
        tok, cache, _ = step(model, cache, tok, 8 + i)
        want.append(tok)
    assert torch.equal(out["tokens"], torch.cat(want, 1))
    assert "request 0:" in capsys.readouterr().out
