"""Quickstart through the PyTorch port: the paper's algorithm and the LM
framework (the twin of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

import torch

from repro_torch.config import RunConfig, get_config
from repro_torch.core import generators, pack_tasks
from repro_torch.core.triad_table import TRIAD_NAMES
from repro_torch.data import SyntheticTokens
from repro_torch.engine import (CensusConfig, EngineConfig, compile,
                                compile_census, plan_cache_stats)
from repro_torch.models.convert import from_jax_params
from repro_torch.models.transformer import init_model
from repro_torch.train import adamw_init, make_train_step


def census_demo(dev, scale=10):
    print("== Triad census on an R-MAT power-law digraph ==")
    g = generators.rmat(scale, edge_factor=8, seed=0, device=dev)
    print(f"graph: n={g.n} arcs={g.m} max_deg={g.max_deg} dyads={g.n_dyads}")
    plan = compile_census(g, CensusConfig(backend="auto", device=dev))
    res = plan.run(g)
    # a same-shape graph reuses the compiled plan (the serving hot path)
    g2 = generators.rmat(scale, edge_factor=8, seed=1, device=dev)
    res2 = compile_census(g2, CensusConfig(backend="auto",
                                           device=dev)).run(g2)
    cache = plan_cache_stats()
    print(f"second same-shape census: total={res2.total:,}; plan cache: "
          f"{ {k: cache[k] for k in ('hits', 'misses', 'size')} }")
    for name, c in zip(TRIAD_NAMES, res.counts):
        if c:
            print(f"  {name:5s} {c:>14,}")
    print(f"  total {res.total:,} == C(n,3) ✓")
    # the fused multi-analytic pass: more results, same traversal
    multi = compile(g, ["triad_census", "dyad_census", "triadic_profile"],
                    EngineConfig(backend="auto", device=dev)).run(g)
    print(f"fused pass: {multi['dyad_census']}, transitivity="
          f"{multi['triadic_profile'].transitivity:.4f}")
    tasks = pack_tasks(g, 16, strategy="sorted_snake")
    print(f"16-shard balance (sorted_snake): imbalance={tasks.imbalance:.4f}")
    return res


def lm_demo(dev, steps=10):
    print(f"\n== {steps}-step LM training (qwen3-family smoke config) ==")
    cfg = get_config("qwen3-4b", smoke=True)
    run = RunConfig(attention_chunk=16)
    model = from_jax_params(cfg, init_model(
        cfg, torch.Generator(device=dev).manual_seed(0)), run=run,
        device=dev, trainable=True)
    opt = adamw_init(dict(model.named_parameters()))
    step = make_train_step(cfg, run, warmup=5)
    ds = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8)
    losses = []
    for i in range(steps):
        model, opt, mets = step(model, opt, {"tokens": torch.from_numpy(
            ds.batch_at(i)).to(dev)})
        losses.append(float(mets["loss"]))
        print(f"  step {i}: loss={losses[-1]:.3f}")
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=int, default=10,
                    help="R-MAT scale of the census demo's graphs")
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    census_demo(dev, args.scale)
    lm_demo(dev, args.steps)


if __name__ == "__main__":
    main()
