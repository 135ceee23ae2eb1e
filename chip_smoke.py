#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

Run from the repository root:  python3 chip_smoke.py

It imports only the port (``src/repro_torch``), never ``jax`` or
``repro``.  Every phase prints one JSON line; any mismatch raises, so the
script exits non-zero and prints no result.  Phases:

1. build   — compile ``census_csr.cu``, ``census_tiles.cu`` and
             ``flash_attention.cu`` with nvcc (sm_90a) from the checkout,
             all at once, and load them; print the card and each ptxas
             report.
2. kernel  — on the Slashdot-sized R-MAT stand-in (the paper's Table 4.1
             network at its published size), every chunk of the main
             path's schedule through the six-tile kernel (the Pallas
             kernel's interface, off the main path) against its plain
             torch version on the same tiles, bit-equal, each timed with
             CUDA events beside its memory bound; then the large-n tile
             case whose exact bin 012 is 134217760.
   csr_kernel — the same chunks through the CSR kernel (the main path's
             kernel) against ``census_csr_ref``, bit-equal, timed, with
             each chunk's bytes and compares bound; the large-n case as a
             graph through the CSR kernel; a hub of degree 70,000, whose
             range counts take the wide layout, through both mappings.
3. small   — ``compile(...).run(g)`` on R-MAT graphs of 64-256 vertices,
             both backends and several bucket sets, against the port's
             brute-force census.
4. full    — the census main path, ``compile(g, ("triad_census",),
             EngineConfig(backend="tiles")).run_raw(g)``, cold then warm,
             bit-identical to ``backend="search"`` on the card, one
             device->host copy per run, one CSR-kernel launch per chunk
             and no six-tile launch; then one more warm run under
             torch.profiler: device time by kernel, the device's idle
             share, and no tile gather.
   amazon  — the main path on the Amazon stand-in at its published size
             (3,015,102 dyads, max degree 20,206): cold and warm census
             time, peak memory, bins equal to ``"search"`` and summing to
             C(n, 3), and the CSR kernel against its plain version on the
             first and last chunk of each bucket.
   fused   — on Slashdot, the four built-in ops in one tiles pass, cold
             and warm beside the census-only plan: the census bins equal
             the census-only plan's, triadic_profile agrees with them, the
             dyad census equals a count from the arc list, degree_stats
             its numpy reference, the raw vector ``"search"``; 63 CSR
             launches and one copy per run; a plan of dyad_census and
             degree_stats launches no census kernel and builds no flags;
             a profiled warm run's device time by group (census_csr,
             member probes, once, fold and the rest).
   fleet   — ``CensusService(ServiceConfig(max_batch=8,
             max_wait_requests=16))`` over 64 R-MAT scale-14 requests of
             one bucket (every 4th with degree_stats) and over a mixed
             fleet (32 of them, 16 Erdos-Renyi, 4 eatSR at full size,
             through ``run_fleet``): every completion equal to a warm
             single run, one in eight to ``"search"``, every census C(n,
             3); one copy per batch, one CSR launch per chunk; requests/s
             beside one warm ``plan.run`` per request; a profiled drive;
             a batch with a poisoned member completes its 7 peers.
   session — on Slashdot, ``plan.apply_delta`` (threshold 1.0) for k =
             4, 64 and 1024 arcs removed and added: mode "delta", raw
             bins equal to the full recompute on the card, one copy per
             application; warm delta time against full time, the host's
             rebuild and the device passes timed apart; then a subscribed
             session streaming 8 mutations of k = 4 and one of k = 1024
             at the default threshold, each poll equal to a full
             recompute, the delta/full split matching the fractions.
   faults_clean — after every normal phase (small, full, amazon, fused,
             fleet, session, dynamic, reorder, partition, each patents
             run): each cached plan has all
             six fault counters at 0 and no demotion, and each service's
             engine recoveries are 0.
   dynamic — Slashdot and Amazon under ``schedule="dynamic"`` on the
             one-card pool (cost-model chunks per bucket): bins equal to
             the static plan's, one copy and one CSR launch per task a
             run (93 and 558 tasks), cold, warm in turns with static, a
             profiled warm run (launches, idle share); the four ops in
             one dynamic pass against the static fused bins.
   reorder — Slashdot under ``reorder="degree"``, ``"bfs"``, ``"rcm"``:
             the four ops' bins equal to the unreordered run; the host
             permutation and relabel timed; warm census in turns with
             the unreordered plan; the CSR kernel against its plain
             version and CUDA-event timed on every chunk of the relabeled
             stream, beside its bound; one ``apply_delta`` (k = 64) under
             rcm equal to the full recompute.
   faults  — injected ``FaultPlan``s on Slashdot, tiles: recoverable chunk
             failures (rate 0.2, one failing attempt) under static and
             dynamic, bit-equal with one copy and ``retries`` equal to
             the chunks the plan selects; the only pool device lost under
             dynamic (one ``dynamic -> static`` rung); the tiles runtime
             failure raising by default and, with ``backend_fallback``,
             demoted once to ``"search"`` with no census_csr launch after;
             a dynamic service of 16 requests over 2 buckets whose
             ``retries`` health counter equals the selected chunks.
   partition — Slashdot in 8 shards (``EngineConfig(partitions=8)``), the
             four ops: pool on one slot, pool under the dynamic schedule on
             two slots of the card, serial, serial with spill, rcm; each
             bit-equal to the unpartitioned run, one copy, census_csr
             launches equal to the shard tasks, one staging per shard and
             no device-to-device copy, cold and warm in turns with the
             unpartitioned plan, peak memory; census_csr against its plain
             version on every chunk of every shard; one ``apply_delta``
             (k = 64) on the partitioned plan against the full recompute;
             chunk faults (seed 16, rate 0.2) recovered bit-equal.
   patents — the Patents stand-in at its published size (n 4,194,304,
             16,493,605 dyads), built once with ``from_edges_mmap``:
             unpartitioned, P = 4 serial with spill, P = 4 pool; bins
             bit-equal, the census tied to the dyad census counted on the
             host (``dyad_identity``), launches equal to the tasks,
             host partition seconds, warm times, peak memory, the shard and
             staging bytes; census_csr against its plain version on the
             first and last chunk of each bucket of each shard.  The graph
             and its files go before the flash phase.
   distributed — ``EngineConfig(backend="distributed")`` over
             ``torch.distributed``, ranks spawned as processes of their
             own, every rank on the one card: W = 1 under ``nccl`` and W
             = 2 under ``gloo``.  Slashdot, four ops: bins on every rank
             equal to the tiles plan's, cold and warm in turns with it,
             one all-reduce and one copy a run, census_csr launches equal
             to the rank's tasks, census_csr against its plain version on
             the first and last chunk of each bucket of the rank's row and
             the row timed, the packing's imbalance.  The W = 1 rank
             also runs one granite MoE layer at full width (bf16, B 4 x
             2048 tokens) through ``make_expert_parallel_moe`` on a
             one-rank ``("data", "model")`` mesh: within 2e-2 of
             ``moe_apply``, 2 all-to-alls, 1 all-gather, 0 all-reduces.
             At W = 2 also:
             Slashdot in 8 shards (``"mesh"``, then ``"serial"``) equal to
             the unpartitioned bins; a k = 64 delta equal to the full
             recompute; chunk faults injected on rank 1 only, retried to
             the clean bins; Amazon's census at its published size.
             faults_clean after each normal run; a rank's failure fails
             the script.
5. flash_kernel — the flash-attention kernel against its plain version
             (``flash_attention_ref``): bf16 at the qwen3-4b prefill shape
             (B 4, T 2048, S 2080, H 32, Hkv 8, D 128) within 2e-2, f32
             within 2e-5, windowed cases, ragged T/S with offset
             positions at every supported head dim, and the edges of the
             bf16 tiling (T 129 / S 257, G 1 and 8, T 1, window 8), MLA's
             head dims (192 in bf16 and f32, 24), G 3 at D 64 and G 7 at D
             128 at their prefill shapes, h2o-danube3's window at B 1, T =
             S = 8192; the build must show no ptxas spills in any bf16
             instantiation; CUDA-event times of the kernel, the plain
             version and SDPA on the equal-work causal slice (T = S =
             2048), and the kernel's bound; the same at MLA's shape (B 4,
             T = S = 2048, H 128, D 192; two bounds: V padded to 192, V at
             its 128 columns) and the window's time beside its bound.
6. serve   — the serving main path at qwen3-4b's full width and depth
             (36 layers, d 2560, vocab 151936; bf16 weights from a seeded
             generator): prefill of B 4 x 2048 prompt tokens into the KV
             cache, then greedy decode to 32 new tokens.  A first prefill
             with a forward hook on every layer's attention core holds
             each of the 36 kernel launches against the plain version on
             that layer's own inputs; the timed run then counts 36 flash
             launches per prefill; one more prefill under torch.profiler.
7. serve_f32 — the same width at 2 layers in f32: prefill logits of the
             flash path against the dense path (<= 1e-3), and decode
             logits against the full forward at every position (<= 1e-3).
   serve_families — every other architecture at full width, bf16, one
             model on the card at a time (``FAMILIES``):
             granite-moe-3b-a800m, qwen1.5-4b, h2o-danube-3-4b,
             musicgen-large, pixtral-12b (1024 prefix embeddings),
             deepseek-coder-33b (all 62 layers), deepseek-v2-236b (1
             dense + 3 MoE layers), zamba2-1.2b (38 layers: 6 super-blocks
             of 6 Mamba2 blocks and the one shared attention block, then 2
             tail blocks) and rwkv6-3b (32 layers); a cell whose weights
             do not fit the card fails.  Each: a checked prefill holding
             every flash launch to the plain version (scaled < 2e-2), then
             a timed prefill into a fresh cache and greedy decode, one
             flash launch per attention call a prefill (zamba2 6, rwkv6 0)
             and none in decode; prefill ms, decode ms per token, peak
             memory, weight bytes; h2o-danube3 also one cacheless B 1 x
             8192 prefill (the window on the kernel); granite and
             deepseek-v2 prefill, zamba2 and rwkv6 prefill and decode
             profiled, the scans under labels.
   serve_f32_families — in f32 at full width: flash against dense
             prefill logits for granite, pixtral and deepseek-v2 (2
             layers; the dense run replays the flash run's MoE routing; at
             most 1 % of the choices, or 2, may differ) and zamba2 (8
             layers: one super-block and 2 tail blocks), decode (MLA:
             absorbed; zamba2 and rwkv6 (2 layers): the one-step
             recurrences) against the full forward (<= 1e-3 each);
             h2o-danube3's 4096-slot ring across its wrap, every decode
             step's logits equal to the cacheless forward's; one layer's
             ``ssd_chunked`` (zamba2) and ``wkv_chunked`` (rwkv6) at full
             width, B 4 x 2000 tokens (a short last chunk), against the
             step-by-step recurrence (<= 1e-4 of its largest magnitude),
             both timed.
8. train   — training on the card (f32 parameters, bf16 compute, remat
             "full", ``"flash"`` at chunk 1,024).  The flash Function at
             one full-width qwen3-4b layer (B 1, T = S = 4,096): output and
             q, k, v gradients against autograd of the plain version
             (scaled: 2e-2 in bf16, 1e-4 in f32), one forward launch and
             none in the backward, its forward + backward timed beside
             the plain version's and SDPA's; qwen3-4b at full width, 2
             layers, f32: every gradient with "flash" against "dense"
             (1e-4 of each leaf's largest magnitude); rwkv6-3b at smoke
             width: its gradients on the card against the CPU's and one
             step; then the cells of ``TRAIN`` at one row of
             ``SHAPES["train_4k"]`` (B 1 x 4,096 from ``SyntheticTokens``):
             qwen3-4b at 16 of 36 layers, zamba2-1.2b at all 38; a checked
             warm-up step (every gradient finite), 3 timed steps (step
             ms, tokens/s, peak memory; flash launches a step = the
             forward's attention calls, 16 and 6), one profiled step
             (device time by label and kernel kind, idle share).
   sharded_train — on a one-rank ``nccl`` group's ``(1, 1)`` mesh, the
             qwen3-4b train cell of ``TRAIN`` through the launcher's setup
             (``launch.train.train_setup``: the rules, every parameter
             and moment a DTensor, the attention core through
             ``local_map``) against the unsharded cell from the same
             seed (a one-rank mesh runs the same local ops): the step-0
             loss and every parameter after it within ONE_RANK_TOL;
             each forward flash call within 2e-2 scaled of the plain
             version, 16 launches in the forward and 16 a step (none in
             the backward); step ms of both, one sharded step profiled;
             both models at SHARDED_TURNS_LAYERS layers timed in turns.
   elastic — that sharded model's whole trees on the host (what a
             checkpoint holds) placed back by ``reshard_tree`` into a
             fresh sharded model: its next step's parameters within
             ONE_RANK_TOL of the uninterrupted one's.
   sharded_prefill — qwen3-4b at full width and depth, B 4 x 2,048,
             ``make_prefill_step(cfg, run, mesh, rules)`` against the
             unsharded prefill: logits within ONE_RANK_TOL of their
             largest magnitude, 36 flash launches each; cold, then warm
             in turns.
   sharded_serve — on that mesh, placed by ``serve_rules``, beside the
             same bf16 weights unsharded (``SHARDED_SERVE``):
             granite-moe-3b-a800m (32 layers), deepseek-v2-236b (4),
             zamba2-1.2b (38) and rwkv6-3b (32) at B 4 x 2,048, the
             cacheless prefill with every flash call held to the plain
             version (32 / 4 / 6 / 0 launches, as unsharded), logits
             within ONE_RANK_TOL, cold then warm in turns; then those and
             qwen3-4b: the cache-writing prefill into a cache placed by
             ``init_cache(mesh=, rules=)`` and greedy decode steps,
             the same tokens, every step's logits within ONE_RANK_TOL,
             the flash launches a prefill as unsharded and none in
             decode; prefill ms and ms per token of each, one profiled
             prefill (not rwkv6's) and decode step of each (idle share).
             The deep models decode 4 tokens, deepseek-v2 16.
   sharded_family_train — one step of zamba2-1.2b (8 of 38 layers) and
             granite-moe-3b-a800m (8 of 32) at B 1 x 4,096 through
             ``train_setup`` against the unsharded step from the same
             seed: loss and every parameter within ONE_RANK_TOL, 1 and 8
             flash launches a step (none in the backward), step ms.
   examples — each ``examples/*_torch.py`` twin's ``main`` on the card
             (``EXAMPLES``; Slashdot's at its published size, serve_decode
             at qwen3-4b's full width): censuses equal to ``"search"``
             and summing to C(n, 3), census_csr launched; greedy tokens
             equal to a replay through ``make_serve_step``, 36 flash
             launches a prefill.
   dryrun  — ``launch.census_dryrun`` for Slashdot and Patents at their
             published sizes on the ``{"data": 16, "model": 16}`` shape
             (per-rank dyads, bytes, census_csr's bound), then the
             meta-device sweep of all 80 (arch x shape x mesh shape)
             cells; each phase's seconds.
9. the kernels line (census_csr's row adds its launches in the fused,
   fleet, session, dynamic, reorder, faults, partition, distributed (per
   rank), patents and example phases; flash_attention's its launches per
   prefill for every architecture, per train step, per sharded train
   step, sharded prefill and sharded decode step of each family, the
   serving twin's, and its MLA and window timings and gradient checks),
   then the result line.

Exits non-zero without a CUDA device.
"""
import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peak memory rate
BF16_FLOP_PER_S = 989e12  # H100 SXM published dense bf16 tensor-core peak
BIN012_LARGE_N = 134217760  # exact bin 012 of the large-n tile case
HUB_DEGREE = 70_000  # past the packed range counts' 2**16 - 1
# dyads per call of census_csr_ref: its intermediates grow with the sum
# of the dyads' smaller rows, and a whole degree bucket of a Patents
# shard needed more than the card's 80 GB in one call
REF_DYADS = 8192
INT32_LANES_PER_SM = 64  # Hopper: int32 results per SM per clock
KERNELS = ("census_csr", "census_tiles", "flash_attention")
T0 = time.perf_counter()

# the serving cell: qwen3-4b at full width, B prompts of PROMPT tokens,
# NEW greedy tokens each (the KV cache holds PROMPT + NEW slots)
ARCH = "qwen3-4b"
SERVE = dict(batch=4, prompt=2048, new=32, layers=36)
# the f32 check: the same width at F32_LAYERS layers; decode is held
# against the full forward over DECODE_T tokens
F32_LAYERS = 2
DECODE_T = 64
# f32 scores per call of the plain flash version in a check (1 GiB)
PLAIN_CHUNK_ELEMS = 2**28
# the other families at full width, one cell each: arch -> batch, prompt,
# new tokens, depth and, where it is not one per layer, the flash launches
# a prefill makes (zamba2's one shared attention block runs once per
# super-block: 6 at 38 layers; rwkv6 has no attention); the prefix of a vlm
# is its config's n_prefix_embeds.  Every depth is the config's own but
# deepseek-v2's, which keeps 1 dense + 3 MoE blocks (60 layers would be
# 472 GB).  A cell whose bf16 weights do not fit the free memory fails the
# script.
FAMILIES = {
    "granite-moe-3b-a800m": dict(batch=4, prompt=2048, new=32, layers=32),
    "qwen1.5-4b": dict(batch=4, prompt=2048, new=16, layers=40),
    "h2o-danube-3-4b": dict(batch=4, prompt=2048, new=16, layers=24),
    "musicgen-large": dict(batch=4, prompt=2048, new=16, layers=48),
    "pixtral-12b": dict(batch=2, prompt=1024, new=16, layers=40),
    "deepseek-coder-33b": dict(batch=1, prompt=2048, new=8, layers=62),
    "deepseek-v2-236b": dict(batch=4, prompt=2048, new=16, layers=4),
    "zamba2-1.2b": dict(batch=4, prompt=2048, new=16, layers=38, flash=6),
    "rwkv6-3b": dict(batch=4, prompt=2048, new=16, layers=32, flash=0),
}
# arch -> the steps run once more under torch.profiler
PROFILED = {"granite-moe-3b-a800m": ("prefill",),
            "deepseek-v2-236b": ("prefill",),
            "zamba2-1.2b": ("prefill", "decode"),
            "rwkv6-3b": ("prefill", "decode")}
# the f32 families check: (arch, batch, text tokens, layers, flash launches
# a prefill makes); zamba2 at 8 layers is one super-block and 2 tail blocks
F32_FAMILIES = (("granite-moe-3b-a800m", 1, 512, 2, 2),
                ("pixtral-12b", 2, 512, 2, 2),
                ("deepseek-v2-236b", 1, 512, 2, 2),
                ("zamba2-1.2b", 1, 512, 8, 1),
                ("rwkv6-3b", 1, 512, 2, 0))
# the scans at full width against their step-by-step recurrence: (arch,
# batch, tokens); 2000 is not a whole number of chunks (128 and 32), so the
# last chunk is short
SCAN_CHECKS = (("zamba2-1.2b", 4, 2000), ("rwkv6-3b", 4, 2000))
# h2o-danube3's ring across its wrap: prefill RING_PREFILL tokens into the
# 4096-slot window ring, then RING_STEPS decode steps past slot 4096
RING_PREFILL, RING_STEPS = 4064, 96
# h2o-danube3's long cacheless prefill: (B, T, S, H, Hkv, D) and window
DANUBE_WINDOW_SHAPE = (1, 8192, 8192, 32, 8, 120)
DANUBE_WINDOW = 4096
# deepseek-v2's prefill core at full width: B, T = S, H = Hkv, qk head dim
# (nope + rope), V's useful head dim
MLA_TIMING_SHAPE = (4, 2048, 128, 192, 128)
# the training cells: one row of SHAPES["train_4k"] (B 1 x 4,096 tokens
# of SyntheticTokens), f32 parameters, bf16 compute, remat "full", "flash"
# at chunk 1,024; arch -> depth and the flash launches a step (one per
# attention call of the forward, none in the backward).  qwen3-4b is cut
# to 16 of 36 layers (2.39 B parameters, 38 GB of parameters, gradients
# and moments); zamba2 keeps its 38.  A cell that does not fit fails.
TRAIN = {"qwen3-4b": dict(layers=16, flash=16),
         "zamba2-1.2b": dict(layers=38, flash=6)}
TRAIN_STEPS = 3  # timed, after one checked warm-up step
TRAIN_CHUNK = 1024
# the sharded path on a one-rank nccl (data, model) = (1, 1) mesh: the
# qwen3-4b train cell of TRAIN through the launcher's setup; the in-turns
# timing and the elastic restore at SHARDED_TURNS_LAYERS (both models on
# the card at once); the launcher's schedule over SHARDED_TOTAL steps
SHARDED_TURNS_LAYERS = 8
SHARDED_TOTAL = 50
# the other families on that mesh against the same weights unsharded:
# arch -> batch, prompt, greedy decode steps, depth, flash launches a
# prefill makes, whether the cacheless prefill is checked too (qwen3-4b's
# is sharded_prefill's) and the steps profiled.  deepseek-v2 keeps 1
# dense + 3 MoE blocks, as in FAMILIES (two bf16 copies take 50 GB).  The
# sharded decode is host-bound on DTensor dispatch (1.2-2.0 s a token at
# 32-38 layers), so the deep models decode 4 tokens, not 16, and rwkv6's
# prefill (~72,600 launches) is not profiled: the cells keep within ~150
# s of the script.
SHARDED_SERVE = {
    "qwen3-4b": dict(batch=4, prompt=2048, new=4, layers=36, flash=36,
                     cacheless=False),
    "granite-moe-3b-a800m": dict(batch=4, prompt=2048, new=4, layers=32,
                                 flash=32),
    "deepseek-v2-236b": dict(batch=4, prompt=2048, new=16, layers=4,
                             flash=4),
    "zamba2-1.2b": dict(batch=4, prompt=2048, new=4, layers=38, flash=6),
    "rwkv6-3b": dict(batch=4, prompt=2048, new=4, layers=32, flash=0,
                     profile=("decode",)),
}
# one sharded train step against the unsharded one (B 1 x 4,096, as
# TRAIN): arch -> depth and flash launches a step.  zamba2 keeps 1
# super-block and 2 tail blocks of 38 (its step is host-bound on the SSD
# loop: ~7 s unsharded at full depth, twice that sharded), granite 8 of
# its 32 layers.
SHARDED_TRAIN = {"zamba2-1.2b": dict(layers=8, flash=1),
                 "granite-moe-3b-a800m": dict(layers=8, flash=8)}
# a one-rank mesh runs the same local ops as the unsharded model, so its
# loss, parameters and logits must equal the unsharded ones: within this,
# scaled (a loss or logits) or absolute (a parameter)
ONE_RANK_TOL = 1e-5
# the example twins on the card: name -> arguments
EXAMPLES = {
    "multi_analytic_torch": ["--backend", "pallas"],
    "census_service_fleet_torch": ["--backend", "pallas"],
    "evolving_graph_torch": ["--backend", "pallas"],
    "triad_census_sna_torch": ["--scale-down", "1"],
    "serve_decode_torch": ["--full"],
}
# the f32 gradient check: qwen3-4b at full width, 2 layers, B 1 x this
TRAIN_F32_T = 2048
# the device split of a profiled train step: kernel name substrings
KERNEL_KINDS = (("flash_forward", ("flash_kernel",)),
                ("gemm", ("gemm", "xmma", "cutlass", "nvjet")),
                ("softmax", ("softmax",)),
                ("optimizer", ("multi_tensor_apply",)))


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_s": time.perf_counter() - T0}), flush=True)


def check(cond, message):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {message}")


def event_ms(torch, fn, reps):
    """Mean device time of ``fn`` over ``reps`` calls after one warm call.

    The card first sleeps for ~2.5 ms, so the host has queued the calls
    before the start event: a kernel shorter than its launch's host cost
    is then timed back to back, not at the host's pace."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(5_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def large_n_case(torch, device):
    """32 asymmetric dyads (2i -> 2i+1) in a graph of n = 2**22 + 3
    vertices; 16 of them, picked by a seeded permutation, have one extra
    neighbour in N(u) with no arc to u or v.  Every dyad then adds n - 2
    triads to bin 012 (the extra neighbour moves one from the dyadic term
    to a connected code of type 012), so bin 012 is 32 * (n - 2)."""
    import numpy as np

    from repro_torch.kernels.triad_census import SENTINEL

    n, D, K = 2**22 + 3, 32, 4
    u = np.arange(D, dtype=np.int32) * 2
    v = u + 1
    extra = np.random.default_rng(0).permutation([True] * 16 + [False] * 16)

    def tile(rows):
        t = np.full((D, K), SENTINEL, np.int32)
        for i, r in enumerate(rows):
            t[i, :len(r)] = sorted(r)
        return torch.as_tensor(t, device=device)

    nbr_u = [[v[i]] + ([n - 1 - i] if extra[i] else []) for i in range(D)]
    tiles = [tile([[v[i]] for i in range(D)]), tile([[]] * D),
             tile([[]] * D), tile([[u[i]] for i in range(D)]),
             tile(nbr_u), tile([[u[i]] for i in range(D)])]
    return (torch.as_tensor(u, device=device),
            torch.as_tensor(v, device=device), n, tiles)


def large_n_csr_case(torch, device, extras):
    """The large-n tile case as a graph (n = 2**22 + 3, 32 asymmetric
    dyads 2i -> 2i+1).  A CSR cannot hold the tile case's extra
    neighbours without arcs, so ``extras`` makes them mutual arcs u <-> w
    instead; without them bin 012 is exactly 32 * (n - 2) = 134217760.
    Returns ``(n, arrays with flags, u, v)``."""
    import numpy as np

    from repro_torch.core import census as tcensus
    from repro_torch.core.graph import from_edges
    from repro_torch.kernels.ops import build_arc_flags_device
    from repro_torch.kernels.triad_census import SENTINEL

    n, D = 2**22 + 3, 32
    u = np.arange(D, dtype=np.int64) * 2
    src, dst = list(u), list(u + 1)
    if extras:
        pick = np.random.default_rng(0).permutation([True] * 16 + [False] * 16)
        w = n - 1 - np.arange(D)
        src += list(u[pick]) + list(w[pick])
        dst += list(w[pick]) + list(u[pick])
    g = from_edges(n, np.asarray(src), np.asarray(dst), device=device)
    a = g.arrays
    flags, counts = build_arc_flags_device(a.out_ptr, a.out_idx, a.nbr_ptr,
                                           a.nbr_idx)
    du, dv = tcensus.canonical_dyads(g)
    pad = (-len(du)) % 32
    du = np.concatenate([du, np.full(pad, SENTINEL, np.int32)])
    dv = np.concatenate([dv, np.full(pad, SENTINEL, np.int32)])
    return (n, a._replace(nbr_flag=flags, nbr_cnt=counts),
            torch.as_tensor(du, device=device),
            torch.as_tensor(dv, device=device))


def wide_hub_case(torch, device):
    """A hub (vertex 0) with HUB_DEGREE neighbours, 96 % of them out-arcs,
    so past what the packed range counts hold, plus a random digraph of
    4 n arcs among the rest: the plan builds the wide counts.  Returns
    ``(n, arrays with flags, u, v)``: 256 hub dyads and 256 others."""
    import numpy as np

    from repro_torch.core import census as tcensus
    from repro_torch.core.graph import from_edges
    from repro_torch.engine import EngineConfig, compile

    n = HUB_DEGREE + 10_000
    rng = np.random.default_rng(0)
    leaves = rng.choice(np.arange(1, n), size=HUB_DEGREE, replace=False)
    kind = rng.choice(3, size=HUB_DEGREE, p=(0.96, 0.02, 0.02))
    src = np.concatenate([np.zeros(int((kind != 1).sum()), np.int64),
                          leaves[kind != 0], rng.integers(1, n, 4 * n)])
    dst = np.concatenate([leaves[kind != 1],
                          np.zeros(int((kind != 0).sum()), np.int64),
                          rng.integers(1, n, 4 * n)])
    g = from_edges(n, src, dst, device=device)
    a = compile(g, ("triad_census",), EngineConfig(
        backend="tiles", device=device)).padded_arrays(g, with_flags=True)
    check(a.nbr_cnt.dim() == 2, "wide hub case: counts are not wide")
    u, v = tcensus.canonical_dyads(g)
    pick = np.concatenate([np.flatnonzero(u == 0)[:256],
                           np.flatnonzero(u != 0)[:256]])
    return (n, a, torch.as_tensor(u[pick], device=device),
            torch.as_tensor(v[pick], device=device))


def csr_chunk_work(torch, arrays, u, v, block):
    """What one CSR-kernel launch must do for these dyads: (bytes,
    compares, candidate lanes, sum of min degrees).  Bytes: every distinct
    row the dyads touch read once (4-byte index and 1-byte flag an entry,
    two 4-byte ptr entries), two 4-byte range counts at each end of each
    dyad, u and v, and the partial rows written.  Compares: each element
    of the smaller row searched in the larger, min(deg u, deg v) *
    ceil(log2(max(deg u, deg v) + 1)) over the valid dyads."""
    from repro_torch.kernels.triad_census import SENTINEL

    valid = u != SENTINEL
    uv = torch.cat([u[valid], v[valid]]).long()
    deg = (arrays.nbr_ptr[1:] - arrays.nbr_ptr[:-1]).long()
    rows = torch.unique(uv)
    du, dv = deg[u[valid].long()], deg[v[valid].long()]
    small, large = torch.minimum(du, dv), torch.maximum(du, dv)
    compares = int((small.double()
                    * torch.ceil(torch.log2(large.double() + 1))).sum())
    nbytes = (int((5 * deg[rows] + 8).sum()) + 16 * int(valid.sum())
              + 8 * u.shape[0] + 64 * (u.shape[0] // block))
    return (nbytes, compares, int((du + dv).sum()), int(small.sum()))


def plain_partials(torch, u, v, n, arrays, block):
    """census_csr_ref's (D / block, 16) partials of the dyads ``(u, v)``,
    computed ``REF_DYADS`` dyads (whole blocks) a call."""
    from repro_torch.kernels.ref import census_csr_ref

    step = max(block, REF_DYADS // block * block)
    return torch.cat([census_csr_ref(u[i: i + step], v[i: i + step], n,
                                     arrays, block=block)
                      for i in range(0, u.shape[0], step)])


def csr_kernel_phase(torch, g, st, tasks, rates, label):
    """The CSR kernel against its plain version on ``tasks`` of the tiles
    stream ``st``, bit-equal; per bucket its CUDA-event time, the plain
    version's, and the bound from each chunk's own bytes and compares."""
    from repro_torch.engine.backends import chunk_dyads, task_lanes
    from repro_torch.kernels.triad_census import census_csr

    per_bucket: dict = {}
    for task in tasks:
        width = task_lanes(task, st.chunk, st.block)
        u, v, _ = chunk_dyads(st.su, st.sv, task, width)
        got = census_csr(u, v, g.n, st.arrays, k=task.key, block=st.block)
        want = plain_partials(torch, u, v, g.n, st.arrays, st.block)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        check(err == 0, f"{label}: census_csr != plain at K={task.key}, "
                        f"dyad {task.start}: max abs err {err}")
        k_ms = event_ms(torch, lambda: census_csr(
            u, v, g.n, st.arrays, k=task.key, block=st.block), reps=3)
        p_ms = event_ms(torch, lambda: plain_partials(
            torch, u, v, g.n, st.arrays, st.block), reps=1)
        nbytes, compares, lanes, min_sum = csr_chunk_work(
            torch, st.arrays, u, v, st.block)
        byte_ms = nbytes / rates["bytes"] * 1e3
        op_ms = compares / rates["int32"] * 1e3
        b = per_bucket.setdefault(task.key, dict(
            K=task.key, chunks=0, dyads=0, kernel_ms=0.0, plain_ms=0.0,
            bytes=0, compares=0, candidate_lanes=0, min_degree_sum=0,
            byte_ms=0.0, op_ms=0.0, bound_ms=0.0, max_abs_err=0))
        b["max_abs_err"] = max(b["max_abs_err"], err)
        b["chunks"] += 1
        b["dyads"] += min(task.end, task.start + width) - task.start
        b["kernel_ms"] += k_ms
        b["plain_ms"] += p_ms
        b["bytes"] += nbytes
        b["compares"] += compares
        b["candidate_lanes"] += lanes
        b["min_degree_sum"] += min_sum
        b["byte_ms"] += byte_ms
        b["op_ms"] += op_ms
        b["bound_ms"] += max(byte_ms, op_ms)
        del u, v, got, want
    for b in per_bucket.values():
        emit("csr_kernel_bucket", graph=label, **b)
    return per_bucket


def flash_inputs(torch, dev, dtype, B, T, S, H, Hkv, D, *, q0=0,
                 filled=None, seed=0):
    """Random q, k, v and positions: queries at q0..q0+T-1 (q0 an int, or
    one offset per batch row), keys at 0..S-1 except that slots from
    ``filled`` on are empty (SENTINEL)."""
    from repro_torch.models.attention import SENTINEL

    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    offsets = torch.as_tensor(q0, dtype=torch.int32, device=dev).reshape(-1, 1)
    q_pos = (torch.arange(T, dtype=torch.int32, device=dev)
             + offsets).expand(B, T).contiguous()
    kv_pos = torch.arange(S, dtype=torch.int32, device=dev)
    if filled is not None:
        kv_pos[filled:] = SENTINEL
    return (normal(B, T, H, D), normal(B, S, Hkv, D), normal(B, S, Hkv, D),
            q_pos, kv_pos.repeat(B, 1))


def visible_pairs(torch, q_pos, kv_pos, window):
    """(query, key) pairs this run's positions make visible, per head."""
    mask = kv_pos[:, None, :] <= q_pos[:, :, None]
    if window is not None:
        mask &= kv_pos[:, None, :] > q_pos[:, :, None] - window
    return int(mask.sum())


def plain_error(torch, got, q, k, v, q_pos, kv_pos, window):
    """``kernel_err`` of a kernel output against the plain version on the
    same input values, its output left in f32.

    A bf16 kernel output is held against this rather than against the
    plain version's own bf16 output: the latter rounds once more, so two
    results a hair apart can land one bf16 step apart (0.03125 for
    outputs in [4, 8)) without either being wrong.  The plain version runs
    once per batch row and slice of kv heads (with their query heads),
    each slice's f32 scores under ``PLAIN_CHUNK_ELEMS``: at the serving
    shapes one call over everything would hold tens of GB of scores."""
    from repro_torch.kernels.ref import flash_attention_ref

    B, T, H, _ = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    step = max(1, PLAIN_CHUNK_ELEMS // (G * T * S))
    err = scaled = 0.0
    for b in range(B):
        for h0 in range(0, Hkv, step):
            h1 = min(Hkv, h0 + step)
            qs = slice(h0 * G, h1 * G)
            want = flash_attention_ref(
                q[b:b + 1, :, qs].float(), k[b:b + 1, :, h0:h1].float(),
                v[b:b + 1, :, h0:h1].float(), q_pos[b:b + 1],
                kv_pos[b:b + 1], window=window)
            e, s = kernel_err(got[b:b + 1, :, qs], want)
            err, scaled = max(err, e), max(scaled, s)
            del want
    return err, scaled


def ptxas_spills(log):
    """{kernel: (spill store bytes, spill load bytes)} from ``-Xptxas -v``."""
    spills, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn is not None:
            spills[fn] = (int(m.group(1)), int(m.group(2)))
    return spills


def kernel_err(got, want):
    """(max abs error, max error scaled by max(1, |want|)).

    The checks hold the scaled error to the tolerance: for outputs of
    magnitude up to 1 that is the absolute error; above, it grows with
    the output as a bf16 step does (outputs of 4-8, which the serving
    path produces, are stored in steps of 0.03125)."""
    diff = (got.float() - want.float()).abs()
    scaled = diff / want.float().abs().clamp(min=1.0)
    return float(diff.max()), float(scaled.max())


def block_err(got, want, rows=128):
    """Largest normwise error of a block of ``rows`` consecutive positions
    (dim 1: queries for q and the output, keys for k and v) over that
    block's own norm.  A fault confined to one tile of rows shows at its
    own size there, however small those rows are beside the tensor's
    largest values (late causal rows average thousands of keys)."""
    diff = got.float() - want.float()
    return max(float(d.norm() / w.float().norm().clamp(min=1e-30))
               for d, w in zip(diff.split(rows, 1), want.split(rows, 1)))


def flash_kernel_phase(torch, dev):
    """The flash kernel against its plain version, its times and bound."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref

    bf16, f32 = torch.bfloat16, torch.float32
    B, P, N = SERVE["batch"], SERVE["prompt"], SERVE["new"]
    cases = [  # name, dtype, (B, T, S, H, Hkv, D), options, tolerance
        ("prefill_bf16", bf16, (B, P, P + N, 32, 8, 128), dict(filled=P),
         None, 2e-2),
        ("square_f32", f32, (2, 512, 512, 8, 2, 128), {}, None, 2e-5),
        ("window_f32_d120", f32, (2, 300, 300, 8, 2, 120), {}, 100, 2e-5),
        ("window_bf16_d120", bf16, (2, 300, 300, 8, 2, 120), {}, 100, 2e-2),
        # the edges of the bf16 tiling: one row past a 128-row q tile and
        # one key past two 128-key kv tiles, another offset per batch row,
        # G = 1 and G = 8, a single query, a window inside one kv tile
        ("edge_tiles_bf16", bf16, (2, 129, 257, 4, 2, 128),
         dict(q0=(128, 61)), None, 2e-2),
        ("gqa_g1_bf16", bf16, (2, 200, 200, 8, 8, 128), {}, None, 2e-2),
        ("gqa_g8_bf16", bf16, (2, 200, 200, 8, 1, 128), {}, None, 2e-2),
        ("single_query_bf16", bf16, (2, 1, 77, 4, 2, 128),
         dict(q0=(60, 200)), None, 2e-2),
        ("window_8_bf16", bf16, (2, 300, 300, 4, 2, 128), {}, 8, 2e-2),
        # MLA's core (G 1 at qk head dim 192, 64-key kv tiles on the bf16
        # route; 24 at smoke size), granite's G 3 at D 64 and
        # deepseek-coder's G 7 at D 128 at their prefill shapes, and
        # h2o-danube3's window at its long prefill
        ("mla_g1_d192_bf16", bf16, (2, 300, 300, 8, 8, 192), {}, None,
         2e-2),
        ("mla_g1_d192_f32", f32, (2, 300, 300, 8, 8, 192), {}, None, 2e-5),
        ("mla_g1_d24_bf16", bf16, (2, 300, 300, 4, 4, 24), {}, None, 2e-2),
        ("granite_g3_d64_bf16", bf16, (B, P, P + N, 24, 8, 64),
         dict(filled=P), None, 2e-2),
        ("coder_g7_d128_bf16", bf16, (1, P, P + 8, 56, 8, 128),
         dict(filled=P), None, 2e-2),
        ("danube_window_bf16", bf16, DANUBE_WINDOW_SHAPE, {}, DANUBE_WINDOW,
         2e-2),
    ]
    for D in (16, 24, 32, 64, 120, 128, 192):  # ragged T, S; offset queries
        for dtype, tol in ((f32, 2e-5), (bf16, 2e-2)):
            cases.append((f"ragged_offset_d{D}_{str(dtype)[6:]}", dtype,
                          (2, 100, 173, 4, 2, D), dict(q0=73), None, tol))
    max_err = 0.0
    for name, dtype, shape, opts, window, tol in cases:
        args = flash_inputs(torch, dev, dtype, *shape, **opts)
        got = flash_attention(*args, window=window)
        torch.cuda.synchronize()
        err, scaled = plain_error(torch, got, *args, window)
        check(scaled < tol, f"flash kernel {name}: scaled error {scaled} "
                            f">= {tol} (max abs {err})")
        if dtype == bf16:
            max_err = max(max_err, err)
        emit("flash_case", case=name, shape=list(shape), window=window,
             max_abs_err=err, max_scaled_err=scaled, tolerance=tol)
        del got, args

    # times and bound at the prefill shape
    q, k, v, q_pos, kv_pos = args = flash_inputs(
        torch, dev, bf16, B, P, P + N, 32, 8, 128, filled=P)
    ms = event_ms(torch, lambda: flash_attention(*args), reps=20)
    plain_ms = event_ms(torch, lambda: flash_attention_ref(*args), reps=3)
    # SDPA on the equal-work causal slice (the filled P x P part)
    qs = q.transpose(1, 2).contiguous()
    ks = k[:, :P].transpose(1, 2).contiguous()
    vs = v[:, :P].transpose(1, 2).contiguous()
    library_ms = event_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True, enable_gqa=True), reps=20)
    H, D = q.shape[2], q.shape[3]
    pairs = visible_pairs(torch, q_pos, kv_pos, None)
    flops = 4 * D * H * pairs  # QK^T and PV, 2 D each per visible pair
    nbytes = sum(t.numel() * t.element_size() for t in args) + \
        q.numel() * q.element_size()  # inputs read once, o written once
    flop_ms = flops / BF16_FLOP_PER_S * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(flop_ms, byte_ms)
    out = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=bound_ms,
               bound_by="operations" if flop_ms >= byte_ms else "bytes",
               max_abs_err=max_err)
    emit("flash_kernel", shape=dict(B=B, T=P, S=k.shape[1], H=H,
                                    Hkv=k.shape[2], D=D),
         visible_pairs=pairs, flops=flops, bytes=nbytes, flop_ms=flop_ms,
         byte_ms=byte_ms, tflop_per_s=flops / ms / 1e9,
         kernel_over_bound=ms / bound_ms, library_over_kernel=library_ms / ms,
         **out)
    del q, k, v, q_pos, kv_pos, args, qs, ks, vs
    out.update(mla=flash_mla_timing(torch, dev),
               window=flash_window_timing(torch, dev))
    torch.cuda.empty_cache()
    return out


def flash_mla_timing(torch, dev):
    """The kernel at MLA's prefill shape (B 4, T = S = 2048, H = Hkv =
    128, qk head dim 192, causal; V padded to 192 as the model pads it),
    the plain version and SDPA on the same inputs, and two bounds: the
    padded work the kernel computes (QK^T and PV at 192 columns), and the
    work with V counted at its 128 useful columns."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref

    B, T, H, D, V = MLA_TIMING_SHAPE
    q, k, v, q_pos, kv_pos = args = flash_inputs(
        torch, dev, torch.bfloat16, B, T, T, H, H, D, seed=5)
    v[..., V:] = 0  # the model's zero padding
    got = flash_attention(*args)
    torch.cuda.synchronize()
    err, scaled = plain_error(torch, got, *args, None)
    check(scaled < 2e-2, f"flash kernel at the MLA shape: scaled error "
                         f"{scaled} (max abs {err})")
    del got
    ms = event_ms(torch, lambda: flash_attention(*args), reps=20)
    plain_ms = event_ms(torch, lambda: flash_attention_ref(*args), reps=1)
    qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    library_ms = event_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True), reps=20)
    pairs = visible_pairs(torch, q_pos, kv_pos, None)
    flops = 4 * D * H * pairs
    flops_v128 = 2 * (D + V) * H * pairs
    nbytes = sum(t.numel() * t.element_size() for t in args) + \
        q.numel() * q.element_size()
    flop_ms = flops / BF16_FLOP_PER_S * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    out = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=max(flop_ms, byte_ms),
               bound_by="operations" if flop_ms >= byte_ms else "bytes",
               bound_ms_v128=max(flops_v128 / BF16_FLOP_PER_S * 1e3,
                                 byte_ms),
               max_abs_err=err)
    emit("flash_kernel_mla", shape=dict(B=B, T=T, S=T, H=H, Hkv=H, D=D),
         visible_pairs=pairs, flops=flops, flops_v128=flops_v128,
         bytes=nbytes, tflop_per_s=flops / ms / 1e9,
         kernel_over_bound=ms / out["bound_ms"],
         kernel_over_bound_v128=ms / out["bound_ms_v128"],
         library_over_kernel=library_ms / ms, max_scaled_err=scaled, **out)
    return out


def flash_window_timing(torch, dev):
    """The kernel at h2o-danube3's long prefill (B 1, T = S = 8192, H 32,
    Hkv 8, D 120, window 4096) beside its bound."""
    from repro_torch.kernels.flash_attention import flash_attention

    args = flash_inputs(torch, dev, torch.bfloat16, *DANUBE_WINDOW_SHAPE,
                        seed=6)
    ms = event_ms(torch, lambda: flash_attention(
        *args, window=DANUBE_WINDOW), reps=20)
    q, _, _, q_pos, kv_pos = args
    pairs = visible_pairs(torch, q_pos, kv_pos, DANUBE_WINDOW)
    flop_ms = 4 * q.shape[3] * q.shape[2] * pairs / BF16_FLOP_PER_S * 1e3
    out = dict(ms=ms, bound_ms=flop_ms, bound_by="operations",
               visible_pairs=pairs)
    emit("flash_kernel_window", shape=list(DANUBE_WINDOW_SHAPE),
         window=DANUBE_WINDOW, kernel_over_bound=ms / flop_ms, **out)
    return out


def device_split(torch, fn):
    """Run ``fn`` once under torch.profiler and read its exported trace
    (``build/profile_trace.json``, removed after; ``key_averages()``
    spends minutes on a train step's ~10^5 launches): wall time, device
    busy time (kernels, copies and fills), the device's idle share,
    launches, device ms by kernel kind (``KERNEL_KINDS``, else "other"),
    the kernels that take the most time and the host ops with the most
    host time of their own; for each ``record_function`` label
    ``group:<name>`` opened inside ``fn``, the device time of the work
    launched under it (on its thread, inside its span; nested labels each
    count it), its host time and its calls."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    path = os.path.join(ROOT, "build", "profile_trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if "dur" in e]
    finally:
        os.remove(path)
    launch_of, host, work = {}, {}, []
    for e in events:
        cat = e.get("cat")
        if cat == "cuda_runtime" and "correlation" in e.get("args", {}):
            launch_of[e["args"]["correlation"]] = (e["tid"], e["ts"])
        elif cat in ("cpu_op", "user_annotation"):
            host.setdefault(e["tid"], []).append(e)
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            work.append(e)
    # host ops: time of their own (their span less their children's)
    own = {}
    groups, points = {}, []  # label opens (0) and closes (2), launches (1)
    for tid, evs in host.items():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []
        for e in evs:
            while stack and stack[-1][0] <= e["ts"]:
                stack.pop()
            if stack:
                own[stack[-1][1]][0] -= e["dur"] / 1e3
            total = own.setdefault(e["name"], [0.0, 0])
            total[0] += e["dur"] / 1e3
            total[1] += 1
            stack.append((e["ts"] + e["dur"], e["name"]))
            if e["name"].startswith("group:"):
                g = groups.setdefault(e["name"][6:], dict(
                    device_ms=0.0, host_ms=0.0, calls=0))
                g["host_ms"] += e["dur"] / 1e3
                g["calls"] += 1
                points += [(e["ts"], 0, tid, e["name"][6:]),
                           (e["ts"] + e["dur"], 2, tid, e["name"][6:])]
    busy, by_name, kinds = 0.0, {}, {}
    for e in work:
        ms, key = e["dur"] / 1e3, e["name"]
        busy += ms
        total, count = by_name.get(key, (0.0, 0))
        by_name[key] = (total + ms, count + 1)
        kind = next((k for k, subs in KERNEL_KINDS
                     if any(x in key.lower() for x in subs)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + ms
        tid, ts = launch_of.get(e.get("args", {}).get("correlation"),
                                (None, None))
        if tid in host:
            points.append((ts, 1, tid, ms))
    open_labels = {}  # tid -> {label: depth}
    for _, kind, tid, x in sorted(points, key=lambda p: p[:2]):
        active = open_labels.setdefault(tid, {})
        if kind == 0:
            active[x] = active.get(x, 0) + 1
        elif kind == 2:
            active[x] -= 1
            if not active[x]:
                del active[x]
        else:
            for name in active:
                groups[name]["device_ms"] += x
    top = sorted(((ms, c, k) for k, (ms, c) in by_name.items()),
                 reverse=True)[:15]
    host_top = sorted(((ms, c, k) for k, (ms, c) in own.items()),
                      reverse=True)[:10]
    return dict(wall_ms=wall_ms, device_busy_ms=busy, kernel_kinds=kinds,
                device_idle_share=1 - busy / wall_ms,
                kernel_launches=len(work), groups=groups,
                top=[dict(ms=ms, count=c, kernel=k[:100])
                     for ms, c, k in top],
                host_top=[dict(ms=ms, count=c, op=k[:60])
                          for ms, c, k in host_top])


@contextlib.contextmanager
def labelled_scans():
    """Run the recurrent families' scans under ``record_function`` labels
    (``group:ssd_chunked``, ``group:ssd_step``, ``group:wkv_chunked``,
    ``group:wkv_recurrent``) for :func:`device_split`, and undo.  The
    blocks look the scans up as globals of their modules on every call."""
    from torch.profiler import record_function

    from repro_torch.models import rwkv, ssm

    def label(name, fn):
        def wrapped(*args, **kwargs):
            with record_function(f"group:{name}"):
                return fn(*args, **kwargs)
        return wrapped

    names = ((ssm, "ssd_chunked"), (ssm, "ssd_step"), (rwkv, "wkv_chunked"),
             (rwkv, "wkv_recurrent"))
    saved = [getattr(mod, name) for mod, name in names]
    for (mod, name), fn in zip(names, saved):
        setattr(mod, name, label(name, fn))
    try:
        yield
    finally:
        for (mod, name), fn in zip(names, saved):
            setattr(mod, name, fn)


@contextlib.contextmanager
def labelled_training():
    """:func:`labelled_scans`, and ``record_function`` labels around the
    flash kernel's forward launch (``group:flash_forward``), the flash
    Function's recomputed backward (``group:attention_backward``: the
    chunked twin's forward and its autograd) and the optimizer update
    (``group:optimizer``), for :func:`device_split`; undone after.  The
    port looks each up at call time (the operator calls the module's
    ``_forward``, autograd the class's ``backward``, the step the train
    module's ``adamw_update``)."""
    from torch.profiler import record_function

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.train import train_step as ts

    def label(name, fn):
        def wrapped(*args, **kwargs):
            with record_function(f"group:{name}"):
                return fn(*args, **kwargs)
        return wrapped

    forward, backward = fa._forward, fa.FlashAttentionFunction.backward
    update = ts.adamw_update
    fa._forward = label("flash_forward", forward)
    fa.FlashAttentionFunction.backward = staticmethod(
        label("attention_backward", backward))
    ts.adamw_update = label("optimizer", update)
    try:
        with labelled_scans():
            yield
    finally:
        fa._forward = forward
        fa.FlashAttentionFunction.backward = staticmethod(backward)
        ts.adamw_update = update


def serve_phase(torch, dev):
    """The serving main path at qwen3-4b's full width: checked, timed,
    profiled (prefill and one decode step)."""
    rec = serve_family(torch, dev, ARCH, SERVE, phase="serve", profile=("prefill", "decode"))
    return dict(launches=rec["flash_launches_per_prefill"],
                max_abs_err=rec["max_abs_err"])


def serve_f32_phase(torch, dev):
    """Full width at F32_LAYERS layers in f32: the flash path against the
    dense path, and decode against the full forward."""
    from repro_torch.config import RunConfig, get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.convert import from_jax_params
    from repro_torch.models.transformer import init_cache, init_model
    from repro_torch.serve import (make_prefill_cache_step, make_prefill_step,
                                   make_serve_step)

    cfg = dataclasses.replace(get_config(ARCH), n_layers=F32_LAYERS)
    B, P, N = SERVE["batch"], SERVE["prompt"], SERVE["new"]
    gen = torch.Generator(device=dev).manual_seed(1)
    params = init_model(cfg, gen, torch.float32)
    runs = {impl: RunConfig(attention_impl=impl, param_dtype="float32",
                            compute_dtype="float32")
            for impl in ("flash", "dense")}
    # both modules hold views of the same f32 weights
    models = {impl: from_jax_params(cfg, params, run=run, device=dev)
              for impl, run in runs.items()}
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                            device=dev, dtype=torch.int32)
    logits, caches = {}, {}
    for impl, run in runs.items():
        flash_attention.launches = 0
        cache = init_cache(cfg, B, P + N, dtype=torch.float32, device=dev)
        logits[impl], caches[impl] = make_prefill_cache_step(cfg, run)(
            models[impl], prompts, cache)
        torch.cuda.synchronize()
        want = cfg.n_layers if impl == "flash" else 0
        check(flash_attention.launches == want,
              f"f32 {impl} prefill: {flash_attention.launches} flash "
              f"launches, want {want}")
    prefill_err = float((logits["flash"] - logits["dense"]).abs().max())
    check(prefill_err <= 1e-3, f"f32 prefill flash vs dense: {prefill_err}")
    cache_err = max(float((a.float() - b.float()).abs().max())
                    for a, b in zip(caches["flash"]["layers"],
                                    caches["dense"]["layers"]))
    del logits, caches

    run = runs["flash"]
    toks = prompts[:2, :DECODE_T].contiguous()
    full = make_prefill_step(cfg, run)(models["flash"], toks)
    cache = init_cache(cfg, 2, DECODE_T, dtype=torch.float32, device=dev)
    serve = make_serve_step(cfg, run)
    steps = []
    for t in range(DECODE_T):
        _, cache, step_logits = serve(models["flash"], cache,
                                      toks[:, t:t + 1], t)
        steps.append(step_logits)
    decode_err = float((full - torch.stack(steps, 1)).abs().max())
    check(decode_err <= 1e-3, f"f32 decode vs full forward: {decode_err}")
    emit("serve_f32", layers=cfg.n_layers, d_model=cfg.d_model,
         vocab=cfg.vocab_size, batch=B, prompt=P,
         prefill_flash_vs_dense_max_abs=prefill_err,
         cache_flash_vs_dense_max_abs=cache_err, decode_tokens=DECODE_T,
         decode_vs_full_forward_max_abs=decode_err)
    del models, params, full, cache
    torch.cuda.empty_cache()


def family_config(torch, arch, spec):
    """The cell's config: the arch at full width and ``spec["layers"]``
    layers, checked to fit the card once the previous cell's model is
    freed.  Returns ``(cfg, cut)``, ``cut`` naming a cut depth or None."""
    from repro_torch.config import get_config
    from repro_torch.models.params import count_params
    from repro_torch.models.transformer import model_defs

    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=spec["layers"])
    cut = (None if cfg.n_layers == full.n_layers
           else f"{cfg.n_layers} of {full.n_layers} layers")
    gc.collect()  # the previous cell's model, then its cached blocks
    torch.cuda.empty_cache()
    need = 2 * count_params(model_defs(cfg))
    free = torch.cuda.mem_get_info()[0]
    check(need <= free, f"{arch}: {need} bytes of bf16 weights at "
                        f"{cfg.n_layers} layers, {free} free")
    return cfg, cut


def attn_slots(cache):
    """The positions of a cache tree's attention slots (the stacked blocks'
    or the hybrid's shared block's, leading dim first), None for RWKV."""
    for key in ("layers", "attn"):
        if key in cache:
            return cache[key].pos
    return None


def recurrent_leaves(cache):
    """The recurrent leaves of a cache tree (RWKV's states and last rows,
    the hybrid's Mamba2 conv inputs and states; none for the attention
    families): a prefill starts from them, so a new prompt needs them
    zeroed."""
    if "mamba" in cache:
        return [*cache["mamba"].values(),
                *(t for tail in cache["tail"] for t in tail.values())]
    return [] if "layers" in cache else list(cache.values())


def whole(t):
    """A DTensor's whole tensor (a collective), any other tensor as it
    is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


@contextlib.contextmanager
def held_to_plain(torch, calls, errs):
    """While entered, every call of an attention core in ``calls`` appends
    its :func:`plain_error` (the kernel's output against the plain
    version on that call's own inputs) to ``errs``.  One hook per core:
    the hybrid's shared core is called once per super-block."""
    def plain(t):  # inference tensors (MLA's cache prefill) take no detach
        return whole(t.detach() if t.requires_grad else t)

    def hook(core, args, out):
        with torch.no_grad():  # a sharded core's DTensors taken whole
            errs.append(plain_error(torch, plain(out),
                                    *(plain(a) for a in args), core.window))

    hooks = [core.register_forward_hook(hook)
             for core in {id(c): c for c in calls}.values()]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


def serve_family(torch, dev, arch, spec, *, phase="family", profile=()):
    """One architecture's cell at full width, bf16: a checked prefill
    (every flash launch held to the plain version on that site's own
    inputs), then a timed prefill into the cache and greedy decode
    (``spec["flash"]`` launches per prefill, by default one per layer,
    none per decode step), then the ``profile`` steps ("prefill",
    "decode") under torch.profiler, the recurrent scans under labels.
    Emits ``{phase}_setup``, ``phase`` and ``{phase}_profile`` lines."""
    from repro_torch.config import RunConfig
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.attention import SENTINEL
    from repro_torch.models.convert import from_jax_params
    from repro_torch.models.transformer import init_cache, init_model
    from repro_torch.serve import (make_prefill_cache_step, make_prefill_step,
                                   make_serve_step)

    cfg, cut = family_config(torch, arch, spec)
    run = RunConfig(attention_impl="flash", param_dtype="bfloat16",
                    compute_dtype="bfloat16")
    B, T, N = spec["batch"], spec["prompt"], spec["new"]
    P = cfg.n_prefix_embeds
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    model = from_jax_params(cfg, init_model(cfg, gen, torch.bfloat16),
                            run=run, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (B, T), generator=gen,
                            device=dev, dtype=torch.int32)
    prefix = None
    if P:  # the vision stub's patch embeddings, at the embeddings' scale
        prefix = torch.randn((B, P, cfg.d_model), generator=gen, device=dev,
                             dtype=torch.bfloat16).mul_(0.02)
    cache = init_cache(cfg, B, P + T + N, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    blocks, calls = model.blocks(), model.attention_calls()
    layers, flash = spec["layers"], spec.get("flash", spec["layers"])
    check(len(blocks) == layers and len(calls) == flash,
          f"{arch}: {len(blocks)} layers and {len(calls)} attention calls "
          f"built, want {layers} and {flash}")
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    emit(f"{phase}_setup", arch=arch, layers=cfg.n_layers, cut=cut,
         d_model=cfg.d_model, vocab=cfg.vocab_size, batch=B, prefix=P,
         prompt=T, new=N, weight_bytes=weight_bytes,
         seconds=time.perf_counter() - t0)
    prefill = make_prefill_cache_step(cfg, run)
    serve = make_serve_step(cfg, run)

    def fresh_prefill():
        """A new prompt: the recurrent leaves it would start from zeroed
        (the attention slots are overwritten)."""
        for t in recurrent_leaves(cache):
            t.zero_()
        return prefill(model, prompts, cache, prefix)

    errs = []
    flash_attention.launches = 0
    with held_to_plain(torch, calls, errs):
        logits, cache = fresh_prefill()
        torch.cuda.synchronize()
    check(flash_attention.launches == flash == len(errs),
          f"{arch} checked prefill: {flash_attention.launches} launches, "
          f"{len(errs)} checked, want {flash}")
    abs_errs, scaled_errs = zip(*errs) if errs else ((), ())
    worst = max(scaled_errs, default=0.0)
    check(worst < 2e-2, f"{arch} checked prefill: scaled error {worst} "
                        f"(max abs {max(abs_errs, default=0.0)})")
    check(logits.shape == (B, P + T, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), f"{arch} prefill logits")
    del logits

    # the timed run: peak memory from here, as in the earlier qwen3-4b cell
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    t0 = time.perf_counter()
    logits, cache = fresh_prefill()
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = flash_attention.launches
    check(bool(torch.isfinite(logits[:, -1]).all()), f"{arch} logits")
    del logits
    out = [tok]
    t0 = time.perf_counter()
    for i in range(N - 1):
        tok, cache, step_logits = serve(model, cache, tok, P + T + i)
        out.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = flash_attention.launches
    tokens = torch.cat(out, 1)
    check(prefill_launches == launches == flash,
          f"{arch} timed run: {prefill_launches} flash launches in prefill, "
          f"{launches} in all; want {flash} (decode runs none)")
    check(tokens.shape == (B, N) and bool(((tokens >= 0)
                                           & (tokens < cfg.vocab_size)).all())
          and bool(torch.isfinite(step_logits).all()), f"{arch} tokens")
    pos = attn_slots(cache)
    last = P + T + N - 2
    check(pos is None or (int(pos[0, 0, last % pos.shape[-1]]) == last
                          and (pos.shape[-1] < last + 2
                               or int(pos[0, 0, last + 1]) == SENTINEL)),
          f"{arch} cache slots after decode")
    check(all(bool(torch.isfinite(t).all()) for t in recurrent_leaves(cache)),
          f"{arch} recurrent cache leaves after decode")
    rec = dict(arch=arch, prefill_ms=prefill_s * 1e3,
               prefill_tokens_per_s=B * (P + T) / prefill_s,
               decode_ms_per_token=decode_s * 1e3 / (N - 1),
               decode_tokens_per_s=B * (N - 1) / decode_s,
               flash_launches_per_prefill=prefill_launches,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               weight_bytes=weight_bytes, layers=cfg.n_layers, cut=cut,
               max_abs_err=max(abs_errs, default=None),
               max_scaled_err=max(scaled_errs, default=None),
               per_layer_abs_err=abs_errs,
               first_tokens=tokens[:, :8].tolist())
    if arch == "h2o-danube-3-4b":  # the window on the kernel, cacheless
        Bl, L = DANUBE_WINDOW_SHAPE[:2]
        long = torch.randint(0, cfg.vocab_size, (Bl, L), generator=gen,
                             device=dev, dtype=torch.int32)
        torch.cuda.synchronize()
        flash_attention.launches = 0
        t0 = time.perf_counter()
        lg = make_prefill_step(cfg, run)(model, long)
        torch.cuda.synchronize()
        rec.update(long_prefill=dict(
            batch=Bl, prompt=L, window=cfg.sliding_window,
            ms=(time.perf_counter() - t0) * 1e3,
            launches=flash_attention.launches))
        check(flash_attention.launches == layers
              and bool(torch.isfinite(lg[:, -1]).all()),
              f"{arch} long prefill: {flash_attention.launches} launches")
        del lg, long
    emit(phase, **rec)
    steps = dict(prefill=fresh_prefill,
                 decode=lambda: serve(model, cache, tok, P + T))
    for step in profile:
        with labelled_scans():
            split = device_split(torch, steps[step])
        emit(f"{phase}_profile", arch=arch, step=step, **split)
    del model, blocks, cache, prompts, prefix, steps
    return rec


def serve_families_phase(torch, dev):
    """Every other family's cell (``FAMILIES``), one model on the card at a
    time.  Returns ``({arch: flash launches per prefill}, the
    largest checked error)``."""
    recs = {arch: serve_family(torch, dev, arch, spec,
                               profile=PROFILED.get(arch, ()))
            for arch, spec in FAMILIES.items()}
    return ({arch: r["flash_launches_per_prefill"]
             for arch, r in recs.items()},
            max(r["max_abs_err"] for r in recs.values()
                if r["max_abs_err"] is not None))


@contextlib.contextmanager
def pinned_routing():
    """Record every MoE routing decision while ``pin["mode"]`` is
    ``"record"`` and replay them, in order, while it is ``"replay"``.

    A replayed call computes its own router probabilities and keeps the
    recorded expert ids, the gates renormalised from its own
    probabilities; ``pin["flips"]`` counts the (token, layer) choices
    whose own top-k differed.  Two runs of one model whose attention paths
    differ by f32 rounding (~1e-5) then differ continuously: a near-tied
    top-k choice that flips between them would otherwise swap a whole
    expert's output into one token, which says nothing about either
    attention path.  The caller bounds ``pin["flips"]``, so that a drift
    that moves many choices still fails.  The pin works because
    ``moe_apply`` looks ``route`` up as a global of ``models.moe`` on
    every call."""
    from repro_torch.models import moe as moe_mod

    original = moe_mod.route
    pin = dict(mode="record", recorded=[], at=0, flips=0, decisions=0)

    def route(x, router, top_k):
        probs, gate, ids = original(x, router, top_k)
        if pin["mode"] == "record":
            pin["recorded"].append(ids)
            return probs, gate, ids
        want = pin["recorded"][pin["at"]]
        pin["at"] += 1
        pin["flips"] += int((ids.sort(-1).values != want.sort(-1).values)
                            .any(-1).sum())
        pin["decisions"] += ids[..., 0].numel()
        g = probs.gather(-1, want)
        return probs, g / g.sum(-1, keepdim=True).clamp(min=1e-9), want

    moe_mod.route = route
    try:
        yield pin
    finally:
        moe_mod.route = original


def f32_family_check(torch, dev, arch, B, T, layers, flash):
    """``arch`` at full width, ``layers`` layers, f32: prefill logits of the
    flash path (``flash`` launches) against the dense path (<= 1e-3; not
    run without an attention call), then decode logits through the cache
    (MLA: the absorbed path; the recurrent families: their one-step
    recurrences) against the full forward over DECODE_T tokens (<= 1e-3;
    MoE with capacity factor 16, so that the 2-token decode batches and
    the full forward drop no pair, as the JAX package's own decode test
    does)."""
    from repro_torch.config import RunConfig, get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.convert import from_jax_params
    from repro_torch.models.transformer import init_cache, init_model
    from repro_torch.serve import (make_prefill_cache_step, make_prefill_step,
                                   make_serve_step)

    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    P = cfg.n_prefix_embeds
    gen = torch.Generator(device=dev).manual_seed(2)
    params = init_model(cfg, gen, torch.float32)
    runs = {impl: RunConfig(attention_impl=impl, param_dtype="float32",
                            compute_dtype="float32")
            for impl in ("flash", "dense")}
    models = {impl: from_jax_params(cfg, params, run=run, device=dev)
              for impl, run in runs.items()}
    prompts = torch.randint(0, cfg.vocab_size, (B, T), generator=gen,
                            device=dev, dtype=torch.int32)
    prefix = None
    if P:
        prefix = torch.randn((B, P, cfg.d_model), generator=gen,
                             device=dev).mul_(0.02)
    logits = {}
    with pinned_routing() as pin:  # the dense run takes the flash run's
        for impl, run in runs.items():  # expert choices
            if not flash:  # no attention call: nothing to compare
                break
            pin["mode"] = "record" if impl == "flash" else "replay"
            flash_attention.launches = 0
            logits[impl] = make_prefill_step(cfg, run)(
                models[impl], prompts, None, prefix)
            torch.cuda.synchronize()
            want = flash if impl == "flash" else 0
            check(flash_attention.launches == want,
                  f"f32 {arch} {impl}: {flash_attention.launches} flash "
                  f"launches, want {want}")
    check(pin["at"] == len(pin["recorded"]),
          f"f32 {arch}: {pin['at']} of {len(pin['recorded'])} routings "
          "replayed")
    check(pin["flips"] <= max(2, pin["decisions"] // 100),
          f"f32 {arch}: {pin['flips']} of {pin['decisions']} routing "
          "choices differ between the flash and dense runs")
    prefill_err = None
    if flash:
        prefill_err = float((logits["flash"] - logits["dense"]).abs().max())
        check(prefill_err <= 1e-3,
              f"f32 {arch} flash vs dense: {prefill_err}")
    del logits, models

    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=16.0))
    run = runs["flash"]
    model = from_jax_params(cfg, params, run=run, device=dev)
    toks = prompts[:, :DECODE_T].contiguous()
    full = make_prefill_step(cfg, run)(model, toks, None, prefix)[:, P:]
    cache = init_cache(cfg, B, P + DECODE_T, dtype=torch.float32, device=dev)
    serve = make_serve_step(cfg, run)
    steps, start = [], 0
    if P:  # the prefix and the first token, then a token a step
        lg, cache = make_prefill_cache_step(cfg, run)(model, toks[:, :1],
                                                      cache, prefix)
        steps, start = [lg[:, -1]], 1
    for t in range(start, DECODE_T):
        _, cache, lg = serve(model, cache, toks[:, t:t + 1], P + t)
        steps.append(lg)
    decode_err = float((full - torch.stack(steps, 1)).abs().max())
    check(decode_err <= 1e-3, f"f32 {arch} decode vs full: {decode_err}")
    emit("family_f32", arch=arch, layers=layers, d_model=cfg.d_model,
         batch=B, prefix=P, prompt=T, prefill_flash_vs_dense_max_abs=
         prefill_err, routing_decisions=pin["decisions"],
         routing_flips_pinned=pin["flips"], flash_launches=flash,
         decode_tokens=DECODE_T, decode_vs_full_forward_max_abs=decode_err)
    del model, params, full, cache
    torch.cuda.empty_cache()


def scan_check(torch, dev, arch, B, T):
    """One layer's chunked scan at ``arch``'s full width on the card, f32
    (no TF32), against its step-by-step recurrence on the same inputs:
    output and final state within 1e-4 of the recurrence's largest
    magnitude.  zamba2: ``ssd_chunked`` (H 64, P 64, N 64, chunk 128; a
    = -1, as ``A_log``'s zero init, dt = softplus of a normal) against
    ``ssd_step`` a token at a time; rwkv6: ``wkv_chunked`` (H 40, D 64,
    chunk 32; w_log = -exp(N(0, 0.25))) against ``wkv_recurrent``.  Both
    timed with CUDA events (the span of host-paced launches)."""
    import torch.nn.functional as F

    from repro_torch.config import get_config
    from repro_torch.models import rwkv, ssm

    cfg = get_config(arch)
    gen = torch.Generator(device=dev).manual_seed(4)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    if cfg.ssm is not None:
        s = cfg.ssm
        H, P, N = s.expand * cfg.d_model // s.head_dim, s.head_dim, (
            s.n_groups * s.d_state)
        x, dt = randn(B, T, H, P), F.softplus(randn(B, T, H))
        a, Bm, Cm = -torch.ones(H, device=dev), randn(B, T, N), randn(B, T, N)
        name, chunk = "ssd_chunked", s.chunk

        def chunked():
            return ssm.ssd_chunked(x, dt, a, Bm, Cm, chunk)

        def recurrent():
            S = torch.zeros((B, H, P, N), device=dev)
            ys = []
            for t in range(T):
                y, S = ssm.ssd_step(S, x[:, t], dt[:, t], a, Bm[:, t],
                                    Cm[:, t])
                ys.append(y)
            return torch.stack(ys, 1), S
    else:
        H, D = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim
        r, k, v = randn(B, T, H, D), randn(B, T, H, D), randn(B, T, H, D)
        w_log, u = -(randn(B, T, H, D) * 0.5).exp(), randn(H, D) * 0.1
        name, chunk = "wkv_chunked", cfg.rwkv.chunk

        def chunked():
            return rwkv.wkv_chunked(r, k, v, w_log, u, chunk)

        def recurrent():
            return rwkv.wkv_recurrent(r, k, v, w_log, u)

    (y, S), (y_ref, S_ref) = chunked(), recurrent()
    errs = {}
    for key, got, want in (("out", y, y_ref), ("state", S, S_ref)):
        scale = max(float(want.abs().max()), 1.0)
        errs[key] = float((got - want).abs().max())
        check(bool(torch.isfinite(got).all()) and errs[key] <= 1e-4 * scale,
              f"{arch} {name} vs the recurrence: {key} error {errs[key]}, "
              f"largest magnitude {scale}")
    emit("scan_check", arch=arch, scan=name, batch=B, tokens=T, chunk=chunk,
         last_chunk=T % chunk or chunk, out_max_abs=errs["out"],
         state_max_abs=errs["state"],
         out_largest=float(y_ref.abs().max()),
         chunked_ms=event_ms(torch, chunked, reps=3),
         recurrent_ms=event_ms(torch, recurrent, reps=1))
    del y, S, y_ref, S_ref
    torch.cuda.empty_cache()


def ring_wrap_check(torch, dev):
    """h2o-danube3 at full width, 2 layers, f32: prefill RING_PREFILL
    tokens into its 4096-slot window ring, then RING_STEPS greedy-free
    decode steps of the given tokens past slot 4096 (the ring wraps);
    every step's logits equal the cacheless forward's at that position
    (<= 1e-3)."""
    from repro_torch.config import RunConfig, get_config
    from repro_torch.models.convert import from_jax_params
    from repro_torch.models.transformer import init_cache, init_model
    from repro_torch.serve import (make_prefill_cache_step, make_prefill_step,
                                   make_serve_step)

    cfg = dataclasses.replace(get_config("h2o-danube-3-4b"),
                              n_layers=F32_LAYERS)
    run = RunConfig(attention_impl="flash", param_dtype="float32",
                    compute_dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(3)
    model = from_jax_params(cfg, init_model(cfg, gen, torch.float32),
                            run=run, device=dev)
    L = RING_PREFILL + RING_STEPS
    toks = torch.randint(0, cfg.vocab_size, (1, L), generator=gen,
                         device=dev, dtype=torch.int32)
    full = make_prefill_step(cfg, run)(model, toks)
    cache = init_cache(cfg, 1, L, dtype=torch.float32, device=dev)
    S = cache["layers"].pos.shape[-1]
    check(S == cfg.sliding_window < L, f"ring of {S} slots for {L} tokens")
    lg, cache = make_prefill_cache_step(cfg, run)(
        model, toks[:, :RING_PREFILL], cache)
    err = float((lg - full[:, :RING_PREFILL]).abs().max())
    serve = make_serve_step(cfg, run)
    for t in range(RING_PREFILL, L):
        _, cache, lg = serve(model, cache, toks[:, t:t + 1], t)
        err = max(err, float((lg - full[:, t]).abs().max()))
    pos = cache["layers"].pos[0, 0]
    check(int(pos[(L - 1) % S]) == L - 1 and int(pos.min()) == L - S,
          "ring positions after the wrap")
    check(err <= 1e-3, f"ring decode vs cacheless forward: {err}")
    emit("ring_wrap", arch=cfg.name, layers=cfg.n_layers, slots=S,
         prefill=RING_PREFILL, decode_steps=RING_STEPS, wrapped_slots=L - S,
         max_abs_vs_cacheless_forward=err)
    del model, full, cache
    torch.cuda.empty_cache()


def serve_f32_families_phase(torch, dev):
    for arch, B, T, layers, flash in F32_FAMILIES:
        f32_family_check(torch, dev, arch, B, T, layers, flash)
    ring_wrap_check(torch, dev)
    for arch, B, T in SCAN_CHECKS:
        scan_check(torch, dev, arch, B, T)


def flash_grad_check(torch, dev):
    """The flash Function under autograd at one full-width qwen3-4b layer
    (B 1, T = S = 4,096, H 32, Hkv 8, D 128, causal): its output and q,
    k, v gradients against autograd of the plain version on the same
    values in f32, scaled by max(1, |want|): within 2e-2 in bf16, 1e-4 in
    f32; and each block of 128 rows within 5e-2 (bf16) or 1e-4 (f32) of
    its own norm (:func:`block_err`); one forward launch, none in the
    backward.  Times the Function's forward + backward, the plain
    version's and SDPA's (CUDA events)."""
    import torch.nn.functional as F

    from repro_torch.config import SHAPES
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref

    T = SHAPES["train_4k"].seq_len
    out = {}
    for dtype, tol, block_tol in ((torch.bfloat16, 2e-2, 5e-2),
                                  (torch.float32, 1e-4, 1e-4)):
        q, k, v, q_pos, kv_pos = flash_inputs(torch, dev, dtype, 1, T, T,
                                              32, 8, 128, seed=7)
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        g_out = torch.randn(q.shape, device=dev, dtype=dtype,
                            generator=torch.Generator(dev).manual_seed(8))
        flash_attention.launches = 0
        got = flash_attention(q, k, v, q_pos, kv_pos, chunk=TRAIN_CHUNK)
        g_got = torch.autograd.grad(got, (q, k, v), g_out)
        torch.cuda.synchronize()
        check(flash_attention.launches == 1,
              f"flash under autograd: {flash_attention.launches} launches")
        ins = [t.detach().float().requires_grad_() for t in (q, k, v)]
        want = flash_attention_ref(*ins, q_pos, kv_pos)
        g_want = torch.autograd.grad(want, ins, g_out.float())
        pairs = [(got.detach(), want.detach()), *zip(g_got, g_want)]
        errs = [kernel_err(a, b) for a, b in pairs]
        blocks = [block_err(a, b) for a, b in pairs]
        worst = max(e[1] for e in errs)
        check(worst < tol, f"flash Function {dtype}: scaled errors {errs}")
        check(max(blocks) < block_tol,
              f"flash Function {dtype}: block errors {blocks}")
        del got, g_got, want, g_want, ins

        def fn_step():
            o = flash_attention(q, k, v, q_pos, kv_pos, chunk=TRAIN_CHUNK)
            torch.autograd.grad(o, (q, k, v), g_out)

        def plain_step():
            o = flash_attention_ref(q, k, v, q_pos, kv_pos)
            torch.autograd.grad(o, (q, k, v), g_out)

        qs, ks, vs = (t.detach().transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        gs = g_out.transpose(1, 2).contiguous()

        def sdpa_step():
            o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                               enable_gqa=True)
            torch.autograd.grad(o, (qs, ks, vs), gs)

        name = str(dtype)[6:]
        out[name] = dict(
            out_scaled_err=errs[0][1], grad_scaled_errs=[e[1] for e in
                                                         errs[1:]],
            block_errs=blocks, block_tolerance=block_tol,
            max_abs_err=max(e[0] for e in errs),
            fwd_bwd_ms=event_ms(torch, fn_step, reps=2),
            plain_fwd_bwd_ms=event_ms(torch, plain_step, reps=1),
            sdpa_fwd_bwd_ms=event_ms(torch, sdpa_step, reps=5))
        emit("flash_grad", dtype=name, shape=dict(B=1, T=T, S=T, H=32, Hkv=8,
                                                  D=128),
             chunk=TRAIN_CHUNK, tolerance=tol, **out[name])
        del q, k, v, qs, ks, vs, g_out, gs
        torch.cuda.empty_cache()
    return out


def train_cell(torch, dev, arch, spec):
    """One training cell (``TRAIN``): qwen3-4b or zamba2-1.2b at full width,
    ``spec["layers"]`` layers, one row of ``train_4k`` (B 1 x 4,096).
    One forward of the loss with every flash call held to the plain
    version on that call's own inputs (2e-2 scaled, as in serving;
    ``spec["flash"]`` calls checked), then a checked warm-up step (every
    parameter's gradient finite, the loss finite, ``spec["flash"]`` flash
    launches), TRAIN_STEPS timed steps (step ms, tokens/s, peak memory,
    launches each), one more profiled with the device split (labels:
    flash forward, attention backward, scans, optimizer; kernels by
    kind)."""
    from repro_torch.config import SHAPES, RunConfig, get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.convert import from_jax_params
    from repro_torch.models.params import count_params
    from repro_torch.models.transformer import init_model, model_defs
    from repro_torch.train import (adamw_init, adamw_update, make_grad_fn,
                                   make_loss_fn, make_train_step)

    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=spec["layers"])
    cut = (None if cfg.n_layers == full.n_layers
           else f"{cfg.n_layers} of {full.n_layers} layers")
    shape = SHAPES["train_4k"]
    T = shape.seq_len
    n_params = count_params(model_defs(cfg))
    gc.collect()
    torch.cuda.empty_cache()
    # parameters, gradients and both moments in f32, and the f32 logits,
    # their log-softmax and its gradient
    need = 16 * n_params + 3 * 4 * T * cfg.vocab_size
    free = torch.cuda.mem_get_info()[0]
    check(need <= free, f"train {arch}: {need} bytes at {cfg.n_layers} "
                        f"layers, {free} free")
    run = RunConfig(attention_impl="flash", attention_chunk=TRAIN_CHUNK,
                    remat="full", param_dtype="float32",
                    compute_dtype="bfloat16")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    model = from_jax_params(cfg, init_model(cfg, gen, torch.float32),
                            run=run, device=dev, trainable=True)
    params = dict(model.named_parameters())
    opt = adamw_init(params)
    ds = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=T,
                         global_batch=shape.global_batch,
                         n_shards=shape.global_batch)
    batches = [{"tokens": torch.from_numpy(ds.batch_at(i)).to(dev)}
               for i in range(TRAIN_STEPS + 2)]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check(len(model.attention_calls()) == spec["flash"],
          f"train {arch}: {len(model.attention_calls())} attention calls")

    # the kernel at this cell's shapes against its plain version: one
    # forward of the loss on the warm-up batch (the step's forward path,
    # under autograd, no backward)
    errs = []
    with held_to_plain(torch, model.attention_calls(), errs):
        loss, _ = make_loss_fn(cfg, run)(model, batches[0])
        torch.cuda.synchronize()
    del loss
    abs_errs, scaled_errs = zip(*errs) if errs else ((), ())
    worst = max(scaled_errs, default=0.0)
    check(len(errs) == spec["flash"] and worst < 2e-2,
          f"train {arch}: {len(errs)} flash calls checked, want "
          f"{spec['flash']}; scaled error {worst}")

    # the checked warm-up step
    flash_attention.launches = 0
    loss, mets, grads = make_grad_fn(cfg, run)(model, batches[0])
    torch.cuda.synchronize()
    warm_launches = flash_attention.launches
    bad = [k for k, g in grads.items() if not bool(torch.isfinite(g).all())]
    zero = [k for k, g in grads.items() if not bool(g.any())]
    check(warm_launches == spec["flash"],
          f"train {arch} warm-up: {warm_launches} flash launches, want "
          f"{spec['flash']}")
    check(set(grads) == set(params) and not bad
          and bool(torch.isfinite(loss)),
          f"train {arch} warm-up: loss {float(loss)}, non-finite grads {bad}")
    opt, _ = adamw_update(params, grads, opt, run)
    del grads

    step = make_train_step(cfg, run)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses, norms, launches = [], [], [], []
    for b in batches[1:TRAIN_STEPS + 1]:
        torch.cuda.synchronize()
        flash_attention.launches = 0
        t0 = time.perf_counter()
        model, opt, mets = step(model, opt, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launches.append(flash_attention.launches)
        losses.append(float(mets["loss"]))
        norms.append(float(mets["grad_norm"]))
    peak = torch.cuda.max_memory_allocated()
    check(all(n == spec["flash"] for n in launches),
          f"train {arch}: flash launches per step {launches}, want "
          f"{spec['flash']}")
    check(all(map(math.isfinite, losses + norms)),
          f"train {arch}: losses {losses}, grad norms {norms}")
    check(all(bool(torch.isfinite(p).all()) for p in params.values()),
          f"train {arch}: non-finite parameters after {TRAIN_STEPS} steps")
    step_ms = [t * 1e3 for t in times]
    rec = dict(arch=arch, layers=cfg.n_layers, cut=cut, d_model=cfg.d_model,
               vocab=cfg.vocab_size, batch=1, seq=T, params=n_params,
               setup_s=setup_s, step_ms=step_ms,
               tokens_per_s=[T / t for t in times],
               max_memory_allocated=peak, flash_launches_per_step=launches,
               warmup_flash_launches=warm_launches,
               flash_max_abs_err=max(abs_errs),
               flash_max_scaled_err=worst, losses=losses,
               grad_norms=norms, zero_grad_leaves=zero)
    emit("train", **rec)
    with labelled_training():
        split = device_split(torch, lambda: step(model, opt,
                                                batches[TRAIN_STEPS + 1]))
    emit("train_profile", arch=arch, **split)
    del model, params, opt, batches, step
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def train_f32_check(torch, dev):
    """qwen3-4b at full width, 2 layers, f32, B 1 x TRAIN_F32_T: the loss
    and every gradient with ``"flash"`` (2 launches) against ``"dense"``
    (none), within 1e-4 of each leaf's largest magnitude (at least 1e-3
    of the largest of all)."""
    from repro_torch.config import RunConfig, get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.convert import from_jax_params
    from repro_torch.models.transformer import init_model
    from repro_torch.train import make_grad_fn

    cfg = dataclasses.replace(get_config(ARCH), n_layers=F32_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(9)
    params = init_model(cfg, gen, torch.float32)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, TRAIN_F32_T + 1),
                                     generator=gen, device=dev,
                                     dtype=torch.int32)}
    res = {}
    for impl in ("flash", "dense"):
        run = RunConfig(attention_impl=impl, attention_chunk=TRAIN_CHUNK,
                        remat="full", param_dtype="float32",
                        compute_dtype="float32")
        model = from_jax_params(cfg, params, run=run, device=dev,
                                trainable=True)
        flash_attention.launches = 0
        loss, _, grads = make_grad_fn(cfg, run)(model, batch)
        torch.cuda.synchronize()
        want = F32_LAYERS if impl == "flash" else 0
        check(flash_attention.launches == want,
              f"f32 train {impl}: {flash_attention.launches} flash launches")
        res[impl] = (float(loss), grads)
        del model
    (lf, gf), (ld, gd) = res["flash"], res["dense"]
    top = max(float(g.abs().max()) for g in gd.values())
    errs = {k: float((gf[k] - g).abs().max())
            / max(float(g.abs().max()), 1e-3 * top) for k, g in gd.items()}
    worst = max(errs, key=errs.get)
    check(abs(lf - ld) <= 1e-4 * max(1.0, abs(ld)) and errs[worst] <= 1e-4,
          f"f32 train flash vs dense: loss {lf} vs {ld}, {worst} "
          f"{errs[worst]}")
    emit("train_f32", arch=ARCH, layers=F32_LAYERS, seq=TRAIN_F32_T,
         loss_flash=lf, loss_dense=ld, worst_leaf=worst,
         worst_scaled_err=errs[worst], leaves=len(errs))
    del res, gf, gd, params
    torch.cuda.empty_cache()
    return errs[worst]


def rwkv_train_check(torch, dev):
    """rwkv6-3b at ``:smoke`` width on the card, f32: the loss and every
    gradient of a train step's backward against the same on the CPU
    (1e-4 of each leaf's largest magnitude, at least 1e-3 of the largest
    of all), then one whole step (finite loss, no flash launch)."""
    from repro_torch.config import RunConfig, get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.convert import from_jax_params
    from repro_torch.models.transformer import init_model
    from repro_torch.train import adamw_init, make_grad_fn, make_train_step

    cfg = get_config("rwkv6-3b", smoke=True)
    run = RunConfig(remat="full", compute_dtype="float32")
    params = init_model(cfg, torch.Generator().manual_seed(5))
    tokens = torch.from_numpy(SyntheticTokens(
        vocab_size=cfg.vocab_size, seq_len=64, global_batch=2).batch_at(0))
    res = {}
    for where in ("cpu", dev):
        model = from_jax_params(cfg, params, run=run, device=where,
                                trainable=True)
        loss, _, grads = make_grad_fn(cfg, run)(
            model, {"tokens": tokens.to(where)})
        res[str(where)] = (float(loss), {k: g.cpu() for k, g in
                                         grads.items()})
    (lc, gc_), (lg, gg) = res["cpu"], res[str(dev)]
    top = max(float(g.abs().max()) for g in gc_.values())
    worst = max(float((gg[k] - g).abs().max())
                / max(float(g.abs().max()), 1e-3 * top)
                for k, g in gc_.items())
    check(all(bool(torch.isfinite(g).all()) for g in gg.values())
          and abs(lg - lc) <= 1e-4 * max(1.0, abs(lc)) and worst <= 1e-4,
          f"rwkv6 train on the card vs the CPU: loss {lg} vs {lc}, "
          f"gradients {worst}")
    flash_attention.launches = 0
    model = from_jax_params(cfg, params, run=run, device=dev, trainable=True)
    opt = adamw_init(dict(model.named_parameters()))
    _, opt, mets = make_train_step(cfg, run)(model, opt,
                                             {"tokens": tokens.to(dev)})
    step_loss = float(mets["loss"])
    check(math.isfinite(step_loss) and flash_attention.launches == 0,
          f"rwkv6 train step: loss {step_loss}, "
          f"{flash_attention.launches} flash launches")
    emit("train_rwkv6_smoke", loss_card=lg, loss_cpu=lc,
         worst_scaled_grad_err=worst, step_loss=step_loss)


def train_phase(torch, dev):
    """The training slice on the card: the flash Function's gradient, the
    f32 2-layer flash-vs-dense gradients, rwkv6's scan under autograd,
    then the ``TRAIN`` cells.  Returns ``({arch: flash launches a step},
    the Function's largest checked bf16 error, its times)``."""
    grad = flash_grad_check(torch, dev)
    train_f32_check(torch, dev)
    rwkv_train_check(torch, dev)
    recs = {arch: train_cell(torch, dev, arch, spec)
            for arch, spec in TRAIN.items()}
    return ({arch: r["flash_launches_per_step"][0] for arch, r in
             recs.items()}, grad["bfloat16"]["max_abs_err"], grad)


@contextlib.contextmanager
def one_rank_group(torch):
    """A one-rank ``nccl`` process group in this process (a free localhost
    port), destroyed on exit: the sharded phases' mesh is ``(1, 1)``."""
    import datetime
    import socket

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    try:
        yield
    finally:
        dist.destroy_process_group()


def step_diff(torch, got, want, lr):
    """A step's parameters (name -> tensor, DTensors taken whole) against
    another's (name -> host tensor): (worst abs difference, elements
    beyond 1e-5, elements); checks every difference within 2 lr (Adam's
    first step moves an element by lr whatever its gradient's size, so a
    near-zero gradient whose sign rounds the other way moves it 2 lr)."""
    worst, off, total = 0.0, 0, 0
    for k, w in want.items():
        with torch.no_grad():
            d = (whole(got[k].detach()).cpu() - w).abs()
        worst = max(worst, float(d.max()))
        off += int((d > 1e-5).sum())
        total += d.numel()
    check(worst <= 2 * lr, f"a parameter moved {worst} apart, past 2 lr")
    return worst, off, total


def train_batches(torch, dev, cfg, n):
    """``n`` rows of ``SHAPES["train_4k"]`` from ``SyntheticTokens``."""
    from repro_torch.config import SHAPES
    from repro_torch.data import SyntheticTokens

    shape = SHAPES["train_4k"]
    ds = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
                         global_batch=shape.global_batch,
                         n_shards=shape.global_batch)
    return [{"tokens": torch.from_numpy(ds.batch_at(i)).to(dev)}
            for i in range(n)]


def timed_steps(torch, step, model, opt, batches):
    """(model, opt, step ms each, flash launches each)."""
    from repro_torch.kernels.flash_attention import flash_attention

    ms, launches = [], []
    for b in batches:
        torch.cuda.synchronize()
        flash_attention.launches = 0
        t0 = time.perf_counter()
        model, opt, mets = step(model, opt, b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(flash_attention.launches)
        check(math.isfinite(float(mets["loss"])), "a non-finite loss")
    return model, opt, ms, launches


def free(torch):
    gc.collect()
    torch.cuda.empty_cache()


def sharded_train_phase(torch, dev):
    """qwen3-4b's train cell (``TRAIN``: 16 layers, B 1 x 4,096, f32
    parameters, bf16 compute, remat "full", flash at chunk 1,024) through
    the launcher's setup (``launch.train.train_setup``: the (1, 1) mesh,
    the rules, every parameter and moment a DTensor) against the same cell
    unsharded from the same seed: the loss of step 0 and every parameter
    after it within ONE_RANK_TOL; one forward's flash calls held to the
    plain version (2e-2 scaled), 16 launches in it and 16 in a step (none
    in the backward); step ms of each; one sharded step profiled (device
    split by label and kernel kind, idle share).  Then both at
    SHARDED_TURNS_LAYERS layers on the card at once, timed in turns (the
    DTensor dispatch cost), and the elastic restore: the sharded model's
    trees (JAX keys, whole, on the host: what a checkpoint holds) placed
    back on the mesh by ``reshard_tree`` into a fresh sharded model, whose
    next step's parameters are within ONE_RANK_TOL of the uninterrupted
    model's.  Returns the flash launches a sharded step."""
    from repro_torch.config import RunConfig, get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.train import train_setup
    from repro_torch.models.convert import from_jax_params
    from repro_torch.models.params import param_specs
    from repro_torch.models.transformer import init_model, model_defs
    from repro_torch.train import (adamw_init, make_loss_fn, make_train_step,
                                   restore_train_state, train_state)
    from repro_torch.train.elastic import reshard_tree
    from repro_torch.train.optimizer import cosine_schedule

    spec = TRAIN[ARCH]
    run = RunConfig(attention_impl="flash", attention_chunk=TRAIN_CHUNK,
                    remat="full", param_dtype="float32",
                    compute_dtype="bfloat16")
    warmup = max(2, SHARDED_TOTAL // 10)

    def unsharded(cfg):
        gen = torch.Generator(device=dev).manual_seed(0)
        model = from_jax_params(cfg, init_model(cfg, gen, torch.float32),
                                run=run, device=dev, trainable=True)
        return (model, adamw_init(dict(model.named_parameters())),
                make_train_step(cfg, run, total_steps=SHARDED_TOTAL,
                                warmup=warmup))

    def lr_at(step):
        return float(cosine_schedule(step, run.learning_rate, warmup=warmup,
                                     total=SHARDED_TOTAL))

    cfg = dataclasses.replace(get_config(ARCH), n_layers=spec["layers"])
    batches = train_batches(torch, dev, cfg, TRAIN_STEPS + 1)
    free(torch)
    model, opt, step = unsharded(cfg)
    model, opt, mets = step(model, opt, batches[0])
    loss_ref = float(mets["loss"])
    ref = {k: whole(p.detach()).to("cpu", copy=True)
           for k, p in model.named_parameters()}
    model, opt, ref_ms, _ = timed_steps(torch, step, model, opt, batches[1:])
    del model, opt, step
    free(torch)

    t0 = time.perf_counter()
    model, opt, step, mesh, rules = train_setup(cfg, run, dev,
                                                total_steps=SHARDED_TOTAL)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check(tuple(mesh.shape) == (1, 1) and model.mesh is mesh,
          f"sharded train: mesh {mesh}")
    check(all(hasattr(p, "placements") for p in model.parameters()),
          "sharded train: a parameter is not a DTensor")
    errs = []
    flash_attention.launches = 0
    with held_to_plain(torch, model.attention_calls(), errs):
        loss, _ = make_loss_fn(cfg, run, mesh, rules)(model, batches[0])
        torch.cuda.synchronize()
    fwd_launches = flash_attention.launches
    del loss
    worst_flash = max((e[1] for e in errs), default=0.0)
    check(len(errs) == fwd_launches == spec["flash"] and worst_flash < 2e-2,
          f"sharded train: {len(errs)} flash calls checked, {fwd_launches} "
          f"launches, want {spec['flash']}; scaled error {worst_flash}")
    flash_attention.launches = 0
    model, opt, mets = step(model, opt, batches[0])
    torch.cuda.synchronize()
    step_launches = flash_attention.launches
    loss0 = float(mets["loss"])
    check(step_launches == spec["flash"],
          f"sharded train step: {step_launches} flash launches")
    loss_diff = abs(loss0 - loss_ref)
    check(loss_diff <= ONE_RANK_TOL * max(1.0, abs(loss_ref)),
          f"sharded train: step-0 loss {loss0}, unsharded {loss_ref}")
    worst, off, total = step_diff(torch, dict(model.named_parameters()), ref,
                                  lr_at(1))
    check(worst <= ONE_RANK_TOL,
          f"sharded train: a parameter {worst} from the unsharded step's "
          f"({off} of {total} past 1e-5)")
    del ref
    model, opt, ms, launches = timed_steps(torch, step, model, opt,
                                           batches[1:])
    check(launches == [spec["flash"]] * TRAIN_STEPS,
          f"sharded train: flash launches a step {launches}")
    peak = torch.cuda.max_memory_allocated()
    with labelled_training():
        split = device_split(torch, lambda: step(model, opt, batches[0]))
    emit("sharded_train", arch=ARCH, layers=cfg.n_layers,
         mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)), setup_s=setup_s,
         loss0=loss0, loss0_unsharded=loss_ref, loss0_abs_diff=loss_diff,
         param_worst_abs_diff=worst, params_past_1e5=off, params=total,
         flash_checked=len(errs), flash_max_scaled_err=worst_flash,
         forward_flash_launches=fwd_launches,
         flash_launches_per_step=[step_launches] + launches,
         step_ms=ms, unsharded_step_ms=ref_ms, max_memory_allocated=peak)
    emit("sharded_train_profile", arch=ARCH, **split)
    del model, opt, step
    free(torch)

    # both at SHARDED_TURNS_LAYERS layers, in turns; then the elastic
    # restore of the sharded one
    cfg = dataclasses.replace(cfg, n_layers=SHARDED_TURNS_LAYERS)
    u_model, u_opt, u_step = unsharded(cfg)
    s_model, s_opt, s_step, mesh, rules = train_setup(
        cfg, run, dev, total_steps=SHARDED_TOTAL)
    turns = {"unsharded": [], "sharded": []}
    for b in batches:
        u_model, u_opt, ms, _ = timed_steps(torch, u_step, u_model, u_opt,
                                            [b])
        turns["unsharded"] += ms
        s_model, s_opt, ms, _ = timed_steps(torch, s_step, s_model, s_opt,
                                            [b])
        turns["sharded"] += ms
    del u_model, u_opt, u_step
    free(torch)
    t0 = time.perf_counter()
    saved = train_state(s_model, s_opt)  # whole trees on the host
    saved_step = s_opt.step
    save_s = time.perf_counter() - t0
    s_model, s_opt, _ = s_step(s_model, s_opt, batches[0])
    after = {k: whole(p.detach()).to("cpu", copy=True)
           for k, p in s_model.named_parameters()}
    del s_model, s_opt, s_step
    free(torch)
    model, opt, step, mesh, rules = train_setup(cfg, run, dev,
                                                total_steps=SHARDED_TOTAL)
    del opt  # the restore brings the moments
    t0 = time.perf_counter()
    specs = param_specs(model_defs(cfg), rules)
    placed = reshard_tree(saved, mesh, {t: specs for t in saved})
    del saved
    opt = restore_train_state(model, placed, saved_step)
    del placed
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    model, opt, _ = step(model, opt, batches[0])
    e_worst, e_off, e_total = step_diff(
        torch, dict(model.named_parameters()), after, lr_at(saved_step + 1))
    check(e_worst <= ONE_RANK_TOL,
          f"elastic: a parameter {e_worst} from the uninterrupted step's "
          f"({e_off} of {e_total} past 1e-5)")
    emit("sharded_turns", arch=ARCH, layers=cfg.n_layers, **{
        f"{k}_step_ms": v for k, v in turns.items()})
    emit("elastic", arch=ARCH, layers=cfg.n_layers, step=saved_step,
         host_trees_s=save_s, reshard_restore_s=restore_s,
         param_worst_abs_diff=e_worst, params_past_1e5=e_off,
         params=e_total)
    del model, opt, step, after
    free(torch)
    return step_launches


def sharded_prefill_phase(torch, dev):
    """qwen3-4b at full width and depth, bf16, B 4 x 2,048: the cacheless
    prefill on the (1, 1) mesh (``make_prefill_step(cfg, run, mesh,
    rules)``) against the unsharded one from the same weights: the logits
    within ONE_RANK_TOL of their largest magnitude (printed), 36 flash
    launches
    each; each model's first (cold) prefill timed, then two more of each
    in turns (warm), then one more of each profiled.  Returns the sharded
    prefill's launches."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.config import RunConfig, get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.convert import from_jax_params
    from repro_torch.models.transformer import init_model
    from repro_torch.serve import make_prefill_step
    from repro_torch.sharding.rules import make_rules

    cfg = get_config(ARCH)
    run = RunConfig(attention_impl="flash", param_dtype="bfloat16",
                    compute_dtype="bfloat16", remat="none")
    B, T = SERVE["batch"], SERVE["prompt"]
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_model(cfg, gen, torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab_size, (B, T), generator=gen,
                           device=dev, dtype=torch.int32)
    mesh = init_device_mesh(dev.type, (1, 1),
                            mesh_dim_names=("data", "model"))
    rules = make_rules(mesh)
    steps = {}
    for label, m in (("unsharded", None), ("sharded", mesh)):
        model = from_jax_params(cfg, params, run=run, device=dev, mesh=m,
                                rules=rules if m is not None else None)
        steps[label] = (model, make_prefill_step(
            cfg, run, m, None if m is None else rules))
    out, launches, ms = {}, {}, {"unsharded": [], "sharded": []}

    def prefill(label):
        model, step = steps[label]
        flash_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = step(model, tokens)
        torch.cuda.synchronize()
        ms[label].append((time.perf_counter() - t0) * 1e3)
        launches[label] = flash_attention.launches
        return logits

    # the first (cold) call of each, checked; then in turns, warm; then
    # one profiled warm prefill of each
    for label in steps:
        out[label] = prefill(label)
    for label in ("unsharded", "sharded", "sharded", "unsharded"):
        del out[label]
        out[label] = prefill(label)
    splits = {}
    for label, (model, step) in steps.items():
        splits[label] = device_split(torch, lambda: step(model, tokens))
    del steps
    got, want = out["sharded"], out["unsharded"]
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    check(got.shape == want.shape == (B, T, cfg.vocab_size)
          and err <= ONE_RANK_TOL * scale,
          f"sharded prefill: logits {tuple(got.shape)} differ by {err} "
          f"(largest {scale})")
    check(launches == {"unsharded": cfg.n_layers, "sharded": cfg.n_layers},
          f"sharded prefill: flash launches {launches}")
    emit("sharded_prefill", arch=ARCH, batch=B, prompt=T,
         logits_max_abs_diff=err, logits_max_abs=scale,
         flash_launches=launches,
         cold_prefill_ms={k: v[0] for k, v in ms.items()},
         warm_prefill_ms={k: v[1:] for k, v in ms.items()})
    for label, split in splits.items():
        emit("sharded_prefill_profile", arch=ARCH, run=label, **split)
    del out, got, want, params
    free(torch)
    return launches["sharded"]


def sharded_serve_cell(torch, dev, arch, spec):
    """One architecture at full width (``SHARDED_SERVE``), bf16, placed on
    the (1, 1) mesh by ``serve_rules`` beside the same seeded weights
    unsharded (both contiguous).
    Unless ``spec["cacheless"]`` is False: the cacheless prefill
    (``make_prefill_step(cfg, run, mesh, rules)``), its flash calls held
    to the plain version (2e-2 scaled) and counted (``spec["flash"]``, as
    the unsharded model's), its logits within ONE_RANK_TOL of the
    unsharded ones' largest magnitude; cold, then warm in turns.  Then
    the sharded model's cache-writing prefill once with its flash calls
    held to the plain version at the cache's S = T + N (2e-2 scaled,
    ``spec["flash"]`` of them), and each model's timed cache-writing
    prefill into its own fresh cache (the
    sharded one placed by ``init_cache(mesh=, rules=)``) and
    ``spec["new"]`` greedy decode steps: the same tokens, every step's
    logits and the prefill's within ONE_RANK_TOL, ``spec["flash"]``
    launches a prefill and none in decode; prefill ms and ms per token of
    each, and one profiled prefill and decode step of each (the idle
    share; ``spec["profile"]`` names fewer).  Returns ``{"prefill": launches, "decode": launches a step}``
    of the sharded model."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.config import RunConfig, get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.specs import serve_rules
    from repro_torch.models.convert import init_module
    from repro_torch.models.params import count_params
    from repro_torch.models.transformer import init_cache, model_defs
    from repro_torch.serve import (make_prefill_cache_step, make_prefill_step,
                                   make_serve_step)

    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=spec["layers"])
    cut = (None if cfg.n_layers == full.n_layers
           else f"{cfg.n_layers} of {full.n_layers} layers")
    free(torch)
    need = 2 * 2 * count_params(model_defs(cfg))  # two bf16 copies
    check(need <= torch.cuda.mem_get_info()[0],
          f"sharded {arch}: {need} bytes of weights do not fit")
    run = RunConfig(attention_impl="flash", param_dtype="bfloat16",
                    compute_dtype="bfloat16", remat="none")
    B, T, N, flash = spec["batch"], spec["prompt"], spec["new"], spec["flash"]
    tokens = torch.randint(0, cfg.vocab_size, (B, T), device=dev,
                           dtype=torch.int32, generator=torch.Generator(
                               device=dev).manual_seed(1))
    mesh = init_device_mesh(dev.type, (1, 1),
                            mesh_dim_names=("data", "model"))
    rules = serve_rules(cfg, run, mesh, B, T + N)

    def seeded():
        return torch.Generator(device=dev).manual_seed(0)

    # the same seeded weights, each model drawing a layer's slice at a
    # time into contiguous (out, in) weights: a view of the JAX-layout
    # (in, out) table would take other GEMM kernels and round otherwise
    models = {"unsharded": (init_module(cfg, seeded(), run=run,
                                        trainable=True).requires_grad_(False)
                            .eval(), None, None),
              "sharded": (init_module(cfg, seeded(), run=run, mesh=mesh,
                                      rules=rules), mesh, rules)}
    check(len(models["sharded"][0].attention_calls()) == flash,
          f"sharded {arch}: {len(models['sharded'][0].attention_calls())} "
          f"attention calls, want {flash}")
    rec = dict(arch=arch, layers=cfg.n_layers, cut=cut, batch=B, prompt=T,
               new=N, mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)),
               expert_sharding=None if cfg.moe is None else
               "expert" if rules.table["experts"] else "tensor")

    def scaled(got, want):
        return float((got - want).abs().max()) / max(
            float(want.abs().max()), 1e-30)

    if spec.get("cacheless", True):
        model = models["sharded"][0]
        errs = []
        flash_attention.launches = 0
        with held_to_plain(torch, model.attention_calls(), errs):
            got = make_prefill_step(cfg, run, mesh, rules)(model, tokens)
            torch.cuda.synchronize()
        check(flash_attention.launches == flash == len(errs),
              f"sharded {arch} checked prefill: {flash_attention.launches} "
              f"launches, {len(errs)} checked, want {flash}")
        worst = max((e[1] for e in errs), default=0.0)
        check(worst < 2e-2, f"sharded {arch}: flash scaled error {worst}")
        ms, launches = {"unsharded": [], "sharded": []}, {}

        def prefill(label):
            m, m_mesh, m_rules = models[label]
            step = make_prefill_step(cfg, run, m_mesh, m_rules)
            torch.cuda.synchronize()
            flash_attention.launches = 0
            t0 = time.perf_counter()
            logits = step(m, tokens)
            torch.cuda.synchronize()
            ms[label].append((time.perf_counter() - t0) * 1e3)
            launches[label] = flash_attention.launches
            return logits

        want = prefill("unsharded")
        err = scaled(got, want)
        check(got.shape == want.shape == (B, T, cfg.vocab_size)
              and err <= ONE_RANK_TOL,
              f"sharded {arch} prefill: logits {err} of their largest "
              f"magnitude apart")
        del got, want
        for label in ("sharded", "unsharded"):
            prefill(label)
        check(launches == {"unsharded": flash, "sharded": flash},
              f"sharded {arch} prefill: flash launches {launches}")
        rec.update(cacheless=dict(
            logits_max_scaled_diff=err, flash_checked=len(errs),
            flash_max_scaled_err=worst, flash_launches=launches,
            cold_ms=ms["unsharded"][0], warm_ms=ms))
        free(torch)

    served, profiles = {}, {}
    for label, (m, m_mesh, m_rules) in models.items():
        prefill = make_prefill_cache_step(cfg, run, m_mesh, m_rules)
        serve = make_serve_step(cfg, run, m_mesh, m_rules)
        if m_mesh is not None:  # its flash calls at the cache's S = T + N
            errs = []
            cache = init_cache(cfg, B, T + N, torch.bfloat16, dev,
                               mesh=m_mesh, rules=m_rules)
            flash_attention.launches = 0
            with held_to_plain(torch, m.attention_calls(), errs):
                prefill(m, tokens, cache)
                torch.cuda.synchronize()
            worst = max((e[1] for e in errs), default=0.0)
            check(flash_attention.launches == flash == len(errs)
                  and worst < 2e-2,
                  f"sharded {arch} checked cache prefill: "
                  f"{flash_attention.launches} launches, {len(errs)} "
                  f"checked, want {flash}; scaled error {worst}")
            rec.update(cache_prefill_flash_checked=len(errs),
                       cache_prefill_flash_max_scaled_err=worst)
            del cache
            free(torch)
        cache = init_cache(cfg, B, T + N, torch.bfloat16, dev, mesh=m_mesh,
                           rules=m_rules)
        torch.cuda.synchronize()
        flash_attention.launches = 0
        t0 = time.perf_counter()
        logits, cache = prefill(m, tokens, cache)
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        prefill_launches = flash_attention.launches
        outs = [logits[:, -1].float()]
        del logits
        toks = []
        flash_attention.launches = 0
        t0 = time.perf_counter()
        for i in range(N):
            tok, cache, lg = serve(m, cache, tok, T + i)
            toks.append(tok)
            outs.append(lg.float())
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / N
        served[label] = dict(tokens=torch.cat(toks, 1), logits=outs,
                             prefill_ms=prefill_ms, decode_ms=decode_ms,
                             prefill_launches=prefill_launches,
                             decode_launches=flash_attention.launches)
        check(prefill_launches == flash and flash_attention.launches == 0,
              f"sharded {arch} {label}: {prefill_launches} flash launches "
              f"in prefill, {flash_attention.launches} in decode")
        steps = {"prefill": lambda: prefill(m, tokens, cache),
                 "decode": lambda: serve(m, cache, tok, T + N - 1)}
        profiles[label] = {step: device_split(torch, steps[step])
                           for step in spec.get("profile",
                                                ("prefill", "decode"))}
        del cache
        free(torch)
    got, want = served["sharded"], served["unsharded"]
    check(torch.equal(got["tokens"], want["tokens"]),
          f"sharded {arch} decode: tokens differ from unsharded")
    step_err = max(scaled(g, w) for g, w in zip(got["logits"],
                                                want["logits"]))
    check(step_err <= ONE_RANK_TOL,
          f"sharded {arch} decode: logits {step_err} apart")
    rec.update(
        decode_logits_max_scaled_diff=step_err, tokens_equal=True,
        first_tokens=got["tokens"][:, :8].tolist(),
        **{f"{k}_{label}": served[label][k] for label in served
           for k in ("prefill_ms", "decode_ms", "prefill_launches",
                     "decode_launches")},
        **{f"{step}_idle_share_{label}": split["device_idle_share"]
           for label in profiles for step, split in profiles[label].items()},
        **{f"{step}_busy_ms_{label}": split["device_busy_ms"]
           for label in profiles for step, split in profiles[label].items()})
    emit("sharded_serve", **rec)
    del models, served, got, want
    free(torch)
    return {"prefill": rec["prefill_launches_sharded"],
            "decode": rec["decode_launches_sharded"]}


def sharded_train_cell(torch, dev, arch, spec):
    """One train step of ``arch`` at full width and ``spec["layers"]``
    layers (``SHARDED_TRAIN``; B 1 x 4,096, f32 parameters, bf16 compute,
    remat "full", flash at chunk 1,024) through the launcher's setup on
    the (1, 1) mesh against the same step unsharded from the same seed,
    the two in turns: one forward of the sharded loss with its flash
    calls held to the plain version (2e-2 scaled, ``spec["flash"]`` of
    them), then the loss and every parameter after a step within
    ONE_RANK_TOL, ``spec["flash"]`` flash launches in each step (the
    forward's; none in the backward), step ms of each.  Returns the
    sharded step's launches."""
    from repro_torch.config import RunConfig, get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.train import train_setup
    from repro_torch.models.convert import from_jax_params
    from repro_torch.models.transformer import init_model
    from repro_torch.train import adamw_init, make_loss_fn, make_train_step
    from repro_torch.train.optimizer import cosine_schedule

    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=spec["layers"])
    run = RunConfig(attention_impl="flash", attention_chunk=TRAIN_CHUNK,
                    remat="full", param_dtype="float32",
                    compute_dtype="bfloat16")
    warmup = max(2, SHARDED_TOTAL // 10)
    batch = train_batches(torch, dev, cfg, 1)[0]
    free(torch)
    torch.cuda.reset_peak_memory_stats()

    def one_step(model, opt, step):
        torch.cuda.synchronize()
        flash_attention.launches = 0
        t0 = time.perf_counter()
        model, opt, mets = step(model, opt, batch)
        torch.cuda.synchronize()
        return (model, float(mets["loss"]), (time.perf_counter() - t0) * 1e3,
                flash_attention.launches)

    gen = torch.Generator(device=dev).manual_seed(0)
    model = from_jax_params(cfg, init_model(cfg, gen, torch.float32),
                            run=run, device=dev, trainable=True)
    model, loss_ref, ref_ms, ref_launches = one_step(
        model, adamw_init(dict(model.named_parameters())),
        make_train_step(cfg, run, total_steps=SHARDED_TOTAL, warmup=warmup))
    ref = {k: whole(p.detach()).to("cpu", copy=True)
           for k, p in model.named_parameters()}
    del model
    free(torch)
    model, opt, step, mesh, rules = train_setup(cfg, run, dev,
                                                total_steps=SHARDED_TOTAL)
    check(all(hasattr(p, "placements") for p in model.parameters()),
          f"sharded train {arch}: a parameter is not a DTensor")
    errs = []
    flash_attention.launches = 0
    with held_to_plain(torch, model.attention_calls(), errs):
        fwd, _ = make_loss_fn(cfg, run, mesh, rules)(model, batch)
        torch.cuda.synchronize()
    del fwd
    worst_flash = max((e[1] for e in errs), default=0.0)
    check(len(errs) == flash_attention.launches == spec["flash"]
          and worst_flash < 2e-2,
          f"sharded train {arch}: {len(errs)} flash calls checked, "
          f"{flash_attention.launches} launches, want {spec['flash']}; "
          f"scaled error {worst_flash}")
    free(torch)
    model, loss, ms, launches = one_step(model, opt, step)
    check(launches == ref_launches == spec["flash"],
          f"sharded train {arch}: {launches} flash launches a step, "
          f"unsharded {ref_launches}, want {spec['flash']}")
    loss_diff = abs(loss - loss_ref)
    check(loss_diff <= ONE_RANK_TOL * max(1.0, abs(loss_ref)),
          f"sharded train {arch}: loss {loss}, unsharded {loss_ref}")
    lr = float(cosine_schedule(1, run.learning_rate, warmup=warmup,
                               total=SHARDED_TOTAL))
    worst, off, total = step_diff(torch, dict(model.named_parameters()), ref,
                                  lr)
    check(worst <= ONE_RANK_TOL,
          f"sharded train {arch}: a parameter {worst} from the unsharded "
          f"step's ({off} of {total} past 1e-5)")
    emit("sharded_family_train", arch=arch, layers=cfg.n_layers,
         cut=f"{cfg.n_layers} of {full.n_layers} layers",
         mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)), loss=loss,
         loss_unsharded=loss_ref, loss_abs_diff=loss_diff,
         param_worst_abs_diff=worst, params_past_1e5=off, params=total,
         flash_launches=launches, unsharded_flash_launches=ref_launches,
         flash_checked=len(errs), flash_max_scaled_err=worst_flash,
         step_ms=ms, unsharded_step_ms=ref_ms,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    del model, opt, step, ref
    free(torch)
    return launches


def examples_phase(torch, dev):
    """Each ``examples/*_torch.py`` twin's ``main`` on the card
    (``EXAMPLES``): every census it prints equal to a ``"search"`` run on
    the same graph and summing to C(n, 3), census_csr launched; the greedy
    tokens of ``serve_decode_torch`` (qwen3-4b, full width) equal to a
    replay through ``make_serve_step``, one flash launch per layer a
    prefill.  Returns ``{twin: launches}`` (census_csr, or flash)."""
    import importlib.util

    import numpy as np

    from repro_torch.engine import EngineConfig, compile
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.triad_census import census_csr
    from repro_torch.models.transformer import init_cache
    from repro_torch.serve import make_prefill_cache_step, make_serve_step

    def search(g):
        return compile(g, ("triad_census",), EngineConfig(
            backend="search", device=dev)).run(g)["triad_census"].counts

    def exact(name, g, counts):
        counts = np.asarray(counts)
        check(np.array_equal(counts, search(g))
              and int(counts.sum()) == c3(g.n),
              f"{name}: census {counts.tolist()} != search or C(n, 3)")

    launches = {}
    for name, args in EXAMPLES.items():
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(ROOT, "examples", name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        census_csr.launches = flash_attention.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):  # the twins' prints
            out = mod.main([*args, "--device", str(dev)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if name == "serve_decode_torch":
            launches[name] = flash_attention.launches
            cfg, run, model = out["cfg"], out["run"], out["model"]
            B, P = out["prompts"].shape
            N = out["tokens"].shape[1]
            check(launches[name] == cfg.n_layers,
                  f"{name}: {launches[name]} flash launches")
            cache = init_cache(cfg, B, P + N, device=dev)
            logits, cache = make_prefill_cache_step(cfg, run)(
                model, out["prompts"], cache)
            tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            want = [tok]
            serve = make_serve_step(cfg, run)
            for i in range(N - 1):
                tok, cache, _ = serve(model, cache, tok, P + i)
                want.append(tok)
            check(torch.equal(out["tokens"], torch.cat(want, 1)),
                  f"{name}: greedy tokens differ from make_serve_step's")
            emit("examples", twin=name, seconds=seconds, arch=cfg.name,
                 layers=cfg.n_layers, d_model=cfg.d_model,
                 flash_launches=launches[name],
                 tokens=out["tokens"].shape[1])
            del out, model, cache, logits
            free(torch)
            continue
        launches[name] = census_csr.launches
        check(launches[name] > 0, f"{name}: no census_csr launch")
        if name == "census_service_fleet_torch":
            for rid, c in out["completions"].items():
                res = c.result
                res = res["triad_census"] if isinstance(res, dict) else res
                exact(name, out["fleet"][rid], res.counts)
            n = len(out["completions"])
        elif name == "multi_analytic_torch":
            exact(name, out["graph"], out["results"]["triad_census"].counts)
            n = out["graph"].n
        else:
            exact(name, out["graph"], out["census"].counts)
            n = out["graph"].n
        emit("examples", twin=name, seconds=seconds,
             census_csr_launches=launches[name],
             **({"requests": n} if "fleet" in name else {"n": n}))
        del out
        free(torch)
    return launches


def dryrun_phase(torch):
    """The launch dry runs on the host: ``census_dryrun`` for Slashdot and
    Patents at their published sizes on the ``{"data": 16, "model": 16}``
    shape (per-rank dyads, bytes and census_csr's bound), then the sweep
    of every (arch x shape x mesh shape) cell on the ``meta`` device, each
    with its seconds."""
    import shutil

    from repro_torch.launch import census_dryrun, sweep

    for name in ("slashdot", "patents"):
        rec = census_dryrun.run(name, scale_down=1.0)
        check(rec["status"] == "ok" and rec["ranks"]["n"] == 256
              and sum(rec["ranks"]["dyads"]) == rec["n_dyads"],
              f"census dry run {name}: {rec['status']}")
        b = rec["census_csr_bound"]
        emit("census_dryrun", dataset=name, mesh=rec["mesh"],
             n_dyads=rec["n_dyads"], max_deg=rec["max_deg"], K=rec["K"],
             chunk_l=rec["chunk_l"], imbalance=rec["imbalance"],
             lane_utilization=rec["lane_utilization"],
             rank_dyads_max=max(rec["ranks"]["dyads"]),
             rank_bytes_max=max(rec["ranks"]["bytes"]),
             census_csr_bound_ms=b["bound_s"] * 1e3,
             bound_by=b["bound_by"], graph_s=rec["graph_s"],
             seconds=rec["total_s"])
    out = os.path.join(ROOT, "build", "dryrun_torch")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        counts = sweep.main(["--out", out, "--force"])
    check(counts["fail"] == 0 and counts["ok"] + counts["skip"] == 80,
          f"dry-run sweep: {counts}")
    emit("dryrun_sweep", cells=counts["ok"] + counts["skip"],
         ok=counts["ok"], skip=counts["skip"],
         seconds=time.perf_counter() - t0)
    shutil.rmtree(out, ignore_errors=True)


def sharded_phases(torch, dev):
    """The sharded train and prefill, the elastic restore, then every
    family of ``SHARDED_SERVE`` (cacheless prefill, cache-writing prefill
    and decode) and ``SHARDED_TRAIN`` (one step) against the unsharded
    model (one-rank ``nccl`` group, (1, 1) mesh), the example twins and
    the dry runs, each phase's seconds emitted.  Returns (flash launches
    a sharded train step by arch, a sharded prefill by arch, a sharded
    decode step by arch, the twins' launches)."""
    seconds = {}
    t0 = time.perf_counter()
    with one_rank_group(torch):
        train_launches = {ARCH: sharded_train_phase(torch, dev)}
        seconds["sharded_train_and_elastic"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        prefill_launches = {ARCH: sharded_prefill_phase(torch, dev)}
        decode_launches = {}
        seconds["sharded_prefill"] = time.perf_counter() - t0
        for arch, spec in SHARDED_SERVE.items():
            t0 = time.perf_counter()
            got = sharded_serve_cell(torch, dev, arch, spec)
            prefill_launches[arch] = got["prefill"]
            decode_launches[arch] = got["decode"]
            seconds[f"sharded_serve_{arch}"] = time.perf_counter() - t0
        for arch, spec in SHARDED_TRAIN.items():
            t0 = time.perf_counter()
            train_launches[arch] = sharded_train_cell(torch, dev, arch, spec)
            seconds[f"sharded_train_{arch}"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    twins = examples_phase(torch, dev)
    seconds["examples"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dryrun_phase(torch)
    seconds["dryrun"] = time.perf_counter() - t0
    emit("sharded_phases_seconds", **seconds)
    return train_launches, prefill_launches, decode_launches, twins


def amazon_phase(torch, dev, rates):
    """The census main path on the Amazon stand-in at its published size:
    cold and warm, against ``"search"`` and C(n, 3), and the CSR kernel
    against its plain version on the first and last chunk of each bucket.
    The six-tile route is not run: its tiles would be ~1.2 TB per run."""
    import numpy as np

    from repro_torch.core import generators
    from repro_torch.engine import EngineConfig, clear_plan_cache, compile
    from repro_torch.engine.backends import tiles_stream
    from repro_torch.kernels.triad_census import census_csr, census_tiles

    t0 = time.perf_counter()
    g = generators.paper_profile("amazon", scale_down=1.0, seed=0,
                                 device=dev)
    emit("graph", name="amazon", n=g.n, arcs=g.m, dyads=g.n_dyads,
         max_deg=g.max_deg, seconds=time.perf_counter() - t0)
    cfg = EngineConfig(backend="tiles", device=dev)
    clear_plan_cache()
    torch.cuda.synchronize()
    census_csr.launches = census_tiles.launches = 0
    t0 = time.perf_counter()
    plan = compile(g, ("triad_census",), cfg)
    raw_cold = plan.run_raw(g)
    cold_s = time.perf_counter() - t0
    check(census_csr.launches == plan.stats["chunks"] > 0
          and census_tiles.launches == 0,
          f"amazon cold run: {census_csr.launches} csr launches, "
          f"{census_tiles.launches} tile launches, {plan.stats}")
    torch.cuda.reset_peak_memory_stats()
    census_csr.launches = 0
    chunks0 = plan.stats["chunks"]
    t0 = time.perf_counter()
    raw_warm = plan.run_raw(g)
    warm_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches, chunks = census_csr.launches, plan.stats["chunks"] - chunks0
    check(launches == chunks > 0 and census_tiles.launches == 0
          and plan.stats["host_syncs"] == 2,
          f"amazon warm run: {launches} launches, {chunks} chunks, "
          f"{plan.stats}")

    split = device_split(torch, lambda: plan.run_raw(g))
    emit("amazon_profile", **split, census_csr_ms=sum(
        t["ms"] for t in split["top"] if "census_csr" in t["kernel"]))

    torch.cuda.reset_peak_memory_stats()
    splan = compile(g, ("triad_census",),
                    EngineConfig(backend="search", device=dev))
    t0 = time.perf_counter()
    raw_search = splan.run_raw(g)
    search_s = time.perf_counter() - t0
    search_peak = torch.cuda.max_memory_allocated()
    check(np.array_equal(raw_cold, raw_warm), "amazon cold != warm")
    check(np.array_equal(raw_warm, raw_search),
          f"amazon tiles {raw_warm.tolist()} != search "
          f"{raw_search.tolist()}")
    result = plan.layout.finalize(raw_warm, g)["triad_census"]
    check(result.total == g.n * (g.n - 1) * (g.n - 2) // 6
          and (result.counts >= 0).all(), "amazon census != C(n, 3)")
    del splan

    st = tiles_stream(plan, g)
    ends = {}
    for task in st.tasks:
        ends.setdefault(task.key, []).append(task)
    picked = [t for ts in ends.values() for t in dict.fromkeys((ts[0], ts[-1]))]
    csr_kernel_phase(torch, g, st, picked, rates, "amazon")
    emit("amazon", backend="tiles", cold_s=cold_s, warm_s=warm_s,
         warm_dyads_per_s=g.n_dyads / warm_s, launches=launches,
         chunks=chunks, host_syncs_per_run=1, max_memory_allocated=peak,
         search_s=search_s, search_max_memory_allocated=search_peak,
         bit_identical_to_search=True, checked_chunks=len(picked),
         counts=result.counts.tolist())
    faults_clean("amazon")
    del st
    dynamic_launches = dynamic_phase(torch, dev, "amazon", g, plan, raw_warm)
    faults_clean("amazon_dynamic")
    del g, plan
    torch.cuda.empty_cache()
    return dynamic_launches


# the fused analytics of the fused phase, and the fleet's two-op requests
FUSED_OPS = ("triad_census", "dyad_census", "degree_stats", "triadic_profile")
FLEET_OPS = ("triad_census", "degree_stats")
FOOTPRINTS = (4, 64, 1024)  # arcs removed and added per delta


def c3(n):
    return n * (n - 1) * (n - 2) // 6


def dyad_identity(g, counts):
    """The triad census tied to the dyad census counted on the host from
    ``g``'s arcs: every dyad lies in ``n - 2`` triads, so for each dyad
    kind (mutual, asymmetric, null) the sum over triad types of (dyads of
    that kind in the type, the digits of its MAN name) x count equals
    that kind's dyad count x (n - 2).  The mutual and asymmetric sums
    read bins 012..300 only, the null sum bin 003 too, so a wrong bin
    anywhere breaks one of them; together they give Σ counts = C(n, 3).  Returns ``{kind: (census side, dyad
    side)}`` as exact ints, and the host's M + A (the canonical dyads).
    Types with the same MAN digits (021D/U/C, 111D/U, 030T/C, 120D/U/C)
    are not told apart: a count moved between two of them passes."""
    import numpy as np

    from repro_torch.core import TRIAD_NAMES
    from repro_torch.core.graph import arcs_host

    src, dst = arcs_host(g)
    keys = np.sort(src * g.n + dst)
    rev = dst * g.n + src
    del src, dst
    at = np.searchsorted(keys, rev).clip(max=len(keys) - 1)
    mutual_arcs = int(np.count_nonzero(keys[at] == rev))
    del keys, rev, at
    m_dyads = mutual_arcs // 2
    a_dyads = g.m - mutual_arcs
    dyads = dict(M=m_dyads, A=a_dyads,
                 N=g.n * (g.n - 1) // 2 - m_dyads - a_dyads)
    counts = [int(c) for c in counts]
    return {kind: (sum(int(name[i]) * c
                       for name, c in zip(TRIAD_NAMES, counts)),
                   dyads[kind] * (g.n - 2))
            for i, kind in enumerate("MAN")}, m_dyads + a_dyads


def warm_times(torch, fns, reps):
    """Host-clock seconds of each of ``fns`` (every call ends in a copy to
    the host), run in turns ``reps`` times; returns one list per fn."""
    out = [[] for _ in fns]
    for _ in range(reps):
        for times, fn in zip(out, fns):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return out


def host_dyad_census(g):
    """The dyad census of ``g`` from its arc list: an arc is mutual when
    its reverse is an arc too (keys ``src * n + dst``)."""
    import numpy as np

    from repro_torch.core.graph import arcs_host

    src, dst = arcs_host(g)
    key = src * g.n + dst
    mutual_arcs = int(np.isin(dst * g.n + src, key).sum())
    mutual, asym = mutual_arcs // 2, g.m - mutual_arcs
    return mutual, asym, g.n * (g.n - 1) // 2 - mutual - asym


def labelled_plan(plan):
    """A fresh copy of ``plan`` (outside the plan cache) whose member
    probes, once contribution and stream set-up run under
    ``torch.profiler.record_function`` labels, and the undo.  (The census
    kernel is launched through ctypes, not a torch op, so the profiler
    puts it under no label: it is found by its kernel name.)"""
    from torch.profiler import record_function

    from repro_torch.engine import backends
    from repro_torch.engine.ops import OpLayout
    from repro_torch.engine.plan import Plan

    def label(name, fn):
        def wrapped(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return wrapped

    saved = (backends.tiles_stream, OpLayout.batch_kernel,
             OpLayout.once_kernel)
    backends.tiles_stream = label("group:stream", saved[0])
    OpLayout.batch_kernel = lambda self, **kw: label(
        "group:member_probes", saved[1](self, **kw))
    OpLayout.once_kernel = lambda self: label("group:once", saved[2](self))
    labelled = Plan(plan.meta, plan.ops, plan.config, plan.backend,
                    plan.device)

    def undo():
        (backends.tiles_stream, OpLayout.batch_kernel,
         OpLayout.once_kernel) = saved

    return labelled, undo


def group_split(torch, fn):
    """One run of ``fn`` under torch.profiler: device time of each
    ``group:`` label and of the census kernels, the rest of the device
    time (the per-chunk fold and the fetch), and the device's idle
    share."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    # a label's device-side span is a user annotation, not a kernel: the
    # kernels under a label are summed on its host-side event
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == cuda and not e.is_user_annotation) / 1e3
    groups = {e.key[6:]: e.device_time_total / 1e3 for e in events
              if e.key.startswith("group:") and e.device_type == cpu}
    groups["census_csr"] = sum(
        e.self_device_time_total for e in events if e.device_type == cuda
        and not e.is_user_annotation and "census_csr" in e.key) / 1e3
    launches = sum(e.count for e in events
                   if e.device_type == cuda and not e.is_user_annotation)
    return dict(wall_ms=wall_ms, device_busy_ms=busy,
                device_idle_share=1 - busy / wall_ms,
                kernel_launches=launches, groups_ms=groups,
                fold_and_rest_ms=busy - sum(groups.values()))


def fused_phase(torch, dev, g):
    """Four ops in one tiles pass on Slashdot: cold and warm against the
    census-only plan, every op against its check, the raw vector against
    ``"search"``, one CSR launch per chunk and one copy per run; a plan
    without the census launches no census kernel and builds no flags; a
    profiled warm run's device time by group."""
    import numpy as np

    from repro_torch.engine import EngineConfig, compile, get_op
    from repro_torch.engine import plan as tplan
    from repro_torch.engine.backends import tiles_stream
    from repro_torch.kernels.triad_census import census_csr

    cfg = EngineConfig(backend="tiles", device=dev)
    census = compile(g, ("triad_census",), cfg)
    raw_census = census.run_raw(g)
    census_chunks = census.stats["chunks"] // census.stats["runs"]
    # the census alone launches once per bucket; the fused plan's other
    # per-dyad kernels keep it on fixed-size chunks
    check(census_chunks == len(tiles_stream(census, g).tasks)
          and census.stats["bucket_passes"] == census.stats["runs"],
          f"census-only plan: {census_chunks} chunks, {census.stats}")
    census_csr.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = compile(g, FUSED_OPS, cfg)
    raw_cold = plan.run_raw(g)
    cold_s = time.perf_counter() - t0
    launches = census_csr.launches
    check(launches == plan.stats["chunks"]
          == len(tiles_stream(plan, g).tasks) > census_chunks
          and plan.stats["bucket_passes"] == 0
          and plan.stats["host_syncs"] == 1,
          f"fused cold run: {launches} launches, {plan.stats}, census "
          f"plan {census_chunks} chunks")
    raws = []
    census_s, fused_s = warm_times(torch, [
        lambda: census.run_raw(g), lambda: raws.append(plan.run_raw(g))], 3)
    check(plan.stats["host_syncs"] == plan.stats["runs"] == 4
          and census_csr.launches == 4 * launches + 3 * census_chunks,
          f"fused warm runs: {plan.stats}, {census_csr.launches} launches")
    check(all(np.array_equal(r, raw_cold) for r in raws), "fused cold != warm")
    lay = plan.layout
    res = lay.finalize(raw_cold, g)
    check(np.array_equal(raw_cold[lay.slices["triad_census"]], raw_census),
          "fused census bins != census-only bins")
    check(res["triadic_profile"]
          == get_op("triadic_profile").finalize(raw_census, g),
          "triadic_profile disagrees with the census bins")
    check(tuple(res["dyad_census"]) == host_dyad_census(g),
          f"dyad census {res['dyad_census']} != {host_dyad_census(g)}")
    want = get_op("degree_stats").reference(g)
    check(all(np.array_equal(a, b) for a, b in zip(res["degree_stats"], want)),
          f"degree stats {res['degree_stats']} != {want}")
    t0 = time.perf_counter()
    raw_search = compile(g, FUSED_OPS, EngineConfig(
        backend="search", device=dev)).run_raw(g)
    search_s = time.perf_counter() - t0
    check(np.array_equal(raw_search, raw_cold),
          f"fused tiles {raw_cold.tolist()} != search {raw_search.tolist()}")

    flags = []
    build_flags = tplan.build_arc_flags_device

    def counted_flags(*args, **kwargs):
        flags.append(1)
        return build_flags(*args, **kwargs)

    tplan.build_arc_flags_device = counted_flags
    try:
        census_csr.launches = 0
        rest = compile(g, ("dyad_census", "degree_stats"), cfg)
        raw_rest = rest.run_raw(g)
    finally:
        tplan.build_arc_flags_device = build_flags
    check(census_csr.launches == 0 and not flags
          and np.array_equal(raw_rest, raw_cold[16:]),
          f"census-free plan: {census_csr.launches} census launches, "
          f"{len(flags)} flag builds")
    rest_s = warm_times(torch, [lambda: rest.run_raw(g)], 2)[0]

    labelled, undo = labelled_plan(plan)
    try:
        labelled.run_raw(g)
        profiled = []
        split = group_split(torch, lambda: profiled.append(
            labelled.run_raw(g)))
    finally:
        undo()
    check(np.array_equal(profiled[0], raw_cold), "profiled fused run")
    emit("fused", graph="slashdot", ops=list(FUSED_OPS), cold_s=cold_s,
         warm_s=fused_s, census_warm_s=census_s,
         warm_over_census=float(np.median(fused_s) / np.median(census_s)),
         census_free_warm_s=rest_s, launches=launches,
         chunks=plan.stats["chunks"] // plan.stats["runs"],
         host_syncs_per_run=1, search_s=search_s,
         bit_identical_to_search=True, census_free_launches=0,
         census_free_flag_builds=0, dyad_census=list(res["dyad_census"]),
         triadic_profile=list(res["triadic_profile"]), **split)
    return launches


def fleet_phase(torch, dev):
    """The census service over two fleets, checked against single runs,
    ``"search"`` and C(n, 3); one copy per batch, one CSR launch per
    chunk, input order from ``run_fleet``; a batch with a poisoned member
    completes its 7 peers.  Returns each timed fleet's census_csr
    launches."""
    import numpy as np

    from repro_torch.core import generators
    from repro_torch.engine import (EngineConfig, InjectedFault, compile,
                                    poison, unpoison)
    from repro_torch.kernels.triad_census import census_csr
    from repro_torch.serve import CensusService, ServiceConfig

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(8) as pool:  # numpy sorts
        rmats = list(pool.map(lambda s: generators.rmat(
            14, edge_factor=8, seed=s, device=dev), range(64)))
        ers = list(pool.map(lambda s: generators.erdos_renyi(
            16384, 131072, seed=s, device=dev), range(16)))
        eatsr = list(pool.map(lambda s: generators.paper_profile(
            "eatSR", scale_down=1.0, seed=s, device=dev), range(4)))
    mixed = rmats[:32] + ers + eatsr
    mixed = [mixed[i] for i in np.random.default_rng(0).permutation(
        len(mixed))]
    emit("fleet_graphs", seconds=time.perf_counter() - t0,
         rmat_dyads=[g.n_dyads for g in rmats[:4]],
         er_dyads=[g.n_dyads for g in ers[:4]],
         eatsr=dict(n=eatsr[0].n, dyads=eatsr[0].n_dyads,
                    max_deg=eatsr[0].max_deg))
    cfg = EngineConfig(backend="tiles", device=dev)
    scfg = ServiceConfig(max_batch=8, max_wait_requests=16, census=cfg)
    same_ops = [FLEET_OPS if i % 4 == 3 else ("triad_census",)
                for i in range(len(rmats))]
    launches = {}

    def drive(fleet, ops):
        """Submit the fleet, poll as it goes, flush; (completions by id,
        service, seconds)."""
        svc = CensusService(scfg)
        done = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if ops is None:
            out = svc.run_fleet(fleet)
            done = dict(enumerate(out))
        else:
            for g, o in zip(fleet, ops):
                svc.submit(g, o)
                done.update((c.request_id, c) for c in svc.poll())
            done.update((c.request_id, c) for c in svc.flush())
        return done, svc, time.perf_counter() - t0

    def census_of(result):
        return result["triad_census"] if isinstance(result, dict) else result

    for name, fleet, ops in (("same_bucket", rmats, same_ops),
                             ("mixed", mixed, None)):
        drive(fleet, ops)  # plans made, kernels warm
        census_csr.launches = 0
        done, svc, fleet_s = drive(fleet, ops)
        fleet_launches = launches[name] = census_csr.launches
        st = svc.stats()
        check(all(st["health"][k] == 0 for k in ENGINE_HEALTH),
              f"{name}: engine recoveries {st['health']}")
        chunks = sum(b["chunks"] for b in st["buckets"].values())
        check(fleet_launches == chunks > 0,
              f"{name}: {fleet_launches} census launches, {chunks} chunks")
        check(all(b["host_syncs"] == b["batches"]
                  for b in st["buckets"].values()),
              f"{name}: host syncs per batch {st['buckets']}")
        # the single-run baseline: one warm plan.run per request
        req_ops = ops or [("triad_census",)] * len(fleet)
        singles = []
        warm_times(torch, [lambda: singles.extend(
            compile(g, o, cfg).run(g) for g, o in zip(fleet, req_ops))], 1)
        singles.clear()
        census_csr.launches = 0
        single_s = warm_times(torch, [lambda: singles.extend(
            compile(g, o, cfg).run(g) for g, o in zip(fleet, req_ops))], 1)[0]
        searched = 0
        for i, (g, o, single) in enumerate(zip(fleet, req_ops, singles)):
            got = done[i] if ops is None else done[i].result
            if ops is not None:
                check(done[i].error is None and done[i].ops == o,
                      f"{name} request {i}: {done[i].error} {done[i].ops}")
                single = single if len(o) > 1 else single[o[0]]
            else:
                single = single["triad_census"]
            check(np.array_equal(census_of(got).counts,
                                 census_of(single).counts)
                  and census_of(got).total == c3(g.n),
                  f"{name} request {i}: census != single run or C(n, 3)")
            if isinstance(got, dict):
                check(all(np.array_equal(a, b) for a, b in zip(
                    got["degree_stats"], single["degree_stats"])),
                    f"{name} request {i}: degree stats != single run")
            if i % 8 == 0:
                search = compile(g, o, EngineConfig(
                    backend="search", device=dev)).run(g)
                check(np.array_equal(census_of(got).counts,
                                     search["triad_census"].counts),
                      f"{name} request {i}: tiles != search")
                searched += 1
        occ = [b["occupancy"] for b in st["buckets"].values()]
        emit("fleet", fleet=name, requests=len(fleet), seconds=fleet_s,
             requests_per_s=len(fleet) / fleet_s, batches=st["batches"],
             mean_batch=st["mean_batch"], mean_occupancy=float(np.mean(occ)),
             buckets=len(st["buckets"]),
             syncs_per_request=sum(b["host_syncs"] for b in
                                   st["buckets"].values()) / len(fleet),
             census_launches=fleet_launches, chunks=chunks,
             single_run_s=single_s[0],
             single_run_requests_per_s=len(fleet) / single_s[0],
             checked_against_search=searched, input_order=ops is None)

    # where a same-bucket fleet's time goes: its first 16 requests
    split = device_split(torch, lambda: drive(rmats[:16], same_ops[:16]))
    emit("fleet_profile", fleet="same_bucket", requests=16, **{
        k: split[k] for k in ("wall_ms", "device_busy_ms",
                              "device_idle_share", "kernel_launches")},
        census_csr_ms=sum(t["ms"] for t in split["top"]
                          if "census_csr" in t["kernel"]),
        top=split["top"][:6], host_top=split["host_top"][:6])

    # a batch with a poisoned member: its 7 peers complete
    bad = rmats[3]
    poison(bad)
    try:
        svc = CensusService(scfg)
        census_csr.launches = 0
        ids = [svc.submit(g) for g in rmats[:8]]
        done = {c.request_id: c for c in svc.poll() + svc.flush()}
    finally:
        unpoison(bad)
    st = svc.stats()
    check(sorted(done) == ids and isinstance(done[3].error, InjectedFault)
          and done[3].result is None, f"poisoned member: {done[3]}")
    for i in (0, 1, 2, 4, 5, 6, 7):
        check(done[i].error is None and np.array_equal(
            done[i].result.counts, compile(rmats[i], "triad_census",
                                           cfg).run(rmats[i])[
                "triad_census"].counts), f"poisoned batch peer {i}")
    health = st["health"]
    check(health["poisoned"] == 1 and health["batch_failures"] == 1,
          f"poisoned batch health {health}")
    emit("fleet_poisoned", batch=8, completed=7, failed=1,
         error=type(done[3].error).__name__, health=health)
    return launches


def footprint_delta(g, k, rng):
    """k existing arcs removed and k random arcs added."""
    import numpy as np

    from repro_torch.core.delta import GraphDelta
    from repro_torch.core.graph import arcs_host

    src, dst = arcs_host(g)
    sel = rng.choice(g.m, size=min(k, g.m), replace=False)
    return GraphDelta(edges_added=rng.integers(0, g.n, size=(k, 2)),
                      edges_removed=np.stack([src[sel], dst[sel]], 1))


def session_phase(torch, dev, g):
    """Deltas on Slashdot: ``apply_delta`` at each footprint (threshold
    1.0) against the full recompute on the card, timed apart from the
    host's rebuild; then a subscribed session streaming 8 mutations of
    k = 4 and one of k = 1024 at the default threshold.  Returns the
    census_csr launches of one delta application at each k, and of the
    whole stream."""
    import numpy as np

    from repro_torch.core.delta import affected_dyads, apply_delta_csr
    from repro_torch.engine import (EngineConfig, compile,
                                    delta_correction)
    from repro_torch.kernels.triad_census import census_csr
    from repro_torch.serve import CensusService, ServiceConfig

    cfg = EngineConfig(backend="tiles", device=dev, delta_threshold=1.0)
    plan = compile(g, ("triad_census",), cfg)
    raw = plan.run_raw(g)
    rng = np.random.default_rng(0)
    launches = {}
    for k in FOOTPRINTS:
        d = footprint_delta(g, k, rng)
        t0 = time.perf_counter()
        g_new = apply_delta_csr(g, d)
        rebuild_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        old, new = affected_dyads(g, d), affected_dyads(g_new, d)
        affected_s = time.perf_counter() - t0
        raw_new = plan.run_raw(g_new)
        census_csr.launches = 0
        chunks = plan.stats["chunks"]
        res = plan.apply_delta(g, d, raw)
        launches[f"k{k}"] = census_csr.launches
        check(res.mode == "delta", f"k={k}: mode {res.mode}")
        check(census_csr.launches == plan.stats["chunks"] - chunks > 0,
              f"k={k}: {census_csr.launches} launches in one application")
        check(np.array_equal(res.raw, raw_new),
              f"k={k}: delta {res.raw.tolist()} != full "
              f"{raw_new.tolist()}")
        check(np.array_equal(res.results["triad_census"].counts,
                             plan.run(g_new)["triad_census"].counts)
              and res.results["triad_census"].total == c3(g.n),
              f"k={k}: results != plan.run(g_new)")
        census_csr.launches = 0
        syncs, chunks = plan.stats["host_syncs"], plan.stats["chunks"]
        delta_s, full_s, corr_s = warm_times(torch, [
            lambda: plan.apply_delta(g, d, raw),
            lambda: plan.run_raw(g_new),
            lambda: delta_correction(plan, g, g_new, d, affected_old=old,
                                     affected_new=new)], 3)
        check(plan.stats["host_syncs"] - syncs == 9,
              f"k={k}: {plan.stats['host_syncs'] - syncs} syncs for 3 "
              "deltas, 3 full runs and 3 corrections")
        check(census_csr.launches == plan.stats["chunks"] - chunks,
              f"k={k}: {census_csr.launches} launches for "
              f"{plan.stats['chunks'] - chunks} chunks")
        emit("session_delta", graph="slashdot", k=k,
             launches=launches[f"k{k}"],
             touched=int(len(d.touched)), affected_old=int(len(old[0])),
             affected_new=int(len(new[0])),
             affected_fraction=res.affected_fraction, mode=res.mode,
             host_syncs_per_application=1, rebuild_host_s=rebuild_s,
             affected_host_s=affected_s, device_passes_s=corr_s,
             delta_s=delta_s, full_s=full_s,
             delta_over_full=float(np.median(delta_s) / np.median(full_s)),
             bit_identical_to_full=True)

    ops = ("triad_census", "dyad_census")
    scfg = EngineConfig(backend="tiles", device=dev)
    svc = CensusService(ServiceConfig(census=scfg))
    sid = svc.subscribe(g, ops)
    acks = []
    launches["stream"] = 0
    for k in (4,) * 8 + (1024,):
        d = footprint_delta(svc._sessions[sid].graph, k, rng)
        census_csr.launches = 0
        acks.append(svc.mutate(sid, d))
        launches["stream"] += census_csr.launches
        g_now = svc._sessions[sid].graph
        got = svc.poll(sid)
        want = compile(g_now, ops, scfg).run(g_now)
        check(np.array_equal(got["triad_census"].counts,
                             want["triad_census"].counts)
              and got["dyad_census"] == want["dyad_census"],
              f"session after {len(acks)} mutations != full recompute")
    counters = svc.stats()["sessions"][sid]
    health = svc.stats()["health"]
    check(all(health[k] == 0 for k in ENGINE_HEALTH),
          f"session: engine recoveries {health}")
    threshold = scfg.delta_threshold
    want_deltas = sum(a["affected_fraction"] <= threshold for a in acks)
    check(all(a["mode"] == "delta" for a in acks[:8])
          and counters["deltas"] == want_deltas
          and counters["fulls"] == len(acks) - want_deltas
          and all((a["mode"] == "delta") == (a["affected_fraction"]
                                             <= threshold) for a in acks),
          f"session split {counters} against {acks}")
    emit("session_stream", ops=list(ops), threshold=threshold,
         mutations=[dict(k=k, mode=a["mode"],
                         affected_fraction=a["affected_fraction"])
                    for k, a in zip((4,) * 8 + (1024,), acks)],
         deltas=counters["deltas"], fulls=counters["fulls"])
    svc.unsubscribe(sid)
    return launches


# -- the execution policy: the dynamic schedule, faults, reordering ----------

FAULT_COUNTERS = ("chunk_failures", "retries", "device_losses", "quarantines",
                  "backend_fallbacks", "schedule_fallbacks")
# the engine's recovery counters as the census service sums them
ENGINE_HEALTH = ("retries", "quarantines", "backend_fallbacks",
                 "schedule_fallbacks")
REORDERS = ("degree", "bfs", "rcm")


def faults_clean(phase):
    """Every cached plan ends a normal phase with all six fault counters at
    0 and no demotion: no path here ran without its kernel."""
    from repro_torch.engine import plan_cache_stats

    entries = plan_cache_stats()["entries"]
    dirty = [(e["ops"], e["backend"], e["faults"], e["degradation"])
             for e in entries if any(e["faults"][k] for k in FAULT_COUNTERS)
             or e["degradation"]]
    check(not dirty, f"{phase}: plans with faults or demotions {dirty}")
    emit("faults_clean", of=phase, plans=len(entries))


def dynamic_tasks(plan, g):
    """The dynamic schedule's tiles tasks of ``g``, derived on the host as
    the engine derives them."""
    from repro_torch.core.census import host_bucket_schedule
    from repro_torch.engine.backends import _bucket_tasks, tiles_geometry

    _, chunk, ks = tiles_geometry(plan)
    counts, need = host_bucket_schedule(g, ks, with_needs=True)
    return _bucket_tasks(ks, counts, chunk, need)


def dynamic_phase(torch, dev, name, g, static, raw_static):
    """``schedule="dynamic"`` on the one-card pool, census on tiles: bins
    equal to the static plan's, one copy and one census_csr launch per
    task a run; cold, and warm in turns with static; a profiled warm run.
    Returns the census_csr launches of one warm dynamic run."""
    import numpy as np

    from repro_torch.engine import EngineConfig, compile
    from repro_torch.kernels.triad_census import census_csr

    cfg = EngineConfig(backend="tiles", device=dev, schedule="dynamic")
    torch.cuda.synchronize()
    census_csr.launches = 0
    t0 = time.perf_counter()
    plan = compile(g, ("triad_census",), cfg)
    raw_cold = plan.run_raw(g)
    cold_s = time.perf_counter() - t0
    tasks = dynamic_tasks(plan, g)
    check(plan.executor.n_devices == 1
          and census_csr.launches == plan.stats["chunks"] == len(tasks)
          and plan.stats["host_syncs"] == 1
          and plan.stats["device_chunks"] == {0: len(tasks)},
          f"{name} dynamic cold: {census_csr.launches} launches, "
          f"{len(tasks)} tasks, {plan.stats}")
    check(np.array_equal(raw_cold, raw_static),
          f"{name} dynamic {raw_cold.tolist()} != static "
          f"{raw_static.tolist()}")
    census_csr.launches = 0
    static_s, dynamic_s = warm_times(torch, [lambda: static.run_raw(g),
                                             lambda: plan.run_raw(g)], 3)
    static_chunks = static.stats["chunks"] // static.stats["runs"]
    check(census_csr.launches == 3 * (len(tasks) + static_chunks)
          and plan.stats["host_syncs"] == 4,
          f"{name} warm: {census_csr.launches} launches, {plan.stats}")
    census_csr.launches = 0
    split = device_split(torch, lambda: plan.run_raw(g))
    launches = census_csr.launches
    check(launches == len(tasks), f"{name} profiled: {launches} launches")
    lengths = [t.end - t.start for t in tasks]
    per_bucket = {}
    for t in tasks:
        per_bucket[t.key] = per_bucket.get(t.key, 0) + 1
    emit("dynamic", graph=name, ops=["triad_census"], pool=1,
         tasks=len(tasks), static_chunks=static_chunks,
         tasks_per_bucket={str(k): c for k, c in per_bucket.items()},
         shortest_task=min(lengths), longest_task=max(lengths),
         launches=launches, host_syncs_per_run=1, cold_s=cold_s,
         warm_s=dynamic_s, static_warm_s=static_s,
         warm_over_static=float(np.median(dynamic_s) / np.median(static_s)),
         bit_identical_to_static=True, faults=plan.stats["faults"],
         degradation=plan.degradation, **{
             k: split[k] for k in ("wall_ms", "device_busy_ms",
                                   "device_idle_share", "kernel_launches")},
         census_csr_ms=sum(t["ms"] for t in split["top"]
                           if "census_csr" in t["kernel"]))
    return launches


def dynamic_fused_phase(torch, dev, g):
    """The four built-in ops in one dynamic tiles pass on Slashdot, against
    the static fused plan's bins.  Returns (tasks, the static raw bins)."""
    import numpy as np

    from repro_torch.engine import EngineConfig, compile
    from repro_torch.kernels.triad_census import census_csr

    static = compile(g, FUSED_OPS, EngineConfig(backend="tiles", device=dev))
    raw_static = static.run_raw(g)
    plan = compile(g, FUSED_OPS, EngineConfig(backend="tiles", device=dev,
                                              schedule="dynamic"))
    census_csr.launches = 0
    t0 = time.perf_counter()
    raw = plan.run_raw(g)
    cold_s = time.perf_counter() - t0
    tasks = len(dynamic_tasks(plan, g))
    check(census_csr.launches == plan.stats["chunks"] == tasks
          and plan.stats["host_syncs"] == 1,
          f"dynamic fused: {census_csr.launches} launches, {plan.stats}")
    check(np.array_equal(raw, raw_static),
          f"dynamic fused {raw.tolist()} != static {raw_static.tolist()}")
    emit("dynamic_fused", graph="slashdot", ops=list(FUSED_OPS), tasks=tasks,
         launches=census_csr.launches, cold_s=cold_s,
         bit_identical_to_static=True)
    return tasks, raw_static


def faults_phase(torch, dev, g, raw_clean):
    """Injected faults on Slashdot, tiles: recoverable chunk failures
    (static 8,192-dyad chunks, dynamic, and every bucket-wide task of
    the default plan failing once), the loss of the only pool device, the tiles
    runtime failure with and without the ``tiles -> search`` rung, and a
    16-request dynamic service.  Every recovered run is bit-equal to the
    clean one with one copy, every counter as the plan injected.  Returns
    the census_csr launches of the recovered runs."""
    import numpy as np

    from repro_torch.core import generators
    from repro_torch.engine import (ChunkRetryError, EngineConfig, FaultPlan,
                                    compile)
    from repro_torch.engine.backends import tiles_stream
    from repro_torch.kernels.triad_census import census_csr
    from repro_torch.serve import CensusService, ServiceConfig

    def run(fp, **kw):
        plan = compile(g, ("triad_census",), EngineConfig(
            backend="tiles", device=dev, fault_plan=fp, **kw))
        census_csr.launches = 0
        raw = plan.run_raw(g)
        check(np.array_equal(raw, raw_clean) and plan.stats["host_syncs"] == 1,
              f"faults {fp} {kw}: bins != clean or {plan.stats}")
        return plan, census_csr.launches

    launches = {}
    chaos = FaultPlan(seed=16, chunk_failure_rate=0.2, fail_attempts=1)
    # every bucket-wide task fails once: the default plan's retry unit is
    # a whole bucket, and four tasks rarely draw a 0.2 failure
    every = FaultPlan(seed=16, chunk_failure_rate=1.0, fail_attempts=1)
    for schedule, fp, kw in (("static", chaos, dict(chunk_dyads=8192)),
                             ("dynamic", chaos, dict(schedule="dynamic")),
                             ("bucket", every, {})):
        plan, n = run(fp, **kw)
        tasks = (dynamic_tasks(plan, g) if schedule == "dynamic"
                 else tiles_stream(plan, g).tasks)
        picked = sum(fp.chunk_fails(t.start, 1) for t in tasks)
        fs = plan.stats["faults"]
        check(picked > 0 and fs["retries"] == fs["chunk_failures"] == picked
              and n == len(tasks) == plan.stats["chunks"]
              and not plan.degradation
              and all(fs[k] == 0 for k in ("device_losses", "quarantines",
                                           "backend_fallbacks",
                                           "schedule_fallbacks")),
              f"chunk chaos {schedule}: {picked} picked, {n} launches, "
              f"{len(tasks)} tasks, {plan.stats}")
        launches[f"chunk_chaos_{schedule}"] = n
        emit("faults", graph="slashdot", case=f"chunk_chaos_{schedule}",
             fault_plan=dataclasses.asdict(fp), tasks=len(tasks),
             selected_chunks=picked, launches=n, host_syncs_per_run=1,
             bit_identical_to_clean=True, faults=fs,
             fault_events=len(plan.stats["fault_events"]),
             degradation=plan.degradation)

    lost = FaultPlan(seed=16, device_loss=(0,))
    plan, n = run(lost, schedule="dynamic")
    fs = plan.stats["faults"]
    check(fs["schedule_fallbacks"] == 1 and fs["device_losses"] == 1
          and fs["retries"] == 0 and not plan.degradation
          and n == plan.stats["chunks"] == len(dynamic_tasks(plan, g)),
          f"device loss: {n} launches, {plan.stats}")
    launches["device_loss"] = n
    emit("faults", graph="slashdot", case="device_loss_dynamic",
         fault_plan=dataclasses.asdict(lost), launches=n,
         host_syncs_per_run=1, bit_identical_to_clean=True, faults=fs,
         fault_events=plan.stats["fault_events"][:8],
         degradation=plan.degradation)

    broken = FaultPlan(runtime_failure=("tiles",))
    plan = compile(g, ("triad_census",), EngineConfig(
        backend="tiles", device=dev, fault_plan=broken))
    census_csr.launches = 0
    try:
        plan.run_raw(g)
        raised = None
    except ChunkRetryError as e:
        raised = type(e).__name__
    check(raised and plan.backend == "tiles" and not plan.degradation
          and census_csr.launches == 0
          and plan.stats["faults"]["backend_fallbacks"] == 0,
          f"runtime failure, default config: raised {raised}, {plan.stats}")
    emit("faults", graph="slashdot", case="runtime_failure_default",
         fault_plan=dataclasses.asdict(broken), raised=raised,
         faults=plan.stats["faults"], degradation=plan.degradation)
    t0 = time.perf_counter()
    plan, n = run(broken, backend_fallback=True)
    demoted_s = time.perf_counter() - t0
    census_csr.launches = 0
    again = plan.run_raw(g)
    fs = plan.stats["faults"]
    check(plan.backend == "search" and plan.requested_backend == "tiles"
          and [d["rung"] for d in plan.degradation] == ["tiles->search"]
          and plan.degradation[0]["stage"] == "runtime"
          and fs["backend_fallbacks"] == 1 and n == 0
          and census_csr.launches == 0 and np.array_equal(again, raw_clean),
          f"runtime rung: {n} / {census_csr.launches} launches, "
          f"{plan.degradation}, {plan.stats}")
    emit("faults", graph="slashdot", case="runtime_failure_fallback",
         fault_plan=dataclasses.asdict(broken), seconds=demoted_s,
         launches_after_demotion=0, bit_identical_to_clean=True, faults=fs,
         degradation=plan.degradation)

    # a dynamic service of 16 requests over 2 buckets under chunk chaos
    fleet = ([generators.rmat(12, edge_factor=8, seed=s, device=dev)
              for s in range(8)]
             + [generators.erdos_renyi(4096, 24000, seed=s, device=dev)
                for s in range(8)])
    cfg = EngineConfig(backend="tiles", device=dev, schedule="dynamic",
                       fault_plan=chaos)
    clean = EngineConfig(backend="tiles", device=dev)
    want_retries = 0
    for fg in fleet:
        want_retries += sum(chaos.chunk_fails(t.start, 1)
                            for t in dynamic_tasks(compile(fg, (
                                "triad_census",), cfg), fg))
    svc = CensusService(ServiceConfig(max_batch=16, max_wait_requests=64,
                                      census=cfg))
    census_csr.launches = 0
    ids = [svc.submit(fg) for fg in fleet]
    done = {c.request_id: c for c in svc.poll() + svc.flush()}
    service_launches = census_csr.launches
    st = svc.stats()
    health = st["health"]
    check(sorted(done) == ids and all(
        done[i].error is None and np.array_equal(
            done[i].result.counts,
            compile(fg, ("triad_census",), clean).run(fg)[
                "triad_census"].counts) for i, fg in zip(ids, fleet)),
        "faulty dynamic service: a completion != its clean run")
    check(len(st["buckets"]) == 2 and want_retries > 0
          and health["retries"] == want_retries
          and all(health[k] == 0 for k in (
              "quarantines", "backend_fallbacks", "schedule_fallbacks",
              "poisoned", "batch_failures", "group_failures"))
          and st["devices"] == {0: service_launches},
          f"faulty dynamic service: want {want_retries} retries, {st}")
    launches["service"] = service_launches
    emit("faults", graph="rmat12+er4096x24000", case="service_dynamic",
         requests=len(fleet), buckets=len(st["buckets"]),
         batches=st["batches"], launches=service_launches,
         devices=st["devices"], health=health,
         expected_retries=want_retries, bit_identical_to_clean=True)
    return launches


def reorder_phase(torch, dev, g, rates, raw_fused):
    """Slashdot under each reorder strategy: the four ops' bins equal to
    the unreordered run, the cold host relabeling and the warm census
    timed, census_csr held to its plain version and timed over every
    chunk of the relabeled stream; one ``apply_delta`` (k = 64) under
    ``rcm`` against the full recompute.  Returns the census_csr launches
    of one warm census run per strategy and of the delta."""
    import numpy as np

    from repro_torch.core.reorder import (compute_permutation,
                                          locality_score, permute_graph)
    from repro_torch.engine import EngineConfig, compile
    from repro_torch.engine.backends import tiles_stream
    from repro_torch.kernels.triad_census import census_csr

    base = compile(g, ("triad_census",),
                   EngineConfig(backend="tiles", device=dev))
    raw_census = base.run_raw(g)
    launches = {}
    for strategy in REORDERS:
        t0 = time.perf_counter()
        perm = compute_permutation(g, strategy)
        perm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        g_x = permute_graph(g, perm)
        relabel_s = time.perf_counter() - t0
        cfg = EngineConfig(backend="tiles", device=dev, reorder=strategy)
        fused = compile(g, FUSED_OPS, cfg)
        check(np.array_equal(fused.run_raw(g), raw_fused),
              f"{strategy}: fused bins != unreordered")
        plan = compile(g, ("triad_census",), cfg)
        raw = plan.run_raw(g)
        check(np.array_equal(raw, raw_census)
              and plan.stats["reorders"] == 1,
              f"{strategy}: census bins != unreordered, {plan.stats}")
        base_s, warm_s = warm_times(torch, [lambda: base.run_raw(g),
                                            lambda: plan.run_raw(g)], 3)
        check(plan.stats["reorders"] == 1 and plan.stats["host_syncs"] == 4,
              f"{strategy}: warm runs reordered again, {plan.stats}")
        # the launches of one warm run of the reordered plan alone
        st = tiles_stream(plan, g_x)
        chunks0 = plan.stats["chunks"]
        torch.cuda.synchronize()
        census_csr.launches = 0
        plan.run_raw(g)
        launches[strategy] = census_csr.launches
        check(launches[strategy] == len(st.tasks)
              == plan.stats["chunks"] - chunks0,
              f"{strategy}: {launches[strategy]} launches, "
              f"{len(st.tasks)} tasks, {plan.stats}")
        buckets = csr_kernel_phase(torch, g_x, st, st.tasks, rates,
                                   f"slashdot_{strategy}")
        emit("reorder", graph="slashdot", strategy=strategy,
             locality_score=locality_score(g_x),
             permutation_host_s=perm_s, relabel_host_s=relabel_s,
             warm_s=warm_s, unreordered_warm_s=base_s,
             launches=launches[strategy], chunks=len(st.tasks),
             census_csr_ms=sum(b["kernel_ms"] for b in buckets.values()),
             census_csr_bound_ms=sum(b["bound_ms"] for b in buckets.values()),
             census_csr_plain_ms=sum(b["plain_ms"] for b in buckets.values()),
             bit_identical_to_unreordered=True, ops=list(FUSED_OPS),
             faults=plan.stats["faults"], degradation=plan.degradation)
        del st, g_x
    emit("reorder_base", graph="slashdot", locality_score=locality_score(g))

    plan = compile(g, ("triad_census",), EngineConfig(
        backend="tiles", device=dev, reorder="rcm", delta_threshold=1.0))
    raw = plan.run_raw(g)
    d = footprint_delta(g, 64, np.random.default_rng(16))
    census_csr.launches = 0
    t0 = time.perf_counter()
    res = plan.apply_delta(g, d, raw)
    delta_s = time.perf_counter() - t0
    launches["delta_rcm_k64"] = census_csr.launches
    want = base.run_raw(res.graph)
    check(res.mode == "delta" and np.array_equal(res.raw, want)
          and np.array_equal(plan.run_raw(res.graph), want)
          and plan.stats["reorders"] == 1,
          f"rcm delta k=64: mode {res.mode}, {plan.stats}")
    emit("reorder_delta", graph="slashdot", strategy="rcm", k=64,
         mode=res.mode, affected_fraction=res.affected_fraction,
         launches=launches["delta_rcm_k64"], seconds=delta_s,
         reorders=plan.stats["reorders"], bit_identical_to_full=True)
    return launches


PARTITIONS = 8  # Slashdot's shards in the partition phase
PATENTS_PARTITIONS = 4
# the partition phase's runs: name -> EngineConfig fields beside partitions
PARTITION_RUNS = {
    "pool": {},
    "pool_dynamic": dict(schedule="dynamic"),
    "serial": dict(partition_mode="serial"),
    "serial_spill": dict(spill=True),
    "rcm": dict(reorder="rcm"),
}
# runs whose pool is widened to this many slots of the one card: the
# config clamps n_executor_devices to the card count, so the smoke sets
# the plan's executor pool itself
SHARED_SLOTS = {"pool_dynamic": 2}


def bucket_ends(tasks):
    """The first and last task of each bucket of a task list."""
    ends = {}
    for t in tasks:
        ends.setdefault(t.key, []).append(t)
    return [t for ts in ends.values() for t in dict.fromkeys((ts[0], ts[-1]))]


def shard_streams(plan, g):
    """Each non-empty shard of ``g`` as the engine stages it for ``plan``:
    ``(shard, TilesStream)`` with the shard's local arrays and flags, its
    bucket-sorted dyads and its tasks."""
    from repro_torch.core.partition import shard_dyads
    from repro_torch.engine import partition as tpart
    from repro_torch.engine.backends import (TilesStream, subset_schedule,
                                             tiles_geometry)

    part = tpart.plan_partition(plan, g)
    geom = tpart._Geometry(plan, g, part)
    block, chunk, _ = tiles_geometry(plan)
    for shard in part.shards:
        if shard.n_dyads:
            u, v, tasks = subset_schedule(
                plan, g, *shard_dyads(g, shard.lo, shard.hi))
            arrays, su, sv = tpart._host_ctx(plan, g, shard, geom, u, v,
                                             plan.device)
            yield shard, TilesStream(arrays, su, sv, tasks, chunk, block)


def shard_kernel_check(torch, plan, g, rates, label, ends_only):
    """census_csr against its plain version on every chunk of every shard
    (``ends_only``: the first and last chunk of each bucket of each
    shard), bit-equal, timed beside its bound.  Returns the totals."""
    out = dict(chunks=0, kernel_ms=0.0, plain_ms=0.0, bound_ms=0.0,
               max_abs_err=0)
    for shard, st in shard_streams(plan, g):
        tasks = bucket_ends(st.tasks) if ends_only else st.tasks
        buckets = csr_kernel_phase(torch, g, st, tasks, rates,
                                   f"{label}_shard{shard.index}")
        for b in buckets.values():
            out["chunks"] += b["chunks"]
            out["kernel_ms"] += b["kernel_ms"]
            out["plain_ms"] += b["plain_ms"]
            out["bound_ms"] += b["bound_ms"]
            out["max_abs_err"] = max(out["max_abs_err"], b["max_abs_err"])
        del st
    return out


def dispatch_s(ps):
    """The shards' dispatch intervals of a partitioned run, summed: on one
    slot, the part of its wall time not spent building, staging and
    sorting shards on the host."""
    return sum(t["end"] - t["start"] for t in ps["shard_times"].values())


def check_partition_run(plan, raw, want, launches, label, shards=None):
    """A partitioned run: bins equal to ``want``, launches equal to the
    shard tasks, one staging per shard it had to run (``shards``, the
    indices; by default every non-empty shard), no copy between devices
    on one card.  Returns the shard tasks."""
    import numpy as np

    ps = plan.stats["partition"]
    tasks = sum(t["tasks"] for t in ps["shard_times"].values())
    if shards is None:
        shards = [i for i, d in enumerate(ps["shard_dyads"]) if d]
    else:
        check(sorted(ps["shard_times"]) == list(shards),
              f"{label}: ran shards {sorted(ps['shard_times'])}, dealt "
              f"{list(shards)}")
    check(np.array_equal(raw, want),
          f"{label}: bins {raw.tolist()} != unpartitioned {want.tolist()}")
    check(launches == tasks > 0 and ps["h2d_puts"] == len(shards)
          and ps["d2d_puts"] == 0,
          f"{label}: {launches} launches, {tasks} shard tasks, "
          f"{ps['h2d_puts']} stagings of {len(shards)} shards, "
          f"{ps['d2d_puts']} device copies")
    return tasks


def partition_phase(torch, dev, g, rates, raw_fused):
    """Slashdot in P = 8 shards, the four ops, tiles: pool (one slot),
    pool under the dynamic schedule on two slots of the card, serial,
    serial with spill, and rcm relabeling, each bit-equal to the
    unpartitioned fused run with one copy and one census_csr launch per
    shard task, cold and warm in turns with it; census_csr against its
    plain version on every chunk of every shard; one apply_delta (k = 64)
    against the full recompute; then chunk faults.  Returns the
    census_csr launches of each path."""
    import numpy as np

    from repro_torch.engine import (EngineConfig, FaultPlan,
                                    clear_plan_cache, compile)
    from repro_torch.engine.executor import pool_devices
    from repro_torch.engine.partition import full_context_bytes
    from repro_torch.kernels.triad_census import census_csr

    clear_plan_cache()
    base = compile(g, FUSED_OPS, EngineConfig(backend="tiles", device=dev))
    check(np.array_equal(base.run_raw(g), raw_fused),
          "partition: unpartitioned fused bins moved")
    torch.cuda.reset_peak_memory_stats()
    base.run_raw(g)
    base_peak = torch.cuda.max_memory_allocated()
    launches = {}
    for name, kw in PARTITION_RUNS.items():
        cfg = EngineConfig(backend="tiles", device=dev,
                           partitions=PARTITIONS, **kw)
        torch.cuda.synchronize()
        census_csr.launches = 0
        t0 = time.perf_counter()
        plan = compile(g, FUSED_OPS, cfg)
        if name in SHARED_SLOTS:
            plan.executor.devices = pool_devices(plan.device,
                                                 SHARED_SLOTS[name])
        raw = plan.run_raw(g)
        cold_s = time.perf_counter() - t0
        check(plan.executor.n_devices == SHARED_SLOTS.get(name, 1),
              f"partition {name}: {plan.executor.n_devices} pool slots")
        check_partition_run(plan, raw, raw_fused, census_csr.launches,
                            f"partition {name} cold")
        base_s, warm_s = warm_times(torch, [lambda: base.run_raw(g),
                                            lambda: plan.run_raw(g)], 3)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        syncs0 = plan.stats["host_syncs"]
        census_csr.launches = 0
        raw = plan.run_raw(g)
        launches[name] = census_csr.launches
        peak = torch.cuda.max_memory_allocated()
        tasks = check_partition_run(plan, raw, raw_fused, launches[name],
                                    f"partition {name}")
        check(plan.stats["host_syncs"] == syncs0 + 1
              and plan.stats["host_syncs"] == 5,
              f"partition {name}: {plan.stats['host_syncs']} copies")
        ps = plan.stats["partition"]
        emit("partition", graph="slashdot", run=name, ops=list(FUSED_OPS),
             partitions=PARTITIONS, mode=ps["mode"],
             pool=plan.executor.n_devices, shard_tasks=tasks,
             launches=launches[name], cold_s=cold_s, warm_s=warm_s,
             unpartitioned_warm_s=base_s,
             warm_over_unpartitioned=float(np.median(warm_s)
                                           / np.median(base_s)),
             shard_dispatch_s=dispatch_s(ps), max_memory_allocated=peak,
             unpartitioned_max_memory_allocated=base_peak,
             shard_dyads=ps["shard_dyads"], halo_sizes=ps["halo_sizes"],
             h2d_puts=ps["h2d_puts"], d2d_puts=ps["d2d_puts"],
             max_shard_bytes=ps["max_shard_bytes"],
             full_context_bytes=full_context_bytes(plan, g),
             max_stage_bytes=ps["max_stage_bytes"],
             stream_bytes=ps["stream_bytes"], spill=ps["spill"],
             shard_overlap=ps["shard_overlap"], faults=plan.stats["faults"],
             host_syncs_per_run=1, bit_identical_to_unpartitioned=True)
        if name == "pool":
            kern = shard_kernel_check(torch, plan, g, rates, "slashdot_p8",
                                      ends_only=False)
            check(kern["chunks"] == tasks and kern["max_abs_err"] == 0,
                  f"partition kernel check: {kern}")
            emit("partition_kernel", graph="slashdot",
                 partitions=PARTITIONS, **kern)
        del plan

    plan = compile(g, FUSED_OPS, EngineConfig(
        backend="tiles", device=dev, partitions=PARTITIONS,
        delta_threshold=1.0))
    raw = plan.run_raw(g)
    d = footprint_delta(g, 64, np.random.default_rng(16))
    syncs0 = plan.stats["host_syncs"]
    torch.cuda.synchronize()
    census_csr.launches = 0
    t0 = time.perf_counter()
    res = plan.apply_delta(g, d, raw)
    delta_s = time.perf_counter() - t0
    launches["delta_k64"] = census_csr.launches
    want = base.run_raw(res.graph)
    shards = plan.stats["partition"]["delta_shards"]
    check(res.mode == "delta" and np.array_equal(res.raw, want)
          and plan.stats["host_syncs"] == syncs0 + 1
          and launches["delta_k64"] > 0 and 1 <= shards <= PARTITIONS,
          f"partition delta k=64: mode {res.mode}, {shards} shards, "
          f"{launches['delta_k64']} launches, {plan.stats}")
    emit("partition_delta", graph="slashdot", k=64, mode=res.mode,
         affected_fraction=res.affected_fraction, delta_shards=shards,
         launches=launches["delta_k64"], seconds=delta_s,
         bit_identical_to_full=True)
    del plan, res
    faults_clean("partition")

    plan = compile(g, FUSED_OPS, EngineConfig(
        backend="tiles", device=dev, partitions=PARTITIONS,
        fault_plan=FaultPlan(seed=16, chunk_failure_rate=0.2)))
    census_csr.launches = 0
    raw = plan.run_raw(g)
    launches["faults"] = census_csr.launches
    check_partition_run(plan, raw, raw_fused, launches["faults"],
                        "partition faults")
    fs = plan.stats["faults"]
    check(fs["retries"] == fs["chunk_failures"] > 0
          and plan.stats["host_syncs"] == 1 and not plan.degradation
          and not any(fs[k] for k in ("device_losses", "quarantines",
                                       "backend_fallbacks",
                                       "schedule_fallbacks")),
          f"partition faults: {fs}, {plan.degradation}")
    emit("partition_faults", graph="slashdot", partitions=PARTITIONS,
         launches=launches["faults"], faults=fs,
         bit_identical_to_unpartitioned=True)
    clear_plan_cache()
    return launches


def patents_phase(torch, dev, rates):
    """Patents at its published size, built once with ``from_edges_mmap``:
    unpartitioned on tiles, then P = 4 serial with spill and P = 4 pool,
    bins bit-equal and held to the host's dyad census (``dyad_identity``),
    one copy and one census_csr
    launch per task a run; census_csr against its plain version on the
    first and last chunk of each bucket of each shard.  Returns the
    census_csr launches of one warm run of each."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.core import generators
    from repro_torch.core.graph import from_edges_mmap
    from repro_torch.engine import EngineConfig, clear_plan_cache, compile
    from repro_torch.engine.partition import full_context_bytes, plan_partition
    from repro_torch.kernels.triad_census import census_csr

    scratch = tempfile.mkdtemp(prefix="chip-smoke-patents-")
    try:
        t0 = time.perf_counter()
        n, src, dst, directed = generators.paper_profile_arcs(
            "patents", scale_down=1.0, seed=0)
        g = from_edges_mmap(n, src, dst, directed=directed, dir=scratch)
        del src, dst
        emit("graph", name="patents", n=g.n, arcs=g.m, dyads=g.n_dyads,
             max_deg=g.max_deg, mmap=True,
             seconds=time.perf_counter() - t0)
        clear_plan_cache()
        torch.cuda.empty_cache()
        runs = (("tiles", {}),
                ("serial_spill", dict(partitions=PATENTS_PARTITIONS,
                                      spill=True)),
                ("pool", dict(partitions=PATENTS_PARTITIONS,
                              partition_mode="pool")))
        launches, want = {}, None
        for name, kw in runs:
            plan = compile(g, ("triad_census",),
                           EngineConfig(backend="tiles", device=dev, **kw))
            fields = {}
            if plan.partitions > 1:
                t0 = time.perf_counter()
                plan_partition(plan, g)
                fields["partition_host_s"] = time.perf_counter() - t0
            torch.cuda.synchronize()
            census_csr.launches = 0
            t0 = time.perf_counter()
            raw_cold = plan.run_raw(g)
            cold_s = time.perf_counter() - t0
            check(census_csr.launches == plan.stats["chunks"] > 0,
                  f"patents {name} cold: {census_csr.launches} launches, "
                  f"{plan.stats}")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            chunks0 = plan.stats["chunks"]
            census_csr.launches = 0
            t0 = time.perf_counter()
            raw = plan.run_raw(g)
            warm_s = time.perf_counter() - t0
            launches[name] = census_csr.launches
            peak = torch.cuda.max_memory_allocated()
            check(launches[name] == plan.stats["chunks"] - chunks0
                  and plan.stats["host_syncs"] == 2
                  and np.array_equal(raw, raw_cold),
                  f"patents {name} warm: {launches[name]} launches, "
                  f"{plan.stats}")
            if want is None:
                want = raw
                result = plan.layout.finalize(raw, g)["triad_census"]
                sums, dyads = dyad_identity(g, result.counts)
                check(all(a == b for a, b in sums.values())
                      and dyads == g.n_dyads
                      and (result.counts >= 0).all(),
                      f"patents census against its dyad census: {sums}, "
                      f"{dyads} host dyads, {g.n_dyads} engine dyads")
                fields["counts"] = result.counts.tolist()
                fields["dyad_identity"] = {k: str(a)
                                           for k, (a, _) in sums.items()}
            else:
                ps = plan.stats["partition"]
                check_partition_run(plan, raw, want, launches[name],
                                    f"patents {name}")
                fields.update(
                    mode=ps["mode"], shard_dispatch_s=dispatch_s(ps),
                    shard_dyads=ps["shard_dyads"],
                    halo_sizes=ps["halo_sizes"], h2d_puts=ps["h2d_puts"],
                    d2d_puts=ps["d2d_puts"],
                    max_shard_bytes=ps["max_shard_bytes"],
                    full_context_bytes=full_context_bytes(plan, g),
                    max_stage_bytes=ps["max_stage_bytes"],
                    stream_bytes=ps["stream_bytes"], spill=ps["spill"],
                    shard_overlap=ps["shard_overlap"],
                    bit_identical_to_unpartitioned=True)
            emit("patents", run=name, partitions=plan.partitions,
                 cold_s=cold_s, warm_s=warm_s,
                 warm_dyads_per_s=g.n_dyads / warm_s,
                 launches=launches[name], host_syncs_per_run=1,
                 max_memory_allocated=peak, faults=plan.stats["faults"],
                 **fields)
            if name == "pool":
                kern = shard_kernel_check(torch, plan, g, rates, "patents_p4",
                                          ends_only=True)
                check(kern["chunks"] > 0 and kern["max_abs_err"] == 0,
                      f"patents kernel check: {kern}")
                emit("patents_kernel", partitions=PATENTS_PARTITIONS, **kern)
            faults_clean(f"patents_{name}")
            del plan
            clear_plan_cache()
            torch.cuda.empty_cache()
        del g
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


# the distributed phase: (name, backend, ranks) of each spawn; every rank
# runs on the one card (NCCL refuses two ranks on one device, gloo shares)
DIST_RUNS = (("nccl_w1", "nccl", 1), ("gloo_w2", "gloo", 2))
DIST_TIMEOUT_S = 120  # the process group's bound on a stuck collective
DIST_FAULT = dict(seed=16, chunk_failure_rate=0.2, fail_attempts=1)
DIST_REPS = 3


def stats_now(plan):
    """This rank's all-reduces, and ``plan``'s copies and chunks so far."""
    from repro_torch.core.distributed import merge_over_mesh

    return dict(syncs=plan.stats["host_syncs"],
                merges=merge_over_mesh.collectives,
                chunks=plan.stats["chunks"])


def check_rank_run(plan, raw, want, launches, before, label, after=None):
    """One distributed run on this rank: bins equal ``want``, one merge and
    one copy (``before`` and ``after``, by default now: :func:`stats_now`
    around the run), and ``launches`` — census_csr's count, set to 0 just
    before the run and read just after — one per chunk the rank
    dispatched."""
    import numpy as np

    after = after or stats_now(plan)
    merges, syncs, chunks = (after[k] - before[k]
                             for k in ("merges", "syncs", "chunks"))
    check(np.array_equal(raw, want), f"{label}: distributed bins "
          f"{np.asarray(raw).tolist()} != {np.asarray(want).tolist()}")
    check(merges == 1 and syncs == 1,
          f"{label}: {merges} all-reduces and {syncs} host copies")
    check(launches == chunks > 0,
          f"{label}: {launches} census_csr launches for {chunks} chunks")


def rank_shards(plan, mesh):
    """The shards this rank of ``mesh`` has to run in ``plan``'s last
    partitioned run, from the shards' dyad counts: under ``"mesh"`` every
    W-th non-empty shard from the rank's own, under ``"serial"`` every
    shard of more than ``r`` dyads (a non-empty share ``r::W``)."""
    from repro_torch.core.distributed import mesh_rank, mesh_size

    ps = plan.stats["partition"]
    W, r = mesh_size(mesh), mesh_rank(mesh)
    nonempty = [i for i, d in enumerate(ps["shard_dyads"]) if d]
    if ps["mode"] == "mesh":
        return nonempty[r::W]
    return [i for i in nonempty if ps["shard_dyads"][i] > r]


def rank_census_phase(torch, dev, mesh, g, ops, rates, label):
    """One graph on this rank: the tiles plan and the distributed plan,
    cold, then warm in turns (each start aligned by a barrier); the
    distributed bins equal the tiles bins, one merge and one copy a run,
    launches equal to the rank's tasks; census_csr against its plain
    version on the first and last chunk of each bucket of the rank's row
    and its whole row timed.  Returns the warm run's launches."""
    import torch.distributed as dist

    from repro_torch.core.distributed import mesh_rank
    from repro_torch.engine import EngineConfig, compile
    from repro_torch.engine.backends import (TilesStream, _upload_dyads,
                                             chunk_dyads, rank_share,
                                             task_lanes, tiles_geometry)
    from repro_torch.kernels.triad_census import census_csr

    tiles = compile(g, ops, EngineConfig(backend="tiles", device=dev))
    plan = compile(g, ops, EngineConfig(backend="distributed", device=dev),
                   mesh=mesh)
    times = {"tiles": [], "distributed": []}
    want = launches = None
    for _ in range(1 + DIST_REPS):  # cold, then warm
        for name, p in (("tiles", tiles), ("distributed", plan)):
            before = stats_now(p)
            dist.barrier()
            census_csr.launches = 0
            t0 = time.perf_counter()
            raw = p.run_raw(g)
            times[name].append(time.perf_counter() - t0)
            if want is None:
                want = raw
            if name == "distributed":
                launches = census_csr.launches
                check_rank_run(p, raw, want, launches, before, label)
    u, v, tasks, stats = rank_share(plan, g)
    check(launches == len(tasks), f"{label}: {launches} launches for "
                                  f"{len(tasks)} rank tasks")
    block, chunk, _ = tiles_geometry(plan)
    arrays = plan.padded_arrays(g, with_flags=True)
    su, sv = _upload_dyads(plan, u, v)
    st = TilesStream(arrays, su, sv, tasks, chunk, block)
    checked = csr_kernel_phase(torch, g, st, bucket_ends(tasks), rates,
                               f"{label}_rank{mesh_rank(mesh)}")
    inputs = [chunk_dyads(su, sv, t, task_lanes(t, chunk, block))[:2]
              + (t.key,) for t in tasks]
    row_ms = event_ms(torch, lambda: [census_csr(
        cu, cv, g.n, arrays, k=k, block=block) for cu, cv, k in inputs],
        reps=DIST_REPS)
    emit("distributed_run", graph=label, ops=list(ops),
         rank=mesh_rank(mesh), ranks=int(mesh.size()), dyads=g.n_dyads,
         rank_dyads=len(u), rank_tasks=len(tasks), launches=launches,
         merges_per_run=1, host_syncs_per_run=1,
         imbalance=stats.imbalance, rank_weights=stats.weights.tolist(),
         cold_s=times["distributed"][0], tiles_cold_s=times["tiles"][0],
         warm_s=times["distributed"][1:], tiles_warm_s=times["tiles"][1:],
         row_kernel_ms=row_ms,
         checked_chunks=sum(b["chunks"] for b in checked.values()),
         max_abs_err=max(b["max_abs_err"] for b in checked.values()),
         equal_to_tiles=True)
    faults_clean(label)
    return launches


def rank_partition_phase(torch, dev, mesh, g, raw_fused, label):
    """Slashdot in ``PARTITIONS`` shards on the distributed backend, the
    four ops, ``"mesh"`` then ``"serial"``: bins equal to the
    unpartitioned run, one merge and one copy, the shards dealt to the
    rank (:func:`rank_shards`) each staged once, a launch per task of
    them; cold and warm.  Returns the launches per mode."""
    import torch.distributed as dist

    from repro_torch.core.distributed import mesh_rank
    from repro_torch.engine import EngineConfig, compile
    from repro_torch.kernels.triad_census import census_csr

    out = {}
    for mode in ("mesh", "serial"):
        plan = compile(g, FUSED_OPS, EngineConfig(
            backend="distributed", device=dev, partitions=PARTITIONS,
            partition_mode=mode), mesh=mesh)
        walls = []
        for _ in range(1 + DIST_REPS):
            before = stats_now(plan)
            dist.barrier()
            census_csr.launches = 0
            t0 = time.perf_counter()
            raw = plan.run_raw(g)
            walls.append(time.perf_counter() - t0)
            out[mode] = census_csr.launches
            check_rank_run(plan, raw, raw_fused, out[mode], before,
                           f"{label}_{mode}")
            check_partition_run(plan, raw, raw_fused, out[mode],
                                f"{label}_{mode}",
                                shards=rank_shards(plan, mesh))
        ps = plan.stats["partition"]
        emit("distributed_partition", graph=label, mode=mode,
             partitions=PARTITIONS, rank=mesh_rank(mesh),
             shards=sorted(ps["shard_times"]), launches=out[mode],
             h2d_puts=ps["h2d_puts"], cold_s=walls[0], warm_s=walls[1:],
             equal_to_unpartitioned=True)
        faults_clean(f"{label}_{mode}")
    return out


def rank_delta_fault_phase(torch, dev, mesh, g, rank, label):
    """A k = 64 delta on the distributed plan (four ops), equal to the
    full recompute on the card, one merge and one copy, a launch per task
    of the rank's share ``r::W`` of the affected dyads; then chunk faults
    injected on rank 1 only (``DIST_FAULT``), retried to the clean bins,
    ``retries`` equal to the rank's selected chunks, a launch per task of
    the rank's row.  Returns the launches of each."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch.core.delta import affected_dyads
    from repro_torch.core.distributed import mesh_size
    from repro_torch.engine import (EngineConfig, FaultPlan,
                                    clear_plan_cache, compile)
    from repro_torch.engine.backends import rank_share, subset_schedule
    from repro_torch.kernels.triad_census import census_csr

    clear_plan_cache()
    plan = compile(g, FUSED_OPS, EngineConfig(
        backend="distributed", device=dev, delta_threshold=1.0), mesh=mesh)
    raw = plan.run_raw(g)
    delta = footprint_delta(g, 64, np.random.default_rng(64))
    before = stats_now(plan)
    dist.barrier()
    census_csr.launches = 0
    t0 = time.perf_counter()
    res = plan.apply_delta(g, delta, raw)
    delta_s = time.perf_counter() - t0
    delta_launches = census_csr.launches
    after = stats_now(plan)
    check(res.mode == "delta", f"{label}: delta ran {res.mode}")
    full = compile(res.graph, FUSED_OPS, EngineConfig(
        backend="tiles", device=dev)).run_raw(res.graph)
    check_rank_run(plan, res.raw, full, delta_launches, before,
                   f"{label}_delta", after)
    W = mesh_size(mesh)
    share = sum(len(subset_schedule(plan, gg, u[rank::W], v[rank::W])[2])
                for gg, (u, v) in ((g, affected_dyads(g, delta)),
                                   (res.graph,
                                    affected_dyads(res.graph, delta))))
    check(delta_launches == share > 0, f"{label}_delta: {delta_launches} "
          f"launches for {share} tasks of the rank's affected dyads")
    emit("distributed_delta", graph=label, k=64, rank=rank,
         launches=delta_launches, seconds=delta_s, equal_to_full=True)
    faults_clean(f"{label}_delta")

    fault = FaultPlan(**DIST_FAULT) if rank == 1 else FaultPlan()
    plan = compile(g, FUSED_OPS, EngineConfig(
        backend="distributed", device=dev, fault_plan=fault), mesh=mesh)
    before = stats_now(plan)
    dist.barrier()
    census_csr.launches = 0
    raw_f = plan.run_raw(g)
    fault_launches = census_csr.launches
    tasks = rank_share(plan, g)[2]
    selected = sum(fault.chunk_fails(t.start, 1) for t in tasks)
    check(plan.stats["faults"]["retries"] == selected
          and (rank != 1 or selected > 0),
          f"{label}: {plan.stats['faults']} for {selected} selected chunks")
    # a failed attempt launches nothing: the fault fires before dispatch
    check_rank_run(plan, raw_f, raw, fault_launches, before,
                   f"{label}_faults")
    check(fault_launches == len(tasks), f"{label}_faults: {fault_launches} "
          f"launches for {len(tasks)} rank tasks")
    emit("distributed_faults", graph=label, rank=rank, selected=selected,
         retries=plan.stats["faults"]["retries"], launches=fault_launches,
         equal_to_clean=True)
    clear_plan_cache()
    return delta_launches, fault_launches


def expert_parallel_rank(torch, dev):
    """One granite MoE layer at full width (d 1536, 40 experts, top 8,
    d_ff 512) in bf16 through ``make_expert_parallel_moe`` on this
    process's one-rank ``("data", "model")`` mesh, against the port's
    ``moe_apply`` on the same weights and tokens (B 4 x 2048): scaled
    error < 2e-2, and 2 all-to-alls, 1 all-gather and 0 all-reduces
    issued by the layer (counted on ``torch.distributed`` itself and by
    the module)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.config import get_config
    from repro_torch.models import moe_expert_parallel as ep
    from repro_torch.models.moe import MoE, moe_apply

    cfg = get_config("granite-moe-3b-a800m")
    mesh = init_device_mesh(dev.type, (1, 1),
                            mesh_dim_names=("data", "model"))
    gen = torch.Generator(device=dev).manual_seed(4)
    moe = MoE(cfg).to(device=dev, dtype=torch.bfloat16).requires_grad_(False)
    for prm in moe.parameters():
        prm.copy_(torch.randn(prm.shape, generator=gen, device=dev,
                              dtype=torch.bfloat16)
                  / float(prm.shape[-2]) ** 0.5)
    x = torch.randn((4, 2048, cfg.d_model), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    p = {"moe/" + name: prm for name, prm in moe.named_parameters()}
    apply = ep.make_expert_parallel_moe(cfg, mesh)
    calls = dict.fromkeys(("all_to_all_single", "all_gather_into_tensor",
                           "all_reduce"), 0)
    originals = {name: getattr(dist, name) for name in calls}

    def counted(name):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return originals[name](*args, **kwargs)
        return wrapper

    module_before = dict(ep.COLLECTIVES)
    for name in calls:
        setattr(dist, name, counted(name))
    try:
        with torch.inference_mode():
            y = apply(p, "moe/", x)
            torch.cuda.synchronize()
    finally:
        for name, fn in originals.items():
            setattr(dist, name, fn)
    module = {k: ep.COLLECTIVES[k] - module_before.get(k, 0)
              for k in ("all_to_all", "all_gather")}
    with torch.inference_mode():
        want, _ = moe_apply(moe, x)
        ms = event_ms(torch, lambda: apply(p, "moe/", x), reps=5)
        flat_ms = event_ms(torch, lambda: moe_apply(moe, x), reps=5)
    err, scaled = kernel_err(y, want.float())
    check(scaled < 2e-2, f"expert-parallel layer vs moe_apply: scaled "
                         f"{scaled} (max abs {err})")
    check(calls == {"all_to_all_single": 2, "all_gather_into_tensor": 1,
                    "all_reduce": 0}
          and module == {"all_to_all": 2, "all_gather": 1},
          f"expert-parallel collectives: {calls}, module {module}")
    emit("expert_parallel", arch=cfg.name, mesh=dict(data=1, model=1),
         tokens=x.shape[0] * x.shape[1], max_abs_err=err,
         max_scaled_err=scaled, collectives=calls, ms=ms, moe_apply_ms=flat_ms)
    return calls


def distributed_rank(rank, world, backend, tmp, dev_name="cuda"):
    """One rank of a distributed phase spawn: every rank on the one card
    (device index 0), a ``backend`` process group of ``world`` ranks
    through a ``file://`` store in ``tmp``, its stdout to ``tmp``.  Runs
    Slashdot's four ops; with two ranks also Amazon's census, Slashdot in
    ``PARTITIONS`` shards, a delta and faults on rank 1."""
    import datetime

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    sys.stdout = open(os.path.join(tmp, f"rank{rank}.out"), "w",
                      buffering=1)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import generators
    from repro_torch.engine import EngineConfig, clear_plan_cache, compile

    dev = torch.device(dev_name)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(tmp, 'pg')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    try:
        mesh = init_device_mesh(dev.type, (world,))
        rates = json.loads(os.environ["CHIP_SMOKE_RATES"])
        label = f"{backend}_w{world}"
        launches = {}
        g = generators.paper_profile("slashdot", scale_down=1.0, seed=0,
                                     device=dev)
        launches["slashdot"] = rank_census_phase(
            torch, dev, mesh, g, FUSED_OPS, rates, f"slashdot_{label}")
        if world > 1:
            raw_fused = compile(g, FUSED_OPS, EngineConfig(
                backend="tiles", device=dev)).run_raw(g)
            clear_plan_cache()
            launches.update({f"p{PARTITIONS}_{k}": v for k, v in
                             rank_partition_phase(
                                 torch, dev, mesh, g, raw_fused,
                                 f"slashdot_{label}").items()})
            launches["delta"], launches["faults"] = rank_delta_fault_phase(
                torch, dev, mesh, g, rank, f"slashdot_{label}")
            del g
            clear_plan_cache()
            ga = generators.paper_profile("amazon", scale_down=1.0, seed=0,
                                          device=dev)
            launches["amazon"] = rank_census_phase(
                torch, dev, mesh, ga, ("triad_census",), rates,
                f"amazon_{label}")
        collectives = None
        if backend == "nccl":
            collectives = expert_parallel_rank(torch, dev)
        emit("distributed_rank_done", label=label, rank=rank,
             launches=launches, expert_parallel=collectives)
    finally:
        dist.destroy_process_group()
        sys.stdout.close()


def distributed_phase(torch, rates, rank_fn=distributed_rank,
                      dev_name="cuda"):
    """The distributed backend on the card: each of ``DIST_RUNS`` spawns
    its ranks (``spawn`` start method), each rank's JSON lines re-emitted
    with its rank; a rank's failure fails the phase.  Returns the
    census_csr launches of every rank's runs."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    os.environ["CHIP_SMOKE_RATES"] = json.dumps(rates)
    out = {}
    for name, backend, world in DIST_RUNS:
        tmp = tempfile.mkdtemp(prefix="chip-smoke-dist-")
        t0 = time.perf_counter()
        try:
            mp.spawn(rank_fn, args=(world, backend, tmp, dev_name),
                     nprocs=world, join=True)
            done = []
            for r in range(world):
                with open(os.path.join(tmp, f"rank{r}.out")) as f:
                    for line in f:
                        rec = json.loads(line)
                        print(json.dumps({**rec, "spawn": name,
                                          "rank": r}), flush=True)
                        if rec["phase"] == "distributed_rank_done":
                            done.append(rec["launches"])
                            check(backend != "nccl"
                                  or rec["expert_parallel"] is not None,
                                  f"{name}: no expert-parallel layer ran")
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        check(len(done) == world, f"{name}: {len(done)} of {world} ranks "
                                  "finished")
        out[name] = done
        emit("distributed_spawn", name=name, backend=backend, ranks=world,
             seconds=time.perf_counter() - t0)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    return run(torch.device("cuda"))


def run(dev) -> int:
    import numpy as np
    import torch

    from repro_torch.core import brute_force_census, generators
    from repro_torch.engine import EngineConfig, clear_plan_cache, compile
    from repro_torch.engine.backends import (chunk_tile_inputs,
                                             tiles_geometry, tiles_stream)
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ref import census_csr_ref, census_tiles_ref
    from repro_torch.kernels.triad_census import (SENTINEL, census_csr,
                                                  census_tiles)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # the card's peak rates for the census kernels' bounds
    rates = dict(bytes=HBM_BYTES_PER_S,
                 int32=sms * INT32_LANES_PER_SM * sm_mhz * 1e6)
    emit("card", name=kind, sms=sms, sm_mhz_max=sm_mhz, **rates)

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references stay f32
    torch.backends.cudnn.allow_tf32 = False

    # 1. build: one nvcc per kernel source, all started together ------------
    def timed_build(name):
        t0 = time.perf_counter()
        lib_path, log = _build.build(name)
        return lib_path, log, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        builds = dict(zip(KERNELS, pool.map(timed_build, KERNELS)))
    for name, (lib_path, log, build_s) in builds.items():
        ptxas = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln or "smem" in ln]
        emit("build", kernel=name, seconds=build_s,
             library=os.path.relpath(lib_path, ROOT), ptxas=ptxas, card=smi,
             torch=torch.__version__, cuda=torch.version.cuda)
    # the bf16 flash kernel keeps S, P and O in registers: no spills
    bf16_spills = {fn: sp for fn, sp in ptxas_spills(
        builds["flash_attention"][1]).items() if "flash_kernel_bf16" in fn}
    check(bf16_spills and not any(st or ld for st, ld in bf16_spills.values()),
          f"bf16 flash kernel spills or no ptxas report: {bf16_spills}")
    emit("build_spills", kernel="flash_attention", bf16=bf16_spills)

    # 2. kernel against its plain version, every chunk of the main path ------
    t0 = time.perf_counter()
    g = generators.paper_profile("slashdot", scale_down=1.0, seed=0,
                                 device=dev)
    gen_s = time.perf_counter() - t0
    emit("graph", name="slashdot", n=g.n, arcs=g.m, dyads=g.n_dyads,
         max_deg=g.max_deg, seconds=gen_s)
    cfg = EngineConfig(backend="tiles", device=dev)
    plan = compile(g, ("triad_census",), cfg)
    st = tiles_stream(plan, g)
    tile_arrays = plan.padded_arrays(g, with_in_csr=True)
    # the six-tile kernel chunk by chunk: the (D, K) tiles of the main
    # path's whole-bucket tasks would take gigabytes
    tile_st = tiles_stream(compile(g, ("triad_census",), dataclasses.replace(
        cfg, chunk_dyads=8192)), g)
    per_bucket: dict = {}
    max_err = 0
    for task in tile_st.tasks:
        u, v, tiles = chunk_tile_inputs(tile_arrays, tile_st.su, tile_st.sv,
                                        task, tile_st.chunk)
        got = census_tiles(u, v, g.n, *tiles, block=tile_st.block)
        want = census_tiles_ref(*tiles, u, v, g.n, block=tile_st.block)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        check(err == 0, f"kernel != plain at K={task.key}, dyad "
                        f"{task.start}: max abs err {err}")
        max_err = max(max_err, err)
        k_ms = event_ms(torch, lambda: census_tiles(
            u, v, g.n, *tiles, block=tile_st.block), reps=3)
        p_ms = event_ms(torch, lambda: census_tiles_ref(
            *tiles, u, v, g.n, block=tile_st.block), reps=1)
        prefix = int(sum(int((t != SENTINEL).sum()) for t in tiles))
        nbytes = (4 * prefix + 8 * tile_st.chunk
                  + 64 * (tile_st.chunk // tile_st.block))
        b = per_bucket.setdefault(task.key, dict(
            K=task.key, chunks=0, dyads=0, kernel_ms=0.0, plain_ms=0.0,
            bytes=0))
        b["chunks"] += 1
        b["dyads"] += min(task.end, task.start + tile_st.chunk) - task.start
        b["kernel_ms"] += k_ms
        b["plain_ms"] += p_ms
        b["bytes"] += nbytes
        del u, v, tiles, got, want
    for b in per_bucket.values():
        b["bound_ms"] = b["bytes"] / HBM_BYTES_PER_S * 1e3
        emit("kernel_bucket", **b)

    u, v, n_big, tiles = large_n_case(torch, dev)
    got = census_tiles(u, v, n_big, *tiles, block=32)
    want = census_tiles_ref(*tiles, u, v, n_big, block=32)
    check(torch.equal(got, want), "large-n case: kernel != plain version")
    bin012 = int(got.long().sum(0)[1])
    check(bin012 == BIN012_LARGE_N,
          f"large-n case: bin 012 = {bin012}, want {BIN012_LARGE_N}")
    emit("kernel_large_n", n=n_big, bin012=bin012, equal=True)
    del tile_arrays

    # 2b. the CSR kernel against its plain version, every chunk -------------
    csr_buckets = csr_kernel_phase(torch, g, st, st.tasks, rates, "slashdot")
    for extras in (False, True):
        n_big, a_big, u, v = large_n_csr_case(torch, dev, extras)
        got = census_csr(u, v, n_big, a_big, k=2, block=32)
        want = census_csr_ref(u, v, n_big, a_big, block=32)
        check(torch.equal(got, want),
              f"large-n CSR case (extras={extras}): kernel != plain version")
        bin012 = int(got.long().sum(0)[1])
        check(extras or bin012 == BIN012_LARGE_N,
              f"large-n CSR case: bin 012 = {bin012}, want {BIN012_LARGE_N}")
        emit("csr_kernel_large_n", n=n_big, extras=extras, bin012=bin012,
             equal=True)
    n_hub, a_hub, u, v = wide_hub_case(torch, dev)
    for k in (512, n_hub):  # both mappings
        got = census_csr(u, v, n_hub, a_hub, k=k, block=32)
        want = census_csr_ref(u, v, n_hub, a_hub, block=32)
        check(torch.equal(got, want),
              f"wide hub case, k={k}: kernel != plain version")
    emit("csr_kernel_wide_hub", n=n_hub, hub_degree=HUB_DEGREE,
         counts_shape=list(a_hub.nbr_cnt.shape), dyads=u.shape[0],
         equal=True)
    del a_big

    # 3. small graphs against the brute-force census --------------------------
    n_small = 0
    for scale in (6, 7, 8):
        for seed in (0, 1):
            gs = generators.rmat(scale, edge_factor=4, seed=seed, device=dev)
            want = brute_force_census(gs).counts
            for backend in ("tiles", "search"):
                for buckets in ((32, 128, 512), (8, 32, 128)):
                    res = compile(gs, ("triad_census",), EngineConfig(
                        backend=backend, buckets=buckets, device=dev)).run(gs)
                    got = res["triad_census"].counts
                    check(np.array_equal(got, want),
                          f"rmat({scale}, seed={seed}) {backend} {buckets}: "
                          f"{got.tolist()} != {want.tolist()}")
                    n_small += 1
    emit("small_graphs", runs=n_small, equal=True)
    faults_clean("small")

    # 4. the main path at full width ------------------------------------------
    clear_plan_cache()
    torch.cuda.synchronize()
    census_csr.launches = census_tiles.launches = 0
    t0 = time.perf_counter()
    plan = compile(g, ("triad_census",), cfg)
    raw_cold = plan.run_raw(g)
    cold_s = time.perf_counter() - t0
    cold_launches = census_csr.launches
    check(cold_launches == plan.stats["chunks"] > 0
          and census_tiles.launches == 0,
          f"cold run: {cold_launches} CSR launches for "
          f"{plan.stats['chunks']} chunks, {census_tiles.launches} six-tile")
    check(plan.stats["host_syncs"] == 1, f"cold run: {plan.stats}")

    torch.cuda.reset_peak_memory_stats()
    chunks0 = plan.stats["chunks"]
    census_csr.launches = census_tiles.launches = 0
    t0 = time.perf_counter()
    raw_warm = plan.run_raw(g)
    warm_s = time.perf_counter() - t0
    launches = census_csr.launches
    tile_launches = census_tiles.launches
    chunks = plan.stats["chunks"] - chunks0
    peak = torch.cuda.max_memory_allocated()
    ks = tiles_geometry(plan)[2]
    check(launches == chunks == len(st.tasks) > 0 and tile_launches == 0
          and len(st.tasks) <= len(ks)
          and plan.stats["bucket_passes"] == 2,
          f"warm run: {launches} CSR launches, {tile_launches} six-tile, "
          f"{chunks} chunks, {len(st.tasks)} tasks, {len(ks)} buckets, "
          f"{plan.stats}")
    check(plan.stats["host_syncs"] == 2, f"warm run: {plan.stats}")

    splan = compile(g, ("triad_census",),
                    EngineConfig(backend="search", device=dev))
    t0 = time.perf_counter()
    raw_search = splan.run_raw(g)
    search_s = time.perf_counter() - t0
    check(splan.stats["host_syncs"] == 1, f"search run: {splan.stats}")
    check(np.array_equal(raw_cold, raw_warm), "cold != warm")
    check(np.array_equal(raw_warm, raw_search),
          f"tiles {raw_warm.tolist()} != search {raw_search.tolist()}")
    result = plan.layout.finalize(raw_warm, g)["triad_census"]
    check(result.total == g.n * (g.n - 1) * (g.n - 2) // 6
          and (result.counts >= 0).all(), "census does not sum to C(n, 3)")
    emit("full", graph="slashdot", backend="tiles", cold_s=cold_s,
         warm_s=warm_s, warm_dyads_per_s=g.n_dyads / warm_s,
         launches=launches, six_tile_launches=tile_launches, chunks=chunks,
         host_syncs_per_run=1,
         candidate_lanes_per_run=sum(b["candidate_lanes"]
                                     for b in csr_buckets.values()),
         min_degree_sum_per_run=sum(b["min_degree_sum"]
                                    for b in csr_buckets.values()),
         compares_per_run=sum(b["compares"] for b in csr_buckets.values()),
         max_memory_allocated=peak,
         search_s=search_s, bit_identical_to_search=True,
         counts=result.counts.tolist())

    # where the warm run's time goes (kernels and host ops by name, idle
    # share), and no tile gather on the way
    gathers = []
    gather_rows = kops._gather_rows

    def counted_gather(*args, **kwargs):
        gathers.append(1)
        return gather_rows(*args, **kwargs)

    raws = []
    kops._gather_rows = counted_gather  # the six-tile gather's row op
    try:
        split = device_split(torch, lambda: raws.append(plan.run_raw(g)))
    finally:
        kops._gather_rows = gather_rows
    check(np.array_equal(raws[0], raw_warm), "profiled run != warm run")
    check(not gathers, f"the main path gathered {len(gathers)} tile rows")
    emit("profile", gather_rows_calls=len(gathers), **split)
    faults_clean("full")
    dynamic_launches = dict(slashdot=dynamic_phase(
        torch, dev, "slashdot", g, plan, raw_warm))

    csr_err = max(b["max_abs_err"] for b in csr_buckets.values())
    csr_row = dict(
        name="census_csr", route="cuda",
        source="src/repro_torch/kernels/csrc/census_csr.cu",
        replaces="src/repro/kernels/triad_census.py:36",
        launches=launches, max_abs_err=csr_err,
        ms=sum(b["kernel_ms"] for b in csr_buckets.values()),
        plain_ms=sum(b["plain_ms"] for b in csr_buckets.values()),
        bound_ms=sum(b["bound_ms"] for b in csr_buckets.values()),
        bound_by=("operations" if sum(b["op_ms"] for b in csr_buckets.values())
                  >= sum(b["byte_ms"] for b in csr_buckets.values())
                  else "bytes"),
        library_ms=None)
    census_row = dict(
        name="census_tiles", route="cuda",
        source="src/repro_torch/kernels/csrc/census_tiles.cu",
        replaces="src/repro/kernels/triad_census.py:36",
        launches=tile_launches, main_path_launches=tile_launches,
        checked_launches=len(tile_st.tasks), max_abs_err=max_err,
        ms=sum(b["kernel_ms"] for b in per_bucket.values()),
        plain_ms=sum(b["plain_ms"] for b in per_bucket.values()),
        bound_ms=sum(b["bound_ms"] for b in per_bucket.values()),
        bound_by="bytes", library_ms=None)
    del st, tile_st, plan, splan
    torch.cuda.empty_cache()

    # 4b. the main path on Amazon at its published size ----------------------
    dynamic_launches["amazon"] = amazon_phase(torch, dev, rates)

    # 4c.-4e. fused ops, fleet serving and deltas, through census_csr --------
    csr_row.update(fused_launches=fused_phase(torch, dev, g))
    faults_clean("fused")
    csr_row.update(fleet_launches=fleet_phase(torch, dev))
    faults_clean("fleet")
    csr_row.update(session_launches=session_phase(torch, dev, g))
    faults_clean("session")

    # 4f.-4h. the dynamic schedule, reordering, injected faults --------------
    dynamic_launches["fused_slashdot"], raw_fused = dynamic_fused_phase(
        torch, dev, g)
    faults_clean("dynamic")
    clear_plan_cache()
    reorder_launches = reorder_phase(torch, dev, g, rates, raw_fused)
    faults_clean("reorder")
    csr_row.update(dynamic_launches=dynamic_launches,
                   reorder_launches=reorder_launches,
                   faults_launches=faults_phase(torch, dev, g, raw_warm))
    clear_plan_cache()

    # 4i.-4j. graph partitions on Slashdot, then Patents at full size -------
    csr_row.update(partition_launches=partition_phase(torch, dev, g, rates,
                                                      raw_fused))
    del g
    torch.cuda.empty_cache()
    csr_row.update(patents_launches=patents_phase(torch, dev, rates))

    # 4k. the distributed backend: ranks in processes of their own ----------
    clear_plan_cache()
    torch.cuda.empty_cache()
    csr_row.update(distributed_launches=distributed_phase(torch, rates))

    # 5.-7. the flash kernel and the serving paths ----------------------------
    flash = flash_kernel_phase(torch, dev)
    served = serve_phase(torch, dev)
    serve_f32_phase(torch, dev)
    family_launches, family_err = serve_families_phase(torch, dev)
    serve_f32_families_phase(torch, dev)
    train_launches, train_err, train_grad = train_phase(torch, dev)

    # 8b. the sharded path, the example twins, the dry runs -----------------
    (sharded_launches, sharded_prefill_launches, sharded_decode_launches,
     twins) = sharded_phases(torch, dev)
    csr_row.update(examples_launches={
        k: v for k, v in twins.items() if k != "serve_decode_torch"})

    # 8. kernels line, result line --------------------------------------------
    flash_row = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:23",
        launches=served["launches"],
        max_abs_err=max(flash["max_abs_err"], served["max_abs_err"],
                        flash["mla"]["max_abs_err"], family_err, train_err),
        ms=flash["ms"], plain_ms=flash["plain_ms"],
        bound_ms=flash["bound_ms"], bound_by=flash["bound_by"],
        library_ms=flash["library_ms"],
        launches_per_prefill={ARCH: served["launches"], **family_launches},
        launches_per_train_step=train_launches, under_autograd=train_grad,
        launches_per_sharded_train_step=sharded_launches,
        launches_per_sharded_prefill=sharded_prefill_launches,
        launches_per_sharded_decode_step=sharded_decode_launches,
        launches_per_example_prefill={
            "serve_decode_torch": twins["serve_decode_torch"]},
        mla_d192=flash["mla"], window_d120=flash["window"])
    print(json.dumps({"kernels": [csr_row, census_row, flash_row]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
