"""Roofline terms on the port's card (counterpart of the formulas of
:mod:`repro.launch.roofline`).

Terms per (arch, mesh), with the peaks of one NVIDIA H100 80GB HBM3
(SXM, 700 W) in place of the TPU v5e constants:

    compute    = flops_per_card / 989e12       [dense bf16 tensor cores]
    memory     = bytes_per_card / 3.35e12      [HBM3]
    collective = collective_bytes_per_card / 450e9   [NVLink 4, one way]

The census kernel's compute term counts int32 compares instead
(:data:`INT32_OPS`).  JAX's ``parse_hlo``, ``analyze_hlo`` and
``analyze(compiled, ...)`` walk XLA's optimized HLO; the port compiles
no HLO, so its dry runs feed these terms with counts from the rule table
(:mod:`repro_torch.launch.dryrun`).
"""
from __future__ import annotations

#: NVIDIA H100 80GB HBM3 (SXM, 700 W): dense bf16 tensor-core peak, FLOP/s
PEAK_FLOPS = 989e12
#: NVIDIA H100 80GB HBM3: HBM3 rate, bytes/s
HBM_BW = 3.35e12
#: NVIDIA H100 80GB HBM3: NVLink 4, bytes/s a direction
NVLINK_BW = 450e9
#: NVIDIA H100 80GB HBM3: int32 results/s, 132 SMs x 64 lanes x 1,980 MHz
#: (the census kernel's compares)
INT32_OPS = 132 * 64 * 1980e6


def roofline_terms(flops: float, bytes_hbm: float, coll_bytes: float) -> dict:
    terms = {
        "compute_s": flops / PEAK_FLOPS,
        "memory_s": bytes_hbm / HBM_BW,
        "collective_s": coll_bytes / NVLINK_BW,
    }
    bottleneck = max(("compute_s", "memory_s", "collective_s"),
                     key=lambda k: terms[k])
    terms["bottleneck"] = bottleneck
    terms["step_s_lower_bound"] = terms[bottleneck]
    return terms


def model_flops(meta: dict) -> float:
    """MODEL_FLOPS: 6·N·D train, 2·N·D forward/prefill, 2·N·B decode."""
    n = meta["active_params"]
    if meta["kind"] == "train":
        return 6.0 * n * meta["global_batch"] * meta["seq_len"]
    if meta["kind"] == "prefill":
        return 2.0 * n * meta["global_batch"] * meta["seq_len"]
    return 2.0 * n * meta["global_batch"]  # decode: one token per request
