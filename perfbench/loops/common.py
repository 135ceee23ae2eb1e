"""Pieces that the traffic drivers share."""
from __future__ import annotations

import torch


def engine(traffic: dict, device):
    """The traffic's ``EngineConfig`` on ``device``."""
    from repro_torch.engine import EngineConfig

    return EngineConfig(**{**traffic.get("engine", {}),
                           "device": str(device)})


def launches() -> int:
    """``census_csr`` launches so far (the program's counter)."""
    from repro_torch.kernels.triad_census import census_csr

    return census_csr.launches


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def first_run(plan, g, device) -> None:
    """A plan's first run, waited for: builds or loads the kernel and
    fills the plan's memos."""
    plan.run_raw(g)
    sync(device)


def answer(c, k: int, ops: tuple) -> dict:
    """A service completion as an answer: ``{op: result}``, or None on
    error."""
    if c.error is not None:
        return {"graph": k, "result": None}
    res = c.result if len(ops) > 1 else {ops[0]: c.result}
    return {"graph": k, "result": dict(res)}
