"""Serving layers of the port: the batched multi-analytic graph service and
the LM stack's prefill and decode steps.

``CensusService`` (:mod:`repro_torch.serve.census_service`) is the graph
fleet front door: requests, each naming the GraphOp analytics it wants,
are grouped by (plan-cache bucket, ops) and run as fused batches through
``Plan.run_batch``, with admission control (:class:`AdmissionError`),
flush-round deadlines (:class:`DeadlineExceeded` completions), member-wise
isolation of poisoned graphs, subscribed sessions over evolving graphs
(rolled back on a failed mutation), a concurrent multi-group flush under
the dynamic executor schedule, and ``stats()["health"]`` / ``devices``
recovery and occupancy counters.
"""
from .census_service import (AdmissionError, CensusCompletion,
                             CensusService, DeadlineExceeded, ServiceConfig)
from .decode import make_prefill_cache_step, make_prefill_step, make_serve_step

__all__ = ["AdmissionError", "CensusCompletion", "CensusService",
           "DeadlineExceeded", "ServiceConfig", "make_prefill_cache_step",
           "make_prefill_step", "make_serve_step"]
