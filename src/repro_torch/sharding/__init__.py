"""Logical-axis sharding rules on a ``torch.distributed`` device mesh
(counterpart of :mod:`repro.sharding`)."""
from .rules import (Rules, batch_axes, constrain, logical_to_spec,
                    make_rules, placements)

__all__ = ["Rules", "batch_axes", "constrain", "logical_to_spec",
           "make_rules", "placements"]
