"""``triad_census``: the 16 bins, exact."""
import torch

from .. import reference

NUMBER, LIMIT = "bins_off", 0


def program_values(result) -> list:
    return [int(x) for x in result.counts]


def reference_values(n: int, src: torch.Tensor, dst: torch.Tensor,
                     acc=torch.int64) -> list:
    return reference.census(n, src, dst, acc=acc)
