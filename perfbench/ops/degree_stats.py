"""``degree_stats``: the out- and in-degree log2 histograms, maxima and
means, exact."""
import torch

from .. import reference

NUMBER, LIMIT = "stats_off", 0


def program_values(result) -> list:
    return ([int(x) for x in result.out_hist]
            + [int(x) for x in result.in_hist]
            + [int(result.max_out), int(result.max_in),
               float(result.mean_out), float(result.mean_in)])


def reference_values(n: int, src: torch.Tensor, dst: torch.Tensor,
                     acc=torch.int64) -> list:
    r = reference.degree_stats(n, src, dst)
    return (r["out_hist"] + r["in_hist"]
            + [r["max_out"], r["max_in"], r["mean_out"], r["mean_in"]])
