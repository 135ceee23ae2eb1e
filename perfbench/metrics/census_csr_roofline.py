"""``census_csr_roofline``: the census's least time on the card
(:func:`perfbench.work.census_work`) summed over the graphs of the
traced window, over the device time of the kernels whose function name
starts with ``census_csr`` in that window, in percent."""
import re

KERNEL = re.compile(r"(^|[\s:])census_csr\w*\(")


def read(rec):
    t = rec.get("trace")
    if not t or not rec.get("traced_graphs"):
        return None
    kernel_s = sum(v for k, v in t["kernel_s"].items()
                   if KERNEL.search(k))
    if kernel_s <= 0:
        return None
    bound_s = sum(rec["bound_s"][i] for i in rec["traced_graphs"])
    return 100.0 * bound_s / kernel_s
