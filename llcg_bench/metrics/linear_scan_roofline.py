"""Per-layer metric linear_scan_roofline: the forward scan kernel's share
of its bound (``llcg_bench.bounds_lm.scan_work`` over the device time of
the kernels named ``linear_scan_kernel``), at float32's peak: the scan
computes in float32 whatever the configuration's precision."""
from llcg_bench.scan_roofline import share


def read(ctx):
    return share(ctx, "linear_scan_kernel", "linear_scan")
