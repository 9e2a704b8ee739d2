"""Per-layer metric linear_scan_bwd_roofline: the scan's gradient kernel's
share of its bound (``llcg_bench.bounds_lm.scan_bwd_work`` over the device
time of the kernels named ``linear_scan_bwd_kernel``), at float32's
peak."""
from llcg_bench.scan_roofline import share


def read(ctx):
    return share(ctx, "linear_scan_bwd_kernel", "linear_scan_bwd")
