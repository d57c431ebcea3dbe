"""Kernels: K3's four bf16 kernels, wherever the model's layers hold a
Mamba2 mixer: the scan's least time at the window's shape times its calls
(launches of ``ssd_chunk_scan_kernel``), over the four kernels' device
time, %."""
from harness import counts, readers

KERNELS = ["ssd_chunk_cb_kernel", "ssd_chunk_state_kernel", "ssd_state_pass_kernel",
           "ssd_chunk_scan_kernel"]


def read(ctx):
    m = ctx["model"]
    if "mamba" not in counts.mixers(m):
        return None
    bound = counts.ssd_call(*counts.ssd_shape(m, ctx["batch"], ctx["seq"]))
    return readers.roofline_pct(ctx, KERNELS, "ssd_chunk_scan_kernel", bound["bound_s"])
