"""Kernels: K1 (``flash_fwd_bf16_kernel``), wherever the model's layers hold
an attention mixer: its least time at the window's shape times its launches
in the trace, over its device time, %."""
from harness import counts, readers


def read(ctx):
    m = ctx["model"]
    if "attn" not in counts.mixers(m):
        return None
    bound = counts.attention_call(*counts.attention_shape(m, ctx["batch"], ctx["seq"]))
    return readers.roofline_pct(ctx, ["flash_fwd_bf16_kernel"], "flash_fwd_bf16_kernel",
                                bound["bound_s"])
