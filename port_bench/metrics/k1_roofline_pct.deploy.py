"""K1's least time by its work, over its device time in the trace, in the deploy window."""

from port_bench.harness import readers

LAYER = "kernels"
UNIT = "%"
MOVES = "deploy_rtf"


def read(ctx, result):
    return readers.kernel_roofline_pct(ctx, "masked_istft_fwd_kernel")
