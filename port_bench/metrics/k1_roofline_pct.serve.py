"""K1's least time by its work, over its device time in the trace, in the serving window."""

from port_bench.harness import readers

LAYER = "kernels"
UNIT = "%"
MOVES = "serve_tick_p95_ms"


def read(ctx, result):
    return readers.kernel_roofline_pct(ctx, "masked_istft_fwd_kernel")
