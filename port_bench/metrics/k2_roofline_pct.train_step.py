"""K2's least time by its work, over its device time in the trace, in the train-step window."""

from port_bench.harness import readers

LAYER = "kernels"
UNIT = "%"
MOVES = "train_step_samples_per_s"


def read(ctx, result):
    return readers.kernel_roofline_pct(ctx, "masked_istft_bwd_kernel")
