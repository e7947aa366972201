"""The bf16 train step's least time at the published peaks of the precisions the configuration declares (operations counted over the reference step at set-up), over the measured time per step."""

from port_bench.harness import readers

LAYER = "train step and model"
UNIT = "%"
MOVES = "train_step_bf16_samples_per_s"


def read(ctx, result):
    return readers.mfu_pct(ctx, "least_step_s", "steps")
