"""Share of the train-step window in which no kernel or memory copy ran on the device (one minus the union of their intervals over the window)."""

from port_bench.harness import readers

LAYER = "device"
UNIT = "%"
MOVES = "train_step_samples_per_s"


def read(ctx, result):
    return readers.device_idle_pct(ctx)
