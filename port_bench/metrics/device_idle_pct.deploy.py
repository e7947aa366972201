"""Share of the deploy window in which no kernel or memory copy ran on the device (one minus the union of their intervals over the window)."""

from port_bench.harness import readers

LAYER = "device"
UNIT = "%"
MOVES = "deploy_rtf"


def read(ctx, result):
    return readers.device_idle_pct(ctx)
