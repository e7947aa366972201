"""Share of the serving window in which no kernel or memory copy ran on the device (one minus the union of their intervals over the window)."""

from port_bench.harness import readers

LAYER = "device"
UNIT = "%"
MOVES = "serve_tick_p95_ms"


def read(ctx, result):
    return readers.device_idle_pct(ctx)
