"""The batched forward's least time at the published peaks of the precisions the configuration declares (operations counted over the reference forward at the cell's capacity at set-up), for every round of the window, over the window's time."""

from port_bench.harness import readers

LAYER = "serving"
UNIT = "%"
MOVES = "serve_tick_p95_ms"


def read(ctx, result):
    return readers.mfu_pct(ctx, "least_tick_s", "ticks")
