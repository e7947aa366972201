"""Mean milliseconds per round of the window that tick() spent outside its call into the batcher's _tick_fn: the host's assembly of windows and frames (the benchmark's spans around both)."""

from port_bench.harness import readers

LAYER = "serving"
UNIT = "ms"
MOVES = "serve_tick_p95_ms"


def read(ctx, result):
    return readers.span_outside_ms_per(ctx, "tick", "tick_fn", "ticks")
