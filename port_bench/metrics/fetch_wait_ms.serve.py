"""Mean milliseconds per round in the window that the batcher spent fetching the predictions to the host (the program's `serve.fetch` spans), which waits for the round's forward on the card."""

from port_bench.harness import program

LAYER = "serving"
UNIT = "ms"
MOVES = "serve_tick_p95_ms"


def read(ctx, result):
    return program.program_span_ms_per(ctx, "serve.fetch", "ticks")
