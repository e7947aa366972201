"""Mean milliseconds per round in the window of the batcher's host assembly (the program's `serve.assemble` and `serve.stage` spans): the emitting sessions' chunks and masks, and the frames staged in pinned memory."""

from port_bench.harness import program

LAYER = "serving"
UNIT = "ms"
MOVES = "serve_tick_p95_ms"


def read(ctx, result):
    return program.program_span_ms_per(ctx, ("serve.assemble", "serve.stage"), "ticks")
