"""Mean milliseconds per round in the window that the sessions' push() calls took (the program's `serve.push` spans): buffering each session's chunk and frame, inside the latency measured from the due time."""

from port_bench.harness import program

LAYER = "serving"
UNIT = "ms"
MOVES = "serve_tick_p95_ms"


def read(ctx, result):
    return program.program_span_ms_per(ctx, "serve.push", "ticks")
