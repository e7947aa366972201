"""Megabytes (1e6 bytes) per round in the window that the stream batcher handed to the card (the program's counters `serve.h2d_bytes` over `serve.rounds`: each round's chunks, shift and valid masks and frames, and each new session's first window)."""

from port_bench.harness import program

LAYER = "serving"
UNIT = "MB"
MOVES = "serve_tick_p95_ms"


def read(ctx, result):
    return program.program_count_ratio(ctx, "serve.h2d_bytes", "serve.rounds", 1e-6)
