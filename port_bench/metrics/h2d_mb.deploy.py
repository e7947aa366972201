"""Megabytes (1e6 bytes) per call in the window that the deploy engine handed to the card (the program's counter `deploy.h2d_bytes`: each batch's mono span, window offsets and frames)."""

from port_bench.harness import program

LAYER = "deploy engine"
UNIT = "MB"
MOVES = "deploy_rtf"


def read(ctx, result):
    return program.program_count_per(ctx, "deploy.h2d_bytes", "calls", 1e-6)
