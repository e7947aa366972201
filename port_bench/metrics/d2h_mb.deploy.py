"""Megabytes (1e6 bytes) per call in the window that the deploy engine fetched from the card (the program's counter `deploy.d2h_bytes`: each batch's predictions, pad lanes included)."""

from port_bench.harness import program

LAYER = "deploy engine"
UNIT = "MB"
MOVES = "deploy_rtf"


def read(ctx, result):
    return program.program_count_per(ctx, "deploy.d2h_bytes", "calls", 1e-6)
