"""Mean milliseconds per deploy() call in the window that the engine waited on its background reader for the next batch (the program's `deploy.wait` spans): the host reads the card cannot hide, most of them the first batch of a call."""

from port_bench.harness import program

LAYER = "deploy engine"
UNIT = "ms"
MOVES = "deploy_rtf"


def read(ctx, result):
    return program.program_span_ms_per(ctx, "deploy.wait", "calls")
