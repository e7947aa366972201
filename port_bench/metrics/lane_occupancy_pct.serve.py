"""Share of the batched forward's lanes in the window that carried an emitting session (the program's counters: 100 * `serve.lanes_emitting` / (`serve.rounds` * the batcher's capacity)); the rest ran on zeros."""

from port_bench.harness import program

LAYER = "serving"
UNIT = "%"
MOVES = "serve_tick_p95_ms"


def read(ctx, result):
    share = program.program_count_ratio(ctx, "serve.lanes_emitting", "serve.rounds", 100.0)
    capacity = ctx.params.get("capacity") if share is not None else None
    return share / capacity if capacity else None
