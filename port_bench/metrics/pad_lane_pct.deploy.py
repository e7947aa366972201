"""Share of the forward's lanes in the window that carried no window (the program's counters: 100 * (`deploy.lanes` - `deploy.windows`) / `deploy.lanes`): the pad lanes of each call's last batch."""

from port_bench.harness import program

LAYER = "deploy engine"
UNIT = "%"
MOVES = "deploy_rtf"


def read(ctx, result):
    trace = program.window_trace(ctx)
    if trace is None or not trace.counters.get("deploy.lanes"):
        return None
    lanes = trace.counters["deploy.lanes"]
    return 100.0 * (lanes - trace.counters.get("deploy.windows", 0)) / lanes
