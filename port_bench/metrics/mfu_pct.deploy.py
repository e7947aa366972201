"""The deploy forward's least time at the published peaks of the precisions the configuration declares (operations counted over the reference forward at set-up), for every real window of the window's calls (pad lanes of a call's last batch are not charged), over the window's time."""

from port_bench.harness import readers

LAYER = "deploy engine"
UNIT = "%"
MOVES = "deploy_rtf"


def read(ctx, result):
    return readers.mfu_pct(ctx, "least_window_s", "windows")
