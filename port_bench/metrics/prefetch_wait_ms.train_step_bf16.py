"""Mean milliseconds per step in the window that the bf16 train-step loop waited for its next batch on the card: the trainer's prefetch, which pins each replayed host batch and starts its copy two batches ahead (the benchmark's span around the trainer's device_prefetch). The feeder's threads are not in it: they made the replayed batches at set-up."""

from port_bench.harness import readers

LAYER = "trainer loop and prefetch"
UNIT = "ms"
MOVES = "train_step_bf16_samples_per_s"


def read(ctx, result):
    return readers.span_ms_per(ctx, "prefetch_wait", "steps")
