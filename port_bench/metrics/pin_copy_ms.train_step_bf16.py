"""Mean milliseconds per step in the window that the trainer's prefetch spent pinning the batch's host arrays (the program's `train.pin` spans, one per array, inside `device_prefetch`): the host copy that the copy to the card waits on."""

from port_bench.harness import program

LAYER = "trainer loop and prefetch"
UNIT = "ms"
MOVES = "train_step_bf16_samples_per_s"


def read(ctx, result):
    return program.program_span_ms_per(ctx, "train.pin", "steps")
