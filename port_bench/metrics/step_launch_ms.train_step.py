"""Mean milliseconds per step in the window that the trainer's loop spent in its call of the train step (the program's `train.launch` spans): the host's launch of the forward, backward and Adam, which waits on the card only where a launch queue fills."""

from port_bench.harness import program

LAYER = "train step and model"
UNIT = "ms"
MOVES = "train_step_samples_per_s"


def read(ctx, result):
    return program.program_span_ms_per(ctx, "train.launch", "steps")
