"""Per cent of the steps in the window whose batch the trainer's prefetch had staged (pinned, and its copy to the card queued) before the loop asked for it, so the loop took it without waiting (the program's counter `train.prefetch_ready`, 1 for such a batch and 0 for one it waited for)."""

from port_bench.harness import program

LAYER = "trainer loop and prefetch"
UNIT = "%"
MOVES = "train_step_samples_per_s"


def read(ctx, result):
    return program.program_count_per(ctx, "train.prefetch_ready", "steps", 100.0)
