"""Megabytes (1e6 bytes) per step in the window that the trainer's prefetch handed to the card (the program's counter `train.h2d_bytes`: every array of every batch it copied)."""

from port_bench.harness import program

LAYER = "trainer loop and prefetch"
UNIT = "MB"
MOVES = "train_step_samples_per_s"


def read(ctx, result):
    return program.program_count_per(ctx, "train.h2d_bytes", "steps", 1e-6)
