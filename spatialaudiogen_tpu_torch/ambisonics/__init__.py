"""Ambisonics host code the port needs: azimuth rotations for training
augmentation, and the formats, SH decoding grids, power maps and EMD of
the eval metrics."""
