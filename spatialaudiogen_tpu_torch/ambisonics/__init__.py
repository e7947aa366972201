"""Ambisonics host code the port needs: azimuth rotations for training augmentation."""
