"""PyTorch model library: layer wrappers, ResNet18, SptAudioGen, weight bridge."""
