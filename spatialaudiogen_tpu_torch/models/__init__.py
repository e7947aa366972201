"""PyTorch model library: layer wrappers, ResNets, SptAudioGen, weight bridge,
recurrent and embedding layers, classification metrics, the model protocol."""
