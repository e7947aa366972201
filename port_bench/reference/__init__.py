"""The benchmark's plain reference: a frozen copy, in plain PyTorch and
NumPy, of the SptAudioGen model's forward pass, its training loss, the
masked comb ISTFT and Adam, the rebuilding of training windows from a
pack, and the count of work and the table of peaks. It imports nothing of
the measured package and nothing of JAX."""
