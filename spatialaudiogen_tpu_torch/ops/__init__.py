"""DFT-as-matmul STFT/ISTFT and the fused masked comb-ISTFT kernel."""
