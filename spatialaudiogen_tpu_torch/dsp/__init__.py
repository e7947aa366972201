"""Signal processing: STFT/ISTFT (the FFT reference functions and the
framing helpers) and the model's window-crop geometry."""

from spatialaudiogen_tpu_torch.dsp.geometry import ModelGeometry
from spatialaudiogen_tpu_torch.dsp.stft import hann_window, istft, stft, stft_for_loss
