"""Signal-processing host code: window-crop geometry and STFT framing helpers."""
