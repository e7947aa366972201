"""Evaluation: the device metric battery + host-side mel-LSD/envelope/EMD,
eval-detailed.txt emission and result aggregation (port of
spatialaudiogen_tpu.eval)."""

from spatialaudiogen_tpu_torch.eval.host_metrics import (
    melspectrogram,
    compute_mel_lsd,
    compute_envelope_dist,
)
from spatialaudiogen_tpu_torch.eval.evaluator import Evaluator
