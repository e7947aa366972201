"""Evaluation metrics and training loss (port of
spatialaudiogen_tpu.models.metrics; reference model.py:62-159
evaluation_ops/loss_ops):

  * stft: per-sample STFT-MSE over the pow2-rounded loss STFT (x100)
  * lsd:  log-spectral distance over the comb STFT (window = 0.025*rate)
  * mse:  per-sample temporal MSE (x5e3 in the aggregate)
  * snr:  10*log10((P_signal+0.1)/(P_noise+0.1))
  * pow:  mean signal power diagnostics

All channel metrics are masked by the per-video channel mask and averaged
over the number of videos carrying each channel (model.py:119-126). The
STFTs are the port's matmul DFTs (ops.dft), in float32.

Under data parallelism (`group`: the data group of parallel.mesh) every
batch sum and count is the global batch's: the per-channel sums are
all-reduced with a differentiable collective, so each rank's loss is the
global loss, and its gradient, averaged over the group, the global one.
Shards whose clips have other layouts (WXY masks Z, WXYZ does not) have
other channel counts, so no rank may normalise by its own.
"""

from __future__ import annotations

import math

import torch

from spatialaudiogen_tpu_torch.models.layers import l2_regularization
from spatialaudiogen_tpu_torch.ops.dft import stft_for_loss_real, stft_real
from spatialaudiogen_tpu_torch.parallel.collectives import all_reduce_sum

EPS_LSD = 1e-2
EPS_SNR = 1e-1

# Reporting scales applied to the per-sample metrics (model.py:127-145:
# stft x100, mse x5e3).
METRIC_SCALES = {"stft": 100.0, "lsd": 1.0, "mse": 5e3, "snr": 1.0}


def stft_mse_ps(gt, pred, window: int, overlap: int):
    """Per-sample per-channel STFT MSE: (B, N, C) x2 -> (B, C)."""
    gr, gi = stft_for_loss_real(gt, window, overlap)
    pr, pi = stft_for_loss_real(pred, window, overlap)
    diff2 = (gr - pr) ** 2 + (gi - pi) ** 2          # |gt - pred|^2
    return diff2.mean(dim=3).mean(dim=2)


def lsd_ps(gt, pred, window: int, overlap: int):
    """Per-sample per-channel log-spectral distance: (B, N, C) x2 -> (B, C)."""

    def power_spect_sq(x2):
        # 10*log10(|x| + EPS) with |x| = sqrt(x2)
        return 10.0 * torch.log(torch.sqrt(x2) + EPS_LSD) / math.log(10.0)

    gr, gi = stft_real(gt.transpose(1, 2), window, overlap)
    pr, pi = stft_real(pred.transpose(1, 2), window, overlap)
    d = power_spect_sq(gr * gr + gi * gi) - power_spect_sq(pr * pr + pi * pi)
    lsd_t = torch.sqrt((d ** 2).mean(dim=3))
    return lsd_t.mean(dim=2)


def temporal_mse_ps(gt, pred):
    return ((gt - pred) ** 2).mean(dim=1)


def temporal_snr_ps(gt, pred):
    p_signal = (gt ** 2).sum(dim=1)
    p_noise = ((gt - pred) ** 2).sum(dim=1)
    return 10.0 * torch.log((p_signal + EPS_SNR) / (p_noise + EPS_SNR)) / math.log(10.0)


def evaluation_metrics(pred, target, mask_channels, audio_rate: int, group=None):
    """Masked metric battery. pred/target (B, T, C_out); mask (B, C_out).

    Returns (metrics dict of 0-d tensors, per_sample dict of (B, C_out)
    tensors: this rank's rows). Channel labels follow the reference's YZX
    order for ambi_order=1. `group`: the metrics of the data group's global
    batch (module docstring).
    """
    window = int(0.025 * audio_rate)     # FFT_WINDOW * rate (definitions.py:10)
    overlap = 2                          # FFT_OVERLAP_R (definitions.py:11)

    per_sample = {
        "stft": stft_mse_ps(target, pred, window, overlap),
        "lsd": lsd_ps(target, pred, window, overlap),
        "mse": temporal_mse_ps(target, pred),
        "snr": temporal_snr_ps(target, pred),
    }

    # batch sums: the masked per-channel sums of each metric, then (no
    # gradient) the channel counts, the signal powers and the row count
    sums = all_reduce_sum(torch.stack([(ps * mask_channels).sum(dim=0)
                                       for ps in per_sample.values()]), group)
    counts = torch.cat([mask_channels.sum(dim=0),
                        torch.stack([(pred.detach() ** 2).mean(dim=2).sum(),
                                     (target ** 2).mean(dim=2).sum(),
                                     mask_channels.new_tensor(float(pred.shape[0]))])])
    if group is not None:
        counts = all_reduce_sum(counts, group)
    n_out = pred.shape[2]
    num_masked = torch.clamp(counts[:n_out], min=1.0)

    metrics = {}
    channel_names = "YZX" if n_out == 3 else [str(i) for i in range(n_out)]
    for key, total in zip(per_sample, sums):
        per_channel = total / num_masked * METRIC_SCALES[key]
        metrics[f"{key}/avg"] = per_channel.mean()
        for i, ch in zip(range(n_out), channel_names):
            metrics[f"{key}/{ch}"] = per_channel[i]

    # sum over time of the mean power over channels and rows
    metrics["pow/pred"] = counts[n_out] / counts[n_out + 2]
    metrics["pow/gt"] = counts[n_out + 1] / counts[n_out + 2]
    return metrics, per_sample


def training_loss(pred, target, mask_channels, audio_rate: int, model=None,
                  weight_decay: float = 5e-4, decay_exclude=(), group=None):
    """Total loss = masked STFT-MSE x100 (+ L2 regularizers over `model`'s
    kernels), reference model.py:156-159 + train.py:139-144, over the data
    group's global batch when `group` is given.
    Returns (total, metrics dict)."""
    metrics, _ = evaluation_metrics(pred, target, mask_channels, audio_rate, group)
    losses = {"stft/mse": metrics["stft/avg"]}
    total = losses["stft/mse"]
    if model is not None and weight_decay > 0:
        reg = l2_regularization(model, weight_decay, exclude=decay_exclude)
        losses["regularization"] = reg
        total = total + reg
    losses["total_loss"] = total
    return total, {**metrics, **losses}
