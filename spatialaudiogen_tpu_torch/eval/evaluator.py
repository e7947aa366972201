"""Evaluator: one deterministic pass over the test split, full metric
battery (port of spatialaudiogen_tpu.eval.evaluator).

Parity with reference eval.py:29-233: loads the model of model_dir (config
from train-params, weights from params.npz), iterates the eval feeder
(duration 0.1 s, skip_rate 10), computes the stft/lsd/mse/snr battery per
sample on the device plus mel-LSD, envelope and EMD (ang_res=30) on the
host, and writes model_dir/eval-detailed.txt with one line per sample for
parse_eval_results-style aggregation.

As in the JAX package: the host metrics run in a thread pool overlapped
with the next device batch; the final partial batch is zero-padded for the
device and truncated on the host (the reference silently drops it), and
the zero pad lanes stay in the forward, where the visual encoders'
batch-statistics BatchNorm (bn_batch_stats) sees them; --device_metrics
and --emd sinkhorn move mel-LSD/envelope and the EMD onto the device.

With a mesh (parallel.mesh, n_model = 1), the JAX Evaluator's batch
sharding over the data axis: every rank reads the same batches (the
feeder on one thread, so in one fixed order), runs its contiguous block
of each batch's rows with the BatchNorm moments and the batch metrics
over the data group, and rank 0 gathers the per-row results in rank
order, scores them on its host pool and writes the one file.
"""

from __future__ import annotations

import os
import time
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from spatialaudiogen_tpu_torch.ambisonics.emd import ambix_emd
from spatialaudiogen_tpu_torch.config import TrainConfig
from spatialaudiogen_tpu_torch.data.pipeline import Feeder
from spatialaudiogen_tpu_torch.data.readers import img_prep_u8
from spatialaudiogen_tpu_torch.eval.host_metrics import compute_envelope_dist, compute_mel_lsd
from spatialaudiogen_tpu_torch.models.convert import load_params
from spatialaudiogen_tpu_torch.models.metrics import METRIC_SCALES
from spatialaudiogen_tpu_torch.models.sptaudiogen import SptAudioGen
from spatialaudiogen_tpu_torch.parallel.mesh import gather_rows, row_block, shard_model
from spatialaudiogen_tpu_torch.train.checkpoint import latest_step
from spatialaudiogen_tpu_torch.train.steps import eval_step

ALL_METRICS = [
    "amplitude/predicted", "amplitude/gt",
    "mse/avg", "mse/X", "mse/Y", "mse/Z",
    "stft/avg", "stft/X", "stft/Y", "stft/Z",
    "lsd/avg", "lsd/X", "lsd/Y", "lsd/Z",
    "mel_lsd/avg", "mel_lsd/X", "mel_lsd/Y", "mel_lsd/Z",
    "snr/avg", "snr/X", "snr/Y", "snr/Z",
    "env_mse/avg", "env_mse/X", "env_mse/Y", "env_mse/Z",
    "emd/dir", "emd/dir2",
]
EVAL_DURATION = 0.1   # eval.py:43
EVAL_BATCH = 16       # eval.py:44 (hardcoded there as well)


class Evaluator:
    """`model_dir` holds train-params.json and params.npz (written by
    train.checkpoint.save_checkpoint, or from a JAX checkpoint by
    tools/export_torch_weights.py); `restored_step` is the step of
    train_state.pt when the dir has one, else None. Runs on `device`
    ("cuda" by default; the CPU only when asked). `mesh` shards each
    batch's rows over the data ranks (module docstring): batch_size must
    divide over them, the feeder runs one thread whatever n_workers says,
    and run() returns the rows on rank 0 only."""

    def __init__(self, model_dir: str, subset_fn: str | None = None,
                 batch_size: int = EVAL_BATCH, db_dir: str | None = None,
                 n_workers: int = 4, emd_ang_res: float = 30,
                 mesh=None, compute_dtype: str | None = None,
                 shard_id: int | None = None, num_shards: int | None = None,
                 emd_mode: str = "exact", device_metrics: bool = False,
                 device: str = "cuda"):
        if mesh is not None and batch_size % mesh.n_data:
            raise ValueError(f"eval batch {batch_size} must divide over {mesh.n_data} "
                             f"data ranks")
        self.mesh = mesh if mesh is not None and mesh.data_group is not None else None
        if self.mesh is not None:
            n_workers = 1    # every rank must form the same batches
        if emd_mode not in ("exact", "sinkhorn"):
            raise ValueError(f"emd_mode must be 'exact' or 'sinkhorn', got {emd_mode!r}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but torch.cuda.is_available() is False")
        self.cfg = TrainConfig.load(model_dir, compute_dtype=compute_dtype)
        self.cfg.model_dir = model_dir
        if db_dir is not None:
            self.cfg.db_dir = db_dir
        self.cfg.sample_dur = EVAL_DURATION
        self.batch_size = batch_size
        self.emd_ang_res = emd_ang_res
        # "exact": per-sample native min-cost-flow EMD in the host pool
        # (reference pyemd semantics). "sinkhorn": the whole batch's EMD
        # solved on the device by annealed Sinkhorn (ops/sinkhorn.py; within
        # 5e-3 relative / 5e-4 absolute of exact, tests/test_sinkhorn.py).
        self.emd_mode = emd_mode
        self._emd_device_fn = None
        if emd_mode == "sinkhorn":
            from spatialaudiogen_tpu_torch.ops.sinkhorn import ambix_emd_batch_fn

            # window=0.1 unconditionally: the exact path (ambix_emd ->
            # SphericalAmbisonicsVisualizer) hardcodes 0.1 s map frames
            # (reference distance.py:131), independent of EVAL_DURATION.
            emd_metric = ambix_emd_batch_fn(
                self.cfg.audio_rate, float(emd_ang_res),
                order=self.cfg.ambi_order, window=0.1)

            def device_emd(pred, mono, target, layout):
                pred_m = torch.cat([mono, pred], dim=2) * layout[:, None, :]
                gt_m = torch.cat([mono, target], dim=2) * layout[:, None, :]
                return emd_metric(pred_m, gt_m)

            self._emd_device_fn = device_emd
        # device_metrics: mel-LSD + Hilbert envelope as matmuls per batch
        # (ops/eval_metrics.py, full float32, within ~1e-6 of the float64
        # host implementations).
        self._spectral_device_fn = None
        if device_metrics:
            from spatialaudiogen_tpu_torch.ops.eval_metrics import (
                envelope_dist_fn, mel_lsd_batch_fn)

            g = self.cfg.model_config().geometry
            mel_fn = mel_lsd_batch_fn(self.cfg.audio_rate)
            env_fn = envelope_dist_fn(g.snd_dur)

            def spectral(pred, target):
                # amplitudes ride along, so the fully on-device mode (with
                # emd_mode="sinkhorn") never copies the predictions back
                amp = (pred.abs().amax(dim=(1, 2)), target.abs().amax(dim=(1, 2)))
                return mel_fn(pred, target), env_fn(pred, target), amp

            self._spectral_device_fn = spectral

        self.model = SptAudioGen(self.cfg.model_config(), frame_hw=tuple(self.cfg.frame_hw))
        # params.npz carries the BN batch_stats too; a dir without it
        # raises here, as the JAX Evaluator's "no checkpoint found" does
        self.model.load_state_dict(load_params(model_dir), strict=True)
        if self.mesh is not None:
            shard_model(self.model, self.mesh)
        self.model.to(self.device).eval()
        self._rows = row_block(batch_size, self.mesh)   # this rank's rows of a batch
        self.restored_step = latest_step(model_dir)

        # multi-host eval: each process scores a disjoint video shard
        # (mirrors train/trainer.py; reference analogue is the per-thread
        # split, feeder.py:232-234).
        self.shard_id = 0 if shard_id is None else shard_id
        self.num_shards = 1 if num_shards is None else num_shards
        self.feeder = Feeder(
            self.cfg.db_dir, subset_fn=subset_fn, ambi_order=self.cfg.ambi_order,
            audio_rate=self.cfg.audio_rate, video_rate=self.cfg.video_rate,
            context=self.cfg.context, duration=EVAL_DURATION,
            return_video="video" in self.cfg.encoders,
            img_prep=img_prep_u8,  # normalized on the device (train/steps.py)
            return_flow="flow" in self.cfg.encoders,
            batch_size=batch_size, n_workers=n_workers, for_eval=True,
            shard_id=self.shard_id, num_shards=self.num_shards)

    def _pad(self, batch: dict):
        n = batch["ambix"].shape[0]
        if n == self.batch_size:
            return batch, n
        out = {}
        for k, v in batch.items():
            if k == "id":
                out[k] = v
                continue
            pad = np.zeros((self.batch_size - n,) + v.shape[1:], v.dtype)
            out[k] = np.concatenate([v, pad], axis=0)
        return out, n

    def _host_metrics(self, sample):
        """Per-sample host metric computation (runs in the worker pool).

        Parity note: like the reference (eval.py:145-185 consumes the RAW
        per-sample `*_ps` tensors; model.py:110-155 applies audio_mask only
        to the batch aggregates), the per-sample records here are unmasked:
        masked channels contribute to the per-channel columns and the
        3-channel means. Only EMD applies the layout mask (eval.py:188-190).
        """
        (sid, mono, gt, pred, layout, stft_d, lsd, mse, snr, emd_pre,
         mel_env_pre) = sample
        rec = OrderedDict()
        rec["stft/avg"] = float(np.mean(stft_d))
        rec["lsd/avg"] = float(np.mean(lsd))
        rec["mse/avg"] = float(np.mean(mse))
        rec["snr/avg"] = float(np.nanmean(snr))
        for i, ch in zip(range(3), "YZX"):
            rec[f"stft/{ch}"] = float(stft_d[i])
            rec[f"lsd/{ch}"] = float(lsd[i])
            rec[f"mse/{ch}"] = float(mse[i])
            rec[f"snr/{ch}"] = float(snr[i])

        if mel_env_pre is not None:
            # computed on the device (--device_metrics), amplitudes included
            mel, env, amp_pred, amp_gt = mel_env_pre
        else:
            mel = compute_mel_lsd(pred, gt, self.cfg.audio_rate)
            env = compute_envelope_dist(pred, gt)
            amp_pred, amp_gt = np.abs(pred).max(), np.abs(gt).max()
        rec["mel_lsd/avg"] = float(np.mean(mel))
        rec["env_mse/avg"] = float(np.mean(env))
        for i, ch in zip(range(3), "YZX"):
            rec[f"mel_lsd/{ch}"] = float(mel[i])
            rec[f"env_mse/{ch}"] = float(env[i])

        if emd_pre is not None:
            emd_dir, emd_dir2 = emd_pre  # solved on the device (emd_mode="sinkhorn")
        else:
            gt_m = np.concatenate([mono, gt], axis=1) * layout[None, :]
            pred_m = np.concatenate([mono, pred], axis=1) * layout[None, :]
            emd_dir, emd_dir2 = ambix_emd(pred_m, gt_m, self.cfg.audio_rate,
                                          ang_res=self.emd_ang_res)
        rec["emd/dir"] = float(emd_dir)
        rec["emd/dir2"] = float(emd_dir2)
        rec["amplitude/gt"] = float(amp_gt)
        rec["amplitude/predicted"] = float(amp_pred)
        return sid, rec

    def _device_batch(self, padded: dict):
        """One padded batch through the eval step and the device metrics;
        -> (pred, mono, target, per-sample dict, emd pair, spectral
        quadruple), numpy on the host, the whole batch in row order
        (pred/mono/target are None under the fully on-device battery,
        which fetches only the per-row metrics). Under a mesh this rank
        runs its rows and rank 0 gathers; the other ranks get None."""
        group = None if self.mesh is None else self.mesh.data_group
        arrays = {k: torch.from_numpy(np.ascontiguousarray(v[self._rows])).to(self.device)
                  for k, v in padded.items() if k != "id"}
        pred, mono, target, _, per_sample = eval_step(self.model, arrays, group)
        layout = arrays["audio_mask"]
        emd = spectral = ()
        if self._emd_device_fn is not None:
            emd = self._emd_device_fn(pred, mono, target, layout)
        if self._spectral_device_fn is not None:
            mel, env, amp = self._spectral_device_fn(pred, target)
            spectral = (mel, env, amp[0], amp[1])
        # every per-row result in one copy back (and one gather)
        audio = () if emd and spectral else (pred, mono, target)
        parts = [*audio, *(per_sample[k] for k in ("stft", "lsd", "mse", "snr")),
                 *emd, *spectral]
        flat = gather_rows(torch.cat([x.reshape(x.shape[0], -1).float() for x in parts], 1),
                           self.mesh)
        if flat is None:       # not rank 0
            return None
        out, col = [], 0
        for x in parts:
            width = x[0].numel()
            out.append(flat[:, col: col + width].reshape((-1,) + tuple(x.shape[1:])).numpy())
            col += width
        if audio:
            pred, mono, target = out[:3]
            out = out[3:]
        else:
            pred = mono = target = [None] * self.batch_size
        ps = dict(zip(("stft", "lsd", "mse", "snr"), out[:4]))
        emd = tuple(out[4:4 + len(emd)]) or None
        spectral = tuple(out[4 + len(emd or ()):]) or None
        return pred, mono, target, ps, emd, spectral

    def _run_secondary(self, max_batches: int | None):
        """run() on a rank of a mesh other than rank 0: its rows of every
        batch through the device, for rank 0 to gather."""
        self.feeder.start()
        try:
            for it, batch in enumerate(self.feeder.batches()):
                if max_batches is not None and it >= max_batches:
                    break
                self._device_batch(self._pad(batch)[0])
        finally:
            self.feeder.stop()
        return {}, []

    def run(self, output_fn: str | None = None, host_threads: int = 8,
            print_every: int = 5, max_batches: int | None = None,
            max_inflight: int | None = None, flush_every: int = 64):
        """One eval pass. Memory- and crash-bounded (reference eval.py:210-215
        dumps periodically): at most ``max_inflight`` (default 2x
        host_threads + one batch) per-sample host-metric futures, each
        holding ~100 KB of mono/gt/pred audio, are in flight at once, and
        completed records stream to ``output_fn`` every ``flush_every``
        results, so a crash at sample N loses at most the unflushed tail.
        Under a mesh every rank must call; rank 0 returns (summary, rows)
        and writes the file, the others return ({}, []).
        """
        if self.mesh is not None and not self.mesh.is_primary:
            return self._run_secondary(max_batches)
        if output_fn is None:
            # sharded runs write one file per shard so that shards never
            # clobber each other's rows on a shared model_dir (cat the
            # shards, or point parse_eval_results at each)
            suffix = (f".shard{self.shard_id}" if self.num_shards > 1 else "")
            output_fn = os.path.join(self.cfg.model_dir, "eval-detailed.txt" + suffix)
        if max_inflight is None:
            max_inflight = 2 * host_threads + self.batch_size
        results: list = []
        n_scored = 0
        self.feeder.start()
        t_start = time.time()
        try:
            with open(output_fn, "w") as out, \
                    ThreadPoolExecutor(max_workers=host_threads) as pool:
                out.write("SampleID | {}\n".format(" ".join(ALL_METRICS)))
                futures: deque = deque()

                def drain(limit: int):
                    """Retire futures (in submit order) down to `limit`
                    outstanding, then opportunistically retire any further
                    already-done head-of-queue entries."""
                    nonlocal n_scored
                    while futures and (len(futures) > limit or futures[0].done()):
                        sid, rec = futures.popleft().result()
                        results.append((sid, rec))
                        out.write("{} | {}\n".format(
                            sid, " ".join(str(rec[m]) for m in ALL_METRICS)))
                        n_scored += 1
                        if n_scored % flush_every == 0:
                            out.flush()

                for it, batch in enumerate(self.feeder.batches()):
                    if max_batches is not None and it >= max_batches:
                        break
                    padded, n_valid = self._pad(batch)
                    pred, mono, target, ps, emd_batch, spectral_batch = \
                        self._device_batch(padded)
                    for smp in range(n_valid):
                        sample = (batch["id"][smp], mono[smp], target[smp], pred[smp],
                                  batch["audio_mask"][smp],
                                  ps["stft"][smp] * METRIC_SCALES["stft"],
                                  ps["lsd"][smp],
                                  ps["mse"][smp] * METRIC_SCALES["mse"],
                                  ps["snr"][smp],
                                  None if emd_batch is None else
                                  (float(emd_batch[0][smp]), float(emd_batch[1][smp])),
                                  None if spectral_batch is None else
                                  (spectral_batch[0][smp], spectral_batch[1][smp],
                                   float(spectral_batch[2][smp]),
                                   float(spectral_batch[3][smp])))
                        futures.append(pool.submit(self._host_metrics, sample))
                    drain(max_inflight)
                    if print_every and it % print_every == 0:
                        print(f"eval: batch {it}, {len(futures)} samples in "
                              f"flight, {n_scored} scored, "
                              f"{time.time() - t_start:.1f}s")
                drain(0)
        finally:
            self.feeder.stop()

        summary = {m: float(np.mean([rec[m] for _, rec in results]))
                   for m in ALL_METRICS} if results else {}
        return summary, results
