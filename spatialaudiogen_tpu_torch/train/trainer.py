"""Training loop: feeder -> prefetch -> train step -> log/checkpoint (port of
spatialaudiogen_tpu.train.trainer).

Orchestration parity with reference train.py:62-236: config persistence and
resume, feeder worker threads, periodic stat prints, NaN abort, checkpoint
every ckpt_every steps and at exit, and a SIGTERM stop at the next step
boundary. Host threads feed a prefetcher that copies each batch to the
card two batches ahead of the step.

Each iteration is a `train.iter` span (utils.profiling; id = the step)
holding `train.batch` (the prefetch: `train.pin`, `train.h2d`),
`train.launch` (the train step's launch) and `train.log` (the log step's
metric fetch and write).

Multi-process runs (parallel.distributed.initialize before the Trainer)
train on a ('data', 'model') mesh (parallel.mesh): cfg.batch_size is the
global batch; each data rank feeds batch_size / n_data rows from its own
shard of the videos (Feeder shard_id/num_shards), and under tensor
parallelism the model group's first rank feeds and broadcasts its rows.
Rank 0 alone writes the config, metrics.jsonl, TensorBoard events and the
checkpoints (the others keep a no-op logger); every rank restores. A
SIGTERM on any rank stops every rank at the same step boundary: the flag
is all-reduced at each boundary, so no rank is left blocked in a
collective.
"""

from __future__ import annotations

import math
import signal
import time

import torch
import torch.distributed as dist

from spatialaudiogen_tpu_torch.config import FLOW, VIDEO, TrainConfig
from spatialaudiogen_tpu_torch.data.pipeline import Feeder, device_prefetch
from spatialaudiogen_tpu_torch.data.readers import img_prep_u8
from spatialaudiogen_tpu_torch.models.convert import to_flax
from spatialaudiogen_tpu_torch.models.resnet import load_npy_blob, load_npy_weights
from spatialaudiogen_tpu_torch.parallel.distributed import global_batch, is_distributed
from spatialaudiogen_tpu_torch.parallel.mesh import gather_full, make_mesh
from spatialaudiogen_tpu_torch.train.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from spatialaudiogen_tpu_torch.train.lr import staircase_decay
from spatialaudiogen_tpu_torch.train.state import create_train_state
from spatialaudiogen_tpu_torch.train.steps import observe_step, train_step
from spatialaudiogen_tpu_torch.utils import profiling
from spatialaudiogen_tpu_torch.utils.logging import MetricLogger

# Fields that define the network: on resume they come from the stored run.
ARCH_FIELDS = ("encoders", "separation", "ambi_order", "audio_rate", "video_rate",
               "context", "sample_dur", "num_sep_tracks", "fft_window",
               "context_units", "freq_mask_units", "loc_units")


class _NullLogger:
    """Logger of the ranks other than 0: every MetricLogger method is a
    no-op (peers on a shared filesystem must not race rank 0's files)."""

    def tick(self, *a, **k): pass

    def log(self, *a, **k): pass

    def log_histograms(self, *a, **k): pass

    def close(self): pass


def jax_names(tensors: dict) -> dict:
    """{state_dict name: tensor} of parameters -> {JAX param path: array}
    without the 'params/' collection (the JAX package's histogram names)."""
    return {k.split("/", 1)[1]: v for k, v in to_flax(tensors).items()}


class Trainer:
    def __init__(self, cfg: TrainConfig, device: str = "cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but torch.cuda.is_available() is False")
        self.mesh = make_mesh(cfg.n_data, cfg.n_model, self.device)
        self.is_primary = self.mesh.is_primary
        if cfg.batch_size % self.mesh.n_data:
            raise ValueError(f"batch_size {cfg.batch_size} does not split over "
                             f"{self.mesh.n_data} data ranks")
        if cfg.resume:
            loaded = TrainConfig.load(cfg.model_dir)
            for key in ARCH_FIELDS:
                setattr(cfg, key, getattr(loaded, key))
            if is_distributed():
                dist.barrier()      # every rank has read the stored run
        if self.is_primary:
            cfg.save()

        self.lr_schedule = staircase_decay(cfg.lr, cfg.lr_decay, cfg.lr_iters)
        self.feeder = None
        if self.mesh.model_rank == 0:
            self.feeder = Feeder(
                cfg.db_dir, subset_fn=cfg.subset_fn, ambi_order=cfg.ambi_order,
                audio_rate=cfg.audio_rate, video_rate=cfg.video_rate,
                context=cfg.context, duration=cfg.sample_dur,
                return_video=VIDEO in cfg.encoders,
                img_prep=img_prep_u8,  # normalised on the device (train/steps.py)
                return_flow=FLOW in cfg.encoders,
                batch_size=cfg.batch_size // self.mesh.n_data, n_workers=cfg.n_workers,
                for_eval=False, seed=cfg.seed,
                shard_id=self.mesh.data_rank, num_shards=self.mesh.n_data)
        self.state = create_train_state(cfg, self.device, mesh=self.mesh)
        if cfg.pretrained_resnet:
            # only when no checkpoint will be restored: keyed on a
            # checkpoint's presence, not on --resume, so a run killed before
            # its first save starts from the pretrained weights again
            if cfg.resume and latest_step(cfg.model_dir) is not None:
                print("--pretrained_resnet ignored: resuming from a checkpoint "
                      "(pretrained init only applies to fresh runs)")
            else:
                self._load_pretrained_visual(cfg.pretrained_resnet)
        self.init_step = 0
        if cfg.resume:
            step = restore_checkpoint(cfg.model_dir, self.state)
            if step is not None:
                self.init_step = step
                print(f"Restored checkpoint at step {step}")
        self.logger = MetricLogger(cfg.model_dir) if self.is_primary else _NullLogger()
        self._stop_requested = False

    def _load_pretrained_visual(self, npy_path: str):
        """Each visual encoder from a reference-style resnet18.npy
        (restore_pretrained parity, model.py:198 / resnet.py:238-249): the
        same blob into video_encoder and flow_encoder, under each scope."""
        model = self.state.model
        blob = load_npy_blob(npy_path)
        sd = model.state_dict()
        for enc in (VIDEO, FLOW):
            if enc not in self.cfg.encoders:
                continue
            sd, unmatched = load_npy_weights(blob, sd, prefix=f"{enc}_encoder")
            print(f"Initialized {enc}_encoder from {npy_path} "
                  f"({len(unmatched)} npy entries unmatched)")
        model.load_state_dict(sd, strict=True)

    def request_stop(self):
        """Ask the loop to stop at the next step boundary (the checkpoint is
        still saved by the exit path). Called by the SIGTERM handler."""
        self._stop_requested = True

    def _stop_agreed(self) -> bool:
        """This rank's stop flag, or under several processes whether any
        rank's is set (one all-reduce at each step boundary)."""
        if not is_distributed():
            return self._stop_requested
        flag = torch.tensor([float(self._stop_requested)])
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    def _log_histograms(self, step: int, batch: dict):
        """Parameter, gradient (the observe step's, on this step's batch)
        and, with tb_activations, activation histograms: full tensors (the
        shards gathered), under the JAX package's tags."""
        cfg, state, mesh = self.cfg, self.state, self.mesh
        model = state.model
        params = gather_full(dict(model.named_parameters()), model, mesh)
        self.logger.log_histograms(step, jax_names(params), prefix="params")
        grads, ends = observe_step(state, batch, cfg.tb_activations, cfg.weight_decay)
        self.logger.log_histograms(step, jax_names(gather_full(grads, model, mesh)),
                                   prefix="grads")
        if cfg.tb_activations:
            self.logger.log_histograms(step, ends, prefix="acts")

    def train(self):
        cfg = self.cfg
        state = self.state
        stream = None
        if self.feeder is not None:
            self.feeder.start()
            stream = device_prefetch(self.feeder.batches(), self.device)
        self._stop_requested = False
        # Stop at the next step boundary on SIGTERM so the exit path saves a
        # checkpoint instead of dying mid-step. Restore-by-flag: the prior
        # handler may have been installed outside Python (signal returns None).
        prev_handler, handler_installed = None, False
        try:
            prev_handler = signal.signal(
                signal.SIGTERM,
                lambda signum, frame: (
                    print("SIGTERM: stopping at step boundary, will checkpoint"),
                    self.request_stop()))
            handler_installed = True
        except ValueError:  # not the main thread (e.g. under a test runner)
            pass
        completed = False
        try:
            t_prev = time.perf_counter()
            while state.step < cfg.n_iters and not self._stop_agreed():
                step = state.step
                with profiling.span("train.iter", step):
                    with profiling.span("train.batch"):
                        local = next(stream)[0] if stream is not None else None
                    dev_batch = global_batch(local, self.mesh, self.device)
                    lr = self.lr_schedule(step)
                    with profiling.span("train.launch"):
                        metrics = train_step(state, dev_batch, lr, cfg.weight_decay,
                                             cfg.clip_norm)
                    if step % cfg.log_every == 0:
                        # one copy of all metrics to the host; it waits for the
                        # step, so the wall time per iteration is what tick records
                        with profiling.span("train.log"):
                            names = list(metrics)
                            values = torch.stack([metrics[k].float() for k in names]).cpu()
                        metrics = dict(zip(names, values.tolist()))
                        metrics["lr"] = lr
                        if math.isnan(metrics["total_loss"]):
                            raise FloatingPointError(
                                f"Training produced a NaN loss at step {step}.")
                    now = time.perf_counter()
                    self.logger.tick(now - t_prev)
                    t_prev = now
                    if step % cfg.log_every == 0:
                        with profiling.span("train.log"):
                            self.logger.log(step, metrics, cfg.batch_size)
                    if cfg.tb_histograms and step % cfg.tb_histograms == 0:
                        self._log_histograms(step, dev_batch)
                    if cfg.ckpt_every and state.step % cfg.ckpt_every == 0:
                        save_checkpoint(cfg.model_dir, state)
                        if self.is_primary:
                            print("=" * 60 + "\nCheckpoint saved\n" + "=" * 60)
            completed = True
        finally:
            # a failed rank cannot join the other ranks' gathers: under
            # several processes only a loop that ended cleanly saves
            if completed or not is_distributed():
                if self.is_primary:
                    print("End of training. Saving model.")
                    cfg.save()
                save_checkpoint(cfg.model_dir, state)
            if self.feeder is not None:
                self.feeder.stop()
            self.logger.close()
            if handler_installed:
                signal.signal(signal.SIGTERM,
                              prev_handler if prev_handler is not None
                              else signal.SIG_DFL)
        return state, state.step

