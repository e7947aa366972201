"""Training loop: feeder -> prefetch -> train step -> log/checkpoint (port of
spatialaudiogen_tpu.train.trainer for one device).

Orchestration parity with reference train.py:62-236: config persistence and
resume, feeder worker threads, periodic stat prints, NaN abort, checkpoint
every ckpt_every steps and at exit, and a SIGTERM stop at the next step
boundary. Host threads feed a prefetcher that copies each batch to the
card two batches ahead of the step.
"""

from __future__ import annotations

import math
import signal
import time

import torch

from spatialaudiogen_tpu_torch.config import TrainConfig
from spatialaudiogen_tpu_torch.data.pipeline import Feeder, device_prefetch
from spatialaudiogen_tpu_torch.data.readers import img_prep_u8
from spatialaudiogen_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from spatialaudiogen_tpu_torch.train.lr import staircase_decay
from spatialaudiogen_tpu_torch.train.state import create_train_state
from spatialaudiogen_tpu_torch.train.steps import train_step
from spatialaudiogen_tpu_torch.utils.logging import MetricLogger

# Fields that define the network: on resume they come from the stored run.
ARCH_FIELDS = ("encoders", "separation", "ambi_order", "audio_rate", "video_rate",
               "context", "sample_dur", "num_sep_tracks", "fft_window",
               "context_units", "freq_mask_units", "loc_units")


class Trainer:
    def __init__(self, cfg: TrainConfig, device: str = "cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but torch.cuda.is_available() is False")
        if cfg.resume:
            loaded = TrainConfig.load(cfg.model_dir)
            for key in ARCH_FIELDS:
                setattr(cfg, key, getattr(loaded, key))
        cfg.save()

        self.lr_schedule = staircase_decay(cfg.lr, cfg.lr_decay, cfg.lr_iters)
        self.feeder = Feeder(
            cfg.db_dir, subset_fn=cfg.subset_fn, ambi_order=cfg.ambi_order,
            audio_rate=cfg.audio_rate, video_rate=cfg.video_rate,
            context=cfg.context, duration=cfg.sample_dur,
            return_video="video" in cfg.encoders,
            img_prep=img_prep_u8,  # normalised on the device (train/steps.py)
            return_flow="flow" in cfg.encoders,
            batch_size=cfg.batch_size, n_workers=cfg.n_workers,
            for_eval=False, seed=cfg.seed)
        self.state = create_train_state(cfg, self.device)
        self.init_step = 0
        if cfg.resume:
            step = restore_checkpoint(cfg.model_dir, self.state)
            if step is not None:
                self.init_step = step
                print(f"Restored checkpoint at step {step}")
        self.logger = MetricLogger(cfg.model_dir)
        self._stop_requested = False

    def request_stop(self):
        """Ask the loop to stop at the next step boundary (the checkpoint is
        still saved by the exit path). Called by the SIGTERM handler."""
        self._stop_requested = True

    def train(self):
        cfg = self.cfg
        state = self.state
        self.feeder.start()
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
        try:
            stream = device_prefetch(self.feeder.batches(), self.device)
            t_prev = time.perf_counter()
            for dev_batch, _ in stream:
                if state.step >= cfg.n_iters or self._stop_requested:
                    break
                step = state.step
                lr = self.lr_schedule(step)
                metrics = train_step(state, dev_batch, lr, cfg.weight_decay, cfg.clip_norm)
                if step % cfg.log_every == 0:
                    # one copy of all metrics to the host; it waits for the
                    # step, so the wall time per iteration is what tick records
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
                    self.logger.log(step, metrics, cfg.batch_size)
                if cfg.ckpt_every and state.step % cfg.ckpt_every == 0:
                    save_checkpoint(cfg.model_dir, state)
                    print("=" * 60 + "\nCheckpoint saved\n" + "=" * 60)
        finally:
            print("End of training. Saving model.")
            cfg.save()
            save_checkpoint(cfg.model_dir, state)
            self.feeder.stop()
            self.logger.close()
            if handler_installed:
                signal.signal(signal.SIGTERM,
                              prev_handler if prev_handler is not None
                              else signal.SIG_DFL)
        return state, state.step

