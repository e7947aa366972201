"""Configuration: `TrainConfig` (CLI-flag parity + persistence/resume) and
the model config (counterparts of spatialaudiogen_tpu.config and
spatialaudiogen_tpu.models.sptaudiogen.SptAudioGenConfig).

`train-params.json` (or the reference's `train-params.txt`) in a model dir
is read and written with the same rules as the JAX package
(`TrainConfig.save/load`, `_parse_txt`, `_coerce`), so model dirs move
between the two packages. `compute_dtype="bfloat16"` runs the conv, deconv
and FC products in bfloat16 with float32 parameters, as the JAX package's
`dtype=jnp.bfloat16` does.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import torch

from spatialaudiogen_tpu_torch.dsp.geometry import ModelGeometry

AUDIO, VIDEO, FLOW = "audio", "video", "flow"
ENCODERS = (AUDIO, VIDEO, FLOW)
NO_SEPARATION, FREQ_MASK = "none", "unet_mask"
COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class SptAudioGenConfig:
    ambi_order: int = 1
    audio_rate: int = 48000
    video_rate: int = 10
    context: float = 1.0
    sample_duration: float = 0.1
    encoders: tuple = (AUDIO, VIDEO)
    separation: str = FREQ_MASK
    sep_num_tracks: int = 32
    loc_fc_units: tuple = (512, 512)
    sep_fft_window: float = 0.025
    # "highest": float32 everywhere, TF32 off for matmuls and convolutions;
    # "default": TF32 allowed (the counterpart of one bf16 MXU pass).
    dft_precision: str = "highest"
    # The masked ISTFT's GEMMs on the card (K1, K2, K3): "default" bf16
    # operands with f32 accumulation (one wgmma pass, the TPU's DEFAULT),
    # "highest" 3xTF32 (f32-grade). The CPU route is f32.
    pallas_precision: str = "default"
    # No use_pallas field: the masked ISTFT routes by device, CUDA tensors
    # through the fused kernels and CPU tensors through their plain
    # versions (the JAX package's "auto").
    # Mono input: the separation U-Net runs channels_last, so its last
    # deconv emits the mask as (B, T, F, tracks), and K3 reads that crop in
    # place (masked_istft_nhwc).
    pallas_nhwc: bool = False
    # Compute dtype of the conv, deconv and FC products (None = float32,
    # or torch.bfloat16): params stay float32, BatchNorm statistics, the
    # sigmoid, the DFTs and the decode run in float32, the mask is stored
    # in this dtype.
    dtype: Any = None
    # Reference quirk: visual-encoder BN uses batch statistics at eval too
    # (model.py:388,396).
    bn_batch_stats: bool = True

    def __post_init__(self):
        if not all(e in ENCODERS for e in self.encoders):
            raise ValueError(f"encoders must be among {ENCODERS}, got {self.encoders}")
        if self.separation not in (NO_SEPARATION, FREQ_MASK):
            raise ValueError(f"unknown separation {self.separation!r}")
        for name in ("dft_precision", "pallas_precision"):
            if getattr(self, name) not in ("highest", "default"):
                raise ValueError(f"{name} must be 'highest' or 'default', "
                                 f"got {getattr(self, name)!r}")
        if self.dtype not in COMPUTE_DTYPES.values():
            raise ValueError(f"dtype must be None or torch.bfloat16, got {self.dtype!r}")
        if set(self.encoders) & {VIDEO, FLOW}:
            vid_dur = self.sample_duration * self.video_rate
            if not (abs(vid_dur - round(vid_dur)) < 1e-6 and round(vid_dur) >= 1):
                raise ValueError(f"visual encoders require sample_duration*video_rate "
                                 f"to be a positive integer (got {vid_dur})")

    @property
    def geometry(self) -> ModelGeometry:
        return ModelGeometry(self.ambi_order, self.audio_rate, self.video_rate,
                             self.context, self.sample_duration,
                             self.sep_fft_window)

    @property
    def num_tracks(self) -> int:
        return 1 if self.separation == NO_SEPARATION else self.sep_num_tracks


@dataclasses.dataclass
class TrainConfig:
    """The fields of spatialaudiogen_tpu.config.TrainConfig, with its
    defaults. Some fields select paths that are not ported yet
    (multi-device, TensorBoard histograms, pretrained ResNet weights);
    cli.train refuses those values."""

    db_dir: str = ""
    model_dir: str = ""
    subset_fn: str | None = None
    encoders: tuple = (AUDIO, VIDEO, FLOW)
    separation: str = FREQ_MASK
    ambi_order: int = 1
    audio_rate: int = 48000
    video_rate: int = 10
    context: float = 1.0
    sample_dur: float = 0.1
    n_iters: int = 1000000
    lr: float = 1e-4
    lr_decay: float = 0.5
    lr_iters: int = 250000
    batch_size: int = 32
    num_sep_tracks: int = 32
    fft_window: float = 0.025
    context_units: tuple = (64, 128, 128)
    freq_mask_units: tuple = (256,)
    loc_units: tuple = (512, 512)
    resume: bool = False
    n_workers: int = 8
    log_every: int = 20
    ckpt_every: int = 5000
    tb_histograms: int = 0
    tb_activations: bool = False
    seed: int = 0
    frame_hw: tuple = (224, 448)
    n_data: int | None = None
    n_model: int = 1
    weight_decay: float = 5e-4
    clip_norm: float | None = None
    dft_precision: str = "highest"
    compute_dtype: str = "float32"
    pallas_precision: str = "default"
    pretrained_resnet: str | None = None

    def model_config(self) -> SptAudioGenConfig:
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(COMPUTE_DTYPES)}, "
                             f"got {self.compute_dtype!r}")
        return SptAudioGenConfig(
            dtype=COMPUTE_DTYPES[self.compute_dtype],
            ambi_order=self.ambi_order,
            audio_rate=self.audio_rate,
            video_rate=self.video_rate,
            context=self.context,
            sample_duration=self.sample_dur,
            encoders=tuple(self.encoders),
            separation=self.separation,
            sep_num_tracks=(self.num_sep_tracks if self.separation == FREQ_MASK
                            else 1),
            loc_fc_units=tuple(self.loc_units),
            sep_fft_window=self.fft_window,
            dft_precision=self.dft_precision,
            pallas_precision=self.pallas_precision,
        )

    def save(self, model_dir: str | None = None):
        """Write train-params.json and the reference-format train-params.txt
        (readable by both packages)."""
        model_dir = model_dir or self.model_dir
        os.makedirs(model_dir, exist_ok=True)
        payload = dataclasses.asdict(self)
        with open(os.path.join(model_dir, "train-params.json"), "w") as f:
            json.dump(payload, f, indent=2, default=list)
        # reference-compatible key: value dump (myutils.py:29-32 format)
        with open(os.path.join(model_dir, "train-params.txt"), "w") as f:
            for k, v in payload.items():
                if isinstance(v, tuple):
                    v = list(v)
                f.write(f"{k}: {v}\n")

    @classmethod
    def load(cls, model_dir: str,
             compute_dtype: str | None = None) -> "TrainConfig":
        """Load saved params; `compute_dtype` overrides the recorded one."""
        json_fn = os.path.join(model_dir, "train-params.json")
        if os.path.exists(json_fn):
            with open(json_fn) as f:
                cfg = cls(**_coerce(json.load(f)))
        else:
            txt_fn = os.path.join(model_dir, "train-params.txt")
            if not os.path.exists(txt_fn):
                raise FileNotFoundError(f"no train-params.json/.txt in {model_dir}")
            cfg = cls(**_coerce(_parse_txt(txt_fn)))
        if compute_dtype is not None:
            cfg.compute_dtype = compute_dtype
        return cfg


def _parse_txt(fn: str) -> dict:
    """Parse the reference 'key: value' format incl. its list syntax
    (myutils.py:40-85 semantics)."""
    raw = {}
    with open(fn) as f:
        for line in f:
            if ":" not in line:
                continue
            k, v = line.split(":", 1)
            raw[k.strip()] = v.strip()
    known = {f.name for f in dataclasses.fields(TrainConfig)}

    def parse_value(val):
        if val in ("None", ""):
            return None
        if val in ("True", "False"):
            return val == "True"
        if val.startswith("["):
            inner = val[1:-1].strip()
            if not inner:
                return ()
            items = [s.strip().strip("'\"") for s in inner.split(",")]
            try:
                return tuple(int(i) for i in items)
            except ValueError:
                return tuple(items)
        for cast in (int, float):
            try:
                return cast(val)
            except ValueError:
                continue
        return val

    out: dict[str, Any] = {}
    for k, v in raw.items():
        if k in known:
            out[k] = parse_value(v)
    return out


def _coerce(payload: dict) -> dict:
    known = {f.name for f in dataclasses.fields(TrainConfig)}
    out = {k: v for k, v in payload.items() if k in known}
    for key in ("encoders", "context_units", "freq_mask_units", "loc_units", "frame_hw"):
        if key in out and isinstance(out[key], list):
            out[key] = tuple(out[key])
    return out
