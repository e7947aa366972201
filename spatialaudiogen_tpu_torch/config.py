"""Configuration: the `TrainConfig` subset that deploy reads, and the model
config (counterparts of spatialaudiogen_tpu.config and
spatialaudiogen_tpu.models.sptaudiogen.SptAudioGenConfig).

`train-params.json` (or the reference's `train-params.txt`) in a model dir
is read with the same rules as the JAX package (`TrainConfig.load`,
`_parse_txt`, `_coerce`); fields this package does not use are ignored.
Only float32 compute is supported so far.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

from spatialaudiogen_tpu.dsp.geometry import ModelGeometry

AUDIO, VIDEO, FLOW = "audio", "video", "flow"
ENCODERS = (AUDIO, VIDEO, FLOW)
NO_SEPARATION, FREQ_MASK = "none", "unet_mask"


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
    # Accepted for config parity; the CUDA kernel runs FP32 FFMA for both
    # values (exact for "highest", more than enough for "default").
    pallas_precision: str = "default"
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
    """The fields of spatialaudiogen_tpu.config.TrainConfig that deploy
    reads; defaults are the JAX package's."""

    model_dir: str = ""
    encoders: tuple = (AUDIO, VIDEO, FLOW)
    separation: str = FREQ_MASK
    ambi_order: int = 1
    audio_rate: int = 48000
    video_rate: int = 10
    context: float = 1.0
    sample_dur: float = 0.1
    num_sep_tracks: int = 32
    fft_window: float = 0.025
    loc_units: tuple = (512, 512)
    frame_hw: tuple = (224, 448)
    dft_precision: str = "highest"
    compute_dtype: str = "float32"
    pallas_precision: str = "default"

    def model_config(self) -> SptAudioGenConfig:
        if self.compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype={self.compute_dtype!r}: the PyTorch port runs "
                f"float32 only so far (bf16 autocast is queued in ROADMAP.md)")
        return SptAudioGenConfig(
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
        """Write train-params.json (readable by both packages)."""
        model_dir = model_dir or self.model_dir
        os.makedirs(model_dir, exist_ok=True)
        with open(os.path.join(model_dir, "train-params.json"), "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2, default=list)

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
    for key in ("encoders", "loc_units", "frame_hw"):
        if key in out and isinstance(out[key], list):
            out[key] = tuple(out[key])
    return out
