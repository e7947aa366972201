#!/usr/bin/env python3
"""Smoke run of the PyTorch port (spatialaudiogen_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Drives the flagship deploy path (audio + RGB encoders, unet_mask head with
32 tracks, 224x448 frames, random weights from a seed) through the port's
own entry points, and fails (non-zero exit) on the first phase that goes
wrong:

  1. preconditions: a CUDA card, its name and power limit, torch/CUDA/nvcc;
  2. build: the fused masked comb-ISTFT kernel (K1) from the checkout's
     sources, with nvcc's register/spill report;
  3. kernel: K1 against its plain PyTorch version on the card at the
     flagship shapes (f32 and bf16 masks) and at a ragged shape, with
     median times of both (CUDA events);
  4. slice: MonoToAmbix.deploy over 2 s of a 4 s clip at batch 16 on the
     card (shape, finiteness, W passthrough bit for bit, K1 launched), and
     the same engine on the CPU over 0.5 s against the card;
  5. numbers: device-forward realtime factors at batch 32 and 128 and the
     deploy realtime factor.

The second-to-last line is a JSON object describing the kernels; the last
is {"ok": true, "device": {...}}. Without a CUDA card the script exits
non-zero and prints no result. Scratch files go to .chip_smoke/ in the
checkout and are removed at the end.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SCRATCH = ROOT / ".chip_smoke"
DEVICE = "cuda"
SEED = 0
RATE = 48000
FRAME_HW = (224, 448)
TRACKS = 32
FORWARD_BATCHES = (32, 128)
CLIP_SECONDS = 4
DEPLOY_START, DEPLOY_SECONDS, DEPLOY_BATCH = 0.5, 2.0, 16
CPU_SECONDS = 0.5
K1_REPLACES = "spatialaudiogen_tpu/ops/pallas_kernels.py:47"


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Median milliseconds of fn() on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# 1. preconditions
# ---------------------------------------------------------------------------

def preconditions() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA card")
    from spatialaudiogen_tpu_torch.ops import masked_istft

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    card = card.splitlines()[torch.cuda.current_device()]
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, nvcc {masked_istft._find_nvcc()}")
    # full float32 in matmuls and convolutions: parity numbers below
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------

def build_kernels() -> float:
    from spatialaudiogen_tpu_torch.ops import masked_istft

    path, seconds, report = masked_istft.build()
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            log(f"  nvcc: {line.strip()}")
    log(f"build: {path.relative_to(ROOT)} in {seconds:.1f} s"
        + (" (already built)" if not report else ""))
    return seconds


# ---------------------------------------------------------------------------
# 3. kernel phase: K1 against its plain version
# ---------------------------------------------------------------------------

def k1_inputs(gen, b, n_in, tracks, t, f, mask_dtype):
    dev = DEVICE
    re = torch.randn((b, n_in, t, f), generator=gen, device=dev)
    im = torch.randn((b, n_in, t, f), generator=gen, device=dev)
    mask = torch.rand((b, n_in, tracks, t, f), generator=gen, device=dev)
    return re, im, mask.to(mask_dtype)


def kernel_phase(card: str) -> dict:
    from spatialaudiogen_tpu_torch.ops import masked_istft as k1

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    cases = [  # name, (B, n_in, TR, T, F), mask dtype, atol, rtol
        ("flagship f32", (16, 1, 32, 28, 1024), torch.float32, 2e-4, 1e-4),
        ("flagship bf16 mask", (16, 1, 32, 28, 1024), torch.bfloat16, 2e-2, 2e-2),
        ("ragged f32", (3, 1, 5, 30, 1024), torch.float32, 2e-4, 1e-4),
    ]
    result = {}
    with torch.no_grad():
        for name, shape, dtype, atol, rtol in cases:
            re, im, mask = k1_inputs(gen, *shape, dtype)
            got = k1.masked_istft(re, im, mask)
            want = k1.masked_istft_plain(re, im, mask)
            torch.cuda.synchronize()
            if got.shape != want.shape:
                raise AssertionError(f"K1 {name}: shape {tuple(got.shape)} != "
                                     f"plain {tuple(want.shape)}")
            err = float((got - want).abs().max())
            ok = bool(torch.allclose(got, want, atol=atol, rtol=rtol))
            ms = time_ms(lambda: k1.masked_istft(re, im, mask))
            plain_ms = time_ms(lambda: k1.masked_istft_plain(re, im, mask))
            log(f"K1 {name} {shape}: max|kernel - plain| {err:.3e} "
                f"(atol {atol:g}, rtol {rtol:g}) -> {'ok' if ok else 'FAIL'}; "
                f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms [{card}]")
            if not ok:
                raise AssertionError(f"K1 {name} disagrees with its plain version")
            result[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return result


# ---------------------------------------------------------------------------
# 4. slice phase: the deploy engine on the card
# ---------------------------------------------------------------------------

def write_model_dir(model_dir: Path) -> None:
    """Flagship config + random weights from a torch.Generator seed, saved
    in the port's checkpoint format (train-params.json + params.npz)."""
    from spatialaudiogen_tpu_torch.config import TrainConfig
    from spatialaudiogen_tpu_torch.models.convert import save_params
    from spatialaudiogen_tpu_torch.models.sptaudiogen import SptAudioGen

    cfg = TrainConfig(model_dir=str(model_dir), encoders=("audio", "video"),
                      separation="unet_mask", num_sep_tracks=TRACKS, frame_hw=FRAME_HW)
    cfg.save()
    model = SptAudioGen(cfg.model_config(), frame_hw=FRAME_HW)
    model.init_weights(torch.Generator().manual_seed(SEED))
    save_params(str(model_dir), model.state_dict())


def write_clip(folder: Path) -> np.ndarray:
    """A 4 s clip in the packed layout (data/packed.py), written with numpy
    only: PCM16 FOA audio, 10 fps uint8 RGB frames (a bright blob moving
    over a textured background) and the audio power index. Returns the
    int16 audio."""
    rng = np.random.RandomState(SEED)
    n = CLIP_SECONDS * RATE
    t = np.arange(n) / RATE
    w = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.1 * rng.randn(n)
    az = np.linspace(-np.pi, np.pi, n)
    foa = np.stack([w, w * np.sin(az), 0.2 * w, w * np.cos(az)], 1)
    audio = np.clip(np.round(foa * 32767 * 0.8), -32768, 32767).astype(np.int16)

    h, wd = FRAME_HW
    n_frames = CLIP_SECONDS * 10
    ys, xs = np.mgrid[0:h, 0:wd]
    texture = rng.randint(0, 60, (h // 8, wd // 8, 3)).repeat(8, 0).repeat(8, 1)
    frames = np.empty((n_frames, h, wd, 3), np.uint8)
    for i in range(n_frames):
        cx = (i / n_frames) * wd
        blob = np.exp(-(((xs - cx) ** 2 + (ys - h / 2) ** 2) / (2 * (0.05 * wd) ** 2)))
        img = texture + blob[..., None] * np.array([255.0, 180.0, 40.0])
        frames[i] = np.clip(img, 0, 255)

    pack = folder / "packed"
    pack.mkdir(parents=True)
    np.save(pack / "ambix.npy", audio)
    np.save(pack / "video.npy", frames)
    meta = {"version": 1, "rate": RATE, "num_channels": 4, "num_files": CLIP_SECONDS,
            "audio_dtype": "int16", "video_frames": n_frames,
            "frame_shape": [h, wd, 3]}
    (pack / "meta.json").write_text(json.dumps(meta))
    with open(folder / "audio_pow.lst", "w") as f:
        for i in range((CLIP_SECONDS - 1) * 10):
            tt = i / 10.0 + 0.5
            ss = int(tt * RATE)
            seg = audio[ss: ss + RATE // 10, 0] / 32768.0
            f.write(f"{tt} {np.sqrt((seg ** 2).mean())}\n")
    return audio


def slice_phase(card: str) -> dict:
    from spatialaudiogen_tpu_torch.deploy.deploy import MonoToAmbix
    from spatialaudiogen_tpu_torch.ops import masked_istft as k1

    model_dir, clip = SCRATCH / "model", SCRATCH / "clip"
    write_model_dir(model_dir)
    audio = write_clip(clip)
    log(f"slice: flagship model dir and {CLIP_SECONDS} s packed clip written")

    engine = MonoToAmbix(str(model_dir), batch_size=DEPLOY_BATCH, device=DEVICE)
    k1.launch_count = 0
    t0 = time.perf_counter()
    ambi = engine.deploy(str(clip), deploy_start=DEPLOY_START,
                         deploy_duration=DEPLOY_SECONDS)
    first_s = time.perf_counter() - t0
    launches = k1.launch_count
    n = int(round(DEPLOY_SECONDS * RATE))
    log(f"deploy (card, batch {DEPLOY_BATCH}): shape {ambi.shape}, "
        f"{first_s:.3f} s wall (first call), K1 launches {launches}")
    if ambi.shape != (n, 4):
        raise AssertionError(f"deploy shape {ambi.shape} != {(n, 4)}")
    if not np.isfinite(ambi).all():
        raise AssertionError("deploy output is not finite")
    s0 = int(round(DEPLOY_START * RATE))
    w_in = audio[s0: s0 + n, 0].astype(np.float32) / 32768.0
    if not np.array_equal(ambi[:, 0], w_in):
        raise AssertionError("W passthrough is not the input bit for bit")
    if launches < 1:
        raise AssertionError("the deploy path never launched the K1 kernel")
    if not np.abs(ambi[:, 1:]).max() > 0:
        raise AssertionError("predicted channels are all zero")

    t0 = time.perf_counter()
    engine.deploy(str(clip), deploy_start=DEPLOY_START, deploy_duration=DEPLOY_SECONDS)
    warm_s = time.perf_counter() - t0
    log(f"deploy (card, batch {DEPLOY_BATCH}): {warm_s:.3f} s wall (warm) -> "
        f"{DEPLOY_SECONDS / warm_s:.2f}x realtime [{card}]")

    # the same engine on the CPU over 0.5 s: one uneven batch (pad lanes)
    exact = {}
    for dev in (DEVICE, "cpu"):
        eng = MonoToAmbix(str(model_dir), batch_size=DEPLOY_BATCH, device=dev,
                          f16_fetch=False)
        exact[dev] = eng.deploy(str(clip), deploy_start=DEPLOY_START,
                                deploy_duration=CPU_SECONDS)
    if not np.array_equal(exact[DEVICE][:, 0], exact["cpu"][:, 0]):
        raise AssertionError("W passthrough differs between card and CPU")
    err = rel_l2(exact[DEVICE][:, 1:], exact["cpu"][:, 1:])
    log(f"deploy card vs CPU over {CPU_SECONDS} s (f32 fetch, TF32 off): "
        f"relative L2 {err:.3e} (limit 1e-4)")
    if not err <= 1e-4:
        raise AssertionError(f"card and CPU deploy disagree: relative L2 {err:.3e}")
    return {"launches": launches, "deploy_first_s": first_s, "deploy_warm_s": warm_s}


# ---------------------------------------------------------------------------
# 5. numbers: device-forward realtime factor
# ---------------------------------------------------------------------------

def forward_numbers(card: str) -> None:
    from spatialaudiogen_tpu_torch.config import TrainConfig
    from spatialaudiogen_tpu_torch.models.convert import load_params
    from spatialaudiogen_tpu_torch.models.sptaudiogen import SptAudioGen

    model_dir = SCRATCH / "model"
    cfg = TrainConfig.load(str(model_dir))
    cfg.sample_dur = 0.1
    mcfg = cfg.model_config()
    g = mcfg.geometry
    model = SptAudioGen(mcfg, frame_hw=FRAME_HW)
    model.load_state_dict(load_params(str(model_dir)))
    model.to(DEVICE).eval()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    for batch in FORWARD_BATCHES:
        audio = 0.1 * torch.randn((batch, g.snd_size, 1), generator=gen, device=DEVICE)
        video = torch.rand((batch, g.vid_dur) + FRAME_HW + (3,), generator=gen,
                           device=DEVICE) - 0.5
        with torch.no_grad():
            ms = time_ms(lambda: model(audio, video), warmup=2, iters=10)
        rtf = batch * g.snd_dur / RATE / (ms / 1e3)
        log(f"device forward batch {batch} f32: {ms:.2f} ms -> {rtf:.1f}x realtime, "
            f"{batch / (ms / 1e3):.0f} windows/s [{card}]")
        del audio, video
    torch.cuda.empty_cache()


def main() -> int:
    card = preconditions()
    shutil.rmtree(SCRATCH, ignore_errors=True)
    SCRATCH.mkdir()
    try:
        build_kernels()
        k1_times = kernel_phase(card)
        slice_result = slice_phase(card)
        forward_numbers(card)
    finally:
        shutil.rmtree(SCRATCH, ignore_errors=True)
    flagship = k1_times["flagship f32"]
    kernels = [{"name": "masked_istft", "route": "cuda",
                "source": "spatialaudiogen_tpu_torch/ops/csrc/masked_istft.cu",
                "replaces": K1_REPLACES, "launches": slice_result["launches"],
                "max_abs_err": flagship["max_abs_err"], "ms": flagship["ms"],
                "plain_ms": flagship["plain_ms"]}]
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
