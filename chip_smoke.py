#!/usr/bin/env python3
"""Smoke run of the PyTorch port (spatialaudiogen_tpu_torch) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --multi_card   # phases 14 and 15's runs, a card per rank

Drives the flagship model (audio + RGB encoders, unet_mask head with 32
tracks, 224x448 frames, random weights from a seed) through the port's own
entry points, deploy, training, eval and serving, in its three
configurations (the default NCHW U-Net in float32, the NHWC-mask U-Net,
bf16 compute), then
the reference's default model (audio + flow + video encoders) the same
way, and the flow ETL's solver on the card (phase 17), and fails
(non-zero exit) on the first phase that goes wrong:

  1. preconditions: a CUDA card, its name and power limit, torch/CUDA/nvcc;
  2. build: the kernels (K1, the fused masked comb-ISTFT; K2, its fused
     backward; K3, K1 over an NHWC mask) from the checkout's sources, one
     nvcc per source started together, with nvcc's register/spill report;
  3. kernels: K1, K2 and K3 at both pallas_precision routes ("default":
     bf16 wgmma; "highest": 3xTF32 wgmma) against their plain versions at
     the same precision, at the flagship shapes, a ragged one and the
     (F, mask frames) that cli.train's flags reach (F 64 and 128, 108 and
     140 frames, F 2048), with f32 and bf16 masks (K3 on the cropped
     channels_last mask, read in place: its vector and its scalar route),
     the bf16 route 1e-4 to 1e-2 from
     float32, 3xTF32 on mixed-scale inputs ten times nearer a float64 run
     than one TF32 pass; K3 within 1e-6 of K1 on the mask made
     track-major, and K3's backward; median times (CUDA events) of each
     kernel, its plain version, a bare torch.matmul of the same GEMM in
     the route's type, each route's bound, and for K3 K1 on the mask made
     track-major (copy included);
  4. deploy: MonoToAmbix.deploy over 2 s of a 4 s clip at batch 16 on the
     card (shape, finiteness, W passthrough bit for bit, K1 launched), and
     the same params on the CPU over 0.5 s against the card at
     pallas_precision "highest" (<= 1e-4) and "default" (1e-4 to 1e-2);
  5. forward numbers: device-forward realtime factors at batch 32 and 128
     for the NCHW and NHWC layouts in f32 and for bf16, and a profile of
     each batch-128 forward by kernel family;
  6. NHWC path: the flagship forward with pallas_nhwc=True against the
     default layout at the same weights, both at "highest" (<= 1e-5) and
     both at "default" (at most a tenth of the NCHW forward's own
     "default"-vs-"highest" gap: K3 rounds as K1 does), K3 launched once
     and K1 never; then one flagship train step at batch 32 on the
     model's default (K3 and K2 launched once each);
  7. train: cli.train for 6 steps at batch 32 over a packed two-clip
     dataset (finite losses, K1 and K2 launched on every step, params
     moved), then MonoToAmbix deploys the trained model on the card;
  8. bf16 train: cli.train --bf16 the same way (float32 params, a bf16
     mask into K1 and K2), then MonoToAmbix(compute_dtype="bfloat16")
     deploys it, held to the float32 deploy of the same params;
  9. train card vs CPU: one reduced train step on both, loss and gradient,
     for the NCHW and the NHWC U-Net, at pallas_precision "highest";
 10. train numbers: train-step time and samples/s at batch 32 and 128 in
     f32 and bf16, and a profile of one step at each by kernel family
     (torch.profiler);
 11. default model (audio, flow and video encoders): deploy through the
     per-window host path at batch 32, card vs CPU at "highest" (<= 1e-4,
     the last batch padded), its realtime factor and the host assembly's
     seconds; the batch-128 forward (f32, bf16) and train step (f32,
     bf16) timed and profiled; cli.train with the default encoders for 6
     steps (K1 and K2 launched on every step);
 12. eval: cli.eval of the model phase 7 trained, at batch 16 over that
     phase's dataset (34 samples: three batches, the last padded), in the
     exact mode (host metrics, native EMD) and with --device_metrics --emd
     sinkhorn, rows, header and finiteness checked, the two modes' rows
     held to each other (EMD rtol 5e-3 / atol 5e-4, the rest rtol 1e-4 /
     atol 1e-5), K1 launched once per batch; eval samples/s, the device
     step, Sinkhorn's ms per batch; then the device mel-LSD and envelope
     after a dft_precision="default" forward, TF32 left on in the
     process, within 1e-5 of float64 on the CPU;
 13. serve: StreamingMonoToAmbix over 3 s of phase 4's clip in 0.1 s
     pushes, one frame each, then flush: bit for bit
     MonoToAmbix(batch_size=1, yuv_frames=False).deploy() over the same
     span, K1 once per window and K2 never, per-window latency (median,
     p90), the batch-1 forward and K1 at batch 1 (CUDA events), the
     batch-128 forward with and without deterministic cuDNN (one distinct
     output of 10 with it); the bf16 stream 1e-3 to 0.1 from the f32 one;
     StreamBatcher at capacity 1 bit for bit the stream; with an
     audio-only unet_mask 32-track model, lane isolation at capacity 32
     bit for bit and 4 lanes within one f16 ulp of independent streams
     (> 99.5% bitwise on 3xTF32, 99% on bf16); the flagship batcher at
     capacity 32 and 128, f32 and bf16, over 2 s (per-tick latency,
     aggregate realtime factor, K1 once per tick), then 3 s at capacity
     128 f32 paced at wall-clock rate (kept_up: p90 tick < 100 ms);
     cli.serve single and 2-session batched over wavs and the packed clip;
 14. multi-device train: cli.train over phase 7's dataset in the
     --coordinator form, two ranks sharing the card (gloo), flagship at
     global batch 32, kernels on 3xTF32: data parallel (n_data 2, 2 steps,
     one clip per rank) and tensor parallel (n_model 2, 2 steps, audio-fc
     split), each held to one process on the same global batches (losses
     within 1e-4 relative on every step: MD_LOSS_RTOL says why), K1 and
     K2 launched once per step on every rank, each rank's step ms and the
     all-reduce's share of rank 0's profiled last step; the spread of one
     process against itself over 3 steps with the halves of each batch
     swapped; then cli.train --tb_histograms 2 --tb_activations --pretrained_resnet (a resnet18.npy it writes) for 3
     steps: conv1 the npy's slice at step 0, the params, grads and acts
     histograms decode, K1/K2 launched once per step and once per observe
     step.

 15. sharded inference: cli.deploy, cli.eval and cli.serve with --n_data 2
     (two ranks sharing the card, so over gloo; a process a rank,
     INFER_RANK_MAIN) against --n_data 1 in this process, the flagship at
     pallas_precision "highest": deploy of phase 4's clip (2 s at batch
     16, --f32_fetch; the tail batch's pad lanes on both ranks) within
     1e-5; eval of phase 7's model in Sinkhorn mode, the one file's rows
     in the same order (EMD rtol 1e-3 / atol 1e-5, the rest rtol 1e-4 /
     atol 1e-5); serve of four flagship sessions (cli.serve fetches
     float16) within one f16 ulp or 1e-5; K1's launches on every rank,
     each run's warm repeat's time and realtime factor beside one
     process's;
 16. order 2: cli.train --ambi_order 2 for 6 steps at batch 32 over two
     9-channel packed clips it writes (K1 and K2 once per step: n_in = 4),
     MonoToAmbix's 9-channel deploy of the result (W, Y, Z, X passed
     through bit for bit), the card against the CPU at "highest" (<=
     1e-4), an Evaluator pass (K1 once per batch), and the order-2
     forward and train step timed at batch 32. Phase 3 also holds K1 and
     K2 at n_in = 4 ("order 2" cases, flagship shapes);
 17. flow: the flow ETL's Horn-Schunck solver (ops/flow.py, plain PyTorch;
     the JAX module holds no Pallas kernel) on the card at 224x448 with
     the JAX defaults and pair_batch 16, over 33 frames of a natural
     texture under zoom + pan with a moving blob, fb_occlusion off and
     on: within 1e-3 px of the port's CPU run of the same frames, zoom +
     pan end-point error under 0.15 px, pairs/s (median of 3 warm runs),
     CUDA launches per pair-batch and the profile's busy share; then the
     default model (audio + flow + video) deploys over a packed clip whose
     flow maps are the card's flow encoded by etl.preprocess.flow_frame_rgb
     (finite, W passed through, K1 launched). The mux and the ETL's
     ffmpeg and jpg steps do not run on the card's host, which has
     neither ffmpeg nor Pillow.

Phase 10 also times the batch-128 train steps with cuDNN's deterministic
algorithms, and phase 12 checks that five eval steps of one batch give
one output (the eval step runs them).

With --multi_card (two cards or more) it builds the kernels and runs only
phase 14's parallel runs, each rank on a card of its own, so that the
mesh's groups run on NCCL: data parallel and tensor parallel on two
cards, and n_data 2 x n_model 2 on four, held to one process as phase 14
holds its runs; then phase 15's three sharded runs on two cards; the last
line is the same JSON object, with the count of cards.

The kernel counts are set to 0 just before each main-path run (deploy,
the NHWC forward and train step, the f32, bf16 and default-model
trainings, the default model's deploy, each cli.eval run, the f32 serve
stream, the serve batcher's ticks, each rank's cli.train and the
TensorBoard cli.train of phase 14, each rank's and each one process's CLI
of phase 15, phase 16's cli.train, deploy and eval, phase 17's deploy) and
read just after it. Everything else runs the model's default pallas_precision, "default"
(K1, K2 and K3 on bf16), except phases 14 and 15's runs ("highest"). The second-to-last line is a JSON object describing the
kernels (top-level times the bf16 route's, the 3xTF32 route's under
"highest"; K1's and K2's launches are those of the f32 training, K3's
those of the NHWC train step, with the NHWC forward's count under
"forward_launches", the default model's training's under
"default_model_launches", K1's in the exact-mode cli.eval under
"eval_launches", in the f32 serve stream under "serve_launches", in the
capacity-128 f32 batcher's 20 ticks under "serve_batcher_launches", and
its batch-1 times under "serve_batch1"; K1's and K2's per rank in phase
14's data and tensor parallel runs, and in its TensorBoard run, under
"multi_device_launches"; K1's per rank in phase 15's sharded deploy, eval
and serve under "sharded_launches", and K1's and K2's in phase 16's
order-2 training (K1's also in its deploy and eval) under
"order2_launches", and K1's in phase 17's deploy over the card-made flow
maps under "flow_deploy_launches"; "shapes" names every shape a
kernel was held to its plain version at, with its bf16-route times); the
last is
{"ok": true, "device": {...}}. Without a CUDA card the
script exits non-zero and prints no result. Scratch files go to
.chip_smoke/ in the checkout and are removed at the end.
"""

from __future__ import annotations

import contextlib
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
TRAIN_BATCHES = (32, 128)
TRAIN_STEPS = 6
TRAIN_CLIP_SECONDS = 18
EVAL_BATCH = 16
K1_REPLACES = "spatialaudiogen_tpu/ops/pallas_kernels.py:47"
K2_REPLACES = "spatialaudiogen_tpu/ops/pallas_kernels.py:141"
K3_REPLACES = "spatialaudiogen_tpu/ops/pallas_kernels.py:333"
PRECISIONS = ("default", "highest")   # kernel routes: bf16 wgmma, 3xTF32 wgmma
# H100 SXM published peaks (dense): bf16 and TF32 on the tensor cores, and
# device-memory bandwidth. A route's bound is the
# larger of its operations over its peak (3xTF32: three TF32 passes) and
# its bytes over the bandwidth.
ROUTE_FLOPS = {"default": 989e12, "highest": 495e12 / 3}
HBM_BYTES_PER_S = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_l2(a, b) -> float:
    if isinstance(a, torch.Tensor):
        return float((a.double() - b.double()).norm() / b.double().norm())
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


def bound(flops: float, nbytes: float, route: str) -> tuple[float, str]:
    """(least ms the card could take on `route`, what bounds it)."""
    t_ops, t_bytes = flops / ROUTE_FLOPS[route], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def istft_work(re, mask, route: str) -> tuple[float, float, float, int]:
    """(flops, input bytes besides the mask, mask bytes, GEMM rows) of one
    K1 or K2 call: the GEMM over (track, frame) rows of the used frames,
    depth F against [C | S], and re, im and both bases read once (the bases
    in bf16 on the "default" route, float32 otherwise)."""
    b, n_in, t, f = re.shape
    t_use = (t // 4) * 4
    rows = b * n_in * mask.shape[2] * t_use
    flops = 2.0 * rows * (2 * f) * f
    spectra = 2 * re.numel() * 4 + 2 * f * f * (2 if route == "default" else 4)
    return flops, spectra, mask.numel() * mask.element_size(), rows


def gemm_ms(rows: int, f: int, precision: str) -> float:
    """One bare torch.matmul of the kernels' product, (rows x 2F) @ (2F x F),
    in the route's operand type: bf16, or float32 with TF32 allowed. A
    yardstick of the tensor cores on this shape, not a library call for the
    fused function."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
    dtype = torch.bfloat16 if precision == "default" else torch.float32
    a = torch.randn((rows, 2 * f), generator=gen, device=DEVICE).to(dtype)
    b = torch.randn((2 * f, f), generator=gen, device=DEVICE).to(dtype)
    torch.backends.cuda.matmul.allow_tf32 = precision == "highest"
    try:
        return time_ms(lambda: torch.matmul(a, b))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


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
        if any(key in line.lower() for key in ("registers", "spill", "error", "warning")):
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


KERNEL_CASES = [  # name, (B, n_in, TR, T, F), mask dtype
    ("flagship f32", (16, 1, 32, 28, 1024), torch.float32),
    ("flagship bf16 mask", (16, 1, 32, 28, 1024), torch.bfloat16),
    ("ragged f32", (3, 1, 5, 30, 1024), torch.float32),
    ("ragged bf16 mask", (3, 1, 5, 30, 1024), torch.bfloat16),
    # ambi_order=2: n_in = 4 input channels, the (B, n_in) axis one stride
    ("order 2 f32", (16, 4, 32, 28, 1024), torch.float32),
    ("order 2 bf16 mask", (16, 4, 32, 28, 1024), torch.bfloat16),
]
# The (F, mask frames) that cli.train's flags reach beyond the flagship
# (--audio_rate / --fft_window / --sample_dur; dsp/geometry.py), at batch
# 16 with the model's 32 tracks: F below 256, more than 128 used frames
# (overlapping chunks in K1 and K3), F = 2048.
SHAPE_CASES = [
    ("F128 T58", (16, 1, 32, 58, 128), torch.float32),        # --audio_rate 16000 --fft_window 0.01
    ("F64 T58", (16, 1, 32, 58, 64), torch.float32),          # --audio_rate 8000 --fft_window 0.01
    ("F64 T108 bf16 mask", (16, 1, 32, 108, 64), torch.bfloat16),   # 16000, 0.005
    ("F1024 T140", (16, 1, 32, 140, 1024), torch.float32),    # --sample_dur 0.7, audio only
    ("F2048 T19", (16, 1, 32, 19, 2048), torch.float32),      # --fft_window 0.05
]


def check_default_route(what: str, got, want_f32) -> float:
    """The bf16 route lies 1e-4 to 1e-2 (relative L2) from the float32
    function: below, no bf16 rounding ran; the TPU's DEFAULT is 2.2e-3."""
    err = rel_l2(got, want_f32)
    log(f"  {what}: relative L2 to the float32 plain version {err:.3e} (limits 1e-4, 1e-2)")
    if not 1e-4 <= err <= 1e-2:
        raise AssertionError(f"{what}: the bf16 route is {err:.3e} from float32")
    return err


def mixed_scale(x, gen):
    """x times 10^u, u uniform in [-2, 2]: large and small values mixed."""
    return x * torch.pow(10.0, 4 * torch.rand(x.shape, generator=gen, device=DEVICE) - 2)


def check_3xtf32(what: str, got, plain, args) -> float:
    """The 3xTF32 route on mixed-scale inputs against the plain version in
    float64: at least ten times nearer than the same plain version with its
    products in one TF32 pass (cuBLAS with TF32 allowed), so the lo parts
    ran. Prints cuBLAS float32's own distance beside it."""
    def dist(outs):
        outs = outs if isinstance(outs, tuple) else (outs,)
        return max(rel_l2(a, w) for a, w in zip(outs, want))

    want = plain(*(x.double() for x in args))
    want = want if isinstance(want, tuple) else (want,)
    f32 = dist(plain(*args))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = dist(plain(*args))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    err = dist(got)
    log(f"{what} on mixed-scale inputs, relative L2 to float64: 3xTF32 kernel {err:.3e}, "
        f"cuBLAS float32 {f32:.3e}, one TF32 pass {tf32:.3e} (limit: a tenth of it)")
    if not err <= tf32 / 10:
        raise AssertionError(f"{what}: 3xTF32 is {err:.3e} from float64, one TF32 pass "
                             f"{tf32:.3e}")
    return err


def kernel_phase(card: str) -> dict:
    """K1 against masked_istft_plain at both precisions, at the flagship
    shapes (batch 16) and a ragged one (5 tracks, T % 4 == 2), f32 and bf16
    masks. Both routes differ from their plain version (the same rounded
    operands on "default") only in float32 summation order, so both are
    held to tests/test_pallas.py's f32 forward tolerance, 2e-4 / 1e-4 (the
    outputs are about 1e-2): "highest" against the float32 function,
    "default" against the plain version that rounds the same operands to
    bf16, which also lies 1e-4 to 1e-2 from float32. "highest" on spectra of
    mixed scale (1e-2 to 1e2) is held to a float64 run (check_3xtf32)."""
    from spatialaudiogen_tpu_torch.ops import masked_istft as k1

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    atol, rtol = 2e-4, 1e-4
    result = {}
    with torch.no_grad():
        for name, shape, dtype in KERNEL_CASES + SHAPE_CASES:
            re, im, mask = k1_inputs(gen, *shape, dtype)
            want_f32 = k1.masked_istft_plain(re, im, mask)
            for precision in PRECISIONS:
                got = k1.masked_istft(re, im, mask, 4, precision)
                want = k1.masked_istft_plain(re, im, mask, 4, precision)
                torch.cuda.synchronize()
                if got.shape != want.shape:
                    raise AssertionError(f"K1 {name}: shape {tuple(got.shape)} != "
                                         f"plain {tuple(want.shape)}")
                err = float((got - want).abs().max())
                ok = bool(torch.allclose(got, want, atol=atol, rtol=rtol))
                ms = time_ms(lambda: k1.masked_istft(re, im, mask, 4, precision))
                plain_ms = time_ms(lambda: k1.masked_istft_plain(re, im, mask, 4, precision))
                flops, spectra, mask_bytes, rows = istft_work(re, mask, precision)
                bound_ms, bound_by = bound(flops, spectra + mask_bytes + got.numel() * 4,
                                           precision)
                g_ms = gemm_ms(rows, shape[-1], precision)
                log(f"K1 {name} {shape} {precision}: max|kernel - plain| {err:.3e} "
                    f"(atol {atol:g}, rtol {rtol:g}) -> {'ok' if ok else 'FAIL'}; "
                    f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, gemm {g_ms:.3f} ms, "
                    f"bound {bound_ms:.3f} ms by {bound_by} [{card}]")
                if not ok:
                    raise AssertionError(f"K1 {name} {precision} disagrees with its plain "
                                         f"version")
                entry = {"shape": list(shape), "max_abs_err": err, "ms": ms,
                         "plain_ms": plain_ms, "gemm_ms": g_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by}
                if precision == "default":
                    entry["rel_l2_f32"] = check_default_route(f"K1 {name}", got, want_f32)
                result[name, precision] = entry
        re, im, mask = k1_inputs(gen, 2, 1, 8, 28, 1024, torch.float32)
        re, im = mixed_scale(re, gen), mixed_scale(im, gen)
        check_3xtf32("K1", k1.masked_istft(re, im, mask, 4, "highest"),
                     k1.masked_istft_plain, (re, im, mask))
    return result


def bwd_kernel_phase(card: str) -> dict:
    """K2 against masked_istft_bwd_plain at both precisions, at the
    flagship shapes (batch 16) and a ragged one; tolerances of
    tests/test_pallas.py:142-159 (f32) for both routes (summation order
    only: "default" is held to the plain version that rounds the same
    operands to bf16). With a bf16 mask, d_mask comes back bf16 from both
    routes, and their float32 sums may round to neighbouring bf16 values
    (one step is at most 2^-7 relative): 1e-3 / 1e-2. "default" also lies
    1e-4 to 1e-2 from the float32 gradients; "highest" on a cotangent of
    mixed scale is held to a float64 run (check_3xtf32)."""
    from spatialaudiogen_tpu_torch.ops import masked_istft as k

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    result = {}
    with torch.no_grad():
        for name, shape, dtype in KERNEL_CASES + SHAPE_CASES:
            atol, rtol = (5e-4, 1e-4) if dtype == torch.float32 else (1e-3, 1e-2)
            re, im, mask = k1_inputs(gen, *shape, dtype)
            b, n_in, tracks, t, f = shape
            out_len = (t // 4) * f - 3 * f // 4
            g = torch.randn((b, n_in, tracks, out_len), generator=gen, device=DEVICE)
            want_f32 = k.masked_istft_bwd_plain(re, im, mask, g)
            for precision in PRECISIONS:
                got = k.masked_istft_bwd(re, im, mask, g, 4, precision)
                want = k.masked_istft_bwd_plain(re, im, mask, g, 4, precision)
                torch.cuda.synchronize()
                err, ok = 0.0, True
                for part, a, w in zip(("d_re", "d_im", "d_mask"), got, want):
                    if a.shape != w.shape or a.dtype != w.dtype:
                        raise AssertionError(f"K2 {name} {part}: {tuple(a.shape)} {a.dtype} "
                                             f"!= plain {tuple(w.shape)} {w.dtype}")
                    err = max(err, float((a.float() - w.float()).abs().max()))
                    ok = ok and bool(torch.allclose(a.float(), w.float(), atol=atol,
                                                    rtol=rtol))
                if t % 4 and float(got[2][..., (t // 4) * 4:, :].abs().max()) != 0.0:
                    raise AssertionError(f"K2 {name}: dropped frames got a gradient")
                ms = time_ms(lambda: k.masked_istft_bwd(re, im, mask, g, 4, precision))
                plain_ms = time_ms(lambda: k.masked_istft_bwd_plain(re, im, mask, g, 4,
                                                                    precision))
                flops, spectra, mask_bytes, rows = istft_work(re, mask, precision)
                nbytes = spectra + 2 * mask_bytes + g.numel() * 4 + 2 * re.numel() * 4
                bound_ms, bound_by = bound(flops, nbytes, precision)
                g_ms = gemm_ms(rows, f, precision)
                log(f"K2 {name} {shape} {precision}: max|kernel - plain| {err:.3e} "
                    f"(atol {atol:g}, rtol {rtol:g}) -> {'ok' if ok else 'FAIL'}; "
                    f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, gemm {g_ms:.3f} ms, "
                    f"bound {bound_ms:.3f} ms by {bound_by} [{card}]")
                if not ok:
                    raise AssertionError(f"K2 {name} {precision} disagrees with its plain "
                                         f"version")
                entry = {"shape": list(shape), "max_abs_err": err, "ms": ms,
                         "plain_ms": plain_ms, "gemm_ms": g_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by}
                if precision == "default":
                    entry["rel_l2_f32"] = max(
                        check_default_route(f"K2 {name} {part}", a, w)
                        for part, a, w in zip(("d_re", "d_im", "d_mask"), got, want_f32))
                result[name, precision] = entry
        re, im, mask = k1_inputs(gen, 2, 1, 8, 28, 1024, torch.float32)
        g = mixed_scale(torch.randn((2, 1, 8, 6400), generator=gen, device=DEVICE), gen)
        check_3xtf32("K2", k.masked_istft_bwd(re, im, mask, g, 4, "highest"),
                     k.masked_istft_bwd_plain, (re, im, mask, g))
    return result


def nhwc_mask(gen, b, tracks, t, f, dtype, height, start):
    """The mask as the NHWC model makes it: frames [start, start + t) of a
    channels_last (B, TR, height, F) deconv output, viewed (B, T, F, TR)."""
    full = torch.rand((b, tracks, height, f), generator=gen, device=DEVICE)
    full = full.to(dtype).contiguous(memory_format=torch.channels_last)
    return full[:, :, start: start + t].permute(0, 2, 3, 1)


def nhwc_kernel_phase(card: str) -> dict:
    """K3 against masked_istft_nhwc_plain at both precisions, on the cropped
    channels_last mask read in place, at the flagship shapes (batch 16: the
    vector route, 4 tracks a load) and a ragged shape (5 tracks: the scalar
    route; T % 4 == 2), f32 and bf16 masks; K1's tolerances and checks
    (kernel_phase), and K3 within 1e-6 of K1 on the mask made track-major
    (K3 keeps K1's rows, k order, bases and epilogue). k1_ms times that
    K1 call at the same precision, the track-major copy included. The
    backward (K2 on the track-major mask, f32 masks, "highest") against
    plain autograd."""
    from spatialaudiogen_tpu_torch.config import SptAudioGenConfig
    from spatialaudiogen_tpu_torch.models.sptaudiogen import AUDIO_KERNELS, AUDIO_STRIDES
    from spatialaudiogen_tpu_torch.ops import masked_istft as k

    g = SptAudioGenConfig().geometry
    (kh, _), (sh, _) = AUDIO_KERNELS[0], AUDIO_STRIDES[0]
    height = (g.deconv1_in_hi - g.deconv1_in_lo) * sh + kh - sh   # narrowed deconv1 frames
    flagship = (16, TRACKS, g.n_mask_frames, g.wind_size, height, g.narrowed_deconv_ss)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    cases = [  # name, (B, TR, T, F, deconv frames, crop start), mask dtype, vector route
        ("flagship f32", flagship, torch.float32, True),
        ("flagship bf16 mask", flagship, torch.bfloat16, True),
        ("ragged f32", (3, 5, 30, 1024, 36, 2), torch.float32, False),
        ("ragged bf16 mask", (3, 5, 30, 1024, 36, 2), torch.bfloat16, False),
    ] + [  # SHAPE_CASES on a cropped channels_last mask of 6 more frames
        (name, (b, tracks, t, f, t + 6, 3), dtype, vector)
        for name, (b, _, tracks, t, f), dtype in SHAPE_CASES
        # the vector route when a 64-row tile holds an even number of tracks
        for vector in [(t // 4) * 4 <= 32]]
    atol, rtol = 2e-4, 1e-4
    result = {}
    for name, shape, dtype, vector in cases:
        b, tracks, t, f, height, start = shape
        re = torch.randn((b, t, f), generator=gen, device=DEVICE)
        im = torch.randn((b, t, f), generator=gen, device=DEVICE)
        mask = nhwc_mask(gen, b, tracks, t, f, dtype, height, start)
        route = "vector" if k.nhwc_vector_route(mask, (t // 4) * 4) else "scalar"
        if (route == "vector") != vector:
            raise AssertionError(f"K3 {name}: took the {route} route")

        def k1_track_major(precision):
            tm = mask.permute(0, 3, 1, 2)[:, None].contiguous()
            return k.masked_istft(re[:, None], im[:, None], tm, 4, precision)[:, 0]

        with torch.no_grad():
            want_f32 = k.masked_istft_nhwc_plain(re, im, mask)
            for precision in PRECISIONS:
                got = k.masked_istft_nhwc(re, im, mask, 4, precision)
                want = k.masked_istft_nhwc_plain(re, im, mask, 4, precision)
                k1_err = float((got - k1_track_major(precision)).abs().max())
                torch.cuda.synchronize()
                if got.shape != want.shape:
                    raise AssertionError(f"K3 {name}: shape {tuple(got.shape)} != "
                                         f"plain {tuple(want.shape)}")
                err = float((got - want).abs().max())
                ok = bool(torch.allclose(got, want, atol=atol, rtol=rtol))
                ms = time_ms(lambda: k.masked_istft_nhwc(re, im, mask, 4, precision))
                plain_ms = time_ms(lambda: k.masked_istft_nhwc_plain(re, im, mask, 4,
                                                                     precision))
                k1_ms = time_ms(lambda: k1_track_major(precision))
                flops, spectra, mask_bytes, rows = istft_work(
                    re[:, None], mask.permute(0, 3, 1, 2)[:, None], precision)
                bound_ms, bound_by = bound(flops, spectra + mask_bytes + got.numel() * 4,
                                           precision)
                g_ms = gemm_ms(rows, f, precision)
                log(f"K3 {name} (B, TR, T, F) {shape[:4]} {precision}, {route} route, mask "
                    f"strides {mask.stride()}: max|kernel - plain| {err:.3e} (atol {atol:g}, "
                    f"rtol {rtol:g}) -> {'ok' if ok else 'FAIL'}, max|K3 - K1 on the "
                    f"track-major mask| {k1_err:.3e} (limit 1e-6); kernel {ms:.3f} ms, plain "
                    f"{plain_ms:.3f} ms, K1 on the mask made track-major (copy included) "
                    f"{k1_ms:.3f} ms, gemm {g_ms:.3f} ms, bound {bound_ms:.3f} ms by "
                    f"{bound_by} [{card}]")
                if not ok:
                    raise AssertionError(f"K3 {name} {precision} disagrees with its plain "
                                         f"version")
                if not k1_err <= 1e-6:
                    raise AssertionError(f"K3 {name} {precision} is {k1_err:.3e} from K1 on "
                                         f"the track-major mask")
                entry = {"shape": [b, 1, tracks, t, f], "max_abs_err": err, "ms": ms,
                         "plain_ms": plain_ms, "k1_ms": k1_ms, "gemm_ms": g_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by}
                if precision == "default":
                    entry["rel_l2_f32"] = check_default_route(f"K3 {name}", got, want_f32)
                result[name, precision] = entry
        if dtype != torch.float32:
            continue
        # backward: K2 on the mask made track-major, against plain autograd
        w = torch.randn(want_f32.shape, generator=gen, device=DEVICE)
        grads = {}
        for route, fn in (("kernel", k.masked_istft_nhwc), ("plain", k.masked_istft_nhwc_plain)):
            args = [x.detach().clone().requires_grad_() for x in (re, im)]
            args.append(mask.detach().requires_grad_())
            (fn(*args) * w).sum().backward()
            grads[route] = [x.grad for x in args]
        torch.cuda.synchronize()
        bwd_err = max(float((a - p).abs().max()) for a, p in zip(*grads.values()))
        bwd_ok = all(torch.allclose(a, p, atol=5e-4, rtol=1e-4) for a, p in zip(*grads.values()))
        log(f"K3 {name} backward (K2 on the track-major mask) vs plain autograd: max "
            f"|diff| {bwd_err:.3e} over d_re, d_im, d_mask (atol 5e-4, rtol 1e-4) -> "
            f"{'ok' if bwd_ok else 'FAIL'}")
        if not bwd_ok:
            raise AssertionError(f"K3 {name}: gradients disagree with the plain version's")
        if t % 4 and float(grads["kernel"][2][:, (t // 4) * 4:].abs().max()) != 0.0:
            raise AssertionError(f"K3 {name}: dropped frames got a gradient")
    b, tracks, t, f, height, start = flagship
    re, im = (mixed_scale(torch.randn((2, t, f), generator=gen, device=DEVICE), gen)
              for _ in range(2))
    mask = nhwc_mask(gen, 2, 8, t, f, torch.float32, height, start)
    with torch.no_grad():
        check_3xtf32("K3", k.masked_istft_nhwc(re, im, mask, 4, "highest"),
                     k.masked_istft_nhwc_plain, (re, im, mask))
    return result


# ---------------------------------------------------------------------------
# 4. slice phase: the deploy engine on the card
# ---------------------------------------------------------------------------

def write_model_dir(model_dir: Path, encoders=("audio", "video")) -> None:
    """Flagship config (or another encoder set) + random weights from a
    torch.Generator seed, saved in the port's checkpoint format
    (train-params.json + params.npz)."""
    from spatialaudiogen_tpu_torch.config import TrainConfig
    from spatialaudiogen_tpu_torch.models.convert import save_params
    from spatialaudiogen_tpu_torch.models.sptaudiogen import SptAudioGen

    cfg = TrainConfig(model_dir=str(model_dir), encoders=tuple(encoders),
                      separation="unet_mask", num_sep_tracks=TRACKS, frame_hw=FRAME_HW)
    cfg.save()
    model = SptAudioGen(cfg.model_config(), frame_hw=FRAME_HW)
    model.init_weights(torch.Generator().manual_seed(SEED))
    save_params(str(model_dir), model.state_dict())


def write_clip(folder: Path, seed: int = SEED, level: float = 1.0,
               seconds: int = CLIP_SECONDS, order: int = 1) -> np.ndarray:
    """A clip of `seconds` (4 by default) in the packed layout
    (data/packed.py), written with numpy only: PCM16 ambisonics of
    `order` ((order + 1)^2 ACN channels: FOA by default, nine at order 2),
    10 fps uint8 RGB frames (a bright blob moving over a textured
    background), flow pixels (angle and magnitude bytes, as the flow jpgs
    hold them) with per-frame magnitude limits, and the audio power index.
    `level` scales the audio (1.0: an RMS of about 0.19). Returns the
    int16 audio."""
    rng = np.random.RandomState(seed)
    n = seconds * RATE
    t = np.arange(n) / RATE
    w = level * (0.3 * np.sin(2 * np.pi * 440 * t) + 0.1 * rng.randn(n))
    az = np.linspace(-np.pi, np.pi, n)
    channels = [w, w * np.sin(az), 0.2 * w, w * np.cos(az)]
    if order == 2:   # V, T, R, S, U of a source on the horizon at azimuth az
        channels += [0.5 * w * np.sin(2 * az), 0.1 * w * np.sin(az), -0.2 * w,
                     0.1 * w * np.cos(az), 0.5 * w * np.cos(2 * az)]
    foa = np.stack(channels, 1)
    audio = np.clip(np.round(foa * 32767 * 0.8), -32768, 32767).astype(np.int16)

    h, wd = FRAME_HW
    n_frames = seconds * 10
    ys, xs = np.mgrid[0:h, 0:wd]
    texture = rng.randint(0, 60, (h // 8, wd // 8, 3)).repeat(8, 0).repeat(8, 1)
    frames = np.empty((n_frames, h, wd, 3), np.uint8)
    for i in range(n_frames):
        cx = (i / n_frames) * wd
        blob = np.exp(-(((xs - cx) ** 2 + (ys - h / 2) ** 2) / (2 * (0.05 * wd) ** 2)))
        img = texture + blob[..., None] * np.array([255.0, 180.0, 40.0])
        frames[i] = np.clip(img, 0, 255)

    flow = np.zeros((n_frames, h, wd, 3), np.uint8)
    flow[..., 0] = rng.randint(0, 256, (n_frames, h, wd))        # angle
    flow[..., 2] = rng.randint(0, 256, (n_frames, h, wd))        # magnitude
    lims = np.stack([np.zeros(n_frames), rng.uniform(1.0, 3.0, n_frames)], 1)

    pack = folder / "packed"
    pack.mkdir(parents=True)
    np.save(pack / "ambix.npy", audio)
    np.save(pack / "video.npy", frames)
    np.save(pack / "flow.npy", flow)
    np.save(pack / "flow_lims.npy", lims.astype(np.float32))
    meta = {"version": 1, "rate": RATE, "num_channels": len(channels), "num_files": seconds,
            "audio_dtype": "int16", "video_frames": n_frames,
            "frame_shape": [h, wd, 3], "flow_frames": n_frames, "flow_shape": [h, wd, 3]}
    (pack / "meta.json").write_text(json.dumps(meta))
    with open(folder / "audio_pow.lst", "w") as f:
        for i in range((seconds - 1) * 10):
            tt = i / 10.0 + 0.5
            ss = int(tt * RATE)
            seg = audio[ss: ss + RATE // 10, 0] / 32768.0
            f.write(f"{tt} {np.sqrt((seg ** 2).mean())}\n")
    return audio


def model_dir_at(model_dir: Path, precision: str) -> Path:
    """A copy of model_dir (same params.npz) whose train-params.json asks
    for pallas_precision=`precision`."""
    import dataclasses

    from spatialaudiogen_tpu_torch.config import TrainConfig

    out = model_dir.with_name(f"{model_dir.name}_{precision}")
    cfg = dataclasses.replace(TrainConfig.load(str(model_dir)), model_dir=str(out),
                              pallas_precision=precision)
    cfg.save()
    shutil.copy(model_dir / "params.npz", out / "params.npz")
    return out


def slice_phase(card: str) -> None:
    from spatialaudiogen_tpu_torch.deploy.deploy import MonoToAmbix
    from spatialaudiogen_tpu_torch.ops import masked_istft as k1

    model_dir, clip = SCRATCH / "model", SCRATCH / "clip"
    write_model_dir(model_dir)
    audio = write_clip(clip)
    log(f"slice: flagship model dir and {CLIP_SECONDS} s packed clip written")

    engine = MonoToAmbix(str(model_dir), batch_size=DEPLOY_BATCH, device=DEVICE)
    k1.launch_count = k1.bwd_launch_count = 0
    t0 = time.perf_counter()
    ambi = engine.deploy(str(clip), deploy_start=DEPLOY_START,
                         deploy_duration=DEPLOY_SECONDS)
    first_s = time.perf_counter() - t0
    launches, bwd_launches = k1.launch_count, k1.bwd_launch_count
    n = int(round(DEPLOY_SECONDS * RATE))
    log(f"deploy (card, batch {DEPLOY_BATCH}): shape {ambi.shape}, "
        f"{first_s:.3f} s wall (first call), K1 launches {launches}, "
        f"K2 launches {bwd_launches}")
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
    if bwd_launches:
        raise AssertionError("the deploy path launched the backward kernel")
    if not np.abs(ambi[:, 1:]).max() > 0:
        raise AssertionError("predicted channels are all zero")

    t0 = time.perf_counter()
    engine.deploy(str(clip), deploy_start=DEPLOY_START, deploy_duration=DEPLOY_SECONDS)
    warm_s = time.perf_counter() - t0
    log(f"deploy (card, batch {DEPLOY_BATCH}): {warm_s:.3f} s wall (warm) -> "
        f"{DEPLOY_SECONDS / warm_s:.2f}x realtime [{card}]")

    # the same params on the CPU over 0.5 s: one uneven batch (pad lanes).
    # The CPU runs float32 whatever pallas_precision says; the card matches
    # it to float32 order with K1's 3xTF32 route ("highest"), and lies 1e-4
    # to 1e-2 from it with the bf16 route (the model's default).
    exact = {}
    for dev, mdir in ((DEVICE, model_dir_at(model_dir, "highest")), (DEVICE, model_dir),
                      ("cpu", model_dir)):
        eng = MonoToAmbix(str(mdir), batch_size=DEPLOY_BATCH, device=dev, f16_fetch=False)
        exact[dev, eng.cfg.pallas_precision] = eng.deploy(
            str(clip), deploy_start=DEPLOY_START, deploy_duration=CPU_SECONDS)
    cpu = exact["cpu", "default"]
    for precision, limits in (("highest", (0.0, 1e-4)), ("default", (1e-4, 1e-2))):
        card_out = exact[DEVICE, precision]
        if not np.array_equal(card_out[:, 0], cpu[:, 0]):
            raise AssertionError("W passthrough differs between card and CPU")
        err = rel_l2(card_out[:, 1:], cpu[:, 1:])
        log(f"deploy card (pallas_precision={precision}) vs CPU over {CPU_SECONDS} s (f32 "
            f"fetch, TF32 off): relative L2 {err:.3e} (limits {limits[0]:g}, {limits[1]:g})")
        if not limits[0] <= err <= limits[1]:
            raise AssertionError(f"card ({precision}) and CPU deploy disagree: relative L2 "
                                 f"{err:.3e}")


KERNEL_FAMILIES = (  # (family, substrings of the kernel name), first match wins
    ("K3 masked_istft_nhwc (fwd)", ("masked_istft_nhwc",)),
    ("K1 masked_istft (fwd)", ("masked_istft_fwd",)),
    ("K2 masked_istft (bwd)", ("masked_istft_bwd",)),
    ("convolution (cuDNN)", ("conv", "fprop", "dgrad", "wgrad", "implicit_", "winograd",
                             "fft", "pointwise_mult_and_sum")),
    ("GEMM (cuBLAS)", ("gemm", "sm90_xmma", "cutlass", "ampere_sgemm", "Kernel2")),
    ("batch norm", ("batch_norm", "bn_")),
    ("optimizer (Adam)", ("multi_tensor", "adam", "Adam")),
    ("reduction", ("reduce", "Reduce")),
    ("copy / layout", ("copy", "Memcpy", "Memset", "cat", "transpose", "pad", "unfold",
                       "index", "scatter", "gather", "nchwToNhwc", "nhwcToNchw")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def profile_step(step_fn, card: str, what: str) -> tuple | None:
    """Device time of one call of step_fn by kernel family (torch.profiler);
    -> (device kernels launched, busy ms, wall ms), None if the profiler
    recorded no device kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        log(f"{what} profile: torch.profiler recorded no device kernels; not measured")
        return None
    totals: dict = {}
    by_name: dict = {}
    for e in kernels:
        family = next((fam for fam, keys in KERNEL_FAMILIES
                       if any(key in e.name for key in keys)), "other")
        ms = e.time_range.elapsed_us() / 1e3
        totals[family] = totals.get(family, 0.0) + ms
        by_name[family, e.name] = by_name.get((family, e.name), 0.0) + ms
    busy = sum(totals.values())
    log(f"{what} profile: {len(kernels)} kernels, device busy "
        f"{busy:.2f} ms of {wall_ms:.2f} ms wall (profiled) [{card}]")
    for family, ms in sorted(totals.items(), key=lambda kv: -kv[1]):
        top_ms, top = max((t, name) for (fam, name), t in by_name.items() if fam == family)
        log(f"  {family:24s} {ms:9.3f} ms  {100 * ms / busy:5.1f}%   largest "
            f"{top_ms:.3f} ms {top[:90]}")
    return len(kernels), busy, wall_ms


# ---------------------------------------------------------------------------
# 5. numbers: device-forward realtime factor and its profile
# ---------------------------------------------------------------------------

FORWARD_CASES = (  # name, SptAudioGenConfig fields
    ("NCHW f32", {}),
    ("NHWC f32", {"pallas_nhwc": True}),
    ("NCHW bf16", {"dtype": torch.bfloat16}),
    ("NHWC bf16", {"dtype": torch.bfloat16, "pallas_nhwc": True}),
)


def flagship_model(model_dir: Path | None = None, **fields):
    """The flagship model with the weights chip_smoke wrote to
    .chip_smoke/model (or to `model_dir`), on the card, in the
    configuration `fields` sets."""
    import dataclasses

    from spatialaudiogen_tpu_torch.config import TrainConfig
    from spatialaudiogen_tpu_torch.models.convert import load_params
    from spatialaudiogen_tpu_torch.models.sptaudiogen import SptAudioGen

    model_dir = model_dir or SCRATCH / "model"
    cfg = TrainConfig.load(str(model_dir))
    cfg.sample_dur = 0.1
    mcfg = dataclasses.replace(cfg.model_config(), **fields)
    model = SptAudioGen(mcfg, frame_hw=FRAME_HW)
    model.load_state_dict(load_params(str(model_dir)))
    return model.to(DEVICE)


def forward_inputs(gen, batch: int, g):
    audio = 0.1 * torch.randn((batch, g.snd_size, 1), generator=gen, device=DEVICE)
    video = torch.rand((batch, g.vid_dur) + FRAME_HW + (3,), generator=gen,
                       device=DEVICE) - 0.5
    return audio, video


def forward_numbers(card: str) -> None:
    for name, fields in FORWARD_CASES:
        model = flagship_model(**fields).eval()
        g = model.cfg.geometry
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        for batch in FORWARD_BATCHES:
            audio, video = forward_inputs(gen, batch, g)
            with torch.no_grad():
                ms = time_ms(lambda: model(audio, video), warmup=2, iters=10)
            rtf = batch * g.snd_dur / RATE / (ms / 1e3)
            log(f"device forward batch {batch} {name}: {ms:.2f} ms -> {rtf:.1f}x realtime, "
                f"{batch / (ms / 1e3):.0f} windows/s [{card}]")
            if batch == FORWARD_BATCHES[-1]:
                with torch.no_grad():
                    profile_step(lambda: model(audio, video), card,
                                 f"device forward batch {batch} {name}")
            del audio, video
        del model
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 6. NHWC path: the flagship forward and a train step with pallas_nhwc=True
# ---------------------------------------------------------------------------

def nhwc_path_phase(card: str) -> dict:
    """Returns K3's launches in the NHWC train step and, apart, in the NHWC
    forward, each counted from 0 just before its run."""
    from spatialaudiogen_tpu_torch.ops import masked_istft as k
    from spatialaudiogen_tpu_torch.train.lr import make_optimizer
    from spatialaudiogen_tpu_torch.train.state import TrainState
    from spatialaudiogen_tpu_torch.train.steps import train_step

    # both layouts at both routes, same weights and inputs. At "highest"
    # (K1 and K3 on 3xTF32) they agree to float32 order; at the model's
    # default, "default" (both on bf16), they lie far nearer each other than
    # either lies from "highest": K3 rounds what K1 rounds.
    outs = {}
    for layout, fields in (("NCHW", {}), ("NHWC", {"pallas_nhwc": True})):
        for precision in PRECISIONS:
            model = flagship_model(pallas_precision=precision, **fields).eval()
            if not outs:
                audio, video = forward_inputs(
                    torch.Generator(device=DEVICE).manual_seed(SEED + 5), DEPLOY_BATCH,
                    model.cfg.geometry)
            taps = {}
            k.launch_count = k.bwd_launch_count = k.nhwc_launch_count = 0
            with torch.no_grad():
                outs[layout, precision] = model(audio, video, taps=taps)
            torch.cuda.synchronize()
            launched = (k.launch_count, k.nhwc_launch_count)
            if launched != ((0, 1) if layout == "NHWC" else (1, 0)):
                raise AssertionError(f"the {layout} forward ({precision}) launched K1 "
                                     f"{launched[0]} and K3 {launched[1]} times")
            if layout == "NHWC" and precision == "default":   # the model's default
                fwd, mask, nhwc = launched, taps["mask"], model
            else:
                del model
    log(f"NHWC forward (flagship, batch {DEPLOY_BATCH}, model default): K1 launches "
        f"{fwd[0]}, K3 launches {fwd[1]}; mask {tuple(mask.shape)} strides {mask.stride()}")
    if mask.stride(2) != 1:
        raise AssertionError(f"the NHWC forward's mask is not channels_last: {mask.stride()}")
    err = rel_l2(outs["NHWC", "highest"].cpu(), outs["NCHW", "highest"].cpu())
    gap = rel_l2(outs["NCHW", "default"].cpu(), outs["NCHW", "highest"].cpu())
    err_d = rel_l2(outs["NHWC", "default"].cpu(), outs["NCHW", "default"].cpu())
    log(f"NHWC vs NCHW forward at the same weights (TF32 off): relative L2 {err:.3e} at "
        f"\"highest\" (limit 1e-5), {err_d:.3e} at \"default\" (limit a tenth of the NCHW "
        f"forward's own \"default\"-vs-\"highest\" gap, {gap:.3e})")
    if not all(torch.isfinite(x).all() for x in outs.values()):
        raise AssertionError("a forward is not finite")
    if not (outs["NHWC", "highest"].shape == outs["NCHW", "highest"].shape and err <= 1e-5):
        raise AssertionError(f"NHWC and NCHW forwards disagree at \"highest\": relative L2 "
                             f"{err:.3e}")
    if not err_d <= gap / 10:
        raise AssertionError(f"NHWC and NCHW forwards at \"default\" are {err_d:.3e} apart, "
                             f"their route's gap {gap:.3e}")
    del audio, video, mask, outs

    batch = TRAIN_BATCHES[0]
    state = TrainState(nhwc, make_optimizer(nhwc.parameters()))
    data = synthetic_batch(torch.Generator(device=DEVICE).manual_seed(SEED + 6), batch,
                           nhwc.cfg.geometry, FRAME_HW, DEVICE)
    k.launch_count = k.bwd_launch_count = k.nhwc_launch_count = 0
    loss = float(train_step(state, data, 1e-4)["total_loss"])
    step = (k.launch_count, k.bwd_launch_count, k.nhwc_launch_count)
    log(f"NHWC train step (flagship, batch {batch}): loss {loss:.4f}, K1/K2/K3 launches "
        f"{step[0]}/{step[1]}/{step[2]}")
    if step != (0, 1, 1) or not np.isfinite(loss):
        raise AssertionError(f"NHWC train step: loss {loss}, K1/K2/K3 launches {step}")
    ms = time_ms(lambda: train_step(state, data, 1e-4), warmup=2, iters=5)
    log(f"train step batch {batch} NHWC f32: {ms:.2f} ms -> {batch / (ms / 1e3):.1f} "
        f"samples/s [{card}]")
    del state, data, nhwc
    torch.cuda.empty_cache()
    return {"launches": step[2], "forward_launches": fwd[1]}


# ---------------------------------------------------------------------------
# 7. train: cli.train on the card, then deploy the trained model
# ---------------------------------------------------------------------------

def write_train_db(db: Path, order: int = 1, seconds: int = TRAIN_CLIP_SECONDS) -> None:
    """Two packed clips (18 s by default) of ambisonics `order` whose
    audio_pow.lst rows all pass the train feeder's 0.2 silence gate
    (data/pipeline.py); the eval feeder takes every tenth window of each,
    34 samples at 18 s (phase 12)."""
    for i in range(2):
        write_clip(db / f"clip{i}", seed=SEED + 10 * order + i, level=1.6, seconds=seconds,
                   order=order)
        levels = [float(line.split()[1]) for line in
                  (db / f"clip{i}" / "audio_pow.lst").read_text().splitlines()]
        if min(levels) <= 0.2:
            raise AssertionError(f"train clip {i}: audio_pow.lst level {min(levels):.3f} "
                                 f"would be gated out by the feeder")


def cli_train_run(db: Path, model_dir: Path, *flags: str, encoders=("audio", "video")):
    """cli.train for TRAIN_STEPS steps at batch 32 on the card, with the
    kernel counts set to 0 just before and read just after (encoders None:
    the CLI's default, audio flow video). Returns (train state, (K1, K2, K3
    launches), losses)."""
    from spatialaudiogen_tpu_torch.cli import train as cli_train
    from spatialaudiogen_tpu_torch.ops import masked_istft as k

    batch = TRAIN_BATCHES[0]
    argv = [str(db), str(model_dir), *(["--encoders", *encoders] if encoders else []),
            "--batch_size", str(batch), "--n_iters", str(TRAIN_STEPS),
            "--log_every", "1", "--ckpt_every", "0", "--n_workers", "4",
            "--seed", str(SEED), "--device", DEVICE, *flags]
    log(f"train: cli.train {' '.join(argv[2:])}")
    k.launch_count = k.bwd_launch_count = k.nhwc_launch_count = 0
    t0 = time.perf_counter()
    state, steps = cli_train.main(argv)
    wall = time.perf_counter() - t0
    launches = (k.launch_count, k.bwd_launch_count, k.nhwc_launch_count)
    recs = [json.loads(line) for line in
            (model_dir / "metrics.jsonl").read_text().splitlines()]
    losses = [r["total_loss"] for r in recs]
    log(f"train (card, batch {batch}{' ' if flags else ''}{' '.join(flags)}): {steps} steps "
        f"in {wall:.1f} s wall (first steps included), K1/K2/K3 launches "
        f"{launches[0]}/{launches[1]}/{launches[2]}, losses {[round(x, 3) for x in losses]}")
    if steps != TRAIN_STEPS or [r["step"] for r in recs] != list(range(TRAIN_STEPS)):
        raise AssertionError(f"train ran {steps} steps, logged {[r['step'] for r in recs]}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train losses not finite: {losses}")
    if min(launches[:2]) < TRAIN_STEPS or launches[2]:
        raise AssertionError(f"K1/K2/K3 launched {launches} times in {TRAIN_STEPS} "
                             f"train steps")
    return state, launches, losses


def train_phase(card: str) -> dict:
    from spatialaudiogen_tpu_torch.config import TrainConfig
    from spatialaudiogen_tpu_torch.deploy.deploy import MonoToAmbix
    from spatialaudiogen_tpu_torch.models.convert import load_params
    from spatialaudiogen_tpu_torch.train.state import create_train_state

    db, model_dir = SCRATCH / "train_db", SCRATCH / "trained"
    write_train_db(db)
    _, launches, _ = cli_train_run(db, model_dir)
    init = create_train_state(TrainConfig.load(str(model_dir)), "cpu", seed=SEED)
    trained = load_params(str(model_dir))
    moved = [name for name, v in init.model.state_dict().items()
             if not torch.equal(v, trained[name])]
    if not any(name.endswith(".weight") for name in moved):
        raise AssertionError("training moved no weight")
    log(f"train: {len(moved)} of {len(trained)} tensors moved from their initial values")

    engine = MonoToAmbix(str(model_dir), batch_size=DEPLOY_BATCH, device=DEVICE)
    ambi = engine.deploy(str(db / "clip0"), deploy_start=DEPLOY_START, deploy_duration=1.0)
    if ambi.shape != (RATE, 4) or not np.isfinite(ambi).all():
        raise AssertionError(f"deploy of the trained model: shape {ambi.shape}, "
                             f"finite {np.isfinite(ambi).all()}")
    log(f"deploy of the trained model (card): shape {ambi.shape}, finite, "
        f"max |pred| {float(np.abs(ambi[:, 1:]).max()):.4f}")
    return {"launches": launches[0], "bwd_launches": launches[1]}


# ---------------------------------------------------------------------------
# 8. bf16 train: cli.train --bf16, then a bf16 deploy of the result
# ---------------------------------------------------------------------------

def bf16_train_phase(card: str) -> None:
    from spatialaudiogen_tpu_torch.config import TrainConfig
    from spatialaudiogen_tpu_torch.deploy.deploy import MonoToAmbix
    from spatialaudiogen_tpu_torch.models.convert import load_params

    db, model_dir = SCRATCH / "train_db", SCRATCH / "trained_bf16"
    state, _, _ = cli_train_run(db, model_dir, "--bf16")
    model = state.model
    if model.cfg.dtype != torch.bfloat16:
        raise AssertionError(f"--bf16 trained a model of dtype {model.cfg.dtype}")
    params = load_params(str(model_dir))
    if not all(p.dtype == torch.float32 for p in model.parameters()) or not all(
            v.dtype == torch.float32 for v in params.values()):
        raise AssertionError("--bf16 training left a parameter that is not float32")
    if TrainConfig.load(str(model_dir)).compute_dtype != "bfloat16":
        raise AssertionError("train-params.json does not record compute_dtype bfloat16")
    # the mask the trained model hands K1 (and K2 in the backward) is bf16
    taps = {}
    audio, video = forward_inputs(torch.Generator(device=DEVICE).manual_seed(SEED + 7), 2,
                                  model.cfg.geometry)
    with torch.no_grad():
        model(audio, video, taps=taps)
    if taps["mask"].dtype != torch.bfloat16:
        raise AssertionError(f"the bf16 model's mask is {taps['mask'].dtype}")
    log(f"bf16 train: params float32 (state and params.npz), mask into K1/K2 "
        f"{taps['mask'].dtype}")
    del state, model, audio, video, taps

    ambi = {}
    for dtype in ("bfloat16", "float32"):
        engine = MonoToAmbix(str(model_dir), batch_size=DEPLOY_BATCH, device=DEVICE,
                             compute_dtype=dtype, f16_fetch=False)
        ambi[dtype] = engine.deploy(str(db / "clip0"), deploy_start=DEPLOY_START,
                                    deploy_duration=1.0)
    a16, a32 = ambi["bfloat16"], ambi["float32"]
    err = rel_l2(a16[:, 1:], a32[:, 1:])
    # at least 1e-3: float32 products with only the mask rounded to bf16
    # would come far closer to the float32 deploy
    log(f"bf16 deploy of the bf16-trained model (card): shape {a16.shape}, relative L2 "
        f"to the float32 deploy of the same params {err:.3e} (limits 1e-3 to 0.1)")
    if a16.shape != (RATE, 4) or not np.isfinite(a16).all():
        raise AssertionError(f"bf16 deploy: shape {a16.shape}, finite {np.isfinite(a16).all()}")
    if not np.array_equal(a16[:, 0], a32[:, 0]) or not 1e-3 <= err <= 0.1:
        raise AssertionError(f"bf16 and float32 deploys disagree: relative L2 {err:.3e}")


# ---------------------------------------------------------------------------
# 9. train step, card against CPU
# ---------------------------------------------------------------------------

def synthetic_batch(gen, batch: int, g, frame_hw, device) -> dict:
    return {"ambix": 0.1 * torch.randn((batch, g.snd_size, g.num_ambi_channels),
                                       generator=gen, device=device),
            "audio_mask": torch.ones((batch, g.num_ambi_channels), device=device),
            "video": torch.randint(0, 256, (batch, g.vid_dur) + tuple(frame_hw) + (3,),
                                   generator=gen, device=device, dtype=torch.uint8)}


def train_card_vs_cpu(card: str, **fields) -> None:
    """Reduced flagship (8 tracks, 64x128 frames, batch 3) in the
    configuration `fields` sets (pallas_precision="highest": the kernels on
    3xTF32), same weights and batch: loss and flattened gradient,
    relative, limit 1e-4."""
    from spatialaudiogen_tpu_torch.config import SptAudioGenConfig
    from spatialaudiogen_tpu_torch.models.sptaudiogen import SptAudioGen
    from spatialaudiogen_tpu_torch.ops import masked_istft as k
    from spatialaudiogen_tpu_torch.train.lr import make_optimizer
    from spatialaudiogen_tpu_torch.train.state import TrainState
    from spatialaudiogen_tpu_torch.train.steps import train_step

    cfg = SptAudioGenConfig(sep_num_tracks=8, **fields)
    layout = "NHWC" if cfg.pallas_nhwc else "NCHW"
    batch = synthetic_batch(torch.Generator().manual_seed(SEED + 3), 3, cfg.geometry,
                            (64, 128), "cpu")
    result = {}
    for dev in ("cpu", DEVICE):
        model = SptAudioGen(cfg, frame_hw=(64, 128)).init_weights(
            torch.Generator().manual_seed(SEED)).to(dev)
        state = TrainState(model, make_optimizer(model.parameters()))
        counts = k.launch_count, k.nhwc_launch_count
        metrics = train_step(state, {n: v.to(dev) for n, v in batch.items()}, 1e-4)
        grad = torch.cat([p.grad.flatten().double().cpu() for p in model.parameters()])
        result[dev] = float(metrics["total_loss"]), grad
        launched = (k.launch_count - counts[0], k.nhwc_launch_count - counts[1])
    if launched != ((0, 1) if cfg.pallas_nhwc else (1, 0)):
        raise AssertionError(f"the {layout} train step on the card launched K1/K3 "
                             f"{launched[0]}/{launched[1]} times")
    (loss_c, g_c), (loss_g, g_g) = result["cpu"], result[DEVICE]
    loss_err = abs(loss_g - loss_c) / abs(loss_c)
    grad_err = float((g_g - g_c).norm() / g_c.norm())
    log(f"train step card vs CPU (reduced flagship, {layout} U-Net, TF32 off): loss "
        f"{loss_g:.6f} vs {loss_c:.6f} (relative {loss_err:.2e}), gradient relative L2 "
        f"{grad_err:.2e} (limit 1e-4)")
    if not (loss_err <= 1e-4 and grad_err <= 1e-4):
        raise AssertionError("card and CPU train steps disagree")


# ---------------------------------------------------------------------------
# 10. train numbers: step time, samples/s, and a profile by kernel family
# ---------------------------------------------------------------------------

def train_numbers(card: str) -> None:
    from spatialaudiogen_tpu_torch.config import TrainConfig
    from spatialaudiogen_tpu_torch.ops.dft import deterministic_cudnn
    from spatialaudiogen_tpu_torch.train.state import create_train_state
    from spatialaudiogen_tpu_torch.train.steps import train_step

    for dtype, batch in ((d, b) for d in ("float32", "bfloat16") for b in TRAIN_BATCHES):
        cfg = TrainConfig(encoders=("audio", "video"), frame_hw=FRAME_HW, seed=SEED,
                          compute_dtype=dtype)
        g = cfg.model_config().geometry
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
        state = create_train_state(cfg, DEVICE)
        data = synthetic_batch(gen, batch, g, FRAME_HW, DEVICE)

        def step():
            train_step(state, data, 1e-4, cfg.weight_decay)

        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(step, warmup=2, iters=5)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        log(f"train step batch {batch} {dtype}: {ms:.2f} ms -> {batch / (ms / 1e3):.1f} "
            f"samples/s, peak memory {peak_gb:.1f} GB [{card}]")
        if batch == TRAIN_BATCHES[-1]:
            # what cuDNN's deterministic algorithms would cost the train
            # step (the eval, deploy and serving forwards run them)
            with deterministic_cudnn():
                det_ms = time_ms(step, warmup=2, iters=5)
            log(f"train step batch {batch} {dtype} with deterministic cuDNN: {det_ms:.2f} ms "
                f"against {ms:.2f} ms ({100 * (det_ms / ms - 1):+.1f}%) [{card}]")
        profile_step(step, card, f"train step batch {batch} {dtype}")
        del state, data
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 11. the default model: audio + flow + video, the CLIs' default --encoders
# ---------------------------------------------------------------------------

DEFAULT_ENCODERS = ("audio", "flow", "video")
DEFAULT_DEPLOY_BATCH = 32
DEFAULT_DEPLOY_SECONDS = 3.0


def default_model_phase(card: str) -> dict:
    """The reference's default model (audio, flow and video encoders) at the
    flagship's width, on the packed clip with flow.npy + flow_lims.npy:
    deploy (flow configs take the per-window host path) at batch 32 on the
    card against the CPU at "highest" over 0.5 s (one batch: 5 windows and
    27 zero pad lanes, kept in the forward), <= 1e-4; the card's deploy
    realtime factor over 3 s at the model's default and the host
    assembly's seconds beside it; the batch-128 forward in f32 and bf16
    (CUDA events) with a profile each; the batch-128 train step in f32 and
    bf16 with a profile each; cli.train with the default encoders for 6
    steps at batch 32 (K1 and K2 launched on every step, K3 never, finite
    losses). Returns the K1/K2 launches of that training."""
    from spatialaudiogen_tpu_torch.config import TrainConfig
    from spatialaudiogen_tpu_torch.deploy.deploy import MonoToAmbix
    from spatialaudiogen_tpu_torch.ops import masked_istft as k
    from spatialaudiogen_tpu_torch.train.state import create_train_state
    from spatialaudiogen_tpu_torch.train.steps import train_step

    model_dir, clip = SCRATCH / "default_model", SCRATCH / "clip"
    write_model_dir(model_dir, DEFAULT_ENCODERS)

    outs = {}
    for dev, mdir in ((DEVICE, model_dir_at(model_dir, "highest")), ("cpu", model_dir)):
        engine = MonoToAmbix(str(mdir), batch_size=DEFAULT_DEPLOY_BATCH, device=dev)
        k.launch_count = k.bwd_launch_count = k.nhwc_launch_count = 0
        outs[dev] = engine.deploy(str(clip), deploy_start=DEPLOY_START,
                                  deploy_duration=CPU_SECONDS)
        if dev == DEVICE:
            launched = (k.launch_count, k.bwd_launch_count, k.nhwc_launch_count)
    card_out, cpu = outs[DEVICE], outs["cpu"]
    n = int(round(CPU_SECONDS * RATE))
    err = rel_l2(card_out[:, 1:], cpu[:, 1:])
    log(f"default model (audio flow video) deploy card (\"highest\") vs CPU over "
        f"{CPU_SECONDS} s at batch {DEFAULT_DEPLOY_BATCH} (5 windows, 27 pad lanes): shape "
        f"{card_out.shape}, relative L2 {err:.3e} (limit 1e-4), K1/K2/K3 launches "
        f"{launched[0]}/{launched[1]}/{launched[2]}")
    if card_out.shape != (n, 4) or cpu.shape != (n, 4) or not np.isfinite(card_out).all():
        raise AssertionError(f"default-model deploy: shapes {card_out.shape} {cpu.shape}")
    if not np.array_equal(card_out[:, 0], cpu[:, 0]):
        raise AssertionError("default-model deploy: W passthrough differs between card and CPU")
    if not err <= 1e-4:
        raise AssertionError(f"default-model deploy: card and CPU {err:.3e} apart")
    if launched != (1, 0, 0):
        raise AssertionError(f"default-model deploy launched K1/K2/K3 {launched} times")

    engine = MonoToAmbix(str(model_dir), batch_size=DEFAULT_DEPLOY_BATCH, device=DEVICE)
    engine.deploy(str(clip), deploy_start=DEPLOY_START, deploy_duration=DEFAULT_DEPLOY_SECONDS)
    t0 = time.perf_counter()
    ambi = engine.deploy(str(clip), deploy_start=DEPLOY_START,
                         deploy_duration=DEFAULT_DEPLOY_SECONDS)
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    n_batches = sum(1 for _ in engine._window_batches(
        engine._reader(str(clip), DEPLOY_START, DEFAULT_DEPLOY_SECONDS)))
    host = time.perf_counter() - t0
    log(f"default model deploy (card, batch {DEFAULT_DEPLOY_BATCH}, model default, warm): "
        f"{DEFAULT_DEPLOY_SECONDS} s in {wall:.3f} s wall -> "
        f"{DEFAULT_DEPLOY_SECONDS / wall:.2f}x realtime; the host's window assembly alone "
        f"({n_batches} batches) {host:.3f} s, {100 * host / wall:.0f}% of the wall [{card}]")
    if ambi.shape != (int(round(DEFAULT_DEPLOY_SECONDS * RATE)), 4) or not np.isfinite(
            ambi).all():
        raise AssertionError(f"default-model deploy: shape {ambi.shape}")
    del engine

    for name, fields in (("f32", {}), ("bf16", {"dtype": torch.bfloat16})):
        model = flagship_model(model_dir, **fields).eval()
        g = model.cfg.geometry
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 8)
        batch = FORWARD_BATCHES[-1]
        audio, video = forward_inputs(gen, batch, g)
        flow = torch.randn(video.shape, generator=gen, device=DEVICE)
        with torch.no_grad():
            ms = time_ms(lambda: model(audio, video, flow), warmup=2, iters=10)
            log(f"default model device forward batch {batch} {name}: {ms:.2f} ms -> "
                f"{batch * g.snd_dur / RATE / (ms / 1e3):.1f}x realtime [{card}]")
            profile_step(lambda: model(audio, video, flow), card,
                         f"default model device forward batch {batch} {name}")
        del model, audio, video, flow
        torch.cuda.empty_cache()

    for dtype in ("float32", "bfloat16"):
        batch = TRAIN_BATCHES[-1]
        cfg = TrainConfig(encoders=DEFAULT_ENCODERS, frame_hw=FRAME_HW, seed=SEED,
                          compute_dtype=dtype)
        g = cfg.model_config().geometry
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
        state = create_train_state(cfg, DEVICE)
        data = synthetic_batch(gen, batch, g, FRAME_HW, DEVICE)
        data["flow"] = torch.randn(data["video"].shape, generator=gen, device=DEVICE)

        def step():
            train_step(state, data, 1e-4, cfg.weight_decay)

        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(step, warmup=2, iters=5)
        log(f"default model train step batch {batch} {dtype}: {ms:.2f} ms -> "
            f"{batch / (ms / 1e3):.1f} samples/s, peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB [{card}]")
        profile_step(step, card, f"default model train step batch {batch} {dtype}")
        del state, data
        torch.cuda.empty_cache()

    _, launches, _ = cli_train_run(SCRATCH / "train_db", SCRATCH / "trained_default",
                                   encoders=None)
    if TrainConfig.load(str(SCRATCH / "trained_default")).encoders != DEFAULT_ENCODERS:
        raise AssertionError("cli.train's default encoders are not audio flow video")
    return {"launches": launches[0], "bwd_launches": launches[1]}


# ---------------------------------------------------------------------------
# 12. eval: cli.eval over phase 7's dataset and model, both modes
# ---------------------------------------------------------------------------

EVAL_MODES = (("exact", ()), ("device", ("--device_metrics", "--emd", "sinkhorn")))


def eval_phase(card: str) -> dict:
    """cli.eval of the flagship that phase 7's cli.train trained, at batch
    16 over that phase's packed dataset (34 samples: batches of 16, 16 and
    2 plus 14 zero pad lanes), one feeder thread so that both runs form the
    same batches (the visual encoder's BatchNorm runs on batch statistics):
    the exact mode (host metrics, native EMD), then --device_metrics --emd
    sinkhorn, held to it row by row (EMD rtol 5e-3 / atol 5e-4, the rest
    rtol 1e-4 / atol 1e-5: tests/test_sinkhorn.py and
    tests/test_eval_metrics_device.py); K1 launched once per batch in each.
    Then the TF32 check: a dft_precision="default" flagship's forward, the
    process's TF32 switches left on, and the device mel-LSD and envelope
    within 1e-5 of the same functions in float64 on the CPU. Prints eval
    samples/s per mode, the host pool's busy share of the wall, the device
    step (forward + battery), Sinkhorn's ms per batch. Returns K1's
    launches in the exact run."""
    import threading

    from spatialaudiogen_tpu_torch.cli import eval as cli_eval
    from spatialaudiogen_tpu_torch.data.pipeline import Feeder
    from spatialaudiogen_tpu_torch.eval.evaluator import ALL_METRICS, Evaluator
    from spatialaudiogen_tpu_torch.ops import masked_istft as k
    from spatialaudiogen_tpu_torch.ops.eval_metrics import (
        _hilbert_kernel,
        envelope_dist_fn,
        mel_lsd_batch_fn,
    )
    from spatialaudiogen_tpu_torch.train.steps import eval_step

    db, model_dir = SCRATCH / "train_db", SCRATCH / "trained"
    n = Feeder(str(db), for_eval=True).count_chunks()
    n_batches = -(-n // EVAL_BATCH)
    if n % EVAL_BATCH == 0 or n_batches < 3:
        raise AssertionError(f"eval data: {n} samples at batch {EVAL_BATCH}")
    # seconds in run(), in its device batches (eval step, device metrics,
    # copies back) and in the host pool's metric calls (summed over threads)
    spent = {"run": 0.0, "device": 0.0, "host": 0.0}
    lock = threading.Lock()
    timed = {"run": "run", "_device_batch": "device", "_host_metrics": "host"}
    originals = {name: getattr(Evaluator, name) for name in timed}

    def timer(name):
        def call(self, *args, **kwargs):
            t0 = time.perf_counter()
            try:
                return originals[name](self, *args, **kwargs)
            finally:
                with lock:
                    spent[timed[name]] += time.perf_counter() - t0
        return call

    rows = {}
    for name in timed:
        setattr(Evaluator, name, timer(name))
    try:
        for mode, flags in EVAL_MODES:
            argv = [str(model_dir), "--db_dir", str(db), "--batch_size", str(EVAL_BATCH),
                    "--n_workers", "1", "--device", DEVICE, "--overwrite", *flags]
            log(f"eval: cli.eval {' '.join(argv[1:])}")
            spent.update(run=0.0, device=0.0, host=0.0)
            k.launch_count = k.bwd_launch_count = k.nhwc_launch_count = 0
            t0 = time.perf_counter()
            cli_eval.main(argv)
            wall = time.perf_counter() - t0
            launches = (k.launch_count, k.bwd_launch_count, k.nhwc_launch_count)
            lines = (model_dir / "eval-detailed.txt").read_text().splitlines()
            results = {sid: dict(zip(ALL_METRICS, map(float, vals.split())))
                       for sid, vals in (line.split(" | ") for line in lines[1:])}
            values = np.array([[rec[m] for m in ALL_METRICS] for rec in results.values()])
            log(f"eval {mode} (card, batch {EVAL_BATCH}): {len(results)} rows in "
                f"{spent['run']:.3f} s -> {len(results) / spent['run']:.2f} samples/s "
                f"({wall:.3f} s with the model's load); device batches {spent['device']:.3f} "
                f"s ({100 * spent['device'] / spent['run']:.0f}% of the wall), host pool busy "
                f"{spent['host']:.3f} s summed over its 8 threads "
                f"({100 * spent['host'] / spent['run']:.0f}% of the wall); K1/K2/K3 "
                f"launches {launches[0]}/{launches[1]}/{launches[2]} [{card}]")
            if lines[0] != "SampleID | " + " ".join(ALL_METRICS) or len(lines) != n + 1:
                raise AssertionError(f"eval {mode}: {len(lines)} lines, header {lines[0][:60]}")
            if len(results) != n or not np.isfinite(values).all():
                raise AssertionError(f"eval {mode}: {len(results)} rows, finite "
                                     f"{np.isfinite(values).all()}")
            if launches != (n_batches, 0, 0):
                raise AssertionError(f"eval {mode}: K1/K2/K3 launched {launches} times in "
                                     f"{n_batches} batches")
            rows[mode] = results
            if mode == "exact":
                exact_launches = launches[0]
    finally:
        for name, fn in originals.items():
            setattr(Evaluator, name, fn)
    if sorted(rows["device"]) != sorted(rows["exact"]):
        raise AssertionError("eval: the two modes scored different samples")
    worst = {}
    for m in ALL_METRICS:
        got = np.array([rows["device"][sid][m] for sid in rows["exact"]])
        want = np.array([rows["exact"][sid][m] for sid in rows["exact"]])
        rtol, atol = (5e-3, 5e-4) if m.startswith("emd/") else (1e-4, 1e-5)
        excess = np.abs(got - want) - (atol + rtol * np.abs(want))
        worst[m] = float(np.abs(got - want).max())
        if (excess > 0).any():
            raise AssertionError(f"eval: device mode's {m} off the exact mode's by "
                                 f"{worst[m]:.3e} (rtol {rtol:g}, atol {atol:g})")
    log("eval device vs exact mode, max abs difference: "
        + ", ".join(f"{m} {v:.2e}" for m, v in worst.items() if m.split("/")[1] == "avg"
                    or m.startswith("emd/")))

    ev = Evaluator(str(model_dir), db_dir=str(db), batch_size=EVAL_BATCH,
                   device_metrics=True, emd_mode="sinkhorn", device=DEVICE)
    g = ev.model.cfg.geometry
    data = synthetic_batch(torch.Generator(device=DEVICE).manual_seed(SEED + 11), EVAL_BATCH,
                           g, FRAME_HW, DEVICE)
    pred, mono, target, _, ps = eval_step(ev.model, data)
    layout = data["audio_mask"]

    def device_step():
        p, mo, t, _, _ = eval_step(ev.model, data)
        ev._emd_device_fn(p, mo, t, layout)
        ev._spectral_device_fn(p, t)

    step_ms = time_ms(device_step, warmup=2, iters=5)
    fwd_ms = time_ms(lambda: eval_step(ev.model, data), warmup=2, iters=5)
    # the eval step runs cuDNN's deterministic algorithms: one answer
    distinct = len({eval_step(ev.model, data)[0].cpu().numpy().tobytes() for _ in range(5)})
    log(f"eval step batch {EVAL_BATCH}: {distinct} distinct output(s) of 5 device steps of "
        f"one batch")
    if distinct != 1:
        raise AssertionError(f"eval step: {distinct} distinct outputs of one batch")
    emd_ms = time_ms(lambda: ev._emd_device_fn(pred, mono, target, layout), warmup=1, iters=5)
    spectral_ms = time_ms(lambda: ev._spectral_device_fn(pred, target), warmup=1, iters=5)
    log(f"eval device step batch {EVAL_BATCH} (forward + STFT battery + mel-LSD, envelope, "
        f"Sinkhorn EMD): {step_ms:.2f} ms; forward + STFT battery {fwd_ms:.2f} ms, Sinkhorn "
        f"EMD (2 x 200 iterations) {emd_ms:.2f} ms, mel-LSD + envelope {spectral_ms:.2f} ms "
        f"[{card}]")
    del ev, data, pred, mono, target, ps

    # TF32: a "default" model's forward sets TF32 inside its scope only; the
    # metrics run full float32 inside theirs, whatever the process has set
    model = flagship_model(model_dir, dft_precision="default").eval()
    audio, video = forward_inputs(torch.Generator(device=DEVICE).manual_seed(SEED + 12),
                                  EVAL_BATCH, model.cfg.geometry)
    switches = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    with torch.no_grad():
        model(audio, video)
    if (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) != switches:
        raise AssertionError("the \"default\" model's forward left the TF32 switches changed")
    del model, audio, video
    gen = torch.Generator().manual_seed(SEED + 13)
    a = 0.1 * torch.randn((EVAL_BATCH, g.snd_dur, 3), generator=gen)
    b = a + 0.05 * torch.randn((EVAL_BATCH, g.snd_dur, 3), generator=gen)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        errs = {}
        for name, fn in (("mel-LSD", mel_lsd_batch_fn(RATE)), ("envelope", envelope_dist_fn(
                g.snd_dur))):
            got = fn(a.to(DEVICE), b.to(DEVICE)).cpu().double()
            errs[name] = float((got - fn(a.double(), b.double())).abs().max())
        if not (torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32):
            raise AssertionError("an eval metric did not restore the TF32 switches")
        # what a leaked switch would cost: the Hilbert product in TF32
        h = torch.from_numpy(_hilbert_kernel(g.snd_dur)).to(DEVICE)
        tf32_err = float((h @ a.to(DEVICE)).cpu().double().sub(
            h.cpu().double() @ a.double()).abs().max())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    log(f"eval metrics on the card after a dft_precision=\"default\" forward, TF32 left on "
        f"in the process: max abs error against float64 on the CPU "
        + ", ".join(f"{k_} {v:.2e}" for k_, v in errs.items())
        + f" (limit 1e-5; the Hilbert product in TF32 alone: {tf32_err:.2e})")
    if max(errs.values()) > 1e-5:
        raise AssertionError(f"eval metrics on the card off float64: {errs}")
    return {"launches": exact_launches}


# ---------------------------------------------------------------------------
# 13. serve: StreamingMonoToAmbix, StreamBatcher and cli.serve on the card
# ---------------------------------------------------------------------------

SERVE_SECONDS = 3.0          # the batch-1 stream, pushed in 0.1 s blocks
SERVE_CAPACITIES = (32, 128)
SERVE_TICKS = 20             # 2 s of 0.1 s ticks per throughput run
SERVE_PACED_TICKS = 30       # 3 s paced at wall-clock rate, capacity 128 f32
SERVE_ISOLATION_CAPACITY = 32
SERVE_LANES = 4


def latency_stats(seconds: list) -> tuple[float, float]:
    """(median, p90) in ms."""
    ms = np.array(seconds) * 1e3
    return float(np.median(ms)), float(np.percentile(ms, 90))


def f16_ulp_check(a: np.ndarray, b: np.ndarray, what: str, min_share: float) -> float:
    """Each element bitwise equal or one float16 ulp apart at its own
    magnitude, and more than `min_share` of them bitwise equal. Returns the
    bitwise share."""
    if a.shape != b.shape or not np.array_equal(a[:, 0], b[:, 0]):
        raise AssertionError(f"{what}: shapes {a.shape} {b.shape} or W passthrough differ")
    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float16))
    over = np.abs(a - b) > ulp.astype(np.float32) * (1 + 1e-6)
    share = float((a == b).mean())
    if over.any() or share <= min_share:
        raise AssertionError(f"{what}: {int(over.sum())} elements over one f16 ulp, "
                             f"{100 * share:.2f}% bitwise equal")
    return share


def stream_run(stream, mono, frames, card: str, what: str) -> tuple[list, list]:
    """Push mono in 0.1 s blocks (one frame each), then flush. Returns (the
    chunks the pushes emitted, the chunks flush emitted), and prints the
    wall time of each push that emitted (median, p90)."""
    pushed, lat = [], []
    for i in range(0, len(mono), 4800):
        t0 = time.perf_counter()
        out = stream.push(mono[i: i + 4800], None if frames is None else frames[i // 4800])
        torch.cuda.synchronize()
        if out:
            lat.append(time.perf_counter() - t0)
            pushed += out
    flushed = stream.flush()
    med, p90 = latency_stats(lat)
    log(f"serve {what}: {len(pushed)} + {len(flushed)} windows (pushes + flush), "
        f"per-window latency median {med:.2f} ms / p90 {p90:.2f} ms [{card}]")
    return pushed, flushed


def batcher_run(batcher, signals, frames, ticks: int, paced: bool = False) -> tuple:
    """Feed every session 0.1 s (and one frame) per tick for `ticks` ticks
    and tick; returns the wall seconds of each tick (all of them run a
    forward: the sessions are warm) and of each tick's _tick_fn (uploads,
    the batched forward, the fetch; the rest of a tick is the host's
    window and frame assembly). Paced: each tick starts when a live source
    would have captured its block. K1 must launch once per tick."""
    from spatialaudiogen_tpu_torch.ops import masked_istft as k

    inner, fn_s = batcher._tick_fn, []

    def timed(*args):
        t0 = time.perf_counter()
        try:
            return inner(*args)
        finally:
            fn_s.append(time.perf_counter() - t0)

    batcher._tick_fn = timed
    lat = []
    start = len(batcher._sessions[0]._buf) + batcher._sessions[0]._buf_start
    t_start = time.perf_counter()
    for j in range(ticks):
        if paced:
            delay = t_start + (j + 1) * 0.1 - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
        lo = start + j * 4800
        for sid, sig in enumerate(signals):
            batcher.push(sid, sig[lo: lo + 4800], frames[(lo // 4800) % len(frames)])
        count = k.launch_count
        t0 = time.perf_counter()
        res = batcher.tick()
        lat.append(time.perf_counter() - t0)
        if len(res) != len(signals) or k.launch_count - count != 1:
            raise AssertionError(f"batcher tick: {len(res)} sessions emitted, K1 launched "
                                 f"{k.launch_count - count} times")
    del batcher._tick_fn
    return lat, fn_s


def serve_phase(card: str) -> dict:
    """Serving on the card, over phase 4's flagship model dir and clip:

    - StreamingMonoToAmbix over 3 s pushed in 0.1 s blocks with one frame
      each, then flush: the windows the pushes emit bit for bit
      MonoToAmbix(batch_size=1, yuv_frames=False).deploy() over the same
      span; K1 launched once per window and K2 never (the main path: the
      counts are set to 0 just before and read just after); per-window
      latency; the batch-1 forward alone and K1 at batch 1 (CUDA events);
      the batch-128 forward with and without deterministic cuDNN (time,
      and distinct outputs of 10 forwards of one batch: 1 with it); the
      same stream in bf16 1e-3 to 0.1 (relative L2) from it;
    - StreamBatcher at capacity 1: bit for bit the stream;
    - with an audio-only unet_mask 32-track model: at capacity 32 a session
      alone and packed with 31 noise neighbours bit for bit; 4 lanes against
      4 independent batch-1 streams within one f16 ulp, more than 99.5%
      bitwise on 3xTF32 and 99% on the bf16 route;
    - the flagship batcher at capacity 32 and 128, f32 and bf16, over 2 s:
      per-tick latency, the aggregate realtime factor, K1 once per tick;
      then 3 s at capacity 128 f32 paced at wall-clock rate (kept_up: p90
      tick under 100 ms);
    - cli.serve single-session and 2-session batched over wavs and the
      packed clip as frames dir: shapes, finiteness, the W passthrough bit
      for bit through the wav's PCM16, K1 once per window or tick.
    Returns K1's launches and batch-1 times."""
    from spatialaudiogen_tpu_torch.cli import serve as cli_serve
    from spatialaudiogen_tpu_torch.deploy.deploy import MonoToAmbix, deterministic_cudnn
    from spatialaudiogen_tpu_torch.deploy.stream import StreamBatcher, StreamingMonoToAmbix
    from spatialaudiogen_tpu_torch.ops import masked_istft as k
    from spatialaudiogen_tpu_torch.utils.io_audio import load_wav, save_wav

    model_dir, clip = SCRATCH / "model", SCRATCH / "clip"
    audio_dir = SCRATCH / "model_audio"
    write_model_dir(audio_dir, encoders=("audio",))
    pcm = np.load(clip / "packed" / "ambix.npy")[:, 0]
    mono = (pcm / np.float32(32768)).astype(np.float32)     # exact: wav decode is /32768
    frames = np.load(clip / "packed" / "video.npy")
    n = int(SERVE_SECONDS * RATE)
    result = {}

    # the batch-1 stream, f32: the main path
    stream = StreamingMonoToAmbix(str(model_dir))
    k.launch_count = k.bwd_launch_count = k.nhwc_launch_count = 0
    pushed, flushed = stream_run(stream, mono[:n], frames, card, "stream f32 (flagship)")
    launches = (k.launch_count, k.bwd_launch_count, k.nhwc_launch_count)
    windows = len(pushed) + len(flushed)
    log(f"serve stream f32: K1/K2/K3 launches {launches[0]}/{launches[1]}/{launches[2]} "
        f"for {windows} windows")
    if launches != (windows, 0, 0) or windows != int((SERVE_SECONDS - 0.5) * 10):
        raise AssertionError(f"stream: K1/K2/K3 launched {launches} for {windows} windows")
    f32 = np.concatenate(pushed + flushed, 0)
    if not np.isfinite(f32).all() or not np.abs(f32[:, 1:]).max() > 0:
        raise AssertionError("stream output not finite, or all zero")
    result["serve_launches"] = launches[0]
    deploy_s = len(pushed) * 0.1    # the windows whose context the pushes held
    ref = MonoToAmbix(str(model_dir), batch_size=1, yuv_frames=False).deploy(
        str(clip), deploy_start=0.5, deploy_duration=deploy_s)
    got = np.concatenate(pushed, 0)
    if got.shape != ref.shape or not np.array_equal(got, ref):
        raise AssertionError(f"stream {got.shape} is not batch-1 deploy {ref.shape} bit for "
                             f"bit (max abs {np.abs(got - ref).max():.3e})")
    log(f"serve stream f32 == MonoToAmbix(batch_size=1).deploy() over {deploy_s:.1f} s: "
        f"bit for bit")

    model = stream.engine.model
    g = model.cfg.geometry
    audio1, video1 = forward_inputs(torch.Generator(device=DEVICE).manual_seed(SEED + 14), 1, g)
    with torch.no_grad():
        fwd_ms = time_ms(lambda: model(audio1, video1), warmup=3, iters=20)
        with deterministic_cudnn():
            det_ms = time_ms(lambda: model(audio1, video1), warmup=3, iters=20)
    shape = (1,) + KERNEL_CASES[0][1][1:]     # the flagship's, at batch 1
    re, im, mask = k1_inputs(torch.Generator(device=DEVICE).manual_seed(SEED + 15), *shape,
                             torch.float32)
    with torch.no_grad():
        got1 = k.masked_istft(re, im, mask, 4, "default")
        want1 = k.masked_istft_plain(re, im, mask, 4, "default")
        k1_ms = time_ms(lambda: k.masked_istft(re, im, mask, 4, "default"))
        plain_ms = time_ms(lambda: k.masked_istft_plain(re, im, mask, 4, "default"))
    err = float((got1 - want1).abs().max())
    flops, spectra, mask_bytes, _ = istft_work(re, mask, "default")
    bound_ms, bound_by = bound(flops, spectra + mask_bytes + got1.numel() * 4, "default")
    log(f"serve: batch-1 flagship forward {det_ms:.2f} ms with cuDNN deterministic (as "
        f"served), {fwd_ms:.2f} ms without (CUDA events); K1 at batch 1 "
        f"{tuple(mask.shape)}: {k1_ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
        f"{bound_ms:.4f} ms by {bound_by}, max|kernel - plain| {err:.3e} [{card}]")
    if not torch.allclose(got1, want1, atol=2e-4, rtol=1e-4):
        raise AssertionError("K1 at batch 1 disagrees with its plain version")
    result["batch1"] = {"shape": list(mask.shape), "max_abs_err": err, "ms": k1_ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "forward_ms": det_ms}
    big = forward_inputs(torch.Generator(device=DEVICE).manual_seed(SEED + 17),
                         SERVE_CAPACITIES[-1], g)
    with torch.no_grad():
        fwd_ms = time_ms(lambda: model(*big), warmup=2, iters=10)
        with deterministic_cudnn():
            det_ms = time_ms(lambda: model(*big), warmup=2, iters=10)

    def distinct(n: int) -> int:
        """Distinct outputs among n forwards of the same batch."""
        with torch.no_grad():
            return len({model(*big).cpu().numpy().tobytes() for _ in range(n)})

    free = distinct(10)
    with deterministic_cudnn():
        det = distinct(10)
    log(f"serve: batch-{SERVE_CAPACITIES[-1]} flagship forward {det_ms:.2f} ms with cuDNN "
        f"deterministic, {fwd_ms:.2f} ms without; distinct outputs of 10 forwards of one "
        f"batch: {det} with, {free} without [{card}]")
    if det != 1:
        raise AssertionError(f"{det} distinct outputs of one batch under deterministic_cudnn")
    del stream, model, audio1, video1, big

    # bf16 compute, the same pushes
    bf16_stream = StreamingMonoToAmbix(str(model_dir), compute_dtype="bfloat16")
    pushed, flushed = stream_run(bf16_stream, mono[:n], frames, card, "stream bf16 (flagship)")
    bf16_err = rel_l2(np.concatenate(pushed + flushed, 0)[:, 1:], f32[:, 1:])
    log(f"serve stream bf16 vs f32: relative L2 {bf16_err:.3e} (limits 1e-3, 0.1)")
    if not 1e-3 <= bf16_err <= 0.1:
        raise AssertionError(f"bf16 stream {bf16_err:.3e} from the f32 one")
    del bf16_stream

    # capacity 1: the stream's batch composition, so bit for bit
    b1 = StreamBatcher(str(model_dir), capacity=1)
    sid = b1.add_session()
    got = []
    for i in range(0, n, 4800):
        b1.push(sid, mono[i: i + 4800], frames[i // 4800])
        got += b1.tick().get(sid, [])
    got += b1.flush(sid).get(sid, [])
    if not np.array_equal(np.concatenate(got, 0), f32):
        raise AssertionError("the capacity-1 batcher is not the stream bit for bit")
    log("serve StreamBatcher capacity 1 == the stream: bit for bit")
    del b1

    # audio-only lanes are independent
    rng = np.random.RandomState(SEED + 16)
    iso = {}
    for neighbours in (0, SERVE_ISOLATION_CAPACITY - 1):
        b = StreamBatcher(str(audio_dir), capacity=SERVE_ISOLATION_CAPACITY)
        sids = [b.add_session() for _ in range(1 + neighbours)]
        out = []
        for i in range(0, 2 * RATE, 9600):
            b.push(sids[0], mono[i: i + 9600])
            for other in sids[1:]:
                b.push(other, (0.2 * rng.randn(9600)).astype(np.float32))
            out += b.tick().get(sids[0], [])
        iso[neighbours] = np.concatenate(out, 0)
    if not np.array_equal(iso[0], iso[SERVE_ISOLATION_CAPACITY - 1]):
        raise AssertionError("audio-only lane isolation is not bitwise")
    log(f"serve StreamBatcher audio-only capacity {SERVE_ISOLATION_CAPACITY}: a session alone "
        f"and packed with {SERVE_ISOLATION_CAPACITY - 1} noise neighbours, bit for bit "
        f"({iso[0].shape[0] // 4800} windows)")
    # 4 lanes against 4 independent batch-1 streams: another batch size
    # sums in another order, so each element is bitwise equal or one f16
    # ulp off. On 3xTF32 ("highest", float32 order, as XLA:CPU is) more
    # than 99.5% are bitwise equal, the bound of tests/test_stream.py; the
    # bf16 route rounds the mask and spectra to bf16, which turns float32
    # order differences into more one-ulp flips (99.39-99.47% bitwise on
    # this model on an H100 80GB HBM3 at 700 W, PERF.md), so it is held to
    # 99%.
    signals = [np.roll(mono, -off)[: int(2.5 * RATE)] for off in (0, 7000, RATE, 3)]
    for precision, min_share in (("highest", 0.995), ("default", 0.99)):
        lanes_dir = audio_dir if precision == "default" else model_dir_at(audio_dir, precision)
        b = StreamBatcher(str(lanes_dir), capacity=SERVE_LANES)
        sids = [b.add_session() for _ in signals]
        lanes = {sid: [] for sid in sids}
        for i in range(0, len(signals[0]), 4800):
            for sid, sig in zip(sids, signals):
                b.push(sid, sig[i: i + 4800])
            for sid, chunks in b.tick().items():
                lanes[sid] += chunks
        for sid in sids:
            for key, chunks in b.flush(sid).items():
                lanes[key] += chunks
        shares = []
        for sid, sig in zip(sids, signals):
            s = StreamingMonoToAmbix(str(lanes_dir))
            want = np.concatenate(s.push(sig) + s.flush(), 0)
            shares.append(f16_ulp_check(np.concatenate(lanes[sid], 0), want,
                                        f"lane {sid} ({precision})", min_share))
        log(f"serve StreamBatcher audio-only capacity {SERVE_LANES} vs independent batch-1 "
            f"streams, pallas_precision={precision}: within one f16 ulp, bitwise shares "
            f"{[round(x, 5) for x in shares]} (limit {min_share:g})")
        del b

    # throughput: the flagship batcher at capacity 32 and 128, f32 and bf16
    result["ticks"] = {}
    for capacity in SERVE_CAPACITIES:
        for dtype in ("float32", "bfloat16"):
            b = StreamBatcher(str(model_dir), capacity=capacity, compute_dtype=dtype)
            # session j hears the clip from 0.1 j s on, repeated: long enough
            # for the join window and every tick (views, no copies)
            ticks = SERVE_TICKS + SERVE_PACED_TICKS
            long = np.tile(mono, -(-(4800 * (capacity + ticks) + g.snd_size) // len(mono)))
            sigs = [long[4800 * j:] for j in range(capacity)]
            for sid, sig in enumerate(sigs):      # join: each lane's first window
                b.add_session()
                b.push(sid, sig[: g.snd_size], frames[0])
                for f in frames[1: 11]:
                    b.push(sid, None, f)
            b.tick()
            k.launch_count = 0
            lat, fn_s = batcher_run(b, sigs, frames, SERVE_TICKS)
            med, p90 = latency_stats(lat)
            rtf = capacity * 0.1 / (med / 1e3)
            log(f"serve StreamBatcher flagship capacity {capacity} {dtype}: {SERVE_TICKS} "
                f"ticks, per-tick latency median {med:.2f} ms / p90 {p90:.2f} ms (of which "
                f"uploads, forward and fetch {latency_stats(fn_s)[0]:.2f} ms), aggregate "
                f"{rtf:.1f}x realtime, K1 launches {k.launch_count} [{card}]")
            result["ticks"][capacity, dtype] = (med, p90, rtf)
            if capacity == SERVE_CAPACITIES[-1] and dtype == "float32":
                result["batcher_launches"] = k.launch_count
                lat, _ = batcher_run(b, sigs, frames, SERVE_PACED_TICKS, paced=True)
                med, p90 = latency_stats(lat)
                log(f"serve StreamBatcher flagship capacity {capacity} f32, "
                    f"{SERVE_PACED_TICKS * 0.1:.0f} s paced at wall-clock rate: per-tick "
                    f"latency median {med:.2f} ms / p90 {p90:.2f} ms, kept_up={p90 < 100.0} "
                    f"[{card}]")
                result["paced"] = (med, p90, bool(p90 < 100.0))
            del b, sigs, long
            torch.cuda.empty_cache()

    # cli.serve: one session, then two batched, over wavs and the packed clip
    wavs = []
    for i in range(2):
        wavs.append(SCRATCH / f"serve_in{i}.wav")
        save_wav(str(wavs[-1]), np.roll(mono, -4800 * i)[: 2 * RATE, None], RATE,
                 subtype="float32")
    for inputs in (wavs[:1], wavs):
        outs = [SCRATCH / f"serve_out{i}.wav" for i in range(len(inputs))]
        argv = [str(model_dir), ",".join(map(str, inputs)), ",".join(map(str, outs)),
                "--frames_dir", ",".join([str(clip)] * len(inputs)), "--device", DEVICE]
        log(f"serve: cli.serve {' '.join(argv[1:])}")
        k.launch_count = 0
        summary = cli_serve.main(argv)
        s0 = int(0.5 * RATE)       # the first window's output starts 0.5 s in
        for src, out in zip(inputs, outs):
            foa, _ = load_wav(str(out), dtype=np.float32)
            src_w, _ = load_wav(str(src), dtype=np.float32)
            # save_wav's PCM16 of the input, read back as load_wav reads it
            w = np.clip(np.round(src_w[s0: s0 + len(foa), 0] * 32767.0), -32768, 32767)
            if foa.shape != (int(1.5 * RATE), 4) or not np.isfinite(foa).all():
                raise AssertionError(f"cli.serve {out.name}: shape {foa.shape}")
            if not np.array_equal(foa[:, 0], w.astype(np.int16) / np.float32(32768)):
                raise AssertionError(f"cli.serve {out.name}: W is not the input's PCM16")
        # K1 once per tick (or push) that ran a forward, then once per
        # flush round of each session: 15 windows a session
        runs = len(summary["latency_s"])
        if k.launch_count != runs + len(inputs) * (15 - runs):
            raise AssertionError(f"cli.serve: K1 launched {k.launch_count} times, "
                                 f"{runs} forwards before the flush")
        log(f"cli.serve {len(inputs)} session(s): outputs (72000, 4), finite, W the input's "
            f"PCM16 bit for bit; K1 launches {k.launch_count}")
    return result


# ---------------------------------------------------------------------------
# 14. multi-device train: data and tensor parallel cli.train across ranks
# ---------------------------------------------------------------------------

MD_BATCH = 32
# (what, n_data, n_model, steps) of phase 14: two ranks on this card
MD_RUNS = (("data parallel", 2, 1, 2), ("tensor parallel", 1, 2, 2))
# --multi_card: a card per rank (NCCL), and the 2x2 grid where there are
# four cards
MD_CARD_RUNS = MD_RUNS + (("data and tensor parallel", 2, 2, 2),)
MD_TB_STEPS = 3
# Relative loss limit against one process, every step. The ranks round
# otherwise than one process (a rank's 16 rows, the BN and loss sums over
# two ranks), and Adam's first updates move each weight by about lr
# whatever its gradient's size, so a weight whose gradient is rounding
# noise moves either way; the loss carries that from the second update
# on. Two steps stay inside 1e-4; a third does not, even for one process
# against itself with the halves of each batch swapped: phase 14 measures
# that spread over MD_SPREAD_STEPS and prints it.
MD_LOSS_RTOL = 1e-4
MD_SPREAD_STEPS = 3

# One rank of phase 14: cli.train in this process with the kernels on
# 3xTF32 (pallas_precision "highest", so that the ranks can be held to one
# process at 1e-4), K1/K2/K3 counts set to 0 just before and read just
# after, each train step timed (synchronised host clock), and rank 0's last
# step profiled: the share of its wall time inside torch.distributed's
# all-reduce (host clock around each call, synchronised) and, from
# torch.profiler, in its allreduce ops. Prints one RANK_RESULT line, with
# the backend the mesh's groups took.
RANK_MAIN = r"""
import dataclasses, json, sys, time
import torch
import torch.distributed as dist
from spatialaudiogen_tpu_torch.cli import train as cli_train
from spatialaudiogen_tpu_torch.config import TrainConfig
from spatialaudiogen_tpu_torch.ops import masked_istft as k
from spatialaudiogen_tpu_torch.parallel import mesh
from spatialaudiogen_tpu_torch.train import trainer

backends = []
collective_backend = mesh.collective_backend
mesh.collective_backend = lambda device: backends.append(collective_backend(device)) or backends[-1]
argv = sys.argv[1:]
rank = int(argv[argv.index("--process_id") + 1])
n_steps = int(argv[argv.index("--n_iters") + 1])
model_config = TrainConfig.model_config
TrainConfig.model_config = lambda self: dataclasses.replace(model_config(self),
                                                            pallas_precision="highest")
step_ms, ar_ms, prof = [], [0.0], {}
all_reduce = dist.all_reduce

def timed_all_reduce(*a, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = all_reduce(*a, **kw)
    torch.cuda.synchronize()
    ar_ms[0] += (time.perf_counter() - t0) * 1e3
    return out

train_step = trainer.train_step

def step(*a, **kw):
    last = rank == 0 and len(step_ms) == n_steps - 1
    if last:
        from torch.profiler import ProfilerActivity, profile
        dist.all_reduce = timed_all_reduce
        p = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        p.__enter__()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = train_step(*a, **kw)
    torch.cuda.synchronize()
    step_ms.append((time.perf_counter() - t0) * 1e3)
    if last:
        p.__exit__(None, None, None)
        dist.all_reduce = all_reduce
        ops = [e for e in p.key_averages() if e.key == "c10d::allreduce_"]
        prof.update(ms=step_ms[-1], timed_all_reduce_ms=ar_ms[0],
                    profiler_allreduce_ms=ops[0].cpu_time_total / 1e3 if ops else None,
                    profiler_allreduce_calls=ops[0].count if ops else None)
    return out

trainer.train_step = step
k.launch_count = k.bwd_launch_count = k.nhwc_launch_count = 0
cli_train.main(argv)
print("RANK_RESULT " + json.dumps({"rank": rank, "launches": [
    k.launch_count, k.bwd_launch_count, k.nhwc_launch_count], "step_ms": step_ms,
    "profile": prof, "backends": backends, "device": str(torch.cuda.current_device())}),
    flush=True)
"""


def md_flags(db: Path, model_dir: Path, steps: int, batch: int) -> list:
    return [str(db), str(model_dir), "--encoders", "audio", "video", "--frame_hw",
            *map(str, FRAME_HW), "--batch_size", str(batch), "--n_iters", str(steps),
            "--log_every", "1", "--ckpt_every", "0", "--n_workers", "1", "--seed", str(SEED),
            "--device", DEVICE]


def run_ranks(db: Path, model_dir: Path, steps: int, n_data: int, n_model: int) -> list:
    """cli.train in the --coordinator form, one process per rank (rank r on
    card r % cards: gloo when ranks share a card, NCCL when each has its
    own). -> each rank's RANK_RESULT."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    n = n_data * n_model
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_MAIN, *md_flags(db, model_dir, steps, MD_BATCH),
         "--n_data", str(n_data), "--n_model", str(n_model), "--coordinator",
         f"localhost:{port}", "--n_processes", str(n), "--process_id", str(r)],
        cwd=str(ROOT), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=400)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    results = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        lines = [line for line in out.splitlines() if line.startswith("RANK_RESULT ")]
        if p.returncode != 0 or not lines:
            raise AssertionError(f"rank {r} of {n} exited {p.returncode}:\n{out[-3000:]}")
        results.append(json.loads(lines[-1][len("RANK_RESULT "):]))
    return results


def one_process_losses(db: Path, steps: int, n_shards: int,
                       swap_halves: bool = False) -> tuple[list, list]:
    """The flagship's steps in this process over the global batches that
    n_shards data ranks form ([rank 0's rows; rank 1's rows]: one feeder
    per shard, the trainer's shards and seed, one worker each; with
    swap_halves the two halves of each batch change places, the same
    loss in exact arithmetic), kernels on 3xTF32. -> (losses, step ms
    after the first)."""
    from spatialaudiogen_tpu_torch.config import TrainConfig
    from spatialaudiogen_tpu_torch.data.pipeline import Feeder
    from spatialaudiogen_tpu_torch.data.readers import img_prep_u8
    from spatialaudiogen_tpu_torch.train.state import create_train_state
    from spatialaudiogen_tpu_torch.train.steps import train_step

    cfg = TrainConfig(encoders=("audio", "video"), frame_hw=FRAME_HW, seed=SEED,
                      batch_size=MD_BATCH, pallas_precision="highest")
    feeders = [Feeder(str(db), ambi_order=1, audio_rate=cfg.audio_rate,
                      video_rate=cfg.video_rate, context=cfg.context,
                      duration=cfg.sample_dur, return_video=True, img_prep=img_prep_u8,
                      batch_size=MD_BATCH // n_shards, n_workers=1, for_eval=False,
                      seed=cfg.seed, shard_id=i, num_shards=n_shards).start()
               for i in range(n_shards)]
    try:
        iters = [f.batches() for f in feeders]
        batches = []
        for _ in range(steps):
            parts = [next(it) for it in iters]
            batch = {key: np.concatenate([p[key] for p in parts]) for key in parts[0]
                     if key != "id"}
            if swap_halves:
                batch = {key: np.roll(v, MD_BATCH // 2, axis=0) for key, v in batch.items()}
            batches.append({key: torch.from_numpy(v).to(DEVICE) for key, v in batch.items()})
    finally:
        for f in feeders:
            f.stop()
    state = create_train_state(cfg, DEVICE)
    losses, ms = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(train_step(state, b, cfg.lr)["total_loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    del state
    torch.cuda.empty_cache()
    return losses, ms[1:]


def write_resnet_npy(path: Path) -> np.ndarray:
    """A reference-style resnet18.npy (TF variable names) of random values
    for the visual encoder, conv1 four input channels wide; -> conv1's
    OIHW slice the encoder must start from."""
    from spatialaudiogen_tpu_torch.config import SptAudioGenConfig
    from spatialaudiogen_tpu_torch.models.convert import nest, to_flax, to_tf_var_dict
    from spatialaudiogen_tpu_torch.models.sptaudiogen import SptAudioGen

    model = SptAudioGen(SptAudioGenConfig(), frame_hw=FRAME_HW)
    visual = {k.replace("/video_encoder/", "/", 1): v for k, v in
              to_flax(model.state_dict()).items() if "/video_encoder/" in k}
    rng = np.random.RandomState(SEED + 14)
    blob = {name: (0.05 * rng.randn(*v.shape)).astype(np.float32)
            for name, v in to_tf_var_dict(nest(visual)).items()}
    for name in blob:
        if name.endswith(("moving_variance", "gamma")):
            blob[name] = 1.0 + np.abs(blob[name])
    w = blob["conv1/weights"]
    blob["conv1/weights"] = np.concatenate([w, w[:, :, :1]], axis=2)
    np.save(path, blob, allow_pickle=True)
    return np.ascontiguousarray(w.transpose(3, 2, 0, 1))


def md_parallel_runs(card: str, runs) -> dict:
    """cli.train over phase 7's two-clip dataset (one clip per data rank)
    in the --coordinator form, flagship at global batch 32, kernels on
    3xTF32, for each (what, n_data, n_model, steps) of `runs`: held to one
    process on the same global batches (losses within MD_LOSS_RTOL), K1
    and K2 launched once per step on every rank, the mesh's groups on the
    backend the ranks' cards call for (gloo when they share one, NCCL when
    each has its own), each rank's step ms and the all-reduce's share of a
    profiled rank-0 step. -> {what: each rank's launches}."""
    db = SCRATCH / "train_db"
    out = {}
    for what, n_data, n_model, steps in runs:
        model_dir = SCRATCH / f"md_{n_data}x{n_model}"
        n_ranks, cards = n_data * n_model, torch.cuda.device_count()
        backend = "nccl" if cards >= n_ranks else "gloo"
        t0 = time.perf_counter()
        ranks = run_ranks(db, model_dir, steps, n_data, n_model)
        wall = time.perf_counter() - t0
        recs = [json.loads(line) for line in (model_dir / "metrics.jsonl").read_text()
                .splitlines()]
        losses = [r["total_loss"] for r in recs]
        want, one_ms = one_process_losses(db, steps, n_data)
        errs = [abs(a - b) / abs(b) for a, b in zip(losses, want)]
        log(f"multi-device {what} (n_data {n_data}, n_model {n_model}, {n_ranks} ranks on "
            f"{min(cards, n_ranks)} card(s), {backend}, global batch {MD_BATCH}, {steps} "
            f"steps in {wall:.1f} s wall): losses {[round(x, 4) for x in losses]}, one "
            f"process {[round(x, 4) for x in want]}, relative differences "
            f"{[f'{e:.2e}' for e in errs]} (limit {MD_LOSS_RTOL})")
        for r in ranks:
            ms = r["step_ms"][1:]
            log(f"  rank {r['rank']} (cuda:{r['device']}, groups {r['backends']}): K1/K2/K3 "
                f"launches {r['launches']}, step ms after the first "
                f"{[round(x, 2) for x in ms]} [{card}]")
        log(f"  one process, same batches: step ms after the first "
            f"{[round(x, 2) for x in one_ms]} [{card}]")
        prof = ranks[0]["profile"]
        ar_ms = prof["timed_all_reduce_ms"]
        log(f"  rank 0's profiled step: {prof['ms']:.2f} ms, of which "
            f"{ar_ms:.2f} ms ({100 * ar_ms / prof['ms']:.1f}%) "
            f"inside torch.distributed.all_reduce (synchronised host clock); torch.profiler: "
            f"{prof['profiler_allreduce_calls']} c10d::allreduce_ calls, "
            f"{prof['profiler_allreduce_ms']} ms on the host [{card}]")
        if len(losses) != steps or not np.isfinite(losses).all() or max(errs) > MD_LOSS_RTOL:
            raise AssertionError(f"{what}: losses {losses} against one process {want}")
        if any(r["launches"] != [steps, steps, 0] for r in ranks):
            raise AssertionError(f"{what}: K1/K2/K3 launches per rank "
                                 f"{[r['launches'] for r in ranks]} in {steps} steps")
        if any(r["backends"] != [backend] for r in ranks):
            raise AssertionError(f"{what}: the mesh's groups took "
                                 f"{[r['backends'] for r in ranks]}, not {backend}")
        out[what] = [r["launches"][:2] for r in ranks]
    return out


def multi_device_phase(card: str) -> dict:
    """md_parallel_runs of MD_RUNS: data parallel (n_data 2) and tensor
    parallel (n_model 2, audio-fc split), 2 steps each, two ranks sharing
    this card; the spread of one process against itself (MD_LOSS_RTOL).
    Then cli.train in this process with --tb_histograms 2
    --tb_activations --pretrained_resnet (an npy it writes) for 3 steps:
    conv1 the npy's slice before step 0, the params, grads and acts
    histograms decode, and the observe steps' K1/K2 launches on top of the
    train steps'."""
    from spatialaudiogen_tpu_torch.cli import train as cli_train
    from spatialaudiogen_tpu_torch.ops import masked_istft as k
    from spatialaudiogen_tpu_torch.train.trainer import Trainer
    from spatialaudiogen_tpu_torch.utils.tensorboard import decode_histograms

    out = md_parallel_runs(card, MD_RUNS)
    db = SCRATCH / "train_db"
    want, _ = one_process_losses(db, MD_SPREAD_STEPS, 2)
    swapped, _ = one_process_losses(db, MD_SPREAD_STEPS, 2, swap_halves=True)
    log(f"one process against itself, the halves of each global batch swapped (the same "
        f"loss in exact arithmetic): relative differences "
        f"{[f'{abs(a - b) / abs(b):.2e}' for a, b in zip(swapped, want)]} over "
        f"{MD_SPREAD_STEPS} steps [{card}]")
    npy = SCRATCH / "resnet18.npy"
    conv1 = write_resnet_npy(npy)
    seen = {}
    train = Trainer.train

    def check_start(self):
        weight = self.state.model.video_encoder.conv1.conv.weight
        seen["conv1"] = weight.detach().cpu().numpy().copy()
        return train(self)

    model_dir = SCRATCH / "md_tb"
    argv = md_flags(db, model_dir, MD_TB_STEPS, MD_BATCH) + [
        "--tb_histograms", "2", "--tb_activations", "--pretrained_resnet", str(npy)]
    Trainer.train = check_start
    try:
        k.launch_count = k.bwd_launch_count = k.nhwc_launch_count = 0
        cli_train.main(argv)
        launches = (k.launch_count, k.bwd_launch_count, k.nhwc_launch_count)
    finally:
        Trainer.train = train
    (events,) = model_dir.glob("events.out.tfevents.*")
    tags = {t for t, *_ in decode_histograms(str(events))}
    kinds = {t.split("/")[0] for t in tags}
    observed = len(range(0, MD_TB_STEPS, 2))
    log(f"cli.train --tb_histograms 2 --tb_activations --pretrained_resnet: {len(tags)} "
        f"histogram tags ({', '.join(sorted(kinds))}), K1/K2/K3 launches "
        f"{launches[0]}/{launches[1]}/{launches[2]} in {MD_TB_STEPS} steps and {observed} "
        f"observe steps; conv1 at step 0 off the npy's slice by "
        f"{float(np.abs(seen['conv1'] - conv1).max()):.3e}")
    if kinds != {"params", "grads", "acts"} or not {
            "params/video_encoder/conv1/conv/kernel", "grads/bottleneck/audio-fc/dense/kernel",
            "acts/separation"} <= tags:
        raise AssertionError(f"histogram tags: {sorted(tags)[:10]}")
    if launches != (MD_TB_STEPS + observed, MD_TB_STEPS + observed, 0):
        raise AssertionError(f"K1/K2/K3 launched {launches} times with the observe steps")
    if not np.array_equal(seen["conv1"], conv1):
        raise AssertionError("conv1 did not start from the npy's slice")
    out["tb"] = list(launches[:2])
    return out


# ---------------------------------------------------------------------------
# 15. sharded inference: cli.deploy, cli.eval and cli.serve with --n_data 2
# ---------------------------------------------------------------------------

SH_DEPLOY_SECONDS = 2.0   # at batch 16: batches of 16 and 4 windows; the tail's 12 pad
                          # lanes fill rank 0's block past 4 and all of rank 1's
SH_SERVE_SECONDS = 2.0
SH_SERVE_OFFSETS = (0, 5000, 48000, 17)     # four sessions: phase 4's mono rolled
SH_DEPLOY_ATOL = 1e-5
# serve, sharded against one process: cli.serve fetches float16, so an
# element may round to the neighbouring float16 value (one ulp at its
# magnitude); near zero, where that ulp is tiny, within SH_SERVE_ATOL
SH_SERVE_ATOL = 1e-5
# eval rows, sharded against one process: (rtol, atol) of the EMD columns
# (Sinkhorn iterates on its inputs) and of the rest (phase 12's atol: the
# snr columns near 0 dB have no relative scale; a first reading at atol
# 1e-6 found snr/Z at -0.0058 dB 5.7e-6 apart)
SH_EVAL_TOL = {"emd": (1e-3, 1e-5), "rest": (1e-4, 1e-5)}

@contextlib.contextmanager
def cli_probes(record: dict):
    """While open, MonoToAmbix.deploy, Evaluator.run and cli.serve's serving
    loop each run twice: the main path's call, with the kernel counts read
    just after it into record["launches"], then the same call again, warm,
    its seconds (synchronised host clock) into record["seconds"] (serving
    also its served and wall seconds); the backend each mesh's groups took
    goes to record["backends"], the float arrays save_wav writes to
    record["wavs"]."""
    from spatialaudiogen_tpu_torch.cli import serve
    from spatialaudiogen_tpu_torch.deploy.deploy import MonoToAmbix
    from spatialaudiogen_tpu_torch.eval.evaluator import Evaluator
    from spatialaudiogen_tpu_torch.ops import masked_istft as k
    from spatialaudiogen_tpu_torch.parallel import mesh
    from spatialaudiogen_tpu_torch.utils import io_audio

    record.update(launches=[], seconds={}, backends=[], wavs={})

    def sync():    # (a CPU rehearsal of the phase has no card to wait for)
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def twice(fn, name):
        def wrapper(*a, **kw):
            out = fn(*a, **kw)
            record["launches"] += [k.launch_count, k.bwd_launch_count, k.nhwc_launch_count]
            sync()
            t0 = time.perf_counter()
            again = fn(*a, **kw)
            sync()
            record["seconds"][name] = time.perf_counter() - t0
            if name == "serve" and again is not None:
                record["served_s"], record["wall_s"] = again["served_s"], again["wall_s"]
            return out
        return wrapper

    def backend(device):
        record["backends"].append(collective_backend(device))
        return record["backends"][-1]

    def keep(fn, data, *a, **kw):
        record["wavs"].setdefault(os.path.basename(fn), np.asarray(data, np.float32))
        return save_wav(fn, data, *a, **kw)

    collective_backend, save_wav = mesh.collective_backend, io_audio.save_wav
    originals = [(MonoToAmbix, "deploy"), (Evaluator, "run"), (serve, "_serve_batched")]
    saved = [getattr(obj, name) for obj, name in originals]
    for (obj, name), fn in zip(originals, saved):
        setattr(obj, name, twice(fn, {"_serve_batched": "serve", "run": "eval"}.get(name, name)))
    mesh.collective_backend, io_audio.save_wav = backend, keep
    k.launch_count = k.bwd_launch_count = k.nhwc_launch_count = 0
    try:
        yield record
    finally:
        for (obj, name), fn in zip(originals, saved):
            setattr(obj, name, fn)
        mesh.collective_backend, io_audio.save_wav = collective_backend, save_wav


def run_cli(module: str, argv: list, out: str, rank: tuple | None = None) -> dict:
    """`module`'s CLI in this process under cli_probes: main(argv), or with
    `rank` = (coordinator, n, r) rank r's rank_main. What main returns on
    rank 0 (deploy's array, eval's rows, serve's float outputs) is saved
    beside `out`. -> the rank's result."""
    import importlib

    mod = importlib.import_module(module)
    with cli_probes({}) as record:
        ret = mod.rank_main(argv, *rank) if rank else mod.main(argv)
    if isinstance(ret, np.ndarray):
        np.save(out + ".npy", ret)
    elif isinstance(ret, tuple) and ret[1]:
        Path(out + ".json").write_text(json.dumps([[sid, rec] for sid, rec in ret[1]]))
    wavs = record.pop("wavs")
    if wavs:
        np.savez(out + ".npz", **wavs)
    return {"rank": rank[2] if rank else 0, "launches": record["launches"][:3],
            "device": torch.cuda.current_device() if torch.cuda.is_available() else "cpu",
            **{key: record[key] for key in ("seconds", "backends", "served_s", "wall_s")
               if key in record}}


# One rank of phase 15: run_cli in a process of its own, its result printed
# on a RANK_RESULT line.
INFER_RANK_MAIN = r"""
import json, sys
import chip_smoke

spec = json.loads(sys.argv[1])
result = chip_smoke.run_cli(spec["module"], spec["argv"], spec["out"],
                            (spec["coordinator"], spec["n"], spec["rank"]))
print("RANK_RESULT " + json.dumps(result), flush=True)
"""


def infer_ranks(module: str, argv: list, n: int, out: Path) -> tuple[list, float]:
    """`module`'s CLI with --n_data n: n = 1 in this process, else one
    process per rank (rank r on card r % cards: gloo when ranks share a
    card, NCCL when each has its own). -> (each rank's result, wall s)."""
    import socket

    argv = [*map(str, argv), "--n_data", str(n), "--device", DEVICE]
    t0 = time.perf_counter()
    if n == 1:
        return [run_cli(module, argv, str(out))], time.perf_counter() - t0
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen(
        [sys.executable, "-c", INFER_RANK_MAIN, json.dumps(
            {"module": module, "argv": argv, "coordinator": f"localhost:{port}", "n": n,
             "rank": r, "out": str(out)})],
        cwd=str(ROOT), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=400)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    wall = time.perf_counter() - t0
    results = []
    for r, (p, text) in enumerate(zip(procs, outs)):
        lines = [line for line in text.splitlines() if line.startswith("RANK_RESULT ")]
        if p.returncode != 0 or not lines:
            raise AssertionError(f"{module} rank {r} of {n} exited {p.returncode}:\n"
                                 f"{text[-3000:]}")
        results.append(json.loads(lines[-1][len("RANK_RESULT "):]))
    return results, wall


def sharded_pair(card: str, what: str, module: str, argv_of, out: Path) -> tuple:
    """The CLI at --n_data 1 and at --n_data 2 (two ranks, one per card
    when there are two, else sharing one over gloo), argv_of(n) its
    arguments: K1 launched on every rank, the groups on the backend the
    cards call for. -> (one process's RANK_RESULT, the ranks' RANK_RESULTs)."""
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= 2 else "gloo"
    (one,), one_wall = infer_ranks(module, argv_of(1), 1, out.with_name(out.name + "_1"))
    ranks, wall = infer_ranks(module, argv_of(2), 2, out.with_name(out.name + "_2"))
    for r in [one] + ranks:
        who = "one process" if r is one else f"rank {r['rank']}"
        log(f"  {what}, {who} (cuda:{r['device']}, groups {r['backends'] or 'none'}): "
            f"K1/K2/K3 launches {r['launches']}, timed {r['seconds']} [{card}]")
    log(f"  {what}: wall of the command (models loaded) {one_wall:.1f} s at --n_data 1 in "
        f"this process, {wall:.1f} s at --n_data 2 over {backend} (processes started)")
    if any(r["launches"][0] < 1 or r["launches"][1:] != [0, 0] for r in [one] + ranks):
        raise AssertionError(f"{what}: K1/K2/K3 launches {[r['launches'] for r in ranks]}")
    if any(set(r["backends"]) != {backend} for r in ranks):
        raise AssertionError(f"{what}: the mesh's groups took "
                             f"{[r['backends'] for r in ranks]}, not {backend}")
    return one, ranks


def sharded_inference_runs(card: str, eval_model: Path | None = None) -> dict:
    """cli.deploy, cli.eval and cli.serve with --n_data 2 (a process a
    rank, INFER_RANK_MAIN) against --n_data 1 (in this process), under
    cli_probes, the flagship at
    pallas_precision "highest" (3xTF32, so float32 summation order is the
    only difference): deploy over phase 4's clip at batch 16 with
    --f32_fetch within SH_DEPLOY_ATOL; eval of phase 7's model over its
    dataset with --device_metrics --emd sinkhorn, the same rows in the same
    order within SH_EVAL_TOL; serve of four sessions of phase 4's clip
    (mono rolled, its packed frames) within one float16 ulp or
    SH_SERVE_ATOL (cli.serve fetches float16). Each with its K1 launches per rank,
    and its warm repeat's time and realtime factor. `eval_model`: the model eval
    scores (phase 7's by default). -> {run: K1 launches per rank}."""
    from spatialaudiogen_tpu_torch.utils.io_audio import save_wav

    model, clip = model_dir_at(SCRATCH / "model", "highest"), SCRATCH / "clip"
    out = {}

    argv = [model, clip, "--batch_size", DEPLOY_BATCH, "--deploy_start", DEPLOY_START,
            "--deploy_duration", SH_DEPLOY_SECONDS, "--f32_fetch"]
    one, ranks = sharded_pair(card, "deploy", "spatialaudiogen_tpu_torch.cli.deploy",
                              lambda n: argv, SCRATCH / "sh_deploy")
    a, b = (np.load(SCRATCH / f"sh_deploy_{n}.npy") for n in (1, 2))
    err = float(np.abs(a - b).max()) if a.shape == b.shape else float("inf")
    t1, t2 = one["seconds"]["deploy"], ranks[0]["seconds"]["deploy"]
    log(f"sharded deploy ({SH_DEPLOY_SECONDS} s, batch {DEPLOY_BATCH}, 3xTF32, f32 fetch): "
        f"shape {b.shape}, max |2 ranks - one process| {err:.3e} (limit {SH_DEPLOY_ATOL:g}); "
        f"deploy() warm {t1:.3f} s ({SH_DEPLOY_SECONDS / t1:.2f}x realtime) in one process, "
        f"{t2:.3f} s ({SH_DEPLOY_SECONDS / t2:.2f}x) on rank 0 [{card}]")
    if not (a.shape == b.shape and np.array_equal(a[:, 0], b[:, 0]) and err <= SH_DEPLOY_ATOL
            and np.isfinite(b).all()):
        raise AssertionError(f"sharded deploy: {a.shape} vs {b.shape}, max diff {err:.3e}")
    out["deploy"] = [r["launches"][0] for r in ranks]

    trained = model_dir_at(eval_model or SCRATCH / "trained", "highest")
    dirs = []
    for n in (1, 2):
        d = SCRATCH / f"sh_eval_model_{n}"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(trained, d)
        dirs.append(d)
    flags = ["--db_dir", SCRATCH / "train_db", "--batch_size", EVAL_BATCH, "--n_workers", "1",
             "--device_metrics", "--emd", "sinkhorn"]
    one, ranks = sharded_pair(card, "eval", "spatialaudiogen_tpu_torch.cli.eval",
                              lambda n: [dirs[n - 1]] + flags, SCRATCH / "sh_eval")
    got, want = (json.loads((SCRATCH / f"sh_eval_{n}.json").read_text()) for n in (2, 1))
    worst = {}
    for (sid_g, g), (sid_w, w) in zip(got, want):
        if sid_g != sid_w:
            raise AssertionError(f"sharded eval rows out of order: {sid_g} != {sid_w}")
        for m, v in w.items():
            rtol, atol = SH_EVAL_TOL["emd" if m.startswith("emd/") else "rest"]
            worst[m] = max(worst.get(m, 0.0), abs(g[m] - v))
            if abs(g[m] - v) > atol + rtol * abs(v) or not np.isfinite(g[m]):
                raise AssertionError(f"sharded eval {sid_g} {m}: {g[m]} vs {v}")
    n_rows = len(want)
    log(f"sharded eval (--device_metrics --emd sinkhorn, batch {EVAL_BATCH}, 3xTF32): "
        f"{len(got)} rows in the one file, same ids and order as one process; max |diff| "
        + ", ".join(f"{m} {worst[m]:.2e}" for m in ("stft/avg", "mse/avg", "emd/dir"))
        + f"; run() warm {one['seconds']['eval']:.2f} s "
        f"({n_rows / one['seconds']['eval']:.1f} "
        f"samples/s) in one process, {ranks[0]['seconds']['eval']:.2f} s "
        f"({n_rows / ranks[0]['seconds']['eval']:.1f}) on rank 0 [{card}]")
    if len(got) != n_rows or any(r["launches"][0] != -(-n_rows // EVAL_BATCH) for r in ranks):
        raise AssertionError(f"sharded eval: {len(got)} rows of {n_rows}, K1 launches "
                             f"{[r['launches'] for r in ranks]}")
    out["eval"] = [r["launches"][0] for r in ranks]

    audio = np.load(clip / "packed" / "ambix.npy")[:, 0].astype(np.float32) / 32768.0
    n_samples = int(SH_SERVE_SECONDS * RATE)
    ins = []
    for i, off in enumerate(SH_SERVE_OFFSETS):
        ins.append(str(SCRATCH / f"sh_serve_in{i}.wav"))
        save_wav(ins[-1], np.roll(audio, -off)[:n_samples, None], RATE)
    outs = [str(SCRATCH / f"sh_serve_out{i}.wav") for i in range(len(ins))]
    argv = [model, ",".join(ins), ",".join(outs), "--frames_dir",
            ",".join([str(clip)] * len(ins))]
    one, ranks = sharded_pair(card, "serve", "spatialaudiogen_tpu_torch.cli.serve",
                              lambda n: argv, SCRATCH / "sh_serve")
    a, b = (np.load(SCRATCH / f"sh_serve_{n}.npz") for n in (1, 2))
    if len(a.files) != len(ins) or sorted(a.files) != sorted(b.files):
        raise AssertionError(f"sharded serve wrote {sorted(b.files)}, one process "
                             f"{sorted(a.files)}")
    shares, diff = [], 0.0
    for key in sorted(a.files):
        x, y = b[key], a[key]
        if x.shape != y.shape or not np.array_equal(x[:, 0], y[:, 0]):
            raise AssertionError(f"sharded serve {key}: shapes {x.shape} {y.shape} or W "
                                 f"passthrough differ")
        ulp = np.spacing(np.maximum(np.abs(x), np.abs(y)).astype(np.float16))
        over = np.abs(x - y) > np.maximum(ulp.astype(np.float32) * (1 + 1e-6),
                                          SH_SERVE_ATOL)
        if over.any():
            raise AssertionError(f"sharded serve {key}: {int(over.sum())} elements over "
                                 f"one f16 ulp and {SH_SERVE_ATOL:g}")
        shares.append(float((x == y).mean()))
        diff = max(diff, float(np.abs(x - y).max()))
    log(f"sharded serve ({len(ins)} sessions of {SH_SERVE_SECONDS} s, 3xTF32, float16 "
        f"fetch): every output within one f16 ulp or {SH_SERVE_ATOL:g} of one process, "
        f"{100 * min(shares):.2f}% bitwise or more, max |diff| {diff:.2e}; warm, "
        f"{one['served_s']:.1f} s served in {one['wall_s']:.2f} s "
        f"({one['served_s'] / one['wall_s']:.1f}x realtime aggregate) in one process, in "
        f"{ranks[0]['wall_s']:.2f} s ({ranks[0]['served_s'] / ranks[0]['wall_s']:.1f}x) "
        f"on 2 ranks [{card}]")
    out["serve"] = [r["launches"][0] for r in ranks]
    return out


# ---------------------------------------------------------------------------
# 16. order 2: cli.train --ambi_order 2, a 9-channel deploy, eval
# ---------------------------------------------------------------------------

ORDER2_CLIP_SECONDS = 6
ORDER2_BATCH = 32


def order2_phase(card: str) -> dict:
    """The flagship at ambi_order=2 (n_in = 4 into K1 and K2; five channels
    predicted): cli.train --ambi_order 2 for TRAIN_STEPS steps at batch 32
    over two 9-channel packed clips written here (K1 and K2 once per step),
    MonoToAmbix deploys the trained model to 9 channels on the card (W, Y,
    Z, X passed through bit for bit, K1 launched), the same params on the
    CPU against the card at pallas_precision "highest" (<= 1e-4), the
    Evaluator's pass over the clips (--device_metrics, Sinkhorn; K1 once per
    batch), and the order-2 forward and train step timed at batch 32."""
    from spatialaudiogen_tpu_torch.config import TrainConfig
    from spatialaudiogen_tpu_torch.deploy.deploy import MonoToAmbix
    from spatialaudiogen_tpu_torch.eval.evaluator import Evaluator
    from spatialaudiogen_tpu_torch.ops import masked_istft as k
    from spatialaudiogen_tpu_torch.train.state import create_train_state
    from spatialaudiogen_tpu_torch.train.steps import train_step

    db, model_dir = SCRATCH / "order2_db", SCRATCH / "order2"
    write_train_db(db, order=2, seconds=ORDER2_CLIP_SECONDS)
    _, launches, _ = cli_train_run(db, model_dir, "--ambi_order", "2", "--frame_hw",
                                   *map(str, FRAME_HW))
    if launches[:2] != (TRAIN_STEPS, TRAIN_STEPS):
        raise AssertionError(f"order 2: K1/K2 launched {launches[:2]} times in "
                             f"{TRAIN_STEPS} steps")

    clip = db / "clip0"
    audio = np.load(clip / "packed" / "ambix.npy")
    engine = MonoToAmbix(str(model_dir), batch_size=DEPLOY_BATCH, device=DEVICE)
    k.launch_count = k.bwd_launch_count = 0
    ambi = engine.deploy(str(clip), deploy_start=DEPLOY_START, deploy_duration=1.0)
    deploy_launches = (k.launch_count, k.bwd_launch_count)
    s0 = int(DEPLOY_START * RATE)
    passthrough = audio[s0: s0 + RATE, :4].astype(np.float32) / 32768.0
    log(f"order 2 deploy (card, batch {DEPLOY_BATCH}): shape {ambi.shape}, K1/K2 launches "
        f"{deploy_launches[0]}/{deploy_launches[1]}")
    if ambi.shape != (RATE, 9) or not np.isfinite(ambi).all():
        raise AssertionError(f"order 2 deploy: shape {ambi.shape}")
    if not np.array_equal(ambi[:, :4], passthrough):
        raise AssertionError("order 2 deploy: W, Y, Z, X are not the input bit for bit")
    if deploy_launches[0] < 1 or deploy_launches[1]:
        raise AssertionError(f"order 2 deploy: K1/K2 launched {deploy_launches}")

    exact = {}
    for dev, mdir in ((DEVICE, model_dir_at(model_dir, "highest")), ("cpu", model_dir)):
        eng = MonoToAmbix(str(mdir), batch_size=DEPLOY_BATCH, device=dev, f16_fetch=False)
        exact[dev] = eng.deploy(str(clip), deploy_start=DEPLOY_START,
                                deploy_duration=CPU_SECONDS)
    err = rel_l2(exact[DEVICE][:, 4:], exact["cpu"][:, 4:])
    log(f"order 2 deploy card (pallas_precision=highest) vs CPU over {CPU_SECONDS} s: "
        f"relative L2 {err:.3e} (limit 1e-4)")
    if not (np.array_equal(exact[DEVICE][:, :4], exact["cpu"][:, :4]) and err <= 1e-4):
        raise AssertionError(f"order 2 deploy: card and CPU disagree ({err:.3e})")

    ev = Evaluator(str(model_dir), db_dir=str(db), batch_size=EVAL_BATCH, n_workers=1,
                   device_metrics=True, emd_mode="sinkhorn", device=DEVICE)
    k.launch_count = 0
    summary, rows = ev.run(output_fn=str(SCRATCH / "order2_eval.txt"), host_threads=4,
                           print_every=0)
    eval_launches = k.launch_count
    log(f"order 2 eval: {len(rows)} samples, K1 launches {eval_launches}, stft/avg "
        f"{summary['stft/avg']:.4f}, emd/dir {summary['emd/dir']:.4f}")
    if not rows or not all(np.isfinite(v) for v in summary.values()) or \
            eval_launches != -(-len(rows) // EVAL_BATCH):
        raise AssertionError(f"order 2 eval: {len(rows)} rows, K1 launched {eval_launches}")

    cfg = TrainConfig(encoders=("audio", "video"), frame_hw=FRAME_HW, seed=SEED, ambi_order=2)
    g = cfg.model_config().geometry
    state = create_train_state(cfg, DEVICE)
    data = synthetic_batch(torch.Generator(device=DEVICE).manual_seed(SEED + 16),
                           ORDER2_BATCH, g, FRAME_HW, DEVICE)
    audio_in = data["ambix"][:, :, :g.num_in_channels].contiguous()
    video = data["video"].float() / 255.0 - 0.5
    model = state.model.eval()
    with torch.no_grad():
        fwd_ms = time_ms(lambda: model(audio_in, video), warmup=2, iters=10)
    model.train()
    step_ms = time_ms(lambda: train_step(state, data, 1e-4, cfg.weight_decay), warmup=2,
                      iters=5)
    log(f"order 2 flagship (n_in 4, 5 channels predicted), batch {ORDER2_BATCH} f32: forward "
        f"{fwd_ms:.2f} ms -> {ORDER2_BATCH * g.snd_dur / RATE / (fwd_ms / 1e3):.1f}x realtime; "
        f"train step {step_ms:.2f} ms -> {ORDER2_BATCH / (step_ms / 1e3):.1f} samples/s [{card}]")
    del state, data, model
    torch.cuda.empty_cache()
    return {"launches": {"train": launches[0], "deploy": deploy_launches[0],
                         "eval": eval_launches},
            "bwd_launches": {"train": launches[1]}}


# ---------------------------------------------------------------------------
# 17. flow: Horn-Schunck on the card, and the default model over its maps
# ---------------------------------------------------------------------------

FLOW_FRAMES = 33            # 32 pairs: two pair-batches of 16
FLOW_PAIR_BATCH = 16
FLOW_ZOOM, FLOW_PAN = 1.004, (1.5, -0.8)   # per frame, about the frame's centre
FLOW_BLOB_FROM = 16         # frames 16.. carry a blob moving FLOW_BLOB_STEP px in x
FLOW_BLOB_STEP = 3.0
FLOW_PURE_PAIRS = 15        # pairs 0-14: zoom + pan only (pair 15 sees the blob appear)
FLOW_MARGIN = 12            # px left out at the frame's edges, as the CPU tests do
FLOW_EPE_LIMIT = 0.15       # px: the bound tests/test_flow_quality.py holds JAX to
# px, max abs, card against the port's CPU run: on the CPU the float32 solve
# of these frames is 1.4e-4 px (fb_occlusion off) and 6.1e-5 px (on) from a
# float64 run at most (tools/flow_cpu_reference.py), so two float32 devices
# should part by about as much
FLOW_CARD_CPU_ATOL = 1e-3
FLOW_RUNS = 3               # warm timed runs per mode
FLOW_DEPLOY_SECONDS = 2.0


def natural_texture(h: int, w: int, rng) -> np.ndarray:
    """1/f-like texture in [0, 1] (tests/test_flow_quality.py's recipe)."""
    from scipy.ndimage import gaussian_filter

    img = np.zeros((h, w))
    for sigma, amp in ((1.0, 0.25), (3.0, 0.5), (9.0, 1.0)):
        img += amp * gaussian_filter(rng.randn(h, w), sigma)
    img -= img.min()
    return img / img.max()


def flow_frames() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """FLOW_FRAMES uint8 gray-as-RGB frames at FRAME_HW, from SEED with numpy
    and scipy: a natural texture under a zoom + pan (frame k+1 is frame k
    through one affine map A, rendered from a texture wider than the frame
    so that no edge is smeared in), and from frame FLOW_BLOB_FROM on a
    textured blob moving FLOW_BLOB_STEP px in x over it. Returns (frames,
    the background's true flow (H, W, 2), which every pair shares, the
    blob's mask per frame (T, H, W))."""
    from scipy.ndimage import gaussian_filter, map_coordinates

    rng = np.random.RandomState(SEED + 17)
    h, w = FRAME_HW
    pad = 64
    big = natural_texture(h + 2 * pad, w + 2 * pad, rng)
    fg = gaussian_filter(rng.rand(h, w), 1.5)
    fg = (fg - fg.min()) / (fg.max() - fg.min())
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    tx, ty = FLOW_PAN
    frames = np.empty((FLOW_FRAMES, h, w, 3), np.uint8)
    masks = np.zeros((FLOW_FRAMES, h, w))
    for k in range(FLOW_FRAMES):
        # A^k(q) = c + s^k (q - c) + t (1 + s + ... + s^(k-1))
        zoom = FLOW_ZOOM ** k
        drift = sum(FLOW_ZOOM ** i for i in range(k))
        img = map_coordinates(big, [pad + cy + zoom * (ys - cy) + ty * drift,
                                    pad + cx + zoom * (xs - cx) + tx * drift],
                              order=3, mode="nearest")
        if k >= FLOW_BLOB_FROM:
            shift = FLOW_BLOB_STEP * (k - FLOW_BLOB_FROM)
            masks[k] = np.exp(-(((xs - w / 3 - shift) ** 2 + (ys - cy) ** 2) / 300.0))
            moved = map_coordinates(fg, [ys, xs - shift], order=3, mode="nearest")
            img = img * (1 - masks[k]) + moved * masks[k]
        frames[k] = np.clip(img * 255, 0, 255).astype(np.uint8)[..., None]
    # flow(p) = A^{-1}(p) - p, so that frame_k(p) ~ frame_k+1(p + flow(p))
    gt = np.stack([(xs - tx - cx) / FLOW_ZOOM + cx - xs,
                   (ys - ty - cy) / FLOW_ZOOM + cy - ys], axis=-1)
    return frames, gt.astype(np.float32), masks


def flow_quality(flow: np.ndarray, gt: np.ndarray, masks: np.ndarray) -> dict:
    """Mean end-point error over the zoom + pan pairs' interior, and the
    blob pairs' mean x-flow on the blob (true FLOW_BLOB_STEP) and off it."""
    m = FLOW_MARGIN
    d = flow[:FLOW_PURE_PAIRS, m:-m, m:-m] - gt[None, m:-m, m:-m]
    blob = range(FLOW_BLOB_FROM, FLOW_FRAMES - 1)
    on = np.concatenate([flow[k, ..., 0][masks[k] > 0.5] for k in blob])
    off = np.concatenate([flow[k, m:-m, m:-m, 0][masks[k][m:-m, m:-m] < 0.05] for k in blob])
    return {"epe": float(np.sqrt((d ** 2).sum(-1)).mean()), "blob_u": float(on.mean()),
            "background_u": float(off.mean()),
            "background_true_u": float(gt[m:-m, m:-m, 0].mean())}


def flow_phase(card: str) -> dict:
    """The port's flow ETL on the card (ops/flow.py, plain PyTorch: the JAX
    module has no Pallas kernel), then the reference's default model over
    the card-made flow maps.

    horn_schunck_flow at the ETL's own frame size (224x448) and the JAX
    defaults (alpha 0.05, 3 warps, 60 Jacobi steps at the coarsest of 4
    levels, pair_batch 16) over FLOW_FRAMES frames (flow_frames), with
    fb_occlusion off and on: the card's flow within FLOW_CARD_CPU_ATOL px
    (max abs) of the port's own CPU run of the same frames, the mean
    end-point error of the zoom + pan pairs under FLOW_EPE_LIMIT px, the
    blob's and background's mean x-flow printed beside their truth; pairs
    per second as the median of FLOW_RUNS warm runs (host gray conversion
    and copies included), and one pair-batch's CUDA launches and busy /
    wall share from a profile. Then the card's flow (fb_occlusion off) is
    encoded with etl.preprocess.flow_frame_rgb into a packed clip's
    flow.npy + flow_lims.npy, and MonoToAmbix deploys the default model
    (audio + flow + video, random weights from SEED) over
    FLOW_DEPLOY_SECONDS of it: finite, W passed through bit for bit, K1
    launched. The mux and the ETL's ffmpeg and jpg steps do not run here:
    the card's host has neither ffmpeg nor Pillow (the CPU tests drive
    them through a stub ffmpeg and dry runs). Returns K1's launches in
    that deploy."""
    from spatialaudiogen_tpu_torch.deploy.deploy import MonoToAmbix
    from spatialaudiogen_tpu_torch.etl.preprocess import flow_frame_rgb
    from spatialaudiogen_tpu_torch.ops import masked_istft as k
    from spatialaudiogen_tpu_torch.ops.flow import flow_pairs, horn_schunck_flow

    frames, gt, masks = flow_frames()
    n_pairs = FLOW_FRAMES - 1
    card_flow = {}
    for fb in (False, True):
        what = f"flow fb_occlusion={'on' if fb else 'off'}"
        flow = horn_schunck_flow(frames, pair_batch=FLOW_PAIR_BATCH, fb_occlusion=fb,
                                 device=DEVICE)
        seconds = []
        for _ in range(FLOW_RUNS):
            t0 = time.perf_counter()
            again = horn_schunck_flow(frames, pair_batch=FLOW_PAIR_BATCH, fb_occlusion=fb,
                                      device=DEVICE)
            seconds.append(time.perf_counter() - t0)
        wall = float(np.median(seconds))
        q = flow_quality(flow, gt, masks)
        log(f"{what} ({FRAME_HW[0]}x{FRAME_HW[1]}, pair_batch {FLOW_PAIR_BATCH}, {n_pairs} "
            f"pairs): median of {FLOW_RUNS} warm runs {wall:.3f} s -> {n_pairs / wall:.1f} pairs/s "
            f"(runs {', '.join(f'{x:.3f}' for x in seconds)}; the runs bitwise equal: "
            f"{np.array_equal(flow, again)}) [{card}]")
        log(f"{what}: zoom + pan EPE {q['epe']:.4f} px over pairs 0-{FLOW_PURE_PAIRS - 1} "
            f"(limit {FLOW_EPE_LIMIT}); blob pairs: blob mean u {q['blob_u']:.3f} px (true "
            f"{FLOW_BLOB_STEP}), background {q['background_u']:.3f} (true "
            f"{q['background_true_u']:.3f})")
        if not (flow.shape == (FLOW_FRAMES,) + FRAME_HW + (2,) and np.isfinite(flow).all()):
            raise AssertionError(f"{what}: shape {flow.shape} or non-finite values")
        if not q["epe"] < FLOW_EPE_LIMIT:
            raise AssertionError(f"{what}: EPE {q['epe']:.4f} px")

        t0 = time.perf_counter()
        cpu = horn_schunck_flow(frames, pair_batch=FLOW_PAIR_BATCH, fb_occlusion=fb,
                                device="cpu")
        cpu_s = time.perf_counter() - t0
        err = float(np.abs(cpu - flow).max())
        log(f"{what}: card vs the port's CPU run of the same frames ({cpu_s:.1f} s on "
            f"{torch.get_num_threads()} threads): max |diff| {err:.3e} px (limit "
            f"{FLOW_CARD_CPU_ATOL})")
        if not err <= FLOW_CARD_CPU_ATOL:
            raise AssertionError(f"{what}: card and CPU {err:.3e} px apart")

        gray = (frames[:FLOW_PAIR_BATCH + 1].astype(np.float32)
                @ np.array([0.299, 0.587, 0.114], np.float32)) / 255.0
        i1 = torch.from_numpy(gray[:-1]).to(DEVICE)
        i2 = torch.from_numpy(gray[1:]).to(DEVICE)
        with torch.inference_mode():
            ms = time_ms(lambda: flow_pairs(i1, i2, fb_occlusion=fb), warmup=1, iters=3)
            prof = profile_step(lambda: flow_pairs(i1, i2, fb_occlusion=fb), card,
                                f"{what} one pair-batch")
        log(f"{what}: one pair-batch of {FLOW_PAIR_BATCH} on the card {ms:.2f} ms (CUDA "
            f"events, tensors already there), "
            + (f"{prof[0]} CUDA launches, busy {100 * prof[1] / prof[2]:.0f}% of the "
               f"profiled wall" if prof else "launches not measured") + f" [{card}]")
        card_flow[fb] = flow
        del i1, i2
        torch.cuda.empty_cache()

    clip, model_dir = SCRATCH / "flow_clip", SCRATCH / "flow_model"
    seconds = (FLOW_FRAMES - 1) // 10
    audio = write_clip(clip, seconds=seconds)
    n = seconds * 10
    encoded = [flow_frame_rgb(f) for f in card_flow[False][:n]]
    np.save(clip / "packed" / "video.npy", frames[:n])
    np.save(clip / "packed" / "flow.npy", np.stack([rgb for rgb, _ in encoded]))
    np.save(clip / "packed" / "flow_lims.npy",
            np.array([lims for _, lims in encoded], np.float32))
    write_model_dir(model_dir, DEFAULT_ENCODERS)
    engine = MonoToAmbix(str(model_dir), batch_size=DEFAULT_DEPLOY_BATCH, device=DEVICE)
    k.launch_count = k.bwd_launch_count = k.nhwc_launch_count = 0
    ambi = engine.deploy(str(clip), deploy_start=DEPLOY_START,
                         deploy_duration=FLOW_DEPLOY_SECONDS)
    launched = (k.launch_count, k.bwd_launch_count, k.nhwc_launch_count)
    s0, n_out = int(DEPLOY_START * RATE), int(round(FLOW_DEPLOY_SECONDS * RATE))
    w_in = audio[s0: s0 + n_out, 0].astype(np.float32) / 32768.0
    log(f"default model (audio flow video) deploy over the card-made flow maps "
        f"({FLOW_DEPLOY_SECONDS} s at batch {DEFAULT_DEPLOY_BATCH}): shape {ambi.shape}, "
        f"K1/K2/K3 launches {launched[0]}/{launched[1]}/{launched[2]}")
    if ambi.shape != (n_out, 4) or not np.isfinite(ambi).all():
        raise AssertionError(f"deploy over the card's flow: shape {ambi.shape}")
    if not np.array_equal(ambi[:, 0], w_in):
        raise AssertionError("deploy over the card's flow: W is not the input bit for bit")
    if launched[0] < 1 or launched[1:] != (0, 0):
        raise AssertionError(f"deploy over the card's flow launched K1/K2/K3 {launched}")
    del engine
    torch.cuda.empty_cache()
    return {"launches": launched[0]}


def phase(fn, *args, **kwargs):
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    log(f"[{fn.__name__}: {time.perf_counter() - t0:.1f} s]")
    return out


def multi_card_main() -> int:
    """--multi_card: phase 14's parallel runs with a card per rank, so the
    mesh's groups run on NCCL (MD_CARD_RUNS: data parallel and tensor
    parallel on two cards, the 2x2 grid on four), each held to one process
    as phase 14 holds its runs; then phase 15's sharded deploy, eval (of
    the random-weight flagship: no phase 7 here) and serve, two ranks on
    two cards. Needs at least two cards."""
    t_start = time.perf_counter()
    card = preconditions()
    cards = torch.cuda.device_count()
    if cards < 2:
        raise SystemExit(f"chip_smoke --multi_card: needs two cards or more, found {cards}")
    shutil.rmtree(SCRATCH, ignore_errors=True)
    SCRATCH.mkdir()
    try:
        phase(build_kernels)
        phase(write_train_db, SCRATCH / "train_db")
        multi = phase(md_parallel_runs, card,
                      [run for run in MD_CARD_RUNS if run[1] * run[2] <= cards])
        write_model_dir(SCRATCH / "model")
        write_clip(SCRATCH / "clip")
        sharded = phase(sharded_inference_runs, card, eval_model=SCRATCH / "model")
    finally:
        shutil.rmtree(SCRATCH, ignore_errors=True)
    log(f"chip_smoke --multi_card: {time.perf_counter() - t_start:.1f} s in all, the build "
        f"included")
    log(f"card: {card}")
    log(json.dumps({"multi_device_launches": multi, "sharded_launches": sharded}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": cards}}))
    return 0


def main() -> int:
    t_start = time.perf_counter()
    card = preconditions()
    shutil.rmtree(SCRATCH, ignore_errors=True)
    SCRATCH.mkdir()
    try:
        phase(build_kernels)
        k1_times = phase(kernel_phase, card)
        k2_times = phase(bwd_kernel_phase, card)
        k3_times = phase(nhwc_kernel_phase, card)
        phase(slice_phase, card)
        phase(forward_numbers, card)
        k3 = phase(nhwc_path_phase, card)
        train = phase(train_phase, card)
        phase(bf16_train_phase, card)
        default = phase(default_model_phase, card)
        phase(train_card_vs_cpu, card, pallas_precision="highest")
        phase(train_card_vs_cpu, card, pallas_nhwc=True, pallas_precision="highest")
        phase(train_numbers, card)
        evaluation = phase(eval_phase, card)
        serving = phase(serve_phase, card)
        multi = phase(multi_device_phase, card)
        sharded = phase(sharded_inference_runs, card)
        order2 = phase(order2_phase, card)
        flow = phase(flow_phase, card)
    finally:
        shutil.rmtree(SCRATCH, ignore_errors=True)
    # The top-level numbers are the "default" (bf16) route's, the one the
    # main paths launch, at the flagship f32-mask case; the 3xTF32 route's
    # are under "highest". K3 also carries k1_ms, K1 on its mask made
    # track-major, copy included.
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "gemm_ms")
    kernels = []
    for name, source, replaces, times, launches, extra in (
            ("masked_istft", "masked_istft.cu", K1_REPLACES, k1_times,
             {"launches": train["launches"],
              "default_model_launches": default["launches"],
              "eval_launches": evaluation["launches"],
              "serve_launches": serving["serve_launches"],
              "serve_batcher_launches": serving["batcher_launches"],
              "serve_batch1": serving["batch1"],
              "multi_device_launches": {what: [r[0] for r in ranks] if what != "tb"
                                        else ranks[0] for what, ranks in multi.items()},
              "sharded_launches": sharded,
              "order2_launches": order2["launches"],
              "flow_deploy_launches": flow["launches"]}, ()),
            ("masked_istft_bwd", "masked_istft_bwd.cu", K2_REPLACES, k2_times,
             {"launches": train["bwd_launches"],
              "default_model_launches": default["bwd_launches"],
              "multi_device_launches": {what: [r[1] for r in ranks] if what != "tb"
                                        else ranks[1] for what, ranks in multi.items()},
              "order2_launches": order2["bwd_launches"]}, ()),
            ("masked_istft_nhwc", "masked_istft_nhwc.cu", K3_REPLACES, k3_times, k3,
             ("k1_ms",))):
        main, highest = times["flagship f32", "default"], times["flagship f32", "highest"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"spatialaudiogen_tpu_torch/ops/csrc/{source}",
            "replaces": replaces, **launches, "precision": "default",
            **{key: main[key] for key in keys + extra},
            # no single library call computes the fused function (the
            # plain version is cuBLAS matmuls plus elementwise ops)
            "library_ms": None,
            "highest": {key: highest[key] for key in keys + extra},
            # every shape the kernel was held to its plain version at, with
            # its times on the bf16 route ("default")
            "shapes": {case: {key: entry[key] for key in ("shape",) + keys + extra}
                       for (case, precision), entry in times.items()
                       if precision == "default"}})
    imported = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "spatialaudiogen_tpu"))
    if imported:
        raise AssertionError(f"the port imported {imported[:5]}")
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all, the build included")
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(multi_card_main() if sys.argv[1:] == ["--multi_card"] else main())
