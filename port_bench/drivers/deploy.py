"""Batch deploy driver: repeated `MonoToAmbix.deploy()` calls over one
packed clip written from the seed, measured in seconds of audio produced
per wall second.

Set-up writes the clip and a model dir (train-params.json and params.npz
of the seeded weights), builds the engine at the cell's batch size and
f16 fetch, counts the reference forward's operations, and makes one
deploy call (every shape of the window's calls). The window then runs
whole calls and closes at the end of the first call that ends past
`--seconds`: every call in it has finished, and the rate is the audio of
all of them over the window's wall time. The benchmark wraps
`fwd_span` (a span) and keeps, of every call, the output rows of a few
windows drawn from the seed.

Correctness, once the window has closed and the engine is freed: the
reference cuts every window of the clip from the pack itself, batches
them as the engine does (pad lanes zeroed: the visual BatchNorm runs on
batch statistics, so lanes see each other), runs its forward and rounds
the predictions to float16 as the configuration's fetch does. Compared:
the W passthrough of the last call (`passthrough_gap`, exact), its Y/Z/X
(`pred_gap`, relative L2), and the sampled windows of every call
(`calls_gap`, the worst relative L2 of a window).
"""

from __future__ import annotations

import gc

import numpy as np

from port_bench.drivers.train import free_weights, model_shape, precision
from port_bench.harness.core import Result
from port_bench.harness.packs import write_db
from port_bench.harness.weights import make_weights
from port_bench.reference.model import ModelShape, Precision, forward
from port_bench.reference.windows import Pack
from port_bench.reference.work import count_flops, istft_work, least_seconds

SAMPLED = 8          # windows of each call kept for the check


def write_model_dir(model_dir, cfg: dict, weights: dict) -> None:
    import torch

    from spatialaudiogen_tpu_torch.models.convert import save_params

    from port_bench.drivers.train import train_config

    tc = train_config(cfg, {"batch_size": 1, "log_every": 20, "n_workers": 1}, "",
                      str(model_dir), 0)
    tc.save()
    save_params(str(model_dir), {k: v.detach().to("cpu", torch.float32) for k, v in
                                 weights.items()})


def window_times(folder: str) -> list:
    """The engine's window times over a whole clip from 0: the chunk
    index's times shifted so the first is 0 (deploy.py:106-107)."""
    with open(f"{folder}/audio_pow.lst") as f:
        ts = [float(line.split()[0]) for line in f if line.strip()]
    return [t - (ts[0] - 0.0) for t in ts]


def reference_deploy(m: ModelShape, p: Precision, weights: dict, folder: str, batch: int,
                     device, f16: bool) -> tuple[np.ndarray, np.ndarray]:
    """(W passthrough (N,), predictions (N, 3)) of the whole clip."""
    import torch

    g = m.geometry
    pack = Pack(folder)
    ts = window_times(folder)
    monos, preds = [], []
    n_frames = pack.meta["video_frames"]
    for k in range(0, len(ts), batch):
        chunk = ts[k: k + batch]
        n = len(chunk)
        audio = np.zeros((batch, g.snd_size, 4), np.float32)
        video = np.zeros((batch, g.vid_dur, *m.frame_hw, 3), np.float32)
        for i, t in enumerate(chunk):
            audio[i] = pack.audio_window(t, g)
            frame = min(max(int(t * g.video_rate), 0), n_frames - 1)
            video[i] = np.asarray(pack.video[frame: frame + g.vid_dur], np.float32) / 255.0 - 0.5
        monos.append(audio[:n, g.target_ss: g.target_ss + g.snd_dur, 0].reshape(-1))
        data = {"ambix": torch.from_numpy(audio).to(device),
                "video": torch.from_numpy(video).to(device)}
        with torch.no_grad():
            out = forward(weights, data, m, p)[:n]
        if f16:
            out = out.half()
        preds.append(out.float().cpu().numpy().reshape(-1, 3))
    return np.concatenate(monos), np.concatenate(preds)


def rel_l2(a: np.ndarray, b: np.ndarray) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def run_program(ctx, m: ModelShape, weights: dict, folder: str) -> dict:
    import torch

    from spatialaudiogen_tpu_torch.deploy.deploy import MonoToAmbix

    params = ctx.params
    model_dir = ctx.workdir / "model"
    write_model_dir(model_dir, ctx.config, weights)
    engine = MonoToAmbix(str(model_dir), batch_size=params["batch_size"], device=ctx.device,
                         f16_fetch=params["f16_fetch"])
    real_fwd = engine.fwd_span

    def fwd_span(*args, **kwargs):
        with ctx.spans("forward"):
            return real_fwd(*args, **kwargs)

    engine.fwd_span = fwd_span
    g = m.geometry
    first = engine.deploy(folder, 0.0, None)             # warm-up: the window's shapes
    n_windows = first.shape[0] // g.snd_dur
    rng = np.random.default_rng(ctx.seed)
    ctx.open_window()
    calls, samples, out = 0, [], first
    while True:
        with ctx.spans("deploy_call"):
            out = engine.deploy(folder, 0.0, None)
        calls += 1
        pick = rng.choice(n_windows, SAMPLED, replace=False)
        samples.append((pick, out.reshape(n_windows, g.snd_dur, -1)[pick].copy()))
        if ctx.window_elapsed() >= ctx.seconds:
            break
    ctx.close_window()
    peak = torch.cuda.max_memory_allocated() if ctx.device.startswith("cuda") else None
    del engine
    gc.collect()
    if ctx.device.startswith("cuda"):
        torch.cuda.empty_cache()
    return {"calls": calls, "audio_s": calls * n_windows * g.snd_dur / g.audio_rate,
            "last": out, "samples": samples, "memory_peak_bytes": peak,
            "n_windows": n_windows}


def compare(prog: dict, ref_mono: np.ndarray, ref_pred: np.ndarray, g) -> dict:
    last = prog["last"]
    per_window = ref_pred.reshape(prog["n_windows"], g.snd_dur, -1)
    calls_gap = max(rel_l2(rows[..., 1:], per_window[pick]) for pick, rows in prog["samples"])
    return {"passthrough_gap": float(np.abs(last[:, 0] - ref_mono).max()),
            "pred_gap": rel_l2(last[:, 1:], ref_pred),
            "calls_gap": calls_gap}


def sound_pass(ctx) -> dict:
    """Set-up, the program through the window, and the reference over the
    same clip: the pass that run() reports and that readings() adds the
    control to."""
    params, cfg = ctx.params, ctx.config
    m = model_shape(cfg)
    folder = str(write_db(ctx.workdir / "db", ctx.seed, 1, params["clip_seconds"],
                          m.frame_hw, False)[0])
    weights = make_weights(m, ctx.seed, ctx.device)
    p = precision(cfg)
    flops = count_flops(m, p, params["batch_size"], backward=False)
    prog = run_program(ctx, m, weights, folder)
    ref = reference_deploy(m, p, weights, folder, params["batch_size"], ctx.device,
                           params["f16_fetch"])
    return {"m": m, "folder": folder, "weights": weights, "flops": flops, "prog": prog,
            "ref": ref, "numbers": compare(prog, *ref, m.geometry)}


def readings(ctx, faults: bool) -> dict:
    """The compared numbers of one sound pass; with `faults`, the
    control's: the reference one precision step below, in the program's
    place, over the same clip."""
    params = ctx.params
    sp = sound_pass(ctx)
    m, prog = sp["m"], sp["prog"]
    out = {"sound": sp["numbers"]}
    if faults:
        mono, pred = reference_deploy(m, precision(ctx.config, "lower"), sp["weights"],
                                      sp["folder"], params["batch_size"], ctx.device,
                                      params["f16_fetch"])
        last = np.concatenate([mono[:, None], pred], 1)
        windows = last.reshape(prog["n_windows"], m.geometry.snd_dur, -1)
        control = {**prog, "last": last,
                   "samples": [(pick, windows[pick]) for pick, _ in prog["samples"]]}
        out["control"] = compare(control, *sp["ref"], m.geometry)
    free_weights(ctx, sp)
    return out


def run(ctx) -> Result:
    params, cfg = ctx.params, ctx.config
    sp = sound_pass(ctx)
    m, prog, numbers = sp["m"], sp["prog"], sp["numbers"]
    limits = ctx.workload["limits"]
    checks = [(k, numbers[k], limits[k]) for k in limits if k in numbers]
    g = m.geometry
    k_flops, k_bytes = istft_work(params["batch_size"], 1, m.tracks, g.n_mask, g.wind,
                                  cfg["pallas_precision"],
                                  2 if cfg["compute_dtype"] == "bfloat16" else 4)
    # MFU charges the real windows only: the last batch of a call is
    # padded to the batch size, and its pad lanes are no useful work
    info = {"calls": prog["calls"], "windows": prog["calls"] * prog["n_windows"],
            "least_window_s": least_seconds(sp["flops"]) / params["batch_size"],
            "istft_flops": k_flops, "istft_bytes": k_bytes, "route": cfg["pallas_precision"],
            "memory_peak_bytes": prog["memory_peak_bytes"], "numbers": numbers}
    free_weights(ctx, sp)
    return Result(metrics={"deploy_rtf": prog["audio_s"] / ctx.window_s},
                  attempted=prog["calls"], failed=0, checks=checks, info=info)
