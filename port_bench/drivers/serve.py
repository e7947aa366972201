"""Open-loop serving driver: `StreamBatcher` (push + tick) with one live
session in every lane, each session's 0.1 s chunk and 10 fps frame due
every 100 ms whatever the batcher is doing; the tail of the ticks' latency
from the moment their chunk was due.

Signals and frames come from the seed: a pool of chunks (tone in noise)
and a pool of uint8 frames, session s taking chunk (s * 7919 + j * 104729)
mod the pool at step j and frame (s * 31 + j) mod its pool, so every lane
and every step differ. Set-up fills each session's first 1.1 s of context
and ticks until every session has emitted (`warm_steps` steps). In the
window, step j is due at T0 + j * 0.1 s: the loop sleeps until then if it
is early, pushes every step now due to every session, and calls `tick()`.
A round emits window k of the sessions, which the push of step k + 10
completed; its latency is from that step's due time until `tick()`
returns. The window closes after the first tick that returns past
`--seconds`; session-chunks due by then and not emitted are failed.

Correctness, once the window has closed and the batcher is freed: for
rounds drawn from the seed among the window's (and the last), the
reference rebuilds every lane's window from the pools (rolling context),
its frame, and zeroes the lanes that did not emit, runs its forward over
the batch (the visual BatchNorm couples the lanes) and rounds to float16
as the fetch does. Compared: the W passthrough (`passthrough_gap`, exact)
and the predictions (`pred_gap`, the worst relative L2 of a round).
"""

from __future__ import annotations

import gc
import time

import numpy as np

from port_bench.drivers.deploy import rel_l2, write_model_dir
from port_bench.drivers.train import free_weights, model_shape, precision
from port_bench.harness.core import Result
from port_bench.harness.weights import make_weights
from port_bench.reference.model import ModelShape, Precision, forward
from port_bench.reference.work import count_flops, istft_work, least_seconds

STEP_S = 0.1
CONTEXT_STEPS = 10          # window k is complete once step k + 10 is pushed
CHECKED_ROUNDS = 3


class Traffic:
    """The sessions' chunks and frames, from the seed."""

    def __init__(self, seed: int, chunk: int, frame_hw, n_chunks: int, n_frames: int):
        rng = np.random.default_rng(int(seed))
        t = np.arange(chunk) / 48000.0
        tones = np.sin(2 * np.pi * rng.uniform(200, 800, (n_chunks, 1)) * t)
        self.chunks = (0.3 * tones + 0.3 * rng.standard_normal((n_chunks, chunk))
                       ).astype(np.float32)
        self.frames = rng.integers(0, 256, (n_frames, *frame_hw, 3), dtype=np.uint8)

    def chunk(self, s: int, j: int) -> np.ndarray:
        return self.chunks[(s * 7919 + j * 104729) % len(self.chunks)]

    def frame(self, s: int, j: int) -> np.ndarray:
        return self.frames[(s * 31 + j) % len(self.frames)]


def open_loop(batcher, sids: list, traffic: Traffic, first_step: int, seconds: float,
              clock=time.perf_counter, sleep=time.sleep, spans=None) -> dict:
    """Drive the batcher open loop from step `first_step` for `seconds`:
    -> {"latency": [s per round], "rounds": [(window k, {sid: chunk})],
    "due": session-chunks due, "emitted": session-chunks emitted,
    "late_s": how far behind its schedule the loop pushed, at most}."""
    t0 = clock()
    pushed = first_step          # next step to push
    latency, rounds = [], []
    emitted, late = 0, 0.0
    while True:
        now = clock()
        due_steps = first_step + int((now - t0) / STEP_S + 1e-9) + 1   # steps due by now
        if pushed >= due_steps:
            wait = max(0.0, t0 + (pushed - first_step) * STEP_S - now)
            if spans is not None:
                with spans("pace_wait"):
                    sleep(wait)
            else:
                sleep(wait)
            continue
        late = max(late, now - (t0 + (pushed - first_step) * STEP_S))
        while pushed < due_steps:
            for s in sids:
                batcher.push(s, traffic.chunk(s, pushed), traffic.frame(s, pushed))
            pushed += 1
        if spans is not None:
            with spans("tick"):
                out = batcher.tick()
        else:
            out = batcher.tick()
        t_ret = clock()
        by_k: dict = {}
        for sid, chunks in out.items():
            k0 = batcher._sessions[sid].next_window - len(chunks)
            for i, c in enumerate(chunks):
                by_k.setdefault(k0 + i, {})[sid] = c
        for k in sorted(by_k):
            due = t0 + (k + CONTEXT_STEPS - first_step) * STEP_S
            latency.append(t_ret - due)
            rounds.append((k, by_k[k]))
            emitted += len(by_k[k])
        if t_ret - t0 >= seconds:
            break
    n_due = int((t_ret - t0) / STEP_S + 1e-9) + 1
    return {"latency": latency, "rounds": rounds, "due": n_due * len(sids),
            "emitted": emitted, "late_s": late, "elapsed": t_ret - t0}


def percentile(values: list, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation, over all values."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def reference_round(m: ModelShape, p: Precision, weights: dict, traffic: Traffic,
                    k: int, lanes: dict, emitting: set, capacity: int, device, f16: bool):
    """(W passthrough, predictions) of window k for every lane: lane ->
    sid; lanes whose sid is not in `emitting` are zero in the batch."""
    import torch

    g = m.geometry
    audio = np.zeros((capacity, g.snd_size, 4), np.float32)
    video = np.zeros((capacity, g.vid_dur, *m.frame_hw, 3), np.float32)
    frame_i = int((0.5 + k * g.snd_dur / g.audio_rate) * g.video_rate)
    for lane, sid in lanes.items():
        if sid not in emitting:
            continue
        window = np.concatenate([traffic.chunk(sid, j) for j in
                                 range(k, k + CONTEXT_STEPS + 1)])[: g.snd_size]
        audio[lane, :, 0] = window
        video[lane, 0] = traffic.frame(sid, frame_i).astype(np.float32) / 255.0 - 0.5
    data = {"ambix": torch.from_numpy(audio).to(device),
            "video": torch.from_numpy(video).to(device)}
    with torch.no_grad():
        out = forward(weights, data, m, p)
    if f16:
        out = out.half()
    return (audio[:, g.target_ss: g.target_ss + g.snd_dur, 0],
            out.float().cpu().numpy())


def build(ctx, m: ModelShape, weights: dict, capacity: int):
    from spatialaudiogen_tpu_torch.deploy.stream import StreamBatcher

    model_dir = ctx.workdir / f"model{capacity}"
    write_model_dir(model_dir, ctx.config, weights)
    return StreamBatcher(str(model_dir), capacity=capacity, f16_fetch=ctx.params["f16_fetch"],
                         device=ctx.device)


def warm(batcher, sids, traffic: Traffic, steps: int) -> int:
    """Fill the first 1.1 s of context and tick through `steps` steps;
    -> the next step to push."""
    for j in range(steps):
        for s in sids:
            batcher.push(s, traffic.chunk(s, j), traffic.frame(s, j))
        batcher.tick()
    return steps


def serve_program(ctx, m: ModelShape, weights: dict, traffic: Traffic) -> dict:
    """Build the batcher, fill and warm every session, run the window."""
    import torch

    params = ctx.params
    batcher = build(ctx, m, weights, params["capacity"])
    real_tick_fn = batcher._tick_fn

    def tick_fn(*args, **kwargs):
        with ctx.spans("tick_fn"):
            return real_tick_fn(*args, **kwargs)

    batcher._tick_fn = tick_fn
    sids = [batcher.add_session() for _ in range(params["sessions"])]
    lanes = {batcher._lane_of[s]: s for s in sids}
    first = warm(batcher, sids, traffic, params["warm_steps"])
    ctx.open_window()
    out = open_loop(batcher, sids, traffic, first, ctx.seconds, spans=ctx.spans)
    ctx.close_window()
    out["lanes"] = lanes
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                if ctx.device.startswith("cuda") else None)
    del batcher
    gc.collect()
    if ctx.device.startswith("cuda"):
        torch.cuda.empty_cache()
    return out


def checked_rounds(run_: dict, seed: int) -> list:
    """Rounds drawn from the seed, and the last."""
    n = len(run_["rounds"])
    rng = np.random.default_rng(seed)
    return sorted(set(rng.choice(n, min(CHECKED_ROUNDS, n), replace=False).tolist())
                  | {n - 1})


def compare_rounds(ctx, m, weights, traffic, run_: dict, picks: list, p: Precision,
                   got_p: Precision | None = None) -> dict:
    """(passthrough_gap, pred_gap) of the picked rounds: the program's
    emitted chunks against the reference at `p`, or with `got_p` the
    reference at that precision in the program's place."""
    capacity, f16 = ctx.params["capacity"], ctx.params["f16_fetch"]
    lanes = run_["lanes"]
    pass_gap, pred_gap = 0.0, 0.0
    for i in picks:
        k, emitted = run_["rounds"][i]
        on = sorted((lane, sid) for lane, sid in lanes.items() if sid in emitted)
        mono, pred = reference_round(m, p, weights, traffic, k, lanes, set(emitted), capacity,
                                     ctx.device, f16)
        if got_p is None:
            got = {lane: emitted[sid] for lane, sid in on}
        else:
            o_mono, o_pred = reference_round(m, got_p, weights, traffic, k, lanes,
                                             set(emitted), capacity, ctx.device, f16)
            got = {lane: np.concatenate([o_mono[lane][:, None], o_pred[lane]], 1)
                   for lane, _ in on}
        for lane, _ in on:
            pass_gap = max(pass_gap, float(np.abs(got[lane][:, 0] - mono[lane]).max()))
        pred_gap = max(pred_gap, rel_l2(np.stack([got[lane][:, 1:] for lane, _ in on]),
                                        np.stack([pred[lane] for lane, _ in on])))
    return {"passthrough_gap": pass_gap, "pred_gap": pred_gap}


def sound_pass(ctx) -> dict:
    """Set-up, the program through the window, and the reference over the
    rounds drawn from the seed: the pass that run() reports and that
    readings() adds the control to."""
    params, cfg = ctx.params, ctx.config
    m = model_shape(cfg)
    weights = make_weights(m, ctx.seed, ctx.device)
    traffic = Traffic(ctx.seed, m.geometry.snd_dur, m.frame_hw, params["chunk_pool"],
                      params["frame_pool"])
    p = precision(cfg)
    flops = count_flops(m, p, params["capacity"], backward=False)
    run_ = serve_program(ctx, m, weights, traffic)
    picks = checked_rounds(run_, ctx.seed)
    numbers = compare_rounds(ctx, m, weights, traffic, run_, picks, p)
    return {"m": m, "weights": weights, "traffic": traffic, "p": p, "flops": flops,
            "run": run_, "picks": picks, "numbers": numbers}


def readings(ctx, faults: bool) -> dict:
    """The compared numbers of one sound pass at the cell's load over a
    short window; with `faults`, on the same rounds, the control's (the
    reference one precision step below, in the program's place)."""
    ctx.seconds = max(ctx.seconds, 1.0)
    sp = sound_pass(ctx)
    out = {"sound": sp["numbers"]}
    if faults:
        out["control"] = compare_rounds(ctx, sp["m"], sp["weights"], sp["traffic"], sp["run"],
                                        sp["picks"], sp["p"],
                                        got_p=precision(ctx.config, "lower"))
    free_weights(ctx, sp)
    return out


def run(ctx) -> Result:
    params, cfg = ctx.params, ctx.config
    sp = sound_pass(ctx)
    m, run_, numbers = sp["m"], sp["run"], sp["numbers"]
    capacity = params["capacity"]
    limits = ctx.workload["limits"]
    checks = [(k, numbers[k], limits[k]) for k in limits if k in numbers]
    g = m.geometry
    k_flops, k_bytes = istft_work(capacity, 1, m.tracks, g.n_mask, g.wind,
                                  cfg["pallas_precision"], 4)
    lat = run_["latency"]
    info = {"ticks": len(lat), "least_tick_s": least_seconds(sp["flops"]),
            "istft_flops": k_flops, "istft_bytes": k_bytes, "route": cfg["pallas_precision"],
            "memory_peak_bytes": run_["memory_peak_bytes"], "numbers": numbers,
            "p50_ms": percentile(lat, 50) * 1e3, "late_s": run_["late_s"]}
    free_weights(ctx, sp)
    return Result(metrics={"serve_tick_p95_ms": percentile(lat, 95) * 1e3},
                  attempted=run_["due"], failed=run_["due"] - run_["emitted"],
                  checks=checks, info=info)
