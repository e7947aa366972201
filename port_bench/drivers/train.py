"""Training driver: the program's `Trainer.train()` (as `cli.train` builds
it) over a pack written from the seed, measured in samples per second.

Set-up writes the pack, makes the weights on the device and hands them to
the trainer's model, and counts the reference step's operations. With
`replay_batches` set (the train-step cells), the trainer's own feeder
makes that many batches from the pack at set-up (random windows and
rotations, uint8 frames, decoded flow), and in the window the trainer's
loop replays them in turn through its own prefetch (pinned copies to the
card two batches ahead), step and logging: the cell measures the loop and
the step, and the feeder's threads, whose rate on the card's eight-core
host swings from run to run by a third, are left out. With
`replay_batches` 0 the feeder runs live in the window, at the cell's
`n_workers`. The benchmark wraps, and changes none of: the feeder's
`start` and `batches` (the replay, or the record of the first batches),
the trainer's `device_prefetch` (the `prefetch_wait` span: the loop's
wait for its next batch on the card), the train step (its loss, Adam's
first moment after the first step, the parameters before the fourth), and
the trainer's logger (the window: it opens after `warm_steps` steps and
asks the trainer to stop at the first step boundary past `--seconds`).
Checkpoints are off in the window; the trainer saves one when it stops.

Correctness, once the window has closed and the program is freed: the
reference rebuilds the first three batches, which the first three steps
took, from the pack (`batch_gap`),
takes three steps from the same weights, and the program's losses, first
gradients, parameter changes after three steps and BN averages are held to
its readings (`loss_gap`, `grad_gap`, `change_gap`, `bn_gap`).
"""

from __future__ import annotations

import dataclasses
import gc

import numpy as np

from port_bench.harness.core import Result
from port_bench.harness.packs import write_db
from port_bench.harness.weights import make_weights
from port_bench.reference.model import ModelShape, Precision
from port_bench.reference.train import BETA1, ReferenceTrainer, trainable
from port_bench.reference.windows import rebuild_batch
from port_bench.reference.work import count_flops, istft_work, least_seconds

CHECK_STEPS = 3
BASE_LR = 1e-4      # the CLI's learning rate; no decay within the first 250 000 steps


def model_shape(cfg: dict) -> ModelShape:
    return ModelShape(encoders=tuple(cfg["encoders"]), tracks=cfg["num_sep_tracks"],
                      frame_hw=tuple(cfg["frame_hw"]), loc_units=tuple(cfg["loc_units"]))


def precision(cfg: dict, control: str | None = None) -> Precision:
    """The precision the configuration states, or its control: one step
    below it (TF32 for float32 with TF32 off, fp8 operands for bf16)."""
    import torch

    p = Precision(compute=torch.bfloat16 if cfg["compute_dtype"] == "bfloat16" else None,
                  istft_bf16=cfg["pallas_precision"] == "default")
    if control == "lower":
        if p.compute is None:
            p = dataclasses.replace(p, tf32=True)
        else:
            p = dataclasses.replace(p, round_to=torch.float8_e4m3fn)
    return p


def train_config(cfg: dict, params: dict, db: str, model_dir: str, seed: int):
    from spatialaudiogen_tpu_torch.config import TrainConfig

    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in cfg.items() if k in fields}
    return TrainConfig(db_dir=db, model_dir=model_dir, batch_size=params["batch_size"],
                       log_every=params["log_every"], ckpt_every=0,
                       n_workers=params["n_workers"], n_iters=10 ** 9,
                       seed=seed % 4_000_000, **kw)


class _WindowLogger:
    """Stands in for the trainer's logger: counts steps, opens the window
    after `warm` steps and closes it at the first step past the length."""

    def __init__(self, ctx, trainer, warm: int):
        self.ctx, self.trainer, self.warm = ctx, trainer, warm
        self.ticks = 0
        self.opened_at = None
        self.window_steps = None

    def tick(self, duration: float):
        self.ticks += 1
        if self.ticks == self.warm:
            self.ctx.open_window()
            self.opened_at = self.ticks
        elif (self.opened_at is not None and self.window_steps is None
              and self.ctx.window_elapsed() >= self.ctx.seconds):
            self.ctx.close_window()
            self.window_steps = self.ticks - self.opened_at
            self.trainer.request_stop()

    def log(self, *a, **k):
        pass

    def log_histograms(self, *a, **k):
        pass

    def close(self):
        pass


def _norms(tensors: list):
    import torch

    return torch.stack([t.float().norm() for t in tensors])


def run_program(ctx, m: ModelShape, weights: dict, db: str) -> dict:
    """Train through the window; -> the program's readings."""
    import torch

    from spatialaudiogen_tpu_torch.train import trainer as trainer_mod

    params, cfg = ctx.params, ctx.config
    tc = train_config(cfg, params, db, str(ctx.workdir / "model"), ctx.seed)
    trainer = trainer_mod.Trainer(tc, device=ctx.device)
    trainer.logger.close()
    logger = _WindowLogger(ctx, trainer, params["warm_steps"])
    trainer.logger = logger
    state = trainer.state
    state.model.load_state_dict(weights, strict=True)
    names = trainable(m)
    named = dict(state.model.named_parameters())
    every = list(weights)
    got: dict = {"batches": [], "losses": [], "nonfinite": torch.zeros((), dtype=torch.int64,
                                                                      device=ctx.device)}

    feeder = trainer.feeder
    if params.get("replay_batches"):
        # the program's feeder makes the batches at set-up; the window
        # replays them in turn, so its steps wait on the step and the
        # copies, not on the feeder's threads (module docstring)
        feeder.start()
        made = feeder.batches()
        recorded = [next(made) for _ in range(params["replay_batches"])]
        feeder.stop()
        got["batches"] = recorded[:CHECK_STEPS]

        def batches():
            while True:
                yield from recorded

        feeder.start = lambda: feeder
    else:
        live = feeder.batches

        def batches():
            for item in live():
                if len(got["batches"]) < CHECK_STEPS:
                    got["batches"].append(item)
                yield item

    real_prefetch = trainer_mod.device_prefetch

    def prefetch(*args, **kwargs):
        stream = real_prefetch(*args, **kwargs)
        while True:
            with ctx.spans("prefetch_wait"):
                item = next(stream, None)
            if item is None:
                return
            yield item

    real_step = trainer_mod.train_step

    def train_step(state, batch, lr, *args, **kwargs):
        step = state.step
        if step == CHECK_STEPS:
            sd = state.model.state_dict()
            got["change"] = _norms([sd[k] - weights[k] for k in every])
        with ctx.spans("train_step"):
            metrics = real_step(state, batch, lr, *args, **kwargs)
        loss = metrics["total_loss"]
        got["nonfinite"] += (~torch.isfinite(loss)).to(torch.int64)
        if step < CHECK_STEPS:
            got["losses"].append(loss.detach().float().clone())
        if step == 0:
            opt = state.optimizer.state
            got["first_grads"] = _norms([opt[named[k]]["exp_avg"] / (1 - BETA1)
                                         for k in names])
        return metrics

    feeder.batches = batches
    trainer_mod.train_step = train_step
    trainer_mod.device_prefetch = prefetch
    try:
        trainer.train()
    finally:
        trainer_mod.train_step = real_step
        trainer_mod.device_prefetch = real_prefetch
    if logger.window_steps is None:
        raise RuntimeError("the trainer stopped before the window closed")
    out = {"window_steps": logger.window_steps, "steps": state.step,
           "batches": got["batches"], "losses": torch.stack(got["losses"]).tolist(),
           "first_grads": got["first_grads"].tolist(), "change": got["change"].tolist(),
           "nonfinite": int(got["nonfinite"])}
    if ctx.device.startswith("cuda"):
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    del trainer, state, named
    gc.collect()
    if ctx.device.startswith("cuda"):
        torch.cuda.empty_cache()
    return out


def reference_readings(ctx, m: ModelShape, weights: dict, db: str, rows: list,
                       p: Precision, keep=None) -> dict:
    """Three reference steps on the batches rebuilt from the pack for the
    program's rows. `keep` (a slice) keeps only those rows of each batch."""
    import torch

    ref = ReferenceTrainer(weights, m, p, rows=keep)
    packs: dict = {}
    losses, gap = [], 0.0
    for batch in rows:
        rebuilt, g = rebuild_batch(db, batch, m.geometry, m.encoders, packs)
        gap = max(gap, g)
        dev = {k: torch.from_numpy(v).to(ctx.device) for k, v in rebuilt.items()}
        losses.append(ref.step(dev, BASE_LR))
    names = trainable(m)
    return {"batch_gap": gap, "losses": losses,
            "first_grads": _norms([ref.first_grads[k] for k in names]).tolist(),
            "change": _norms([ref.params[k] - weights[k] for k in weights]).tolist()}


def compare(prog: dict, ref: dict, m: ModelShape, names_all: list) -> dict:
    """The numbers compared (module docstring)."""
    names = trainable(m)
    lp, lr = np.array(prog["losses"]), np.array(ref["losses"])
    out = {"loss_gap": float(np.max(np.abs(lp - lr) / np.abs(lr)))}
    gp, gr = np.array(prog["first_grads"]), np.array(ref["first_grads"])
    med = np.median(gr)
    out["grad_gap"] = float(np.max(np.abs(gp - gr) / np.maximum(gr, med)))
    cp, cr = np.array(prog["change"]), np.array(ref["change"])
    is_param = np.array([n in set(names) for n in names_all])
    grad_of = dict(zip(names, gr))
    kept = np.array([is_param[i] and grad_of[n] >= 1e-3 * med for i, n in enumerate(names_all)])
    med_c = np.median(cr[kept])
    out["change_gap"] = float(np.max(np.abs(cp - cr)[kept] / np.maximum(cr[kept], med_c)))
    bn = ~is_param
    if bn.any():
        med_b = np.median(cr[bn])
        out["bn_gap"] = float(np.max(np.abs(cp - cr)[bn] / np.maximum(cr[bn], med_b)))
    return out


def _shifted_rows(batch: dict) -> dict:
    """A feeder fault: every row's audio window one sample late."""
    return {**batch, "ambix": np.roll(batch["ambix"], -1, axis=1)}


def sound_pass(ctx) -> dict:
    """Set-up, the program through the window, and the reference over the
    rows the program took: the pass that run() reports and that
    readings() adds its faults to."""
    params, cfg = ctx.params, ctx.config
    m = model_shape(cfg)
    db = ctx.workdir / "db"
    write_db(db, ctx.seed, params["clips"], params["clip_seconds"], m.frame_hw,
             "flow" in m.encoders)
    weights = make_weights(m, ctx.seed, ctx.device)
    p = precision(cfg)
    flops = count_flops(m, p, params["batch_size"], backward=True)
    prog = run_program(ctx, m, weights, str(db))
    ref = reference_readings(ctx, m, weights, str(db), prog["batches"], p)
    numbers = {"batch_gap": ref["batch_gap"], **compare(prog, ref, m, list(weights))}
    return {"m": m, "db": str(db), "weights": weights, "p": p, "flops": flops,
            "prog": prog, "ref": ref, "numbers": numbers}


def free_weights(ctx, sp: dict) -> None:
    """Drop a pass's weights and give their memory back to the card."""
    import torch

    sp.pop("weights", None)
    if ctx.device.startswith("cuda"):
        torch.cuda.empty_cache()


def readings(ctx, faults: bool) -> dict:
    """The compared numbers of one sound pass, with the worst step's and
    tensor's names; with `faults`, on the same rows, those of the control
    (the reference one precision step below, in the program's place), of
    a step that leaves half of the batch out and takes the mean over the
    rest, and of a feeder whose windows start one sample late."""
    sp = sound_pass(ctx)
    m, db, weights, prog, ref = sp["m"], sp["db"], sp["weights"], sp["prog"], sp["ref"]
    names = list(weights)

    def numbers(other):
        out = compare(other, ref, m, names)
        out["loss_gap_steps"] = [abs(a - b) / abs(b) for a, b in
                                 zip(other["losses"], ref["losses"])]
        grads, want = np.array(other["first_grads"]), np.array(ref["first_grads"])
        worst = np.abs(grads - want) / np.maximum(want, np.median(want))
        out["grad_gap_leaf"] = trainable(m)[int(np.argmax(worst))]
        return out

    out = {"sound": {**sp["numbers"], **numbers(prog)}}
    if faults:
        cfg, rows = ctx.config, prog["batches"]
        half = slice(0, ctx.params["batch_size"] // 2)
        out["control"] = numbers(reference_readings(
            ctx, m, weights, db, rows, precision(cfg, "lower")))
        out["half_batch"] = numbers(reference_readings(ctx, m, weights, db, rows, sp["p"],
                                                       keep=half))
        out["window_shift"] = {"batch_gap": max(
            rebuild_batch(db, _shifted_rows(b), m.geometry, m.encoders)[1] for b in rows)}
    free_weights(ctx, sp)
    return out


def run(ctx) -> Result:
    params, cfg = ctx.params, ctx.config
    sp = sound_pass(ctx)
    m, prog, numbers = sp["m"], sp["prog"], sp["numbers"]
    limits = ctx.workload["limits"]
    checks = [(k, numbers[k], limits[k]) for k in limits if k in numbers]
    g = m.geometry
    route = cfg["pallas_precision"]
    mask_bytes = 2 if cfg["compute_dtype"] == "bfloat16" else 4
    k_flops, k_bytes = istft_work(params["batch_size"], 1, m.tracks, g.n_mask, g.wind, route,
                                  mask_bytes)
    steps = prog["window_steps"]
    info = {"steps": steps, "batch_size": params["batch_size"],
            "least_step_s": least_seconds(sp["flops"]), "istft_flops": k_flops,
            "istft_bytes": k_bytes, "route": route,
            "memory_peak_bytes": prog.get("memory_peak_bytes"), "numbers": numbers}
    rate = steps * params["batch_size"] / ctx.window_s
    free_weights(ctx, sp)
    return Result(metrics={params["metric"]: rate}, attempted=prog["steps"],
                  failed=prog["nonfinite"], checks=checks, info=info)
