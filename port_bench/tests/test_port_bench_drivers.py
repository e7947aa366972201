"""Each driver dry-runs on the CPU at tiny shapes through the whole run
but the look for a card; the same run with the timed path broken
underneath comes out not correct, once for each fault the cell can have;
the control (the reference one precision step below, in the program's
place) fails the cell's limits; and on a card every cell runs as the
benchmark runs it.

    python -m pytest port_bench/tests -q
    python -m pytest port_bench/tests -q -m cuda      # on the card
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import pytest
import torch

from port_bench.harness import core

TRAIN_CELLS = ["audio_rgb.train_step.b128", "audio_flow_rgb.train_step.b128.bf16"]
CELLS = TRAIN_CELLS + ["audio_rgb.deploy.b128", "audio_rgb.serve.open"]
SEED = 2 ** 33 + 101
# tiny shapes; the CPU route runs the masked ISTFT in float32, so the
# reference does too ("highest"); the cells' own limits
SMALL = {"config": {"num_sep_tracks": 8, "frame_hw": [64, 128], "pallas_precision": "highest"},
         "params": {"batch_size": 4, "n_workers": 2, "clips": 2, "clip_seconds": 3,
                    "warm_steps": 5, "capacity": 3, "sessions": 3, "chunk_pool": 64,
                    "frame_pool": 8}}


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def small(cell: str) -> dict:
    wl = core.workload(cell)
    params = {k: v for k, v in SMALL["params"].items() if k in wl["params"]}
    if wl["driver"] == "deploy":
        params["clip_seconds"] = 3
    return {"config": SMALL["config"], "params": params}


def dry_run(cell: str, seconds: float = 0.5):
    from port_bench.run import run_cell

    line, checks, _ = run_cell(cell, SEED, seconds, False, "cpu", overrides=small(cell),
                               t_start=time.perf_counter())
    return line, dict((k, (v, lim)) for k, v, lim in checks)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_dry_runs_correct_on_the_cpu(cell):
    line, checks = dry_run(cell)
    assert line["correct"] is True, checks
    # a CPU tick takes about the 0.1 s a step lasts, so the open loop may
    # run behind here; training steps and deploy calls do not fail
    assert line["attempted"] > 0
    assert line["failed"] == 0 or core.workload(cell)["driver"] == "serve"
    assert set(checks) == set(core.workload(cell)["limits"])
    e2e = {m["name"] for m in core.cell_metrics(core.load_json(core.ROOT / "BENCHMARK.json"),
                                                cell)[0]}
    assert set(line["metrics"]) == e2e and all(v["value"] > 0 for v in line["metrics"].values())


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_a_train_cell_with_its_feeder_live_dry_runs_correct(cell):
    """`replay_batches` 0: the feeder's threads run in the window, and the
    check traces the steps' rows back to the pack as with the replay."""
    from port_bench.run import run_cell

    over = small(cell)
    over["params"]["replay_batches"] = 0
    line, checks, _ = run_cell(cell, SEED + 1, 0.5, False, "cpu", overrides=over,
                               t_start=time.perf_counter())
    assert line["correct"] is True, checks
    assert line["attempted"] > SMALL["params"]["warm_steps"] and line["failed"] == 0


def test_deploy_mfu_charges_the_real_windows_only():
    """A call's last batch is padded to the batch size; the pad lanes are
    no useful work, so MFU counts the clip's windows, not its batches."""
    cell = "audio_rgb.deploy.b128"
    over = small(cell)
    over["params"]["batch_size"] = 3          # 20 windows: the last batch has a pad lane
    wl = core.workload(cell)
    wl = {**wl, "params": {**wl["params"], **over["params"]}}
    cfg = {**core.config(wl["config"]), **over["config"]}
    with tempfile.TemporaryDirectory() as work:
        ctx = core.Context(cell, wl, cfg, SEED, 0.5, False, "cpu", Path(work),
                           time.perf_counter())
        ctx.result = core.driver("deploy").run(ctx)
    info, batch = ctx.result.info, wl["params"]["batch_size"]
    per_call = info["windows"] // info["calls"]
    assert info["windows"] == info["calls"] * per_call and per_call % batch, info
    mfu = core.metric("mfu_pct.deploy").read(ctx, ctx.result)
    assert mfu == pytest.approx(100.0 * info["least_window_s"] * info["windows"] / ctx.window_s)


def _state_unchanged(real):
    """A step that returns its state unchanged: the update is undone."""
    def step(state, batch, *args, **kwargs):
        keep = {k: v.clone() for k, v in state.model.state_dict().items()}
        metrics = real(state, batch, *args, **kwargs)
        state.model.load_state_dict(keep)
        return metrics
    return step


def _half_batch(real):
    """Half of the batch left out, the mean taken over the rest."""
    def step(state, batch, *args, **kwargs):
        half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        return real(state, half, *args, **kwargs)
    return step


@pytest.mark.parametrize("cell", TRAIN_CELLS)
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch])
def test_a_broken_train_step_is_not_correct(cell, fault, monkeypatch):
    from spatialaudiogen_tpu_torch.train import trainer

    monkeypatch.setattr(trainer, "train_step", fault(trainer.train_step))
    line, checks = dry_run(cell)
    assert line["correct"] is False, checks


def test_an_answer_altered_where_deploy_produces_it_is_not_correct(monkeypatch):
    from spatialaudiogen_tpu_torch.deploy.deploy import MonoToAmbix

    real = MonoToAmbix.fwd_span

    def altered(self, *args, **kwargs):
        out = real(self, *args, **kwargs).clone()
        out[1] *= 1.1
        return out

    monkeypatch.setattr(MonoToAmbix, "fwd_span", altered)
    line, checks = dry_run("audio_rgb.deploy.b128")
    assert line["correct"] is False, checks


def test_an_answer_altered_where_serving_produces_it_is_not_correct(monkeypatch):
    from spatialaudiogen_tpu_torch.deploy.stream import StreamBatcher

    real = StreamBatcher._tick_fn

    def altered(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        out[0] *= 1.1
        return out

    monkeypatch.setattr(StreamBatcher, "_tick_fn", altered)
    line, checks = dry_run("audio_rgb.serve.open", seconds=1.0)
    assert line["correct"] is False, checks


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_cells_limits(cell):
    """The reference one precision step below the configuration's (TF32
    operands for float32, fp8 operands for bf16), in the program's place,
    at tiny shapes: at least one compared number passes its limit."""
    limits = core.workload(cell)["limits"]
    over = small(cell)
    wl = core.workload(cell)
    wl = {**wl, "params": {**wl["params"], **over["params"]}}
    cfg = {**core.config(wl["config"]), **over["config"]}
    drv = core.driver(wl["driver"])
    with tempfile.TemporaryDirectory() as work:
        ctx = core.Context(cell, wl, cfg, SEED, 0.5, False, "cpu", Path(work),
                           time.perf_counter())
        got = drv.readings(ctx, True)
    assert all(got["sound"][k] <= lim for k, lim in limits.items() if k in got["sound"])
    assert any(got["control"][k] > lim for k, lim in limits.items() if k in got["control"]), got


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_runs_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python -m pytest port_bench/tests -m cuda)")
    proc = subprocess.run([sys.executable, "port_bench/run.py", "--workload", cell,
                           "--seed", str(SEED), "--seconds", "3", "--trace", "0"],
                          cwd=core.ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert proc.stderr.strip().splitlines()[-1].startswith("check ")
