"""The harness: cells, configurations, drivers and metrics found by name
(and new ones taken from new files alone), the result line's keys, the
window's rates and open-loop tails, the idle share from the union of
intervals, and the imports it may not make.

    python -m pytest port_bench/tests -q
"""

from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest

from port_bench.harness import core, trace

BENCH = core.BENCH_DIR
ROOT = core.ROOT
CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def benchmark() -> dict:
    return core.load_json(ROOT / "BENCHMARK.json")


def test_every_cell_config_driver_and_metric_is_found_by_name():
    bench = benchmark()
    configs = {c["name"]: c for c in bench["configs"]}
    for cell in bench["workloads"]:
        wl = core.workload(cell["name"])
        assert (wl["config"], wl["traffic"], wl["chips"], wl["why"]) == (
            cell["config"], cell["traffic"], cell["chips"], cell["why"])
        entry = configs[cell["config"]]
        assert entry["file"] == f"port_bench/configs/{cell['config']}.json"
        assert core.config(cell["config"])["source"] == entry["source"]
        assert callable(core.driver(wl["driver"]).run)
        e2e, layer = core.cell_metrics(bench, cell["name"])
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer
    for entry in bench["per_layer"]:
        mod = core.metric(entry["name"])
        assert (mod.LAYER, mod.UNIT, mod.MOVES) == (entry["layer"], entry["unit"],
                                                     entry["moves"])
        assert callable(mod.read)


DUMMY_DRIVER = '''
from port_bench.harness.core import Result


def run(ctx):
    ctx.open_window()
    with ctx.spans("work"):
        n = sum(range(1000))
    ctx.close_window()
    return Result(metrics={"dummy_rate": 3.0}, attempted=2, failed=0,
                  checks=[("dummy_gap", 0.0, ctx.workload["limits"]["dummy_gap"])],
                  info={"n": n, "scale": ctx.params["scale"]})
'''

DUMMY_METRIC = '''
LAYER = "dummy layer"
UNIT = "%"
MOVES = "dummy_rate"


def read(ctx, result):
    return 50.0 * result.info["scale"]
'''


@pytest.fixture
def dummy_bench(tmp_path):
    """A copy of the benchmark with a cell, a configuration, a driver and a
    metric added as new files and new entries only."""
    bench_dir = tmp_path / "port_bench"
    shutil.copytree(BENCH, bench_dir, ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = benchmark()
    (bench_dir / "drivers" / "dummy.py").write_text(DUMMY_DRIVER)
    (bench_dir / "metrics" / "dummy_pct.dummy.py").write_text(DUMMY_METRIC)
    (bench_dir / "configs" / "dummy.json").write_text(json.dumps({"source": "x"}))
    (bench_dir / "workloads" / "dummy.cell.json").write_text(json.dumps(
        {"config": "dummy", "driver": "dummy", "traffic": "dummy", "chips": 1, "why": "test",
         "params": {"scale": 1.5}, "limits": {"dummy_gap": 0.0}}))
    bench["workloads"].append({"name": "dummy.cell", "config": "dummy", "traffic": "dummy",
                               "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "dummy_rate", "unit": "x/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["dummy.cell"]})
    bench["per_layer"].append({"name": "dummy_pct.dummy", "unit": "%", "better": "higher",
                               "source": "program_span", "layer": "dummy layer",
                               "moves": "dummy_rate"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench_dir


@pytest.mark.parametrize("traced", [False, True])
def test_a_cell_and_metric_added_as_new_files_are_taken(dummy_bench, traced):
    from port_bench.run import run_cell

    line, checks, _ = run_cell("dummy.cell", 7, 0.0, traced, "cpu", bench_dir=dummy_bench)
    if traced:
        assert line["metrics"] == {"dummy_pct.dummy": {"value": 75.0, "unit": "%"}}
        assert list(line) == CONTRACT_KEYS + ["breakdown", "checks"]
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(line["device"])
    else:
        assert set(line["metrics"]) == {"dummy_rate", "setup_s"}
        assert line["metrics"]["dummy_rate"] == {"value": 3.0, "unit": "x/s"}
        assert list(line) == CONTRACT_KEYS + ["checks"]
    assert line["correct"] is True and checks == [("dummy_gap", 0.0, 0.0)]
    assert line["checks"] == {"dummy_gap": {"value": 0.0, "limit": 0.0}}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])


def test_a_metric_that_finds_nothing_is_left_out(dummy_bench):
    from port_bench.run import run_cell

    (dummy_bench / "metrics" / "dummy_pct.dummy.py").write_text(
        DUMMY_METRIC.replace('50.0 * result.info["scale"]', "None"))
    line, _, _ = run_cell("dummy.cell", 7, 0.0, True, "cpu", bench_dir=dummy_bench)
    assert line["metrics"] == {}


def test_union_of_intervals_counts_overlaps_once():
    assert trace.union_length([]) == 0.0
    assert trace.union_length([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4.0
    assert trace.union_length([(4, 5), (0, 1)]) == 2.0
    assert trace.gaps([(1, 2), (1.5, 3), (5, 6)], 0, 8) == [(0, 1), (3, 5), (6, 8)]


def test_idle_share_reads_the_union_not_the_sum():
    from port_bench.harness import readers

    summary = trace.TraceSummary(window_s=10.0, busy_s=trace.union_length(
        [(0, 4), (2, 6)]), kernel_s={}, kernel_calls={}, breakdown={})
    ctx = types.SimpleNamespace(trace_summary=summary)
    assert readers.device_idle_pct(ctx) == pytest.approx(40.0)


def test_kernel_roofline_reads_launches_and_device_time():
    from port_bench.harness import readers
    from port_bench.reference.work import bound_seconds

    summary = trace.TraceSummary(10.0, 5.0, {"void masked_istft_fwd_kernel<1>": 0.004},
                                 {"void masked_istft_fwd_kernel<1>": 4}, {})
    info = {"istft_flops": 4.8e11, "istft_bytes": 1e9, "route": "default"}
    ctx = types.SimpleNamespace(trace_summary=summary,
                                result=types.SimpleNamespace(info=info))
    want = 100 * 4 * bound_seconds(4.8e11, 1e9, "default") / 0.004
    assert readers.kernel_roofline_pct(ctx, "masked_istft_fwd_kernel") == pytest.approx(want)
    assert readers.kernel_roofline_pct(ctx, "masked_istft_bwd_kernel") is None


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.t += max(s, 0.0)


def test_train_window_counts_every_step_over_all_its_time():
    from port_bench.drivers.train import _WindowLogger

    clock = _Clock()
    events = []
    ctx = types.SimpleNamespace(seconds=1.0)
    ctx.open_window = lambda: events.append(("open", clock.t))
    ctx.window_elapsed = lambda: clock.t - events[0][1]

    def close():
        events.append(("close", clock.t))
        ctx.window_s = clock.t - events[0][1]

    ctx.close_window = close
    trainer = types.SimpleNamespace(request_stop=lambda: events.append(("stop", clock.t)))
    logger = _WindowLogger(ctx, trainer, warm=3)
    step_s = [0.5, 0.5, 0.5, 0.3, 0.3, 0.3, 0.3, 0.3]
    for s in step_s:
        clock.t += s
        logger.tick(s)
    # opened at the third tick (t = 1.5), closed at the first tick past 1 s
    assert events[0] == ("open", 1.5) and events[1][0] == "close"
    assert logger.window_steps == 4 and ctx.window_s == pytest.approx(1.2)
    # the rate the driver reports: every step of the window over its time
    assert logger.window_steps * 128 / ctx.window_s == pytest.approx(4 * 128 / 1.2)


class _FakeBatcher:
    """Sessions that emit window k once step k + 10 is pushed; each tick
    costs `tick_s` of the fake clock, and `stall` more at one tick."""

    def __init__(self, clock, tick_s, stall_at=None, stall_s=0.0):
        self.clock, self.tick_s = clock, tick_s
        self.stall_at, self.stall_s = stall_at, stall_s
        self.pushed = {}
        self._sessions = {}
        self.ticks = 0

    def add(self, sid):
        self.pushed[sid] = 0
        self._sessions[sid] = types.SimpleNamespace(next_window=0)

    def push(self, sid, chunk, frame):
        self.pushed[sid] += 1

    def tick(self):
        self.clock.t += self.tick_s + (self.stall_s if self.ticks == self.stall_at else 0.0)
        self.ticks += 1
        out = {}
        for sid, s in self._sessions.items():
            ready = self.pushed[sid] - 10
            while s.next_window < ready:
                out.setdefault(sid, []).append(s.next_window)
                s.next_window += 1
        return out


def _open_loop(stall_at=None, stall_s=0.0):
    from port_bench.drivers import serve

    clock = _Clock()
    b = _FakeBatcher(clock, 0.02, stall_at, stall_s)
    for sid in range(2):
        b.add(sid)
    traffic = types.SimpleNamespace(chunk=lambda s, j: None, frame=lambda s, j: None)
    first = 0
    for _ in range(11):                      # set-up: the first 1.1 s of context
        for sid in range(2):
            b.push(sid, None, None)
        first += 1
    b.tick()
    return serve.open_loop(b, [0, 1], traffic, first, 5.0, clock=clock, sleep=clock.sleep)


def test_open_loop_times_each_tick_from_its_due_time():
    run = _open_loop()
    lat = run["latency"]
    assert len(lat) >= 49 and all(x == pytest.approx(0.02) for x in lat)
    assert run["emitted"] == run["due"]


def test_a_stall_shows_in_the_later_ticks_and_the_p95():
    from port_bench.drivers import serve

    run = _open_loop(stall_at=20, stall_s=0.35)
    lat = run["latency"]
    i = next(i for i, x in enumerate(lat) if x > 0.3)
    # the stalled round, then the rounds due during the stall, which the
    # next tick (0.02 s) emits late: each timed from its own due time
    assert lat[i] == pytest.approx(0.37)
    assert lat[i + 1: i + 4] == pytest.approx([0.29, 0.19, 0.09])
    assert all(x == pytest.approx(0.02) for x in lat[i + 4:])
    assert serve.percentile(lat, 95) > 0.1
    assert run["late_s"] == pytest.approx(0.27)     # the first step due in the stall


def test_percentile_is_taken_over_all_values():
    from port_bench.drivers import serve

    values = list(range(1, 101))
    assert serve.percentile(values, 95) == pytest.approx(95.05)
    assert serve.percentile(values, 50) == pytest.approx(50.5)


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_under_the_benchmark_imports_jax_or_the_jax_package():
    files = list(BENCH.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        banned = _imports(path) & {"jax", "jaxlib", "flax", "spatialaudiogen_tpu", "bench",
                                   "chip_smoke"}
        assert not banned, (path, banned)
    for path in (BENCH / "reference").rglob("*.py"):
        assert "spatialaudiogen_tpu_torch" not in _imports(path), path


def test_loaded_modules_are_compared_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "spatialaudiogen_tpu_torch_fake", types.ModuleType("x"))
    assert "spatialaudiogen_tpu" not in core.banned_imports()
    monkeypatch.setitem(sys.modules, "spatialaudiogen_tpu.models", types.ModuleType("x"))
    assert core.banned_imports() == ["spatialaudiogen_tpu"]


def test_run_without_a_card_exits_non_zero_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                           "audio_rgb.train_step.b128", "--seed", str(2 ** 33 + 5), "--seconds", "1",
                           "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_a_checkout_without_the_program_fails(tmp_path):
    shutil.copytree(BENCH, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    code = ("import sys; sys.path.insert(0, '.'); from port_bench.run import run_cell; "
            "run_cell('audio_rgb.deploy.b128', 3, 1.0, False, 'cpu')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0 and "spatialaudiogen_tpu_torch" in proc.stderr
