"""The readers of the program's own spans and counters: each new metric
against a context whose window holds known spans and counters; the window
cut from the tracer's records by time; nothing read from an untraced run
or from a program without the tracer; the trace summary unchanged by the
program's `sag.*` ranges mirrored on the device's timeline, which name the
idle gaps the host spent inside them; and each cell's traced dry run on
the CPU reporting its new metrics.

    python -m pytest port_bench/tests -q
"""

from __future__ import annotations

import time
import types

import pytest
import torch

from port_bench.harness import core, program, trace

SEED = 2 ** 33 + 7


def record(name, start_ms, end_ms, parent=None, id=None):
    from spatialaudiogen_tpu_torch.utils.profiling import SpanRecord

    ns = int(1e6)
    return SpanRecord(name, int(start_ms * ns), int(end_ms * ns), parent, 1, id,
                      int((end_ms - start_ms) * ns))


def fake_ctx(info: dict, spans: list, counters: dict, monkeypatch):
    from spatialaudiogen_tpu_torch.utils.profiling import Trace

    monkeypatch.setattr(program, "window_trace", lambda ctx: Trace(spans, counters))
    return types.SimpleNamespace(result=types.SimpleNamespace(info=info), trace=True,
                                 params={"capacity": 48})


# (metric, info, spans, counters, expected)
CASES = [
    ("pin_copy_ms.train_step", {"steps": 4},
     [record("train.pin", 0, 30), record("train.pin", 40, 50), record("train.h2d", 50, 51)],
     {}, 10.0),
    ("pin_copy_ms.train_step_bf16", {"steps": 2},
     [record("train.pin", 0, 70), record("train.pin", 100, 190)], {}, 80.0),
    ("h2d_mb.train_step", {"steps": 3}, [], {"train.h2d_bytes": 3 * 146_700_000}, 146.7),
    ("h2d_mb.train_step_bf16", {"steps": 2}, [], {"train.h2d_bytes": 601_600_000}, 300.8),
    ("step_launch_ms.train_step", {"steps": 2},
     [record("train.launch", 0, 5), record("train.launch", 10, 17)], {}, 6.0),
    ("step_launch_ms.train_step_bf16", {"steps": 1}, [record("train.launch", 0, 9)], {}, 9.0),
    ("read_wait_ms.deploy", {"calls": 2},
     [record("deploy.wait", 0, 150), record("deploy.wait", 200, 210),
      record("deploy.read", 0, 100)], {}, 80.0),
    ("pad_lane_pct.deploy", {"calls": 3}, [],
     {"deploy.lanes": 3 * 1280, "deploy.windows": 3 * 1190}, 100.0 * 90 / 1280),
    ("push_ms.serve", {"ticks": 4}, [record("serve.push", 0, 1)] * 8, {}, 2.0),
    ("assemble_ms.serve", {"ticks": 2},
     [record("serve.assemble", 0, 8), record("serve.stage", 8, 12),
      record("serve.assemble", 20, 26), record("serve.fetch", 26, 60)], {}, 9.0),
    ("fetch_wait_ms.serve", {"ticks": 2},
     [record("serve.fetch", 0, 30), record("serve.fetch", 40, 80)], {}, 35.0),
    ("h2d_mb.deploy", {"calls": 2}, [], {"deploy.h2d_bytes": 2 * 398_610_220}, 398.61022),
    ("d2h_mb.deploy", {"calls": 4}, [], {"deploy.d2h_bytes": 4 * 36_864_000}, 36.864),
    ("h2d_mb.serve", {"ticks": 3}, [],
     {"serve.h2d_bytes": 5 * 15_372_672, "serve.rounds": 5}, 15.372672),
    ("lane_occupancy_pct.serve", {"ticks": 4}, [],
     {"serve.lanes_emitting": 3 * 48 + 12, "serve.rounds": 4}, 100.0 * 156 / 192),
]


@pytest.mark.parametrize("name, info, spans, counters, want", CASES,
                         ids=[c[0] for c in CASES])
def test_each_program_metric_reads_its_spans_and_counters(name, info, spans, counters, want,
                                                          monkeypatch):
    ctx = fake_ctx(info, spans, counters, monkeypatch)
    mod = core.metric(name)
    assert mod.read(ctx, ctx.result) == pytest.approx(want)
    empty = fake_ctx(info, [], {}, monkeypatch)
    assert mod.read(empty, empty.result) is None


def test_the_new_entries_name_their_cells_and_a_program_source():
    bench = core.load_json(core.ROOT / "BENCHMARK.json")
    cells = {c["name"] for c in bench["workloads"]}
    new = [m for m in bench["per_layer"] if m["name"] in {c[0] for c in CASES}]
    assert len(new) == len(CASES) == 15
    for entry in new:
        assert entry["source"] in ("program_span", "program_counter")
        assert set(entry["workloads"]) <= cells and len(entry["workloads"]) == 1


def test_the_window_is_cut_from_the_tracer_by_time():
    from spatialaudiogen_tpu_torch.utils.profiling import TRACER, span

    TRACER.start()
    try:
        with span("before"):
            pass
        time.sleep(0.002)
        t0 = time.perf_counter()
        with span("inside"):
            TRACER.count("n", 3)
        window_s = time.perf_counter() - t0
        time.sleep(0.002)
        with span("after"):
            TRACER.count("n", 5)
        ctx = types.SimpleNamespace(trace=True, _t0=t0, window_s=window_s)
        got = program.window_trace(ctx)
    finally:
        TRACER.stop()
    assert [s.name for s in got.spans] == ["inside"] and got.counters == {"n": 3}
    assert program.window_trace(types.SimpleNamespace(trace=False, _t0=t0,
                                                      window_s=window_s)) is None


def test_a_program_without_the_tracer_reads_nothing(monkeypatch):
    """The parent of the tracer's change runs these readers too: they find
    no tracer there and give None."""
    from spatialaudiogen_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "TRACER")
    ctx = types.SimpleNamespace(trace=True, _t0=1.0, window_s=1.0,
                                result=types.SimpleNamespace(info={"steps": 1}))
    assert program.window_trace(ctx) is None
    assert core.metric("pin_copy_ms.train_step").read(ctx, ctx.result) is None


class _Event:
    def __init__(self, name, kind, start_us, end_us, annotation=False):
        self._name, self._kind = name, kind
        self._s, self._e, self._a = int(start_us * 1e3), int(end_us * 1e3), annotation

    def name(self):
        return self._name

    def device_type(self):
        return self._kind

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def is_user_annotation(self):
        return self._a


def _prof(events):
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=results))


def test_program_ranges_change_no_device_time_and_name_the_gaps():
    """A window with two kernels and a 400 us gap between them while the
    host waits inside `sag.deploy.wait` (under the benchmark's span):
    with the program's ranges on both timelines, busy_s and kernel_s are
    those of the kernels alone, and the gap is named by the program span."""
    from torch.autograd import DeviceType

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    base = [_Event("bench.deploy_call", cpu, 0, 1000, True),
            _Event("k_a", cuda, 100, 300), _Event("k_b", cuda, 700, 900),
            _Event("bench.deploy_call", cuda, 100, 900, True)]
    program_ranges = [_Event("sag.deploy.call", cpu, 10, 990, True),
                      _Event("sag.deploy.wait", cpu, 310, 690, True),
                      _Event("sag.deploy.forward", cpu, 50, 120, True),
                      _Event("sag.deploy.forward", cuda, 100, 300, True),
                      _Event("sag.deploy.call", cuda, 100, 900, True)]
    plain = trace.summarize(_prof(base), 800e-6)
    mirrored = trace.summarize(_prof(base + program_ranges), 800e-6)
    assert mirrored.busy_s == pytest.approx(plain.busy_s) == pytest.approx(400e-6)
    assert mirrored.kernel_s == plain.kernel_s
    assert not [k for k in mirrored.kernel_s if k.startswith("sag.")]
    label, seconds = mirrored.breakdown["idle_gaps"][0]
    assert label == "host: bench.deploy_call > sag.deploy.wait"
    assert seconds == pytest.approx(400e-6)


TRAIN_CELLS = ["audio_rgb.train_step.b128", "audio_flow_rgb.train_step.b128.bf16"]
# on the CPU the prefetch wraps the arrays without pinning them
ON_THE_CARD_ONLY = {"pin_copy_ms.train_step", "pin_copy_ms.train_step_bf16"}


@pytest.mark.parametrize("cell", TRAIN_CELLS + ["audio_rgb.deploy.b128",
                                                "audio_rgb.serve.open"])
def test_a_traced_dry_run_reports_the_program_metrics(cell):
    from port_bench.run import run_cell
    from port_bench.tests.test_port_bench_drivers import small

    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        line, checks, _ = run_cell(cell, SEED, 0.5, True, "cpu", overrides=small(cell),
                                   t_start=time.perf_counter())
    finally:
        torch.set_num_threads(prev)
    assert line["correct"] is True, checks
    bench = core.load_json(core.ROOT / "BENCHMARK.json")
    names = {m["name"] for m in core.cell_metrics(bench, cell)[1]
             if m["source"] in ("program_span", "program_counter")}
    new = {c[0] for c in CASES} & names
    assert new and set(line["metrics"]) >= new - ON_THE_CARD_ONLY
    for name in new - ON_THE_CARD_ONLY:
        assert line["metrics"][name]["value"] >= 0, name
    if cell in TRAIN_CELLS:
        small_batch = small(cell)["params"]["batch_size"]
        suffix = "train_step" if "bf16" not in cell else "train_step_bf16"
        assert line["metrics"][f"h2d_mb.{suffix}"]["value"] > 0.001 * small_batch
    if cell == "audio_rgb.deploy.b128":
        assert 0 <= line["metrics"]["pad_lane_pct.deploy"]["value"] < 100
        assert line["metrics"]["d2h_mb.deploy"]["value"] > 0
    if cell == "audio_rgb.serve.open":
        assert 0 < line["metrics"]["lane_occupancy_pct.serve"]["value"] <= 100
        assert line["metrics"]["h2d_mb.serve"]["value"] > 0
