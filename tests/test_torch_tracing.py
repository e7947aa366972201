"""The port's tracer (utils/profiling.py) in the program, on the CPU: the
spans and counters that a training run, a deploy and the stream batcher
record, with their parents, ids and threads; counters against the arrays'
bytes and the batches' lanes; the off path, which reads no clock and opens
no profiler range; and the `sag.*` ranges a torch.profiler records, nested
as the spans in memory are.

A reduced flagship (audio + video, unet_mask with 2 tracks, 64x128 frames)
is trained for three steps on a synthetic clip made by the port; the
trained model dir then deploys and serves.
"""

from __future__ import annotations

import os
import threading
import types

import numpy as np
import pytest
import torch

from spatialaudiogen_tpu_torch.config import TrainConfig
from spatialaudiogen_tpu_torch.data.pipeline import device_prefetch
from spatialaudiogen_tpu_torch.data.synthetic import make_synthetic_dataset
from spatialaudiogen_tpu_torch.deploy.deploy import MonoToAmbix
from spatialaudiogen_tpu_torch.deploy.stream import StreamBatcher
from spatialaudiogen_tpu_torch.train.trainer import Trainer
from spatialaudiogen_tpu_torch.utils import profiling
from spatialaudiogen_tpu_torch.utils.profiling import TRACER

FRAME_HW = (64, 128)
START, DURATION, BATCH = 0.5, 0.5, 3        # 5 windows: two batches, one pad lane
STEPS = 3


@pytest.fixture(autouse=True)
def _tracer_off():
    TRACER.stop()
    yield
    TRACER.stop()


def traced(fn):
    """-> (fn's result, what the tracer recorded while it ran)."""
    TRACER.start()
    try:
        out = fn()
    finally:
        trace = TRACER.stop()
    return out, trace


def parent_name(trace, s):
    return None if s.parent is None else trace.spans[s.parent].name


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A 3-step training run under the tracer -> (db clip, model dir, trace)."""
    root = str(tmp_path_factory.mktemp("tracingdb"))
    make_synthetic_dataset(root, n_videos=1, duration=3.0, frame_hw=FRAME_HW, seed=2)
    model_dir = str(tmp_path_factory.mktemp("tracingmodel") / "model")
    cfg = TrainConfig(db_dir=root, model_dir=model_dir, encoders=("audio", "video"),
                      separation="unet_mask", num_sep_tracks=2, frame_hw=FRAME_HW,
                      n_iters=STEPS, batch_size=2, n_workers=1, log_every=2, ckpt_every=0,
                      seed=0)
    torch.set_num_threads(2)
    TRACER.stop()
    _, trace = traced(lambda: Trainer(cfg, device="cpu").train())
    return os.path.join(root, "synth000"), model_dir, trace


def test_training_records_the_loop_spans(trained):
    _, _, trace = trained
    main = threading.get_ident()
    roots = trace.of("train.iter")
    assert [s.id for s in roots] == list(range(STEPS))
    assert all(s.parent is None and s.thread == main for s in roots)
    for name in ("train.batch", "train.launch"):
        spans = trace.of(name)
        assert [s.id for s in spans] == list(range(STEPS)), name
        assert {parent_name(trace, s) for s in spans} == {"train.iter"}, name
    # the log steps (log_every 2): the metric fetch and the write
    assert sorted({s.id for s in trace.of("train.log")}) == [0, 2]
    # the feeder is read by the prefetch's staging thread, outside the loop's spans
    waits = trace.of("feeder.wait")
    assert waits and all(s.parent is None and s.thread != main for s in waits)
    assert "train.samples" not in trace.counters
    # on the CPU the arrays are wrapped, not copied: no pin, no copy
    assert not trace.of("train.pin") and not trace.of("train.h2d")
    assert trace.counters["train.h2d_bytes"] > 0
    for s in trace.spans:
        assert s.end_ns >= s.start_ns and 0 <= s.self_ns <= s.duration_ns
    it = roots[-1]
    children = [s for s in trace.spans if s.parent == trace.spans.index(it)]
    assert it.self_ns == it.duration_ns - sum(c.duration_ns for c in children)


def _batches():
    rng = np.random.default_rng(0)
    return [{"id": [f"v{i}", f"w{i}"],
             "ambix": rng.standard_normal((2, 32, 4)).astype(np.float32),
             "video": rng.integers(0, 256, (2, 1, 4, 8, 3), dtype=np.uint8)}
            for i in range(2)]


def test_device_prefetch_records_the_bytes_and_no_copy_on_the_cpu():
    """Two batches through the prefetch inside a parent span on the CPU:
    the arrays are wrapped, not pinned or copied, so no `train.pin` or
    `train.h2d` span is recorded (the card test records both), and
    `train.h2d_bytes` holds every array's bytes."""
    batches = _batches()

    def run():
        stream = device_prefetch(iter(batches), "cpu")
        got = []
        for step in range(2):
            with profiling.span("train.iter", step):
                with profiling.span("train.batch"):
                    got.append(next(stream))
        return got

    got, trace = traced(run)
    assert [g[1]["id"] for g in got] == [b["id"] for b in batches]
    for (dev, _), b in zip(got, batches):
        assert all(dev[k].device.type == "cpu" and np.array_equal(dev[k].numpy(), b[k])
                   for k in ("ambix", "video"))
    want = sum(b[k].nbytes for b in batches for k in ("ambix", "video"))
    assert trace.counters["train.h2d_bytes"] == want
    assert not trace.of("train.pin") and not trace.of("train.h2d")
    assert [s.id for s in trace.of("train.batch")] == [0, 1]


@pytest.fixture(scope="module")
def deployed(trained):
    clip, model_dir, _ = trained
    engine = MonoToAmbix(model_dir, batch_size=BATCH, device="cpu")
    engine.deploy(clip, START, DURATION)          # call 1, untraced
    out, trace = traced(lambda: engine.deploy(clip, START, DURATION))
    return engine, clip, out, trace


def test_deploy_records_the_call_and_the_reader_thread(deployed):
    engine, _, out, trace = deployed
    main = threading.get_ident()
    (call,) = trace.of("deploy.call")
    assert call.id == 2 and call.parent is None and call.thread == main
    for name, n in (("deploy.reader", 1), ("deploy.upload", 2), ("deploy.forward", 2),
                    ("deploy.drain", 2), ("deploy.join", 1)):
        spans = trace.of(name)
        assert len(spans) == n, name
        assert all(parent_name(trace, s) == "deploy.call" and s.id == 2 and s.thread == main
                   for s in spans), name
    # two batches and the end of the reader's stream
    assert len(trace.of("deploy.wait")) == 3
    reads = trace.of("deploy.read")
    assert len(reads) == 2
    assert all(s.parent is None and s.id == 2 and s.thread != main for s in reads)
    assert out.shape[0] == 5 * engine.geometry.snd_dur


def test_deploy_counters_match_the_batches(deployed):
    """windows 5, lanes 2 x 3 (one pad lane), H2D bytes the sum of the
    arrays the reader makes, D2H bytes the float16 predictions."""
    engine, clip, _, trace = deployed
    g = engine.geometry
    c = trace.counters
    assert (c["deploy.windows"], c["deploy.lanes"]) == (5, 2 * BATCH)
    assert c["deploy.lanes"] - c["deploy.windows"] == 1
    reader = engine._reader(clip, START, DURATION)
    want = sum(a.nbytes for _, span, rel, video, _ in engine._span_batches(reader, clip)
               for a in (span, rel, video) if a is not None)
    assert c["deploy.h2d_bytes"] == want
    assert c["deploy.d2h_bytes"] == 2 * BATCH * g.snd_dur * engine._n_out * 2


def test_stream_batcher_records_push_and_rounds(trained):
    """Two sessions pushed 1.2 s of audio and frames, then one tick(): the
    pushes carry the id of the round they feed, each round is a root with
    its assembly, staging, upload, forward and fetch, and the counters
    hold the rounds, the emitting lanes and the bytes sent up."""
    clip, model_dir, _ = trained
    batcher = StreamBatcher(model_dir, capacity=2, device="cpu")
    sids = [batcher.add_session(), batcher.add_session()]
    g = batcher.geometry
    rng = np.random.default_rng(1)
    frame = rng.integers(0, 256, FRAME_HW + (3,), dtype=np.uint8)

    def run():
        for _ in range(12):
            for sid in sids:
                batcher.push(sid, 0.1 * rng.standard_normal(g.snd_dur).astype(np.float32),
                             frame)
        return batcher.tick()

    out, trace = traced(run)
    rounds = len(out[sids[0]])
    assert rounds >= 2 and len(out[sids[1]]) == rounds
    pushes = trace.of("serve.push")
    assert len(pushes) == 24 and {s.id for s in pushes} == {0}
    assert all(s.parent is None for s in pushes)
    ticks = trace.of("serve.tick")
    assert [s.id for s in ticks] == list(range(rounds))
    for name in ("serve.assemble", "serve.stage", "serve.upload", "serve.forward",
                 "serve.fetch"):
        spans = trace.of(name)
        assert [s.id for s in spans] == list(range(rounds)), name
        assert {parent_name(trace, s) for s in spans} == {"serve.tick"}, name
    c = trace.counters
    assert (c["serve.rounds"], c["serve.lanes_emitting"]) == (rounds, 2 * rounds)
    per_round = 2 * g.snd_dur * 4 + 2 * 2 * 4 + 2 * g.vid_dur * frame.nbytes
    fresh = 2 * g.snd_size * 4          # each lane's first full window
    assert c["serve.h2d_bytes"] == rounds * per_round + fresh


def test_off_path_records_nothing_reads_no_clock_and_opens_no_range(trained, monkeypatch):
    """Off (not started, no profiler recording): span() is the shared
    no-op, count() returns, and a whole deploy records nothing."""
    clip, model_dir, _ = trained

    def boom(*a, **k):
        raise AssertionError("the off path read the clock or opened a range")

    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(perf_counter_ns=boom))
    monkeypatch.setattr(profiling, "record_function", boom)
    monkeypatch.setattr(profiling, "_PROFILER", types.SimpleNamespace(_is_profiler_enabled=False))
    assert profiling.span("x") is profiling._NO_SPAN
    with profiling.span("x", 3) as s:
        assert s is None
    assert profiling.count("x", 5) is None
    MonoToAmbix(model_dir, batch_size=BATCH, device="cpu").deploy(clip, START, DURATION)
    trace = TRACER.take()
    assert trace.spans == [] and trace.counters == {}


def test_profiler_ranges_nest_as_the_spans(deployed):
    """Under torch.profiler the tracer records by itself, and each span of
    the calling thread is a `sag.<name>` range on the profiler's host
    timeline, nested in its parent's range as the span is in memory (the
    reader thread's `deploy.read` stays in memory: the profiler follows the
    thread that started it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine, clip, _, _ = deployed
    TRACER.take()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.deploy(clip, START, DURATION)
    trace = TRACER.take()
    main = threading.get_ident()
    assert {s.thread for s in trace.of("deploy.read")} - {main}
    mine = [s for s in trace.spans if s.thread == main]
    ranges: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("sag.") and e.device_type() == DeviceType.CPU:
            ranges.setdefault(e.name()[4:], []).append((e.start_ns(), e.end_ns()))
    assert mine and {s.name for s in mine} == set(ranges)
    # the k-th span of a name is the k-th range of that name, by start
    order = {}
    for name in ranges:
        ranges[name].sort()
        spans = sorted((s for s in mine if s.name == name), key=lambda s: s.start_ns)
        assert len(spans) == len(ranges[name]), name
        order.update({id(s): ranges[name][k] for k, s in enumerate(spans)})
    nested = 0
    for s in mine:
        if s.parent is not None:
            lo, hi = order[id(s)]
            plo, phi = order[id(trace.spans[s.parent])]
            assert plo <= lo and hi <= phi, (s.name, trace.spans[s.parent].name)
            nested += 1
    assert nested >= 9


def test_records_past_the_cap_are_dropped_and_counted(monkeypatch):
    """At most MAX_RECORDS spans and as many counts are kept between
    handovers; the rest are dropped, and the handover says how many."""
    monkeypatch.setattr(profiling, "MAX_RECORDS", 3)

    def run():
        for i in range(5):
            with profiling.span("s", i):
                profiling.count("n", 2)

    _, trace = traced(run)
    assert [s.id for s in trace.spans] == [0, 1, 2]
    assert trace.counters == {"n": 6, "tracer.dropped_spans": 2, "tracer.dropped_counts": 2}
    _, again = traced(run)
    assert len(again.spans) == 3 and again.counters["n"] == 6


def test_a_torch_without_the_profiler_flag_leaves_the_tracer_to_its_switch(monkeypatch):
    """Where torch.autograd.profiler has no `_is_profiler_enabled`, a profile
    records no span and opens no range, and the switch still works."""
    from torch.autograd import profiler as autograd_profiler
    from torch.profiler import ProfilerActivity, profile

    assert profiling._profiler_flag(autograd_profiler) is autograd_profiler
    monkeypatch.setattr(profiling, "_PROFILER", profiling._profiler_flag(types.SimpleNamespace()))

    def run():
        with profiling.span("x", 1):
            profiling.count("n")

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    assert TRACER.take().spans == []
    assert not [e for e in prof.profiler.kineto_results.events()
                if e.name().startswith("sag.")]
    _, trace = traced(run)
    assert [s.name for s in trace.spans] == ["x"] and trace.counters == {"n": 1}
