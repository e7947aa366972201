"""The readers of the trainer prefetch's `train.prefetch_ready` counter:
each metric against a window with known counts, 0 (not nothing) where the
loop waited for every batch, nothing without the counter; their entries;
and a traced dry run of each train-step cell on the CPU reporting them.

    python -m pytest port_bench/tests -q
"""

from __future__ import annotations

import time

import pytest
import torch

from port_bench.harness import core
from port_bench.tests.test_port_bench_program import SEED, TRAIN_CELLS, fake_ctx

READY = {"audio_rgb.train_step.b128": "prefetch_ready_pct.train_step",
         "audio_flow_rgb.train_step.b128.bf16": "prefetch_ready_pct.train_step_bf16"}


@pytest.mark.parametrize("name", sorted(READY.values()))
@pytest.mark.parametrize("steps, ready, want", [(4, 3, 75.0), (5, 5, 100.0), (2, 0, 0.0)])
def test_prefetch_ready_reads_the_share_of_steps_staged_ahead(name, steps, ready, want,
                                                              monkeypatch):
    ctx = fake_ctx({"steps": steps}, [], {"train.prefetch_ready": ready}, monkeypatch)
    assert core.metric(name).read(ctx, ctx.result) == pytest.approx(want)
    empty = fake_ctx({"steps": steps}, [], {}, monkeypatch)
    assert core.metric(name).read(empty, empty.result) is None


def test_the_prefetch_ready_entries_name_their_cell_and_the_counter_source():
    bench = core.load_json(core.ROOT / "BENCHMARK.json")
    entries = {m["name"]: m for m in bench["per_layer"]}
    for cell, name in READY.items():
        entry, mod = entries[name], core.metric(name)
        assert entry["workloads"] == [cell] and entry["source"] == "program_counter"
        assert (entry["layer"], entry["unit"], entry["moves"]) == (mod.LAYER, mod.UNIT,
                                                                    mod.MOVES)


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_a_traced_dry_run_reports_the_prefetch_ready_share(cell):
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
    assert 0 <= line["metrics"][READY[cell]]["value"] <= 100
