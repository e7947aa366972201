"""cli.train across processes on the CPU (gloo): the spawn form (--n_data 2,
--n_model 2) and the --coordinator/--n_processes/--process_id form,
against the port in one process on the same global batches.

The dataset has two 3 s synthetic clips, one of them under a WXY clip's
id from meta/audio_layouts.txt (its Z channel masked): with two data ranks
each feeds one clip (Feeder shard_id/num_shards), so the shards' channel
counts differ. The one-process run rebuilds the global batch the two
ranks form, [rank 0's rows; rank 1's rows], from two Feeders with the
trainer's shards and seed and one worker each (the parity oracle of
tests/test_multiprocess.py), and takes the same steps. Losses rtol 1e-5.

Also: the 2x2 grid (four ranks) equals the same one process and its
checkpoint restores there; a tensor-parallel run equals a one-process cli.train (one feeder on
the model group's first rank, its rows broadcast), its checkpoint restores
in one process and a one-process checkpoint resumes on its ranks; a rank
killed mid-run fails the other with a
non-zero exit well inside the collectives' timeout; a SIGTERM on one rank
stops both at the same step boundary with a checkpoint; a rank that raises
fails the spawn form.
"""

import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from spatialaudiogen_tpu.data.synthetic import make_synthetic_dataset
from spatialaudiogen_tpu_torch.cli import train as cli_train
from spatialaudiogen_tpu_torch.config import TrainConfig
from spatialaudiogen_tpu_torch.data.pipeline import Feeder
from spatialaudiogen_tpu_torch.data.readers import img_prep_u8
from spatialaudiogen_tpu_torch.models.convert import load_params
from spatialaudiogen_tpu_torch.train.checkpoint import latest_step, restore_checkpoint
from spatialaudiogen_tpu_torch.train.state import create_train_state
from spatialaudiogen_tpu_torch.train.steps import train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WXY_ID = "-3GumCmyAIk"    # a WXY clip of meta/audio_layouts.txt
STEPS, BATCH = 2, 4
FLAGS = ["--encoders", "audio", "video", "--num_sep_tracks", "2", "--frame_hw", "64", "128",
         "--batch_size", str(BATCH), "--n_workers", "1", "--log_every", "1",
         "--ckpt_every", "0", "--seed", "0", "--device", "cpu"]


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    root = tmp_path_factory.mktemp("multidb") / "db"
    make_synthetic_dataset(str(root), n_videos=2, duration=3.0, frame_hw=(64, 128), seed=1)
    os.rename(root / "synth001", root / WXY_ID)
    return str(root)


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """Every rank a one-thread CPU process, and torch here on one thread."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def drop_model_dirs(tmp_path):
    """Each test's model dirs go when it ends: a checkpoint of this model
    is 300 MB."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _losses(model_dir) -> list:
    recs = [json.loads(line) for line in open(os.path.join(model_dir, "metrics.jsonl"))]
    return [r["total_loss"] for r in recs]


def _cfg(db, **kw) -> TrainConfig:
    return TrainConfig(db_dir=db, encoders=("audio", "video"), num_sep_tracks=2,
                       frame_hw=(64, 128), batch_size=BATCH, n_workers=1, seed=0, **kw)


@pytest.fixture(scope="module")
def one_process(db):
    """The port's STEPS steps in one process over the global batches two
    data ranks form. -> (losses, the global batches' channel masks)."""
    cfg = _cfg(db)
    feeders = [Feeder(db, ambi_order=1, audio_rate=cfg.audio_rate, video_rate=cfg.video_rate,
                      context=cfg.context, duration=cfg.sample_dur, return_video=True,
                      img_prep=img_prep_u8, batch_size=BATCH // 2, n_workers=1,
                      for_eval=False, seed=cfg.seed, shard_id=k, num_shards=2).start()
               for k in (0, 1)]
    try:
        iters = [f.batches() for f in feeders]
        batches = []
        for _ in range(STEPS):
            parts = [next(it) for it in iters]
            batches.append({k: torch.from_numpy(np.concatenate([p[k] for p in parts]))
                            for k in parts[0] if k != "id"})
    finally:
        for f in feeders:
            f.stop()
    state = create_train_state(cfg, "cpu")
    losses = [float(train_step(state, b, cfg.lr)["total_loss"]) for b in batches]
    return losses, [b["audio_mask"].numpy() for b in batches]


def test_the_shards_differ_in_layout(one_process):
    for mask in one_process[1]:
        assert mask[: BATCH // 2, 2].tolist() == [0.0, 0.0]       # rank 0: the WXY clip
        assert mask[BATCH // 2:, 2].tolist() == [1.0, 1.0]


def test_spawn_form_matches_one_process(db, one_process, tmp_path):
    model_dir = str(tmp_path / "dp_spawn")
    assert cli_train.main([db, model_dir, *FLAGS, "--n_iters", str(STEPS),
                           "--n_data", "2"]) is None
    np.testing.assert_allclose(_losses(model_dir), one_process[0], rtol=1e-5)
    assert latest_step(model_dir) == STEPS
    assert TrainConfig.load(model_dir).n_data == 2


def test_two_by_two_grid_matches_one_process(db, one_process, tmp_path):
    """--n_data 2 --n_model 2: four ranks, each data rank's model group fed
    by its first rank, audio-fc split in each group; the same global
    batches as the data-parallel runs, so the one-process losses; its
    checkpoint restores in one process with audio-fc whole."""
    model_dir = str(tmp_path / "grid")
    assert cli_train.main([db, model_dir, *FLAGS, "--n_iters", str(STEPS), "--n_data", "2",
                           "--n_model", "2"]) is None
    np.testing.assert_allclose(_losses(model_dir), one_process[0], rtol=1e-5)
    restored = create_train_state(TrainConfig.load(model_dir), "cpu")
    assert restore_checkpoint(model_dir, restored) == STEPS
    assert restored.model.bottleneck.get_submodule("audio-fc").dense.weight.shape[0] == 1024


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start_ranks(db, model_dir, n_iters, *extra):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, "-m", "spatialaudiogen_tpu_torch.cli.train", db, model_dir, *FLAGS,
         "--n_iters", str(n_iters), "--n_data", "2", *extra, "--coordinator",
         f"localhost:{port}", "--n_processes", "2", "--process_id", str(pid)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in (0, 1)]


def _finish(procs, timeout=300) -> list:
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


def test_coordinator_form_matches_one_process(db, one_process, tmp_path):
    model_dir = str(tmp_path / "dp_coord")
    procs = _start_ranks(db, model_dir, STEPS)
    outs = _finish(procs)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {pid}:\n{out[-4000:]}"
    assert "total_loss" not in outs[1]           # rank 1 keeps a no-op logger
    np.testing.assert_allclose(_losses(model_dir), one_process[0], rtol=1e-5)


def test_tensor_parallel_matches_one_process_and_restores(db, tmp_path):
    """--n_data 1 --n_model 2: one feeder, its rows broadcast to the model
    group, audio-fc split over the two ranks; a one-process cli.train on
    the same flags sees the same batches."""
    tp_dir, one_dir = str(tmp_path / "tp"), str(tmp_path / "one")
    flags = [*FLAGS, "--n_iters", str(STEPS)]
    flags[flags.index("--batch_size") + 1] = "2"
    assert cli_train.main([db, tp_dir, *flags, "--n_data", "1", "--n_model", "2"]) is None
    state, _ = cli_train.main([db, one_dir, *flags])
    np.testing.assert_allclose(_losses(tp_dir), _losses(one_dir), rtol=1e-5)
    restored = create_train_state(TrainConfig.load(tp_dir), "cpu")
    assert restore_checkpoint(tp_dir, restored) == STEPS
    fc = restored.model.bottleneck.get_submodule("audio-fc").dense.weight
    assert fc.shape[0] == 1024
    for k, v in load_params(one_dir).items():
        got = restored.model.state_dict()[k]
        assert float((got - v).abs().max()) <= STEPS * 1e-4 + 1e-7, k


def test_tensor_parallel_resumes_a_one_process_checkpoint(db, tmp_path):
    """A one-process checkpoint restores onto two tensor-parallel ranks
    (each cuts its rows of audio-fc and of its Adam moments) and the next
    step equals the one-process resume's."""
    flags = [*FLAGS]
    flags[flags.index("--batch_size") + 1] = "2"
    one_dir = tmp_path / "one"
    cli_train.main([db, str(one_dir), *flags, "--n_iters", "1"])
    tp_dir = tmp_path / "tp"
    shutil.copytree(one_dir, tp_dir)
    resume = [*flags, "--n_iters", "2", "--resume"]
    assert cli_train.main([db, str(tp_dir), *resume, "--n_data", "1", "--n_model", "2"]) is None
    cli_train.main([db, str(one_dir), *resume])
    assert latest_step(str(tp_dir)) == latest_step(str(one_dir)) == 2
    np.testing.assert_allclose(_losses(tp_dir), _losses(one_dir), rtol=1e-5)


def test_killed_rank_fails_the_run(db, tmp_path):
    procs = _start_ranks(db, str(tmp_path / "killed"), 100000)
    try:
        deadline = time.time() + 240
        for line in procs[0].stdout:
            if "total_loss" in line:
                break
            assert time.time() < deadline
        procs[1].kill()
        t0 = time.time()
        procs[0].communicate(timeout=120)
        assert procs[0].returncode != 0
        assert time.time() - t0 < 120
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


def test_sigterm_on_one_rank_stops_both_with_a_checkpoint(db, tmp_path):
    model_dir = str(tmp_path / "stopped")
    procs = _start_ranks(db, model_dir, 100000)
    try:
        deadline = time.time() + 240
        for line in procs[0].stdout:
            if "total_loss" in line:
                break
            assert time.time() < deadline
        procs[1].send_signal(signal.SIGTERM)
        outs = _finish(procs, timeout=120)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs[1][-3000:]
    assert latest_step(model_dir) is not None


def test_a_failing_rank_fails_the_spawn_form(db, tmp_path):
    with pytest.raises(Exception, match="does not split"):
        cli_train.main([db, str(tmp_path / "bad"), *FLAGS, "--n_iters", "1",
                        "--n_data", "2", "--batch_size", "3"])
