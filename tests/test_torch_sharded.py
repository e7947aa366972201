"""The port's sharded inference on two gloo CPU ranks: deploy
(MonoToAmbix(mesh=), cli.deploy --n_data), eval (Evaluator(mesh=),
cli.eval --n_data) and serving (StreamBatcher(mesh=), cli.serve
--n_data), against the port in one process and against the JAX package's
engines on a (2, 1) mesh of the conftest's virtual CPU devices.

Two model dirs with the JAX package's initialisation, exported with
tools/export_torch_weights.py: the reduced flagship (audio + video,
unet_mask with 8 tracks, 64x128 frames; the visual encoder's
batch-statistics BatchNorm takes its moments over both ranks' rows) and
an audio-only one (separation "none": lanes independent, no collective in
the forward). One synthetic dataset of two 3 s clips serves all:

  * deploy at batch 4 over 1 s of the first clip (10 windows: batches of
    4, 4 and 2), so the tail batch's two pad lanes are rank 1's whole
    block, on the on-device gather and on the host route;
  * eval at batch 6 over the four eval samples, so the one batch's two
    zero pad lanes sit in rank 1's block of three rows, in exact mode and
    with the fully on-device battery (--device_metrics --emd sinkhorn);
  * serving: four sessions at capacity 4, two lanes a rank, over 1.6 s
    of the clip's mono rolled four ways, f32 fetch.

The ranks (tests/torch_infer_worker.py) start once for the module and run
while the JAX engines and the one-process port run here.
"""

import os
import shutil
import types

import numpy as np
import pytest
import torch
from jax_model_dirs import FRAME_HW, jax_model_dir, jitted_init
from torch_infer_worker import batcher_outputs, deploy_outputs, start_ranks, wait_ranks

import spatialaudiogen_tpu.deploy.deploy as jax_deploy
from spatialaudiogen_tpu.data.synthetic import make_synthetic_dataset
from spatialaudiogen_tpu.deploy.stream import StreamBatcher as JaxStreamBatcher
from spatialaudiogen_tpu.eval.evaluator import Evaluator as JaxEvaluator
from spatialaudiogen_tpu.parallel.mesh import make_mesh as jax_make_mesh
from spatialaudiogen_tpu.utils.io_audio import load_wav
from spatialaudiogen_tpu_torch.cli.deploy import main as deploy_main
from spatialaudiogen_tpu_torch.cli.eval import main as eval_main
from spatialaudiogen_tpu_torch.cli.serve import main as serve_main
from spatialaudiogen_tpu_torch.data.readers import AudioChunkReader, VideoFrameReader
from spatialaudiogen_tpu_torch.deploy.deploy import MonoToAmbix
from spatialaudiogen_tpu_torch.eval.evaluator import ALL_METRICS
from spatialaudiogen_tpu_torch.parallel.mesh import Mesh, row_block
from spatialaudiogen_tpu_torch.utils.io_audio import save_wav

# deploy
START, DURATION, BATCH = 0.5, 1.0, 4
DEPLOY_FLAGS = ["--batch_size", str(BATCH), "--deploy_start", str(START),
                "--deploy_duration", str(DURATION), "--rgb_frames", "--f32_fetch",
                "--save_ambix", "--device", "cpu"]
# eval
EVAL_BATCH = 6
N_SAMPLES = 4
EVAL_MODES = {"exact": [], "device": ["--device_metrics", "--emd", "sinkhorn"]}
# the JAX side's EMD solver per mode (its other device metrics are not compared)
JAX_EMD = {"exact": "exact", "device": "sinkhorn"}
# serving
SERVE_SECONDS = 1.6
CAPACITY = 4
OFFSETS = (0, 5000, 48000, 17)
SERVE_MODELS = ("audio", "av")


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def read_rows(fn: str) -> list:
    """[(sample id, {metric: value})] of an eval-detailed file, in order."""
    lines = open(fn).read().splitlines()
    assert lines[0] == "SampleID | " + " ".join(ALL_METRICS)
    rows = []
    for line in lines[1:]:
        sid, vals = line.split(" | ")
        rows.append((sid, dict(zip(ALL_METRICS, map(float, vals.split())))))
    return rows


def sessions_npz(path: str, clip: str, with_frames: bool) -> str:
    """The serving sessions' signals (and the clip's 10 fps frames)."""
    reader = AudioChunkReader(clip + "/ambix", rate=None, ambi_order=1)
    mono = reader.get(0.0, int(SERVE_SECONDS * reader.rate))[:, 0]
    frames = np.zeros((0,), np.uint8)
    if with_frames:
        video = VideoFrameReader(clip + "/video", rate=VideoFrameReader.RAW_RATE,
                                 img_prep=lambda x: x)
        frames = np.stack([video.get_by_index(i / 10.0, 1)[0]
                           for i in range(int(SERVE_SECONDS * 10))])
    np.savez(path, signals=np.stack([np.roll(mono, -off) for off in OFFSETS]),
             frames=frames)
    return path


def jax_batcher(model_dir: str, sessions: str) -> dict:
    """tests/test_stream.py's mesh batcher over batcher_outputs' sessions."""
    data = np.load(sessions)
    signals, frames = data["signals"], data["frames"]
    b = JaxStreamBatcher(model_dir, capacity=CAPACITY, f16_fetch=False,
                         mesh=jax_make_mesh(n_data=2, n_model=1))
    sids = [b.add_session() for _ in signals]
    got = {sid: [] for sid in sids}
    block = b.geometry.snd_dur
    for k in range(0, signals.shape[1] - block + 1, block):
        for i, sid in enumerate(sids):
            b.push(sid, signals[i][k: k + block], frames[k // block] if len(frames) else None)
        for sid, chunks in b.tick().items():
            got[sid].extend(chunks)
    for sid in sids:
        for k, v in b.flush(sid).items():
            got[k].extend(v)
    return {f"s{i}": np.concatenate(got[sid], 0) for i, sid in enumerate(sids)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run's results: {"deploy": {side: ...}, "wav": {n_data: ...},
    "eval": {(side, mode): rows}, "eval_files": [...], "serve": {(side,
    model): chunks}, "serve_wav": {n_data: [...]}}, side in sharded / one
    / jax."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    root = str(tmp_path_factory.mktemp("shardeddb"))
    make_synthetic_dataset(root, n_videos=2, duration=3.0, frame_hw=FRAME_HW, seed=3)
    clip = os.path.join(root, "synth000")
    out = str(tmp_path_factory.mktemp("shardedout"))
    r = {}
    with jitted_init():
        dirs = {"av": jax_model_dir(str(tmp_path_factory.mktemp("shardedav")), root),
                "audio": jax_model_dir(str(tmp_path_factory.mktemp("shardedaudio")), root,
                                       ("audio",), "none")}
        eval_one_dir = os.path.join(out, "eval_one_model")
        shutil.copytree(dirs["av"], eval_one_dir)
        sessions = {name: sessions_npz(os.path.join(out, f"{name}.npz"), clip, name == "av")
                    for name in SERVE_MODELS}
        ins = [os.path.join(out, f"in{i}.wav") for i in range(len(OFFSETS))]
        for fn, sig in zip(ins, np.load(sessions["audio"])["signals"]):
            save_wav(fn, sig[:, None], 48000)
        serve_outs = {n: [os.path.join(out, f"serve{n}_{i}.wav") for i in range(len(ins))]
                      for n in (1, 2)}
        deploy_args = dict(model_dir=dirs["av"], clip=clip, start=START, duration=DURATION,
                           batch=BATCH)
        eval_flags = ["--db_dir", root, "--batch_size", str(EVAL_BATCH), "--n_workers", "1",
                      "--emd_ang_res", "36", "--overwrite", "--device", "cpu"]
        detailed = os.path.join(dirs["av"], "eval-detailed.txt")
        tasks = [
            ["deploy", {"args": deploy_args, "out": os.path.join(out, "deploy.npz")}],
            ["deploy", {"args": deploy_args, "out": os.path.join(out, "deploy_nccl.npz"),
                        "as_nccl": True}],
            ["cli", {"module": "spatialaudiogen_tpu_torch.cli.deploy",
                     "argv": [dirs["av"], clip, "--n_data", "2", "--output_fn",
                              os.path.join(out, "deploy2")] + DEPLOY_FLAGS}]]
        tasks += [["cli", {"module": "spatialaudiogen_tpu_torch.cli.eval",
                           "argv": [dirs["av"], "--n_data", "2"] + eval_flags + extra,
                           "copy": [[detailed, os.path.join(out, f"eval-{mode}.txt")]]}]
                  for mode, extra in EVAL_MODES.items()]
        tasks += [["batcher", {"args": {"model_dir": dirs[name], "sessions": sessions[name],
                                        "capacity": CAPACITY},
                               "out": os.path.join(out, f"serve-{name}.npz")}]
                  for name in SERVE_MODELS]
        tasks.append(["cli", {"module": "spatialaudiogen_tpu_torch.cli.serve",
                              "argv": [dirs["audio"], ",".join(ins), ",".join(serve_outs[2]),
                                       "--n_data", "2", "--device", "cpu"]}])
        procs = start_ranks(out, tasks)
        try:
            jengine = jax_deploy.MonoToAmbix(dirs["av"], batch_size=BATCH, f16_fetch=False,
                                             mesh=jax_make_mesh(n_data=2, n_model=1))
            jdeploy = {"ambi": jengine.deploy(clip, START, DURATION)}
            jdeploy["host_mono"], jdeploy["host_pred"] = jengine._predict_span_host(
                clip, START, DURATION)
            r["deploy"] = {"jax": jdeploy, "one": deploy_outputs(**deploy_args)}
            deploy_main([dirs["av"], clip, "--n_data", "1", "--output_fn",
                         os.path.join(out, "deploy1")] + DEPLOY_FLAGS)
            r["eval"] = {}
            for mode, extra in EVAL_MODES.items():
                eval_main([eval_one_dir, "--n_data", "1"] + eval_flags + extra)
                r["eval"]["one", mode] = read_rows(
                    os.path.join(eval_one_dir, "eval-detailed.txt"))
                fn = os.path.join(out, f"eval-jax-{mode}.txt")
                JaxEvaluator(dirs["av"], batch_size=EVAL_BATCH, db_dir=root, n_workers=1,
                             emd_ang_res=36, emd_mode=JAX_EMD[mode],
                             mesh=jax_make_mesh(n_data=2, n_model=1)).run(
                    output_fn=fn, host_threads=2, print_every=0)
                r["eval"]["jax", mode] = read_rows(fn)
            r["serve"] = {}
            for name in SERVE_MODELS:
                r["serve"]["one", name] = batcher_outputs(dirs[name], sessions[name], CAPACITY)
                r["serve"]["jax", name] = jax_batcher(dirs[name], sessions[name])
            serve_main([dirs["audio"], ",".join(ins), ",".join(serve_outs[1]), "--n_data",
                        "1", "--device", "cpu"])
        finally:
            wait_ranks(procs)
    r["deploy"]["sharded"] = dict(np.load(os.path.join(out, "deploy.npz")))
    r["deploy"]["sharded_nccl_route"] = dict(np.load(os.path.join(out, "deploy_nccl.npz")))
    r["wav"] = {n: load_wav(os.path.join(out, f"deploy{n}.wav"))[0] for n in (1, 2)}
    for mode in EVAL_MODES:
        r["eval"]["sharded", mode] = read_rows(os.path.join(out, f"eval-{mode}.txt"))
    r["eval_files"] = sorted(f for f in os.listdir(dirs["av"]) if f.startswith("eval-"))
    for name in SERVE_MODELS:
        r["serve"]["sharded", name] = dict(np.load(os.path.join(out, f"serve-{name}.npz")))
    r["serve_wav"] = {n: [load_wav(fn)[0] for fn in fns] for n, fns in serve_outs.items()}
    yield r
    torch.set_num_threads(threads)
    for path in (*dirs.values(), out):      # model dirs hold 100 MB checkpoints
        shutil.rmtree(path, ignore_errors=True)


# --- deploy ---------------------------------------------------------------------

def test_sharded_deploy_matches_one_process(runs):
    """Two ranks = one process, as the JAX engine's mesh deploy is held to
    its single device (tests/test_deploy.py): the W passthrough bit for bit,
    the predictions within 1e-5 (float32 moments summed over the ranks in
    another order)."""
    got, want = runs["deploy"]["sharded"]["ambi"], runs["deploy"]["one"]["ambi"]
    assert got.shape == want.shape == (int(DURATION * 48000), 4)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_card_per_rank_route_matches_the_gloo_route(runs):
    """With a card per rank (NCCL) the blocks are gathered before the copy
    back and only rank 0 copies (MonoToAmbix._copy_back); that route, its
    collectives run over gloo here, gives the gloo route's bits on both
    deploy routes."""
    got, want = runs["deploy"]["sharded_nccl_route"], runs["deploy"]["sharded"]
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_sharded_host_route_matches_one_process(runs):
    """The per-window host route (_predict_span_host, the flow configs')
    shards the same way: mono bit for bit, predictions within 1e-5."""
    got, want = runs["deploy"]["sharded"], runs["deploy"]["one"]
    np.testing.assert_array_equal(got["host_mono"], want["host_mono"])
    np.testing.assert_allclose(got["host_pred"], want["host_pred"], atol=1e-5)


@pytest.mark.parametrize("route", ["ondevice", "host"])
def test_sharded_deploy_matches_jax_mesh(runs, route):
    """Both routes against the JAX engine on its (2, 1) mesh, within the
    port-vs-JAX bound of tests/test_torch_deploy.py (2.5e-4 relative L2:
    the JAX engine's own float32 error on such clips is about 1.2e-4)."""
    got, want = runs["deploy"]["sharded"], runs["deploy"]["jax"]
    if route == "ondevice":
        got, want = got["ambi"], want["ambi"]
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
        got, want = got[:, 1:], want[:, 1:]
    else:
        np.testing.assert_array_equal(got["host_mono"], want["host_mono"])
        got, want = got["host_pred"], want["host_pred"]
    assert got.shape == want.shape and np.isfinite(got).all()
    assert rel_l2(got, want) <= 2.5e-4


def test_deploy_cli_n_data_writes_the_one_process_wav(runs):
    """cli.deploy --n_data 2 --save_ambix writes one wav, rank 0's, equal to
    --n_data 1's up to PCM16 rounding (1.5/32768)."""
    wav = runs["wav"]
    assert wav[2].shape == wav[1].shape == (int(DURATION * 48000), 4)
    np.testing.assert_allclose(wav[2], wav[1], rtol=0, atol=1.5 / 32768)


def test_local_span_of_a_tail_batch():
    """Rank 1's block of a tail batch with two real windows: its offsets
    are all pad lanes (-1), its frames its rows; rank 0 keeps the real
    windows' sub-span, offsets made relative to it."""
    g = types.SimpleNamespace(snd_size=100)
    span = np.arange(400, dtype=np.float32)[:, None]
    rel = np.array([7, 57, -1, -1])
    video = np.arange(4)[:, None]
    for rank, (want_rel, want_span, want_video) in enumerate(
            [([0, 50], span[7:157], [[0], [1]]), ([-1, -1], span[0:100], [[2], [3]])]):
        mesh = Mesh(n_data=2, rank=rank, data_group=object())
        engine = types.SimpleNamespace(mesh=mesh, geometry=g, _rows=row_block(BATCH, mesh))
        got_span, got_rel, got_video = MonoToAmbix._local_span(engine, span, rel, video)
        np.testing.assert_array_equal(got_rel, want_rel)
        np.testing.assert_array_equal(got_span, want_span)
        np.testing.assert_array_equal(got_video, want_video)


@pytest.mark.parametrize("n_rows, rank, want", [(4, 0, (0, 2)), (4, 1, (2, 4)),
                                                (32, 1, (16, 32))])
def test_row_block_is_p_data(n_rows, rank, want):
    """P('data'): rank d of N holds rows [d*n/N, (d+1)*n/N); indivisible
    batches raise."""
    mesh = Mesh(n_data=2, rank=rank, data_group=object())
    block = row_block(n_rows, mesh)
    assert (block.start, block.stop) == want
    assert row_block(n_rows, None) == slice(0, n_rows)
    with pytest.raises(ValueError, match="divide"):
        row_block(3, mesh)


# --- eval -----------------------------------------------------------------------

def summary(rows: list) -> dict:
    return {m: float(np.mean([rec[m] for _, rec in rows])) for m in ALL_METRICS}


@pytest.mark.parametrize("mode", list(EVAL_MODES))
def test_sharded_eval_file_is_the_one_process_file(runs, mode):
    """One eval-detailed.txt with the one process's sample ids in its
    order, and every column within rtol 1e-4 / atol 1e-6 of it (the ranks
    sum the BatchNorm moments in another order; EMD at rtol 1e-3 / atol
    1e-5, the summary's bound: the exact solver's flow can move with its
    inputs)."""
    rows = runs["eval"]
    got, want = rows["sharded", mode], rows["one", mode]
    assert [sid for sid, _ in got] == [sid for sid, _ in want]
    assert len(got) == N_SAMPLES
    for (sid, g), (_, w) in zip(got, want):
        for m in ALL_METRICS:
            rtol, atol = (1e-3, 1e-5) if m.startswith("emd/") else (1e-4, 1e-6)
            np.testing.assert_allclose(g[m], w[m], rtol=rtol, atol=atol,
                                       err_msg=f"{mode} {sid} {m}")


@pytest.mark.parametrize("mode", list(EVAL_MODES))
@pytest.mark.parametrize("other", ["one", "jax"])
def test_sharded_eval_summary(runs, mode, other):
    """The sharded summary against one process and against the JAX
    Evaluator on its (2, 1) mesh, as tests/test_eval.py holds the JAX mesh
    to one device: rel 1e-3, abs 1e-5 on stft/avg, mse/avg, emd/dir."""
    got, want = summary(runs["eval"]["sharded", mode]), summary(runs["eval"][other, mode])
    for key in ("stft/avg", "mse/avg", "emd/dir"):
        assert got[key] == pytest.approx(want[key], rel=1e-3, abs=1e-5), key


def test_sharded_eval_writes_one_file(runs):
    """Rank 0 alone writes, and without multi-host shards no .shard{K}
    suffix: the model dir holds one eval-detailed.txt."""
    assert runs["eval_files"] == ["eval-detailed.txt"]


def test_sharded_eval_device_mode_matches_exact_mode(runs):
    """The two sharded modes agree as one process's do
    (tests/test_torch_eval.py): EMD rtol 5e-3 / atol 5e-4, the rest rtol
    1e-4 / atol 1e-5."""
    rows = runs["eval"]
    for (sid, d), (_, e) in zip(rows["sharded", "device"], rows["sharded", "exact"]):
        for m in ALL_METRICS:
            rtol, atol = (5e-3, 5e-4) if m.startswith("emd/") else (1e-4, 1e-5)
            np.testing.assert_allclose(d[m], e[m], rtol=rtol, atol=atol, err_msg=f"{sid} {m}")


# --- serving --------------------------------------------------------------------

@pytest.mark.parametrize("name", SERVE_MODELS)
@pytest.mark.parametrize("other", ["one", "jax"])
def test_sharded_batcher(runs, name, other):
    """Every session's chunks: the mono column bit for bit, the predictions
    within 1e-5 of the one-process batcher and of the JAX mesh batcher
    (tests/test_stream.py's bound: shardings reorder per-lane reductions
    by about 1e-6)."""
    got, want = runs["serve"]["sharded", name], runs["serve"][other, name]
    assert sorted(got) == sorted(want) == [f"s{i}" for i in range(len(OFFSETS))]
    for key in want:
        assert got[key].shape == want[key].shape and got[key].shape[0] >= 5 * 4800
        np.testing.assert_array_equal(got[key][:, 0], want[key][:, 0])
        np.testing.assert_allclose(got[key], want[key], atol=1e-5, err_msg=f"{name} {key}")


def test_serve_cli_n_data_writes_the_one_process_wavs(runs):
    """cli.serve --n_data 2 with four inputs writes four wavs, rank 0's,
    equal to --n_data 1's up to PCM16 rounding (1.5/32768): the audio-only
    model's lanes are independent, so each lane's float16 predictions are
    the same."""
    wavs = runs["serve_wav"]
    assert len(wavs[2]) == len(wavs[1]) == len(OFFSETS)
    for got, want in zip(wavs[2], wavs[1]):
        assert got.shape == want.shape and got.shape[1] == 4
        np.testing.assert_allclose(got, want, rtol=0, atol=1.5 / 32768)
