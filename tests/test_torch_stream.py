"""The PyTorch port's streaming serving (deploy/stream.py, cli/serve.py)
against the JAX StreamingMonoToAmbix and against the port's own batch-1
deploy.

Two JAX model dirs are written with create_train_state + save_checkpoint
and exported with tools/export_torch_weights.py: audio-only
(separation="none") and audio+video (unet_mask, 8 tracks, 64x128 frames).
A third, audio+video+flow, is written by the port alone (its tests hold
the port to itself). One synthetic clip with frames and flow serves all.
Everything runs on the CPU (the plain K1), torch on one thread.
"""

import os
import shutil
import sys
import time

import jax
import numpy as np
import pytest
import torch

import spatialaudiogen_tpu.deploy.deploy as jax_deploy
import spatialaudiogen_tpu.train.state as jax_state
from spatialaudiogen_tpu.config import TrainConfig
from spatialaudiogen_tpu.data.synthetic import make_synthetic_dataset
from spatialaudiogen_tpu.deploy.stream import StreamingMonoToAmbix as JaxStream
from spatialaudiogen_tpu.models import SptAudioGen as JaxModel
from spatialaudiogen_tpu.train.checkpoint import save_checkpoint
from spatialaudiogen_tpu.train.lr import make_optimizer
from spatialaudiogen_tpu_torch.cli.serve import main as serve_main
from spatialaudiogen_tpu_torch.config import TrainConfig as PortConfig
from spatialaudiogen_tpu_torch.data.readers import (
    AudioChunkReader,
    FlowFrameReader,
    VideoFrameReader,
)
from spatialaudiogen_tpu_torch.deploy.deploy import MonoToAmbix, host_rgb_to_i420
from spatialaudiogen_tpu_torch.deploy.stream import StreamBatcher, StreamingMonoToAmbix
from spatialaudiogen_tpu_torch.models.convert import save_params
from spatialaudiogen_tpu_torch.models.sptaudiogen import SptAudioGen
from spatialaudiogen_tpu_torch.utils.io_audio import load_wav, save_wav

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
from export_torch_weights import export  # noqa: E402

FRAME_HW = (64, 128)
BLOCK = 4800   # 0.1 s: one frame per block, as a live mux pushes


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _jitted_init(create_train_state, states: dict):
    """create_train_state as one jitted program, built once per model
    config. Eager, on XLA:CPU, it compiles every op of the forward on first
    use: about 40 s for this module's two models, against 11 s jitted. The
    JAX engine and the weight export call it only for a restore target's
    structure."""
    def create(model, tx, rng, batch):
        key = repr(model.cfg)
        if key not in states:
            states[key] = jax.jit(lambda r: create_train_state(model, tx, r, batch))(rng)
        return states[key]
    return create


def _jax_model_dir(path: str, db: str, encoders, separation: str) -> str:
    cfg = TrainConfig(db_dir=db, model_dir=path, encoders=encoders, separation=separation,
                      num_sep_tracks=8, frame_hw=FRAME_HW, n_data=1)
    cfg.save()
    g = cfg.model_config().geometry
    example = {"ambix": np.zeros((1, g.snd_size, 4), np.float32),
               "audio_mask": np.ones((1, 4), np.float32)}
    if "video" in encoders:
        example["video"] = np.zeros((1, g.vid_dur) + FRAME_HW + (3,), np.float32)
    state = jax_state.create_train_state(JaxModel(cfg.model_config()), make_optimizer(),
                                         jax.random.PRNGKey(3), example)
    save_checkpoint(path, state, 1)
    export(path)
    return path


@pytest.fixture(scope="module", autouse=True)
def setup(tmp_path_factory):
    """(clip folder, {"audio", "av", "flow": model dir}). The module runs
    torch on one thread: a batch-1 forward is many small ops, and six test
    workers' OpenMP threads otherwise spin each other out."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    patch = pytest.MonkeyPatch()
    init = _jitted_init(jax_state.create_train_state, {})
    for module in (jax_state, jax_deploy):
        patch.setattr(module, "create_train_state", init)
    root = str(tmp_path_factory.mktemp("torchstreamdb"))
    ids = make_synthetic_dataset(root, n_videos=1, duration=4.0, frame_hw=FRAME_HW,
                                 with_flow=True, seed=3)
    models = {
        "audio": _jax_model_dir(str(tmp_path_factory.mktemp("streamaudio")), root,
                                ("audio",), "none"),
        "av": _jax_model_dir(str(tmp_path_factory.mktemp("streamav")), root,
                             ("audio", "video"), "unet_mask")}
    flow_dir = str(tmp_path_factory.mktemp("streamflow"))
    cfg = PortConfig(model_dir=flow_dir, encoders=("audio", "video", "flow"),
                     separation="none", frame_hw=FRAME_HW)
    cfg.save()
    model = SptAudioGen(cfg.model_config(), frame_hw=FRAME_HW)
    save_params(flow_dir, model.init_weights(torch.Generator().manual_seed(4)).state_dict())
    models["flow"] = flow_dir
    yield os.path.join(root, ids[0]), models
    patch.undo()
    torch.set_num_threads(threads)


def _mono_of(clip: str, seconds: float) -> np.ndarray:
    reader = AudioChunkReader(clip + "/ambix", rate=None, ambi_order=1)
    return reader.get(0.0, int(seconds * reader.rate))[:, 0]


def _frames_of(clip: str, n: int) -> list:
    reader = VideoFrameReader(clip + "/video", rate=VideoFrameReader.RAW_RATE,
                              img_prep=lambda x: x)
    return [reader.get_by_index(i / 10.0, 1)[0] for i in range(n)]


def _frame_at(frames: list, i: int):
    return frames[i] if i < len(frames) else None


def _stream_blocks(stream, mono, frames=None, flush=True) -> np.ndarray:
    """Push mono in 0.1 s blocks (one frame each while frames last)."""
    chunks = []
    for i in range(0, len(mono), BLOCK):
        chunks += stream.push(mono[i: i + BLOCK],
                              None if frames is None else _frame_at(frames, i // BLOCK))
    if flush:
        chunks += stream.flush()
    return np.concatenate(chunks, 0)


def _f16_ulp_close(a: np.ndarray, b: np.ndarray, what: str):
    """Each element bitwise equal or one float16 ulp apart at its own
    magnitude, and more than 99.5% bitwise equal (batch-C and batch-1
    forwards sum per lane in another order, ~1e-7 in float32, before the
    float16 fetch rounds)."""
    np.testing.assert_array_equal(a[:, 0], b[:, 0], err_msg=f"{what} mono")
    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float16))
    over = np.abs(a - b) > ulp.astype(np.float32) * (1 + 1e-6)
    assert not over.any(), f"{what}: {over.sum()} elements differ by > 1 f16 ulp"
    assert (a == b).mean() > 0.995, f"{what}: too few bitwise-equal"


# --- the stream against JAX and against batch-1 deploy -------------------

@pytest.mark.parametrize("name", ["audio", "av"])
def test_stream_matches_jax(setup, name):
    """The port's stream and JAX's over the same 0.1 s pushes (one frame
    each for the video model), float32 fetch, then flush: the same chunk
    count, the W passthrough bit for bit. Audio-only: relative L2 below
    1e-5. Audio+video, held as test_torch_deploy.py holds deploy (the
    synthetic frames' flat background makes the visual encoder's
    batch-statistics BatchNorm magnify float32 rounding, and JAX's own
    float32 run is the less exact one): the port within 2e-5 of a float64
    run of the same weights, and within 2.5e-4 of JAX."""
    clip, models = setup
    mono = _mono_of(clip, 1.8)
    frames = _frames_of(clip, 18) if name == "av" else None
    port = _stream_blocks(StreamingMonoToAmbix(models[name], f16_fetch=False, device="cpu"),
                          mono, frames)
    ref = _stream_blocks(JaxStream(models[name], f16_fetch=False), mono, frames)
    assert port.shape == ref.shape == (int(1.3 * 48000), 4)
    np.testing.assert_array_equal(port[:, 0], ref[:, 0])
    if name == "audio":
        assert rel_l2(port[:, 1:], ref[:, 1:]) < 1e-5
        return
    exact = StreamingMonoToAmbix(models[name], f16_fetch=False, device="cpu")
    exact.engine.model.double()
    f64 = _stream_blocks(exact, mono, frames)
    errs = {"port-f64": rel_l2(port[:, 1:], f64[:, 1:]),
            "port-jax": rel_l2(port[:, 1:], ref[:, 1:])}
    assert errs["port-f64"] <= 2e-5 and errs["port-jax"] <= 2.5e-4, errs


@pytest.mark.parametrize("name", ["audio", "av"])
def test_stream_matches_batch1_deploy(setup, name):
    """Bit for bit MonoToAmbix(batch_size=1, yuv_frames=False).deploy() over
    the same span: audio pushed in odd-sized blocks (emission must not
    care), video one frame per 0.1 s block."""
    clip, models = setup
    duration = 1.5 if name == "audio" else 1.0
    ref = MonoToAmbix(models[name], batch_size=1, device="cpu", yuv_frames=False).deploy(
        clip, 0.5, duration)
    stream = StreamingMonoToAmbix(models[name], device="cpu")
    assert abs(stream.algorithmic_latency_s - 0.5) < 1e-3
    mono = _mono_of(clip, 0.5 + duration + 1.2)
    if name == "audio":
        chunks, pos = [], 0
        rng = np.random.RandomState(0)
        while pos < len(mono):
            n = int(rng.randint(1000, 30000))
            chunks += stream.push(mono[pos: pos + n])
            pos += n
        got = np.concatenate(chunks, 0)
    else:
        got = _stream_blocks(stream, mono, _frames_of(clip, 28), flush=False)
    np.testing.assert_array_equal(got[: ref.shape[0]], ref)


def test_stream_flow_route_matches_deploy(setup):
    """Flow configs (audio + video + flow) stream through fwd_windows, the
    forward batch deploy's host route runs: bit for bit the batch-1 deploy
    (RGB normalised in float32 first, as the deploy reader does). An
    (H, W, 2) raw (dx, dy) push derives the magnitude channel."""
    clip, models = setup
    ref = MonoToAmbix(models["flow"], batch_size=1, device="cpu").deploy(clip, 0.5, 1.0)
    stream = StreamingMonoToAmbix(models["flow"], device="cpu")
    mono = _mono_of(clip, 2.7)
    frames = _frames_of(clip, 27)
    reader = FlowFrameReader(clip + "/flow", os.path.join(clip, "flow", "flow_limits.npy"),
                             rate=VideoFrameReader.RAW_RATE)
    chunks = []
    for k in range(0, len(mono), BLOCK):
        flow = reader.get_by_index((k // BLOCK) / 10.0, 1)[0]
        chunks += stream.push(mono[k: k + BLOCK], frames[k // BLOCK], flow=flow)
    got = np.concatenate(chunks, 0)[: ref.shape[0]]
    np.testing.assert_array_equal(got, ref)
    assert stream.video_frames_substituted == stream.flow_frames_substituted == 0

    raw = StreamingMonoToAmbix(models["flow"], device="cpu")
    raw.push(None, flow=flow[..., :2])
    f = raw._session._flows[0]
    np.testing.assert_array_equal(f[..., :2], flow[..., :2])
    np.testing.assert_allclose(f[..., 2], np.hypot(f[..., 0], f[..., 1]), rtol=1e-6)


# --- stream semantics: flush, memory, drops, congestion, I420 ------------

def test_flush_emits_all_output_within_pushed_audio(setup):
    """flush() zero-pads the future context so output covers [0.5 s, T);
    a second flush emits nothing."""
    clip, models = setup
    stream = StreamingMonoToAmbix(models["audio"], device="cpu")
    chunks = stream.push(_mono_of(clip, 3.0)) + stream.flush()
    assert np.concatenate(chunks, 0).shape[0] == int((3.0 - 0.5) * 48000)
    assert stream.flush() == []


def test_stream_memory_bounded(setup):
    """24 s pushed in 1 s blocks through a bounded sample buffer."""
    clip, models = setup
    stream = StreamingMonoToAmbix(models["audio"], device="cpu")
    mono = _mono_of(clip, 4.0)
    for _ in range(6):
        for i in range(0, len(mono), 48000):
            stream.push(mono[i: i + 48000])
    assert len(stream._session._buf) < 8 * stream.geometry.snd_size
    assert len(stream._session._frames) == 0


def test_dropped_frames_do_not_stall(setup):
    """A source that stops delivering frames at t = 0.6 s keeps emitting
    (repeat-last-frame substitution after frame_patience_s)."""
    clip, models = setup
    stream = StreamingMonoToAmbix(models["av"], device="cpu")
    emitted = _stream_blocks(stream, _mono_of(clip, 3.5), _frames_of(clip, 6), flush=False)
    assert emitted.shape[0] >= 15 * 4800
    assert stream.frames_substituted == stream.video_frames_substituted > 0


def test_congestion_stall_catch_up_semantics(setup):
    """A stalled card delays but never drops. The stream with its first two
    forwards stalled emits bit for bit the unstalled run. The batcher,
    ticked only after all pushes, holds the whole backlog, drains every
    window in one tick (within one f16 ulp of the batch-1 stream: another
    batch size), then gc bounds the buffer and nothing is left."""
    clip, models = setup
    mono = _mono_of(clip, 4.0)
    ref = StreamingMonoToAmbix(models["audio"], device="cpu").push(mono)

    stream = StreamingMonoToAmbix(models["audio"], device="cpu")
    real_fwd = stream.engine.fwd_span
    calls = {"n": 0}

    def stalled_fwd(*args):
        calls["n"] += 1
        if calls["n"] <= 2:
            time.sleep(0.2)
        return real_fwd(*args)

    stream.engine.fwd_span = stalled_fwd
    got = []
    for i in range(0, len(mono), BLOCK):
        got += stream.push(mono[i: i + BLOCK])
    assert len(got) == len(ref)
    np.testing.assert_array_equal(np.concatenate(got), np.concatenate(ref))

    b = StreamBatcher(models["audio"], capacity=2, device="cpu")
    sid = b.add_session()
    sess = b._sessions[sid]
    for i in range(0, len(mono), BLOCK):
        b.push(sid, mono[i: i + BLOCK])
    assert len(sess._buf) >= len(mono) - BLOCK
    out = b.tick()
    assert len(out[sid]) == len(ref)
    _f16_ulp_close(np.concatenate(out[sid]), np.concatenate(ref), "catch-up")
    assert len(sess._buf) < 8 * b.geometry.snd_size
    assert b.tick() == {}


def test_stream_i420_frames_track_rgb(setup):
    """(H*3/2, W) I420 planes pushed instead of RGB (the form live 4:2:0
    sources produce). The stream's I420 run (fwd_span's I420 branch)
    within 2.5e-4 (relative L2, float32 fetch) of JAX's I420 stream, the
    audio+video bound of test_stream_matches_jax; it lies within 0.1 of the
    RGB run (chroma subsampling only: this untrained model's visual
    encoder, on batch-1 statistics, turns it into 6%, JAX's alike); the W
    passthrough is the same. A capacity-1 batcher fed the planes
    (video_input's I420 branch) equals the I420 stream bit for bit."""
    clip, models = setup
    mono = _mono_of(clip, 1.5)
    frames = _frames_of(clip, 15)
    planes = [host_rgb_to_i420(f[None])[0] for f in frames]
    rgb, yuv = (_stream_blocks(StreamingMonoToAmbix(models["av"], f16_fetch=False,
                                                    device="cpu"), mono, f)
                for f in (frames, planes))
    ref = _stream_blocks(JaxStream(models["av"], f16_fetch=False), mono, planes)
    assert rgb.shape == yuv.shape == ref.shape
    np.testing.assert_array_equal(rgb[:, 0], yuv[:, 0])
    assert rel_l2(yuv[:, 1:], ref[:, 1:]) <= 2.5e-4
    assert rel_l2(yuv[:, 1:], rgb[:, 1:]) < 0.1

    b = StreamBatcher(models["av"], capacity=1, f16_fetch=False, device="cpu")
    sid = b.add_session()
    got = []
    for i in range(0, len(mono), BLOCK):
        b.push(sid, mono[i: i + BLOCK], planes[i // BLOCK])
        got += b.tick().get(sid, [])
    got += b.flush(sid).get(sid, [])
    np.testing.assert_array_equal(np.concatenate(got, 0), yuv)


# --- the batcher ----------------------------------------------------------

def test_stream_batcher_lane_isolation_is_bitwise(setup):
    """Audio-only: a session's output through a capacity-4 batcher is bit
    for bit the same alone and packed with three noise neighbours."""
    clip, models = setup
    mono = _mono_of(clip, 3.0)

    def run(n_neighbours):
        b = StreamBatcher(models["audio"], capacity=4, device="cpu")
        sid = b.add_session()
        others = [b.add_session() for _ in range(n_neighbours)]
        rng = np.random.RandomState(7)
        out = []
        for i in range(0, len(mono), 9600):
            b.push(sid, mono[i: i + 9600])
            for o in others:
                b.push(o, rng.randn(9600).astype(np.float32) * 0.2)
            out += b.tick().get(sid, [])
        return out

    alone, packed = run(0), run(3)
    assert len(alone) == len(packed) > 10
    np.testing.assert_array_equal(np.concatenate(alone), np.concatenate(packed))


def test_stream_batcher_matches_independent_streams(setup):
    """Four audio-only sessions through one capacity-4 batcher against four
    independent batch-1 streams, within one f16 ulp per element (see
    _f16_ulp_close): staggered signals, odd-sized blocks, the fourth joins
    mid-run. Then one leaves, and a new session reuses its lane: its first
    windows match that signal's stream the same way."""
    clip, models = setup
    mono = _mono_of(clip, 4.0)
    signals = [np.roll(mono, -off)[: len(mono) - 48000] for off in (0, 7000, 48000, 3)]
    ref = []
    for sig in signals:
        s = StreamingMonoToAmbix(models["audio"], device="cpu")
        ref.append(s.push(sig) + s.flush())

    batcher = StreamBatcher(models["audio"], capacity=4, device="cpu")
    sids = [batcher.add_session() for _ in range(3)]
    got = {i: [] for i in range(4)}
    rng = np.random.RandomState(1)
    pos = 0
    while pos < len(signals[0]):
        n = int(rng.randint(3000, 20000))
        for i, sid in enumerate(sids):
            batcher.push(sid, signals[i][pos: pos + n])
        pos += n
        if len(sids) == 3 and pos > 60000:
            sids.append(batcher.add_session())   # join mid-run
            batcher.push(sids[3], signals[3][:pos])
        for sid, chunks in batcher.tick().items():
            got[sids.index(sid)].extend(chunks)
    for sid in sids:
        for k, v in batcher.flush(sid).items():
            got[sids.index(k)].extend(v)
    for i in range(4):
        assert len(got[i]) == len(ref[i]), (i, len(got[i]), len(ref[i]))
        _f16_ulp_close(np.concatenate(got[i]), np.concatenate(ref[i]), f"session {i}")

    lane = batcher._lane_of[sids[0]]
    batcher.remove_session(sids[0])
    assert batcher.n_sessions == 3
    assert not batcher._buf[lane].any()      # the freed lane is zeroed
    sid_new = batcher.add_session()
    assert batcher._lane_of[sid_new] == lane
    batcher.push(sid_new, signals[0][:100000])
    out = batcher.tick()[sid_new]
    assert len(out) >= 9
    _f16_ulp_close(np.concatenate(out), np.concatenate(ref[0][: len(out)]), "reused lane")


def test_stream_batcher_video_capacity1_matches_stream(setup):
    """Video lanes share the visual encoder's batch statistics, so only a
    capacity-1 batcher can be held to the batch-1 stream: bit for bit."""
    clip, models = setup
    mono = _mono_of(clip, 2.5)
    frames = _frames_of(clip, 25)
    ref = _stream_blocks(StreamingMonoToAmbix(models["av"], device="cpu"), mono, frames,
                         flush=False)
    b = StreamBatcher(models["av"], capacity=1, device="cpu")
    sid = b.add_session()
    got = []
    for i in range(0, len(mono), BLOCK):
        b.push(sid, mono[i: i + BLOCK], frames[i // BLOCK])
        got += b.tick().get(sid, [])
    np.testing.assert_array_equal(np.concatenate(got), ref)


def test_stream_batcher_refuses_flow_configs(setup):
    _, models = setup
    with pytest.raises(AssertionError, match="flow configs"):
        StreamBatcher(models["flow"], capacity=2, device="cpu")


class _CudnnLog(torch.overrides.TorchFunctionMode):
    """Records torch.backends.cudnn.deterministic at every convolution."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") in ("conv2d", "conv_transpose2d"):
            self.seen.append((func.__name__, torch.backends.cudnn.deterministic))
        return func(*args, **(kwargs or {}))


def test_serving_forwards_run_deterministic_cudnn(setup):
    """The U-Net's transposed convolutions run cuDNN backward-data
    algorithms, some of which sum with atomics: the stream's window
    forward (fwd_span), the flow route's (fwd_windows), the batcher's
    tick and the batch deploy all convolve with cudnn.deterministic on,
    and restore the switch they found."""
    clip, models = setup
    mono = _mono_of(clip, 1.2)
    frames = _frames_of(clip, 12)
    flow = np.zeros(FRAME_HW + (2,), np.float32)
    runs = {
        "stream": lambda: _stream_blocks(StreamingMonoToAmbix(models["av"], device="cpu"),
                                         mono, frames, flush=False),
        "flow": lambda: _stream_blocks(_WithFlow(models["flow"], flow), mono, frames,
                                       flush=False),
        "batcher": lambda: _stream_blocks(_OneLane(models["av"]), mono, frames, flush=False),
        "deploy": lambda: MonoToAmbix(models["av"], batch_size=2, device="cpu").deploy(
            clip, 0.5, 0.2)}
    for name, run in runs.items():
        log = _CudnnLog()
        with log:
            run()
        assert not torch.backends.cudnn.deterministic, name
        kinds = {kind for kind, _ in log.seen}
        assert "conv_transpose2d" in kinds or name == "flow", (name, kinds)  # flow: no U-Net
        assert log.seen and all(on for _, on in log.seen), (name, log.seen[:3])


class _WithFlow:
    """The stream with the same flow map pushed beside every frame."""

    def __init__(self, model_dir, flow):
        self.stream = StreamingMonoToAmbix(model_dir, device="cpu")
        self.flow = flow

    def push(self, samples, frame=None):
        return self.stream.push(samples, frame, self.flow)


class _OneLane:
    """A capacity-1 StreamBatcher behind the stream's push()/flush()."""

    def __init__(self, model_dir):
        self.batcher = StreamBatcher(model_dir, capacity=1, device="cpu")
        self.sid = self.batcher.add_session()

    def push(self, samples, frame=None):
        self.batcher.push(self.sid, samples, frame)
        return self.batcher.tick().get(self.sid, [])


# --- cli.serve ------------------------------------------------------------

def _write_wav(path, signal) -> str:
    save_wav(str(path), signal[:, None], 48000, subtype="float32")
    return str(path)


@pytest.mark.parametrize("mode", ["audio", "video-jpgs", "video-pack"])
def test_serve_cli_single_matches_library(setup, tmp_path, mode):
    """cli.serve over a float32 wav (and a frames dir: jpgs, or a packed
    copy of the clip) equals the library stream over the same 0.1 s blocks,
    up to the output wav's PCM16 rounding (1.1/32768)."""
    from spatialaudiogen_tpu.data.packed import pack_video

    clip, models = setup
    name = "audio" if mode == "audio" else "av"
    mono = _mono_of(clip, 1.5)
    argv = [models[name], _write_wav(tmp_path / "in.wav", mono), str(tmp_path / "out.wav"),
            "--device", "cpu"]
    frames = None
    if mode != "audio":
        frames = _frames_of(clip, 15)
        frames_dir = clip + "/video"
        if mode == "video-pack":
            frames_dir = str(tmp_path / "packed_clip")
            shutil.copytree(clip, frames_dir)
            pack_video(frames_dir)
        argv += ["--frames_dir", frames_dir]
    summary = serve_main(argv)
    got, rate = load_wav(str(tmp_path / "out.wav"), dtype=np.float32)
    want = _stream_blocks(StreamingMonoToAmbix(models[name], device="cpu"), mono, frames)
    assert rate == 48000 and got.shape == want.shape == (48000, 4)
    np.testing.assert_allclose(got, want, atol=1.1 / 32768)
    assert summary["served_s"] == 1.0 and len(summary["latency_s"]) == 5


@pytest.mark.parametrize("name", ["audio", "av"])
def test_serve_cli_batched_matches_library(setup, tmp_path, name):
    """Comma-separated inputs share one StreamBatcher: each output equals a
    library capacity-2 batcher fed the same blocks and frames (per-input
    --frames_dir for the video model; its lanes share batch statistics, so
    the batch-1 stream is no oracle there), up to PCM16 rounding."""
    clip, models = setup
    mono = _mono_of(clip, 1.5)
    sigs = [mono, np.roll(mono, -4800)]
    ins = ",".join(_write_wav(tmp_path / f"in{i}.wav", s) for i, s in enumerate(sigs))
    outs = [str(tmp_path / f"out{i}.wav") for i in range(2)]
    argv = [models[name], ins, ",".join(outs), "--device", "cpu"]
    frames = _frames_of(clip, 15) if name == "av" else None
    if frames is not None:
        argv += ["--frames_dir", f"{clip}/video,{clip}/video"]
    serve_main(argv)

    b = StreamBatcher(models[name], capacity=2, device="cpu")
    sids = [b.add_session(), b.add_session()]
    ref = {sid: [] for sid in sids}
    for k in range(0, len(mono), BLOCK):
        for i, sid in enumerate(sids):
            b.push(sid, sigs[i][k: k + BLOCK], None if frames is None else frames[k // BLOCK])
        for sid, chunks in b.tick().items():
            ref[sid].extend(chunks)
    for sid in sids:
        for k, v in b.flush(sid).items():
            ref[k].extend(v)
    for out_fn, sid in zip(outs, sids):
        got, _ = load_wav(out_fn, dtype=np.float32)
        want = np.concatenate(ref[sid], 0)
        assert got.shape == want.shape == (48000, 4)
        np.testing.assert_allclose(got, want, atol=1.1 / 32768)


def test_serve_cli_refuses_n_data(setup, tmp_path):
    """--n_data shards the multi-session batcher (tests/test_torch_sharded.py):
    on one session, or on a session count it does not divide, it raises
    ValueError before any model is loaded (the inputs do not exist)."""
    _, models = setup
    for inputs in ("in.wav", "a.wav,b.wav,c.wav"):
        outputs = inputs.replace("in", "out").replace(".wav", "_out.wav")
        with pytest.raises(ValueError, match="n_data"):
            serve_main([models["audio"], inputs, outputs, "--n_data", "2", "--device", "cpu"])
