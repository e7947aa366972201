"""The port's own copies of the JAX package's host modules (geometry, STFT
framing helpers, rotations, wav I/O, readers, packed readers, feeder)
against the originals: the same inputs give the same outputs, bit for bit.
"""

import dataclasses
import importlib
import itertools
import os
import threading
import time

import numpy as np
import pytest
import torch

from spatialaudiogen_tpu.ambisonics import rotation as jax_rotation
from spatialaudiogen_tpu.data import packed as jax_packed
from spatialaudiogen_tpu.data.pipeline import Feeder as JaxFeeder
from spatialaudiogen_tpu.data.readers import SampleReader as JaxSampleReader
from spatialaudiogen_tpu.data.readers import img_prep_u8 as jax_img_prep_u8
from spatialaudiogen_tpu.data.synthetic import make_synthetic_dataset
from spatialaudiogen_tpu.dsp import geometry as jax_geometry
from spatialaudiogen_tpu.utils import io_audio as jax_io_audio
from spatialaudiogen_tpu_torch.ambisonics import rotation
from spatialaudiogen_tpu_torch.data.generic import BackgroundGenerator
from spatialaudiogen_tpu_torch.data.pipeline import Feeder, device_prefetch
from spatialaudiogen_tpu_torch.data.readers import SampleReader, img_prep_u8
from spatialaudiogen_tpu_torch.dsp import geometry
from spatialaudiogen_tpu_torch.utils import io_audio

# each package's dsp/__init__ re-exports a function named `stft`
jax_stft = importlib.import_module("spatialaudiogen_tpu.dsp.stft")
stft = importlib.import_module("spatialaudiogen_tpu_torch.dsp.stft")


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    """Two synthetic clips in the reference layout; the second also packed."""
    root = str(tmp_path_factory.mktemp("torchdb"))
    ids = make_synthetic_dataset(root, n_videos=2, duration=3.0, frame_hw=(64, 128), seed=3)
    jax_packed.pack_video(os.path.join(root, sorted(ids)[1]))
    return root, sorted(ids)


@pytest.mark.parametrize("kw", [
    {},
    {"ambi_order": 2, "sample_duration": 0.2},
    {"audio_rate": 44100, "video_rate": 10, "context": 2.0, "fft_window": 0.02},
])
def test_geometry_copy_matches(kw):
    mine, ref = geometry.ModelGeometry(**kw), jax_geometry.ModelGeometry(**kw)
    names = [n for n, v in vars(type(ref)).items() if isinstance(v, property)]
    names += [f.name for f in dataclasses.fields(ref)]
    for name in names:
        assert getattr(mine, name) == getattr(ref, name), name
    assert mine.chunk_start_sample(1.4) == ref.chunk_start_sample(1.4)


def test_stft_helpers_copy_matches():
    for n in (1024, 1200, 2048):
        np.testing.assert_array_equal(stft.hann_window(n), jax_stft.hann_window(n))
    assert stft.frame_count(52799, 1024, 4) == jax_stft.frame_count(52799, 1024, 4)
    x = np.random.RandomState(0).randn(2, 4800, 3).astype(np.float32)
    want, wwin = jax_stft.loss_frame_windows(x, 1200, 2)
    got, gwin = stft.loss_frame_windows(torch.from_numpy(x), 1200, 2)
    assert gwin == wwin
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("order", [1, 2])
def test_rotation_copy_matches(order):
    chunk = np.random.RandomState(order).randn(100, (order + 1) ** 2).astype(np.float32)
    np.testing.assert_array_equal(rotation.rotate_ambisonics(chunk, 0.7),
                                  jax_rotation.rotate_ambisonics(chunk, 0.7))


def test_io_audio_copy_matches(tmp_path):
    data = np.random.RandomState(1).uniform(-0.9, 0.9, (4800, 4))
    fn = str(tmp_path / "a.wav")
    io_audio.save_wav(fn, data, 48000)
    want, wrate = jax_io_audio.load_wav(fn)
    got, grate = io_audio.load_wav(fn)
    assert grate == wrate
    np.testing.assert_array_equal(got, want)
    assert io_audio.wav_info(fn) == jax_io_audio.wav_info(fn)
    np.testing.assert_array_equal(io_audio.pcm16_exact(got), jax_io_audio.pcm16_exact(want))
    assert io_audio.pcm16_exact(data) is None
    np.testing.assert_array_equal(io_audio.load_wav(fn, 24000)[0],
                                  jax_io_audio.load_wav(fn, 24000)[0])


@pytest.mark.parametrize("clip", [0, 1], ids=["wav-jpg", "packed"])
def test_sample_reader_gives_the_same_chunks(db, clip):
    """Train-mode reading (shuffled, random rotations, u8 frames) from one
    seed: the same chunk ids, audio and frames."""
    root, ids = db
    folder = os.path.join(root, ids[clip])
    kw = dict(return_video=True, skip_silence_thr=0.2, shuffle=True, random_rotations=True)
    mine = SampleReader(folder, img_prep=img_prep_u8, rng=np.random.RandomState(7), **kw)
    ref = JaxSampleReader(folder, img_prep=jax_img_prep_u8, rng=np.random.RandomState(7), **kw)
    assert type(mine.audio_reader).__name__ == type(ref.audio_reader).__name__
    assert mine.chunks_t == ref.chunks_t and mine.chunks_t
    for _ in range(4):
        a, b = mine.get(), ref.get()
        assert a["id"] == b["id"]
        np.testing.assert_array_equal(a["ambix"], b["ambix"])
        assert a["video"].dtype == np.uint8
        np.testing.assert_array_equal(a["video"], b["video"])


def test_sample_reader_reads_flow(tmp_path):
    """return_flow=True on a clip with flow jpgs: the JAX reader's chunks,
    flow maps included, bit for bit (tests/test_torch_flow.py holds the
    flow readers themselves)."""
    make_synthetic_dataset(str(tmp_path), n_videos=1, duration=2.0, frame_hw=(32, 64),
                           with_flow=True, seed=4)
    folder = str(tmp_path / "synth000")
    kw = dict(return_video=False, return_flow=True, random_rotations=True)
    mine = SampleReader(folder, rng=np.random.RandomState(2), **kw)
    ref = JaxSampleReader(folder, rng=np.random.RandomState(2), **kw)
    for _ in range(2):
        a, b = mine.get(), ref.get()
        assert set(a) == set(b) == {"id", "ambix", "flow"}
        assert a["flow"].shape == (1, 32, 64, 3) and a["flow"].dtype == np.float32
        np.testing.assert_array_equal(a["flow"], b["flow"])


def _batches(feeder, n):
    feeder.start()
    try:
        it = feeder.batches()
        return [next(it) for _ in range(n)]
    finally:
        feeder.stop()


@pytest.mark.parametrize("for_eval", [False, True], ids=["train", "eval"])
def test_feeder_gives_the_same_batches(db, for_eval):
    """One worker, one seed: the port's Feeder and the JAX Feeder yield the
    same batches (ids, audio, u8 frames, channel masks)."""
    root, _ = db
    kw = dict(batch_size=3, n_workers=1, for_eval=for_eval, seed=5, return_video=True)
    mine = _batches(Feeder(root, img_prep=img_prep_u8, **kw), 2)
    ref = _batches(JaxFeeder(root, img_prep=jax_img_prep_u8, **kw), 2)
    for a, b in zip(mine, ref):
        assert a["id"] == b["id"]
        assert set(a) == set(b) == {"id", "ambix", "video", "audio_mask"}
        for key in ("ambix", "video", "audio_mask"):
            np.testing.assert_array_equal(a[key], b[key])


def test_device_prefetch_on_cpu_keeps_values_and_order():
    batches = [{"id": [i], "x": np.full((2, 3), i, np.float32),
                "v": np.full((1, 2), i, np.uint8)} for i in range(5)]
    out = list(device_prefetch(iter(batches), "cpu", depth=2))
    assert [host["id"] for _, host in out] == [[i] for i in range(5)]
    for i, (dev, _) in enumerate(out):
        assert set(dev) == {"x", "v"} and dev["v"].dtype == torch.uint8
        assert torch.equal(dev["x"], torch.full((2, 3), float(i)))


def _numbered(i: int) -> dict:
    return {"id": [i], "x": np.full((2, 3), i, np.float32), "v": np.full((1, 2), i, np.uint8)}


def test_device_prefetch_stages_more_batches_than_its_ring_in_order():
    """Nine batches through depth 2 (a ring of three): each batch, in the
    iterator's order, with its own values and dtypes."""
    out = list(device_prefetch(map(_numbered, range(9)), "cpu", depth=2))
    assert [host["id"] for _, host in out] == [[i] for i in range(9)]
    for i, (dev, _) in enumerate(out):
        assert dev["x"].dtype == torch.float32 and dev["v"].dtype == torch.uint8
        assert torch.equal(dev["x"], torch.full((2, 3), float(i)))
        assert torch.equal(dev["v"], torch.full((1, 2), i, dtype=torch.uint8))


def test_device_prefetch_raises_the_iterators_error_at_the_consumer():
    def batches():
        yield _numbered(0)
        yield _numbered(1)
        raise OSError("pack unreadable")

    stream = device_prefetch(batches(), "cpu")
    assert [next(stream)[1]["id"] for _ in range(2)] == [[0], [1]]
    with pytest.raises(OSError, match="pack unreadable"):
        next(stream)


@pytest.mark.parametrize("taken", [0, 1, 5])
def test_closing_device_prefetch_over_an_infinite_iterator_joins_its_thread(taken):
    before = set(threading.enumerate())
    stream = device_prefetch(map(_numbered, itertools.count()), "cpu", depth=2)
    next(stream)
    for _ in range(taken):
        next(stream)
    started = set(threading.enumerate()) - before
    assert len(started) == 1
    t0 = time.perf_counter()
    stream.close()
    assert time.perf_counter() - t0 < 1.0
    assert not [t for t in started if t.is_alive()]
    assert not set(threading.enumerate()) - before


def test_device_prefetch_counts_the_batches_staged_before_the_consumer_asked():
    """A consumer slower than the iterator finds every batch after the first
    staged already: `train.prefetch_ready` counts them, once per batch taken
    (a batch it waited for counts 0), and `train.h2d_bytes` every array."""
    from spatialaudiogen_tpu_torch.utils.profiling import TRACER

    n = 6
    TRACER.start()
    try:
        stream = device_prefetch(map(_numbered, range(n)), "cpu")
        for _ in range(n):
            time.sleep(0.1)
            next(stream)
        stream.close()
    finally:
        trace = TRACER.stop()
    assert n - 1 <= trace.counters["train.prefetch_ready"] <= n
    assert trace.counters["train.h2d_bytes"] == n * (2 * 3 * 4 + 2)


def test_a_consumer_faster_than_the_iterator_counts_no_ready_batch():
    from spatialaudiogen_tpu_torch.utils.profiling import TRACER

    def slow():
        for i in range(3):
            time.sleep(0.1)
            yield _numbered(i)

    TRACER.start()
    try:
        assert len(list(device_prefetch(slow(), "cpu"))) == 3
    finally:
        trace = TRACER.stop()
    assert trace.counters["train.prefetch_ready"] == 0


def test_background_generator_surfaces_errors():
    def gen():
        yield 1
        raise OSError("disk")

    it = iter(BackgroundGenerator(gen(), depth=1))
    assert next(it) == 1
    with pytest.raises(OSError, match="disk"):
        next(it)


def test_closing_a_background_generators_iteration_stops_its_thread():
    before = set(threading.enumerate())
    it = iter(BackgroundGenerator(itertools.count(), depth=2))
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    it.close()
    assert not set(threading.enumerate()) - before
