"""The port's own copies of the JAX package's host modules (geometry, STFT
framing helpers, rotations, wav I/O, readers, packed readers, feeder)
against the originals: the same inputs give the same outputs, bit for bit.
"""

import dataclasses
import importlib
import os

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
from spatialaudiogen_tpu_torch.dsp import geometry, stft
from spatialaudiogen_tpu_torch.utils import io_audio

# the JAX package's dsp/__init__ re-exports a function named `stft`
jax_stft = importlib.import_module("spatialaudiogen_tpu.dsp.stft")


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


def test_background_generator_surfaces_errors():
    def gen():
        yield 1
        raise OSError("disk")

    it = iter(BackgroundGenerator(gen(), depth=1))
    assert next(it) == 1
    with pytest.raises(OSError, match="disk"):
        next(it)
