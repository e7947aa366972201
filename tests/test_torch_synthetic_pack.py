"""The port's synthetic dataset generator (data/synthetic.py) and dataset
packer (data/packed.py's writers, `sag-torch-pack`) against the JAX
package's.

Both generators must write the same files byte for byte (wavs, jpgs, flow
jpgs and limits, audio_pow.lst), with flow and without. Both packers must
write the same .npy files and meta.json byte for byte from the same
dataset, through pack_all and through the CLI (one worker, and a pool of
two spawned workers), for PCM16 and for float32 sources;
and each package's readers must read the other's pack window for window
as they read their own. Reduced sizes: 64x128 frames, 3 s clips.
"""

import contextlib
import filecmp
import io
import os
import shutil

import numpy as np
import pytest

from spatialaudiogen_tpu.data import packed as jax_packed
from spatialaudiogen_tpu.data import readers as jax_readers
from spatialaudiogen_tpu.data.synthetic import make_synthetic_dataset as jax_make_dataset
from spatialaudiogen_tpu_torch.data import packed
from spatialaudiogen_tpu_torch.data import readers
from spatialaudiogen_tpu_torch.data.synthetic import make_synthetic_dataset
from spatialaudiogen_tpu_torch.utils.io_audio import save_wav

KW = dict(n_videos=2, duration=3.0, frame_hw=(64, 128), seed=3)


def tree(root: str) -> dict:
    """{relative path: bytes} of every file under root."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            fn = os.path.join(dirpath, name)
            with open(fn, "rb") as f:
                out[os.path.relpath(fn, root)] = f.read()
    return out


def pack_files(root: str) -> dict:
    return {k: v for k, v in tree(root).items() if f"{os.sep}packed{os.sep}" in k}


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """{with_flow: (port root, JAX root, ids)}."""
    out = {}
    for with_flow in (False, True):
        base = tmp_path_factory.mktemp(f"synthetic_flow{int(with_flow)}")
        ids = make_synthetic_dataset(str(base / "port"), with_flow=with_flow, **KW)
        assert jax_make_dataset(str(base / "jax"), with_flow=with_flow, **KW) == ids
        out[with_flow] = (str(base / "port"), str(base / "jax"), ids)
    return out


@pytest.mark.parametrize("with_flow", [False, True], ids=["no_flow", "flow"])
def test_synthetic_dataset_matches_jax(datasets, with_flow):
    port_root, jax_root, ids = datasets[with_flow]
    got, want = tree(port_root), tree(jax_root)
    assert sorted(got) == sorted(want)
    assert got == want
    names = {os.path.relpath(k, ids[0]) for k in got if k.startswith(ids[0] + os.sep)}
    assert ("flow/flow_limits.npy" in names) == with_flow
    assert {"audio_pow.lst", "ambix/000000.wav", "video/000029.jpg"} <= names


@pytest.mark.parametrize("how", ["pack_all", "cli_one_worker", "cli_pool"])
def test_pack_matches_jax(datasets, tmp_path, how):
    _, jax_root, ids = datasets[True]
    port_root, ref_root = str(tmp_path / "port"), str(tmp_path / "jax")
    shutil.copytree(jax_root, port_root)
    shutil.copytree(jax_root, ref_root)
    jax_packed.pack_all(ref_root, n_workers=1)
    if how == "pack_all":
        out = packed.pack_all(port_root, n_workers=1)
        assert out == [os.path.join(port_root, i, "packed") for i in ids]
    elif how == "cli_one_worker":
        packed.main([port_root, "--num_workers", "1"])
    else:   # a pool of two spawned workers
        with contextlib.redirect_stdout(io.StringIO()) as out:
            packed.main([port_root, "--num_workers", "2"])
        assert out.getvalue().strip() == f"packed {len(ids)} videos under {port_root}"
    got, want = pack_files(port_root), pack_files(ref_root)
    assert sorted(os.path.basename(k) for k in got if k.startswith(ids[0])) == \
        ["ambix.npy", "flow.npy", "flow_lims.npy", "meta.json", "video.npy"]
    assert got == want
    meta = packed.json.loads(got[os.path.join(ids[0], "packed", "meta.json")])
    assert meta["audio_dtype"] == "int16" and meta["video_frames"] == 30
    # idempotent: a second pack leaves the files as they are
    mtime = os.path.getmtime(os.path.join(port_root, ids[0], "packed", "ambix.npy"))
    packed.pack_all(port_root, n_workers=1)
    assert os.path.getmtime(os.path.join(port_root, ids[0], "packed", "ambix.npy")) == mtime


def test_float32_source_packs_as_jax(tmp_path):
    """Wavs that are not PCM16-exact pack as float32, the same bytes."""
    for who in ("port", "jax"):
        folder = tmp_path / who / "clip"
        (folder / "ambix").mkdir(parents=True)
        for i in range(2):
            save_wav(str(folder / "ambix" / f"{i:06d}.wav"),
                     (0.3 * np.random.RandomState(i).randn(48000, 4)), 48000,
                     subtype="float32")
        (folder / "audio_pow.lst").write_text("0.5 0.3\n")
    packed.pack_all(str(tmp_path / "port"))
    jax_packed.pack_all(str(tmp_path / "jax"))
    got, want = pack_files(str(tmp_path / "port")), pack_files(str(tmp_path / "jax"))
    assert got == want and len(got) == 2
    assert np.load(tmp_path / "port" / "clip" / "packed" / "ambix.npy").dtype == np.float32


@pytest.fixture(scope="module")
def two_packs(datasets, tmp_path_factory):
    """The flow dataset packed once by each package."""
    _, jax_root, ids = datasets[True]
    roots = {}
    for who, module in (("port", packed), ("jax", jax_packed)):
        root = str(tmp_path_factory.mktemp(f"pack_{who}"))
        shutil.rmtree(root)
        shutil.copytree(jax_root, root)
        module.pack_all(root, n_workers=1)
        roots[who] = root
    return roots, ids


@pytest.mark.parametrize("reader_pkg", ["jax", "port"])
def test_readers_read_either_pack(two_packs, reader_pkg):
    """Each package's packed readers give the same windows over the other's
    pack as over its own, and its SampleReader picks up either pack."""
    roots, ids = two_packs
    pk, rd = (jax_packed, jax_readers) if reader_pkg == "jax" else (packed, readers)
    windows = {}
    for who, root in roots.items():
        folder = os.path.join(root, ids[1])
        assert pk.is_packed(folder)
        audio = pk.PackedAudioReader(folder, 48000, 1)
        video = pk.PackedVideoReader(folder, 10, img_prep=rd.img_prep_default)
        flow = pk.PackedFlowReader(folder, 10)
        windows[who] = [audio.get(0.5, 52799, None), audio.get(2.7, 52799, -3.1),
                        video.get_by_index(0.0, 4, 2.0), video.get_by_index(2.9, 3, None),
                        flow.get_by_index(0.5, 1), flow.get_by_index(2.8, 4)]
        sample = rd.SampleReader(folder, return_video=True, return_flow=True,
                                 img_prep=rd.img_prep_default, shuffle=False)
        assert isinstance(sample.audio_reader, pk.PackedAudioReader)
    for got, want in zip(windows["port"], windows["jax"]):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert filecmp.cmp(os.path.join(roots["port"], ids[1], "packed", "video.npy"),
                       os.path.join(roots["jax"], ids[1], "packed", "video.npy"), shallow=False)
