"""The port's TensorBundle reader and writer (spatialaudiogen_tpu_torch.
utils.tf_bundle) against the JAX package's (spatialaudiogen_tpu.utils.
tf_bundle), which tests/test_tf_bundle.py pins to known-good vectors.

Both writers must give the same bytes for the same tensors (every dtype of
DTYPES, scalars, a multi-block index), both readers the same arrays, on
bundles of either writer and on the golden fixture. The port's CRC32C runs
in numpy lanes above 32 KB, at most 2^16 of them: it is held to the JAX
byte loop bit for bit on lengths around each of its cuts and past the cap.
"""

import os

import numpy as np
import pytest

from spatialaudiogen_tpu.utils import tf_bundle as jax_tb
from spatialaudiogen_tpu_torch.utils import tf_bundle as tb

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "tfbundle", "model.ckpt-42")


def tensors_of_every_dtype(rng) -> dict:
    out = {}
    for code, dtype in tb.DTYPES.items():
        if dtype == np.bool_:
            value = rng.rand(3, 4) > 0.5
        elif dtype.kind == "f":
            value = rng.randn(2, 3, 5).astype(dtype)
        else:
            info = np.iinfo(dtype)
            value = rng.randint(info.min, info.max, (7,), dtype=np.int64).astype(dtype)
        out[f"scope/dtype_{code}/weights"] = value
        out[f"scalar_{code}"] = np.array(value.ravel()[0], dtype)
    out["global_step"] = np.array(152000, np.int64)
    out["float64_is_written_as_float32"] = rng.randn(4)
    return out


def files(prefix: str) -> dict:
    names = (".index", ".data-00000-of-00001")
    out = {}
    for suffix in names:
        with open(prefix + suffix, "rb") as f:
            out[suffix] = f.read()
    with open(os.path.join(os.path.dirname(prefix), "checkpoint"), "rb") as f:
        out["checkpoint"] = f.read()
    return out


def assert_same_arrays(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype and got[name].shape == want[name].shape
        assert np.array_equal(got[name], want[name]), name


def test_dtype_table_is_jax_table():
    assert tb.DTYPES == jax_tb.DTYPES and tb.TABLE_MAGIC == jax_tb.TABLE_MAGIC


@pytest.mark.parametrize("n", [0, 1, 9, 4095, (1 << 15) - 1, 1 << 15, (1 << 15) + 1, 65536 + 7,
                               (1 << 20) + 3])
def test_crc32c_matches_jax(n):
    data = np.random.RandomState(n).bytes(n)
    for start in (0, 0x12345678):
        assert tb.crc32c(data, start) == jax_tb.crc32c(data, start)
    assert tb.masked_crc32c(data) == jax_tb.masked_crc32c(data)


def test_crc32c_past_the_lane_cap_matches_jax():
    """From 4 MB on the lanes stop at 2^16 and grow wider instead (here 65
    bytes, the first lane padded): the regime of the flagship's large
    tensors. One pass of the JAX byte loop (about 2 s)."""
    data = np.random.RandomState(22).bytes((1 << 22) + 5)
    assert tb.masked_crc32c(data) == jax_tb.masked_crc32c(data)


def test_crc32c_check_vectors():
    assert tb.crc32c(b"123456789") == 0xE3069283
    assert tb.crc32c(b"\x00" * 32) == 0x8A9136AA
    assert tb.crc32c(b"\x00" * 40000) == jax_tb.crc32c(b"\x00" * 40000)


def test_writers_give_the_same_bytes(tmp_path):
    tensors = tensors_of_every_dtype(np.random.RandomState(0))
    for who, module in (("jax", jax_tb), ("port", tb)):
        module.save_tf_checkpoint(str(tmp_path / who / "model.ckpt-152000"), tensors)
    jax_files = files(str(tmp_path / "jax" / "model.ckpt-152000"))
    assert files(str(tmp_path / "port" / "model.ckpt-152000")) == jax_files
    back = tb.load_tf_checkpoint(str(tmp_path / "port"), verify_crc=True)
    assert back["scalar_9"].shape == () and back["float64_is_written_as_float32"].dtype == \
        np.float32
    assert_same_arrays(back, jax_tb.load_tf_checkpoint(str(tmp_path / "jax"), verify_crc=True))


def test_multi_block_index_and_large_tensor(tmp_path):
    """300 names in 256-byte blocks, and a tensor above the CRC's lane cut:
    the same bytes from both writers, read back by both readers."""
    rng = np.random.RandomState(1)
    tensors = {f"scope_{i:03d}/very/long/nested/variable_name_{i:03d}/weights":
               rng.randn(4, 4).astype(np.float32) for i in range(300)}
    tensors["big/weights"] = rng.randn(300, 1000).astype(np.float32)
    for who, module in (("jax", jax_tb), ("port", tb)):
        prefix = str(tmp_path / who / "model.ckpt-7")
        module.save_tf_checkpoint(prefix, tensors)
        entries = module.read_index_file(prefix + ".index")["entries"]
        module.write_index_file(prefix + ".index", entries, block_size=256)
    assert files(str(tmp_path / "port" / "model.ckpt-7")) == \
        files(str(tmp_path / "jax" / "model.ckpt-7"))
    for who in ("jax", "port"):
        prefix = str(tmp_path / who / "model.ckpt-7")
        assert_same_arrays(tb.load_tf_checkpoint(prefix, verify_crc=True), tensors)
        assert_same_arrays(jax_tb.load_tf_checkpoint(prefix, verify_crc=True), tensors)


def test_readers_agree_on_golden_fixture():
    back = tb.load_tf_checkpoint(FIXTURE, verify_crc=True)
    assert_same_arrays(back, jax_tb.load_tf_checkpoint(FIXTURE, verify_crc=True))
    assert back["step"] == 42 and back["step"].dtype == np.int64
    np.testing.assert_array_equal(back["a/biases"], np.array([-1.5, 2.5], np.float32))
    index = tb.read_index_file(FIXTURE + ".index")
    want = jax_tb.read_index_file(FIXTURE + ".index")
    assert index["header"] == want["header"]
    assert {k: e.serialize() for k, e in index["entries"].items()} == \
        {k: e.serialize() for k, e in want["entries"].items()}


@pytest.mark.parametrize("where", ["index", "data"])
def test_crc_corruption_detected(tmp_path, where):
    prefix = str(tmp_path / "model.ckpt-1")
    tb.save_tf_checkpoint(prefix, {"w": np.arange(16, dtype=np.float32),
                                   "big": np.arange(20000, dtype=np.float32)})
    fn = prefix + (".index" if where == "index" else ".data-00000-of-00001")
    blob = bytearray(open(fn, "rb").read())
    blob[1 if where == "index" else 40000] ^= 0xFF
    open(fn, "wb").write(bytes(blob))
    for module in (tb, jax_tb):
        with pytest.raises(ValueError, match="checksum|magic"):
            module.load_tf_checkpoint(prefix, verify_crc=True)
    if where == "data":   # unverified, the data still loads (the fast path)
        assert tb.load_tf_checkpoint(prefix)["big"].shape == (20000,)


def test_latest_checkpoint(tmp_path):
    for step in (5, 100, 20):
        tb.save_tf_checkpoint(str(tmp_path / f"model.ckpt-{step}"),
                              {"w": np.full((2,), step, np.float32)})
    for module in (tb, jax_tb):
        assert module.latest_checkpoint(str(tmp_path)).endswith("model.ckpt-20")
    os.remove(str(tmp_path / "checkpoint"))
    for module in (tb, jax_tb):
        assert module.latest_checkpoint(str(tmp_path)).endswith("model.ckpt-100")
    assert float(tb.load_tf_checkpoint(str(tmp_path))["w"][0]) == 100.0
    (tmp_path / "empty").mkdir()
    assert tb.latest_checkpoint(str(tmp_path / "empty")) is None
    with pytest.raises(FileNotFoundError):
        tb.load_tf_checkpoint(str(tmp_path / "empty"))
