"""The port's copy of the TensorBoard writer and its MetricLogger against the
JAX package's: the same crc32c, the same event bytes at a fixed wall time,
scalars and histograms that decode through the JAX package's readers to
the same tags and values, non-finite entries dropped, and the TB scalars
on by default (a port run leaves an events file, as a JAX run does)."""

import glob
import os

import numpy as np
import pytest

from spatialaudiogen_tpu.utils import tensorboard as jax_tb
from spatialaudiogen_tpu.utils.logging import MetricLogger as JaxLogger
from spatialaudiogen_tpu_torch.utils import tensorboard as tb
from spatialaudiogen_tpu_torch.utils.logging import MetricLogger


@pytest.mark.parametrize("data", [b"", b"\x00" * 32, b"123456789", bytes(range(256))])
def test_crc32c_matches(data):
    assert tb.crc32c(data) == jax_tb.crc32c(data)
    assert tb._masked_crc(data) == jax_tb._masked_crc(data)


def test_event_bytes_match_at_a_fixed_wall_time():
    rng = np.random.RandomState(0)
    values = rng.randn(500).astype(np.float32)
    for port_fn, jax_fn, args in (
            (tb._scalar_event, jax_tb._scalar_event, ("total_loss", 2.5, 7, 1234.5)),
            (tb._histo_event, jax_tb._histo_event, ("params/a/kernel", values, 3, 99.0)),
            (tb._version_event, jax_tb._version_event, (42.0,))):
        assert port_fn(*args) == jax_fn(*args)


def test_writer_files_match(tmp_path, monkeypatch):
    """One file from each writer, with time.time() pinned: equal bytes."""
    paths = []
    for mod, sub in ((tb, "port"), (jax_tb, "jax")):
        monkeypatch.setattr(mod.time, "time", lambda: 1700000000.25)
        w = mod.TBEventWriter(str(tmp_path / sub))
        w.add_scalar("loss", 1.5, 0)
        w.add_histogram("h", np.arange(10.0), 1)
        w.add_histogram("bad", np.array([np.nan, np.inf]), 1)   # dropped whole
        w.close()
        paths.append(w.path)
    port, want = (open(p, "rb").read() for p in paths)
    assert port == want
    assert len(tb.read_records(paths[0])) == 3


def _one_file(d) -> str:
    (path,) = glob.glob(str(d / "events.out.tfevents.*"))
    return path


def test_metric_logger_decodes_to_the_jax_loggers_tags(tmp_path):
    """Scalars in one run dir, histograms in another (the JAX package's
    decode_scalars reads files of scalar events only)."""
    rng = np.random.RandomState(1)
    hist = {"audio_encoder/conv1/conv/kernel": rng.randn(4, 3).astype(np.float32),
            "localization/fc3/dense/bias": np.array([1.0, np.nan, 2.0, np.inf, 3.0])}
    for cls, sub in ((MetricLogger, "port"), (JaxLogger, "jax")):
        logger = cls(str(tmp_path / sub / "scalars"))
        logger.tick(0.1)
        logger.log(5, {"total_loss": 3.25, "stft/mse": 3.0}, batch_size=4)
        logger.close()
        logger = cls(str(tmp_path / sub / "histograms"))
        logger.log_histograms(5, hist, prefix="grads")
        logger.close()
    scalars = [jax_tb.decode_scalars(_one_file(tmp_path / sub / "scalars"))
               for sub in ("port", "jax")]
    assert scalars[0] == scalars[1] and len(scalars[0]) == 2
    histos = [jax_tb.decode_histograms(_one_file(tmp_path / sub / "histograms"))
              for sub in ("port", "jax")]
    assert histos[0] == histos[1]
    assert {t for t, *_ in histos[0]} == {"grads/audio_encoder/conv1/conv/kernel",
                                          "grads/localization/fc3/dense/bias"}
    # the non-finite entries of the bias were dropped, the rest kept
    (num,) = [n for t, _, _, n, _ in histos[0] if t.endswith("bias")]
    assert num == 3
    assert os.path.exists(tmp_path / "port" / "scalars" / "metrics.jsonl")


def test_metric_logger_without_tensorboard(tmp_path):
    logger = MetricLogger(str(tmp_path), tensorboard=False)
    logger.log(0, {"total_loss": 1.0}, batch_size=2)
    logger.log_histograms(0, {"a": np.ones(3)})
    logger.close()
    assert not glob.glob(str(tmp_path / "events.out.tfevents.*"))
