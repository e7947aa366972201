"""The port's generic library against the JAX package's on the CPU: the
recurrent layers and their weight bridge, Embedding, the classification
metrics, GenericHarness on tests/test_generic_lib.py's logistic regression,
ArrayDataset / parallel_map, image_prep (against the cv2 path), the ffmpeg
audio helpers (through a stub ffmpeg), sh_matrix_polar_torch, the tracer
and device_trace, and the model interface protocol. Inputs are drawn from
a seed with numpy; weights come across from flax's parameters.
"""

import json
import os
import stat
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from spatialaudiogen_tpu.ambisonics.sh import sh_matrix_polar, sh_matrix_polar_jnp
from spatialaudiogen_tpu.data import generic as jax_generic
from spatialaudiogen_tpu.data import image_prep as jax_prep
from spatialaudiogen_tpu.models import classification_metrics as jax_metrics
from spatialaudiogen_tpu.models.embedding import Embedding as JaxEmbedding
from spatialaudiogen_tpu.models.recurrent import BidirectionalRecurrent as JaxBi
from spatialaudiogen_tpu.models.recurrent import Recurrent as JaxRecurrent
from spatialaudiogen_tpu.train.harness import GenericHarness as JaxHarness
from spatialaudiogen_tpu.utils import io_audio as jax_io
from spatialaudiogen_tpu_torch.ambisonics.sh import sh_matrix_polar_torch
from spatialaudiogen_tpu_torch.config import SptAudioGenConfig
from spatialaudiogen_tpu_torch.data import generic, image_prep
from spatialaudiogen_tpu_torch.models import classification_metrics as metrics
from spatialaudiogen_tpu_torch.models.embedding import Embedding
from spatialaudiogen_tpu_torch.models.interface import GenerativeAudioModel
from spatialaudiogen_tpu_torch.models.recurrent import (
    BidirectionalRecurrent,
    Recurrent,
    gru,
    lstm,
    rnn,
)
from spatialaudiogen_tpu_torch.models.sptaudiogen import SptAudioGen
from spatialaudiogen_tpu_torch.train.harness import GenericHarness
from spatialaudiogen_tpu_torch.utils import io_audio
from spatialaudiogen_tpu_torch.utils.profiling import TRACER, device_trace, span

torch.set_num_threads(1)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("cell", ["rnn", "lstm", "gru"])
@pytest.mark.parametrize("return_state", [False, True])
def test_recurrent_matches_jax(cell, return_state):
    """Recurrent over (2, 7, 5) -> 6 units at flax's weights: outputs and
    the final state (h, or (c, h) for the LSTM, flax's carry order) within
    1e-6 of JAX's."""
    x = np.random.RandomState(0).randn(2, 7, 5).astype(np.float32)
    model = JaxRecurrent(6, cell, return_state=return_state)
    variables = jax.jit(lambda a: model.init(jax.random.PRNGKey(1), a))(x)
    want = _np_tree(jax.jit(model.apply)(variables, x))
    port = Recurrent(5, 6, cell, return_state=return_state)
    port.load_flax(_np_tree(variables["params"]["cell"]))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    if return_state:
        (state, y), (want_state, want_y) = got, want
        for a, b in zip(jax.tree_util.tree_leaves(state), jax.tree_util.tree_leaves(want_state)):
            np.testing.assert_allclose(a.numpy(), b, atol=1e-6)
    else:
        y, want_y = got, want
    np.testing.assert_allclose(y.numpy(), want_y, atol=1e-6)


def test_bidirectional_and_helpers_match_jax():
    """BidirectionalRecurrent (GRU) against JAX's at 1e-6; rnn/lstm/gru
    build the named cells."""
    x = np.random.RandomState(1).randn(3, 9, 4).astype(np.float32)
    model = JaxBi(5, "gru")
    variables = jax.jit(lambda a: model.init(jax.random.PRNGKey(2), a))(x)
    want = np.asarray(jax.jit(model.apply)(variables, x))
    port = BidirectionalRecurrent(4, 5, "gru").load_flax(_np_tree(variables["params"]))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 9, 10)
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert isinstance(rnn(4, 5).cell, torch.nn.RNN)
    assert isinstance(lstm(4, 5).cell, torch.nn.LSTM)
    assert isinstance(gru(4, 5).cell, torch.nn.GRU)


def test_embedding_matches_jax():
    ids = np.array([[1, 2, 9], [3, 0, 3]])
    model = JaxEmbedding(10, 4)
    variables = model.init(jax.random.PRNGKey(0), ids)
    want = np.asarray(model.apply(variables, ids))
    port = Embedding(10, 4).load_flax(_np_tree(variables["params"]))
    with torch.no_grad():
        np.testing.assert_allclose(port(torch.from_numpy(ids)).numpy(), want, atol=1e-6)


def test_classification_metrics_match_jax_with_ties():
    """accuracy and top_k_accuracy against JAX's on logits with ties (among
    equal logits a stable sort keeps the higher class ids last, as
    jnp.argsort does), with integer and one-hot labels."""
    rng = np.random.RandomState(2)
    logits = rng.randint(0, 3, (64, 6)).astype(np.float32)       # many ties
    labels = rng.randint(0, 6, 64)
    onehot = np.eye(6, dtype=np.float32)[labels]
    for lab in (labels, onehot):
        tl, tlab = torch.from_numpy(logits), torch.from_numpy(lab)
        assert float(metrics.accuracy(tl, tlab)) == float(jax_metrics.accuracy(logits, lab))
        for k in (1, 2, 3, 5):
            assert float(metrics.top_k_accuracy(tl, tlab, k)) == \
                float(jax_metrics.top_k_accuracy(logits, lab, k)), k


def _gaussians():
    rng = np.random.RandomState(0)
    n = 512
    x = np.concatenate([rng.randn(n, 8) + 1.5, rng.randn(n, 8) - 1.5]).astype(np.float32)
    y = np.concatenate([np.zeros(n, np.int32), np.ones(n, np.int32)])
    return x, y


def test_generic_harness_matches_jax():
    """tests/test_generic_lib.py's logistic regression, Adam(1e-2), clip_norm
    0.5 (active: the first gradients' global norm is above it): each of the
    16 steps' losses within 1e-5 absolute plus 1e-5 relative of JAX's
    harness from the same initial weights and batches (Adam's first steps
    move each weight by about lr whatever its gradient, so the two
    optimisers' last-bit differences in the weights, 1e-7 after a step,
    reach the loss amplified by the inputs' scale: 1.1e-5 on a loss of 1.07
    by step 11); then evaluate (batch-size weighted, 1e-5) and predict
    (logits within 1e-4)."""
    import flax.linen as nn

    x, y = _gaussians()

    class Logistic(nn.Module):
        @nn.compact
        def __call__(self, x):
            return nn.Dense(2)(x)

    @jax.jit   # evaluate calls it outside the step's jit: one compile, not one per op
    def xent(logits, labels):
        return optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()

    jax_h = JaxHarness(Logistic(), xent, {"acc": jax.jit(jax_metrics.accuracy)},
                       optimizer=optax.adam(1e-2), clip_norm=0.5)
    jax_h._init(x[:1])
    params = _np_tree(jax_h.params)
    linear = torch.nn.Linear(8, 2)
    with torch.no_grad():
        linear.weight.copy_(torch.from_numpy(params["Dense_0"]["kernel"].T.copy()))
        linear.bias.copy_(torch.from_numpy(params["Dense_0"]["bias"]))
    port = GenericHarness(linear, torch.nn.functional.cross_entropy,
                          {"acc": metrics.accuracy},
                          optimizer=lambda p: torch.optim.Adam(p, lr=1e-2), clip_norm=0.5,
                          device="cpu")
    grads = jax.jit(jax.grad(lambda p: xent(Logistic().apply({"params": p}, x[:64]),
                                            y[:64])))(params)
    assert float(optax.global_norm(grads)) > 0.5

    data_j = jax_generic.ArrayDataset(x, y, batch_size=64, seed=1)
    data_p = generic.ArrayDataset(x, y, batch_size=64, seed=1)
    losses_j, losses_p = [], []
    for (fj, lj), (fp, lp) in zip(data_j, data_p):
        losses_j.append(jax_h.fit([(fj, lj)])[-1]["loss"])
        losses_p.append(port.fit([(fp, lp.astype(np.int64))])[-1]["loss"])
    assert len(losses_p) == 16
    np.testing.assert_allclose(losses_p, losses_j, atol=1e-5, rtol=1e-5)
    assert losses_p[-1] < losses_p[0]

    batches = [(x[i: i + 100], y[i: i + 100].astype(np.int64)) for i in range(0, 1024, 100)]
    got = port.evaluate(batches)
    want = jax_h.evaluate([(f, lab.astype(np.int32)) for f, lab in batches])
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=1e-5)
    preds = port.predict(x[:5])
    assert isinstance(preds, np.ndarray) and preds.shape == (5, 2)
    # logits of size 2.5 from weights 1e-6 apart after the 16 steps
    np.testing.assert_allclose(preds, jax_h.predict(x[:5]), atol=1e-4)


def test_array_dataset_order_and_parallel_map():
    """ArrayDataset gives JAX's batches (order, remainder, drop_remainder,
    no shuffle) for a seed over two passes; parallel_map equals the map on
    spawned workers and in process."""
    a = np.arange(50)[:, None] * np.ones((1, 3))
    b = np.arange(50) * 10
    for kw in ({"seed": 3}, {"seed": 3, "drop_remainder": True}, {"shuffle": False}):
        mine = generic.ArrayDataset(a, b, batch_size=8, **kw)
        theirs = jax_generic.ArrayDataset(a, b, batch_size=8, **kw)
        assert len(mine) == len(theirs)
        for _ in range(2):
            for (pa, pb), (ja, jb) in zip(mine, theirs, strict=True):
                np.testing.assert_array_equal(pa, ja)
                np.testing.assert_array_equal(pb, jb)
    images = [np.random.RandomState(i).randint(0, 256, (4, 5, 3), np.uint8) for i in range(5)]
    want = [image_prep.imagenet_normalize(im) for im in images]
    for n_workers in (1, 2):
        got = generic.parallel_map(image_prep.imagenet_normalize, images, n_workers=n_workers)
        for g, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("shape", [(256, 320, 3), (100, 120, 3), (37, 41, 3), (50, 70)])
def test_image_prep_matches_cv2_path(shape):
    """eval_image and distort_image (the same RandomState draws) against
    JAX's cv2 path: uint8 results within 1 LSB, the share of pixels that
    differ at most 1% (0% to 0.3% seen: cv2's scalar tails round otherwise
    than its vector body, which the port follows); float32 images within
    1e-3 of cv2 on 0..255 values; the normalisations bit for bit."""
    img = np.random.RandomState(sum(shape)).randint(0, 256, shape, np.uint8)
    pairs = [(image_prep.eval_image(img, 64, 64), jax_prep.eval_image(img, 64, 64)),
             (image_prep.eval_image(img, 130, 90), jax_prep.eval_image(img, 130, 90))]
    for seed in range(4):
        pairs.append((image_prep.distort_image(img, 56, 48, np.random.RandomState(seed)),
                      jax_prep.distort_image(img, 56, 48, np.random.RandomState(seed))))
    for got, want in pairs:
        assert got.shape == want.shape and got.dtype == np.uint8
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.01, (diff.max(), (diff > 0).mean())
    rng_p, rng_j = np.random.RandomState(9), np.random.RandomState(9)
    image_prep.distort_image(img, 32, 32, rng_p)
    jax_prep.distort_image(img, 32, 32, rng_j)
    assert rng_p.rand() == rng_j.rand()                  # the same draws consumed
    flt = img.astype(np.float32)
    np.testing.assert_allclose(image_prep.eval_image(flt, 64, 64),
                               jax_prep.eval_image(flt, 64, 64), atol=1e-3)
    for name in ("imagenet_normalize", "model_normalize") if img.ndim == 3 else ():
        np.testing.assert_array_equal(getattr(image_prep, name)(img),
                                      getattr(jax_prep, name)(img))


F32LE_STUB = """#!{python}
import json, os, shutil, sys, wave
import numpy as np
folder = {folder!r}
args = sys.argv[1:]
with open(os.path.join(folder, "calls.jsonl"), "a") as f:
    f.write(json.dumps(args) + "\\n")
src = args[args.index("-i") + 1]
if args[-1] != "pipe:1":
    shutil.copy(src, args[-1])
    sys.exit(0)
with wave.open(src) as w:
    rate, n_ch = w.getframerate(), w.getnchannels()
    pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2").reshape(-1, n_ch)
assert int(args[args.index("-ar") + 1]) == rate and int(args[args.index("-ac") + 1]) == n_ch
skip = int(round(float(args[args.index("-ss") + 1]) * rate)) if "-ss" in args else 0
sys.stdout.buffer.write((pcm[skip:] / 32768.0).astype("<f4").tobytes())
"""


@pytest.fixture()
def ffmpeg_stub(tmp_path, monkeypatch):
    """A stand-in ffmpeg first on PATH: records its argv, copies the input
    for a transcode and decodes a PCM16 wav to float32 on stdout for the
    f32le pipe (honouring -ss)."""
    stub = tmp_path / "bin" / "ffmpeg"
    stub.parent.mkdir()
    stub.write_text(F32LE_STUB.format(python=sys.executable, folder=str(stub.parent)))
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{stub.parent}{os.pathsep}{os.environ['PATH']}")
    return stub.parent


def test_ffmpeg_audio_helpers_match_jax(ffmpeg_stub, tmp_path):
    """convert_to_wav and FfmpegAudioReader (seek, chunks, EOF) give JAX's
    commands and JAX's chunks bit for bit, and the chunks are the file's
    samples."""
    audio = (np.random.RandomState(4).randn(48000, 2) * 0.2).clip(-1, 1)
    src = str(tmp_path / "in.wav")
    io_audio.save_wav(src, audio, 48000)
    want, _ = io_audio.load_wav(src)
    for mod, tag in ((io_audio, "port"), (jax_io, "jax")):
        out = mod.convert_to_wav(src, str(tmp_path / f"{tag}.wav"), rate=48000, n_channels=2)
        assert open(out, "rb").read() == open(src, "rb").read()
    chunks = {}
    for mod, tag in ((io_audio, "port"), (jax_io, "jax")):
        reader = mod.FfmpegAudioReader(src, rate=48000, n_channels=2, seek=0.25)
        chunks[tag] = list(reader.loop_chunks(5000))
        assert reader.get_chunk(10) is None
        reader.close()
    assert [c.shape for c in chunks["port"]] == [(5000, 2)] * 7 + [(1000, 2)]
    for a, b in zip(chunks["port"], chunks["jax"], strict=True):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.concatenate(chunks["port"]),
                                  want[12000:].astype(np.float32))
    calls = [json.loads(line) for line in (ffmpeg_stub / "calls.jsonl").read_text().splitlines()]
    assert calls[0][:-1] == calls[1][:-1] and calls[2] == calls[3] and "-ss" in calls[2]


def test_sh_matrix_polar_torch_matches_jax_and_numpy():
    """Orders 0..3 on 500 directions: against sh_matrix_polar_jnp (float32,
    1e-5) and numpy's scipy path (float64 input, 1e-10)."""
    rng = np.random.RandomState(6)
    phi = rng.uniform(-np.pi, np.pi, 500)
    nu = rng.uniform(-np.pi / 2, np.pi / 2, 500)
    for order in range(4):
        got64 = sh_matrix_polar_torch(torch.from_numpy(phi), torch.from_numpy(nu), order)
        np.testing.assert_allclose(got64.numpy(), sh_matrix_polar(phi, nu, order), atol=1e-10)
        p32, n32 = phi.astype(np.float32), nu.astype(np.float32)
        got = sh_matrix_polar_torch(torch.from_numpy(p32), torch.from_numpy(n32), order)
        np.testing.assert_allclose(got.numpy(), np.asarray(sh_matrix_polar_jnp(
            jnp.asarray(p32), jnp.asarray(n32), order)), atol=1e-5)
    with pytest.raises(ValueError):
        sh_matrix_polar_torch(torch.zeros(1), torch.zeros(1), 4)


def test_section_timer_and_device_trace(tmp_path):
    """The tracer's summary(): totals, counts, means and self time of
    nested spans, started and stopped by hand; device_trace(device="cpu")
    switches the tracer on for its block and hands over its spans, and
    writes one trace file that parses as a Chrome trace and holds the ops
    of the block and the tracer's `sag.*` ranges, nested as the spans are;
    asked for a CUDA trace without a card it raises."""
    TRACER.start()
    for _ in range(3):
        with span("data"):
            pass
    with span("step"):
        with span("step.inner"):
            torch.ones(3).sum()
    summary = TRACER.stop().summary()
    assert summary["data"]["count"] == 3 and summary["step"]["count"] == 1
    assert summary["data"]["mean_ms"] == pytest.approx(1000 * summary["data"]["total_s"] / 3)
    assert summary["step"]["self_s"] == pytest.approx(
        summary["step"]["total_s"] - summary["step.inner"]["total_s"])
    with device_trace(str(tmp_path / "trace"), device="cpu") as held:
        assert TRACER.on
        a = torch.randn(32, 32)
        with span("outer"):
            with span("mm"):
                torch.mm(a, a)
    assert not TRACER.on
    assert [s.name for s in held.trace.spans] == ["mm", "outer"]
    assert TRACER.take().spans == []
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    ranges = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("name", "").startswith("sag.")}
    assert set(ranges) == {"sag.outer", "sag.mm"}
    assert ranges["sag.outer"][0] <= ranges["sag.mm"][0] <= ranges["sag.mm"][1] \
        <= ranges["sag.outer"][1]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            with device_trace(str(tmp_path / "cuda_trace")):
                pass


def test_sptaudiogen_is_a_generative_audio_model():
    model = SptAudioGen(SptAudioGenConfig(encoders=("audio",), sep_num_tracks=2))
    assert isinstance(model, GenerativeAudioModel)
    assert not isinstance(torch.nn.Linear(2, 2), GenerativeAudioModel)
