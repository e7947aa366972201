"""The PyTorch port's eval (Evaluator, eval_step, cli.eval) against the JAX
Evaluator, and the TF32 scope of the model and the eval metrics.

A JAX model dir (reduced flagship: audio+video, unet_mask with 8 tracks,
64x128 frames) is written with create_train_state + save_checkpoint and
exported with tools/export_torch_weights.py. Both Evaluators score the
same synthetic dataset (two 3 s clips, four eval samples) on the CPU at
batch 3 with one feeder thread, so both form the same batches and the last
one carries two zero pad lanes. The visual encoder's BatchNorm runs on
batch statistics at eval (bn_batch_stats), so the pad lanes reach the real
sample of that batch, in both packages alike; a port that dropped them, or
batched differently, would not match the JAX rows.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from spatialaudiogen_tpu.config import TrainConfig
from spatialaudiogen_tpu.data.synthetic import make_synthetic_dataset
from spatialaudiogen_tpu.eval.evaluator import Evaluator as JaxEvaluator
from spatialaudiogen_tpu.eval.parse_results import aggregate as jax_aggregate
from spatialaudiogen_tpu.models import SptAudioGen as JaxModel
from spatialaudiogen_tpu.train.checkpoint import save_checkpoint
from spatialaudiogen_tpu.train.lr import make_optimizer
from spatialaudiogen_tpu.train.state import create_train_state
from spatialaudiogen_tpu_torch.cli.eval import main as cli_main
from spatialaudiogen_tpu_torch.config import SptAudioGenConfig
from spatialaudiogen_tpu_torch.eval.evaluator import ALL_METRICS, Evaluator
from spatialaudiogen_tpu_torch.models.sptaudiogen import SptAudioGen

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
from export_torch_weights import export  # noqa: E402

FRAME_HW = (64, 128)
BATCH = 3
N_SAMPLES = 4    # 2 clips x 2 eval chunks (3 s clip, skip_rate 10)
MODES = {"exact": {}, "device": {"device_metrics": True, "emd_mode": "sinkhorn"}}


@pytest.fixture(scope="module", autouse=True)
def evals(tmp_path_factory):
    """The two Evaluators' rows in both modes. The module runs torch on one
    thread: Sinkhorn's hundreds of small ops, with every thread of every
    test worker spinning in OpenMP barriers, ran 0.3 s alone and 220 s with
    six workers on eight cores (one thread: 0.7 s either way)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    root = str(tmp_path_factory.mktemp("torchevaldb"))
    make_synthetic_dataset(root, n_videos=2, duration=3.0, frame_hw=FRAME_HW, seed=3)
    model_dir = str(tmp_path_factory.mktemp("torchevalmodel"))
    out_dir = tmp_path_factory.mktemp("torchevalout")
    cfg = TrainConfig(db_dir=root, model_dir=model_dir, encoders=("audio", "video"),
                      separation="unet_mask", num_sep_tracks=8, frame_hw=FRAME_HW,
                      n_data=1)
    cfg.save()
    g = cfg.model_config().geometry
    example = {"ambix": np.zeros((1, g.snd_size, 4), np.float32),
               "audio_mask": np.ones((1, 4), np.float32),
               "video": np.zeros((1, g.vid_dur) + FRAME_HW + (3,), np.float32)}
    state = create_train_state(JaxModel(cfg.model_config()), make_optimizer(),
                               jax.random.PRNGKey(7), example)
    save_checkpoint(model_dir, state, 1)
    export(model_dir)
    rows = {}
    for mode, kw in MODES.items():
        for pkg, cls in (("jax", JaxEvaluator), ("port", Evaluator)):
            extra = {} if pkg == "jax" else {"device": "cpu"}
            ev = cls(model_dir, batch_size=BATCH, db_dir=root, n_workers=1, **kw, **extra)
            fn = str(out_dir / f"{pkg}-{mode}.txt")
            _, res = ev.run(output_fn=fn, host_threads=2, print_every=0)
            rows[pkg, mode] = dict(res), fn
    yield root, model_dir, rows
    torch.set_num_threads(threads)


def _assert_rows_close(got, want, rest_tol, emd_tol=(5e-3, 5e-4)):
    assert sorted(got) == sorted(want) and len(got) == N_SAMPLES
    for sid in want:
        for m in ALL_METRICS:
            rtol, atol = emd_tol if m.startswith("emd/") else rest_tol
            np.testing.assert_allclose(got[sid][m], want[sid][m], rtol=rtol, atol=atol,
                                       err_msg=f"{sid} {m}")


@pytest.mark.parametrize("mode", list(MODES))
def test_rows_match_jax(evals, mode):
    """Row for row, by sample id: EMD at rtol 5e-3 / atol 5e-4 (the device
    mode's Sinkhorn against the exact solver's order), the rest at rtol
    2e-3 / atol 1e-5 (the JAX package's own float32 forward lies about
    1.2e-4 from float64 on this data, tests/test_torch_deploy.py)."""
    _, _, rows = evals
    _assert_rows_close(rows["port", mode][0], rows["jax", mode][0], (2e-3, 1e-5))


def test_device_mode_matches_exact_mode(evals):
    """The port's two modes, as tests/test_eval_metrics_device.py holds the
    JAX ones: EMD at rtol 5e-3 / atol 5e-4, the rest at rtol 1e-4 / atol
    1e-5 (mel-LSD and envelope in float32 on the device against float64 on
    the host; the other columns are the same numbers)."""
    _, _, rows = evals
    _assert_rows_close(rows["port", "device"][0], rows["port", "exact"][0], (1e-4, 1e-5))


def test_detailed_file_and_aggregate(evals):
    """eval-detailed rows: the header, one finite row per sample, and the
    same headline numbers (parse_results.aggregate) as the JAX file."""
    from spatialaudiogen_tpu_torch.eval.parse_results import aggregate, parse_eval_detailed_file

    _, _, rows = evals
    fn = rows["port", "exact"][1]
    lines = open(fn).read().splitlines()
    assert lines[0] == "SampleID | " + " ".join(ALL_METRICS)
    vals, _, keys = parse_eval_detailed_file(fn)
    assert keys == ALL_METRICS
    assert sum(v.shape[0] for v in vals.values()) == N_SAMPLES
    assert all(np.isfinite(v).all() for v in vals.values())
    got, want = aggregate(fn), jax_aggregate(rows["jax", "exact"][1])
    assert set(got) == set(want) == {"MSE", "STFT", "ENV", "EMD"}
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=5e-3, atol=5e-4, err_msg=key)


def test_last_batch_is_padded_with_zero_lanes(evals):
    """The final partial batch goes to the device at full size with zero
    lanes; its ids stay the real ones."""
    root, model_dir, _ = evals
    ev = Evaluator(model_dir, batch_size=BATCH, db_dir=root, n_workers=1, device="cpu")
    batch = {"id": ["a 0.5"], "ambix": np.ones((1, 5, 4), np.float32),
             "audio_mask": np.ones((1, 4), np.float32)}
    padded, n = ev._pad(batch)
    assert n == 1 and padded["id"] == ["a 0.5"]
    assert padded["ambix"].shape == (BATCH, 5, 4)
    assert (padded["ambix"][1:] == 0).all() and (padded["audio_mask"][1:] == 0).all()


def test_restore_needs_params(evals, tmp_path):
    """A dir exported from JAX has params.npz and no train_state.pt: the
    step is unknown. A dir without params.npz raises, as the JAX
    Evaluator's "no checkpoint found" does."""
    root, model_dir, _ = evals
    ev = Evaluator(model_dir, batch_size=BATCH, db_dir=root, device="cpu")
    assert ev.restored_step is None
    TrainConfig.load(model_dir).save(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="params.npz"):
        Evaluator(str(tmp_path), db_dir=root, device="cpu")


def test_refusals(evals):
    """A mesh whose data ranks the batch does not divide over (the JAX
    Evaluator asserts it), an unknown EMD mode, and the card where there
    is none: each raises before any model loads."""
    from spatialaudiogen_tpu_torch.parallel.mesh import Mesh

    root, model_dir, _ = evals
    with pytest.raises(ValueError, match="divide"):
        Evaluator(model_dir, db_dir=root, batch_size=3,
                  mesh=Mesh(n_data=2, data_group=object()), device="cpu")
    with pytest.raises(ValueError, match="emd_mode"):
        Evaluator(model_dir, db_dir=root, emd_mode="approx", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            Evaluator(model_dir, db_dir=root)


def test_cli_overwrite_guard_covers_shards(tmp_path):
    """Stale per-shard files block a rerun unless --overwrite, which removes
    them (mirrors tests/test_eval.py's test of the JAX CLI)."""
    model_dir = str(tmp_path / "m")
    os.makedirs(model_dir)
    stale = os.path.join(model_dir, "eval-detailed.txt.shard3")
    open(stale, "w").write("SampleID | stale\n")
    with pytest.raises(FileExistsError, match="shard3"):
        cli_main([model_dir, "--device", "cpu"])
    # --overwrite removes the stale shard; the run then fails for want of
    # a train-params file
    with pytest.raises(FileNotFoundError, match="params"):
        cli_main([model_dir, "--overwrite", "--device", "cpu"])
    assert not os.path.exists(stale)


def test_cli_refuses_n_data(tmp_path):
    """--n_data runs (tests/test_torch_sharded.py), but the eval batch must
    divide over the ranks, as the JAX Evaluator asserts: ValueError before
    any model is loaded or file touched (the model dir is empty)."""
    with pytest.raises(ValueError, match="divide"):
        cli_main([str(tmp_path), "--n_data", "2", "--batch_size", "3", "--device", "cpu"])


def test_cli_compute_dtype_bfloat16(evals, capsys):
    """cli.eval --compute_dtype bfloat16 scores the float32 checkpoint with
    bf16 conv/FC products: every sample, finite, into
    MODEL_DIR/eval-detailed.txt; the STFT distance moves from the float32
    run's but stays near it. parse_eval_results reads the file."""
    from spatialaudiogen_tpu_torch.cli.parse_eval_results import main as parse_main

    from spatialaudiogen_tpu_torch.eval.parse_results import parse_eval_detailed_file

    root, model_dir, rows = evals
    cli_main([model_dir, "--db_dir", root, "--batch_size", str(BATCH), "--n_workers", "1",
              "--compute_dtype", "bfloat16", "--device", "cpu", "--overwrite"])
    fn = os.path.join(model_dir, "eval-detailed.txt")
    vals, _, keys = parse_eval_detailed_file(fn)
    got = np.concatenate(list(vals.values()))
    assert got.shape == (N_SAMPLES, len(ALL_METRICS)) and np.isfinite(got).all()
    stft = got[:, keys.index("stft/avg")].mean()
    f32 = np.mean([rec["stft/avg"] for rec in rows["port", "exact"][0].values()])
    assert stft != f32
    np.testing.assert_allclose(stft, f32, rtol=0.1)
    capsys.readouterr()
    parse_main([fn])
    assert [line.split(" = ")[0] for line in capsys.readouterr().out.splitlines()] == [
        "MSE", "STFT", "ENV", "EMD"]


# --- TF32 scope -------------------------------------------------------------

class _TF32Log(torch.overrides.TorchFunctionMode):
    """Records torch's TF32 switches at every matmul-like call."""

    OPS = {"matmul", "einsum", "__matmul__", "mm", "bmm", "conv2d", "conv_transpose2d"}

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") in self.OPS:
            self.seen.append((torch.backends.cuda.matmul.allow_tf32,
                              torch.backends.cudnn.allow_tf32))
        return func(*args, **(kwargs or {}))


def _small_model(dft_precision):
    cfg = SptAudioGenConfig(sep_num_tracks=2, dft_precision=dft_precision)
    return SptAudioGen(cfg, frame_hw=FRAME_HW).init_weights(torch.Generator().manual_seed(0))


def _tf32_switches():
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


def test_metrics_run_full_float32_after_a_tf32_forward():
    """A dft_precision="default" model's forward (TF32 allowed inside it)
    interleaved with the device eval metrics: the switches read True in
    the forward and False in every matmul of mel-LSD, the envelope and the
    Sinkhorn EMD, whatever the process had set, and each scope restores
    what it found; the metric values do not move."""
    from spatialaudiogen_tpu_torch.ops.eval_metrics import envelope_dist_fn, mel_lsd_batch_fn
    from spatialaudiogen_tpu_torch.ops.sinkhorn import ambix_emd_batch_fn

    rng = np.random.RandomState(0)
    pred = torch.from_numpy((rng.randn(2, 4800, 4) * 0.1).astype(np.float32))
    gt = pred + torch.from_numpy((rng.randn(2, 4800, 4) * 0.05).astype(np.float32))
    fns = {"mel": mel_lsd_batch_fn(48000), "env": envelope_dist_fn(4800),
           "emd": ambix_emd_batch_fn(48000, 30.0, n_iters=4)}

    def metrics():
        return {k: fn(pred, gt) for k, fn in fns.items()}

    model = _small_model("default")
    g = model.cfg.geometry
    audio = torch.from_numpy((rng.randn(2, g.snd_size, 1) * 0.1).astype(np.float32))
    video = torch.from_numpy(rng.rand(2, g.vid_dur, *FRAME_HW, 3).astype(np.float32) - 0.5)
    saved = _tf32_switches()
    try:
        for process in ((False, True), (True, True), (False, False)):
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = process
            before = metrics()
            with _TF32Log() as fwd_log:
                with torch.no_grad():
                    model(audio, video)
            assert fwd_log.seen and all(s == (True, True) for s in fwd_log.seen)
            assert _tf32_switches() == process
            with _TF32Log() as log:
                after = metrics()
            assert log.seen and all(s == (False, False) for s in log.seen), log.seen
            assert _tf32_switches() == process
            for key in before:
                torch.testing.assert_close(after[key], before[key], rtol=0, atol=0)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.parametrize("dft_precision, tf32", [("default", True), ("highest", False)])
def test_train_step_backward_runs_under_its_forward_precision(dft_precision, tf32):
    """train_step's forward, loss and backward all run under the model's
    dft_precision (the backward's aten ops too), and the process switches
    are back as found afterwards; eval_step likewise."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from spatialaudiogen_tpu_torch.train.lr import make_optimizer as torch_optimizer
    from spatialaudiogen_tpu_torch.train.state import TrainState
    from spatialaudiogen_tpu_torch.train.steps import eval_step, train_step

    class AtenLog(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name in ("mm", "bmm", "addmm", "convolution", "convolution_backward"):
                self.seen.setdefault(name, set()).add(_tf32_switches())
            return func(*args, **(kwargs or {}))

    model = _small_model(dft_precision)
    g = model.cfg.geometry
    gen = torch.Generator().manual_seed(1)
    batch = {"ambix": 0.1 * torch.randn((2, g.snd_size, 4), generator=gen),
             "audio_mask": torch.ones((2, 4)),
             "video": torch.randint(0, 256, (2, g.vid_dur) + FRAME_HW + (3,), generator=gen,
                                    dtype=torch.uint8)}
    state = TrainState(model, torch_optimizer(model.parameters()))
    saved = _tf32_switches()
    try:
        process = (not tf32, not tf32)
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = process
        with AtenLog() as log:
            train_step(state, batch, 1e-4)
        assert "convolution_backward" in log.seen, sorted(log.seen)
        assert all(s == {(tf32, tf32)} for s in log.seen.values()), log.seen
        assert _tf32_switches() == process
        with AtenLog() as log:
            eval_step(model, batch)
        assert log.seen and all(s == {(tf32, tf32)} for s in log.seen.values()), log.seen
        assert _tf32_switches() == process
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
