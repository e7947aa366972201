"""The released-model route of the port: cli/import_tf_checkpoint.py and
cli/export_to_tf_bundle.py against the JAX package's
tools/import_tf_checkpoint.py, tools/export_to_tf_bundle.py and
tools/export_torch_weights.py.

For each encoder set (audio; audio + video; audio + flow + video) the
module makes a JAX model dir (reduced geometry: 8 tracks, 64x128 frames),
exports it as a TF1 bundle with the JAX tool and imports that bundle with
the port's. Every variable of the JAX dir is drawn from a seed, BN
statistics included (variances in [0.5, 2], so a swapped or dropped
moving_variance shows): the route moves values and never runs the model.
Everything is compared bit for bit: the port's params.npz against
tools/export_torch_weights.py of the JAX dir, the port's own bundle
against the JAX tool's bundle, and the JAX import of the port's bundle
against the JAX dir's variables.

Two things of the JAX package are replaced while the module runs, both
for time. The JAX writer's CRC32C is a byte loop (0.43-0.63 s a MB by
tools/time_tf_bundle_crc.py; these bundles hold 50 to 150 MB): it runs through the port's crc32c,
which tests/test_torch_tf_bundle.py holds to the JAX function bit for
bit. And create_train_state, which the JAX tools call for a restore
target's structure, returns numpy zeros of the shapes jax.eval_shape
traces, once per configuration, instead of compiling the model's
initialisation (about 10 s a configuration on XLA:CPU).
"""

import contextlib
import io
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spatialaudiogen_tpu.train.state as jax_state
import spatialaudiogen_tpu.utils.tf_bundle as jax_tf_bundle
from spatialaudiogen_tpu.config import TrainConfig as JaxTrainConfig
from spatialaudiogen_tpu.models import SptAudioGen as JaxModel
from spatialaudiogen_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from spatialaudiogen_tpu.train.lr import make_optimizer as jax_make_optimizer
from spatialaudiogen_tpu_torch.cli import export_to_tf_bundle, import_tf_checkpoint
from spatialaudiogen_tpu_torch.config import TrainConfig
from spatialaudiogen_tpu_torch.models.convert import nest, to_tf_var_dict
from spatialaudiogen_tpu_torch.train.checkpoint import STATE_FILE, latest_step, \
    restore_checkpoint
from spatialaudiogen_tpu_torch.train.state import create_train_state
from spatialaudiogen_tpu_torch.utils import tf_bundle


TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")
sys.path.insert(0, TOOLS)
import export_to_tf_bundle as jax_export_tool  # noqa: E402
import import_tf_checkpoint as jax_import_tool  # noqa: E402
from export_torch_weights import export as jax_export_weights  # noqa: E402

ENCODER_SETS = {"audio": ("audio",), "audio_video": ("audio", "video"),
                "audio_flow_video": ("audio", "flow", "video")}
STEP = 7
FRAME_HW = (64, 128)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def run(main, argv) -> tuple[list, object]:
    """(stdout lines, SystemExit code or None) of main(argv)."""
    code = None
    with contextlib.redirect_stdout(io.StringIO()) as out:
        try:
            main(argv)
        except SystemExit as stop:
            code = stop.code
    return out.getvalue().splitlines(), code


def npz(path) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def assert_bitwise(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
        assert np.array_equal(got[key], want[key]), key


def zeros(shapes):
    """numpy zeros in the place of each jax.ShapeDtypeStruct of a tree."""
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)


@contextlib.contextmanager
def shaped_init():
    """JAX's create_train_state (and its TF-bundle CRC) as the module
    docstring says, until the context ends. The model's variable shapes
    are traced once per configuration; the rest is create_train_state's
    own body over zeros."""
    shapes = {}

    def create(model, tx, rng, batch):
        key = (repr(model.cfg), sorted((k, np.shape(v)) for k, v in batch.items()))
        if repr(key) not in shapes:
            shapes[repr(key)] = jax.eval_shape(
                lambda r: jax_state.init_variables(model, r, batch), rng)
        variables = zeros(shapes[repr(key)])
        params = variables["params"]
        return jax_state.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                    batch_stats=variables.get("batch_stats", {}),
                                    opt_state=zeros(jax.eval_shape(tx.init, params)))

    patch = pytest.MonkeyPatch()
    patch.setattr(jax_state, "create_train_state", create)
    patch.setattr(jax_tf_bundle, "crc32c", tf_bundle.crc32c)
    try:
        yield
    finally:
        patch.undo()


def jax_model_dir(path: str, encoders: tuple, seed: int) -> None:
    """A JAX model dir at `path` with an orbax checkpoint at STEP whose
    variables are drawn from `seed` (BN variances in [0.5, 2])."""
    cfg = JaxTrainConfig(model_dir=path, encoders=encoders, separation="unet_mask",
                         num_sep_tracks=8, frame_hw=FRAME_HW, n_data=1)
    cfg.save()
    g = cfg.model_config().geometry
    example = {"ambix": np.zeros((1, g.snd_size, 4), np.float32),
               "audio_mask": np.ones((1, 4), np.float32)}
    for key in ("video", "flow"):
        if key in encoders:
            example[key] = np.zeros((1, g.vid_dur) + FRAME_HW + (3,), np.float32)
    state = jax_state.create_train_state(JaxModel(cfg.model_config()), jax_make_optimizer(),
                                         jax.random.PRNGKey(seed), example)
    rng = np.random.default_rng(seed)

    def draw(path_keys, x):
        if path_keys[-1].key == "var":
            return jnp.asarray(rng.uniform(0.5, 2.0, x.shape).astype(x.dtype))
        return jnp.asarray(rng.standard_normal(x.shape, np.float32).astype(x.dtype))

    params, stats = (jax.tree_util.tree_map_with_path(draw, tree)
                     for tree in (state.params, state.batch_stats))
    jax_save_checkpoint(path, state.replace(params=params, batch_stats=stats), STEP)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """{encoder set: paths} after the JAX dir's export to params.npz and to a
    bundle (JAX tools), and the port's import of that bundle. shaped_init()
    stays in place while the module's tests run."""
    root = tmp_path_factory.mktemp("tf_route")
    out = {}
    try:
        with shaped_init():
            for i, (name, encoders) in enumerate(ENCODER_SETS.items()):
                d = {key: str(root / f"{name}_{key}")
                     for key in ("jax", "bundle", "port", "port_bundle", "back")}
                jax_model_dir(d["jax"], encoders, seed=i + 1)
                jax_export_weights(d["jax"])
                run(jax_export_tool.main, [d["jax"], d["bundle"]])
                os.makedirs(d["port"])
                shutil.copy(os.path.join(d["jax"], "train-params.json"), d["port"])
                d["import_lines"], d["import_code"] = run(
                    import_tf_checkpoint.main, [d["port"], d["bundle"], "--step", str(STEP)])
                out[name] = d
            yield out
    finally:
        shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("name", list(ENCODER_SETS))
def test_port_import_of_jax_bundle_matches_jax_export(dirs, name):
    d = dirs[name]
    index = tf_bundle.read_index_file(os.path.join(d["bundle"], f"model.ckpt-{STEP}.index"))
    n = len(index["entries"]) - 1      # global_step dropped
    assert d["import_code"] is None
    assert d["import_lines"] == [f"Matched {n}/{n} TF variables",
                                 f"Wrote checkpoint step {STEP} to {d['port']}"]
    want = npz(os.path.join(d["jax"], "params.npz"))
    assert_bitwise(npz(os.path.join(d["port"], "params.npz")), want)
    # the BN statistics came through as drawn, not at their initial values
    # (the audio encoder has no BN)
    var = [k for k in want if k.startswith("batch_stats/") and k.endswith("/var")]
    assert (var or name == "audio") and all(not np.allclose(want[k], 1.0) for k in var)


@pytest.mark.parametrize("name", list(ENCODER_SETS))
def test_port_export_round_trips_through_jax_import(dirs, name):
    """The port's bundle is the JAX tool's, byte for byte; the JAX import
    of it gives back the JAX dir's variables bit for bit."""
    d = dirs[name]
    lines, code = run(export_to_tf_bundle.main, [d["port"], d["port_bundle"]])
    prefix = os.path.join(d["port_bundle"], f"model.ckpt-{STEP}")
    entries = tf_bundle.read_index_file(prefix + ".index")["entries"]
    assert code is None and lines == [f"Exported {len(entries)} variables to {prefix}.*"]
    # (the JAX tool's bundle holds global_step STEP as int64, a scalar)
    assert (entries["global_step"].dtype, entries["global_step"].shape) == (9, ())
    for fn in (f"model.ckpt-{STEP}.index", f"model.ckpt-{STEP}.data-00000-of-00001",
               "checkpoint"):
        with open(os.path.join(d["bundle"], fn), "rb") as a, \
                open(os.path.join(d["port_bundle"], fn), "rb") as b:
            assert a.read() == b.read(), fn

    os.makedirs(d["back"])
    shutil.copy(os.path.join(d["jax"], "train-params.json"), d["back"])
    lines, code = run(jax_import_tool.main, [d["back"], d["port_bundle"], "--step", str(STEP)])
    assert code is None, lines
    jax_export_weights(d["back"])
    assert_bitwise(npz(os.path.join(d["back"], "params.npz")),
                   npz(os.path.join(d["jax"], "params.npz")))


def test_npz_route(dirs, tmp_path):
    """An npz (and a pickled-dict npy) of TF variable names, as
    tools/export_tf_checkpoint.py writes, imports as the bundle does."""
    d = dirs["audio"]
    tf_vars = tf_bundle.load_tf_checkpoint(d["bundle"])
    del tf_vars["global_step"]
    np.savez(tmp_path / "vars.npz", **tf_vars)
    np.save(tmp_path / "vars.npy", tf_vars, allow_pickle=True)
    want = npz(os.path.join(d["jax"], "params.npz"))
    for fn in ("vars.npz", "vars.npy"):
        model_dir = tmp_path / fn.replace(".", "_")
        model_dir.mkdir()
        shutil.copy(os.path.join(d["jax"], "train-params.json"), model_dir)
        lines, code = run(import_tf_checkpoint.main, [str(model_dir), str(tmp_path / fn)])
        assert code is None and lines[0] == f"Matched {len(tf_vars)}/{len(tf_vars)} TF variables"
        assert_bitwise(npz(model_dir / "params.npz"), want)


def test_unmatched_variables_exit_as_jax(dirs, tmp_path):
    """A bundle with variables the model lacks (and an Adam slot, dropped):
    the same lines and exit from both importers, and both write with
    --allow_unmatched."""
    d = dirs["audio"]
    tf_vars = tf_bundle.load_tf_checkpoint(d["bundle"])
    tf_vars["bogus/scope/weights"] = np.ones((3, 3), np.float32)
    tf_vars["audio_encoder/extra/moving_mean"] = np.zeros(5, np.float32)
    tf_vars["audio_encoder/conv1/weights/Adam_1"] = np.zeros(2, np.float32)
    bundle = str(tmp_path / "bundle" / "model.ckpt-3")
    tf_bundle.save_tf_checkpoint(bundle, tf_vars)
    results = {}
    for who, main in (("jax", jax_import_tool.main), ("port", import_tf_checkpoint.main)):
        model_dir = tmp_path / who
        model_dir.mkdir()
        shutil.copy(os.path.join(d["jax"], "train-params.json"), model_dir)
        results[who] = run(main, [str(model_dir), bundle])
        assert sorted(os.listdir(model_dir)) == ["train-params.json"], who
        lines, code = run(main, [str(model_dir), bundle, "--allow_unmatched"])
        assert code is None, (who, lines)
        results[who + "_allowed"] = lines[:-1]     # the last names the dir written
    lines, code = results["port"]
    n = len(tf_vars) - 2
    assert lines == [f"Matched {n - 2}/{n} TF variables",
                     "  unmatched: audio_encoder/extra/moving_mean (5,)",
                     "  unmatched: bogus/scope/weights (3, 3)"]
    assert code == "Unmatched variables; re-run with --allow_unmatched to accept."
    assert results["port"] == results["jax"]
    assert results["port_allowed"] == results["jax_allowed"] == lines
    assert_bitwise(npz(tmp_path / "port" / "params.npz"), npz(os.path.join(d["jax"], "params.npz")))


def test_step_lands_in_train_state(dirs, tmp_path):
    """--step is the checkpoint's step: train_state.pt holds it with a fresh
    Adam state, a restore resumes at it, and the exporter writes it as
    global_step. A dir with no checkpoint is refused by the exporter."""
    d = dirs["audio_video"]
    saved = torch.load(os.path.join(d["port"], STATE_FILE), map_location="cpu",
                       weights_only=True)
    assert saved["step"] == STEP and latest_step(d["port"]) == STEP
    assert saved["optimizer"]["state"] == {}
    state = create_train_state(TrainConfig.load(d["port"]), "cpu", seed=5)
    assert restore_checkpoint(d["port"], state) == STEP and state.step == STEP
    # the JAX tool's bundle holds to_tf_var_dict of the exported params
    bundle = tf_bundle.load_tf_checkpoint(d["bundle"], verify_crc=True)
    assert int(bundle.pop("global_step")) == STEP
    assert_bitwise(bundle, to_tf_var_dict(nest(npz(os.path.join(d["jax"], "params.npz")))))

    bare = tmp_path / "bare"
    bare.mkdir()
    for fn in ("train-params.json", "params.npz"):
        shutil.copy(os.path.join(d["jax"], fn), bare)
    lines, code = run(export_to_tf_bundle.main, [str(bare), str(tmp_path / "out")])
    assert code == f"no checkpoint in {bare}" and not (tmp_path / "out").exists()
