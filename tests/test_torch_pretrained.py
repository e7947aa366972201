"""--pretrained_resnet in the port: a reference-style resnet18.npy (TF
variable names, written here from the JAX package's to_tf_var_dict of
random visual-encoder variables, conv1 widened to 4 input channels, plus
an fc1000 entry the encoder does not have) loads through the port's
load_npy_weights to exactly what the JAX package's load_npy_weights
gives, with conv1 cut to 3 channels and the same unmatched entries; and
cli.train starts from it on a fresh run and ignores it on --resume from a
checkpoint."""

import shutil

import numpy as np
import pytest
import torch

from spatialaudiogen_tpu.config import TrainConfig as JaxTrainConfig
from spatialaudiogen_tpu.data.synthetic import make_synthetic_dataset
from spatialaudiogen_tpu.models import SptAudioGen as JaxModel
from spatialaudiogen_tpu.models.convert import to_tf_var_dict
from spatialaudiogen_tpu.models.resnet import load_npy_weights as jax_load_npy_weights
from spatialaudiogen_tpu.train.state import init_variables
from spatialaudiogen_tpu_torch.cli import train as cli_train
from spatialaudiogen_tpu_torch.config import TrainConfig
from spatialaudiogen_tpu_torch.models import convert
from spatialaudiogen_tpu_torch.models.convert import from_flax, load_params, to_flax
from spatialaudiogen_tpu_torch.models.resnet import load_npy_weights
from spatialaudiogen_tpu_torch.models.sptaudiogen import SptAudioGen

CFG = dict(encoders=("audio", "video"), separation="unet_mask", num_sep_tracks=2,
           frame_hw=(64, 128))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one thread in this module: its work is many small ops, and
    the other test workers' threads share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def drop_model_dirs(tmp_path):
    """Each test's model dirs go when it ends: a checkpoint of this model
    is 300 MB."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def flat(tree: dict) -> dict:
    import jax

    return {"/".join(k.key for k in path): np.array(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def npy(tmp_path_factory):
    """(npy path, JAX variables of the reduced model)."""
    import jax

    jcfg = JaxTrainConfig(**CFG)
    g = jcfg.model_config().geometry
    example = {"video": np.zeros((1, g.vid_dur) + CFG["frame_hw"] + (3,), np.float32)}
    variables = init_variables(JaxModel(jcfg.model_config()), jax.random.PRNGKey(0), example)
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    rng = np.random.RandomState(4)
    visual = {coll: jax.tree_util.tree_map(
        lambda x: rng.randn(*x.shape).astype(np.float32), variables[coll]["video_encoder"])
        for coll in ("params", "batch_stats")}
    blob = to_tf_var_dict(visual)
    blob["conv1/weights"] = np.concatenate(
        [blob["conv1/weights"], rng.randn(*blob["conv1/weights"].shape[:2], 1, 64)
         .astype(np.float32)], axis=2)
    blob["fc1000/weights"] = rng.randn(512, 1000).astype(np.float32)
    path = tmp_path_factory.mktemp("resnet") / "resnet18.npy"
    np.save(path, blob, allow_pickle=True)
    return str(path), variables


def test_load_matches_the_jax_package(npy):
    path, variables = npy
    want, want_unmatched = jax_load_npy_weights(path, variables, prefix="video_encoder")
    want = flat(want)
    model = SptAudioGen(TrainConfig(**CFG).model_config(), frame_hw=CFG["frame_hw"])
    model.load_state_dict(from_flax(flat(variables)), strict=True)
    sd, unmatched = load_npy_weights(path, model.state_dict(), prefix="video_encoder")
    assert sorted(unmatched) == sorted(want_unmatched) == ["video_encoder/fc1000/weights"]
    got = to_flax(sd)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    blob = np.load(path, allow_pickle=True).item()
    conv1 = got["params/video_encoder/conv1/conv/kernel"]
    np.testing.assert_array_equal(conv1, blob["conv1/weights"][:, :, :3])
    moved = [k for k in got if not np.array_equal(got[k], flat(variables)[k])]
    assert moved and all("/video_encoder/" in k for k in moved)


def test_numpy_half_of_the_name_mapping(npy):
    """to_tf_var_dict and restore_tf_var_dict of the port's copy round-trip
    the JAX variables, and name them as the JAX package does."""
    _, variables = npy
    visual = {coll: variables[coll]["video_encoder"] for coll in ("params", "batch_stats")}
    names = convert.to_tf_var_dict(visual)
    assert set(names) == set(to_tf_var_dict(visual))
    back, unmatched = convert.restore_tf_var_dict(names, convert.nest(flat(visual)))
    assert not unmatched
    for k, v in flat(visual).items():
        np.testing.assert_array_equal(convert.flatten(back)[k], v)


def test_cli_starts_from_the_npy_and_resume_ignores_it(npy, tmp_path, capsys):
    path, _ = npy
    db = tmp_path / "db"
    make_synthetic_dataset(str(db), n_videos=1, duration=3.0, frame_hw=CFG["frame_hw"], seed=5)
    model_dir = tmp_path / "model"
    argv = [str(db), str(model_dir), "--encoders", "audio", "video", "--num_sep_tracks", "2",
            "--frame_hw", "64", "128", "--batch_size", "2", "--n_workers", "1",
            "--log_every", "1", "--ckpt_every", "0", "--device", "cpu"]
    cli_train.main(argv + ["--n_iters", "0", "--pretrained_resnet", path])
    assert "Initialized video_encoder" in capsys.readouterr().out
    saved = to_flax(load_params(str(model_dir)))
    blob = np.load(path, allow_pickle=True).item()
    np.testing.assert_array_equal(saved["params/video_encoder/conv1/conv/kernel"],
                                  blob["conv1/weights"][:, :, :3])
    np.testing.assert_array_equal(saved["batch_stats/video_encoder/conv2_1/conv_1/bn/mean"],
                                  blob["conv2_1/conv_1/bn/moving_mean"])
    # a step trains from there; --resume from that checkpoint ignores the npy
    cli_train.main(argv + ["--n_iters", "1", "--pretrained_resnet", path])
    trained = load_params(str(model_dir))
    state, step = cli_train.main(argv + ["--n_iters", "1", "--resume",
                                         "--pretrained_resnet", path])
    assert step == 1 and "--pretrained_resnet ignored" in capsys.readouterr().out
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, trained[k]), k
