"""The port's ResNets against the JAX package's on the CPU: ResNet18's
truncate_at / ends / fc head, the bottleneck ResNets (a one-block-a-stage
ResNetBottleneck forward and train-mode BN update; ResNet-50/101/152
parameter names and shapes against jax.eval_shape of JAX's), and the
caffe-style npy loader. Weights come across through
models.convert.from_flax; inputs are drawn from a seed with numpy.
"""

import jax
import numpy as np
import pytest
import torch

from spatialaudiogen_tpu.models import resnet as jax_resnet
from spatialaudiogen_tpu_torch.models import resnet as port_resnet
from spatialaudiogen_tpu_torch.models.convert import from_flax, to_flax
from seeded_variables import seeded_variables

torch.set_num_threads(1)


def flat_variables(variables) -> dict:
    return {"/".join(k.key for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(variables)[0]}


def flat_shapes(tree) -> dict:
    return {"/".join(k.key for k in path): tuple(x.shape)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def jax_run(model, variables, x, train: bool = True):
    """A jitted JAX apply with mutable batch_stats -> ((y, ends), new state)."""
    return jax.jit(lambda v, a: model.apply(v, a, train=train, mutable=["batch_stats"]))(
        variables, x)


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


def _check_ends(got: dict, want: dict, tol: float) -> None:
    """Every end of `got` against the same name in `want` (a jitted
    function's dict comes back with its keys sorted)."""
    for name, mine in got.items():
        value = np.asarray(want[name])
        mine = mine.detach().numpy()
        if mine.ndim == 4:
            mine = mine.transpose(0, 2, 3, 1)
        assert mine.shape == value.shape, name
        assert rel_l2(mine, value) <= tol, (name, rel_l2(mine, value))


@pytest.fixture(scope="module")
def resnet18_jax():
    """JAX's full ResNet18 (10 classes) on batch statistics: its variables,
    input, output and ends. A truncated JAX ResNet18 is the same code
    returning at `truncate_at`, so its output is this run's end there."""
    x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32) - 0.5
    model = jax_resnet.ResNet18(truncate_at=None, num_classes=10)
    variables = seeded_variables(model, x, seed=0)
    (y, ends), _ = jax_run(model, variables, x)
    return flat_variables(variables), x, {"fc": y, **ends}


@pytest.mark.parametrize("truncate_at", [None, "conv5_2", "conv3_1", "conv1"])
def test_resnet18_truncate_at_ends_and_fc_match_jax(resnet18_jax, truncate_at):
    """ResNet18(truncate_at) forward on batch statistics, output and every
    end within 1e-5 relative L2 of JAX's (float32 reduction order through
    up to 17 layers); the full network's fc over the global mean."""
    flat, x, want = resnet18_jax
    port = port_resnet.ResNet18(truncate_at=truncate_at, num_classes=10)
    mine = from_flax(flat)
    if truncate_at is not None:
        mine = {k: v for k, v in mine.items() if k in port.state_dict()}
    port.load_state_dict(mine, strict=True)
    with torch.no_grad():
        got, got_ends = port(_nchw(x), return_ends=True)
    names = ["conv1"] + [f"conv{s}_{b}" for s in range(2, 6) for b in (1, 2)] + ["fc"]
    assert list(got_ends) == names[: names.index(truncate_at or "fc") + 1]
    assert torch.equal(got, got_ends[truncate_at or "fc"])
    _check_ends(got_ends, want, 1e-5)
    assert hasattr(port, "fc") == (truncate_at is None)


def test_resnet18_encoder_keys_unchanged():
    """The model's encoder (truncate_at conv5_2, the default) holds exactly
    the JAX encoder's variables and no fc: params.npz, models/convert.py and
    every model dir keep their names."""
    port = port_resnet.ResNet18()
    model = jax_resnet.ResNet18(truncate_at="conv5_2")
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               np.zeros((1, 64, 64, 3), np.float32)))
    got = {k: v.shape for k, v in to_flax(port.state_dict()).items()}
    assert got == flat_shapes(shapes)
    assert not any("fc" in k for k in port.state_dict())


@pytest.fixture(scope="module")
def bottleneck_jax():
    """JAX's ResNetBottleneck(stage_blocks=(1, 1, 1, 1)), 7 classes, with
    seeded variables (running averages away from their init, so that
    train=False reads them): the model, its variables (flat and nested)
    and a 32x32 batch."""
    x = np.random.RandomState(1).rand(2, 32, 32, 3).astype(np.float32) - 0.5
    model = jax_resnet.ResNetBottleneck(stage_blocks=(1, 1, 1, 1), num_classes=7)
    nested = seeded_variables(model, x, train=False, seed=1)
    return model, flat_variables(nested), nested, x


@pytest.mark.parametrize("train", [True, False])
def test_bottleneck_resnet_matches_jax(bottleneck_jax, train):
    """ResNetBottleneck(stage_blocks=(1, 1, 1, 1)) at 32x32, batch 2:
    logits and every end within 1e-4 relative L2 of JAX's (on batch
    statistics res5a's BN normalises over two values, 1x1 each, which
    scales float32 rounding up: 1.7e-5 seen); with train=True the BN
    running averages after the step equal JAX's batch_stats within 1e-6
    absolute plus 1e-5 relative (each takes 0.01 of a batch moment that
    carries the forward's rounding; 1.7e-7 seen)."""
    model, flat, nested, x = bottleneck_jax
    (y, ends), new_state = jax_run(model, nested, x, train=train)
    port = port_resnet.ResNetBottleneck(stage_blocks=(1, 1, 1, 1), num_classes=7)
    port.load_state_dict(from_flax(flat), strict=True)
    with torch.no_grad():
        got, got_ends = port(_nchw(x), batch_stats=train, update_stats=train,
                             return_ends=True)
    assert list(got_ends) == ["conv1", "res2a", "res3a", "res4a", "res5a", "fc1000"]
    _check_ends({"out": got, **got_ends}, {"out": y, **ends}, 1e-4)
    if train:
        moved = flat_variables({"batch_stats": new_state["batch_stats"]})
        for key, value in from_flax(moved).items():
            np.testing.assert_allclose(port.state_dict()[key].numpy(), value.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("name, blocks", [("ResNet50", (3, 4, 6, 3)),
                                          ("ResNet101", (3, 4, 23, 3)),
                                          ("ResNet152", (3, 8, 36, 3))])
def test_deep_resnet_names_match_jax(name, blocks):
    """Every parameter and running average of ResNet50/101/152 under JAX's
    name with JAX's shape (jax.eval_shape of JAX's init, no forward): the
    caffe names res2a..res5c, b{i} in ResNet152's res4, branch1 on each
    stage's first block only, fc1000."""
    model = getattr(jax_resnet, name)()
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               np.zeros((1, 32, 32, 3), np.float32),
                                               train=False))
    port = getattr(port_resnet, name)()
    got = {k: v.shape for k, v in to_flax(port.state_dict()).items()}
    assert got == flat_shapes(shapes)
    assert port.blocks[-1] == "res5c" and len(port.blocks) == sum(blocks)
    if name == "ResNet152":
        assert "res4b35" in port.blocks and "res4c" not in port.blocks


def _caffe_blob(variables, rng, conv1_in: int) -> dict:
    """A caffe-style npy dict for `variables`' network, drawn from rng."""
    params = variables["params"]

    def bn(layer):
        n = layer["scale"].shape[0]
        return {"scale": rng.rand(n).astype(np.float32) + 0.5,
                "offset": rng.randn(n).astype(np.float32),
                "mean": rng.randn(n).astype(np.float32),
                "variance": rng.rand(n).astype(np.float32) + 0.5}

    shape = params["conv1"]["conv"]["kernel"].shape
    blob = {"conv1": {"weights": rng.randn(*shape[:2], conv1_in, shape[3]).astype(np.float32)},
            "bn_conv1": bn(params["conv1"]["bn"])}
    for block, sub in params.items():
        if not block.startswith("res"):
            continue
        for branch, layer in sub.items():
            tag = f"{block[3:]}_{branch}"
            blob[f"res{tag}"] = {"weights": rng.randn(*layer["conv"]["kernel"].shape)
                                 .astype(np.float32)}
            blob[f"bn{tag}"] = bn(layer["bn"])
    fc = params["fc1000"]["kernel"].shape
    blob["fc1000"] = {"weights": rng.randn(*fc).astype(np.float32),
                      "biases": rng.randn(fc[1]).astype(np.float32)}
    return blob


def test_load_caffe_style_npy_matches_jax(bottleneck_jax, tmp_path):
    """A seed-drawn caffe-style blob (4-channel conv1, cut to 3) loaded by
    both packages: every variable equal to JAX's load but conv1's BN. JAX's
    loader sends bn_conv1 to its generic bn branch (as res/conv1/...),
    where nothing matches, so its own bn_conv1 branch never runs; the port
    loads bn_conv1 into conv1's BN, as that branch means to."""
    _, _, variables, _ = bottleneck_jax
    blob = _caffe_blob(variables, np.random.RandomState(5), conv1_in=4)
    path = tmp_path / "resnet.npy"
    np.save(path, blob, allow_pickle=True)
    want_vars, want_unmatched = jax_resnet.load_caffe_style_npy(str(path), variables)
    want = from_flax(flat_variables(want_vars))
    port = port_resnet.ResNetBottleneck(stage_blocks=(1, 1, 1, 1), num_classes=7)
    got, unmatched = port_resnet.load_caffe_style_npy(str(path), port.state_dict())
    assert unmatched == {}
    assert sorted(want_unmatched) == [f"res/conv1/bn/{leaf}" for leaf in
                                      ("beta", "gamma", "moving_mean", "moving_variance")]
    for key, value in want.items():
        if key.startswith("conv1.bn."):
            continue
        assert torch.equal(got[key], value), key
    bn = blob["bn_conv1"]
    for leaf, field in (("scale", "scale"), ("bias", "offset"), ("mean", "mean"),
                        ("var", "variance")):
        np.testing.assert_array_equal(got[f"conv1.bn.{leaf}"].numpy(), bn[field])
    np.testing.assert_array_equal(got["fc1000.weight"].numpy(), blob["fc1000"]["weights"].T)
    np.testing.assert_array_equal(got["conv1.conv.weight"].numpy(),
                                  blob["conv1"]["weights"][:, :, :3].transpose(3, 2, 0, 1))
