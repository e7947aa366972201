"""The plain reference held to the port's CPU route at small shapes (64x128
frames, 8 tracks): the forward, the loss and a train step with its
gradients, Adam and BN averages; the masked ISTFT and its gradient against
the port's plain versions at both routes; windows rebuilt from a pack
against the port's reader; the count of work.

    python -m pytest port_bench/tests -q
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from port_bench.harness.packs import write_db
from port_bench.harness.weights import make_weights
from port_bench.reference import model as ref_model
from port_bench.reference import work
from port_bench.reference.model import ModelShape, Precision
from port_bench.reference.train import ReferenceTrainer, trainable
from port_bench.reference.windows import rebuild_batch

SMALL_HW = (64, 128)
TRACKS = 8
SEED = 2 ** 35 + 11


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _batch(encoders, b=3, seed=0):
    rng = np.random.default_rng(seed)
    out = {"ambix": torch.tensor(0.3 * rng.standard_normal((b, 52799, 4)), dtype=torch.float32),
           "audio_mask": torch.tensor([[1.0, 1.0, 0.0, 1.0]] * (b - 1) + [[1.0] * 4])}
    if "video" in encoders:
        out["video"] = torch.tensor(rng.integers(0, 256, (b, 1, *SMALL_HW, 3), dtype=np.uint8))
    if "flow" in encoders:
        out["flow"] = torch.tensor(rng.standard_normal((b, 1, *SMALL_HW, 3)), dtype=torch.float32)
    return out


def _port_state(encoders, weights, compute_dtype="float32"):
    from spatialaudiogen_tpu_torch.config import TrainConfig
    from spatialaudiogen_tpu_torch.train.state import create_train_state

    cfg = TrainConfig(encoders=encoders, num_sep_tracks=TRACKS, frame_hw=SMALL_HW,
                      compute_dtype=compute_dtype)
    state = create_train_state(cfg, "cpu")
    state.model.load_state_dict(weights, strict=True)
    return state


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.parametrize("encoders", [("audio", "video"), ("audio", "flow", "video")])
def test_train_steps_follow_the_port(encoders):
    """Two steps, held by the benchmark's own measures (drivers/train.py
    compare: norms per tensor, against the larger of its own and the
    median's)."""
    from spatialaudiogen_tpu_torch.train.steps import train_step

    from port_bench.drivers.train import compare

    m = ModelShape(encoders=encoders, tracks=TRACKS, frame_hw=SMALL_HW)
    weights = make_weights(m, SEED, "cpu")
    state = _port_state(encoders, weights)
    # the port's CPU route runs the masked ISTFT in float32
    ref = ReferenceTrainer(weights, m, Precision(istft_bf16=False))
    named = dict(state.model.named_parameters())
    losses = []
    for i in range(2):
        batch = _batch(encoders, seed=i)
        losses.append(float(train_step(state, batch, 1e-4)["total_loss"]))
        ref.step(batch, 1e-4)
        if i == 0:
            first = [float((state.optimizer.state[named[k]]["exp_avg"] / 0.1).norm())
                     for k in trainable(m)]
    sd = state.model.state_dict()
    prog = {"losses": losses, "first_grads": first,
            "change": [float((sd[k] - weights[k]).norm()) for k in weights]}
    ref_losses = []
    again = ReferenceTrainer(weights, m, Precision(istft_bf16=False))
    for i in range(2):
        ref_losses.append(again.step(_batch(encoders, seed=i), 1e-4))
    want = {"losses": ref_losses,
            "first_grads": [float(ref.first_grads[k].norm()) for k in trainable(m)],
            "change": [float((ref.params[k] - weights[k]).norm()) for k in weights]}
    got = compare(prog, want, m, list(weights))
    assert abs(losses[0] - ref_losses[0]) <= 1e-6 * abs(ref_losses[0])
    # after the first step Adam has moved every weight by about the learning
    # rate whatever its gradient's size, so rounding in near-zero gradients
    # shows in the next loss and in each tensor's change; float32 rounding
    # through batch statistics of 3 rows reaches the first convolution's
    # gradient at some 5e-3, where the TF32 control reads 3e-2 at these shapes
    assert got["loss_gap"] <= 1e-5
    assert got["grad_gap"] <= 1e-2
    assert got["change_gap"] <= 2e-2
    assert got["bn_gap"] <= 1e-3


def test_bf16_forward_follows_the_port():
    encoders = ("audio", "flow", "video")
    m = ModelShape(encoders=encoders, tracks=TRACKS, frame_hw=SMALL_HW)
    weights = make_weights(m, SEED, "cpu")
    model = _port_state(encoders, weights, "bfloat16").model
    batch = _batch(encoders)
    video = batch["video"].float() / 255.0 - 0.5
    with torch.no_grad():
        got = model(batch["ambix"][:, :, :1], video, batch["flow"], train=True,
                    update_stats=False)
        want = ref_model.forward(weights, batch, m,
                                 Precision(compute=torch.bfloat16, istft_bf16=False))
        f32 = ref_model.forward(weights, batch, m, Precision(istft_bf16=False))
    # bf16 rounding through some 30 layers of random weights: on the CPU,
    # whose bf16 kernels accumulate otherwise than the card's, the port and
    # the reference part by about 1e-2, as each parts from float32
    assert _rel(got, want) <= 2e-2
    assert _rel(want, f32) >= 5e-3


@pytest.mark.parametrize("precision", ["default", "highest"])
def test_masked_istft_and_its_gradient_follow_the_plain_kernels(precision):
    from spatialaudiogen_tpu_torch.ops.masked_istft import (
        masked_istft_bwd_plain,
        masked_istft_plain,
    )

    gen = torch.Generator().manual_seed(3)
    re, im = (torch.randn(2, 1, 28, 1024, generator=gen) for _ in range(2))
    mask = torch.rand(2, 1, 4, 28, 1024, generator=gen).requires_grad_(True)
    re.requires_grad_(True)
    im.requires_grad_(True)
    p = Precision(istft_bf16=precision == "default")
    out = ref_model.masked_istft(re, im, mask, p)
    want = masked_istft_plain(re.detach(), im.detach(), mask.detach(), 4, precision)
    assert _rel(out.detach(), want) <= 1e-6
    g = torch.randn(out.shape, generator=gen)
    d_re, d_im, d_mask = torch.autograd.grad(out, (re, im, mask), g)
    w_re, w_im, w_mask = masked_istft_bwd_plain(re.detach(), im.detach(), mask.detach(), g, 4,
                                                precision)
    for got, want in ((d_re, w_re), (d_im, w_im), (d_mask, w_mask)):
        assert _rel(got, want) <= 1e-5


def test_tf32_and_fp8_controls_round_the_operands():
    x = torch.tensor([1.0 + 2 ** -12, 1.0 + 2 ** -10, -3.0 - 2 ** -10], requires_grad=True)
    y = ref_model.tf32_round(x)
    assert y.tolist() == [1.0, 1.0 + 2 ** -10, -3.0 - 2 ** -9]
    (g,) = torch.autograd.grad(y.sum(), x)
    assert g.tolist() == [1.0, 1.0, 1.0]
    p = Precision(compute=torch.bfloat16, round_to=torch.float8_e4m3fn)
    z = ref_model._operand(torch.tensor([1.05]), p)     # e4m3 steps by 1/8 here
    assert z.dtype == torch.bfloat16 and float(z) == 1.0


def test_windows_rebuilt_from_the_pack_match_the_port_reader(tmp_path):
    from spatialaudiogen_tpu_torch.data.readers import SampleReader, img_prep_u8

    folders = write_db(tmp_path, SEED, 2, 3, SMALL_HW, True)
    m = ModelShape(encoders=("audio", "flow", "video"), tracks=TRACKS, frame_hw=SMALL_HW)
    rows = []
    for i, folder in enumerate(folders):
        reader = SampleReader(str(folder), img_prep=img_prep_u8, return_flow=True,
                              skip_silence_thr=0.2, rng=np.random.RandomState(i))
        rows += [c for c in reader.loop_chunks(6)]
    assert len(rows) == 12
    batch = {k: [r[k] for r in rows] if k == "id" else np.stack([r[k] for r in rows])
             for k in rows[0]}
    rebuilt, gap = rebuild_batch(str(tmp_path), batch, m.geometry, m.encoders)
    assert gap <= 1e-6
    assert rebuilt["video"].dtype == np.uint8
    # one sample late is a different window
    late = {**batch, "ambix": np.roll(batch["ambix"], -1, axis=1)}
    assert rebuild_batch(str(tmp_path), late, m.geometry, m.encoders)[1] > 1e-2


def test_work_of_the_kernels_and_the_count_of_operations():
    flops, nbytes = work.istft_work(16, 1, 32, 28, 1024, "default", 4)
    assert flops == pytest.approx(60.13e9, rel=1e-3)       # the flagship call at batch 16
    assert work.bound_seconds(flops, nbytes, "default") == pytest.approx(flops / 989e12)
    m = ModelShape(tracks=TRACKS, frame_hw=SMALL_HW)
    fwd = work.count_flops(m, Precision(), 2, backward=False)
    step = work.count_flops(m, Precision(), 2, backward=True)
    assert set(fwd) == {"f32", "bf16"}
    # the masked ISTFT's GEMMs are charged at the declared bf16 route: one
    # product forward, one in the backward (K2 does the work K1 does)
    k_flops, _ = work.istft_work(2, 1, TRACKS, 28, 1024, "default", 4)
    assert fwd["bf16"] == pytest.approx(k_flops)
    assert step["bf16"] == pytest.approx(2 * k_flops)
    assert 2.5 * fwd["f32"] < step["f32"] < 3.5 * fwd["f32"]
    assert work.least_seconds({"f32": 67e12, "bf16": 989e12}) == pytest.approx(2.0)
