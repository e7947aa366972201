"""The port's Trainer, checkpoints and train CLI on the CPU: a smoke run with
resume on a synthetic dataset (the shape of tests/test_trainer.py), the
trained params.npz deployed by the port's MonoToAmbix, the SIGTERM stop,
`--bf16` training, the default encoders (audio, flow, video) through the
CLI, and the CLI's refusals of flags whose paths are not ported yet."""

import json
import os

import numpy as np
import pytest
import torch

from spatialaudiogen_tpu.data.synthetic import make_synthetic_dataset
from spatialaudiogen_tpu_torch.cli import train as cli_train
from spatialaudiogen_tpu_torch.config import TrainConfig
from spatialaudiogen_tpu_torch.deploy.deploy import MonoToAmbix
from spatialaudiogen_tpu_torch.models.convert import load_params
from spatialaudiogen_tpu_torch.train.checkpoint import latest_step, restore_checkpoint
from spatialaudiogen_tpu_torch.train.state import create_train_state
from spatialaudiogen_tpu_torch.train.trainer import Trainer


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torchtraindb"))
    make_synthetic_dataset(root, n_videos=2, duration=3.0, frame_hw=(64, 128), seed=1)
    return root


def _cfg(db, model_dir, **kw):
    base = dict(db_dir=db, model_dir=model_dir, encoders=("audio", "video"),
                separation="unet_mask", num_sep_tracks=2, frame_hw=(64, 128),
                n_iters=2, batch_size=2, n_workers=1, log_every=1, ckpt_every=0, seed=0)
    base.update(kw)
    return TrainConfig(**base)


@pytest.fixture(scope="module")
def trained(db, tmp_path_factory):
    model_dir = str(tmp_path_factory.mktemp("torchmodel") / "model")
    before = create_train_state(_cfg(db, model_dir), "cpu").model.state_dict()
    state, step = Trainer(_cfg(db, model_dir), device="cpu").train()
    return model_dir, before, state, step


def test_train_smoke_writes_artifacts(trained):
    model_dir, before, state, step = trained
    assert step == 2
    for name in ("train-params.json", "train-params.txt", "params.npz", "train_state.pt"):
        assert os.path.exists(os.path.join(model_dir, name)), name
    recs = [json.loads(line) for line in
            open(os.path.join(model_dir, "metrics.jsonl")).read().splitlines()]
    assert [r["step"] for r in recs] == [0, 1]
    assert all(np.isfinite(r["total_loss"]) and r["lr"] == 1e-4 for r in recs)
    after = state.model.state_dict()
    changed = [k for k in before if not torch.equal(before[k], after[k])]
    assert any(k.endswith(".weight") for k in changed)
    assert any(k.endswith(".mean") for k in changed), "BN running averages did not move"
    assert latest_step(model_dir) == 2


def test_resume_continues_from_the_checkpoint(db, trained):
    model_dir, _, state, _ = trained
    trainer = Trainer(_cfg(db, model_dir, resume=True, n_iters=3), device="cpu")
    assert trainer.init_step == 2
    restored = trainer.state
    for k, v in state.model.state_dict().items():
        assert torch.equal(restored.model.state_dict()[k], v), k
    opt = restored.optimizer.state_dict()["state"]
    assert opt and all(int(s["step"]) == 2 for s in opt.values())
    _, step = trainer.train()
    assert step == 3
    assert latest_step(model_dir) == 3


def test_restore_of_an_empty_dir_leaves_the_state(db, tmp_path):
    state = create_train_state(_cfg(db, str(tmp_path)), "cpu")
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    assert restore_checkpoint(str(tmp_path), state) is None
    assert all(torch.equal(before[k], v) for k, v in state.model.state_dict().items())


def test_trained_params_deploy_on_cpu(db, trained):
    model_dir = trained[0]
    sd = load_params(model_dir)
    assert any(k.endswith(".mean") for k in sd)
    engine = MonoToAmbix(model_dir, batch_size=2, device="cpu")
    clip = os.path.join(db, sorted(os.listdir(db))[0])
    ambi = engine.deploy(clip, deploy_start=0.5, deploy_duration=0.3)
    assert ambi.shape == (int(0.3 * 48000), 4)
    assert np.isfinite(ambi).all()


@pytest.mark.parametrize("flags, match", [
    (["--process_id", "0"], "multi-process"),
    (["--n_model", "2"], "multi-device"),
    (["--n_data", "4"], "multi-device"),
    (["--coordinator", "localhost:1234"], "multi-process"),
    (["--tb_histograms", "10"], "tb_histograms"),
    (["--pretrained_resnet", "resnet18.npy"], "pretrained_resnet"),
])
def test_cli_refuses_unported_flags(tmp_path, flags, match):
    argv = [str(tmp_path / "db"), str(tmp_path / "model")] + flags
    argv += ["--encoders", "audio", "video"]
    with pytest.raises(NotImplementedError, match=match):
        cli_train.main(argv)
    assert not (tmp_path / "model").exists()


def test_cli_trains_the_default_encoders(tmp_path):
    """cli.train with the JAX CLI's default --encoders (audio flow video):
    two CPU steps over clips with flow, finite losses, the flow encoder's
    weights moved and saved apart from the video encoder's, and the model
    dir deploys through MonoToAmbix's host path."""
    db = tmp_path / "flowdb"
    make_synthetic_dataset(str(db), n_videos=2, duration=3.0, frame_hw=(64, 128),
                           with_flow=True, seed=2)
    model_dir = tmp_path / "flowmodel"
    state, step = cli_train.main([str(db), str(model_dir), "--num_sep_tracks", "2",
                                  "--frame_hw", "64", "128", "--n_iters", "2",
                                  "--batch_size", "2", "--n_workers", "1", "--log_every", "1",
                                  "--ckpt_every", "0", "--device", "cpu"])
    assert step == 2 and state.model.cfg.encoders == ("audio", "flow", "video")
    recs = [json.loads(line) for line in (model_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1]
    assert all(np.isfinite(r["total_loss"]) for r in recs)
    init = create_train_state(TrainConfig.load(str(model_dir)), "cpu", seed=0)
    trained = load_params(str(model_dir))
    moved = [k for k, v in init.model.state_dict().items() if not torch.equal(v, trained[k])]
    assert any(k.startswith("flow_encoder.") and k.endswith(".weight") for k in moved)
    assert any(k.startswith("video_encoder.") and k.endswith(".weight") for k in moved)
    ambi = MonoToAmbix(str(model_dir), batch_size=2, device="cpu").deploy(
        str(db / "synth000"), deploy_start=0.5, deploy_duration=0.3)
    assert ambi.shape == (int(0.3 * 48000), 4) and np.isfinite(ambi).all()


def test_cli_bf16_trains_with_float32_params(db, tmp_path):
    """--bf16 (tests/test_trainer.py:137-155 for the port): two steps with
    the conv/FC products in bfloat16, finite losses, float32 params.npz, and
    the run's config records the dtype."""
    model_dir = tmp_path / "bf16model"
    state, step = cli_train.main([db, str(model_dir), "--encoders", "audio", "video",
                                  "--bf16", "--num_sep_tracks", "2", "--frame_hw", "64", "128",
                                  "--n_iters", "2", "--batch_size", "2", "--n_workers", "1",
                                  "--log_every", "1", "--ckpt_every", "0", "--device", "cpu"])
    assert step == 2 and state.model.cfg.dtype == torch.bfloat16
    recs = [json.loads(line) for line in (model_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1]
    assert all(np.isfinite(r["total_loss"]) for r in recs)
    params = load_params(str(model_dir))
    assert params and all(v.dtype == torch.float32 for v in params.values())
    assert TrainConfig.load(str(model_dir)).compute_dtype == "bfloat16"


def test_cli_parses_the_jax_flags():
    args = cli_train.parse_arguments(["db", "m", "--encoders", "audio", "video",
                                      "--batch_size", "32", "--n_iters", "6",
                                      "--log_every", "1", "--ckpt_every", "0"])
    assert args.device == "cuda" and args.encoders == ["audio", "video"]
    assert args.subset_fn is None and args.frame_hw == [224, 448]


def test_sigterm_stops_at_a_step_boundary_and_saves(db, tmp_path):
    """SIGTERM mid-training: the loop stops at the next step boundary and
    the exit path still writes the checkpoint (tests/test_trainer.py's
    preemption test, for the port)."""
    import signal
    import subprocess
    import sys
    import time

    model_dir = str(tmp_path / "sigterm_model")
    code = f"""
from spatialaudiogen_tpu_torch.config import TrainConfig
from spatialaudiogen_tpu_torch.train.trainer import Trainer
cfg = TrainConfig(db_dir={db!r}, model_dir={model_dir!r}, encoders=("audio", "video"),
                  separation="unet_mask", num_sep_tracks=2, frame_hw=(64, 128),
                  n_iters=100000, batch_size=2, n_workers=1, log_every=1, ckpt_every=0)
Trainer(cfg, device="cpu").train()
print("TRAINER_EXITED_CLEANLY", flush=True)
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    lines = []
    try:
        deadline = time.time() + 240
        for line in proc.stdout:
            lines.append(line)
            if "total_loss" in line:
                break
            assert time.time() < deadline, "".join(lines)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
        lines.append(out)
    finally:
        if proc.poll() is None:
            proc.kill()
    full = "".join(lines)
    assert proc.returncode == 0, full
    assert "TRAINER_EXITED_CLEANLY" in full, full
    assert latest_step(model_dir) is not None, full
