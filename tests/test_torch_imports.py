"""Import hygiene of the PyTorch port, and chip_smoke.py's refusal to run
without a card.

The port imports torch, numpy and its own modules: never jax/flax/optax/
orbax, and nothing of the JAX package `spatialaudiogen_tpu`, not even its
framework-free host modules (the port keeps its own copies of those). Its
kernels build lazily, so every module imports on a machine without nvcc.
"""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "spatialaudiogen_tpu_torch"
FORBIDDEN = ("jax", "flax", "optax", "orbax", "spatialaudiogen_tpu")
PORT_FILES = sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py"))
CHECKED_FILES = PORT_FILES + ["chip_smoke.py"]

IMPORT_ALL = f"""
import contextlib, importlib, io, json, os, pkgutil, sys, tempfile
import spatialaudiogen_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from spatialaudiogen_tpu_torch.cli import deploy, eval, parse_eval_results, serve, train
from spatialaudiogen_tpu_torch.cli import flow, power_map, spatialmedia
from spatialaudiogen_tpu_torch.cli import binauralize, encode, encode_and_binauralize
from spatialaudiogen_tpu_torch.cli import export_to_tf_bundle, import_tf_checkpoint
from spatialaudiogen_tpu_torch.data import packed
from spatialaudiogen_tpu_torch.etl import download, preprocess
deploy.parse_arguments(["model", "input", "video.mp4", "--save_video", "--overlay_map", "--VR"])
for cli in (flow, power_map, spatialmedia, download, preprocess, import_tf_checkpoint,
            export_to_tf_bundle, encode, binauralize, encode_and_binauralize, packed):
    with contextlib.redirect_stdout(io.StringIO()) as text:
        try:
            cli.main(["--help"])
        except SystemExit as stop:
            assert stop.code == 0 and "usage" in text.getvalue(), cli
        else:
            raise AssertionError(cli)
serve.parse_arguments(["model", "a.wav,b.wav", "oa.wav,ob.wav", "--frames_dir", "d1,d2"])
train.parse_arguments(["db", "model", "--encoders", "audio", "video"])
eval.parse_arguments(["model", "--device_metrics", "--emd", "sinkhorn"])
with tempfile.TemporaryDirectory() as d:
    fn = os.path.join(d, "eval-detailed.txt")
    with open(fn, "w") as f:
        f.write("SampleID | mse/avg stft/avg env_mse/avg emd/dir\\nv 0.5 | 0.1 2.0 0.02 0.03\\n")
    with contextlib.redirect_stdout(io.StringIO()):
        parse_eval_results.main([fn])
print(json.dumps({{"modules": names,
                  "forbidden": sorted({{m.split(".")[0] for m in sys.modules}}
                                      & set({list(FORBIDDEN)!r})),
                  "image_libs": sorted({{m.split(".")[0] for m in sys.modules}}
                                       & {{"PIL", "cv2", "sklearn"}})}}))
"""


def _env_without_cuda_tools() -> dict:
    """This interpreter's environment with no nvcc reachable and no card."""
    env = {k: v for k, v in os.environ.items() if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = os.pathsep.join(p for p in env.get("PATH", "").split(os.pathsep)
                                  if p and not (Path(p) / "nvcc").exists())
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_every_module_imports_without_jax_or_nvcc():
    import json

    proc = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=ROOT, timeout=300,
                          env=_env_without_cuda_tools(), capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in ("ops.masked_istft", "deploy.deploy", "train.trainer", "cli.train",
                 "data.pipeline", "data.readers", "dsp.geometry", "utils.io_audio",
                 "eval.evaluator", "ops.eval_metrics", "ops.sinkhorn", "cli.eval",
                 "cli.parse_eval_results", "ambisonics.emd", "utils.io_position",
                 "deploy.stream", "cli.serve", "parallel.mesh", "parallel.distributed",
                 "parallel.collectives", "utils.tensorboard", "ops.flow", "etl.flow",
                 "etl.preprocess", "etl.download", "etl.projections", "etl.reproject",
                 "deploy.mux", "deploy.sa3d", "utils.cmd", "utils.io_video", "cli.flow",
                 "cli.spatialmedia", "cli.power_map", "utils.tf_bundle",
                 "cli.import_tf_checkpoint", "cli.export_to_tf_bundle", "data.packed",
                 "data.synthetic", "ambisonics.encoder", "ambisonics.binauralizer",
                 "ambisonics.binaural_filters", "ambisonics.hrir", "ambisonics.tdesigns",
                 "cli.encode", "cli.binauralize", "cli.encode_and_binauralize",
                 "data.image_prep", "data.generic", "models.recurrent", "models.embedding",
                 "models.classification_metrics", "models.interface", "models.resnet",
                 "train.harness", "utils.profiling"):
        assert f"spatialaudiogen_tpu_torch.{name}" in out["modules"], name
    assert out["forbidden"] == [], out["forbidden"]
    # the card's host has no Pillow, OpenCV or scikit-learn: nothing of the
    # port may need them to import (data.synthetic imports Pillow when it
    # writes a jpg)
    assert out["image_libs"] == [], out["image_libs"]


@pytest.mark.parametrize("path", CHECKED_FILES)
def test_no_framework_import_statements(path):
    """No import statement of jax/flax/optax/orbax or of the JAX package
    (`spatialaudiogen_tpu` not followed by `_torch`)."""
    pattern = re.compile(rf"^\s*(import|from) ({'|'.join(FORBIDDEN)})(?!_torch)\b")
    lines = (ROOT / path).read_text().splitlines()
    bad = [f"{path}:{i + 1}: {line}" for i, line in enumerate(lines) if pattern.match(line)]
    assert not bad, bad


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "script-alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """No visible card (or no port beside the script): non-zero exit and no
    result line."""
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    env = _env_without_cuda_tools()
    if alone:
        env.pop("PYTHONPATH")
    proc = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env, timeout=300,
                          capture_output=True, text=True)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_package_data_ships_every_kernel_source():
    """An installed (non-editable) port builds K1-K3 from the sources and
    headers that ops/masked_istft.py names: pyproject.toml's package-data
    must match each of them."""
    import fnmatch
    import tomllib

    from spatialaudiogen_tpu_torch.ops import masked_istft

    with open(ROOT / "pyproject.toml", "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"]["spatialaudiogen_tpu_torch"]
    files = masked_istft.SOURCES + masked_istft.HEADERS
    assert any(p.suffix == ".cuh" for p in files)
    for path in files:
        rel = str(path.relative_to(PORT))
        assert path.exists() and any(fnmatch.fnmatch(rel, g) for g in globs), (rel, globs)
