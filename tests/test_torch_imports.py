"""Import hygiene of the PyTorch port, and chip_smoke.py's refusal to run
without a card.

The port imports torch, numpy and the JAX package's framework-free host
modules, never jax/flax/optax/orbax; its kernel builds lazily, so every
module imports on a machine without nvcc.
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
FORBIDDEN = ("jax", "flax", "optax", "orbax")
PORT_FILES = sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py"))

IMPORT_ALL = f"""
import importlib, json, pkgutil, sys
import spatialaudiogen_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
print(json.dumps({{"modules": names,
                  "forbidden": sorted({{m.split(".")[0] for m in sys.modules}}
                                      & set({list(FORBIDDEN)!r}))}}))
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
    assert "spatialaudiogen_tpu_torch.ops.masked_istft" in out["modules"]
    assert "spatialaudiogen_tpu_torch.deploy.deploy" in out["modules"]
    assert out["forbidden"] == [], out["forbidden"]


@pytest.mark.parametrize("path", PORT_FILES)
def test_no_framework_import_statements(path):
    pattern = re.compile(rf"^\s*(import|from) ({'|'.join(FORBIDDEN)})\b")
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
