"""The port stands alone: no module of spurfies_tpu_torch, nor
chip_smoke.py, chip_k3_parts.py, chip_k8_parts.py or the card-only tests,
imports JAX, optax, orbax or anything of spurfies_tpu, and every port
module imports with JAX made unimportable."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "spurfies_tpu_torch"
FORBIDDEN = re.compile(r"^(jax|jaxlib|optax|orbax|flax|spurfies_tpu)(\.|$)")


def _port_modules():
    """The package's .py files; ``build/`` holds kernel builds (and may hold
    an unpacked copy of the repo), not the package's sources."""
    return sorted(p for p in PORT.rglob("*.py")
                  if p.relative_to(PORT).parts[0] != "build")


def _sources():
    # test_torch_cuda.py runs on the card's machine, which has no JAX
    return _port_modules() + [ROOT / "chip_smoke.py",
                              ROOT / "chip_k3_parts.py",
                              ROOT / "chip_k8_parts.py",
                              ROOT / "tests" / "test_torch_cuda.py"]


def _imported(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _module_names():
    for p in _port_modules():
        rel = p.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_forbidden_pattern_spares_the_port():
    assert FORBIDDEN.match("spurfies_tpu.model.field")
    assert FORBIDDEN.match("jax.numpy") and FORBIDDEN.match("jax")
    assert not FORBIDDEN.match("spurfies_tpu_torch.model.field")


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_forbidden_imports(path):
    bad = [m for m in _imported(path) if m and FORBIDDEN.match(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_module_imports_without_jax():
    names = list(_module_names())
    assert len(names) > 20
    # the training slice's modules are among them
    assert {"spurfies_tpu_torch.model.losses",
            "spurfies_tpu_torch.train.optim",
            "spurfies_tpu_torch.train.trainer",
            "spurfies_tpu_torch.ops.scatter_rows"} <= set(names)
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'optax', 'orbax', 'spurfies_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr


def test_chip_smoke_refuses_without_a_card():
    """Without a CUDA device the smoke test exits non-zero and prints no
    result."""
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
