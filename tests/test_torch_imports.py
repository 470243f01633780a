"""The port stands alone: no module of spurfies_tpu_torch, nor the
scripts ``chip_*.py`` or the card-only tests, imports JAX, optax, orbax
or anything of spurfies_tpu, and every port
module (``scripts/`` and ``eval/`` too) imports with JAX made
unimportable.  Nor do they import the libraries that the card's machine
lacks (imageio, cv2, matplotlib, yaml, tensorboardX, sklearn); Pillow only
in the JPEG branch of ``data.scene_data.read_image``.  A DTU scene exported by the port loads,
and ``configs/dtu_pn.yaml`` reads, with all of them unimportable."""

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
# what the card's machine does not install
ABSENT = re.compile(
    r"^(imageio|cv2|matplotlib|yaml|tensorboardX|PIL|sklearn)(\.|$)")
BLOCKED = ("jax", "jaxlib", "optax", "orbax", "spurfies_tpu", "imageio", "cv2",
           "matplotlib", "yaml", "tensorboardX", "PIL", "sklearn")
# the one place that may import Pillow: the JPEG branch
JPEG_BRANCH = ("data/scene_data.py", "read_image")


def _port_modules():
    """The package's .py files; ``build/`` holds kernel builds (and may hold
    an unpacked copy of the repo), not the package's sources."""
    return sorted(p for p in PORT.rglob("*.py")
                  if p.relative_to(PORT).parts[0] != "build")


def _sources():
    # test_torch_cuda.py runs on the card's machine, which has no JAX
    return _port_modules() + sorted(ROOT.glob("chip_*.py")) + [
        ROOT / "tests" / "test_torch_cuda.py"]


def _imported(path, with_function=False):
    """The modules ``path`` imports; with ``with_function``, (module, name
    of the function the import sits in, or None)."""
    tree = ast.parse(path.read_text(), filename=str(path))

    def walk(node, func):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from walk(child, child.name)
                continue
            names = []
            if isinstance(child, ast.Import):
                names = [a.name for a in child.names]
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                names = [child.module]
            for name in names:
                yield (name, func) if with_function else name
            yield from walk(child, func)

    yield from walk(tree, None)


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


def test_absent_pattern():
    assert ABSENT.match("imageio.v2") and ABSENT.match("cv2")
    assert ABSENT.match("PIL.Image") and ABSENT.match("yaml")
    assert ABSENT.match("sklearn.neighbors")
    assert not ABSENT.match("cv2x") and not ABSENT.match("torch.utils")


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_absent_library_imports(path):
    """imageio, cv2, matplotlib, yaml, tensorboardX and sklearn nowhere;
    Pillow only in the JPEG branch of ``read_image``."""
    rel = path.relative_to(ROOT).as_posix()
    bad = [(m, fn) for m, fn in _imported(path, with_function=True)
           if m and ABSENT.match(m)
           and not (m.split(".")[0] == "PIL"
                    and (rel, fn) == ("spurfies_tpu_torch/" + JPEG_BRANCH[0],
                                      JPEG_BRANCH[1]))]
    assert not bad, f"{rel} imports {bad}"


def test_every_module_imports_without_jax():
    names = list(_module_names())
    assert len(names) > 20
    # the training slice's, the evaluation's and the scripts' modules are
    # among them
    assert {"spurfies_tpu_torch.model.losses",
            "spurfies_tpu_torch.train.optim",
            "spurfies_tpu_torch.train.trainer",
            "spurfies_tpu_torch.ops.scatter_rows",
            "spurfies_tpu_torch.ops.gather_rows",
            "spurfies_tpu_torch.cli.evaluate",
            "spurfies_tpu_torch.cli.eval_dtu",
            "spurfies_tpu_torch.eval.chamfer",
            "spurfies_tpu_torch.eval.clean_mesh",
            "spurfies_tpu_torch.eval.lpips",
            "spurfies_tpu_torch.eval.marching",
            "spurfies_tpu_torch.eval.mesh_extract",
            "spurfies_tpu_torch.eval.nvs",
            "spurfies_tpu_torch.eval.ssim",
            "spurfies_tpu_torch.scripts.micro_gather"} <= set(names)
    code = (
        "import sys\n"
        f"for m in {BLOCKED!r}:\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr


def test_scene_loads_without_the_absent_libraries(tmp_path):
    """In a process where JAX, imageio, cv2, matplotlib, yaml, tensorboardX
    and Pillow cannot be imported: the port exports the tiny DTU fixture,
    loads it through ``data/dtu.py`` (PNG images and masks) and reads
    ``configs/dtu_pn.yaml``."""
    code = (
        "import sys\n"
        f"for m in {BLOCKED!r}:\n"
        "    sys.modules[m] = None\n"
        "from spurfies_tpu_torch.config import load_yaml\n"
        "from spurfies_tpu_torch.data.dtu import load_dtu\n"
        "from spurfies_tpu_torch.data.synthetic import export_synthetic_dtu\n"
        "cfg = load_yaml('configs/dtu_pn.yaml')\n"
        "assert cfg.dataset.img_res == (576, 768), cfg.dataset.img_res\n"
        f"export_synthetic_dtu({str(tmp_path)!r}, scan_id=24, n_views=30,\n"
        "                     img_res=(24, 32), n_points=500)\n"
        f"sd = load_dtu({str(tmp_path)!r}, 24, (24, 32), 3)\n"
        "assert sd.train.rgb.shape == (3, 24 * 32, 3)\n"
        "assert 0 < sd.train.mask.mean() < 1\n"
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
