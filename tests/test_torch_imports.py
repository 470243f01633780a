"""The port stands alone: no module of spurfies_tpu_torch, nor the
scripts ``chip_*.py`` or the card-only tests, imports JAX, optax, orbax
or anything of spurfies_tpu, and every port
module (``scripts/`` and ``eval/`` too) imports with JAX made
unimportable.  Nor do they import the libraries that the card's machine
lacks (imageio, cv2, matplotlib, yaml, tensorboardX, sklearn); Pillow only
in the JPEG branch of ``data.scene_data.read_image``.  A DTU scene
exported by the port loads, ``configs/dtu_pn.yaml`` reads, the local
loss's bundle builds and the prior pretrains with all of them
unimportable."""

import _torch_threads  # noqa: F401  (caps torch's threads under xdist)

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
    """imageio, cv2, matplotlib, yaml, tensorboardX, Pillow and sklearn
    nowhere (JPEGs go through the port's own decoder)."""
    rel = path.relative_to(ROOT).as_posix()
    bad = [(m, fn) for m, fn in _imported(path, with_function=True)
           if m and ABSENT.match(m)]
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
            "spurfies_tpu_torch.scripts.micro_gather",
            "spurfies_tpu_torch.model.local_loss",
            "spurfies_tpu_torch.model.featext",
            "spurfies_tpu_torch.data.mvs_local",
            "spurfies_tpu_torch.prior.shapes",
            "spurfies_tpu_torch.prior.mesh_corpus",
            "spurfies_tpu_torch.prior.pretrain",
            "spurfies_tpu_torch.cli.pretrain_prior",
            "spurfies_tpu_torch.prep.pointcloud",
            "spurfies_tpu_torch.prep.dust3r_net",
            "spurfies_tpu_torch.prep.alignment",
            "spurfies_tpu_torch.prep.colmap",
            "spurfies_tpu_torch.cli.prep_pointcloud",
            "spurfies_tpu_torch.utils.profiling",
            "spurfies_tpu_torch.utils.flops",
            "spurfies_tpu_torch.cli.fleet"} <= set(names)
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


def test_local_loss_and_pretraining_without_the_absent_libraries(tmp_path):
    """In a process where JAX, cv2, imageio, Pillow and the others cannot be
    imported: the Vis-MVSNet fixtures of an exported DTU scene are
    written, a random-weight checkpoint converted, the local bundle built
    (PNG read as BGR, the bilinear resize, the extractor; 384x512
    images), and two pretraining steps run on a two-shape corpus."""
    code = (
        "import sys\n"
        f"for m in {BLOCKED!r}:\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "from spurfies_tpu_torch.convert.torch_ckpt import "
        "convert_vismvsnet\n"
        "from spurfies_tpu_torch.data.mvs_local import build_local_bundle\n"
        "from spurfies_tpu_torch.data.synthetic import (\n"
        "    export_synthetic_dtu, export_synthetic_mvs,\n"
        "    random_vismvsnet_state)\n"
        "from spurfies_tpu_torch.prior import pretrain as p\n"
        f"root = {str(tmp_path)!r}\n"
        "export_synthetic_dtu(root, scan_id=24, n_views=30,\n"
        "                     img_res=(24, 32), n_points=500)\n"
        "export_synthetic_mvs(root, scan_id=24)\n"
        "fx = convert_vismvsnet(random_vismvsnet_state(0), 'cpu')\n"
        "b = build_local_bundle(root, 24, fx, np.eye(4, dtype=np.float32),\n"
        "                       feat_img_scale=1, device='cpu')\n"
        "assert b.feats.shape == (3, 192, 256, 32), b.feats.shape\n"
        "cfg = p.PriorConfig(n_shapes=2, n_surface_cap=512, n_query=256,\n"
        "                    batch_queries=128, spacing=0.05, steps=2)\n"
        "params, hist = p.pretrain(cfg, log_every=1, device='cpu')\n"
        "assert len(hist) == 2 and np.isfinite(hist[-1]['loss'])\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr


def test_prep_cli_without_the_absent_libraries(tmp_path):
    """In a process where JAX, imageio, cv2, Pillow and the others cannot be
    imported: the prep CLI reads three PNGs through the port's codec (one
    resized to the network's size by the port's cubic resize), converts a
    synthetic checkpoint, and exports a scene, on the CPU at a tiny
    network."""
    code = (
        "import sys\n"
        f"for m in {BLOCKED!r}:\n"
        "    sys.modules[m] = None\n"
        "import dataclasses, functools, os\n"
        "import numpy as np, torch\n"
        "from spurfies_tpu_torch.cli import prep_pointcloud as cli\n"
        "from spurfies_tpu_torch.data.png import write_png\n"
        "from spurfies_tpu_torch.prep import dust3r_net as d\n"
        "tiny = d.Dust3rConfig(img_size=(32, 32), enc_dim=32, enc_depth=1,\n"
        "                      enc_heads=2, dec_dim=16, dec_depth=1,\n"
        "                      dec_heads=2)\n"
        f"root = {str(tmp_path)!r}\n"
        "os.makedirs(root + '/imgs')\n"
        "rng = np.random.default_rng(0)\n"
        "for i, hw in enumerate([(32, 32), (32, 32), (40, 48)]):\n"
        "    write_png(f'{root}/imgs/{i}.png',\n"
        "              rng.integers(0, 255, hw + (3,)).astype(np.uint8))\n"
        "torch.save(d.random_dust3r_state(tiny), root + '/d.pth')\n"
        "cli.Dust3rConfig = lambda img_size: tiny\n"
        "cli.run_inference = functools.partial(cli.run_inference,\n"
        "                                      img_size=(32, 32))\n"
        "out = cli.main(['--scan', 's', '--images', root + '/imgs',\n"
        "                '--ckpt', root + '/d.pth', '--out-root', root,\n"
        "                '--conf', '1.5', '--align-iters', '3',\n"
        "                '--device', 'cpu'])\n"
        "assert len(out['points']) > 0\n"
        "assert os.path.exists(root + '/own_data/s/s.json')\n"
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
