"""Global alignment (``spurfies_tpu_torch/prep/alignment.py``) against the
JAX package's (optax's Adam on its cosine schedule), on the CPU.

E=3 edges of P=256 noisy, consistent points (each edge a random
similarity of one cloud), random confidences, 30 iterations, in the
free-pose and the preset-pose modes: points, poses, edge scales and the
final loss within 1e-4 of their scale (f32 on both sides: the reductions'
sum orders differ; the measured gap is about 1.1e-5 on the points).
"""

import _torch_threads  # noqa: F401  (caps torch's threads under xdist)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spurfies_tpu.prep import alignment as ja
from spurfies_tpu_torch.prep import alignment as ta

TOL = 1e-4


def _close(ours, ref, tol=TOL):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape and ours.dtype == ref.dtype
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert float(np.abs(ours - ref).max()) <= tol * scale


def test_quat_to_rot_is_jax():
    q = np.random.default_rng(0).normal(size=(7, 4)).astype(np.float32)
    q[0] = [1, 0, 0, 0]
    _close(ta.quat_to_rot(torch.from_numpy(q)).numpy(),
           ja.quat_to_rot(jnp.asarray(q)), 1e-6)
    np.testing.assert_array_equal(
        ta.quat_to_rot(torch.from_numpy(q[:1])).numpy()[0], np.eye(3))


def test_scale_preset_poses_is_jax():
    rng = np.random.default_rng(1)
    poses = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    poses[:, :3, 3] = rng.uniform(-3, 3, (4, 3))
    a, sa = ta.scale_preset_poses(poses, 0.225)
    b, sb = ja.scale_preset_poses(poses, 0.225)
    np.testing.assert_array_equal(a, b)
    assert sa == sb


def test_cosine_lr_is_optax():
    """Within f32 rounding of optax's cosine (1e-6 of lr; the port's
    schedule is in float64)."""
    import optax
    sched = optax.cosine_decay_schedule(0.01, 30, 1e-3)
    for c in (0, 1, 15, 29, 30, 40):
        assert ta.cosine_lr(0.01, 30, c) == pytest.approx(float(sched(c)),
                                                          abs=1e-8)


def _edges_scene(P=256, seed=0):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(-0.5, 0.5, (P, 3)).astype(np.float32)
    edges = np.array([[0, 1], [1, 2], [0, 2]])
    xi, xj = [], []
    for _ in range(3):
        scale = rng.uniform(0.7, 1.4)
        shift = rng.uniform(-0.2, 0.2, 3)
        xi.append((gt + 0.01 * rng.normal(size=(P, 3)) - shift) / scale)
        xj.append((gt + 0.01 * rng.normal(size=(P, 3)) - shift) / scale)
    ci = rng.uniform(1, 30, (3, P)).astype(np.float32)
    cj = rng.uniform(1, 30, (3, P)).astype(np.float32)
    return (edges, np.stack(xi).astype(np.float32),
            np.stack(xj).astype(np.float32), ci, cj)


@pytest.mark.parametrize("preset", [False, True])
def test_align_pointmaps_is_jax(preset):
    edges, xi, xj, ci, cj = _edges_scene()
    poses = None
    if preset:
        rng = np.random.default_rng(2)
        poses = np.tile(np.eye(4), (3, 1, 1))
        poses[:, :3, 3] = rng.uniform(-1, 1, (3, 3))
        poses, _ = ja.scale_preset_poses(poses)
    ref = ja.align_pointmaps(edges, xi, xj, ci, cj, 3,
                             ja.AlignConfig(iters=30), preset_poses=poses)
    out = ta.align_pointmaps(edges, xi, xj, ci, cj, 3,
                             ta.AlignConfig(iters=30), preset_poses=poses)
    for k in ("points", "poses", "edge_scales"):
        _close(out[k], ref[k])
    assert out["loss"] == pytest.approx(ref["loss"], rel=TOL)
    # the losses fall, and the last is the one reported
    assert out["losses"].shape == (30,) and out["losses"][-1] == out["loss"]
    assert out["losses"][-1] < out["losses"][0]


def test_alignment_loop_takes_inference_tensors():
    """``infer_pair``'s outputs are inference tensors; the alignment takes
    them as they are (it copies its inputs) and leaves them untouched."""
    edges, xi, xj, ci, cj = _edges_scene(P=64)
    with torch.inference_mode():
        ins = [torch.from_numpy(a).clone() for a in (xi, xj, ci, cj)]
    out = ta.align_pointmaps(edges, *ins, 3, ta.AlignConfig(iters=5))
    ref = ta.align_pointmaps(edges, xi, xj, ci, cj, 3,
                             ta.AlignConfig(iters=5))
    np.testing.assert_array_equal(out["points"], ref["points"])
    assert torch.equal(ins[0], torch.from_numpy(xi))
