"""Per-scene neural-point state (port of
``spurfies_tpu/model/neural_points.py``).

Reference ``spurfies/model/pointneus_disent.py:116-205``:
  * positions: PLY -> voxel_downsample(vox_res=300) -> fixed buffer.
  * color latents ``[N, 64]``: U(-1e-4, 1e-4); first 3 dims overwritten with
    point RGB mapped to [-1, 1] when initialize_colors.
  * geometry latents ``[N, 32]``: N(0, 0.01) clipped to max-norm 1.

The point set never changes, so the query table, the TV-regulariser
neighbour graph and the fine occupancy bitmap are built once here.
"""

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from spurfies_tpu_torch.config import ModelConfig
from spurfies_tpu_torch.device import resolve_device
from spurfies_tpu_torch.ops.downsample import voxel_downsample
from spurfies_tpu_torch.ops.voxel_grid import (
    QueryTable,
    VoxelGridSpec,
    build_occupancy_bitmap,
    build_query_table,
    query_grid,
)


@dataclass
class SceneState:
    """Non-trainable per-scene tensors."""
    points: torch.Tensor          # [N, 3]
    table: QueryTable             # per-cell candidate lists
    tv_idx: torch.Tensor          # [N, k] TV-graph neighbour indices
    tv_valid: torch.Tensor        # [N, k] bool
    occ_fine: torch.Tensor = None  # [rows, 128] int8 fine occupancy bitmap
    spec: VoxelGridSpec = None


def grid_spec_from_config(cfg: ModelConfig) -> VoxelGridSpec:
    return VoxelGridSpec(
        voxel_size=cfg.voxel_size,
        voxel_scale=cfg.voxel_scale,
        lo=tuple(cfg.scene_lo),
        hi=tuple(cfg.scene_hi),
        max_pts_per_cell=cfg.max_pts_per_voxel,
    )


def shrink_query_table(table: QueryTable, spec: VoxelGridSpec):
    """Slice the table to the smallest sufficient qcap (32, 64, 96, 128).

    Candidate lists are packed front-first, so cutting to the scene's
    largest list is exact and shortens every query's candidate scan.
    """
    occ = int(torch.max(torch.sum(table.idx >= 0, dim=-1)))
    qcap = next((c for c in (32, 64, 96, 128) if occ <= c), spec.qcap)
    if qcap >= spec.qcap:
        return table, spec
    table = QueryTable(idx=table.idx[:, :qcap].contiguous(),
                       pos=table.pos[:, :, :qcap].contiguous(),
                       r=table.r, n_points=table.n_points)
    return table, dataclasses.replace(spec, qcap=qcap)


def build_tv_graph(points: torch.Tensor, table: QueryTable,
                   spec: VoxelGridSpec, k: int):
    """kNN of each neural point among the neural points, self-edges removed
    when other neighbours exist (reference utils.tv_regul :221-258); lone
    points keep only the self edge."""
    n = points.shape[0]
    tv_idx, _ = query_grid(points, table, spec, k=k)
    own = torch.arange(n, dtype=torch.int32, device=points.device)[:, None]
    is_self = tv_idx == own
    valid = tv_idx >= 0
    others = torch.sum(valid & ~is_self, dim=-1, keepdim=True) > 0
    tv_valid = valid & ~(is_self & others)
    return torch.where(tv_valid, tv_idx, 0), tv_valid


def build_scene(raw_points: np.ndarray, cfg: ModelConfig,
                raw_colors: np.ndarray | None = None,
                generator: torch.Generator | None = None, device="cuda"):
    """Voxel-downsample the cloud, init latents, precompute lookup tables.

    Args:
      raw_points: ``[M, 3]`` input cloud (e.g. DUSt3R output).
      raw_colors: optional ``[M, 3]`` uint8-range colors.
      generator: CPU ``torch.Generator`` for the latent init.

    Returns:
      (scene: SceneState, latents: {'feats_color' [N,64],
       'feats_geometry' [N,32]} -- they go into params['train']).
    """
    if cfg.entangled:
        raise NotImplementedError(
            "entangled model: ROADMAP.md Queue 1 item 'Legacy entangled "
            "model'")
    dev = resolve_device(device)
    generator = generator if generator is not None else torch.Generator()
    pts, cols, _ = voxel_downsample(np.asarray(raw_points), cfg.vox_res,
                                    raw_colors)
    n = pts.shape[0]
    spec = grid_spec_from_config(cfg)
    points = torch.as_tensor(pts, dtype=torch.float32, device=dev)
    table = build_query_table(points, spec, r=cfg.r)
    table, spec = shrink_query_table(table, spec)
    tv_idx, tv_valid = build_tv_graph(points, table, spec, cfg.k)
    occ_fine = build_occupancy_bitmap(points, spec, r=cfg.r)
    scene = SceneState(points=points, table=table, tv_idx=tv_idx,
                       tv_valid=tv_valid, occ_fine=occ_fine, spec=spec)

    fdim = cfg.feature_vector_size
    feats_color = torch.empty(n, fdim).uniform_(-1e-4, 1e-4,
                                                generator=generator)
    if cfg.initialize_colors and cols is not None:
        feats_color[:, :3] = torch.as_tensor(
            cols[:, :3], dtype=torch.float32) * 2.0 / 255.0 - 1.0
    feats_geometry = 0.01 * torch.randn(n, fdim // 2, generator=generator)
    norms = torch.linalg.norm(feats_geometry, dim=-1, keepdim=True)
    feats_geometry = feats_geometry * torch.clamp(norms, max=1.0) / (
        norms + 1e-7)
    latents = {"feats_color": feats_color.to(dev),
               "feats_geometry": feats_geometry.to(dev)}
    return scene, latents
