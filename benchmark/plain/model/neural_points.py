"""Per-scene neural-point state (reference
``spurfies/model/pointneus_disent.py:116-205``): positions from the PLY ->
voxel_downsample(vox_res=300) -> fixed buffer.  The point set never
changes, so the query table, the TV-regulariser neighbour graph and the
fine occupancy bitmap are built once here.
"""

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from benchmark.plain.config import ModelConfig
from benchmark.plain.device import resolve_device
from benchmark.plain.ops.downsample import voxel_downsample
from benchmark.plain.ops.voxel_grid import (
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
                raw_colors: np.ndarray | None = None, device="cuda"):
    """Voxel-downsample the cloud and precompute the lookup tables.

    Returns (scene: SceneState, colors ``[N, 3]`` of the kept points or
    None)."""
    dev = resolve_device(device)
    pts, cols, _ = voxel_downsample(np.asarray(raw_points), cfg.vox_res,
                                    raw_colors)
    spec = grid_spec_from_config(cfg)
    points = torch.as_tensor(pts, dtype=torch.float32, device=dev)
    table = build_query_table(points, spec, r=cfg.r)
    table, spec = shrink_query_table(table, spec)
    tv_idx, tv_valid = build_tv_graph(points, table, spec, cfg.k)
    occ_fine = build_occupancy_bitmap(points, spec, r=cfg.r)
    scene = SceneState(points=points, table=table, tv_idx=tv_idx,
                       tv_valid=tv_valid, occ_fine=occ_fine, spec=spec)
    return scene, cols
