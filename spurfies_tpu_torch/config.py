"""Typed configuration (single system serving train + eval).

The port's own copy of ``spurfies_tpu/config.py``: the same frozen
dataclasses, ``load_yaml`` and ``apply_overrides``, so one YAML file and one
preset table drive both packages.  The comments give the reason for each
default; the measurements behind them are the JAX package's, recorded in
``spurfies_tpu/config.py``, and none of them is this port's.

The reference has three config layers that drift apart (Hydra YAML, pyhocon
.conf duplicates, argparse — SURVEY §5 "Config / flag system").  Here one set
of frozen dataclasses covers every knob, loadable from YAML with dotted CLI
overrides.

Knob provenance: ``config/ours.yaml``, ``config/base.yaml``,
``config/vol/{dtu_pn,mip_nerf,own_data}.yaml`` in the reference.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class DensityConfig:
    """LaplaceDensity (reference density.py:16-30; config vol/*.yaml)."""
    beta_init: float = 0.1
    beta_min: float = 1e-4


@dataclass(frozen=True)
class SamplerConfig:
    """ErrorBoundSampler_pn knobs (reference config/vol/dtu_pn.yaml:36-44)."""
    near: float = 0.5
    far: float = 4.5
    n_samples: int = 64
    n_samples_eval: int = 128
    n_samples_extra: int = 32
    eps: float = 0.1
    beta_iters: int = 10
    max_total_iters: int = 5
    add_tiny: float = 1e-6  # reference default 0.0; >0 guards 0/0 for
    #                         converged rays which it never sampled (we do)


@dataclass(frozen=True)
class ModelConfig:
    """PointVolSDF knobs (reference config/vol/dtu_pn.yaml:23-35)."""
    feature_vector_size: int = 64     # color latent dim (geometry = half)
    entangled: bool = False           # legacy single-latent ablation
    #                                   (reference pointneus.py; trainable
    #                                   trunk, 1/d weights, uniform sampler)
    scene_bounding_sphere: float = 3.0
    white_bkgd: bool = False
    bg_color: tuple = (1.0, 1.0, 1.0)
    initialize_colors: bool = True
    k: int = 8                        # neighbors per shading point
    probe_k: int = 0                  # neighbors for the SAMPLER's no-grad
    #                                   importance probe only (0 = k,
    #                                   reference-exact). The probe guides
    #                                   where samples land, never the
    #                                   rendered SDF.  k=1 is faster but
    #                                   loses sampling precision (higher
    #                                   train rgb-L1), so it is NOT the
    #                                   default; it is in the "throughput"
    #                                   preset.
    r: float = 2.0                    # query radius in voxel_size units
    rbf: float = 45.0                 # RBF sharpness (hardcoded, model :42)
    vox_res: int = 300                # point-cloud voxel downsample res
    max_shading_pts: int = 80
    render_budget_frac: float = 0.0   # >0: cap render-path SDF evals at
    #                                   frac*R*S valid shading points.
    #                                   GATE FAILED at 0.5 (converged scenes
    #                                   exceed the budget -> dropped
    #                                   geometry, 10dB PSNR loss) — keep 0
    #                                   unless the scene's valid fraction is
    #                                   known to be low.
    pair_budget_frac: float = 0.0     # >0: compact the [R*S, K] pair grid
    #                                   to its first frac*R*S*K valid pairs
    #                                   (COLUMN-major: nearest neighbors
    #                                   first) before the frozen SDF MLP
    #                                   (invalid slots are ~half the dense
    #                                   grid).  Exact when nothing
    #                                   overflows; overflow sheds the
    #                                   FARTHEST neighbors of tail points
    #                                   (effective k shrinks — no holes,
    #                                   no SDF bias).  Keep 0: in the JAX
    #                                   package the row gathers and
    #                                   scatter-backs cost more than the
    #                                   MLP work they save.  The port runs
    #                                   it through K7a.
    color_pair_frac: float = 0.0      # >0: same pair compaction for the
    #                                   trainable color MLP (the [M*K, 256]
    #                                   activation traffic is paid fwd AND
    #                                   stored-activation bwd).  Fraction
    #                                   of the color path's own pair grid
    #                                   (after color_top_samples).  Keep
    #                                   0, for pair_budget_frac's reason.
    color_top_samples: int = 32       # >0: run the color MLP only on the
    #                                   top-K samples per ray by rendering
    #                                   weight, rescaled to preserve total
    #                                   weight (quadrature subsampling;
    #                                   0 = exact reference behavior).
    #                                   32 passed the quality gate at the
    #                                   reference's mesh error; 24 did
    #                                   not.
    ray_budget_frac: float = -1.0     # TRAIN-ONLY: >0 compacts the ray
    #                                   batch to frac*R candidate rays
    #                                   BEFORE the sampler (coarse
    #                                   cell-occupancy over the uniform
    #                                   init grid), running the whole
    #                                   sampler/query/MLP/color pipeline
    #                                   at the reduced static width and
    #                                   scattering outputs back dense.
    #                                   ~26% of a uniform pixel batch
    #                                   misses the cloud (micro_scols);
    #                                   the reference never pays for
    #                                   misses (CUDA ray_mask compaction).
    #                                   Overflow candidate rays drop from
    #                                   the batch (excluded from losses
    #                                   like misses). 0 = reference-dense;
    #                                   -1 = AUTO (Trainer measures the
    #                                   scene's occupancy fraction over
    #                                   the train views once and adds a
    #                                   4-sigma batch-sampling margin;
    #                                   full-frame scenes calibrate to
    #                                   dense).  It passed the quality
    #                                   gate at the reference's mesh error.
    #                                   DEFAULT -1 (auto): this is
    #                                   reference-EQUIVALENT, not beyond —
    #                                   the CUDA kernel's ray_mask
    #                                   compaction also never pays for
    #                                   miss rays (model/utils.py:90-113);
    #                                   only the RNG stream differs.
    #                                   preset=reference_exact restores
    #                                   the dense path.
    probe_budget_frac: float = -1.0   # TRAIN-ONLY budget for the sampler's
    #                                   no-grad importance probe
    #                                   (field.sdf_probe): fraction of the
    #                                   R*n_samples_eval uniform probe
    #                                   points allowed through the kNN +
    #                                   frozen-MLP pipeline.  -1 = AUTO
    #                                   (Trainer measures worst-view
    #                                   per-ray sample occupancy over the
    #                                   fine bitmap on the rays the ray
    #                                   budget keeps, + 4-sigma margin);
    #                                   (0,1) explicit; >= 1 = DENSE (no
    #                                   budget at all, reference-exact);
    #                                   anything else = legacy 0.25.
    #                                   The calibrated fraction applies
    #                                   ONLY to the FIRST (uniform-z)
    #                                   probe it was calibrated against;
    #                                   importance re-probes (train
    #                                   fast_iters >= 2 and all eval
    #                                   probes) are surface-concentrated
    #                                   and use the gated 0.25.  Overflow
    #                                   surfaces as the probe_overflow
    #                                   step metric.
    occ_compact: bool = False         # TRAIN-ONLY: compact ray samples by
    #                                   OCCUPANCY (one-int gather) BEFORE
    #                                   the kNN query, so only the S
    #                                   selected columns are queried.
    #                                   Occupancy over-selects vs the
    #                                   reference's has-neighbor rule only
    #                                   when a cell's candidate list serves
    #                                   no in-radius neighbor; such columns
    #                                   render as empty space. False =
    #                                   reference-exact column selection.
    #                                   Eval renders always use the
    #                                   reference path.
    scatter_mode: str = "pallas"      # latent-gradient scatter-add backend:
    #                                   "pallas" (banked VMEM accumulator,
    #                                   ops/pallas_scatter.py; TPU only —
    #                                   silently falls back to xla off-TPU)
    #                                   | "xla" (autodiff scatter). Same
    #                                   math, different accumulate order;
    #                                   bit-parity tested in the JAX
    #                                   package.  The port scatters with
    #                                   K5 for both values.
    fused_agg: bool = True            # r5 fused gather+MLP+RBF+aggregate
    #                                   Pallas path (pair_sdf_aggregate):
    #                                   per-point outputs only, backward
    #                                   fuses the cotangent expansion into
    #                                   the banked latent scatter.  False
    #                                   = r4 per-pair kernels + XLA glue
    #                                   (in the port: K6a/K6b + PyTorch).
    #                                   Same math (near-bitwise vs r4 path,
    #                                   tests/test_pallas_mlp.py).
    pos_multires: int = 6             # position encoding bands
    view_multires: int = 3            # view-dir encoding bands
    # voxel grid (reference pointneus_disent.py:45-62)
    voxel_size: float = 0.025
    voxel_scale: float = 3.0
    scene_lo: tuple = (-1.0, -1.0, -1.0)
    scene_hi: tuple = (1.0, 1.0, 1.0)
    max_pts_per_voxel: int = 26
    density: DensityConfig = field(default_factory=DensityConfig)
    ray_sampler: SamplerConfig = field(default_factory=SamplerConfig)


@dataclass(frozen=True)
class LossConfig:
    """Loss weights (reference config/ours.yaml:15-20, loss.py:90-97)."""
    rgb_weight: float = 1.0
    eikonal_weight: float = 0.001
    tv_weight: float = 0.01
    local_weight: float = 0.5
    pseudo_weight: float = 0.5
    mask_weight: float = 1.0
    cloud_anchor_weight: float = 0.0  # BEYOND-REFERENCE: L1 of sdf at the
    #                                   input cloud points. The pseudo loss
    #                                   anchors sdf=0 at the (near-skewed)
    #                                   rendered depth, drifting the zero
    #                                   set ~0.02 inside the cloud (mesh
    #                                   bias, NOTES_ROUND2); the cloud
    #                                   points are surface samples, so
    #                                   anchoring them at 0 opposes the
    #                                   drift at its source. 0 = reference
    #                                   behavior.
    fd_eikonal_anneal_init: float = 0.0   # >0 with anneal_steps: the fd
    #                                   eikonal weight STARTS here and
    #                                   decays geometrically to
    #                                   fd_eikonal_weight over anneal_steps
    #                                   (strong early unit-slope pressure
    #                                   while the field forms, gentle
    #                                   late so rendering recovers —
    #                                   NOTES_ROUND2: constant 0.1 cost
    #                                   3.9 dB).
    fd_eikonal_anneal_steps: int = 0
    fd_eikonal_points: int = 0        # >0: evaluate the fd-eikonal term on
    #                                   a random subset of shading points
    #                                   (same expected pressure; the full
    #                                   set costs two extra pair-MLP
    #                                   passes over every shading pair).
    #                                   0 = all points.
    fd_eikonal_weight: float = 0.0    # BEYOND-REFERENCE: finite-difference
    #                                   eikonal at shading points. The
    #                                   analytic eikonal is a NO-OP here
    #                                   (frozen piecewise-linear decoder =>
    #                                   d(grad)/d(latents) == 0 a.e. — the
    #                                   reference has the same dead term);
    #                                   the FD version restores unit-slope
    #                                   pressure on the field.
    rgb_loss: str = "l1"              # "l1" | "mse"


@dataclass(frozen=True)
class TrainConfig:
    """Trainer knobs (reference config/ours.yaml, train.py:175-189)."""
    learning_rate: float = 5.0e-4
    latent_learning_rate: float = 5.0e-4  # ref declares 1e-2 group but the
    #                                       group list is empty (train.py:150-157,
    #                                       175-183) -> latents train at lr
    num_pixels: int = 1024
    opt_steps: int = 100_000
    cosine_t_max: int = 100_000
    cosine_eta_min: float = 3.0e-4
    grad_clip: float = 1.0
    checkpoint_freq: int = 15_000     # in steps (ref counts epochs; 1 img/ep)
    render_freq: int = 500
    split_n_pixels: int = 500
    fast_iters: int = 1               # sampler iterations during training
    scan_unroll: int = 1              # lax.scan unroll for the JAX
    #                                   package's train window; kept so one
    #                                   YAML drives both packages.
    eval_iters: int = 0               # sampler iterations for eval renders;
    #                                   0 = sampler.max_total_iters (the
    #                                   reference's fast=-1 full-quality
    #                                   path, train.py:522). Small values
    #                                   trade render quality for speed and
    #                                   keep dryrun/CI compiles cheap.
    render_chunk: int = 4096          # max rays per eval-render call; the
    #                                   actual chunk adapts down to the
    #                                   image size, so a small image is
    #                                   not padded to a whole chunk.
    render_skip_empty: bool = True    # eval renders: skip whole chunks
    #                                   whose rays all miss the fine
    #                                   occupancy bitmap (host-side numpy
    #                                   test; superset property makes the
    #                                   emitted miss defaults exact).
    #                                   Real frames carry large
    #                                   background bands — the eval-side
    #                                   analogue of train ray compaction.
    seed: int = 0
    data_parallel: int = 1            # ray-sharded devices


@dataclass(frozen=True)
class EvalConfig:
    """Eval-side knobs (the reference has none — argparse flags only,
    eval_spurfies.py:377-441; these make the beat-the-reference stack a
    config/preset decision, VERDICT r2 #9)."""
    auto_iso: bool = False            # extract the mesh at the calibrated
    #                                   iso level (median SDF at the input
    #                                   cloud points) instead of 0 —
    #                                   debiases the pseudo-loss depth
    #                                   skew at extraction time
    #                                   (eval/mesh_extract.calibrate_iso_level).
    #                                   CLI --auto-iso still forces it on.


@dataclass(frozen=True)
class DataConfig:
    data_dir: str = "own_data"        # own_data | dtu | mipnerf
    data_dir_root: str = "data"
    scan_id: str = "114"
    img_res: tuple = (576, 768)
    num_views: int = 3


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    dataset: DataConfig = field(default_factory=DataConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    expname: str = "ours"
    exps_folder: str = "exps"


# ---------------------------------------------------------------------------
# Generic dataclass <- dict/YAML/CLI plumbing.
# ---------------------------------------------------------------------------

def _coerce(tp, value):
    if dataclasses.is_dataclass(tp) and isinstance(value, dict):
        return _from_dict(tp, value)
    if tp is tuple or getattr(tp, "__origin__", None) is tuple:
        return tuple(value)
    return value


def _from_dict(cls, d: dict):
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in d.items():
        if key not in fields:
            raise KeyError(f"unknown config key '{key}' for {cls.__name__}")
        ftype = fields[key].type
        resolved = _resolve_type(cls, ftype)
        kwargs[key] = _coerce(resolved, value)
    return cls(**kwargs)


def _resolve_type(cls, ftype):
    if isinstance(ftype, str):
        import sys
        mod = sys.modules[cls.__module__]
        return getattr(mod, ftype, eval(ftype, vars(mod)))  # noqa: S307
    return ftype


def config_from_dict(d: dict) -> Config:
    return _from_dict(Config, d)


def load_yaml(path: str) -> Config:
    import yaml
    with open(path) as f:
        d = yaml.safe_load(f) or {}
    return config_from_dict(d)


# Named override bundles ("preset=<name>" on any CLI).  The default config
# is reference-exact; presets package the measured beyond-reference knobs.
# Every entry cites its gate (validate_pipeline on the synthetic scene;
# rgb-L1 + mesh err are the stable metrics — PSNR is ±5 dB at 2k steps).
PRESETS: dict[str, list[str]] = {
    # Reference-exact behavior: also pins the dense (uncompacted) ray
    # batch — the default ray_budget_frac=-1 is reference-EQUIVALENT
    # (the CUDA kernel also drops miss rays) but changes the RNG stream.
    # color_top_samples=0 restores exact quadrature (the reference colors
    # EVERY sample, pointneus_disent.py:325-346; the top-32 default is a
    # gated beyond-reference subsampling — VERDICT r4 weak #1), and
    # probe_budget_frac=0 pins the legacy dense-gated sampler probe
    # instead of the auto-calibrated occupancy budget.
    "reference_exact": ["model.ray_budget_frac=0",
                        "model.color_top_samples=0",
                        "model.probe_budget_frac=1",
                        "train.render_skip_empty=false"],
    # Maximum training throughput at gated quality (the gates and their
    # measurements are the JAX package's; see spurfies_tpu/config.py).
    # ray_budget_frac=-1 auto-calibrates per scene; it is also the default
    # and stays here for configs that override the default off.
    # occ_compact is NOT included: under ray compaction it is redundant
    # (same pruned work); the renderer ignores it when both are on.
    # train.eval_iters=3 renders with fewer sampler iterations than the
    # reference's 5 at the same masked PSNR.
    "throughput": [
        "model.probe_k=1",
        "model.ray_budget_frac=-1",
        "train.eval_iters=3",
    ],
    # Best mesh quality (the JAX package's gates; see spurfies_tpu/config.py).
    # cloud_anchor 0.5 lowers the mesh error and its signed bias at no
    # rendering cost.  The anchor pins sdf(cloud)~0 so auto-iso calibrates
    # to ~0 with it (kept on: recovers bias whenever the anchor is
    # overridden off).
    "quality_beat": [
        "loss.cloud_anchor_weight=0.5",
        "eval.auto_iso=true",
    ],
}


def apply_overrides(cfg: Config, overrides: list[str]) -> Config:
    """Apply ``a.b.c=value`` dotted overrides (reference Hydra-CLI surface).

    ``preset=<name>`` expands to the PRESETS bundle (applied in place, so
    later explicit overrides win over preset values).
    """
    expanded: list[str] = []
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got '{ov}'")
        key, _, raw = ov.partition("=")
        if key.strip() == "preset":
            name = raw.strip()
            if name not in PRESETS:
                raise KeyError(
                    f"unknown preset '{name}' (have: {sorted(PRESETS)})")
            expanded.extend(PRESETS[name])
        else:
            expanded.append(ov)
    for ov in expanded:
        key, _, raw = ov.partition("=")
        cfg = _set_dotted(cfg, key.strip().split("."), _parse_value(raw.strip()))
    return cfg


def _parse_value(raw: str) -> Any:
    import json
    try:
        return json.loads(raw)
    except (ValueError, TypeError):
        return raw


def _set_dotted(obj, path: list[str], value):
    name = path[0]
    if not dataclasses.is_dataclass(obj) or name not in {
        f.name for f in dataclasses.fields(obj)
    }:
        raise KeyError(f"unknown config path element '{name}'")
    if len(path) == 1:
        current = getattr(obj, name)
        if isinstance(current, tuple) and isinstance(value, list):
            value = tuple(value)
        return dataclasses.replace(obj, **{name: value})
    return dataclasses.replace(
        obj, **{name: _set_dotted(getattr(obj, name), path[1:], value)}
    )
