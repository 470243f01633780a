#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``spurfies_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package.  Phases, in order (any
failure exits non-zero before the last line):

  1. device: the card's name and ``nvidia-smi`` name / power limit;
  2. build: every kernel of ``spurfies_tpu_torch/csrc`` with nvcc for
     sm_90a and its host routines (``host_dedup.cpp``, ``host_jpeg.cpp``)
     with the host
     compiler, one process per source, all at once (seconds, and each entry
     function's registers and spills); the HGMMA and HMMA counts of the
     SASS of the wgmma kernels (WGMMA_KERNELS: K3, K2, K6a, K6b, K7a, K7b
     and the colour stack's), each of which must hold HGMMA;
  3. scenes: the DUSt3R-like cloud of ``make_dust3r_like_scene`` (the
     JAX package's bench scene, 192x256 views; ~6k points -> the packed K1
     variant) and a dense 40k-point sphere (>2**15 points -> the exact K1
     variant), both with the repo's pretrained prior
     (``spurfies_tpu_torch/assets/local_prior.npz``) and seeded latents;
  4. render kernels: K1-K3 against their plain PyTorch versions on the
     card, in bf16, on the inputs of the first 4096-ray chunk of each
     scene's render (probe and shading shapes), with timings and bounds
     (K1 also by its C entry, ``kernel_ms``, and on the shading input the
     ``K1 step 0`` line: its lists per warp and the wrapper's host time);
     K2's and K3's pt exactly 0 on points with no real pair, K3's w and
     r_lat exactly 0 on dump pairs, and each timed again with every pair
     made a dump pair (K3: under a tenth of the real run's time; K2: under
     a tenth of what its pairs would take if each cost a real one); K2's pt
     bit-equal to K3's pt[:, :2] on the probe input; on dust3r_like also
     K6b / K6a on that chunk's probe and shading pair rows
     (``model.fused_agg=false``, K6a's r_lat bit-equal to K3's on the
     valid pairs, K6b's s and x_pi bit-equal to K6a's on the probe rows,
     K7a's s and r bit-equal to K6a's on u = [g_lat | K6a's x_pi] of the
     shading rows) and K7a on its shading pairs compacted as
     ``model.pair_budget_frac=0.625`` compacts them;
  5. render path: launch counters set to 0, then ``make_render_fn`` renders
     view 0 of both scenes in full (2 x 49,152 rays, default ModelConfig,
     render_chunk=4096, 5 sampler iterations); outputs must be finite and
     every kernel's counter must have moved by the count the chunking
     implies; prints rays/s and the masked PSNR against the analytic view;
     then view 0 of dust3r_like again with ``model.fused_agg=false``, its
     counters read on their own (K1 6, K6b 5 and K6a 1 per chunk, no K2/K3);
  6. reference render: the first 4096-ray chunk rendered again with the
     plain versions substituted for the kernels, compared ray by ray; the
     same for the chunk under ``model.fused_agg=false`` and under
     ``model.render_budget_frac=0.9``;
  7. where the render's time goes: view 0 of the DUSt3R-like scene
     rendered warm TIMED_RENDERS times (rays/s), then once under
     ``torch.profiler`` (the ``profile:`` JSON line), and once more under
     ``model.fused_agg=false`` (the ``profile fused_agg=false render:``
     line);
  8. training kernels: a ``Trainer`` on the DUSt3R-like scene at full
     width (1024 rays/step, default config, auto budgets) takes one step
     whose kernel inputs are kept; every launch of it runs again against
     its plain version: K1 (probe, shading, pseudo-SDF), K2 (probe) and K3
     (render SDF, pseudo-SDF) by the limits of phase 4; K4 and K5 within
     the f32 sum-order limit of ``sum_order_within`` (an f32-reordered
     plain sum is read beside it as a control), with timings, bounds and
     ``index_add_`` as the library yardstick (K1, K4 and K5 also by their
     C entries); on each path's largest K5 launch, the ``K5 step 0`` line
     (its zero rows, hottest index and distinct (tile, index) pairs, and
     K5 timed as it is, with the zero rows dropped, in a random order and
     with no repeated index); on the default path's K1 launches, the ``K1
     step 0`` line;
  9. reference step: the loss and the gradient of every trained tensor of
     one batch, through the kernels and through the plain versions, with
     the same batch and draws, compared by ``compare_grads``; then two
     steps under ``torch.cuda.set_sync_debug_mode`` count the host syncs;
 10. training path: the DUSt3R-like scene renders view 0 (masked PSNR),
     trains a warm-up window, then -- counters set to 0 -- TRAIN_STEPS
     timed steps (train rays/s), and renders view 0 again; the loss must
     stay finite, no step may be skipped, rgb_loss must fall and every
     kernel's counter must equal steps x its per-step count; a few steps
     on the dense sphere drive K4/K5 with N > 2**15 and the exact K1;
 11. where a step's time goes: PROFILE_STEPS steps under
     ``torch.profiler`` (the ``train profile:`` JSON line);
 12. two more training paths on dust3r_like, each through phases 8-11
     (every launch of one step against its plain version, one batch's
     loss and gradients, host syncs, OPTION_WARMUP + OPTION_STEPS steps
     with launch counts, a profiled window; the ``train profile <tag>:``
     JSON line): ``model.fused_agg=false`` (K6a, K6b, K5; no
     K2/K3/K4) and ``model.pair_budget_frac=0.625
     model.color_pair_frac=0.75`` (K7a, and K5 behind ``gather_latents``);
 13. pair-MLP microbenchmark (``scripts/microbench.py:88-104``): K7b and
     K7a on MICRO_PAIRS random pairs, counters read on their own, each
     timed and held against its plain version; the ``K7b step 0`` line
     (K7b through its wrapper and by its C entry, the TFLOP/s it executes,
     its blocks and the weight bytes they read); K7b's s bit-equal to
     K7a's on the same pairs;
 14. the fused colour (``field.FUSED_COLOR``, set and restored around each
     use), in three places: after phase 5, view 0 of dust3r_like rendered
     in full with its launch counts (the pack and K8a once per chunk), and
     after phase 7 once more under ``torch.profiler`` (the ``profile
     fused_color render:`` line);
     after phase 6,
     the first chunk against the plain versions (``compare_chunk``), K8a
     held against its plain version on that chunk's colour inputs, and the
     colour path timed through ``aggregate_color`` fused and dense
     (FUSED_COLOR off) at the same shapes, forward and forward+backward;
     after phase 13, the training path of phase 12 with FUSED_COLOR on (the
     pack, K8a and K8b once a step; the pack bit-equal to its plain
     version, K8b's dlat by phase 4's limits, its dW/db by
     ``compare_grads``' 1e-2 relative L2 and bit-equal over two
     launches), OPTION_WARMUP + OPTION_STEPS
     steps, and the colour path timed at one step's shapes;
 15. the training CLI at the reference DTU config: a synthetic DTU scan
     (CLI_VIEWS views of 576x768, phase 3's dense sphere: the exact K1)
     written by ``export_synthetic_dtu`` into a temporary directory, the
     PNG decode times (the fixture's own file and Paeth-filtered 576x768
     and 1200x1600 images), then ``cli.train.main`` with ``--config
     configs/dtu_pn.yaml --scans scan24`` for CLI_STEPS steps and again
     with ``--resume`` to CLI_STEPS + CLI_RESUME_STEPS, a validation
     render (144x192) and a checkpoint every CLI_EVERY steps; counters set
     to 0 just before the two calls.  It fails unless the trainer's
     tensors are on the card, the resumed run restored step CLI_STEPS with
     params bit-equal to the saved ``latest``, the launches equal steps x
     the per-step counts plus each validation render's (its chunking's)
     counts, ``metrics.jsonl`` holds finite losses with rgb_loss falling
     and a ``val`` PSNR row at every render, the checkpoints are there,
     every launch of one captured step of the CLI's trainer holds against
     its plain version and two steps make no host sync.  It prints the
     export and load seconds, the decode times, train rays/s and ms/step
     and the validation render's ms.  Every K3 ``r_lat`` check (here and
     in phases 4 and 8) and every K6a/K7a ``r`` check holds a row above
     0.05 of its column's scale as a LeakyReLU gate flipped on its kink
     (``explain_kinks``), or fails;
 16. the evaluation CLIs on phase 15's trained scan (``eval_phase``):
     ``cli.evaluate.main`` with ``--mesh --rendering --resolution 512
     --max-views 2`` (counters set to 0 just before it), then
     ``calibrate_iso_level`` and ``cli.eval_dtu.main`` on the mesh and the
     export's GT cloud, each part timed (grid, probe by wall and CUDA
     events, device marching, ``largest_component``, PLY write, each NVS
     render, SSIM, PNG writes; the cleaning's passes, sampling, dedup and
     KD queries).  It holds the probe's K1 and K2 at its busiest chunk
     against their plain versions, the grid of its 8 busiest chunks
     against the plain versions' (phase 4's limits, the same points at
     1000), the device marching against the CPU's on a 128**3 block
     (faces equal), the launches (chunks x (K1 + K2) in the probe, each
     render's chunking, one K1 a scene build), 0 host syncs in the probe
     loop, LPIPS card against CPU (random weights) and ``chamfer.json``;
     it prints the probe budget's busiest chunk;
 17. K9 (``ops/gather_rows.py``): the port's ``micro_gather`` script
     (counters set to 0 just before it), then K9 bit-equal to
     ``table[idx]`` at 655,360 x 40, timed beside it;
 18. ``model.occ_compact`` in training (``option_phase``, the OPTIONS
     entry ``occ_compact``: ``model.ray_budget_frac=0``, the option's
     only active setting): phase 12's path on dust3r_like -- one captured
     step held launch by launch, a batch's loss and gradients against the
     plain versions, 0 host syncs, OPTION_WARMUP + OPTION_STEPS steps with
     launches = steps x PER_STEP and rgb_loss falling -- and a profile;
 19. the legacy entangled model (``entangled_phase``,
     ``model.entangled=true`` on dust3r_like): a full 192x256 render (K1
     once a chunk, nothing else), a batch's loss and gradients through K1
     and its plain version, 0 host syncs, OPTION_WARMUP + OPTION_STEPS
     steps (K1 once a step, nothing else), their ms a step and the peak
     device memory;
 20. the local (Vis-MVSNet) feature loss through the training CLI
     (``local_phase``): a random-weight ``ckpt/vismvsnet.pt`` in the
     reference's key layout and the ``cam4feat`` / ``image`` fixtures
     written from phase 15's scan; the extractor on the card against the
     CPU; ``cli.train.main`` at ``configs/dtu_pn.yaml`` with
     ``loss.local_weight=0.5`` for LOCAL_STEPS steps (the bundle on the
     card, local_loss finite and non-zero, the launches, one captured step
     against the plain versions, 0 host syncs), the bundle's build time
     and ms/step beside phase 15's;
 21. prior pretraining (``pretrain_phase``): ``cli.pretrain_prior.main``
     at ``PriorConfig``'s widths for PRIOR_STEPS of its 20,000 steps (K1
     once a step, sdf_l1 falling, steps/s), one step through K1 against
     its plain version, and the saved npz in a ``Trainer``
     (``load_frozen``) rendering a chunk;
 22. point-cloud prep (``prep_phase``) at ``Dust3rConfig()``'s full width
     (ViT-L encoder, two ViT-B decoders, 384x512 images): a random-weight
     checkpoint in the upstream key layout, written as f16; one pair
     through the network on the card against the CPU (PREP_TOL of each
     output's scale); then ``cli.prep_pointcloud.main`` on the first three
     images of phase 15's scan (``--device cuda --conf PREP_CONF``): the
     weights' load and convert time, each pair's ms, the alignment's
     seconds and first and last loss, the points kept by the confidence
     filter and by the subsample, peak device memory, 0 launches of the
     TPU-kernel counterparts (this path has none), the alignment loop run
     again on the CLI's pointmaps with 0 host syncs, and the ``.ply`` and
     ``.json`` read back;
 23. ray sharding (``dp_phase``, ``train.data_parallel``) on dust3r_like
     at the default config: two ranks on the one card through
     ``parallel.launch`` over gloo (NCCL refuses two ranks on one device):
     DP_PARITY_STEPS steps, each step's whole-batch loss parts against a
     dp=1 ``Trainer``'s of the same seed within DP_PARTS_RTOL relative
     (``tests/test_torch_parallel.py``'s limit) and each leaf after them
     within DP_LEAF_LR learning rates of its own, the host syncs
     of two steps, DP_STEPS timed steps (ms/step, loss parts finite,
     rgb_loss falling, each rank's launches), the ranks' parameters
     bit-equal; then, on the same two ranks, ``cli.train.main`` at
     ``train.data_parallel=2`` on phase 15's scan for DP_CLI_STEPS steps
     (one experiment directory, one checkpoint, written by rank 0) and a
     ``--resume`` from DP_CLI_STEPS (restored at that step) for
     DP_CLI_RESUME more, whose gathered validation render is held to a
     dp=1 render of the same checkpoint by phase 6's limits; and one rank
     over NCCL (its all-reduce on the card) for DP_NCCL_STEPS steps,
     ms/step and 0 host syncs, beside phase 10's unsharded ms/step;
 24. the sphere validation (``validate_phase``): the port's
     ``scripts.validate_pipeline`` at VALIDATE_STEPS steps (counters set
     to 0 just before it): the launches (steps x PER_STEP, one K1 in the
     build, chunks x (K1 + K2) in each of the two mesh probes, the iso
     calibration's probe, view 0's render), then the masked PSNR and the
     mean radius error held to the JAX package's own script on the CPU
     within VALIDATE_PSNR_MARGIN dB and VALIDATE_RADIUS_MARGIN
     (``validate_gate``);
 25. the acceptance chain (``chain_phase``): the port's
     ``scripts.acceptance_chain`` through its ``main`` in the temporary
     root at CHAIN_STEPS steps, the mesh at CHAIN_MESH_RES and CHAIN_VIEWS
     views (192x256, the production widths): ``--stop-at CHAIN_STOP``,
     then ``--resume``, the production run's path; each call's launches
     (builds, steps x PER_STEP, each render's chunking, the mesh probe),
     the record's keys against ``artifacts/acceptance_chain_r05.json``'s,
     one experiment directory, a non-empty mesh, finite Chamfer, PSNR and
     SSIM;
 26. JPEG input (``jpeg_phase``): every fixture of ``tests/fixtures/jpeg``
     decoded by ``read_image`` and ``read_bgr`` and held to the SHA-256 of
     imageio's and cv2's arrays recorded in its ``hashes.json`` (neither
     library is on the card's machine; ``read_bgr`` turns the EXIF-6 file
     as cv2 does, and raises a ``ValueError`` on the grey lossless file,
     whose ``"cv2"`` is null), each file's JPEG process (baseline,
     progressive, lossless, arithmetic, no DHT) and the decoder's ms per
     megapixel on this host; then the
     three committed views trained through ``cli.train.main`` three ways
     (counters set to 0 just before each): as an own-data scene (the
     ``.json`` and ``.ply`` of ``export_synthetic_own_data`` at the
     views' scene, ``configs/own_data.yaml``), as the mip-NeRF ``garden``
     layout (the files named as ``TRAIN_FRAMES["garden"]``,
     ``configs/mip_nerf.yaml``) and as the scene that
     ``cli.prep_pointcloud`` makes of them (phase 22's random DUSt3R at
     full width; no launch in the prep), each JPEG_STEPS steps: launches =
     the build's K1 + steps x PER_STEP + each render's chunking, rgb_loss
     finite and falling from the first third of the JPEG_WINDOWS windows
     to the last;
 27. the 100k-step run's script (``run100k_phase``): the port's
     ``scripts.run_100k`` through its ``main`` in the temporary root, cut
     to RUN100K_STEPS steps at the production widths (default config, 1024
     rays, the dust3r_like scene): ``--stop-at RUN100K_KILL``, then
     ``--resume`` (the kill), the production run's path; each call's
     launches (the build, the steps, each evaluation's two mesh probes,
     calibration probe and two renders), the record's keys against
     ``artifacts/run100k_default.json``'s, the events, finite evaluations;
 28. the ``kernels`` JSON line (launches by render, training, evaluation
     and microbenchmark runs), the ``redesign_order`` line (the kernels
     ranked by launches x (ms - bound_ms) in this run) and the
     ``redesign_order_kernel_ms`` line (the same with the C entry's time
     where a kernel has one), the ``nvidia-smi`` line, then the device
     JSON line.
"""

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

# peak rates of one H100 SXM (NVIDIA data sheet; dense, at 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
CHUNK = 4096
TIMED_RENDERS = 3
TRAIN_WARMUP = 20
TRAIN_STEPS = 200
TRAIN_WINDOW = 50
DENSE_STEPS = 3
PROFILE_STEPS = 10
# kernel launches of one training step at the default config (fast_iters=1:
# one sampler probe; the shading query and the pseudo-SDF probe; K3 and K4
# for the render's SDF and for the pseudo-SDF loss; K5 for the colour
# latents); K1 is the packed or the exact variant by the cloud's size
PER_STEP = {"select_knn": 3, "pair_sdf_value_agg": 1, "pair_sdf_aggregate": 2,
            "pair_sdf_aggregate_bwd": 2, "scatter_add_rows": 1}
# the two option paths: fused_agg=false probes with K6b and runs K6a for the
# render SDF and the pseudo-SDF, each scattering its latent gradient with K5
# (as does the colour); the pair-compacted SDF runs K7a (its latents' K5),
# the probe stays K2 and the pseudo-SDF K3/K4, and the colour's K5 is
# gather_latents'
OPTIONS = {
    "unfused": (["model.fused_agg=false"],
                {"select_knn": 3, "pair_sdf_rows_value": 1,
                 "pair_sdf_rows_grad": 2, "scatter_add_rows": 3}),
    "pairs": (["model.pair_budget_frac=0.625", "model.color_pair_frac=0.75"],
              {"select_knn": 3, "pair_sdf_value_agg": 1,
               "pair_sdf_value_and_input_grad": 1, "pair_sdf_aggregate": 1,
               "pair_sdf_aggregate_bwd": 1, "scatter_add_rows": 2}),
}
OPTION_WARMUP = 20
OPTION_STEPS = 50
# phase 18: occ_compact in training (active only without the ray budget)
OPTIONS["occ_compact"] = (["model.ray_budget_frac=0",
                           "model.occ_compact=true"], PER_STEP)
# phase 19: the legacy entangled model, whose training step runs K1 once
# (the shading query: uniform z-values, no probe, no TV or pseudo-SDF)
ENTANGLED_STEP = {"select_knn": 1}
ENTANGLED_TRAINED = ("feats", "F", "T", "R", "beta")
# phase 20: the local (Vis-MVSNet) loss through the CLI on phase 15's scan
LOCAL_STEPS = 100
# phase 21: prior pretraining at PriorConfig's widths, cut to PRIOR_STEPS
# of its 20,000 steps; K1 once a step
PRIOR_STEPS = 500
# phase 22: point-cloud prep at Dust3rConfig()'s full width, random weights;
# with them the head's c is about N(0, 0.58) (a LayerNorm'd token through a
# +-1/sqrt(768) uniform linear), so conf = 1 + exp(c) >= PREP_CONF keeps
# about a quarter of the 3 x 384 x 512 points (the CLI's default, 10, would
# keep almost none); the card's pair against the CPU's within PREP_TOL of
# each output's scale (f32, TF32 off on both: only the sum order differs)
PREP_CONF = 2.5
PREP_TOL = 1e-4
# phase 23: ray sharding on dust3r_like, two ranks on the one card over
# gloo and one rank over NCCL; the training CLI on two ranks on phase 15's
# scan, then a resume
DP_PARITY_STEPS = 2
# the parity steps' limits: the loss parts as tests/test_torch_parallel.py
# holds them; every leaf within half a learning rate (Adam moves an entry
# by about lr a step whatever its gradient, so 2 lr a step would pass any
# gradient; the largest leaf difference read on an H100 was 0.35 lr)
DP_PARTS_RTOL = 1e-5
DP_LEAF_LR = 0.5
DP_STEPS = 20
DP_WINDOW = 5
DP_NCCL_STEPS = 10
DP_CLI_STEPS = 20
DP_CLI_RESUME = 10
# phase 24: the port's validate_pipeline (the analytic sphere) at
# VALIDATE_STEPS, held to the JAX package's own script run on the CPU with
# the same steps (`JAX_PLATFORMS=cpu python scripts/validate_pipeline.py
# --steps 1000`, its JSON in PERF.md; the script's default 2,000 steps do
# not finish within 70 min on an 8-core CPU): the masked PSNR at most
# VALIDATE_PSNR_MARGIN dB below JAX's, the mean radius error at most
# VALIDATE_RADIUS_MARGIN above JAX's
VALIDATE_STEPS = 1000
VALIDATE_RES = 128
JAX_VALIDATE = {"masked_psnr": 23.23, "mesh_mean_radius_err": 0.02289}
VALIDATE_PSNR_MARGIN = 3.0
VALIDATE_RADIUS_MARGIN = 0.01
# phase 25: the port's acceptance chain at a cut budget (steps, mesh grid,
# views; the widths are the production run's): --stop-at CHAIN_STOP, then
# --resume to CHAIN_STEPS
CHAIN_STEPS = 300
CHAIN_STOP = 200
CHAIN_MESH_RES = 256
CHAIN_VIEWS = 2
# phase 26: JPEG input; each CLI run trains JPEG_STEPS steps in windows of
# JPEG_STEPS // JPEG_WINDOWS (a validation render after each), and rgb_loss
# must fall from the mean of the first JPEG_WINDOWS // 3 windows to that of
# the last: a window's rgb_loss is its last step's, one batch of 1024 rays,
# so single windows are noisy (the prep scene's read 0.430, 0.329, 0.328,
# 0.327, 0.322, 0.439 over 60 steps)
JPEG_STEPS = 120
JPEG_WINDOWS = 12
JPEG_DECODE_REPS = 5
# phase 27: the port's run_100k cut to RUN100K_STEPS, killed (and split
# over two calls) at RUN100K_KILL, evaluated there and at the end
# (a checkpoint falls on a window's end, and the kill on a checkpoint, as
# in the production run: windows of 500, checkpoints every 15k, kill at 45k)
RUN100K_STEPS = 600
RUN100K_KILL = 300
RUN100K_WINDOW = 50
RUN100K_CKPT = 150
# the prior's dtype of cli.train.train_scene on the card
CLI_DTYPE = "bfloat16"
# ms/step of the timed training paths, by tag (train_path)
TIMED = {}
# the fused colour path's training step: the default's launches, with the
# colour stack through the pack (once a step), K8a forward and K8b backward
# (its latents' K5 stays)
FUSED_COLOR_STEP = dict(PER_STEP, pack_color_weights=1, fused_color_fwd=1,
                        fused_color_bwd=1)
MICRO_PAIRS = 655360
# phase 16: cli.evaluate on phase 15's trained scan, the mesh at EVAL_RES
# (the reference's 512) and EVAL_VIEWS novel views; the probe's chunk and
# budget are eval/mesh_extract.py's and model/field.sdf_probe's defaults
EVAL_RES = 512
EVAL_VIEWS = 2
EVAL_CHUNK = 262144
PROBE_BUDGET = 0.25
EVAL_HELD_CHUNKS = 8
MARCH_BLOCK = 128
# phase 17: K9 at scripts/micro_gather.py's default shape
GATHER_ROWS, GATHER_N, GATHER_D = 655360, 6144, 40
# the training CLI at configs/dtu_pn.yaml (576x768 views, 1024 rays a
# step): a synthetic DTU scan of CLI_VIEWS views with phase 3's dense
# sphere, CLI_STEPS steps, then --resume to CLI_STEPS + CLI_RESUME_STEPS;
# a validation render and a checkpoint every CLI_EVERY steps
CLI_VIEWS = 49
CLI_RES = (576, 768)
CLI_STEPS = 200
CLI_RESUME_STEPS = 100
CLI_EVERY = 100
# bf16 weights that the value-only kernels (K2, K6b, K7b) stream from
# PriorLayers.k3_buffer: its 13 up-sweep chunks of [256, 64], and w_v
UP_SWEEP_CHUNKS = 13
UP_SWEEP_WEIGHTS = UP_SWEEP_CHUNKS * 256 * 64 + 256
# device-kernel names of the port's kernels, by the kernels line's label
# (a label may have several: K8a and K8b launch one kernel per piece; K1's
# two variants are one template, select_kernel<PackedKey or ExactKey, ...>)
KERNEL_NAMES = (("K1 select_knn packed", "PackedKey"),
                ("K1 select_knn exact", "ExactKey"),
                ("K2 pair_sdf_value_agg", "value_agg_kernel"),
                ("K3 pair_sdf_aggregate", "sdf_agg_kernel"),
                ("K4 pair_sdf_aggregate_bwd", "agg_bwd_kernel"),
                ("K5 scatter_add_rows", "scatter_rows_kernel"),
                ("K6a pair_sdf_rows_grad", "rows_grad_kernel"),
                ("K6b pair_sdf_rows_value", "rows_value_kernel"),
                ("K7a pair_sdf_value_and_input_grad", "rows_pre_grad_kernel"),
                ("K7b pair_sdf_value", "rows_pre_value_kernel"),
                ("K8p pack_color_weights", "color_pack_kernel"),
                ("K8a fused_color_fwd", "color_pair_fwd_kernel"),
                ("K8a fused_color_fwd", "color_point_fwd_kernel"),
                ("K8b fused_color_bwd", "color_pair_recompute_kernel"),
                ("K8b fused_color_bwd", "color_point_bwd_kernel"),
                ("K8b fused_color_bwd", "color_pair_bwd_kernel"),
                ("K8b fused_color_bwd", "color_dw_kernel"),
                ("K8b fused_color_bwd", "color_reduce_kernel"))
# the wgmma kernels whose SASS must hold HGMMA: (label, library, kernel)
WGMMA_KERNELS = (("K3", "sdf_agg", "sdf_agg_kernel"),
                 ("K2", "sdf_agg", "value_agg_kernel"),
                 ("K6a", "sdf_agg", "rows_grad_kernel"),
                 ("K6b", "sdf_agg", "rows_value_kernel"),
                 ("K7a", "sdf_agg", "rows_pre_grad_kernel"),
                 ("K7b", "sdf_agg", "rows_pre_value_kernel"),
                 ("K8a pair", "color_mlp", "color_pair_fwd_kernel"),
                 ("K8a point", "color_mlp", "color_point_fwd_kernel"),
                 ("K8b pair recompute", "color_mlp",
                  "color_pair_recompute_kernel"),
                 ("K8b point", "color_mlp", "color_point_bwd_kernel"),
                 ("K8b reverse pair", "color_mlp", "color_pair_bwd_kernel"))
# MACs of the colour stack: F_color per pair, R per point; the backward's
# dW products repeat the forward's, its delta products skip what no output
# reads (F0's posenc rows, R0's dir_enc rows)
F_MACS = 103 * 256 + 3 * 256 * 256
R_MACS = 277 * 256 + 256 * 256 + 256 * 3
F_BWD_MACS = F_MACS + 3 * 256 * 256 + 64 * 256
R_BWD_MACS = R_MACS + 256 * 3 + 2 * 256 * 256
COLOR_PARAMS = F_MACS + 4 * 256 + R_MACS + 2 * 256 + 3      # 361,731 f32
TRAINED = ("feats_geometry", "feats_color", "F_color", "R", "beta")


def log(*a):
    print(*a, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events,
    after one warm-up call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def bound_ms(n_bytes, flops, peak_flops):
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = flops / peak_flops * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def setup_scene(pts, cols, cfg, prior_path, seed, dev):
    import torch

    from spurfies_tpu_torch.convert.from_jax import load_prior_npz
    from spurfies_tpu_torch.model.networks import init_model_params
    from spurfies_tpu_torch.model.neural_points import build_scene

    gen = torch.Generator().manual_seed(seed)
    scene, latents = build_scene(pts, cfg.model, cols, generator=gen,
                                 device=dev)
    params = init_model_params(cfg.model, gen, device=dev)
    tp = dict(params["train"], **latents)
    return scene, tp, load_prior_npz(prior_path, device=dev)


def first_chunk(scene, view, cfg, dev):
    """cam_loc / ray_dirs of the first CHUNK occupied rays of a view (the
    render's first chunk) and the number of occupied rays."""
    import torch

    from spurfies_tpu_torch.core.cameras import get_camera_params
    from spurfies_tpu_torch.model.renderer import coarse_ray_occupancy

    uv = torch.as_tensor(view["uv"], device=dev)[None]
    pose = torch.as_tensor(view["pose"], device=dev)[None]
    K = torch.as_tensor(view["intrinsics"], device=dev)[None]
    dirs_b, cam_b = get_camera_params(uv, pose, K)
    dirs = dirs_b.reshape(-1, 3)
    cam = cam_b.expand(dirs.shape[0], 3)
    occ = coarse_ray_occupancy(cam, dirs, scene, cfg.model.ray_sampler)
    sel = torch.nonzero(occ)[:, 0]
    return cam[sel[:CHUNK]], dirs[sel[:CHUNK]], int(sel.numel()), sel[:CHUNK]


def kernel_inputs(scene, tp, prior, cam, dirs, cfg):
    """The first chunk's kernel inputs: the first (uniform-z) probe's K1 and
    K2 inputs, and the shading query's K1 and K3 inputs, made by the port's
    own functions as ``_render_body`` makes them."""
    import torch

    from spurfies_tpu_torch.core.density import get_beta
    from spurfies_tpu_torch.model import field
    from spurfies_tpu_torch.model.sampler import (
        error_bound_z_vals,
        uniform_z_vals,
    )
    from spurfies_tpu_torch.ops.voxel_grid import (
        _cell_ids,
        compact_rays,
        fine_occupancy,
        query_grid,
    )

    m = cfg.model
    spec = scene.spec
    geo = tp["feats_geometry"]
    n = geo.shape[0]
    table = field.pair_table(geo, scene.points)

    def k1_in(x):
        x = x.contiguous()
        return x, _cell_ids(x, spec)

    # probe: uniform z, occupancy budget 0.25
    z = uniform_z_vals(cam.shape[0], m.ray_sampler.near, m.ray_sampler.far,
                       m.ray_sampler.n_samples_eval, False,
                       device=cam.device)
    pts = (cam[:, None, :] + z[..., None] * dirs[:, None, :]).reshape(-1, 3)
    budget = max(int(pts.shape[0] * 0.25) // 128 * 128, 128)
    sel, sel_ok, _ = field.compact_pair_slots(
        fine_occupancy(pts, scene.occ_fine, spec), budget)
    xp, cidp = k1_in(pts[sel])
    idx_p, _ = query_grid(xp, scene.table, spec, k=m.k)
    idx_ext_p = field._idx_ext(idx_p, (idx_p >= 0) & sel_ok[:, None], n)

    # shading: the sampler's z-values, then the has-neighbour compaction
    def probe(x, first=False):
        return field.sdf_probe(prior, geo, scene, x, m.k, m.r, m.rbf,
                               budget_frac=0.25, need_grad=False,
                               return_overflow=True)

    z_all, _ = error_bound_z_vals(probe, cam, dirs, m.ray_sampler,
                                  get_beta(tp["beta"], m.density.beta_min),
                                  m.ray_sampler.max_total_iters, False)
    q = (cam[:, None, :] + z_all[..., None] * dirs[:, None, :]).reshape(-1, 3)
    xs, cids = k1_in(q)
    idx_all, _ = query_grid(xs, scene.table, spec, k=m.k)
    idx_all = idx_all.reshape(cam.shape[0], -1, m.k)
    csel, cval = compact_rays(torch.any(idx_all >= 0, -1), m.max_shading_pts)
    zs = torch.gather(z_all, 1, csel)
    nbr = torch.gather(idx_all, 1, csel[..., None].expand(-1, -1, m.k))
    x3 = (cam[:, None, :] + zs[..., None] * dirs[:, None, :]).reshape(-1, 3)
    valid = ((nbr >= 0) & cval[..., None]).reshape(-1, m.k)
    idx_ext_s = field._idx_ext(nbr.reshape(-1, m.k), valid, n)
    # K6: the same probe and shading pairs as gathered rows; K7: the
    # shading pairs compacted as pair_budget_frac=0.625 compacts them
    valid_p = (idx_p >= 0) & sel_ok[:, None]
    budget = max(int(x3.shape[0] * m.k * 0.625) // 256 * 256, 256)
    _, pidx, x_pi, _, seg = field._compact_pairs(
        nbr.reshape(-1, m.k), valid, scene.points, x3, m.rbf, budget)
    ok = seg < x3.shape[0]
    u = torch.cat([geo[pidx.long()], x_pi], -1).contiguous()
    return {"probe_k1": (xp, cidp), "k2": (table, idx_ext_p, xp.contiguous()),
            "shade_k1": (xs, cids),
            "k3": (table, idx_ext_s, x3.contiguous()),
            "k6b": (field.pair_rows(geo, scene.points, idx_p, xp),
                    valid_p.reshape(-1)),
            "k6a": (field.pair_rows(geo, scene.points, nbr.reshape(-1, m.k),
                                    x3), valid.reshape(-1)),
            "k7": ((u,), ok)}


def k1_args(x, cid, scene, k, packed):
    """K1's arguments as ``query_grid`` passes them for ``scene``."""
    import numpy as np

    qt = scene.table
    r2 = float(np.float32(scene.spec.radius(qt.r) ** 2))
    return (x, cid, qt.idx, qt.pos, r2, k, packed)


def k1_kernel_ms(args, reps):
    """K1's own device time on ``args``: its C entry launched ``reps``
    times into one pair of outputs (CUDA events).  At the training shape the
    wrapper's checks, allocations and ``ctypes`` call take longer on the
    host than the kernel takes on the card, so its time is the host's."""
    import torch

    from spurfies_tpu_torch.ops import cuda_build
    from spurfies_tpu_torch.ops import select_knn as sk

    x, cid, qidx, qpos, r2, k, packed = args
    m = x.shape[0]
    out_idx = torch.empty((m, k), dtype=torch.int32, device=x.device)
    out_d2 = torch.empty((m, k), dtype=torch.float32, device=x.device)
    lib = cuda_build.load("select_knn", sk._SIG)
    stream = torch.cuda.current_stream(x.device).cuda_stream

    def run():
        cuda_build.check(lib.select_knn_launch(
            x.data_ptr(), cid.data_ptr(), qidx.data_ptr(), qpos.data_ptr(),
            m, qidx.shape[0], qidx.shape[1], k, float(r2), int(packed),
            out_idx.data_ptr(), out_d2.data_ptr(), stream), "select_knn")
    return cuda_ms(run, reps)


def k1_inputs_study(x, cid, qidx, qpos, r2, k):
    """What K1's time depends on in one launch's inputs, per warp of 32
    consecutive queries (as a kernel of one thread a query runs them, the
    exact variant's design): the list lengths scanned (the mean over
    queries, the mean of each warp's longest, and the share of lane-steps
    idle while a warp walks its longest list), the candidates inside the
    radius, and the distinct cells a warp reads."""
    import torch

    m, q = x.shape[0], qidx.shape[1]
    in_grid = (cid >= 0) & (cid < qidx.shape[0])
    c = torch.where(in_grid, cid, 0).long()
    cand = qidx[c]
    length = torch.where(in_grid, (cand >= 0).sum(1), 0)
    diff = qpos[c] - x[:, :, None]
    d2 = (diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1]) \
        + diff[:, 2] * diff[:, 2]
    inside = ((cand >= 0) & (d2 <= r2) & in_grid[:, None]).sum(1)
    pad = (-m) % 32
    warp_max = torch.cat([length, length.new_zeros(pad)]).view(-1, 32) \
        .amax(1).float()
    cells = torch.where(in_grid, cid.long(), -1)
    srt = torch.cat([cells, cells.new_full((pad,), -1)]).view(-1, 32) \
        .sort(1).values
    distinct = ((srt[:, 1:] != srt[:, :-1]) & (srt[:, 1:] >= 0)).sum(1) \
        + (srt[:, 0] >= 0).long()
    return {"queries": m, "qcap": q,
            "in_grid_share": float(in_grid.float().mean()),
            "list_mean": float(length.float().mean()),
            "warp_max_mean": float(warp_max.mean()),
            "list_max": int(length.max()),
            "idle_lane_share": 1.0 - float(length.sum()) /
            max(float(warp_max.sum()) * 32.0, 1.0),
            "inside_radius_mean": float(inside.float().mean()),
            "inside_radius_ge_k_share": float((inside >= k).float().mean()),
            "cells_per_warp_mean": float(distinct.float().mean()),
            "cells_per_warp_max": int(distinct.max())}


def k1_host_ms(args, reps):
    """The host time of one K1 wrapper call: the host clock over ``reps``
    calls with no synchronise between them."""
    import torch

    from spurfies_tpu_torch.ops import select_knn as sk

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        sk.select_knn(*args)
    host_ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return host_ms


def check_k1(name, args, reps, study=False):
    """K1 against its plain version on ``args`` (:func:`k1_args`), timed
    through its wrapper (``ms``) and by its C entry (``kernel_ms``,
    :func:`k1_kernel_ms`); with ``study`` also :func:`k1_step0` (the ``K1
    step 0`` line: :func:`k1_inputs_study`, the wrapper's host time)."""
    import torch

    from spurfies_tpu_torch.ops import select_knn as sk

    x, cid, qidx, qpos, r2, k, packed = args
    ki, kd = sk.select_knn(*args)
    ri, rd = sk.select_knn_ref(*args)
    torch.cuda.synchronize()
    # tolerance: bit-equal ids and d2 (the kernel avoids FMA contraction,
    # so it does the plain version's f32 operations)
    if not bool((ki == ri).all()):
        fail(f"{name}: {int((ki != ri).sum())} neighbour ids differ")
    fin = torch.isfinite(rd)
    if not bool((torch.isfinite(kd) == fin).all()):
        fail(f"{name}: validity differs")
    err = float((kd[fin] - rd[fin]).abs().max()) if bool(fin.any()) else 0.0
    if err != 0.0:
        fail(f"{name}: d2 differs by {err}")
    ms = cuda_ms(lambda: sk.select_knn(*args), reps)
    kernel_ms = k1_kernel_ms(args, reps)
    plain_ms = cuda_ms(lambda: sk.select_knn_ref(*args), 3)
    # library yardstick: torch.topk over the [M, qcap] distance matrix
    in_grid = (cid >= 0) & (cid < qidx.shape[0])
    c = torch.where(in_grid, cid, 0).long()
    diff = qpos[c] - x[:, :, None]
    d2m = (diff * diff).sum(1)
    d2m = torch.where((qidx[c] >= 0) & in_grid[:, None] & (d2m <= r2),
                      d2m, float("inf"))
    lib_ms = cuda_ms(lambda: torch.topk(d2m, k, dim=1, largest=False), reps)
    # bound: x, cid and the outputs once, the table rows of the cells that
    # are queried once; ~9 f32 ops per candidate a query really scans
    m = x.shape[0]
    cells = torch.unique(cid[in_grid])
    q = qidx.shape[1]
    scanned = (qidx[c] >= 0).sum(1)[in_grid].sum()
    n_bytes = m * (12 + 4 + k * 8) + int(cells.numel()) * q * 16
    b_ms, b_by = bound_ms(n_bytes, 9.0 * float(scanned), PEAK_F32_FLOPS)
    log(f"{name}: M={m} qcap={q} ids+d2 bit-equal; kernel {ms:.4f} ms "
        f"(C entry alone {kernel_ms:.4f}), plain {plain_ms:.4f} ms, topk "
        f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    res = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": lib_ms, "max_abs_err": err,
           "kernel_ms": kernel_ms, "rows": m}
    if study:
        res["step0"] = dict(k1_inputs_study(*args[:6]), wrapper_ms=ms,
                            kernel_ms=kernel_ms,
                            wrapper_host_ms=k1_host_ms(args, reps))
        log(f"K1 step 0, {name}: {json.dumps(res['step0'])}")
    return res


def check_pair(name, fn, ref, args, prior, prior_f32, rbf, reps):
    import torch

    with torch.no_grad():
        outs = fn(*args, prior, rbf)
        refs = ref(*args, prior, rbf)
        # control: the plain version in f32, read against the limits below
        # and never held to them; it shows what a change of rounding reads
        ctrl = ref(*args, prior_f32, rbf)
    torch.cuda.synchronize()
    if not isinstance(outs, tuple):
        outs, refs, ctrl = (outs,), (refs,), (ctrl,)
    pt, pt_r = outs[0], refs[0]
    if not bool(torch.isfinite(pt).all()):
        fail(f"{name}: non-finite output")
    # tolerance: bf16 on both sides with the same rounding points; only the
    # f32 sums inside each product run in another order, so a bf16 rounding
    # can land one ulp (2**-8 relative) apart and carry through the layers
    err = within(f"{name} per-point sums", pt, pt_r)
    within(f"{name} per-point sums, control f32 plain", ctrl[0], pt_r,
           hold=False)
    table, idx_ext, x = args
    p, k = idx_ext.shape
    # real pairs: an index in [0, N); the rest read the dump row
    real = ((idx_ext >= 0) & (idx_ext < table.shape[0] - 1)).reshape(-1)
    # K2 and K3 compute no dump pair: a point with none real gets pt = 0
    empty = ~real.view(p, k).any(1)
    if bool((pt[empty] != 0).any()):
        fail(f"{name}: pt not exactly 0 on a point with no real pair")
    if len(outs) == 3:
        w_err = float((outs[1] - refs[1]).abs().max())
        if w_err > 1e-6:               # expf against torch.exp, ulps
            fail(f"{name}: w differs by {w_err}")
        # K3 computes no dump pair: w and r_lat exactly 0 there (the plain
        # version has the prior's gradient at the dump position in r_lat,
        # which no consumer reads: K4 drops w == 0 rows)
        if bool((outs[1][~real] != 0).any()) or \
                bool((outs[2][~real] != 0).any()):
            fail(f"{name}: w or r_lat not exactly 0 on a dump pair")
        where = real.nonzero()[:, 0]
        rows_of = pair_inputs(table, idx_ext, x)
        within(f"{name} r_lat (real pairs)", outs[2][real].float(),
               refs[2][real].float(),
               kink=(prior, lambda rows: rows_of(where[rows])))
        within(f"{name} r_lat, control f32 plain", ctrl[2][real].float(),
               refs[2][real].float(), hold=False)
    del ctrl
    with torch.no_grad():
        ms = cuda_ms(lambda: fn(*args, prior, rbf), reps)
        plain_ms = cuda_ms(lambda: ref(*args, prior, rbf), 2)
    # MACs per pair: up 32*256 + 3*256 + 3*256*256 + 256; K3 adds the down
    # sweep 3*256*256 + 256*35 (the first delta is elementwise).  The work
    # this data needs is that of the real pairs: a pair on the dump row
    # has w == 0 and adds nothing (neither kernel computes it).
    up = 32 * 256 + 3 * 256 + 3 * 256 * 256 + 256
    down = 3 * 256 * 256 + 256 * 35
    grad = len(outs) == 3
    pairs = int(real.sum())
    flops = 2.0 * pairs * (up + (down if grad else 0))
    n_bytes = table.numel() * 4 + p * k * 4 + p * 12 + \
        (p * 20 + p * k * (4 + 64) if grad else p * 8)
    b_ms, b_by = bound_ms(n_bytes, flops, PEAK_BF16_FLOPS)
    log(f"{name}: P={p} k={k}, {pairs} real pairs "
        f"({pairs / (p * k):.3f}); kernel {ms:.4f} ms "
        f"({flops / ms / 1e9:.1f} TFLOP/s on real pairs, "
        f"{flops * p * k / max(pairs, 1) / ms / 1e9:.1f} counting every "
        "pair), "
        f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "max_abs_err": err,
            "rows": p}


def dump_cost(name, fn, args, prior, rbf, reps, limit):
    """K3 or K2 (``fn``) on one P twice: with its real pairs, and with
    every pair made a dump pair.  A dump pair costs no product work, so the
    second run must give zeros everywhere and take under ``limit`` of the
    first's time."""
    import torch

    table, idx_ext, x = args
    dump = torch.full_like(idx_ext, table.shape[0] - 1)
    with torch.no_grad():
        outs = fn(table, dump, x, prior, rbf)
        torch.cuda.synchronize()
        if not isinstance(outs, tuple):
            outs = (outs,)
        if any(bool((o != 0).any()) for o in outs):
            fail(f"{name}: an all-dump input gave a nonzero output")
        ms_real = cuda_ms(lambda: fn(*args, prior, rbf), reps)
        ms_dump = cuda_ms(lambda: fn(table, dump, x, prior, rbf), reps)
    log(f"{name}: P={idx_ext.shape[0]}, every pair a dump pair "
        f"{ms_dump:.4f} ms, its real pairs {ms_real:.4f} ms "
        f"(ratio {ms_dump / ms_real:.4f}, must be < {limit:.4g})")
    if ms_dump >= limit * ms_real:
        fail(f"{name}: dump pairs still cost product work")


def sass_opcodes(lib, kernel, opcodes):
    """``{opcode: count}`` in the SASS of the kernel whose name contains
    ``kernel`` in the library ``lib`` (``cuobjdump -sass``); None where the
    toolkit has no cuobjdump."""
    from spurfies_tpu_torch.ops import cuda_build

    tool = os.path.join(os.path.dirname(cuda_build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    text = "".join(sec for sec in out.split("Function : ")[1:]
                   if kernel in sec.split("\n", 1)[0])
    if not text:
        fail(f"no kernel named *{kernel}* in {lib}")
    return {op: len(re.findall(rf"\b{op}\.", text)) for op in opcodes}


def check_rows(name, fn, ref, args, prior, prior_f32, reps, radius,
               n_real=None):
    """A per-row pair-MLP kernel (K6a/K6b on (g, x), K7a/K7b on (u,))
    against its plain version: x_pi bit-equal (the same f32 subtraction),
    s and r by the limits of phase 4 (the 0.05 rule on the rows whose x_pi
    lies in the query ``radius``: no RBF weight reads the others; r's rows
    above it held as kink flips, ``explain_kinks``), with the f32 control
    beside them.  ``n_real``: the rows this data needs
    (valid pairs; default all)."""
    import torch

    xpi = args[1] - args[0][:, 32:] if len(args) == 2 else args[0][:, 32:]
    keep = (xpi * xpi).sum(1) <= radius * radius

    def rows_of(rows):
        return args[0][rows, :32], xpi[rows]

    with torch.no_grad():
        outs = fn(*args, prior)
        refs = ref(*args, prior)
        ctrl = ref(*args, prior_f32)
    torch.cuda.synchronize()
    if not isinstance(outs, tuple):
        outs, refs, ctrl = (outs,), (refs,), (ctrl,)
    grad = len(outs) == 3 or (len(args) == 1 and len(outs) == 2)
    labels = ("s", "r", "x_pi")[:len(outs)] if grad else ("s", "x_pi")
    err = 0.0
    for label, o, r, c in zip(labels, outs, refs, ctrl):
        if not bool(torch.isfinite(o).all()):
            fail(f"{name}: non-finite {label}")
        if label == "x_pi":
            if not torch.equal(o, r):
                fail(f"{name}: x_pi differs from x - pos")
            continue
        # r (K6a, K7a): a row above 0.05 must be a kink flip
        err = max(err, within(f"{name} {label}", o, r, keep=keep,
                              kink=(prior, rows_of) if label == "r"
                              else None))
        within(f"{name} {label}, control f32 plain", c, r, hold=False,
               keep=keep)
    del ctrl
    with torch.no_grad():
        ms = cuda_ms(lambda: fn(*args, prior), reps)
        plain_ms = cuda_ms(lambda: ref(*args, prior), 2)
    rows = args[0].shape[0]
    needed = ("" if n_real is None else
              f", {n_real} rows the data needs ({n_real / max(rows, 1):.3f})")
    n_real = rows if n_real is None else n_real
    up = 32 * 256 + 3 * 256 + 3 * 256 * 256 + 256
    down = 3 * 256 * 256 + 256 * 35
    per_row = 2.0 * (up + (down if grad else 0))
    # bytes: every input row read once, every output written once, and the
    # packed bf16 weights that the kernel streams (all of k3_buffer; without
    # the down sweep its 13 up-sweep chunks and w_v) and the f32 biases
    w_elems = prior.k3_buffer().numel() if grad else UP_SWEEP_WEIGHTS
    n_bytes = sum(t.numel() * 4 for t in args) + \
        sum(o.numel() * 4 for o in outs) + w_elems * 2 + \
        prior.bias_buffer().numel() * 4
    b_ms, b_by = bound_ms(n_bytes, per_row * n_real, PEAK_BF16_FLOPS)
    b_all, _ = bound_ms(n_bytes, per_row * rows, PEAK_BF16_FLOPS)
    log(f"{name}: M={rows}{needed}; kernel {ms:.4f} ms "
        f"({per_row * rows / ms / 1e9:.1f} TFLOP/s executed), plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; {b_all:.4f} ms "
        "counting every row)")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "max_abs_err": err,
            "bound_all_rows_ms": b_all, "rows": rows, "rows_needed": n_real}


def k7b_step0(u, prior, reps):
    """Step 0 of K7b's redesign: what holds it on ``u``.  Its time through
    the wrapper and by its C entry alone (CUDA events, one output), the
    TFLOP/s that executes, its blocks and the bf16 weight bytes they read
    a 128-row tile (from L2: the weights fit there) and their sum over a
    launch.  The ``K7b step 0`` line; returns the C entry's ms."""
    import torch

    from spurfies_tpu_torch.ops import cuda_build, pair_mlp

    m = u.shape[0]
    out = torch.empty((m,), dtype=torch.float32, device=u.device)
    # csrc/sdf_agg.cu: a persistent grid, one block an SM, each streaming
    # the 13 up-sweep chunks of k3_buffer a tile
    wbuf, bbuf = prior.k3_buffer(), prior.bias_buffer()
    lib = cuda_build.load("sdf_agg", pair_mlp._SIG_SDF_AGG)
    stream = torch.cuda.current_stream(u.device).cuda_stream

    def run():
        cuda_build.check(lib.pair_sdf_pre_value_launch(
            u.data_ptr(), m, wbuf.data_ptr(), bbuf.data_ptr(),
            out.data_ptr(), stream), "pair_sdf_value")
    with torch.no_grad():
        wrapper_ms = cuda_ms(lambda: pair_mlp.pair_sdf_value(u, prior), reps)
    kernel_ms = cuda_ms(run, reps)
    tiles = -(-m // 128)
    blocks = min(tiles, torch.cuda.get_device_properties(
        u.device).multi_processor_count)
    tile_bytes = UP_SWEEP_CHUNKS * 256 * 64 * 2
    flops = 2.0 * (32 * 256 + 3 * 256 + 3 * 256 * 256 + 256) * m
    launch_bytes = tile_bytes * tiles
    log(f"K7b step 0: M={m}; wrapper {wrapper_ms:.4f} ms, C entry "
        f"{kernel_ms:.4f} ms, {flops / kernel_ms / 1e9:.1f} TFLOP/s "
        f"executed; {blocks} blocks, {tiles} tiles of 128 rows, "
        f"{tile_bytes} weight bytes a tile ({launch_bytes / 1e9:.3f} GB a "
        f"launch from L2, {launch_bytes / kernel_ms / 1e6:.0f} GB/s)")
    return kernel_ms


def within(what, out, ref, hold=True, keep=None, kink=None):
    """|out - ref| <= 2**-6 |ref| + 1e-3 scale for 99.9% of the entries and
    <= 0.05 scale for all, per column (scale: the column's max |ref|; the
    0.1% allows a LeakyReLU gate that flips on a kink).  ``keep`` (bool per
    row): the rows the data can use; the 0.05 rule is then held on them,
    with their own scale, and the reading over every row is printed beside
    it (a per-pair kernel also runs masked slots, whose gate flips no
    output reads).  ``kink``: for a pair-MLP gradient (K3's r_lat, K6a's and
    K7a's r), ``(layers, row_inputs)``: a row above 0.05 then passes only
    when :func:`explain_kinks` shows it is the plain row with one gate
    flipped on its kink.  Returns the max abs error; fails on a breach when
    ``hold``."""
    out = out.reshape(out.shape[0], -1)
    ref = ref.reshape(ref.shape[0], -1)
    scale = ref.abs().amax(0, keepdim=True) + 1e-30
    d = (out - ref).abs()
    beyond = (d > 2.0 ** -6 * ref.abs() + 1e-3 * scale).float().mean()
    worst = every = float((d / scale).max())
    kept = scale
    if keep is not None:
        kept = ref[keep].abs().amax(0, keepdim=True) + 1e-30
        worst = float((d[keep] / kept).max()) if bool(keep.any()) else 0.0
    err = float(d.max())
    log(f"  {what}: max abs err {err:.3e}, max err / column scale "
        f"{worst:.3e}" + ("" if keep is None else
                          f" on the {int(keep.sum())} rows in the query "
                          f"radius ({every:.3e} on every row)")
        + f", share beyond 2^-6 rel {float(beyond):.2e}")
    if hold and worst > 0.05 and kink is not None:
        explain_kinks(what, out, ref, kept, *kink, keep=keep)
        worst = 0.0                  # every row above 0.05 is a kink flip
    if hold and (float(beyond) > 1e-3 or worst > 0.05):
        fail(f"{what}: kernel and plain version disagree")
    return err


# a pair-MLP gradient row above 0.05 of scale (within) passes as a kink
# flip when the plain row recomputed with one of its KINK_UNITS nearest-
# kink gates flipped lies within KINK_RESIDUAL of scale of the kernel's row
# and that unit's margin |a| / sum|terms| is below KINK_MARGIN; such rows
# may be at most KINK_SHARE of the rows (measured on the H100 over 100
# trained dtu_cli steps: residual <= 0.0094, margin <= 0.0145; PERF.md 6)
KINK_UNITS = 8
KINK_RESIDUAL = 0.02
KINK_MARGIN = 2.0 ** -5
KINK_SHARE = 1e-3


def gate_margins(lat, xpi, layers):
    """One pair row (``lat [1, d]``, ``xpi [1, 3]``) through the plain up
    sweep: its LeakyReLU gates (a > 0, per layer) and each unit's kink
    margin ``|a| / sum|terms|`` over the terms of its pre-activation,
    ``[n_act * H]`` (layer-major)."""
    import torch

    from spurfies_tpu_torch.ops import pair_mlp as pm

    d = lat.shape[1]
    cd = layers.compute_dtype
    w0 = layers.ws[0].float()
    a = pm._first_split(layers, lat, xpi)
    terms = lat.to(cd).float().abs() @ w0[:d].abs() \
        + xpi.to(cd).float().abs() @ w0[d:].abs() + layers.bs[0].abs()
    gates, margins = [], []
    for i in range(layers.n_act):
        if i > 0:
            a = pm._mm(h, layers.ws[i]) + layers.bs[i]
            terms = h.float().abs() @ layers.ws[i].float().abs() \
                + layers.bs[i].abs()
        gates.append(a > 0)
        margins.append(a.abs() / (terms + 1e-30))
        h = torch.maximum(a, 0.01 * a).to(cd)
    return gates, torch.cat(margins, 1)[0]


def flipped_r(layers, gates, unit=None):
    """The row's ``r [1, d + 3]`` by the plain down sweep on ``gates``,
    with the gate of ``unit`` (``layer * H + j``; None: none) flipped."""
    from spurfies_tpu_torch.ops import pair_mlp as pm

    gs = [g.clone() for g in gates]
    if unit is not None:
        layer, j = divmod(int(unit), gs[0].shape[1])
        gs[layer][0, j] = ~gs[layer][0, j]
    return pm._down_sweep(layers, gs, 1, gs[0].device)


def kink(lat, xpi, layers, kernel_row, scale):
    """The pair row's smallest kink margin, and the worst error (of the
    column ``scale``) of ``kernel_row [1, c]`` against the plain version of
    this one row recomputed alone (its first c columns in the compute
    dtype), as it is (``recomputed``) and with the gate of one of its
    KINK_UNITS nearest-kink units flipped (``flipped``, the best of them,
    at ``flip_layer`` / ``flip_unit`` with margin ``flip_margin``)."""
    import torch

    gates, m = gate_margins(lat, xpi, layers)
    c = kernel_row.shape[1]

    def err(unit):
        r = flipped_r(layers, gates, unit)[:, :c].to(
            layers.compute_dtype).float()
        return float(((kernel_row - r).abs() / scale).max())

    best = None
    for j in torch.argsort(m)[:KINK_UNITS].tolist():
        e = err(j)
        if best is None or e < best[0]:
            best = (e, j)
    layer, unit = divmod(best[1], gates[0].shape[1])
    return {"min_margin": float(m.min()), "recomputed": err(None),
            "flipped": best[0], "flip_layer": layer, "flip_unit": unit,
            "flip_margin": float(m[best[1]])}


def explain_kinks(what, out, ref, scale, layers, row_inputs, keep=None):
    """Hold the rows of a pair-MLP gradient (``out``/``ref`` ``[R, c]``)
    whose worst entry is above 0.05 of its column ``scale`` (among the
    ``keep`` rows, if given) by what they are: each must be its plain row
    recomputed alone with one gate flipped on its kink (:func:`kink`:
    within KINK_RESIDUAL of scale, the unit's margin below KINK_MARGIN),
    and they may be at most KINK_SHARE of the rows.  ``row_inputs(rows)``
    gives the rows' ``(lat [n, d], xpi [n, 3])``.  Prints the explained
    rows, their worst margin and worst residual; fails otherwise.  Returns
    ``{"rows", "share", "worst_margin", "worst_residual"}``."""
    import torch

    above = (out - ref).abs().div(scale).amax(1) > 0.05
    if keep is not None:
        above &= keep
    rows = torch.nonzero(above)[:, 0]
    n = int(keep.sum()) if keep is not None else out.shape[0]
    share = rows.numel() / max(n, 1)
    if share > KINK_SHARE:
        fail(f"{what}: {rows.numel()} rows above 0.05 of scale, "
             f"{share:.2e} of {n}; kink flips may be at most {KINK_SHARE}")
    lat, xpi = row_inputs(rows)
    found = [kink(lat[i:i + 1], xpi[i:i + 1], layers,
                  out[r:r + 1].float(), scale)
             for i, r in enumerate(rows.tolist())]
    stats = {"rows": len(found), "share": share,
             "worst_margin": max((f["flip_margin"] for f in found),
                                 default=0.0),
             "worst_residual": max((f["flipped"] for f in found),
                                   default=0.0)}
    log(f"  {what}: {stats['rows']} rows above 0.05 of scale explained by "
        f"one gate flipped on its kink ({share:.2e} of {n} rows); worst "
        f"margin {stats['worst_margin']:.4f} (< {KINK_MARGIN}), worst "
        f"residual {stats['worst_residual']:.4f} (<= {KINK_RESIDUAL})")
    bad = [(r, f) for r, f in zip(rows.tolist(), found)
           if not (f["flipped"] <= KINK_RESIDUAL
                   and f["flip_margin"] < KINK_MARGIN)]
    if bad:
        fail(f"{what}: row {bad[0][0]} is not one gate flipped on its kink: "
             f"{json.dumps(bad[0][1])}")
    return stats


def pair_inputs(table, idx_ext, x):
    """``pairs`` (flat indices of ``idx_ext``'s pairs) -> their ``(lat,
    xpi)`` rows, as the plain pair-MLP versions gather them."""
    import torch

    def rows_of(pairs):
        n, k = table.shape[0], idx_ext.shape[1]
        idx = idx_ext.reshape(-1)[pairs].long()
        g = table[torch.where((idx >= 0) & (idx < n), idx, n - 1)]
        return g[:, :-3], x[pairs // k] - g[:, -3:]
    return rows_of


def compare_chunk(a, b):
    """Ray-by-ray agreement of two renders of one chunk (kernels vs plain
    versions, both bf16).

    The SDF values agree to a bf16 ulp, but the sampler's beta bisection
    makes discrete choices on them, so a few rays place their samples
    elsewhere; and an RBF weight exp(-(45 d)^2) moves ~10% when a sample
    moves by 1e-3, so such a ray's normal and colour move with it.  Hence:
    ray_mask may flip on 0.2% of the rays; depth and acc agree within 2e-3
    on 95% of the rays (median within 1e-4); and on the rays whose depth
    and acc agree within 1e-6 (the same samples; at least half of them),
    normal and colour agree within 1e-2 on 99% (median within 1e-3)."""
    import numpy as np

    mask = a["ray_mask"].cpu().numpy()
    if (mask != b["ray_mask"].cpu().numpy()).mean() > 0.002:
        fail("chunk: ray_mask differs on more than 0.2% of the rays")
    both = mask & b["ray_mask"].cpu().numpy()
    if not both.any():
        fail("chunk: no ray hit the cloud")
    err = {key: (a[key] - b[key]).abs().reshape(len(mask), -1).amax(-1)
           .cpu().numpy()[both]
           for key in ("depth_values", "acc", "normal_map", "rgb_values")}
    same = (err["depth_values"] <= 1e-6) & (err["acc"] <= 1e-6)
    stats = {"same_sample_share": float(same.mean())}
    for key, t, t_med, sub in (("depth_values", 2e-3, 1e-4, None),
                               ("acc", 2e-3, 1e-4, None),
                               ("normal_map", 1e-2, 1e-3, same),
                               ("rgb_values", 1e-2, 1e-3, same)):
        e = err[key] if sub is None else err[key][sub]
        share = 0.05 if sub is None else 0.01
        stats[key] = {q: float(np.quantile(e, v)) for q, v in
                      (("p50", 0.5), ("p95", 0.95), ("p99", 0.99),
                       ("max", 1.0))}
        stats[key]["share_beyond"] = float((e > t).mean())
        if (e > t).mean() > share or np.median(e) > t_med:
            fail(f"chunk: {key} differs: {stats[key]}")
    if same.mean() < 0.5:
        fail(f"chunk: only {same.mean():.2f} of the rays kept their samples")
    return stats


def profile_summary(prof, wall_ms):
    """Device-busy share and device time by kernel and by PyTorch op of a
    ``torch.profiler`` run.  Device time is counted once, on the kernel
    events; a PyTorch op's self device time is the time of the kernels it
    launched directly."""
    from torch.autograd import DeviceType

    kernels, ops = {}, {}
    for evt in prof.key_averages():
        us = evt.self_device_time_total
        if us <= 0 or evt.is_user_annotation:
            continue
        into = ops if evt.device_type == DeviceType.CPU else kernels
        into[evt.key] = into.get(evt.key, 0.0) + us
    groups = {label: 0.0 for label, _ in KERNEL_NAMES}
    parts = {}              # labels of several device kernels: each one's
    for key, us in kernels.items():
        hit = next(((lb, pat) for lb, pat in KERNEL_NAMES if pat in key),
                   None)
        if hit is not None:
            groups[hit[0]] += us / 1e3
            parts[hit[1]] = parts.get(hit[1], 0.0) + us / 1e3
    multi = {lb for lb, _ in KERNEL_NAMES
             if sum(lb == other for other, _ in KERNEL_NAMES) > 1}
    busy_ms = sum(kernels.values()) / 1e3
    if busy_ms <= 0:
        fail("profile: the profiler saw no device time")
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:15]
    return {"profiled_wall_ms": wall_ms,
            "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms,
            "kernel_ms": groups,
            "kernel_parts_ms": {pat: parts.get(pat, 0.0)
                                for lb, pat in KERNEL_NAMES if lb in multi},
            "pytorch_ops_ms": {k: v / 1e3 for k, v in top_ops},
            "pytorch_ops_total_ms": sum(ops.values()) / 1e3}


def profiled(fn):
    """``fn()`` once under ``torch.profiler``, between synchronisations;
    returns :func:`profile_summary` of it."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return profile_summary(prof, wall_ms)


def profile_render(render_image, scene, tp, frozen, view):
    """Rays/s of TIMED_RENDERS warm renders of ``view`` (host clock around
    work that ends in a synchronise), then one render under
    ``torch.profiler``."""
    import torch

    args = (tp, scene, frozen, view["uv"], view["pose"], view["intrinsics"])
    n = len(view["uv"])
    walls = []
    for _ in range(TIMED_RENDERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_image(*args)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return {"rays": n, "render_wall_s": walls,
            "rays_per_s": [n / w for w in walls],
            **profiled(lambda: render_image(*args))}


def kernel_sites():
    """Where the port calls each kernel's wrapper: (module, attribute,
    plain version), K1 to K7a and K8a/K8b (K7b has no caller in the port:
    the microbenchmark calls it)."""
    from spurfies_tpu_torch.model import field
    from spurfies_tpu_torch.ops import (
        fused_color,
        pair_mlp,
        scatter_rows,
        voxel_grid,
    )
    from spurfies_tpu_torch.ops import select_knn as sk

    return [(fused_color, "pack_color_weights",
             fused_color.pack_color_weights_ref),
            (fused_color, "fused_color_fwd", fused_color.fused_color_fwd_ref),
            (fused_color, "fused_color_bwd", fused_color.fused_color_bwd_ref),
            (voxel_grid, "select_knn", sk.select_knn_ref),
            (field, "pair_sdf_value_agg", pair_mlp.pair_sdf_value_agg_ref),
            (pair_mlp, "pair_sdf_aggregate", pair_mlp.pair_sdf_aggregate_ref),
            (pair_mlp, "pair_sdf_aggregate_bwd",
             pair_mlp.pair_sdf_aggregate_bwd_ref),
            (field, "scatter_add_rows", scatter_rows.scatter_add_rows_ref),
            (field, "pair_sdf_rows_value", pair_mlp.pair_sdf_rows_value_ref),
            (pair_mlp, "pair_sdf_rows_grad", pair_mlp.pair_sdf_rows_grad_ref),
            (pair_mlp, "pair_sdf_value_and_input_grad",
             pair_mlp.pair_sdf_value_and_input_grad_ref)]


class substituted:
    """Put ``make(wrapper, plain)`` in place of each kernel's wrapper where
    the port calls it (the port has no switch), or at ``sites`` (the same
    triples), and restore them on exit."""

    def __init__(self, make, sites=None):
        self.make = make
        self.given = sites

    def __enter__(self):
        self.sites = self.given or kernel_sites()
        self.saved = [getattr(mod, name) for mod, name, _ in self.sites]
        for (mod, name, ref), fn in zip(self.sites, self.saved):
            setattr(mod, name, self.make(fn, ref))
        return self

    def __exit__(self, *exc):
        for (mod, name, _), fn in zip(self.sites, self.saved):
            setattr(mod, name, fn)
        return False


def plain_versions():
    """The plain PyTorch versions in place of the kernels' wrappers."""
    return substituted(lambda fn, ref: ref)


@contextlib.contextmanager
def fused_color_set(on):
    """``field.FUSED_COLOR = on``, and put back as it was on exit."""
    from spurfies_tpu_torch.model import field

    saved = field.FUSED_COLOR
    field.FUSED_COLOR = on
    try:
        yield
    finally:
        field.FUSED_COLOR = saved


def counters():
    """The program's launch counters (``utils.profiling.COUNTS``), with
    every kernel module imported, so that each has registered its names."""
    from spurfies_tpu_torch.ops import (  # noqa: F401
        fused_color,
        gather_rows,
        pair_mlp,
        scatter_rows,
        select_knn,
    )
    from spurfies_tpu_torch.utils.profiling import COUNTS
    return COUNTS


def zero_counts():
    c = counters()
    for key in c:
        c[key] = 0


def read_counts():
    return dict(counters())


def sum_order_within(what, out, ref, abs_sum, count, hold=True):
    """|out - ref| <= 2 c 2**-24 sum|terms| on every entry: two f32 sums of
    the same c terms in any two orders lie that close (each lies within
    (c - 1) 2**-24 sum|terms| of the exact sum).  ``abs_sum``: the same
    scatter of |terms|; ``count``: the terms of each output row.  Prints
    the largest share of the limit used; fails on a breach when ``hold``.
    Returns the max abs error."""
    tol = 2.0 * count[:, None].float() * 2.0 ** -24 * abs_sum
    d = (out - ref).abs()
    used = float((d / tol.clamp(min=1e-38)).max())
    err = float(d.max())
    log(f"  {what}: max abs err {err:.3e}, max share of the sum-order "
        f"limit {used:.3e}, entries beyond it {int((d > tol).sum())}")
    if hold and bool((d > tol).any()):
        fail(f"{what}: kernel and plain version disagree beyond f32 "
             "reordering")
    return err


def capture_step(trainer, sites=None):
    """One training step; returns, by wrapper name, the arguments of each
    kernel launch in it (references, all of the wrapper's parameters in
    order, in launch order), or of each call at ``sites``."""
    return capture(lambda: trainer.train_step(trainer.bundle, trainer.state,
                                              trainer.generator), sites)


def capture(fn, sites=None):
    """``fn()``; returns, by function name, the arguments of each call of
    the kernels' wrappers (or of the functions at ``sites``) in it."""
    import inspect

    seen = {}

    def recorder(fn, ref):
        sig = inspect.signature(fn)

        def rec(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            seen.setdefault(fn.__name__, []).append(
                tuple(bound.arguments.values()))
            return fn(*args, **kwargs)
        return rec

    with substituted(recorder, sites):
        fn()
    return seen


def check_step(tag, seen, prior_f32, radius):
    """Every kernel launch of one captured step (:func:`capture_step`)
    against its plain version: K1 bit-equal, the pair-MLP kernels and K8a
    by the limits of phase 4, K4/K5 by ``sum_order_within``, K8b's dlat by
    phase 4's and its dW/db by 1e-2 relative L2.  Returns, by wrapper name,
    the result of its largest launch, with the smaller launches' results
    under ``later``."""
    from spurfies_tpu_torch.ops import pair_mlp

    best = {}
    for name, calls in seen.items():
        big = 1 if name in ("pair_sdf_value_agg", "pair_sdf_aggregate") else 0
        calls = sorted(calls, key=lambda a: -getattr(a[big], "shape",
                                                    (0,))[0])
        for i, args in enumerate(calls):
            what = f"{name} ({tag}, launch {i + 1} of {len(calls)})"
            if name == "pack_color_weights":
                r = check_pack(what, args, 20)
            elif name == "fused_color_fwd":
                r = check_k8a(what, args, 10)
            elif name == "fused_color_bwd":
                r = check_k8b(what, args, 5)
            elif name == "select_knn":
                r = check_k1(what, args, 10,
                             study=tag in ("dust3r_like", "dense_sphere"))
            elif name == "pair_sdf_aggregate_bwd":
                r = check_k4(what, args, 50, study=i == 0)
            elif name == "scatter_add_rows":
                r = check_k5(what, args, 50, study=i == 0)
            elif big:
                table, idx_ext, x, layers, rbf = args
                r = check_pair(what, getattr(pair_mlp, name),
                               getattr(pair_mlp, f"{name}_ref"),
                               (table, idx_ext, x), layers, prior_f32, rbf,
                               5)
            else:                                    # K6a, K6b, K7a
                r = check_rows(what, getattr(pair_mlp, name),
                               getattr(pair_mlp, f"{name}_ref"),
                               tuple(args[:-1]), args[-1], prior_f32, 5,
                               radius)
            if i == 0:
                best[name] = r
            else:
                best[name].setdefault("later", []).append(r)
        del calls
    return best


def expected_counts(keys, per_step, steps, knn):
    """Launch counts of ``steps`` steps: ``per_step`` each, K1 under the
    variant ``knn``, every other counter 0."""
    expect = {k: 0 for k in keys}
    for key, per in per_step.items():
        expect[knn if key == "select_knn" else key] = per * steps
    return expect


def train_path(tag, trainer, per_step, warmup, steps, window, smi=None):
    """Phases 8-10 for one ``Trainer`` on dust3r_like: one captured step
    with every launch against its plain version, one batch's loss and
    gradients through the kernels and through the plain versions, host
    syncs in two steps, then ``warmup`` steps and -- counters set to 0 --
    ``steps`` timed ones.  Fails unless the loss stays finite, no step is
    skipped, rgb_loss falls and the counters equal steps x ``per_step``.
    Returns (results by wrapper name, launches, history)."""
    import numpy as np
    import torch

    from spurfies_tpu_torch.ops.pair_mlp import _prep_layers

    dev = trainer.device
    mc = trainer.cfg.model
    log(f"trainer {tag}: {trainer.scene.points.shape[0]} points, auto "
        f"budgets ray {mc.ray_budget_frac:.4f} probe "
        f"{mc.probe_budget_frac:.4f}")
    seen = capture_step(trainer)
    got = {k: len(v) for k, v in seen.items()}
    if got != per_step:
        fail(f"{tag}: one step launched {got}, expected {per_step}")
    spec = trainer.scene.spec
    best = check_step(tag, seen, _prep_layers(trainer.frozen, torch.float32),
                      spec.radius(trainer.scene.table.r))
    del seen
    torch.cuda.empty_cache()

    batch = trainer.sample_batch(
        trainer.views, torch.Generator(device=dev).manual_seed(7))
    parts_k, grads_k = loss_and_grads(trainer, batch, seed=8)
    with plain_versions():
        parts_p, grads_p = loss_and_grads(trainer, batch, seed=8)
    log(f"{tag} step, kernels vs plain versions (same batch and draws):")
    compare_grads(parts_k, grads_k, parts_p, grads_p)
    del grads_k, grads_p
    n_sync, first_sync = count_host_syncs(trainer, 2)
    log(f"{tag}: host syncs in 2 training steps: {n_sync}"
        + (f" (first: {first_sync})" if n_sync else ""))
    if n_sync:
        fail(f"{tag}: a training step waits on the card")

    history = []
    trainer.run(warmup, window=warmup,
                callback=lambda s_, m: history.append((s_, m)))
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.run(steps, window=window,
                callback=lambda s_, m: history.append((s_, m)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    n_pix = trainer.cfg.train.num_pixels
    TIMED[tag] = wall / steps * 1e3
    log(f"train {tag}: {steps} steps x {n_pix} rays in {wall:.3f} s = "
        f"{steps * n_pix / wall:.1f} train rays/s "
        f"({wall / steps * 1e3:.2f} ms/step); launches {launches}"
        + (f" [{smi}]" if smi else ""))
    for step, m in history:
        log(f"  step {step}: " + ", ".join(
            f"{k} {m[k]:.5g}" for k in ("loss", "rgb_loss", "eikonal_loss",
                                        "mask_loss", "pseudo_loss", "tv_loss",
                                        "psnr", "ray_overflow",
                                        "probe_overflow", "notfinite")))
    if not all(np.isfinite(m["loss"]) and m["notfinite"] == 0
               for _, m in history):
        fail(f"{tag}: a non-finite loss or a skipped step")
    if not history[-1][1]["rgb_loss"] < history[0][1]["rgb_loss"]:
        fail(f"{tag}: rgb_loss did not fall")
    expect = expected_counts(launches, per_step, steps, "select_knn_packed")
    if launches != expect:
        fail(f"{tag}: launch counts {launches} != expected {expect}")
    return best, launches, history


def check_k4(name, args, reps, study=False):
    """K4 against its plain version on one real launch's inputs, timed
    through its wrapper (``ms``) and by its C entry (``kernel_ms``,
    :func:`k4_kernel_ms`); with ``study`` also :func:`k4_inputs_study`,
    :func:`k4_variants_ms` and :func:`k4_host_ms` of these inputs (the ``K4
    step 0`` line)."""
    import torch

    from spurfies_tpu_torch.ops import pair_mlp

    num_bar, w, r_lat, idx_ext, n = args
    p, k = idx_ext.shape
    out = pair_mlp.pair_sdf_aggregate_bwd(*args)
    ref = pair_mlp.pair_sdf_aggregate_bwd_ref(*args)
    flat = idx_ext.reshape(-1).long()
    keep = (flat >= 0) & (flat < n) & (w != 0)
    count = torch.bincount(flat[keep], minlength=n)
    abs_sum = pair_mlp.pair_sdf_aggregate_bwd_ref(
        num_bar.abs(), w.abs(), r_lat.abs(), idx_ext, n)
    # control: the plain sum over the points in another order
    perm = torch.randperm(p, device=w.device)
    ctrl = pair_mlp.pair_sdf_aggregate_bwd_ref(
        num_bar[perm], w.view(p, k)[perm].reshape(-1),
        r_lat.view(p, k, -1)[perm].reshape(p * k, -1), idx_ext[perm], n)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()):
        fail(f"{name}: non-finite output")
    err = sum_order_within(name, out, ref, abs_sum, count)
    sum_order_within(f"{name}, control: plain summed in another order",
                     ctrl, ref, abs_sum, count, hold=False)
    ms = cuda_ms(lambda: pair_mlp.pair_sdf_aggregate_bwd(*args), reps)
    kernel_ms = k4_kernel_ms(*args, reps)
    plain_ms = cuda_ms(lambda: pair_mlp.pair_sdf_aggregate_bwd_ref(*args),
                       5)
    # library yardstick: index_add_ of the expanded cotangent's kept rows
    # (the expansion itself is left out of the time)
    ct = ((torch.repeat_interleave(num_bar, k) * w)[:, None]
          * r_lat.float())[keep]
    idx_k = flat[keep]
    lib_ms = cuda_ms(lambda: torch.zeros((n, 32), device=w.device)
                     .index_add_(0, idx_k, ct), reps)
    kept = int(keep.sum())
    dump = int((flat == n).sum())
    # bytes: idx and w of every row, r_lat of the kept rows, num_bar, and
    # the output written once
    n_bytes = p * k * 8 + kept * 64 + p * 4 + n * 32 * 4
    b_ms, b_by = bound_ms(n_bytes, 2.0 * 32 * kept, PEAK_F32_FLOPS)
    log(f"{name}: P={p} k={k} rows {p * k}, kept {kept} "
        f"({kept / (p * k):.3f}), dump rows {dump} ({dump / (p * k):.3f}), "
        f"{kept / max(int((count > 0).sum()), 1):.1f} adds per latent row "
        f"hit; kernel {ms:.4f} ms (C entry alone {kernel_ms:.4f}), plain "
        f"{plain_ms:.4f} ms, index_add_ {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by})")
    res = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": lib_ms, "max_abs_err": err,
           "kernel_ms": kernel_ms, "rows": p * k}
    if study:
        res["step0"] = dict(k4_inputs_study(*args), wrapper_ms=ms,
                            library_ms=lib_ms,
                            kernel_ms=k4_variants_ms(*args, reps),
                            host_ms=k4_host_ms(args, 10 * reps))
        log(f"K4 step 0, {name}: {json.dumps(res['step0'])}")
    return res


def k4_inputs_study(num_bar, w, r_lat, idx_ext, n, tiles=(128, 256, 512)):
    """What K4's time depends on in one launch's inputs: the kept rows
    (index in [0, n) and w != 0), the dump rows (index n) and the w == 0
    rows on a real index, the adds at the hottest latent row, and for each
    tile size T the kept rows' distinct (T-row tile, index) pairs: the adds
    left after a pre-sum of equal indices within each tile."""
    import torch

    flat = idx_ext.reshape(-1).long()
    rows = flat.numel()
    in_range = (flat >= 0) & (flat < n)
    keep = in_range & (w != 0)
    hot = torch.bincount(flat[keep], minlength=n)
    out = {"rows": rows, "kept_share": float(keep.float().mean()),
           "dump_share": float((flat == n).float().mean()),
           "w0_share": float((in_range & (w == 0)).float().mean()),
           "latent_rows_hit": int((hot > 0).sum()),
           "adds_at_hottest": int(hot.max())}
    row = torch.arange(rows, device=flat.device)
    for t in tiles:
        out[f"distinct_T{t}"] = int(torch.unique(
            ((row // t) * n + flat)[keep]).numel())
    return out


def k4_variants_ms(num_bar, w, r_lat, idx_ext, n, reps):
    """Step 0 of K4's redesign: its C entry timed (:func:`k4_kernel_ms`)
    on one launch's inputs as they are, and as rows of k = 1 (num_bar
    repeated a row): in the same order; in a random order; with every
    dropped row (index outside [0, n) or w == 0) removed, the cost of the
    warps that leave at once; with ``arange(rows) % n`` for idx, no index
    repeated within n rows, the contention floor (timing only)."""
    import torch

    p, k = idx_ext.shape
    flat = idx_ext.reshape(-1)
    nb = torch.repeat_interleave(num_bar, k)
    keep = (flat >= 0) & (flat < n) & (w != 0)
    perm = torch.randperm(p * k, device=w.device)

    def rows(sel):
        return (nb[sel].contiguous(), w[sel].contiguous(),
                r_lat[sel].contiguous(), flat[sel].contiguous()[:, None], n)
    every = torch.arange(p * k, device=w.device)
    flat_idx = (every % n).to(torch.int32)[:, None]
    return {"as_is": k4_kernel_ms(num_bar, w, r_lat, idx_ext, n, reps),
            "rows_k1": k4_kernel_ms(*rows(every), reps),
            "random_order": k4_kernel_ms(*rows(perm), reps),
            "dropped_removed": k4_kernel_ms(*rows(keep), reps),
            "no_repeats": k4_kernel_ms(nb, w, r_lat, flat_idx, n, reps)}


def k4_host_ms(args, reps):
    """The host time of one K4 wrapper call (the host clock over ``reps``
    calls with no synchronise between them, as :func:`k1_host_ms`), and of
    each of its parts alone: the input checks, the output's allocation, the
    stream lookup and the ``ctypes`` call (into one output; one
    cooperative launch zeroes it and adds)."""
    import torch

    from spurfies_tpu_torch.ops import cuda_build, pair_mlp

    num_bar, w, r_lat, idx_ext, n = args
    p, k = idx_ext.shape
    out = w.new_empty((n, 32))
    lib = cuda_build.load("agg_bwd", pair_mlp._SIG_BWD)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    parts = {
        "wrapper": lambda: pair_mlp.pair_sdf_aggregate_bwd(*args),
        "checks": lambda: pair_mlp._check_bwd_inputs(*args),
        "alloc": lambda: w.new_empty((n, 32)),
        "stream": lambda: torch._C._cuda_getCurrentRawStream(
            w.get_device()),
        "ctypes_call": lambda: lib.pair_sdf_aggregate_bwd_launch(
            num_bar.data_ptr(), w.data_ptr(), r_lat.data_ptr(),
            idx_ext.data_ptr(), p * k, k, n, out.data_ptr(), stream)}
    res = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        res[name] = (time.perf_counter() - t0) / reps * 1e3
        torch.cuda.synchronize()
    return res


def k4_kernel_ms(num_bar, w, r_lat, idx_ext, n, reps):
    """K4's own device time on these inputs: its C entry (one launch that
    zeroes the output, then adds) called ``reps`` times into one output
    (CUDA events), as :func:`k5_kernel_ms` times K5."""
    import torch

    from spurfies_tpu_torch.ops import cuda_build, pair_mlp

    p, k = idx_ext.shape
    out = torch.empty((n, 32), device=w.device)
    lib = cuda_build.load("agg_bwd", pair_mlp._SIG_BWD)
    stream = torch.cuda.current_stream(w.device).cuda_stream

    def run():
        cuda_build.check(lib.pair_sdf_aggregate_bwd_launch(
            num_bar.data_ptr(), w.data_ptr(), r_lat.data_ptr(),
            idx_ext.data_ptr(), p * k, k, n, out.data_ptr(), stream),
            "pair_sdf_aggregate_bwd")
    return cuda_ms(run, reps)


def k5_inputs_study(ct, idx, n, tiles=(128, 256, 512)):
    """What K5's time depends on in one launch's inputs: the share of rows
    that are all zero, the rows at the hottest index, and for each tile
    size T the kept (and the non-zero) rows against their distinct (T-row
    tile, index) pairs, the adds left after a pre-sum of equal indices
    within each tile."""
    import torch

    m = ct.shape[0]
    keep = (idx >= 0) & (idx < n)
    zero = (ct == 0).all(1)
    hot = torch.bincount(idx[keep].long(), minlength=n)
    out = {"rows": m, "kept": int(keep.sum()),
           "zero_rows_share": float(zero.float().mean()),
           "hottest_index": int(hot.argmax()),
           "rows_at_hottest": int(hot.max()),
           "nonzero_rows_at_hottest": int(
               (keep & ~zero & (idx == hot.argmax())).sum())}
    row = torch.arange(m, device=idx.device)
    for t in tiles:
        key = (row // t) * n + idx.long()
        out[f"distinct_T{t}"] = int(torch.unique(key[keep]).numel())
        out[f"distinct_nonzero_T{t}"] = int(
            torch.unique(key[keep & ~zero]).numel())
    out["nonzero_kept"] = int((keep & ~zero).sum())
    return out


def k5_kernel_ms(ct, idx, n, reps):
    """K5's own device time on these inputs: its C entry launched ``reps``
    times into one zeroed output (CUDA events).  The wrapper's checks and
    zero fill take more host time than the kernel takes on the card, so
    timing the wrapper would time the host."""
    import torch

    from spurfies_tpu_torch.ops import cuda_build
    from spurfies_tpu_torch.ops import scatter_rows as sr

    m, d = ct.shape
    out = torch.zeros((n, d), device=ct.device)
    lib = cuda_build.load("scatter_rows", sr._SIG)
    stream = torch.cuda.current_stream(ct.device).cuda_stream

    def run():
        cuda_build.check(lib.scatter_add_rows_launch(
            ct.data_ptr(), ct.stride(0), idx.data_ptr(), m, d, n,
            out.data_ptr(), stream), "scatter_add_rows")
    return cuda_ms(run, reps)


def k5_variants_ms(ct, idx, n, reps):
    """Step 0 of K5's redesign: the kernel timed on one launch's inputs
    four ways (:func:`k5_kernel_ms`) -- as they are; with every all-zero
    row's index set to n (dropped before any atomic); with the rows in a
    random order (the same row stride); with ``arange(m) % n`` for idx, no
    index repeated within n rows: the contention floor (timing only, its
    result is not compared)."""
    import torch

    m, d = ct.shape
    zero = (ct == 0).all(1)
    idx_nz = torch.where(zero, torch.full_like(idx, n), idx)
    perm = torch.randperm(m, device=ct.device)
    ct_perm = torch.empty((m, ct.stride(0)), dtype=ct.dtype,
                          device=ct.device)[:, :d]
    ct_perm.copy_(ct[perm])
    idx_perm = idx[perm].contiguous()
    idx_flat = (torch.arange(m, device=ct.device) % n).to(torch.int32)
    return {"as_is": k5_kernel_ms(ct, idx, n, reps),
            "zero_rows_dropped": k5_kernel_ms(ct, idx_nz, n, reps),
            "random_order": k5_kernel_ms(ct_perm, idx_perm, n, reps),
            "no_repeats": k5_kernel_ms(ct, idx_flat, n, reps)}


def check_k5(name, args, reps, study=False):
    """K5 against its plain version on one real launch's inputs, timed
    through its wrapper (``ms``, a fresh zeroed output each call, as every
    kernel is timed) against ``torch.zeros(...).index_add_``; beside them
    the kernel alone by :func:`k5_kernel_ms` (``kernel_ms``) against
    ``index_add_`` into one zeroed output (``library_zeroed_ms``).  With
    ``study``, also :func:`k5_inputs_study` and :func:`k5_variants_ms` of
    these inputs (the ``K5 step 0`` line)."""
    import torch

    from spurfies_tpu_torch.ops import scatter_rows as sr

    ct, idx, n = args
    m, d = ct.shape
    out = sr.scatter_add_rows(*args)
    ref = sr.scatter_add_rows_ref(*args)
    keep = (idx >= 0) & (idx < n)
    count = torch.bincount(idx[keep].long(), minlength=n)
    abs_sum = sr.scatter_add_rows_ref(ct.abs(), idx, n)
    perm = torch.randperm(m, device=ct.device)
    ctrl = sr.scatter_add_rows_ref(ct[perm], idx[perm], n)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()):
        fail(f"{name}: non-finite output")
    err = sum_order_within(name, out, ref, abs_sum, count)
    sum_order_within(f"{name}, control: plain summed in another order",
                     ctrl, ref, abs_sum, count, hold=False)
    ms = cuda_ms(lambda: sr.scatter_add_rows(*args), reps)
    kernel_ms = k5_kernel_ms(ct, idx, n, reps)
    plain_ms = cuda_ms(lambda: sr.scatter_add_rows_ref(*args), 5)
    # index_add_ of the kept rows: into a fresh zeroed output like the
    # wrapper, and into one zeroed output like k5_kernel_ms
    ct_k, idx_k = ct[keep].contiguous(), idx[keep].long()
    lib_ms = cuda_ms(lambda: torch.zeros((n, d), device=ct.device)
                     .index_add_(0, idx_k, ct_k), reps)
    lib_out = torch.zeros((n, d), device=ct.device)
    lib_zeroed_ms = cuda_ms(lambda: lib_out.index_add_(0, idx_k, ct_k), reps)
    kept = int(keep.sum())
    n_bytes = m * 4 + kept * d * 4 + n * d * 4
    b_ms, b_by = bound_ms(n_bytes, float(kept * d), PEAK_F32_FLOPS)
    log(f"{name}: M={m} d={d} row stride {ct.stride(0)}, kept {kept}, "
        f"{kept / max(int((count > 0).sum()), 1):.1f} rows per latent row "
        f"hit; kernel {ms:.4f} ms (C entry alone {kernel_ms:.4f}), plain "
        f"{plain_ms:.4f} ms, index_add_ {lib_ms:.4f} ms (into one zeroed "
        f"output {lib_zeroed_ms:.4f}), bound {b_ms:.4f} ms ({b_by})")
    res = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": lib_ms, "max_abs_err": err,
           "kernel_ms": kernel_ms, "library_zeroed_ms": lib_zeroed_ms}
    if study:
        res["step0"] = dict(k5_inputs_study(ct, idx, n),
                            ms=k5_variants_ms(ct, idx, n, reps))
        log(f"K5 step 0, {name}: {json.dumps(res['step0'])}")
    return res


def rel_l2_within(what, out, ref, limit, hold=True):
    """||out - ref|| / ||ref|| <= ``limit``; prints the reading, fails on a
    breach when ``hold``.  Returns the max abs error."""
    import torch

    rel = float(torch.linalg.vector_norm(out - ref)
                / max(float(torch.linalg.vector_norm(ref)), 1e-30))
    err = float((out - ref).abs().max())
    log(f"  {what}: relative L2 {rel:.3e} (limit {limit:g}), max abs err "
        f"{err:.3e}")
    if hold and not rel <= limit:
        fail(f"{what}: kernel and plain version disagree")
    return err


def k8_work(wn, p, bwd):
    """(flops of the real pairs, flops of every row, bytes) of K8a or K8b
    on ``p`` points: F_color's work on the pairs with wn != 0 (an invalid
    pair adds nothing: its weight, and so its delta, is 0) and R's on
    every point; each input read once, each output written once, the f32
    weights read once."""
    real = int((wn != 0).sum())
    f, r = (F_MACS + F_BWD_MACS, R_MACS + R_BWD_MACS) if bwd else (F_MACS,
                                                                   R_MACS)
    n_bytes = 8 * p * (12 + 256 + 4) + p * 84 + 4 * COLOR_PARAMS
    n_bytes += (p * 12 + 8 * p * 256 + 4 * COLOR_PARAMS) if bwd else p * 12
    return (2.0 * (real * f + p * r), 2.0 * (8 * p * f + p * r), n_bytes,
            real)


def check_pack(name, args, reps):
    """The pack against its plain version: the same bits."""
    import torch

    from spurfies_tpu_torch.ops import fused_color as fc

    with torch.no_grad():
        out = fc.pack_color_weights(*args)
        ref = fc.pack_color_weights_ref(*args)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            bad = (out != ref).nonzero().flatten()
            log(f"  {name}: {bad.numel()} values differ, in chunks "
                f"{sorted(set((bad // fc.PACK_CHUNK).tolist()))[:20]}; first "
                f"{bad[:5].tolist()}: kernel {out[bad[:5]].tolist()}, plain "
                f"{ref[bad[:5]].tolist()}; finite weights "
                f"{all(bool(torch.isfinite(l['w']).all()) for n in args for l in n)}")
            fail(f"{name}: the pack differs from its plain version")
        ms = cuda_ms(lambda: fc.pack_color_weights(*args), reps)
        plain_ms = cuda_ms(lambda: fc.pack_color_weights_ref(*args), 3)
    n_bytes = 4 * (COLOR_PARAMS - 4 * 256 - 2 * 256 - 3) + 2 * out.numel()
    b_ms, b_by = bound_ms(n_bytes, 0, PEAK_BF16_FLOPS)
    log(f"{name}: {out.numel()} bf16 values, bit-equal to plain; kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "max_abs_err": 0.0}


def check_k8a(name, args, reps):
    """K8a (the pair and point kernels, on the step's packed weights)
    against its plain version on one launch's inputs: rgb by the limits
    of phase 4, with the f32 plain control beside them."""
    import torch

    from spurfies_tpu_torch.ops import fused_color as fc

    x_pi, lat, wn, dir_enc, f_color, r, dt, _ = args
    with torch.no_grad():
        # the step's optimizer has updated the weights since its pack
        args = (*args[:7], fc.pack_color_weights(f_color, r))
        out = fc.fused_color_fwd(*args)
        ref = fc.fused_color_fwd_ref(*args)
        ctrl = fc.fused_color_fwd_ref(*args[:6], torch.float32)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(out).all()):
            fail(f"{name}: non-finite rgb")
        err = within(f"{name} rgb", out, ref)
        within(f"{name} rgb, control f32 plain", ctrl, ref, hold=False)
        del ctrl
        ms = cuda_ms(lambda: fc.fused_color_fwd(*args), reps)
        plain_ms = cuda_ms(lambda: fc.fused_color_fwd_ref(*args), 3)
    p = dir_enc.shape[0]
    flops, flops_all, n_bytes, real = k8_work(wn, p, False)
    b_ms, b_by = bound_ms(n_bytes, flops, PEAK_BF16_FLOPS)
    b_all, _ = bound_ms(n_bytes, flops_all, PEAK_BF16_FLOPS)
    log(f"{name}: P={p}, {real} real pairs of {8 * p} "
        f"({real / max(8 * p, 1):.3f}); kernel {ms:.4f} ms "
        f"({flops_all / ms / 1e9:.1f} TFLOP/s executed), plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; {b_all:.4f} ms "
        "counting every pair)")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "max_abs_err": err,
            "bound_all_rows_ms": b_all, "rows": 8 * p, "rows_needed": real}


def check_k8b(name, args, reps):
    """K8b against its plain version on one launch's inputs: dlat by the
    limits of phase 4, each dW/db within ``compare_grads``' 1e-2 relative
    L2 (the dW/db sums run in another order: split-K partials), the f32
    plain control read beside each; no latent gradient on a pair of weight
    0; and a second launch gives the same bits in dlat and every dW/db."""
    import torch

    from spurfies_tpu_torch.ops import fused_color as fc

    x_pi, lat, wn, dir_enc, f_color, r, rgb_bar, dt, _ = args
    with torch.no_grad():
        # the step's optimizer has updated the weights since its pack
        args = (*args[:8], fc.pack_color_weights(f_color, r))
        dlat, dws, dbs = fc.fused_color_bwd(*args)
        ref = fc.fused_color_bwd_ref(*args)
        ctrl = fc.fused_color_bwd_ref(*args[:7], torch.float32)
        torch.cuda.synchronize()
        outs = [dlat] + dws + dbs
        if not all(bool(torch.isfinite(o).all()) for o in outs):
            fail(f"{name}: non-finite output")
        if bool((dlat[wn == 0] != 0).any()):
            fail(f"{name}: a pair of weight 0 got a latent gradient")
        again = fc.fused_color_bwd(*args)
        same = [torch.equal(a, b) for a, b in zip(
            outs, [again[0]] + again[1] + again[2])]
        log(f"  {name}: a second launch gives the same bits in "
            f"{sum(same)} of {len(same)} outputs (dlat, 7 dW, 7 db)")
        if not all(same):
            fail(f"{name}: two launches differ (dW/db not deterministic)")
        del again
        err = within(f"{name} dlat", dlat, ref[0])
        within(f"{name} dlat, control f32 plain", ctrl[0], ref[0],
               hold=False)
        names = ("F0", "F1", "F2", "F3", "R0", "R1", "R2")
        labels = [f"dW {n}" for n in names] + [f"db {n}" for n in names]
        for label, o, rf, c in zip(labels, outs[1:], ref[1] + ref[2],
                                   ctrl[1] + ctrl[2]):
            err = max(err, rel_l2_within(f"{name} {label}", o, rf, 1e-2))
            rel_l2_within(f"{name} {label}, control f32 plain", c, rf, 1e-2,
                          hold=False)
        del ref, ctrl, outs, dlat, dws, dbs
        ms = cuda_ms(lambda: fc.fused_color_bwd(*args), reps)
        plain_ms = cuda_ms(lambda: fc.fused_color_bwd_ref(*args), 3)
    p = dir_enc.shape[0]
    flops, flops_all, n_bytes, real = k8_work(wn, p, True)
    b_ms, b_by = bound_ms(n_bytes, flops, PEAK_BF16_FLOPS)
    b_all, _ = bound_ms(n_bytes, flops_all, PEAK_BF16_FLOPS)
    scratch = fc._lib().fused_color_bwd_scratch_bytes(p)
    log(f"{name}: P={p}, {real} real pairs of {8 * p}; kernel {ms:.4f} ms "
        f"({flops_all / ms / 1e9:.1f} TFLOP/s executed; scratch {scratch} "
        f"bytes), plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
        f"{b_all:.4f} ms counting every pair)")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "max_abs_err": err,
            "bound_all_rows_ms": b_all, "rows": 8 * p, "rows_needed": real,
            "scratch_bytes": scratch}


def colour_paths(args, reps):
    """``field.aggregate_color`` on one call's captured arguments, fused
    (K8a, K8b) and dense (FUSED_COLOR off, the PyTorch colour MLPs) at the
    same shapes: ms of the forward and of forward + backward (the gradient
    of every colour leaf for a random cotangent)."""
    import torch

    from spurfies_tpu_torch.model import field

    tp = args[0]
    leaves = [tp["feats_color"].detach().requires_grad_(True)]
    nets = {}
    for n in ("F_color", "R"):
        nets[n] = [{k: layer[k].detach().requires_grad_(True)
                    for k in ("w", "b")} for layer in tp[n]]
        leaves += [layer[k] for layer in nets[n] for k in ("w", "b")]
    tp2 = dict(nets, feats_color=leaves[0])
    call = (tp2, leaves[0]) + tuple(args[2:])
    c = torch.randn((args[5].shape[0], 3), device=args[5].device)

    def fwd():
        with torch.no_grad():
            field.aggregate_color(*call)

    def fwd_bwd():
        rgb = field.aggregate_color(*call)
        torch.autograd.grad((rgb * c).sum(), leaves)

    out = {}
    for mode, on in (("fused", True), ("dense", False)):
        with fused_color_set(on):
            out[f"{mode}_fwd_ms"] = cuda_ms(fwd, reps)
            out[f"{mode}_fwd_bwd_ms"] = cuda_ms(fwd_bwd, reps)
    log(f"  colour path through aggregate_color, M={args[5].shape[0]} "
        f"points: " + ", ".join(f"{k} {v:.4f}" for k, v in out.items()))
    return out


def redesign_order(rows, key="ms"):
    """The kernels line's rows ranked by the time this run spent above
    their bounds: launches x (ms - bound_ms), the render and microbenchmark
    launches at the row's own shape, the training launches at its
    ``train_shape`` and the evaluation's at its ``eval_shape`` where it has
    them (else at the row's shape).  ``key="kernel_ms"`` takes the C
    entry's time where a row has one (K1, K4, K5), else ``ms``.  A row's
    ``launch_2`` (K4's second, smaller launch of a step) counts its
    ``launches`` at its own shape.  Returns [(label, excess ms)], largest
    first."""
    def over(shape, n):
        return n * (shape.get(key, shape["ms"]) - shape["bound_ms"])

    order = []
    for row in rows:
        l2 = row.get("launch_2", {"launches": 0, "ms": 0.0, "bound_ms": 0.0})
        excess = (over(row, row["launches_render"]
                       + row["launches_microbench"])
                  + over(row.get("train_shape", row),
                         row["launches_train"] - l2["launches"])
                  + over(row.get("eval_shape", row),
                         row.get("launches_eval", 0))
                  + over(l2, l2["launches"]))
        order.append((row["name"], excess))
    return sorted(order, key=lambda kv: -kv[1])


def loss_and_grads(trainer, batch, seed, trained=TRAINED):
    """Loss parts and the gradient of every ``trained`` tensor of one
    batch, the draws from a generator seeded ``seed`` (no update)."""
    import torch

    from spurfies_tpu_torch.train.optim import flatten

    gen = torch.Generator(device=trainer.device).manual_seed(seed)
    tp = trainer.state.params
    leaves = flatten({k: tp[k] for k in trained})
    loss, parts = trainer.loss_fn(tp, trainer.bundle, batch,
                                  trainer.state.step, gen)
    grads = torch.autograd.grad(loss, leaves)
    names = [f"{k}[{i}]" for k in trained for i in range(len(flatten(tp[k])))]
    return ({k: float(v.detach()) for k, v in parts.items()},
            dict(zip(names, grads)))


def compare_grads(parts_k, grads_k, parts_p, grads_p):
    """One batch's loss parts and gradients through the kernels against
    the plain versions (same batch, same draws, bf16 on both sides).

    The kernels' per-point sums agree with the plain ones to a bf16 ulp
    (phase 4), but the sampler's beta bisection and the top-W colour
    selection make discrete choices on them, so a few rays place or weigh
    their samples elsewhere, and every loss and gradient is a sum over
    the rays.  Limits: each loss part within 1e-3 relative (+ 1e-6), each
    gradient within 1e-2 relative L2: room for a few of the ~830 rays to
    move (read on the H100: 8.6e-7 and 8.2e-4, no ray moved).  Returns the
    worst readings."""
    import torch

    worst_part = max(abs(parts_k[k] - parts_p[k]) / (abs(parts_p[k]) + 1e-6)
                     for k in parts_p)
    rel = {k: float(torch.linalg.vector_norm(grads_k[k] - grads_p[k])
                    / (torch.linalg.vector_norm(grads_p[k]) + 1e-30))
           for k in grads_p}
    log(f"  loss parts: worst relative difference {worst_part:.3e}; "
        f"gradients, relative L2: " + ", ".join(f"{k} {v:.2e}"
                                                for k, v in rel.items()))
    for k, g in grads_k.items():
        if not bool(torch.isfinite(g).all()):
            fail(f"gradient {k} through the kernels is not finite")
    if worst_part > 1e-3:
        fail(f"loss parts differ by {worst_part:.3e} relative")
    bad = {k: v for k, v in rel.items() if v > 1e-2}
    if bad:
        fail(f"gradients differ beyond 1e-2 relative L2: {bad}")
    return worst_part, max(rel.values())


def syncs_in(fn):
    """The host syncs that ``torch.cuda.set_sync_debug_mode("warn")``
    reports while ``fn()`` runs (their messages)."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    # a sync reads "called a synchronizing CUDA operation"; the mode's own
    # notice ("... is a prototype feature and does not yet detect all
    # synchronizing operations") is none
    return [str(w.message) for w in caught
            if "synchroniz" in str(w.message).lower()
            and "prototype" not in str(w.message)]


def count_host_syncs(trainer, steps):
    """Host syncs of ``steps`` training steps; returns (count, first
    message).  A ``.item()`` read first shows that the count sees one."""
    import torch

    probe = torch.ones((), device=trainer.device)
    if not syncs_in(lambda: probe.item()):
        fail("the sync debug mode does not report a .item() read")

    def steps_fn():
        for _ in range(steps):
            trainer.train_step(trainer.bundle, trainer.state,
                               trainer.generator)

    msgs = syncs_in(steps_fn)
    return len(msgs), (msgs[0] if msgs else "")


def masked_psnr(trainer, view):
    import torch

    from spurfies_tpu_torch.core.metrics import psnr

    out = trainer.render_image(view["uv"], view["pose"], view["intrinsics"])
    return float(psnr(torch.as_tensor(out["rgb_values"]),
                      torch.as_tensor(view["rgb"]),
                      torch.as_tensor(view["mask"])))


def best_s(fn, reps=3):
    """The least host wall time of ``reps`` calls of ``fn``, in seconds."""
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    return min(walls)


def png_decode_times(image_path, tmp, smi):
    """Decode times of the fixture's own PNG (Sub rows: the row path) and
    of Paeth-filtered 576x768 and 1200x1600 images (the anti-diagonal
    path), each read back bit-equal."""
    from spurfies_tpu_torch.data.png import read_png, write_png
    from spurfies_tpu_torch.data.scene_data import resize_nearest

    import numpy as np

    img = read_png(image_path)
    times = {f"{img.shape[0]}x{img.shape[1]} Sub (fixture)":
             best_s(lambda: read_png(image_path))}
    for res in ((576, 768), (1200, 1600)):
        path = os.path.join(tmp, f"paeth_{res[0]}x{res[1]}.png")
        big = resize_nearest(img, res)
        write_png(path, big, 4)
        if not np.array_equal(read_png(path), big):
            fail(f"PNG decode of the Paeth-filtered {res} image")
        times[f"{res[0]}x{res[1]} Paeth"] = best_s(lambda: read_png(path))
    log("cli: PNG decode s (host, best of 3): " + ", ".join(
        f"{k} {v:.4f}" for k, v in times.items()) + f" [{smi}]")
    return times


def render_counts(trainer, uv, pose, intrinsics, keys, knn):
    """The launches of ``trainer.render_image(uv, pose, intrinsics)``,
    which its chunking fixes: per chunk of occupied rays, K1 (variant
    ``knn``) once a sampler round and once for shading, K2 once a round and
    K3 once; ``keys``: the counters."""
    view = {"uv": uv, "pose": pose, "intrinsics": intrinsics}
    _, _, n_occ, _ = first_chunk(trainer.scene, view, trainer.cfg,
                                 trainer.device)
    eff = min(trainer.cfg.train.render_chunk, -(-len(uv) // 128) * 128)
    iters = (trainer.cfg.train.eval_iters
             or trainer.cfg.model.ray_sampler.max_total_iters)
    return expected_counts(keys, {"select_knn": iters + 1,
                                  "pair_sdf_value_agg": iters,
                                  "pair_sdf_aggregate": 1},
                           -(-n_occ // eff), knn)


def trainer_spies(rec):
    """Spies on ``Trainer.__init__``, ``run`` and ``render_image`` (by name,
    for :class:`substituted`) that append to ``rec``: ``"init"`` each
    build's launches, ``"run"`` (steps, wall s, rays a step), ``"render"``
    (trainer, uv, pose, intrinsics, wall s, launches) and ``"render_ms"``."""
    import numpy as np
    import torch

    def spy_init(init):
        def f(self, *a, **k):
            before = read_counts()
            init(self, *a, **k)
            torch.cuda.synchronize()
            after = read_counts()
            rec["init"].append({k_: after[k_] - before[k_] for k_ in after})
        return f

    def spy_run(run):
        def f(self, n_steps, window=100, callback=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run(self, n_steps, window=window, callback=callback)
            torch.cuda.synchronize()
            rec["run"].append((n_steps, time.perf_counter() - t0,
                               self.cfg.train.num_pixels))
            return out
        return f

    def spy_render(render):
        def f(self, uv, pose, intrinsics):
            torch.cuda.synchronize()
            before = read_counts()
            t0 = time.perf_counter()
            out = render(self, uv, pose, intrinsics)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            after = read_counts()
            rec["render"].append((self, np.asarray(uv), pose, intrinsics,
                                  wall, {k: after[k] - before[k]
                                         for k in after}))
            rec["render_ms"].append(wall * 1e3)
            return out
        return f

    return {"__init__": spy_init, "run": spy_run, "render_image": spy_render}


def cli_phase(smi, tmp):
    """Phase 15: ``cli.train.main`` at ``configs/dtu_pn.yaml`` on a synthetic
    DTU scan (with its GT cloud) written under ``tmp``, then ``--resume``;
    the scan and the experiment stay there for phase 16.  Returns the
    launches of the two calls as ``(train, render, ms/step)``: the
    training steps with the one K1 launch of each Trainer's build (its TV
    neighbours, a training input), the validation renders, and the
    training's ms a step."""
    import numpy as np
    import torch

    from spurfies_tpu_torch.cli import train as cli_train
    from spurfies_tpu_torch.data.synthetic import export_synthetic_dtu
    from spurfies_tpu_torch.ops.pair_mlp import _prep_layers
    from spurfies_tpu_torch.train.trainer import Trainer

    here = os.path.dirname(os.path.abspath(__file__))
    rec = {"run": [], "render": [], "render_ms": [], "init": [], "load": [],
           "restore": []}

    def spy_load(load):
        def f(cfg, scan):
            t0 = time.perf_counter()
            sd = load(cfg, scan)
            rec["load"].append(time.perf_counter() - t0)
            return sd
        return f

    def spy_restore(restore):
        def f(self, path):
            restore(self, path)
            rec["restore"].append((int(self.state.step), {
                k: (v.detach().clone() if torch.is_tensor(v) else
                    [{kk: t.detach().clone() for kk, t in layer.items()}
                     for layer in v])
                for k, v in self.state.params.items()}))
        return f

    render_sum = dict.fromkeys(read_counts(), 0)
    n_renders = [0, 0]                  # renders, rays of each

    def check_renders(knn):
        """Hold each validation render's launches, which its chunking
        fixes, and add them to ``render_sum``.  Run after each CLI call, so
        that no trainer outlives the call that made it."""
        for tr, uv, pose, K, _, delta in rec["render"]:
            expect = render_counts(tr, uv, pose, K, delta, knn)
            if delta != expect:
                fail(f"cli: a validation render launched {delta}, expected "
                     f"{expect}")
            for k in render_sum:
                render_sum[k] += delta[k]
            n_renders[:] = n_renders[0] + 1, len(uv)
        rec["render"].clear()

    data = os.path.join(tmp, "data")
    t0 = time.perf_counter()
    export_synthetic_dtu(data, scan_id=24, n_views=CLI_VIEWS,
                         img_res=CLI_RES, n_points=40000, radius=0.8,
                         cam_dist=2.4, seed=1,
                         gt_root=os.path.join(data, "dtu_eval"))
    t_export = time.perf_counter() - t0
    log(f"cli: export_synthetic_dtu of {CLI_VIEWS} views at "
        f"{CLI_RES[0]}x{CLI_RES[1]} (40,000 raw points) in "
        f"{t_export:.2f} s [{smi}]")
    png_decode_times(os.path.join(data, "dtu", "scan24", "image",
                                  "000000.png"), tmp, smi)

    args = ["--config", os.path.join(here, "configs", "dtu_pn.yaml"),
            "--scans", "scan24"]
    ov = [f"dataset.data_dir_root={data}",
          f"exps_folder={os.path.join(tmp, 'exps')}",
          f"train.render_freq={CLI_EVERY}",
          f"train.checkpoint_freq={CLI_EVERY}"]
    total = CLI_STEPS + CLI_RESUME_STEPS
    spies = dict(trainer_spies(rec), restore_checkpoint=spy_restore,
                 load_scene_data=spy_load)
    sites = [(Trainer, name, None) for name in list(spies)[:4]]
    with substituted(lambda fn, _: spies[fn.__name__](fn),
                     sites + [(cli_train, "load_scene_data", None)]):
        zero_counts()
        [(first, exp)] = cli_train.main(
            args + ov + [f"train.opt_steps={CLI_STEPS}"])
        torch.cuda.synchronize()
        launches_first = read_counts()
        knn = ("select_knn_packed" if 0 < first.scene.table.n_points
               <= 2 ** 15 else "select_knn_exact")
        check_renders(knn)
        saved = torch.load(exp.checkpoint_path("latest"),
                           map_location=first.device, weights_only=True)
        del first
        torch.cuda.empty_cache()
        zero_counts()
        [(trainer, exp2)] = cli_train.main(
            ["--resume"] + args + ov + [f"train.opt_steps={total}"])
        torch.cuda.synchronize()
        launches_resume = read_counts()
        check_renders(knn)
    launches = {k: launches_first[k] + launches_resume[k]
                for k in launches_first}

    # where everything lives, and what was restored
    n_pts = trainer.scene.points.shape[0]
    log(f"cli: scan24 {n_pts} points after subsampling (K1 "
        f"{knn.split('_')[-1]}), auto budgets ray "
        f"{trainer.cfg.model.ray_budget_frac:.4f} probe "
        f"{trainer.cfg.model.probe_budget_frac:.4f}; load_scene_data "
        + ", ".join(f"{t:.2f}" for t in rec["load"]) + f" s [{smi}]")
    if knn != "select_knn_exact":
        fail("cli: the DTU scan does not select the exact K1")
    tensors = [trainer.scene.points, trainer.scene.table.idx,
               trainer.state.step, *trainer.views.values()]
    tensors += [t for v in trainer.state.params.values()
                for t in ([v] if torch.is_tensor(v) else
                          [x for layer in v for x in layer.values()])]
    tensors += [t for v in trainer.frozen.values() for layer in v
                for t in layer.values()]
    if not all(t.is_cuda for t in tensors):
        fail("cli: a trainer tensor is not on the card")
    if exp2.dir != exp.dir or int(trainer.state.step) != total:
        fail(f"cli: resumed into {exp2.dir} at step "
             f"{int(trainer.state.step)}, expected {exp.dir} at {total}")
    if len(rec["restore"]) != 1 or rec["restore"][0][0] != CLI_STEPS:
        fail(f"cli: restores {[r[0] for r in rec['restore']]}, expected "
             f"one at step {CLI_STEPS}")
    restored = rec["restore"][0][1]
    same = all(
        torch.equal(restored[k], v) if torch.is_tensor(v) else
        all(torch.equal(a[kk], b[kk]) for a, b in zip(restored[k], v)
            for kk in b)
        for k, v in saved["params"].items())
    log(f"cli: --resume restored step {rec['restore'][0][0]}, params "
        f"{'bit-equal to' if same else 'DIFFERENT from'} the saved latest")
    if not same or saved["step"] != CLI_STEPS:
        fail("cli: the resumed params are not the saved checkpoint's")

    # launches: steps x the per-step counts, plus one K1 launch in each
    # scene build (the TV neighbours), plus the validation renders'
    steps = sum(r[0] for r in rec["run"])
    if steps != total or n_renders[0] != total // CLI_EVERY:
        fail(f"cli: {steps} steps and {n_renders[0]} renders, "
             f"expected {total} and {total // CLI_EVERY}")
    for delta in rec["init"]:
        if delta != expected_counts(delta, {"select_knn": 1}, 1, knn):
            fail(f"cli: a Trainer's build launched {delta}")
    build_sum = {k: len(rec["init"]) * (k == knn) for k in launches}
    train_launches = {k: launches[k] - render_sum[k] for k in launches}
    expect = expected_counts(launches, PER_STEP, total, knn)
    if {k: train_launches[k] - build_sum[k] for k in launches} != expect:
        fail(f"cli: training launches {train_launches} - builds "
             f"{build_sum} != {expect}")
    wall = sum(r[1] for r in rec["run"])
    rays = sum(r[0] * r[2] for r in rec["run"])
    log(f"cli: train {total} steps x {rec['run'][0][2]} rays in "
        f"{wall:.3f} s = {rays / wall:.1f} train rays/s "
        f"({wall / total * 1e3:.2f} ms/step) [{smi}]; launches "
        f"{launches} (validation renders: {render_sum}; scene builds: "
        f"{build_sum})")
    log(f"cli: validation render ms at {-(-CLI_RES[0] // 4)}x"
        f"{-(-CLI_RES[1] // 4)} ({n_renders[1]} rays): "
        + ", ".join(f"{t:.1f}" for t in rec["render_ms"]) + f" [{smi}]")

    # metrics.jsonl, the val rows and the checkpoints
    with open(os.path.join(exp.plots_dir, "logs", "metrics.jsonl")) as f:
        rows = [json.loads(ln) for ln in f]
    train_rows = [r for r in rows if "rgb_loss" in r]
    val_rows = [r for r in rows if "rgb_loss" not in r]
    for r in train_rows:
        log(f"  cli step {r['step']}: " + ", ".join(
            f"{k} {r[k]:.5g}" for k in ("loss", "rgb_loss", "eikonal_loss",
                                        "mask_loss", "psnr",
                                        "ray_overflow", "probe_overflow",
                                        "notfinite")))
    log("cli: val psnr " + ", ".join(
        f"step {r['step']} {r['psnr']:.2f} dB" for r in val_rows))
    every = list(range(CLI_EVERY, total + 1, CLI_EVERY))
    if [r["step"] for r in train_rows] != every or [
            r["step"] for r in val_rows] != every:
        fail(f"cli: metrics.jsonl rows at {[r['step'] for r in rows]}")
    if not all(np.isfinite(r["loss"]) and r["notfinite"] == 0
               for r in train_rows) or not all(
            np.isfinite(r["psnr"]) for r in val_rows):
        fail("cli: a non-finite loss or PSNR, or a skipped step")
    if not train_rows[-1]["rgb_loss"] < train_rows[0]["rgb_loss"]:
        fail("cli: rgb_loss did not fall across the windows")
    ckpts = sorted(os.listdir(exp.ckpt_dir))
    if ckpts != sorted([str(s_) for s_ in every] + ["latest"]):
        fail(f"cli: checkpoints {ckpts}")

    # one captured step of the CLI's trainer against the plain versions
    seen = capture_step(trainer)
    got = {k: len(v) for k, v in seen.items()}
    if got != PER_STEP:
        fail(f"cli: one step launched {got}, expected {PER_STEP}")
    check_step("dtu_cli", seen, _prep_layers(trainer.frozen,
                                             torch.float32),
               trainer.scene.spec.radius(trainer.scene.table.r))
    del seen
    n_sync, first_sync = count_host_syncs(trainer, 2)
    log(f"cli: host syncs in 2 training steps: {n_sync}"
        + (f" (first: {first_sync})" if n_sync else ""))
    if n_sync:
        fail("cli: a training step waits on the card")
    del trainer, saved, rec
    torch.cuda.empty_cache()
    return train_launches, render_sum, wall / total * 1e3


def random_vgg_state(seed):
    """Seeded random torchvision-VGG16 and LPIPS-linear state dicts (the
    weights are not in the repository): He-scaled convolutions, small
    positive heads."""
    import torch

    from spurfies_tpu_torch.eval import lpips

    gen = torch.Generator().manual_seed(seed)
    vgg, c = {}, 3
    outs = [64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512]
    for i, o in zip(lpips.CONV_IDX, outs):
        vgg[f"features.{i}.weight"] = torch.randn(
            o, c, 3, 3, generator=gen) * math.sqrt(2.0 / (9 * c))
        vgg[f"features.{i}.bias"] = torch.randn(o, generator=gen) * 0.01
        c = o
    lin = {f"lin{i}.model.1.weight": torch.rand(1, ch, 1, 1, generator=gen)
           * 0.1 for i, ch in enumerate(lpips.CHANNELS)}
    return vgg, lin


def eval_phase(smi, tmp):
    """Phase 16: ``cli.evaluate.main`` (the mesh at EVAL_RES, EVAL_VIEWS
    novel views) on phase 15's trained scan under ``tmp``, counters set to
    0 just before it, then ``calibrate_iso_level`` and ``cli.eval_dtu.main``
    on its mesh and the export's GT, every part timed.  It holds the
    probe's K1 and K2 at its busiest chunk against their plain versions,
    the grid of the EVAL_HELD_CHUNKS busiest chunks against the plain
    versions' (phase 4's limits; the same points read 1000), the device
    marching against the CPU's on a MARCH_BLOCK**3 block holding the
    surface (faces equal, vertices within 1e-12 relative), the launches
    (chunks x (K1 + K2) in the probe, each render's chunking, one K1 in the
    scene build), 0 host syncs in the probe loop, LPIPS on the card against
    the CPU (random weights, 1e-4 relative) and ``chamfer.json``.  Prints
    the probe budget's busiest chunk.  Returns (the launches, {wrapper:
    result} of the busiest chunk's K1 and K2)."""
    import numpy as np
    import torch

    from spurfies_tpu_torch.cli import eval_dtu as cli_eval_dtu
    from spurfies_tpu_torch.cli import evaluate as cli_eval
    from spurfies_tpu_torch.data.png import read_png
    from spurfies_tpu_torch.eval import (
        chamfer,
        clean_mesh,
        lpips,
        marching,
        mesh_extract,
        nvs,
    )
    from spurfies_tpu_torch.model.field import SDF_FILLER
    from spurfies_tpu_torch.ops.pair_mlp import _prep_layers
    from spurfies_tpu_torch.ops.voxel_grid import fine_occupancy
    from spurfies_tpu_torch.train.trainer import Trainer

    here = os.path.dirname(os.path.abspath(__file__))
    t_phase = time.perf_counter()
    data = os.path.join(tmp, "data")
    out = os.path.join(tmp, "results")
    rec = {"render": []}

    def timed(key):
        def make(fn):
            def f(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = fn(*a, **k)
                torch.cuda.synchronize()
                rec.setdefault(key, []).append(time.perf_counter() - t0)
                return res
            return f
        return make

    def spy_probe(fn):
        def f(sdf_fn, axes, chunk=EVAL_CHUNK):
            got = {}
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

            def run():
                ev[0].record()
                got["vals"] = fn(sdf_fn, axes, chunk)
                ev[1].record()
            before = read_counts()
            t0 = time.perf_counter()
            msgs = syncs_in(run)
            wall = time.perf_counter() - t0
            after = read_counts()
            rec["probe"] = {"wall_s": wall,
                            "device_ms": ev[0].elapsed_time(ev[1]),
                            "syncs": msgs, "axes": axes, "chunk": chunk,
                            "vals": got["vals"], "sdf_fn": sdf_fn,
                            "launches": {k: after[k] - before[k]
                                         for k in after}}
            return got["vals"]
        return f

    def spy_march(fn):
        def f(sdf, level=0.0, spacing=(1.0, 1.0, 1.0),
              origin=(0.0, 0.0, 0.0)):
            rec["march_args"] = (level, spacing, origin)
            return timed("marching")(fn)(sdf, level, spacing, origin)
        return f

    def spy_render(fn):
        def f(self, uv, pose, intrinsics):
            torch.cuda.synchronize()
            before = read_counts()
            t0 = time.perf_counter()
            res = fn(self, uv, pose, intrinsics)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            after = read_counts()
            rec["render"].append((self, np.asarray(uv), pose, intrinsics,
                                  wall, {k: after[k] - before[k]
                                         for k in after}))
            return res
        return f

    def spy_sdf_fn(fn):
        def f(trainer):
            rec["trainer"] = trainer
            return fn(trainer)
        return f

    def spy_dedup(fn):
        def f(pts, *a, **k):
            kept = timed("dedup")(fn)(pts, *a, **k)
            rec["dedup_points"] = (len(pts), len(kept))
            return kept
        return f

    # spies by the name of the function they wrap (nvs.ssim_fn is ssim)
    spies = {"grid_axes": timed("grid"), "probe_grid": spy_probe,
             "marching_tetrahedra": spy_march,
             "largest_component": timed("largest_component"),
             "save_mesh_ply": timed("ply_write"),
             "render_image": spy_render, "ssim": timed("ssim"),
             "write_png": timed("png_write"), "make_sdf_fn": spy_sdf_fn,
             "clean_mesh_by_masks": timed("clean_mask"),
             "clean_mesh_by_visibility": timed("clean_visibility"),
             "clean_mesh_by_frustum": timed("clean_frustum"),
             "chamfer_dtu": timed("chamfer_dtu"),
             "sample_triangles": timed("sample"),
             "radius_downsample": spy_dedup}
    sites = [(mesh_extract, name, None) for name in (
        "grid_axes", "probe_grid", "marching_tetrahedra",
        "largest_component", "save_mesh_ply")]
    sites += [(Trainer, "render_image", None), (nvs, "ssim_fn", None),
              (nvs, "write_png", None), (cli_eval, "make_sdf_fn", None)]
    sites += [(clean_mesh, f"clean_mesh_by_{p}", None)
              for p in ("masks", "visibility", "frustum")]
    sites += [(chamfer, name, None) for name in (
        "chamfer_dtu", "sample_triangles", "radius_downsample")]
    ov = [f"dataset.data_dir_root={data}",
          f"exps_folder={os.path.join(tmp, 'exps')}"]
    with substituted(lambda fn, _: spies[fn.__name__](fn), sites):
        zero_counts()
        t0 = time.perf_counter()
        [summary] = cli_eval.main(
            ["--config", os.path.join(here, "configs", "dtu_pn.yaml"),
             "--scans", "scan24", "--mesh", "--rendering", "--resolution",
             str(EVAL_RES), "--max-views", str(EVAL_VIEWS), "--out", out]
            + ov)
        torch.cuda.synchronize()
        t_eval = time.perf_counter() - t0
        launches = read_counts()
        t0 = time.perf_counter()
        scores = cli_eval_dtu.main(
            ["--scans", "24", "--meshes", out, "--data-root", data,
             "--gt-root", os.path.join(data, "dtu_eval"), "--out",
             os.path.join(out, "chamfer.json")])
        t_dtu = time.perf_counter() - t0

    trainer = rec["trainer"]
    scene = trainer.scene
    knn = ("select_knn_packed" if 0 < scene.table.n_points <= 2 ** 15
           else "select_knn_exact")
    if knn != "select_knn_exact":
        fail("eval: the DTU scan does not select the exact K1")
    mesh = summary.get("mesh", {})
    log(f"eval: cli.evaluate {t_eval:.2f} s: mesh {mesh.get('n_verts')} "
        f"verts / {mesh.get('n_faces')} faces at resolution {EVAL_RES}; NVS "
        f"PSNR {summary['nvs']['psnr']}, SSIM {summary['nvs']['ssim']}; "
        f"lpips {summary['nvs']['lpips']} ({summary['nvs'].get('lpips_skipped_reason')}) [{smi}]")
    if not mesh.get("n_faces"):
        fail("eval: an empty mesh")
    if len(summary["nvs"]["psnr"]) != EVAL_VIEWS or not all(
            np.isfinite(v) for v in summary["nvs"]["psnr"]
            + summary["nvs"]["ssim"]):
        fail(f"eval: NVS scores {summary['nvs']}")

    # the probe: chunks x (K1 + K2), no host sync in the loop
    probe = rec["probe"]
    axes, chunk, vals = probe["axes"], probe["chunk"], probe["vals"]
    steps = [int(a.shape[0]) for a in axes]
    n = steps[0] * steps[1] * steps[2]
    chunks = -(-n // chunk)
    want = expected_counts(probe["launches"], {"select_knn": 1,
                                               "pair_sdf_value_agg": 1},
                           chunks, knn)
    log(f"eval: probe grid {steps} = {n} points in {chunks} chunks of "
        f"{chunk}: wall {probe['wall_s']:.3f} s, device (CUDA events) "
        f"{probe['device_ms']:.1f} ms ({probe['device_ms'] / chunks:.2f} ms "
        f"a chunk), host syncs {len(probe['syncs'])}, launches "
        f"{probe['launches']} [{smi}]")
    if probe["launches"] != want:
        fail(f"eval: the probe launched {probe['launches']}, expected {want}")
    if probe["syncs"]:
        fail(f"eval: the probe loop waits on the card: {probe['syncs'][0]}")
    render_sum = dict.fromkeys(launches, 0)
    for tr, uv, pose, K, wall, delta in rec["render"]:
        want = render_counts(tr, uv, pose, K, delta, knn)
        if delta != want:
            fail(f"eval: an NVS render launched {delta}, expected {want}")
        for k in render_sum:
            render_sum[k] += delta[k]
    build = {k: int(k == knn) for k in launches}
    total = {k: probe["launches"][k] + render_sum[k] + build[k]
             for k in launches}
    if launches != total:
        fail(f"eval: cli.evaluate launched {launches}, expected probe + "
             f"renders + one K1 in the scene build = {total}")
    log(f"eval: NVS renders at {CLI_RES[0]}x{CLI_RES[1]}: "
        + ", ".join(f"{r[4] * 1e3:.1f} ms" for r in rec["render"])
        + f"; launches {render_sum} [{smi}]")
    log("eval: parts s (host, synchronized): "
        + ", ".join(f"{k} {sum(rec.get(k, [0.0])):.4f}" for k in (
            "grid", "marching", "largest_component", "ply_write", "ssim",
            "png_write")) + f" [{smi}]")

    # the probe budget: each chunk's occupied points against its slots
    occ = torch.stack([
        fine_occupancy(mesh_extract.grid_points(axes, i, min(i + chunk, n)),
                       scene.occ_fine, scene.spec).sum()
        for i in range(0, n, chunk)]).cpu()
    sizes = torch.tensor([min(chunk, n - i) for i in range(0, n, chunk)])
    budget = torch.tensor([max(int(m * PROBE_BUDGET) // 128 * 128, 128)
                           for m in sizes.tolist()])
    share = occ.double() / sizes
    top = int(share.argmax())
    log(f"eval: probe budget {PROBE_BUDGET}: busiest chunk {top} holds "
        f"{int(occ[top])} occupied of {int(sizes[top])} points (share "
        f"{float(share[top]):.4f}); chunks over their {int(budget[0])} "
        f"slots: {int((occ > budget).sum())} of {chunks} (occupied points "
        f"dropped: {int((occ - budget).clamp(min=0).sum())})")

    # K1 and K2 at the busiest chunk, against their plain versions
    sdf_fn = probe["sdf_fn"]

    def chunk_pts(i):
        return mesh_extract.grid_points(axes, i * chunk,
                                        min((i + 1) * chunk, n))
    seen = capture(lambda: sdf_fn(chunk_pts(top)))
    prior_f32 = _prep_layers(trainer.frozen, torch.float32)
    best = check_step("eval probe", seen, prior_f32,
                      scene.spec.radius(scene.table.r))
    del seen

    # the grid of the busiest chunks against the plain versions'
    for i in torch.argsort(occ, descending=True)[:EVAL_HELD_CHUNKS].tolist():
        got = vals[i * chunk:min((i + 1) * chunk, n)]
        with plain_versions():
            ref = sdf_fn(chunk_pts(i))
        empty = ref == SDF_FILLER
        if not torch.equal(got == SDF_FILLER, empty):
            fail(f"eval: grid chunk {i}: {int(((got == SDF_FILLER) != empty).sum())} "
                 "points read empty space in one version only")
        within(f"eval grid chunk {i} ({int((~empty).sum())} probed points)",
               got[~empty][:, None], ref[~empty][:, None])

    # the device marching against the CPU's on a block holding the surface
    level, spacing, origin = rec["march_args"]
    grid = vals.reshape(steps)
    first = torch.nonzero(grid < level)[0].tolist()
    lo = [min(max(c - MARCH_BLOCK // 2, 0), max(s_ - MARCH_BLOCK, 0))
          for c, s_ in zip(first, steps)]
    block = grid[lo[0]:lo[0] + MARCH_BLOCK, lo[1]:lo[1] + MARCH_BLOCK,
                 lo[2]:lo[2] + MARCH_BLOCK].contiguous()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vd, fd = marching.marching_tetrahedra(block, level, spacing, origin)
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    vc, fc = marching.marching_tetrahedra(block.cpu(), level, spacing, origin)
    t_cpu = time.perf_counter() - t0
    rel = float(np.abs(vd - vc).max() / max(np.abs(vc).max(), 1e-30)) \
        if len(vc) else 0.0
    log(f"eval: marching on a {list(block.shape)} block at {lo}: {len(fc)} "
        f"faces, device {t_dev:.3f} s, CPU {t_cpu:.3f} s, faces "
        f"{'equal' if np.array_equal(fd, fc) else 'DIFFERENT'}, vertices "
        f"within {rel:.2e} relative")
    if not len(fc) or not np.array_equal(fd, fc) or rel > 1e-12:
        fail("eval: the device marching differs from the CPU's")
    del grid, block, vals

    # calibrate_iso_level once: one probe of its 16,384 points
    zero_counts()
    t0 = time.perf_counter()
    iso = mesh_extract.calibrate_iso_level(scene.points, sdf_fn)
    t_iso = time.perf_counter() - t0
    iso_launches = read_counts()
    want = expected_counts(iso_launches, {"select_knn": 1,
                                          "pair_sdf_value_agg": 1}, 1, knn)
    log(f"eval: calibrate_iso_level {iso:+.5f} in {t_iso:.3f} s, launches "
        f"{iso_launches} [{smi}]")
    if iso_launches != want:
        fail(f"eval: calibrate_iso_level launched {iso_launches}")
    launches = {k: launches[k] + iso_launches[k] for k in launches}

    # LPIPS with random weights on the two rendered views: card and CPU
    vgg, lin = random_vgg_state(0)
    imgs = [(read_png(os.path.join(out, "dtu_pn_scan24",
                                   f"eval_{vid:03d}.png")) / 255.0,
             read_png(os.path.join(data, "dtu", "scan24", "image",
                                   f"{vid:06d}.png")) / 255.0)
            for vid in summary["eval_ids"]]
    lp = {}
    for dev in ("cuda", "cpu"):
        convs = lpips.convert_vgg16_features(vgg, dev)
        lins = lpips.convert_lpips_linear(lin, dev)
        if dev == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        lp[dev] = [float(lpips.lpips(convs, lins, a, b)) for a, b in imgs]
        lp[dev + "_s"] = time.perf_counter() - t0
    rel = max(abs(a - b) / abs(b) for a, b in zip(lp["cuda"],
                                                   lp["cpu"]))
    log(f"eval: LPIPS (random weights) card {lp['cuda']} in "
        f"{lp['cuda_s']:.3f} s, CPU {lp['cpu']} in "
        f"{lp['cpu_s']:.3f} s; relative difference {rel:.2e} [{smi}]")
    if rel > 1e-4:
        fail("eval: LPIPS on the card differs from the CPU's")

    # the Chamfer protocol
    parts = {k: sum(rec.get(k, [])) for k in (
        "clean_mask", "clean_visibility", "clean_frustum", "sample",
        "dedup")}
    parts["kd_and_filters"] = sum(rec.get("chamfer_dtu", [])) \
        - parts["sample"] - parts["dedup"]
    log(f"eval: cli.eval_dtu {t_dtu:.2f} s: {scores.get(24)}; parts s "
        + json.dumps(parts) + f"; dedup {rec['dedup_points'][0]} samples "
        f"-> {rec['dedup_points'][1]} [{smi}]")
    path = os.path.join(out, "chamfer.json")
    if not os.path.exists(path):
        fail("eval: cli.eval_dtu wrote no chamfer.json")
    with open(path) as f:
        per_scan = json.load(f)["per_scan"]
    if "24" not in per_scan or not all(
            np.isfinite(per_scan["24"][k]) for k in ("acc", "comp",
                                                      "overall")):
        fail(f"eval: chamfer.json holds {per_scan}")
    log(f"eval: phase 16 wall {time.perf_counter() - t_phase:.2f} s")
    del trainer, rec
    torch.cuda.empty_cache()
    return launches, best


def k9_phase(smi):
    """Phase 17: the port's ``micro_gather`` script (K9 at the shapes of
    ``scripts/micro_gather.py``, each rows-per-block setting), counters set
    to 0 just before it; then K9 bit-equal to ``table[idx]`` at GATHER_ROWS
    x GATHER_D (n GATHER_N), timed beside its plain version and
    ``table[idx]`` (``aten::index``).  Returns (the script's launches, the
    kernels-line result)."""
    import numpy as np
    import torch

    from spurfies_tpu_torch.ops import gather_rows as gr
    from spurfies_tpu_torch.scripts import micro_gather

    zero_counts()
    rc = micro_gather.main(["--rows", str(GATHER_ROWS), "--n",
                            str(GATHER_N), "--d", str(GATHER_D)])
    torch.cuda.synchronize()
    launches = read_counts()
    if rc != 0:
        fail(f"micro_gather exited with {rc}")
    m, n, d = GATHER_ROWS, GATHER_N, GATHER_D
    rng = np.random.default_rng(1)
    dev = torch.device("cuda")
    table = torch.as_tensor(rng.normal(size=(n, d)), dtype=torch.float32,
                            device=dev)
    idx = torch.as_tensor(rng.integers(0, n, m), dtype=torch.int32,
                          device=dev)
    got = gr.gather_rows(table, idx)
    # tolerance: bit-equal (a gather moves bits)
    if not torch.equal(got, gr.gather_rows_ref(table, idx)):
        fail("K9 gather_rows differs from table[idx]")
    ms = cuda_ms(lambda: gr.gather_rows(table, idx), 50)
    plain_ms = cuda_ms(lambda: gr.gather_rows_ref(table, idx), 50)
    lib_ms = cuda_ms(lambda: table[idx], 50)
    # bound: the output written and the indices read once, the table read
    # from HBM once; the gathered reads hit the L2-resident table (983 KB)
    n_bytes = m * d * 4 + m * 4 + n * d * 4
    b_ms, b_by = bound_ms(n_bytes, 0.0, PEAK_F32_FLOPS)
    b_all = (n_bytes + m * d * 4) / PEAK_BYTES * 1e3
    log(f"K9 gather_rows: [{m}, {d}] from [{n}, {d}], bit-equal; kernel "
        f"{ms:.4f} ms ({n_bytes / ms / 1e6:.0f} GB/s), plain "
        f"{plain_ms:.4f} ms, table[idx] {lib_ms:.4f} ms, bound {b_ms:.4f} "
        f"ms ({b_by}; {b_all:.4f} ms with every gathered read from HBM); "
        f"micro_gather launches {launches['gather_rows']} [{smi}]")
    return launches, {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                      "bound_by": b_by, "library_ms": lib_ms,
                      "max_abs_err": 0.0, "bound_gathered_reads_ms": b_all,
                      "rows": m}


def option_phase(tag, cfg, pts, cols, views, prior, smi=None):
    """One option path of OPTIONS on dust3r_like (phases 12 and 18):
    :func:`train_path` (one captured step against the plain versions, a
    batch's loss and gradients, host syncs, OPTION_WARMUP + OPTION_STEPS
    steps with their launches), then PROFILE_STEPS steps profiled.
    Returns (results by wrapper name, launches)."""
    import torch

    from spurfies_tpu_torch.config import apply_overrides
    from spurfies_tpu_torch.train.trainer import Trainer

    ov, per_step = OPTIONS[tag]
    tr = Trainer(apply_overrides(cfg, ov), pts, cols, views, device="cuda")
    tr.load_frozen(prior)
    best, counts, _ = train_path(f"dust3r_like {tag}", tr, per_step,
                                 OPTION_WARMUP, OPTION_STEPS, OPTION_STEPS,
                                 smi)
    prof = profiled(lambda: tr.run(PROFILE_STEPS, window=PROFILE_STEPS))
    prof["ms_per_step"] = prof["profiled_wall_ms"] / PROFILE_STEPS
    log(f"train profile {tag}: {json.dumps(prof)}")
    del tr
    torch.cuda.empty_cache()
    return best, counts


def entangled_phase(smi, cfg, pts, cols, views, view):
    """Phase 19: the legacy entangled model (``model.entangled=true``) on
    dust3r_like: one full render of ``view`` (its launches: K1 once a
    chunk of occupied rays), a batch's loss and gradients through K1 and
    through its plain version, host syncs in two steps (0), then
    OPTION_WARMUP + OPTION_STEPS steps (K1 once a step, nothing else; the
    loss finite, rgb_loss falling), their ms a step and the peak device
    memory.  Returns (render launches, training launches)."""
    import numpy as np
    import torch

    from spurfies_tpu_torch.config import apply_overrides
    from spurfies_tpu_torch.train.trainer import Trainer

    cfg_e = apply_overrides(cfg, ["model.entangled=true"])
    tr = Trainer(cfg_e, pts, cols, views, device="cuda")
    if tr.prior is not None or set(tr.state.params) != set(
            ENTANGLED_TRAINED):
        fail(f"entangled: trainer holds {sorted(tr.state.params)}")
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = tr.render_image(view["uv"], view["pose"], view["intrinsics"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_render = read_counts()
    _, _, n_occ, _ = first_chunk(tr.scene, view, cfg_e, tr.device)
    eff = min(cfg_e.train.render_chunk, -(-len(view["uv"]) // 128) * 128)
    expect = expected_counts(launches_render, ENTANGLED_STEP, -(-n_occ // eff),
                             "select_knn_packed")
    if launches_render != expect:
        fail(f"entangled render launches {launches_render} != {expect}")
    n = len(view["uv"])
    for key, v in out.items():
        if v.shape[0] != n or not np.isfinite(v.astype(np.float64)).all():
            fail(f"entangled render: output {key} not finite / wrong shape")
    if out["ray_mask"].sum() < 0.1 * n:
        fail("entangled render: almost no ray hit the cloud")
    log(f"entangled: render {n} rays ({n_occ} occupied) in {wall:.3f} s = "
        f"{n / wall:.1f} rays/s, {cfg_e.model.ray_sampler.n_samples} "
        f"uniform samples a ray; launches {launches_render} [{smi}]")

    batch = tr.sample_batch(tr.views,
                            torch.Generator(device=tr.device).manual_seed(7))
    parts_k, grads_k = loss_and_grads(tr, batch, 8, ENTANGLED_TRAINED)
    with plain_versions():
        parts_p, grads_p = loss_and_grads(tr, batch, 8, ENTANGLED_TRAINED)
    log("entangled step, K1 vs its plain version (same batch and draws):")
    compare_grads(parts_k, grads_k, parts_p, grads_p)
    del grads_k, grads_p
    n_sync, first_sync = count_host_syncs(tr, 2)
    log(f"entangled: host syncs in 2 training steps: {n_sync}"
        + (f" (first: {first_sync})" if n_sync else ""))
    if n_sync:
        fail("entangled: a training step waits on the card")

    history = []
    tr.run(OPTION_WARMUP, window=OPTION_WARMUP,
           callback=lambda s_, m: history.append((s_, m)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    tr.run(OPTION_STEPS, window=OPTION_STEPS // 2,
           callback=lambda s_, m: history.append((s_, m)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    expect = expected_counts(launches, ENTANGLED_STEP, OPTION_STEPS,
                             "select_knn_packed")
    if launches != expect:
        fail(f"entangled training launches {launches} != {expect}")
    for step, m in history:
        log(f"  entangled step {step}: " + ", ".join(
            f"{k} {m[k]:.5g}" for k in ("loss", "rgb_loss", "eikonal_loss",
                                        "mask_loss", "psnr", "notfinite")))
    if not all(np.isfinite(m["loss"]) and m["notfinite"] == 0
               for _, m in history):
        fail("entangled: a non-finite loss or a skipped step")
    if not history[-1][1]["rgb_loss"] < history[0][1]["rgb_loss"]:
        fail("entangled: rgb_loss did not fall")
    n_pix = cfg_e.train.num_pixels
    log(f"entangled: train {OPTION_STEPS} steps x {n_pix} rays in "
        f"{wall:.3f} s = {wall / OPTION_STEPS * 1e3:.2f} ms/step "
        f"({OPTION_STEPS * n_pix / wall:.1f} train rays/s), peak device "
        f"memory {peak:.2f} GiB; launches {launches} [{smi}]")
    eprof = profiled(lambda: tr.run(3, window=3))
    eprof["ms_per_step"] = eprof["profiled_wall_ms"] / 3
    log(f"train profile entangled: {json.dumps(eprof)} [{smi}]")
    del tr
    torch.cuda.empty_cache()
    return launches_render, launches


def local_phase(smi, tmp, cli_ms):
    """Phase 20: the local (Vis-MVSNet) feature loss through the training
    CLI on phase 15's scan under ``tmp``.  A random-weight
    ``ckpt/vismvsnet.pt`` in the reference's key layout goes into a
    working directory, the ``cam4feat`` and ``image`` fixtures are written
    from the export's cameras and train views (``export_synthetic_mvs``);
    the extractor's features on the card are held against the CPU's on
    the fixture's three 768x1024 images (1e-4 of the scale: f32, TF32
    off); then ``cli.train.main`` at ``configs/dtu_pn.yaml`` with
    ``loss.local_weight=0.5`` runs LOCAL_STEPS steps from that directory
    (counters set to 0 just before it).  It fails unless the bundle is on
    the card, every step's local_loss is finite and some non-zero, no
    step is skipped, the launches are steps x PER_STEP plus the scene
    build's and the validation render's, one captured step holds against
    the plain versions and two steps make no host sync.  It prints the
    bundle's build time and ms/step beside phase 15's ``cli_ms``.
    Returns (training launches, render launches)."""
    import numpy as np
    import torch

    from spurfies_tpu_torch.cli import train as cli_train
    from spurfies_tpu_torch.convert.torch_ckpt import convert_vismvsnet
    from spurfies_tpu_torch.data.mvs_local import feature_images
    from spurfies_tpu_torch.data.scene_data import glob_images
    from spurfies_tpu_torch.data.synthetic import (
        export_synthetic_mvs,
        random_vismvsnet_state,
    )
    from spurfies_tpu_torch.ops.pair_mlp import _prep_layers
    from spurfies_tpu_torch.train import trainer as ttrainer

    here = os.path.dirname(os.path.abspath(__file__))
    data = os.path.join(tmp, "data")
    work = os.path.join(tmp, "local")
    os.makedirs(os.path.join(work, "ckpt"))
    state = random_vismvsnet_state(0)
    torch.save(state, os.path.join(work, "ckpt", "vismvsnet.pt"))
    t0 = time.perf_counter()
    ids = export_synthetic_mvs(data, scan_id=24)
    log(f"local: cam4feat and image fixtures of views {ids} written in "
        f"{time.perf_counter() - t0:.2f} s")

    # the extractor on the card against the CPU, same weights and images
    paths = glob_images(os.path.join(data, "dtu", "DTU_pixelnerf",
                                     "dtu_scan24", "image"))[:3]
    batch = torch.from_numpy(feature_images(paths))
    fx = convert_vismvsnet(state, "cuda")
    with torch.no_grad():
        t0 = time.perf_counter()
        f_cpu = convert_vismvsnet(state, "cpu")(batch)[2]
        cpu_s = time.perf_counter() - t0
        xb = batch.cuda()
        f_dev = fx(xb)[2]
        dev_ms = cuda_ms(lambda: fx(xb), 3)
    scale = float(f_cpu.abs().max())
    err = float((f_dev.cpu() - f_cpu).abs().max())
    log(f"local: featext {tuple(batch.shape)} -> f3 {tuple(f_dev.shape)}: "
        f"card {dev_ms:.2f} ms, CPU {cpu_s:.3f} s; max abs err "
        f"{err:.3e} ({err / scale:.2e} of the scale {scale:.3g}; f32, TF32 "
        f"off) [{smi}]")
    # tolerance: f32 convolutions in cuDNN's sum order against the CPU's
    if not err <= 1e-4 * scale:
        fail("local: the extractor's features on the card differ from the "
             "CPU's")
    del fx, f_cpu, f_dev, xb

    rec = {"bundle_s": [], "run": [], "render": [], "render_ms": [],
           "parts": [], "init": []}

    def spy_bundle(build):
        def f(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = build(*a, **k)
            torch.cuda.synchronize()
            rec["bundle_s"].append(time.perf_counter() - t0)
            return out
        return f

    def spy_step(make):
        def f(*a, **k):
            loss_fn, sample_batch, step = make(*a, **k)

            def g(*a2, **k2):
                parts = step(*a2, **k2)
                rec["parts"].append(parts)
                return parts
            return loss_fn, sample_batch, g
        return f

    args = ["--config", os.path.join(here, "configs", "dtu_pn.yaml"),
            "--scans", "scan24", f"dataset.data_dir_root={data}",
            f"exps_folder={os.path.join(tmp, 'exps_local')}",
            "loss.local_weight=0.5", f"train.opt_steps={LOCAL_STEPS}",
            f"train.render_freq={LOCAL_STEPS}",
            f"train.checkpoint_freq={LOCAL_STEPS}"]
    wrap = dict(trainer_spies(rec), build_local_bundle=spy_bundle,
                make_train_step=spy_step)
    sites = [(ttrainer.Trainer, name, None) for name in list(wrap)[:3]]
    sites += [(cli_train, "build_local_bundle", None),
              (ttrainer, "make_train_step", None)]
    cwd = os.getcwd()
    os.chdir(work)
    try:
        with substituted(lambda fn, _: wrap[fn.__name__](fn), sites):
            zero_counts()
            [(trainer, _)] = cli_train.main(args)
            torch.cuda.synchronize()
            launches = read_counts()
    finally:
        os.chdir(cwd)

    ctx = trainer.local_ctx
    if ctx is None or not ctx["feats"].is_cuda or tuple(
            ctx["feats"].shape) != (3, 384, 512, 32):
        fail("local: the trainer holds no bundle on the card")
    knn = "select_knn_exact"
    render_sum = dict.fromkeys(launches, 0)
    for tr, uv, pose, K, _, delta in rec["render"]:
        if delta != render_counts(tr, uv, pose, K, delta, knn):
            fail(f"local: a validation render launched {delta}")
        for k in render_sum:
            render_sum[k] += delta[k]
    for delta in rec["init"]:
        if delta != expected_counts(delta, {"select_knn": 1}, 1, knn):
            fail(f"local: the Trainer's build launched {delta}")
    train_launches = {k: launches[k] - render_sum[k] for k in launches}
    expect = expected_counts(launches, PER_STEP, LOCAL_STEPS, knn)
    expect[knn] += len(rec["init"])
    if train_launches != expect:
        fail(f"local: training launches {train_launches} != {expect}")
    steps = rec["parts"][:LOCAL_STEPS]
    vals = torch.stack([p["local_loss"] for p in steps]).cpu().numpy()
    skipped = torch.stack([p["notfinite"] for p in steps]).cpu().numpy()
    rgb = torch.stack([p["rgb_loss"] for p in steps]).cpu().numpy()
    if not np.isfinite(vals).all() or skipped.any():
        fail("local: a non-finite local_loss or a skipped step")
    if not (vals > 0).any():
        fail("local: local_loss is 0 on every step")
    wall = sum(r[1] for r in rec["run"])
    log(f"local: bundle built in {rec['bundle_s'][0]:.3f} s (3 images at "
        f"768x1024 through the extractor on the card) [{smi}]")
    log(f"local: local_loss over {len(vals)} steps: first {vals[0]:.5g}, "
        f"last {vals[-1]:.5g}, mean {vals.mean():.5g}, non-zero on "
        f"{int((vals > 0).sum())}; rgb_loss {rgb[:10].mean():.5g} -> "
        f"{rgb[-10:].mean():.5g} (first and last 10 steps)")
    log(f"local: train {LOCAL_STEPS} steps in {wall:.3f} s = "
        f"{wall / LOCAL_STEPS * 1e3:.2f} ms/step (phase 15 without the "
        f"local loss: {cli_ms:.2f} ms/step); launches {train_launches} "
        f"(validation render {render_sum}) [{smi}]")
    del rec["parts"][:]

    seen = capture_step(trainer)
    got = {k: len(v) for k, v in seen.items()}
    if got != PER_STEP:
        fail(f"local: one step launched {got}, expected {PER_STEP}")
    check_step("dtu_local", seen, _prep_layers(trainer.frozen, torch.float32),
               trainer.scene.spec.radius(trainer.scene.table.r))
    del seen
    n_sync, first_sync = count_host_syncs(trainer, 2)
    log(f"local: host syncs in 2 training steps: {n_sync}"
        + (f" (first: {first_sync})" if n_sync else ""))
    if n_sync:
        fail("local: a training step waits on the card")
    lprof = profiled(lambda: trainer.run(PROFILE_STEPS, window=PROFILE_STEPS))
    lprof["ms_per_step"] = lprof["profiled_wall_ms"] / PROFILE_STEPS
    log(f"train profile local loss: {json.dumps(lprof)} [{smi}]")
    del trainer, rec
    torch.cuda.empty_cache()
    return train_launches, render_sum


def pretrain_phase(smi, tmp, cfg, pts, cols, views, view):
    """Phase 21: prior pretraining through ``cli.pretrain_prior.main`` at
    ``PriorConfig``'s widths (32 shapes, 4,096 points, 8,192 queries,
    batches of 4,096), cut to PRIOR_STEPS of its 20,000 steps, in a
    working directory under ``tmp`` (counters set to 0 just before it).
    It fails unless K1 (packed) ran once a step and nothing else, the mean
    sdf_l1 of the last 50 steps is below the first 50's, one step of the
    trained parameters through K1 and through its plain version gives the
    same loss and decoder and latent gradients (1e-6 relative; 1e-5
    relative L2: the latents' gather adds in another order), and the
    saved npz loads into a ``Trainer`` (``load_frozen``) that renders a
    chunk of ``view`` with its launches.  It prints the corpus build time
    and steps/s.  Returns (pretraining launches, render launches)."""
    import numpy as np
    import torch

    from spurfies_tpu_torch.cli import pretrain_prior as cli_pretrain
    from spurfies_tpu_torch.prior import pretrain as tpre
    from spurfies_tpu_torch.train.optim import flatten
    from spurfies_tpu_torch.train.trainer import Trainer

    work = os.path.join(tmp, "prior")
    os.makedirs(work)
    rec = {"aux": []}

    def spy_corpus(build):
        def f(*a, **k):
            t0 = time.perf_counter()
            out = build(*a, **k)
            torch.cuda.synchronize()
            rec["corpus_s"] = time.perf_counter() - t0
            rec["corpus"] = out
            return out
        return f

    def spy_step(make):
        def f(*a, **k):
            step = make(*a, **k)

            def g(*a2, **k2):
                if not rec["aux"]:
                    torch.cuda.synchronize()
                    rec["t0"] = time.perf_counter()
                aux = step(*a2, **k2)
                rec["aux"].append(aux)
                return aux
            return g
        return f

    def spy_save(save):
        def f(*a, **k):
            torch.cuda.synchronize()
            rec["t1"] = time.perf_counter()
            return save(*a, **k)
        return f

    spies = [((tpre, "build_corpus", None), spy_corpus),
             ((tpre, "make_prior_train_step", None), spy_step),
             ((cli_pretrain, "save_prior", None), spy_save)]
    wrap = {name: spy for (_, name, _), spy in spies}
    cwd = os.getcwd()
    os.chdir(work)
    try:
        with substituted(lambda fn, _: wrap[fn.__name__](fn),
                         [site for site, _ in spies]):
            zero_counts()
            params, history = cli_pretrain.main(
                ["--steps", str(PRIOR_STEPS)])
            torch.cuda.synchronize()
            launches = read_counts()
    finally:
        os.chdir(cwd)
    pcfg = tpre.PriorConfig(steps=PRIOR_STEPS)
    expect = expected_counts(launches, {"select_knn": 1}, PRIOR_STEPS,
                             "select_knn_packed")
    if launches != expect or len(rec["aux"]) != PRIOR_STEPS:
        fail(f"pretrain: launches {launches} != {expect} over "
             f"{len(rec['aux'])} steps")
    sdf = torch.stack([a["sdf_l1"] for a in rec["aux"]]).cpu().numpy()
    loss = torch.stack([a["loss"] for a in rec["aux"]]).cpu().numpy()
    cov = torch.stack([a["coverage"] for a in rec["aux"]]).cpu().numpy()
    if not np.isfinite(loss).all():
        fail("pretrain: a non-finite loss")
    if not sdf[-50:].mean() < sdf[:50].mean():
        fail("pretrain: sdf_l1 did not fall")
    steps_s = PRIOR_STEPS / (rec["t1"] - rec["t0"])
    log(f"pretrain: {pcfg.n_shapes} shapes x {pcfg.n_surface_cap} points, "
        f"{pcfg.n_query} queries, batches of {pcfg.batch_queries}; corpus "
        f"built in {rec['corpus_s']:.2f} s; {PRIOR_STEPS} of {20000} steps "
        f"at {steps_s:.2f} steps/s ({1e3 / steps_s:.2f} ms/step); sdf_l1 "
        f"{sdf[:50].mean():.5f} -> {sdf[-50:].mean():.5f} (first and last "
        f"50 steps), coverage {cov[-50:].mean():.3f}; history {history}; "
        f"launches {launches} [{smi}]")

    # one step of the trained parameters, K1 against its plain version
    corpus, spec = rec["corpus"]
    qidx = torch.randperm(pcfg.n_query, device="cuda",
                          generator=torch.Generator(device="cuda")
                          .manual_seed(3))[:pcfg.batch_queries]

    def one():
        lo, aux = tpre.prior_loss(params, corpus, spec, pcfg, 1, qidx)
        return lo, torch.autograd.grad(lo, flatten(params))

    lk, gk = one()
    with plain_versions():
        lp, gp = one()
    lk, lp = float(lk.detach()), float(lp.detach())
    rel = max(float(torch.linalg.vector_norm(a - b)
                    / (torch.linalg.vector_norm(b) + 1e-30))
              for a, b in zip(gk, gp))
    dl = abs(lk - lp) / abs(lp)
    log(f"pretrain step, K1 vs its plain version: loss {lk:.6g} "
        f"(relative difference {dl:.2e}), gradients (decoder, latents) "
        f"relative L2 at most {rel:.2e}")
    if not all(bool(torch.isfinite(g).all()) for g in gk):
        fail("pretrain: a gradient through K1 is not finite")
    # tolerance: the same ids (K1 bit-equal); the latents' gather backward
    # adds in another order on the card
    if dl > 1e-6 or rel > 1e-5:
        fail("pretrain: the step through K1 differs from the plain step")
    del gk, gp, rec

    # the saved prior in a Trainer, one chunk rendered
    out = os.path.join(work, cli_pretrain.DEFAULT_OUT + ".npz")
    tr = Trainer(cfg, pts, cols, views, device="cuda")
    tr.load_frozen(tpre.load_prior(out, "cuda"))
    if not all(torch.equal(a, b.detach()) for a, b in zip(
            flatten(tr.frozen), flatten(tpre.frozen_params(params)))):
        fail("pretrain: the saved prior does not load back bit-equal")
    _, _, _, sel = first_chunk(tr.scene, view, cfg, tr.device)
    uv = np.asarray(view["uv"])[sel.cpu().numpy()]
    zero_counts()
    img = tr.render_image(uv, view["pose"], view["intrinsics"])
    torch.cuda.synchronize()
    launches_render = read_counts()
    expect = render_counts(tr, uv, view["pose"], view["intrinsics"],
                           launches_render, "select_knn_packed")
    if launches_render != expect:
        fail(f"pretrain: the chunk render launched {launches_render}, "
             f"expected {expect}")
    if not all(np.isfinite(v.astype(np.float64)).all()
               for v in img.values()):
        fail("pretrain: the chunk rendered with the pretrained prior is "
             "not finite")
    log(f"pretrain: the saved prior rendered {len(uv)} rays (hit "
        f"{int(img['ray_mask'].sum())}); launches {launches_render}")
    opt = tpre.PriorOptimizer(pcfg)
    step = tpre.make_prior_train_step(pcfg, spec, opt, device="cuda")
    state = opt.init(params)
    pprof = profiled(lambda: [step(params, state, corpus)
                              for _ in range(PROFILE_STEPS)])
    pprof["ms_per_step"] = pprof["profiled_wall_ms"] / PROFILE_STEPS
    log(f"train profile pretrain: {json.dumps(pprof)} [{smi}]")
    del tr, params
    torch.cuda.empty_cache()
    return launches, launches_render


def dust3r_pair_flops(cfg):
    """Products of one DUSt3R pair (two encodes, both decoders, both
    heads): 2 flops a multiply-add, attention's two products included."""
    n = cfg.n_tokens
    de, dd = cfg.enc_dim, cfg.dec_dim
    enc = (2 * n * 3 * cfg.patch ** 2 * de
           + cfg.enc_depth * (24 * n * de * de + 4 * n * n * de))
    dec = cfg.dec_depth * (32 * n * dd * dd + 8 * n * n * dd)
    heads = 2 * n * dd * cfg.patch ** 2 * 4
    return 2 * enc + 2 * (2 * n * de * dd) + 2 * dec + 2 * heads


def prep_profile(fn):
    """:func:`profiled` without the port's kernels' groups (the prep path
    launches none)."""
    prof = profiled(fn)
    return {k: v for k, v in prof.items()
            if k not in ("kernel_ms", "kernel_parts_ms")}


def prep_phase(smi, tmp):
    """Phase 22: point-cloud prep through ``cli.prep_pointcloud.main`` at
    ``Dust3rConfig()``'s full width on the first three images of phase
    15's scan under ``tmp`` (576x768 PNGs, resized to 384x512 by the
    CLI).  A checkpoint of random weights in the upstream key layout
    (``prep.dust3r_net.random_dust3r_state``, seeded) is written as f16.
    First one pair through the network on the card against the CPU (each
    output within PREP_TOL of its scale); then the CLI with ``--device cuda
    --conf PREP_CONF`` (counters set to 0 just before it), its parts timed
    by spies.  It fails unless every output is finite, the three pairs ran,
    the alignment's losses are finite, points survive the filter and the
    subsample, no TPU-kernel counterpart was launched (this path has
    none), the alignment loop run again on the CLI's pointmaps makes no
    host sync, and the ``.ply`` and ``.json`` read back with the counts
    printed."""
    import numpy as np
    import torch

    from spurfies_tpu_torch.cli import prep_pointcloud as cli_prep
    from spurfies_tpu_torch.data.ply import load_ply
    from spurfies_tpu_torch.data.scene_data import glob_images, load_image
    from spurfies_tpu_torch.prep import alignment, pointcloud
    from spurfies_tpu_torch.prep import dust3r_net as dn

    t_phase = time.perf_counter()
    cfg = dn.Dust3rConfig()
    work = os.path.join(tmp, "prep")
    os.makedirs(work)
    ckpt = os.path.join(work, "dust3r.pth")
    t0 = time.perf_counter()
    state = dn.random_dust3r_state(cfg, seed=0, dtype=torch.float16)
    n_params = sum(v.numel() for v in state["model"].values())
    make_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    torch.save(state, ckpt)
    save_s = time.perf_counter() - t0
    del state
    log(f"prep: random DUSt3R checkpoint at Dust3rConfig() (encoder "
        f"{cfg.enc_depth} x {cfg.enc_dim}, decoders 2 x {cfg.dec_depth} x "
        f"{cfg.dec_dim}, images {cfg.img_size}): {n_params:,} parameters, "
        f"drawn in {make_s:.2f} s, written as f16 "
        f"({os.path.getsize(ckpt) / 2 ** 30:.3f} GiB) in {save_s:.2f} s")

    images = os.path.join(tmp, "data", "dtu", "scan24", "image")
    paths = glob_images(images)[:3]
    imgs = [torch.from_numpy(load_image(p, cfg.img_size) * 2.0 - 1.0)
            for p in paths]

    # one pair on the card against the CPU, the same weights and images
    net_cpu = dn.convert_dust3r(ckpt, cfg)
    net = dn.Dust3rNet(net_cpu.params, cfg).to("cuda")
    a, b = imgs[0].cuda(), imgs[1].cuda()
    out_dev = net(a, b)
    pair_ms = cuda_ms(lambda: net(a, b), 3)
    t0 = time.perf_counter()
    out_cpu = net_cpu(imgs[0], imgs[1])
    cpu_s = time.perf_counter() - t0
    flops = dust3r_pair_flops(cfg)
    errs = {}
    for k, ref in out_cpu.items():
        scale = float(ref.abs().max())
        errs[k] = float((out_dev[k].cpu() - ref).abs().max()) / scale
    log(f"prep: pair (0, 1) on the card {pair_ms:.2f} ms "
        f"({flops / 1e12:.3f} TFLOP, {flops / pair_ms / 1e9:.1f} TFLOP/s; "
        f"f32 bound {flops / PEAK_F32_FLOPS * 1e3:.2f} ms), on the CPU "
        f"{cpu_s:.2f} s; max abs err by output, over its scale: "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f" (limit {PREP_TOL:g}: f32, TF32 off) [{smi}]")
    if not all(bool(torch.isfinite(v).all()) for v in out_dev.values()):
        fail("prep: the network's outputs on the card are not finite")
    if not max(errs.values()) <= PREP_TOL:
        fail("prep: the network on the card differs from the CPU")
    log(f"profile prep pair: {json.dumps(prep_profile(lambda: net(a, b)))} "
        f"[{smi}]")
    del net, net_cpu, out_dev, out_cpu, a, b
    torch.cuda.empty_cache()

    rec = {"convert_s": [], "pair_ms": [], "filter": [], "subsample": []}

    def spy_convert(fn):
        def f(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            rec["convert_s"].append(time.perf_counter() - t0)
            return out
        return f

    def spy_pair(fn):
        def f(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            rec["pair_ms"].append((time.perf_counter() - t0) * 1e3)
            return out
        return f

    def spy_align(fn):
        def f(*a, **k):
            rec["align_in"] = (a, k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            rec["align_s"] = time.perf_counter() - t0
            rec["align"] = out
            return out
        return f

    def spy_filter(fn):
        def f(points, *a, **k):
            out = fn(points, *a, **k)
            rec["filter"].append((len(points), len(out[0])))
            return out
        return f

    def spy_subsample(fn):
        def f(points, *a, **k):
            t0 = time.perf_counter()
            keep = fn(points, *a, **k)
            rec["subsample"].append((len(points), len(keep),
                                     time.perf_counter() - t0))
            return keep
        return f

    wrap = {"convert_dust3r": spy_convert, "infer_pair": spy_pair,
            "align_pointmaps": spy_align,
            "filter_by_confidence": spy_filter,
            "radius_dedup": spy_subsample}
    sites = [(cli_prep, "convert_dust3r", None), (dn, "infer_pair", None),
             (cli_prep, "align_pointmaps", None),
             (pointcloud, "filter_by_confidence", None),
             (pointcloud, "radius_dedup", None)]
    out_root = os.path.join(work, "out")
    args = ["--scan", "prep24", "--images", images, "--ckpt", ckpt,
            "--out-root", out_root, "--conf", str(PREP_CONF),
            "--device", "cuda"]
    base = torch.cuda.memory_allocated()
    with substituted(lambda fn, _: wrap[fn.__name__](fn), sites):
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        res = cli_prep.main(args)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = read_counts()
    peak = torch.cuda.max_memory_allocated()

    n_pts = 3 * cfg.img_size[0] * cfg.img_size[1]
    losses = rec["align"]["losses"]
    [(n_in, n_conf)] = rec["filter"]
    [(n_sub_in, n_kept, sub_s)] = rec["subsample"]
    log(f"prep: CLI end to end {cli_s:.2f} s: weights loaded and converted "
        f"in {rec['convert_s'][0]:.2f} s; pairs "
        + ", ".join(f"{ms:.2f}" for ms in rec["pair_ms"])
        + f" ms; alignment {rec['align_s']:.3f} s "
        f"({len(losses)} iterations, loss {losses[0]:.6g} -> "
        f"{losses[-1]:.6g}); confidence filter (>= {PREP_CONF}) kept "
        f"{n_conf:,} of {n_in:,} points ({n_conf / n_in:.4f}); subsample "
        f"(0.025) kept {n_kept:,} in {sub_s:.3f} s; peak device memory "
        f"{peak / 2 ** 30:.3f} GiB ({base / 2 ** 30:.3f} allocated before "
        f"the CLI) [{smi}]")
    if any(launches.values()):
        fail(f"prep: the prep path launched TPU-kernel counterparts "
             f"{launches}")
    log(f"prep: launches of the TPU-kernel counterparts {launches} (this "
        f"path runs none of them)")
    if len(rec["pair_ms"]) != 3 or n_in != n_pts:
        fail(f"prep: {len(rec['pair_ms'])} pairs, {n_in} points")
    if not np.isfinite(losses).all():
        fail("prep: an alignment loss is not finite")
    if not (0 < n_kept <= n_conf == n_sub_in):
        fail("prep: no point survived the filter and the subsample")

    # the alignment loop again on the CLI's pointmaps: no host sync in it
    a, k = rec["align_in"]
    st = alignment.init_alignment(a[0], *a[1:5], k["n_views"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    syncs = syncs_in(lambda: alignment.run_alignment(st, k["cfg"]))
    loop_s = time.perf_counter() - t0
    log(f"prep: host syncs in the alignment loop ({k['cfg'].iters} "
        f"iterations, {loop_s:.3f} s alone): {len(syncs)}"
        + (f" (first: {syncs[0]})" if syncs else ""))
    if syncs:
        fail("prep: the alignment loop waits on the card")
    st = alignment.init_alignment(a[0], *a[1:5], k["n_views"])
    aprof = prep_profile(lambda: alignment.run_alignment(
        st, alignment.AlignConfig(iters=20)))
    log(f"profile prep alignment (20 iterations): {json.dumps(aprof)} "
        f"[{smi}]")
    del st, rec

    # the exported scene read back
    out_dir = res["out_dir"]
    pts, cols = load_ply(os.path.join(out_dir, "prep24.ply"))
    with open(os.path.join(out_dir, "prep24.json")) as f:
        meta = json.load(f)
    mats = np.asarray([fr["transform_matrix"] for fr in meta["frames"]])
    if (len(pts) != n_kept or cols is not None
            or not np.isfinite(pts).all() or mats.shape != (3, 4, 4)
            or not np.isfinite(mats).all()
            or (meta["w"], meta["h"]) != (512, 384)):
        fail(f"prep: the exported scene reads back wrong ({len(pts)} "
             f"points, frames {mats.shape})")
    log(f"prep: read back {len(pts):,} points (range "
        f"{pts.min():.4f} .. {pts.max():.4f}) and {len(mats)} cameras; "
        f"phase wall {time.perf_counter() - t_phase:.2f} s [{smi}]")
    torch.cuda.empty_cache()


def stderr_lines(fn):
    """``fn()`` with this process's file descriptor 2 sent to a file; the
    lines written there.  A C++ warning raised on a thread that Python
    does not run (gloo's workers) goes there, not to ``warnings``."""
    sys.stderr.flush()
    saved = os.dup(2)
    with tempfile.TemporaryFile(mode="w+") as f:
        os.dup2(f.fileno(), 2)
        try:
            fn()
        finally:
            sys.stderr.flush()
            os.dup2(saved, 2)
            os.close(saved)
        f.seek(0)
        return f.read().splitlines()


def dp_dust3r(group, steps):
    """Phase 23 on one rank of ``group`` (a ``parallel.launch`` rank): a
    ``Trainer`` on dust3r_like at the default config, sharded over the
    group, with the repo's prior.  Returns its parameters after
    DP_PARITY_STEPS steps, the host syncs of two more (those ``syncs_in``
    reads, and those the sync debug mode reports on the collectives' own
    threads), then ``steps`` timed steps in windows of DP_WINDOW: their
    ms/step, the whole batch's metrics (the parity steps' first), this
    rank's launches and the parameters after them; then PROFILE_STEPS
    steps, under ``torch.profiler`` on rank 0 (its device time, and the
    host and device time of each collective and copy)."""
    import torch

    from spurfies_tpu_torch.config import Config, apply_overrides
    from spurfies_tpu_torch.convert.from_jax import PRIOR_ASSET, load_prior_npz
    from spurfies_tpu_torch.data.synthetic import make_dust3r_like_scene
    from spurfies_tpu_torch.train.optim import flatten
    from spurfies_tpu_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False   # as the parent's
    torch.backends.cudnn.allow_tf32 = False
    cfg = apply_overrides(Config(), [f"train.data_parallel={group.world}"])
    pts, cols, views = make_dust3r_like_scene()
    tr = Trainer(cfg, pts, cols, views, group=group)
    tr.load_frozen(load_prior_npz(PRIOR_ASSET, device=group.device))
    hist = []
    tr.run(DP_PARITY_STEPS, window=1,
           callback=lambda s_, m: hist.append((s_, m)))
    early = [p.detach().clone() for p in flatten(tr.state.params)]
    box = []
    lines = stderr_lines(lambda: box.append(count_host_syncs(tr, 2)))
    n_sync, first_sync = box[0]
    threads = sum("called a synchronizing CUDA operation" in ln
                  for ln in lines)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.run(steps, window=DP_WINDOW,
           callback=lambda s_, m: hist.append((s_, m)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    prof = None
    if group.lead:
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as p:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            tr.run(PROFILE_STEPS, window=PROFILE_STEPS)
            torch.cuda.synchronize()
            p_ms = (time.perf_counter() - t1) * 1e3
        prof = profile_summary(p, p_ms)
        prof["ms_per_step"] = p_ms / PROFILE_STEPS
        prof["collectives"] = {
            e.key: {"calls": e.count, "host_ms": e.cpu_time_total / 1e3,
                    "device_ms": e.device_time_total / 1e3}
            for e in p.key_averages()
            if any(t in e.key.lower() for t in (
                "all_reduce", "allreduce", "gloo", "nccl", "memcpy"))}
    else:
        tr.run(PROFILE_STEPS, window=PROFILE_STEPS)
    mc = tr.cfg.model
    return {"early": early, "syncs": n_sync, "first_sync": first_sync,
            "profile": prof,
            "thread_syncs": threads,
            "ms": wall / steps * 1e3, "hist": hist, "launches": launches,
            "params": [p.detach() for p in flatten(tr.state.params)],
            "budgets": (mc.ray_budget_frac, mc.probe_budget_frac),
            "backend": group.backend}


def dp_val_uv(trainer):
    """The validation render's rays of ``cli.train.train_scene`` (view 0 at
    a quarter of CLI_RES)."""
    h, w = CLI_RES
    return trainer.views["uv"].cpu().numpy().reshape(h, w, 2)[::4, ::4] \
        .reshape(-1, 2)


def dp_cli(group, args, ov):
    """Phase 23's training CLI on one rank: ``cli.train.main`` at
    ``train.data_parallel=2`` (this process is a rank already, so it
    trains here) for DP_CLI_STEPS steps, then ``--resume`` for
    DP_CLI_RESUME more, the step each restore starts from recorded; the
    experiment's directories and checkpoints after each call, the
    parameters at the end and the gathered validation render of them."""
    import torch

    from spurfies_tpu_torch.cli import train as cli_train
    from spurfies_tpu_torch.train.optim import flatten
    from spurfies_tpu_torch.train.trainer import Trainer

    def listing(exp):
        return (sorted(os.listdir(os.path.dirname(exp.dir))),
                sorted(os.listdir(exp.ckpt_dir)))

    [(tr, exp)] = cli_train.main(args + ov + [f"train.opt_steps="
                                              f"{DP_CLI_STEPS}"])
    first = listing(exp)
    del tr
    torch.cuda.empty_cache()
    restored = []

    def spy(restore):
        def f(self, path):
            restore(self, path)
            restored.append(int(self.state.step))
        return f

    with substituted(lambda fn, _: spy(fn),
                     [(Trainer, "restore_checkpoint", None)]):
        [(tr, exp2)] = cli_train.main(
            ["--resume"] + args + ov
            + [f"train.opt_steps={DP_CLI_STEPS + DP_CLI_RESUME}"])
    render = tr.render_image(dp_val_uv(tr), tr.views["pose"][0],
                             tr.views["intrinsics"][0])
    return {"first": first, "resumed": listing(exp2), "restored": restored,
            "same_dir": exp.dir == exp2.dir, "step": int(tr.state.step),
            "latest": exp2.checkpoint_path("latest"), "render": render,
            "params": [p.detach() for p in flatten(tr.state.params)]}


def dp_rank(group, args, ov):
    """Phase 23's two-rank run: :func:`dp_dust3r`, then :func:`dp_cli`."""
    return {"dust3r": dp_dust3r(group, DP_STEPS),
            "cli": dp_cli(group, args, ov)}


def dp_phase(smi, tmp, cfg, pts, cols, views, prior):
    """Phase 23 (see the module's docstring).  The ranks are processes of
    their own; every kernel launch of theirs is counted there, and the
    kernels line keeps this process's counts."""
    import numpy as np
    import torch

    from spurfies_tpu_torch.cli import train as cli_train
    from spurfies_tpu_torch.config import apply_overrides, load_yaml
    from spurfies_tpu_torch.parallel.launch import launch
    from spurfies_tpu_torch.train.optim import flatten
    from spurfies_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    args = ["--config", os.path.join(here, "configs", "dtu_pn.yaml"),
            "--scans", "scan24"]
    ov = [f"dataset.data_dir_root={os.path.join(tmp, 'data')}",
          f"exps_folder={os.path.join(tmp, 'exps_dp')}",
          f"train.render_freq={CLI_EVERY}",
          f"train.checkpoint_freq={CLI_EVERY}"]
    try:
        t0 = time.perf_counter()
        r0, r1 = launch(dp_rank, 2, args, ov + ["train.data_parallel=2"],
                        devices=("cuda:0", "cuda:0"))
        wall_gloo = time.perf_counter() - t0
        t0 = time.perf_counter()
        [nccl] = launch(dp_dust3r, 1, DP_NCCL_STEPS, devices=("cuda:0",))
        wall_nccl = time.perf_counter() - t0
    except RuntimeError as e:
        fail(f"data_parallel: {e}")
    d0, d1 = r0["dust3r"], r1["dust3r"]
    log(f"data_parallel: two ranks on cuda:0 over {d0['backend']} in "
        f"{wall_gloo:.2f} s (spawn, scene, {DP_PARITY_STEPS} + 2 + "
        f"{DP_STEPS} steps, the CLI's two calls), one rank over "
        f"{nccl['backend']} in {wall_nccl:.2f} s [{smi}]")
    if d0["backend"] != "gloo" or nccl["backend"] != "nccl":
        fail("data_parallel: the ranks did not get gloo and NCCL")

    # the two ranks against a dp=1 Trainer of the same seed: each parity
    # step's whole-batch loss parts, and the parameters after them
    tr = Trainer(cfg, pts, cols, views, device="cuda")
    tr.load_frozen(prior)
    one = []
    tr.run(DP_PARITY_STEPS, window=1,
           callback=lambda s_, m: one.append((s_, m)))
    for (step, a), (step_2, b) in zip(one, d0["hist"][:DP_PARITY_STEPS]):
        rel = {k: abs(a[k] - b.get(k, math.inf)) / max(abs(a[k]), 1e-30)
               for k in a}
        log(f"data_parallel: step {step}'s loss parts, dp=2 against dp=1, "
            f"relative: " + json.dumps({k: float(f"{v:.3g}")
                                        for k, v in rel.items()}))
        if step != step_2 or set(a) != set(b) or any(
                abs(a[k] - b[k]) > DP_PARTS_RTOL * abs(a[k]) + 1e-12
                for k in a):
            fail(f"data_parallel: step {step}'s loss parts at dp=2 are not "
                 f"dp=1's within {DP_PARTS_RTOL} relative")
    tp = tr.state.params
    names = [f"{k}[{i}]" for k in tp for i in range(len(flatten(tp[k])))]
    diff = {n: float(np.abs(p.detach().cpu().numpy() - q).max())
            for n, p, q in zip(names, flatten(tp), d0["early"])}
    del tr
    lr = cfg.train.learning_rate
    log(f"data_parallel: after {DP_PARITY_STEPS} steps, largest difference "
        f"of each leaf from dp=1: " + json.dumps(
            {k: float(f"{v:.3g}") for k, v in diff.items()}))
    if max(diff.values()) > DP_LEAF_LR * lr:
        fail(f"data_parallel: a leaf at dp=2 is more than {DP_LEAF_LR} lr "
             "from dp=1's")
    rank_diff = max(float(np.abs(p - q).max()) for p, q in zip(
        d0["early"] + d0["params"], d1["early"] + d1["params"]))
    log(f"data_parallel: the two ranks' largest parameter difference "
        f"{rank_diff}")
    if rank_diff != 0:
        fail("data_parallel: the ranks' parameters differ")

    # the timed steps
    for tag, d in (("gloo, 2 ranks", d0), ("nccl, 1 rank", nccl)):
        for step, m in d["hist"]:
            log(f"  {tag} step {step}: " + ", ".join(
                f"{k} {m[k]:.5g}" for k in (
                    "loss", "rgb_loss", "eikonal_loss", "mask_loss",
                    "pseudo_loss", "tv_loss", "psnr", "ray_overflow",
                    "probe_overflow", "notfinite")))
        hist = [m for _, m in d["hist"]]
        if not all(np.isfinite(m["loss"]) and m["notfinite"] == 0
                   for m in hist):
            fail(f"data_parallel ({tag}): a non-finite loss or a skipped "
                 "step")
    if not d0["hist"][-1][1]["rgb_loss"] < d0["hist"][0][1]["rgb_loss"]:
        fail("data_parallel: rgb_loss did not fall on two ranks")
    for tag, d, steps in (("rank 0", d0, DP_STEPS),
                          ("rank 1", d1, DP_STEPS),
                          ("nccl rank", nccl, DP_NCCL_STEPS)):
        expect = expected_counts(d["launches"], PER_STEP, steps,
                                 "select_knn_packed")
        log(f"data_parallel: {tag} launched {d['launches']} in {steps} "
            "steps")
        if d["launches"] != expect:
            fail(f"data_parallel: {tag} launched {d['launches']}, expected "
                 f"{expect}")
    log(f"data_parallel: ms/step {d0['ms']:.2f} (2 ranks on one card, "
        f"gloo), {nccl['ms']:.2f} (1 rank, NCCL), "
        f"{TIMED['dust3r_like']:.2f} (phase 10, unsharded); host syncs in 2 "
        f"steps, on the step's thread and on the collectives' threads: gloo "
        f"rank 0 {d0['syncs']} and {d0['thread_syncs']}, rank 1 "
        f"{d1['syncs']} and {d1['thread_syncs']}"
        + (f" (first: {d0['first_sync']})" if d0["syncs"] else "")
        + f", NCCL {nccl['syncs']} and {nccl['thread_syncs']}; auto budgets "
        f"{tuple(float(b) for b in d0['budgets'])} [{smi}]")
    for tag, d in (("gloo, 2 ranks", d0), ("nccl, 1 rank", nccl)):
        log(f"data_parallel profile ({tag}, rank 0, {PROFILE_STEPS} "
            f"steps): {json.dumps(d['profile'])}")
    if nccl["syncs"] or nccl["thread_syncs"]:
        fail(f"data_parallel: the NCCL step waits on the card "
             f"({nccl['first_sync']})")

    # the training CLI on the two ranks
    c0, c1 = r0["cli"], r1["cli"]
    log(f"data_parallel: cli first call: experiments {c0['first'][0]}, "
        f"checkpoints {c0['first'][1]}; resume restored at "
        f"{c0['restored']}, {c1['restored']}, ended at step {c0['step']}, "
        f"checkpoints {c0['resumed'][1]}")
    if (len(c0["first"][0]) != 1 or c0["first"][1] != [str(DP_CLI_STEPS),
                                                      "latest"]
            or c0["restored"] != [DP_CLI_STEPS] or c1["restored"]
            != [DP_CLI_STEPS] or not c0["same_dir"]
            or c0["step"] != DP_CLI_STEPS + DP_CLI_RESUME
            or c0["resumed"] != ([c0["first"][0][0]], sorted(
                [str(DP_CLI_STEPS), str(DP_CLI_STEPS + DP_CLI_RESUME),
                 "latest"]))):
        fail("data_parallel: the CLI's experiment, checkpoints or resume "
             "are not what one dp=1 run writes")
    rank_diff = max(float(np.abs(p - q).max())
                    for p, q in zip(c0["params"], c1["params"]))
    if rank_diff != 0:
        fail("data_parallel: the CLI ranks' parameters differ")
    ccfg = apply_overrides(load_yaml(args[1]), ov)
    sd = cli_train.load_scene_data(ccfg, "scan24")
    tr = Trainer(ccfg, sd.points, sd.colors, sd.train_views(),
                 device="cuda", compute_dtype=getattr(torch, CLI_DTYPE))
    tr.restore_checkpoint(c0["latest"])
    one = tr.render_image(dp_val_uv(tr), tr.views["pose"][0],
                          tr.views["intrinsics"][0])
    del tr, sd
    torch.cuda.empty_cache()
    for r, c in ((0, c0), (1, c1)):
        stats = compare_chunk({k: torch.as_tensor(v) for k, v in
                               c["render"].items()},
                              {k: torch.as_tensor(v) for k, v in one.items()})
        log(f"data_parallel: rank {r}'s gathered validation render of "
            f"{len(one['ray_mask'])} rays vs dp=1's of the same checkpoint: "
            f"{json.dumps(stats)}")
    log(f"data_parallel: phase wall {time.perf_counter() - t_phase:.2f} s "
        f"[{smi}]")


def validate_gate(got, ref=None):
    """Phase 24's rule: the port's sphere within the margins of the JAX
    package's (``JAX_VALIDATE``) -- masked PSNR at least JAX's less
    VALIDATE_PSNR_MARGIN dB, ``mesh_mean_radius_err`` at most JAX's plus
    VALIDATE_RADIUS_MARGIN (a NaN, an empty mesh, fails both)."""
    ref = ref or JAX_VALIDATE
    floor = ref["masked_psnr"] - VALIDATE_PSNR_MARGIN
    ceil = ref["mesh_mean_radius_err"] + VALIDATE_RADIUS_MARGIN
    if not got["masked_psnr"] >= floor:
        fail(f"validate: masked PSNR {got['masked_psnr']} below {floor} "
             f"(JAX {ref['masked_psnr']} - {VALIDATE_PSNR_MARGIN})")
    if not got["mesh_mean_radius_err"] <= ceil:
        fail(f"validate: mean radius error {got['mesh_mean_radius_err']} "
             f"above {ceil} (JAX {ref['mesh_mean_radius_err']} + "
             f"{VALIDATE_RADIUS_MARGIN})")


def spy_probe_grid(rec):
    """A spy on ``mesh_extract.probe_grid`` (by name, for
    :class:`substituted`) that appends each call's chunks and launches to
    ``rec["probe"]``."""
    import torch

    def make(fn):
        def f(sdf_fn, axes, chunk=EVAL_CHUNK):
            torch.cuda.synchronize()
            before = read_counts()
            vals = fn(sdf_fn, axes, chunk)
            torch.cuda.synchronize()
            after = read_counts()
            n = math.prod(int(a.shape[0]) for a in axes)
            rec["probe"].append((-(-n // chunk), {k: after[k] - before[k]
                                                  for k in after}))
            return vals
        return f
    return make


def held_launches(tag, rec, launches, knn, per_step, extra=None):
    """Hold ``launches`` (one run's, counters from 0) to what its parts
    fix: one K1 in each ``Trainer`` build, ``per_step`` a training step,
    each render's chunking (:func:`render_counts`), chunks x (K1 + K2) in
    each mesh probe, plus ``extra``; ``rec`` as :func:`trainer_spies` and
    :func:`spy_probe_grid` fill it.  Clears ``rec``'s lists."""
    parts = dict.fromkeys(launches, 0)

    def add(delta):
        for k in parts:
            parts[k] += delta[k]
    for delta in rec["init"]:
        if delta != expected_counts(delta, {"select_knn": 1}, 1, knn):
            fail(f"{tag}: a Trainer's build launched {delta}")
        add(delta)
    steps = sum(r[0] for r in rec["run"])
    add(expected_counts(launches, per_step, steps, knn))
    for tr, uv, pose, K, _, delta in rec["render"]:
        want = render_counts(tr, uv, pose, K, delta, knn)
        if delta != want:
            fail(f"{tag}: a render launched {delta}, expected {want}")
        add(delta)
    for chunks, delta in rec["probe"]:
        want = expected_counts(delta, {"select_knn": 1,
                                       "pair_sdf_value_agg": 1}, chunks, knn)
        if delta != want:
            fail(f"{tag}: a mesh probe of {chunks} chunks launched {delta}, "
                 f"expected {want}")
        add(delta)
    if extra:
        add(extra)
    if launches != parts:
        fail(f"{tag}: launched {launches}, expected {parts} (builds "
             f"{len(rec['init'])}, {steps} steps, {len(rec['render'])} "
             f"renders, {len(rec['probe'])} probes)")
    log(f"{tag}: launches {launches} = {len(rec['init'])} builds + {steps} "
        f"steps + {len(rec['render'])} renders + {len(rec['probe'])} mesh "
        "probes" + (f" + {extra}" if extra else ""))
    for key in ("init", "run", "render", "render_ms", "probe"):
        rec[key].clear()
    return steps


def validate_phase(smi):
    """Phase 24: the port's ``scripts.validate_pipeline`` on the card at
    VALIDATE_STEPS steps (counters set to 0 just before it): the launches
    (steps x PER_STEP, one K1 in the build, both mesh probes, the
    calibration's probe and view 0's render), then ``validate_gate``
    against the JAX package's CPU run."""
    import torch

    from spurfies_tpu_torch.eval import mesh_extract
    from spurfies_tpu_torch.scripts import validate_pipeline
    from spurfies_tpu_torch.train.trainer import Trainer

    rec = {"init": [], "run": [], "render": [], "render_ms": [],
           "probe": []}
    spies = dict(trainer_spies(rec), probe_grid=spy_probe_grid(rec))
    sites = [(Trainer, name, None) for name in ("__init__", "run",
                                                "render_image")]
    sites.append((mesh_extract, "probe_grid", None))
    with substituted(lambda fn, _: spies[fn.__name__](fn), sites):
        zero_counts()
        t0 = time.perf_counter()
        got = validate_pipeline.main(["--steps", str(VALIDATE_STEPS),
                                      "--resolution", str(VALIDATE_RES)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
    knn = "select_knn_packed"
    trainer = rec["render"][0][0]
    if not 0 < trainer.scene.table.n_points <= 2 ** 15:
        fail("validate: the sphere does not select the packed K1")
    if got["prior"] != "pretrained" or len(rec["probe"]) != 2:
        fail(f"validate: prior {got['prior']}, {len(rec['probe'])} mesh "
             "probes (expected the repo's prior and 2)")
    steps = held_launches("validate", rec, launches, knn, PER_STEP,
                          extra=expected_counts(launches, {
                              "select_knn": 1, "pair_sdf_value_agg": 1}, 1,
                              knn))
    if steps != VALIDATE_STEPS:
        fail(f"validate: {steps} steps, expected {VALIDATE_STEPS}")
    log(f"validate: {json.dumps(got)}; JAX (CPU) {json.dumps(JAX_VALIDATE)};"
        f" margins -{VALIDATE_PSNR_MARGIN} dB, +{VALIDATE_RADIUS_MARGIN}; "
        f"phase wall {wall:.2f} s [{smi}]")
    validate_gate(got)
    del trainer
    torch.cuda.empty_cache()


def chain_phase(smi, tmp):
    """Phase 25: the port's ``scripts.acceptance_chain`` through its
    ``main`` in ``tmp`` at CHAIN_STEPS steps, the mesh at CHAIN_MESH_RES and
    CHAIN_VIEWS views: ``--stop-at CHAIN_STOP``, then ``--resume`` (counters
    set to 0 just before each).  It holds each call's launches, the
    record's keys to ``artifacts/acceptance_chain_r05.json``'s, one
    experiment directory, a non-empty mesh and finite Chamfer, PSNR and
    SSIM."""
    import numpy as np
    import torch

    from spurfies_tpu_torch.eval import mesh_extract
    from spurfies_tpu_torch.scripts import acceptance_chain
    from spurfies_tpu_torch.train.trainer import Trainer

    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(tmp, "chain")
    out = os.path.join(work, "record.json")
    args = ["--steps", str(CHAIN_STEPS), "--mesh-resolution",
            str(CHAIN_MESH_RES), "--max-views", str(CHAIN_VIEWS),
            "--workdir", work, "--out", out]
    rec = {"init": [], "run": [], "render": [], "render_ms": [],
           "probe": []}
    spies = dict(trainer_spies(rec), probe_grid=spy_probe_grid(rec))
    sites = [(Trainer, name, None) for name in ("__init__", "run",
                                                "render_image")]
    sites.append((mesh_extract, "probe_grid", None))
    knn = "select_knn_packed"
    records, t_phase = [], time.perf_counter()
    with substituted(lambda fn, _: spies[fn.__name__](fn), sites):
        for tag, extra, steps, renders in (
                ("stop", ["--stop-at", str(CHAIN_STOP)], CHAIN_STOP, 1),
                ("resume", ["--resume"], CHAIN_STEPS - CHAIN_STOP,
                 1 + CHAIN_VIEWS + 4)):
            zero_counts()
            t0 = time.perf_counter()
            records.append(acceptance_chain.main(args + extra))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_counts()
            tr = rec["render"][0][0]
            if not 0 < tr.scene.table.n_points <= 2 ** 15:
                fail("chain: the DTU scan does not select the packed K1")
            n_render, n_probe = len(rec["render"]), len(rec["probe"])
            got = held_launches(f"chain {tag}", rec, launches, knn, PER_STEP)
            del tr
            if (got, n_render, n_probe) != (steps, renders, tag == "resume"):
                fail(f"chain {tag}: {got} steps, {n_render} renders, "
                     f"{n_probe} probes; expected {steps}, {renders}, "
                     f"{int(tag == 'resume')}")
            log(f"chain {tag}: {wall:.2f} s; stages " + json.dumps(
                records[-1]["stages"]) + f" [{smi}]")
            if tag == "stop" and os.path.exists(out):
                fail("chain: --stop-at wrote the record")
    torch.cuda.empty_cache()

    stop, full = records
    if "nvs" in stop or [(c["from"], c["to"]) for c in stop["stages"][
            "train"]["calls"]] != [(0, CHAIN_STOP)]:
        fail("chain: the --stop-at call evaluated, or trained "
             f"{stop['stages']['train']['calls']}")
    with open(os.path.join(here, "artifacts",
                           "acceptance_chain_r05.json")) as f:
        r05 = json.load(f)
    with open(out) as f:
        written = json.load(f)
    missing = [k for k in r05 if k not in full] + [
        f"{k}.{kk}" for k, v in r05.items() if isinstance(v, dict)
        for kk in v if kk != "note" and kk not in full.get(k, {})]
    if missing or written != json.loads(json.dumps(full)):
        fail(f"chain: the record lacks {missing} of the r05 record's keys, "
             "or differs from the file")
    exps = os.listdir(os.path.join(work, "exps", "dtu_pn_scan24"))
    calls = [(c["from"], c["to"]) for c in full["stages"]["train"]["calls"]]
    if len(exps) != 1 or calls != [(0, CHAIN_STOP),
                                   (CHAIN_STOP, CHAIN_STEPS)]:
        fail(f"chain: experiments {exps}, train calls {calls}")
    nvs, near, cham = full["nvs"], full["nvs_nearviews"], full["chamfer"]
    scores = nvs["psnr"] + nvs["ssim"] + near["psnr"] + near["ssim"] + [
        cham[k] for k in ("acc", "comp", "overall")]
    if not full["mesh"]["n_faces"] or len(nvs["psnr"]) != CHAIN_VIEWS or \
            len(near["psnr"]) != 4 or not np.all(np.isfinite(scores)):
        fail(f"chain: mesh {full['mesh']}, NVS {nvs['psnr']}, near "
             f"{near['psnr']}, Chamfer {cham}")
    rays = full["stages"]["train"]["rays_per_s"]
    log(f"chain: {CHAIN_STEPS} steps ({rays:.1f} train rays/s), mesh "
        f"{full['mesh']} at {CHAIN_MESH_RES}, NVS PSNR "
        f"{nvs['mean_psnr']:.2f} SSIM {nvs['mean_ssim']:.4f}, near PSNR "
        f"{near['mean_psnr']:.2f} SSIM {near['mean_ssim']:.4f}, Chamfer "
        f"{json.dumps(cham)}, probe budget {json.dumps(full['probe_budget'])};"
        f" phase wall {time.perf_counter() - t_phase:.2f} s [{smi}]")


# the JPEG processes the host decoder reads, by SOF marker
JPEG_FRAMES = {0xC0: "baseline", 0xC1: "extended sequential",
               0xC2: "progressive", 0xC3: "lossless",
               0xC9: "arithmetic sequential", 0xCA: "arithmetic progressive"}


def jpeg_frame_kind(data):
    """The file's JPEG process by its SOF marker, and "no DHT" for a
    Huffman file without DHT segments (a Motion-JPEG frame)."""
    pos, dht, kind = 2, False, "no SOF"
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        m = data[pos + 1]
        if m == 0xDA:
            break
        dht |= m == 0xC4
        kind = JPEG_FRAMES.get(m, kind)
        pos += 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
    huffman = kind in ("baseline", "extended sequential", "progressive",
                       "lossless")
    return kind + (", no DHT" if huffman and not dht else "")


def sha256_digest(img):
    """Shape, dtype and SHA-256 of an array's bytes (C order), as
    ``tests/test_torch_jpeg.py`` records them."""
    import hashlib

    import numpy as np
    img = np.ascontiguousarray(img)
    return {"shape": list(img.shape), "dtype": str(img.dtype),
            "sha256": hashlib.sha256(img.tobytes()).hexdigest()}


def jpeg_cli(tag, rec, knn_of, argv, smi):
    """``cli.train.main(argv)`` (counters set to 0 just before it) with its
    launches held (``held_launches``: the build's K1, JPEG_STEPS x
    PER_STEP, each validation render's chunking) and rgb_loss finite and
    falling in its ``metrics.jsonl``.  Returns (ms a step, first and last
    rgb_loss means)."""
    import numpy as np
    import torch

    from spurfies_tpu_torch.cli import train as cli_train

    zero_counts()
    t0 = time.perf_counter()
    [(trainer, exp)] = cli_train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    knn = knn_of(trainer)
    n_pts = trainer.scene.points.shape[0]
    del trainer
    torch.cuda.empty_cache()
    steps = held_launches(f"jpeg {tag}", rec, launches, knn, PER_STEP)
    with open(os.path.join(exp.plots_dir, "logs", "metrics.jsonl")) as f:
        rows = [json.loads(ln) for ln in f]
    losses = [r["rgb_loss"] for r in rows if "rgb_loss" in r]
    part = JPEG_WINDOWS // 3
    first, last = np.mean(losses[:part]), np.mean(losses[-part:])
    log(f"jpeg {tag}: {n_pts} points (K1 {knn.split('_')[-1]}), {steps} "
        f"steps in {wall:.2f} s of CLI; rgb_loss by window "
        + ", ".join(f"{v:.5f}" for v in losses) + f" [{smi}]")
    if steps != JPEG_STEPS or len(losses) != JPEG_WINDOWS:
        fail(f"jpeg {tag}: {steps} steps, {len(losses)} windows")
    if not np.all(np.isfinite(losses)) or not last < first:
        fail(f"jpeg {tag}: rgb_loss not finite or not falling ({first} -> "
             f"{last})")
    return wall / steps * 1e3, first, last


def jpeg_phase(smi, tmp):
    """Phase 26: the fixtures of ``tests/fixtures/jpeg`` decoded on this
    host and held to the hashes that imageio and cv2 gave
    (``hashes.json``), the decoder's ms per megapixel, then the three views
    trained through ``cli.train.main`` as an own-data scene, as mip-NeRF
    ``garden`` and as the scene ``cli.prep_pointcloud`` makes of them."""
    import shutil

    import torch

    from spurfies_tpu_torch.cli import prep_pointcloud as cli_prep
    from spurfies_tpu_torch.data import jpeg
    from spurfies_tpu_torch.data.mip_nerf import TRAIN_FRAMES
    from spurfies_tpu_torch.data.mvs_local import read_bgr
    from spurfies_tpu_torch.data.scene_data import read_image
    from spurfies_tpu_torch.data.synthetic import export_synthetic_own_data
    from spurfies_tpu_torch.eval import mesh_extract
    from spurfies_tpu_torch.prep import dust3r_net as dn
    from spurfies_tpu_torch.train.trainer import Trainer

    here = os.path.dirname(os.path.abspath(__file__))
    t_phase = time.perf_counter()
    fixtures = os.path.join(here, "tests", "fixtures", "jpeg")
    with open(os.path.join(fixtures, "hashes.json")) as f:
        record = json.load(f)
    scene = record["scene"]
    for name, want in sorted(record["files"].items()):
        path = os.path.join(fixtures, name)
        with open(path, "rb") as f:
            data = f.read()
        got = {"imageio": sha256_digest(read_image(path))}
        if want["cv2"] is None:  # cv2 reads nothing: read_bgr must refuse
            try:
                got["cv2"] = sha256_digest(read_bgr(path))
            except ValueError:
                got["cv2"] = None
        else:
            got["cv2"] = sha256_digest(read_bgr(path))
        h, w = want["imageio"]["shape"][:2]
        ms = best_s(lambda: jpeg.decode_jpeg(data),
                    JPEG_DECODE_REPS) * 1e3
        same = {k: "bit-equal to" if got[k] == want[k] else "DIFFERENT from"
                for k in got}
        if want["cv2"] is None:
            same["cv2"] = ("refusing as" if got["cv2"] is None
                           else "reading what refuses in")
        log(f"jpeg: {name} [{jpeg_frame_kind(data)}] {w}x{h} "
            f"({len(data):,} bytes), EXIF "
            f"orientation {jpeg.orientation(data)}: read_image "
            f"{same['imageio']} imageio, read_bgr {same['cv2']} cv2; "
            f"decode {ms:.2f} ms = {ms / (h * w / 1e6):.2f} ms/MP "
            f"(best of {JPEG_DECODE_REPS}, one host thread) [{smi}]")
        if got != want:
            fail(f"jpeg: {name} decodes to {got}, recorded {want}")

    views = sorted(n for n in record["files"] if n.startswith("view_"))
    work = os.path.join(tmp, "jpeg")
    rec = {"init": [], "run": [], "render": [], "render_ms": [],
           "probe": []}
    spies = dict(trainer_spies(rec), probe_grid=spy_probe_grid(rec))
    sites = [(Trainer, name, None) for name in ("__init__", "run",
                                                "render_image")]
    sites.append((mesh_extract, "probe_grid", None))

    def knn_of(trainer):
        return ("select_knn_packed" if 0 < trainer.scene.table.n_points
                <= 2 ** 15 else "select_knn_exact")

    every = JPEG_STEPS // JPEG_WINDOWS
    common = [f"train.opt_steps={JPEG_STEPS}",
              f"train.render_freq={every}",
              f"train.checkpoint_freq={JPEG_STEPS}"]

    def copy_views(dst, names):
        os.makedirs(dst, exist_ok=True)
        for src, name in zip(views, names):
            shutil.copy(os.path.join(fixtures, src), os.path.join(dst, name))

    # (a) own data: the views' scene as export_synthetic_own_data writes it,
    # its PNGs replaced by the committed JPEGs
    own = os.path.join(work, "own")
    export_synthetic_own_data(own, scan=scene["scan"],
                              n_views=scene["n_views"],
                              img_res=tuple(scene["img_res"]),
                              seed=scene["seed"])
    inst = os.path.join(own, "own_data", scene["scan"])
    shutil.rmtree(os.path.join(inst, "image"))
    copy_views(os.path.join(inst, "image"), views)
    runs = {}
    with substituted(lambda fn, _: spies[fn.__name__](fn), sites):
        runs["own_data"] = jpeg_cli("own_data", rec, knn_of, [
            "--config", os.path.join(here, "configs", "own_data.yaml"),
            "--scans", scene["scan"], f"dataset.data_dir_root={own}",
            f"exps_folder={os.path.join(work, 'exps_own')}"] + common, smi)

        # (b) mip-NeRF garden: the same scene, the views under the
        # dataset's names
        mip = os.path.join(work, "mip")
        garden = os.path.join(mip, "mipnerf", "garden")
        names = TRAIN_FRAMES["garden"]
        copy_views(os.path.join(garden, "image"), names)
        with open(os.path.join(inst, f"{scene['scan']}.json")) as f:
            meta = json.load(f)
        for fr, name in zip(meta["frames"], names):
            fr["file_path"] = f"image/{name}"
        with open(os.path.join(garden, "garden.json"), "w") as f:
            json.dump(meta, f)
        shutil.copy(os.path.join(inst, f"{scene['scan']}.ply"),
                    os.path.join(garden, "garden.ply"))
        runs["mipnerf_garden"] = jpeg_cli("mipnerf garden", rec, knn_of, [
            "--config", os.path.join(here, "configs", "mip_nerf.yaml"),
            "--scans", "garden", f"dataset.data_dir_root={mip}",
            "loss.local_weight=0",       # no Vis-MVSNet checkpoint
            f"exps_folder={os.path.join(work, 'exps_mip')}"] + common, smi)

        # (c) the prep CLI on the JPEGs (phase 22's random DUSt3R), then
        # the scene it wrote, the views beside it
        ckpt = os.path.join(tmp, "prep", "dust3r.pth")
        if not os.path.exists(ckpt):
            os.makedirs(os.path.dirname(ckpt), exist_ok=True)
            torch.save(dn.random_dust3r_state(dn.Dust3rConfig(), seed=0,
                                              dtype=torch.float16), ckpt)
        prep_root = os.path.join(work, "prep")
        zero_counts()
        t0 = time.perf_counter()
        res = cli_prep.main(["--scan", "jpeg_prep", "--images",
                             os.path.join(inst, "image"), "--ckpt", ckpt,
                             "--out-root", prep_root, "--conf",
                             str(PREP_CONF), "--device", "cuda"])
        torch.cuda.synchronize()
        prep_s = time.perf_counter() - t0
        if any(read_counts().values()):
            fail(f"jpeg prep: the prep CLI launched {read_counts()}")
        copy_views(os.path.join(res["out_dir"], "image"), views)
        log(f"jpeg prep: cli.prep_pointcloud on the three JPEGs in "
            f"{prep_s:.2f} s: {len(res['points']):,} points, alignment "
            f"loss {res['loss']:.6g} [{smi}]")
        torch.cuda.empty_cache()
        runs["prep"] = jpeg_cli("prep", rec, knn_of, [
            "--config", os.path.join(here, "configs", "own_data.yaml"),
            "--scans", "jpeg_prep", f"dataset.data_dir_root={prep_root}",
            f"exps_folder={os.path.join(work, 'exps_prep')}"] + common, smi)
    log("jpeg: ms/step by scene " + json.dumps(
        {k: round(v[0], 2) for k, v in runs.items()})
        + f"; phase wall {time.perf_counter() - t_phase:.2f} s [{smi}]")


def run100k_phase(smi, tmp):
    """Phase 27: the port's ``scripts.run_100k`` through its ``main`` in
    ``tmp`` at RUN100K_STEPS steps: ``--stop-at RUN100K_KILL``, then
    ``--resume`` (counters set to 0 just before each).  It holds each
    call's launches, the record's keys to
    ``artifacts/run100k_default.json``'s, its events and finite
    evaluations."""
    import numpy as np
    import torch

    from spurfies_tpu_torch.eval import mesh_extract
    from spurfies_tpu_torch.scripts import run_100k
    from spurfies_tpu_torch.train.trainer import Trainer

    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(tmp, "run100k")
    out = os.path.join(work, "record.json")
    args = ["--steps", str(RUN100K_STEPS), "--kill-at", str(RUN100K_KILL),
            "--eval-at", str(RUN100K_KILL), str(RUN100K_STEPS), "--window",
            str(RUN100K_WINDOW), "--ckpt-dir", os.path.join(work, "ckpts"),
            "--out", out]
    ov = [f"train.checkpoint_freq={RUN100K_CKPT}"]
    rec = {"init": [], "run": [], "render": [], "render_ms": [],
           "probe": []}
    spies = dict(trainer_spies(rec), probe_grid=spy_probe_grid(rec))
    sites = [(Trainer, name, None) for name in ("__init__", "run",
                                                "render_image")]
    sites.append((mesh_extract, "probe_grid", None))
    knn = "select_knn_packed"
    records, t_phase = [], time.perf_counter()
    with substituted(lambda fn, _: spies[fn.__name__](fn), sites):
        for tag, extra, steps in (
                ("stop", ["--stop-at", str(RUN100K_KILL)], RUN100K_KILL),
                ("resume", ["--resume"], RUN100K_STEPS - RUN100K_KILL)):
            zero_counts()
            t0 = time.perf_counter()
            records.append(run_100k.main(args + extra + ov))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_counts()
            tr = rec["render"][0][0]
            if not 0 < tr.scene.table.n_points <= 2 ** 15:
                fail("run100k: the scene does not select the packed K1")
            del tr
            n_render, n_probe = len(rec["render"]), len(rec["probe"])
            # each evaluation: the calibration's probe of the cloud (K1 +
            # K2 once) and the beta render through the module-level
            # render, launched as the render of the same view before it
            extra_launches = expected_counts(
                launches, {"select_knn": 1, "pair_sdf_value_agg": 1},
                n_render, knn)
            for r in rec["render"]:
                for k in extra_launches:
                    extra_launches[k] += r[5][k]
            got = held_launches(f"run100k {tag}", rec, launches, knn,
                                PER_STEP, extra=extra_launches)
            if (got, n_render, n_probe) != (steps, 1, 2):
                fail(f"run100k {tag}: {got} steps, {n_render} renders, "
                     f"{n_probe} probes; expected {steps}, 1, 2")
            log(f"run100k {tag}: {wall:.2f} s; windows " + json.dumps(
                records[-1]["windows"][-(steps // RUN100K_WINDOW):])
                + f" [{smi}]")
    torch.cuda.empty_cache()

    stop, full = (json.loads(json.dumps(r)) for r in records)
    with open(os.path.join(here, "artifacts", "run100k_default.json")) as f:
        ref = json.load(f)
    with open(out) as f:
        written = json.load(f)
    ev_keys = list(ref["evals"]["30000"]) + ["masked_psnr_beta3e3"]
    if sorted(full) != sorted(ref) or written != full or any(
            list(w) != list(ref["windows"][0]) for w in full["windows"]) \
            or any(sorted(e) != sorted(ev_keys)
                   for e in full["evals"].values()):
        fail(f"run100k: the record's keys {sorted(full)} are not the JAX "
             "record's, or differ from the file")
    events = [(e["step"], e["event"]) for e in full["events"]]
    want = [(s, "checkpoint") for s in range(
        RUN100K_CKPT, RUN100K_STEPS + 1, RUN100K_CKPT)]
    want.insert(RUN100K_KILL // RUN100K_CKPT,
                (RUN100K_KILL, f"host-resume from {RUN100K_KILL}"))
    steps = [w["step"] for w in full["windows"]]
    if events != want or list(stop["evals"]) != [str(RUN100K_KILL)] or \
            list(full["evals"]) != [str(RUN100K_KILL), str(RUN100K_STEPS)] \
            or steps != list(range(RUN100K_WINDOW, RUN100K_STEPS + 1,
                                   RUN100K_WINDOW)):
        fail(f"run100k: events {events}, evals {list(full['evals'])}, "
             f"windows {steps}")
    vals = [v for e in full["evals"].values() for v in e.values()]
    if not all(v is not None and np.isfinite(v) for v in vals) or any(
            w["notfinite"] for w in full["windows"]):
        fail(f"run100k: evaluations {full['evals']}")
    ms = [w["ms_per_step"] for w in full["windows"]]
    log(f"run100k: {RUN100K_STEPS} steps, ms/step by window {ms}; evals "
        f"{json.dumps(full['evals'])}; total_wall_s {full['total_wall_s']};"
        f" phase wall {time.perf_counter() - t_phase:.2f} s [{smi}]")


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: needs PyTorch", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port "
              "on a GPU and has nothing to report without one",
              file=sys.stderr)
        return 2
    import numpy as np

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        from spurfies_tpu_torch.config import Config, apply_overrides
        from spurfies_tpu_torch.convert.from_jax import PRIOR_ASSET
        from spurfies_tpu_torch.core.metrics import psnr
        from spurfies_tpu_torch.data.synthetic import (
            make_dust3r_like_scene,
            make_synthetic_scene,
        )
        from spurfies_tpu_torch.model import field, renderer
        from spurfies_tpu_torch.ops import cuda_build, pair_mlp
        from spurfies_tpu_torch.ops.pair_mlp import _prep_layers
        from spurfies_tpu_torch.train.trainer import Trainer, make_render_fn
    except ImportError as e:
        print(f"chip_smoke: run it from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2

    # --- 1. device ---
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions: f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    device_name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"device: {device_name}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")

    # --- 2. build ---
    t0 = time.perf_counter()
    secs = cuda_build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s wall "
        + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items()))
    for src in cuda_build.SOURCES:
        path = cuda_build.BUILD_DIR / f"{src}.log"
        if path.exists():
            text = path.read_text()
            report = cuda_build.ptxas_report(text) or {"": [
                ln.strip() for ln in text.splitlines()
                if "registers" in ln or "spill" in ln]}
            for entry, lines in report.items():
                log(f"  {src} {entry}: " + " | ".join(lines))
    for label, lib, kernel in WGMMA_KERNELS:
        ops = sass_opcodes(cuda_build.lib_path(lib), kernel,
                           ("HGMMA", "HMMA"))
        log(f"build: {label} SASS ({kernel}): " + (
            "cuobjdump not found" if ops is None else
            f"HGMMA {'present' if ops['HGMMA'] else 'absent'} "
            f"({ops['HGMMA']} HGMMA, {ops['HMMA']} HMMA instructions)"))
        if ops is not None and not ops["HGMMA"]:
            fail(f"build: {label}'s products are not on wgmma")

    # --- 3. scenes ---
    cfg = Config()
    prior_path = PRIOR_ASSET
    t0 = time.perf_counter()
    pts_a, cols_a, views_a = make_dust3r_like_scene()
    pts_b, cols_b, views_b = make_synthetic_scene(
        n_points=40000, n_views=3, img_res=(192, 256), radius=0.8,
        cam_dist=2.4, seed=1)
    scenes = {}
    for tag, pts, cols, views, seed in (("dust3r_like", pts_a, cols_a,
                                         views_a, 0),
                                        ("dense_sphere", pts_b, cols_b,
                                         views_b, 1)):
        scene, tp, frozen = setup_scene(pts, cols, cfg, prior_path, seed,
                                        dev)
        view = {"uv": views["uv"], "pose": views["pose"][0],
                "intrinsics": views["intrinsics"][0],
                "rgb": views["rgb"][0], "mask": views["mask"][0]}
        packed = 0 < scene.table.n_points <= 2 ** 15
        scenes[tag] = (scene, tp, frozen, view, packed)
        log(f"scene {tag}: {scene.points.shape[0]} points, qcap "
            f"{scene.spec.qcap}, K1 variant {'packed' if packed else 'exact'}")
    torch.cuda.synchronize()
    log(f"scenes built in {time.perf_counter() - t0:.2f} s")
    if scenes["dust3r_like"][4] is not True or scenes["dense_sphere"][4]:
        fail("scene sizes do not select both K1 variants")

    # --- 4. kernels against their plain versions ---
    results = {}
    chunk_rays = {}
    n_occ = {}
    for tag, (scene, tp, frozen, view, packed) in scenes.items():
        prior = _prep_layers(frozen, torch.bfloat16)
        prior_f32 = _prep_layers(frozen, torch.float32)
        cam, dirs, n_occ[tag], sel = first_chunk(scene, view, cfg, dev)
        chunk_rays[tag] = sel
        with torch.no_grad():
            inp = kernel_inputs(scene, tp, prior, cam, dirs, cfg)
        k1 = "K1 select_knn packed" if packed else "K1 select_knn exact"
        radius = scene.spec.radius(scene.table.r)
        check_k1(k1 + " (probe)", k1_args(*inp["probe_k1"], scene,
                                          cfg.model.k, packed), 20)
        results[k1] = check_k1(k1 + " (shading)", k1_args(
            *inp["shade_k1"], scene, cfg.model.k, packed), 20, study=True)
        if tag == "dust3r_like":
            results["K2 pair_sdf_value_agg"] = check_pair(
                "K2 pair_sdf_value_agg", pair_mlp.pair_sdf_value_agg,
                pair_mlp.pair_sdf_value_agg_ref, inp["k2"], prior,
                prior_f32, cfg.model.rbf, 10)
            results["K3 pair_sdf_aggregate"] = check_pair(
                "K3 pair_sdf_aggregate", pair_mlp.pair_sdf_aggregate,
                pair_mlp.pair_sdf_aggregate_ref, inp["k3"], prior,
                prior_f32, cfg.model.rbf, 5)
            dump_cost("K3 pair_sdf_aggregate (dump pairs)",
                      pair_mlp.pair_sdf_aggregate, inp["k3"], prior,
                      cfg.model.rbf, 5, 0.1)
            # K2's limit: a tenth of what its P k pairs would take if each
            # cost what a real one does (73 % of its pairs are dump pairs)
            table2, idx2, _ = inp["k2"]
            n_real = int(((idx2 >= 0) & (idx2 < table2.shape[0] - 1)).sum())
            dump_cost("K2 pair_sdf_value_agg (dump pairs)",
                      pair_mlp.pair_sdf_value_agg, inp["k2"], prior,
                      cfg.model.rbf, 10, 0.1 * idx2.numel() / max(n_real, 1))
            # K2 is K3 without the down sweep: the same tiles, the same
            # up-sweep instructions and sums, so its pt is K3's pt[:, :2]
            with torch.no_grad():
                pt2 = pair_mlp.pair_sdf_value_agg(*inp["k2"], prior,
                                                  cfg.model.rbf)
                pt3 = pair_mlp.pair_sdf_aggregate(*inp["k2"], prior,
                                                  cfg.model.rbf)[0]
                same = torch.equal(pt2, pt3[:, :2])
            log(f"K2 pt vs K3 pt[:, :2] on the {pt2.shape[0]} probe points: "
                f"{'bit-equal' if same else 'DIFFERENT'}")
            if not same:
                fail("K2 and K3 disagree on the same points")
            del pt2, pt3
            for label, key, what, reps in (
                    ("K6b pair_sdf_rows_value", "k6b", "probe", 10),
                    ("K6a pair_sdf_rows_grad", "k6a", "shading", 5),
                    ("K7a pair_sdf_value_and_input_grad", "k7",
                     "shading pairs, pair_budget_frac=0.625", 5)):
                args, needed = inp[key]
                fn = label.split()[1]
                results[label] = check_rows(
                    f"{label} ({what})", getattr(pair_mlp, fn),
                    getattr(pair_mlp, f"{fn}_ref"), args, prior,
                    prior_f32, reps, radius, int(needed.sum()))
            # K6a runs K3's sweeps on the same shading pairs: on every
            # valid pair its r_lat is K3's, bit for bit
            with torch.no_grad():
                _, _, r_lat = pair_mlp.pair_sdf_aggregate(
                    *inp["k3"], prior, cfg.model.rbf)
                (g, xr), valid = inp["k6a"]
                r6 = pair_mlp.pair_sdf_rows_grad(g, xr, prior)[1]
                same = torch.equal(r6[valid, :32].to(torch.bfloat16),
                                   r_lat[valid])
            log(f"K6a r_lat vs K3 r_lat on the {int(valid.sum())} valid "
                f"shading pairs: {'bit-equal' if same else 'DIFFERENT'}")
            if not same:
                fail("K6a and K3 disagree on the same pairs")
            # K6b is K6a without the down sweep: on the probe's rows its s
            # and x_pi are K6a's, bit for bit
            with torch.no_grad():
                (g, xr), _ = inp["k6b"]
                s6b, xpi6b = pair_mlp.pair_sdf_rows_value(g, xr, prior)
                s6a, _, xpi6a = pair_mlp.pair_sdf_rows_grad(g, xr, prior)
                same = torch.equal(s6b, s6a) and torch.equal(xpi6b, xpi6a)
            log(f"K6b s, x_pi vs K6a s, x_pi on the {g.shape[0]} probe rows: "
                f"{'bit-equal' if same else 'DIFFERENT'}")
            if not same:
                fail("K6b and K6a disagree on the same rows")
            # K7a is K6a whose gather reads x_pi from u: on u = [g_lat | K6a's
            # x_pi] of the shading rows its s and r are K6a's, bit for bit
            with torch.no_grad():
                (g, xr), _ = inp["k6a"]
                s6a, r6a, xpi6a = pair_mlp.pair_sdf_rows_grad(g, xr, prior)
                u = torch.cat([g[:, :32], xpi6a], 1)
                s7a, r7a = pair_mlp.pair_sdf_value_and_input_grad(u, prior)
                same = torch.equal(s7a, s6a) and torch.equal(r7a, r6a)
            log(f"K7a s, r vs K6a s, r on the {g.shape[0]} shading rows: "
                f"{'bit-equal' if same else 'DIFFERENT'}")
            if not same:
                fail("K7a and K6a disagree on the same rows")
            del r_lat, r6, s6b, xpi6b, s6a, xpi6a, r6a, u, s7a, r7a
        del inp
        torch.cuda.empty_cache()

    # --- 5. render path ---
    render_image = make_render_fn(cfg, device="cuda")
    zero_counts()
    outs, walls = {}, {}
    for tag, (scene, tp, frozen, view, _) in scenes.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[tag] = render_image(tp, scene, frozen, view["uv"], view["pose"],
                                 view["intrinsics"])
        torch.cuda.synchronize()
        walls[tag] = time.perf_counter() - t0
    launches_render = read_counts()
    log(f"render path launches: {launches_render}")

    iters = cfg.model.ray_sampler.max_total_iters
    chunks = {t: math.ceil(n_occ[t] / CHUNK) for t in scenes}
    expect = dict({k: 0 for k in launches_render},
                  select_knn_packed=(iters + 1) * chunks["dust3r_like"],
                  select_knn_exact=(iters + 1) * chunks["dense_sphere"],
                  pair_sdf_value_agg=iters * sum(chunks.values()),
                  pair_sdf_aggregate=sum(chunks.values()))
    if launches_render != expect:
        fail(f"launch counts {launches_render} != expected {expect}")
    for tag, out in outs.items():
        n = len(scenes[tag][3]["uv"])
        for key, v in out.items():
            if v.shape[0] != n or not np.isfinite(v.astype(np.float64)).all():
                fail(f"{tag}: output {key} not finite / wrong shape")
        if out["ray_mask"].sum() < 0.1 * n:
            fail(f"{tag}: almost no ray hit the cloud")
        view = scenes[tag][3]
        m = torch.as_tensor(view["mask"])
        p = float(psnr(torch.as_tensor(out["rgb_values"]),
                       torch.as_tensor(view["rgb"]), m))
        log(f"render {tag}: {n} rays ({n_occ[tag]} occupied, "
            f"{chunks[tag]} chunks) in {walls[tag]:.3f} s = "
            f"{n / walls[tag]:.1f} rays/s; hit rays {int(out['ray_mask'].sum())}"
            f"; masked PSNR vs the analytic view {p:.2f} dB (random colour "
            "MLPs)")

    # the same view with model.fused_agg=false: K6b probes, K6a shades
    scene, tp, frozen, view, _ = scenes["dust3r_like"]
    cfg_unfused = apply_overrides(cfg, OPTIONS["unfused"][0])
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    unfused_render_fn = make_render_fn(cfg_unfused, device="cuda")
    out_u = unfused_render_fn(
        tp, scene, frozen, view["uv"], view["pose"], view["intrinsics"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_unfused = read_counts()
    expect = expected_counts(
        launches_unfused, {"select_knn": iters + 1,
                           "pair_sdf_rows_value": iters,
                           "pair_sdf_rows_grad": 1},
        chunks["dust3r_like"], "select_knn_packed")
    if launches_unfused != expect:
        fail(f"fused_agg=false launch counts {launches_unfused} != "
             f"expected {expect}")
    n = len(view["uv"])
    for key, v in out_u.items():
        if v.shape[0] != n or not np.isfinite(v.astype(np.float64)).all():
            fail(f"fused_agg=false: output {key} not finite / wrong shape")
    p = float(psnr(torch.as_tensor(out_u["rgb_values"]),
                   torch.as_tensor(view["rgb"]), torch.as_tensor(view["mask"])))
    log(f"render dust3r_like, fused_agg=false: {n} rays in {wall:.3f} s = "
        f"{n / wall:.1f} rays/s; hit rays {int(out_u['ray_mask'].sum())} "
        f"(fused: {int(outs['dust3r_like']['ray_mask'].sum())}); masked PSNR "
        f"{p:.2f} dB; launches {launches_unfused}")
    del out_u

    # the same view with field.FUSED_COLOR: K8a colours each chunk
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    colour_render_fn = make_render_fn(cfg, device="cuda")
    with fused_color_set(True):
        out_c = colour_render_fn(
            tp, scene, frozen, view["uv"], view["pose"], view["intrinsics"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_colour_render = read_counts()
    expect = expected_counts(
        launches_colour_render, {"select_knn": iters + 1,
                                 "pair_sdf_value_agg": iters,
                                 "pair_sdf_aggregate": 1,
                                 "pack_color_weights": 1,
                                 "fused_color_fwd": 1},
        chunks["dust3r_like"], "select_knn_packed")
    if launches_colour_render != expect:
        fail(f"FUSED_COLOR render launch counts {launches_colour_render} != "
             f"expected {expect}")
    for key, v in out_c.items():
        if v.shape[0] != n or not np.isfinite(v.astype(np.float64)).all():
            fail(f"FUSED_COLOR render: output {key} not finite / wrong shape")
    p = float(psnr(torch.as_tensor(out_c["rgb_values"]),
                   torch.as_tensor(view["rgb"]), torch.as_tensor(view["mask"])))
    log(f"render dust3r_like, FUSED_COLOR: {n} rays in {wall:.3f} s = "
        f"{n / wall:.1f} rays/s; hit rays {int(out_c['ray_mask'].sum())}; "
        f"masked PSNR {p:.2f} dB (random colour MLPs); launches "
        f"{launches_colour_render}")
    del out_c

    # --- 6. one chunk through the plain versions, on the card ---
    scene, tp, frozen, view, _ = scenes["dust3r_like"]
    sel = chunk_rays["dust3r_like"].cpu().numpy()
    inputs = {"uv": torch.as_tensor(view["uv"][sel], device=dev)[None],
              "pose": torch.as_tensor(view["pose"], device=dev)[None],
              "intrinsics": torch.as_tensor(view["intrinsics"],
                                            device=dev)[None]}
    params = {"frozen": _prep_layers(frozen, torch.bfloat16), "train": tp}
    with torch.no_grad():
        out_k = renderer.render_rays(params, scene, inputs, cfg.model,
                                     train=False, iters=iters)
        with plain_versions():
            out_p = renderer.render_rays(params, scene, inputs, cfg.model,
                                         train=False, iters=iters)
    worst = compare_chunk(out_k, out_p)
    log(f"chunk of {len(sel)} rays, kernels vs plain versions, per-ray "
        f"max abs differences: {json.dumps(worst)}")
    for label, ov in (("fused_agg=false", OPTIONS["unfused"][0]),
                      ("render_budget_frac=0.9",
                       ["model.render_budget_frac=0.9"])):
        mcfg = apply_overrides(cfg, ov).model
        with torch.no_grad():
            out_k = renderer.render_rays(params, scene, inputs, mcfg,
                                         train=False, iters=iters)
            with plain_versions():
                out_p = renderer.render_rays(params, scene, inputs, mcfg,
                                             train=False, iters=iters)
        worst = compare_chunk(out_k, out_p)
        log(f"chunk, {label}, kernels vs plain versions: "
            f"{json.dumps(worst)}")
    # FUSED_COLOR: the chunk through K8a, recording its colour inputs
    chunk = {}
    with fused_color_set(True), torch.no_grad():
        seen = capture(lambda: chunk.update(out=renderer.render_rays(
            params, scene, inputs, cfg.model, train=False, iters=iters)),
            kernel_sites() + [(field, "aggregate_color", None)])
        with plain_versions():
            out_p = renderer.render_rays(params, scene, inputs, cfg.model,
                                         train=False, iters=iters)
    out_k = chunk.pop("out")
    worst = compare_chunk(out_k, out_p)
    log(f"chunk, FUSED_COLOR, kernels vs plain versions: {json.dumps(worst)}")
    if len(seen.get("fused_color_fwd", ())) != 1:
        fail("FUSED_COLOR chunk: K8a was not launched once")
    results["K8a fused_color_fwd"] = check_k8a(
        "K8a fused_color_fwd (first chunk's colour)",
        seen["fused_color_fwd"][0], 5)
    colour_render = colour_paths(seen["aggregate_color"][0], 3)
    del seen

    # --- 7. where the time goes (the dust3r_like scene of phase 6) ---
    prof = profile_render(render_image, scene, tp, frozen, view)
    log(f"profile: {json.dumps(prof)}")
    # the same view under FUSED_COLOR, profiled after the timed renders
    with fused_color_set(True):
        rprof = profiled(lambda: colour_render_fn(
            tp, scene, frozen, view["uv"], view["pose"], view["intrinsics"]))
    log(f"profile fused_color render: {json.dumps(rprof)}")
    # and under model.fused_agg=false (K6b probes, K6a shades)
    uprof = profiled(lambda: unfused_render_fn(
        tp, scene, frozen, view["uv"], view["pose"], view["intrinsics"]))
    log(f"profile fused_agg=false render: {json.dumps(uprof)}")

    del render_image, unfused_render_fn, outs, out_k, out_p
    torch.cuda.empty_cache()

    # --- 8-10. training: every launch of one step against its plain
    # version, one batch through both, host syncs, the timed path ---
    _, _, prior_a, view_a, _ = scenes["dust3r_like"]
    t0 = time.perf_counter()
    trainer = Trainer(cfg, pts_a, cols_a, views_a, device="cuda")
    trainer.load_frozen(prior_a)
    torch.cuda.synchronize()
    log(f"trainer dust3r_like built in {time.perf_counter() - t0:.2f} s")
    psnr0 = masked_psnr(trainer, view_a)
    best, launches_train, _ = train_path("dust3r_like", trainer, PER_STEP,
                                         TRAIN_WARMUP, TRAIN_STEPS,
                                         TRAIN_WINDOW)
    results["K4 pair_sdf_aggregate_bwd"] = best["pair_sdf_aggregate_bwd"]
    results["K5 scatter_add_rows"] = best["scatter_add_rows"]
    default_best = {k: best[k] for k in ("select_knn", "pair_sdf_value_agg",
                                         "pair_sdf_aggregate")}
    del best
    psnr1 = masked_psnr(trainer, view_a)
    log(f"view 0 masked PSNR vs the analytic view: {psnr0:.2f} dB before "
        f"training, {psnr1:.2f} dB after {TRAIN_WARMUP + TRAIN_STEPS + 3} "
        "steps")

    # a few steps on the dense sphere: N > 2**15, the exact K1; one
    # captured step holds its launches (K1 exact, K4 at N = 37,267) against
    # their plain versions first
    dense = Trainer(cfg, pts_b, cols_b, views_b, device="cuda")
    dense.load_frozen(prior_a)
    seen = capture_step(dense)
    got = {k: len(v) for k, v in seen.items()}
    if got != PER_STEP:
        fail(f"dense_sphere: one step launched {got}, expected {PER_STEP}")
    dense_best = check_step(
        "dense_sphere", seen, _prep_layers(dense.frozen, torch.float32),
        dense.scene.spec.radius(dense.scene.table.r))
    del seen
    dense_hist = []
    zero_counts()
    dense.run(DENSE_STEPS, window=DENSE_STEPS,
              callback=lambda s_, m: dense_hist.append(m))
    launches_dense = read_counts()
    expect = expected_counts(launches_dense, PER_STEP, DENSE_STEPS,
                             "select_knn_exact")
    log(f"train dense_sphere: {dense.scene.points.shape[0]} points, "
        f"{DENSE_STEPS} steps, loss {dense_hist[-1]['loss']:.5g}; launches "
        f"{launches_dense}")
    if launches_dense != expect or not np.isfinite(dense_hist[-1]["loss"]):
        fail(f"dense_sphere training: launches {launches_dense} != {expect} "
             "or a non-finite loss")
    del dense
    torch.cuda.empty_cache()

    # --- 11. where a training step's time goes ---
    tprof = profiled(lambda: trainer.run(PROFILE_STEPS,
                                         window=PROFILE_STEPS))
    tprof["steps"] = PROFILE_STEPS
    tprof["ms_per_step"] = tprof["profiled_wall_ms"] / PROFILE_STEPS
    log(f"train profile: {json.dumps(tprof)}")

    del trainer
    torch.cuda.empty_cache()

    # --- 12. the two option paths ---
    option_best, launches_options = {}, []
    for tag in ("unfused", "pairs"):
        best, counts = option_phase(tag, cfg, pts_a, cols_a, views_a,
                                    prior_a)
        option_best.update(best)
        launches_options.append(counts)

    # --- 13. pair-MLP microbenchmark: K7b's path ---
    rng = np.random.default_rng(0)
    u = torch.as_tensor(np.concatenate(
        [rng.normal(0, 0.3, (MICRO_PAIRS, 32)),
         rng.normal(0, 0.03, (MICRO_PAIRS, 3))], -1).astype(np.float32),
        device=dev)
    prior = _prep_layers(prior_a, torch.bfloat16)
    prior_f32 = _prep_layers(prior_a, torch.float32)
    zero_counts()
    with torch.no_grad():
        pair_mlp.pair_sdf_value(u, prior)
        pair_mlp.pair_sdf_value_and_input_grad(u, prior)
    torch.cuda.synchronize()
    launches_micro = read_counts()
    expect = expected_counts(launches_micro, {"pair_sdf_value": 1,
                                              "pair_sdf_value_and_input_grad":
                                              1}, 1, None)
    if launches_micro != expect:
        fail(f"microbench launch counts {launches_micro} != {expect}")
    # every random pair is held (radius inf): none is masked
    results["K7b pair_sdf_value"] = check_rows(
        f"K7b pair_sdf_value (microbench, {MICRO_PAIRS} pairs)",
        pair_mlp.pair_sdf_value, pair_mlp.pair_sdf_value_ref, (u,), prior,
        prior_f32, 20, math.inf)
    results["K7b pair_sdf_value"]["kernel_ms"] = k7b_step0(u, prior, 20)
    # K7b is K7a without the down sweep: on the same pairs its s is K7a's
    with torch.no_grad():
        same = torch.equal(pair_mlp.pair_sdf_value(u, prior),
                           pair_mlp.pair_sdf_value_and_input_grad(u, prior)[0])
    log(f"K7b s vs K7a s on the {MICRO_PAIRS} pairs: "
        f"{'bit-equal' if same else 'DIFFERENT'}")
    if not same:
        fail("K7b and K7a disagree on the same pairs")
    check_rows(
        f"K7a pair_sdf_value_and_input_grad (microbench, {MICRO_PAIRS} "
        "pairs)", pair_mlp.pair_sdf_value_and_input_grad,
        pair_mlp.pair_sdf_value_and_input_grad_ref, (u,), prior, prior_f32,
        10, math.inf)
    del u, prior_f32

    # --- 14. the fused colour's training path, FUSED_COLOR set around it
    # (its render parts ran after phases 5 and 6) ---
    with fused_color_set(True):
        tr = Trainer(cfg, pts_a, cols_a, views_a, device="cuda")
        tr.load_frozen(prior_a)
        colour_best, launches_colour_train, _ = train_path(
            "dust3r_like fused_color", tr, FUSED_COLOR_STEP, OPTION_WARMUP,
            OPTION_STEPS, OPTION_STEPS)
        cprof = profiled(lambda: tr.run(PROFILE_STEPS, window=PROFILE_STEPS))
        cprof["ms_per_step"] = cprof["profiled_wall_ms"] / PROFILE_STEPS
        log(f"train profile fused_color: {json.dumps(cprof)}")
        seen = capture_step(tr, [(field, "aggregate_color", None)])
        colour_train = colour_paths(seen["aggregate_color"][0], 10)
        del seen, tr
    torch.cuda.empty_cache()

    # --- 15. the training CLI at configs/dtu_pn.yaml; 16. the evaluation
    # CLIs on its trained scan; 17. K9 through the port's micro_gather;
    # 18. occ_compact in training; 19. the entangled model; 20. the local
    # loss through the CLI on phase 15's scan; 21. prior pretraining;
    # 22. point-cloud prep on phase 15's images; 23. ray sharding; 24. the
    # sphere validation; 25. the acceptance chain at a cut budget; 26. JPEG
    # input; 27. the 100k-step run's script at a cut budget ---
    with tempfile.TemporaryDirectory() as tmp:
        launches_cli, launches_cli_render, cli_ms = cli_phase(smi, tmp)
        launches_eval, eval_best = eval_phase(smi, tmp)
        launches_k9, results["K9 gather_rows"] = k9_phase(smi)
        _, launches_occ = option_phase("occ_compact", cfg, pts_a, cols_a,
                                       views_a, prior_a, smi)
        launches_ent_render, launches_ent = entangled_phase(
            smi, cfg, pts_a, cols_a, views_a, view_a)
        launches_local, launches_local_render = local_phase(smi, tmp,
                                                            cli_ms)
        launches_prior, launches_prior_render = pretrain_phase(
            smi, tmp, cfg, pts_a, cols_a, views_a, view_a)
        prep_phase(smi, tmp)
        dp_phase(smi, tmp, cfg, pts_a, cols_a, views_a, prior_a)
        validate_phase(smi)
        chain_phase(smi, tmp)
        jpeg_phase(smi, tmp)
        run100k_phase(smi, tmp)

    # --- 28. report ---
    render_runs = (launches_render, launches_unfused, launches_colour_render,
                   launches_cli_render, launches_ent_render,
                   launches_local_render, launches_prior_render)
    train_runs = (launches_train, launches_dense, *launches_options,
                  launches_colour_train, launches_cli, launches_occ,
                  launches_ent, launches_local, launches_prior)
    micro_runs = (launches_micro, launches_k9)
    results["K8b fused_color_bwd"] = colour_best["fused_color_bwd"]
    results["K8p pack_color_weights"] = colour_best["pack_color_weights"]

    def total(runs, key):
        return sum(c[key] for c in runs)

    launches = {k: total(render_runs + train_runs + micro_runs, k)
                + launches_eval[k] for k in launches_render}
    # the training shapes' times, beside phase 4's eval-chunk times
    train_shape = {"K1 select_knn packed": default_best["select_knn"],
                   "K1 select_knn exact": dense_best["select_knn"],
                   "K2 pair_sdf_value_agg": default_best["pair_sdf_value_agg"],
                   "K3 pair_sdf_aggregate": default_best["pair_sdf_aggregate"],
                   "K6a pair_sdf_rows_grad": option_best["pair_sdf_rows_grad"],
                   "K6b pair_sdf_rows_value":
                   option_best["pair_sdf_rows_value"],
                   "K7a pair_sdf_value_and_input_grad":
                   option_best["pair_sdf_value_and_input_grad"],
                   "K8a fused_color_fwd": colour_best["fused_color_fwd"]}
    # the colour path through aggregate_color, fused and dense (FUSED_COLOR
    # off: PyTorch's products, not a library call of the same function)
    colour_path = {"render_chunk": colour_render, "train": colour_train}
    rows = []
    meta = {
        "K1 select_knn packed": ("select_knn_packed",
                                 "spurfies_tpu_torch/csrc/select_knn.cu",
                                 "spurfies_tpu/ops/pallas_select.py:69"),
        "K1 select_knn exact": ("select_knn_exact",
                                "spurfies_tpu_torch/csrc/select_knn.cu",
                                "spurfies_tpu/ops/pallas_select.py:33"),
        "K2 pair_sdf_value_agg": ("pair_sdf_value_agg",
                                  "spurfies_tpu_torch/csrc/sdf_agg.cu",
                                  "spurfies_tpu/ops/pallas_mlp.py:640"),
        "K3 pair_sdf_aggregate": ("pair_sdf_aggregate",
                                  "spurfies_tpu_torch/csrc/sdf_agg.cu",
                                  "spurfies_tpu/ops/pallas_mlp.py:576"),
        "K4 pair_sdf_aggregate_bwd": ("pair_sdf_aggregate_bwd",
                                      "spurfies_tpu_torch/csrc/agg_bwd.cu",
                                      "spurfies_tpu/ops/pallas_mlp.py:683"),
        "K5 scatter_add_rows": ("scatter_add_rows",
                                "spurfies_tpu_torch/csrc/scatter_rows.cu",
                                "spurfies_tpu/ops/pallas_scatter.py:37"),
        "K6a pair_sdf_rows_grad": ("pair_sdf_rows_grad",
                                   "spurfies_tpu_torch/csrc/sdf_agg.cu",
                                   "spurfies_tpu/ops/pallas_mlp.py:195"),
        "K6b pair_sdf_rows_value": ("pair_sdf_rows_value",
                                    "spurfies_tpu_torch/csrc/sdf_agg.cu",
                                    "spurfies_tpu/ops/pallas_mlp.py:260"),
        "K7a pair_sdf_value_and_input_grad": (
            "pair_sdf_value_and_input_grad",
            "spurfies_tpu_torch/csrc/sdf_agg.cu",
            "spurfies_tpu/ops/pallas_mlp.py:51"),
        "K7b pair_sdf_value": ("pair_sdf_value",
                               "spurfies_tpu_torch/csrc/sdf_agg.cu",
                               "spurfies_tpu/ops/pallas_mlp.py:146"),
        "K8p pack_color_weights": ("pack_color_weights",
                                   "spurfies_tpu_torch/csrc/color_mlp.cu",
                                   "spurfies_tpu/ops/pallas_color.py:63"),
        "K8a fused_color_fwd": ("fused_color_fwd",
                                "spurfies_tpu_torch/csrc/color_mlp.cu",
                                "spurfies_tpu/ops/pallas_color.py:92"),
        "K8b fused_color_bwd": ("fused_color_bwd",
                                "spurfies_tpu_torch/csrc/color_mlp.cu",
                                "spurfies_tpu/ops/pallas_color.py:108"),
        "K9 gather_rows": ("gather_rows",
                           "spurfies_tpu_torch/csrc/gather_rows.cu",
                           "scripts/micro_gather.py:44"),
    }
    # the evaluation's probe shape (phase 16's busiest chunk)
    eval_shape = {"K1 select_knn exact": eval_best["select_knn"],
                  "K2 pair_sdf_value_agg": eval_best["pair_sdf_value_agg"]}
    # launches: the render paths', the training paths', the evaluation's
    # and the microbenchmarks' runs, each with the counters set to 0 just
    # before it
    for label, (key, src, rep) in meta.items():
        r = results[label]
        row = {"name": label, "route": "cuda", "source": src,
               "replaces": rep, "launches": launches[key],
               "launches_render": total(render_runs, key),
               "launches_train": total(train_runs, key),
               "launches_eval": launches_eval[key],
               "launches_microbench": total(micro_runs, key),
               "max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        if label in train_shape:
            t = train_shape[label]
            row["train_shape"] = {k: t[k] for k in (
                "rows", "ms", "kernel_ms", "plain_ms", "bound_ms",
                "bound_all_rows_ms", "max_abs_err") if k in t}
        if label in eval_shape:
            e = eval_shape[label]
            row["eval_shape"] = {k: e[k] for k in (
                "rows", "ms", "kernel_ms", "plain_ms", "bound_ms",
                "library_ms", "max_abs_err") if k in e}
        if label.startswith("K4"):
            # the step's second, pseudo-SDF launch: one a step on every
            # path that runs K4
            l2 = r["later"][0]
            row["launch_2"] = {k: l2[k] for k in (
                "rows", "ms", "kernel_ms", "plain_ms", "bound_ms",
                "library_ms", "max_abs_err")}
            row["launch_2"]["launches"] = sum(
                c[key] // per[key] for c, per in (
                    (launches_train, PER_STEP), (launches_dense, PER_STEP),
                    (launches_options[1], OPTIONS["pairs"][1]),
                    (launches_colour_train, FUSED_COLOR_STEP),
                    (launches_cli, PER_STEP), (launches_occ, PER_STEP),
                    (launches_local, PER_STEP)))
        if label.startswith("K8"):
            row["colour_path_ms"] = colour_path
        for k in ("scratch_bytes", "kernel_ms", "library_zeroed_ms"):
            if k in r:
                row[k] = r[k]
        rows.append(row)
        if launches[key] == 0:
            fail(f"{label} was not launched on the main path")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"redesign_order": redesign_order(rows)}))
    log(json.dumps({"redesign_order_kernel_ms":
                    redesign_order(rows, "kernel_ms")}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
