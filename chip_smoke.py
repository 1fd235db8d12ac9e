#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit:

    python3 chip_smoke.py

It builds the CUDA kernels from ``gendr_tpu_torch/csrc`` (one nvcc per
source, started together, into ``gendr_tpu_torch/_build_cache/``), then

1. holds each kernel against its plain PyTorch version on the card: on the
   flagship scene (642-vertex icosphere, 256x256, uniform CDF, tau 1e-2,
   probabilistic alpha, hard RGB, random per-face colours) and on
   alpha-only, the max/hard/einstein alpha families, a 100x100 render
   (ragged edge tiles) and a batch of 4 views; on softmax RGB with 1, 25
   and 36 texels per face and with vertex colours, hard RGB with 25 texels
   and with vertex colours, and 4 single-sided views with 25 texels; on the
   panda_dist renderer's scene and configuration (gaussian, tau 1e-2) at
   256x256; on the default GenDR's inputs of phase 4 (4 views at 512x512,
   surface and vertex textures); and on the inputs the shape optimizer of
   phase 3 gives the kernels (its soft and hard renderers on its template
   from 24 views at 64x64, the hard renderer on its 120 goal views); and,
   for the parametric folds, on the flagship (whose CDF is the uniform
   one, so coverage saturates at exactly 1) with each of hamacher, frank,
   yager, aczel_alsina, dombi and schweizer_sklar, alpha-only and hard RGB,
   softmax RGB with 25 texels for yager and frank, frank with the logistic
   CDF, the panda_tcn renderer with yager and aczel_alsina at 256x256, and
   the shape optimizer's soft renderer with yager p=2; and, for big
   surface textures, on the flagship at 256x256 with 49, 256 and 1024
   texels per face, softmax and hard RGB (one single-sided, one folded by
   yager), hard RGB with 1089, and on path (e)'s own inputs (the mesh
   loaded from an OBJ file at 256 texels per face, 4 views at 512x512).
   Each case compares the forward image (and, for hard RGB, every winner), the
   gradient of 0.5 sum(alpha^2) + 0.1 sum(rgb), each side through its own
   forward, and two backward runs, bitwise;
2. drives the render path, Mesh -> Lighting -> LookAt -> GenDR at 256x256
   (hard RGB) and its gradient to the mesh vertices, against the plain
   backend, and checks that both kernels' launch counters rose;
3. drives the training path, the shape optimizer of
   ``gendr_tpu_torch.experiments.opt_shape`` at its default width
   (642-vertex template, 64x64, 24 views, logistic sigma 1e-2,
   probabilistic, lr 10^-1.5, procedural cube target), and checks that the
   hard IoU loss fell, every gradient was finite and both kernels ran;
4. drives the textured paths: (a) ``gendr_tpu_torch.animations.panda_dist
   --quick`` at its defaults (1280-face textured stand-in, 25 texels per
   face, 768x768 with 2x anti-aliasing: 1536x1536 renders, 2 distributions
   x 7 taus), checking one forward launch per frame, none backward, and
   every frame finite with alpha in [0, 1]; one full-width frame (uniform,
   tau 1e-2) against backend='torch'; (b) the default GenDR
   (anti-aliased 256x256, softmax RGB) on 4 views with surface and then
   vertex textures, forward and loss.backward() to vertices and textures,
   one launch of each kernel per run, against backend='torch'; (c) path
   (l): the default GenDR through backend='torch' on 4 views of the
   stand-in at 33 x 33 texels a face, above the kernels' softmax cap,
   forward and backward twice, the image and the face, vertex and texel
   gradients bitwise equal (no atomics), under 16 GiB of device memory,
   both runs timed (``--torch-texel-only`` runs it alone);
5. drives the t-conorm sweeps, path (c): ``gendr_tpu_torch.animations.
   panda_tcn`` at its defaults (1536x1536 renders, 25 texels, softmax RGB,
   uniform CDF) over the full canonical list of 11 t-conorm configurations
   x the 7 taus of --quick, ``--sweep-p --quick`` (hamacher, yager,
   aczel_alsina x 8 values of p) and ``triangles_tcn --quick``, checking
   one forward launch per frame, none backward, and every frame finite
   with alpha in [0, 1]; one full-width yager frame against
   backend='torch'; and path (d), the shape optimizer with ``--aggr-func
   yager --t_conorm_p 2`` for 30 steps, as phase 3;
6. drives the asset paths: (e) the textured stand-in written with
   ``obj_io.save_obj(texture_res=16)`` into a temporary directory (OBJ,
   MTL, PNG atlas) and read back with ``load_obj(load_texture=True,
   texture_res=16)`` onto the card (1280 faces x 256 texels), the default
   GenDR on 4 views of that mesh, forward and loss.backward() into
   vertices and textures (one launch of each kernel, finite non-zero
   texture gradients, the image against backend='torch' off the texel
   fold), then ``GENDR_PANDA_OBJ=<that file>`` through ``panda_dist
   --quick --texture-res 16`` (14 frames at 1536x1536, one forward launch
   each, the PNGs read back with the port's reader); (f) ``voxelization``
   of the 1280-face icosphere at 32^3 and 64^3 on the card, voxel for
   voxel equal to the CPU's, its solid count against the ball's volume;
   (g) ``experiments.opt_camera --quick`` (16 poses, 50 annealed steps at
   64x64): the loss falls, the poses stay finite, one launch of each
   kernel per step;
7. runs both probe kernels of ``csrc/ulp_probe.cu`` over every case of the
   three ULP tools, the whole phase in one launch of each, against torch
   on the card and on the CPU, prints the table, and fails where a kernel
   and torch on the card differ by more than ULP_BUDGET, where the two
   kernels differ, or where a case's output in the batch differs from its
   own one-case launch;
8. drives the sharded paths, path (h): (h1) the forward and backward
   kernels on row bands (K1e/K2e: two halves of the image and a ragged
   band of rows 37-136) and on the two face halves a 2-way face split
   gives (the second offset by its base_offset, with caller-padded faces)
   against their plain versions, with phase 1's gates, on the flagship,
   alpha-only, softmax RGB with 25 texels and yager p=2; the kernel's band
   rows bitwise equal to its full render, the halves' carries merged
   against the full render, the bands' gradients summed against the full
   backward; (h2) ``gendr_tpu_torch.parallel.sharding`` in 4 processes on
   the one card over gloo, mesh fp=2 x sp=2: the flagship and the default
   GenDR's inputs (4 views at 512x512, softmax, 25 texels) through the
   sharded render and loss.backward() against the unsharded render, every
   rank launching both kernels; (h3) the dry run's IoU loss with Adam on
   the 642-vertex template from 24 views at 64x64 over dp=2 x fp=2 for 10
   steps: the loss falls and the first gradient agrees with the unsharded
   step's; and the ``backend='torch'`` 1536x1536 frame of phase 4b under
   16 GiB of device memory;
9. drives path (i), ``gendr_tpu_torch.experiments.train_reconstruction
   --synthetic`` at its published width (Encoder 64 / 1024 / 512, Decoder
   1024 wide on the 642-vertex template, batch 64: 256 silhouettes a step
   at 64x64, uniform x probabilistic at tau 10^-1.5), the dataset cut to 8
   objects of each of the three synthetic classes: (i1) 30 steps and an
   evaluation through the CLI, the loss of the last 5 steps below that of
   the first 5, every loss and gradient finite, the voxel IoU finite;
   (i3) one step with ``--data-parallel 2`` (two gloo ranks of the one
   card, BatchNorm with the whole batch's moments) against the
   one-process step at seeds 0-2, each parameter tensor's gradient within
   1.5 times the change that reordering the batch makes to it; (i2) both
   kernels against their plain versions on the experiment's own inputs
   (the first step's B=256 render and the dataset's 24-view hard render)
   with phase 1's gates; (i4) the
   synthetic dataset's silhouettes and voxels on the card against the
   CPU's; (i5) the step's time beside opt_shape's;
10. times the kernels against their plain versions beside their bounds, at
   a 128-row band and a face half of the flagship (K1e/K2e),
   the flagship (hard RGB, and softmax RGB with one texel), at the panda
   frame and at the default GenDR's shapes (surface and vertex textures),
   a yager panda_tcn frame at tau 1e-2 and tau 1 and path (d)'s render
   beside the probabilistic fold at the same shapes, path (i)'s two
   renders, the probe kernels (a whole probe phase in one launch against
   one case a launch),
   path (e)'s mesh at 25, 256 and 1024 texels per face under softmax and
   hard RGB (forward and backward at 4 views of 512x512, forward at a
   1536x1536 frame; each forward line also gives the longest tile list
   in chunks and the pairs the kernel visits after its per-tile cull
   beside those a walk of every face of the listed chunks would visit,
   each backward line the slices S its chunk lists are cut into, the
   longest slice in tiles and the workspace's size),
   ``load_obj`` and ``voxelization`` on the host clock, the panda frames'
   render alone, the forward render and the forward + backward through
   both backends, and the median training step through both backends;
11. drives path (j), ``--chain`` of the three experiments (the eager
   phases above pass ``--chain 1``): (j1) ``opt_shape --chain 10``, (j2)
   ``opt_camera --quick --chain 20`` and (j3) ``train_reconstruction
   --synthetic --chain 8`` at path (i)'s width, a block cut short by
   ``--decay-at``, each against its ``--chain 1`` run from the same start,
   bitwise, with no deterministic algorithms asked for (losses, hard
   losses, steps to a threshold, parameters, BatchNorm statistics), and
   two eager runs bitwise equal; (j4) the kernels of a
   replay against their plain versions on the CUDA graph's buffers; the
   captured Adam against optax's rule; (j5) one host fetch a block, and a
   capture with a host read-back raising (run last); (j6) each
   experiment's step eager and chained: the median step on the host
   clock, the device busy share and kernels a step (torch.profiler), one
   replay's time on the card and the render kernels' launches;
12. drives per-tile face compaction (``RenderConfig.compact='auto'``, the
   default, which phases 1-11 also run where its gate fires): on the
   flagship, its band of rows 128-255, the default GenDR's inputs and a
   scene whose corner tile overflows its slabs, the gate fires and both
   kernels hold against their plain versions with phase 1's gates, the
   forward bitwise compact='off'; rasterize_bwd_slab (K2's launch over
   the appended chunks, a thread per pixel of a chunk's tile, for alpha
   and hard RGB over vertex colours or one texel) alone against its plain
   version wherever it runs, with its blocks and lanes with work; then
   'auto' against 'off' in turns: both kernels per call and back to back,
   the prepass's device kernels and host time, the eager flagship render
   and forward + backward, the default GenDR's forward + backward, visited
   pairs, path (k)'s render at both of its taus (both kernels, K2 back to
   back) and the chained opt_camera --quick step;
13. drives path (k), ``experiments.opt_camera`` at its command line's
   defaults (200 poses at 64x64, logistic x probabilistic, --chain 20, the
   cube stand-in, starting angles 15-35 degrees): (k1) both kernels
   against their plain versions with phase 1's gates on the soft render of
   the first step at B=200, at tau 1e-1 and 1e-7 (the anneal's ends;
   compaction fires: one slab a tile, 3200 blocks of rasterize_bwd_slab,
   held alone against its plain version), each timed beside its bound;
   (k2) 100 annealed steps with --chain 20 against
   --chain 1 from the same poses, bitwise, the first replay's kernels
   against their plain versions, one launch of each kernel a step; (k3)
   each step eager and chained, timed as (j6).  ``--camera-only`` runs it
   alone;
14. holds the prepass kernel (``csrc/prepass.cu``) against the plain
   prepass on the card, every output bit for bit (PREPASS_CASES: the
   benchmark cells' shapes, B=200 and B=256 at 64x64, a face count that
   is no chunk multiple, tied Morton keys, degenerate faces, a face shard's
   band, surface and vertex textures, the flagship at 256x256 with
   compaction off, the kernel's whole sort of 16384 faces), a captured prepass replayed against the eager one, the
   plain path where compaction fires or the faces pass the kernel's sort,
   one kernel prepass a forward at the cells' shapes; then, at the cells'
   shapes, the kernel and the plain prepass captured in graphs and
   replayed, beside the byte bound.  ``--prepass-only`` runs it alone, with
   ptxas's report of the kernel.

Every failure raises, and the script then exits non-zero.  It exits
non-zero with no result where there is no CUDA device.  The last line of
its output is one JSON object naming the device; the one before it the
card's name and power limit; the one before that the kernels (six:
rasterize_fwd, rasterize_bwd, rasterize_bwd_slab, the two probes and the
prepass).
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

IMG_TOL = 2e-3        # max |image| difference (tools/tpu_selfcheck.py:404-409)
WINNER_AGREE = 0.999  # share of covered pixels whose winner face agrees
# gradient agreement: share of entries within np.isclose(atol, rtol)
# (tools/tpu_selfcheck.py:407-409)
GRAD_ATOL, GRAD_RTOL, GRAD_AGREE = 5e-4, 5e-3, 0.99
TRAIN_STEPS = 30
TRAIN_LR, TRAIN_SIGMA = 10 ** -1.5, 1e-2
# the panda_dist sweep as its users run it on the card: its defaults
# (--resolution 768 with 2x anti-aliasing: a 1536x1536 render, texture_res 5)
PANDA_ARGS = ['--quick', '--device', 'cuda']
PANDA_FRAMES = 14  # --quick: 2 distributions x 7 taus
GENDR_VIEWS = 4
# path (l): backend='torch' over a surface texture above the kernels'
# softmax cap (cuda_backend.SOFTMAX_TS_CAP = 1024 texels a face), where it
# is the only backend on the card: 33 x 33 texels a face, the smallest
# size above the cap
TORCH_TEXEL_RES = 33
# path (c): the t-conorm sweeps as their users run them on the card, and the
# frames they make: 11 configurations x 7 taus, 3 families x 8 values of p,
# and --quick's 2 configurations x 7 taus of the triangle
TCN_ARGS = ['--quick', '--device', 'cuda']
TCN_FRAMES = (77, 24, 14)
# path (d): training with a parametric fold
YAGER_ARGS = ['--aggr-func', 'yager', '--t_conorm_p', '2']
# a full-width yager frame through backend='cuda' (a serial fold) against
# backend='torch' (the butterfly's grouping): the image gate.  Measured
# 2.07e-4 on an NVIDIA H100 80GB HBM3 at 700 W, beside 2.2e-4 for the
# probabilistic frame of panda_dist: the two backends' pair math, not the
# fold order, sets it
TCN_VS_TORCH_TOL = IMG_TOL
# what kernel vs torch on the card may differ by, per kind of probe op,
# for the render gates to hold (image 2e-3 on [0, 1]; gradients rtol 5e-3):
# one function or IEEE operation 2 ulp; a coverage (cdf, fold) 1e-5
# absolute, two orders under the image gate after a pixel folds a hundred
# pairs; a derivative or a chain 1e-4 of max(|value|, 1), well under the
# gradient gate's rtol
ULP_BUDGET = dict(primitive=('max_ulp', 2), cdf=('max_abs', 1e-5),
                  fold=('max_abs', 1e-5), pdf=('max_rel', 1e-4),
                  fold_backward=('max_rel', 1e-4), chain=('max_rel', 1e-4))
# path (e): the OBJ file's texels per face edge (load_obj's maximum in the
# reference), the sweep through GENDR_PANDA_OBJ, and how far the image may
# differ from backend='torch': on the fold of the texel grid the two
# backends' last ulp picks one of two texels (ROADMAP.md Queue 3), so a
# share of pixels may differ by more than IMG_TOL
OBJ_TEXTURE_RES = 16
OBJ_PANDA_ARGS = PANDA_ARGS + ['--texture-res', str(OBJ_TEXTURE_RES)]
FOLD_BUDGET = 0.01
# path (f): the surface pass marks every cell a face crosses and its lower
# neighbours along two axes, which thickens the solid ball by about 0.7 of
# a cell (0.76 at 32^3, 0.65 at 64^3): its count is held to the volume of
# the ball of radius R + VOXEL_SHELL cells within VOXEL_TOL
VOXEL_SIZES = (32, 64)
VOXEL_SHELL, VOXEL_TOL = 0.7, 0.05
# path (g)
CAMERA_ARGS = ['--quick', '--device', 'cuda', '--chain', '1']
# path (h): the sharded render.  Row bands of the flagship (two halves of
# the image and a ragged band whose last tile row is cut), on the flagship
# and on alpha-only, softmax (25 texels) and yager p=2 variants (name,
# RenderConfig keywords, p, texels per face); the ranks of one card, each
# its own process; and (h3)'s training: dp=2 x fp=2 over 24 views at 64x64
# of the 642-vertex template, 10 Adam steps at the dry run's lr
BANDS = ((0, 128), (128, 128), (37, 100))
BAND_CASES = [('flagship', {}, 0.0, 1),
              ('alpha', dict(channels='alpha'), 0.0, 1),
              ('softmax25', dict(aggr_rgb_func='softmax'), 0.0, 25),
              ('yager', dict(aggr_alpha_func='yager'), 2.0, 1)]
SHARD_RANKS = 4
SHARD_VIEWS, SHARD_SIZE, SHARD_STEPS, SHARD_LR = 24, 64, 10, 1e-2
SHARD_TIMEOUT = 300  # seconds the ranks of (h2) and (h3) may take
# (h3)'s first sharded gradient against the unsharded one: the largest
# norm-relative error (the gradient's entries are ~1e-2, where GRAD_ATOL
# alone would pass a lost share of a face shard)
SHARD_GRAD_REL = 1e-4
# path (i): train_reconstruction at its published width (Encoder 64 / 1024 /
# 512, Decoder 1024 wide on the 642-vertex template, batch 64 at 64x64,
# uniform x probabilistic at the table's tau 10^-1.5) on the three synthetic
# classes, the dataset cut to RECON_OBJECTS objects a class (64 in a full
# run); (i3)'s dp ranks and its bound against the one-process step; the
# share of (i4)'s silhouette pixels that must equal the CPU's (a pixel
# centre on a face edge is a tie the card's and the CPU's camera transforms
# may break apart); (i5)'s timed steps
RECON_CLASSES = ('syn_ellipsoid', 'syn_box', 'syn_peanut')
RECON_OBJECTS, RECON_STEPS, RECON_TIMED_STEPS = 8, 30, 10
RECON_DP_RANKS, RECON_DP_REL = 2, 1e-4
# (i3) runs at these seeds: the spread of its parameter difference
RECON_DP_SEEDS = (0, 1, 2)
# (i3)'s floor, at every seed: in one process, the batch in these many
# other orders (reversed, then permutations drawn from the seed); the dp
# step's parameters may differ from one process's by at most
# RECON_DP_FLOOR_K times the largest of them (the dp run sums the same
# batch in another order too: over the seeds 0-2 its difference was 0.5,
# 1.9 and 0.9 times the reversed batch's alone, on an NVIDIA H100 80GB
# HBM3 at 700 W)
RECON_DP_REORDERS, RECON_DP_FLOOR_K = 4, 2.0
# and tensor by tensor: the gradient (Adam's first moment) of each
# parameter tensor within RECON_DP_GRAD_TENSOR_K times that tensor's floor,
# at every seed (measured: within 1.20 times over 4 reorders, 1.01 over 16,
# on an NVIDIA H100 80GB HBM3 at 700 W).  The parameters after Adam's first
# step are printed tensor by tensor but gated only as the whole vector:
# that step, -lr g / (|g| + 1e-8), moves an entry whose |g| is near 1e-8
# by anything up to lr, so one ulp of such a gradient can set a tensor's
# ratio (4.70 times over 4 reorders, one ulp over a floor of 0 over 16)
RECON_DP_GRAD_TENSOR_K = 1.5
# the gradient's bound: in one process, reordering the batch of 64
# (BatchNorm's sums in another order) moved the whole gradient by 1.9e-3
# norm-relative on an NVIDIA H100 80GB HBM3 at 700 W (the uniform CDF's PDF
# is a box, and a pair within an ulp of its edge adds or drops 1 / 2 tau);
# a gradient not averaged over the ranks is off by a factor 2
RECON_DP_GRAD_REL = 1e-2
RECON_SIL_AGREE = 0.999
# path (j): --chain of the three experiments, each at its path's width, the
# chained run against the eager one (--chain 1) from the same start: (j1)
# opt_shape, phase 3's setting; (j2) opt_camera --quick; (j3)
# train_reconstruction at path (i)'s width, --decay-at inside the first
# block of 8 (blocks of 5, 8 and 3).  Losses and parameters bitwise equal
# (every sum of the training paths runs in a fixed order), with no
# deterministic algorithms asked for; each timed over CHAIN_TIMED_BLOCKS
# blocks of the chain's length after the comparison
CHAIN_SHAPE, CHAIN_CAMERA, CHAIN_RECON = 10, 20, 8
CHAIN_RECON_STEPS, CHAIN_RECON_DECAY = 16, 6
CHAIN_TIMED_BLOCKS = 3
# the first range of the camera experiment's starting angles, which (j2)
# and path (k) run; path (k): opt_camera at its command line's defaults
# (200 poses at 64x64, logistic x probabilistic, lr 0.3, dist-eps 100,
# --chain 20, the cube stand-in): (k1) the kernels at the anneal's first
# and last tau; (k2) CAMERA_DEFAULT_STEPS steps (5 blocks of 20) chained
# against eager
CAMERA_RANGE = (15, 35)
CAMERA_DEFAULT_TAUS = (1e-1, 1e-7)
CAMERA_DEFAULT_STEPS = 100
# (j2)'s Adam against optax's rule: test_torch_camera.py's tolerance
ADAM_RTOL, ADAM_ATOL = 1e-5, 1e-6
# the backend='torch' frame of phase 4b peaked at 52.6 GiB before its
# pixel bands (torch_backend.PAIR_BUDGET); above this it fails
TORCH_PEAK_GIB = 16.0
# the card's peaks (NVIDIA's H100 SXM data sheet, at a 700 W power limit):
# float32 outside the tensor cores and HBM bandwidth
H100_FP32_FLOPS, H100_HBM_BYTES = 67e12, 3.35e12
# float operations per (pixel, face) pair inside the bbox gate, counted in
# csrc/rasterize_{fwd,bwd}.cu with the uniform CDF (one per add, multiply,
# divide, compare, min/max or transcendental): the pair math and alpha
# fold, plus the hard-RGB depth key or the softmax depth, exponentials,
# texel gather and blend; the backward adds the closest feature, the PDF
# chain and, for softmax, the colour, z and texture chain
FWD_FLOPS_PER_PAIR = (73, 81, 121)   # by cuda_backend.MODE_*
BWD_FLOPS_PER_PAIR = (110, 120, 190)
# those counts hold the probabilistic fold (2 operations) and its
# aggregate-inverse rule (4); a parametric family's fold_step and
# aggregate_backward take their place, counted in csrc/pairmath.cuh the
# same way (a powf, logf or expm1f is one): by config.py's t-conorm id
FOLD_FLOPS = {4: 13, 5: 13, 6: 9, 7: 20, 8: 19, 9: 12}
FOLD_BWD_FLOPS = {4: 18, 5: 13, 6: 6, 7: 18, 8: 17, 9: 16}


def render_launches(fwd, bwd, slab=0):
    """The render kernels' counts (cuda_backend.LAUNCHES) a run should
    leave: the forward, the backward, and of the backward's calls those
    that launched rasterize_bwd_slab over compaction's appended chunks
    (alpha or hard RGB over vertex colours or one texel, compacted)."""
    return {'rasterize_fwd': fwd, 'rasterize_bwd': bwd,
            'rasterize_bwd_slab': slab}


def render_counts(launches):
    """The render kernels' counts of a cuda_backend.LAUNCHES snapshot, the
    prepass kernel's left out (a path's shapes decide whether its prepass
    takes the kernel; phase 14 checks that count)."""
    return {k: launches[k] for k in render_launches(0, 0)}


# the kernels every backward render launches (rasterize_bwd_slab runs only
# where compaction fires)
RENDER_KERNELS = ('rasterize_fwd', 'rasterize_bwd')


def flops_per_pair(cfg, mode):
    """(forward, backward) float operations per gated pair of cfg."""
    tid = cfg.aggr_alpha_func
    return (FWD_FLOPS_PER_PAIR[mode] + FOLD_FLOPS.get(tid, 2) - 2,
            BWD_FLOPS_PER_PAIR[mode] + FOLD_BWD_FLOPS.get(tid, 4) - 4)


def smi_line():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()


def _template_name(mangled):
    """The name of a templated kernel in its mangled entry name: the
    identifier whose length prefix is followed by its template arguments
    (the anonymous namespace's hash may end in digits, so every suffix of
    a run of digits is tried)."""
    import re
    for m in re.finditer(r'(?=(\d+))', mangled):
        n, start = int(m.group(1)), m.start() + len(m.group(1))
        name = mangled[start:start + n]
        if mangled.startswith('ILi', start + n) and name.isidentifier():
            return name
    return ''


def ptxas_summary(report):
    """Per kernel instantiation of a ptxas -v report, one line: the
    kernel's name and template arguments (for the render kernels ALPHA,
    MODE of csrc/pairmath.cuh) or, for a kernel that has none, its entry
    name, its registers and its spills."""
    import re
    lines, entry = [], ''
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            args = re.findall(r'Li(\d+)E', m.group(1))
            entry = (_template_name(m.group(1)) + '<' + ', '.join(args) + '>'
                     if args else m.group(1))
        elif 'spill' in line:
            lines.append(f'{entry} {line.split(":", 1)[-1].strip()}')
        elif 'registers' in line:
            lines[-1] += '; ' + line.split(':', 1)[-1].strip()
    return lines


def flagship_scene(device, B=1, seed=0, TS=1, texture_type='surface'):
    """Face vertices [B, 1280, 9] of the 642-vertex icosphere (x0.9) seen
    from distance 2.732, elevation 30 deg, azimuths 45 + 90*i, perspective
    30 deg, and random textures: TS texels per face [B, 1280, TS, 3], or
    three vertex colours per face [B, 1280, 3, 3]."""
    import torch
    from gendr_tpu_torch import data
    from gendr_tpu_torch.geometry import core, transforms as T
    v, f = data.icosphere(3)
    verts = torch.as_tensor(v, device=device)[None].expand(B, -1, -1) * 0.9
    eyes = T.get_points_from_angles(
        torch.full((B,), 2.732), torch.full((B,), 30.0),
        45.0 + 90.0 * torch.arange(B, dtype=torch.float32))
    verts = T.perspective(T.look_at(verts, eyes.to(device)), 30.0)
    faces = torch.as_tensor(f, device=device)[None].expand(B, -1, -1)
    fv = core.face_vertices(verts, faces).reshape(B, -1, 9).contiguous()
    ts = 3 if texture_type == 'vertex' else TS
    tex = np.random.RandomState(seed).rand(B, fv.shape[1], ts, 3)
    return fv, torch.as_tensor(tex, dtype=torch.float32, device=device)


CASES = [
    # name, RenderConfig keywords, batch, image size
    ('flagship', {}, 1, 256),
    ('alpha', dict(channels='alpha'), 1, 256),
    ('max', dict(aggr_alpha_func='max'), 1, 256),
    ('hard', dict(aggr_alpha_func='hard'), 1, 256),
    ('einstein', dict(aggr_alpha_func='einstein'), 1, 256),
    ('ragged100', {}, 1, 100),
    ('batch4', {}, 4, 256),
]
# K1b/K2b: softmax RGB and textures on the same scene; name, RenderConfig
# keywords, batch, image size, texels per face
TEXTURE_CASES = [
    ('softmax1', dict(aggr_rgb_func='softmax'), 1, 256, 1),
    ('softmax25', dict(aggr_rgb_func='softmax'), 1, 256, 25),
    ('softmax36', dict(aggr_rgb_func='softmax'), 1, 256, 36),
    ('softmaxvtx', dict(aggr_rgb_func='softmax', texture_type='vertex'), 1,
     256, 1),
    ('hard25', {}, 1, 256, 25),
    ('hardvtx', dict(texture_type='vertex'), 1, 256, 1),
    ('softmax25b4', dict(aggr_rgb_func='softmax', double_side=False), 4, 256,
     25),
]

# K1c/K2c: the six parametric t-conorms on the same scene, each at the
# parameter of animations/t_conorms.py; name, RenderConfig keywords, p,
# texels per face.  The flagship's CDF is the uniform one, so these hold
# frank (and the rest) where coverage saturates at exactly 1
_FAMILIES = [('hamacher', 0.5), ('frank', 2.0), ('yager', 2.0),
             ('aczel_alsina', 2.0), ('dombi', 2.0),
             ('schweizer_sklar', -2.0)]
T_CONORM_CASES = (
    [(f'{fam[:8]} a', dict(aggr_alpha_func=fam, channels='alpha'), p, 1)
     for fam, p in _FAMILIES]
    + [(f'{fam[:8]} h', dict(aggr_alpha_func=fam), p, 1)
       for fam, p in _FAMILIES]
    + [('yager sm25', dict(aggr_alpha_func='yager', aggr_rgb_func='softmax'),
        0.5, 25),
       ('frank sm25', dict(aggr_alpha_func='frank', aggr_rgb_func='softmax'),
        2.0, 25),
       ('frank logis', dict(aggr_alpha_func='frank', dist_func='logistic'),
        0.5, 1)])


# K1d/K2d: surface textures above 36 texels per face on the same scene;
# name, RenderConfig keywords, p, texels per face.  49 keeps its sums in
# shared memory, 256 and above in global memory; one case is single-sided,
# one folds with yager
BIG_TEXTURE_CASES = [
    ('softmax49', dict(aggr_rgb_func='softmax'), 0.0, 49),
    ('hard49', {}, 0.0, 49),
    ('softmax256ss', dict(aggr_rgb_func='softmax', double_side=False), 0.0,
     256),
    ('hard256', {}, 0.0, 256),
    ('softmax1024y', dict(aggr_rgb_func='softmax', aggr_alpha_func='yager'),
     2.0, 1024),
    ('hard1024', {}, 0.0, 1024),
    ('hard1089', {}, 0.0, 1089),
]


def flagship_cfg(image_size=256, **kw):
    from gendr_tpu_torch import config as C
    args = dict(image_size=image_size, dist_func='uniform',
                aggr_alpha_func='probabilistic', aggr_rgb_func='hard',
                backend='cuda')
    args.update(kw)
    return C.RenderConfig.create(**args)


def grads_through(cfg, params, fv, tex, kernel, aux=None):
    """(grad_face_vertices, grad_textures) of 0.5 sum(alpha^2) + 0.1
    sum(rgb) (tools/tpu_selfcheck.py:380-382) through the forward and the
    backward kernels (kernel=True) or through their plain versions; each
    side's backward reads its own forward's image."""
    from gendr_tpu_torch.raster import cuda_backend as CB
    aux = aux or CB.prepass(fv, tex, cfg, params)
    TS = tex.shape[2]
    band = (aux['row0'], aux['height'])
    fwd = CB.rasterize_fwd if kernel else CB.rasterize_fwd_plain
    bwd = CB.rasterize_bwd if kernel else CB.rasterize_bwd_plain
    out = fwd(aux['tile_counts'], aux['tile_ids'], aux['par'], aux['packed'],
              aux['perm'], cfg, TS, *band)
    rows = bwd(*backward_args(aux, cfg, params, TS, out))
    return CB.unpermute_grads(rows, aux['perm'], tex, cfg,
                              aux.get('oct_ids'))


def backward_args(aux, cfg, params, TS, out):
    """The backward kernel's arguments on the prepass aux, its band and
    its sorted chunks, with the pixel columns of the gradient of 0.5
    sum(alpha^2) + 0.1 sum(rgb) (tools/tpu_selfcheck.py:380-382) at the
    forward kernel's output out."""
    import torch
    from gendr_tpu_torch.raster import cuda_backend as CB
    soft, aggrs = CB._finalize_soa(out, cfg, params)
    # d loss / d soft_colors
    g = torch.cat([torch.full_like(soft[:, :3], 0.1), soft[:, 3:]], dim=1)
    pix = CB.pixel_columns(soft, aggrs, g, cfg)
    return (aux['chunk_counts'], aux['chunk_ids'], aux['par'], aux['packed'],
            aux['perm'], pix, cfg, TS, aux['row0'], aux['height'],
            CB.sorted_face_count(aux) // cfg.face_chunk)


def agreement(got, want):
    """Share of entries with np.isclose(got, want, GRAD_ATOL, GRAD_RTOL)."""
    got = got.detach().cpu().numpy()
    want = want.detach().cpu().numpy()
    return float(np.isclose(got, want, atol=GRAD_ATOL,
                            rtol=GRAD_RTOL).mean())


def check_kernels(name, cfg, params, fv, tex, aux=None):
    """Each kernel against its plain version on one input (the band of
    rows and the faces its prepass aux holds): the image, the winner ids
    (hard RGB: none may differ), the gradient of each side through its own
    forward, and the backward kernel twice, bitwise equal.  Prints one line
    and raises on a failed gate; returns (img_err, grad_err)."""
    import torch
    from gendr_tpu_torch import config as C
    from gendr_tpu_torch.raster import cuda_backend as CB
    aux = aux or CB.prepass(fv, tex, cfg, params)
    args = (aux['tile_counts'], aux['tile_ids'], aux['par'], aux['packed'],
            aux['perm'], cfg, tex.shape[2], aux['row0'], aux['height'])
    got_k = CB.rasterize_fwd(*args)
    got_p = CB.rasterize_fwd_plain(*args)
    torch.cuda.synchronize()
    soft_k, ag_k = CB._finalize_soa(got_k, cfg, params)
    soft_p, ag_p = CB._finalize_soa(got_p, cfg, params)
    img_err = float((soft_k - soft_p).abs().max())
    alpha = soft_p[:, 3]
    partial = float(((alpha > 0) & (alpha < 1)).float().mean())
    B, size = fv.shape[0], cfg.image_size
    rows = '' if aux['height'] == size else \
        f' rows {aux["row0"]}+{aux["height"]}'
    if 'oct_ids' in aux:
        rows += (f' compacted ({aux["packed"].shape[2]} columns for '
                 f'{CB.sorted_face_count(aux)} faces)')
    line = (f'[kernel vs plain] {name:11s} B={B} {size}x{size}{rows} '
            f'F={fv.shape[1]} TS={tex.shape[2]}: img_err={img_err:.3g} '
            f'alpha_err={float((soft_k[:, 3] - alpha).abs().max()):.3g} '
            f'alpha_partial={partial:.4f}')
    if CB.render_mode(cfg) == CB.MODE_HARD:
        ids_k, ids_p = ag_k[:, 1], ag_p[:, 1]
        covered = (ids_k >= 0) | (ids_p >= 0)
        flips = int((covered & (ids_k != ids_p)).sum())
        line += f' flips={flips} of {int(covered.sum())} covered'
        if flips:
            raise AssertionError(f'{name}: {flips} winner flips')
    elif CB.render_mode(cfg) == CB.MODE_SOFTMAX:
        rel = ((ag_k - ag_p).abs() / ag_p.abs().clamp(min=1e-6)).amax()
        line += f' softmax_aggr_rel_err={float(rel):.3g}'

    gk = grads_through(cfg, params, fv, tex, True, aux)
    gk2 = grads_through(cfg, params, fv, tex, True, aux)
    gp = grads_through(cfg, params, fv, tex, False, aux)
    torch.cuda.synchronize()
    grad_agree = agreement(gk[0], gp[0])
    tex_agree = agreement(gk[1], gp[1])
    grad_err = float((gk[0] - gp[0]).abs().max())
    grad_scale = float(gp[0].abs().max())
    bitwise = all(torch.equal(a, b) for a, b in zip(gk, gk2))
    # where the CDF is nearly a step (tau 1e-7) a handful of entries are
    # not zero, and agreement is won mostly by zeros: print how many
    nonzero = '/'.join(str(int((g[0] != 0).sum())) for g in (gk, gp))
    line += (f' | grad_agree={grad_agree:.6f} '
             f'texgrad_agree={tex_agree:.6f} grad_err={grad_err:.3g} '
             f'grad_scale={grad_scale:.3g} grad_nonzero={nonzero} '
             f'texgrad_scale={float(gp[1].abs().max()):.3g} '
             f'bitwise_repeat={bitwise}')
    print(line, flush=True)
    if not img_err < IMG_TOL:
        raise AssertionError(f'{name}: img_err {img_err} >= {IMG_TOL}')
    if not (grad_agree > GRAD_AGREE and tex_agree > GRAD_AGREE):
        raise AssertionError(f'{name}: gradient agreement {grad_agree}, '
                             f'texture {tex_agree}')
    if not bitwise:
        raise AssertionError(f'{name}: two backward runs differ')
    # a step's PDF is 0: the heaviside renderer has no geometry gradient;
    # elsewhere the gradient must lie well above the absolute tolerance,
    # so that agreement is not won by the tolerance alone
    if cfg.dist_func != C.HEAVISIDE and not grad_scale > 100 * GRAD_ATOL:
        raise AssertionError(f'{name}: geometry gradient {grad_scale}')
    if slab_route(aux, cfg, tex.shape[2]):
        check_slab(name, cfg, params, aux, tex.shape[2], got_k)
    return img_err, grad_err


# rasterize_bwd_slab against its plain version: one entry per input that
# check_kernels held it on (the kernels line's max_abs_err)
SLAB_CHECKS = []


def check_slab(name, cfg, params, aux, TS, out):
    """rasterize_bwd_slab alone against its plain version on one compacted
    input: the appended chunks' columns of K2's rows, from the same pixel
    columns (those of the forward kernel's output out), with phase 1's
    gates on the xy and the texture rows.  Prints the launch's blocks and
    its lanes with work (slab_lanes)."""
    import torch
    from gendr_tpu_torch.raster import cuda_backend as CB
    Fs = CB.sorted_face_count(aux)
    bargs = backward_args(aux, cfg, params, TS, out)
    n0 = CB.LAUNCHES['rasterize_bwd_slab']
    got = CB.rasterize_bwd(*bargs)[..., Fs:]
    if CB.LAUNCHES['rasterize_bwd_slab'] != n0 + 1:
        raise AssertionError(f'{name}: rasterize_bwd_slab was not launched')
    want = CB.rasterize_bwd_plain(*bargs)[..., Fs:]
    torch.cuda.synchronize()
    xy = agreement(got[:, :6], want[:, :6])
    tx = agreement(got[:, 6:], want[:, 6:]) if got.shape[1] > 6 else 1.0
    err = float((got - want).abs().max())
    lanes = slab_lanes(aux, cfg)
    nb = lanes['blocks']
    SLAB_CHECKS.append(dict(name=name, err=err, xy=xy, tex=tx, **lanes))
    print(f'[slab] {name}: {nb} blocks; lanes with work, a thread per slot '
          f'{lanes["slot_lanes"] / (nb * cfg.face_chunk):.4f}, a thread per '
          f'pixel (rasterize_bwd_slab) {lanes["before_cull"] / (nb * 256):.4f}'
          f' before the cull, {lanes["after_cull"] / (nb * 256):.4f} after; '
          f'{lanes["pairs"]:.6g} gated pairs; the slab columns against the '
          f'plain version: grad_agree={xy:.6f} texgrad_agree={tx:.6f} '
          f'err={err:.3g} scale={float(want.abs().max()):.3g} nonzero '
          f'{int((got != 0).sum())}/{int((want != 0).sum())}', flush=True)
    if not (xy > GRAD_AGREE and tx > GRAD_AGREE):
        raise AssertionError(f'{name}: slab columns agree {xy}, {tx}')


def t_conorm_inputs(kw, p, ts, device='cuda'):
    """(cfg, params, face vertices, textures) of a T_CONORM_CASES entry."""
    from gendr_tpu_torch import config as C
    params = C.RenderParams(dist_scale=1e-2,
                            aggr_alpha_t_conorm_p=p).as_dict()
    return (flagship_cfg(256, **kw), params,
            *flagship_scene(device, TS=ts))


def training_inputs(device='cuda', extra=()):
    """The inputs the shape optimizer gives the kernels (phase 3): its soft
    renderer (logistic sigma 1e-2, probabilistic, alpha) and its hard
    renderer (heaviside, hard alpha, squared distance) on the 642-vertex
    template from 24 views at 64x64, the first step's scene; the hard
    renderer on the 120 goal views of the cube.  extra: further opt_shape
    arguments.  Yields (name, cfg, params, face vertices, textures)."""
    import torch
    from gendr_tpu_torch.raster.render import render_config
    exp, eyes, _ = _shape_experiment(None, device, extra)
    exp.diff_renderer.dist_scale = TRAIN_SIGMA
    with torch.no_grad():
        template, _, _ = exp.model_mesh(eyes)
        _, goal = exp.goal_mesh(exp.args.model_obj)
    for name, renderer, mesh in (('opt soft', exp.diff_renderer, template),
                                 ('opt hard', exp.hard_renderer, template),
                                 ('opt goal', exp.hard_renderer, goal)):
        cfg, params = render_config(**renderer.render_kwargs())
        fv = mesh.face_vertices
        fv = fv.reshape(fv.shape[0], fv.shape[1], 9).contiguous()
        yield name, cfg, params, fv, mesh.face_textures.contiguous()


def panda_inputs(device='cuda', size=256, dist_func='gaussian', tau=1e-2,
                 texture_res=5, **renderer_kw):
    """The panda_dist sweep's renderer (renderer_kw apart) at a render size
    of size x size (its GenDR renders at twice --resolution) on its scene,
    the textured stand-in (TS=25 at its default) or the mesh
    GENDR_PANDA_OBJ names: (cfg, params, face vertices, textures)."""
    from gendr_tpu_torch.animations import panda_dist as PD
    from gendr_tpu_torch.raster.render import render_config
    args = PD.parse_args(['--resolution', str(size // 2), '--device',
                          device, '--texture-res', str(texture_res)])
    fv, tex = PD.scene(args.texture_res, device)
    r = PD.renderer(args, dist_func, 0)
    r.dist_scale = tau
    cfg, params = render_config(**{**r.render_kwargs(), **renderer_kw})
    return cfg, params, fv.reshape(1, -1, 9).contiguous(), tex.contiguous()


def tcn_inputs(device='cuda', size=256, t_conorm='yager', p=2.0, tau=1e-2):
    """The panda_tcn sweep's renderer at a render size of size x size on
    its scene: (cfg, params, face vertices, textures)."""
    from gendr_tpu_torch.animations import panda_tcn as TCN
    from gendr_tpu_torch.raster.render import render_config
    args = TCN.parse_args(['--resolution', str(size // 2), '--device',
                           device])
    fv, tex = TCN.scene(args)
    cfg, params = render_config(
        **TCN.renderer(args, t_conorm, p, tau).render_kwargs())
    return cfg, params, fv.reshape(1, -1, 9).contiguous(), tex.contiguous()


def make_obj(out_dir):
    """Path (e)'s asset: the textured stand-in baked into an OBJ, its MTL
    and a PNG atlas by obj_io.save_obj at OBJ_TEXTURE_RES.  Returns the
    OBJ's path."""
    from gendr_tpu_torch import data
    from gendr_tpu_torch.geometry import obj_io
    v, f, tex = data.textured_scene(OBJ_TEXTURE_RES)
    path = os.path.join(out_dir, 'stand_in.obj')
    obj_io.save_obj(path, v, f, tex[0], texture_res=OBJ_TEXTURE_RES)
    return path


def obj_scene(obj_path, texture_res=OBJ_TEXTURE_RES):
    """(vertices, faces, textures, texture_res) of the OBJ on the card."""
    from gendr_tpu_torch.geometry import obj_io
    v, f, tex = obj_io.load_obj(obj_path, load_texture=True,
                                texture_res=texture_res, device='cuda')
    return v, f, tex, texture_res


def gendr_path(texture_type, backend=None, scene=None, times=None,
               **renderer_kw):
    """Mesh -> Lighting -> LookAt -> GenDR(anti_aliasing=True) with the
    renderer's defaults (256x256 rendered at 512x512, softmax RGB, uniform
    tau 1e-2, probabilistic, single-sided) on the textured stand-in
    (texture_res 5, TS=25; or random vertex colours), or on scene =
    (vertices, faces, textures, texture_res), from GENDR_VIEWS
    views, and loss.backward() of 0.5 sum(alpha^2) + 0.1 sum(rgb) to the
    vertices and textures.  Where times is a dict, it gets 'forward_ms'
    (the mesh to the loss) and 'backward_ms', host clock, each ended by a
    synchronise.  Returns (image, face vertices [B, F, 9] and textures as
    the renderer took them, the gradients of the face vertices, vertices
    and textures)."""
    import torch
    import gendr_tpu_torch as G
    from gendr_tpu_torch import data
    v, f, tex, res = scene or (*data.textured_scene(5), 5)
    if texture_type == 'vertex':
        tex = np.random.RandomState(0).rand(v.shape[0], 3)
    verts = torch.as_tensor(v, device='cuda').clone().requires_grad_(True)
    tex = torch.as_tensor(tex, dtype=torch.float32, device='cuda').clone() \
        .requires_grad_(True)
    if times is not None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
    mesh = G.Mesh.create(verts, f, tex, res if texture_type == 'surface'
                         else 1, texture_type).repeat(GENDR_VIEWS)
    look = G.LookAt().to('cuda')
    views = torch.full((GENDR_VIEWS,), 1.0)
    look.set_eyes_from_angles(2.732 * views, 30.0 * views,
                              90.0 * torch.arange(GENDR_VIEWS))
    mesh = look(G.Lighting().to('cuda')(mesh))
    fv = mesh.face_vertices
    fv.retain_grad()
    ftex = mesh.face_textures
    img = G.GenDR(anti_aliasing=True, texture_type=texture_type,
                  backend=backend, **renderer_kw).forward_tensors(fv, ftex)
    loss = 0.5 * (img[:, 3] ** 2).sum() + 0.1 * img[:, :3].sum()
    if times is not None:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    loss.backward()
    if times is not None:
        torch.cuda.synchronize()
        times['forward_ms'] = 1e3 * (t1 - t0)
        times['backward_ms'] = 1e3 * (time.perf_counter() - t1)
    B = fv.shape[0]
    return (img.detach(), fv.detach().reshape(B, -1, 9).contiguous(),
            ftex.detach().contiguous(), fv.grad.reshape(B, -1, 9),
            verts.grad, tex.grad)


def gendr_inputs():
    """The kernels' inputs on path (b), the default GenDR: yields (name,
    cfg, params, face vertices, textures) for surface and vertex
    textures."""
    import gendr_tpu_torch as G
    from gendr_tpu_torch.raster.render import render_config
    for texture_type in ('surface', 'vertex'):
        _, fv, tex, *_ = gendr_path(texture_type)
        cfg, params = render_config(**G.GenDR(
            anti_aliasing=True, texture_type=texture_type).render_kwargs())
        yield f'gendr {texture_type[:4]}', cfg, params, fv, tex


def obj_gendr_inputs(obj_path, texture_res=OBJ_TEXTURE_RES, **renderer_kw):
    """The kernels' inputs on path (e): the default GenDR (renderer_kw
    apart) on 4 views of the OBJ's mesh: (cfg, params, face vertices,
    textures)."""
    import gendr_tpu_torch as G
    from gendr_tpu_torch.raster.render import render_config
    _, fv, tex, *_ = gendr_path('surface', None,
                                obj_scene(obj_path, texture_res),
                                **renderer_kw)
    cfg, params = render_config(**G.GenDR(
        anti_aliasing=True, **renderer_kw).render_kwargs())
    return cfg, params, fv, tex


def compare_kernels(obj_path):
    """Phase 1: each kernel vs its plain version on each case, on the
    shape optimizer's inputs, on the panda_dist renderer's and on path
    (e)'s.  Returns the largest image error and the largest gradient
    error."""
    from gendr_tpu_torch import config as C
    params = C.RenderParams(dist_scale=1e-2).as_dict()
    worst_img = worst_grad = 0.0
    cases = [(name, flagship_cfg(size, **kw), params,
              *flagship_scene('cuda', B)) for name, kw, B, size in CASES]
    cases += [(name, flagship_cfg(size, **kw), params,
               *flagship_scene('cuda', B, TS=ts,
                               texture_type=kw.get('texture_type',
                                                   'surface')))
              for name, kw, B, size, ts in TEXTURE_CASES]
    cases.append(('panda', *panda_inputs()))
    cases += [(name, *t_conorm_inputs(kw, p, ts))
              for name, kw, p, ts in T_CONORM_CASES]
    cases += [('tcn yager', *tcn_inputs()),
              ('tcn aczel', *tcn_inputs(t_conorm='aczel_alsina', p=0.5))]
    # path (d)'s soft renderer (its hard renderer is phase 3's)
    opt_yager = next(iter(training_inputs(extra=YAGER_ARGS)))
    cases.append(('opt yager', *opt_yager[1:]))
    cases += [(name, *t_conorm_inputs(kw, p, ts))
              for name, kw, p, ts in BIG_TEXTURE_CASES]
    cases.append(('obj gendr', *obj_gendr_inputs(obj_path)))
    for name, cfg, params, fv, tex in [*cases, *gendr_inputs(),
                                       *training_inputs()]:
        img_err, grad_err = check_kernels(name, cfg, params, fv, tex)
        worst_img = max(worst_img, img_err)
        worst_grad = max(worst_grad, grad_err)
    return worst_img, worst_grad


def render_path():
    """Phase 2: Mesh -> Lighting -> LookAt -> GenDR through the public API
    with the default backend, and the gradient of the render to the mesh
    vertices.  Returns each kernel's launches in that run."""
    import torch
    import gendr_tpu_torch as G
    from gendr_tpu_torch import data
    from gendr_tpu_torch.raster import cuda_backend as CB
    v, f = data.icosphere(3)
    look = G.LookAt(viewing_angle=30).to('cuda')
    look.set_eyes_from_angles(2.732, 30.0, 45.0)
    size = 256
    kw = dict(image_size=size, dist_func='uniform', dist_scale=1e-2,
              aggr_alpha_func='probabilistic', aggr_rgb_func='hard')

    def run(backend):
        verts = torch.tensor(v * 0.9, device='cuda', requires_grad=True)
        mesh = G.Mesh.create(verts, f)
        img = G.GenDR(backend=backend, **kw)(look(G.Lighting()(mesh)))
        loss = 0.5 * (img[:, 3] ** 2).sum() + 0.1 * img[:, :3].sum()
        loss.backward()
        return img.detach(), verts.grad

    for k in CB.LAUNCHES:
        CB.LAUNCHES[k] = 0
    img, grad = run(None)
    torch.cuda.synchronize()
    launches = dict(CB.LAUNCHES)

    ref, ref_grad = run('torch')
    err = float((img - ref).abs().max())
    grad_agree = agreement(grad, ref_grad)
    alpha = img[0, 3]
    coverage = float((alpha > 0.5).float().mean())
    c = size // 2
    centre = img[0, :3, c, c]
    print(f'[render path] {tuple(img.shape)} launches={launches} '
          f'img_err_vs_torch_backend={err:.3g} '
          f'vertex_grad_agree_vs_torch_backend={grad_agree:.6f} '
          f'grad_err={float((grad - ref_grad).abs().max()):.3g} '
          f'grad_scale={float(ref_grad.abs().max()):.3g} '
          f'coverage={coverage:.4f} '
          f'centre_rgb={[round(float(x), 4) for x in centre]}', flush=True)
    if tuple(img.shape) != (1, 4, size, size):
        raise AssertionError(f'shape {tuple(img.shape)}')
    if not (bool(torch.isfinite(img).all())
            and bool(torch.isfinite(grad).all())):
        raise AssertionError('non-finite image or gradient')
    if not err < IMG_TOL:
        raise AssertionError(f'render path vs torch backend: {err}')
    if not grad_agree > GRAD_AGREE:
        raise AssertionError(f'vertex gradient vs torch backend: '
                             f'{grad_agree}')
    if not 0.1 < coverage < 0.9:
        raise AssertionError(f'alpha coverage {coverage}')
    if not bool((centre > 0.25).all()):
        raise AssertionError(f'centre pixel not lit: {centre}')
    for k in RENDER_KERNELS:
        if launches[k] < 1:
            raise AssertionError(f'the render path never launched {k}')
    return launches


@contextlib.contextmanager
def compaction(mode):
    """Renders within run with per-tile face compaction as RenderConfig.
    compact = mode says: 'auto' is every render's default (GenDR has no
    compact keyword, as gendr_tpu's has none), and 'off' shuts the gate
    (cuda_backend._compact_eligible) for a comparison of the two."""
    from gendr_tpu_torch.raster import cuda_backend as CB
    gate = CB._compact_eligible
    if mode == 'off':
        CB._compact_eligible = lambda cfg, allow_compact: False
    try:
        yield
    finally:
        CB._compact_eligible = gate


def overflow_scene(device='cuda'):
    """384 tiny faces clustered in one corner of a 128x128 image
    (tests/test_pallas.py:818-852): one tile hits 48 octets, more than its
    slabs hold, and falls back to its chunk list.  (face vertices [1,
    384, 9], white textures [1, 384, 1, 3]) from a numpy seed."""
    import torch
    rng = np.random.RandomState(5)
    F = 384
    centers = (rng.rand(F, 1, 2).astype(np.float32) * 0.15
               + np.array([-0.85, 0.65], np.float32))
    tri = centers + rng.randn(F, 3, 2).astype(np.float32) * 0.01
    z = np.full((F, 3, 1), 3.0, np.float32) \
        + rng.rand(F, 3, 1).astype(np.float32)
    fv = np.concatenate([tri, z], -1).reshape(1, F, 9)
    return (torch.from_numpy(fv).to(device),
            torch.ones((1, F, 1, 3), device=device))


def _back_to_back(fn, n=200):
    """ms a call of fn over n calls back to back between two CUDA events
    (the card's queue stays full: the host's latency per call is left
    out), the median of 3 such runs after a warm-up."""
    import torch
    fn()
    runs = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / n)
    return float(np.median(runs))


def _prepass_cost(fv, tex, cfg, params, reps=20, fn=None):
    """(host-clock ms of a prepass, synchronized, median of reps; its
    device kernels from the profiler, None where it shows none).  fn: the
    prepass to run, cuda_backend.prepass where None."""
    import torch
    from torch import profiler
    from gendr_tpu_torch.raster import cuda_backend as CB
    fn = fn or CB.prepass
    times = []
    for _ in range(reps + 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(fv, tex, cfg, params)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    with profiler.profile(activities=[profiler.ProfilerActivity.CPU,
                                      profiler.ProfilerActivity.CUDA]) as pr:
        fn(fv, tex, cfg, params)
        torch.cuda.synchronize()
    kernels = sum(e.count for e in pr.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return float(np.median(times[3:])), kernels or None


# phase 14: the prepass kernel (csrc/prepass.cu) against the plain prepass,
# bitwise (tests/test_torch_prepass.py runs the same cases): name, batch,
# faces, image size, prepass_scene's kind, texels per face, RenderConfig
# keywords (flagship_cfg's), RenderParams keywords.  The first three are
# the benchmark's cells: opt_camera (logistic, dist_eps 100) at tau 0.1
# and 1e-7, and the reconstruction's 256 silhouettes (uniform, dist_eps
# 300, tau 10^-1.5)
_CAMERA_CFG = dict(dist_func='logistic', channels='alpha')
PREPASS_CASES = [
    ('camera.blur', 200, 1280, 64, 'views', 1, _CAMERA_CFG,
     dict(dist_scale=1e-1, dist_eps=100.0)),
    ('camera.sharp', 200, 1280, 64, 'views', 1, _CAMERA_CFG,
     dict(dist_scale=1e-7, dist_eps=100.0)),
    ('recon.train', 256, 1280, 64, 'views', 1, dict(channels='alpha'),
     dict(dist_scale=10 ** -1.5, dist_eps=300.0)),
    ('ragged F=1000', 8, 1000, 64, 'views', 1, _CAMERA_CFG, {}),
    ('key ties', 8, 1280, 64, 'ties', 1, _CAMERA_CFG, {}),
    ('degenerate', 8, 1000, 48, 'degenerate', 1, _CAMERA_CFG, {}),
    ('shard band', 8, 1280, 64, 'shard', 1, _CAMERA_CFG, {}),
    ('surface 25', 4, 1000, 64, 'views', 25, dict(aggr_rgb_func='softmax'),
     {}),
    ('vertex', 4, 1280, 64, 'views', 1, dict(texture_type='vertex'), {}),
    ('flagship off', 1, 1280, 256, 'views', 1, dict(compact='off'), {}),
    ('sort full', 2, 16384, 64, 'views', 1, _CAMERA_CFG, {}),
]
# the prepass's outputs that the kernel writes
PREPASS_OUTPUTS = ('packed', 'perm', 'tile_counts', 'tile_ids',
                   'chunk_counts', 'chunk_ids')


def prepass_scene(kind, B, F, device, seed=0, TS=1, texture_type='surface'):
    """(face vertices [B, F, 9], textures, prepass keywords) of a phase 14
    scene: 'views', the 1280-face icosphere's first F faces (repeated past
    1280) seen from B seeded cameras (distance 2.5-4, elevation and
    azimuth N(0, 60) degrees, perspective 30 degrees); 'ties', the same
    with every odd face a copy of the one before and the first quarter
    moved off the image's lower left corner, where their keys clamp to 0;
    'degenerate', the same with point-degenerate faces, faces whose three
    vertices are collinear or two of them equal, and vertices at depth 0;
    'shard', the same with the face-sharded path's keywords (a seeded
    fvalid, the band of rows 16-47, no compaction).  Textures: TS texels a
    face, or three vertex colours."""
    import torch
    from gendr_tpu_torch import data
    from gendr_tpu_torch.geometry import core, transforms as T
    rng = np.random.RandomState(seed)
    v, f = data.icosphere(3)
    verts = torch.as_tensor(v, dtype=torch.float32)[None].expand(B, -1, -1)
    eyes = T.get_points_from_angles(2.5 + 1.5 * rng.rand(B),
                                    60.0 * rng.randn(B), 60.0 * rng.randn(B))
    verts = T.perspective(T.look_at(0.9 * verts, eyes), 30.0)
    faces = torch.as_tensor(np.resize(np.asarray(f), (F, 3)))
    fv = core.face_vertices(verts, faces[None].expand(B, -1, -1)) \
        .reshape(B, F, 9).numpy().astype(np.float32)
    kw = {}
    if kind == 'ties':
        fv[:, 1::2] = fv[:, 0:F - F % 2:2]
        fv[:, :F // 4, [0, 1, 3, 4, 6, 7]] -= 5.0
    elif kind == 'degenerate':
        fv[:, 0::7, 3:6] = fv[:, 0::7, 0:3]
        fv[:, 0::7, 6:9] = fv[:, 0::7, 0:3]
        fv[:, 1::7, 6:9] = 0.5 * (fv[:, 1::7, 0:3] + fv[:, 1::7, 3:6])
        fv[:, 2::7, 3:6] = fv[:, 2::7, 0:3]
        fv[:, 3::7, 2] = 0.0
    elif kind == 'shard':
        kw = dict(fvalid=torch.as_tensor(rng.rand(F) < 0.8, device=device),
                  row_band=(16, 32), allow_compact=False)
    ts = 3 if texture_type == 'vertex' else TS
    tex = rng.rand(B, F, ts, 3).astype(np.float32)
    return (torch.as_tensor(fv, device=device),
            torch.as_tensor(tex, device=device), kw)


def prepass_inputs(case, device):
    """(name, cfg, params, face vertices, textures, prepass keywords) of
    one of PREPASS_CASES."""
    from gendr_tpu_torch import config as C
    name, B, F, size, kind, TS, cfg_kw, params_kw = case
    cfg = flagship_cfg(size, **cfg_kw)
    fv, tex, kw = prepass_scene(kind, B, F, device, TS=TS,
                                texture_type=cfg_kw.get('texture_type',
                                                        'surface'))
    return name, cfg, C.RenderParams(**params_kw).as_dict(), fv, tex, kw


def prepass_mismatch(got, want):
    """{output: what differs} between two prepasses' outputs, bit for bit
    (a float's bits, so that the NaN of a padded face's depth rows compares
    too, and the sign of a zero); empty where every output is bitwise
    equal."""
    import torch
    bad = {}
    for k in PREPASS_OUTPUTS:
        a, b = got[k], want[k]
        if a.shape != b.shape or a.dtype != b.dtype:
            bad[k] = (f'{tuple(a.shape)} {a.dtype} against '
                      f'{tuple(b.shape)} {b.dtype}')
            continue
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        diff = a != b
        if bool(diff.any()):
            where = diff.nonzero()[:4].tolist()
            if k == 'packed':
                where = (f'rows {diff.any(2).any(0).nonzero().flatten()}'
                         f' first at {where}')
            bad[k] = f'{int(diff.sum())} of {diff.numel()} differ: {where}'
    return bad


def check_prepass(name, cfg, params, fv, tex, kw):
    """The prepass kernel against the plain prepass on one input:
    prepass_path sends it to the kernel, the call launches it once, and
    every output, the parameter vector and the band are bitwise the plain
    prepass's.  Prints one line; raises on a difference."""
    import torch
    from gendr_tpu_torch.raster import cuda_backend as CB
    path = CB.prepass_path(cfg, fv.shape[1], tex.shape[2], fv.device,
                           kw.get('fvalid'), kw.get('allow_compact', True))
    if path != 'kernel':
        raise AssertionError(f'[prepass] {name}: prepass_path {path}')
    n = CB.LAUNCHES['prepass']
    got = CB.prepass(fv, tex, cfg, params, **kw)
    if CB.LAUNCHES['prepass'] != n + 1:
        raise AssertionError(f'[prepass] {name}: {CB.LAUNCHES["prepass"] - n}'
                             f' prepass launches for one call')
    want = CB.prepass_plain(fv, tex, cfg, params, **kw)
    torch.cuda.synchronize()
    bad = prepass_mismatch(got, want)
    if set(got) != set(want) or not torch.equal(got['par'], want['par']) \
            or (got['row0'], got['height']) != (want['row0'], want['height']):
        bad['aux'] = f'{sorted(got)} against {sorted(want)}'
    B, NI, Fp = want['packed'].shape
    print(f'[prepass] {name}: B={B} F={fv.shape[1]} Fp={Fp} NI={NI} '
          f'{cfg.image_size}^2 rows {got["row0"]}+{got["height"]}: '
          + ('every output bitwise the plain prepass\'s' if not bad else
             f'DIFFERS {bad}'), flush=True)
    if bad:
        raise AssertionError(f'[prepass] {name}: {bad}')


def _captured(fn):
    """(a CUDA graph of fn, what the captured call returned), fn warmed up
    on a side stream first, as experiments.common.StepChain captures."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


def _graph_ms(fn, n=100):
    """ms a replay of fn captured in a CUDA graph, over n replays back to
    back between two CUDA events (median of 3 after a warm-up), as the
    experiments' chained steps run it."""
    return _back_to_back(_captured(fn)[0].replay, n)


def check_prepass_replay(name, cfg, params, fv, tex):
    """A kernel prepass captured in a CUDA graph (one launch counted at
    the capture), its outputs overwritten, then replayed: bitwise the
    eager prepass.  The parameter vector goes onto the card first, as a
    chained step holds it.  Raises on a difference."""
    import torch
    from gendr_tpu_torch.raster import cuda_backend as CB
    from gendr_tpu_torch.raster import pairmath as PM
    p = PM.vector_params(PM._params_vec(params, cfg, fv.device))
    eager = CB.prepass(fv, tex, cfg, p)
    n = CB.LAUNCHES['prepass']
    graph, captured = _captured(lambda: CB.prepass(fv, tex, cfg, p))
    if CB.LAUNCHES['prepass'] != n + 2:  # the warm-up and the capture
        raise AssertionError(f'[prepass] {name}: {CB.LAUNCHES["prepass"] - n}'
                             f' launches counted for a warm-up and a capture')
    for k in PREPASS_OUTPUTS:
        captured[k].fill_(-1)
    graph.replay()
    torch.cuda.synchronize()
    bad = prepass_mismatch(captured, eager)
    if bad:
        raise AssertionError(f'[prepass] {name} replayed: {bad}')


def check_plain_prepass(name, cfg, params, fv, tex):
    """A CUDA prepass that prepass_path sends to the plain PyTorch path:
    PREPASS_PLAIN counts it, the kernel stays unlaunched, and the aux is
    bitwise prepass_plain's.  Raises otherwise."""
    from gendr_tpu_torch.raster import cuda_backend as CB
    path = CB.prepass_path(cfg, fv.shape[1], tex.shape[2], fv.device)
    n, m = CB.LAUNCHES['prepass'], CB.PREPASS_PLAIN['cuda']
    aux = CB.prepass(fv, tex, cfg, params)
    counts = (CB.LAUNCHES['prepass'] - n, CB.PREPASS_PLAIN['cuda'] - m)
    bad = prepass_mismatch(aux, CB.prepass_plain(fv, tex, cfg, params))
    if path != 'plain' or counts != (0, 1) or bad:
        raise AssertionError(f'[prepass] {name}: path {path}, (kernel, '
                             f'plain) calls {counts}, {bad}')
    return aux


def prepass_bytes(aux, fv, tex, cfg):
    """Bytes a prepass must move at least: the face vertices (and the
    texture rows it packs) read once, the packed rows, perm and both lists
    written once."""
    ntex = 0 if cfg.channels == 'alpha' else (
        3 if cfg.texture_type == 'vertex' else tex.shape[2])
    B, F = fv.shape[:2]
    written = sum(aux[k].numel() * aux[k].element_size()
                  for k in PREPASS_OUTPUTS)
    return B * F * (9 + 3 * ntex) * 4 + written


def prepass_phase(smi):
    """Phase 14: the prepass kernel against the plain prepass, bitwise, on
    PREPASS_CASES; a captured prepass replayed against the eager one; the
    plain path where compaction fires or the faces pass the kernel's sort
    (PREPASS_PLAIN counts the call, the kernel stays unlaunched); one
    kernel prepass per forward at each cell's shape; then, at the cells'
    shapes, the kernel and the plain prepass each captured in a graph and
    replayed back to back (the way the cells run them) beside the byte
    bound, their device kernels and host ms a call (_prepass_cost).
    Returns ({shape: {'prepass': numbers}}, launches of the phase)."""
    import torch
    from gendr_tpu_torch.raster import cuda_backend as CB
    from gendr_tpu_torch.raster import pairmath as PM
    for k in CB.LAUNCHES:
        CB.LAUNCHES[k] = 0
    inputs = [prepass_inputs(case, 'cuda') for case in PREPASS_CASES]
    for name, cfg, params, fv, tex, kw in inputs:
        check_prepass(name, cfg, params, fv, tex, kw)

    name, cfg, params, fv, tex, kw = inputs[0]
    check_prepass_replay(name, cfg, params, fv, tex)
    # the plain path: a compacted shape, and faces past the kernel's sort
    plain_cases = [
        ('compacted flagship', flagship_cfg(), *flagship_scene('cuda')),
        ('F > sort cap', flagship_cfg(64, compact='off'),
         *prepass_scene('views', 1, CB.PREPASS_SORT_CAP + 1, 'cuda')[:2])]
    for what, cfg_p, fv_p, tex_p in plain_cases:
        check_plain_prepass(what, cfg_p, params, fv_p, tex_p)
    # one kernel prepass per forward at each cell's shape
    for name, cfg, params, fv, tex, kw in inputs[:3]:
        before = dict(CB.LAUNCHES)
        CB.forward_with_aux(fv, tex, cfg, params)
        delta = {k: CB.LAUNCHES[k] - before[k] for k in CB.LAUNCHES}
        if delta != dict(render_launches(1, 0), prepass=1):
            raise AssertionError(f'[prepass] {name} forward: {delta}')
    torch.cuda.synchronize()
    launches = dict(CB.LAUNCHES)
    print(f'[prepass] {len(inputs)} inputs bitwise, a replay bitwise the '
          f'eager prepass, {len(plain_cases)} shapes on the plain path, one '
          f'kernel prepass a forward at the cells\' shapes; launches '
          f'{launches}', flush=True)

    kt = {}
    for name, cfg, params, fv, tex, kw in inputs[:3]:
        p = PM.vector_params(PM._params_vec(params, cfg, 'cuda'))
        aux = CB.prepass(fv, tex, cfg, p)
        ms = _graph_ms(lambda: CB.prepass(fv, tex, cfg, p))
        plain_ms = _graph_ms(lambda: CB.prepass_plain(fv, tex, cfg, p))
        nbytes = prepass_bytes(aux, fv, tex, cfg)
        bound = 1e3 * nbytes / H100_HBM_BYTES
        host, kernels = _prepass_cost(fv, tex, cfg, p)
        plain_host, plain_kernels = _prepass_cost(
            fv, tex, cfg, p, fn=CB.prepass_plain)
        kt[f'prepass {name}'] = {'prepass': dict(
            ms=ms, plain_ms=plain_ms, bound=(bound, 'bytes'))}
        print(f'[prepass timing] {smi}: {name} (B={fv.shape[0]}, '
              f'{fv.shape[1]} faces, {cfg.image_size}^2): replayed in a '
              f'graph, kernel {ms:.5f} ms against plain {plain_ms:.5f} ms '
              f'({plain_ms / ms:.1f}x); bound {bound:.5f} ms ({nbytes / 1e6:.2f}'
              f' MB at 3.35 TB/s; {100 * bound / ms:.1f} % of it); device '
              f'kernels {kernels} against {plain_kernels}; host ms a call, '
              f'synchronized, {host:.3f} against {plain_host:.3f}',
              flush=True)
    return kt, launches


def compaction_phase(smi):
    """Per-tile face compaction (RenderConfig.compact 'auto', the default):
    on the flagship, its band of rows 128-255, the default GenDR's inputs
    and the overflow scene, the gate fires (packed columns past the sorted
    faces; the overflow scene keeps a chunk list), K1 and K2 against their
    plain versions under check_kernels' gates, and the forward kernel's
    output bitwise that of compact='off'.  Then 'auto' against 'off' in
    turns (off, auto, auto, off): both kernels per call and back to back,
    the prepass's device kernels and host time, the flagship's eager
    render and forward + backward through render, the default GenDR's
    forward + backward, visited pairs, and the chained opt_camera --quick
    step (16 poses of a 12-face cube at 64x64: the gate fires).  The
    eager flagship forward + backward is this phase's main path: the
    kernels' counts are set to 0 before it and read after.  Returns
    (launches, largest image error, largest gradient error, time_kernels'
    results by shape)."""
    import dataclasses
    import torch
    from gendr_tpu_torch import config as C, render
    from gendr_tpu_torch.experiments import opt_camera as OC
    from gendr_tpu_torch.raster import cuda_backend as CB
    params = C.RenderParams(dist_scale=1e-2).as_dict()
    fv, tex = flagship_scene('cuda')
    cfg = flagship_cfg()
    ofv, otex = overflow_scene()
    inputs = [('compact flag', cfg, params, fv, tex, None),
              ('compact band', cfg, params, fv, tex, (128, 128)),
              *[(n.replace('gendr', 'compact'), c, p, f, t, None)
                for n, c, p, f, t in gendr_inputs()],
              ('compact over', flagship_cfg(128, dist_func='logistic'),
               C.RenderParams(dist_scale=3e-3).as_dict(), ofv, otex, None)]
    img = grad = 0.0
    for name, c, p, f, t, band in inputs:
        aux = CB.prepass(f, t, c, p, row_band=band)
        if 'oct_ids' not in aux:
            raise AssertionError(f'{name}: the compaction gate did not fire')
        if name == 'compact over' and not int(aux['tile_counts'].max()) > 1:
            raise AssertionError(f'{name}: no tile overflowed its slabs')
        i, g = check_kernels(name, c, p, f, t, aux)
        img, grad = max(img, i), max(grad, g)
        off = CB.prepass(f, t, dataclasses.replace(c, compact='off'), p,
                         row_band=band)
        outs = [CB.rasterize_fwd(a['tile_counts'], a['tile_ids'], a['par'],
                                 a['packed'], a['perm'], c, t.shape[2],
                                 a['row0'], a['height']) for a in (aux, off)]
        if not torch.equal(*outs):
            raise AssertionError(f'{name}: the compacted forward is not '
                                 f'bitwise the uncompacted one')
    print(f'[compaction] {len(inputs)} inputs compacted: K1 and K2 within '
          f'the gates of their plain versions, the forward bitwise '
          f'compact=\'off\'', flush=True)

    kw = dict(image_size=256, dist_func='uniform', dist_scale=1e-2,
              aggr_alpha_func='probabilistic', aggr_rgb_func='hard')
    fvg = fv.clone().requires_grad_(True)

    def fwd_bwd(mode):
        img = render(fvg, tex, compact=mode, **kw)
        loss = 0.5 * (img[:, 3] ** 2).sum() + 0.1 * img[:, :3].sum()
        return torch.autograd.grad(loss, fvg)

    # the main path: the eager flagship forward + backward, compacted
    for k in CB.LAUNCHES:
        CB.LAUNCHES[k] = 0
    fwd_bwd('auto')
    torch.cuda.synchronize()
    launches = dict(CB.LAUNCHES)
    if render_counts(launches) != render_launches(1, 1, 1):
        raise AssertionError(f'compacted render launches {launches}')

    kt, t = {}, {}
    gcfg, gparams, gfv, gtex = next(
        (c, p, f, x) for n, c, p, f, x in gendr_inputs() if 'surf' in n)
    for mode in ('off', 'auto', 'auto', 'off'):
        with compaction(mode):
            c = dataclasses.replace(cfg, compact=mode)
            r = time_kernels(smi, f'flagship compact={mode}', c, params, fv,
                             tex, 50, plain=(1, 0))
            gc = dataclasses.replace(gcfg, compact=mode)
            rg = time_kernels(smi, f'default GenDR compact={mode}', gc,
                              gparams, gfv, gtex, 20, plain=(1, 0))
            kt.setdefault(f'flagship compact={mode}', r)
            kt.setdefault(f'default GenDR compact={mode}', rg)
            aux = CB.prepass(fv, tex, c, params)
            fargs = (aux['tile_counts'], aux['tile_ids'], aux['par'],
                     aux['packed'], aux['perm'], c, 1)
            bargs = backward_args(aux, c, params, 1,
                                  CB.rasterize_fwd(*fargs))
            row = dict(
                fwd_b2b=_back_to_back(lambda: CB.rasterize_fwd(*fargs)),
                bwd_b2b=_back_to_back(lambda: CB.rasterize_bwd(*bargs)),
                prepass=_prepass_cost(fv, tex, c, params),
                gendr_prepass=_prepass_cost(gfv, gtex, gc, gparams),
                render=_median_ms(lambda: render(fv, tex, compact=mode,
                                                 **kw), 50),
                fwd_bwd=_median_ms(lambda: fwd_bwd(mode), 50),
                gendr_fwd_bwd=_median_ms(lambda: gendr_path('surface'), 10),
                visited=r['rasterize_fwd']['visited_pairs'])
            for k, v in row.items():
                t.setdefault(k, {}).setdefault(mode, []).append(v)
    # path (k)'s render (opt_camera at its defaults, B=200) both ways, K2
    # back to back beside time_kernels' medians
    exp, init = camera_experiment(CHAIN_CAMERA)
    for tau in CAMERA_DEFAULT_TAUS:
        ccfg, cparams, cfv, ctex = camera_inputs(exp, init, tau)
        for mode in ('off', 'auto', 'auto', 'off'):
            with compaction(mode):
                c = dataclasses.replace(ccfg, compact=mode)
                shape = f'opt_camera B=200 tau {tau:g} compact={mode}'
                kt.setdefault(shape, time_kernels(smi, shape, c, cparams,
                                                  cfv, ctex, 50,
                                                  plain=(1, 0)))
                aux = CB.prepass(cfv, ctex, c, cparams)
                TS = ctex.shape[2]
                bargs = backward_args(aux, c, cparams, TS, CB.rasterize_fwd(
                    aux['tile_counts'], aux['tile_ids'], aux['par'],
                    aux['packed'], aux['perm'], c, TS))
                t.setdefault(f'camera_bwd_b2b tau {tau:g}', {}).setdefault(
                    mode, []).append(_back_to_back(
                        lambda: CB.rasterize_bwd(*bargs)))
    del exp
    cam = {}
    for mode in ('off', 'auto'):
        with compaction(mode):
            args = OC.parse_args(['--quick', '--device', 'cuda', '--chain',
                                  str(CHAIN_CAMERA)])
            exp = OC.CameraExperiment(args, args.device, args.backend)
            exp.run(OC.initial_poses(args.batch_size, 15, 35),
                    num_iterations=1)
            cam[mode] = time_chain(
                smi, f'opt_camera --quick --chain {CHAIN_CAMERA}, '
                f'compact={mode}', exp.chain('iou'), CHAIN_CAMERA)['step_ms']
            del exp
    t['camera_chained_step'] = cam
    print(f'[compaction] {smi}: compact=\'auto\' against \'off\', in turns '
          f'(off, auto, auto, off): flagship K1 / K2 back to back (200 '
          f'launches, CUDA events) {t["fwd_b2b"]} / {t["bwd_b2b"]} ms; '
          f'prepass (host ms, device kernels) flagship {t["prepass"]}, '
          f'default GenDR {t["gendr_prepass"]}; eager flagship render '
          f'{t["render"]} ms, forward + backward {t["fwd_bwd"]} ms (medians '
          f'of 50, CUDA events); default GenDR forward + backward '
          f'{t["gendr_fwd_bwd"]} ms (medians of 10); visited pairs at the '
          f'flagship {t["visited"]}; chained opt_camera --quick step {cam} '
          f'ms; opt_camera at its defaults (B=200), K2 back to back '
          + ', '.join(f'{k[15:]} {v} ms' for k, v in t.items()
                      if k.startswith('camera_bwd_b2b'))
          + f'; the main path\'s launches {launches}', flush=True)
    return launches, img, grad, kt


def _shape_experiment(backend, device='cuda', extra=()):
    from gendr_tpu_torch.experiments import opt_shape as OS
    args = OS.parse_args(['--model_obj', 'proc_cube.obj', '--device', device,
                          *extra])
    exp = OS.ShapeExperiment(args, device, backend)
    cameras, images = exp.goals(args.model_obj)
    eyes, targets = exp.view_set(cameras, images, '24@30')
    return exp, eyes, targets


def training_path(extra=()):
    """Phase 3, and with extra = YAGER_ARGS path (d): TRAIN_STEPS steps of
    the shape optimizer through the kernels.  Returns each kernel's
    launches in that run and the step times."""
    import torch
    from gendr_tpu_torch.raster import cuda_backend as CB
    exp, eyes, targets = _shape_experiment(None, extra=['--chain', '1',
                                                        *extra])
    for k in CB.LAUNCHES:
        CB.LAUNCHES[k] = 0
    rec = exp.run(TRAIN_LR, TRAIN_SIGMA, eyes, targets, TRAIN_STEPS)
    torch.cuda.synchronize()
    launches = dict(CB.LAUNCHES)
    h = rec['hard_losses']
    print(f'[training path] opt_shape{"".join(" " + a for a in extra)}, '
          f'642-vertex template (1280 faces), 24 views at 64x64, logistic '
          f'sigma 1e-2, {exp.args.aggr_func}, lr 10^-1.5, cube target: hard '
          f'IoU loss {h[0]:.6f} after step 1, '
          f'{h[-1]:.6f} after step {len(h)} (best {min(h):.6f}); '
          f'gradients finite={rec["grads_finite"]}; launches={launches}',
          flush=True)
    if not h[-1] < h[0]:
        raise AssertionError(f'hard IoU loss did not fall: {h}')
    if not rec['grads_finite']:
        raise AssertionError('a non-finite gradient in training')
    for k in RENDER_KERNELS:
        if launches[k] < 1:
            raise AssertionError(f'the training path never launched {k}')
    return launches, rec['step_s']


def panda_path(args=PANDA_ARGS, what='1280 faces, TS=25'):
    """Phase 4a, and with args = OBJ_PANDA_ARGS under GENDR_PANDA_OBJ path
    (e)'s sweep: panda_dist through its command line (--quick, PNGs into
    a temporary directory), forward only.  Checks one forward launch per
    frame and none backward, every frame finite with alpha in [0, 1], and
    every PNG read back as a 768x768 RGB image that is not blank.  Returns
    the launches and ms/frame."""
    import tempfile
    import torch
    from gendr_tpu_torch.animations import panda_dist as PD
    from gendr_tpu_torch.raster import cuda_backend as CB
    with tempfile.TemporaryDirectory() as out_dir:
        for k in CB.LAUNCHES:
            CB.LAUNCHES[k] = 0
        ms, stats = PD.main(args + ['--out-dir', out_dir])
        torch.cuda.synchronize()
        launches = dict(CB.LAUNCHES)
        pngs = [p for p in os.listdir(out_dir) if p.endswith('.png')]
        from gendr_tpu_torch.utils.png import read_png
        for name in pngs:
            frame = read_png(os.path.join(out_dir, name))
            if frame.shape != (768, 768, 3) or frame.std() == 0:
                raise AssertionError(f'{name}: read back {frame.shape}, '
                                     f'std {frame.std()}')
    ok = all(fin and 0.0 <= lo and hi <= 1.0 for fin, lo, hi in stats)
    print(f'[panda path] panda_dist {" ".join(args)}: {what}, '
          f'1536x1536 render (768x768 with 2x AA): {len(stats)} '
          f'frames, {len(pngs)} PNGs read back, ms/frame (render+fetch+png, host '
          f'clock) {[round(x, 3) for x in ms]}; frames finite with alpha '
          f'in [0, 1]: {ok}; launches={launches}', flush=True)
    if len(stats) != PANDA_FRAMES or len(pngs) != PANDA_FRAMES:
        raise AssertionError(f'{len(stats)} frames, {len(pngs)} PNGs')
    if not ok:
        raise AssertionError(f'a frame is not finite or alpha leaves '
                             f'[0, 1]: {stats}')
    if render_counts(launches) != render_launches(PANDA_FRAMES, 0):
        raise AssertionError(f'panda path launches {launches}')
    return launches, ms


def panda_frame_vs_torch():
    """Phase 4b: one full-width frame of the sweep (uniform, tau 1e-2,
    1536x1536) through backend='cuda' and backend='torch'."""
    import torch
    from gendr_tpu_torch.animations import panda_dist as PD
    args = PD.parse_args(PANDA_ARGS)
    fv, tex = PD.scene(args.texture_res, 'cuda')
    imgs = {}
    for backend in ('cuda', 'torch'):
        args.backend = backend
        r = PD.renderer(args, 'uniform', 0)
        r.dist_scale = 1e-2
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            imgs[backend] = r.forward_tensors(fv, tex)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        imgs[backend + '_peak'] = peak
    err = float((imgs['cuda'] - imgs['torch']).abs().max())
    alpha = imgs['cuda'][0, 3]
    torch_peak = imgs['torch_peak']
    print(f'[panda frame] uniform tau 1e-2, 1536x1536 render: img_err vs '
          f'backend=torch {err:.3g}, coverage '
          f'{float((alpha > 0.5).float().mean()):.4f}, peak device memory '
          f'(max_memory_allocated) cuda {imgs["cuda_peak"]:.2f} GiB, torch '
          f'{torch_peak:.2f} GiB in bands of PAIR_BUDGET pair elements '
          f'(52.6 GiB in one step before; gate {TORCH_PEAK_GIB} GiB)',
          flush=True)
    del imgs
    torch.cuda.empty_cache()
    if not err < IMG_TOL:
        raise AssertionError(f'panda frame vs torch backend: {err}')
    if not torch_peak < TORCH_PEAK_GIB:
        raise AssertionError(f'backend=torch peaked at {torch_peak} GiB')
    return torch_peak


def tcn_path():
    """Phase 5, path (c): the t-conorm sweeps through panda_tcn's entry
    points at their defaults, PNGs into a temporary directory, forward
    only: the tau sweep over the full canonical list (the command line's
    --quick keeps only max and probabilistic, which run no parametric
    fold), the p sweep and the triangle sweep through their command
    lines.  Checks one forward launch per frame and none backward, and
    every frame finite with alpha in [0, 1].  Returns the launches."""
    import tempfile
    import torch
    from gendr_tpu_torch.animations import panda_tcn as TCN, triangles_tcn
    from gendr_tpu_torch.animations.common import T_CONORMS
    from gendr_tpu_torch.raster import cuda_backend as CB
    with tempfile.TemporaryDirectory() as out_dir:
        out = ['--out-dir', out_dir]
        for k in CB.LAUNCHES:
            CB.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        sweeps = [TCN.run(TCN.parse_args(TCN_ARGS + out), T_CONORMS),
                  TCN.main(TCN_ARGS + ['--sweep-p'] + out),
                  triangles_tcn.main(TCN_ARGS + out)]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(CB.LAUNCHES)
        pngs = len([p for p in os.listdir(out_dir) if p.endswith('.png')])
    frames = tuple(len(stats) for stats in sweeps)
    ok = all(fin and 0.0 <= lo and hi <= 1.0
             for stats in sweeps for fin, lo, hi in stats)
    print(f'[tcn path] panda_tcn {" ".join(TCN_ARGS)} over the 11 canonical '
          f't-conorm configurations, then --sweep-p, then triangles_tcn: '
          f'1280 faces, TS=25, 1536x1536 renders (768x768 with 2x AA), '
          f'softmax RGB, uniform: {frames} frames, {pngs} PNGs in '
          f'{seconds:.1f} s (render+fetch+png, host clock); frames finite '
          f'with alpha in [0, 1]: {ok}; launches={launches}', flush=True)
    # the triangle sweep's --quick names coincide with the tau sweep's first
    # two configurations, so its 14 PNGs replace theirs
    if frames != TCN_FRAMES or pngs != sum(TCN_FRAMES[:2]):
        raise AssertionError(f'{frames} frames, {pngs} PNGs')
    if not ok:
        raise AssertionError(f'a frame is not finite or alpha leaves '
                             f'[0, 1]: {sweeps}')
    if render_counts(launches) != render_launches(sum(TCN_FRAMES), 0):
        raise AssertionError(f'tcn path launches {launches}')
    return launches


def tcn_frame_vs_torch():
    """One full-width frame of the tau sweep (yager p=2, tau 1e-2,
    1536x1536) through backend='cuda', whose threads fold serially, and
    backend='torch', which folds in the JAX package's butterfly grouping."""
    import torch
    from gendr_tpu_torch.animations import panda_tcn as TCN
    args = TCN.parse_args(TCN_ARGS)
    fv, tex = TCN.scene(args)
    imgs = {}
    for backend in ('cuda', 'torch'):
        args.backend = backend
        with torch.no_grad():
            imgs[backend] = TCN.renderer(args, 'yager', 2.0) \
                .forward_tensors(fv, tex)
    torch.cuda.synchronize()
    err = float((imgs['cuda'] - imgs['torch']).abs().max())
    alpha = imgs['cuda'][0, 3]
    print(f'[tcn frame] yager p=2 tau 1e-2, 1536x1536 render: img_err vs '
          f'backend=torch {err:.3g} (tolerance {TCN_VS_TORCH_TOL}), coverage '
          f'{float((alpha > 0.5).float().mean()):.4f}', flush=True)
    del imgs
    torch.cuda.empty_cache()
    if not err < TCN_VS_TORCH_TOL:
        raise AssertionError(f'tcn frame vs torch backend: {err}')


def within_ulp_budget(result):
    """Does a probe result's kernel-vs-torch-on-the-card difference stay
    inside ULP_BUDGET for its op's kind?"""
    from gendr_tpu_torch.tools import _ulp
    field, limit = ULP_BUDGET[_ulp.OPS[result.case.op].kind]
    return getattr(result.card, field) <= limit


def probe_phase():
    """Phase 7: every case of the three ULP tools through both probe
    kernels, the whole phase in one launch of each (one a table piece),
    against torch on the card and on the CPU.  Prints the table; raises
    where a kernel leaves its budget against torch on the card, where the
    two kernels differ from each other, or where a case's output in the
    batch differs from its own one-case launch (all bitwise).  Returns the
    batch's launches and the largest absolute difference from torch on the
    card over the cdf and fold cases."""
    import torch
    from gendr_tpu_torch.tools import _ulp
    cases = _ulp.check_cases() + _ulp.bisect_cases() + _ulp.smem_cases()
    for k in _ulp.LAUNCHES:
        _ulp.LAUNCHES[k] = 0
    outs = {k: _ulp.run_cases(cases, k) for k in _ulp.LAUNCHES}
    torch.cuda.synchronize()
    launches = dict(_ulp.LAUNCHES)
    results = {k: _ulp.compare(cases, k, o) for k, o in outs.items()}
    alone = {k: [_ulp.run_cases([c], k)[0] for c in cases] for k in outs}

    def same(a, b):
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    split = [c.name for c, a, b in zip(cases, *outs.values())
             if not same(a, b)]
    apart = [f'{k}: {c.name}' for k in outs
             for c, a, b in zip(cases, outs[k], alone[k]) if not same(a, b)]
    print(f'[probes] {len(cases)} cases x (ulp_elementwise, '
          f'ulp_param_vector), one launch each: kernel vs torch on the card '
          f'| on the CPU')
    over = []
    for by_value, by_vector in zip(*results.values()):
        _ulp.report(by_value)
        if by_value.case.name in split:
            print(f'      ulp_param_vector differs from ulp_elementwise: '
                  f'vs the CPU {by_vector.cpu}')
        over += [r.case.name for r in (by_value, by_vector)
                 if not within_ulp_budget(r)]
    by_value = results['ulp_elementwise']
    bitwise = sum(r.card.n_differ == 0 for r in by_value)
    bitwise_cpu = sum(r.cpu.n_differ == 0 for r in by_value)
    worst = max(r.card.max_abs for rs in results.values() for r in rs
                if _ulp.OPS[r.case.op].kind in ('cdf', 'fold'))
    print(f'[probes] {bitwise} of {len(cases)} cases bitwise with torch on '
          f'the card, {bitwise_cpu} with torch on the CPU; the two kernels '
          f'agree bitwise on {len(cases) - len(split)}; the batch bitwise its '
          f'one-case launches on {2 * len(cases) - len(apart)} of '
          f'{2 * len(cases)}; over budget: {over or "none"}; '
          f'launches={launches}', flush=True)
    if over or split or apart:
        raise AssertionError(f'probe kernels: over budget {over}, the two '
                             f'kernels differ on {split}, the batch differs '
                             f'from one case a launch on {apart}')
    if launches != {k: _ulp.launches(len(cases), k) for k in launches}:
        raise AssertionError(f'probe launches {launches}')
    return launches, worst


def time_probes(smi, reps):
    """Both probe kernels over the whole probe phase (the 111 cases of the
    three tools), the inputs packed on the card beforehand: one launch of
    the phase back to back (CUDA events, median of reps) and its device
    time (the profiler); the same cases as one-case launches, one after
    another (CUDA events around all of them) and their device time a
    launch (the profiler's mean); the torch expressions of every case on
    the card (the plain version); the batch's bound from its bytes: each x
    and second y read once, each output written once (operations counted
    as one an element, a floor: the bytes bound it).  Then where the
    batch's time goes, on the device: the phase with every op made
    MUL_ADD (the same bytes, no work), the cases of the Kummer series (31
    IEEE divisions an element) alone and the others alone.  Returns
    {kernel: dict}."""
    import torch
    from gendr_tpu_torch import config as C
    from gendr_tpu_torch.tools import _ulp
    cases = _ulp.check_cases() + _ulp.bisect_cases() + _ulp.smem_cases()
    elements = sum(c.x.size for c in cases)
    nbytes = 4 * (2 * elements + sum(c.y.size for c in cases
                                     if _ulp._has_y(c)))
    kummer = [c.op in ('KUMMER_DIV', 'GAMMA_FULL_DIV') or (
        c.op == 'CDF' and int(c.q[0]) in (C.GAMMA, C.GAMMA_REV))
        for c in cases]
    parts = dict(
        no_work=[c._replace(op='MUL_ADD', y=c.x if c.y is None else c.y)
                 for c in cases],
        kummer=[c for c, k in zip(cases, kummer) if k],
        others=[c for c, k in zip(cases, kummer) if not k])
    args = [(c.op, torch.as_tensor(c.x).cuda(),
             torch.as_tensor(c.x if c.y is None else c.y).cuda(),
             _ulp._pad_params(c.q)) for c in cases]
    vector = [(op, x, y, torch.tensor(q, device='cuda'))
              for op, x, y, q in args]
    res = {}
    for kernel in _ulp.LAUNCHES:
        name = f'{kernel}_kernel'
        batch = _probe_launch(cases, kernel)
        singles = [_probe_launch([c], kernel) for c in cases]

        def one_by_one():
            for single in singles:
                single()

        def plain():
            for op, x, y, q in (args if kernel == 'ulp_elementwise'
                                else vector):
                _ulp.OPS[op].torch(x, y, q)
        events_ms = _median_ms(batch, reps)
        device_ms = _profiled_ms(batch, [name], reps)[name]
        res[kernel] = dict(
            ms=device_ms if device_ms is not None else events_ms,
            events_ms=events_ms, device_ms=device_ms,
            cases_ms=_median_ms(one_by_one, 5),
            case_device_ms=_profiled_ms(one_by_one, [name], 3)[name],
            plain_ms=_median_ms(plain, 3),
            bound=bound(nbytes, elements),
            parts={k: _profiled_ms(_probe_launch(v, kernel), [name],
                                   reps)[name] for k, v in parts.items()})
    for kernel, r in res.items():
        case_ms = r['case_device_ms']
        print(f'[timing] {smi}: probe phase, {len(cases)} cases, {elements} '
              f'elements, {nbytes} bytes, through {kernel}: one launch '
              f'({_ulp.launches(len(cases), kernel)} a phase) '
              f'{r["events_ms"]:.4f} ms back to back (CUDA events, median '
              f'of {reps}), {_fmt_ms(r["device_ms"])} on the device '
              f'(profiler); {len(cases)} one-case launches '
              f'{r["cases_ms"]:.4f} ms one after another (CUDA events, '
              f'median of 5), {_fmt_ms(case_ms)} a launch on the device '
              f'(profiler), '
              f'{_fmt_ms(case_ms and case_ms * len(cases))} summed; torch '
              f'on the card {r["plain_ms"]:.4f} ms; bound '
              f'{r["bound"][0]:.6f} ms ({r["bound"][1]}); on the device, '
              f'every op as MUL_ADD (the same bytes) '
              f'{_fmt_ms(r["parts"]["no_work"])}, the '
              f'{sum(kummer)} Kummer-series cases alone '
              f'{_fmt_ms(r["parts"]["kummer"])}, the other '
              f'{len(cases) - sum(kummer)} alone '
              f'{_fmt_ms(r["parts"]["others"])}', flush=True)
    return res


def _probe_launch(cases, kernel):
    """A function that launches kernel over cases, packed on the card once
    beforehand."""
    import torch
    from gendr_tpu_torch.tools import _ulp
    packed = _ulp.pack(cases)
    inputs = _ulp._inputs(cases, packed, 'cuda')
    out = torch.empty(packed.n_out, device='cuda')
    return lambda: _ulp.launch(kernel, packed, inputs, out)


def _fmt_ms(ms):
    return 'not measured' if ms is None else f'{ms:.6f} ms'


def gendr_default_path():
    """Phase 4c: the default GenDR forward and backward (path (b)) with
    surface and vertex textures.  Checks one launch of each kernel per
    call, finite outputs and gradients, and the image and the gradients
    against backend='torch'.  Returns the launches of each run."""
    import torch
    from gendr_tpu_torch.raster import cuda_backend as CB
    launches = {}
    for texture_type in ('surface', 'vertex'):
        for k in CB.LAUNCHES:
            CB.LAUNCHES[k] = 0
        img, _, _, gfv, gv, gt = gendr_path(texture_type)
        torch.cuda.synchronize()
        launches[texture_type] = dict(CB.LAUNCHES)
        t0 = time.perf_counter()
        ref, _, _, rfv, rv, rt = gendr_path(texture_type, 'torch')
        torch.cuda.synchronize()
        torch_ms = 1e3 * (time.perf_counter() - t0)
        cuda_ms = _median_ms(lambda: gendr_path(texture_type), 10)
        err = float((img - ref).abs().max())
        alpha = img[:, 3]
        finite = all(bool(torch.isfinite(x).all())
                     for x in (img, gfv, gv, gt))
        agree = [agreement(a, b) for a, b in ((gfv, rfv), (gv, rv),
                                              (gt, rt))]
        print(f'[gendr path] {texture_type} textures, {GENDR_VIEWS} views, '
              f'GenDR(anti_aliasing=True) {tuple(img.shape)}: '
              f'launches={launches[texture_type]} finite={finite} alpha in '
              f'[{float(alpha.min()):.3g}, {float(alpha.max()):.3g}] | vs '
              f'backend=torch: img_err={err:.3g} '
              f'face_grad_agree={agree[0]:.6f} '
              f'vertex_grad_agree={agree[1]:.6f} '
              f'texture_grad_agree={agree[2]:.6f} '
              f'face_grad_scale={float(rfv.abs().max()):.3g} '
              f'vertex_grad_err={float((gv - rv).abs().max()):.3g} '
              f'vertex_grad_scale={float(rv.abs().max()):.3g} | forward + '
              f'backward: backend=cuda {cuda_ms:.3f} ms (median of 10, CUDA '
              f'events), backend=torch {torch_ms:.1f} ms (one run, host '
              f'clock)',
              flush=True)
        del ref, rfv, rv, rt
        torch.cuda.empty_cache()
        if render_counts(launches[texture_type]) != render_launches(1, 1):
            raise AssertionError(f'gendr path launches {launches}')
        if not finite or not (0.0 <= float(alpha.min())
                              and float(alpha.max()) <= 1.0):
            raise AssertionError('gendr path: non-finite output or alpha '
                                 'outside [0, 1]')
        if not err < IMG_TOL:
            raise AssertionError(f'gendr path vs torch backend: {err}')
        if not (agree[0] > GRAD_AGREE and agree[2] > GRAD_AGREE):
            raise AssertionError(f'gendr path gradients vs torch backend: '
                                 f'{agree}')
        if not (float(gv.abs().max()) > 0 and float(gt.abs().max()) > 0):
            raise AssertionError('gendr path: a zero gradient')
    return launches


def torch_texel_phase():
    """Path (l): the default GenDR (softmax RGB) through backend='torch' on
    GENDR_VIEWS views of the textured stand-in at TORCH_TEXEL_RES^2 texels
    a face, above the kernels' softmax cap, forward and backward twice on
    the same inputs: the image and the face, vertex and texel gradients
    bitwise equal across the runs (the texel gradient is a fixed-order
    segment sum, torch_backend.texel_sums: no atomics), finite, the texel
    gradient not zero, the peak device memory under TORCH_PEAK_GIB.
    Prints both runs' forward and backward times.  Returns nothing: no
    kernel runs here."""
    import torch
    from gendr_tpu_torch import data
    from gendr_tpu_torch.raster import cuda_backend as CB
    res = TORCH_TEXEL_RES
    if not res * res > CB.SOFTMAX_TS_CAP:
        raise AssertionError(f'{res * res} texels a face is inside the '
                             f'kernels\' cap')
    scene = (*data.textured_scene(res), res)
    launches = dict(CB.LAUNCHES)
    runs = []
    for _ in range(2):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        times = {}
        img, _, _, gfv, gv, gt = gendr_path('surface', 'torch', scene, times)
        runs.append(((img, gfv, gv, gt), times,
                     torch.cuda.max_memory_allocated() / 2 ** 30))
    names = ('image', 'face gradient', 'vertex gradient', 'texel gradient')
    (first, _, _), (second, _, _) = runs
    equal = {n: torch.equal(a.view(torch.int32), b.view(torch.int32))
             for n, a, b in zip(names, first, second)}
    gt = first[3]
    finite = all(bool(torch.isfinite(x).all()) for x in first)
    nonzero = int((gt != 0).sum())
    peak = max(p for _, _, p in runs)
    print(f'[torch texels] {smi_line()}: default GenDR (softmax RGB, '
          f'anti-aliased 256x256) through backend=torch on {GENDR_VIEWS} '
          f'views of the stand-in at {res * res} texels a face (kernels\' '
          f'cap {CB.SOFTMAX_TS_CAP}), texture gradient '
          f'{tuple(gt.shape)}: two runs bitwise equal '
          + ', '.join(f'{n} {e}' for n, e in equal.items())
          + f'; finite {finite}; texel gradient entries not zero '
          f'{nonzero} of {gt.numel()}, largest '
          f'{float(gt.abs().max()):.3g}; forward / backward ms (host clock, '
          f'synchronised) ' + ', '.join(
              f'{t["forward_ms"]:.1f} / {t["backward_ms"]:.1f}'
              for _, t, _ in runs)
          + f'; peak device memory (max_memory_allocated) {peak:.2f} GiB '
          f'(gate {TORCH_PEAK_GIB} GiB)', flush=True)
    del runs, first, second, gt
    torch.cuda.empty_cache()
    if CB.LAUNCHES != launches:
        raise AssertionError('backend=torch launched a kernel')
    if not all(equal.values()):
        raise AssertionError(f'backend=torch: two runs differ: {equal}')
    if not finite or not nonzero:
        raise AssertionError('backend=torch: a non-finite or zero gradient')
    if not peak < TORCH_PEAK_GIB:
        raise AssertionError(f'backend=torch peaked at {peak} GiB')


def obj_path(obj_file):
    """Phase 6, path (e): load_obj of the written OBJ onto the card, the
    default GenDR on 4 views of it forward and backward, and the sweep
    through GENDR_PANDA_OBJ.  Returns the launches of the GenDR run and of
    the sweep, and load_obj's host-clock time."""
    import torch
    from gendr_tpu_torch import data
    from gendr_tpu_torch.raster import cuda_backend as CB
    obj_scene(obj_file)  # builds the tokenizer, reads the files once
    t0 = time.perf_counter()
    scene = obj_scene(obj_file)
    torch.cuda.synchronize()
    load_ms = 1e3 * (time.perf_counter() - t0)
    v, f, tex, res = scene
    TS = res * res
    src = torch.as_tensor(data.textured_scene(res)[2][0], device='cuda')
    bake_err = float((tex.mean(1) - src.mean(1)).abs().max())
    sizes = {ext: os.path.getsize(obj_file[:-4] + ext)
             for ext in ('.obj', '.mtl', '.png')}
    print(f'[obj path] save_obj(texture_res={res}) wrote {sizes} bytes; '
          f'load_obj(load_texture=True, texture_res={res}, device=cuda): '
          f'vertices {tuple(v.shape)}, faces {tuple(f.shape)}, textures '
          f'{tuple(tex.shape)} on {tex.device} in [{float(tex.min()):.4f}, '
          f'{float(tex.max()):.4f}], per-face mean colour within '
          f'{bake_err:.4f} of the source after bake and resample; '
          f'{load_ms:.1f} ms (host clock, second call)', flush=True)
    if tuple(tex.shape) != (1280, TS, 3) or tuple(f.shape) != (1280, 3) \
            or tuple(v.shape) != (642, 3) or not tex.is_cuda:
        raise AssertionError('load_obj shapes or device')
    if not (bool(torch.isfinite(tex).all()) and float(tex.min()) >= 0.0
            and float(tex.max()) <= 1.0):
        raise AssertionError('loaded texture is not finite in [0, 1]')
    if not bake_err < 0.1:
        raise AssertionError(f'bake and resample moved a face colour by '
                             f'{bake_err}')

    for k in CB.LAUNCHES:
        CB.LAUNCHES[k] = 0
    img, _, _, gfv, gv, gt = gendr_path('surface', None, scene)
    torch.cuda.synchronize()
    launches = dict(CB.LAUNCHES)
    ref, _, _, rfv, rv, rt = gendr_path('surface', 'torch', scene)
    torch.cuda.synchronize()
    cuda_ms = _median_ms(lambda: gendr_path('surface', None, scene), 10)
    err = (img - ref).abs().amax(1)
    off_fold = float((err > IMG_TOL).float().mean())
    alpha_err = float((img[:, 3] - ref[:, 3]).abs().max())
    alpha = img[:, 3]
    finite = all(bool(torch.isfinite(x).all()) for x in (img, gfv, gv, gt))
    agree = [agreement(a, b) for a, b in ((gfv, rfv), (gt, rt))]
    print(f'[obj path] default GenDR on {GENDR_VIEWS} views of the loaded '
          f'mesh, TS={TS}, {tuple(img.shape)}: launches={launches} '
          f'finite={finite} alpha in [{float(alpha.min()):.3g}, '
          f'{float(alpha.max()):.3g}] texture_grad_scale='
          f'{float(gt.abs().max()):.3g} texture_grad_nonzero='
          f'{float((gt != 0).float().mean()):.4f} | vs backend=torch: '
          f'max img_err={float(err.max()):.3g}, pixels beyond {IMG_TOL}: '
          f'{off_fold:.6f} (budget {FOLD_BUDGET}), alpha_err='
          f'{alpha_err:.3g} '
          f'face_grad_agree={agree[0]:.6f} texture_grad_agree='
          f'{agree[1]:.6f} | forward + backward {cuda_ms:.3f} ms (median of '
          f'10, CUDA events)', flush=True)
    del ref, rfv, rv, rt
    torch.cuda.empty_cache()
    if render_counts(launches) != render_launches(1, 1):
        raise AssertionError(f'obj path launches {launches}')
    if not finite or not (0.0 <= float(alpha.min())
                          and float(alpha.max()) <= 1.0):
        raise AssertionError('obj path: non-finite output or alpha outside '
                             '[0, 1]')
    if not (float(gt.abs().max()) > 0 and float(gv.abs().max()) > 0):
        raise AssertionError('obj path: a zero gradient')
    if not (off_fold <= FOLD_BUDGET and alpha_err < IMG_TOL):
        raise AssertionError(f'obj path vs torch backend: {off_fold} of the '
                             f'pixels beyond {IMG_TOL}, alpha {alpha_err}')

    os.environ['GENDR_PANDA_OBJ'] = obj_file
    try:
        sweep, _ = panda_path(OBJ_PANDA_ARGS,
                              f'GENDR_PANDA_OBJ, 1280 faces, TS={TS}')
    finally:
        del os.environ['GENDR_PANDA_OBJ']
    return launches, sweep, load_ms


def voxel_path():
    """Phase 6, path (f): Mesh.voxelize of the 1280-face icosphere (radius
    0.4 in the reference's [-0.5, 0.5] convention) on the card and on the
    CPU.  Returns the host-clock ms per grid size on the card."""
    import torch
    import gendr_tpu_torch as G
    from gendr_tpu_torch import data
    v, f = data.icosphere(3)
    ms = {}
    for vs in VOXEL_SIZES:
        mesh = G.Mesh.create(v * 0.4, f, device='cuda')
        mesh.voxelize(vs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vox = mesh.voxelize(vs)
        torch.cuda.synchronize()
        ms[vs] = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        cpu = G.Mesh.create(v * 0.4, f, device='cpu').voxelize(vs)
        cpu_ms = 1e3 * (time.perf_counter() - t0)
        differ = int((vox.cpu() != cpu).sum())
        solid = int(vox.sum())
        radius = 0.4 * vs * vs / (vs - 1)
        ball = 4 / 3 * np.pi * (radius + VOXEL_SHELL) ** 3
        c = vs // 2
        print(f'[voxel path] voxelization of 1280 faces at {vs}^3 on '
              f'{vox.device}: {solid} solid cells, ball of radius '
              f'{radius:.2f} + {VOXEL_SHELL} cells {ball:.0f} (ratio '
              f'{solid / ball:.4f}), centre {int(vox[0, c, c, c])}, corner '
              f'{int(vox[0, 0, 0, 0])}; cells differing from the CPU: '
              f'{differ}; {ms[vs]:.2f} ms on the card, {cpu_ms:.1f} ms on '
              f'the CPU (host clock)', flush=True)
        if tuple(vox.shape) != (1, vs, vs, vs) or not vox.is_cuda:
            raise AssertionError(f'voxel grid {tuple(vox.shape)}')
        if differ:
            raise AssertionError(f'{differ} cells differ from the CPU')
        if not abs(solid / ball - 1) < VOXEL_TOL:
            raise AssertionError(f'solid count {solid} against {ball}')
        if int(vox[0, c, c, c]) != 1 or int(vox[0, 0, 0, 0]) != 0:
            raise AssertionError('centre not solid or corner not empty')
    return ms


def camera_path():
    """Phase 6, path (g): opt_camera --quick on the card (16 poses, 50
    steps, 64x64, alpha only, tau annealed 1e-1 .. 1e-7).  Returns each
    kernel's launches in the run and the seconds it took."""
    import torch
    from gendr_tpu_torch.experiments import opt_camera as OC
    from gendr_tpu_torch.raster import cuda_backend as CB
    args = OC.parse_args(CAMERA_ARGS)
    exp = OC.CameraExperiment(args, args.device, args.backend)
    init = OC.initial_poses(args.batch_size, 15, 35)
    exp.run(init, num_iterations=2)  # warm-up
    for k in CB.LAUNCHES:
        CB.LAUNCHES[k] = 0
    rec = exp.run(init)
    torch.cuda.synchronize()
    launches = dict(CB.LAUNCHES)
    losses = np.array(rec['losses'])
    first, last = float(losses[:5].mean()), float(losses[-5:].mean())
    finite = bool(np.isfinite(rec['poses']).all()
                  and np.isfinite(losses).all())
    moved = float(np.abs(rec['poses'] - init).max())
    print(f'[camera path] opt_camera {" ".join(CAMERA_ARGS)}: '
          f'{args.batch_size} poses, {rec["iterations"]} steps at '
          f'{args.image_size}x{args.image_size}, procedural cube: IoU loss '
          f'(sum over poses) {first:.4f} over the first 5 steps, {last:.4f} '
          f'over the last 5; poses and losses finite={finite}, largest pose '
          f'change {moved:.3f}; {1e3 * rec["seconds"] / rec["iterations"]:.3f}'
          f' ms per step (host clock, synchronized at the ends); '
          f'launches={launches}', flush=True)
    if not last < first:
        raise AssertionError(f'camera loss did not fall: {first} -> {last}')
    if not finite:
        raise AssertionError('camera path: non-finite pose or loss')
    n = rec['iterations']
    if render_counts(launches) != render_launches(n, n, n):
        raise AssertionError(f'camera path launches {launches}')
    return launches, rec['seconds']


def reconstruction_args(device='cuda', extra=()):
    """The command line of path (i): train_reconstruction at full width on
    the synthetic classes, RECON_OBJECTS objects a class."""
    return ['--synthetic', '--class_ids', ','.join(RECON_CLASSES),
            '--synthetic-objects', str(RECON_OBJECTS), '--device', device,
            *extra]


def _rel(got, want):
    """Norm-relative difference of two tensors."""
    return float((got.double() - want.double()).norm()
                 / want.double().norm())


def reconstruction_path(device='cuda'):
    """Path (i1): RECON_STEPS steps of train_reconstruction's CLI at full
    width (batch 64: 256 silhouettes a step at 64x64 through K1a / K2a),
    an evaluation at the end.  The mean loss of the last 5 steps must be
    below that of the first 5, every loss and gradient finite, the mean
    voxel IoU finite, and each kernel launched once a step (the forward
    also once for each object of the synthetic dataset: 24 views in one
    render).  Returns each kernel's launches and the run's result."""
    import torch
    from gendr_tpu_torch.experiments import train_reconstruction as TR
    from gendr_tpu_torch.raster import cuda_backend as CB
    argv = reconstruction_args(device, [
        '-ni', str(RECON_STEPS), '--eval_freq', str(RECON_STEPS),
        '--print_freq', '5', '--max-eval-batches', '2', '--chain', '1'])
    for k in CB.LAUNCHES:
        CB.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    res = TR.main(argv)
    if device != 'cpu':
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(CB.LAUNCHES)
    losses = np.array(res['losses'])
    first, last = float(losses[:5].mean()), float(losses[-5:].mean())
    print(f'[reconstruction path] train_reconstruction {" ".join(argv)}: '
          f'Encoder 64/1024/512, Decoder 1024 wide on the 642-vertex '
          f'template (1280 faces), batch 64 (256 silhouettes a step) at '
          f'64x64, uniform x probabilistic, tau '
          f'{TR.parse_args(argv).dist_scale:.6g}; '
          f'loss {first:.6f} over the first 5 steps, {last:.6f} over the '
          f'last 5 ({[round(x, 6) for x in res["losses"]]}); gradients '
          f'finite={res["grads_finite"]}; mean voxel IoU '
          f'{res["mean_iou"]:.3f}; {seconds:.1f} s with the dataset and '
          f'the evaluation; launches={launches}', flush=True)
    if len(losses) != RECON_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f'reconstruction losses {losses}')
    if not last < first:
        raise AssertionError(f'reconstruction loss did not fall: {first} '
                             f'-> {last}')
    if not res['grads_finite']:
        raise AssertionError('reconstruction: a non-finite gradient')
    if not np.isfinite(res['mean_iou']):
        raise AssertionError(f'reconstruction IoU {res["mean_iou"]}')
    objects = RECON_OBJECTS * len(RECON_CLASSES)
    if device != 'cpu' and render_counts(launches) != render_launches(
            RECON_STEPS + objects, RECON_STEPS):
        raise AssertionError(f'reconstruction path launches {launches}')
    return launches, res


def reconstruction_inputs(device='cuda'):
    """The inputs path (i) gives the kernels: the first step's render (the
    model at its initial weights on the seed's first batch, [Raa, Rba,
    Rab, Rbb]: B=256 at 64x64, alpha only) and the synthetic dataset's
    render of its first object (24 views, heaviside CDF, hard alpha, hard
    RGB).  Yields (name, cfg, params, face vertices, textures)."""
    import torch
    from gendr_tpu_torch.experiments import train_reconstruction as TR
    from gendr_tpu_torch.raster.render import render_config
    args = TR.parse_args(reconstruction_args(device))
    dataset, _ = TR.make_datasets(args, device)
    exp = TR.build_experiment(args, device)
    ia, ib, ea, eb = (torch.from_numpy(x).to(device) for x in
                      dataset.get_random_batch(np.random.RandomState(
                          args.seed), args.batch_size))
    with torch.no_grad():
        verts = exp.reconstruct(torch.cat([ia, ib]), True)
        mesh = exp.silhouette_mesh(torch.cat([verts, verts]),
                                   torch.cat([ea, ea, eb, eb]))
    exp.renderer.dist_scale = args.dist_scale
    cfg, params = render_config(**exp.renderer.render_kwargs())
    fv = mesh.face_vertices
    yield ('recon', cfg, params,
           fv.reshape(fv.shape[0], fv.shape[1], 9).contiguous(),
           mesh.face_textures.contiguous())
    # the dataset's renderer on its first object (SyntheticShapeNet)
    from gendr_tpu_torch import GenDR, Lighting, LookAt, Mesh, data
    rng = np.random.RandomState(args.seed)
    v, f = data.icosphere(2)
    verts = torch.as_tensor(TR._synthetic_shape(rng, RECON_CLASSES[0], v),
                            device=device)
    renderer = GenDR(image_size=args.image_size, dist_func=0,
                     dist_scale=1e-4, dist_squared=True, dist_eps=1,
                     aggr_alpha_func=0, aggr_rgb_func='hard')
    look = LookAt(viewing_angle=15).to(device)
    look.set_eyes(TR._eyes(2.732, 30.0, np.arange(24, dtype=np.float32)))
    with torch.no_grad():
        mesh = look(Lighting().to(device)(Mesh.create(
            verts[None].repeat(24, 1, 1), np.repeat(f[None], 24, 0))))
    cfg, params = render_config(**renderer.render_kwargs())
    fv = mesh.face_vertices
    yield ('recon data', cfg, params,
           fv.reshape(fv.shape[0], fv.shape[1], 9).contiguous(),
           mesh.face_textures.contiguous())


def reconstruction_phase(opt_shape_steps, device='cuda'):
    """Paths (i2), (i4) and (i5): K1a / K2a against their plain versions on
    path (i)'s own inputs with phase 1's gates (the check's time and peak
    device memory printed: the plain versions walk B=256 x 4096 pixels a
    face chunk at a time); SyntheticShapeNet's silhouettes and voxels on
    the card against the CPU's plain render and voxelizer; the training
    step's time, host clock after warm-up, beside opt_shape's.  Returns
    (largest image error, largest gradient error, median step ms)."""
    import torch
    from gendr_tpu_torch.experiments import train_reconstruction as TR
    worst_img = worst_grad = 0.0
    for name, cfg, params, fv, tex in reconstruction_inputs(device):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        img_err, grad_err = check_kernels(name, cfg, params, fv, tex)
        torch.cuda.synchronize()
        print(f'[kernel vs plain] {name}: the check (kernels, plain versions '
              f'and the backward twice) took {time.perf_counter() - t0:.2f} '
              f's, peak device memory '
              f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB',
              flush=True)
        worst_img, worst_grad = max(worst_img, img_err), max(worst_grad,
                                                             grad_err)
        del fv, tex
        torch.cuda.empty_cache()

    # (i4) one object of each class: the card's render and voxels against
    # the CPU's
    card = TR.SyntheticShapeNet(1, 64, 0, RECON_CLASSES, device=device)
    cpu = TR.SyntheticShapeNet(1, 64, 0, RECON_CLASSES, device='cpu')
    agree = float((card.images == cpu.images).mean())
    voxels_equal = bool(np.array_equal(card.voxels, cpu.voxels))
    print(f'[reconstruction data] SyntheticShapeNet, 1 object of each of '
          f'{list(RECON_CLASSES)}, 24 views at 64x64 and 32^3 voxels: '
          f'silhouette pixels equal to the CPU\'s {agree:.6f} (coverage '
          f'{float((cpu.images[:, 3] > 0).mean()):.4f}), voxels equal '
          f'{voxels_equal} ({int(cpu.voxels.sum())} solid cells)',
          flush=True)
    if not agree >= RECON_SIL_AGREE:
        raise AssertionError(f'synthetic silhouettes: {agree} of pixels '
                             f'equal to the CPU\'s')
    if not voxels_equal:
        raise AssertionError('synthetic voxels differ from the CPU\'s')

    # (i5) the step, synchronized, after 3 warm-up steps
    args = TR.parse_args(reconstruction_args(device))
    args.synthetic_objects = 1
    dataset, _ = TR.make_datasets(args, device)
    exp = TR.build_experiment(args, device)
    opt = torch.optim.Adam(exp.parameters(), lr=args.learning_rate)
    images = torch.from_numpy(dataset.images).to(device)
    rng = np.random.RandomState(args.seed)
    times = []
    for i in range(3 + RECON_TIMED_STEPS):
        ids_a, ids_b, ea, eb = dataset.get_random_batch_ids(rng,
                                                            args.batch_size)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = [images[torch.from_numpy(ids).to(device).long()].float()
                 / 255. for ids in (ids_a, ids_b)]
        exp.train_step(opt, *batch, torch.from_numpy(ea).to(device),
                       torch.from_numpy(eb).to(device), args.dist_scale)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    step_ms = float(np.median(times[3:]))
    print(f'[reconstruction step] train_reconstruction step (batch 64, '
          f'256 silhouettes at 64x64, 1280 faces: encoder, decoder, render '
          f'forward + backward, Adam), host clock, synchronized: median '
          f'{step_ms:.3f} ms of {RECON_TIMED_STEPS} after 3 warm-up steps '
          f'({[round(t, 3) for t in times]}), beside opt_shape\'s '
          f'{1e3 * float(np.median(opt_shape_steps[1:])):.3f} ms (24 '
          f'silhouettes, phase 3)', flush=True)
    return worst_img, worst_grad, step_ms


def _grad(exp, batch, dist_scale, order):
    """The loss's gradient over every parameter, one flat vector, on the
    batch with its samples in ``order``."""
    import torch
    for p in exp.parameters():
        p.grad = None
    exp.loss_fn(*(x[order] for x in batch), dist_scale).backward()
    return torch.cat([p.grad.reshape(-1) for p in exp.parameters()])


def reconstruction_dp_phase(device='cuda'):
    """Path (i3) over RECON_DP_SEEDS (the runs' --seed: the weights, the
    batch): for each, _reconstruction_dp_step, whose parameters are held
    to RECON_DP_REL at the first seed (the one path (i3) has always run)
    and to their own floor at every seed, and each gradient tensor to its
    own floor; then the spread of the differences over the seeds.
    Returns each kernel's launches summed over the ranks of every seed's
    step."""
    launches, params, floors = {}, [], []
    ratios = {'parameters': [], 'gradient': []}
    for seed in RECON_DP_SEEDS:
        errs, floor, step_launches, by_tensor = _reconstruction_dp_step(
            device, seed, first=seed == RECON_DP_SEEDS[0])
        params.append(errs['parameters'])
        floors.append(floor)
        for kind, rows in by_tensor.items():
            ratios[kind] += [(_ratio(d, f), n, seed)
                             for n, (d, f) in rows.items()]
        for k, n in step_launches.items():
            launches[k] = launches.get(k, 0) + n
    print(f'[reconstruction dp] seeds {list(RECON_DP_SEEDS)}: parameters '
          f'after the step, norm-relative, dp against one process '
          f'{[float(f"{e:.3g}") for e in params]} (max {max(params):.3g}; '
          f'gate {RECON_DP_REL} at seed {RECON_DP_SEEDS[0]}); one process '
          f'with the batch reordered, the largest of {RECON_DP_REORDERS} '
          f'orders {[float(f"{e:.3g}") for e in floors]} (gate: '
          f'{RECON_DP_FLOOR_K:g} times, at every seed)', flush=True)
    for kind, rs in ratios.items():
        k = RECON_DP_GRAD_TENSOR_K if kind == 'gradient' else RECON_DP_FLOOR_K
        print(f'[reconstruction dp] the {kind} by tensor, the largest dp / '
              f'floor ratios: ' + ', '.join(
                  f'{n} {r:.2f} (seed {sd})'
                  for r, n, sd in sorted(rs, reverse=True)[:5])
              + f'; above {k:g} times their floor: '
              f'{sum(r > k for r, _, _ in rs)} of {len(rs)}'
              + (' (the gate)' if kind == 'gradient' else ' (printed)'),
              flush=True)
    return launches


def _ratio(d, f):
    """d / f, where a floor of 0 gives inf (or 0 where d is 0 too)."""
    return d / f if f > 0 else (float('inf') if d > 0 else 0.0)


def _reconstruction_dp_step(device, seed, first=True):
    """One step of train_reconstruction --data-parallel 2 (two gloo ranks
    of the one card) against the one-process step at --seed seed, from
    the checkpoint each saves after it.  Within RECON_DP_REL
    norm-relative: the loss, the parameters after the step (over the
    whole model) and each BatchNorm statistic (which needs the whole batch's moments).  The
    gradient itself, Adam's first moment in the checkpoint (Adam's first
    step, about lr times the gradient's sign, would not show a gradient
    off by a constant factor), within RECON_DP_GRAD_REL.  Printed beside
    them, the floor of both: in one process, the largest change of the
    gradient, and of the parameters after Adam's first step, when the
    batch's samples are merely put in RECON_DP_REORDERS other orders
    (BatchNorm's sums in another order).  A convolution's bias, whose exact
    gradient is 0 under the BatchNorm that follows, is held to no more
    than lr on both sides.  The parameters are held to RECON_DP_REL where
    ``first`` and to RECON_DP_FLOOR_K times their floor at every seed;
    the gradient of each parameter tensor to RECON_DP_GRAD_TENSOR_K times
    that tensor's floor; the other differences to their bounds at every
    seed.  Prints the parameters' and the gradient's numbers tensor by
    tensor.  Returns (the differences by name, the parameters' floor,
    each kernel's launches summed over the ranks, {'parameters' or
    'gradient': {parameter name: (its dp difference, its floor)}})."""
    import tempfile
    import torch
    from gendr_tpu_torch.experiments import train_reconstruction as TR
    argv = reconstruction_args(device, [
        '-ni', '1', '--eval_freq', '1', '--print_freq', '1',
        '--max-eval-batches', '1', '--synthetic-objects', '2', '--chain',
        '1', '--seed', str(seed)])
    with tempfile.TemporaryDirectory() as tmp:
        one = TR.main(argv + ['--checkpoint-dir', os.path.join(tmp, 'one')])
        t0 = time.perf_counter()
        two = TR.main(argv + ['--checkpoint-dir', os.path.join(tmp, 'two'),
                              '--data-parallel', str(RECON_DP_RANKS)])
        seconds = time.perf_counter() - t0
        want, got = (torch.load(TR._checkpoints(os.path.join(tmp, d))[-1],
                                weights_only=True) for d in ('one', 'two'))
    args = TR.parse_args(argv)
    exp = TR.build_experiment(args, device)
    names = exp.parameter_names()
    lr = args.learning_rate

    def flat(state, stats):
        return torch.cat([v.reshape(-1) for part in ('encoder', 'decoder')
                          for k, v in state[part].items()
                          if ('running' in k) == stats])

    def moment(ckpt):
        return torch.cat([ckpt['optimizer']['state'][i]['exp_avg']
                          .reshape(-1) for i in range(len(names))])
    errs = {'loss': abs(two['losses'][0] - one['losses'][0])
            / abs(one['losses'][0]),
            'parameters': _rel(flat(got, False), flat(want, False))}
    for part in ('encoder', 'decoder'):
        for k, w in want[part].items():
            if 'running' in k:
                errs[f'{part}.{k}'] = _rel(got[part][k], w)
    bias_ok = all(
        max(float(got[p][k].abs().max()), float(want[p][k].abs().max()))
        <= lr * 1.001 for p, k in (n.split('.', 1) for n in names)
        if k.startswith('convs.') and k.endswith('.bias'))
    grad_rel = _rel(moment(got), moment(want))
    # the floor: one process, the same batch in other orders
    dataset, _ = TR.make_datasets(args, device)
    batch = [torch.from_numpy(x).to(device) for x in
             dataset.get_random_batch(np.random.RandomState(args.seed),
                                      args.batch_size)]
    order = torch.arange(args.batch_size, device=device)
    perms = np.random.RandomState(seed)
    orders = [order.flip(0)] + [
        torch.from_numpy(perms.permutation(args.batch_size)).to(device)
        for _ in range(RECON_DP_REORDERS - 1)]
    theta = torch.cat([p.detach().reshape(-1) for p in exp.parameters()])

    def adam_step(g):
        # Adam's first step from zero moments: -lr g / (|g| + eps)
        return theta - lr * g / (g.abs() + 1e-8)
    sizes = [p.numel() for p in exp.parameters()]
    g0 = _grad(exp, batch, args.dist_scale, order)
    floor_grad = floor_params = 0.0
    # the same two floors parameter tensor by parameter tensor
    floor_by = {'parameters': [0.0] * len(names),
                'gradient': [0.0] * len(names)}

    def by_tensor_max(kind, a, b):
        floor_by[kind] = [max(f, _rel(x, y)) for f, x, y in
                          zip(floor_by[kind], a.split(sizes), b.split(sizes))]
    for o in orders:
        g1 = _grad(exp, batch, args.dist_scale, o)
        floor_grad = max(floor_grad, _rel(g1, g0))
        a1, a0 = adam_step(g1), adam_step(g0)
        floor_params = max(floor_params, _rel(a1, a0))
        by_tensor_max('parameters', a1, a0)
        by_tensor_max('gradient', g1, g0)
    dp_by = {'parameters': [_rel(got[part][k], want[part][k]) for part, k in
                            (n.split('.', 1) for n in names)],
             'gradient': [_rel(x, y) for x, y in zip(
                 moment(got).split(sizes), moment(want).split(sizes))]}
    by_tensor = {kind: {n: (d, f) for n, d, f in
                        zip(names, dp_by[kind], floor_by[kind])}
                 for kind in dp_by}
    grad_over = {n: _ratio(d, f) for n, (d, f) in by_tensor['gradient']
                 .items() if not d <= RECON_DP_GRAD_TENSOR_K * f}
    for kind, rows in by_tensor.items():
        print(f'[reconstruction dp] seed {seed}, the {kind} by tensor, '
              f'norm-relative: dp against one process / the largest of '
              f'{RECON_DP_REORDERS} one-process reorders = ratio: '
              + '; '.join(f'{n} {d:.3g} / {f:.3g} = {_ratio(d, f):.2f}'
                          for n, (d, f) in rows.items()), flush=True)
    worst = max((k for k in errs if k != 'parameters'), key=errs.get)
    launches = {k: sum(r[k] for r in two['launches'])
                for k in two['launches'][0]}
    print(f'[reconstruction dp] --data-parallel {RECON_DP_RANKS} (gloo, '
          f'ranks on one card, BatchNorm with the whole batch\'s moments) '
          f'vs one process, seed {seed}, first step at batch '
          f'{args.batch_size}: loss '
          f'{two["losses"][0]:.8f} vs {one["losses"][0]:.8f}; norm-relative '
          f'differences: loss {errs["loss"]:.3g}, parameters after the '
          f'step {errs["parameters"]:.3g} (one process, the batch in '
          f'{RECON_DP_REORDERS} other orders, largest: '
          f'{floor_params:.3g}), largest BatchNorm statistic '
          f'{max(v for k, v in errs.items() if "running" in k):.3g}, '
          f'gradient {grad_rel:.3g} (one process, batch reordered, '
          f'largest: '
          f'{floor_grad:.3g}); the gradient tensor by tensor within '
          f'{RECON_DP_GRAD_TENSOR_K:g} times its floor: '
          f'{len(names) - len(grad_over)} of {len(names)} (largest ratio '
          f'{max(_ratio(d, f) for d, f in by_tensor["gradient"].values()):.3f}'
          f'); convolution biases within lr {bias_ok}; '
          f'seconds in collectives per rank {two["collective_seconds"]}; '
          f'launches per rank {two["launches"]}; {seconds:.1f} s with the '
          f'ranks\' start', flush=True)
    if not (errs[worst] < RECON_DP_REL and bias_ok
            and grad_rel < RECON_DP_GRAD_REL and not grad_over
            and errs['parameters'] <= RECON_DP_FLOOR_K * floor_params
            and (errs['parameters'] < RECON_DP_REL or not first)):
        raise AssertionError(f'data-parallel step vs one process at seed '
                             f'{seed}: {worst} {errs[worst]}, parameters '
                             f'{errs["parameters"]} (floor {floor_params}), '
                             f'gradient {grad_rel}, gradient tensors over '
                             f'{RECON_DP_GRAD_TENSOR_K:g} times their floor '
                             f'{grad_over}, biases {bias_ok}')
    if device != 'cpu' and not all(r[k] >= 1 for r in two['launches']
                                   for k in RENDER_KERNELS):
        raise AssertionError(f'a dp rank launched no kernel: '
                             f'{two["launches"]}')
    return errs, floor_params, launches, by_tensor


# ---------------------------------------------------------------------------
# path (j): --chain of the three experiments
# ---------------------------------------------------------------------------

def record_captured_kernels():
    """Wrap both kernel wrappers so that each call made while a CUDA graph
    is captured keeps its arguments and its output: buffers of the graph,
    which every replay writes again.  The calls of a StepChain's marked
    copy of its step (captured while a phase recorder is active) are left
    out: that graph replays only under a profiler.  Returns (calls,
    restore)."""
    import torch
    from gendr_tpu_torch.raster import cuda_backend as CB
    from gendr_tpu_torch.utils import profiling
    calls = []
    originals = {n: getattr(CB, n) for n in ('rasterize_fwd',
                                             'rasterize_bwd')}

    def wrap(name, fn):
        def recorded(*args, **kw):
            out = fn(*args, **kw)
            if torch.cuda.is_current_stream_capturing() \
                    and profiling.recorder() is None:
                calls.append((name, args, kw, out))
            return out
        return recorded
    for name, fn in originals.items():
        setattr(CB, name, wrap(name, fn))

    def restore():
        for name, fn in originals.items():
            setattr(CB, name, fn)
    return calls, restore


def replay_vs_plain(label, calls):
    """(j4): each kernel launch of a captured step, its output as the last
    replay left it against the plain version on the same buffers, with
    phase 1's gates.  Returns (image error, gradient error)."""
    import torch
    from gendr_tpu_torch.raster import cuda_backend as CB
    torch.cuda.synchronize()
    parts, img_err, grad_err = [], 0.0, 0.0
    for name, args, kw, out in calls:
        plain = getattr(CB, name + '_plain')(*args, **kw)
        torch.cuda.synchronize()
        err = float((out - plain).abs().max())
        B = out.shape[0]
        if name == 'rasterize_fwd':
            img_err = max(img_err, err)
            parts.append(f'K1 B={B} err={err:.3g}')
            if not err < IMG_TOL:
                raise AssertionError(f'{label}: replay K1 err {err}')
        else:
            agree = agreement(out, plain)
            grad_err = max(grad_err, err)
            parts.append(f'K2 B={B} agree={agree:.6f} err={err:.3g} '
                         f'scale={float(plain.abs().max()):.3g}')
            if not agree > GRAD_AGREE:
                raise AssertionError(f'{label}: replay K2 agreement {agree}')
        del plain
    torch.cuda.empty_cache()
    print(f'[chain] (j4) {label}: the kernels of a replay against their '
          f'plain versions on the graph\'s buffers: '
          + '; '.join(parts), flush=True)
    if not any(c[0] == 'rasterize_fwd' for c in calls) \
            or not any(c[0] == 'rasterize_bwd' for c in calls):
        raise AssertionError(f'{label}: the graph holds no K1 or no K2')
    return img_err, grad_err


def _rel_list(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want),
                                                         1e-30)))


def _launch_counts(steps, before, replays0, captured0):
    """Kernel launches of a run through a StepChain: what the wrappers
    counted (warm-up and eager steps; a capture's calls record, not
    launch) plus the captured launches times the run's replays."""
    from gendr_tpu_torch.raster import cuda_backend as CB
    new_capture = steps.captured if not captured0 else {}
    return {k: CB.LAUNCHES[k] - before[k] - new_capture.get(k, 0)
            + steps.captured.get(k, 0) * (steps.replays - replays0)
            for k in CB.LAUNCHES}


def chained_run(steps, fn):
    """fn() through steps, a StepChain: (fn's result, its kernel
    launches, the blocks it fetched)."""
    from gendr_tpu_torch.raster import cuda_backend as CB
    before = dict(CB.LAUNCHES)
    replays0, fetches0 = steps.replays, steps.fetches
    captured0 = steps.graph is not None
    res = fn()
    return (res, _launch_counts(steps, before, replays0, captured0),
            steps.fetches - fetches0)


def time_chain(smi, label, steps, n):
    """(j6): blocks of n steps through steps (a StepChain), each step on
    the inputs its buffers hold now: the median step (host clock, the
    block to its fetch, over n; at least CHAIN_TIMED_BLOCKS blocks and 30
    steps), the device's busy share over blocks of at least 10 steps
    (torch.profiler: device time over wall time), the device kernels a
    step and each render kernel's launches a step; for a captured step,
    also one replay's time on the card (CUDA events around 20 replays back
    to back), which the kernels' time and the gaps between them fill.
    Returns a dict."""
    import torch
    from torch import profiler
    xs = {k: v.detach().cpu()[None].repeat(n, *([1] * v.ndim))
          for k, v in steps.inputs.items()}
    reps = max(CHAIN_TIMED_BLOCKS, 30 // n)
    profiled = max(1, 10 // n)
    steps.run(xs)  # warm-up (the capture, where there is none yet)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps.run(xs)
        times.append(1e3 * (time.perf_counter() - t0) / n)
    torch.cuda.synchronize()
    with profiler.profile(activities=[profiler.ProfilerActivity.CPU,
                                      profiler.ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        (_, launches, _) = chained_run(
            steps, lambda: [steps.run(xs) for _ in range(profiled)])
        wall = time.perf_counter() - t0
    stepped = n * profiled
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(getattr(e, 'self_device_time_total', None)
                  or getattr(e, 'self_cuda_time_total', 0) for e in dev)
    kernels = sum(e.count for e in dev)
    replay_ms = None
    if steps.graph is not None:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            steps.graph.replay()
        end.record()
        end.synchronize()
        replay_ms = start.elapsed_time(end) / 20
    r = dict(step_ms=float(np.median(times)), times=times, profiled=stepped,
             busy=busy_us * 1e-6 / wall if kernels else None,
             kernels=kernels / stepped if kernels else None,
             kernel_ms=busy_us * 1e-3 / stepped if kernels else None,
             replay_ms=replay_ms,
             # the profiler slows what it traces (most where a step is many
             # small kernels): the kernels' time against the untraced step
             kernel_share=(busy_us * 1e-3 / stepped / float(np.median(times))
                           if kernels else None),
             launches={k: v / stepped for k, v in launches.items()})
    busy = 'not measured' if r['busy'] is None else f'{r["busy"]:.4f}'
    replay = '' if replay_ms is None else (
        f'; one replay {replay_ms:.3f} ms on the card (20 back to back, '
        f'CUDA events)')
    print(f'[chain] (j6) {smi}: {label}: median step '
          f'{r["step_ms"]:.3f} ms (host clock, a block of {n} to its '
          f'fetch over {n}, {reps} blocks: '
          f'{[round(t, 3) for t in times]}); device busy share {busy} '
          f'(profiler, {stepped} steps; the kernels\' time a step over the '
          f'untraced median step: '
          f'{r["kernel_share"] if kernels else "not measured"}); device '
          f'kernels a step '
          f'{r["kernels"] if kernels else "not measured"}, their time '
          f'{r["kernel_ms"] if kernels else "not measured"} ms a step'
          f'{replay}; render kernel launches a step {r["launches"]}',
          flush=True)
    return r


def chain_shape_path(smi):
    """(j1): opt_shape at phase 3's width and setting, TRAIN_STEPS steps
    eager and with --chain CHAIN_SHAPE from the template, bitwise equal
    (the experiments' sums run in a fixed order; no deterministic
    algorithms are asked for); the first chained block is one step, whose
    replay (j4) checks.  Then (j6) on new experiments, the eager one run
    twice from the template: bitwise equal too."""
    import torch
    runs = {}
    for chain in (1, CHAIN_SHAPE):
        exp, eyes, targets = _shape_experiment(
            None, extra=['--chain', str(chain)])
        errs = (0.0, 0.0)
        if chain > 1:
            calls, restore = record_captured_kernels()
            try:
                exp.run(TRAIN_LR, TRAIN_SIGMA, eyes, targets, 1)
            finally:
                restore()
            errs = replay_vs_plain('opt_shape (the first replay)', calls)
            del calls
        else:
            exp.run(TRAIN_LR, TRAIN_SIGMA, eyes, targets, 1)
        rec, launches, fetches = chained_run(exp.steps, lambda: exp.run(
            TRAIN_LR, TRAIN_SIGMA, eyes, targets, TRAIN_STEPS))
        params = torch.cat([p.detach().reshape(-1)
                            for p in exp.model.parameters()])
        runs[chain] = dict(rec=rec, launches=launches, fetches=fetches,
                           params=params, errs=errs, steps=exp.steps)
        del exp
    e, c = runs[1], runs[CHAIN_SHAPE]
    h_e, h_c = e['rec']['hard_losses'], c['rec']['hard_losses']
    # a threshold the eager run's best hard loss crosses midway
    thr = float(np.minimum.accumulate(h_e)[TRAIN_STEPS // 2]) + 1e-7

    def steps_to(h):
        below = np.flatnonzero(np.minimum.accumulate(h) < thr)
        return int(below[0]) if below.size else None
    rel = dict(loss=_rel_list(c['rec']['losses'], e['rec']['losses']),
               hard=_rel_list(h_c, h_e),
               params=_rel(c['params'], e['params']))
    same = sum(a == b for a, b in zip(c['rec']['losses'],
                                      e['rec']['losses']))
    same_h = sum(a == b for a, b in zip(h_c, h_e))
    blocks = -(-TRAIN_STEPS // CHAIN_SHAPE)
    # the timing experiments; the eager one runs twice from the template
    # first, and the two must agree bitwise
    timed = {}
    for chain in (1, CHAIN_SHAPE):
        exp, eyes, targets = _shape_experiment(
            None, extra=['--chain', str(chain)])
        timed[chain] = [exp.run(TRAIN_LR, TRAIN_SIGMA, eyes, targets,
                                TRAIN_STEPS if chain == 1 else 1)
                        for _ in range(2 if chain == 1 else 1)], exp
    floor = _rel_list(timed[1][0][1]['losses'], timed[1][0][0]['losses'])
    print(f'[chain] (j1) opt_shape --chain {CHAIN_SHAPE} against --chain 1, '
          f'{TRAIN_STEPS} steps, 24 views at 64x64, 642-vertex template: '
          f'relative differences: soft losses '
          f'{rel["loss"]:.3g}, hard losses {rel["hard"]:.3g}, parameters '
          f'after step {TRAIN_STEPS} {rel["params"]:.3g} (norm); bitwise '
          f'equal: {same} of {TRAIN_STEPS} soft, {same_h} hard losses '
          f'(two eager runs from the template: soft losses '
          f'{floor:.3g} apart); steps to the hard loss {thr:.6f}: '
          f'{steps_to(h_c)} chained, {steps_to(h_e)} eager; hard loss '
          f'{h_e[0]:.6f} -> {h_e[-1]:.6f}; host fetches {c["fetches"]} for '
          f'{blocks} blocks (eager {e["fetches"]}); captured launches a '
          f'step {c["steps"].captured}; launches eager {e["launches"]}, '
          f'chained {c["launches"]}', flush=True)
    if max(rel.values()) != 0 or same != TRAIN_STEPS \
            or same_h != TRAIN_STEPS or floor != 0:
        raise AssertionError(f'(j1) chained vs eager not bitwise: {rel}, '
                             f'{same}, {same_h}; two eager runs {floor}')
    if steps_to(h_c) != steps_to(h_e) or steps_to(h_e) is None:
        raise AssertionError('(j1) steps to threshold differ')
    if c['fetches'] != blocks or e['fetches'] != TRAIN_STEPS:
        raise AssertionError(f'(j1) fetches {c["fetches"]}, '
                             f'{e["fetches"]}')
    for r in (e, c):
        if min(r['launches'][k] for k in RENDER_KERNELS) < TRAIN_STEPS:
            raise AssertionError(f'(j1) launches {r["launches"]}')
    timing = {chain: time_chain(
        smi, f'opt_shape --chain {chain} (train step + hard eval)',
        exp.steps, chain) for chain, (_, exp) in timed.items()}
    return c['launches'], c['errs'], timing


def adam_vs_optax_rule():
    """(j2): the capturable Adam of the experiments on the card, stepped by
    replays of a captured graph (the gradient from a static buffer),
    against optax.adam(1.0, b1=0.5, b2=0.99) with its updates scaled by
    lr, transcribed in numpy float64 (optax is not on the card): 5 steps
    at lr 0.3, test_torch_camera.py's test_adam_matches_optax and its
    tolerance."""
    import torch
    from gendr_tpu_torch.experiments.common import StepChain, make_adam
    rng = np.random.RandomState(0)
    p0 = rng.randn(4, 4).astype(np.float32)
    grads = rng.randn(5, 4, 4).astype(np.float32)
    p = torch.tensor(p0, device='cuda', requires_grad=True)
    opt = make_adam([p], 0.3, betas=(0.5, 0.99))
    g = torch.zeros(4, 4, device='cuda')

    def step():
        p.grad = g.clone()
        opt.step()
        return p.detach().sum()[None]
    steps = StepChain(step, {'g': g}, capture=True, state=[p], optimizer=opt)
    steps.run({'g': grads})
    want, mu, nu = p0.astype(np.float64), 0.0, 0.0
    for t, gr in enumerate(grads.astype(np.float64), 1):
        mu = 0.5 * mu + 0.5 * gr
        nu = 0.99 * nu + 0.01 * gr * gr
        want = want - 0.3 * (mu / (1 - 0.5 ** t)) / (
            np.sqrt(nu / (1 - 0.99 ** t)) + 1e-8)
    got = p.detach().cpu().numpy()
    err = float(np.abs(got - want).max())
    ok = bool(np.allclose(got, want, rtol=ADAM_RTOL, atol=ADAM_ATOL))
    print(f'[chain] (j2) capturable Adam (lr a tensor on the card), 5 '
          f'replays of a captured step against optax.adam\'s rule: max '
          f'|diff| {err:.3g}, within rtol {ADAM_RTOL} atol {ADAM_ATOL}: '
          f'{ok} (replays {steps.replays})', flush=True)
    if not ok:
        raise AssertionError(f'(j2) captured Adam vs optax rule: {err}')


def capture_must_fail():
    """(j5): a step that reads a value back to the host cannot be
    captured: StepChain raises instead of running it eagerly."""
    import torch
    from gendr_tpu_torch.experiments.common import StepChain
    x = torch.ones(4, device='cuda')
    steps = StepChain(lambda: x * float(x.sum()), {'x': x}, capture=True)
    try:
        steps.run({'x': np.ones((2, 4), np.float32)})
    except RuntimeError as e:
        print(f'[chain] (j5) a step that calls float() on a tensor of the '
              f'card: capture raised {type(e).__name__}: '
              f'{str(e).splitlines()[0][:120]}', flush=True)
        torch.cuda.synchronize()
        return
    raise AssertionError('(j5) a capture with a host read-back did not raise')


def chain_camera_path(smi):
    """(j2): opt_camera --quick (16 poses, 50 steps at 64x64) eager and
    with --chain CHAIN_CAMERA (blocks of 20, 20 and 10) from the same
    start, bitwise equal; the chained experiment's first run is 1 step,
    whose replay (j4) checks.  The captured Adam against optax's rule;
    (j6) on new experiments, after two eager runs, bitwise equal too."""
    import torch

    def experiment(chain):
        return camera_experiment(chain, ['--quick'])
    runs, errs = camera_chained_vs_eager(experiment, 'opt_camera')
    e, c = runs[1], runs[CHAIN_CAMERA]
    n = e['rec']['iterations']
    rel = dict(loss=_rel_list(c['rec']['losses'], e['rec']['losses']),
               poses=_rel(*(torch.from_numpy(r['rec']['poses'])
                            for r in (c, e))))
    same = sum(a == b for a, b in zip(c['rec']['losses'],
                                      e['rec']['losses']))
    blocks = -(-n // CHAIN_CAMERA)
    timed = {}
    for chain in (1, CHAIN_CAMERA):
        exp, init = experiment(chain)
        timed[chain] = [exp.run(init, num_iterations=None if chain == 1
                                else 1) for _ in range(2 if chain == 1
                                                       else 1)], exp
    floor = _rel_list(timed[1][0][1]['losses'], timed[1][0][0]['losses'])
    print(f'[chain] (j2) opt_camera --quick --chain {CHAIN_CAMERA} against '
          f'--chain 1, {n} steps, 16 poses at 64x64: relative differences: '
          f'losses {rel["loss"]:.3g}, '
          f'final poses {rel["poses"]:.3g} (norm); bitwise equal losses: '
          f'{same} of {n} (two eager runs: {floor:.3g} apart); loss '
          f'{e["rec"]["losses"][0]:.4f} -> '
          f'{e["rec"]["losses"][-1]:.4f}; host fetches {c["fetches"]} for '
          f'{blocks} blocks (eager {e["fetches"]}); captured launches a '
          f'step {c["steps"].captured}; launches eager {e["launches"]}, '
          f'chained {c["launches"]}', flush=True)
    if not (c['rec']['iterations'] == n and max(rel.values()) == 0
            and same == n and floor == 0):
        raise AssertionError(f'(j2) chained vs eager not bitwise: {rel}, '
                             f'{same} of {n}; two eager runs {floor}')
    if c['fetches'] != blocks or e['fetches'] != n:
        raise AssertionError(f'(j2) fetches {c["fetches"]}, {e["fetches"]}')
    for r in (e, c):
        if render_counts(r['launches']) != render_launches(n, n, n):
            raise AssertionError(f'(j2) launches {r["launches"]}')
    adam_vs_optax_rule()
    timing = {chain: time_chain(smi, f'opt_camera --quick --chain {chain}',
                                exp.chain('iou'), chain)
              for chain, (_, exp) in timed.items()}
    return c['launches'], errs, timing


def chain_reconstruction_path(smi, device='cuda'):
    """(j3): train_reconstruction --synthetic at path (i)'s width through
    main, CHAIN_RECON_STEPS steps eager and with --chain CHAIN_RECON,
    --decay-at CHAIN_RECON_DECAY (blocks of 5, 8 and 3): losses, the
    parameters and BatchNorm's statistics of the checkpoint after the last
    step bitwise equal; the last replay's kernels (j4).  (j6) on two more
    runs of one block each."""
    import tempfile
    import torch
    from gendr_tpu_torch.experiments import train_reconstruction as TR
    from gendr_tpu_torch.raster import cuda_backend as CB
    argv = reconstruction_args(device, [
        '--eval_freq', str(CHAIN_RECON_STEPS), '--print_freq',
        str(CHAIN_RECON_STEPS), '--max-eval-batches', '1', '--decay-at',
        str(CHAIN_RECON_DECAY)])
    runs = {}
    errs = (0.0, 0.0)
    with tempfile.TemporaryDirectory() as tmp:
        for chain in (1, CHAIN_RECON):
            ckpt = os.path.join(tmp, str(chain))
            before = dict(CB.LAUNCHES)
            calls, restore = record_captured_kernels()
            try:
                res = TR.main(argv + ['-ni', str(CHAIN_RECON_STEPS),
                                      '--chain', str(chain),
                                      '--checkpoint-dir', ckpt])
            finally:
                restore()
            steps = res['steps']
            launches = _launch_counts(steps, before, 0, False)
            state = torch.load(TR._checkpoints(ckpt)[-1], weights_only=True)
            runs[chain] = dict(res=res, state=state, launches=launches,
                               steps=steps)
            if chain > 1:
                errs = replay_vs_plain('train_reconstruction (the last '
                                       'replay)', calls)
            del calls, res
    e, c = runs[1], runs[CHAIN_RECON]

    def flat(state, stats):
        return torch.cat([v.reshape(-1) for part in ('encoder', 'decoder')
                          for k, v in state[part].items()
                          if ('running' in k) == stats])
    rel = dict(loss=float(np.linalg.norm(np.subtract(c['res']['losses'],
                                                     e['res']['losses']))
                          / np.linalg.norm(e['res']['losses'])),
               params=_rel(flat(c['state'], False), flat(e['state'], False)),
               stats=_rel(flat(c['state'], True), flat(e['state'], True)))
    same = sum(a == b for a, b in zip(c['res']['losses'],
                                      e['res']['losses']))
    blocks = [TR.block_length(i, CHAIN_RECON, CHAIN_RECON_STEPS,
                              CHAIN_RECON_DECAY, CHAIN_RECON_STEPS,
                              CHAIN_RECON_STEPS) for i in (1, 6, 14)]
    print(f'[chain] (j3) train_reconstruction --synthetic --chain '
          f'{CHAIN_RECON} against --chain 1, batch 64 (256 silhouettes at '
          f'64x64), {CHAIN_RECON_STEPS} steps, --decay-at '
          f'{CHAIN_RECON_DECAY} (blocks {blocks}): norm-relative '
          f'differences: losses {rel["loss"]:.3g} '
          f'({same} of {CHAIN_RECON_STEPS} bitwise equal), parameters '
          f'{rel["params"]:.3g}, BatchNorm statistics {rel["stats"]:.3g}; '
          f'loss {e["res"]["losses"][0]:.6f} -> '
          f'{e["res"]["losses"][-1]:.6f}; host fetches '
          f'{c["steps"].fetches} for {len(blocks)} blocks (eager '
          f'{e["steps"].fetches}); captured launches a step '
          f'{c["steps"].captured}; launches eager {e["launches"]}, chained '
          f'{c["launches"]} (the forward also renders the dataset)',
          flush=True)
    if max(rel.values()) != 0 or same != CHAIN_RECON_STEPS:
        raise AssertionError(f'(j3) chained vs eager not bitwise: {rel}, '
                             f'{same} of {CHAIN_RECON_STEPS}')
    if blocks != [5, 8, 3] or c['steps'].fetches != 3 \
            or e['steps'].fetches != CHAIN_RECON_STEPS:
        raise AssertionError(f'(j3) blocks {blocks}, fetches '
                             f'{c["steps"].fetches}, {e["steps"].fetches}')
    if min(r['launches']['rasterize_bwd'] for r in (e, c)) \
            != CHAIN_RECON_STEPS:
        raise AssertionError(f'(j3) launches {e["launches"]}, '
                             f'{c["launches"]}')
    del runs
    timing = {}
    for chain in (1, CHAIN_RECON):
        res = TR.main(argv + ['-ni', str(max(chain, 3)), '--chain',
                              str(chain)])
        timing[chain] = time_chain(
            smi, f'train_reconstruction --synthetic --chain {chain}',
            res['steps'], chain)
        del res
    return c['launches'], errs, timing


def chain_phase(smi):
    """Path (j): (j1)-(j3), the replays' kernels (j4), the capture's
    checks (j5; capture_must_fail, run last of all, after it) and the step
    times (j6).  Returns (launches by path, the replays' largest image and
    gradient errors, the timings)."""
    t0 = time.perf_counter()
    by_path, timing = {}, {}
    img = grad = 0.0
    for name, fn in (('chain_shape', chain_shape_path),
                     ('chain_camera', chain_camera_path),
                     ('chain_reconstruction', chain_reconstruction_path)):
        by_path[name], (i, g), timing[name] = fn(smi)
        img, grad = max(img, i), max(grad, g)
    print(f'[chain] (j5) every capture in capture_error_mode=\'global\', '
          f'every block\'s replays under torch.cuda.set_sync_debug_mode('
          f'\'error\') (common.StepChain); path (j) took '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    summary = {name: {str(k): dict(step_ms=r['step_ms'], busy=r['busy'],
                                   kernels=r['kernels'],
                                   kernel_ms=r['kernel_ms'],
                                   kernel_share=r['kernel_share'],
                                   replay_ms=r['replay_ms'])
                      for k, r in t.items()} for name, t in timing.items()}
    print(f'[chain] (j6) {smi}: ' + json.dumps(summary), flush=True)
    return by_path, (img, grad), summary


# ---------------------------------------------------------------------------
# path (k): opt_camera at its defaults
# ---------------------------------------------------------------------------

def camera_experiment(chain, extra=(), device='cuda'):
    """The camera experiment of opt_camera's command line with --chain
    chain and the further arguments extra (none: its defaults, 200 poses
    at 64x64), and the starting poses of CAMERA_RANGE."""
    from gendr_tpu_torch.experiments import opt_camera as OC
    args = OC.parse_args(['--device', device, '--chain', str(chain), *extra])
    exp = OC.CameraExperiment(args, args.device, args.backend)
    return exp, OC.initial_poses(args.batch_size, *CAMERA_RANGE)


def camera_chained_vs_eager(experiment, label, n=None):
    """Camera runs from the same poses with --chain CHAIN_CAMERA and with
    --chain 1 (experiment(chain) gives (the experiment, its starting
    poses)): the chained experiment's first run is 1 step, whose replay's
    kernels (j4) checks against their plain versions; then each runs n
    steps (None: its -ni) through chained_run, the kernels' counts set to
    0 just before.  Returns ({chain: dict(rec, launches, fetches, steps,
    exp)}, the replay's (image error, gradient error))."""
    from gendr_tpu_torch.raster import cuda_backend as CB
    runs = {}
    for chain in (1, CHAIN_CAMERA):
        exp, init = experiment(chain)
        if chain > 1:
            calls, restore = record_captured_kernels()
            try:
                exp.run(init, num_iterations=1)
            finally:
                restore()
            errs = replay_vs_plain(f'{label} (the first replay)', calls)
            del calls
        else:
            exp.run(init, num_iterations=1)
        steps = exp.chain('iou')
        for k in CB.LAUNCHES:
            CB.LAUNCHES[k] = 0
        rec, launches, fetches = chained_run(
            steps, lambda: exp.run(init, num_iterations=n))
        runs[chain] = dict(rec=rec, launches=launches, fetches=fetches,
                           steps=steps, exp=exp)
    return runs, errs


def camera_inputs(exp, poses, tau):
    """(cfg, params, face vertices, textures) that the camera experiment's
    soft render of ``poses`` gives the kernels at dist_scale tau."""
    import torch
    from gendr_tpu_torch.experiments import opt_camera as OC
    from gendr_tpu_torch.raster.render import render_config
    cfg, params = render_config(**{**exp.diff_renderer.render_kwargs(),
                                   'dist_scale': tau})
    with torch.no_grad():
        mesh = exp.lighting(exp.base_mesh)
        verts = OC.transform_cameras(
            mesh.vertices, torch.as_tensor(poses, device=exp.device),
            exp.poses_gt)
        mesh = mesh.with_vertices(verts)
    fv = mesh.face_vertices
    return (cfg, params, fv.reshape(fv.shape[0], fv.shape[1], 9).contiguous(),
            mesh.face_textures.contiguous())


def camera_default_kernels(smi, exp, init, reps=50):
    """(k1): both kernels against their plain versions (check_kernels'
    gates) on the soft render of the experiment's first step, B=200, at
    each tau of CAMERA_DEFAULT_TAUS (the anneal's first and last), with
    the compacted lists' shape and K2's slices printed; then each timed
    (time_kernels).  Returns (image error, gradient error, timings by
    shape)."""
    from gendr_tpu_torch.raster import cuda_backend as CB
    img = grad = 0.0
    kt = {}
    for tau in CAMERA_DEFAULT_TAUS:
        cfg, params, fv, tex = camera_inputs(exp, init, tau)
        aux = CB.prepass(fv, tex, cfg, params)
        B, FC = fv.shape[0], cfg.face_chunk
        Fs, Fp = CB.sorted_face_count(aux), aux['packed'].shape[2]
        _, NO = CB._bwd_layout(cfg)
        T = aux['chunk_ids'].shape[2]
        S = CB.bwd_slice_count(B, NO, Fs, T, compacted=Fs < Fp)
        ws_mib = (S > 1) * S * B * NO * Fs * 4 / 2**20
        print(f'[camera defaults] (k1) tau {tau:g}: B={B}, {T} tiles, '
              f'compaction {"on" if "oct_ids" in aux else "off"}: {Fs} '
              f'sorted face columns and {Fp - Fs} slot columns, '
              f'{(Fp - Fs) // FC * B} slab blocks in K2\'s launch of the '
              f'appended chunks; K2 S={S} over the sorted chunks, workspace '
              f'{ws_mib:.2f} MiB', flush=True)
        if 'oct_ids' not in aux:
            raise AssertionError('(k1) compaction did not fire at B=200')
        i, g = check_kernels(f'camera {tau:g}', cfg, params, fv, tex, aux)
        img, grad = max(img, i), max(grad, g)
        shape = f'opt_camera B={B} tau {tau:g}'
        kt[shape] = time_kernels(smi, shape, cfg, params, fv, tex, reps)
    return img, grad, kt


def camera_default_path(smi):
    """Path (k): opt_camera at its defaults.  (k1) camera_default_kernels
    on the first step's inputs; (k2) CAMERA_DEFAULT_STEPS annealed
    steps from the same poses with --chain CHAIN_CAMERA and with --chain 1
    (blocks of 20 against 100 eager steps), the losses and the poses
    bitwise equal with no deterministic algorithms asked for, and the
    first replay's kernels against their plain versions on the graph's
    buffers (as (j4)); each run's launches counted from 0, one of each
    kernel a step; (k3) each step timed (time_chain).  Returns (launches
    by path, (image error, gradient error), timings by shape, the step
    timings)."""
    import torch
    t0 = time.perf_counter()
    n = CAMERA_DEFAULT_STEPS
    img, grad, kt = camera_default_kernels(smi, *camera_experiment(
        CHAIN_CAMERA))
    runs, (i, g) = camera_chained_vs_eager(
        camera_experiment, 'opt_camera defaults, B=200', n)
    img, grad = max(img, i), max(grad, g)
    c, e = runs[CHAIN_CAMERA], runs[1]
    same = sum(a == b for a, b in zip(c['rec']['losses'],
                                      e['rec']['losses']))
    poses_equal = np.array_equal(c['rec']['poses'], e['rec']['poses'])
    blocks = -(-n // CHAIN_CAMERA)
    print(f'[camera defaults] (k2) opt_camera at its defaults (200 poses at '
          f'64x64, range {CAMERA_RANGE}), {n} steps annealed '
          f'1e-1 .. 1e-7, --chain {CHAIN_CAMERA} against --chain 1: bitwise '
          f'equal losses {same} of {n}, final poses bitwise equal '
          f'{poses_equal}; loss {e["rec"]["losses"][0]:.4f} -> '
          f'{e["rec"]["losses"][-1]:.4f}; host fetches {c["fetches"]} for '
          f'{blocks} blocks (eager {e["fetches"]}); launches chained '
          f'{c["launches"]}, eager {e["launches"]}', flush=True)
    if not (c['rec']['iterations'] == e['rec']['iterations'] == n
            and same == n and poses_equal):
        raise AssertionError(f'(k2) chained vs eager not bitwise: {same} of '
                             f'{n} losses, poses equal {poses_equal}')
    if c['fetches'] != blocks or e['fetches'] != n:
        raise AssertionError(f'(k2) fetches {c["fetches"]}, {e["fetches"]}')
    for r in (c, e):
        if render_counts(r['launches']) != render_launches(n, n, n):
            raise AssertionError(f'(k2) launches {r["launches"]}')
    timing = {str(chain): time_chain(
        smi, f'opt_camera defaults (200 poses) --chain {chain}',
        r['exp'].chain('iou'), chain) for chain, r in runs.items()}
    del runs
    torch.cuda.empty_cache()
    print(f'[camera defaults] path (k) took {time.perf_counter() - t0:.1f} s',
          flush=True)
    summary = {k: dict(step_ms=r['step_ms'], busy=r['busy'],
                       kernels=r['kernels'], kernel_ms=r['kernel_ms'],
                       kernel_share=r['kernel_share'],
                       replay_ms=r['replay_ms'], launches=r['launches'])
               for k, r in timing.items()}
    print(f'[camera defaults] (k3) {smi}: ' + json.dumps(summary), flush=True)
    return (dict(camera_default=c['launches'],
                 camera_default_eager=e['launches']),
            (img, grad), kt, summary)


def face_halves(cfg, fv, tex):
    """The two face shards a 2-way face split gives: (face vertices,
    textures, fvalid, base_offset) each; the second carries a chunk of
    padding faces that its fvalid marks invalid, as render_sharded pads."""
    import torch
    F = fv.shape[1]
    h, pad = F // 2, cfg.face_chunk
    fv1 = torch.cat([fv[:, h:], torch.zeros_like(fv[:, :pad])], 1)
    tex1 = torch.cat([tex[:, h:], torch.zeros_like(tex[:, :pad])], 1)
    return [(fv[:, :h], tex[:, :h], None, 0),
            (fv1, tex1, torch.arange(F - h + pad, device=fv.device) < F - h,
             h)]


def shard_parts(cfg, params, fv, tex, n_fp, n_sp):
    """The kernel inputs of each rank of an n_fp x n_sp split of one scene,
    as render_sharded makes them: (label, face vertices, textures, prepass
    aux) of face shard i (padded, with its fvalid) over row band j."""
    from gendr_tpu_torch.parallel import sharding as S
    from gendr_tpu_torch.raster import cuda_backend as CB
    hb = cfg.image_size // n_sp
    parts = []
    for i in range(n_fp):
        f, t, v, _ = S._face_shard(fv, tex, cfg, n_fp, i)
        for j in range(n_sp):
            band = (j * hb, hb) if n_sp > 1 else None
            parts.append((f'fp{i}/{n_fp} sp{j}/{n_sp}', f, t,
                          CB.prepass(f, t, cfg, params, v, band)))
    return parts


def band_parts(cfg, params, fv, tex):
    """Path (h1)'s kernel inputs of one scene: (label, face vertices,
    textures, prepass aux) for each row band of BANDS over all faces, for
    each of the two face_halves over all rows, and for each rank's band of
    a face shard of path (h2)'s fp=2 x sp=2 split."""
    from gendr_tpu_torch.raster import cuda_backend as CB
    parts = [(f'rows {r0}+{hb}', fv, tex,
              CB.prepass(fv, tex, cfg, params, row_band=(r0, hb)))
             for r0, hb in BANDS]
    parts += [(f'half {i}', f, t, CB.prepass(f, t, cfg, params, v))
              for i, (f, t, v, _) in enumerate(face_halves(cfg, fv, tex))]
    return parts + shard_parts(cfg, params, fv, tex, 2, 2)


def rank_inputs():
    """The kernel inputs of every rank of (h2)'s default-GenDR scene
    (fp=2 x sp=2) and of (h3)'s first step (dp=2 x fp=2): (label, cfg,
    params, face vertices, textures, prepass aux)."""
    from gendr_tpu_torch.parallel import sharding as S
    name, cfg, params, fv, tex = next(iter(gendr_inputs()))
    for label, f, t, aux in shard_parts(cfg, params, fv, tex, 2, 2):
        yield f'{name} {label}', cfg, params, f, t, aux
    cfg, params, base_v, faces, eyes_all = train_scene('cuda')
    fv, tex = S.silhouette_inputs(base_v, faces, eyes_all)
    b = SHARD_VIEWS // 2
    for d in range(2):
        for label, f, t, aux in shard_parts(cfg, params, fv[d * b:(d + 1) * b],
                                            tex[d * b:(d + 1) * b], 2, 1):
            yield f'train dp{d}/2 {label}', cfg, params, f, t, aux


def band_phase():
    """Path (h1): K1e and K2e against their plain versions on row bands,
    face halves and the sharded ranks' bands of face shards of the
    flagship and its variants (BAND_CASES), and on the inputs every rank of
    paths (h2) and (h3) launches them on (rank_inputs), with the gates of
    phase 1; then, kernels alone: each band's rows bitwise equal
    to the full render's, the two halves' carries (the second offset by
    its base_offset) merged after the background against the full render,
    and the bands' gradients summed against the full backward.  Returns the
    largest image and gradient errors against the plain versions."""
    import torch
    from gendr_tpu_torch.raster import cuda_backend as CB
    from gendr_tpu_torch.raster import torch_backend as TB
    worst_img = worst_grad = 0.0
    for name, cfg, params, f, t, aux in rank_inputs():
        img_err, grad_err = check_kernels(name, cfg, params, f, t, aux)
        worst_img = max(worst_img, img_err)
        worst_grad = max(worst_grad, grad_err)
    for name, kw, p, ts in BAND_CASES:
        cfg, params, fv, tex = t_conorm_inputs(kw, p, ts)
        halves = face_halves(cfg, fv, tex)
        for label, f, t, aux in band_parts(cfg, params, fv, tex):
            img_err, grad_err = check_kernels(f'{name} {label}', cfg, params,
                                              f, t, aux)
            worst_img = max(worst_img, img_err)
            worst_grad = max(worst_grad, grad_err)
        B, S = fv.shape[0], cfg.image_size
        full, _ = CB.forward_partial(fv, tex, cfg, params)
        differ = 0
        for r0, hb in BANDS:
            band, _ = CB.forward_partial(fv, tex, cfg, params,
                                         row_band=(r0, hb))
            pix = slice(r0 * S, (r0 + hb) * S)
            differ += sum(int((a != b[:, pix]).sum())
                          for a, b in zip(band, full))
        soft, aggrs = CB.forward(fv, tex, cfg, params)
        P = S * S
        bg = params['background_color'].cuda().reshape(1, 1, 3) \
            .expand(B, P, 3)
        merged = TB.background_carry(B, P, bg, cfg, params)
        for f, t, v, off in halves:
            carry, _ = CB.forward_partial(f, t, cfg, params, base_offset=off,
                                          fvalid=v)
            merged = TB.merge_carries(merged, carry, cfg, params)
        msoft, maggrs = TB.finalize(merged, cfg)
        merge_err = float((msoft - soft).abs().max())
        line = (f'[bands] {name}: band rows differing bitwise from the full '
                f'render {differ}; merged face halves vs full render '
                f'img_err={merge_err:.3g}')
        if CB.render_mode(cfg) == CB.MODE_HARD:
            covered = (maggrs[:, 1] >= 0) | (aggrs[:, 1] >= 0)
            ids = float((maggrs[:, 1] == aggrs[:, 1])[covered].float()
                        .mean())
            line += f' winner ids agree {ids:.6f}'
        else:
            ids = 1.0
        g = torch.cat([torch.full_like(soft[:, :3], 0.1), soft[:, 3:]], 1)
        want = CB.backward_from_aux(fv, tex, None, soft, aggrs, g, cfg,
                                    params)
        got = None
        for r0, hb in BANDS[:2]:
            rows = slice(r0, r0 + hb)
            gb = CB.backward_from_aux(
                fv, tex, None, soft[:, :, rows].contiguous(),
                aggrs[:, :, rows].contiguous(), g[:, :, rows].contiguous(),
                cfg, params, row_band=(r0, hb))
            got = gb if got is None else tuple(a + b for a, b in zip(got, gb))
        torch.cuda.synchronize()
        agree = [agreement(a, b) for a, b in zip(got, want)]
        line += (f'; summed band gradients vs full backward: '
                 f'grad_agree={agree[0]:.6f} texgrad_agree={agree[1]:.6f} '
                 f'max_err={float((got[0] - want[0]).abs().max()):.3g}')
        print(line, flush=True)
        if differ or not merge_err < IMG_TOL or ids < WINNER_AGREE \
                or min(agree) <= GRAD_AGREE:
            raise AssertionError(f'bands {name}: {line}')
    return worst_img, worst_grad


def _sync(device):
    import torch
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


def _render_loss(img):
    return 0.5 * (img[:, 3] ** 2).sum() + 0.1 * img[:, :3].sum()


def _sharded_render_rank(scenes, device):
    """(h2) in one rank: each scene through render_sharded's autograd
    (fp=2 x sp=2) and loss.backward(), against the unsharded
    backend='cuda' render on the same card."""
    import torch
    from gendr_tpu_torch.parallel import sharding as S
    from gendr_tpu_torch.raster import cuda_backend as CB
    from gendr_tpu_torch.raster.render import _Render
    mesh = S.make_mesh({'fp': 2, 'sp': 2})
    out = {}
    for name, cfg, params, fv, tex in scenes:
        fv, tex = fv.to(device), tex.to(device)
        render_fn = S.make_sharded_render(cfg, mesh, None, 'fp', 'sp')
        runs = []
        for _ in range(3):  # launches from the first, times from the others
            for k in CB.LAUNCHES:
                CB.LAUNCHES[k] = 0
            c0 = S.collective_seconds()
            fvg = fv.clone().requires_grad_(True)
            texg = tex.clone().requires_grad_(True)
            _sync(device)
            t0 = time.perf_counter()
            img = render_fn(fvg, texg, params)
            _render_loss(img).backward()
            _sync(device)
            runs.append((1e3 * (time.perf_counter() - t0),
                         1e3 * (S.collective_seconds() - c0),
                         dict(CB.LAUNCHES)))
        fvr = fv.clone().requires_grad_(True)
        texr = tex.clone().requires_grad_(True)
        ref = _Render.apply(fvr, texr, cfg, params)
        _render_loss(ref).backward()
        _sync(device)
        out[name] = dict(
            shape=tuple(img.shape),
            img_err=float((img.detach() - ref.detach()).abs().max()),
            finite=bool(torch.isfinite(img).all()
                        and torch.isfinite(fvg.grad).all()),
            grad_agree=agreement(fvg.grad, fvr.grad),
            texgrad_agree=agreement(texg.grad, texr.grad),
            grad_scale=float(fvr.grad.abs().max()),
            ms=[r[0] for r in runs[1:]], collective_ms=[r[1] for r in runs[1:]],
            launches=runs[0][2])
    return out


def train_scene(device):
    """(h3)'s scene: (cfg, params, template vertices [1, 642, 3], faces
    [1, 1280, 3], SHARD_VIEWS eyes) of the dry run's loss at SHARD_SIZE^2."""
    import torch
    from gendr_tpu_torch import config as C, data
    from gendr_tpu_torch.parallel import sharding as S
    v, f = data.icosphere(3)
    cfg = C.RenderConfig.create(image_size=SHARD_SIZE, dist_func='uniform',
                                aggr_alpha_func='probabilistic',
                                aggr_rgb_func='hard', backend='cuda')
    params = C.RenderParams(dist_scale=3e-2, dist_eps=1e2).as_dict()
    return (cfg, params, torch.as_tensor(v, device=device)[None] * 0.5,
            torch.as_tensor(f, device=device)[None],
            torch.as_tensor(S.dryrun_eyes(SHARD_VIEWS), device=device))


def _sharded_train_rank(device):
    """(h3) in one rank: SHARD_STEPS steps of the dry run's IoU loss with
    Adam on a displacement of the 642-vertex template over dp=2 x fp=2 from
    SHARD_VIEWS views at SHARD_SIZE^2, against a target of the template at
    0.8 its size; the first step's gradient against the unsharded step's
    (all views, backend='cuda')."""
    import torch
    from gendr_tpu_torch.parallel import sharding as S
    from gendr_tpu_torch.raster import cuda_backend as CB
    from gendr_tpu_torch.raster.render import _Render
    mesh = S.make_mesh({'dp': 2, 'fp': 2})
    cfg, params, base_v, faces, eyes_all = train_scene(device)

    def unsharded(fv, tex, p):
        return _Render.apply(fv, tex, cfg, p)
    with torch.no_grad():
        target_all = unsharded(*S.silhouette_inputs(base_v * 0.8, faces,
                                                    eyes_all), params)[:, 3]
    d0 = torch.zeros_like(base_v, requires_grad=True)
    S.silhouette_loss(unsharded, params, base_v + d0, faces, eyes_all,
                      target_all).backward()
    eyes, target = S.shard_batch((eyes_all, target_all), mesh)
    render_fn = S.make_sharded_render(cfg, mesh, 'dp', 'fp')
    displace = torch.zeros_like(base_v, requires_grad=True)
    opt = torch.optim.Adam([displace], lr=SHARD_LR)
    for k in CB.LAUNCHES:
        CB.LAUNCHES[k] = 0
    losses, step_ms, coll_ms = [], [], []
    for i in range(SHARD_STEPS):
        c0 = S.collective_seconds()
        _sync(device)
        t0 = time.perf_counter()
        losses.append(S.train_step(lambda: S.silhouette_loss(
            render_fn, params, base_v + displace, faces, eyes, target),
            opt, displace, mesh))
        _sync(device)
        step_ms.append(1e3 * (time.perf_counter() - t0))
        coll_ms.append(1e3 * (S.collective_seconds() - c0))
        if i == 0:
            g0 = displace.grad.clone()
    return dict(losses=losses, step_ms=step_ms, collective_ms=coll_ms,
                launches=dict(CB.LAUNCHES),
                grad_agree=agreement(g0, d0.grad),
                grad_rel=float((g0 - d0.grad).norm() / d0.grad.norm()),
                grad_scale=float(d0.grad.abs().max()))


def _shard_rank(rank, world, init_file, out_dir, scenes, device):
    """One rank of paths (h2) and (h3): gloo over the default group, every
    rank on the one card; saves its results to out_dir."""
    import torch
    import torch.distributed as dist
    torch.set_num_threads(2)
    dist.init_process_group('gloo', init_method=f'file://{init_file}',
                            world_size=world, rank=rank)
    try:
        res = dict(render=_sharded_render_rank(scenes, device),
                   train=_sharded_train_rank(device))
        torch.save(res, os.path.join(out_dir, f'rank{rank}.pt'))
    finally:
        dist.destroy_process_group()


def sharded_phase(opt_shape_steps, scenes=None, device='cuda'):
    """Paths (h2) and (h3): SHARD_RANKS ranks on the one card, gloo.
    (h2): the flagship (256x256, 1280 faces, hard RGB) and the default
    GenDR's inputs (4 views at 512x512, softmax, 25 texels) through the
    sharded render and its gradient on fp=2 x sp=2, against the unsharded
    backend='cuda' render; every rank must launch both kernels.  (h3): the
    sharded training step; its loss must fall and its first gradient agree
    with the unsharded step's (grad_agree and SHARD_GRAD_REL).  Returns the launches of each path summed
    over the ranks and the timings.  scenes: (name, cfg, params, face
    vertices, textures) of (h2) in place of those two."""
    import tempfile
    import torch
    from gendr_tpu_torch import config as C
    from gendr_tpu_torch.parallel import sharding as S
    from gendr_tpu_torch.raster import cuda_backend as CB
    if scenes is None:
        fv, tex = flagship_scene('cuda')
        scenes = [('flagship', flagship_cfg(), C.RenderParams(
            dist_scale=1e-2).as_dict(), fv.cpu(), tex.cpu())]
        _, cfg, params, gfv, gtex = next(iter(gendr_inputs()))
        scenes.append(('gendr', cfg, params, gfv.cpu(), gtex.cpu()))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        S.spawn_ranks(_shard_rank, SHARD_RANKS,
                      (SHARD_RANKS, os.path.join(out_dir, 'init'), out_dir,
                       scenes, device), SHARD_TIMEOUT)
        ranks = [torch.load(os.path.join(out_dir, f'rank{r}.pt'),
                            weights_only=False) for r in range(SHARD_RANKS)]
    seconds = time.perf_counter() - t0
    launches = {'sharded': {k: 0 for k in CB.LAUNCHES},
                'sharded_training': {k: 0 for k in CB.LAUNCHES}}
    failed = []
    for scene, *_ in scenes:
        res = [r['render'][scene] for r in ranks]
        for r in res:
            for k, n in r['launches'].items():
                launches['sharded'][k] += n
        print(f'[sharded render] {scene} {res[0]["shape"]}, fp=2 x sp=2 on '
              f'{SHARD_RANKS} ranks of one card (gloo), forward + '
              f'loss.backward() vs the unsharded backend=cuda render: '
              f'img_err {[r["img_err"] for r in res]}, grad_agree '
              f'{[round(r["grad_agree"], 6) for r in res]}, texgrad_agree '
              f'{[round(r["texgrad_agree"], 6) for r in res]}, grad_scale '
              f'{res[0]["grad_scale"]:.3g}; launches per rank '
              f'{[r["launches"] for r in res]}; forward + backward ms per '
              f'rank (host clock, synchronized; 2 runs after a warm-up) '
              f'{[[round(x, 3) for x in r["ms"]] for r in res]}, of them '
              f'collectives (CUDA events) {[[round(x, 3) for x in r["collective_ms"]] for r in res]}',
              flush=True)
        for r in res:
            if not (r['finite'] and r['img_err'] < IMG_TOL
                    and r['grad_agree'] > GRAD_AGREE
                    and r['texgrad_agree'] > GRAD_AGREE
                    and all(r['launches'][k] >= 1
                            for k in RENDER_KERNELS)):
                failed.append(scene)
    train = [r['train'] for r in ranks]
    for r in train:
        for k, n in r['launches'].items():
            launches['sharded_training'][k] += n
    t = train[0]
    shard_med = float(np.median(t['step_ms'][1:]))
    coll_med = float(np.median(t['collective_ms'][1:]))
    opt_med = 1e3 * float(np.median(opt_shape_steps[1:]))
    print(f'[sharded training] dry run loss (1 - IoU), Adam lr {SHARD_LR}, '
          f'642-vertex template (1280 faces), {SHARD_VIEWS} views at '
          f'{SHARD_SIZE}x{SHARD_SIZE}, dp=2 x fp=2 on {SHARD_RANKS} ranks: '
          f'loss {t["losses"][0]:.6f} at step 1, {t["losses"][-1]:.6f} at '
          f'step {SHARD_STEPS}; first gradient vs the unsharded step: '
          f'grad_agree {[round(r["grad_agree"], 6) for r in train]}, '
          f'norm-relative error {[r["grad_rel"] for r in train]}, scale '
          f'{t["grad_scale"]:.3g}; median step {shard_med:.3f} ms (host '
          f'clock, synchronized) of which collectives {coll_med:.3f} ms '
          f'(CUDA events), '
          f'beside opt_shape\'s {opt_med:.3f} ms (phase 3, one process); '
          f'launches per rank {[r["launches"] for r in train]}; '
          f'{seconds:.1f} s for (h2) + (h3) with the ranks\' start',
          flush=True)
    if any(r['losses'] != t['losses'] for r in train):
        failed.append('ranks took different steps')
    if not t['losses'][-1] < t['losses'][0]:
        failed.append(f'loss did not fall: {t["losses"]}')
    if not all(r['grad_agree'] > GRAD_AGREE
               and r['grad_rel'] < SHARD_GRAD_REL for r in train):
        failed.append('first gradient')
    if not all(r['launches'][k] >= 1 for r in train
               for k in RENDER_KERNELS):
        failed.append('a training rank launched no kernel')
    if failed:
        raise AssertionError(f'sharded paths: {failed}')
    return launches, dict(step_ms=shard_med, collective_ms=coll_med,
                          render_ms={s[0]: ranks[0]['render'][s[0]]['ms']
                                     for s in scenes})


def _profiled_ms(fn, kernels, reps):
    """{kernel: ms a launch} of the device kernels whose names hold each of
    ``kernels``, over reps calls of fn after a warm-up (torch.profiler's
    device time: each kernel alone, where fn launches several); None where
    the profiler shows one no time."""
    import torch
    from torch import profiler
    fn()
    torch.cuda.synchronize()
    with profiler.profile(activities=[profiler.ProfilerActivity.CPU,
                                      profiler.ProfilerActivity.CUDA]) as pr:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in pr.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    res = {}
    for kernel in kernels:
        ev = [e for e in dev if kernel in e.key]
        us = sum(getattr(e, 'self_device_time_total', None)
                 or getattr(e, 'self_cuda_time_total', 0) for e in ev)
        n = sum(e.count for e in ev)
        res[kernel] = us * 1e-3 / n if n and us else None
    return res


def _median_ms(fn, reps, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def gated_pairs(aux, cfg):
    """(pixel, face) pairs inside each valid face's bbox + cull margin,
    the pairs both kernels run the pair math on, counted from the packed
    bbox rows: per face, the pixel centres in its x range times those in
    its y range, over the rows of the aux's band."""
    import torch
    from gendr_tpu_torch.raster import cuda_backend as CB
    from gendr_tpu_torch.raster import pack, pairmath as PM
    # the sorted faces alone: compaction's slots repeat them, a tile each
    pk = aux['packed'][:, :, :CB.sorted_face_count(aux)].double()
    m = float(aux['par'][PM.P_MARGIN])
    is_ = cfg.image_size
    # row r has the y centre index is - 1 - r
    ylo, yhi = is_ - aux['row0'] - aux['height'], is_ - 1 - aux['row0']

    def centres(lo, hi, first=0, last=is_ - 1):
        # centre indices c in [first, last] with (2c + 1 - is) / is in
        # [lo - m, hi + m]
        a = torch.ceil(((lo - m) * is_ + is_ - 1) / 2).clamp(first, last + 1)
        b = torch.floor(((hi + m) * is_ + is_ - 1) / 2).clamp(first - 1, last)
        return (b - a + 1).clamp(min=0)
    nx = centres(pk[:, pack.R_BBOX + 0], pk[:, pack.R_BBOX + 1])
    ny = centres(pk[:, pack.R_BBOX + 2], pk[:, pack.R_BBOX + 3], ylo, yhi)
    return float((nx * ny * (pk[:, pack.R_FVALID] > 0)).sum())


def visited_pairs(aux, cfg):
    """What the forward kernel walks on the aux's inputs: (the longest
    tile list in chunks, the pairs a walk of every face of each listed
    chunk visits, the pairs the kernel visits), a pair being a pixel of a
    tile inside the image and the band and a face the tile walks; the
    kernel walks the faces cuda_backend.tile_face_survivors keeps."""
    import torch
    from gendr_tpu_torch.raster import cuda_backend as CB, pairmath as PM
    is_, height = cfg.image_size, aux['height']
    tx = -(-is_ // CB.TILE)
    t = torch.arange(aux['tile_counts'].shape[1], device=aux['par'].device)
    c0, r0 = t % tx * CB.TILE, t // tx * CB.TILE
    pixels = ((torch.clamp(c0 + CB.TILE, max=is_) - c0)
              * (torch.clamp(r0 + CB.TILE, max=height) - r0)).double()
    survivors, _ = CB.tile_face_survivors(
        aux['packed'], cfg, aux['par'][PM.P_MARGIN], aux['row0'], height,
        (aux['tile_counts'], aux['tile_ids']))
    listed = aux['tile_counts'].double() * cfg.face_chunk
    return (int(aux['tile_counts'].max()), float((listed * pixels).sum()),
            float((survivors.double() * pixels).sum()))


def slab_route(aux, cfg, TS):
    """Whether K2 runs compaction's appended chunks through
    rasterize_bwd_slab on this prepass (the C entry's rule: alpha, or hard
    RGB whose texture sums live in registers: vertex colours or one
    texel)."""
    from gendr_tpu_torch import config as C
    from gendr_tpu_torch.raster import cuda_backend as CB
    mode = CB.render_mode(cfg)
    return ('oct_ids' in aux and mode != CB.MODE_SOFTMAX
            and (mode == CB.MODE_ALPHA or TS == 1
                 or cfg.texture_type == C.TEXTURE_VERTEX))


def slab_lanes(aux, cfg):
    """What the launch over compaction's appended chunks (slabs) gives its
    lanes, from the prepass alone: 'blocks' (a block per slab and batch
    element); 'slot_lanes', the lanes with work of a thread per slot (a
    live slot of a slab that lists a tile), of blocks x FC; of a thread per
    pixel of the slab's tile (rasterize_bwd_slab), of blocks x 256:
    'before_cull', the pixels inside the image and the band of blocks with
    a live slot, and 'after_cull', those inside the gate of at least one
    slot (a survivor's); and 'pairs', the slabs' gated (pixel, slot)
    pairs."""
    import torch
    from gendr_tpu_torch.raster import cuda_backend as CB
    from gendr_tpu_torch.raster import pack, pairmath as PM
    FC, is_, height = cfg.face_chunk, cfg.image_size, aux['height']
    Fs, Fp = CB.sorted_face_count(aux), aux['packed'].shape[2]
    B, nslab = aux['packed'].shape[0], (Fp - Fs) // FC
    pk = aux['packed'][:, :, Fs:].reshape(B, -1, nslab, FC)
    listed = aux['chunk_counts'][:, Fs // FC:] > 0           # [B, nslab]
    tile = aux['chunk_ids'][:, Fs // FC:, 0].long()
    valid = (pk[:, pack.R_FVALID] > 0) & listed[..., None]   # [B, nslab, FC]
    tx = -(-is_ // CB.TILE)
    i = torch.arange(CB.TILE, device=tile.device)
    cols = (tile % tx * CB.TILE)[..., None] + i              # [B, nslab, 16]
    rows = (tile // tx * CB.TILE)[..., None] + i             # band-local
    xp = (2.0 * cols.float() + 1.0 - is_) / is_
    yp = (2.0 * (is_ - 1 - (aux['row0'] + rows)).float() + 1.0 - is_) / is_
    m = aux['par'][PM.P_MARGIN]

    def bb(r):
        return pk[:, pack.R_BBOX + r, ..., None]             # [B, nslab, FC, 1]
    gx = ((xp[:, :, None] >= bb(0) - m) & (xp[:, :, None] <= bb(1) + m)
          & (cols < is_)[:, :, None])
    gy = ((yp[:, :, None] >= bb(2) - m) & (yp[:, :, None] <= bb(3) + m)
          & (rows < height)[:, :, None])
    gate = gy[..., :, None] & gx[..., None, :] & valid[..., None, None]
    inside = (rows < height)[..., :, None] & (cols < is_)[..., None, :]
    return dict(blocks=B * nslab, slot_lanes=int(valid.sum()),
                before_cull=int((inside & valid.any(2)[..., None, None])
                                .sum()),
                after_cull=int(gate.any(2).sum()),
                pairs=float(gate.sum()))


def bound(nbytes, flops):
    """(ms, 'bytes' or 'operations'): the least time the card could take,
    the larger of the bytes over HBM bandwidth and the operations over
    the float32 peak."""
    t_bytes = nbytes / H100_HBM_BYTES * 1e3
    t_ops = flops / H100_FP32_FLOPS * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _input_bytes(tensors, packed, cfg, pairs):
    """Bytes a kernel must read of its inputs: each once, except that of a
    surface texture's rows in packed no more than the one texel (12 bytes)
    each gated pair can sample."""
    from gendr_tpu_torch import config as C
    from gendr_tpu_torch.raster import pack
    n = _nbytes(*tensors)
    if cfg.channels != 'alpha' and cfg.texture_type == C.TEXTURE_SURFACE:
        rows = packed[:, pack.R_TEX:]
        n -= max(0, _nbytes(rows) - int(pairs) * 12)
    return n


def time_kernels(smi, name, cfg, params, fv, tex, reps, bwd=True,
                 plain=(3, 1), fvalid=None, row_band=None):
    """Medians of each kernel (CUDA events, reps launches) and of its plain
    version (plain = (calls, warm-up calls)), beside its bound, on the
    faces fvalid marks and the rows of row_band (K1e/K2e; None: all).
    Prints one line; returns {kernel: dict}."""
    import torch
    from gendr_tpu_torch.raster import cuda_backend as CB
    aux = CB.prepass(fv, tex, cfg, params, fvalid, row_band)
    TS = tex.shape[2]
    mode = CB.render_mode(cfg)
    pairs = gated_pairs(aux, cfg)
    band = (aux['row0'], aux['height'])
    args = (aux['tile_counts'], aux['tile_ids'], aux['par'], aux['packed'],
            aux['perm'], cfg, TS, *band)
    # the bound counts the bytes of the function, the sorted faces' columns
    # and the sorted chunks' lists: compaction's slots repeat those faces
    # (the same render with compact='off' gives the same bits), so their
    # columns and the slabs' lists are the implementation's, not the work's
    Fs = CB.sorted_face_count(aux)
    k_sliced = Fs // cfg.face_chunk
    packed_s, perm_s = aux['packed'][..., :Fs], aux['perm'][..., :Fs]
    out = CB.rasterize_fwd(*args)
    fwd_flops, bwd_flops = flops_per_pair(cfg, mode)
    longest, walked, visited = visited_pairs(aux, cfg)
    res = {'rasterize_fwd': dict(
        ms=_median_ms(lambda: CB.rasterize_fwd(*args), reps),
        plain_ms=_median_ms(lambda: CB.rasterize_fwd_plain(*args), *plain),
        bound=bound(_input_bytes((*args[:3], packed_s, perm_s), packed_s,
                                 cfg, pairs)
                    + _nbytes(out), pairs * fwd_flops),
        longest_list=longest, walked_pairs=walked, visited_pairs=visited)}
    if bwd:
        bargs = backward_args(aux, cfg, params, TS, out)
        pix = bargs[5]
        rows = CB.rasterize_bwd(*bargs)
        # the kernel's slices: a block walks at most `longest` tiles of the
        # longest list of a sliced chunk; the workspace holds S slots of
        # the sliced chunks' columns where S > 1
        B, NO, Fp = rows.shape
        nslices = CB.bwd_slice_count(B, NO, Fs, aux['chunk_ids'].shape[2],
                                     compacted=Fs < Fp)
        n_max = int(aux['chunk_counts'][:, :k_sliced].max())
        ws_mib = (nslices > 1) * nslices * B * NO * Fs * 4 / 2**20
        lists = (aux['chunk_counts'][:, :k_sliced],
                 aux['chunk_ids'][:, :k_sliced])
        res['rasterize_bwd'] = dict(
            ms=_median_ms(lambda: CB.rasterize_bwd(*bargs), reps),
            plain_ms=_median_ms(lambda: CB.rasterize_bwd_plain(*bargs),
                                *plain),
            bound=bound(_input_bytes((*lists, aux['par'], packed_s, perm_s,
                                      pix), packed_s, cfg, pairs)
                        + _nbytes(rows[..., :Fs]), pairs * bwd_flops),
            slices=nslices, longest_list=n_max, workspace_mib=ws_mib,
            longest_slice=max(e - s for s, e in CB.bwd_slices(n_max,
                                                              nslices)))
        if slab_route(aux, cfg, TS):
            # rasterize_bwd_slab alone: its device time within K2's calls
            # (the profiler), its plain version on the appended chunks
            # alone (the sorted chunks' counts zeroed), its bound from the
            # slabs' own work: their lists, the pixel columns, the fvalid
            # and bbox rows of every slot and every row of a live one (a
            # dead slot's other rows are never needed), the result's
            # columns, and the gated pairs
            lanes = slab_lanes(aux, cfg)
            counts = aux['chunk_counts'].clone()
            counts[:, :k_sliced] = 0
            sl = (slice(None), slice(k_sliced, None))
            slab_rows = aux['packed'][:, :, Fs:]
            # K2's launches one by one: the sorted chunks' slices, their
            # reduce, the slabs
            parts = _profiled_ms(lambda: CB.rasterize_bwd(*bargs),
                                 ('rasterize_bwd_kernel',
                                  'rasterize_bwd_reduce',
                                  'rasterize_bwd_slab'), reps)
            res['rasterize_bwd']['launch_ms'] = parts
            res['rasterize_bwd_slab'] = dict(
                ms=parts['rasterize_bwd_slab'],
                plain_ms=_median_ms(lambda: CB.rasterize_bwd_plain(
                    counts, *bargs[1:]), *plain),
                bound=bound(_nbytes(aux['chunk_counts'][sl],
                                    aux['chunk_ids'][sl], aux['par'], pix,
                                    rows[..., Fs:])
                            + 5 * 4 * slab_rows[:, 0].numel()
                            + lanes['slot_lanes'] * (slab_rows.shape[1] + 1)
                            * 4, lanes['pairs'] * bwd_flops),
                blocks=lanes['blocks'])
    torch.cuda.empty_cache()
    parts = [f'{k} {r["ms"] if r["ms"] is None else round(r["ms"], 4)} ms,'
             f' plain {r["plain_ms"]:.4f} ms, '
             f'bound {r["bound"][0]:.4f} ms ({r["bound"][1]})'
             + (f', longest tile list {r["longest_list"]} chunks, '
                f'{r["visited_pairs"]:.6g} visited pairs (every face of '
                f'the listed chunks: {r["walked_pairs"]:.6g})'
                if 'visited_pairs' in r else '')
             + (f', S={r["slices"]}, longest slice {r["longest_slice"]} '
                f'of a {r["longest_list"]}-tile list, workspace '
                f'{r["workspace_mib"]:.1f} MiB' if 'slices' in r else '')
             + (', its launches (profiler, ms a launch) '
                + json.dumps(r['launch_ms']) if 'launch_ms' in r else '')
             for k, r in res.items()]
    B = fv.shape[0]
    rows = '' if row_band is None else f' rows {band[0]}+{band[1]}'
    print(f'[timing] {smi}: {name} (B={B}, {cfg.image_size}x'
          f'{cfg.image_size}{rows}, F={fv.shape[1]}, TS={TS}, {pairs:.6g} '
          f'gated pairs, medians of {reps}): ' + '; '.join(parts), flush=True)
    return res


def prepass_cost(smi, obj_file, reps=20):
    """The prepass (sort, pack, hit lists) on path (e)'s inputs at 25, 256
    and 1024 texels per face: its host-clock median, synchronized, and the
    device kernels it launches (torch.profiler; 'not measured' where the
    profiler shows no device activity)."""
    import torch
    from torch import profiler
    from gendr_tpu_torch.raster import cuda_backend as CB
    parts = []
    for res in (5, OBJ_TEXTURE_RES, 32):
        cfg, params, fv, tex = obj_gendr_inputs(obj_file, res)
        times = []
        for i in range(reps + 3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            CB.prepass(fv, tex, cfg, params)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        with profiler.profile(activities=[
                profiler.ProfilerActivity.CPU,
                profiler.ProfilerActivity.CUDA]) as prof:
            CB.prepass(fv, tex, cfg, params)
            torch.cuda.synchronize()
        kernels = sum(e.count for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
        parts.append(f'TS={res * res} {float(np.median(times[3:])):.3f} ms, '
                     f'{kernels or "not measured"} device kernels')
    print(f'[timing] {smi}: prepass on path (e) (B=4, 1280 faces, 512x512), '
          f'host clock, synchronized, median of {reps}: ' + '; '.join(parts),
          flush=True)


def timings(smi, cuda_steps, yager_steps, obj_file, reps=50):
    """Phase 7: medians of CUDA-event timings after warm-up, and host-clock
    frame and step times.  Returns time_kernels' results by shape."""
    import torch
    from gendr_tpu_torch import config as C, render
    from gendr_tpu_torch.animations import panda_dist as PD
    from gendr_tpu_torch.parallel import sharding as S
    fv, tex = flagship_scene('cuda')
    kw = dict(image_size=256, dist_func='uniform', dist_scale=1e-2,
              aggr_alpha_func='probabilistic', aggr_rgb_func='hard')
    t = {}
    for backend in ('cuda', 'torch', 'torch', 'cuda'):
        ms = _median_ms(lambda: render(fv, tex, backend=backend, **kw), reps)
        t.setdefault(backend, []).append(ms)
    print(f'[timing] {smi}: forward render 256x256 1280 faces, median of '
          f'{reps}: backend=cuda {t["cuda"]} ms, backend=torch '
          f'{t["torch"]} ms (order cuda, torch, torch, cuda)', flush=True)

    fvg = fv.clone().requires_grad_(True)

    def fwd_bwd(backend):
        img = render(fvg, tex, backend=backend, **kw)
        loss = 0.5 * (img[:, 3] ** 2).sum() + 0.1 * img[:, :3].sum()
        return torch.autograd.grad(loss, fvg)

    tb = {}
    for backend in ('cuda', 'torch', 'torch', 'cuda'):
        n = reps if backend == 'cuda' else 10
        ms = _median_ms(lambda: fwd_bwd(backend), n)
        tb.setdefault(backend, []).append(ms)
    print(f'[timing] {smi}: forward+backward 256x256 1280 faces: '
          f'backend=cuda {tb["cuda"]} ms (median of {reps}), backend=torch '
          f'{tb["torch"]} ms (median of 10) (order cuda, torch, torch, '
          f'cuda)', flush=True)

    args = PD.parse_args(PANDA_ARGS)
    pfv, ptex = PD.scene(args.texture_res, 'cuda')
    frames = PD.frames(args, pfv, ptex)
    frame_ms = {}
    while True:
        t0 = time.perf_counter()
        try:
            dist_id, _, _ = next(frames)
        except StopIteration:
            break
        torch.cuda.synchronize()
        frame_ms.setdefault(dist_id, []).append(
            1e3 * (time.perf_counter() - t0))
    print(f'[timing] {smi}: panda_dist --quick frames, the render alone '
          f'(host clock, synchronized; 1536x1536, TS=25, anti-aliased), ms '
          f'by distribution in tau order: '
          f'{[[round(x, 3) for x in v] for v in frame_ms.values()]}',
          flush=True)

    params = C.RenderParams(dist_scale=1e-2).as_dict()
    shapes = [('flagship', flagship_cfg(), params, fv, tex),
              ('flagship softmax', flagship_cfg(aggr_rgb_func='softmax'),
               params, fv, tex)]
    # the main paths of the textured slice: a panda_dist frame at full
    # width (forward only; uniform tau 1e-2 and the sweep's densest frame,
    # gaussian tau 1, where every chunk hits every tile), and the default
    # GenDR's forward and backward with surface and vertex textures
    for dist_func, tau in (('uniform', 1e-2), ('gaussian', 1.0)):
        shapes.append((f'panda {dist_func} tau {tau:g}',
                       *panda_inputs('cuda', 1536, dist_func, tau)))
    shapes += list(gendr_inputs())
    # the parametric slice's main paths: a panda_tcn frame at full width,
    # sparse (tau 1e-2) and dense (tau 1), folded by yager p=2 and, beside
    # it, by the probabilistic product; and path (d)'s soft render (B=24,
    # 64x64, alpha only), forward and backward, likewise
    for tau in (1e-2, 1.0):
        for t_conorm, p in (('yager', 2.0), ('probabilistic', 0.0)):
            shapes.append((f'tcn {t_conorm} tau {tau:g}',
                           *tcn_inputs('cuda', 1536, t_conorm, p, tau)))
    for name, extra in (('opt yager', YAGER_ARGS), ('opt probabilistic', ())):
        shapes.append((name, *next(iter(training_inputs(extra=extra)))[1:]))
    # path (i)'s render: B=256 at 64x64, alpha only, forward and backward;
    # and its dataset's (24 views, heaviside CDF, hard alpha, hard RGB)
    shapes += list(reconstruction_inputs())
    # the big-texture slice's main path: the default GenDR on the OBJ's
    # mesh (4 views at 512x512, forward and backward) at 256 and 1024 texels
    # per face and, on the same geometry, at 25; softmax RGB and hard RGB
    # (the K1d question: does hard RGB at 256 texels cost more than at 25?);
    # and a 1536x1536 panda_dist frame of that mesh (uniform tau 1e-2)
    for res in (5, OBJ_TEXTURE_RES, 32):
        for rgb in ('softmax', 'hard'):
            shapes.append((f'obj gendr {rgb} TS={res * res}',
                           *obj_gendr_inputs(obj_file, res,
                                             aggr_rgb_func=rgb)))
    os.environ['GENDR_PANDA_OBJ'] = obj_file
    try:
        for res in (OBJ_TEXTURE_RES, 32):
            for rgb in ('softmax', 'hard'):
                shapes.append((f'obj panda {rgb} TS={res * res}',
                               *panda_inputs('cuda', 1536, 'uniform', 1e-2,
                                             res, aggr_rgb_func=rgb)))
    finally:
        del os.environ['GENDR_PANDA_OBJ']
    kt = {}
    # the sharded slice (K1e/K2e): a 128-row band of the flagship over all
    # faces, its first face half over all rows, and what each rank of path
    # (h2)'s fp=2 x sp=2 split launches: a 128-row band of a 640-face shard
    cfg = flagship_cfg()
    kt['flagship band 128'] = time_kernels(
        smi, 'flagship band 128', cfg, params, fv, tex, reps,
        row_band=(128, 128))
    hfv, htex, _, _ = face_halves(cfg, fv, tex)[0]
    kt['flagship fp half'] = time_kernels(
        smi, 'flagship fp half', cfg, params, hfv, htex, reps)
    for i in range(2):
        sfv, stex, valid, _ = S._face_shard(fv, tex, cfg, 2, i)
        for j in range(2):
            name = f'flagship shard fp{i} sp{j}'
            kt[name] = time_kernels(smi, name, cfg, params, sfv, stex, reps,
                                    fvalid=valid, row_band=(128 * j, 128))
    for name, cfg, params, sfv, stex in shapes:
        panda = name.startswith(('panda', 'tcn', 'obj panda'))
        kt[name] = time_kernels(smi, name, cfg, params, sfv, stex, reps,
                                bwd=not panda,
                                plain=(1, 0) if panda or name.startswith(
                                    ('obj', 'recon'))
                                else (3, 1))
    prepass_cost(smi, obj_file)
    exp, eyes, targets = _shape_experiment('torch')
    torch_steps = exp.run(TRAIN_LR, TRAIN_SIGMA, eyes, targets, 6)['step_s'][1:]
    cuda_med = 1e3 * float(np.median(cuda_steps[1:]))
    torch_med = 1e3 * float(np.median(torch_steps))
    yager_med = 1e3 * float(np.median(yager_steps[1:]))
    print(f'[timing] {smi}: opt_shape step (forward+backward+Adam, 24 views '
          f'64x64, 1280 faces), host clock, synchronized: backend=cuda '
          f'median {cuda_med:.3f} ms of {len(cuda_steps) - 1} '
          f'(probabilistic), {yager_med:.3f} ms of {len(yager_steps) - 1} '
          f'(yager p=2), '
          f'backend=torch median {torch_med:.3f} ms of {len(torch_steps)}',
          flush=True)
    kt['probes'] = time_probes(smi, reps)
    return kt


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this smoke '
              'test needs an NVIDIA GPU', file=sys.stderr)
        return 1
    # imported only now: a copy of this script without the repo fails here
    from gendr_tpu_torch import _build
    from gendr_tpu_torch.raster import cuda_backend as CB

    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f'[device] {smi} | torch {torch.__version__} cuda '
          f'{torch.version.cuda} | {kind}', flush=True)
    if sys.argv[1:] == ['--chain-only']:
        # a quick look at path (j) alone; the full run has no arguments
        _build.build(*_build.SIGNATURES)
        chain_phase(smi)
        capture_must_fail()
        return 0
    if sys.argv[1:] == ['--compact-only']:
        # a quick look at phase 12 alone
        _build.build(*_build.SIGNATURES)
        compaction_phase(smi)
        return 0
    if sys.argv[1:] == ['--torch-texel-only']:
        # a quick look at path (l) alone: it builds no kernel
        torch_texel_phase()
        return 0
    if sys.argv[1:] == ['--camera-only']:
        # a quick look at path (k) alone
        _build.build(*_build.SIGNATURES)
        camera_default_path(smi)
        return 0
    if sys.argv[1:] == ['--prepass-only']:
        # a quick look at phase 14 alone
        _build.build('prepass')
        for line in ptxas_summary(_build.BUILD_LOG['prepass']):
            print(f'[build] prepass: {line}')
        prepass_phase(smi)
        return 0

    t0 = time.perf_counter()
    names = tuple(_build.SIGNATURES)
    _build.build(*names)
    _build.build_native('objparse')
    print(f'[build] {", ".join(names)} and the OBJ tokenizer ready in '
          f'{time.perf_counter() - t0:.2f} s', flush=True)
    for name in names:
        for line in ptxas_summary(_build.BUILD_LOG[name]):
            print(f'[build] {name}: {line}')

    import tempfile
    with tempfile.TemporaryDirectory() as obj_dir:
        t0 = time.perf_counter()
        obj_file = make_obj(obj_dir)
        save_ms = 1e3 * (time.perf_counter() - t0)
        img_err, grad_err = compare_kernels(obj_file)
        band_img_err, band_grad_err = band_phase()
        img_err = max(img_err, band_img_err)
        grad_err = max(grad_err, band_grad_err)
        by_path = dict(render=render_path())
        by_path['training'], cuda_steps = training_path()
        sharded, shard_times = sharded_phase(cuda_steps)
        by_path.update(sharded)
        by_path['panda'], _ = panda_path()
        panda_frame_vs_torch()
        for texture_type, launches in gendr_default_path().items():
            by_path[f'gendr_{texture_type}'] = launches
        torch_texel_phase()
        by_path['tcn'] = tcn_path()
        tcn_frame_vs_torch()
        by_path['training_yager'], yager_steps = training_path(YAGER_ARGS)
        by_path['obj_gendr'], by_path['obj_panda'], load_ms = \
            obj_path(obj_file)
        voxel_ms = voxel_path()
        by_path['camera'], _ = camera_path()
        by_path['reconstruction'], _ = reconstruction_path()
        by_path['reconstruction_dp'] = reconstruction_dp_phase()
        recon_img, recon_grad, recon_ms = reconstruction_phase(cuda_steps)
        img_err = max(img_err, recon_img)
        grad_err = max(grad_err, recon_grad)
        chain_paths, (chain_img, chain_grad), chain_times = chain_phase(smi)
        by_path.update(chain_paths)
        img_err = max(img_err, chain_img)
        grad_err = max(grad_err, chain_grad)
        by_path['compaction'], c_img, c_grad, compact_kt = \
            compaction_phase(smi)
        img_err = max(img_err, c_img)
        grad_err = max(grad_err, c_grad)
        camera_paths, (k_img, k_grad), camera_kt, camera_times = \
            camera_default_path(smi)
        by_path.update(camera_paths)
        img_err = max(img_err, k_img)
        grad_err = max(grad_err, k_grad)
        probe_launches, probe_err = probe_phase()
        prepass_kt, by_path['prepass'] = prepass_phase(smi)
        kt = timings(smi, cuda_steps, yager_steps, obj_file)
        kt.update(compact_kt)
        kt.update(camera_kt)
        kt.update(prepass_kt)
    print(f'[timing] {smi}: host clock: save_obj(texture_res='
          f'{OBJ_TEXTURE_RES}) of 1280 faces x 256 texels {save_ms:.1f} ms; '
          f'load_obj(load_texture=True, texture_res={OBJ_TEXTURE_RES}, '
          f'device=cuda) {load_ms:.1f} ms; voxelization of 1280 faces on the '
          f'card ' + ', '.join(f'{vs}^3 {ms:.2f} ms'
                               for vs, ms in voxel_ms.items()), flush=True)

    if not SLAB_CHECKS:
        raise AssertionError('rasterize_bwd_slab was held against its plain '
                             'version on no input')
    # phase 14 raises on any bit that differs from the plain prepass
    errs = dict(rasterize_fwd=img_err, rasterize_bwd=grad_err,
                rasterize_bwd_slab=max(c['err'] for c in SLAB_CHECKS),
                ulp_elementwise=probe_err, ulp_param_vector=probe_err,
                prepass=0.0)
    sources = dict(rasterize_fwd='rasterize_fwd', rasterize_bwd='rasterize_bwd',
                   rasterize_bwd_slab='rasterize_bwd',
                   ulp_elementwise='ulp_probe', ulp_param_vector='ulp_probe',
                   prepass='prepass')
    replaces = dict(rasterize_fwd='gendr_tpu/raster/pallas_backend.py:254',
                    rasterize_bwd='gendr_tpu/raster/pallas_backend.py:1171',
                    rasterize_bwd_slab='gendr_tpu/raster/pallas_backend.py:'
                    '1171',
                    ulp_elementwise='tools/ulp_check.py:47 and '
                    'tools/ulp_bisect.py:36',
                    ulp_param_vector='tools/ulp_smem.py:37',
                    prepass='no Pallas kernel: the XLA prepass of '
                    'gendr_tpu/raster/pallas_backend.py:1002 (_sorted_faces)'
                    ' and gendr_tpu/raster/pack.py (pack_faces, '
                    'tile_chunk_mask, compact_hits)')
    envelopes = dict(rasterize_fwd='K1a+K1b+K1c+K1d+K1e',
                     rasterize_bwd='K2a+K2b+K2c+K2d+K2e',
                     rasterize_bwd_slab='K2 of compaction\'s appended chunks:'
                     ' alpha, hard RGB over vertex colours or one texel',
                     ulp_elementwise='probe', ulp_param_vector='probe',
                     prepass='the uncompacted prepass of up to '
                     f'{CB.PREPASS_SORT_CAP} padded faces')
    # each kernel's numbers at the shape of the sharded slice's main path:
    # for both render kernels, the flagship's rank of path (h2) that the
    # kernel takes longest on (a 128-row band of a 640-face shard; the
    # step waits for the slowest rank), for the probes the whole probe
    # phase in one launch (ms its device time); the other shapes are in
    # by_shape
    # rasterize_bwd_slab, which no sharded render launches: path (k)'s
    # render at tau 1e-1, where the slab launch takes K2 longest
    ranks = [k for k in kt if k.startswith('flagship shard ')]
    main_shape = dict(ulp_elementwise='probes', ulp_param_vector='probes',
                      rasterize_bwd_slab='opt_camera B=200 tau 0.1',
                      prepass='prepass camera.sharp',
                      **{name: max(ranks, key=lambda k: kt[k][name]['ms'])
                         for name in ('rasterize_fwd', 'rasterize_bwd')})
    by_path['probes'] = probe_launches

    def numbers(r):
        return dict(ms=r['ms'], plain_ms=r['plain_ms'], bound_ms=r['bound'][0],
                    bound_by=r['bound'][1])
    # last: a capture that must fail leaves nothing after it to spoil
    capture_must_fail()
    print(json.dumps({'kernels': [{
        'name': name, 'route': 'cuda',
        'source': f'gendr_tpu_torch/csrc/{sources[name]}.cu',
        'replaces': replaces[name], 'envelope': envelopes[name],
        'launches': sum(p.get(name, 0) for p in by_path.values()),
        'launches_by_path': {k: p[name] for k, p in by_path.items()
                             if name in p},
        'max_abs_err': errs[name], 'shape': main_shape[name],
        **numbers(kt[main_shape[name]][name]), 'library_ms': None,
        'by_shape': {shape: numbers(r[name]) for shape, r in kt.items()
                     if name in r}} for name in sources],
        'sharded_step_ms': shard_times['step_ms'],
        'sharded_collective_ms': shard_times['collective_ms'],
        'reconstruction_step_ms': recon_ms, 'chain': chain_times,
        'camera_default': camera_times}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
