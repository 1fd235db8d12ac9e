"""Single-view 3D reconstruction on ShapeNet (13 classes).

Port of ``experiments/train_reconstruction.py``: a conv encoder and a
template-sphere decoder are trained with a 2-view silhouette IoU loss
through the differentiable renderer, and evaluated by 32^3 voxel IoU
against ground truth.  One step is encoder -> decoder -> lighting ->
look_at -> render [Raa, Rba, Rab, Rbb] -> IoU + Laplacian + flatten ->
Adam, with lr and tau decayed x0.3 at ``--decay-at``.  The training images
live on the device as uint8 and a step gathers its batch by index
(``--host-data`` uploads each batch instead); the losses stay on the
device until a print reads them.  ``--checkpoint-dir`` keeps the last 3
checkpoints (model, BatchNorm statistics, Adam state and the batch
stream's RNG), saved at each evaluation; a restarted run resumes from the
latest and draws the batches the uninterrupted run would have drawn.
``--data-parallel N`` runs N ranks (``parallel.sharding``): each draws the
whole batch, trains on its share, normalises with the whole batch's
BatchNorm moments and averages the gradient over dp, so the parameters
and Adam state stay replicated.

``--chain N`` (default 0: 8 on the card, 1 on the CPU, as the JAX
script's 8 on the accelerator) trains N steps a block, on the N batches
drawn for it (one copy of their image ids to the device), and fetches
their losses once a block; a block never straddles ``--decay-at``, a print
or an evaluation (:func:`block_length`), so checkpoints land on block ends.
On the card the step is captured once as a CUDA graph, gathers its batch
from the device-resident dataset by the ids of a static buffer and is
replayed per step; ``--host-data`` and ``--data-parallel`` run the block as
a loop and say why.

On CUDA tensors the render and its gradient run through the hand-written
kernels (``backend='cuda'``, alpha only); on CPU tensors through the plain
``torch`` backend.  ``main`` turns TF32 off for cuDNN's convolutions and
for matrix products, as the JAX script asks for float32 matmuls: PyTorch
runs convolutions in TF32 on the card unless told not to.

Dataset: the reference's ``mesh_reconstruction.zip`` (an npz per class) is
not in the repository; point ``--dataset-dir`` at a copy, or pass
``--synthetic`` for the procedural stand-in (random deformations of a
sphere in up to 14 families, silhouettes from this package's hard
renderer, voxels from its voxelizer).

Usage (from the repo root):
    python -m gendr_tpu_torch.experiments.train_reconstruction --synthetic
    python -m gendr_tpu_torch.experiments.train_reconstruction --synthetic \\
        --quick --device cpu --image_size 16
"""

from __future__ import annotations

import argparse
import glob
import math
import os
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gendr_tpu_torch import GenDR, Lighting, LookAt, Mesh, data
from gendr_tpu_torch.device import resolve_device, to_device
from gendr_tpu_torch.experiments.common import (StepChain, chain_capture,
                                                iou_loss, make_adam, set_lr)
from gendr_tpu_torch.geometry import core, voxelize
from gendr_tpu_torch.geometry.losses import FlattenLoss, LaplacianLoss
from gendr_tpu_torch.geometry.transforms import get_points_from_angles
from gendr_tpu_torch.parallel import sharding as S
from gendr_tpu_torch.utils import profiling

CLASS_IDS_MAP = {
    '02691156': 'Airplane', '02828884': 'Bench', '02933112': 'Cabinet',
    '02958343': 'Car', '03001627': 'Chair', '03211117': 'Display',
    '03636649': 'Lamp', '03691459': 'Loudspeaker', '04090263': 'Rifle',
    '04256520': 'Sofa', '04379243': 'Table', '04401088': 'Telephone',
    '04530566': 'Watercraft',
}

# tuned default log10(dist_scale) per (distribution x t-conorm)
# (the reference's train_reconstruction.py:556-574)
DISTS_WITH_DEFAULT_SCALE = [
    'uniform', 'gaussian', 'logistic', 'logistic_squares', 'cauchy',
    'cauchy_squares', 'gumbel_min', 'gamma_rev', 'gamma_rev_squares',
    'exponential_rev',
]
TCONORMS_WITH_DEFAULT_SCALE = ['probabilistic_0.0', 'einstein_0.0',
                               'yager_2.0']
DEFAULT_LOG_SCALES = np.array([
    [-1.5, -1.5, -1.5],
    [-1.5, -1.5, -2.0],
    [-2.0, -2.0, -2.0],
    [-4.0, -4.0, -4.0],
    [-3.5, -3.5, -3.0],
    [-4.5, -4.5, -4.0],
    [-2.0, -2.5, -2.0],
    [-2.0, -2.0, -2.0],
    [-4.0, -4.0, -3.5],
    [-2.0, -2.0, -2.0],
], np.float32)

CHECKPOINTS_KEPT = 3
# above this many bytes the training images stay on the host
DEVICE_DATA_MAX_BYTES = 8e9


def default_dist_scale(distribution, squared, t_conorm, t_conorm_p):
    dist = distribution + ('_squares' if squared else '')
    tcn = f'{t_conorm}_{t_conorm_p:.1f}'
    if dist not in DISTS_WITH_DEFAULT_SCALE:
        raise ValueError(f'no default dist_scale for {dist}')
    if tcn not in TCONORMS_WITH_DEFAULT_SCALE:
        raise ValueError(f'no default dist_scale for {tcn}')
    log_scale = DEFAULT_LOG_SCALES[
        DISTS_WITH_DEFAULT_SCALE.index(dist),
        TCONORMS_WITH_DEFAULT_SCALE.index(tcn)]
    return float(10 ** log_scale)


# ---------------------------------------------------------------------------
# Models (the reference's train_reconstruction.py:91-167)
# ---------------------------------------------------------------------------

def _lecun_normal_(weight, fan_in):
    """flax's default kernel initializer: a normal of variance 1 / fan_in,
    truncated at two standard deviations."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std)


def _linear(dim_in, dim_out):
    layer = nn.Linear(dim_in, dim_out)
    _lecun_normal_(layer.weight, dim_in)
    nn.init.zeros_(layer.bias)
    return layer


class BatchNorm(nn.Module):
    """flax.linen.BatchNorm over the channels of NCHW.

    Training normalises with the batch's moments E[x] and E[x^2] - E[x]^2
    (biased, clamped at 0) and moves the running statistics by
    ``momentum`` of those same moments (flax's momentum 0.9 keeps 0.9 of
    the old value: momentum 0.1 here).  ``torch.nn.BatchNorm2d`` would move
    the running variance by the unbiased variance, n / (n - 1) larger.
    With ``data_parallel`` (a sharding mesh and its axis) the moments are
    the whole dp batch's: the per-channel sums are all-reduced over dp in
    the forward and in the backward.
    """

    def __init__(self, channels, momentum=0.1, eps=1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.data_parallel = None
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer('running_mean', torch.zeros(channels))
        self.register_buffer('running_var', torch.ones(channels))

    def forward(self, x):
        if self.training:
            n = x.numel() // x.shape[1]
            sums = torch.stack([x.sum((0, 2, 3)), (x * x).sum((0, 2, 3))])
            if self.data_parallel is not None:
                mesh, axis = self.data_parallel
                sums = S.all_reduce_sum(sums, mesh, axis)
                n *= mesh.size(axis)
            mean = sums[0] / n
            var = torch.clamp(sums[1] / n - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_((1 - m) * self.running_mean
                                        + m * mean)
                self.running_var.copy_((1 - m) * self.running_var + m * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean[None, :, None, None]) * mul[None, :, None, None]
                + self.bias[None, :, None, None])


class Encoder(nn.Module):
    """Three 5x5 stride-2 convolutions with BatchNorm and ReLU, then three
    ReLU linear layers: images [B, 4, H, W] -> features [B, dim_out]."""

    def __init__(self, dim1=64, dim2=1024, dim_out=512, image_size=64,
                 in_channels=4):
        super().__init__()
        widths = (in_channels, dim1, dim1 * 2, dim1 * 4)
        self.convs = nn.ModuleList()
        self.bns = nn.ModuleList()
        size = image_size
        for c_in, c_out in zip(widths[:-1], widths[1:]):
            conv = nn.Conv2d(c_in, c_out, 5, stride=2, padding=2)
            _lecun_normal_(conv.weight, c_in * 25)
            nn.init.zeros_(conv.bias)
            self.convs.append(conv)
            self.bns.append(BatchNorm(c_out))
            size = (size - 1) // 2 + 1
        self.fcs = nn.ModuleList([_linear(widths[-1] * size * size, dim2),
                                  _linear(dim2, dim2),
                                  _linear(dim2, dim_out)])

    def set_data_parallel(self, mesh, axis='dp'):
        """Normalise with the moments of the whole batch over ``axis``."""
        for bn in self.bns:
            bn.data_parallel = (mesh, axis)

    def forward(self, x):
        for conv, bn in zip(self.convs, self.bns):
            x = F.relu(bn(conv(x)))
        # NCHW flatten; the first layer's rows are in (c, h, w) order
        # (interop.reconstruction_params_from_jax permutes flax's (h, w, c))
        x = x.reshape(x.shape[0], -1)
        for fc in self.fcs:
            x = F.relu(fc(x))
        return x


class Decoder(nn.Module):
    """Template-sphere deformation head (NMR-style; the reference's
    train_reconstruction.py:119-167).

    An MLP predicts a per-vertex displacement in logit space plus a global
    centroid shift; the template's coordinates are mapped axis-wise to
    logits, displaced, and squashed back through a sigmoid, so the deformed
    mesh can never leave the unit volume.  A template coordinate of exactly
    0 has the logit -inf: its vertex stays at 0 on that axis, with a zero
    gradient.
    """

    def __init__(self, vertices_base, dim_in=512, width=1024,
                 centroid_scale=0.1, bias_scale=1.0):
        super().__init__()
        template = torch.as_tensor(np.asarray(vertices_base, np.float32)) \
            * 0.5
        self.nv = template.shape[0]
        self.centroid_scale = centroid_scale
        self.bias_scale = bias_scale
        t_abs = template.abs()
        self.register_buffer('axis_sign', torch.sign(template),
                             persistent=False)
        self.register_buffer('logits', torch.log(t_abs / (1.0 - t_abs)),
                             persistent=False)
        self.fc1 = _linear(dim_in, width)
        self.fc2 = _linear(width, width * 2)
        self.fc_centroid = _linear(width * 2, 3)
        self.fc_displace = _linear(width * 2, self.nv * 3)

    def forward(self, features):
        h = F.relu(self.fc1(features))
        h = F.relu(self.fc2(h))
        centroid = torch.tanh(
            self.fc_centroid(h) * self.centroid_scale)[:, None, :]
        displace = (self.fc_displace(h)
                    * self.bias_scale).reshape(-1, self.nv, 3)
        deformed = torch.sigmoid(self.logits + displace) * self.axis_sign
        # squeeze each half-space toward the shifted centroid so the
        # translation cannot push vertices out of [-1, 1]
        deformed = (F.relu(deformed) * (1.0 - centroid)
                    - F.relu(-deformed) * (1.0 + centroid))
        return (deformed + centroid) * 0.5


# ---------------------------------------------------------------------------
# Datasets
# ---------------------------------------------------------------------------

def _eyes(distance, elevation, viewpoints):
    """Eyes [B, 3] (numpy) of the dataset's cameras at viewpoint ids."""
    n = viewpoints.shape[0]
    return get_points_from_angles(
        torch.from_numpy(np.full(n, distance, np.float32)),
        torch.from_numpy(np.full(n, elevation, np.float32)),
        torch.from_numpy(-viewpoints * 15)).numpy()


class ShapeNet:
    """npz-per-class dataset (the reference's train_reconstruction.py:
    271-358): ``{class_id}_{set_name}_images.npz`` ([objects, 24, 4, 64,
    64] uint8) and ``..._voxels.npz`` ([objects, 32, 32, 32]) under
    ``root/mesh_reconstruction``."""

    def __init__(self, root, class_ids, set_name):
        self.class_ids = class_ids
        self.set_name = set_name
        self.elevation = 30.0
        self.distance = 2.732
        images, voxels = [], []
        self.num_data = {}
        self.pos = {}
        count = 0
        for class_id in class_ids:
            with np.load(os.path.join(
                    root, 'mesh_reconstruction',
                    f'{class_id}_{set_name}_images.npz')) as im:
                images.append(im[im.files[0]])
            with np.load(os.path.join(
                    root, 'mesh_reconstruction',
                    f'{class_id}_{set_name}_voxels.npz')) as vx:
                voxels.append(vx[vx.files[0]])
            self.num_data[class_id] = images[-1].shape[0]
            self.pos[class_id] = count
            count += self.num_data[class_id]
        self.images = np.ascontiguousarray(
            np.concatenate(images, 0).reshape((-1, 4, 64, 64)))
        self.voxels = np.ascontiguousarray(np.concatenate(voxels, 0))

    @property
    def class_ids_pair(self):
        return zip(self.class_ids,
                   [CLASS_IDS_MAP[i] for i in self.class_ids])

    def _draw(self, rng, batch_size):
        """Image ids and viewpoints of a batch: the JAX script's draws from
        rng, call for call, so a seed gives the same batches."""
        with profiling.span('data.draw'):
            return self._draw_ids(rng, batch_size)

    def _draw_ids(self, rng, batch_size):
        data_ids_a = np.zeros(batch_size, 'int32')
        data_ids_b = np.zeros(batch_size, 'int32')
        vp_a = np.zeros(batch_size, np.float32)
        vp_b = np.zeros(batch_size, np.float32)
        for i in range(batch_size):
            class_id = rng.choice(self.class_ids)
            object_id = rng.randint(0, self.num_data[class_id])
            va = rng.randint(0, 24)
            vb = rng.randint(0, 24)
            data_ids_a[i] = (object_id + self.pos[class_id]) * 24 + va
            data_ids_b[i] = (object_id + self.pos[class_id]) * 24 + vb
            vp_a[i] = va
            vp_b[i] = vb
        return (data_ids_a, data_ids_b,
                _eyes(self.distance, self.elevation, vp_a),
                _eyes(self.distance, self.elevation, vp_b))

    def get_random_batch(self, rng, batch_size):
        """(images_a, images_b [B, 4, H, W] float32 in [0, 1], eyes_a,
        eyes_b [B, 3]) as numpy."""
        data_ids_a, data_ids_b, eyes_a, eyes_b = self._draw(rng, batch_size)
        images_a = self.images[data_ids_a].astype(np.float32) / 255.
        images_b = self.images[data_ids_b].astype(np.float32) / 255.
        return images_a, images_b, eyes_a, eyes_b

    def get_random_batch_ids(self, rng, batch_size):
        """The same draws as get_random_batch, as int32 image ids into
        ``images`` (for a device-resident copy) and eyes."""
        return self._draw(rng, batch_size)

    def get_all_batches_for_evaluation(self, batch_size, class_id):
        data_ids = np.arange(self.num_data[class_id]) + self.pos[class_id]
        viewpoint_ids = np.tile(np.arange(24), data_ids.size)
        data_ids = np.repeat(data_ids, 24) * 24 + viewpoint_ids
        for i in range((data_ids.size - 1) // batch_size + 1):
            ids = data_ids[i * batch_size:(i + 1) * batch_size]
            images = self.images[ids].astype(np.float32) / 255.
            voxels = self.voxels[ids // 24].astype(np.float32)
            yield images, voxels


def _synthetic_shape(rng, family, v):
    """One random mesh of a synthetic class family (unit icosphere v)."""
    scale = 0.25 + rng.rand(3) * 0.2
    if family == 'syn_ellipsoid' or family == 'synthetic':
        return (v * scale[None, :]).astype(np.float32)
    if family == 'syn_box':
        # superquadric: pushes the sphere toward a rounded box
        p = 0.45 + rng.rand() * 0.2
        return (np.sign(v) * np.abs(v) ** p * scale[None, :] * 0.85) \
            .astype(np.float32)
    if family == 'syn_peanut':
        # two-lobe pinch along x
        pinch = 0.45 + rng.rand() * 0.25
        r = 1.0 - pinch * np.exp(-(v[:, 0] / 0.35) ** 2)
        out = v * scale[None, :]
        out[:, 1] *= r
        out[:, 2] *= r
        return out.astype(np.float32)
    # the 10 families that bring the synthetic benchmark to the reference's
    # 13-class scale: procedural stand-ins, each with its own silhouette
    # statistic, not ShapeNet data
    if family == 'syn_disk':
        # flattened ellipsoid (display/table-top-like aspect)
        out = v * scale[None, :]
        out[:, 1] *= 0.25 + rng.rand() * 0.15
        return out.astype(np.float32)
    if family == 'syn_pear':
        # linear taper along y (lamp-shade-like)
        t = 0.35 + rng.rand() * 0.25
        r = 1.0 - t * (v[:, 1] + 1.0) * 0.5
        out = v * scale[None, :]
        out[:, 0] *= r
        out[:, 2] *= r
        return out.astype(np.float32)
    if family == 'syn_star':
        # radial lobes around the y axis
        k = rng.choice([3, 4, 5])
        a = 0.18 + rng.rand() * 0.12
        theta = np.arctan2(v[:, 2], v[:, 0])
        r = 1.0 + a * np.cos(k * theta) * (1.0 - v[:, 1] ** 2)
        out = v * scale[None, :]
        out[:, 0] *= r
        out[:, 2] *= r
        return out.astype(np.float32)
    if family == 'syn_bump':
        # one gaussian protrusion at a random surface direction
        d = rng.randn(3)
        d /= np.linalg.norm(d)
        a = 0.5 + rng.rand() * 0.3
        r = 1.0 + a * np.exp(-((1.0 - v @ d) / 0.3) ** 2)
        return (v * r[:, None] * scale[None, :] * 0.8).astype(np.float32)
    if family == 'syn_dumbbell':
        # deep asymmetric two-lobe pinch
        pinch = 0.62 + rng.rand() * 0.18
        c = rng.rand() * 0.3 - 0.15
        r = 1.0 - pinch * np.exp(-((v[:, 0] - c) / 0.3) ** 2)
        out = v * scale[None, :]
        out[:, 1] *= r
        out[:, 2] *= r
        return out.astype(np.float32)
    if family == 'syn_cone':
        # taper to a near-point at +y
        t = 0.75 + rng.rand() * 0.2
        r = 1.0 - t * np.clip(v[:, 1], 0.0, 1.0)
        out = v * scale[None, :]
        out[:, 0] *= r
        out[:, 2] *= r
        return out.astype(np.float32)
    if family == 'syn_capsule':
        # stretched midsection with spherical caps
        s = 0.8 + rng.rand() * 0.6
        out = v * scale[None, :]
        out[:, 0] = np.where(np.abs(v[:, 0]) < 0.5, v[:, 0] * (1 + s),
                             np.sign(v[:, 0]) * (np.abs(v[:, 0]) + 0.5 * s))
        out[:, 0] *= scale[0] * 0.7
        return out.astype(np.float32)
    if family == 'syn_egg':
        # asymmetric ellipsoid: one end fatter
        a = 0.25 + rng.rand() * 0.2
        r = 1.0 + a * v[:, 1]
        out = v * scale[None, :]
        out[:, 0] *= r
        out[:, 2] *= r
        return out.astype(np.float32)
    if family == 'syn_twist':
        # rotation around y proportional to height
        a = (0.6 + rng.rand() * 0.8) * np.pi / 2
        ang = a * v[:, 1]
        c, s = np.cos(ang), np.sin(ang)
        out = v * (scale * np.array([1.0, 1.0, 0.55]))[None, :]
        x, z = out[:, 0].copy(), out[:, 2].copy()
        out[:, 0] = c * x - s * z
        out[:, 2] = s * x + c * z
        return out.astype(np.float32)
    if family == 'syn_wave':
        # sinusoidal radial ripple along y
        k = 2 + rng.randint(3)
        a = 0.12 + rng.rand() * 0.1
        r = 1.0 + a * np.sin(np.pi * k * v[:, 1])
        out = v * scale[None, :]
        out[:, 0] *= r
        out[:, 2] *= r
        return out.astype(np.float32)
    raise ValueError(family)


class SyntheticShapeNet(ShapeNet):
    """Procedural stand-in for ShapeNet through the same pipeline: random
    meshes of the given families, 24 silhouettes of each from this
    package's hard renderer (heaviside CDF, hard alpha) in one render
    call, ground-truth voxels from its voxelizer at 32^3, both on
    ``device`` (None: the card).  With several classes the multi-class
    evaluation (per-class IoU and their mean) runs as on ShapeNet."""

    def __init__(self, n_objects=32, image_size=64, seed=0,
                 class_ids=('synthetic',), device=None):
        rng = np.random.RandomState(seed)
        self.class_ids = list(class_ids)
        self.elevation = 30.0
        self.distance = 2.732
        self.num_data = {c: n_objects for c in self.class_ids}
        self.pos = {c: i * n_objects
                    for i, c in enumerate(self.class_ids)}
        v, f = data.icosphere(2)
        renderer = GenDR(
            image_size=image_size, dist_func=0, dist_scale=1e-4,
            dist_squared=True, dist_eps=1, aggr_alpha_func=0,
            aggr_rgb_func='hard')
        dev = resolve_device(device)
        faces = torch.as_tensor(f, device=dev)[None]
        lighting = Lighting().to(dev)
        transform = LookAt(viewing_angle=15).to(dev)
        transform.set_eyes(_eyes(self.distance, self.elevation,
                                 np.arange(24, dtype=np.float32)))

        images = []
        voxels = []
        with torch.no_grad():
            for class_id in self.class_ids:
                for _ in range(n_objects):
                    verts = torch.as_tensor(
                        _synthetic_shape(rng, class_id, v), device=dev)
                    # one render of the 24 views, then the voxel grid
                    mesh = Mesh.create(verts[None].repeat(24, 1, 1),
                                       faces.repeat(24, 1, 1))
                    sil = renderer(transform(lighting(mesh)))[:, 3]
                    fv = core.face_vertices(verts[None], faces)
                    vox = voxelize.voxelization(
                        fv * 1.0 * (32 - 1) / 32 + 0.5, 32, False)[0]
                    sil = sil.cpu().numpy()
                    rgba = np.zeros((24, 4, sil.shape[1], sil.shape[2]),
                                    np.float32)
                    rgba[:, :3] = sil[:, None]
                    rgba[:, 3] = sil
                    images.append((rgba * 255).astype(np.uint8))
                    voxels.append(
                        vox.permute(1, 0, 2).flip(2).cpu().numpy())
        self.images = np.concatenate(images, 0).reshape(-1, 4, image_size,
                                                        image_size)
        self.voxels = np.stack(voxels, 0).astype(np.float32)


CLASS_IDS_MAP['synthetic'] = 'Synthetic'
CLASS_IDS_MAP['syn_ellipsoid'] = 'SynEllipsoid'
CLASS_IDS_MAP['syn_box'] = 'SynBox'
CLASS_IDS_MAP['syn_peanut'] = 'SynPeanut'
CLASS_IDS_MAP['syn_disk'] = 'SynDisk'
CLASS_IDS_MAP['syn_pear'] = 'SynPear'
CLASS_IDS_MAP['syn_star'] = 'SynStar'
CLASS_IDS_MAP['syn_bump'] = 'SynBump'
CLASS_IDS_MAP['syn_dumbbell'] = 'SynDumbbell'
CLASS_IDS_MAP['syn_cone'] = 'SynCone'
CLASS_IDS_MAP['syn_capsule'] = 'SynCapsule'
CLASS_IDS_MAP['syn_egg'] = 'SynEgg'
CLASS_IDS_MAP['syn_twist'] = 'SynTwist'
CLASS_IDS_MAP['syn_wave'] = 'SynWave'
SYNTHETIC_CLASSES = ('syn_ellipsoid', 'syn_box', 'syn_peanut')
# the 13-class synthetic benchmark mirroring the reference's 13 ShapeNet
# classes (the reference's train_reconstruction.py:254-268)
SYNTHETIC_CLASSES_13 = SYNTHETIC_CLASSES + (
    'syn_disk', 'syn_pear', 'syn_star', 'syn_bump', 'syn_dumbbell',
    'syn_cone', 'syn_capsule', 'syn_egg', 'syn_twist', 'syn_wave')


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

class Reconstruction:
    """The model, the renderer and the losses of one run, and its steps
    (the JAX script's closures of main()).  encoder, decoder: the modules
    (on ``device``); faces: the template's [nf, 3]; mesh: a sharding mesh
    whose 'dp' axis splits the batch, or None."""

    def __init__(self, args, encoder, decoder, faces, device, mesh=None):
        self.args = args
        self.device = torch.device(device)
        self.encoder = encoder.to(self.device)
        self.decoder = decoder.to(self.device)
        self.mesh = mesh
        if mesh is not None:
            self.encoder.set_data_parallel(mesh, 'dp')
        faces = np.asarray(faces)
        self.faces = torch.as_tensor(faces, device=self.device)
        # the template's faces are fixed: their table of fixed-order sums
        self.incidence = core.incidence(self.faces, decoder.nv)
        self.laplacian = LaplacianLoss(np.zeros((decoder.nv, 3)), faces) \
            .to(self.device)
        self.flatten = FlattenLoss(faces).to(self.device)
        self.lighting = Lighting().to(self.device)
        self.transform = LookAt(viewing_angle=15).to(self.device)
        self.renderer = GenDR(
            image_size=args.image_size, dist_func=args.distribution,
            dist_scale=1.0, dist_squared=args.squared,
            dist_shape=args.dist_shape, dist_shift=args.dist_shift,
            dist_eps=args.dist_eps, aggr_alpha_func=args.t_conorm,
            aggr_alpha_t_conorm_p=args.t_conorm_p, aggr_rgb_func='hard',
            backend=args.backend, channels='alpha')
        # the renderer's parameter vector, a static buffer a chained block
        # writes its rows into
        self.par = to_device(self.renderer.params_vector(), self.device)

    def parameters(self):
        return [*self.encoder.parameters(), *self.decoder.parameters()]

    def parameter_names(self):
        """'encoder.<name>' / 'decoder.<name>' of parameters(), in order
        (the optimizer state's order)."""
        return [f'{part}.{name}' for part, module in
                (('encoder', self.encoder), ('decoder', self.decoder))
                for name, _ in module.named_parameters()]

    def reconstruct(self, images, train):
        self.encoder.train(train)
        features = profiling.grad_mark(self.encoder(images), 'encoder.bwd')
        profiling.mark('decoder')
        return profiling.grad_mark(self.decoder(features), 'decoder.bwd')

    def silhouette_mesh(self, vertices, eyes):
        """The lit mesh of vertices [B, nv, 3] seen from eyes [B, 3]."""
        B = vertices.shape[0]
        mesh = self.lighting(Mesh.create(vertices,
                                         self.faces[None].expand(B, -1, -1),
                                         incidence=self.incidence))
        self.transform.set_eyes(eyes)
        return self.transform(mesh)

    def set_dist_scale(self, dist_scale):
        """Write the renderer's vector at dist_scale into ``par``."""
        self.par.copy_(to_device(self.renderer.params_vector(
            dist_scale=dist_scale), self.device))

    def loss_fn(self, images_a, images_b, eyes_a, eyes_b, dist_scale=None):
        """2-view cross-consistency loss (the reference's
        train_reconstruction.py:211-231, 41-46): render [Raa, Rba, Rab,
        Rbb] and compare with the two target views.  dist_scale (a number)
        is written into ``par`` first; None renders with ``par`` as it
        is."""
        if dist_scale is not None:
            self.set_dist_scale(dist_scale)
        args = self.args
        images = torch.cat([images_a, images_b], 0)
        vertices = self.reconstruct(images, True)
        profiling.mark('geometry')
        lap = self.laplacian(vertices).mean()
        flat = self.flatten(vertices).mean()
        eyes = torch.cat([eyes_a, eyes_a, eyes_b, eyes_b], 0)
        sils = self.renderer(self.silhouette_mesh(
            torch.cat([vertices, vertices], 0), eyes), par=self.par)[:, 3]
        profiling.mark('loss')
        raa, rba, rab, rbb = sils.chunk(4)
        ta, tb = images_a[:, 3], images_b[:, 3]
        sil_loss = (iou_loss(raa, ta) + iou_loss(rba, ta)
                    + iou_loss(rab, tb) + iou_loss(rbb, tb)) / 4
        return sil_loss + args.lambda_laplacian * lap \
            + args.lambda_flatten * flat

    def train_step(self, opt, images_a, images_b, eyes_a, eyes_b,
                   dist_scale=None, lr_scale=1.0):
        """One Adam step at lr x lr_scale; see step."""
        set_lr(opt, self.args.learning_rate * lr_scale)
        return self.step(opt, images_a, images_b, eyes_a, eyes_b,
                         dist_scale)

    def step(self, opt, images_a, images_b, eyes_a, eyes_b,
             dist_scale=None):
        """One Adam step at the optimizer's lr on this rank's share of the
        batch, the gradient averaged over dp; returns (the batch's loss,
        every gradient finite), both 0-d tensors on the device."""
        profiling.mark('encoder')
        opt.zero_grad(set_to_none=True)
        loss = self.loss_fn(images_a, images_b, eyes_a, eyes_b, dist_scale)
        profiling.mark('loss.bwd')
        loss.backward()
        params = self.parameters()
        if self.mesh is not None:
            loss = S.average_gradients(params, loss, self.mesh, 'dp')
        profiling.mark('finite')
        finite = torch.stack([torch.isfinite(p.grad).all()
                              for p in params]).all()
        profiling.mark('adam')
        opt.step()
        return loss.detach(), finite

    @torch.no_grad()
    def predict_voxels(self, images):
        """The reference's evaluate_iou voxel pipeline
        (train_reconstruction.py:233-241): [B, 32, 32, 32]."""
        vertices = self.reconstruct(images, False)
        B = vertices.shape[0]
        fv = core.face_vertices(vertices, self.faces[None].expand(B, -1, -1))
        fv = fv * 1.0 * (32. - 1) / 32. + 0.5
        vox = voxelize.voxelization(fv, 32, False)
        return vox.permute(0, 2, 1, 3).flip(3)

    def evaluate(self, dataset, label, log=print):
        """Voxel IoU per class and its mean over classes, in percent."""
        args = self.args
        iou_all = []
        for class_id, class_name in dataset.class_ids_pair:
            total, count = 0.0, 0
            for bi, (im, vx) in enumerate(
                    dataset.get_all_batches_for_evaluation(
                        args.batch_size, class_id)):
                if args.max_eval_batches and bi >= args.max_eval_batches:
                    break
                pred = self.predict_voxels(
                    torch.from_numpy(im).to(self.device))
                vx = torch.from_numpy(vx).to(self.device)
                inter = (vx * pred).sum((1, 2, 3))
                union = ((vx + pred) > 0).sum((1, 2, 3))
                total += float((inter / union.clamp(min=1)).sum())
                count += im.shape[0]
            iou_cls = total / count * 100
            iou_all.append(iou_cls)
            log(f'Mean {label} IoU: {iou_cls:.3f} for class {class_name}')
        mean_iou = sum(iou_all) / len(iou_all)
        log(f'Mean {label} IoU: {mean_iou:.3f} for all classes')
        return mean_iou


def build_experiment(args, device, mesh=None):
    """The full-width model of the JAX script (Encoder 64 / 1024 / 512,
    Decoder 1024 wide on the 642-vertex template, 1280 faces), made on the
    CPU from ``args.seed`` so every rank starts from the same weights."""
    v, f = data.sphere(642)
    torch.manual_seed(args.seed)
    encoder = Encoder(image_size=args.image_size)
    decoder = Decoder(v)
    return Reconstruction(args, encoder, decoder, f, device, mesh)


def make_datasets(args, device):
    """(training set, validation set) of the run."""
    if args.synthetic:
        n_obj = args.synthetic_objects or (4 if args.quick else 64)
        ids = args.class_ids.split(',')
        syn_ids = [c for c in ids if c.startswith('syn')] or ['synthetic']
        train = SyntheticShapeNet(n_obj, args.image_size, args.seed,
                                  class_ids=syn_ids, device=device)
        return train, train
    class_ids = args.class_ids.split(',')
    return (ShapeNet(args.dataset_dir, class_ids, 'train'),
            ShapeNet(args.dataset_dir, class_ids, 'val'))


def _rng_state(np_rng):
    name, keys, pos, has_gauss, gauss = np_rng.get_state()
    if name != 'MT19937':
        raise ValueError(f'unexpected numpy RNG {name}')
    return dict(keys=torch.from_numpy(keys.astype(np.int64)), pos=int(pos),
                has_gauss=int(has_gauss), gauss=float(gauss))


def _set_rng_state(np_rng, state):
    np_rng.set_state(('MT19937', state['keys'].numpy().astype(np.uint32),
                      state['pos'], state['has_gauss'], state['gauss']))


def _checkpoints(directory):
    """The checkpoint files of ``directory``, oldest first."""
    return sorted(glob.glob(os.path.join(directory, 'ckpt_*.pt')))


def save_checkpoint(directory, iteration, exp, opt, np_rng):
    """The training state after ``iteration`` steps: model, BatchNorm
    statistics, Adam state and the batch stream's RNG; keeps the last
    CHECKPOINTS_KEPT."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f'ckpt_{iteration:09d}.pt')
    torch.save(dict(iteration=iteration,
                    encoder=exp.encoder.state_dict(),
                    decoder=exp.decoder.state_dict(),
                    optimizer=opt.state_dict(),
                    rng=_rng_state(np_rng)), path + '.tmp')
    os.replace(path + '.tmp', path)
    for old in _checkpoints(directory)[:-CHECKPOINTS_KEPT]:
        os.remove(old)


def restore_checkpoint(directory, exp, opt, np_rng):
    """Load the latest checkpoint of ``directory``, if any, into the
    model, the optimizer and the RNG; returns its iteration (0: none)."""
    paths = _checkpoints(directory) if directory else []
    if not paths:
        return 0
    # loaded on the CPU: load_state_dict copies onto the parameters' device
    state = torch.load(paths[-1], map_location='cpu', weights_only=True)
    exp.encoder.load_state_dict(state['encoder'])
    exp.decoder.load_state_dict(state['decoder'])
    # the groups keep their lr (on the card a tensor a captured step
    # reads), which the run sets before every block
    lrs = [group['lr'] for group in opt.param_groups]
    opt.load_state_dict(state['optimizer'])
    for group, lr in zip(opt.param_groups, lrs):
        group['lr'] = lr
    _set_rng_state(np_rng, state['rng'])
    return state['iteration']


def block_length(i, chain, num_iterations, decay_at, print_freq,
                 eval_freq):
    """Steps of the block that starts at iteration i: at most chain, none
    past num_iterations, and never across the decay at decay_at, a print
    (every print_freq) or an evaluation (every eval_freq), which fire at
    the block's last step (the JAX script's rule,
    experiments/train_reconstruction.py:771-779)."""
    n = min(chain, num_iterations - i + 1)
    if i < decay_at < i + n:
        n = decay_at - i
    nxt_print = ((i - 1) // print_freq + 1) * print_freq
    nxt_eval = ((i - 1) // eval_freq + 1) * eval_freq
    return max(1, min(n, nxt_print - i + 1, nxt_eval - i + 1))


def chain_length(args, device):
    """--chain, where 0 means 8 on the card and 1 elsewhere."""
    return args.chain or (8 if torch.device(device).type == 'cuda' else 1)


def train(args, device, mesh=None):
    """The run of ``main`` in one process (one rank of ``mesh``'s dp axis,
    or the only one): returns {'mean_iou', 'final_loss', 'losses' (every
    step's, as floats), 'grads_finite', 'steps' (the StepChain)}.  Rank 0
    alone prints, evaluates and saves checkpoints."""
    lead = mesh is None or mesh.index('dp') == 0
    log = print if lead else (lambda *a, **k: None)
    dataset_train, dataset_val = make_datasets(args, device)
    exp = build_experiment(args, device, mesh)
    opt = make_adam(exp.parameters(), args.learning_rate)
    # the batch stream's RNG is part of the training state: a resumed run
    # must draw the batches it would have drawn uninterrupted
    np_rng = np.random.RandomState(args.seed)
    start_iter = restore_checkpoint(args.checkpoint_dir, exp, opt,
                                    np_rng) + 1
    if start_iter > 1:
        log(f'Restored checkpoint at iteration {start_iter - 1}; '
            f'resuming from {start_iter}.')

    # the training images stay on the device as uint8; a step gathers its
    # batch by index and normalises it there
    dev_images = None
    if not args.host_data:
        gb = dataset_train.images.nbytes / 1e9
        if dataset_train.images.nbytes <= DEVICE_DATA_MAX_BYTES:
            dev_images = torch.from_numpy(dataset_train.images).to(
                exp.device)
            log(f'device-resident dataset: {gb:.2f} GB uint8')
        else:
            log(f'dataset {gb:.2f} GB > 8 GB; streaming batches from host '
                f'(use --host-data to silence)')
    if mesh is not None:
        log(f'data-parallel over {mesh.size("dp")} ranks')

    # a step's inputs: the batch's image ids into the device-resident
    # dataset (or its images), its eyes and the renderer's vector
    B, size = args.batch_size, args.image_size
    inputs = dict(eyes=torch.zeros((2, B, 3), device=exp.device),
                  par=exp.par)
    if dev_images is not None:
        inputs['ids'] = torch.zeros((2, B), dtype=torch.long,
                                    device=exp.device)
    else:
        inputs['images'] = torch.zeros((2, B, 4, size, size),
                                       device=exp.device)

    def step():
        if dev_images is not None:
            ids = inputs['ids']
            if mesh is not None:
                ids = S.shard_batch(ids.T, mesh, 'dp').T
            images = dev_images[ids].float() / 255.
        else:
            images = inputs['images']
            if mesh is not None:
                images = S.shard_batch(images.transpose(0, 1), mesh,
                                       'dp').transpose(0, 1)
        eyes = inputs['eyes']
        if mesh is not None:
            eyes = S.shard_batch(eyes.transpose(0, 1), mesh,
                                 'dp').transpose(0, 1)
        loss, ok = exp.step(opt, images[0], images[1], eyes[0], eyes[1])
        return torch.stack([loss, ok.to(loss.dtype)])

    chain = chain_length(args, exp.device)
    reason = ('--data-parallel: its collectives (BatchNorm\'s moments, the '
              'gradient all-reduce) run through torch.distributed'
              if mesh is not None else
              '--host-data: each block\'s image batches come from host '
              'memory' if dev_images is None else None)
    steps = StepChain(step, inputs, chain_capture(exp.device, chain, reason),
                      state=[*exp.parameters(), *exp.encoder.buffers()],
                      optimizer=opt)
    draw = (dataset_train.get_random_batch_ids if dev_images is not None
            else dataset_train.get_random_batch)

    losses = []
    finite = True
    t0 = time.time()
    i = start_iter
    while i <= args.num_iterations:
        # lr and dist_scale decay at the boundary (the reference: 150k of
        # 250k, train_reconstruction.py:70-84)
        decayed = i >= args.decay_at
        lr_scale = 0.3 if decayed else 1.0
        dist_scale = args.dist_scale * (0.3 if decayed else 1.0)
        n = block_length(i, chain, args.num_iterations, args.decay_at,
                         args.print_freq, args.eval_freq)
        batches = [draw(np_rng, B) for _ in range(n)]
        xs = dict(eyes=np.stack([np.stack(b[2:]) for b in batches]),
                  par=exp.renderer.params_vector(
                      dist_scale=dist_scale).repeat(n, 1))
        if dev_images is not None:
            xs['ids'] = np.stack([np.stack(b[:2]) for b in batches]
                                 ).astype(np.int64)
        else:
            xs['images'] = np.stack([np.stack(b[:2]) for b in batches])
        set_lr(opt, args.learning_rate * lr_scale)
        res = steps.run(xs)
        losses += res[:, 0].tolist()
        finite &= bool(res[:, 1].all())
        i_last = i + n - 1

        if i_last % args.print_freq == 0:
            dt = time.time() - t0
            recent = losses[-args.print_freq:]
            log(f'Iter: [{i_last}/{args.num_iterations}]\t'
                f'Loss {np.mean(recent):.4f}\t'
                f'lr {args.learning_rate * lr_scale:.6f}\t'
                f'sv {dist_scale:.6f}\t'
                f'({(i_last - start_iter + 1) / dt:.2f} it/s)')
        if i_last % args.eval_freq == 0 and lead:
            exp.evaluate(dataset_val, 'Valid', log)
            if args.checkpoint_dir:
                save_checkpoint(args.checkpoint_dir, i_last, exp, opt,
                                np_rng)
        i += n

    mean_iou = exp.evaluate(dataset_val, 'Final', log) if lead else None
    # a restored run past num_iterations trains zero steps
    final_loss = float(np.mean(losses[-10:])) if losses else float('nan')
    return dict(mean_iou=mean_iou, final_loss=final_loss, losses=losses,
                grads_finite=finite, steps=steps)


def _rank_device(args, rank):
    if args.device.startswith('cuda'):
        return torch.device('cuda', rank % torch.cuda.device_count())
    return torch.device(args.device)


def _dp_rank(rank, world, init_file, out_dir, args):
    """One rank of --data-parallel: NCCL where each rank has a card of its
    own, else gloo (several ranks on one card, or the CPU)."""
    import torch.distributed as dist
    from gendr_tpu_torch.raster import cuda_backend as CB
    device = _rank_device(args, rank)
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    torch.set_num_threads(max(1, torch.get_num_threads() // world))
    backend = ('nccl' if device.type == 'cuda'
               and world <= torch.cuda.device_count() else 'gloo')
    dist.init_process_group(backend, init_method=f'file://{init_file}',
                            world_size=world, rank=rank)
    # a spawned rank starts with torch's defaults: set main's again
    float32_backends()
    try:
        mesh = S.make_mesh({'dp': world})
        result = train(args, device, mesh)
        del result['steps']
        result['launches'] = dict(CB.LAUNCHES)
        result['collective_seconds'] = S.collective_seconds()
        torch.save(result, os.path.join(out_dir, f'rank{rank}.pt'))
    finally:
        dist.destroy_process_group()


def train_data_parallel(args, world):
    """``train`` in ``world`` spawned ranks over one dp axis; returns rank
    0's result, with every rank's kernel launches and seconds in
    collectives ('launches', 'collective_seconds': lists by rank)."""
    if args.batch_size % world:
        raise SystemExit(f'train_reconstruction: --batch_size '
                         f'{args.batch_size} does not split over {world} '
                         f'ranks')
    if args.device.startswith('cuda'):
        # built once here, not raced by the ranks
        from gendr_tpu_torch import _build
        _build.build('rasterize_fwd', 'rasterize_bwd', 'prepass')
    with tempfile.TemporaryDirectory() as out_dir:
        S.spawn_ranks(_dp_rank, world, (world, os.path.join(out_dir, 'init'),
                                        out_dir, args))
        ranks = [torch.load(os.path.join(out_dir, f'rank{r}.pt'),
                            weights_only=False) for r in range(world)]
    result = ranks[0]
    result['launches'] = [r['launches'] for r in ranks]
    result['collective_seconds'] = [r['collective_seconds'] for r in ranks]
    return result


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--class_ids', type=str,
                        default=','.join(c for c in CLASS_IDS_MAP
                                         if not c.startswith('syn')))
    parser.add_argument('--image_size', type=int, default=64)
    parser.add_argument('--batch_size', type=int, default=64)
    parser.add_argument('-lr', '--learning_rate', type=float, default=1e-4)
    parser.add_argument('-ni', '--num_iterations', type=int, default=250000)
    parser.add_argument('--print_freq', type=int, default=1000)
    parser.add_argument('--eval_freq', type=int, default=10000)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--distribution', type=str, default='uniform')
    parser.add_argument('-sq', '--squared', action='store_true')
    parser.add_argument('--dist_scale', type=float, default=None)
    parser.add_argument('--dist_shape', type=float, default=0)
    parser.add_argument('--dist_shift', type=float, default=0)
    parser.add_argument('--dist_eps', type=float, default=300.)
    parser.add_argument('--t_conorm', type=str, default='probabilistic')
    parser.add_argument('--t_conorm_p', type=float, default=0)
    parser.add_argument('--lambda_laplacian', type=float, default=5e-3)
    parser.add_argument('--lambda_flatten', type=float, default=5e-4)
    parser.add_argument('--dataset-dir', type=str, default='./data-shapenet')
    parser.add_argument('--synthetic', action='store_true')
    parser.add_argument('--synthetic-objects', type=int, default=0,
                        help='objects per synthetic class (0: 64, or 4 '
                        'with --quick)')
    parser.add_argument('--backend', type=str, default=None,
                        help="'cuda' (the kernels), 'torch' (plain), or "
                        'the default for the device')
    parser.add_argument('--device', type=str, default='cuda',
                        help="'cuda' (the default: the card) or 'cpu'")
    parser.add_argument('--checkpoint-dir', type=str, default=None)
    parser.add_argument('--data-parallel', type=int, nargs='?', const=-1,
                        default=0, metavar='N',
                        help='split the batch over N ranks (no N: one per '
                        'card); on one card the ranks share it over gloo')
    parser.add_argument('--quick', action='store_true')
    parser.add_argument('--host-data', action='store_true',
                        help='keep training images on the host and upload '
                        'each batch (default: images live on the device as '
                        'uint8 and batches are gathered by index)')
    parser.add_argument('--chain', type=int, default=0,
                        help='training steps a block, on batches drawn for '
                        'the block, their losses fetched once a block: on '
                        'the card one step captured as a CUDA graph and '
                        'replayed; 0 = 8 on the card, 1 elsewhere')
    parser.add_argument('--decay-at', type=int, default=150000,
                        help='iteration at which lr and dist_scale decay '
                             'x0.3 (reference: 150k of 250k, '
                             'train_reconstruction.py:70-84); lower it to '
                             'exercise the decay logic in shorter runs')
    parser.add_argument('--max-eval-batches', type=int, default=0,
                        help='cap eval batches per class (0 = no cap); '
                        '--quick sets 2 unless given explicitly')
    args = parser.parse_args(argv)
    if args.dist_scale is None:
        args.dist_scale = default_dist_scale(
            args.distribution, args.squared, args.t_conorm, args.t_conorm_p)
    if args.quick:
        args.num_iterations = min(args.num_iterations, 20)
        args.batch_size = min(args.batch_size, 8)
        args.print_freq = 5
        args.eval_freq = args.num_iterations  # eval exactly once, at the end
        args.max_eval_batches = args.max_eval_batches or 2
    return args


def float32_backends():
    """float32 convolutions and matrix products, as the JAX script's
    jax_default_matmul_precision='float32', and cuDNN's deterministic
    algorithms: its default weight and data gradients of the encoder's
    convolutions (wgrad_alg0, dgrad) sum by atomics, so two runs of a step
    would differ in the last bits."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True


def main(argv=None):
    args = parse_args(argv)
    cuda = args.device.startswith('cuda')
    if cuda and not torch.cuda.is_available():
        raise SystemExit('train_reconstruction: --device cuda needs a CUDA '
                         'device (torch.cuda.is_available() is False); pass '
                         '--device cpu to run on the CPU')
    float32_backends()
    print(f'Using dist_scale {args.dist_scale} for {args.distribution} x '
          f'{args.t_conorm}.')
    print(vars(args))
    world = args.data_parallel
    if world < 0:
        world = torch.cuda.device_count() if cuda else 1
    if world > 1:
        return train_data_parallel(args, world)
    return train(args, args.device)


if __name__ == '__main__':
    main()
