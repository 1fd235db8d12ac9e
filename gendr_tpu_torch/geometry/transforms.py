"""Camera math: look-at basis, spherical eyes, projections.

Port of the parts of ``gendr_tpu/geometry/transforms.py`` the forward path
uses:
* ``get_points_from_angles`` — gendr/functional/get_points_from_angles.py:11-29
* ``look_at``      — gendr/functional/look_at.py:11-68
* ``perspective`` / ``orthogonal`` — gendr/transform.py:14-45
* ``Transform`` / ``LookAt`` — gendr/transform.py:48-138

The rotation is a float32 einsum.  On the card PyTorch would run it as a
matmul, and a TF32 matmul keeps only ~3 decimal digits; the JAX package
lost its camera experiment to reduced-precision einsums of exactly this
kind, so ``gendr_tpu_torch`` turns TF32 off when it is imported.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def _as_batch(v, b, device):
    v = torch.as_tensor(v, dtype=torch.float32, device=device)
    if v.ndim == 1:
        v = v[None, :].expand(b, v.shape[0])
    return v


def _normalize(v, eps=1e-5):
    # torch.nn.functional.normalize semantics: v / max(||v||, eps)
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / torch.clamp(n, min=eps)


def get_points_from_angles(distance, elevation, azimuth, degrees=True):
    """Spherical -> cartesian eye positions (get_points_from_angles.py:11-29).

    Scalar inputs give a [3] tensor; batched tensors give [B, 3].
    """
    distance = torch.as_tensor(distance, dtype=torch.float32)
    elevation = torch.as_tensor(elevation, dtype=torch.float32)
    azimuth = torch.as_tensor(azimuth, dtype=torch.float32)
    if degrees:
        elevation = elevation * (math.pi / 180.0)
        azimuth = azimuth * (math.pi / 180.0)
    return torch.stack([
        distance * torch.cos(elevation) * torch.sin(azimuth),
        distance * torch.sin(elevation),
        -distance * torch.cos(elevation) * torch.cos(azimuth),
    ], dim=-1)


def look_at(vertices, eye, at=(0, 0, 0), up=(0, 1, 0), only_rotate=False):
    """Right-handed look-at basis; rotates (and translates) vertices into
    camera space (look_at.py:51-66). vertices: [B, nv, 3]."""
    if vertices.ndim != 3:
        raise ValueError('vertices Tensor should have 3 dimensions')
    b = vertices.shape[0]
    eye = _as_batch(eye, b, vertices.device)
    at = _as_batch(at, b, vertices.device)
    up = _as_batch(up, b, vertices.device)

    z_axis = _normalize(at - eye)
    x_axis = _normalize(torch.linalg.cross(up, z_axis))
    y_axis = _normalize(torch.linalg.cross(z_axis, x_axis))
    r = torch.stack([x_axis, y_axis, z_axis], dim=1)  # [B, 3, 3]

    if not only_rotate:
        vertices = vertices - eye[:, None, :]
    return torch.einsum('bnk,bjk->bnj', vertices, r)


def perspective(vertices, angle=30.0):
    """Divide x,y by z*tan(angle) (transform.py:14-29). ``angle`` in degrees;
    a scalar or a per-batch [B] tensor."""
    if vertices.ndim != 3:
        raise ValueError('vertices Tensor should have 3 dimensions')
    angle = torch.as_tensor(angle, dtype=torch.float32,
                            device=vertices.device) * (math.pi / 180.0)
    width = torch.tan(angle).reshape(-1, 1)  # [1 or B, 1]
    z = vertices[:, :, 2]
    x = vertices[:, :, 0] / z / width
    y = vertices[:, :, 1] / z / width
    return torch.stack((x, y, z), dim=2)


def orthogonal(vertices, scale=1.0):
    """Orthogonal projection (transform.py:32-45)."""
    if vertices.ndim != 3:
        raise ValueError('vertices Tensor should have 3 dimensions')
    z = vertices[:, :, 2]
    return torch.stack((vertices[:, :, 0] * scale,
                        vertices[:, :, 1] * scale, z), dim=2)


class Transform(nn.Module):
    """Base: transforms a Mesh's vertices, returns a new Mesh
    (transform.py:48-61)."""

    def transform(self, vertices):
        raise NotImplementedError

    def forward(self, mesh):
        return mesh.with_vertices(self.transform(mesh.vertices))


class LookAt(Transform):
    """transform.py:109-138."""

    def __init__(self, perspective=True, viewing_angle=30, viewing_scale=1.0,
                 eye=None):
        super().__init__()
        self.perspective = perspective
        self.viewing_angle = viewing_angle
        self.viewing_scale = viewing_scale
        if eye is None:
            eye = [0, 0, -(1.0 / math.tan(math.radians(viewing_angle)) + 1)]
        self.register_buffer('_eye', torch.as_tensor(eye,
                                                     dtype=torch.float32))

    def set_eyes_from_angles(self, distances, elevations, azimuths):
        self.set_eyes(get_points_from_angles(distances, elevations,
                                             azimuths))

    def set_eyes(self, eyes):
        self._eye = torch.as_tensor(eyes, dtype=torch.float32,
                                    device=self._eye.device)

    @property
    def eyes(self):
        return self._eye

    def transform(self, vertices):
        vertices = look_at(vertices, self._eye)
        if self.perspective:
            return perspective(vertices, angle=self.viewing_angle)
        return orthogonal(vertices, scale=self.viewing_scale)
