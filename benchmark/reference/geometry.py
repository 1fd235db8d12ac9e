"""The benchmark's own geometry: the meshes its cells render and the camera
transforms, in plain numpy and PyTorch.

It imports nothing of the program.  The meshes are part of the problem (the
inputs both sides are handed), and the transforms are the reference side's
own: the same formulas the published GenDR / SoftRas code uses
(get_points_from_angles, look_at, perspective), written out elementwise, so
that no matrix product can run in TF32.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def icosphere(level):
    """A subdivided icosahedron: 10 * 4**level + 2 unit vertices [nv, 3]
    float32 and faces [nf, 3] int32 (level 3: 642 / 1280, the tessellation
    of the published sphere_642.obj; level 2: 162 / 320).  Vertices are
    numbered in order of creation, each edge midpoint once, in float64."""
    t = (1.0 + math.sqrt(5.0)) / 2.0
    verts = [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
             (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
             (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1)]
    verts = [np.array(v, np.float64) / np.linalg.norm(v) for v in verts]
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
             (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
             (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
             (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    for _ in range(level):
        cache = {}

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = verts[a] + verts[b]
                cache[key] = len(verts)
                verts.append(m / np.linalg.norm(m))
            return cache[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca)]
        faces = new_faces
    return np.array(verts, np.float32), np.array(faces, np.int32)


def peanut(v, scale, pinch):
    """The reconstruction's two-lobe family (syn_peanut) at fixed
    parameters: v scaled per axis, then pinched in y and z near x = 0."""
    r = 1.0 - pinch * np.exp(-(v[:, 0] / 0.35) ** 2)
    out = v * np.asarray(scale, np.float64)[None, :]
    out[:, 1] *= r
    out[:, 2] *= r
    return out.astype(np.float32)


def synthetic_shape(rng, family, v):
    """One random mesh of a synthetic family, drawing from rng as the
    program's stand-in dataset does, draw for draw: the formulas are part
    of the problem the reconstruction cell trains on."""
    scale = 0.25 + rng.rand(3) * 0.2
    out = v * scale[None, :]
    if family in ('syn_ellipsoid', 'synthetic'):
        return out.astype(np.float32)
    if family == 'syn_box':
        p = 0.45 + rng.rand() * 0.2
        return (np.sign(v) * np.abs(v) ** p * scale[None, :] * 0.85) \
            .astype(np.float32)
    if family == 'syn_peanut':
        pinch = 0.45 + rng.rand() * 0.25
        r = 1.0 - pinch * np.exp(-(v[:, 0] / 0.35) ** 2)
        out[:, 1] *= r
        out[:, 2] *= r
        return out.astype(np.float32)
    if family == 'syn_disk':
        out[:, 1] *= 0.25 + rng.rand() * 0.15
        return out.astype(np.float32)
    if family == 'syn_pear':
        t = 0.35 + rng.rand() * 0.25
        r = 1.0 - t * (v[:, 1] + 1.0) * 0.5
        out[:, 0] *= r
        out[:, 2] *= r
        return out.astype(np.float32)
    if family == 'syn_star':
        k = rng.choice([3, 4, 5])
        a = 0.18 + rng.rand() * 0.12
        theta = np.arctan2(v[:, 2], v[:, 0])
        r = 1.0 + a * np.cos(k * theta) * (1.0 - v[:, 1] ** 2)
        out[:, 0] *= r
        out[:, 2] *= r
        return out.astype(np.float32)
    if family == 'syn_bump':
        d = rng.randn(3)
        d /= np.linalg.norm(d)
        a = 0.5 + rng.rand() * 0.3
        r = 1.0 + a * np.exp(-((1.0 - v @ d) / 0.3) ** 2)
        return (v * r[:, None] * scale[None, :] * 0.8).astype(np.float32)
    if family == 'syn_dumbbell':
        pinch = 0.62 + rng.rand() * 0.18
        c = rng.rand() * 0.3 - 0.15
        r = 1.0 - pinch * np.exp(-((v[:, 0] - c) / 0.3) ** 2)
        out[:, 1] *= r
        out[:, 2] *= r
        return out.astype(np.float32)
    if family == 'syn_cone':
        t = 0.75 + rng.rand() * 0.2
        r = 1.0 - t * np.clip(v[:, 1], 0.0, 1.0)
        out[:, 0] *= r
        out[:, 2] *= r
        return out.astype(np.float32)
    if family == 'syn_capsule':
        s = 0.8 + rng.rand() * 0.6
        out[:, 0] = np.where(np.abs(v[:, 0]) < 0.5, v[:, 0] * (1 + s),
                             np.sign(v[:, 0]) * (np.abs(v[:, 0]) + 0.5 * s))
        out[:, 0] *= scale[0] * 0.7
        return out.astype(np.float32)
    if family == 'syn_egg':
        a = 0.25 + rng.rand() * 0.2
        r = 1.0 + a * v[:, 1]
        out[:, 0] *= r
        out[:, 2] *= r
        return out.astype(np.float32)
    if family == 'syn_twist':
        a = (0.6 + rng.rand() * 0.8) * np.pi / 2
        ang = a * v[:, 1]
        c, s = np.cos(ang), np.sin(ang)
        out = v * (scale * np.array([1.0, 1.0, 0.55]))[None, :]
        x, z = out[:, 0].copy(), out[:, 2].copy()
        out[:, 0] = c * x - s * z
        out[:, 2] = s * x + c * z
        return out.astype(np.float32)
    if family == 'syn_wave':
        k = 2 + rng.randint(3)
        a = 0.12 + rng.rand() * 0.1
        r = 1.0 + a * np.sin(np.pi * k * v[:, 1])
        out[:, 0] *= r
        out[:, 2] *= r
        return out.astype(np.float32)
    raise ValueError(family)


def write_obj(path, vertices, faces):
    """A plain OBJ file: 'v x y z' with 8 decimals, 'f a b c' 1-based."""
    with open(path, 'w') as f:
        for x, y, z in np.asarray(vertices, np.float64):
            f.write(f'v {x:.8f} {y:.8f} {z:.8f}\n')
        for a, b, c in np.asarray(faces) + 1:
            f.write(f'f {a} {b} {c}\n')


def read_obj(path):
    """(vertices [nv, 3] float32, faces [nf, 3] int64) of the triangles of
    an OBJ file that write_obj wrote."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if parts and parts[0] == 'v':
                verts.append([float(x) for x in parts[1:4]])
            elif parts and parts[0] == 'f':
                faces.append([int(p.split('/')[0]) - 1 for p in parts[1:4]])
    return np.array(verts, np.float32), np.array(faces, np.int64)


# ---------------------------------------------------------------------------
# Camera transforms (the published get_points_from_angles, look_at,
# perspective), batched over the first axis
# ---------------------------------------------------------------------------

def points_from_angles(distance, elevation, azimuth):
    """Eyes [..., 3] from spherical coordinates in degrees."""
    el = elevation * (math.pi / 180.0)
    az = azimuth * (math.pi / 180.0)
    return torch.stack([distance * torch.cos(el) * torch.sin(az),
                        distance * torch.sin(el),
                        -distance * torch.cos(el) * torch.cos(az)], -1)


def _unit(v):
    n = torch.sqrt((v * v).sum(-1, keepdim=True))
    return v / torch.clamp(n, min=1e-5)


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def look_at(vertices, eye, only_rotate=False):
    """vertices [B, nv, 3] in the camera frame of eyes [B, 3] looking at the
    origin with up = +y."""
    up = torch.zeros_like(eye)
    up[:, 1] = 1.0
    z = _unit(-eye)
    x = _unit(_cross(up, z))
    y = _unit(_cross(z, x))
    if not only_rotate:
        vertices = vertices - eye[:, None, :]
    return torch.stack([(vertices * a[:, None, :]).sum(-1)
                        for a in (x, y, z)], -1)


def perspective(vertices, angle):
    """x and y divided by z tan(angle); angle in degrees, a number or [B]."""
    width = torch.tan(torch.as_tensor(angle, dtype=vertices.dtype,
                                      device=vertices.device)
                      * (math.pi / 180.0)).reshape(-1, 1)
    z = vertices[..., 2]
    return torch.stack([vertices[..., 0] / z / width,
                        vertices[..., 1] / z / width, z], -1)
