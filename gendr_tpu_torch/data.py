"""Procedural data assets (numpy only).

A copy of ``gendr_tpu/data.py``, which the port cannot import without jax.
The reference ships binary assets (experiments/data/sphere_642.obj,
sphere_1352.obj, cameras.npy); we generate the equivalent geometry
procedurally:

* ``icosphere(3)`` — 642 vertices / 1280 faces, the same tessellation class
  as sphere_642.obj (a level-3 subdivided icosahedron).
* ``uv_sphere(28, 50)`` — 1352 vertices / 2700 faces like sphere_1352.obj.
* ``camera_grid()`` — the 120-pose grid of cameras.npy: distance 2.732,
  elevations {-60,-30,0,30,60}, azimuths 0..-345 step -15.
"""

from __future__ import annotations

import math

import numpy as np


def icosphere(level: int = 3, radius: float = 1.0):
    """Subdivided icosahedron: 10*4^level + 2 vertices."""
    t = (1.0 + math.sqrt(5.0)) / 2.0
    verts = [
        (-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
        (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
        (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1),
    ]
    verts = [np.array(v, np.float64) / np.linalg.norm(v) for v in verts]
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    for _ in range(level):
        cache = {}
        new_faces = []

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = verts[a] + verts[b]
                m = m / np.linalg.norm(m)
                cache[key] = len(verts)
                verts.append(m)
            return cache[key]

        for (a, b, c) in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (ab, b, bc), (ca, bc, c),
                          (ab, bc, ca)]
        faces = new_faces
    v = np.array(verts, np.float32) * radius
    f = np.array(faces, np.int32)
    return v, f


def uv_sphere(n_lat: int = 28, n_lon: int = 50, radius: float = 1.0):
    """Latitude/longitude sphere: (n_lat-1)*n_lon + 2 vertices."""
    verts = [np.array([0.0, radius, 0.0])]
    for i in range(1, n_lat):
        theta = math.pi * i / n_lat
        for j in range(n_lon):
            phi = 2 * math.pi * j / n_lon
            verts.append(np.array([
                radius * math.sin(theta) * math.cos(phi),
                radius * math.cos(theta),
                radius * math.sin(theta) * math.sin(phi)]))
    verts.append(np.array([0.0, -radius, 0.0]))
    south = len(verts) - 1

    def ring(i, j):
        return 1 + (i - 1) * n_lon + (j % n_lon)

    faces = []
    for j in range(n_lon):
        faces.append((0, ring(1, j + 1), ring(1, j)))
    for i in range(1, n_lat - 1):
        for j in range(n_lon):
            a, b = ring(i, j), ring(i, j + 1)
            c, d = ring(i + 1, j), ring(i + 1, j + 1)
            faces.append((a, b, d))
            faces.append((a, d, c))
    for j in range(n_lon):
        faces.append((south, ring(n_lat - 1, j), ring(n_lat - 1, j + 1)))
    return (np.array(verts, np.float32),
            np.array(faces, np.int32))


def sphere(num_vertices: int = 642):
    """Template spheres matching the reference's assets by vertex count."""
    if num_vertices == 642:
        return icosphere(3)
    if num_vertices == 1352:
        return uv_sphere(28, 50)
    if num_vertices == 162:
        return icosphere(2)
    if num_vertices == 2562:
        return icosphere(4)
    raise ValueError(f'no sphere template with {num_vertices} vertices')


def camera_grid():
    """[120, 3] array of (distance, elevation, azimuth) poses matching the
    reference's cameras.npy (5 elevations x 24 azimuths)."""
    poses = []
    for elev in (-60.0, -30.0, 0.0, 30.0, 60.0):
        for k in range(24):
            poses.append((2.732, elev, -15.0 * k))
    return np.array(poses, np.float32)


def textured_scene(texture_res: int = 5):
    """The procedural stand-in for the reference's textured panda
    (``animations/common.py:textured_scene`` without an OBJ): icosphere(3)
    x0.8 with a surface texture of texture_res^2 texels per face, coloured
    per face by its centre.  Returns (vertices [642, 3], faces [1280, 3],
    textures [1, 1280, texture_res^2, 3])."""
    v, f = icosphere(3)
    tex = np.zeros((f.shape[0], texture_res ** 2, 3), np.float32)
    centers = v[f].mean(1)
    tex[:, :, 0] = 0.5 + 0.5 * np.sin(6 * centers[:, 0])[:, None]
    tex[:, :, 1] = 0.5 + 0.5 * np.cos(6 * centers[:, 1])[:, None]
    tex[:, :, 2] = 0.6
    return v * 0.8, f, tex[None]


def test_meshes(name: str = 'cube'):
    """Simple procedural stand-ins for the reference's OBJ assets."""
    if name == 'cube':
        v = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                      for z in (-1, 1)], np.float32) * 0.6
        f = np.array([
            (0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5),
            (0, 4, 5), (0, 5, 1), (2, 3, 7), (2, 7, 6),
            (0, 2, 6), (0, 6, 4), (1, 5, 7), (1, 7, 3)], np.int32)
        return v, f
    if name == 'sphere':
        return icosphere(2)
    raise ValueError(name)
