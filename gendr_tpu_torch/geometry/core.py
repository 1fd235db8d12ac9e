"""Core mesh tensor ops: gathers and normals.

Port of ``gendr_tpu/geometry/core.py``:
* ``face_vertices`` — gendr/functional/face_vertices.py:9-27;
* ``vertex_normals`` — gendr/functional/vertex_normals.py:10-46;
* ``surface_normals`` — gendr/mesh.py:105-109.

The sums over a vertex's corners (the vertex normals, the gradient of the
gather) run in a fixed order, with no atomics (``ops/segments.py``), over
an :class:`Incidence` table: built once for a fixed mesh
(:func:`incidence`), or made on each call from the faces, with static
shapes and no read back to the host.  The order is the one ``index_add_``
and the gather's backward take on the CPU, so CPU results keep their bits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gendr_tpu_torch.ops.segments import (Segments, gather_rows,
                                          module_segments, register_segments,
                                          segment_sum, segments)


class Incidence(NamedTuple):
    """A mesh's corners by vertex, the tables of its fixed-order sums.

    gather: the corners in face-major order (face f corner c at 3 f + c),
    the gradient of :func:`face_vertices`; normals: in corner-major order
    (c nf + f), the vertex normals' sum (vertex_normals.py:33-44)."""
    gather: Segments
    normals: Segments


def incidence(faces: torch.Tensor, nv: int) -> Incidence:
    """The Incidence of faces [nf, 3] (one table for every batch element
    of a mesh with these faces) or [B, nf, 3], over nv vertices."""
    faces = torch.as_tensor(faces).long()
    return Incidence(segments(faces.flatten(-2), nv),
                     segments(faces.transpose(-1, -2).flatten(-2), nv))


def register_incidence(module: torch.nn.Module, inc: Incidence):
    """Keep inc in module as buffers (``segments.register_segments``: they
    move with it and stay out of its state_dict); module_incidence reads
    it back."""
    for name, seg in inc._asdict().items():
        register_segments(module, f'incidence_{name}', seg)


def module_incidence(module: torch.nn.Module):
    """The Incidence register_incidence kept in module, or None."""
    segs = [module_segments(module, f'incidence_{n}')
            for n in Incidence._fields]
    return None if segs[0] is None else Incidence(*segs)


def face_vertices(vertices: torch.Tensor, faces: torch.Tensor,
                  inc: Incidence = None):
    """Gather per-face vertex attributes.

    vertices: [B, nv, D] float; faces: [B, nf, 3] int -> [B, nf, 3, D].
    The gradient sums each vertex's corners in a fixed order over ``inc``
    (the faces' :class:`Incidence`; None: made here).
    """
    if vertices.ndim != 3 or faces.ndim != 3 or faces.shape[2] != 3:
        raise ValueError(f'expected vertices [B, nv, D] and faces '
                         f'[B, nf, 3], got {tuple(vertices.shape)} and '
                         f'{tuple(faces.shape)}')
    B, nf = faces.shape[:2]
    seg = inc.gather if inc is not None else None
    out = gather_rows(vertices, faces.reshape(B, 3 * nf), seg)
    return out.reshape(B, nf, 3, vertices.shape[2])


def _face_cross_products(vertices, faces, inc=None):
    """Per-face, per-corner cross products (area-weighted normals), in the
    reference's corner convention (vertex_normals.py:33-44)."""
    fv = face_vertices(vertices, faces, inc)  # [B, nf, 3, 3]
    v0, v1, v2 = fv[:, :, 0], fv[:, :, 1], fv[:, :, 2]
    n0 = torch.linalg.cross(v1 - v0, v2 - v0)
    n1 = torch.linalg.cross(v2 - v1, v0 - v1)
    n2 = torch.linalg.cross(v0 - v2, v1 - v2)
    return n0, n1, n2


def vertex_normals(vertices: torch.Tensor, faces: torch.Tensor,
                   inc: Incidence = None):
    """Area-weighted vertex normals. [B,nv,3] x [B,nf,3] -> [B,nv,3]: each
    vertex sums its corners' cross products in corner-major order, over
    ``inc`` (None: made here)."""
    B, nv = vertices.shape[:2]
    if inc is None:
        inc = incidence(faces, nv)
    n0, n1, n2 = _face_cross_products(vertices, faces, inc)
    val = torch.cat([n0, n1, n2], dim=1)             # [B, 3nf, 3]
    normals = segment_sum(val, inc.normals)
    norm = torch.linalg.vector_norm(normals, dim=-1, keepdim=True)
    return normals / torch.clamp(norm, min=1e-6)


def surface_normals(vertices: torch.Tensor, faces: torch.Tensor,
                    inc: Incidence = None):
    """Unit face normals, reference convention cross(v2-v1, v0-v1)
    (mesh.py:105-109). [B,nf,3]."""
    fv = face_vertices(vertices, faces, inc)
    v10 = fv[:, :, 0] - fv[:, :, 1]
    v12 = fv[:, :, 2] - fv[:, :, 1]
    n = torch.linalg.cross(v12, v10)
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    return n / torch.clamp(norm, min=1e-6)
