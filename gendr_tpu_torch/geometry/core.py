"""Core mesh tensor ops: gathers and normals.

Port of ``gendr_tpu/geometry/core.py``:
* ``face_vertices`` — gendr/functional/face_vertices.py:9-27;
* ``vertex_normals`` — gendr/functional/vertex_normals.py:10-46 (one
  ``index_add_``; on a CUDA tensor its sums run in atomic order, so the
  normals may differ from run to run in the last bit);
* ``surface_normals`` — gendr/mesh.py:105-109.
"""

from __future__ import annotations

import torch


def face_vertices(vertices: torch.Tensor, faces: torch.Tensor):
    """Gather per-face vertex attributes.

    vertices: [B, nv, D] float; faces: [B, nf, 3] int -> [B, nf, 3, D].
    """
    if vertices.ndim != 3 or faces.ndim != 3 or faces.shape[2] != 3:
        raise ValueError(f'expected vertices [B, nv, D] and faces '
                         f'[B, nf, 3], got {tuple(vertices.shape)} and '
                         f'{tuple(faces.shape)}')
    bidx = torch.arange(vertices.shape[0], device=vertices.device)
    return vertices[bidx[:, None, None], faces.long()]


def _face_cross_products(vertices, faces):
    """Per-face, per-corner cross products (area-weighted normals), in the
    reference's corner convention (vertex_normals.py:33-44)."""
    fv = face_vertices(vertices, faces)  # [B, nf, 3, 3]
    v0, v1, v2 = fv[:, :, 0], fv[:, :, 1], fv[:, :, 2]
    n0 = torch.linalg.cross(v1 - v0, v2 - v0)
    n1 = torch.linalg.cross(v2 - v1, v0 - v1)
    n2 = torch.linalg.cross(v0 - v2, v1 - v2)
    return n0, n1, n2


def vertex_normals(vertices: torch.Tensor, faces: torch.Tensor):
    """Area-weighted vertex normals. [B,nv,3] x [B,nf,3] -> [B,nv,3]."""
    B, nv = vertices.shape[:2]
    n0, n1, n2 = _face_cross_products(vertices, faces)
    idx = torch.cat([faces[:, :, 0], faces[:, :, 1], faces[:, :, 2]], dim=1)
    val = torch.cat([n0, n1, n2], dim=1)             # [B, 3nf, 3]
    flat = (idx.long() + nv * torch.arange(B, device=idx.device)[:, None])
    normals = vertices.new_zeros((B * nv, 3)).index_add_(
        0, flat.reshape(-1), val.reshape(-1, 3)).reshape(B, nv, 3)
    norm = torch.linalg.vector_norm(normals, dim=-1, keepdim=True)
    return normals / torch.clamp(norm, min=1e-6)


def surface_normals(vertices: torch.Tensor, faces: torch.Tensor):
    """Unit face normals, reference convention cross(v2-v1, v0-v1)
    (mesh.py:105-109). [B,nf,3]."""
    fv = face_vertices(vertices, faces)
    v10 = fv[:, :, 0] - fv[:, :, 1]
    v12 = fv[:, :, 2] - fv[:, :, 1]
    n = torch.linalg.cross(v12, v10)
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    return n / torch.clamp(norm, min=1e-6)
