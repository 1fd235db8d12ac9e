"""Mesh: a triangle-mesh container.

Port of ``gendr_tpu/geometry/mesh.py`` (API parity with the reference's
``gendr.Mesh``, gendr/mesh.py:13-126).  ``vertices``/``faces``/``textures``
are buffers, so ``Mesh.to(device)`` moves them; the transforms and the
lighting return new meshes (``with_vertices``/``with_textures``) instead of
writing in place.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from gendr_tpu_torch.geometry import core


class Mesh(nn.Module):
    def __init__(self, vertices, faces, textures, texture_res=1,
                 texture_type='surface'):
        super().__init__()
        self.register_buffer('vertices', vertices)   # [B, nv, 3] float32
        self.register_buffer('faces', faces)         # [B, nf, 3] int32
        self.register_buffer('textures', textures)
        self.texture_res = texture_res
        self.texture_type = texture_type

    @staticmethod
    def create(vertices, faces, textures=None, texture_res=1,
               texture_type='surface', device=None) -> 'Mesh':
        """Normalizing constructor (mirrors gendr/mesh.py:17-58): promotes
        numpy inputs and unbatched 2D tensors, and fills default white
        textures when none are given."""
        vertices = torch.as_tensor(vertices, dtype=torch.float32,
                                   device=device)
        faces = torch.as_tensor(faces, dtype=torch.int32,
                                device=vertices.device)
        if vertices.ndim == 2:
            vertices = vertices[None]
        if faces.ndim == 2:
            faces = faces[None]
        b, nv = vertices.shape[:2]
        nf = faces.shape[1]
        dev = vertices.device

        if textures is None:
            if texture_type == 'surface':
                textures = torch.ones((b, nf, texture_res ** 2, 3),
                                      dtype=torch.float32, device=dev)
            elif texture_type == 'vertex':
                textures = torch.ones((b, nv, 3), dtype=torch.float32,
                                      device=dev)
                texture_res = 1
            else:
                raise ValueError(texture_type)
        else:
            textures = torch.as_tensor(textures, dtype=torch.float32,
                                       device=dev)
            if textures.ndim == 3 and texture_type == 'surface':
                textures = textures[None]
            if textures.ndim == 2 and texture_type == 'vertex':
                textures = textures[None]
            if texture_type == 'surface':
                texture_res = int(np.sqrt(textures.shape[2]))
        return Mesh(vertices, faces, textures, texture_res, texture_type)

    # -- derived quantities --------------------------------------------------

    @property
    def batch_size(self):
        return self.vertices.shape[0]

    @property
    def num_vertices(self):
        return self.vertices.shape[1]

    @property
    def num_faces(self):
        return self.faces.shape[1]

    @property
    def face_vertices(self):
        return core.face_vertices(self.vertices, self.faces)

    @property
    def surface_normals(self):
        return core.surface_normals(self.vertices, self.faces)

    @property
    def vertex_normals(self):
        return core.vertex_normals(self.vertices, self.faces)

    @property
    def face_textures(self):
        """Per-face textures as consumed by the rasterizer (mesh.py:115-122):
        surface textures pass through; vertex colors are gathered per face."""
        if self.texture_type == 'surface':
            return self.textures
        if self.texture_type == 'vertex':
            return core.face_vertices(self.textures, self.faces)
        raise ValueError('texture type not applicable')

    # -- functional updates ---------------------------------------------------

    def with_vertices(self, vertices) -> 'Mesh':
        return Mesh(vertices, self.faces, self.textures, self.texture_res,
                    self.texture_type)

    def with_textures(self, textures) -> 'Mesh':
        return Mesh(self.vertices, self.faces, textures, self.texture_res,
                    self.texture_type)

    def repeat(self, n) -> 'Mesh':
        """Tile the batch dimension n times."""
        return Mesh(self.vertices.repeat(n, 1, 1), self.faces.repeat(n, 1, 1),
                    self.textures.repeat((n,) + (1,) * (self.textures.ndim
                                                        - 1)),
                    self.texture_res, self.texture_type)
