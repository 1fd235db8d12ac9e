"""Mesh: a triangle-mesh container.

Port of ``gendr_tpu/geometry/mesh.py`` (API parity with the reference's
``gendr.Mesh``, gendr/mesh.py:13-126).  ``vertices``/``faces``/``textures``
are buffers, so ``Mesh.to(device)`` moves them; the transforms and the
lighting return new meshes (``with_vertices``/``with_textures``) instead of
writing in place.  ``incidence`` (``core.incidence`` of the faces, built
once for a mesh whose faces stay fixed) is the table of the fixed-order
sums over each vertex's corners, kept as buffers too (not persistent, so
the state_dict stays the same); without it each call makes its own.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from gendr_tpu_torch.device import resolve_device
from gendr_tpu_torch.geometry import core


class Mesh(nn.Module):
    def __init__(self, vertices, faces, textures, texture_res=1,
                 texture_type='surface', incidence=None):
        super().__init__()
        self.register_buffer('vertices', vertices)   # [B, nv, 3] float32
        self.register_buffer('faces', faces)         # [B, nf, 3] int32
        self.register_buffer('textures', textures)
        self.texture_res = texture_res
        self.texture_type = texture_type
        if incidence is not None:
            core.register_incidence(self, incidence)

    @staticmethod
    def create(vertices, faces, textures=None, texture_res=1,
               texture_type='surface', device=None,
               incidence=None) -> 'Mesh':
        """Normalizing constructor (mirrors gendr/mesh.py:17-58): promotes
        numpy inputs and unbatched 2D tensors, and fills default white
        textures when none are given.  ``device=None``: the device of a
        tensor argument, else the card (device.resolve_device).
        ``incidence``: ``core.incidence`` of these faces, or None."""
        device = resolve_device(device, vertices, faces, textures)
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
        return Mesh(vertices, faces, textures, texture_res, texture_type,
                    incidence)

    @classmethod
    def from_obj(cls, filename_obj, normalization=False, load_texture=False,
                 texture_res=1, texture_type='surface',
                 device=None) -> 'Mesh':
        """Load a Wavefront .obj (mesh.py:60-77) onto ``device`` (None: the
        card, device.resolve_device)."""
        from gendr_tpu_torch.geometry import obj_io
        loaded = obj_io.load_obj(
            filename_obj, normalization=normalization,
            texture_res=texture_res, load_texture=load_texture,
            texture_type=texture_type, device=device)
        textures = loaded[2] if load_texture else None
        return cls.create(loaded[0], loaded[1], textures, texture_res,
                          texture_type)

    def save_obj(self, filename_obj, save_texture=False, texture_res_out=16):
        from gendr_tpu_torch.geometry import obj_io
        if self.batch_size != 1:
            raise ValueError('Could not save when batch size > 1')
        if save_texture:
            obj_io.save_obj(filename_obj, self.vertices[0], self.faces[0],
                            textures=self.textures[0],
                            texture_res=texture_res_out,
                            texture_type=self.texture_type)
        else:
            obj_io.save_obj(filename_obj, self.vertices[0], self.faces[0],
                            textures=None)

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
    def incidence(self):
        """The faces' core.Incidence this mesh keeps, or None."""
        return core.module_incidence(self)

    @property
    def face_vertices(self):
        return core.face_vertices(self.vertices, self.faces, self.incidence)

    @property
    def surface_normals(self):
        return core.surface_normals(self.vertices, self.faces, self.incidence)

    @property
    def vertex_normals(self):
        return core.vertex_normals(self.vertices, self.faces, self.incidence)

    @property
    def face_textures(self):
        """Per-face textures as consumed by the rasterizer (mesh.py:115-122):
        surface textures pass through; vertex colors are gathered per face."""
        if self.texture_type == 'surface':
            return self.textures
        if self.texture_type == 'vertex':
            return core.face_vertices(self.textures, self.faces,
                                      self.incidence)
        raise ValueError('texture type not applicable')

    def voxelize(self, voxel_size=32):
        """Solid-voxelize into [B, vs, vs, vs] occupancy (mesh.py:124-126)."""
        from gendr_tpu_torch.geometry import voxelize
        fv = self.face_vertices * voxel_size / (voxel_size - 1) + 0.5
        return voxelize.voxelization(fv, voxel_size, False)

    # -- functional updates ---------------------------------------------------

    def with_incidence(self) -> 'Mesh':
        """This mesh with its incidence table built, once, from the faces of
        its first batch element (a batch shares its faces)."""
        return Mesh(self.vertices, self.faces, self.textures, self.texture_res,
                    self.texture_type,
                    core.incidence(self.faces[0], self.num_vertices))

    def with_vertices(self, vertices) -> 'Mesh':
        return Mesh(vertices, self.faces, self.textures, self.texture_res,
                    self.texture_type, self.incidence)

    def with_textures(self, textures) -> 'Mesh':
        return Mesh(self.vertices, self.faces, textures, self.texture_res,
                    self.texture_type, self.incidence)

    def repeat(self, n) -> 'Mesh':
        """Tile the batch dimension n times."""
        return Mesh(self.vertices.repeat(n, 1, 1), self.faces.repeat(n, 1, 1),
                    self.textures.repeat((n,) + (1,) * (self.textures.ndim
                                                        - 1)),
                    self.texture_res, self.texture_type,
                    self._shared_incidence())

    def _shared_incidence(self):
        """The incidence table if it serves every batch element alike (1-d
        tables), else None: a tiled batch's per-element table would not."""
        inc = self.incidence
        if inc is None or inc.gather.order.ndim != 1:
            return None
        return inc
