"""Lighting: ambient + Lambertian directional.

Port of ``gendr_tpu/geometry/lighting.py`` (gendr/functional/lighting.py:12-47
and the module wrappers gendr/lighting.py:12-71).
"""

from __future__ import annotations

import torch
from torch import nn

from gendr_tpu_torch.device import as_float32


def _vec(v, device):
    v = as_float32(v, device)
    if v.ndim == 1:
        v = v[None, :]
    return v


def ambient_lighting(light, light_intensity=0.5, light_color=(1, 1, 1)):
    """light [B, n, 3] += intensity * color (functional/lighting.py:12-23)."""
    color = _vec(light_color, light.device)
    return light + light_intensity * color[:, None, :]


def directional_lighting(light, normals, light_intensity=0.5,
                         light_color=(1, 1, 1), light_direction=(0, 1, 0)):
    """Lambert term relu(n . l) (functional/lighting.py:26-47).  A face
    edge-on to the light (n . l exactly 0, as a symmetric sphere's equator
    is to a light along an axis) passes no gradient, as upstream's
    F.relu; a clamp would pass all of it."""
    color = _vec(light_color, light.device)
    direction = _vec(light_direction, light.device)
    cosine = torch.relu((normals * direction[:, None, :]).sum(2))
    return light + light_intensity * (color[:, None, :] * cosine[:, :, None])


class AmbientLighting(nn.Module):
    """gendr/lighting.py:12-20."""

    def __init__(self, light_intensity=0.5, light_color=(1, 1, 1)):
        super().__init__()
        self.light_intensity = light_intensity
        self.light_color = light_color

    def forward(self, light):
        return ambient_lighting(light, self.light_intensity, self.light_color)


class DirectionalLighting(nn.Module):
    """gendr/lighting.py:23-34."""

    def __init__(self, light_intensity=0.5, light_color=(1, 1, 1),
                 light_direction=(0, 1, 0)):
        super().__init__()
        self.light_intensity = light_intensity
        self.light_color = light_color
        self.light_direction = light_direction

    def forward(self, light, normals):
        return directional_lighting(light, normals, self.light_intensity,
                                    self.light_color, self.light_direction)


class Lighting(nn.Module):
    """Ambient + a list of directional lights applied to mesh textures
    (gendr/lighting.py:37-71)."""

    def __init__(self, intensity_ambient=0.5, color_ambient=(1, 1, 1),
                 intensity_directionals=0.5, color_directionals=(1, 1, 1),
                 directions=(0, 1, 0)):
        super().__init__()
        self.ambient = AmbientLighting(intensity_ambient, color_ambient)
        self.directionals = nn.ModuleList([DirectionalLighting(
            intensity_directionals, color_directionals, directions)])

    def forward(self, mesh):
        dev = mesh.vertices.device
        if mesh.texture_type == 'surface':
            light = torch.zeros((mesh.batch_size, mesh.num_faces, 3),
                                dtype=torch.float32, device=dev)
            light = self.ambient(light)
            for directional in self.directionals:
                light = directional(light, mesh.surface_normals)
            new_textures = mesh.textures * light[:, :, None, :]
        elif mesh.texture_type == 'vertex':
            light = torch.zeros((mesh.batch_size, mesh.num_vertices, 3),
                                dtype=torch.float32, device=dev)
            light = self.ambient(light)
            for directional in self.directionals:
                light = directional(light, mesh.vertex_normals)
            new_textures = mesh.textures * light
        else:
            raise ValueError(mesh.texture_type)
        return mesh.with_textures(new_textures)
