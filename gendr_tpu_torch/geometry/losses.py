"""Mesh regularization losses: uniform Laplacian and dihedral flatness.

Port of ``gendr_tpu/geometry/losses.py`` (semantics of the reference's
gendr/losses.py:11-120):

* ``LaplacianLoss``: the reference materializes a dense nv x nv matrix
  (losses.py:17-36, O(nv^2) memory); here the uniform Laplacian
  L x = x - mean of the neighbour vertices is a gather plus a segment
  sum over the edge list (O(E)), in the order ``index_add_`` takes on the
  CPU.
* ``FlattenLoss``: (cos(dihedral) + 1)^2 over the interior edges, with the
  edge -> opposite-vertex tables built in one dict pass instead of the
  reference's O(E*F) loop.

Both are ``nn.Module``s whose index tables are buffers, so ``.to(device)``
moves them.  Every sum over an index (the neighbour sum, the gradients of
the gathers) runs in a fixed order over a table built with the module
(``ops/segments.py``), so the losses and their gradients are a function of
their inputs on the card too.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from gendr_tpu_torch.ops.segments import (gather_rows, module_segments,
                                          register_segments, segment_sum,
                                          segments)


def _unique_edges(faces, pairs):
    """Sorted undirected edges (min, max) of the given vertex pairs of
    every face."""
    edges = set()
    for f in faces:
        for i, j in pairs:
            a, b = int(f[i]), int(f[j])
            edges.add((min(a, b), max(a, b)))
    return sorted(edges)


class LaplacianLoss(nn.Module):
    """||L x||^2 with the row-normalized uniform graph Laplacian."""

    def __init__(self, vertex, faces, average=False):
        super().__init__()
        faces = np.asarray(faces)
        self.nv = int(np.asarray(vertex).shape[0])
        self.nf = int(faces.shape[0])
        self.average = average
        e = np.array(_unique_edges(faces, ((0, 1), (1, 2), (0, 2))),
                     np.int64).reshape(-1, 2)
        # both directions: row i gathers neighbour j
        self.register_buffer('rows', torch.from_numpy(
            np.concatenate([e[:, 0], e[:, 1]])))
        self.register_buffer('cols', torch.from_numpy(
            np.concatenate([e[:, 1], e[:, 0]])))
        deg = np.zeros(self.nv, np.float32)
        np.add.at(deg, e[:, 0], 1)
        np.add.at(deg, e[:, 1], 1)
        self.register_buffer('deg', torch.from_numpy(np.maximum(deg, 1.0)))
        for name in ('rows', 'cols'):
            register_segments(self, name,
                              segments(getattr(self, name), self.nv))

    def forward(self, x):
        """x: [B, nv, 3] -> per-batch loss [B] (losses.py:34-42)."""
        neighbor_sum = segment_sum(
            gather_rows(x, self.cols, module_segments(self, 'cols')),
            module_segments(self, 'rows'))
        lap = x - neighbor_sum / self.deg[None, :, None]
        loss = (lap ** 2).sum(dim=(1, 2))
        if self.average:
            return loss.sum() / x.shape[0]
        return loss


class FlattenLoss(nn.Module):
    """Penalize (cos(dihedral) + 1)^2 across interior edges."""

    def __init__(self, faces, average=False):
        super().__init__()
        faces = np.asarray(faces)
        self.nf = int(faces.shape[0])
        self.average = average
        # the edge set as the reference builds it (losses.py:52): the
        # (f0, f1) and (f1, f2) vertex pairs of every face
        edge_set = _unique_edges(faces, ((0, 1), (1, 2)))
        # opposite vertices from every face holding both endpoints, in face
        # order (losses.py:58-69)
        opposite = {e: [] for e in edge_set}
        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            for e, opp in (((min(a, b), max(a, b)), c),
                           ((min(b, c), max(b, c)), a),
                           ((min(a, c), max(a, c)), b)):
                if e in opposite:
                    opposite[e].append(opp)
        # the reference assumes a closed manifold (two faces per edge); an
        # open mesh's boundary edges drop out of the loss
        quads = [(u, v, opps[0], opps[1]) for (u, v), opps in
                 ((e, opposite[e]) for e in edge_set) if len(opps) >= 2]
        q = torch.tensor(quads, dtype=torch.int64).reshape(-1, 4)
        # the vertices the faces name (the gradient of any further ones
        # is 0: ops.segments.gather_rows pads it)
        nv = int(faces.max()) + 1 if faces.size else 0
        for i, name in enumerate(('v0s', 'v1s', 'v2s', 'v3s')):
            self.register_buffer(name, q[:, i].contiguous())
            register_segments(self, name, segments(q[:, i], nv))

    def _gather(self, vertices, name):
        return gather_rows(vertices, getattr(self, name),
                           module_segments(self, name))

    def forward(self, vertices, eps=1e-6):
        """vertices: [B, nv, 3] -> [B] (losses.py:78-120: every norm and
        divide is eps-regularized, and the rejection length is taken as
        |wing| sin(angle))."""
        edge_a = self._gather(vertices, 'v1s') \
            - self._gather(vertices, 'v0s')
        edge_sq = (edge_a ** 2).sum(-1)
        edge_len = torch.sqrt(edge_sq + eps)

        def edge_rejection(wing_idx):
            wing = self._gather(vertices, wing_idx) \
                - self._gather(vertices, 'v0s')
            wing_len = torch.sqrt((wing ** 2).sum(-1) + eps)
            proj = (edge_a * wing).sum(-1)
            cos_w = proj / (edge_len * wing_len + eps)
            sin_w = torch.sqrt(1 - cos_w ** 2 + eps)
            rej = wing - edge_a * (proj / (edge_sq + eps))[:, :, None]
            return rej, wing_len * sin_w

        rej2, len2 = edge_rejection('v2s')
        rej3, len3 = edge_rejection('v3s')
        cos_dihedral = (rej2 * rej3).sum(-1) / (len2 * len3 + eps)
        loss = ((cos_dihedral + 1) ** 2).sum(1)
        if self.average:
            return loss.sum() / vertices.shape[0]
        return loss
