"""The benchmark's plain silhouette rasterizer: GenDR's soft alpha and its
hard (heaviside) alpha, forward and gradient, in plain PyTorch.

Independent of the program: it works from the faces' screen-space
vertices, with the published definitions.

* A (pixel, face) pair is evaluated where the pixel centre lies inside the
  face's screen-space bounding box widened by the cull margin (the
  margin can only drop pairs whose coverage is at most 1e-6, which GenDR
  drops anyway).  ``pair_ranges`` gives each face's pixel rectangle, and
  ``count_pairs`` their total, the pair count the rooflines are held to.
* The signed distance is the distance from the pixel centre to the
  nearest edge segment, positive inside the triangle; the coverage of a
  pair is the CDF of distance / tau, kept where the pixel is inside or
  its squared distance is under dist_eps * tau, and where it exceeds 1e-6.
* The probabilistic t-conorm folds a pixel's coverages into
  alpha = 1 - prod(1 - p); its gradient with respect to one coverage is
  GenDR's aggregate-inverse rule (1 - alpha) / max(1 - p, 1e-6).

Pairs are walked in blocks of at most ``BLOCK`` pairs: a block gathers its
faces' vertices and pixel centres into flat arrays.  The backward
recomputes each block's coverages under autograd, so memory holds one
block's graph at a time whatever the number of pairs (about 1e9 at
opt_camera's tau = 0.1).
"""

from __future__ import annotations

import torch

BLOCK = 1 << 24
LOGISTIC_U = 13.9     # CDF(-13.9) < 1e-6
UNIFORM_U = 1.0


def cull_margin(dist, tau, dist_eps):
    """The gate's radius around a face's bbox: the smaller of the distance
    beyond which dist_eps culls a pair and that at which the CDF falls
    under 1e-6; heaviside has none."""
    if dist == 'heaviside':
        return 0.0
    u = {'logistic': LOGISTIC_U, 'uniform': UNIFORM_U}[dist]
    return min((dist_eps * tau) ** 0.5, u * tau)


def pair_ranges(xy, image_size, margin):
    """Per face, the pixel centres inside its bbox widened by margin:
    (first column, columns, first row, rows), int64 [B, F] each.  xy: the
    faces' screen-space vertices [B, F, 3, 2] in NDC; the centre of column
    c is (2c + 1 - S) / S and that of row r is (S - 1 - 2r) / S.  Computed
    in float64."""
    S = image_size
    xy = xy.detach().double()
    lo = xy.amin(2) - margin
    hi = xy.amax(2) + margin
    a = torch.ceil((lo * S + S - 1) / 2).clamp(0, S)
    b = torch.floor((hi * S + S - 1) / 2).clamp(-1, S - 1)
    n = (b - a + 1).clamp(min=0).long()
    a = a.long()
    # y centre index yi lies on row S - 1 - yi
    return a[..., 0], n[..., 0], S - 1 - (a[..., 1] + n[..., 1] - 1), \
        n[..., 1]


def count_pairs(xy, image_size, margin):
    """The gated (pixel, face) pairs of every face of xy [B, F, 3, 2]."""
    _, nx, _, ny = pair_ranges(xy, image_size, margin)
    return float((nx * ny).sum())


def _blocks(counts):
    """Contiguous ranges [s, e) of the flat face index whose pairs sum to at
    most BLOCK (a face alone may pass it)."""
    ends = torch.cumsum(counts, 0).tolist()
    out, s, base = [], 0, 0
    for i, end in enumerate(ends):
        if end - base > BLOCK and i > s:
            out.append((s, i))
            s, base = i, ends[i - 1]
    out.append((s, len(ends)))
    return out


def _pairs(ranges, s, e, F, S):
    """The pairs of flat faces [s, e): (flat face index, flat pixel index
    b * S * S + row * S + column, column, row)."""
    x0, nx, y0, ny = (r.reshape(-1)[s:e] for r in ranges)
    c = nx * ny
    dev = c.device
    face = torch.repeat_interleave(torch.arange(s, e, device=dev), c)
    start = torch.cumsum(c, 0) - c
    off = torch.arange(int(c.sum()), device=dev) - \
        torch.repeat_interleave(start, c)
    k = face - s
    col = x0[k] + off % nx[k]
    row = y0[k] + off // nx[k]
    return face, (face // F) * S * S + row * S + col, col, row


def _coverage(v, col, row, S, dist, tau, thr):
    """The coverage of pairs: v [n, 3, 2] the face's vertices, col / row
    the pixel's indices; heaviside: 1 inside or on the face."""
    dt = v.dtype
    px = ((2 * col + 1 - S).to(dt) / S)
    py = ((S - 1 - 2 * row).to(dt) / S)
    x = v[..., 0] - px[:, None]
    y = v[..., 1] - py[:, None]
    # twice the signed areas of the sub-triangles opposite each vertex
    e = [x[:, 1] * y[:, 2] - x[:, 2] * y[:, 1],
         x[:, 2] * y[:, 0] - x[:, 0] * y[:, 2],
         x[:, 0] * y[:, 1] - x[:, 1] * y[:, 0]]
    area = e[0] + e[1] + e[2]
    inside = (e[0] * area > 0) & (e[1] * area > 0) & (e[2] * area > 0)
    on = (e[0] * area >= 0) & (e[1] * area >= 0) & (e[2] * area >= 0) \
        & (area != 0)
    if dist == 'heaviside':
        return on.to(dt)
    d2 = None
    for k in range(3):
        ax, ay = x[:, k], y[:, k]
        dx, dy = x[:, (k + 1) % 3] - ax, y[:, (k + 1) % 3] - ay
        t = (-(ax * dx + ay * dy)) / torch.clamp(dx * dx + dy * dy,
                                                 min=1e-30)
        t = torch.clamp(t, 0.0, 1.0)
        qx, qy = ax + t * dx, ay + t * dy
        dk = qx * qx + qy * qy
        d2 = dk if d2 is None else torch.minimum(d2, dk)
    dis = torch.sqrt(torch.clamp(d2, min=1e-30))
    u = torch.where(inside, dis, -dis) / tau
    if dist == 'logistic':
        p = torch.sigmoid(u)
    elif dist == 'uniform':
        p = torch.clamp(0.5 * u + 0.5, 0.0, 1.0)
    else:
        raise ValueError(dist)
    keep = (inside | (d2 < thr)) & (p > 1e-6)
    return torch.where(keep, p, torch.zeros_like(p))


class _Render:
    def __init__(self, S, dist, tau, dist_eps):
        self.S, self.dist, self.tau = S, dist, tau
        self.thr = dist_eps * tau
        self.margin = cull_margin(dist, tau, dist_eps)

    def walk(self, xy):
        """Yields each block's (flat face index, flat pixel index, column,
        row, faces' vertices [n, 3, 2])."""
        B, F = xy.shape[:2]
        ranges = pair_ranges(xy, self.S, self.margin)
        counts = (ranges[1] * ranges[3]).reshape(-1)
        flat = xy.reshape(B * F, 3, 2)
        for s, e in _blocks(counts):
            face, pix, col, row = _pairs(ranges, s, e, F, self.S)
            yield face, pix, col, row, flat[face]

    def alpha(self, xy):
        """alpha [B, S, S]: hard, the union of the faces; soft, the
        probabilistic fold."""
        B = xy.shape[0]
        P = self.S * self.S
        if self.dist == 'heaviside':
            hits = torch.zeros(B * P, dtype=xy.dtype, device=xy.device)
            for _, pix, col, row, v in self.walk(xy):
                p = _coverage(v, col, row, self.S, self.dist, self.tau,
                              self.thr)
                hits.index_add_(0, pix, p)
            return (hits > 0).to(xy.dtype).reshape(B, self.S, self.S)
        logq = torch.zeros(B * P, dtype=xy.dtype, device=xy.device)
        for _, pix, col, row, v in self.walk(xy):
            p = _coverage(v, col, row, self.S, self.dist, self.tau,
                          self.thr)
            logq.index_add_(0, pix, torch.log1p(-p))
        return (1.0 - torch.exp(logq)).reshape(B, self.S, self.S)

    def grad(self, xy, alpha, g_alpha):
        """d(sum g_alpha * alpha) / d xy, block by block."""
        out = torch.zeros_like(xy).reshape(-1, 3, 2)
        q = (1.0 - alpha).reshape(-1)
        g = g_alpha.reshape(-1)
        for face, pix, col, row, v in self.walk(xy.detach()):
            v = v.detach().requires_grad_(True)
            with torch.enable_grad():
                p = _coverage(v, col, row, self.S, self.dist, self.tau,
                              self.thr)
                coef = g[pix] * q[pix] / torch.clamp(1.0 - p.detach(),
                                                     min=1e-6)
                gv, = torch.autograd.grad((coef * p).sum(), v)
            out.index_add_(0, face, gv)
        return out.reshape(xy.shape)


class _SoftAlpha(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xy, r):
        alpha = r.alpha(xy)
        ctx.r = r
        ctx.save_for_backward(xy, alpha)
        return alpha

    @staticmethod
    def backward(ctx, g):
        xy, alpha = ctx.saved_tensors
        return ctx.r.grad(xy, alpha, g), None


def soft_alpha(xy, S, dist, tau, dist_eps):
    """GenDR's alpha [B, S, S] of faces xy [B, F, 3, 2], differentiable."""
    return _SoftAlpha.apply(xy, _Render(S, dist, tau, dist_eps))


def hard_alpha(xy, S):
    """The union of the faces xy [B, F, 3, 2] (heaviside CDF, hard alpha):
    1 where a pixel centre lies inside or on a face."""
    return _Render(S, 'heaviside', 1.0, 0.0).alpha(xy.detach())


def face_xy(vertices, faces):
    """[B, F, 3, 2]: the screen-space x, y of each face's vertices."""
    return vertices[:, faces, :2]
