"""Plain reference of the textured fit (the program's
``experiments.fit_textured``): upstream opt_shape.py's sphere template and
sigmoid displacement with a sigmoid-parametrized surface texture, lit by
ambient + directional light, seen from a view set by look_at and
perspective, rendered by GenDR at its constructor's defaults (uniform CDF,
probabilistic t-conorm, softmax RGB over surface textures) at twice the
output size and pooled, the IoU of the alpha plus the mean squared error
of the RGB plus the Laplacian and flatten terms, and Adam.  It imports
nothing of the program; ``follow`` takes what the benchmark hands both
sides (the template, the goal mesh and its texel colours, the eyes, the
starting parameters and the settings) and works out the goal images
itself.

Float32 with TF32 off, or ``dtype`` (the control).  The semantics are
upstream's as SURVEY.md records them (generalized_renderer_cuda_kernel.cu,
"cu"):

* alpha: ``raster.soft_alpha``, the probabilistic fold of the pairs'
  coverage;
* a gated pair with coverage above 1e-6 takes part in the RGB where its
  face is front-facing (unless double_side) and its perspective-correct
  depth zp = 1 / sum_k(w_k / z_k) lies in [near, far] (cu:807-810,
  824), w the barycentrics clamped to [0, 1] and divided by their sum (at
  least 1e-5; cu:67-72) after the determinant's clamp to +-1e-10
  (cu:653);
* its colour is the texel of the R x R grid folded into two triangles
  that w selects (cu:178-185), the fold's test taken in exact arithmetic:
  beyond the edge opposite vertex 2 it picks the lower triangle;
* the depth softmax (cu:728-738, 824-839, 855-861): the background starts
  the sum at exp(eps / gamma) with the running max at eps, so with
  zn = (far - zp) / (far - near) a pixel's RGB is
  (bg e^(2 eps / gamma) + sum p c e^(zn / gamma)) /
  (e^(2 eps / gamma) + sum p e^(zn / gamma)), here with every exponent
  taken from the pixel's largest;
* gradients by autograd: the clipped barycentrics (so the texel and the
  depth's weights) are constants of the backward, so a vertex's x and y
  take the coverage's gradient and its z the depth's (cu:1026-1052).

Pairs are walked in ``raster``'s blocks; the RGB's backward recomputes each
block under autograd from the pixels' sums, so memory holds one block's
graph at a time."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import geometry as G
from benchmark.reference import raster as R
from benchmark.reference import recon
from benchmark.reference.adam import Adam

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

VIEWING_ANGLE = 15.0
# Lighting()'s defaults: ambient 0.5, one directional light 0.5 along +y,
# both white
AMBIENT, DIRECTIONAL, DIRECTION = 0.5, 0.5, (0.0, 1.0, 0.0)


def shape_vertices(base, displace, center):
    """opt_shape.py's ShapeModel: the template base [nv, 3] (the unit
    sphere halved) moved in logit space by displace [1, nv, 3], squashed
    back by a sigmoid and shifted toward tanh(center [1, 1, 3])."""
    b = base[None]
    logit = torch.log(b.abs() / (1 - b.abs()))
    c = torch.tanh(center)
    v = torch.sigmoid(logit + displace) * torch.sign(b)
    v = F.relu(v) * (1 - c) - F.relu(-v) * (c + 1)
    return v + c


def surface_normals(v, faces):
    """Unit normals [B, nf, 3] of cross(v2 - v1, v0 - v1) (gendr's
    mesh.surface_normals), the norm at least 1e-6."""
    fv = v[:, faces]
    n = G._cross(fv[:, :, 2] - fv[:, :, 1], fv[:, :, 0] - fv[:, :, 1])
    return n / torch.clamp(torch.sqrt((n * n).sum(-1, keepdim=True)),
                           min=1e-6)


def light(textures, v, faces):
    """Surface textures [B, nf, TS, 3] lit by ambient + directional light
    on the faces' normals (lighting.py:49-55)."""
    d = torch.as_tensor(DIRECTION, dtype=v.dtype, device=v.device)
    cos = F.relu((surface_normals(v, faces) * d).sum(-1))
    return textures * (AMBIENT + DIRECTIONAL * cos)[:, :, None, None]


def screen_faces(v, faces, eyes):
    """The faces' screen-space vertices [B, nf, 3, 3] (x, y in NDC and the
    camera's z) of v [1, nv, 3] seen from eyes [B, 3]."""
    x = v.expand(eyes.shape[0], -1, -1)
    return G.perspective(G.look_at(x, eyes), VIEWING_ANGLE)[:, faces]


def fold_texel(w, R_):
    """The texel of an R x R grid folded into two triangles that the
    clipped barycentrics w [n, 3] select (cu:178-185), in [0, R^2 - 1]:
    the lower triangle's where (w0 + w1) R - floor(w0 R) - floor(w1 R) is at
    most 1.  Beyond the edge opposite vertex 2 (w2 clipped to 0) w0 + w1 is
    1 and the test reads exactly 1, whatever the last bit of a float sum."""
    w0, w1 = w[:, 0], w[:, 1]
    wx = torch.floor(w0 * R_)
    wy = torch.floor(w1 * R_)
    lower = (w[:, 2] == 0) | ((w0 + w1) * R_ - wx - wy <= 1.0)
    idx = torch.where(lower, wy * R_ + wx,
                      (R_ - 1 - wy) * R_ + (R_ - 1 - wx))
    return torch.clamp(idx, 0, R_ * R_ - 1).long()


def clipped_barycentrics(v, col, row, S):
    """w [n, 3] of the pixel centres in the faces v [n, 3, 2]: the
    barycentrics with the determinant at least 1e-10 in size, each clamped
    to [0, 1], over their sum (at least 1e-5)."""
    dt = v.dtype
    px = (2 * col + 1 - S).to(dt) / S
    py = (S - 1 - 2 * row).to(dt) / S
    x = v[..., 0] - px[:, None]
    y = v[..., 1] - py[:, None]
    e = torch.stack([x[:, 1] * y[:, 2] - x[:, 2] * y[:, 1],
                     x[:, 2] * y[:, 0] - x[:, 0] * y[:, 2],
                     x[:, 0] * y[:, 1] - x[:, 1] * y[:, 0]], -1)
    det = e.sum(-1, keepdim=True)
    det = torch.where(det > 0, torch.clamp(det, min=1e-10),
                      torch.clamp(det, max=-1e-10))
    w = torch.clamp(e / det, 0.0, 1.0)
    return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-5)


class _Softmax:
    """The depth softmax of one render: S the render's size, the renderer's
    settings in cfg, TS texels a face."""

    def __init__(self, S, cfg, TS):
        self.S = S
        self.tau, self.eps = cfg['dist_scale'], cfg['aggr_rgb_eps']
        self.gamma = cfg['aggr_rgb_gamma']
        self.near, self.far = cfg['near'], cfg['far']
        self.double_side = cfg['double_side']
        self.R = round(TS ** 0.5)
        self.raster = R._Render(S, cfg['dist_func'], self.tau,
                                cfg['dist_eps'])

    def pairs(self, xyz, tex, logit_max=None):
        """Per block of gated pairs: (flat pixel index, whether the pair
        takes part in the RGB, its logit zn / gamma less the pixel's
        logit_max (the logit itself where None), coverage, colour [n, 3]),
        differentiable in xyz [B, nf, 3, 3] and tex [B, nf, TS, 3]."""
        flat, flat_tex = xyz.reshape(-1, 3, 3), tex.reshape(-1, *tex.shape[2:])
        for face, pix, col, row, _ in self.raster.walk(
                xyz[..., :2].detach()):
            v = flat[face]
            p = R._coverage(v[..., :2], col, row, self.S, 'uniform',
                            self.tau, self.raster.thr)
            vd = v.detach()
            w = clipped_barycentrics(vd[..., :2], col, row, self.S)
            zp = (1.0 / (w / vd[..., 2]).sum(-1))
            ok = (p.detach() > 0) & (zp >= self.near) & (zp <= self.far)
            if not self.double_side:
                x, y = vd[..., 0], vd[..., 1]
                ok &= ((y[:, 2] - y[:, 0]) * (x[:, 1] - x[:, 0])
                       < (y[:, 1] - y[:, 0]) * (x[:, 2] - x[:, 0]))
            # the depth's gradient reaches z alone
            denom = torch.where(ok, (w / v[..., 2]).sum(-1), 1.0)
            logit = (self.far - 1.0 / denom) / (self.far - self.near) \
                / self.gamma
            if logit_max is not None:
                logit = torch.where(ok, logit - logit_max[pix], 0.0)
            c = flat_tex[face, fold_texel(w, self.R)]
            yield pix, ok, logit, p, c

    def logit_max(self, xyz, tex):
        """Per pixel the largest logit: the background's 2 eps / gamma or a
        taking pair's."""
        B = xyz.shape[0]
        out = torch.full((B * self.S * self.S,), 2 * self.eps / self.gamma,
                         dtype=xyz.dtype, device=xyz.device)
        for pix, ok, logit, _, _ in self.pairs(xyz, tex):
            out.scatter_reduce_(0, pix[ok], logit[ok], 'amax')
        return out

    @staticmethod
    def terms(ok, logit, p, c):
        e = torch.where(ok, p * torch.exp(logit), 0.0)
        return e, e[:, None] * c

    def sums(self, xyz, tex, m):
        """Per pixel sum p e^(zn / gamma - m) and that weighted by the
        colours [n, 3]."""
        n = xyz.shape[0] * self.S * self.S
        s = torch.zeros(n, dtype=xyz.dtype, device=xyz.device)
        c = torch.zeros((n, 3), dtype=xyz.dtype, device=xyz.device)
        for pix, ok, logit, p, col in self.pairs(xyz, tex, m):
            e, ec = self.terms(ok, logit, p, col)
            s.index_add_(0, pix, e)
            c.index_add_(0, pix, ec)
        return s, c

    def grad(self, xyz, tex, m, gs, gc):
        """The gradients of sum(gs * s + gc * c) in xyz and tex, block by
        block."""
        gx, gt = torch.zeros_like(xyz), torch.zeros_like(tex)
        xyz = xyz.detach().requires_grad_(True)
        tex = tex.detach().requires_grad_(True)
        with torch.enable_grad():
            for pix, ok, logit, p, col in self.pairs(xyz, tex, m):
                e, ec = self.terms(ok, logit, p, col)
                a, b = torch.autograd.grad(
                    (gs[pix] * e).sum() + (gc[pix] * ec).sum(), [xyz, tex],
                    allow_unused=True)
                if a is not None:
                    gx += a
                if b is not None:
                    gt += b
        return gx, gt


class _Sums(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xyz, tex, soft):
        m = soft.logit_max(xyz, tex)
        s, c = soft.sums(xyz, tex, m)
        ctx.soft = soft
        ctx.save_for_backward(xyz, tex, m)
        ctx.mark_non_differentiable(m)
        return s, c, m

    @staticmethod
    def backward(ctx, gs, gc, _):
        xyz, tex, m = ctx.saved_tensors
        return (*ctx.soft.grad(xyz, tex, m, gs, gc), None)


def render(xyz, tex, cfg):
    """RGBA [B, 4, image_size, image_size] of faces xyz [B, nf, 3, 3] with
    surface textures tex [B, nf, TS, 3]: rendered at twice image_size
    where cfg asks for anti-aliasing and pooled 2 x 2."""
    S = cfg['image_size'] * (2 if cfg['anti_aliasing'] else 1)
    B = xyz.shape[0]
    alpha = R.soft_alpha(xyz[..., :2], S, cfg['dist_func'], cfg['dist_scale'],
                         cfg['dist_eps'])
    s, c, m = _Sums.apply(xyz, tex, _Softmax(S, cfg, tex.shape[2]))
    bg_w = torch.exp(2 * cfg['aggr_rgb_eps'] / cfg['aggr_rgb_gamma'] - m)
    bg = torch.as_tensor(cfg['background_color'], dtype=xyz.dtype,
                         device=xyz.device)
    rgb = (c + bg * bg_w[:, None]) / (s + bg_w)[:, None]
    img = torch.cat([rgb.reshape(B, S, S, 3).permute(0, 3, 1, 2),
                     alpha[:, None]], 1)
    return F.avg_pool2d(img, 2) if cfg['anti_aliasing'] else img


def iou_loss_mean(pred, target):
    inter = (pred * target).sum((1, 2))
    union = (pred + target - pred * target).sum((1, 2)) + 1e-6
    return (1.0 - inter / union).mean()


def goal_images(goal_v, goal_f, goal_tex, eyes, cfg, device,
                dtype=torch.float32):
    """The targets: the goal mesh (vertices [nv, 3], faces [nf, 3], texel
    colours [nf, TS, 3]) lit and rendered from eyes [B, 3]."""
    v = torch.as_tensor(goal_v, device=device, dtype=dtype)[None]
    f = torch.as_tensor(goal_f, device=device, dtype=torch.long)
    tex = light(torch.as_tensor(goal_tex, device=device, dtype=dtype)[None],
                v, f)
    eyes = torch.as_tensor(eyes, device=device, dtype=dtype)
    with torch.no_grad():
        return render(screen_faces(v, f, eyes),
                      tex.expand(eyes.shape[0], -1, -1, -1), cfg)


def loss(params, base, faces, eyes, targets, cfg):
    """One step's loss of the parameters {'displace', 'center',
    'texture'}; faces as numpy."""
    f = torch.as_tensor(faces, device=base.device, dtype=torch.long)
    v = shape_vertices(base, params['displace'], params['center'])
    lit = light(torch.sigmoid(params['texture']), v, f)
    img = render(screen_faces(v, f, eyes),
                 lit.expand(eyes.shape[0], -1, -1, -1), cfg)
    # the reconstruction's regularizers count each vertex's neighbours in
    # float32
    v32 = v.float()
    return iou_loss_mean(img[:, 3], targets[:, 3]) \
        + ((img[:, :3] - targets[:, :3]) ** 2).mean() \
        + (cfg['lambda_laplacian'] * recon.laplacian(v32, faces).mean()
           + cfg['lambda_flatten'] * recon.flatten(v32, faces).mean()
           ).to(v.dtype)


def follow(template, goal, eyes, start, cfg, steps, device,
           dtype=torch.float32):
    """Steps of the fit from the parameters start {'displace' [1, nv, 3],
    'center' [1, 1, 3], 'texture' [1, nf, TS, 3]}: dict(losses [steps],
    grads {name: the first step's gradient}, change {name: after
    ``steps``}), computed in dtype.  template: (vertices [nv, 3], faces
    [nf, 3]) of the unit sphere; goal: (vertices, faces, texel colours)."""
    v0, faces = template
    base = torch.as_tensor(v0, device=device, dtype=dtype) * 0.5
    targets = goal_images(*goal, eyes, cfg, device, dtype)
    eyes = torch.as_tensor(eyes, device=device, dtype=dtype)
    names = ('displace', 'center', 'texture')
    P = {k: torch.as_tensor(start[k], device=device, dtype=dtype).clone()
         for k in names}
    opt = Adam([P[k] for k in names], cfg['learning_rate'],
               tuple(cfg['betas']))
    losses, first = [], None
    for _ in range(steps):
        leaves = {k: P[k].detach().requires_grad_(True) for k in names}
        value = loss(leaves, base, faces, eyes, targets, cfg)
        g = torch.autograd.grad(value, [leaves[k] for k in names])
        losses.append(float(value.detach()))
        first = g if first is None else first
        opt.step(g)
    return dict(losses=losses,
                grads={k: gk.float() for k, gk in zip(names, first)},
                change={k: (P[k] - torch.as_tensor(
                    start[k], device=device, dtype=dtype)).float()
                    for k in names})
