"""Plain reference of the reconstruction's training step (the published
train_reconstruction.py): the encoder (three 5x5 stride-2 convolutions
with batch normalisation and ReLU, three ReLU linear layers), the
template-sphere decoder, the silhouettes of the two view sets, the IoU,
Laplacian and flatten losses, and Adam.  It imports nothing of the
program.  ``follow`` takes what the benchmark hands both sides (the
weights, the template, the training images and the batches' image ids)
and works out the cameras of each view itself.  ``dataset_images`` makes
the training images: the synthetic stand-in for ShapeNet's 13 classes.

Convolutions and matrix products run in float32 with TF32 off, unless
``tf32`` asks for the lower precision (the control)."""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import geometry as G
from benchmark.reference import raster as R
from benchmark.reference.adam import Adam

VIEWS = 24
DISTANCE, ELEVATION, VIEWING_ANGLE = 2.732, 30.0, 15.0


def param_shapes(cfg, nv):
    """[(name, shape)] of the encoder's and decoder's parameters."""
    e, d = cfg['encoder'], cfg['decoder']
    widths = [4] + e['conv_widths']
    out = []
    size = cfg['image_size']
    for i, (cin, cout) in enumerate(zip(widths[:-1], widths[1:])):
        out += [(f'encoder.convs.{i}.weight', (cout, cin, 5, 5)),
                (f'encoder.convs.{i}.bias', (cout,))]
        size = (size - 1) // 2 + 1
    for i, c in enumerate(e['conv_widths']):
        out += [(f'encoder.bns.{i}.weight', (c,)),
                (f'encoder.bns.{i}.bias', (c,))]
    dims = [widths[-1] * size * size] + e['dims']
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        out += [(f'encoder.fcs.{i}.weight', (b, a)),
                (f'encoder.fcs.{i}.bias', (b,))]
    w1, w2 = d['widths']
    for name, a, b in (('fc1', dims[-1], w1), ('fc2', w1, w2),
                       ('fc_centroid', w2, 3), ('fc_displace', w2, 3 * nv)):
        out += [(f'decoder.{name}.weight', (b, a)),
                (f'decoder.{name}.bias', (b,))]
    return out


def init_weights(shapes, seed, device):
    """The weights of a run, on the device from the seed in a few large
    calls: every weight matrix and kernel from one normal truncated at two
    standard deviations, scaled to variance 1 / fan_in (flax's LeCun
    normal); biases 0; batch normalisation's scale 1."""
    mats = [(n, s) for n, s in shapes
            if n.endswith('weight') and '.bns.' not in n]
    total = sum(math.prod(s) for _, s in mats)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.empty(total, device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    out, o = {}, 0
    for name, shape in shapes:
        if (name, shape) in mats:
            n = math.prod(shape)
            std = math.sqrt(1.0 / math.prod(shape[1:])) / 0.87962566103423978
            out[name] = (flat[o:o + n] * std).reshape(shape)
            o += n
        elif '.bns.' in name and name.endswith('weight'):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def _bn(x, w, b, eps=1e-5):
    """Batch normalisation in training: the batch's moments E[x] and
    E[x^2] - E[x]^2 (biased, at least 0) over all but the channels."""
    mean = x.mean((0, 2, 3))
    var = torch.clamp((x * x).mean((0, 2, 3)) - mean * mean, min=0.0)
    return (x - mean[None, :, None, None]) \
        * (torch.rsqrt(var + eps) * w)[None, :, None, None] \
        + b[None, :, None, None]


def encode(W, x):
    i = 0
    while f'encoder.convs.{i}.weight' in W:
        x = F.conv2d(x, W[f'encoder.convs.{i}.weight'],
                     W[f'encoder.convs.{i}.bias'], stride=2, padding=2)
        x = F.relu(_bn(x, W[f'encoder.bns.{i}.weight'],
                       W[f'encoder.bns.{i}.bias']))
        i += 1
    x = x.reshape(x.shape[0], -1)
    i = 0
    while f'encoder.fcs.{i}.weight' in W:
        x = F.relu(F.linear(x, W[f'encoder.fcs.{i}.weight'],
                            W[f'encoder.fcs.{i}.bias']))
        i += 1
    return x


def decode(W, h, template):
    """Vertices [B, nv, 3]: the template's coordinates (halved) moved in
    logit space by a predicted displacement and squashed back by a
    sigmoid, then squeezed toward a predicted centroid shift."""
    t = template * 0.5
    logits = torch.log(t.abs() / (1.0 - t.abs()))
    h = F.relu(F.linear(h, W['decoder.fc1.weight'], W['decoder.fc1.bias']))
    h = F.relu(F.linear(h, W['decoder.fc2.weight'], W['decoder.fc2.bias']))
    centroid = torch.tanh(F.linear(h, W['decoder.fc_centroid.weight'],
                                   W['decoder.fc_centroid.bias'])
                          * 0.1)[:, None, :]
    displace = F.linear(h, W['decoder.fc_displace.weight'],
                        W['decoder.fc_displace.bias']).reshape(
                            h.shape[0], -1, 3)
    v = torch.sigmoid(logits + displace) * torch.sign(t)
    v = F.relu(v) * (1.0 - centroid) - F.relu(-v) * (1.0 + centroid)
    return (v + centroid) * 0.5


def _edges(faces, pairs):
    return sorted({(min(int(f[i]), int(f[j])), max(int(f[i]), int(f[j])))
                   for f in faces for i, j in pairs})


def laplacian(x, faces):
    """Per batch element: the sum of squares of x minus the mean of each
    vertex's neighbours (the uniform graph Laplacian)."""
    e = torch.as_tensor(_edges(faces, ((0, 1), (1, 2), (0, 2))),
                        device=x.device)
    rows = torch.cat([e[:, 0], e[:, 1]])
    cols = torch.cat([e[:, 1], e[:, 0]])
    nb = torch.zeros_like(x).index_add_(1, rows, x[:, cols])
    deg = torch.zeros(x.shape[1], device=x.device).index_add_(
        0, rows, torch.ones_like(rows, dtype=x.dtype))
    lap = x - nb / torch.clamp(deg, min=1.0)[None, :, None]
    return (lap ** 2).sum((1, 2))


def flatten(v, faces, eps=1e-6):
    """Per batch element: (cos(dihedral) + 1)^2 summed over the edges that
    are a face's (v0, v1) or (v1, v2), each with the opposite vertices of
    the first two faces holding it."""
    edges = _edges(faces, ((0, 1), (1, 2)))
    opp = {e: [] for e in edges}
    for a, b, c in (map(int, f) for f in faces):
        for e, o in (((min(a, b), max(a, b)), c), ((min(b, c), max(b, c)), a),
                     ((min(a, c), max(a, c)), b)):
            if e in opp:
                opp[e].append(o)
    q = torch.as_tensor([(u, w, o[0], o[1]) for (u, w), o in opp.items()
                         if len(o) >= 2], device=v.device)
    v0, v1, v2, v3 = (v[:, q[:, i]] for i in range(4))
    a = v1 - v0
    a2 = (a * a).sum(-1)
    alen = torch.sqrt(a2 + eps)

    def rejection(w):
        w = w - v0
        wlen = torch.sqrt((w * w).sum(-1) + eps)
        proj = (a * w).sum(-1)
        cos = proj / (alen * wlen + eps)
        sin = torch.sqrt(1 - cos ** 2 + eps)
        return w - a * (proj / (a2 + eps))[..., None], wlen * sin

    r2, l2 = rejection(v2)
    r3, l3 = rejection(v3)
    cos_d = (r2 * r3).sum(-1) / (l2 * l3 + eps)
    return ((cos_d + 1) ** 2).sum(1)


def iou_loss_mean(pred, target):
    inter = (pred * target).sum((1, 2))
    union = (pred + target - pred * target).sum((1, 2)) + 1e-6
    return (1.0 - inter / union).mean()


def eyes(view_ids, device):
    n = len(view_ids)
    return G.points_from_angles(
        torch.full((n,), DISTANCE, device=device),
        torch.full((n,), ELEVATION, device=device),
        -torch.as_tensor(np.asarray(view_ids, np.float32), device=device)
        * 15)


def screen(vertices, eye):
    return G.perspective(G.look_at(vertices, eye), VIEWING_ANGLE)


def dataset_images(dataset, device):
    """The training images of the synthetic stand-in for ShapeNet, uint8
    [classes x objects x 24, 4, S, S] on the device (the silhouette in every
    channel, 0 or 255), image id (object x 24 + view): each class's objects
    drawn from one stream seeded by the seed, in class order, on the level-2
    icosphere, seen from the dataset's 24 cameras (distance 2.732,
    elevation 30, azimuth -15 x view, viewing angle 15), heaviside CDF and
    hard alpha."""
    v2, f2 = G.icosphere(2)
    rng = np.random.RandomState(dataset['seed'])
    shapes = np.stack([G.synthetic_shape(rng, c, v2)
                       for c in dataset['classes']
                       for _ in range(dataset['objects'])])
    n = len(shapes)
    verts = torch.as_tensor(shapes, device=device).repeat_interleave(VIEWS,
                                                                     0)
    xy = R.face_xy(screen(verts, eyes(np.tile(np.arange(VIEWS), n), device)),
                   torch.as_tensor(f2, device=device, dtype=torch.long))
    sil = R.hard_alpha(xy, dataset['image_size'])
    return (sil * 255).to(torch.uint8)[:, None].repeat(1, 4, 1, 1)


@contextlib.contextmanager
def _precision(tf32):
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _step(W, names, ids, data, template, faces, faces_t, cfg, device,
          pairs):
    """One step's (loss, gradient of every leaf of names, gated pairs of
    its render: counted where pairs is None)."""
    S = cfg['image_size']
    images = data[torch.as_tensor(ids.reshape(-1), device=device)] \
        .float() / 255.
    tgt = list(images[:, 3].chunk(2))
    e = [eyes(row % VIEWS, device) for row in ids]
    v = decode(W, encode(W, images), template)
    reg = cfg['lambda_laplacian'] * laplacian(v, faces).mean() \
        + cfg['lambda_flatten'] * flatten(v, faces).mean()
    xy = R.face_xy(screen(torch.cat([v, v]),
                          torch.cat([e[0], e[0], e[1], e[1]])), faces_t)
    if pairs is None:
        pairs = R.count_pairs(xy, S, R.cull_margin(
            cfg['dist_func'], cfg['dist_scale'], cfg['dist_eps']))
    sils = R.soft_alpha(xy, S, cfg['dist_func'], cfg['dist_scale'],
                        cfg['dist_eps'])
    raa, rba, rab, rbb = sils.chunk(4)
    loss = (iou_loss_mean(raa, tgt[0]) + iou_loss_mean(rba, tgt[0])
            + iou_loss_mean(rab, tgt[1]) + iou_loss_mean(rbb, tgt[1])) / 4 \
        + reg
    return loss, torch.autograd.grad(loss, [W[k] for k in names]), pairs


def follow(W0, template, faces, data, batches, cfg, device, tf32=False):
    """The steps of ``batches`` (each [2, B] ids of images of data: the
    first and second view set) from weights W0: dict(losses, grads {name:
    the first step's gradient}, change {name: after the last step}, pairs
    (the gated pairs of the first step's render))."""
    W = {k: v.detach().clone().requires_grad_(True) for k, v in W0.items()}
    names = list(W)
    opt = Adam([W[k] for k in names], cfg['learning_rate'])
    template = torch.as_tensor(template, device=device)
    faces_t = torch.as_tensor(faces, device=device, dtype=torch.long)
    losses, grads, pairs = [], None, None
    for ids in batches:
        with _precision(tf32):
            loss, g, pairs = _step(W, names, np.asarray(ids), data, template,
                                   faces, faces_t, cfg, device, pairs)
        losses.append(float(loss.detach()))
        if grads is None:
            grads = {k: gk.detach() for k, gk in zip(names, g)}
        opt.step(g)
    change = {k: (W[k] - W0[k]).detach() for k in names}
    return dict(losses=losses, grads=grads, change=change, pairs=pairs)
