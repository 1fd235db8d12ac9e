"""Rendering across processes over ``torch.distributed``: data-parallel
batch (dp), face-parallel (fp) and pixel-parallel (sp).

Port of ``gendr_tpu/parallel/sharding.py``.  Each rank of the default
process group is one device; :func:`make_mesh` lays the ranks out over
named axes and makes a process group per axis.

* **dp** splits the batch of views: each rank passes its own shard
  (:func:`shard_batch`), the render needs no communication, and the caller
  averages the model's gradient over dp (:func:`train_step`), as XLA's
  inserted all-reduce does in the JAX package.
* **fp** splits the faces: the face axis is padded to a multiple of
  ``n_fp x face_chunk`` (``fvalid`` marks the padding), each rank folds its
  slice into a partial aggregation carry (``cuda_backend.forward_partial``:
  the forward kernel with no background fold, K1e; or
  ``torch_backend.forward_carry``), the carries are all-gathered over fp
  and folded in shard order after the background state.  Hard-RGB winner
  ids carry the slice's ``base_offset``, so they are global.
* **sp** splits the image rows: each rank renders a band of rows (NDC stays
  global, so a band is the same rows of a full render) and the bands are
  all-gathered over sp; the backward sums each band's gradient and
  all-reduces the sum over sp.

Every rank returns the same full ``[B_dp, 4, H, W]`` image, and the
gradient of :func:`make_sharded_render`'s render equals the unsharded
render's on every rank.  The collectives use the process group's backend:
NCCL across cards; on one card several ranks cannot share an NCCL
communicator, so they run gloo, which takes CUDA tensors and stages them
through the host.  The Mosaic gates of the JAX module (``_xla_fallback``,
``_tiles_feasible``, ``_align_fc``) have no counterpart: the kernels take
any band and chunk.

    mesh = make_mesh({'dp': 2, 'fp': 2, 'sp': 2})   # in every rank
    img = render_sharded(fv_shard, tex_shard, cfg, params, mesh, sp_axis='sp')
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from gendr_tpu_torch import config as C
from gendr_tpu_torch import data
from gendr_tpu_torch.device import resolve_device
from gendr_tpu_torch.geometry import core, transforms as T
from gendr_tpu_torch.raster import cuda_backend as CB
from gendr_tpu_torch.raster import torch_backend as TB

# the time this process spent in this module's collectives: seconds of
# those already read, and (start, end) CUDA events of those on CUDA tensors
# not read yet (collective_seconds)
_COLLECTIVE_TIME = {'seconds': 0.0, 'events': []}


class ProcessMesh:
    """The default group's ranks laid out row-major over named axes (the
    first axis slowest), with a process group per axis of more than one
    rank.  ``shape[axis]`` is the axis's size, ``coord[axis]`` this rank's
    index on it, ``groups[axis]`` the group of the ranks that differ from
    this one on that axis alone (ordered by their index on it)."""

    def __init__(self, axes: Dict[str, int]):
        names, sizes = list(axes), [int(n) for n in axes.values()]
        world, rank = dist.get_world_size(), dist.get_rank()
        if int(np.prod(sizes)) != world:
            raise ValueError(f'mesh {axes} needs {int(np.prod(sizes))} '
                             f'ranks, the default group has {world}')
        self.shape = dict(zip(names, sizes))
        self.coord = dict(zip(names, (int(i) for i in
                                      np.unravel_index(rank, sizes))))
        self.groups = {}
        grid = np.arange(world).reshape(sizes)
        for a, name in enumerate(names):
            self.groups[name] = None
            if sizes[a] == 1:
                continue
            # new_group is collective over the world: every rank makes
            # every line's group, in the same order
            for line in np.moveaxis(grid, a, -1).reshape(-1, sizes[a]):
                group = dist.new_group([int(r) for r in line])
                if rank in line:
                    self.groups[name] = group

    def size(self, axis: Optional[str]) -> int:
        return self.shape.get(axis, 1) if axis else 1

    def index(self, axis: Optional[str]) -> int:
        return self.coord.get(axis, 0) if axis else 0


def make_mesh(axes: Dict[str, int]) -> ProcessMesh:
    """A mesh over the initialised default group from an axis-name -> size
    dict, e.g. {'dp': 2, 'fp': 4}; the sizes' product must be the world
    size.  Every rank calls it, in the same order as any other mesh."""
    return ProcessMesh(axes)


def shard_batch(tree, mesh: ProcessMesh, axis: str = 'dp'):
    """This rank's slice of the leading (batch) axis of a tensor, or of each
    tensor of a tuple or list, over ``axis``."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(shard_batch(v, mesh, axis) for v in tree)
    n, i = mesh.size(axis), mesh.index(axis)
    if tree.shape[0] % n:
        raise ValueError(f'batch {tree.shape[0]} does not split over '
                         f'{n} ranks of {axis!r}')
    b = tree.shape[0] // n
    return tree[i * b:(i + 1) * b]


def spawn_ranks(fn, nprocs, args=(), timeout=None):
    """Run fn(rank, *args) in nprocs fresh processes and wait for all of
    them: the ``spawn`` start method, since a process that has initialised
    CUDA cannot fork.  Raises if a rank fails or the ranks outlast
    ``timeout`` seconds, and stops every rank either way.  Each rank
    initialises its own process group (``dist.init_process_group``)."""
    import torch.multiprocessing as mp
    ctx = mp.spawn(fn, args=args, nprocs=nprocs, join=False)
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        # join returns False while some rank still runs
        while not ctx.join(None if deadline is None
                           else max(0.0, deadline - time.monotonic())):
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(f'{nprocs} ranks still running after '
                                   f'{timeout} s')
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
                proc.join()


def collective_seconds() -> float:
    """Seconds this process has spent in this module's collectives so far.
    On CUDA tensors a collective is timed by CUDA events on the current
    stream around it: an NCCL collective returns once it is queued, and
    gloo's first waits for the kernels queued before it, so neither's host
    clock is its time.  Waits for the collectives still queued."""
    t = _COLLECTIVE_TIME
    for start, end in t['events']:
        end.synchronize()
        t['seconds'] += start.elapsed_time(end) / 1e3
    t['events'].clear()
    return t['seconds']


def _collective(op, mesh, axis, x, *args):
    """op(*args) over ``axis``'s group, timed for collective_seconds; x is
    the tensor sent."""
    group = mesh.groups[axis]
    if not x.is_cuda:
        t0 = time.perf_counter()
        op(*args, group=group)
        _COLLECTIVE_TIME['seconds'] += time.perf_counter() - t0
        return
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    op(*args, group=group)
    end.record()
    _COLLECTIVE_TIME['events'].append((start, end))
    if len(_COLLECTIVE_TIME['events']) >= 256:
        collective_seconds()


def _all_gather(x, mesh: ProcessMesh, axis):
    """[n, *x.shape]: x of each rank on ``axis``, in axis order."""
    n = mesh.size(axis)
    if n == 1:
        return x[None]
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(n)]
    _collective(dist.all_gather, mesh, axis, x, out, x)
    return torch.stack(out)


def _all_reduce_sum(x, mesh: ProcessMesh, axis):
    """The sum of x over the ranks of ``axis`` (x itself is summed into)."""
    if mesh.size(axis) > 1:
        _collective(dist.all_reduce, mesh, axis, x, x)
    return x


class _AllReduceSum(torch.autograd.Function):
    """all_reduce_sum with its gradient: every rank's loss reads the sum,
    so the gradient of a rank's x is the sum of the ranks' gradients of
    the sum (one more all-reduce, in the backward)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _all_reduce_sum(x.clone(), mesh, axis)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        return _all_reduce_sum(grad.clone(), ctx.mesh, ctx.axis), None, None


def all_reduce_sum(x, mesh: ProcessMesh, axis):
    """The sum of x over the ranks of ``axis``, differentiable: a batch
    statistic of the whole dp batch (the global moments that XLA's
    inserted reduction gives a dp-sharded BatchNorm in the JAX package)."""
    return _AllReduceSum.apply(x, mesh, axis)


def _pad_to(x, n, axis):
    """x zero-padded to n along ``axis``."""
    need = n - x.shape[axis]
    if need == 0:
        return x
    pads = [0, 0] * (x.ndim - axis - 1) + [0, need]
    return torch.nn.functional.pad(x, pads)


def _band(mesh: ProcessMesh, sp_axis, image_size):
    """(row0, height) of this rank's row band, or None when the rows are
    not split."""
    n_sp = mesh.size(sp_axis)
    if n_sp == 1:
        return None
    if image_size % n_sp:
        raise ValueError(f'image_size {image_size} does not split into '
                         f'{n_sp} row bands')
    hb = image_size // n_sp
    return (mesh.index(sp_axis) * hb, hb)


def _chunk_unit(cfg: C.RenderConfig) -> int:
    """A face shard's face count must be a multiple of this."""
    return cfg.face_chunk


def _face_shard(face_vertices, textures, cfg: C.RenderConfig, n_fp, i_fp):
    """Face shard i_fp of n_fp: (face vertices, textures, fvalid,
    base_offset) of its slice of the faces padded to a multiple of
    n_fp x face_chunk; fvalid marks the faces that are not padding."""
    F = face_vertices.shape[1]
    unit = n_fp * _chunk_unit(cfg)
    Fp = -(-F // unit) * unit
    Fl = Fp // n_fp
    base_offset = i_fp * Fl
    fl = slice(base_offset, base_offset + Fl)
    fv_l = _pad_to(face_vertices.to(torch.float32), Fp, 1)[:, fl]
    tex_l = _pad_to(textures.to(torch.float32), Fp, 1)[:, fl]
    fvalid_l = (torch.arange(Fp, device=face_vertices.device) < F)[fl]
    return fv_l, tex_l, fvalid_l, base_offset


def _resolve_backend(cfg: C.RenderConfig, face_vertices, backend=None):
    """The per-shard engine: the one named (``backend``, else
    ``cfg.backend``), else the CUDA kernels for CUDA tensors and the plain
    torch backend for CPU tensors."""
    backend = cfg.backend if backend is None else backend
    if backend is None:
        backend = 'cuda' if face_vertices.is_cuda else 'torch'
    if backend not in ('cuda', 'torch'):
        raise ValueError(f'backend must be "cuda" or "torch", got {backend!r}')
    return CB if backend == 'cuda' else TB


# the carry's six fields travel as one float32 block [B, 8, P]: alpha, smax,
# ssum, r, g, b, depth and the winner id (an integer below 2^24, exact)
def _pack_carry(carry):
    alpha, smax, ssum, rgb, depth, fidx = carry
    return torch.cat([alpha[:, None], smax[:, None], ssum[:, None],
                      rgb.transpose(1, 2), depth[:, None],
                      fidx.to(torch.float32)[:, None]], dim=1)


def _unpack_carry(x):
    return (x[:, 0], x[:, 1], x[:, 2], x[:, 3:6].transpose(1, 2), x[:, 6],
            x[:, 7].to(torch.int32))


def _forward(face_vertices, textures, cfg: C.RenderConfig, params: Dict,
             mesh: ProcessMesh, fp_axis, sp_axis, backend):
    """The sharded forward on this rank: (image [B, 4, H, W], its band's
    soft colours and aggrs_info, and what the backward needs)."""
    B, F = face_vertices.shape[:2]
    dev = face_vertices.device
    is_ = cfg.image_size
    engine = _resolve_backend(cfg, face_vertices, backend)
    band = _band(mesh, sp_axis, is_)
    P = is_ * (band[1] if band else is_)
    fv_l, tex_l, fvalid_l, base_offset = _face_shard(
        face_vertices, textures, cfg, mesh.size(fp_axis),
        mesh.index(fp_axis))

    aux = None
    if engine is CB:
        # a shard passes its fvalid even at fp=1, so per-tile face
        # compaction stays off on every sharded render, as in gendr_tpu
        carry, aux = CB.forward_partial(fv_l, tex_l, cfg, params,
                                        base_offset=base_offset,
                                        fvalid=fvalid_l, row_band=band)
    else:
        carry = TB.forward_carry(fv_l, tex_l, fvalid_l,
                                 TB.empty_carry(B, P, cfg, dev), cfg, params,
                                 base_offset=base_offset, row_band=band)
    # the shards' carries in shard order, folded after the background state
    # (the reference's initial state, sharding.py:190-197)
    gathered = _all_gather(_pack_carry(carry), mesh, fp_axis)
    bg = params['background_color'].to(dev).reshape(1, 1, 3).expand(B, P, 3)
    merged = TB.background_carry(B, P, bg, cfg, params)
    for part in gathered:
        merged = TB.merge_carries(merged, _unpack_carry(part), cfg, params)
    soft, aggrs = TB.finalize(merged, cfg)
    bands = _all_gather(soft, mesh, sp_axis)        # [n_sp, B, 4, h, W]
    image = bands.permute(1, 2, 0, 3, 4).reshape(B, 4, is_, is_)
    shard = dict(engine=engine, fv=fv_l, tex=tex_l, fvalid=fvalid_l,
                 base_offset=base_offset, band=band, aux=aux, F=F)
    return image, soft, aggrs, shard


def render_sharded(face_vertices, textures, cfg: C.RenderConfig,
                   params: Dict, mesh: ProcessMesh,
                   dp_axis: Optional[str] = 'dp',
                   fp_axis: Optional[str] = 'fp',
                   sp_axis: Optional[str] = None, backend=None):
    """Forward render with the batch split over ``dp_axis``, the faces over
    ``fp_axis`` and the image rows over ``sp_axis``: a collective, called by
    every rank with its dp shard's face_vertices [B_dp, F, 9] and textures
    [B_dp, F, TS, 3].  Returns soft_colors [B_dp, 4, H, W], the same on
    every rank of the dp shard.  ``backend``: 'cuda' (the kernels; their
    plain versions for CPU tensors), 'torch', or None (cfg.backend, else by
    the tensors' device).  The dp axis needs no communication here."""
    del dp_axis  # each rank already holds its dp shard
    with torch.no_grad():
        image, _, _, _ = _forward(face_vertices, textures, cfg, params, mesh,
                                  fp_axis, sp_axis, backend)
    return image


class _ShardedRender(torch.autograd.Function):
    """render_sharded with the reference's gradient: each rank computes its
    face slice's gradient from its band's pixels, the bands' sums are
    all-reduced over sp (sharding.py:301-304) and the slices all-gathered
    over fp, so every rank returns the whole [B_dp, F, ...] gradient."""

    @staticmethod
    def forward(ctx, face_vertices, textures, cfg, params, mesh, fp_axis,
                sp_axis, backend):
        image, soft, aggrs, shard = _forward(
            face_vertices, textures, cfg, params, mesh, fp_axis, sp_axis,
            backend)
        ctx.state = (cfg, params, mesh, fp_axis, sp_axis, soft, aggrs, shard)
        return image

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_image):
        cfg, params, mesh, fp_axis, sp_axis, soft, aggrs, shard = ctx.state
        band = shard['band']
        g = grad_image.contiguous() if band is None else \
            grad_image[:, :, band[0]:band[0] + band[1]].contiguous()
        if shard['engine'] is CB:
            gf, gt = CB.backward_from_aux(
                shard['fv'], shard['tex'], shard['aux'], soft, aggrs, g, cfg,
                params, shard['base_offset'], shard['fvalid'], band)
        else:
            gf, gt = TB.backward(shard['fv'], shard['tex'], soft, aggrs, g,
                                 cfg, params, shard['base_offset'], band)
        B, Fl = gf.shape[:2]
        # one buffer for both gradients: one all-reduce, one all-gather
        flat = _all_reduce_sum(torch.cat([gf.reshape(B, Fl, -1),
                                          gt.reshape(B, Fl, -1)], dim=2),
                               mesh, sp_axis)
        flat = _all_gather(flat, mesh, fp_axis)      # [n_fp, B, Fl, 9 + t]
        flat = flat.permute(1, 0, 2, 3).reshape(B, -1, flat.shape[-1])
        F = shard['F']
        grad_faces = flat[:, :F, :9]
        grad_tex = flat[:, :F, 9:].reshape((B, F) + gt.shape[2:])
        return grad_faces, grad_tex, None, None, None, None, None, None


def make_sharded_render(cfg: C.RenderConfig, mesh: ProcessMesh,
                        dp_axis='dp', fp_axis='fp', sp_axis=None,
                        backend=None):
    """A differentiable render_sharded: ``render_fn(face_vertices, textures,
    params)`` on each rank's dp shard, whose gradient to face_vertices and
    textures equals the unsharded render's on every rank.  Averaging a
    model's gradient over dp is the caller's (train_step)."""
    del dp_axis  # each rank already holds its dp shard

    def render_fn(face_vertices, textures, params):
        return _ShardedRender.apply(face_vertices, textures, cfg, params,
                                    mesh, fp_axis, sp_axis, backend)
    return render_fn


def silhouette_inputs(verts, faces, eyes):
    """(face_vertices [B, nf, 9], white textures [B, nf, 1, 3]) of a mesh
    (verts [1, nv, 3], faces [1, nf, 3]) seen from eyes [B, 3] through
    look_at and a 30 degree perspective, as the dry run renders it."""
    B = eyes.shape[0]
    v = T.perspective(T.look_at(verts.expand(B, -1, -1), eyes), 30.0)
    fv = core.face_vertices(v, faces.expand(B, -1, -1)).reshape(B, -1, 9)
    return fv, torch.ones((B, fv.shape[1], 1, 3), device=fv.device)


def silhouette_loss(render_fn, params, verts, faces, eyes, target):
    """The dry run's loss on this rank's views: the mean over eyes of
    1 - IoU(alpha, target) of silhouette_inputs' render
    (__graft_entry__.py:127-141)."""
    pred = render_fn(*silhouette_inputs(verts, faces, eyes), params)[:, 3]
    inter = (pred * target).sum((1, 2))
    union = (pred + target - pred * target).sum((1, 2)) + 1e-6
    return (1.0 - inter / union).mean()


def average_gradients(params, loss, mesh: ProcessMesh, dp_axis='dp'):
    """Replace each parameter's gradient by its mean over ``dp_axis`` and
    return the mean of ``loss`` (a 0-d tensor, left on its device), in one
    all-reduce: the step of the whole dp batch, since each rank's loss is
    the mean over an equal shard.  params: a tensor or a sequence."""
    params = [params] if isinstance(params, torch.Tensor) else list(params)
    buf = torch.cat([p.grad.reshape(-1) for p in params]
                    + [loss.detach().reshape(1)])
    buf = _all_reduce_sum(buf, mesh, dp_axis) / mesh.size(dp_axis)
    offset = 0
    for p in params:
        p.grad.copy_(buf[offset:offset + p.numel()].reshape(p.shape))
        offset += p.numel()
    return buf[-1]


def train_step(loss_fn, optimizer, param, mesh: ProcessMesh, dp_axis='dp'):
    """One optimizer step on ``param`` with a loss over this rank's dp
    shard: the loss and the gradient are averaged over ``dp_axis``
    (average_gradients) before the update, so every rank takes the same
    step.  Returns the averaged loss."""
    optimizer.zero_grad()
    loss = loss_fn()
    loss.backward()
    loss = average_gradients(param, loss, mesh, dp_axis)
    optimizer.step()
    return float(loss)


def _factor(n_devices):
    """__graft_entry__.py's dp x fp x sp factorization of n_devices."""
    sp = 2 if n_devices % 8 == 0 else 1
    fp = 2 if n_devices % 2 == 0 else 1
    return n_devices // (fp * sp), fp, sp


def dryrun_eyes(B):
    """The dry run's B eyes on a circle of radius 2 at height 0.7."""
    return np.stack([[2.0 * np.cos(a), 0.7, 2.0 * np.sin(a)] for a in
                     np.linspace(0, 2 * np.pi, B, endpoint=False)]
                    ).astype(np.float32)


def dryrun_multichip(n_devices: int, device=None) -> Dict:
    """One silhouette-IoU training step (Adam, lr 1e-2) of a mesh
    displacement over an n_devices mesh, batch x faces x rows, then the
    four render cases of the JAX package's dry run (rgb, TS and 2x
    anti-aliasing vary), forward and backward, on tiny shapes: the port of
    ``__graft_entry__.dryrun_multichip``.  Every rank calls it inside an
    initialised default group of n_devices ranks; tensors live on
    ``device`` (None: the card).  Returns {'mesh': (dp, fp, sp), 'loss':
    the first step's loss, 'renders': {case: loss}}."""
    if not dist.is_initialized() or dist.get_world_size() != n_devices:
        raise RuntimeError(f'dryrun_multichip({n_devices}) runs in every '
                           f'rank of an initialised group of {n_devices}')
    dev = resolve_device(device)
    dp, fp, sp = _factor(n_devices)
    mesh = make_mesh({'dp': dp, 'fp': fp, 'sp': sp})
    sp_axis = 'sp' if sp > 1 else None
    image_size = 16
    v, f = data.icosphere(1)   # 42 vertices, 80 faces
    B = 2 * dp                 # two views per dp shard
    cfg = C.RenderConfig.create(
        image_size=image_size, dist_func='uniform',
        aggr_alpha_func='probabilistic', aggr_rgb_func='hard',
        face_chunk=32)
    params = C.RenderParams(dist_scale=3e-2, dist_eps=1e2,
                            background_color=(0.0, 0.0, 0.0)).as_dict()
    render_fn = make_sharded_render(cfg, mesh, 'dp', 'fp', sp_axis)
    base_v = torch.as_tensor(v, device=dev)[None] * 0.5
    faces = torch.as_tensor(f, device=dev)[None]
    eyes_all = torch.as_tensor(dryrun_eyes(B), device=dev)
    eyes = shard_batch(eyes_all, mesh)
    target = torch.full((eyes.shape[0], image_size, image_size), 0.3,
                        device=dev)
    displace = torch.zeros((1, v.shape[0], 3), device=dev,
                           requires_grad=True)
    opt = torch.optim.Adam([displace], lr=1e-2)
    loss = train_step(lambda: silhouette_loss(
        render_fn, params, base_v + displace, faces, eyes, target),
        opt, displace, mesh)
    if not (np.isfinite(loss) and bool(torch.isfinite(displace).all())):
        raise AssertionError(f'dryrun_multichip: loss {loss}')
    renders = {}

    def dry_render(axes, rgb, ts, aa):
        m = make_mesh(axes)
        Br = 2 * axes.get('dp', 1)
        cfg_r = C.RenderConfig.create(
            image_size=32 if aa else 16, dist_func='logistic',
            aggr_alpha_func='einstein', aggr_rgb_func=rgb, face_chunk=32)
        rfn = make_sharded_render(cfg_r, m, 'dp', 'fp',
                                  'sp' if axes.get('sp', 1) > 1 else None)
        pr = C.RenderParams(dist_scale=1e-2, dist_eps=1e2,
                            aggr_rgb_gamma=1e-2,
                            background_color=(0.2, 0.1, 0.3)).as_dict()
        fv0, _ = silhouette_inputs(base_v, faces, eyes_all[:Br])
        tex0 = torch.as_tensor(np.random.RandomState(0).rand(
            Br, fv0.shape[1], ts, 3).astype(np.float32), device=dev)
        fv_d = shard_batch(fv0, m).clone().requires_grad_(True)
        tex_d = shard_batch(tex0, m).clone().requires_grad_(True)
        img = rfn(fv_d, tex_d, pr)
        if aa:
            b_, c_, h_, w_ = img.shape
            img = img.reshape(b_, c_, h_ // 2, 2, w_ // 2, 2).mean((3, 5))
        val = (img[:, :3] ** 2).sum() + img[:, 3].sum()
        val.backward()
        total = float(_all_reduce_sum(val.detach().clone(), m, 'dp'))
        if not (np.isfinite(total) and bool(torch.isfinite(fv_d.grad).all())
                and bool(torch.isfinite(tex_d.grad).all())):
            raise AssertionError(f'dryrun_multichip: {axes} {rgb}: {total}')
        tag = 'x'.join(f'{k}={n}' for k, n in axes.items())
        renders[f'{tag} rgb={rgb} TS={ts} aa={aa}'] = total

    axes1 = {'dp': dp, 'fp': fp, 'sp': sp}
    dry_render(axes1, 'softmax', ts=4, aa=True)
    dry_render(axes1, 'hard', ts=4, aa=False)
    if n_devices % 4 == 0:
        axes2 = {'dp': n_devices // 4, 'fp': 4}
        dry_render(axes2, 'softmax', ts=4, aa=False)
        dry_render(axes2, 'hard', ts=4, aa=True)
    return dict(mesh=(dp, fp, sp), loss=loss, renders=renders)
