"""Shared experiment utilities: losses, image grids, GIF writing, meshes,
and the chained training steps of ``--chain``.

Port of ``experiments/common.py`` (the helpers at the top of the reference
experiment scripts, experiments/opt_shape.py:20-47 there).  The JAX
scripts run ``--chain N`` training steps in one ``jax.lax.scan`` dispatch
and fetch the per-step losses once a block; :class:`StepChain` is the
port's counterpart: on the card one step captured as a CUDA graph and
replayed N times, on the CPU the same step in a loop.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from gendr_tpu_torch import data
from gendr_tpu_torch.device import as_float32, to_device
from gendr_tpu_torch.geometry import obj_io
from gendr_tpu_torch.utils import profiling


def iou_loss(predict, target, reduce='mean'):
    """1 - IoU per batch element (opt_shape.py:20-24 / opt_camera.py:18-22:
    the two scripts differ only in the final reduction)."""
    dims = tuple(range(1, predict.ndim))
    intersect = (predict * target).sum(dims)
    union = (predict + target - predict * target).sum(dims) + 1e-6
    per = 1.0 - intersect / union
    return per.mean() if reduce == 'mean' else per.sum()


def mse_loss(predict, target):
    return ((predict - target) ** 2).mean()


def make_grid(pred, target, grid_x, grid_y):
    """Tile predicted/target silhouettes side by side into a uint8 image
    (opt_shape.py:31-47)."""
    pred = np.asarray(torch.as_tensor(pred).detach().cpu())
    target = np.asarray(torch.as_tensor(target).detach().cpu())
    rows = []
    j = 0
    for _ in range(grid_y):
        row = []
        for _ in range(grid_x):
            row.append(pred[j])
            row.append(target[j])
            j += 1
        rows.append(np.concatenate(row, 1))
    img = np.concatenate(rows, 0)
    return (255 * np.clip(img, 0, 1)).astype(np.uint8)


def require_gif_support(prog):
    """Stop a command line that asks for --gif where imageio, an optional
    dependency, is not installed: before any step runs, not after them."""
    try:
        import imageio.v2  # noqa: F401
    except ImportError:
        raise SystemExit(f'{prog}: --gif writes its frames with imageio, '
                         f'which is not installed; install it or run '
                         f'without --gif') from None


class GifWriter:
    """Frames to a GIF file; imageio is imported only here (it is an
    optional dependency: see require_gif_support)."""

    def __init__(self, path):
        import imageio.v2 as imageio
        self.writer = imageio.get_writer(path, mode='I')

    def append(self, frame):
        self.writer.append_data(frame)

    def close(self):
        self.writer.close()


def load_or_make_mesh(model_obj, data_dir=None):
    """(vertices [nv, 3] float32, faces [nf, 3] int32) as numpy: the OBJ
    file model_obj, or the file of that name in data_dir, where one
    exists; else a procedural stand-in for the reference's binary assets,
    as the JAX package makes them: sphere_642/1352 regenerate by
    tessellation class, and any other missing asset (airplane, teapot)
    falls back to a cube.
    """
    name = os.path.basename(model_obj)
    candidates = [model_obj]
    if data_dir:
        candidates.append(os.path.join(data_dir, name))
    for path in candidates:
        if os.path.exists(path):
            vertices, faces = obj_io.load_obj(path, device='cpu')
            return vertices.numpy(), faces.numpy()
    if name.startswith('sphere_'):
        return data.sphere(int(name.split('_')[1].split('.')[0]))
    print(f'[gendr_tpu_torch] asset {model_obj} not found; using '
          f'procedural cube', file=sys.stderr)
    return data.test_meshes('cube')


def make_adam(params, lr, betas=(0.9, 0.999)):
    """torch.optim.Adam over params.  On the card it is capturable, its lr a
    tensor on the card (set_lr writes it), so a CUDA graph of a step reads
    each block's lr and its bias corrections are computed there; on the
    CPU the plain Adam, lr a number."""
    params = list(params)
    dev = params[0].device
    if dev.type == 'cuda':
        return torch.optim.Adam(params, lr=as_float32(lr, dev), betas=betas,
                                capturable=True)
    return torch.optim.Adam(params, lr=lr, betas=betas)


def set_lr(opt, lr):
    """Every group's learning rate to lr: written into a tensor lr (a
    captured step reads it there), assigned where it is a number."""
    for group in opt.param_groups:
        if isinstance(group['lr'], torch.Tensor):
            group['lr'].fill_(lr)
        else:
            group['lr'] = lr


def reset_optimizer(opt, lr):
    """The optimizer's state back to a fresh one's (its tensors zeroed in
    place, which a captured step keeps reading) and its lr to lr."""
    with torch.no_grad():
        for state in opt.state.values():
            for v in state.values():
                if isinstance(v, torch.Tensor):
                    v.zero_()
    set_lr(opt, lr)


def chain_capture(device, chain, reason=None):
    """Whether a StepChain captures its step: on the card for chain > 1,
    unless ``reason`` names what keeps the step from being captured, which
    is then printed."""
    if torch.device(device).type != 'cuda' or chain <= 1:
        return False
    if reason:
        print(f'chain: loop (not captured: {reason})')
        return False
    return True


class StepChain:
    """Training steps a block at a time, the results fetched once a block.

    ``step()`` runs one training step.  It reads its per-step inputs from
    the tensors of ``inputs`` (name -> tensor on the device): before step j
    of a block, row j of the block's input of that name is copied into
    it.  It returns a 1-d tensor of that step's results (its loss, ...).

    With ``capture`` (the card), the first block warms the step up on a
    side stream, as PyTorch's recipe for CUDA graphs asks (this also builds
    the kernels and sets their attributes), captures one step with
    ``capture_error_mode='global'`` and puts ``state`` (the tensors the
    step updates in place: parameters, BatchNorm statistics) and the
    optimizer's state back as they were before the warm-up.  Each step of a
    block is then one replay of the graph, under
    ``torch.cuda.set_sync_debug_mode('error')``: nothing in a block waits
    for the card.  A failed capture raises.  Without ``capture`` the step
    runs as it is, step after step.  Either way a block copies its inputs
    to the device once and fetches its results once.

    ``fetches`` counts the fetches, ``replays`` the replays; ``captured``
    holds the kernel launches (cuda_backend.LAUNCHES) the graph recorded,
    which each replay launches again.

    The step's phase marks (``utils.profiling.mark``) are kept only for a
    block's last step while a profiler records: the capture makes a second
    graph of the step with its marks (event-record nodes), in a pool of its
    own, which replays in place of the plain graph there and nowhere else,
    so no other replay carries a mark; an eager block records that step's
    marks.  After each fetch, while a profiler records, that step's phases
    go into ``profiling.phase_table()``.  The block's copy, each step and
    the fetch are the profiler's spans ``gendr.chain.inputs``, ``.step``
    and ``.fetch``.
    """

    def __init__(self, step, inputs, capture=False, state=(),
                 optimizer=None, warmup=2):
        self.step = step
        self.inputs = inputs
        self.capture = capture
        self.state = list(state)
        self.optimizer = optimizer
        self.warmup = warmup
        self.device = next(iter(inputs.values())).device
        self.graph = None
        self.out = None
        self.marked = None    # (graph, out, recorder) of the marked copy
        self.fetches = 0
        self.replays = 0
        self.captured = {}
        self.recorder = None

    def run(self, xs):
        """Steps len(xs[name]) times, step j with row j of each xs[name] (on
        the host) in inputs[name]; returns their results [n, k] on the
        CPU."""
        with profiling.span('chain.inputs'):
            block = {k: to_device(torch.as_tensor(v), self.device)
                     for k, v in xs.items()}
        n = len(next(iter(block.values())))
        outs = []
        self.recorder = None
        if self.capture:
            if self.graph is None:
                self._load(block, 0)
                self._capture()
            previous = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode('error')
            try:
                for j in range(n):
                    graph, out = self.graph, self.out
                    if j == n - 1 and profiling.active():
                        graph, out, self.recorder = self.marked
                    with profiling.span('chain.step'):
                        self._load(block, j)
                        graph.replay()
                    outs.append(out.clone())
            finally:
                torch.cuda.set_sync_debug_mode(previous)
            self.replays += n
        else:
            for j in range(n):
                with profiling.span('chain.step'):
                    self._load(block, j)
                    if j == n - 1 and profiling.active():
                        self.recorder = profiling.Recorder(self.device)
                        out = self._recorded_step(self.recorder)
                    else:
                        out = self.step()
                outs.append(out.detach())
        self.fetches += 1
        with profiling.span('chain.fetch'):
            res = torch.stack(outs).cpu()
        if self.recorder is not None:
            profiling.add_phases(self.recorder)
        return res

    def _recorded_step(self, recorder):
        """step() with its phase marks kept by recorder, and a last mark
        where it returns."""
        with profiling.recording(recorder):
            out = self.step()
            profiling.mark('end')
        return out

    def _load(self, block, j):
        for k, v in block.items():
            self.inputs[k].copy_(v[j])

    def _optimizer_state(self):
        if self.optimizer is None:
            return {}
        return {id(p): {k: v.clone() for k, v in s.items()
                        if isinstance(v, torch.Tensor)}
                for p, s in self.optimizer.state.items()}

    def _graph(self, step):
        """(a CUDA graph of step(), its output)."""
        if self.optimizer is not None:
            # the captured backward allocates the gradients in the graph's
            # pool, where each replay writes them
            self.optimizer.zero_grad(set_to_none=True)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode='global'):
            out = step()
        return graph, out

    def _capture(self):
        from gendr_tpu_torch.raster import cuda_backend as CB
        saved = [t.detach().clone() for t in self.state]
        saved_opt = self._optimizer_state()
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            for _ in range(self.warmup):
                self.step()
        main.wait_stream(side)
        before = dict(CB.LAUNCHES)
        recorder = profiling.Recorder(self.device)
        self.marked = (*self._graph(lambda: self._recorded_step(recorder)),
                       recorder)
        # the marked copy launches what the plain graph does: counted once
        CB.LAUNCHES.update(before)
        # the plain graph last: the parameters' .grad are its buffers
        self.graph, self.out = self._graph(self.step)
        self.captured = {k: CB.LAUNCHES[k] - before[k] for k in before}
        with torch.no_grad():
            for t, v in zip(self.state, saved):
                t.copy_(v)
            if self.optimizer is not None:
                for p, s in self.optimizer.state.items():
                    old = saved_opt.get(id(p), {})
                    for k, v in s.items():
                        if isinstance(v, torch.Tensor):
                            if k in old:
                                v.copy_(old[k])
                            else:
                                v.zero_()
