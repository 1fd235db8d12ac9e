"""Cells of the reconstruction experiment: the program's
``experiments.train_reconstruction`` step (``Reconstruction.step``) driven
through ``experiments.common.StepChain`` as ``train()`` builds it: the
training images loaded by its ``ShapeNet`` dataset from npz files in
ShapeNet's layout, resident on the card as uint8 and gathered by image id;
each block's batches drawn from the seed's stream by the dataset's own
draw; captured and replayed for ``chain`` > 1.  No evaluation, print or
decay falls in the window.

The benchmark hands the program, and its reference, the training images
(the synthetic stand-in for ShapeNet, made on the card from the seed and
written under TMPDIR as a user's copy of the dataset would lie), the
weights (made on the card from the seed) and the template sphere."""

from __future__ import annotations

import os

import numpy as np
import torch

from benchmark import problem
from benchmark.reference import geometry as G
from benchmark.reference import recon as ref


def _write_shapenet(root, classes, images, objects):
    """The images [classes x objects x 24, 4, S, S] as ShapeNet's npz files
    of the training split under root/mesh_reconstruction (the voxels
    zero: no evaluation runs)."""
    d = os.path.join(root, 'mesh_reconstruction')
    os.makedirs(d, exist_ok=True)
    per = images.reshape(len(classes), objects, 24, *images.shape[1:])
    for c, im in zip(classes, per):
        np.savez(os.path.join(d, f'{c}_train_images.npz'), im)
        np.savez(os.path.join(d, f'{c}_train_voxels.npz'),
                 np.zeros((objects, 32, 32, 32), np.uint8))


class Cell:
    """One run's system under test.  ``fault`` plants a fault in the
    program (for the benchmark's tests and calibration only): 'frozen', a
    step that leaves the weights unchanged; 'half_batch', IoU losses over
    half of each view set, averaged over that half."""

    def __init__(self, cfg, traffic, seed, device, tmp, fault=None):
        from gendr_tpu_torch.experiments import train_reconstruction as TR
        from gendr_tpu_torch.experiments.common import (StepChain,
                                                        chain_capture,
                                                        make_adam, set_lr)
        self.cfg = cfg
        self.device = torch.device(device)
        self.chain = traffic['chain']
        self.set_lr = set_lr
        seed32 = seed % 2 ** 32
        B, S = cfg['batch_size'], cfg['image_size']
        self.dataset = dict(seed=seed32, classes=cfg['classes'],
                            objects=cfg['objects'], image_size=S)
        TR.float32_backends()
        args = TR.parse_args([
            '--dataset-dir', tmp, '--class_ids', ','.join(cfg['classes']),
            '--image_size',
            str(S), '--batch_size', str(B), '-lr', str(cfg['learning_rate']),
            '--seed', str(seed32), '--distribution', cfg['dist_func'],
            '--dist_scale', repr(cfg['dist_scale']), '--dist_eps',
            str(cfg['dist_eps']), '--t_conorm', cfg['aggr_func'],
            '--lambda_laplacian', repr(cfg['lambda_laplacian']),
            '--lambda_flatten', repr(cfg['lambda_flatten']),
            '--chain', str(self.chain), '--device', self.device.type])
        self.args = args
        if fault == 'half_batch':
            whole = TR.iou_loss

            def half(p, t, reduce='mean'):
                h = p.shape[0] // 2
                return whole(p[:h], t[:h], reduce)
            TR.iou_loss = half
            self._restore = lambda: setattr(TR, 'iou_loss', whole)
        else:
            self._restore = lambda: None
        images = ref.dataset_images(self.dataset, self.device).cpu().numpy()
        self.images = images
        if self.device.type == 'cuda':
            # the peak the run reports is the program's, not the rendering
            # of the benchmark's inputs
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)
        _write_shapenet(tmp, cfg['classes'], images, cfg['objects'])
        data = TR.ShapeNet(tmp, cfg['classes'], 'train')
        self.template, self.faces = G.icosphere(cfg['template_level'])
        with torch.device(self.device):
            encoder = TR.Encoder(image_size=S)
            decoder = TR.Decoder(self.template)
        exp = TR.Reconstruction(args, encoder, decoder, self.faces,
                                self.device)
        shapes = ref.param_shapes(cfg, len(self.template))
        self.W = ref.init_weights(shapes, seed, self.device)
        named = dict(zip(exp.parameter_names(), exp.parameters()))
        if [(n, tuple(p.shape)) for n, p in named.items()] != \
                [(n, tuple(s)) for n, s in shapes]:
            raise ValueError('the program\'s parameters are not the '
                             'configuration\'s')
        with torch.no_grad():
            for n, p in named.items():
                p.copy_(self.W[n])
        opt = make_adam(exp.parameters(), args.learning_rate)
        if fault == 'frozen':
            opt.step = lambda *a, **k: None
        images = torch.from_numpy(data.images).to(self.device)
        inputs = dict(eyes=torch.zeros((2, B, 3), device=self.device),
                      par=exp.par,
                      ids=torch.zeros((2, B), dtype=torch.long,
                                      device=self.device))

        def step():
            batch = images[inputs['ids']].float() / 255.
            eyes = inputs['eyes']
            loss, ok = exp.step(opt, batch[0], batch[1], eyes[0], eyes[1])
            return torch.stack([loss, ok.to(loss.dtype)])

        self.exp, self.opt, self.data, self.named = exp, opt, data, named
        self.steps = StepChain(
            step, inputs, chain_capture(self.device, self.chain),
            state=[*exp.parameters(), *exp.encoder.buffers()], optimizer=opt)
        self.rng = np.random.RandomState(seed32)
        self.row = exp.renderer.params_vector(dist_scale=args.dist_scale)
        self.done = 0

    def run(self, n):
        """n steps on n batches drawn now: their losses, and how many
        steps had a gradient that was not finite."""
        B = self.args.batch_size
        batches = [self.data.get_random_batch_ids(self.rng, B)
                   for _ in range(n)]
        xs = dict(eyes=np.stack([np.stack(b[2:]) for b in batches]),
                  par=self.row[None].repeat(n, 1),
                  ids=np.stack([np.stack(b[:2]) for b in batches]
                               ).astype(np.int64))
        self.set_lr(self.opt, self.args.learning_rate)
        res = self.steps.run(xs)
        self.done += n
        self.last_ids = xs['ids']
        return res[:, 0], int((res[:, 1] == 0).sum())

    def block(self):
        return self.run(self.chain)

    def first_steps(self, steps=3):
        """The first ``steps`` steps through the window's own call, on
        batches that all differ: the program's readings, dict(losses,
        grads {name: the first gradient, as Adam's state holds it after
        step 1}, change {name: after ``steps``})."""
        b1 = self.opt.param_groups[0]['betas'][0]
        losses, _ = self.run(1)
        self.first_ids = [self.last_ids[0]]
        grads = {}
        for n, p in self.named.items():
            s = self.opt.state.get(p, {})
            grads[n] = (s['exp_avg'] / (1.0 - b1) if 'exp_avg' in s
                        else torch.zeros_like(p)).detach().clone()
        more, _ = self.run(steps - 1)
        self.first_ids += list(self.last_ids)
        change = {n: (p - self.W[n]).detach().clone()
                  for n, p in self.named.items()}
        return dict(losses=losses.tolist() + more.tolist(), grads=grads,
                    change=change)

    def free(self):
        self._restore()
        del self.exp, self.opt, self.data, self.named, self.steps

    def reference(self, steps=3, tf32=False):
        """The plain reference's readings over the same first steps."""
        self._ref = ref.follow(
            self.W, self.template, self.faces,
            torch.as_tensor(self.images, device=self.device),
            self.first_ids[:steps], self.cfg, self.device, tf32)
        return self._ref

    def work(self):
        """The step's work from the problem: the network's operations from
        its layer shapes, and the render's gated pairs at the reference's
        first step."""
        cfg = self.cfg
        B, S = cfg['batch_size'], cfg['image_size']
        pairs = self._ref['pairs']
        w = problem.render_work(pairs, 4 * B, len(self.faces), S)
        net = problem.network_flops(
            2 * B, 2 * B, S, [4] + cfg['encoder']['conv_widths'],
            cfg['encoder']['dims'], cfg['decoder']['widths'],
            len(self.template))
        w.update(pairs=pairs, network_flops=net,
                 step_flops=net + w['fwd_flops'] + w['bwd_flops'])
        return w
