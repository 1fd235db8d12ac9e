"""Per-step losses of a train_reconstruction run, and the steps around its
largest jump replayed from a checkpoint through both render backends.

    python -m gendr_tpu_torch.tools.recon_steps [--steps N] [--replay K]
        [--out FILE] -- <train_reconstruction arguments>

1. Trains N steps with the given arguments (its ``--chain``; ``-ni``,
   ``--eval_freq`` and ``--checkpoint-dir`` are set here) and keeps every
   step's loss.
2. Finds the step s (after the first 1 000) whose loss is the largest
   multiple of the median of the 200 steps before it, and trains again
   from the start to c = s - K // 2 (at most N - K), with a checkpoint at
   c (training is bitwise reproducible on the card: the new run's losses
   must equal the first run's).
3. From that checkpoint, K eager steps on the run's own batches through
   ``backend='cuda'`` (the kernels), and before each the same loss's
   gradient through ``backend='torch'`` (the plain backend) on the same
   parameters and batch: both losses, and the two gradients'
   norm-relative difference over all parameters.  Then the same K steps
   from the same checkpoint through ``backend='torch'`` alone.

Prints the run's loss in windows of 100 steps, the ten largest jumps, and
the replay step by step; writes the same as JSON to ``--out``.

With ``--at STEP`` it looks at one step instead: trains to STEP - 1 with
a checkpoint, renders STEP's batch, and takes the silhouette loss's
gradient to every face's vertices through both backends; prints the
faces whose gradients differ most and the batch elements' norm-relative
differences, and saves the element with the largest difference (its
face vertices after the camera, the silhouette its loss compares with,
tau and the face) to ``--save`` (.npz), which
tests/test_torch_sliver_face.py holds against gendr_tpu on the CPU.
Needs the card (``--device cuda``, the default of train_reconstruction).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile

import numpy as np
import torch

from gendr_tpu_torch.experiments import train_reconstruction as TR
from gendr_tpu_torch.experiments.common import iou_loss, make_adam, set_lr

WINDOW = 200  # steps whose median a step's loss is measured against
SKIP = 1000   # the first steps, where the loss falls fastest


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--steps', type=int, default=3000)
    p.add_argument('--replay', type=int, default=60)
    p.add_argument('--out', default=None)
    p.add_argument('--at', type=int, default=0)
    p.add_argument('--save', default=None)
    p.add_argument('train', nargs=argparse.REMAINDER,
                   help='train_reconstruction arguments, after --')
    args = p.parse_args(argv)
    if args.train[:1] == ['--']:
        args.train = args.train[1:]
    return args


def run(train_argv, steps, checkpoint_dir=None):
    """TR.train over train_argv for ``steps`` steps: the losses."""
    argv = train_argv + ['-ni', str(steps), '--eval_freq', str(steps),
                         '--max-eval-batches', '1']
    if checkpoint_dir:
        argv += ['--checkpoint-dir', checkpoint_dir]
    TR.float32_backends()
    return TR.train(TR.parse_args(argv), 'cuda')['losses']


def jumps(losses):
    """[(ratio, step)], step 1-based: each step's loss over the median of
    the WINDOW steps before it, after the first SKIP steps."""
    x = np.asarray(losses)
    return [(float(x[i] / np.median(x[i - WINDOW:i])), i + 1)
            for i in range(max(SKIP, WINDOW), len(x))]


def restored(train_argv, ckpt, backend=None):
    """(args, dataset, experiment, optimizer, batch RNG, its step, the
    images on the card) of the checkpoint in ckpt."""
    args = TR.parse_args(train_argv + (['--backend', backend] if backend
                                       else []))
    dataset, _ = TR.make_datasets(args, 'cuda')
    exp = TR.build_experiment(args, 'cuda')
    opt = make_adam(exp.parameters(), args.learning_rate)
    rng = np.random.RandomState(args.seed)
    start = TR.restore_checkpoint(ckpt, exp, opt, rng)
    return (args, dataset, exp, opt, rng, start,
            torch.from_numpy(dataset.images).to('cuda'))


def next_batch(args, dataset, rng, images):
    """The run's next batch: (images a, images b, eyes a, eyes b)."""
    ids_a, ids_b, eyes_a, eyes_b = (
        torch.as_tensor(x, device='cuda')
        for x in dataset.get_random_batch_ids(rng, args.batch_size))
    return (images[ids_a.long()].float() / 255.,
            images[ids_b.long()].float() / 255., eyes_a, eyes_b)


def plain_twin(train_argv, exp):
    """A Reconstruction through backend='torch' on exp's own modules."""
    return TR.Reconstruction(
        TR.parse_args(train_argv + ['--backend', 'torch']), exp.encoder,
        exp.decoder, exp.faces.cpu().numpy(), 'cuda')


def face_grads(rec, vertices, batch, tau):
    """The silhouette loss (loss_fn's, without the mesh terms) of
    vertices [B, nv, 3] through rec's renderer: (its value, the face
    vertices after the camera [4B, F, 9], their gradient, the silhouettes'
    targets [4B, H, W])."""
    ia, ib, ea, eb = batch
    v = torch.cat([vertices, vertices]).detach()
    mesh = rec.silhouette_mesh(v, torch.cat([ea, ea, eb, eb]))
    fv = mesh.face_vertices.detach().requires_grad_()
    rec.set_dist_scale(tau)
    sils = rec.renderer.forward_tensors(fv, mesh.face_textures, rec.par)
    targets = torch.cat([ia[:, 3], ia[:, 3], ib[:, 3], ib[:, 3]])
    loss = sum(iou_loss(r, t) for r, t in zip(sils[:, 3].chunk(4),
                                               targets.chunk(4))) / 4
    loss.backward()
    B, F = fv.shape[:2]
    return (float(loss.detach()), fv.detach().reshape(B, F, 9),
            fv.grad.reshape(B, F, 9), targets)


def inspect(train_argv, step, save):
    """--at: the faces' gradients of one step through both backends."""
    with tempfile.TemporaryDirectory() as ckpt:
        run(train_argv, step - 1, ckpt)
        args, dataset, exp, _, rng, start, images = restored(train_argv,
                                                             ckpt)
    batch = next_batch(args, dataset, rng, images)
    tau = args.dist_scale * (0.3 if step >= args.decay_at else 1.0)
    with torch.no_grad():
        vertices = exp.reconstruct(torch.cat(batch[:2]), True)
    lk, fv, gk, targets = face_grads(exp, vertices, batch, tau)
    lp, _, gp, _ = face_grads(plain_twin(train_argv, exp), vertices, batch,
                              tau)
    B, F = gk.shape[:2]
    rel = float((gk - gp).norm() / gp.norm())
    print(f'step {step} (from the checkpoint at {start}): silhouette loss '
          f'kernels {lk:.6f}, plain {lp:.6f}; the faces\' gradient, '
          f'norm-relative {rel:.3g}')
    diff = (gk - gp).abs().amax(-1).reshape(-1)
    for i in torch.topk(diff, 5).indices.tolist():
        b, f = divmod(i, F)
        edges = [float((fv[b, f, 3 * j:3 * j + 2]
                        - fv[b, f, 3 * ((j + 1) % 3):3 * ((j + 1) % 3) + 2])
                       .norm()) for j in range(3)]
        others = gp[b].abs().amax(-1)
        others[f] = 0
        print(f'  element {b} face {f}: largest |gradient| kernels '
              f'{float(gk[b, f].abs().max()):.6g}, plain '
              f'{float(gp[b, f].abs().max()):.6g}, every other face of the '
              f'element at most {float(others.max()):.3g}; its edges '
              f'(x, y after the camera) ' + ', '.join(f'{e:.3g}'
                                                      for e in edges))
    per = ((gk - gp).reshape(B, -1).norm(dim=1)
           / gp.reshape(B, -1).norm(dim=1).clamp(min=1e-30))
    b = int(per.argmax())
    f = int(diff.reshape(B, F)[b].argmax())
    print(f'  by element, norm-relative: {b} {float(per[b]):.3g}; the '
          f'rest at most {float(per[per != per[b]].max()):.3g}')
    if save:
        np.savez(save, face_vertices=fv[b].cpu().numpy(),
                 target=targets[b].cpu().numpy(), weight=1.0 / B,
                 tau=tau, face=f, kernels=gk[b, f].cpu().numpy(),
                 plain=gp[b, f].cpu().numpy())


def replay(train_argv, ckpt, backend, n, check=False):
    """n eager steps from the checkpoint in ckpt through ``backend``; with
    ``check``, before each the gradient through backend='torch' on the
    same parameters and batch.  Returns [{step, loss, (torch_loss,
    grad_rel)}]."""
    args, dataset, exp, opt, rng, start, images = restored(
        train_argv, ckpt, backend)
    plain = plain_twin(train_argv, exp) if check else None
    rows = []
    for i in range(start + 1, start + n + 1):
        scale = 0.3 if i >= args.decay_at else 1.0
        batch = next_batch(args, dataset, rng, images)
        row = {'step': i}
        if plain is not None:
            stats = [b.clone() for b in exp.encoder.buffers()]
            for p in exp.parameters():
                p.grad = None
            loss = plain.loss_fn(*batch, args.dist_scale * scale)
            loss.backward()
            want = torch.cat([p.grad.reshape(-1) for p in exp.parameters()])
            row['torch_loss'] = float(loss.detach())
            for b, s in zip(exp.encoder.buffers(), stats):
                b.copy_(s)
        set_lr(opt, args.learning_rate * scale)
        loss, _ = exp.step(opt, *batch, args.dist_scale * scale)
        row['loss'] = float(loss)
        if plain is not None:
            got = torch.cat([p.grad.reshape(-1) for p in exp.parameters()])
            row['grad_rel'] = float((got - want).norm() / want.norm())
        rows.append(row)
    return rows


def main(argv=None):
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print('recon_steps: needs a CUDA device', file=sys.stderr)
        return 1
    if args.at:
        inspect(args.train, args.at, args.save)
        return 0
    losses = run(args.train, args.steps)
    x = np.asarray(losses)
    print('loss, mean of each 100 steps: ' + ' '.join(
        f'{x[i:i + 100].mean():.4f}' for i in range(0, len(x), 100)))
    top = sorted(jumps(losses), reverse=True)[:10]
    print('largest jumps (step: loss / median of the 200 before): '
          + ', '.join(f'{s}: {x[s - 1]:.4f} / {r:.2f}' for r, s in top))
    s = top[0][1]
    c = max(min(s - args.replay // 2, args.steps - args.replay), 1)
    result = dict(losses=losses, jumps=top, checkpoint=c)
    with tempfile.TemporaryDirectory() as ckpt:
        again = run(args.train, c, ckpt)
        result['reproduced'] = again == losses[:c]
        print(f'retrained to step {c}: its losses equal the first run\'s '
              f'{result["reproduced"]}', flush=True)
        result['cuda'] = replay(args.train, ckpt, 'cuda', args.replay, True)
        result['torch'] = replay(args.train, ckpt, 'torch', args.replay)
    for a, b in zip(result['cuda'], result['torch']):
        print(f'step {a["step"]}: run {x[a["step"] - 1]:.5f} | kernels '
              f'{a["loss"]:.5f}, plain on the same parameters '
              f'{a["torch_loss"]:.5f}, gradients norm-relative '
              f'{a["grad_rel"]:.3g} | plain alone {b["loss"]:.5f}')
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(result, f)
    return 0


if __name__ == '__main__':
    sys.exit(main())
