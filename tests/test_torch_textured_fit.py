"""The textured fit (``experiments.fit_textured``) against the benchmark's
plain reference of it (``benchmark/reference/textured.py``, plain torch
written from upstream's semantics, importing nothing of the port), on the
CPU at a small size: 2 views of 32x32 (64x64 rendered, 2x anti-aliasing),
the level-1 icosphere as the template and the pinched goal, surface
textures of 4 and 25 texels a face, the displacement, the centre and the
texture drawn from a seed.  Three steps of ``TexturedFit`` through its
StepChain are held to the reference on the loss, each leaf's first
gradient (norm-relative: summed vertex gradients cancel, ROADMAP Queue F)
and the parameters' change; the texel grid's two triangles swapped in the
port's texel lookup fails the same bounds."""

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from benchmark import run
from benchmark.reference import geometry as G
from benchmark.reference import textured as RT
from gendr_tpu_torch import data
from gendr_tpu_torch.experiments import fit_textured as FT
from gendr_tpu_torch.raster import geometry as RG

SIZE, VIEWS, LEVEL = 32, ('24@30', (0, 12)), 1
# the widest readings of four seeds of each backend and texel count were
# 8e-6 (loss), 6.6e-4 (grad: the centre's, the sum of every vertex's
# gradient, which cancels) and 4.6e-4 (change); the swapped fold read at
# least 2.9e-4, 1.7e-2 and 1.0e-2 on four seeds.  Each limit lies between,
# with room on both sides.  (Before the fold's test read exactly 1 beyond
# the edge opposite vertex 2, each side's last bit picked the texel of
# those pixels, and the sound readings reached 7e-4, 1.9e-2 and 1.4e-2.)
LIMITS = dict(loss=5e-5, grad=5e-3, change=5e-3)


@pytest.fixture
def level1_template(monkeypatch):
    """ShapeModel(42): the level-1 icosphere as the sphere template."""
    whole = data.sphere
    monkeypatch.setattr(data, 'sphere', lambda n: data.icosphere(LEVEL)
                        if n == 42 else whole(n))


def readings(backend, texture_res, seed):
    """(the port's, the reference's) dict(losses, grads, change) of three
    steps from seeded parameters."""
    args = FT.parse_args(['--device', 'cpu', '-is', str(SIZE), '--chain',
                          '1', '--texture-res', str(texture_res)])
    args.num_vertices = 42
    fit = FT.TexturedFit(args, 'cpu', backend)
    tv, tf = G.icosphere(LEVEL)
    goal_v, goal_f = FT.pinched_sphere(LEVEL)
    goal = (goal_v, goal_f, FT.goal_textures(goal_f.shape[0], texture_res,
                                             seed))
    eyes = FT.view_eyes(VIEWS[0])[list(VIEWS[1])]
    fit.begin(eyes, fit.goal_images(*goal, eyes))
    rng = np.random.RandomState(seed)
    names = ('displace', 'center', 'texture')
    start = dict(
        displace=0.3 * rng.randn(1, tv.shape[0], 3),
        center=0.1 * rng.randn(1, 1, 3),
        texture=rng.randn(1, tf.shape[0], texture_res ** 2, 3))
    start = {k: torch.as_tensor(v, dtype=torch.float32)
             for k, v in start.items()}
    with torch.no_grad():
        for name, p in zip(names, fit.parameters()):
            p.copy_(start[name])
    row = fit.renderer.params_vector()[None]
    losses = [float(fit.steps.run({'par': row})[0, 0])]
    b1 = fit.opt.param_groups[0]['betas'][0]
    grads = {k: fit.opt.state[p]['exp_avg'] / (1 - b1)
             for k, p in zip(names, fit.parameters())}
    losses += [float(fit.steps.run({'par': row})[0, 0]) for _ in range(2)]
    change = {k: p.detach() - start[k]
              for k, p in zip(names, fit.parameters())}
    cfg = dict(run.load_spec('gendr.textured')['cfg'], image_size=SIZE)
    ref = RT.follow((tv, tf), goal, eyes, start, cfg, 3, 'cpu')
    return dict(losses=losses, grads=grads, change=change), ref


def over(gaps):
    return {k: (gaps[k], lim) for k, lim in LIMITS.items() if gaps[k] > lim}


@pytest.mark.parametrize('backend,texture_res,seed', [
    ('torch', 2, 3), ('torch', 5, 4), ('cuda', 5, 5)])
def test_the_fit_agrees_with_the_reference(level1_template, backend,
                                           texture_res, seed):
    """backend 'cuda' on CPU tensors runs the kernels' plain versions,
    per-tile face compaction on (80 faces over 16 tiles: one slab a
    tile)."""
    prog, ref = readings(backend, texture_res, seed)
    assert all(np.isfinite(prog['losses']))
    gaps = run.gaps(prog, ref)
    assert not over(gaps), gaps


def swapped_fold(w_clip, R):
    """surface_texel_index with the grid's two triangles swapped."""
    w_x = torch.floor(w_clip[0] * R).to(torch.int32)
    w_y = torch.floor(w_clip[1] * R).to(torch.int32)
    lower = (w_clip[0] + w_clip[1]) * R - w_x.to(torch.float32) \
        - w_y.to(torch.float32) <= 1.0
    idx = torch.where(lower, (R - 1 - w_y) * R + (R - 1 - w_x),
                      w_y * R + w_x)
    return torch.clamp(idx, 0, R * R - 1)


@pytest.mark.parametrize('texture_res,seed', [(2, 3), (5, 4)])
def test_the_swapped_texel_fold_fails(level1_template, monkeypatch,
                                      texture_res, seed):
    monkeypatch.setattr(RG, 'surface_texel_index', swapped_fold)
    prog, ref = readings('torch', texture_res, seed)
    assert over(run.gaps(prog, ref))


def test_the_step_marks_its_shading_and_pool(level1_template):
    """A recorded step's phases hold the shading and the pool both ways,
    in the step's order."""
    from gendr_tpu_torch.utils import profiling
    args = FT.parse_args(['--device', 'cpu', '-is', '8', '--chain', '1',
                          '--texture-res', '2'])
    args.num_vertices = 42
    fit = FT.TexturedFit(args, 'cpu')
    eyes = FT.view_eyes('24@30')[:2]
    v, f = FT.pinched_sphere(LEVEL)
    fit.begin(eyes, fit.goal_images(v, f, FT.goal_textures(f.shape[0], 2, 0),
                                    eyes))
    rec = profiling.Recorder('cpu')
    with profiling.recording(rec):
        fit.train_step(fit.eyes, fit.targets)
        profiling.mark('end')
    names = [n for n, _ in rec.marks]
    assert {'shade', 'shade.bwd', 'aa', 'aa.bwd', 'render', 'render.bwd',
            'geometry', 'geometry.bwd', 'loss', 'adam'} <= set(names)
    assert names.index('shade') < names.index('render') < names.index('aa')
    assert names.index('aa.bwd') < names.index('render.bwd') \
        < names.index('shade.bwd')


def test_an_edge_on_face_passes_no_light_gradient():
    """Lighting()'s Lambert term is upstream's relu(n . l): a normal
    edge-on to the light (n . l exactly 0, as the template sphere's
    equator is to the light along +y at the fit's start) passes its
    normal no gradient, one turned a little toward the light passes it
    all, one turned a little away none."""
    from gendr_tpu_torch.geometry.lighting import directional_lighting
    normals = torch.tensor([[[1.0, 0.0, 0.0], [0.0, 1e-3, 1.0],
                             [0.0, -1e-3, 1.0]]], requires_grad=True)
    directional_lighting(torch.zeros(1, 3, 3), normals).sum().backward()
    g = normals.grad[0, :, 1]
    assert g[0] == 0 and g[2] == 0 and g[1] > 0
