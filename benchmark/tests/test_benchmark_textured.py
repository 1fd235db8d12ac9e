"""The textured fit's cell, gendr.textured: its driver's pair count, its
plain reference's imports and precision, its files, and whole runs of the
harness at a tiny size on the CPU (the program's plain torch backend
there): the sound run is correct, a planted fault is not."""

import ast
import json
import os

import pytest
import torch

from benchmark import calibrate, run
from benchmark.drivers import textured as D
from benchmark.reference import geometry as G
from benchmark.reference import raster as R
from conftest import ROOT

CELL = 'gendr.textured'
# at 2 views of 16x16 most texels are seen by a pixel or two, their
# gradients near zero, and Adam's first steps move such an entry by the
# learning rate whatever its size: the first gradient agrees to 6.3e-5 on
# five seeds, but the later steps' losses to 2.7e-3 and the change to
# 2.1e-2, wider than at the cell's 24 views of 512x512.  The bfloat16
# control reads 2.3 on the gradient, half the views 2.3.
TINY_LIMITS = dict(loss=1e-2, grad=1e-3, change=0.05)


def tiny_spec(**traffic):
    """The cell at 2 views of 8x8 (16x16 rendered) on the 162-vertex
    template, the goal the level-1 pinched icosphere."""
    spec = run.load_spec(CELL)
    spec['cfg'].update(image_size=8, num_vertices=162)
    spec['cfg']['mesh']['level'] = 1
    spec['traffic'].update(views='2@30', chain=2, trace_steps=2, **traffic)
    spec['limits'] = TINY_LIMITS
    return spec


def brute_pairs(xy, S, margin):
    """Every (pixel, face) pair whose pixel centre lies in the face's bbox
    widened by margin, counted pixel by pixel."""
    c = (2 * torch.arange(S, dtype=torch.float64) + 1 - S) / S
    xy = xy.double()
    lo, hi = xy.amin(2) - margin, xy.amax(2) + margin      # [B, F, 2]
    inx = (c >= lo[..., :1]) & (c <= hi[..., :1])          # [B, F, S]
    iny = (c >= lo[..., 1:]) & (c <= hi[..., 1:])
    return float((inx.sum(-1) * iny.sum(-1)).sum())


def test_the_pair_count_is_the_brute_force_count():
    spec = tiny_spec()
    cfg, tr = spec['cfg'], spec['traffic']
    v, f = D.template(cfg['num_vertices'])
    xy = D.ref.screen_faces(torch.as_tensor(v)[None] * 0.5,
                            torch.as_tensor(f, dtype=torch.long),
                            D.eyes(tr['views'], 'cpu'))[..., :2]
    S = 2 * cfg['image_size']
    margin = R.cull_margin('uniform', tr['tau'], cfg['dist_eps'])
    want = brute_pairs(xy, S, margin)
    assert want > 0
    assert D.start_pairs(cfg, tr['tau'], tr['views'], 'cpu') == want


def test_the_eyes_are_opt_shapes_view_set():
    e = D.eyes('24@30', 'cpu')
    want = G.points_from_angles(torch.full((24,), 2.732),
                                torch.full((24,), 30.0),
                                -15.0 * torch.arange(24.0))
    assert torch.allclose(e, want, atol=1e-6)


def test_the_reference_imports_nothing_of_the_program_and_no_tf32():
    path = os.path.join(ROOT, 'benchmark', 'reference', 'textured.py')
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split('.')[0])
    assert not names & {'jax', 'jaxlib', 'flax', 'optax', 'gendr_tpu',
                        'gendr_tpu_torch'}
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        import importlib
        import benchmark.reference.textured as T
        importlib.reload(T)
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def test_the_cells_files_parse():
    bench = json.load(open(os.path.join(ROOT, 'BENCHMARK.json')))
    cell = {w['name']: w for w in bench['workloads']}[CELL]
    spec = run.load_spec(CELL)
    assert cell['chips'] == 1 and spec['cfg']['driver'] == 'textured'
    assert spec['cfg']['reduced'] == []
    assert set(spec['traffic']) == {'tau', 'views', 'chain', 'restart',
                                    'trace_steps'}
    assert set(spec['limits']) == set(TINY_LIMITS)
    assert all(v > 0 for v in spec['limits'].values())
    assert {m['name'] for m in spec['end_to_end']} == {'step_ms', 'setup_s'}
    assert {m['name'] for m in spec['per_layer']} == {
        'fwd_roofline.textured', 'bwd_roofline.textured',
        'render_bwd_ms.textured', 'prepass_ms.textured',
        'shade_ms.textured', 'launches_per_step.textured'}


def test_the_tiny_cell_agrees_with_the_reference():
    result, info = run.run_cell(tiny_spec(), 2 ** 31 + 41, 0.2, 0,
                                device='cpu')
    assert result['correct'], result['checks']
    assert run.forbidden_loaded() == []
    assert result['attempted'] > 0 and result['failed'] == 0
    assert set(result['metrics']) == {'step_ms', 'setup_s'}
    assert set(result['checks']) == {'loss_gap', 'grad_gap', 'change_gap',
                                     'nonfinite_steps'}
    w = info['run'].work
    assert w['fwd_flops'] == D.FWD_FLOPS_PER_PAIR * w['pairs'] > 0


@pytest.mark.parametrize('fault', ['frozen', 'half_batch'])
def test_a_fault_is_not_correct(fault):
    result, _ = run.run_cell(tiny_spec(), 43, 0.2, 0, device='cpu',
                             fault=fault)
    assert not result['correct'], result['checks']


def test_the_bfloat16_control_fails():
    spec = tiny_spec()
    g, _, _, _ = calibrate.reading(spec, 47, 'control', 'cpu')
    assert any(g[k] > lim for k, lim in spec['limits'].items()), g
