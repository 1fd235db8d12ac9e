"""``opt_camera``'s chained step on the compacted path, on the CPU.

At 128² the camera experiment's 1 280-face mesh gets per-tile face
compaction (``cuda_backend._compaction``): the plan
(``pack.compact_plan``), the forward on the compacted tile lists, the slab
chunks' backward and ``unpermute_grads`` through the plan's ``oct_ids``.
Here the same path runs through the kernels' plain versions
(``backend='cuda'`` on CPU tensors) at a shape where compaction fires with
the same density arithmetic: 4 poses at 32² on the level-1 stand-in (80
faces padded to one chunk of 128, 4 tiles, r = 128 / (8 · 4) = 4).  The
step, chained as the command line chains it, is held to the benchmark's
plain reference (``benchmark/reference/camera.follow``) and to the same
step with compaction off; a traced block's census counts what compaction
did and its phase table splits the plan off the prepass.
"""

import numpy as np
import pytest
import torch

from benchmark.drivers import camera as D
from benchmark.reference import camera as ref
from benchmark.reference import geometry as G
from gendr_tpu_torch import utils
from gendr_tpu_torch.experiments import opt_camera as OC
from gendr_tpu_torch.raster import cuda_backend as CB
from gendr_tpu_torch.raster.render import render_config
from gendr_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401

B, SIZE, CHAIN = 4, 32, 3
CFG = dict(mesh=dict(level=1, scale=[0.8, 0.56, 0.56], pinch=0.5),
           image_size=SIZE, batch_size=B, learning_rate=0.3,
           betas=[0.5, 0.99], dist_func='logistic', dist_eps=100)
# the benchmark's compared steps run at check_tau, after a first step at
# the window's tau whose loss alone is compared: at 32² no pixel centre
# lies within the logistic's reach of an edge at 1e-7, so it has no
# gradient
CHECK_TAU, TAU = 1e-3, 1e-7
# against the reference: both sides in float32, with other expressions for
# a pixel's distance to an edge (the packed rows' against the reference's
# own), which move a coverage near an edge by a few ulps.  These poses read
# 1.6e-7, 7.1e-6 and 4.6e-6; the reference computed in bfloat16 reads
# 1.4e-2, 0.55 and 0.43.  (Other poses at this shape put a sliver face's
# coverage further off, PERF.md's Open questions: up to 4.5e-5 and 4e-3.)
REF_LOSS, REF_GRAD, REF_CHANGE = 1e-5, 1e-3, 1e-4
# against compaction off: the same pair math on the same faces, only the
# fold's order of the faces and the slots' sum onto their faces differ, a
# few ulps
OFF_LOSS, OFF_GRAD, OFF_CHANGE = 1e-6, 1e-5, 1e-5


@pytest.fixture(scope='module')
def obj(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('standin') / 'standin.obj')
    v, f = D.mesh(CFG)
    G.write_obj(path, v, f)
    return path


def _experiment(obj):
    args = OC.parse_args(['--model_obj', obj, '-bs', str(B), '-is',
                          str(SIZE), '--chain', str(CHAIN), '--device',
                          'cpu', '--backend', 'cuda'])
    exp = OC.CameraExperiment(args, 'cpu', args.backend)
    exp.begin(OC.initial_poses(B, 15, 35))
    return exp


def _steps(obj, tau, n):
    """n chained steps at tau from the command line's starting poses:
    (losses, the first gradient as Adam's state holds it, the poses'
    change)."""
    exp = _experiment(obj)
    steps = exp.chain('iou')
    rows = exp.diff_renderer.params_vector(dist_scale=tau)[None] \
        .repeat(n, 1)
    losses = steps.run({'par': rows[:1]})[:, 0].tolist()
    grad = exp.opt.state[exp.poses]['exp_avg'] / (1.0 - 0.5)
    if n > 1:
        losses += steps.run({'par': rows[1:]})[:, 0].tolist()
    change = exp.poses.detach() - torch.as_tensor(OC.initial_poses(B, 15,
                                                                   35))
    return np.array(losses), grad.clone(), change


def _reference(obj, tau, n):
    r = ref.follow(obj, OC.goal_poses(B), OC.initial_poses(B, 15, 35), CFG,
                   tau, n, 'cpu')
    return np.array(r['losses']), r['grads']['poses'], r['change']['poses']


def _gaps(a, b):
    """(the widest relative gap of the losses, of the gradients' norms
    and of the changes' norms)."""
    la, ga, ca = a
    lb, gb, cb = b
    return (float(np.max(np.abs(la - lb) / np.abs(lb))),
            float((ga - gb).norm() / gb.norm()),
            float((ca - cb).norm() / cb.norm()))


def test_compaction_fires_at_this_shape(obj):
    exp = _experiment(obj)
    cfg, _ = render_config(**exp.diff_renderer.render_kwargs())
    F = D.mesh(CFG)[1].shape[0]
    Fp = -(-F // cfg.face_chunk) * cfg.face_chunk
    assert (F, Fp) == (80, 128)
    assert CB._compaction(cfg, 1, Fp, None, True) > 0


def test_chained_step_against_the_reference(obj):
    prog = _steps(obj, CHECK_TAU, 3)
    loss, grad, change = _gaps(prog, _reference(obj, CHECK_TAU, 3))
    assert loss < REF_LOSS and grad < REF_GRAD and change < REF_CHANGE, \
        (loss, grad, change)
    timed = _steps(obj, TAU, 1)[0]
    want = _reference(obj, TAU, 1)[0]
    assert float(np.max(np.abs(timed - want) / want)) < REF_LOSS


def test_chained_step_against_compaction_off(obj, monkeypatch):
    prog = _steps(obj, CHECK_TAU, 3)
    monkeypatch.setattr(CB, '_compaction', lambda *a, **k: 0)
    loss, grad, change = _gaps(prog, _steps(obj, CHECK_TAU, 3))
    assert loss < OFF_LOSS and grad < OFF_GRAD and change < OFF_CHANGE, \
        (loss, grad, change)


def test_a_traced_block_counts_compaction_and_splits_its_phase(obj,
                                                               tmp_path):
    profiling.reset_phases()
    exp = _experiment(obj)
    rows = exp.diff_renderer.params_vector(dist_scale=TAU)[None] \
        .repeat(CHAIN, 1)
    try:
        with utils.trace(str(tmp_path)):
            exp.chain('iou').run({'par': rows})
        counts = profiling.counter_table()
        phases = profiling.phase_table()
    finally:
        profiling.reset_phases()
    got = {k: v['sum'] for k, v in counts.items()}
    assert {v['samples'] for v in counts.values()} == {1}
    assert got['compact.tiles_slab'] > 0
    assert got['compact.tiles_slab'] <= got['compact.tiles_hit'] <= B * 4
    # one slab of 128 slots a tile
    assert got['compact.slots'] == B * 4 * 128
    assert 0 < got['compact.slots_used'] <= got['compact.slots']
    assert {'prepass', 'compact', 'raster'} <= set(phases)
    names = [n for n, _ in exp.chain('iou').recorder.marks]
    i = names.index('compact')
    assert names[i - 1:i + 3] == ['prepass', 'compact', 'prepass', 'raster']
