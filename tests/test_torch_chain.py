"""``--chain`` of the port's three experiments on the CPU, and the
parameter vector that a chained step reads from a static buffer.

A chained run (``--chain 3`` over 4 steps: a block of 3, then a tail block
of 1) against the step-by-step run (``--chain 1``) of opt_shape at 16x16,
opt_camera and train_reconstruction --synthetic: per-step losses, hard
losses, steps-to-threshold and the final parameters bitwise equal, under
``torch.use_deterministic_algorithms`` with one thread (on the CPU a block
is a plain loop of the same step; ``--chain 1`` is held against the JAX
scripts by test_torch_train.py, test_torch_camera.py and
test_torch_reconstruction.py).  The reconstruction's block lengths against
a transcription of the JAX script's rule; the vector bitwise equal to the
one the render path derived before it moved onto the device, for every
distribution and alpha mode; the command-line defaults against the JAX
scripts'.
"""

import ast
import itertools
import os

import numpy as np
import pytest
import torch

from gendr_tpu_torch import GenDR, config as C
from gendr_tpu_torch.experiments import common
from gendr_tpu_torch.experiments import opt_camera as OC
from gendr_tpu_torch.experiments import opt_shape as OS
from gendr_tpu_torch.experiments import train_reconstruction as TR
from gendr_tpu_torch.raster import cuda_backend as CB
from gendr_tpu_torch.raster import pack
from gendr_tpu_torch.raster import pairmath as PM
from gendr_tpu_torch.raster import render as R
from gendr_tpu_torch.raster import torch_backend as TB
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 4
CHAIN = 3


@pytest.fixture
def deterministic():
    """Deterministic algorithms, beside the module's one intra-op thread
    (tests/torch_threads.py): two runs of the same steps then agree
    bitwise (test_torch_reconstruction_cli.py)."""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


# ---------------------------------------------------------------------------
# opt_shape
# ---------------------------------------------------------------------------

def _shape_run(chain, criterion_threshold=None):
    args = OS.parse_args(['-is', '16', '--device', 'cpu', '--model_obj',
                          'proc_cube.obj', '--chain', str(chain)])
    args.num_vertices = 162
    exp = OS.ShapeExperiment(args, 'cpu')
    cameras, images = exp.goals(args.model_obj)
    eyes, targets = exp.view_set(cameras, images, '24@30')
    eyes, targets = eyes[:4], targets[:4]
    rec = exp.run(10 ** -1.5, 3e-2, eyes, targets, STEPS)
    params = {k: v.detach().clone() for k, v in
              exp.model.named_parameters()}
    args.criterion = 'steps_to_threshold'
    args.num_iterations = STEPS
    args.loss_threshold = criterion_threshold or 0.0
    first = exp.execute_setting(10 ** -1.5, 3e-2, eyes, targets)
    return rec, params, first, exp


def test_opt_shape_chain_equals_step_by_step(deterministic):
    one, p_one, _, e_one = _shape_run(1)
    # a threshold crossed after the first step: the bookkeeping over a
    # block's vector of hard losses gives the step-by-step index
    h = np.minimum.accumulate(one['hard_losses'])
    threshold = float(h[1]) + 1e-7
    one, p_one, first_one, e_one = _shape_run(1, threshold)
    chained, p_chained, first_chained, e_chained = _shape_run(CHAIN,
                                                              threshold)
    assert len(one['hard_losses']) == STEPS
    assert chained['losses'] == one['losses']
    assert chained['hard_losses'] == one['hard_losses']
    assert chained['grads_finite'] and one['grads_finite']
    assert first_chained == first_one < STEPS
    for k in p_one:
        assert torch.equal(p_chained[k], p_one[k]), k
    # blocks of 3 + 1 fetch twice a run, step by step once a step; two runs
    assert e_chained.steps.fetches == 2 * 2
    assert e_one.steps.fetches == 2 * STEPS


# ---------------------------------------------------------------------------
# opt_camera
# ---------------------------------------------------------------------------

def _camera_run(chain):
    args = OC.parse_args(['--device', 'cpu', '-is', '16', '-bs', '4', '-ni',
                          str(STEPS), '--model_obj', 'proc_cube.obj',
                          '--chain', str(chain)])
    exp = OC.CameraExperiment(args, 'cpu')
    rec = exp.run(OC.initial_poses(4, 15, 35))
    return rec, exp


def test_opt_camera_chain_equals_step_by_step(deterministic):
    one, e_one = _camera_run(1)
    chained, e_chained = _camera_run(CHAIN)
    assert one['iterations'] == chained['iterations'] == STEPS
    assert chained['losses'] == one['losses']
    assert np.isfinite(one['losses']).all()
    np.testing.assert_array_equal(chained['poses'], one['poses'])
    # each step annealed: the buffer holds the last step's vector
    want = e_one.diff_renderer.params_vector(
        dist_scale=float(np.logspace(-1, -7, STEPS)[-1]))
    assert torch.equal(e_chained.par, want) and torch.equal(e_one.par, want)
    assert e_chained.chains['iou'].fetches == 2
    assert e_one.chains['iou'].fetches == STEPS


def test_opt_camera_gif_forces_one_step_a_block():
    """--gif samples a frame every 20 steps of the step-by-step run: a run
    with a writer fetches once a step whatever --chain says."""
    args = OC.parse_args(['--device', 'cpu', '-is', '16', '-bs', '4', '-ni',
                          '3', '--model_obj', 'proc_cube.obj'])
    assert args.chain == 20
    exp = OC.CameraExperiment(args, 'cpu')
    frames = []
    rec = exp.run(OC.initial_poses(4, 15, 35), writer=frames)
    assert rec['iterations'] == 3 and exp.chains['iou'].fetches == 3
    assert len(frames) == 1 and frames[0].dtype == np.uint8


def test_opt_shape_gif_forces_one_step_a_block():
    args = OS.parse_args(['-is', '16', '--device', 'cpu'])
    assert args.chain == 10
    args.num_vertices = 162
    exp = OS.ShapeExperiment(args, 'cpu')
    # the frame is a grid of 24 views
    eyes = torch.tensor([[0.0, 0.0, -2.7]] * 24)
    targets = torch.zeros((24, 16, 16))
    frames = []
    rec = exp.run(10 ** -1.5, 3e-2, eyes, targets, 3, writer=frames)
    assert len(rec['hard_losses']) == 3 and len(frames) == 3
    assert exp.steps.fetches == 3


# ---------------------------------------------------------------------------
# train_reconstruction
# ---------------------------------------------------------------------------

def _recon_cli(tmp_path, chain, *extra):
    ckpt = str(tmp_path / f'chain{chain}{"".join(extra)}')
    res = TR.main(['--synthetic', '--class_ids', 'syn_ellipsoid',
                   '--synthetic-objects', '1', '--image_size', '16',
                   '--batch_size', '2', '--max-eval-batches', '1',
                   '--device', 'cpu', '-ni', str(STEPS), '--print_freq',
                   '100', '--eval_freq', str(STEPS), '--decay-at', '3',
                   '--chain', str(chain), '--checkpoint-dir', ckpt, *extra])
    state = torch.load(TR._checkpoints(ckpt)[-1], weights_only=True)
    return res, state


def _assert_states_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _assert_states_equal(a[k], b[k])
        elif isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_train_reconstruction_chain_equals_step_by_step(tmp_path,
                                                        deterministic):
    """--decay-at 3 stops the first block of 3 after 2 steps: blocks of 2
    and 2, against 4 of 1; the losses, the model, BatchNorm's statistics,
    Adam's state and the batch stream after step 4 bitwise equal."""
    one, s_one = _recon_cli(tmp_path, 1)
    chained, s_chained = _recon_cli(tmp_path, CHAIN)
    assert len(one['losses']) == STEPS
    assert chained['losses'] == one['losses']
    assert chained['grads_finite'] and one['grads_finite']
    assert chained['mean_iou'] == one['mean_iou']
    assert s_one['iteration'] == s_chained['iteration'] == STEPS
    _assert_states_equal(s_chained, s_one)
    assert chained['steps'].fetches == 2 and one['steps'].fetches == STEPS
    # --host-data: the block's image batches staged from host memory, the
    # same steps on the same pixels
    host, s_host = _recon_cli(tmp_path, CHAIN, '--host-data')
    assert 'images' in host['steps'].inputs
    assert 'ids' in chained['steps'].inputs
    assert host['losses'] == one['losses']
    _assert_states_equal(s_host, s_one)


def _jax_block_length(i, chain, num_iterations, decay_at, print_freq,
                      eval_freq):
    """experiments/train_reconstruction.py:771-779, transcribed."""
    n = min(chain, num_iterations - i + 1)
    if i < decay_at < i + n:
        n = decay_at - i
    nxt_print = ((i - 1) // print_freq + 1) * print_freq
    nxt_eval = ((i - 1) // eval_freq + 1) * eval_freq
    n = max(1, min(n, nxt_print - i + 1, nxt_eval - i + 1))
    return n


@pytest.mark.parametrize('chain', [1, 2, 3, 5, 8])
def test_block_length_follows_the_jax_rule(chain):
    """Every start i of runs up to 14 steps, decay points 1-15, print and
    eval periods 1-6: the same length as the JAX rule; the blocks of a run
    cover its steps once and end on every print, eval and the step before
    the decay."""
    for ni, decay_at, pf, ef in itertools.product(range(1, 15), range(1, 16),
                                                  range(1, 7), range(1, 7)):
        i, ends = 1, []
        while i <= ni:
            n = TR.block_length(i, chain, ni, decay_at, pf, ef)
            assert n == _jax_block_length(i, chain, ni, decay_at, pf, ef)
            assert 1 <= n <= chain and i + n - 1 <= ni
            assert not i < decay_at < i + n
            ends.append(i + n - 1)
            i += n
        assert ends[-1] == ni
        for k in range(1, ni + 1):
            if k % pf == 0 or k % ef == 0 or k + 1 == decay_at:
                assert k in ends, (ni, decay_at, pf, ef, k)


# ---------------------------------------------------------------------------
# the command lines
# ---------------------------------------------------------------------------

def _jax_chain_default(script):
    """The default of --chain in the JAX script experiments/<script>."""
    tree = ast.parse(open(os.path.join(ROOT, 'experiments', script)).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and node.args
                and isinstance(node.args[0], ast.Constant)
                and node.args[0].value == '--chain'):
            return next(k.value.value for k in node.keywords
                        if k.arg == 'default')
    raise AssertionError(f'no --chain in {script}')


def test_chain_defaults_are_the_jax_scripts():
    assert OS.parse_args([]).chain == _jax_chain_default('opt_shape.py') \
        == 10
    assert OC.parse_args([]).chain == _jax_chain_default('opt_camera.py') \
        == 20
    args = TR.parse_args([])
    assert args.chain == _jax_chain_default('train_reconstruction.py') == 0
    # 0: 8 on the accelerator, 1 elsewhere (the JAX script's 8 on the TPU)
    assert TR.chain_length(args, 'cuda') == 8
    assert TR.chain_length(args, 'cpu') == 1
    assert TR.chain_length(TR.parse_args(['--chain', '3']), 'cpu') == 3


def test_chain_capture_only_on_the_card(capsys):
    assert common.chain_capture('cuda', 8)
    assert not common.chain_capture('cuda', 1)
    assert not common.chain_capture('cpu', 8)
    assert capsys.readouterr().out == ''
    assert not common.chain_capture('cuda', 8, '--host-data: why')
    assert capsys.readouterr().out == \
        'chain: loop (not captured: --host-data: why)\n'


# ---------------------------------------------------------------------------
# the parameter vector
# ---------------------------------------------------------------------------

def _previous_params_vec(params, cfg):
    """The vector as the render path derived it before it moved onto the
    device: every parameter pinned to the CPU, one [16] vector."""
    f32 = torch.float32
    p = {k: torch.as_tensor(v, dtype=f32).cpu() for k, v in params.items()}
    margin = pack.cull_margin(cfg, p)
    bg = p['background_color'].reshape(3)
    return torch.stack([
        p['dist_scale'], p['dist_shape'], p['dist_shift'],
        p['dist_eps'] * p['dist_scale'], p['aggr_alpha_t_conorm_p'],
        p['aggr_rgb_eps'], p['aggr_rgb_gamma'], p['near'], p['far'],
        torch.exp(-torch.lgamma(p['dist_shape'] + 1.0)),
        torch.exp(-torch.lgamma(torch.clamp(p['dist_shape'], min=1e-6))),
        bg[0], bg[1], bg[2], torch.zeros((), dtype=f32), margin.to(f32)])


# a valid t-conorm parameter for each alpha mode (render's eager check)
T_CONORM_P = {C.HAMACHER_TCN: 0.5, C.FRANK_TCN: 2.0, C.YAGER_TCN: 2.0,
              C.ACZEL_ALSINA_TCN: 1.5, C.DOMBI_TCN: 2.0,
              C.SCHWEIZER_SKLAR_TCN: -1.0}


@pytest.mark.parametrize('alpha', sorted(set(C.AGGR_ALPHA_FUNC_MAP.values())))
@pytest.mark.parametrize('dist', sorted(set(C.DIST_FUNC_MAP.values())))
def test_vector_equals_the_previous_derivation(dist, alpha):
    """For every distribution and alpha mode, with a shape, a shift and a
    background: GenDR.params_vector, its rows over a schedule of 5 taus
    (what a chained block copies to the device once) and the vector a
    render hands its backend equal the previous derivation bitwise."""
    shape = 0.7 + 0.1 * dist
    kw = dict(dist_func=dist, dist_shape=shape, dist_shift=0.05 * alpha,
              dist_eps=300.0, aggr_alpha_func=alpha,
              aggr_alpha_t_conorm_p=T_CONORM_P.get(alpha, 0.0),
              background_color=(0.2, 0.1, 0.3), image_size=16,
              channels='alpha', aggr_rgb_func='hard')
    taus = np.logspace(-1, -7, 5)
    renderer = GenDR(dist_scale=1e-2, **kw)
    schedule = renderer.params_vector(dist_scale=torch.from_numpy(taus))
    assert schedule.shape == (5, PM.NPAR) and schedule.dtype == torch.float32
    for k, tau in enumerate(taus):
        r = GenDR(dist_scale=float(tau), **kw)
        cfg, params = R.render_config(**r.render_kwargs())
        want = _previous_params_vec(params, cfg)
        got = r.params_vector()
        assert torch.equal(got, want)
        assert torch.equal(schedule[k], want)
        # the dict a render hands the backends: views of that vector
        host = PM.params_vector(params, cfg)
        dev_params = PM.vector_params(host)
        assert torch.equal(PM._params_vec(dev_params, cfg), want)
        assert torch.equal(CB.prepass(
            torch.zeros((1, 1, 9)), torch.zeros((1, 1, 1, 3)), cfg,
            dev_params)['par'], want)


def _scene(seed=0, B=1, F=12, TS=1):
    rng = np.random.RandomState(seed)
    centre = rng.uniform(-0.6, 0.6, (B, F, 1, 2))
    xy = centre + rng.uniform(-0.3, 0.3, (B, F, 3, 2))
    z = rng.uniform(2.0, 4.0, (B, F, 3, 1))
    fv = torch.from_numpy(np.concatenate([xy, z], -1).astype(np.float32))
    tex = torch.from_numpy(rng.uniform(0, 1, (B, F, TS, 3))
                           .astype(np.float32))
    return fv.reshape(B, F, 9), tex


@pytest.mark.parametrize('backend', ['torch', 'cuda'])
@pytest.mark.parametrize('rgb', ['hard', 'softmax'])
def test_eager_render_unchanged(backend, rgb):
    """render and GenDR (by their own vector, or by par) against the
    backends called with the params dict of config.RenderParams, which
    derive the vector themselves: forward and gradient bitwise (on CPU
    tensors backend='cuda' runs the kernels' plain versions)."""
    fv, tex = _scene()
    kw = dict(image_size=16, dist_func='logistic', dist_scale=3e-2,
              aggr_rgb_func=rgb, background_color=(0.2, 0.1, 0.3),
              backend=backend)
    cfg, params = R.render_config(**{**GenDR(**kw).render_kwargs()})
    mod = CB if backend == 'cuda' else TB

    def run(fn):
        f = fv.clone().requires_grad_(True)
        t = tex.clone().requires_grad_(True)
        img = fn(f, t)
        (img * torch.linspace(0, 1, img.numel()).reshape(img.shape)) \
            .sum().backward()
        return img.detach(), f.grad, t.grad

    class Direct(torch.autograd.Function):
        @staticmethod
        def forward(ctx, f, t):
            sc, ag, aux = mod.forward_with_aux(f, t, cfg, params)
            ctx.save_for_backward(f, t, sc, ag)
            ctx.aux = aux
            return sc

        @staticmethod
        def backward(ctx, g):
            f, t, sc, ag = ctx.saved_tensors
            return mod.backward_from_aux(f, t, ctx.aux, sc, ag, g, cfg,
                                         params)

    want = run(Direct.apply)
    renderer = GenDR(**kw)
    for got in (run(lambda f, t: R.render(f, t, **renderer.render_kwargs())),
                run(renderer.forward_tensors),
                run(lambda f, t: renderer.forward_tensors(
                    f, t, par=renderer.params_vector()))):
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_render_checks_par():
    fv, tex = _scene()
    with pytest.raises(ValueError, match='par must be'):
        R.render(fv, tex, image_size=16, par=torch.zeros(15))
    with pytest.raises(ValueError, match='par must be'):
        R.render(fv, tex, image_size=16,
                 par=torch.zeros(PM.NPAR, dtype=torch.float64))


def test_module_keeps_its_device_copy():
    """GenDR copies its vector to a device once while its parameters stay
    the same (a 'meta' tensor stands in for the card here)."""
    r = GenDR(dist_scale=1e-2)
    meta = torch.device('meta')
    first = r._device_vector(meta)
    assert first.device == meta and r._device_vector(meta) is first
    r.dist_scale = 2e-2
    second = r._device_vector(meta)
    assert second is not first and r._device_vector(meta) is second
    # a tensor parameter on the CPU: compared by the vector it gives
    r.dist_scale = torch.tensor(2e-2)
    assert r._device_vector(meta) is second
    r.dist_scale.fill_(3e-2)
    assert r._device_vector(meta) is not second
    # on the CPU the vector is the derivation itself
    assert torch.equal(r._device_vector(torch.device('cpu')),
                       r.params_vector())


def test_step_chain_restores_nothing_in_a_loop():
    """Without capture a block is the step in a loop: row j of each input
    in its buffer at step j, the results stacked, one fetch a block."""
    buf = torch.zeros(2)
    seen = []

    def step():
        seen.append(buf.clone())
        return buf * 2

    chain = common.StepChain(step, {'x': buf})
    out = chain.run({'x': np.arange(6, dtype=np.float32).reshape(3, 2)})
    assert torch.equal(out, 2 * torch.arange(6.0).reshape(3, 2))
    assert [s.tolist() for s in seen] == [[0, 1], [2, 3], [4, 5]]
    assert chain.fetches == 1 and chain.replays == 0 and chain.graph is None
