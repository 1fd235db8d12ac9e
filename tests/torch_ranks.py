"""Rank side of tests/test_torch_sharding.py: gloo ranks on the CPU that run
the port's sharded render on numpy scenes and save what they computed.

Kept apart from the test file so that a spawned rank imports torch and
gendr_tpu_torch only, not jax.  Each case is a dict: 'kind' ('forward',
'grad', 'aggrs' or 'dryrun'), the mesh 'axes', the RenderConfig keywords
'cfg', the port's params dict 'params', the full-batch scene 'fv' [B, F, 9]
and 'tex' [B, F, TS, 3] (numpy), 'backend' and 'sp_axis'.  A rank passes
its dp shard and keeps what it got for it.
"""

import os

import torch
import torch.distributed as dist

from gendr_tpu_torch import config as C
from gendr_tpu_torch.parallel import sharding as S


def _loss(img):
    # tests/test_sharding.py's loss
    return (img[:, 3] ** 2).sum() + (img[:, :3] * 0.3).sum()


def run_case(case):
    if case['kind'] == 'dryrun':
        return S.dryrun_multichip(case['n'], device='cpu')
    c0 = S.collective_seconds()
    mesh = S.make_mesh(case['axes'])
    cfg = C.RenderConfig.create(**case['cfg'])
    fv = S.shard_batch(torch.tensor(case['fv']), mesh)
    tex = S.shard_batch(torch.tensor(case['tex']), mesh)
    out = dict(coord=dict(mesh.coord))
    kw = dict(fp_axis='fp', sp_axis=case.get('sp_axis'),
              backend=case['backend'])
    if case['kind'] == 'forward':
        out['image'] = S.render_sharded(fv, tex, cfg, case['params'], mesh,
                                        **kw).numpy()
    elif case['kind'] == 'aggrs':
        _, _, aggrs, _ = S._forward(fv, tex, cfg, case['params'], mesh,
                                    kw['fp_axis'], kw['sp_axis'],
                                    kw['backend'])
        out['aggrs'] = aggrs.numpy()
    else:
        fv.requires_grad_(True)
        tex.requires_grad_(True)
        render_fn = S.make_sharded_render(cfg, mesh, 'dp', **kw)
        img = render_fn(fv, tex, case['params'])
        _loss(img).backward()
        out.update(image=img.detach().numpy(), grad_fv=fv.grad.numpy(),
                   grad_tex=tex.grad.numpy())
    out['collective_seconds'] = S.collective_seconds() - c0
    return out


def _rank(rank, world, init_file, out_dir, cases):
    torch.set_num_threads(1)
    dist.init_process_group('gloo', init_method=f'file://{init_file}',
                            world_size=world, rank=rank)
    try:
        results = {name: run_case(case) for name, case in cases}
        torch.save(results, os.path.join(out_dir, f'rank{rank}.pt'))
    finally:
        dist.destroy_process_group()


def spawn(world, cases, out_dir, timeout=300):
    """Run the cases ([(name, case)]) in ``world`` gloo ranks on the CPU;
    returns [rank] -> {name: result}.  Fails a run that outlasts
    ``timeout`` seconds, and stops its ranks."""
    os.makedirs(out_dir, exist_ok=True)
    S.spawn_ranks(_rank, world, (world, os.path.join(out_dir, 'init'),
                                 out_dir, cases), timeout)
    return [torch.load(os.path.join(out_dir, f'rank{r}.pt'),
                       weights_only=False) for r in range(world)]
