"""The readings that the limits of ``correct`` are set from, at a cell's own
size, one process for many seeds:

    python3 benchmark/calibrate.py --workload NAME --mode MODE --seeds 1 2 3

MODE 'sound': the program's first three steps against the plain reference
(the lower readings).  'control': the reference computed in the precision
below the configuration's (bfloat16 for the camera's float32; TF32 for
the reconstruction's float32 with TF32 off) put in the program's place,
against the reference (the upper readings).  'half_batch': the program
with half of each batch's loss left out, the mean taken over the rest,
against the reference.  A step that leaves its state unchanged reads 1 on
'change' by construction and needs no run.  Each seed prints one JSON
line; the last line gives, per number, the largest reading ('sound') or the
smallest (the others).  ``--check-tau`` sets the tau of the compared
steps in the camera's cells (the traffic's ``check_tau``), one summary
line for each value given.  The benchmark's own runs never run this."""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from benchmark import run as R  # noqa: E402


def reading(spec, seed, mode, device):
    cfg = spec['cfg']
    with tempfile.TemporaryDirectory() as tmp:
        cell = R.driver(cfg).Cell(cfg, spec['traffic'], seed, device, tmp,
                                  'half_batch' if mode == 'half_batch'
                                  else None)
        prog = cell.first_steps(R.FIRST_STEPS)
        cell.free()
        if torch.device(device).type == 'cuda':
            torch.cuda.empty_cache()
        ref = cell.reference(R.FIRST_STEPS)
        if mode == 'control':
            low = (dict(tf32=True) if cfg['driver'] == 'recon'
                   else dict(dtype=torch.bfloat16))
            prog = cell.reference(R.FIRST_STEPS, **low)
    return R.gaps(prog, ref), prog['losses'], ref['losses'], leaves(prog, ref)


def leaves(prog, ref):
    """Every leaf's gap of the first gradient's and of the change's norm,
    widest first: {'grads': [[name, gap, reference norm]], 'change': ...}."""
    out = {}
    for part in ('grads', 'change'):
        rn = {k: R._norm(v) for k, v in ref[part].items()}
        med = R.statistics.median(rn.values())
        gaps = sorted(((k, R._ratio(abs(R._norm(prog[part][k]) - rn[k]),
                                    max(rn[k], med)), rn[k])
                       for k in rn), key=lambda r: -r[1])
        out[part] = [list(r) for r in gaps]
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--workload', required=True)
    p.add_argument('--mode', choices=('sound', 'control', 'half_batch'),
                   default='sound')
    p.add_argument('--seeds', type=int, nargs='+', required=True)
    p.add_argument('--device', default='cuda')
    p.add_argument('--check-tau', type=float, nargs='+', default=[None])
    a = p.parse_args(argv)
    spec = R.load_spec(a.workload)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pick = max if a.mode == 'sound' else min
    for tau in a.check_tau:
        if tau is not None:
            spec['traffic']['check_tau'] = tau
        head = dict(workload=a.workload, mode=a.mode,
                    check_tau=spec['traffic'].get('check_tau'))
        rows = []
        for seed in a.seeds:
            t0 = time.perf_counter()
            g, lp, lr, worst = reading(spec, seed, a.mode, a.device)
            rows.append(g)
            print(json.dumps(head | dict(
                seed=seed, gaps=g, losses=lp, ref_losses=lr,
                worst_leaves=worst,
                seconds=round(time.perf_counter() - t0, 2))), flush=True)
        print(json.dumps(head | dict(seeds=len(rows), summary={
            k: pick(r[k] for r in rows) for k in rows[0]})), flush=True)


if __name__ == '__main__':
    main()
