"""One run of one cell of the benchmark of gendr_tpu_torch.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  The cell's configuration, traffic and limits
are found by name: ``BENCHMARK.json`` names the cell's configuration and
traffic, ``benchmark/configs/<configuration>.json`` holds its sizes and
names its driver (``benchmark/drivers/<driver>.py``, with the plain
reference it calls under ``benchmark/reference/``),
``benchmark/traffic/<traffic>.json`` the loop's parameters, and
``benchmark/workloads/<cell>.json`` the limits of the comparison that
decides ``correct``.  Each metric is read by ``benchmark/metrics/<name>.py``.

A run: set-up (the program built as a user's run builds it, the weights and
inputs made from the seed, the first three training steps through the
window's own call); with ``--trace 1`` a traced stretch of the loop under
torch.profiler; the window, ``--seconds`` of the loop on the host clock;
the peak device memory; then, with the program's state freed, the plain
reference over the same first three steps, and the comparison.  The last
line of standard output is the result, as JSON; the numbers compared, each
beside its limit, are the last lines of standard error and the result's
last key.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import statistics
import sys
import tempfile
import time


def _process_start():
    """The host clock (perf_counter) at which this process started."""
    now = time.perf_counter()
    try:
        with open('/proc/self/stat') as f:
            ticks = int(f.read().rsplit(')', 1)[1].split()[19])
        with open('/proc/uptime') as f:
            uptime = float(f.read().split()[0])
        return now - (uptime - ticks / os.sysconf('SC_CLK_TCK'))
    except (OSError, ValueError, IndexError):
        return now


PROCESS_START = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, 'benchmark')
# The bytecode of every module a run imports (torch, sympy, the program),
# written by the checkout's first run and read by the others.  Where the
# installation holds no valid .pyc files, or may not write them, each run
# would compile the source of every module it imports again, seconds of
# host work in every run's set-up
BYTECODE = os.path.join(HERE, '_pycache')
if __name__ == '__main__':
    sys.pycache_prefix = BYTECODE
    sys.dont_write_bytecode = False
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'gendr_tpu')
FIRST_STEPS = 3


def _json(path):
    with open(path) as f:
        return json.load(f)


def load_spec(workload, bench=None, dirs=None):
    """Everything a run of ``workload`` reads from files: dict(name, cfg,
    traffic, limits, end_to_end, per_layer), the metrics being the
    BENCHMARK.json entries this cell reports.  ``dirs`` may point the
    'configs', 'traffic' or 'workloads' lookups elsewhere."""
    bench = bench or _json(os.path.join(ROOT, 'BENCHMARK.json'))
    dirs = {k: os.path.join(HERE, k)
            for k in ('configs', 'traffic', 'workloads')} | (dirs or {})
    cells = {w['name']: w for w in bench['workloads']}
    if workload not in cells:
        raise SystemExit(f'run.py: no workload {workload!r} in '
                         f'BENCHMARK.json')
    w = cells[workload]
    e2e = [m for m in bench['end_to_end']
           if workload in m.get('workloads', [workload])]
    names = {m['name'] for m in e2e}
    layer = [m for m in bench['per_layer']
             if (workload in m['workloads'] if 'workloads' in m
                 else m['moves'] in names)]
    return dict(
        name=workload, chips=w['chips'],
        cfg=_json(os.path.join(dirs['configs'], w['config'] + '.json')),
        traffic=_json(os.path.join(dirs['traffic'], w['traffic'] + '.json')),
        limits=_json(os.path.join(dirs['workloads'],
                                  workload + '.json'))['limits'],
        end_to_end=e2e, per_layer=layer)


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(cfg):
    return _module(os.path.join(HERE, 'drivers', cfg['driver'] + '.py'),
                   'benchmark_driver_' + cfg['driver'])


def read_metric(name, run):
    """The metric's reader's value, or None where it found nothing."""
    mod = _module(os.path.join(HERE, 'metrics', name + '.py'),
                  'benchmark_metric_' + name.replace('.', '_'))
    return mod.read(run)


def _norm(t):
    return float(torch.linalg.vector_norm(t.detach().double().cpu()))


def _ratio(num, den):
    if den == 0:
        return 0.0 if num == 0 else float('inf')
    return num / den


def _leaf_gaps(prog, ref, names):
    """Each leaf's gap between the program's and the reference's norm,
    against the larger of the reference's norm of that leaf and of the
    median leaf."""
    rn = {k: _norm(ref[k]) for k in names}
    med = statistics.median(rn.values())
    return [_ratio(abs(_norm(prog[k]) - rn[k]), max(rn[k], med))
            for k in names]


def gaps(prog, ref):
    """The numbers a cell may compare: 'loss' (the widest relative gap of
    a step's loss), 'grad' (the first gradient's gap at the worst leaf),
    'grad_q75' (at the upper quartile of the leaves' gaps), 'change' (the
    parameters' change over the steps, worst leaf, leaving out leaves whose
    reference gradient is under a thousandth of the median leaf's: they
    move under Adam by round-off alone) and, where the compared steps run
    at another tau than the window's, 'loss_timed' (the relative gap of
    the first step's loss at the window's tau)."""
    def rel(a, b):
        return _ratio(abs(a - b), abs(b))
    names = list(ref['grads'])
    gn = {k: _norm(ref['grads'][k]) for k in names}
    med = statistics.median(gn.values())
    live = [k for k in names if gn[k] >= 1e-3 * med]
    grad = _leaf_gaps(prog['grads'], ref['grads'], names)
    out = dict(loss=max(rel(a, b) for a, b in zip(prog['losses'],
                                                   ref['losses'])),
               grad=max(grad), grad_q75=float(np.percentile(grad, 75)),
               change=max(_leaf_gaps(prog['change'], ref['change'], live)))
    if 'timed_loss' in ref:
        out['loss_timed'] = rel(prog['timed_loss'], ref['timed_loss'])
    return out


class Run:
    """What the metrics' readers read: setup_s; the window (window_s,
    window_steps, block_times [(steps, seconds)]); the traced stretch
    (trace, a benchmark.trace.Trace, traced_s, traced_steps); work (the
    step's operations and bytes from the problem); cfg, traffic."""


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def forbidden_loaded():
    """The modules of JAX or of the JAX package that this process holds,
    by top-level name compared whole (gendr_tpu_torch begins with
    gendr_tpu)."""
    return sorted({m.split('.')[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(spec, seed, seconds, trace, device='cuda', fault=None):
    """One run: (the result line's dict, with 'checks' last; dict(prog,
    ref, gaps, run): the readings and what the readers read)."""
    from benchmark.trace import Trace
    device = torch.device(device)
    cfg, traffic = spec['cfg'], spec['traffic']
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = Run()
    run.cfg, run.traffic = cfg, traffic
    run.trace = None
    tmp = tempfile.mkdtemp(prefix='gendr_bench_')
    try:
        t_cell = time.perf_counter()
        cell = driver(cfg).Cell(cfg, traffic, seed, device, tmp, fault)
        t_first = time.perf_counter()
        prog = cell.first_steps(FIRST_STEPS)
        _sync(device)
        t_end = time.perf_counter()
        run.setup_s = t_end - PROCESS_START
        print(f'setup: {t_cell - PROCESS_START:.3f} s to the cell, '
              f'{t_first - t_cell:.3f} s building it, {t_end - t_first:.3f} '
              f's in its first {FIRST_STEPS} steps', file=sys.stderr)
        attempted, failed = 0, 0
        if trace:
            from torch import profiler
            acts = [profiler.ProfilerActivity.CPU]
            if device.type == 'cuda':
                acts.append(profiler.ProfilerActivity.CUDA)
            steps = 0
            with profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                while steps < traffic['trace_steps']:
                    with profiler.record_function('bench.block'):
                        losses, bad = cell.block()
                    steps += len(losses)
                    failed += bad
                run.traced_s = time.perf_counter() - t0
            run.traced_steps = steps
            attempted += steps
            run.trace = Trace.from_profiler(prof)
        times = []
        t0 = time.perf_counter()
        while True:
            b0 = time.perf_counter()
            losses, bad = cell.block()
            b1 = time.perf_counter()
            times.append((len(losses), b1 - b0))
            failed += bad
            if b1 - t0 >= seconds:
                break
        run.window_s = b1 - t0
        run.window_steps = sum(n for n, _ in times)
        per = sorted(1e3 * s / n for n, s in times)
        print(f'window: {run.window_steps} steps in {len(times)} blocks, '
              f'{run.window_s:.3f} s; ms a step by block: min {per[0]:.3f}, '
              f'median {per[len(per) // 2]:.3f}, max {per[-1]:.3f}',
              file=sys.stderr)
        run.block_times = times
        attempted += run.window_steps
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == 'cuda' else 0)
        cell.free()
        if device.type == 'cuda':
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        ref = cell.reference(FIRST_STEPS)
        run.work = cell.work()
        print(f'reference: {time.perf_counter() - t_ref:.3f} s',
              file=sys.stderr)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    g = gaps(prog, ref)
    checks = {f'{k}_gap': (g[k], limit)
              for k, limit in spec['limits'].items()}
    checks['nonfinite_steps'] = (failed, 0)
    correct = all(v <= limit for v, limit in checks.values())
    wanted = spec['per_layer'] if trace else spec['end_to_end']
    metrics = {}
    for m in wanted:
        v = read_metric(m['name'], run)
        if v is not None:
            metrics[m['name']] = dict(value=v, unit=m['unit'])
    dev = dict(platform='gpu' if device.type == 'cuda' else device.type,
               kind=(torch.cuda.get_device_name(device)
                     if device.type == 'cuda' else 'cpu'),
               count=1, memory_peak_bytes=peak)
    result = dict(correct=correct, attempted=attempted, failed=failed,
                  metrics=metrics, device=dev)
    if trace:
        dev.update(busy_s=run.trace.busy_s(), window_s=run.traced_s)
        result['breakdown'] = run.trace.breakdown()
    result['checks'] = {k: dict(value=v, limit=limit)
                        for k, (v, limit) in checks.items()}
    return result, dict(prog=prog, ref=ref, gaps=g, run=run)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    spec = load_spec(a.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < spec['chips']:
        print(f'run.py: the cell needs {spec["chips"]} CUDA device(s); '
              f'torch.cuda.is_available() is {torch.cuda.is_available()}, '
              f'{torch.cuda.device_count()} found', file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result, _ = run_cell(spec, a.seed, a.seconds, a.trace)
    # after the window, the reference, the comparison and every reader
    loaded = forbidden_loaded()
    if loaded:
        print(f'run.py: the process holds {loaded} once the window has '
              f'closed; the benchmark measures gendr_tpu_torch alone',
              file=sys.stderr)
        return 3
    for k, c in result['checks'].items():
        print(f'check {k} {c["value"]!r} limit {c["limit"]!r}',
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
