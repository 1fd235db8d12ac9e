"""Evaluate the t-conorm surfaces over [0, 1]^2.

Port of ``animations/t_conorms.py``: each t-conorm's fold over a grid and
its gradient by the aggregate-inverse rule, the surface values written to
CSV for plotting.  Plain tensor code on the CPU: it runs no render.

    python -m gendr_tpu_torch.animations.t_conorms --out-dir /tmp/surfaces
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from gendr_tpu_torch import config as C
from gendr_tpu_torch.ops import tconorms as T

# one valid parameter per family (t_conorms.py:34-37)
CONFIGS = [('max', 0.0), ('probabilistic', 0.0), ('einstein', 0.0),
           ('hamacher', 0.5), ('frank', 2.0), ('yager', 2.0),
           ('aczel_alsina', 2.0), ('dombi', 2.0),
           ('schweizer_sklar', -2.0)]


def surface(name, p=0.0, n=65):
    """(A, B, A _|_ B, d(A _|_ B)/dB by the aggregate-inverse rule) on the
    n x n grid of [0, 1]^2, as numpy arrays."""
    tid = C.AGGR_ALPHA_FUNC_MAP[name]
    a = torch.linspace(0.0, 1.0, n)
    A, B = torch.meshgrid(a, a, indexing='xy')
    Z = T.fold_step(tid, A, B, p)
    dZ = T.aggregate_backward(tid, Z, B, p)
    return A.numpy(), B.numpy(), Z.numpy(), dZ.numpy()


def main(out_dir='./results/tconorm_surfaces', points=65):
    os.makedirs(out_dir, exist_ok=True)
    for name, p in CONFIGS:
        _, _, Z, _ = surface(name, p, points)
        np.savetxt(os.path.join(out_dir, f'{name}_p{p}.csv'), Z,
                   delimiter=',')
        print(f'{name} (p={p}): Z in [{Z.min():.3f}, {Z.max():.3f}]')


if __name__ == '__main__':
    ap = argparse.ArgumentParser()
    ap.add_argument('--out-dir', type=str,
                    default='./results/tconorm_surfaces')
    ap.add_argument('--points', type=int, default=65)
    a = ap.parse_args()
    main(a.out_dir, a.points)
