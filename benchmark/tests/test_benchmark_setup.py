"""The set-up that every run pays: the bytecode of what a run imports is
written once, at a fixed path of the checkout, and read by later runs,
even where the environment asks Python not to write bytecode."""

import glob
import os
import subprocess
import sys

from benchmark import run


def test_a_run_keeps_its_bytecode_in_the_checkout():
    env = dict(os.environ, PYTHONDONTWRITEBYTECODE='1')
    proc = subprocess.run(
        [sys.executable, os.path.join(run.HERE, 'run.py'), '--help'],
        cwd=run.ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert run.BYTECODE.startswith(run.ROOT + os.sep)
    torch_dir = os.path.dirname(run.torch.__file__)
    cached = glob.glob(os.path.join(run.BYTECODE + torch_dir,
                                    '__init__.*.pyc'))
    assert cached, f'no bytecode of torch under {run.BYTECODE}'


def test_importing_the_harness_leaves_the_bytecode_settings_alone():
    assert sys.pycache_prefix != run.BYTECODE
