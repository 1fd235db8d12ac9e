"""What the benchmark's files import: nothing of JAX or of the JAX package
anywhere (top-level module names compared whole: gendr_tpu_torch begins
with gendr_tpu), none of the repository's scripts, and nothing of the
program in the plain reference."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEVER = {'jax', 'jaxlib', 'flax', 'optax', 'gendr_tpu', 'chip_smoke',
         'bench'}


def _files(sub=''):
    out = []
    for d, dirs, names in os.walk(os.path.join(HERE, sub)):
        dirs[:] = [n for n in dirs if n != '_pycache']
        if os.path.basename(d) == 'tests':
            continue
        out += [os.path.join(d, n) for n in names if n.endswith('.py')]
    return sorted(out)


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split('.')[0])
    return names


def test_the_walk_finds_the_harness():
    names = {os.path.relpath(p, HERE) for p in _files()}
    assert {'run.py', 'reference/raster.py', 'drivers/camera.py',
            'metrics/step_ms.py'} <= names


@pytest.mark.parametrize('path', _files(), ids=lambda p: os.path.relpath(
    p, HERE))
def test_no_jax_and_no_scripts(path):
    assert not top_level_imports(path) & NEVER


@pytest.mark.parametrize('path', _files('reference'),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_the_reference_imports_nothing_of_the_program(path):
    assert 'gendr_tpu_torch' not in top_level_imports(path)


def test_names_are_compared_whole(tmp_path):
    p = tmp_path / 'm.py'
    p.write_text('import gendr_tpu_torch.raster\nfrom jax import numpy\n')
    assert top_level_imports(str(p)) == {'gendr_tpu_torch', 'jax'}


def test_a_module_loaded_after_the_window_stops_the_run(monkeypatch,
                                                        capsys):
    """sys.modules is read just before the result line, after the
    reference, the comparison and the metrics' readers: a module of JAX
    that any of them loads stops the run with no result."""
    import sys
    import types

    from benchmark import run

    def late_import(*a, **k):
        monkeypatch.setitem(sys.modules, 'jax.numpy',
                            types.ModuleType('jax.numpy'))
        return dict(correct=True, checks={}), {}
    monkeypatch.setattr(run.torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(run.torch.cuda, 'device_count', lambda: 1)
    monkeypatch.setattr(run, 'run_cell', late_import)
    assert run.main(['--workload', 'camera.blur', '--seed', '1',
                     '--seconds', '1']) == 3
    out = capsys.readouterr()
    assert out.out == '' and "['jax']" in out.err
