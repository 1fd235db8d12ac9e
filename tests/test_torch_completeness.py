"""Nothing of ``gendr_tpu`` is left to port, held statically (the sources
read with ``ast``, the port's modules imported; no render, no jit).

(a) Every public top-level name of every ``gendr_tpu/**/*.py``,
    ``experiments/*.py`` and ``animations/*.py`` has a counterpart of the
    same name in the matching module of ``gendr_tpu_torch/``, or is listed
    in ``NOT_PORTED`` with its reason (ROADMAP.md, Queue 1: "Not to port"
    and the JAX-only helpers).  One case per JAX module.
(b) Every ``pallas_call`` in ``gendr_tpu/``, ``tools/``, ``experiments/``
    and ``animations/`` names its hand-written kernels in ``PALLAS_SITES``,
    and each of those ``__global__`` kernels is defined in
    ``gendr_tpu_torch/csrc/``; every ``__global__`` kernel there answers a
    site, or is listed in ``NO_SITE`` with its source and its reason (a
    hand-written kernel of the port where the JAX package had XLA).
(c) Each of those kernels' launch counters is a key of its wrapper's
    ``LAUNCHES`` and is reported and checked by ``chip_smoke.py``.

A new Pallas kernel or a new public name in ``gendr_tpu`` fails here until
it is ported or listed with a reason.
"""

import ast
import importlib
import pathlib
import re

import pytest
from torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / 'gendr_tpu_torch'

# JAX modules whose counterpart has another name in the port
MODULE_MAP = {
    'gendr_tpu.raster.pallas_backend': 'gendr_tpu_torch.raster.cuda_backend',
    'gendr_tpu.raster.xla_backend': 'gendr_tpu_torch.raster.torch_backend',
}

# whole JAX modules that are not ported: {module: reason}
MODULES_NOT_PORTED = {
    'gendr_tpu.raster.oracle':
        "the JAX package's test-only dense oracle (tests/test_render.py, "
        "tests/test_pallas.py); the port's oracle is gendr_tpu on the CPU",
    'gendr_tpu.raster.prep':
        "faces_info feeds the dense oracle and the finfo argument of the "
        "JAX backends; the port's backends take no finfo",
}

# public names that are not ported: {(JAX module, name): reason}
_ORACLE_GEOMETRY = ("the rest of raster/geometry.py, the JAX package's "
                    "test-only dense oracle")
_MOSAIC = 'Mosaic tiling, which the CUDA kernels do not need'
NOT_PORTED = {
    ('gendr_tpu.ops.distributions', 'erfc'):
        'JAX-only helper: the port uses torch.special.erfc',
    ('gendr_tpu.ops.distributions', 'arctan'):
        'JAX-only helper: the port uses torch.atan',
    ('gendr_tpu.ops.distributions', 'arcsin'):
        'JAX-only helper: the port uses torch.asin',
    **{('gendr_tpu.raster.geometry', name): _ORACLE_GEOMETRY
       for name in ('signed_distance', 'barycentric', 'inside_loose',
                    'inside_strict', 'face_frontside', 'outside_bbox',
                    'barycentric_clip', 'perspective_depth')},
    **{('gendr_tpu.raster.pack', name): _MOSAIC
       for name in ('tile', 'untile', 'tile_soa', 'untile_soa',
                    'tile_grid')},
    ('gendr_tpu.raster.pallas_backend', 'fallback_reason'):
        'the silent XLA fallback for configurations outside Mosaic\'s '
        'envelope; the port raises ValueError (cuda_backend.check_envelope)',
    ('gendr_tpu.raster.pallas_backend', 'backward'):
        "the finfo contract over backward_from_aux; the port's render "
        'calls cuda_backend.backward_from_aux',
    ('gendr_tpu.raster.pallas_backend', 'IDS_SMEM_CAP_BYTES'):
        'the split between SMEM and HBM hit lists; a CUDA block reads its '
        'own list row',
    ('gendr_tpu.raster.pallas_backend', 'IDS_ALIGN'):
        'the padding of the HBM hit-list rows of that split',
    ('gendr_tpu.raster.pallas_backend', 'TEXEL_BLOCK'):
        "one-hot texel selection in 8-texel blocks, for Mosaic's lack of "
        'a per-lane gather; a CUDA pair gathers its texel',
    ('gendr_tpu.raster.pallas_backend', 'TEXEL_UNROLL_CAP'):
        'the unrolled one-hot texel selection of the same workaround',
    ('gendr_tpu.raster.pallas_backend', 'HARD_INKERNEL_TS_CAP'):
        "the deferred hard-RGB epilogues of the same workaround; the CUDA "
        "kernels sample the winner's texel in the kernel at any size",
}

# every pallas_call, by file and enclosing function: (the TPU kernel, the
# .cu file under gendr_tpu_torch/csrc/, its __global__ kernels)
PALLAS_SITES = {
    'gendr_tpu/raster/pallas_backend.py:_fwd_kernel_out':
        ('_fwd_kernel', 'rasterize_fwd.cu', ('rasterize_fwd_kernel',)),
    'gendr_tpu/raster/pallas_backend.py:backward_from_aux':
        ('_bwd_kernel', 'rasterize_bwd.cu',
         ('rasterize_bwd_kernel', 'rasterize_bwd_reduce',
          'rasterize_bwd_slab')),
    'tools/ulp_check.py:_pallas_elementwise':
        ('kernel', 'ulp_probe.cu', ('ulp_elementwise_kernel',)),
    'tools/ulp_bisect.py:_pallas_elementwise':
        ('kernel', 'ulp_probe.cu', ('ulp_elementwise_kernel',)),
    'tools/ulp_smem.py:pallas_smem':
        ('kernel', 'ulp_probe.cu', ('ulp_param_vector_kernel',)),
}

# the hand-written kernels that answer no pallas_call: {kernel: (the .cu
# file under gendr_tpu_torch/csrc/, the reason)}
_PREPASS = ("the XLA prepass of gendr_tpu/raster/pallas_backend.py:"
            "_sorted_faces and pack.py's pack_faces, tile_chunk_mask and "
            "compact_hits: as ~380 plain torch launches a render it took "
            "0.96 ms of a 2.15 ms step at the camera cells' shape "
            "(PERF.md)")
NO_SITE = {'prepass_sort': ('prepass.cu', _PREPASS),
           'prepass_pack': ('prepass.cu', _PREPASS)}

# each __global__ kernel's launch counter: (the wrapper's module, its key
# in that module's LAUNCHES)
COUNTERS = {
    'rasterize_fwd_kernel':
        ('gendr_tpu_torch.raster.cuda_backend', 'rasterize_fwd'),
    'rasterize_bwd_kernel':
        ('gendr_tpu_torch.raster.cuda_backend', 'rasterize_bwd'),
    'rasterize_bwd_reduce':
        ('gendr_tpu_torch.raster.cuda_backend', 'rasterize_bwd'),
    'rasterize_bwd_slab':
        ('gendr_tpu_torch.raster.cuda_backend', 'rasterize_bwd_slab'),
    'ulp_elementwise_kernel':
        ('gendr_tpu_torch.tools._ulp', 'ulp_elementwise'),
    'ulp_param_vector_kernel':
        ('gendr_tpu_torch.tools._ulp', 'ulp_param_vector'),
    'prepass_sort': ('gendr_tpu_torch.raster.cuda_backend', 'prepass'),
    'prepass_pack': ('gendr_tpu_torch.raster.cuda_backend', 'prepass'),
}

SCANNED = ('gendr_tpu', 'tools', 'experiments', 'animations')


def _jax_modules():
    paths = sorted((ROOT / 'gendr_tpu').rglob('*.py'))
    paths += sorted((ROOT / 'experiments').glob('*.py'))
    paths += sorted((ROOT / 'animations').glob('*.py'))
    return {_module_name(p): p for p in paths}


def _module_name(path):
    parts = list(path.relative_to(ROOT).with_suffix('').parts)
    if parts[-1] == '__init__':
        parts.pop()
    return '.'.join(parts)


def _port_module(module):
    if module in MODULE_MAP:
        return MODULE_MAP[module]
    if module.startswith('gendr_tpu'):
        return 'gendr_tpu_torch' + module[len('gendr_tpu'):]
    return 'gendr_tpu_torch.' + module


def _bound_names(body, package):
    """The names a module body binds at its top level: definitions,
    assignments and, in a package's __init__, imports; into the branches
    of top-level if and try statements, but not under
    ``if __name__ == '__main__'``."""
    names = set()
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            names |= {n.id for t in targets for n in ast.walk(t)
                      if isinstance(n, ast.Name)}
        elif isinstance(node, (ast.Import, ast.ImportFrom)) and package:
            names |= {(a.asname or a.name).split('.')[0] for a in node.names}
        elif isinstance(node, ast.If):
            if not any(isinstance(n, ast.Constant) and n.value == '__main__'
                       for n in ast.walk(node.test)):
                names |= _bound_names(node.body + node.orelse, package)
        elif isinstance(node, ast.Try):
            names |= _bound_names(
                node.body + node.orelse + node.finalbody
                + [n for h in node.handlers for n in h.body], package)
    return names


def public_names(path):
    """The public top-level names of a source file, read with ast."""
    tree = ast.parse(path.read_text(), str(path))
    return {n for n in _bound_names(tree.body, path.name == '__init__.py')
            if not n.startswith('_')}


JAX_MODULES = _jax_modules()


def test_the_allowlists_name_real_modules_and_names():
    """Every allowlist entry names a JAX module and a public name of it
    that the port lacks, and gives a reason."""
    for module, reason in MODULES_NOT_PORTED.items():
        assert module in JAX_MODULES and reason, module
        with pytest.raises(ImportError):
            importlib.import_module(_port_module(module))
    for (module, name), reason in NOT_PORTED.items():
        assert module in JAX_MODULES and reason, (module, name)
        assert name in public_names(JAX_MODULES[module]), (module, name)
        port = importlib.import_module(_port_module(module))
        assert not hasattr(port, name), \
            f'{module}.{name} is ported now: take it off NOT_PORTED'
    assert len(JAX_MODULES) >= 40


@pytest.mark.parametrize('module', sorted(JAX_MODULES))
def test_public_names_have_a_port(module):
    names = public_names(JAX_MODULES[module])
    if module in MODULES_NOT_PORTED:
        return
    port = importlib.import_module(_port_module(module))
    missing = sorted(n for n in names if not hasattr(port, n)
                     and (module, n) not in NOT_PORTED)
    assert not missing, (
        f'{module} has public names with no counterpart in '
        f'{_port_module(module)}: {missing}; port them, or list each in '
        f'NOT_PORTED with its reason')


def _pallas_sites():
    """{'file:enclosing top-level function': [line, ...]} of every call
    to pallas_call in the scanned directories, and the number of lines
    that call it textually outside comments."""
    sites, textual = {}, 0
    for top in SCANNED:
        for path in sorted((ROOT / top).rglob('*.py')):
            src = path.read_text()
            textual += sum(1 for line in src.splitlines()
                           if re.search(r'\bpallas_call\s*\(',
                                        line.split('#')[0]))
            tree = ast.parse(src, str(path))
            for node in tree.body:
                for call in ast.walk(node):
                    if not isinstance(call, ast.Call):
                        continue
                    f = call.func
                    name = f.attr if isinstance(f, ast.Attribute) else \
                        getattr(f, 'id', None)
                    if name == 'pallas_call':
                        key = (f'{path.relative_to(ROOT).as_posix()}:'
                               f'{getattr(node, "name", "<module>")}')
                        sites.setdefault(key, []).append(call.lineno)
    return sites, textual


def _cuda_kernels():
    """{__global__ kernel name: .cu file name} under gendr_tpu_torch/csrc/
    (attributes such as __launch_bounds__(...) between __global__ and the
    name are skipped)."""
    found = {}
    for path in sorted((PORT / 'csrc').glob('*.cu')):
        src = re.sub(r'//[^\n]*|/\*.*?\*/', '', path.read_text(),
                     flags=re.S)
        for m in re.finditer(
                r'__global__\s+void\s+((?:__\w+__\s*(?:\([^)]*\))?\s*)*)'
                r'(\w+)\s*\(', src):
            found[m.group(2)] = path.name
    return found


def test_every_pallas_call_has_a_cuda_kernel():
    sites, textual = _pallas_sites()
    assert sum(len(v) for v in sites.values()) == textual == 5, sites
    assert set(sites) == set(PALLAS_SITES), (
        f'pallas_call sites without a port (or a table entry whose site '
        f'is gone): {sorted(set(sites) ^ set(PALLAS_SITES))}')
    kernels = _cuda_kernels()
    for site, (_, cu, names) in PALLAS_SITES.items():
        for name in names:
            assert kernels.get(name) == cu, (site, name, kernels)


def test_every_cuda_kernel_answers_a_pallas_site():
    answered = {n for _, _, names in PALLAS_SITES.values() for n in names}
    assert not answered & set(NO_SITE)
    assert set(_cuda_kernels()) == answered | set(NO_SITE) == set(COUNTERS)
    kernels = _cuda_kernels()
    for name, (cu, reason) in NO_SITE.items():
        assert kernels[name] == cu and reason, name


def _chip_smoke_kernel_line():
    """The dicts of chip_smoke.main that make its kernels JSON line:
    {'sources': {counter: .cu stem}, 'replaces': {counter: file:line}},
    the names of the LAUNCHES dicts the script sets to 0, and the script's
    source."""
    src = (ROOT / 'chip_smoke.py').read_text()
    tree = ast.parse(src)
    main, = [n for n in tree.body
             if isinstance(n, ast.FunctionDef) and n.name == 'main']
    tables = {}
    for node in ast.walk(main):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id in ('sources', 'replaces')):
            # dict(key=value, ...)
            tables[node.targets[0].id] = {
                kw.arg: ast.literal_eval(kw.value)
                for kw in node.value.keywords}
    reset = set()
    for node in ast.walk(tree):
        # for k in X.LAUNCHES: X.LAUNCHES[k] = 0
        if (isinstance(node, ast.For)
                and isinstance(node.iter, ast.Attribute)
                and node.iter.attr == 'LAUNCHES'
                and any(isinstance(s, ast.Assign)
                        and isinstance(s.value, ast.Constant)
                        and s.value.value == 0 for s in node.body)):
            reset.add(ast.unparse(node.iter.value))
    return tables, reset, src, tree


@pytest.mark.parametrize('kernel', sorted(COUNTERS))
def test_chip_smoke_checks_each_kernels_launches(kernel):
    module, counter = COUNTERS[kernel]
    launches = importlib.import_module(module).LAUNCHES
    assert counter in launches, (module, counter)
    tables, reset, src, tree = _chip_smoke_kernel_line()
    # the script counts from 0 for both wrappers' counters (CB is
    # cuda_backend, _ulp the probes' module)
    assert {'CB', '_ulp'} <= reset, reset
    # the kernels line reports the counter's launches, from the .cu that
    # defines the kernel, beside the TPU kernel it replaces
    assert tables['sources'][counter] + '.cu' == _cuda_kernels()[kernel]
    sites = [site.split(':')[0] for site, (_, _, names)
             in PALLAS_SITES.items() if kernel in names]
    assert all(s in tables['replaces'][counter] for s in sites), \
        (counter, tables['replaces'][counter], sites)
    # and fails a run that did not launch it: the render kernels every
    # path checks (RENDER_KERNELS), the slab launch its own count, the
    # probes' counts against _ulp.launches
    render_kernels, = [ast.literal_eval(n.value) for n in tree.body
                       if isinstance(n, ast.Assign)
                       and ast.unparse(n.targets[0]) == 'RENDER_KERNELS']
    assert (counter in render_kernels
            or f"CB.LAUNCHES['{counter}']" in src
            or (module.endswith('_ulp') and '_ulp.launches(' in src)), \
        f'chip_smoke.py does not check the launches of {counter}'
