"""The port stands alone: no JAX, no pygsp_tpu, no networkx and no
matplotlib at load time, no silent CPU fallback."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import pygsp_tpu_torch as tgsp
from pygsp_tpu_torch.core import sparse as tsp
from pygsp_tpu_torch.core import _cuda, banded_kernel, csr_kernel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# One fresh interpreter refuses jax, jaxlib, pygsp_tpu (but not
# pygsp_tpu_torch), networkx, an optional dependency that the graph I/O
# imports only when called, and matplotlib, which plotting imports only when
# called; then it imports every module of the port and
# loads the scripts that drive it on the card without running them. After
# each part it prints, as one JSON line, the refused modules loaded so far;
# last, it tries the JAX package itself, which the hook must refuse.
_SCRIPT = '''
import importlib, importlib.util, json, pkgutil, sys
REFUSED = ('jax', 'jaxlib', 'pygsp_tpu', 'networkx', 'matplotlib')

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in REFUSED:
            raise ImportError('refused import of ' + name)
        return None

sys.meta_path.insert(0, Refuse())

def report(part):
    loaded = sorted(m for m in sys.modules if m.split('.')[0] in REFUSED)
    print(json.dumps([part, loaded]), flush=True)

def load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)       # defines main() but does not run it
    assert callable(module.main)

import pygsp_tpu_torch
for info in pkgutil.walk_packages(pygsp_tpu_torch.__path__,
                                  prefix='pygsp_tpu_torch.'):
    importlib.import_module(info.name)
report('package')
load('chip_smoke', 'chip_smoke.py')
report('chip_smoke')
load('profile_torch_port', 'tools/profile_torch_port.py')
report('profile_tool')
load('bench_torch', 'bench_torch.py')
report('bench_torch')
load('fold_instances', 'tools/fold_instances.py')
report('fold_tool')
load('slot_variants', 'tools/slot_variants.py')
report('slot_tool')
load('engines_multicard', 'tools/engines_multicard.py')
report('engines_tool')
load('engines_scaling', 'tools/engines_scaling.py')
report('scaling_tool')
load('engines_grad_l5', 'tools/engines_grad_l5.py')
report('engines_grad_tool')
try:
    import pygsp_tpu
except ImportError as err:
    print(json.dumps(['hook', str(err)]), flush=True)
'''


@pytest.fixture(scope='module')
def isolated_run():
    """The parts the script reported, by name, and its standard error."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, '-c', _SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    parts = dict(json.loads(line) for line in proc.stdout.splitlines()
                 if line.startswith('['))
    return parts, proc.stderr


@pytest.mark.parametrize('part', ['package', 'chip_smoke', 'profile_tool',
                                  'bench_torch', 'fold_tool', 'slot_tool',
                                  'engines_tool', 'scaling_tool',
                                  'engines_grad_tool'])
def test_imports_neither_jax_nor_pygsp_tpu(isolated_run, part):
    parts, stderr = isolated_run
    assert part in parts, stderr
    assert parts[part] == []


def test_the_hook_does_refuse(isolated_run):
    """The hook of the test above would catch an import of the JAX package."""
    parts, stderr = isolated_run
    assert 'refused import of pygsp_tpu' in parts.get('hook', ''), stderr


@pytest.mark.parametrize('script', ['chip_smoke.py', 'bench_torch.py'])
def test_scripts_fail_without_a_card(script):
    """Without a CUDA device each script exits non-zero and prints no
    result."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES='')
    proc = subprocess.run([sys.executable, script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ''
    assert 'no CUDA device' in proc.stderr


def test_graph_without_device_refuses_to_run_on_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    W = np.array([[0., 1.], [1., 0.]])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tgsp.graphs.Graph(W)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tgsp.graphs.Grid2d(3, 3)


def test_cheby_coeff_without_device_refuses_to_run_on_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tgsp.ops.cheby_coeff(lambda x: torch.exp(-x)[None, :], 2.0, m=4)


def _no_build(*args, **kwargs):
    raise AssertionError('a CPU tensor must not reach the CUDA build')


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    monkeypatch.setattr(_cuda, 'build', _no_build)
    monkeypatch.setattr(_cuda, 'function', _no_build)
    monkeypatch.setattr(csr_kernel.csr_spmm, 'launches', 0)
    monkeypatch.setattr(banded_kernel.banded_spmm, 'launches', 0)
    G = tgsp.graphs.Grid2d(12, 11, device='cpu', dtype=torch.float64)
    G.estimate_lmax()
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(G.N, 3)))
    g = tgsp.filters.Heat(G, [2.0, 20.0])
    r_csr = g.filter(x, order=12)
    r_band = tgsp.ops.cheby_op(G.L.to_banded(), G.lmax,
                               tgsp.ops.cheby_coeff(g.evaluate, G.lmax, m=12,
                                                    dtype=torch.float64,
                                                    device='cpu'), x)
    assert torch.allclose(r_csr, r_band.permute(1, 2, 0), atol=1e-12)
    assert csr_kernel.csr_spmm.launches == 0
    assert banded_kernel.banded_spmm.launches == 0


def test_other_devices_are_refused_not_rerouted():
    """A tensor on neither the CPU nor a card is refused by each wrapper."""
    A = tsp.from_dense(np.eye(4) + np.eye(4, k=1), device='cpu')
    x = torch.zeros(4, 2, device='meta')
    args = [t.to('meta') for t in (A.rowptr, A.cols, A.vals)]
    with pytest.raises(ValueError, match='runs on cuda or cpu'):
        csr_kernel.csr_spmm(*args, x)
    tiles = torch.zeros(1, 1, 128, 128, device='meta')
    with pytest.raises(ValueError, match='runs on cuda or cpu'):
        banded_kernel.banded_spmm(tiles, x, 4)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_cuda, 'BUILD', str(tmp_path))
    monkeypatch.setenv('CUDA_HOME', str(tmp_path / 'no_cuda'))
    monkeypatch.setenv('PATH', str(tmp_path))
    with pytest.raises(RuntimeError, match='nvcc not found'):
        _cuda.build(['csr_spmm'])


def test_kernel_sources_are_in_the_package():
    for name in ('csr_spmm', 'banded_spmm'):
        src = os.path.join(_cuda.CSRC, name + '.cu')
        with open(src) as f:
            text = f.read()
        assert 'Replaces:' in text and 'extern "C"' in text
        assert f'{name}_f32' in text and f'{name}_f64' in text
