"""The auxiliaries of the port: ``checkpoint`` (a round trip, and files
written by either package loaded by the other, at float64) and
``profiling`` (``Throughput``, and ``trace`` writing a trace), on the
CPU."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygsp_tpu as jgsp
import pygsp_tpu_torch as tgsp
from pygsp_tpu import checkpoint as jckpt
from pygsp_tpu_torch import checkpoint as tckpt
from pygsp_tpu_torch import profiling

CPU64 = dict(device='cpu', dtype=torch.float64)


def test_checkpoint_roundtrip(tmp_path):
    rng = np.random.default_rng(42)
    G = tgsp.graphs.Sensor(40, seed=4, **CPU64)
    G.compute_fourier_basis()
    G.set_signal('s', rng.normal(size=(40, 2)))
    path = str(tmp_path / 'g.npz')
    tckpt.save_graph(path, G)
    G2 = tckpt.load_graph(path, **CPU64)
    assert np.array_equal(G2.W.toarray(), G.W.toarray())
    assert G2.lmax == G.lmax and G2.lap_type == G.lap_type
    assert torch.equal(G2.U, G.U) and torch.equal(G2.e, G.e)
    assert G2.coherence == G.coherence
    assert np.array_equal(G2.signals['s'], G.signals['s'])
    assert np.array_equal(G2.coords, G.coords)


def test_checkpoint_without_fourier_and_tensor_signals(tmp_path):
    """``include_fourier=False`` leaves the basis out; a tensor signal is
    saved from the host copy."""
    G = tgsp.graphs.Ring(12, **CPU64)
    G.compute_laplacian('normalized')
    G.estimate_lmax(method='bounds')
    G.compute_fourier_basis()
    G.set_signal('t', torch.arange(12, dtype=torch.float64))
    path = str(tmp_path / 'g.npz')
    tckpt.save_graph(path, G, include_fourier=False)
    with np.load(path) as d:
        assert 'U' not in d.files and 'e' not in d.files
    G2 = tckpt.load_graph(path, **CPU64)
    assert G2._U is None and G2.lap_type == 'normalized'
    assert G2.lmax == G.lmax
    assert np.array_equal(G2.signals['t'], np.arange(12.0))


def _jax_graph():
    G = jgsp.graphs.Sensor(48, seed=7)
    G.compute_fourier_basis()
    G.set_signal('a', np.random.default_rng(1).normal(size=48))
    G.set_signal('b', np.random.default_rng(2).normal(size=(48, 3)))
    return G


def test_a_jax_file_loads_in_the_port(tmp_path):
    J = _jax_graph()
    path = str(tmp_path / 'j.npz')
    jckpt.save_graph(path, J)
    T = tckpt.load_graph(path, **CPU64)
    assert np.array_equal(T.W.toarray(), J.W.toarray())
    assert T.lmax == J.lmax and T._lmax_method == J._lmax_method
    assert np.array_equal(T.U.numpy(), np.asarray(J.U))
    assert np.array_equal(T.e.numpy(), np.asarray(J.e))
    for name in ('a', 'b'):
        assert np.array_equal(T.signals[name], J.signals[name])
    # the loaded graph works: its Laplacian is the JAX package's
    x = np.random.default_rng(3).normal(size=48)
    assert np.allclose(T.L.dot(x).numpy(), np.asarray(J.L.dot(jnp.asarray(x))),
                       rtol=0, atol=1e-12)


def test_a_port_file_loads_in_the_jax_package(tmp_path):
    T = tgsp.graphs.Sensor(48, seed=7, **CPU64)
    T.compute_fourier_basis()
    T.set_signal('a', np.random.default_rng(1).normal(size=48))
    path = str(tmp_path / 't.npz')
    tckpt.save_graph(path, T)
    J = jckpt.load_graph(path)
    assert np.array_equal(J.W.toarray(), T.W.toarray())
    assert J.lmax == T.lmax and J._lmax_method == T._lmax_method
    assert np.array_equal(np.asarray(J.U), T.U.numpy())
    assert np.array_equal(np.asarray(J.e), T.e.numpy())
    assert np.array_equal(J.signals['a'], T.signals['a'])


def test_throughput_meter():
    meter = profiling.Throughput(n_edges=100, k_order=3, n_signals=2)
    with meter:
        sum(range(1000))
    rep = meter.report()
    assert rep['edge_ops'] == 600 and rep['runs'] == 1
    assert set(rep) == {'edge_ops', 'best_ms', 'edge_ops_per_s', 'runs'}
    assert meter.last_s == meter.times[-1] > 0
    assert meter.best_edge_ops_per_s == 600 / meter.last_s


def test_throughput_on_the_cpu_does_not_touch_cuda(monkeypatch):
    def refuse(*args):
        raise AssertionError('no CUDA synchronize for CPU work')
    monkeypatch.setattr(torch.cuda, 'synchronize', refuse)
    with profiling.Throughput(10, device='cpu') as meter:
        pass
    assert meter.report()['runs'] == 1


def test_trace_writes_a_trace(tmp_path):
    G = tgsp.graphs.Ring(32, **CPU64)
    G.estimate_lmax(method='bounds')
    g = tgsp.filters.Heat(G, 5.0)
    x = torch.ones(32, dtype=torch.float64)
    log_dir = str(tmp_path / 'trace')
    with profiling.trace(log_dir) as prof:
        g.filter(x, order=8)
    files = [f for _, _, fs in os.walk(log_dir) for f in fs]
    assert any(f.endswith('.pt.trace.json') for f in files), files
    assert len(prof.key_averages()) > 0


@pytest.mark.parametrize('name', ['checkpoint', 'profiling', 'plotting'])
def test_auxiliaries_on_the_package(name):
    import importlib
    module = getattr(tgsp, name, None) or importlib.import_module(
        f'pygsp_tpu_torch.{name}')
    assert module.__name__ == f'pygsp_tpu_torch.{name}'
