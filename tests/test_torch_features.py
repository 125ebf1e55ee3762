"""The port's features module and the utils it adds against pygsp_tpu, at
float64 on the CPU: ``compute_avg_adj_deg`` exactly (the same boolean
product), ``compute_tig``, ``compute_norm_tig`` and ``compute_spectrogram``
within 1e-10 with λmax pinned to the JAX package's, ``resistance_distance``
within 1e-10 and ``filterbank_handler``'s dispatch.
"""

import numpy as np
import pytest
import torch

import pygsp_tpu as jgsp
import pygsp_tpu_torch as tgsp
from pygsp_tpu import features as jfeatures
from pygsp_tpu import utils as jutils
from pygsp_tpu_torch import features as tfeatures
from pygsp_tpu_torch import utils as tutils

CPU64 = dict(device='cpu', dtype=torch.float64)
TOL = 1e-10


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1.0)


@pytest.fixture(scope='module')
def sensor():
    J = jgsp.graphs.Sensor(64, seed=42)
    T = tgsp.graphs.Sensor(64, seed=42, **CPU64)
    J.estimate_lmax()
    T._lmax, T._lmax_method = float(J.lmax), J._lmax_method
    return J, T


@pytest.mark.parametrize('name,kw', [('Ring', dict(N=8)),
                                     ('Sensor', dict(N=64, seed=42)),
                                     ('Path', dict(N=9, directed=True))])
def test_avg_adj_deg_matches_jax(name, kw):
    J = getattr(jgsp.graphs, name)(**kw)
    T = getattr(tgsp.graphs, name)(**kw, **CPU64)
    assert np.array_equal(tfeatures.compute_avg_adj_deg(T),
                          np.asarray(jfeatures.compute_avg_adj_deg(J)))


@pytest.mark.parametrize('scale', [10, [5, 20]])
def test_tig_and_its_norm_match_jax(sensor, scale):
    J, T = sensor
    gj, gt = jgsp.filters.Heat(J, scale=scale), tgsp.filters.Heat(T, scale)
    tig_j, tig_t = jfeatures.compute_tig(gj), tfeatures.compute_tig(gt)
    norm_j = jfeatures.compute_norm_tig(gj, order=20)
    norm_t = tfeatures.compute_norm_tig(gt, order=20)
    if np.ndim(scale):
        assert len(tig_t) == len(tig_j) == 2 and len(norm_t) == 2
    else:
        tig_j, tig_t, norm_j, norm_t = [tig_j], [tig_t], [norm_j], [norm_t]
    for a, b in zip(tig_t + norm_t, tig_j + norm_j):
        _close(a, b)
    _close(tfeatures.compute_tig(gt, i=0), tig_j[0])


@pytest.mark.parametrize('kw', [dict(M=8), dict(M=5, order=40),
                                dict(M=6, atom='custom')])
def test_spectrogram_matches_jax(sensor, kw):
    J, T = sensor
    kw = dict(kw)
    if kw.get('atom') == 'custom':
        kw_j = dict(kw, atom=lambda x: 1.0 / (1.0 + x ** 2))
        kw_t = dict(kw, atom=lambda x: 1.0 / (1.0 + x ** 2))
    else:
        kw_j = kw_t = kw
    want = jfeatures.compute_spectrogram(J, **kw_j)
    got = tfeatures.compute_spectrogram(T, **kw_t)
    assert isinstance(got, np.ndarray) and got.shape == (T.N, kw['M'])
    _close(got, want)
    assert got is T.spectr


def test_resistance_distance_matches_jax(sensor):
    J, T = sensor
    _close(tutils.resistance_distance(T).toarray(),
           jutils.resistance_distance(J).toarray())
    L = T.L.to_scipy()
    _close(tutils.resistance_distance(L).toarray(),
           jutils.resistance_distance(L).toarray())
    N = tgsp.graphs.Sensor(16, seed=1, lap_type='normalized', **CPU64)
    with pytest.raises(ValueError, match='combinatorial'):
        tutils.resistance_distance(N)


def test_filterbank_handler_dispatches_as_jax():
    class Bank:
        def __init__(self, n):
            self.n_filters = n

    def per_kernel(f, x, i=0):
        return (x, i)

    for handler in (tutils.filterbank_handler, jutils.filterbank_handler):
        fn = handler(per_kernel)
        assert fn(Bank(3), 'x') == [('x', 0), ('x', 1), ('x', 2)]
        assert fn(Bank(1), 'x') == ('x', 0)
        assert fn(Bank(3), 'x', i=2) == ('x', 2)
        assert fn.__name__ == 'per_kernel'
