"""The port's reduction module against pygsp_tpu, at float64 on the CPU.

Kron reduction (each method; ``'eliminate'`` from a seed), the sparsifiers
(seeded; their resistances from the dense pseudo-inverse or the CG sketch,
whose probes both packages draw from NumPy's seed 0), ``interpolate``,
the pyramid with ``compute_full_eigen=True``, and
``tree_multiresolution``: all within 1e-10 of the JAX package's. Two
samplers cannot match and are held by a property instead: the Lanczos
start vector of ``graph_multiresolution`` (the JAX package draws it from
``jax.random``, which torch cannot reproduce), held by its top eigenvector
against ``eigh``'s, and the sparsification inside the pyramid, which both
packages leave unseeded.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import pygsp_tpu as jgsp
import pygsp_tpu_torch as tgsp
from pygsp_tpu import reduction as jred
from pygsp_tpu_torch import reduction as tred

CPU64 = dict(device='cpu', dtype=torch.float64)
TOL = 1e-10


def _close(got, want, tol=TOL):
    if sps.issparse(want):
        got, want = sps.csr_matrix(got).toarray(), want.toarray()
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1.0)


@pytest.fixture(scope='module')
def sensor():
    return (jgsp.graphs.Sensor(128, seed=42),
            tgsp.graphs.Sensor(128, seed=42, **CPU64))


def _keep(n, seed, share=0.5):
    return np.flatnonzero(np.random.default_rng(seed).random(n) < share)


@pytest.mark.parametrize('method,kw', [('exact', {}), ('auto', {}),
                                       ('eliminate', dict(seed=3))])
def test_kron_reduction_of_a_graph_matches_jax(sensor, method, kw):
    J, T = sensor
    keep = _keep(T.N, 1)
    Gj = jred.kron_reduction(J, keep, method=method, **kw)
    Gt = tred.kron_reduction(T, keep, method=method, **kw)
    _close(Gt.W, Gj.W)
    assert np.array_equal(Gt.coords, Gj.coords)
    assert Gt.device == T.device and Gt.dtype == T.dtype


@pytest.mark.parametrize('method', ['exact', 'eliminate'])
def test_kron_reduction_of_a_laplacian_matches_jax(sensor, method):
    J, T = sensor
    L = sps.csr_matrix(T.L.to_scipy()) + 0.01 * sps.eye(T.N)
    keep = _keep(T.N, 2)
    _close(tred.kron_reduction(L, keep, method=method, seed=4, device='cpu',
                               dtype=torch.float64),
           jred.kron_reduction(L, keep, method=method, seed=4))


def test_kron_reduction_routes_past_the_dense_limit(sensor, monkeypatch):
    """Above the dense limit 'exact' takes SciPy's sparse LU and 'auto'
    eliminates, in both packages."""
    J, T = sensor
    monkeypatch.setattr(jred, '_DENSE_SOLVE_MAX', 10)
    monkeypatch.setattr(tred, '_DENSE_SOLVE_MAX', 10)
    keep = _keep(T.N, 5)
    _close(tred.kron_reduction(T, keep, method='exact').W,
           jred.kron_reduction(J, keep, method='exact').W)
    _close(tred.kron_reduction(T, keep, seed=2).W,
           jred.kron_reduction(J, keep, seed=2).W)


def test_kron_reduction_errors_match_jax(sensor):
    J, T = sensor
    for call_t, call_j, err in (
            (lambda: tred.kron_reduction(T, [0, 1], method='x'),
             lambda: jred.kron_reduction(J, [0, 1], method='x'), ValueError),
            (lambda: tred.kron_reduction(
                tgsp.graphs.Path(5, directed=True, **CPU64), [0]),
             lambda: jred.kron_reduction(jgsp.graphs.Path(5, directed=True),
                                         [0]), NotImplementedError)):
        with pytest.raises(err) as jerr:
            call_j()
        with pytest.raises(err) as terr:
            call_t()
        assert str(terr.value) == str(jerr.value)


def test_schur_by_elimination_matches_jax(sensor):
    _, T = sensor
    L = sps.csr_matrix(T.L.to_scipy())
    keep = _keep(T.N, 6)
    drop = np.setdiff1d(np.arange(T.N), keep)
    _close(tred._schur_by_elimination(L, keep, drop, seed=9, exact_degree=3),
           jred._schur_by_elimination(L, keep, drop, seed=9, exact_degree=3))


@pytest.mark.parametrize('eps', [0.3, 0.7])
def test_graph_sparsify_matches_jax(sensor, eps):
    J, T = sensor
    Gj = jred.graph_sparsify(J, eps, seed=1)
    Gt = tred.graph_sparsify(T, eps, seed=1)
    _close(Gt.W, Gj.W)
    assert Gt.is_connected() and Gt.dtype == T.dtype


def test_graph_sparsify_of_a_laplacian_matches_jax(sensor):
    J, T = sensor
    L = sps.csc_matrix(T.L.to_scipy())
    _close(tred.graph_sparsify(L, 0.5, seed=2, device='cpu',
                               dtype=torch.float64).tocsr(),
           jred.graph_sparsify(L, 0.5, seed=2).tocsr())
    for eps in (0.01, 1.0):
        with pytest.raises(ValueError) as jerr:
            jred.graph_sparsify(J, eps)
        with pytest.raises(ValueError) as terr:
            tred.graph_sparsify(T, eps)
        assert str(terr.value) == str(jerr.value)


def test_graph_sparsify_sketch_route_matches_jax(sensor, monkeypatch):
    """Above the dense limit the resistances come from the CG sketch."""
    J, T = sensor
    monkeypatch.setattr(jred, '_DENSE_RESISTANCE_MAX', 50)
    monkeypatch.setattr(tred, '_DENSE_RESISTANCE_MAX', 50)
    _close(tred.graph_sparsify(T, 0.6, seed=3, n_probes=16).W,
           jred.graph_sparsify(J, 0.6, seed=3, n_probes=16).W)


@pytest.mark.parametrize('kw', [dict(), dict(n_probes=8, seed=4, tol=1e-9)])
def test_effective_resistances_sketch_matches_jax(sensor, kw):
    J, T = sensor
    sj, tj, Rj = jred.effective_resistances_sketch(J, **kw)
    st, tt, Rt = tred.effective_resistances_sketch(T, **kw)
    assert np.array_equal(st, sj) and np.array_equal(tt, tj)
    _close(Rt, Rj)


def test_effective_resistances_sketch_obeys_fosters_theorem(sensor):
    """Σ_e w_e R_e = N − 1 on a connected graph, within the sketch's
    error (about 1/√k per edge, averaged over the edges)."""
    _, T = sensor
    s, t, R = tred.effective_resistances_sketch(T, n_probes=64)
    w = np.asarray(T.W[s, t]).ravel()
    assert abs(np.sum(w * R) / (T.N - 1) - 1) <= 0.05


def test_graph_sparsify_sketch_matches_jax(sensor):
    J, T = sensor
    _close(tred.graph_sparsify_sketch(T, 0.5, seed=5).W,
           jred.graph_sparsify_sketch(J, 0.5, seed=5).W)


@pytest.mark.parametrize('cols', [None, 2])
def test_interpolate_matches_jax(sensor, cols):
    J, T = sensor
    J.estimate_lmax()
    T._lmax = float(J.lmax)
    keep = _keep(T.N, 7)
    shape = (len(keep),) if cols is None else (len(keep), cols)
    f = np.random.default_rng(8).normal(size=shape)
    _close(tred.interpolate(T, f, keep, order=40),
           jred.interpolate(J, f, keep, order=40))


@pytest.fixture(scope='module')
def pyramids():
    """Pyramids of 2 levels from the full Fourier basis, unsparsified."""
    J = jgsp.graphs.Sensor(96, seed=42)
    T = tgsp.graphs.Sensor(96, seed=42, **CPU64)
    kw = dict(levels=2, sparsify=False, compute_full_eigen=True)
    return (jred.graph_multiresolution(J, **kw),
            tred.graph_multiresolution(T, **kw))


def test_graph_multiresolution_matches_jax(pyramids):
    Gj, Gt = pyramids
    assert [g.N for g in Gt] == [g.N for g in Gj]
    for gj, gt in zip(Gj, Gt):
        _close(gt.W, gj.W)
        _close(gt.e.numpy(), np.asarray(gj.e))
        for key in ('idx', 'orig_idx'):
            assert np.array_equal(gt.mr[key], gj.mr[key]), key
    for gj, gt in zip(Gj[:-1], Gt[:-1]):
        _close(gt.mr['K_reg'], gj.mr['K_reg'])


@pytest.mark.parametrize('kw', [dict(order=30), dict()])
def test_pyramid_matches_jax(pyramids, kw):
    Gj, Gt = pyramids
    f = np.random.default_rng(10).normal(size=Gt[0].N)
    caj, pej = jred.pyramid_analysis(Gj, f, **kw)
    cat, pet = tred.pyramid_analysis(Gt, f, **kw)
    for a, b in zip(cat + pet, caj + pej):
        _close(a, b)
    recj, _ = jred.pyramid_synthesis(Gj, caj[-1], pej)
    rect, _ = tred.pyramid_synthesis(Gt, cat[-1], pet)
    _close(rect, recj)
    if kw:       # the same order on both sides: an exact reconstruction
        assert np.abs(rect - f).max() <= 1e-10 * np.abs(f).max()


def test_pyramid_errors_match_jax(pyramids):
    Gj, Gt = pyramids
    f = np.random.default_rng(11).normal(size=(Gt[0].N, 3))
    for call_t, call_j in (
            (lambda: tred.pyramid_analysis(Gt, f),
             lambda: jred.pyramid_analysis(Gj, f)),
            (lambda: tred.pyramid_analysis(Gt, f[:5, 0]),
             lambda: jred.pyramid_analysis(Gj, f[:5, 0])),
            (lambda: tred.pyramid_analysis(Gt, f[:, 0], h_filters=[len] * 3),
             lambda: jred.pyramid_analysis(Gj, f[:, 0], h_filters=[len] * 3)),
            (lambda: tred.pyramid_synthesis(Gt, f[:2, 0], [f[:, 0]]),
             lambda: jred.pyramid_synthesis(Gj, f[:2, 0], [f[:, 0]]))):
        with pytest.raises(ValueError) as jerr:
            call_j()
        with pytest.raises(ValueError) as terr:
            call_t()
        assert str(terr.value) == str(jerr.value)


def test_lanczos_route_finds_the_top_eigenvector():
    """The start vector cannot match ``jax.random``'s: the Lanczos route's
    top eigenvector is held against ``eigh``'s, up to sign, within 1e-6,
    and the pyramid it gives keeps the full basis route's vertices."""
    T = tgsp.graphs.Sensor(96, seed=42, **CPU64)
    e, U = np.linalg.eigh(T.L.to_dense().numpy())
    gen = torch.Generator().manual_seed(0)
    V = tred._largest_eigenvector(T, gen)
    V = V / np.linalg.norm(V)
    assert min(np.abs(V - U[:, -1]).max(),
               np.abs(V + U[:, -1]).max()) <= 1e-6
    lanczos = tred.graph_multiresolution(T, 2, sparsify=False)
    full = tred.graph_multiresolution(
        tgsp.graphs.Sensor(96, seed=42, **CPU64), 2, sparsify=False,
        compute_full_eigen=True)
    for a, b in zip(lanczos[1:], full[1:]):
        assert np.array_equal(a.mr['idx'], b.mr['idx'])
        _close(a.W, b.W)
    # an explicit generator is taken as given
    gen = torch.Generator().manual_seed(5)
    Gs = tred.graph_multiresolution(T, 1, sparsify=False, generator=gen)
    assert np.array_equal(Gs[1].mr['idx'], full[1].mr['idx'])


def test_sparsified_pyramid_keeps_its_levels_connected(monkeypatch):
    """Both packages sparsify inside the pyramid without a seed: held by
    what the sample must give, a connected graph of fewer edges. The
    unseeded generator is given a seed here, so that the test draws the
    same sample every run."""
    default_rng = np.random.default_rng
    monkeypatch.setattr(np.random, 'default_rng', lambda seed=None:
                        default_rng(7 if seed is None else seed))
    T = tgsp.graphs.Sensor(200, seed=42, **CPU64)
    Gs = tred.graph_multiresolution(T, 2)
    dense = tred.graph_multiresolution(
        tgsp.graphs.Sensor(200, seed=42, **CPU64), 2, sparsify=False)
    # level 1 reduces the same graph; level 2 reduces level 1's sample
    assert Gs[1].N == dense[1].N and Gs[1].Ne < dense[1].Ne
    for a, b in zip(Gs[1:], Gs[:-1]):
        assert a.is_connected() and a.N < b.N
        assert np.array_equal(a.mr['orig_idx'],
                              b.mr['orig_idx'][a.mr['idx']])


@pytest.mark.parametrize('method', ['resistance_distance', 'unweighted'])
def test_tree_multiresolution_matches_jax(method):
    J = jgsp.graphs.Comet(30, k=6)
    T = tgsp.graphs.Comet(30, k=6, **CPU64)
    Gj, sj = jred.tree_multiresolution(J, 3, reduction_method=method,
                                       compute_full_eigen=True, root=2)
    Gt, st = tred.tree_multiresolution(T, 3, reduction_method=method,
                                       compute_full_eigen=True, root=2)
    assert len(Gt) == len(Gj)
    for a, b, ka, kb in zip(Gt, Gj, st, sj):
        _close(a.W, b.W)
        assert np.array_equal(ka, kb)
        _close(a.e.numpy(), np.asarray(b.e))
