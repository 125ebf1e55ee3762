"""The port's layouts and graph I/O against pygsp_tpu, on the CPU.

``spring`` and ``community2D`` run the JAX package's own NumPy code from
the same seed: the coordinates are equal. The Laplacian eigenmaps go
through ``compute_fourier_basis(k)``: LOBPCG above 2000 vertices, held as
tests/test_torch_eigen.py holds the partial basis (eigenvalues within 1e-6
of SciPy's ``eigsh`` and of the JAX package's, each vector's alignment
``|Uᵀ U_ref|`` within 1e-4 of 1), and the dense ``eigh`` below (the
coordinates within 1e-10 of the JAX package's, up to each column's sign).
I/O: networkx round trips and the file formats against the JAX package's
exports; graph-tool is not installed, so its tests skip.
"""

import os

import networkx as nx
import numpy as np
import pytest
import scipy.sparse.linalg as spl
import torch

import pygsp_tpu as jgsp
import pygsp_tpu_torch as tgsp
from pygsp_tpu.graphs import _io as jio
from pygsp_tpu_torch.graphs import _io as tio

CPU64 = dict(device='cpu', dtype=torch.float64)
# above the dense path's 2000 vertices; a grid of two unequal sides has
# simple small eigenvalues
EIGENMAP_GRID = (100, 27)


@pytest.mark.parametrize('kw', [dict(), dict(dim=3, iterations=20, k=0.3),
                                dict(pos=[[0.1, 0.2], [0.5, 0.5]],
                                     fixed=[0], center=[1.0, 2.0])])
def test_spring_matches_jax(kw):
    J = jgsp.graphs.Ring(12)
    T = tgsp.graphs.Ring(12, **CPU64)
    J.set_coordinates('spring', seed=4, **kw)
    T.set_coordinates('spring', seed=4, **kw)
    assert np.array_equal(T.coords, J.coords)


def test_spring_on_a_large_graph_matches_jax():
    """Above 2048 vertices: repulsion from a seeded sample, attraction
    along the edges."""
    J = jgsp.graphs.Grid2d(50, 45)
    T = tgsp.graphs.Grid2d(50, 45, **CPU64)
    J.set_coordinates('spring', seed=2, iterations=3)
    T.set_coordinates('spring', seed=2, iterations=3)
    assert np.array_equal(T.coords, J.coords)


def test_community2d_matches_jax():
    kw = dict(N=80, Nc=3, seed=5)
    J = jgsp.graphs.Community(**kw)
    T = tgsp.graphs.Community(**kw, **CPU64)
    J.set_coordinates('community2D', seed=1)
    T.set_coordinates('community2D', seed=1)
    assert np.array_equal(T.coords, J.coords)
    for key in ('world_rad', 'comm_sizes', 'com_coords'):
        assert np.array_equal(T.info[key], J.info[key]), key
    R = tgsp.graphs.Ring(5, **CPU64)
    with pytest.raises(ValueError, match='community coordinates'):
        R.set_coordinates('community2D')


def _held(e, U, er, Ur):
    e, U = np.asarray(e), np.asarray(U)
    assert np.abs(e - er).max() <= 1e-6
    assert np.abs(np.diag(np.abs(U.T @ Ur)) - 1).max() <= 1e-4


@pytest.fixture(scope='module')
def eigenmap_grid():
    J = jgsp.graphs.Grid2d(*EIGENMAP_GRID)
    T = tgsp.graphs.Grid2d(*EIGENMAP_GRID, **CPU64)
    er, Ur = spl.eigsh(T.L.to_scipy(), 5, which='SM')
    assert np.diff(er).min() > 1e-4          # simple eigenvalues
    return J, T, er, Ur


@pytest.mark.parametrize('kind,k', [('laplacian_eigenmap2D', 3),
                                    ('laplacian_eigenmap3D', 4)])
def test_eigenmaps_by_lobpcg_match_eigsh_and_jax(eigenmap_grid, kind, k):
    J, T, er, Ur = eigenmap_grid
    T._U = T._e = None
    T.set_coordinates(kind)
    assert T.U.shape == (T.N, k)
    _held(T.e, T.U, er[:k], Ur[:, :k])
    J._U = J._e = None
    J.set_coordinates(kind)
    _held(T.e, T.U, J.e, J.U)
    assert np.array_equal(T.coords, T.U[:, 1:k].numpy())


@pytest.mark.parametrize('kind,cols', [('laplacian_eigenmap2D', 2),
                                       ('laplacian_eigenmap3D', 3)])
def test_eigenmaps_by_eigh_match_jax(kind, cols):
    J = jgsp.graphs.Sensor(200, seed=42)
    T = tgsp.graphs.Sensor(200, seed=42, **CPU64)
    J.set_coordinates(kind)
    T.set_coordinates(kind)
    assert T.coords.shape == (200, cols)
    signs = np.sign(np.sum(T.coords * J.coords, axis=0))
    assert np.abs(T.coords * signs - J.coords).max() <= 1e-10


def _with_signals(G):
    G.set_signal('temperature', np.arange(G.N, dtype=float))
    G.set_signal('count', np.arange(G.N) % 3)
    G.set_signal('xy', np.stack([np.ones(G.N), np.arange(G.N) * 0.5], 1))
    return G


@pytest.mark.parametrize('directed', [False, True])
def test_to_networkx_matches_jax(directed):
    J = _with_signals(jgsp.graphs.Path(6, directed=directed))
    T = _with_signals(tgsp.graphs.Path(6, directed=directed, **CPU64))
    gj, gt = jio.to_networkx(J), T.to_networkx()
    assert type(gt) is type(gj) and gt.name == gj.name == 'Path'
    assert dict(gt.nodes(data=True)) == dict(gj.nodes(data=True))
    assert sorted(gt.edges(data=True)) == sorted(gj.edges(data=True))


def test_networkx_round_trip_matches_jax():
    nx_graph = jio.to_networkx(_with_signals(jgsp.graphs.Ring(9)))
    J = jio.from_networkx(nx_graph)
    T = tgsp.graphs.Graph.from_networkx(nx_graph, **CPU64)
    assert abs(T.W - J.W).max() == 0
    assert set(T.signals) == set(J.signals) == {'temperature', 'count', 'xy'}
    for name in T.signals:
        assert np.array_equal(T.signals[name], J.signals[name]), name
    assert T.device == torch.device('cpu') and T.dtype == torch.float64


def test_from_networkx_fills_nan_and_sums_multiedges():
    graph = nx.MultiGraph()
    graph.add_node(0, a=1.0)
    graph.add_edges_from([(0, 1, {'weight': 2.0}), (0, 1, {'weight': 3.0}),
                          (1, 2, {'weight': 1.0})])
    J = jio.from_networkx(graph)
    T = tio.from_networkx(graph, **CPU64)
    assert T.W[0, 1] == J.W[0, 1] == 5.0
    assert np.array_equal(T.signals['a'], J.signals['a'], equal_nan=True)
    assert np.isnan(T.signals['a'][1:]).all()


def test_signals_on_a_tensor_export():
    T = tgsp.graphs.Ring(4, **CPU64)
    T.set_signal('s', torch.arange(4, dtype=torch.float64))
    assert [d['s'] for _, d in T.to_networkx().nodes(data=True)] == \
        [0.0, 1.0, 2.0, 3.0]


@pytest.mark.parametrize('fmt', ['graphml', 'gml', 'gexf'])
def test_save_load_round_trip_matches_jax(tmp_path, fmt):
    T = _with_signals(tgsp.graphs.Sensor(30, seed=3, **CPU64))
    J = _with_signals(jgsp.graphs.Sensor(30, seed=3))
    path = os.path.join(tmp_path, f'g.{fmt}')
    T.save(path)
    H = tgsp.graphs.Graph.load(path, **CPU64)
    HJ = jgsp.graphs.Graph.load(path)       # the JAX package reads ours
    assert abs(H.W - T.W).max() <= 1e-12 * T.W.max()
    assert abs(HJ.W - H.W).max() == 0
    for name in T.signals:
        assert np.allclose(H.signals[name], T.signals[name], rtol=0,
                           atol=1e-12), name
    J.save(os.path.join(tmp_path, f'j.{fmt}'))
    HT = tio.load(os.path.join(tmp_path, f'j.{fmt}'), backend='networkx',
                  **CPU64)                   # and we read the JAX package's
    assert abs(HT.W - H.W).max() == 0


def test_io_errors_match_jax(tmp_path):
    G = tgsp.graphs.Ring(4, **CPU64)
    J = jgsp.graphs.Ring(4)
    for call_t, call_j in (
            (lambda: G.save('g.txt'), lambda: J.save('g.txt')),
            (lambda: tio.load('g.dot', **CPU64), lambda: jio.load('g.dot')),
            (lambda: G.save(str(tmp_path / 'g.gml'), backend='igraph'),
             lambda: J.save(str(tmp_path / 'g.gml'), backend='igraph'))):
        with pytest.raises(ValueError) as jerr:
            call_j()
        with pytest.raises(ValueError) as terr:
            call_t()
        assert str(terr.value) == str(jerr.value)


def test_graph_tool_backend_missing_raises_import_error(tmp_path):
    try:
        import graph_tool  # noqa: F401
    except ImportError:
        pass
    else:
        pytest.skip('graph-tool is installed')
    G = tgsp.graphs.Ring(4, **CPU64)
    with pytest.raises(ImportError, match='graph-tool'):
        G.to_graphtool()
    with pytest.raises(ImportError, match='graph-tool'):
        G.save(str(tmp_path / 'g.gml'), backend='graph-tool')


def test_graph_tool_round_trip():
    pytest.importorskip('graph_tool')
    T = _with_signals(tgsp.graphs.Ring(7, **CPU64))
    H = tgsp.graphs.Graph.from_graphtool(T.to_graphtool(), **CPU64)
    assert abs(H.W - T.W).max() == 0
    assert np.array_equal(H.signals['xy'], T.signals['xy'])
