"""Helpers that no other test names, held to the JAX package's in float64
on the CPU: ``utils.distanz``, ``rescale_center``, ``compute_log_scales``,
``loadmat`` (every point cloud the package ships) and ``build_logger``;
``RandomRegular.is_regular``; ``ops.eigen.matvec_adj``;
``core.operators.degrees_from_adjacency``; ``convert.banded_from_numpy``
(the JAX package's banded leaves carried across); and ``plotting``'s
``plot_graph``, ``plot_filter``, ``show`` and ``close`` with the Agg
backend (the same artists and data, no display)."""

import logging
import os
import types

import matplotlib

matplotlib.use('Agg')

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import scipy.sparse as sps  # noqa: E402
import torch  # noqa: E402

import pygsp_tpu as jgsp  # noqa: E402
from pygsp_tpu import plotting as jplot  # noqa: E402
from pygsp_tpu import utils as jutils  # noqa: E402
from pygsp_tpu.core import operators as jops  # noqa: E402
from pygsp_tpu.core import sparse as jsparse  # noqa: E402
from pygsp_tpu.graphs import randomregular as jrr  # noqa: E402
from pygsp_tpu.ops import eigen as jeigen  # noqa: E402
from pygsp_tpu.ops.spmm import spmm as jax_spmm  # noqa: E402

import pygsp_tpu_torch as tgsp  # noqa: E402
from pygsp_tpu_torch import convert  # noqa: E402
from pygsp_tpu_torch import plotting as tplot  # noqa: E402
from pygsp_tpu_torch import utils as tutils  # noqa: E402
from pygsp_tpu_torch.core import operators as tops  # noqa: E402
from pygsp_tpu_torch.core import sparse as tsparse  # noqa: E402
from pygsp_tpu_torch.graphs import randomregular as trr  # noqa: E402
from pygsp_tpu_torch.ops import eigen as teigen  # noqa: E402

CPU = dict(device='cpu', dtype=torch.float64)


def _close(a, b, tol=1e-12):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    assert a.shape == b.shape
    assert np.abs(a - b).max(initial=0.0) <= tol * max(
        np.abs(b).max(initial=0.0), 1.0)


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    jplot.close_all()
    tplot.close_all()


# ---------------------------------------------------------------------------
# utils
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('shapes', [((3, 7), None), ((3, 7), (3, 5)),
                                    ((7,), None), ((2, 1), (2, 4))])
def test_distanz(shapes):
    rng = np.random.default_rng(0)
    x = rng.normal(size=shapes[0])
    y = None if shapes[1] is None else rng.normal(size=shapes[1])
    _close(tutils.distanz(x, y), jutils.distanz(x, y))


@pytest.mark.parametrize('shape', [(2, 10), (3, 6), (1, 5)])
def test_rescale_center(shape):
    x = np.random.default_rng(1).uniform(-3, 7, size=shape)
    got = tutils.rescale_center(x)
    _close(got, jutils.rescale_center(x))
    assert np.abs(got).max() == pytest.approx(1.0)


@pytest.mark.parametrize('args', [(1.0, 10.0, 3), (0.01, 37.5, 8),
                                  (0.2, 4.0, 5, 0.5, 3.0), (1.0, 1.0, 1)])
def test_compute_log_scales(args):
    _close(tutils.compute_log_scales(*args), jutils.compute_log_scales(*args))


ASSETS = sorted(f[:-len('.npz')] for f in os.listdir(os.path.join(
    os.path.dirname(tgsp.__file__), 'data', 'pointclouds'))
    if f.endswith('.npz'))


def test_the_port_ships_the_point_clouds():
    assert ASSETS == sorted(
        f[:-len('.npz')] for f in os.listdir(os.path.join(
            os.path.dirname(jgsp.__file__), 'data', 'pointclouds'))
        if f.endswith('.npz'))


@pytest.mark.parametrize('name', ASSETS)
def test_loadmat(name):
    got, want = tutils.loadmat(name), jutils.loadmat(name)
    assert sorted(got) == sorted(want)
    for key in want:
        a, b = got[key], want[key]
        assert sps.issparse(a) == sps.issparse(b), key
        if sps.issparse(b):
            assert a.format == b.format and a.shape == b.shape
            assert (a != b).nnz == 0, key
        else:
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and np.array_equal(a, b), key
    assert tutils.loadmat('pointclouds/' + name).keys() == got.keys()


def test_build_logger():
    got = tutils.build_logger('helper_parity.port')
    want = jutils.build_logger('helper_parity.jax')
    assert (got.level, got.propagate) == (want.level, want.propagate)
    assert [type(h) for h in got.handlers] == [type(h) for h in want.handlers]
    assert (got.handlers[0].formatter._fmt
            == want.handlers[0].formatter._fmt)
    # a second call keeps the one handler
    assert tutils.build_logger('helper_parity.port').handlers == got.handlers


# ---------------------------------------------------------------------------
# RandomRegular.is_regular
# ---------------------------------------------------------------------------

class _Messages(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _is_regular_messages(module, G):
    catch = _Messages()
    module._logger.addHandler(catch)
    try:
        G.is_regular()
    finally:
        module._logger.removeHandler(catch)
    return catch.messages


def _broken(W):
    """A stand-in for a graph whose adjacency is W with a self loop, a
    one-sided edge and a parallel edge's weight of 2 (graphs refuse an
    edit of W; ``is_regular`` reads ``W`` and ``d`` alone)."""
    W = sps.lil_matrix(W, dtype=float)
    W[0, 0] = 1.0
    W[1, 2] = 2.0
    W = sps.csr_matrix(W)
    return types.SimpleNamespace(W=W, d=np.diff(W.indptr),
                                 is_regular=lambda: None)


def test_random_regular_is_regular():
    kw = dict(N=24, k=3, seed=2)
    jG, tG = jgsp.graphs.RandomRegular(**kw), tgsp.graphs.RandomRegular(
        **kw, **CPU)
    assert (sps.csr_matrix(tG.W) != sps.csr_matrix(jG.W)).nnz == 0
    assert _is_regular_messages(trr, tG) == _is_regular_messages(jrr, jG) \
        == []
    _close(np.asarray(tG.d), np.asarray(jG.d))
    G = _broken(jG.W)
    G.is_regular = lambda: trr.RandomRegular.is_regular(G)
    got = _is_regular_messages(trr, G)
    G.is_regular = lambda: jrr.RandomRegular.is_regular(G)
    want = _is_regular_messages(jrr, G)
    assert got == want and len(got) == 1
    assert 'not symmetric' in got[0] and 'self loop' in got[0]


# ---------------------------------------------------------------------------
# matvec_adj, degrees_from_adjacency, banded_from_numpy
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def W():
    A = sps.random(300, 300, density=0.03, random_state=4)
    A = sps.lil_matrix(A + A.T)
    A[7, :] = 0                                  # an isolated vertex
    A[:, 7] = 0
    A = sps.csr_matrix(A)
    A.eliminate_zeros()
    return A


@pytest.mark.parametrize('s', [1, 4])
def test_matvec_adj(W, s):
    x = np.random.default_rng(s).normal(size=(W.shape[0], s))
    got = teigen.matvec_adj(tsparse.from_scipy(W, dtype=torch.float64,
                                               device='cpu'),
                            torch.from_numpy(x))
    want = jeigen.matvec_adj(jsparse.from_scipy(W, dtype=jnp.float64),
                             jnp.asarray(x))
    _close(got.numpy(), want)
    _close(got.numpy(), W @ x)


def test_degrees_from_adjacency(W):
    d, dw = tops.degrees_from_adjacency(
        tsparse.from_scipy(W, dtype=torch.float64, device='cpu'))
    jd, jdw = jops.degrees_from_adjacency(jsparse.from_scipy(
        W, dtype=jnp.float64))
    _close(d.numpy(), jd)
    _close(dw.numpy(), jdw)
    assert float(d[7]) == float(dw[7]) == 0.0
    _close(d.numpy(), np.diff(W.indptr))


def test_banded_from_numpy():
    """The JAX package's banded leaves, carried across: the same tiles, and
    the port's banded SpMM on them equal to the JAX package's."""
    G = jgsp.graphs.Grid2d(20, 13)
    B = jsparse.banded_from_scipy(sps.csr_matrix(G.W), dtype=jnp.float64)
    leaves = {'tiles': np.asarray(B.tiles), 'n_rows': B.n_rows,
              'n_cols': B.n_cols, 'nnz': B.nnz, 'half_bw': B.half_bw}
    got = convert.banded_from_numpy(leaves, device='cpu')
    assert (got.n_rows, got.n_cols, got.nnz, got.half_bw) == (
        B.n_rows, B.n_cols, B.nnz, B.half_bw)
    assert np.array_equal(got.tiles.numpy(), leaves['tiles'])
    x = np.random.default_rng(3).normal(size=(B.n_cols, 3))
    want = np.asarray(jax_spmm(B, jnp.asarray(x)))
    _close(tsparse.spmm(got, torch.from_numpy(x)).numpy(), want)
    _close(want, sps.csr_matrix(G.W) @ x)


# ---------------------------------------------------------------------------
# plotting
# ---------------------------------------------------------------------------

def _artists(ax):
    """The data of an axes: each collection's offsets, sizes, colours and
    segments, each line's data, the title and labels."""
    out = []
    for c in ax.collections:
        item = {'type': type(c).__name__,
                'offsets': np.asarray(c.get_offsets(), dtype=float)}
        if hasattr(c, 'get_sizes'):
            item['sizes'] = np.asarray(c.get_sizes(), dtype=float)
        item['facecolors'] = np.asarray(c.get_facecolors(), dtype=float)
        if hasattr(c, 'get_segments'):
            item['segments'] = [np.asarray(s, dtype=float)
                                for s in c.get_segments()]
        out.append(item)
    lines = [(np.asarray(ln.get_xdata(), dtype=float),
              np.asarray(ln.get_ydata(), dtype=float), ln.get_label())
             for ln in ax.get_lines()]
    return out, lines, (ax.get_title(), ax.get_xlabel(), ax.get_ylabel())


def _same_artists(got, want):
    (gc, gl, gt), (wc, wl, wt) = _artists(got), _artists(want)
    assert gt == wt and (wc or wl)
    assert [c['type'] for c in gc] == [c['type'] for c in wc]
    for a, b in zip(gc, wc):
        for key in b:
            if key == 'type':
                continue
            if key == 'segments':
                assert len(a[key]) == len(b[key])
                for s, t in zip(a[key], b[key]):
                    _close(s, t)
            else:
                _close(a[key], b[key])
    assert len(gl) == len(wl)
    for (gx, gy, glab), (wx, wy, wlab) in zip(gl, wl):
        _close(gx, wx)
        _close(gy, wy)
        assert glab == wlab


@pytest.fixture(scope='module')
def sensors():
    return (tgsp.graphs.Sensor(30, seed=1, **CPU),
            jgsp.graphs.Sensor(30, seed=1))


@pytest.mark.parametrize('options', [
    dict(), dict(edges=False, indices=True, highlight=[0, 3], title='t'),
    dict(vertex_color='signal', vertex_size='degree', edge_width='weight')])
def test_plot_graph(sensors, options):
    tG, jG = sensors
    _close(tG.coords, jG.coords)
    kw = dict(options)
    wkw = dict(options)
    if kw.get('vertex_color') == 'signal':
        sig = np.random.default_rng(2).normal(size=tG.N)
        kw['vertex_color'] = wkw['vertex_color'] = sig
        kw['vertex_size'] = np.asarray(tG.dw)
        wkw['vertex_size'] = np.asarray(jG.dw)
        kw['edge_width'] = tG.get_edge_list()[2]
        wkw['edge_width'] = np.asarray(jG.get_edge_list()[2])
    _same_artists(tplot.plot_graph(tG, **kw), jplot.plot_graph(jG, **wkw))


@pytest.mark.parametrize('scale', [5.0, [2.0, 10.0]])
def test_plot_filter(sensors, scale):
    tG, jG = sensors
    tG.estimate_lmax()
    jG.estimate_lmax()
    jG._lmax = tG._lmax = float(jG.lmax)
    got = tplot.plot_filter(tgsp.filters.Heat(tG, scale=scale), n=50)
    want = jplot.plot_filter(jgsp.filters.Heat(jG, scale=scale), n=50)
    _same_artists(got, want)


def test_show_and_close():
    """Under Agg, ``show`` draws nothing and returns as the JAX package's
    does; ``close`` closes the current figure, ``close('all')`` every
    one."""
    import matplotlib.pyplot as plt
    for module in (tplot, jplot):
        plt.close('all')
        plt.figure()
        plt.figure()
        assert module.show(block=False) is None
        module.close()
        assert len(plt.get_fignums()) == 1
        module.close('all')
        assert plt.get_fignums() == []
