"""The port's graph zoo against pygsp_tpu, on the CPU.

Each model class runs the JAX package's own NumPy and SciPy code on the
host, so that the same parameters and seed give the same W, coordinates and
attributes. Each is checked at two parameter sets, then through
``compute_laplacian(fmt='auto')`` (the hybrid ELL format at these sizes),
whose product must agree with the JAX package's within 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import pygsp_tpu as jgsp
import pygsp_tpu_torch as tgsp
from pygsp_tpu_torch.core import sparse as tsp

CPU64 = dict(device='cpu', dtype=torch.float64)

# (class, two keyword sets): small sizes, seeds where the class draws
CASES = {
    'Airfoil': ({}, {'lap_type': 'normalized'}),
    'Comet': (dict(N=12, k=5), dict(N=40, k=7)),
    'Community': (dict(N=60, Nc=3, seed=4),
                  dict(N=120, Nc=4, seed=9, world_density=0.02)),
    'DavidSensorNet': (dict(N=64), dict(N=120, seed=3)),
    'ErdosRenyi': (dict(N=50, p=0.2, seed=7),
                   dict(N=80, p=0.1, seed=2, connected=True)),
    'FullConnected': (dict(N=8), dict(N=15)),
    'LineGraph': ('Ring', 'Grid2d'),
    'LowStretchTree': (dict(k=3), dict(k=4)),
    'Minnesota': ({}, dict(connected=False)),
    'Path': (dict(N=5), dict(N=30, directed=True)),
    'RandomRegular': (dict(N=32, k=4, seed=2), dict(N=60, k=3, seed=5)),
    'RandomRing': (dict(N=10, seed=1), dict(N=50, seed=8)),
    'Ring': (dict(N=8), dict(N=20, k=3)),
    'Star': (dict(N=6), dict(N=25)),
    'StochasticBlockModel': (dict(N=90, k=3, p=0.5, q=0.05, seed=3),
                             dict(N=150, k=4, p=0.3, seed=11,
                                  directed=True)),
    'SwissRoll': (dict(N=100, seed=5),
                  dict(N=80, seed=6, dim=2, srtype='classic', noise=True)),
    'Torus': (dict(Nv=4, Mv=3), dict(Nv=10)),
}

# attributes the classes set, compared where a class has them
ATTRS = ('info', 'k', 'seed', 'p', 'q', 'z', 'M', 'directed', 'self_loops',
         'connected', 'labels', 'root', 'angles', 'x', 'N1', 'N2', 'Nv', 'Mv',
         'Nc', 'min_comm', 'comm_sizes', 'size_ratio', 'world_density',
         'comm_density', 'k_neigh', 'epsilon', 'a', 'b', 'dim', 'thresh',
         's', 'noise', 'srtype', 'max_iter', 'n_try')


def _make(name, which):
    kw = CASES[name][which]
    if name == 'LineGraph':
        inner = dict(Ring=dict(N=9), Grid2d=dict(N1=4, N2=3))[kw]
        return (jgsp.graphs.LineGraph(getattr(jgsp.graphs, kw)(**inner)),
                tgsp.graphs.LineGraph(getattr(tgsp.graphs, kw)(**inner,
                                                               **CPU64)))
    return (getattr(jgsp.graphs, name)(**kw),
            getattr(tgsp.graphs, name)(**kw, **CPU64))


def _same(a, b, what):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), what
        for k in a:
            _same(a[k], b[k], f'{what}[{k!r}]')
    elif sps.issparse(a):
        assert abs(a - b).max() == 0, what
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.array_equal(np.asarray(a), np.asarray(b)), what
    else:
        assert a == b, what


@pytest.mark.parametrize('which', [0, 1])
@pytest.mark.parametrize('name', list(CASES))
def test_model_matches_jax(name, which):
    J, T = _make(name, which)
    assert type(T).__name__ == name
    assert (T.N, T.Ne) == (J.N, J.Ne)
    assert T.W.shape == J.W.shape and abs(T.W - J.W).max() == 0
    assert (T.coords is None) == (J.coords is None)
    if J.coords is not None:
        assert np.array_equal(T.coords, J.coords)
    for attr in ATTRS:
        assert hasattr(T, attr) == hasattr(J, attr), attr
        if hasattr(J, attr):
            _same(getattr(J, attr), getattr(T, attr), attr)
    _same(dict(J.plotting), dict(T.plotting), 'plotting')
    assert repr(T) == repr(J)
    assert T.lap_type == J.lap_type
    assert abs(T.L.to_scipy() - J.L.to_scipy()).max() <= 1e-14


@pytest.mark.parametrize('name', list(CASES))
def test_auto_format_takes_the_model_to_hybrid(name):
    """At these sizes fmt='auto' is the hybrid ELL format in both
    packages, and its product agrees."""
    J, T = _make(name, 0)
    J.compute_laplacian(J.lap_type, fmt='auto')
    T.compute_laplacian(T.lap_type, fmt='auto')
    assert isinstance(T.L.offdiag, tsp.ELLMatrix)
    assert type(J.L.offdiag).__name__ == 'ELLMatrix'
    x = np.random.default_rng(T.N).normal(size=(T.N, 3))
    got = (T.L @ torch.from_numpy(x)).numpy()
    want = np.asarray(J.L @ jnp.asarray(x))
    assert np.abs(got - want).max() <= 1e-12 * max(1.0, np.abs(want).max())


def test_zoo_exports_as_the_jax_package():
    names = set(CASES) | {'Grid2d', 'BarabasiAlbert', 'Logo', 'Graph'}
    assert names <= set(dir(tgsp.graphs))
    for name in names:
        assert getattr(tgsp.graphs, name).__name__ == name
    assert tgsp.graphs.ring.Ring is tgsp.graphs.Ring
    with pytest.raises(AttributeError):
        tgsp.graphs.NotAGraph


def test_zoo_refusals_match_jax():
    for name, kw in (('Comet', dict(N=5, k=5)), ('Ring', dict(N=2)),
                     ('Ring', dict(N=6, k=4)), ('RandomRing', dict(N=2)),
                     ('RandomRegular', dict(N=5, k=3)),
                     ('StochasticBlockModel',
                      dict(N=20, k=2, p=[0.5, 0.4, 0.3])),
                     ('Community', dict(N=30, world_density=2.0)),
                     ('SwissRoll', dict(N=20, dim=4))):
        with pytest.raises(ValueError) as jerr:
            getattr(jgsp.graphs, name)(**kw)
        with pytest.raises(ValueError) as terr:
            getattr(tgsp.graphs, name)(**kw, **CPU64)
        assert str(terr.value) == str(jerr.value), name


def test_set_coordinates_closed_forms_match_jax():
    J = jgsp.graphs.Path(7)
    T = tgsp.graphs.Path(7, **CPU64)
    for kind in ('line1D', 'line2D', 'ring2D', 'random2D', 'random3D'):
        J.set_coordinates(kind, seed=3)
        T.set_coordinates(kind, seed=3)
        assert np.array_equal(T.coords, J.coords), kind
    T.set_coordinates(np.ones((7, 3)))
    assert T.coords.shape == (7, 3)
    with pytest.raises(ValueError, match='Expecting coordinates'):
        T.set_coordinates(np.ones((6, 2)))
    # the solved layouts are ported (tests/test_torch_layout_io.py): the
    # default, 'spring', gives the JAX package's coordinates
    J.set_coordinates(seed=3)
    T.set_coordinates(seed=3)
    assert np.array_equal(T.coords, J.coords)
    with pytest.raises(ValueError, match='Unexpected argument'):
        T.set_coordinates('spiral')
