"""The port's nearest-neighbour graphs against pygsp_tpu, on the CPU.

Each class runs the JAX package's own host code (SciPy's KDTree, the
Gaussian weights, ``utils.symmetrize``) and draws from the same NumPy
generators (``RandomState`` for ``Cube`` and ``Sphere``, ``default_rng``
for ``Sensor`` and ``TwoMoons``), so the same parameters and seed give the
JAX package's W, coordinates and attributes exactly. Each class is checked
at two parameter sets, then its Laplacian's product against the JAX
package's within 1e-12.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import pygsp_tpu as jgsp
import pygsp_tpu_torch as tgsp

CPU64 = dict(device='cpu', dtype=torch.float64)
TOL = 1e-12

_IMG = np.random.default_rng(0).random((8, 9))
_IMG3 = np.random.default_rng(1).random((6, 7, 3))
_PTS = np.random.default_rng(2).normal(size=(50, 3))

# (class, two parameter sets): small sizes, seeds where the class draws
CASES = {
    'NNGraph': (dict(Xin=_PTS, k=4),
                dict(Xin=_PTS, NNtype='radius', epsilon=0.3,
                     symmetrize_type='maximum', dist_type='manhattan')),
    'Sensor': (dict(N=64, seed=42), dict(N=100, k=5, distributed=True,
                                         seed=3)),
    'Sphere': (dict(nb_pts=64, seed=6), dict(nb_pts=80, nb_dim=2, seed=1)),
    'Cube': (dict(nb_pts=64, seed=6), dict(nb_pts=90, nb_dim=2, seed=2)),
    'TwoMoons': (dict(), dict(moontype='synthesized', N=100, seed=7,
                              sigmad=0.1)),
    'Bunny': (dict(), dict(lap_type='normalized')),
    'ImgPatches': (dict(img=_IMG), dict(img=_IMG3, patch_shape=2, k=5)),
    'Grid2dImgPatches': (dict(img=_IMG), dict(img=_IMG, patch_shape=(5, 5),
                                              k=4)),
}

# attributes the classes set, compared where a class has them
ATTRS = ('Xin', 'NNtype', 'use_flann', 'center', 'rescale', 'k', 'sigma',
         'epsilon', 'symmetrize_type', 'dist_type', 'order', 'distributed',
         'seed', 'radius', 'nb_pts', 'nb_dim', 'sampling', 'moontype', 'dim',
         'sigmag', 'sigmad', 'distance', 'labels', 'img', 'patch_shape',
         'lap_type', 'plotting')


def _make(name, which):
    kw = CASES[name][which]
    return (getattr(jgsp.graphs, name)(**kw),
            getattr(tgsp.graphs, name)(**kw, **CPU64))


def _same(a, b, what):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), what
        for k in a:
            _same(a[k], b[k], f'{what}[{k!r}]')
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.array_equal(np.asarray(a), np.asarray(b)), what
    else:
        assert a == b, what


@pytest.mark.parametrize('which', [0, 1])
@pytest.mark.parametrize('name', list(CASES))
def test_nn_graph_matches_jax(name, which):
    J, T = _make(name, which)
    assert type(T).__name__ == name
    assert (T.N, T.Ne) == (J.N, J.Ne)
    assert abs(T.W - J.W).max() == 0
    assert np.array_equal(T.coords, J.coords)
    for attr in ATTRS:
        if hasattr(J, attr):
            _same(getattr(J, attr), getattr(T, attr), f'{name}.{attr}')
    assert T._get_extra_repr() == J._get_extra_repr()
    assert T.device == torch.device('cpu') and T.dtype == torch.float64


@pytest.mark.parametrize('name', list(CASES))
def test_nn_graph_laplacian_matches_jax(name):
    J, T = _make(name, 0)
    x = np.random.default_rng(4).normal(size=(T.N, 3))
    want = np.asarray(J.L @ x)
    got = (T.L @ torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_grid2dimgpatches_aggregates_on_one_device():
    T = tgsp.graphs.Grid2dImgPatches(_IMG, aggregate=lambda Wp, Wg: Wg,
                                     **CPU64)
    assert abs(T.W - tgsp.graphs.Grid2d(8, 9, **CPU64).W).max() == 0
    for G in (T, T.Gg, T.Gp):
        assert G.device == torch.device('cpu') and G.dtype == torch.float64


def test_nn_graphs_on_the_float32_default():
    """Without a dtype the operators are float32, W the same host array."""
    T = tgsp.graphs.Sensor(64, seed=42, device='cpu')
    assert T.L.dtype == torch.float32
    assert abs(T.W - jgsp.graphs.Sensor(64, seed=42).W).max() == 0


@pytest.mark.parametrize('name,kw', [
    ('NNGraph', dict(Xin=_PTS, k=50)),
    ('NNGraph', dict(Xin=_PTS, NNtype='other')),
    ('NNGraph', dict(Xin=_PTS, NNtype='radius', epsilon=1e-9)),
    ('Sensor', dict(N=50, distributed=True)),
    ('Sphere', dict(sampling='grid')),
    ('Cube', dict(sampling='grid')),
    ('TwoMoons', dict(moontype='other')),
    ('ImgPatches', dict(img=np.zeros(5))),
])
def test_nn_graph_errors_match_jax(name, kw):
    with pytest.raises(ValueError) as jerr:
        getattr(jgsp.graphs, name)(**kw)
    with pytest.raises(ValueError) as terr:
        getattr(tgsp.graphs, name)(**kw, **CPU64)
    assert str(terr.value) == str(jerr.value)


def test_cube_refuses_four_dimensions_as_jax_does():
    with pytest.raises(NotImplementedError):
        jgsp.graphs.Cube(nb_dim=4)
    with pytest.raises(NotImplementedError, match='Dimension > 3'):
        tgsp.graphs.Cube(nb_dim=4, **CPU64)


def test_nn_graphs_are_exported_lazily():
    names = ('NNGraph', 'Bunny', 'Cube', 'Grid2dImgPatches', 'ImgPatches',
             'Sensor', 'Sphere', 'TwoMoons')
    assert set(names) <= set(dir(tgsp.graphs))
    for name in names:
        assert issubclass(getattr(tgsp.graphs, name), tgsp.graphs.Graph)
    assert sps.issparse(tgsp.graphs.Sensor(16, seed=1, **CPU64).W)
