"""The port's graphs, Laplacians and λmax estimates against pygsp_tpu.

Both packages build the same host scipy adjacency from the same seed; the
port's operators live on CPU tensors in float64 here.
"""

import numpy as np
import pytest
import torch

import pygsp_tpu as jgsp
import pygsp_tpu_torch as tgsp
from pygsp_tpu.ops import eigen as jeigen
from pygsp_tpu_torch.ops import eigen as teigen

CPU64 = dict(device='cpu', dtype=torch.float64)

GRAPHS = {
    'logo': lambda pkg, **kw: pkg.graphs.Logo(**kw),
    'grid2d': lambda pkg, **kw: pkg.graphs.Grid2d(12, 10, **kw),
    'ba': lambda pkg, **kw: pkg.graphs.BarabasiAlbert(150, m0=3, m=3,
                                                      seed=1, **kw),
}


def _pair(name, lap_type='combinatorial'):
    return (GRAPHS[name](jgsp, lap_type=lap_type),
            GRAPHS[name](tgsp, lap_type=lap_type, **CPU64))


@pytest.mark.parametrize('lap_type', ['combinatorial', 'normalized'])
@pytest.mark.parametrize('name', sorted(GRAPHS))
def test_graph_matches_jax(name, lap_type):
    J, T = _pair(name, lap_type)
    assert (T.N, T.Ne) == (J.N, J.Ne)
    assert abs(T.W - J.W).max() == 0          # same host builder: exact
    assert np.array_equal(T.d, J.d)
    assert np.allclose(T.dw, J.dw, rtol=0, atol=1e-14)
    assert (T.is_directed(), T.has_loops(), T.is_connected()) == (
        J.is_directed(), J.has_loops(), J.is_connected())
    # f64 degree sums in another order: 1e-14
    assert abs(T.L.to_scipy() - J.L.to_scipy()).max() <= 1e-14
    assert T.L.lap_type == lap_type and T.L.dtype == torch.float64
    assert np.allclose(T.L.to_dense().numpy(), J.L.to_scipy().toarray(),
                       rtol=0, atol=1e-14)


@pytest.mark.parametrize('name', sorted(GRAPHS))
def test_lmax_bounds_equal(name):
    J, T = _pair(name)
    J.estimate_lmax(method='bounds')
    T.estimate_lmax(method='bounds')
    assert T.lmax == J.lmax                   # the same host arithmetic
    # the tensor version of the bounds, against JAX's (f64 sums: 1e-12)
    want = float(jeigen.estimate_lmax_bounds(J.W_op))
    got = float(teigen.estimate_lmax_bounds(T.W_op))
    assert abs(got - want) <= 1e-12 * want


@pytest.mark.parametrize('name', sorted(GRAPHS))
def test_lmax_lanczos_close(name):
    J, T = _pair(name)
    J.estimate_lmax()
    T.estimate_lmax()
    # different start vectors (jax.random vs torch.Generator): 2e-2, the
    # regime tests/test_baseline_configs.py holds the JAX estimate to
    assert abs(T.lmax - J.lmax) / J.lmax < 2e-2
    assert T.lmax <= T._get_upper_bound()


def test_lmax_lanczos_is_seeded():
    T = tgsp.graphs.Grid2d(9, 7, **CPU64)
    a = float(teigen.estimate_lmax_lanczos(T.L, seed=3))
    b = float(teigen.estimate_lmax_lanczos(T.L, seed=3))
    assert a == b


def test_lmax_property_estimates_once():
    T = tgsp.graphs.Grid2d(6, 5, **CPU64)
    lmax = T.lmax                             # estimated on first use
    assert T._lmax_method == 'lanczos' and T.lmax == lmax


@pytest.mark.parametrize('case', ['nan', 'inf', 'non_square'])
def test_bad_adjacency_raises_like_jax(case):
    W = np.ones((4, 4)) - np.eye(4)
    if case == 'nan':
        W[0, 1] = np.nan
    elif case == 'inf':
        W[0, 1] = np.inf
    else:
        W = W[:3]
    with pytest.raises(ValueError) as jerr:
        jgsp.graphs.Graph(W)
    with pytest.raises(ValueError) as terr:
        tgsp.graphs.Graph(W, device='cpu')
    assert str(terr.value) == str(jerr.value)


def test_wrong_length_signal_raises_like_jax():
    J, T = _pair('grid2d')
    s = np.zeros(J.N + 1)
    with pytest.raises(ValueError, match='First dimension must be') as jerr:
        J.set_signal('x', s)
    with pytest.raises(ValueError, match='First dimension must be') as terr:
        T.set_signal('x', s)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match='First dimension must be'):
        tgsp.filters.Heat(T).filter(torch.zeros(J.N - 1))


def test_graph_api_details():
    W = np.array([[0., 1., 0.], [1., 0., 2.], [0., 2., 0.]])
    T = tgsp.graphs.Graph(W, **CPU64)
    with pytest.raises(AttributeError):
        T.W = W
    assert T.A.dtype == bool and T.A.nnz == 4
    x = torch.tensor([1.0, 2.0, 4.0], dtype=torch.float64)
    # x^T L x = Σ_edges w (x_i - x_j)^2 = 1·1 + 2·4
    assert float(T.dirichlet_energy(x)) == 9.0
    assert torch.equal(T.L.dot(x.numpy()), T.L @ x)
    with pytest.raises(ValueError, match='Unknown Laplacian type'):
        T.compute_laplacian('bogus')
    # each format builds the operator of the requested type, as the JAX
    # package does ('auto' is 'hybrid' here), and a refused one leaves the
    # operator of that type, as the JAX package builds it before it looks
    # at the format
    J = jgsp.graphs.Graph(W)
    for fmt, lap_type, error, match in (
            ('chunked', 'normalized', None, 'ChunkedELLMatrix'),
            ('hybrid', 'combinatorial', None, 'ELLMatrix'),
            ('auto', 'normalized', None, 'ELLMatrix'),
            ('bogus', 'combinatorial', ValueError, 'Unknown Laplacian format'),
            ('bogus', 'normalized', ValueError, 'Unknown Laplacian format')):
        if error is None:
            T.compute_laplacian(lap_type, fmt=fmt)
            J.compute_laplacian(lap_type, fmt=fmt)
            assert type(T.L.offdiag).__name__ == match
            assert type(J.L.offdiag).__name__ == match
        else:
            with pytest.raises(error, match=match):
                T.compute_laplacian(lap_type, fmt=fmt)
            with pytest.raises(error, match=match):
                J.compute_laplacian(lap_type, fmt=fmt)
        assert T.L.lap_type == T.lap_type == J.L.lap_type == lap_type
        assert abs(T.L.to_scipy() - J.L.to_scipy()).max() <= 1e-14
        T.estimate_lmax(method='bounds')
        J.estimate_lmax(method='bounds')
        assert T.lmax == pytest.approx(J.lmax, rel=1e-14)
        exact = float(np.linalg.eigvalsh(T.L.to_dense().numpy()).max())
        assert exact <= T.lmax
    with pytest.raises(ValueError, match='Unknown method'):
        T.estimate_lmax(method='bogus')
    assert repr(tgsp.graphs.Grid2d(3, 2, device='cpu')) == (
        'Grid2d(n_vertices=6, n_edges=7)')


def test_directed_graph_symmetrized_like_jax():
    W = np.array([[0., 1., 0.], [0., 0., 3.], [2., 0., 0.]])
    J, T = jgsp.graphs.Graph(W), tgsp.graphs.Graph(W, **CPU64)
    assert T.is_directed() and np.allclose(T.d, J.d) and np.allclose(
        T.dw, J.dw)
    assert abs(T.L.to_scipy() - J.L.to_scipy()).max() <= 1e-14


def test_float32_is_the_default_operator_dtype():
    T = tgsp.graphs.Grid2d(4, 4, device='cpu')
    assert T.L.dtype == torch.float32 and T.W_op.dtype == torch.float32
    assert T.L.device.type == 'cpu'


def test_ba_edges_fast_matches_jax():
    from pygsp_tpu.graphs.barabasialbert import ba_edges_fast as jfast
    src, tgt = tgsp.graphs.ba_edges_fast(2000, m0=4, m=4, seed=7)
    jsrc, jtgt = jfast(2000, m0=4, m=4, seed=7)
    assert np.array_equal(src, jsrc) and np.array_equal(tgt, jtgt)
    assert (tgt >= 0).all() and (tgt < src).all()
