"""The difference operator (``compute_differential_operator``, ``D``,
``grad``, ``div``), ``CSRMatrix.T`` and the graph-core odds
(``is_weighted``, ``subgraph``, ``extract_components``, ``get_edge_list``)
against pygsp_tpu, in float64 on the CPU.

Tolerance 1e-12 of the largest reference magnitude: the port computes
``grad`` as a CSR product of Dᵀ (two entries a row) and ``div`` as one of D
(each vertex's entries in edge order), where the JAX package gathers and
adds two segment sums, sources then targets; the same f64 products summed
in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch
from unittest import mock

import pygsp_tpu as jgsp
import pygsp_tpu_torch as tgsp
from pygsp_tpu.core import sparse as jsp
from pygsp_tpu_torch.core import sparse as tsp

CPU64 = dict(device='cpu', dtype=torch.float64)
TOL = 1e-12


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert float(np.abs(got - want).max()) <= tol * max(
        1.0, float(np.abs(want).max()))


def _adjacency(case, n=40, seed=5):
    """A weighted adjacency: symmetric, directed (W ≠ Wᵀ) or symmetric with
    self-loops; every vertex on a path, so the graph is connected."""
    rng = np.random.default_rng(seed)
    W = sps.random(n, n, density=0.12, random_state=rng)
    W = W + sps.diags(rng.uniform(0.5, 2, n - 1), 1)
    if case != 'directed':
        W = W + W.T
    W = sps.lil_matrix(W)
    W.setdiag(0)
    if case == 'loops':
        for v in (3, 17, 31):
            W[v, v] = 0.7
    return sps.csr_matrix(W)


CASES = [('undirected', 'combinatorial'), ('undirected', 'normalized'),
         ('directed', 'combinatorial'), ('directed', 'normalized'),
         ('loops', 'combinatorial'), ('loops', 'normalized')]


def _pair(case, lap_type):
    W = _adjacency(case)
    J = jgsp.graphs.Graph(W, lap_type=lap_type)
    T = tgsp.graphs.Graph(W, lap_type=lap_type, **CPU64)
    J.compute_differential_operator()
    T.compute_differential_operator()
    return J, T


@pytest.mark.parametrize('case,lap_type', CASES)
def test_grad_div_and_d_match_jax(case, lap_type):
    J, T = _pair(case, lap_type)
    assert T.D.n_edges == J.D.n_edges and T.D.n_vertices == J.N
    assert abs(T.D.to_scipy() - J.D.to_scipy()).max() <= TOL
    _close(T.D.toarray(), J.D.toarray())
    rng = np.random.default_rng(1)
    for shape in ((T.N,), (T.N, 3), (T.N, 2, 2)):
        x = rng.normal(size=shape)
        _close(T.grad(x), J.grad(x))
        _close(T.D.T.dot(x), J.D.T.dot(jnp.asarray(x)))
        y = rng.normal(size=(T.D.n_edges,) + shape[1:])
        _close(T.div(y), J.div(y))
        _close(T.D.dot(y), J.D.dot(jnp.asarray(y)))


@pytest.mark.parametrize('case,lap_type', CASES)
def test_div_grad_is_the_laplacian(case, lap_type):
    _, T = _pair(case, lap_type)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(T.N, 4)))
    _close(T.div(T.grad(x)), T.L @ x)


def test_grad_and_div_are_adjoint_in_autograd():
    _, T = _pair('directed', 'normalized')
    x = torch.randn(T.N, 2, dtype=torch.float64, requires_grad=True)
    y = torch.randn(T.D.n_edges, 2, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(T.grad, (x,))
    assert torch.autograd.gradcheck(T.div, (y,))
    assert torch.autograd.gradgradcheck(T.grad, (x,))
    # ⟨Dᵀx, y⟩ = ⟨x, D y⟩, and each one's backward is the other
    gy = torch.randn(T.D.n_edges, 2, dtype=torch.float64)
    (gx,) = torch.autograd.grad(T.grad(x), x, gy)
    _close(gx, T.div(gy))
    gxx = torch.randn(T.N, 2, dtype=torch.float64)
    (gyy,) = torch.autograd.grad(T.div(y), y, gxx)
    _close(gyy, T.grad(gxx))


def test_difference_operator_api_matches_jax():
    W = _adjacency('undirected')
    J, T = jgsp.graphs.Graph(W), tgsp.graphs.Graph(W, **CPU64)
    with mock.patch.object(T.logger, 'warning') as warn:
        D = T.D                                 # computed on first use
    warn.assert_called_once()
    assert 'compute_differential_operator' in warn.call_args[0][0]
    assert T.D is D
    with pytest.raises(ValueError) as jerr:
        J.div(np.zeros(J.Ne + 1))
    with pytest.raises(ValueError) as terr:
        T.div(np.zeros(T.Ne + 1))
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError) as jerr:
        J.grad(np.zeros(J.N + 1))
    with pytest.raises(ValueError) as terr:
        T.grad(np.zeros(T.N + 1))
    assert str(terr.value) == str(jerr.value)
    # a new Laplacian type drops the operator, the same type keeps it
    T.compute_laplacian('combinatorial')
    assert T._D is D
    T.compute_laplacian('normalized')
    assert T._D is None
    T.compute_differential_operator()
    J.compute_laplacian('normalized')
    J.compute_differential_operator()
    _close(T.D.toarray(), J.D.toarray())
    # Dᵀ is a CSR matrix of Ne rows with two entries each, D its transpose
    assert T.D.DT.shape == (T.Ne, T.N) and T.D.DT.nnz == 2 * T.Ne
    assert T.D.D.shape == (T.N, T.Ne)
    f32 = tgsp.graphs.Graph(W, device='cpu')
    f32.compute_differential_operator()
    assert f32.grad(np.ones(f32.N, np.float32)).dtype == torch.float32
    assert f32.grad(np.ones(f32.N)).dtype == torch.float64   # promoted


@pytest.mark.parametrize('shape', [(30, 45), (45, 30), (64, 64)])
def test_csr_transpose_arrays_equal_jax(shape):
    rng = np.random.default_rng(sum(shape))
    M = sps.random(*shape, density=0.1, random_state=rng, format='coo')
    M.data = rng.normal(size=M.nnz)
    args = (M.row, M.col, M.data, shape[0], shape[1])
    Aj = jsp.from_coo(*args).T
    At = tsp.from_coo(*args, **CPU64).T
    for name in ('rows', 'cols', 'vals', 'rowptr'):
        assert np.array_equal(getattr(At, name).numpy(),
                              np.asarray(getattr(Aj, name))), name
    assert At.rows.dtype == At.cols.dtype == At.rowptr.dtype == torch.int32
    assert (At.n_rows, At.n_cols, At.nnz) == (Aj.n_rows, Aj.n_cols, Aj.nnz)
    assert abs(tsp.to_scipy(At) - M.T).max() == 0
    x = torch.from_numpy(rng.normal(size=(shape[0], 3)))
    _close(At @ x, M.T @ x.numpy())


# ---------------------------------------------------------------------------
# the graph-core odds
# ---------------------------------------------------------------------------

def test_is_weighted_and_edge_list_match_jax():
    for case in ('undirected', 'directed', 'loops'):
        W = _adjacency(case)
        J, T = jgsp.graphs.Graph(W), tgsp.graphs.Graph(W, **CPU64)
        assert T.is_weighted() == J.is_weighted() is True
        for got, want in zip(T.get_edge_list(), J.get_edge_list()):
            assert np.array_equal(got, want)
    J, T = jgsp.graphs.Grid2d(5, 4), tgsp.graphs.Grid2d(5, 4, **CPU64)
    assert T.is_weighted() == J.is_weighted() is False
    src, tgt, w = T.get_edge_list()
    assert np.all(src < tgt) and len(w) == T.Ne


def test_subgraph_matches_jax():
    J, T = jgsp.graphs.Grid2d(6, 5), tgsp.graphs.Grid2d(6, 5, **CPU64)
    sig = np.arange(T.N, dtype=float)
    J.set_signal('ramp', sig)
    T.set_signal('ramp', sig)
    T.set_signal('t', torch.from_numpy(2 * sig))
    J.compute_laplacian('normalized')
    T.compute_laplacian('normalized')
    verts = [0, 1, 2, 5, 6, 7, 29]
    Hj, Ht = J.subgraph(verts), T.subgraph(verts)
    assert (Ht.N, Ht.Ne, Ht.lap_type) == (Hj.N, Hj.Ne, Hj.lap_type)
    assert abs(Ht.W - Hj.W).max() == 0
    assert np.array_equal(Ht.coords, Hj.coords)
    assert np.array_equal(Ht.signals['ramp'], Hj.signals['ramp'])
    assert torch.equal(Ht.signals['t'], torch.from_numpy(2 * sig[verts]))
    assert Ht.device == T.device and Ht.dtype == T.dtype
    assert abs(Ht.L.to_scipy() - Hj.L.to_scipy()).max() <= TOL


def test_extract_components_matches_jax():
    A = _adjacency('undirected', n=12, seed=1)
    W = sps.block_diag([A, sps.csr_matrix((1, 1)), _adjacency(
        'undirected', n=7, seed=2)], format='csr')
    perm = np.random.default_rng(0).permutation(W.shape[0])
    W = W[perm][:, perm]
    J, T = jgsp.graphs.Graph(W), tgsp.graphs.Graph(W, **CPU64)
    cj, ct = J.extract_components(), T.extract_components()
    assert len(ct) == len(cj) == 3
    for gj, gt in zip(cj, ct):
        assert np.array_equal(gt.info['orig_idx'], gj.info['orig_idx'])
        assert abs(gt.W - gj.W).max() == 0 and gt.N == gj.N


def test_extract_components_of_a_directed_graph_logs_an_error():
    W = _adjacency('directed')
    J, T = jgsp.graphs.Graph(W), tgsp.graphs.Graph(W, **CPU64)
    with mock.patch.object(J.logger, 'error') as jerr, \
            mock.patch.object(T.logger, 'error') as terr:
        assert J.extract_components() is None
        assert T.extract_components() is None
    assert terr.call_args_list == jerr.call_args_list
    assert terr.call_count == 1
