"""The port's sparse formats and SpMM plain versions against pygsp_tpu.

Inputs are made from a seed with numpy and go through both packages. On
these CPU tensors the kernel wrappers run their plain PyTorch versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from pygsp_tpu.core import sparse as jsp
from pygsp_tpu.ops.pallas_banded import banded_spmm_pallas
from pygsp_tpu_torch.core import sparse as tsp
from pygsp_tpu_torch.core import banded_kernel, csr_kernel


def _random_sparse(n, density, seed):
    rng = np.random.default_rng(seed)
    A = sps.random(n, n, density=density, random_state=rng, format='csr')
    return (A + A.T).tocsr()


def _banded(n, offsets, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    A = sum(sps.diags(rng.normal(size=n - o), o) for o in offsets)
    return (A + A.T).astype(dtype).tocsr()


def test_csr_roundtrips_and_layout():
    A = _random_sparse(300, 0.03, 0)
    M = tsp.from_scipy(A, dtype=torch.float64, device='cpu')
    J = jsp.from_scipy(A)
    # exact: the same host builder, so the same padded layout
    for field in ('rows', 'cols', 'vals', 'rowptr'):
        assert np.array_equal(getattr(M, field).numpy(),
                              np.asarray(getattr(J, field))), field
    assert (M.n_rows, M.n_cols, M.nnz) == (J.n_rows, J.n_cols, J.nnz)
    assert abs(tsp.to_scipy(M) - A).max() == 0
    assert np.array_equal(tsp.to_dense(M).numpy(), A.toarray())
    D = tsp.from_dense(A.toarray(), dtype=torch.float64, device='cpu')
    assert abs(tsp.to_scipy(D) - A).max() == 0
    assert M.dtype == torch.float64
    assert tsp.from_scipy(A, device='cpu').dtype == torch.float32


def test_from_coo_sums_duplicates_and_checks_indices():
    M = tsp.from_coo([0, 0, 1], [1, 1, 0], [1.0, 2.0, 5.0], 2,
                     dtype=torch.float64, device='cpu')
    assert tsp.to_dense(M).tolist() == [[0.0, 3.0], [5.0, 0.0]]
    with pytest.raises(ValueError, match='out of range'):
        tsp.from_coo([0, 2], [1, 0], [1.0, 1.0], 2, device='cpu')


@pytest.mark.parametrize('edge_block', [1024, 64])
@pytest.mark.parametrize('sum_duplicates', [True, False])
def test_from_coo_keywords_match_jax(sum_duplicates, edge_block):
    """``sum_duplicates`` and ``edge_block`` as in the JAX package: unsorted
    triplets with repeated places and explicit zeros give the same padded
    arrays, and with the duplicates kept as separate entries ``A @ x``
    still sums them (f64, 1e-12)."""
    rng = np.random.default_rng(5)
    n, e = 90, 700
    rows, cols = rng.integers(0, n, e), rng.integers(0, n, e)
    rows[:60], cols[:60] = rows[60:120], cols[60:120]     # repeated places
    vals = rng.normal(size=e)
    vals[::37] = 0.0
    M = tsp.from_coo(rows, cols, vals, n, sum_duplicates=sum_duplicates,
                     edge_block=edge_block, dtype=torch.float64,
                     device='cpu')
    J = jsp.from_coo(rows, cols, vals, n, sum_duplicates=sum_duplicates,
                     edge_block=edge_block, dtype=np.float64)
    for field in ('rows', 'cols', 'vals', 'rowptr'):
        assert np.array_equal(getattr(M, field).numpy(),
                              np.asarray(getattr(J, field))), field
    assert (M.nnz, M.n_edges_padded) == (J.nnz, J.n_edges_padded)
    assert M.n_edges_padded % edge_block == 0
    x = rng.normal(size=(n, 3))
    want = np.asarray(jsp.spmm(J, jnp.asarray(x)))
    got = tsp.spmm(M, torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    A = sps.csr_matrix((vals, (rows, cols)), shape=(n, n))
    for build, jbuild, arg in ((tsp.from_scipy, jsp.from_scipy, A),
                               (tsp.from_dense, jsp.from_dense, A.toarray())):
        M = build(arg, edge_block=edge_block, dtype=torch.float64,
                  device='cpu')
        J = jbuild(arg, edge_block=edge_block, dtype=np.float64)
        assert M.n_edges_padded == J.n_edges_padded
        assert np.array_equal(M.cols.numpy(), np.asarray(J.cols))


@pytest.mark.parametrize('s', [1, 5, 128])
def test_csr_spmm_matches_jax(s):
    A = _random_sparse(400, 0.02, 1)
    x = np.random.default_rng(2).normal(size=(400, s))
    want = np.asarray(jsp.spmm(jsp.from_scipy(A), jnp.asarray(x)))
    M = tsp.from_scipy(A, dtype=torch.float64, device='cpu')
    got = tsp.spmm(M, torch.from_numpy(x)).numpy()
    assert np.allclose(got, want, rtol=0, atol=1e-12)   # f64 summation order
    got1 = (M @ torch.from_numpy(x[:, 0])).numpy()      # 1-D signal
    assert np.allclose(got1, want[:, 0], rtol=0, atol=1e-12)


@pytest.mark.parametrize('offsets', [(1, 7, 60), (1, 128, 300, 500)])
@pytest.mark.parametrize('s', [1, 5, 128])
def test_banded_plain_matches_jax_einsum(offsets, s):
    n = 700
    A = _banded(n, offsets, 3)
    x = np.random.default_rng(4).normal(size=(n, s))
    want = np.asarray(jsp.banded_spmm(jsp.banded_from_scipy(A),
                                      jnp.asarray(x)))
    B = tsp.banded_from_scipy(A, dtype=torch.float64, device='cpu')
    assert B.half_bw == -(-max(offsets) // 128)
    got = banded_kernel.banded_spmm_plain(B.tiles, torch.from_numpy(x), n)
    assert np.allclose(got.numpy(), want, rtol=0, atol=1e-12)   # f64 order
    assert np.allclose(tsp.spmm(B, torch.from_numpy(x)).numpy(), want,
                       rtol=0, atol=1e-12)
    assert np.allclose(tsp.banded_spmm(B, torch.from_numpy(x)).numpy(), want,
                       rtol=0, atol=1e-12)


@pytest.mark.parametrize('s', [5, 128])
def test_banded_plain_matches_pallas_interpret(s):
    """Same set-up as tests/test_core.py::test_pallas_banded_interpret."""
    n = 300
    A = _banded(n, (1, 7, 60), 5, np.float32)
    x = np.random.default_rng(6).normal(size=(n, s)).astype(np.float32)
    want = np.asarray(banded_spmm_pallas(
        jsp.banded_from_scipy(A, dtype=np.float32), jnp.asarray(x),
        interpret=True))
    B = tsp.banded_from_scipy(A, dtype=torch.float32, device='cpu')
    got = banded_kernel.banded_spmm_plain(B.tiles, torch.from_numpy(x), n)
    assert np.allclose(got.numpy(), want, rtol=0, atol=1e-4)  # f32 order


def test_banded_roundtrip_and_wide_band():
    A = _banded(500, (1, 3, 200), 7)
    B = tsp.banded_from_scipy(A, dtype=torch.float64, device='cpu')
    assert abs(tsp.to_scipy(B) - A).max() == 0
    J = jsp.banded_from_scipy(A)
    assert np.array_equal(B.tiles.numpy(), np.asarray(J.tiles))
    assert tsp.banded_from_scipy(A, max_half_bw=1, device='cpu') is None


def test_kernel_wrappers_validate_arguments():
    A = tsp.from_scipy(_random_sparse(50, 0.1, 8), dtype=torch.float64,
                       device='cpu')
    x = torch.zeros(50, 3, dtype=torch.float64)
    with pytest.raises(ValueError, match='int32'):
        csr_kernel.csr_spmm(A.rowptr.long(), A.cols, A.vals, x)
    with pytest.raises(ValueError, match='one dtype'):
        csr_kernel.csr_spmm(A.rowptr, A.cols, A.vals, x.float())
    with pytest.raises(ValueError, match='2-D'):
        csr_kernel.csr_spmm(A.rowptr, A.cols, A.vals, x[:, 0])
    tiles = torch.zeros(1, 3, 128, 128, dtype=torch.float64)
    with pytest.raises(ValueError, match='tiles must be'):
        banded_kernel.banded_spmm(tiles[:, :2], x, 50)
    with pytest.raises(ValueError, match='contiguous'):
        banded_kernel.banded_spmm(tiles, torch.zeros(3, 50,
                                                     dtype=torch.float64).T, 50)


def test_unported_format_raises():
    """An operand of no format of the port raises TypeError naming the
    formats it has, from the SpMM and both exports."""
    for fn in (lambda m: tsp.spmm(m, torch.zeros(3)), tsp.to_scipy,
               tsp.to_dense):
        with pytest.raises(TypeError, match='CSRMatrix, ELLMatrix, '
                           'BandedMatrix, ChunkedELLMatrix or '
                           'WindowedELLMatrix'):
            fn(object())
