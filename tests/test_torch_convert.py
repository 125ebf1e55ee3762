"""Operators carried across from pygsp_tpu by ``pygsp_tpu_torch.convert``.

The JAX leaves go over as numpy arrays (``np.asarray``) plus the static
ints, and the port's operator must apply the same matrix.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygsp_tpu as jgsp
from pygsp_tpu.core import operators as jops
from pygsp_tpu_torch import convert
from pygsp_tpu_torch.core import BandedMatrix, CSRMatrix
from pygsp_tpu_torch.core.operators import matvec


def _leaves(L):
    """A JAX LaplacianOp as numpy leaves and static ints."""
    off = {f.name: getattr(L.offdiag, f.name)
           for f in dataclasses.fields(L.offdiag)}
    off = {k: (v if isinstance(v, int) else np.asarray(v))
           for k, v in off.items()}
    return {'offdiag': off, 'diag': np.asarray(L.diag),
            'lap_type': L.lap_type}


@pytest.mark.parametrize('fmt', ['csr', 'banded'])
@pytest.mark.parametrize('lap_type', ['combinatorial', 'normalized'])
def test_laplacian_carries_across(fmt, lap_type):
    G = jgsp.graphs.Grid2d(20, 9, lap_type=lap_type)
    L = G.L if fmt == 'csr' else G.L.to_banded()
    T = convert.laplacian_from_numpy(_leaves(L), device='cpu')
    assert isinstance(T.offdiag, CSRMatrix if fmt == 'csr' else BandedMatrix)
    assert T.lap_type == lap_type and T.dtype == torch.float64
    x = np.random.default_rng(0).normal(size=(G.N, 4))
    want = np.asarray(jops.matvec(L, jnp.asarray(x)))
    got = matvec(T, torch.from_numpy(x)).numpy()
    assert np.allclose(got, want, rtol=0, atol=1e-12)    # f64 order
    assert abs(T.to_scipy() - L.to_scipy()).max() == 0


def test_csr_leaves_keep_their_layout():
    G = jgsp.graphs.BarabasiAlbert(200, m0=2, m=2, seed=3)
    leaves = _leaves(G.L)['offdiag']
    M = convert.csr_from_numpy(leaves, device='cpu')
    for name in ('rows', 'cols', 'vals', 'rowptr'):
        assert np.array_equal(getattr(M, name).numpy(), leaves[name]), name
    assert M.rowptr.dtype == torch.int32 and M.cols.dtype == torch.int32
    assert (M.n_rows, M.n_cols, M.nnz) == (G.N, G.N, G.L.offdiag.nnz)


def test_float32_leaves_stay_float32():
    L = jgsp.graphs.Grid2d(6, 6).L
    leaves = _leaves(jops.LaplacianOp(offdiag=L.offdiag.astype(jnp.float32),
                                      diag=L.diag.astype(jnp.float32),
                                      lap_type=L.lap_type))
    T = convert.laplacian_from_numpy(leaves, device='cpu')
    assert T.dtype == torch.float32 and T.diag.dtype == torch.float32


@pytest.mark.parametrize('fault', ['col_high', 'col_negative', 'rowptr_end',
                                   'rowptr_decreases', 'rowptr_length'])
def test_malformed_csr_leaves_are_refused(fault):
    leaves = _leaves(jgsp.graphs.Grid2d(5, 4).L)['offdiag']
    leaves = {k: (v.copy() if isinstance(v, np.ndarray) else v)
              for k, v in leaves.items()}
    if fault == 'col_high':
        leaves['cols'][3] = leaves['n_cols']
    elif fault == 'col_negative':
        leaves['cols'][0] = -1
    elif fault == 'rowptr_end':
        leaves['rowptr'][-1] += 1
    elif fault == 'rowptr_decreases':
        leaves['rowptr'][2], leaves['rowptr'][3] = (leaves['rowptr'][3],
                                                    leaves['rowptr'][2])
    else:
        leaves['rowptr'] = leaves['rowptr'][:-1]
    with pytest.raises(ValueError):
        convert.csr_from_numpy(leaves, device='cpu')


def _difference_leaves(D):
    """A JAX ``_DifferenceOp`` as numpy leaves and its vertex count."""
    return {'sources': np.asarray(D.sources), 'targets': np.asarray(D.targets),
            'v_src': np.asarray(D.v_src), 'v_tgt': np.asarray(D.v_tgt),
            'n_vertices': D.n_vertices}


@pytest.mark.parametrize('lap_type', ['combinatorial', 'normalized'])
def test_difference_operator_carries_across(lap_type):
    G = jgsp.graphs.BarabasiAlbert(120, m0=3, m=2, seed=4, lap_type=lap_type)
    G.compute_differential_operator()
    D = convert.difference_from_numpy(_difference_leaves(G.D), device='cpu')
    assert (D.n_vertices, D.n_edges) == (G.N, G.D.n_edges)
    assert D.DT.vals.dtype == D.D.vals.dtype == torch.float64
    rng = np.random.default_rng(2)
    x = rng.normal(size=(G.N, 3))
    y = rng.normal(size=(G.D.n_edges, 3))
    for got, want in ((D.grad(torch.from_numpy(x)), G.D.grad(jnp.asarray(x))),
                      (D.div(torch.from_numpy(y)), G.D.div(jnp.asarray(y)))):
        assert np.allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)
    assert abs(D.to_scipy() - G.D.to_scipy()).max() == 0


@pytest.mark.parametrize('fault', ['source_high', 'target_negative',
                                   'lengths', 'two_d'])
def test_malformed_difference_leaves_are_refused(fault):
    G = jgsp.graphs.Grid2d(4, 3)
    G.compute_differential_operator()
    leaves = {k: (v.copy() if isinstance(v, np.ndarray) else v)
              for k, v in _difference_leaves(G.D).items()}
    if fault == 'source_high':
        leaves['sources'][2] = G.N
    elif fault == 'target_negative':
        leaves['targets'][0] = -1
    elif fault == 'lengths':
        leaves['v_tgt'] = leaves['v_tgt'][:-1]
    else:
        leaves['v_src'] = leaves['v_src'][:, None]
    with pytest.raises(ValueError):
        convert.difference_from_numpy(leaves, device='cpu')
