"""The port's windowed-compact format against pygsp_tpu, in float64 on the CPU.

Sizes follow tests/test_windowed.py. The builder is the JAX package's own
NumPy code, so the same input must pack to the same arrays; the SpMM and
the Chebyshev recurrence on it must agree to the last digits f64 allows
(λmax pinned: the packages draw their Lanczos start vectors from different
generators).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import pygsp_tpu as jgsp
import pygsp_tpu_torch as tgsp
from pygsp_tpu.core import sparse as jsp
from pygsp_tpu.core import windowed as jwd
from pygsp_tpu.core.operators import laplacian_op as j_laplacian_op
from pygsp_tpu.ops import chebyshev as jcheby
from pygsp_tpu_torch import convert
from pygsp_tpu_torch.core import _cuda, windowed_kernel
from pygsp_tpu_torch.core import chunked as tck
from pygsp_tpu_torch.core import sparse as tsp
from pygsp_tpu_torch.core import windowed as twd
from pygsp_tpu_torch.core.operators import laplacian_op as t_laplacian_op
from pygsp_tpu_torch.ops import chebyshev as tcheby

from test_chunked import _random_powerlaw

CPU64 = dict(device='cpu', dtype=torch.float64)
TOL = 1e-12          # f64, the fold sums in another order than XLA's dot


def _powerlaw(n=500, seed=3, **kw):
    return _random_powerlaw(n, np.random.default_rng(seed), **kw)


def _with_hub(n=300, seed=9):
    """tests/test_windowed.py::test_windowed_hub_rows's matrix."""
    rng = np.random.default_rng(seed)
    W = _random_powerlaw(n, rng).tolil()
    W[5, :] = rng.random(n)
    W[:, 5] = W[5, :].T
    W[5, 5] = 0
    return sps.csr_matrix(W)


def _with_hubs(n=333, seed=4, hubs=(5, 6, 330)):
    """Hub rows next to each other and in the ragged last chunk: their
    residue entries repeat across the tiers of every source chunk, the
    ragged last one among them."""
    rng = np.random.default_rng(seed)
    W = _random_powerlaw(n, rng).tolil()
    for h in hubs:
        W[h, :] = rng.random(n) + 0.5
        W[:, h] = W[h, :].T
        W[h, h] = 0
    return sps.csr_matrix(W)


def _rectangular():
    """tests/test_windowed.py::test_borrow_span_packing's matrix."""
    A = sps.random(3000, 5000, density=2e-3, random_state=7, format='csr')
    A.data[:] = np.random.default_rng(42).normal(size=A.nnz)
    return A


# (matrix, builder keywords): window_rows 16/32/64/256, spans 2/3/4, hub
# rows, ragged chunks, both permute modes, a rectangular matrix, and the
# builder's own choices throughout
CASES = {
    'P16': (_powerlaw, dict(chunk_rows=64, window_rows=16)),
    'P32': (_powerlaw, dict(chunk_rows=256, window_rows=32)),
    'P64-no-permute': (_powerlaw, dict(chunk_rows=128, window_rows=64,
                                       permute=None)),
    'P256-int32-rowid': (_powerlaw, dict(chunk_rows=512, window_rows=256)),
    'span4-borrow-and-levels': (lambda: _powerlaw(400, 7, avg_deg=10),
                                dict(chunk_rows=128, window_rows=32,
                                     slab_width=4, borrow_span=4)),
    'span3': (_powerlaw, dict(chunk_rows=128, window_rows=32, slab_width=6,
                              borrow_span=3)),
    'hub-rows': (_with_hub, dict(chunk_rows=64, window_rows=16)),
    'hubs-ragged-span4': (_with_hubs, dict(chunk_rows=64, window_rows=16,
                                           borrow_span=4)),
    'ragged': (lambda: _powerlaw(333, 23), dict(chunk_rows=128,
                                                window_rows=64)),
    'auto': (lambda: _powerlaw(2000, 5), {}),
    'rectangular-span4': (_rectangular, dict(chunk_rows=1024, slab_width=4,
                                             borrow_span=4, permute=None)),
}


def _build(case):
    make, kw = CASES[case]
    W = make()
    return W, jwd.windowed_from_scipy(W, **kw), twd.windowed_from_scipy(
        W, device='cpu', **kw)


def _leaves(J):
    """The JAX matrix's leaves as numpy, in convert's layout."""
    leaves = {k: None if getattr(J, k) is None else np.asarray(getattr(J, k))
              for k in ('cols', 'vals', 'rowid', 'level_rows', 'rowptr',
                        'perm', 'iperm')}
    leaves['levels'] = [{'cols': np.asarray(lev.cols),
                         'vals': np.asarray(lev.vals),
                         'src_chunk': lev.src_chunk} for lev in J.levels]
    leaves.update({k: getattr(J, k) for k in convert._WINDOWED_INTS})
    return leaves


def _assert_same_arrays(T, leaves):
    for k in ('cols', 'vals', 'rowid', 'level_rows', 'rowptr', 'perm',
              'iperm'):
        want, got = leaves[k], getattr(T, k)
        assert (want is None) == (got is None), k
        if want is not None:
            assert got.device.type == 'cpu'
            assert np.array_equal(got.numpy(), want), k
    assert len(T.levels) == len(leaves['levels'])
    for lev, want in zip(T.levels, leaves['levels']):
        assert lev.src_chunk == want['src_chunk']
        assert np.array_equal(lev.cols.numpy(), want['cols'])
        assert np.array_equal(lev.vals.numpy(), want['vals'])
    for k in convert._WINDOWED_INTS:
        assert getattr(T, k) == leaves[k], k


@pytest.mark.parametrize('case', list(CASES))
def test_builder_packs_the_same_arrays_as_jax(case):
    _, J, T = _build(case)
    _assert_same_arrays(T, _leaves(J))
    # row ids: uint8 kept, uint16 widened to int32
    assert T.rowid.dtype == (torch.uint8 if np.asarray(J.rowid).dtype
                             == np.uint8 else torch.int32)
    for name in ('n_slots', 'n_out_chunks', 'n_src_chunks', 'shape'):
        assert getattr(T, name) == getattr(J, name), name
    assert T.out_chunk_size(T.n_out_chunks - 1) == J.out_chunk_size(
        J.n_out_chunks - 1)


@pytest.mark.parametrize('s', [1, 5, 129])
@pytest.mark.parametrize('case', ['P16', 'span4-borrow-and-levels',
                                  'P256-int32-rowid', 'rectangular-span4',
                                  'hubs-ragged-span4'])
def test_spmm_matches_jax_and_scipy(case, s):
    W, J, T = _build(case)
    x = np.random.default_rng(s).normal(size=(W.shape[1], s))
    got = (T @ torch.from_numpy(x)).numpy()
    assert got.shape == (W.shape[0], s)
    assert np.allclose(got, np.asarray(jwd.windowed_spmm(J, jnp.asarray(x))),
                       rtol=0, atol=TOL)
    assert np.allclose(got, W @ x, rtol=0, atol=TOL)


def test_spmm_forms_and_round_trips():
    """1-D and rank-3 signals through the dispatch, the chunk-tuple form in
    the internal order, and the scipy/dense exports."""
    W, J, T = _build('ragged')
    x = np.random.default_rng(0).normal(size=(W.shape[0], 2, 3))
    got = tsp.spmm(T, torch.from_numpy(x))
    assert got.shape == x.shape
    assert np.allclose(got.numpy(), np.einsum('ij,jab->iab', W.toarray(), x),
                       rtol=0, atol=TOL)
    v = x[:, 0, 0]
    assert np.allclose(tgsp.ops.spmm(T, torch.from_numpy(v)).numpy(), W @ v,
                       rtol=0, atol=TOL)
    xp = jnp.asarray(v)[np.asarray(J.perm)]
    want = jwd.windowed_spmm_chunks(J, jwd.chunk_signal(xp, J.chunk_rows))
    got = T.spmm_chunks(tck.chunk_signal(torch.from_numpy(np.asarray(xp)),
                                         T.chunk_rows))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert np.allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL)
    assert abs(tsp.to_scipy(T) - W).max() < 1e-14
    assert abs(twd.windowed_to_scipy(T) - jwd.windowed_to_scipy(J)).max() == 0
    assert np.allclose(tsp.to_dense(T).numpy(), W.toarray(), rtol=0, atol=0)


def test_scale_astype_abs_match_jax():
    W, J, T = _build('span4-borrow-and-levels')
    x = np.random.default_rng(1).normal(size=W.shape[0])
    for jm, tm in ((J.scale_vals(2.0), T.scale_vals(2.0)),
                   (J.abs_vals(), T.abs_vals())):
        assert np.allclose((tm @ torch.from_numpy(x)).numpy(),
                           np.asarray(jm @ jnp.asarray(x)), rtol=0, atol=TOL)
    T32 = T.astype(torch.float32)
    assert T32.dtype == torch.float32
    assert all(lev.vals.dtype == torch.float32 for lev in T32.levels)
    # a float32 signal on a float64 matrix is promoted, as in JAX
    y = T @ torch.from_numpy(x.astype(np.float32))
    assert y.dtype == torch.float64


def _laplacians(lap_type):
    """(JAX windowed L, port windowed L, port CSR L, λmax) of
    tests/test_windowed.py::test_windowed_cheby_matches_plain."""
    W = _powerlaw(500, 17)
    J = j_laplacian_op(jsp.from_scipy(W), lap_type).to_windowed(
        chunk_rows=96, window_rows=32)
    Tc = t_laplacian_op(tsp.from_scipy(W, **CPU64), lap_type)
    lmax = 1.02 * float(abs(sps.linalg.eigsh(
        Tc.to_scipy(), k=1, return_eigenvectors=False)[0]))
    return J, Tc.to_windowed(chunk_rows=96, window_rows=32), Tc, lmax


@pytest.mark.parametrize('lap_type', ['combinatorial', 'normalized'])
def test_cheby_op_matches_jax(lap_type):
    J, T, Tc, lmax = _laplacians(lap_type)
    assert isinstance(T.offdiag, twd.WindowedELLMatrix)
    assert T.offdiag.perm is not None             # the shuffled order
    rng = np.random.default_rng(17)
    c = rng.normal(size=(3, 21))
    x = rng.normal(size=(500, 3))
    want = np.asarray(jcheby.cheby_op(J, lmax, jnp.asarray(c),
                                      jnp.asarray(x)))
    got = tcheby.cheby_op(T, lmax, torch.from_numpy(c), torch.from_numpy(x))
    assert got.shape == want.shape == (3, 500, 3)
    assert np.allclose(got.numpy(), want, rtol=0, atol=TOL)
    # the CSR path computes the same bank
    csr = tcheby.cheby_op(Tc, lmax, torch.from_numpy(c), torch.from_numpy(x))
    assert np.allclose(got.numpy(), csr.numpy(), rtol=0, atol=1e-11)
    # order 1 and a 1-D signal
    c1 = torch.from_numpy(c[:, :2])
    got1 = tcheby.cheby_op(T, lmax, c1, torch.from_numpy(x[:, 0]))
    want1 = jcheby.cheby_op(J, lmax, jnp.asarray(c[:, :2]),
                            jnp.asarray(x[:, 0]))
    assert np.allclose(got1.numpy(), np.asarray(want1), rtol=0, atol=TOL)


def test_graph_windowed_heat_bank_matches_jax():
    """``compute_laplacian(fmt='windowed')`` → ``Heat(...).filter`` on both
    packages, λmax pinned."""
    W = _powerlaw(700, 11)
    J = jgsp.graphs.Graph(W)
    T = tgsp.graphs.Graph(W, **CPU64)
    J.compute_laplacian(fmt='windowed')
    T.compute_laplacian(fmt='windowed')
    assert isinstance(T.L.offdiag, twd.WindowedELLMatrix)
    _assert_same_arrays(T.L.offdiag, _leaves(J.L.offdiag))
    J.estimate_lmax()
    T._lmax, T._lmax_method = J.lmax, 'pinned'
    scales = [5.0, 10.0, 25.0, 50.0]
    s = np.random.default_rng(1).normal(size=(J.N, 3))
    want = np.asarray(jgsp.filters.Heat(J, scales).filter(s, order=30))
    got = tgsp.filters.Heat(T, scales).filter(torch.from_numpy(s), order=30)
    assert got.shape == want.shape == (J.N, 3, 4)
    assert np.allclose(got.numpy(), want, rtol=0, atol=TOL)
    assert abs(T.L.to_scipy() - J.L.to_scipy()).max() < 1e-14


def test_lanczos_lmax_through_the_windowed_matvec():
    """λmax from the windowed operator (recursion in the shuffled order)
    equals the CSR operator's: the same start vector, permuted once."""
    W = _powerlaw(600, 13)
    G = tgsp.graphs.Graph(W, **CPU64)
    H = tgsp.graphs.Graph(W, **CPU64)
    H.compute_laplacian(fmt='windowed')
    G.estimate_lmax()
    H.estimate_lmax()
    assert abs(G.lmax - H.lmax) <= 1e-9 * G.lmax
    exact = float(sps.linalg.eigsh(G.L.to_scipy(), k=1,
                                   return_eigenvectors=False)[0])
    assert exact <= H.lmax <= 1.02 * exact


def test_auto_format_picks_windowed_above_the_chunk_size():
    n = tck.CHUNK_ROWS + 5
    path = sps.diags([np.ones(n - 1), np.ones(n - 1)], [-1, 1], format='csr')
    G = tgsp.graphs.Graph(path, device='cpu')
    G.compute_laplacian(fmt='auto')
    assert isinstance(G.L.offdiag, twd.WindowedELLMatrix)
    assert G.L.offdiag.n_out_chunks >= 2
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(n, 2)))
    assert torch.allclose(G.L @ x.float(), torch.from_numpy(
        (G.L.to_scipy() @ x.numpy())).float(), atol=1e-5)


def test_convert_takes_jax_leaves():
    W, J, T = _build('hub-rows')
    leaves = _leaves(J)
    M = convert.windowed_from_numpy(leaves, device='cpu')
    _assert_same_arrays(M, leaves)
    x = np.random.default_rng(3).normal(size=(W.shape[0], 4))
    assert np.allclose((M @ torch.from_numpy(x)).numpy(),
                       np.asarray(J @ jnp.asarray(x)), rtol=0, atol=TOL)
    # a whole Laplacian: the windowed leaves are told by their rowid
    JL = j_laplacian_op(jsp.from_scipy(W), 'normalized').to_windowed(
        chunk_rows=64, window_rows=16)
    L = convert.laplacian_from_numpy({
        'offdiag': _leaves(JL.offdiag), 'diag': np.asarray(JL.diag),
        'lap_type': JL.lap_type}, device='cpu')
    assert isinstance(L.offdiag, twd.WindowedELLMatrix)
    assert np.allclose((L @ torch.from_numpy(x)).numpy(),
                       np.asarray(JL @ jnp.asarray(x)), rtol=0, atol=TOL)


def _break(leaves, what):
    leaves = dict(leaves)
    R = leaves['chunk_rows']
    if what == 'col past the sentinel':
        leaves['cols'] = leaves['cols'].copy()
        leaves['cols'][0, 0, 0, 0] = R + 1
    elif what == 'col past the ragged chunk':
        leaves['cols'] = leaves['cols'].copy()
        leaves['cols'][-1, 0, -1, 0] = leaves['n_cols'] % R
    elif what == 'rowid past the span':
        leaves['rowid'] = leaves['rowid'].copy()
        leaves['rowid'][0, 0, 0, 0] = (leaves['borrow_span']
                                       * leaves['window_rows'])
    elif what == 'chunk_rows not NW windows':
        leaves['chunk_rows'] = R + leaves['window_rows']
    elif what == 'level row past the matrix':
        leaves['level_rows'] = leaves['level_rows'].copy()
        leaves['level_rows'][0] = leaves['n_rows']
    elif what == 'level col past the sentinel':
        lev = dict(leaves['levels'][0])
        lev['cols'] = lev['cols'].copy()
        lev['cols'][0, 0] = R + 1
        leaves['levels'] = [lev] + leaves['levels'][1:]
    elif what == 'perm without iperm':
        leaves['iperm'] = None
    elif what == 'perm not a permutation':
        leaves['perm'] = np.zeros_like(leaves['perm'])
    return leaves


@pytest.mark.parametrize('what', [
    'col past the sentinel', 'col past the ragged chunk',
    'rowid past the span', 'chunk_rows not NW windows',
    'level row past the matrix', 'level col past the sentinel',
    'perm without iperm', 'perm not a permutation'])
def test_convert_refuses_bad_leaves(what):
    _, J, _ = _build('ragged')
    leaves = _leaves(J)
    assert leaves['n_cols'] % leaves['chunk_rows']      # a ragged chunk
    assert leaves['levels']
    convert.windowed_from_numpy(leaves, device='cpu')   # the good ones pass
    with pytest.raises(ValueError):
        convert.windowed_from_numpy(_break(leaves, what), device='cpu')


def test_bf16_modes_name_their_roadmap_item():
    """The narrow modes run on the windowed format, as in the JAX package
    (their parity is tests/test_torch_carry.py), and raise its ValueError
    on the CSR format."""
    J, T, Tc, lmax = _laplacians('combinatorial')
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(500, 2)))
    c = torch.ones(1, 5, dtype=torch.float64) * 0.5 ** torch.arange(5)
    exact = tcheby.cheby_op(T, lmax, c, x)
    for kw in (dict(carry_dtype=torch.float32),
               dict(vals_dtype=torch.float32)):
        out = tcheby.cheby_op(T, lmax, c, x, **kw)
        assert out.dtype == torch.float64
        assert torch.allclose(out, exact, rtol=0, atol=1e-5)
        with pytest.raises(ValueError, match='chunked/windowed'):
            tcheby.cheby_op(Tc, lmax, c, x, **kw)
    y = torch.cat(T.offdiag.spmm_chunks((x,), out_dtype=torch.float32))
    assert y.dtype == torch.float32
    assert torch.allclose(y.double(), torch.cat(T.offdiag.spmm_chunks((x,))),
                          rtol=0, atol=1e-5)
    # a carry in the signal's own dtype is the exact path, as in JAX
    assert torch.equal(tcheby.cheby_op(T, lmax, c, x,
                                       carry_dtype=torch.float64), exact)
    with pytest.raises(ValueError, match='must have 500 rows'):
        T.offdiag @ torch.zeros(499)


def test_builder_refusals_match_jax():
    W = _powerlaw(100, 1)
    for kw, match in ((dict(chunk_rows=100, window_rows=64), 'multiple'),
                      (dict(chunk_rows=65536, window_rows=65536), 'uint16'),
                      (dict(borrow_span=1), 'borrow_span'),
                      (dict(permute='sorted'), 'permute')):
        with pytest.raises(ValueError, match=match):
            jwd.windowed_from_scipy(W, **kw)
        with pytest.raises(ValueError, match=match):
            twd.windowed_from_scipy(W, device='cpu', **kw)
    assert twd.auto_chunk_rows(10, 1 << 22, 1 << 22) == jwd.auto_chunk_rows(
        10, 1 << 22, 1 << 22) == 1 << 16


def _no_build(*args, **kwargs):
    raise AssertionError('a CPU tensor must not reach the CUDA build')


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    monkeypatch.setattr(_cuda, 'build', _no_build)
    monkeypatch.setattr(_cuda, 'function', _no_build)
    for k in windowed_kernel.KERNELS:
        monkeypatch.setattr(k, 'launches', 0)
    _, T, _, lmax = _laplacians('combinatorial')
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(500, 2)))
    tcheby.cheby_op(T, lmax, torch.ones(2, 6, dtype=torch.float64), x)
    assert all(k.launches == 0 for k in windowed_kernel.KERNELS)


def test_operator_conversions():
    W = _powerlaw(300, 5)
    L = t_laplacian_op(tsp.from_scipy(W, **CPU64), 'combinatorial')
    Lw = L.to_windowed(chunk_rows=128, window_rows=32, slab_width=8)
    assert Lw.to_windowed() is Lw
    assert Lw.offdiag.cols.shape[-1] == 8 and Lw.offdiag.window_rows == 32
    assert Lw.n_vertices == 300 and Lw.dtype == torch.float64
    assert np.allclose(Lw.to_dense().numpy(), L.to_dense().numpy(), rtol=0,
                       atol=1e-14)
    shifted = Lw.shifted(0.5, 1.0)
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(300, 2)))
    assert torch.allclose(shifted @ x, 0.5 * (L @ x - x), rtol=0, atol=1e-13)
