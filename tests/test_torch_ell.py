"""The port's multi-level ELL ('hybrid') format against pygsp_tpu, in float64
on the CPU.

The builder is the JAX package's own NumPy code, so the same input must
pack to the same arrays. The SpMM, the Chebyshev recurrence, synthesis,
Lanczos and the fixed-graph VJP on it must agree to 1e-12 (λmax pinned:
the packages draw their Lanczos start vectors from different generators).
The helpers at the top also serve tests/test_torch_chunked.py.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import pygsp_tpu as jgsp
import pygsp_tpu_torch as tgsp
from pygsp_tpu.core import sparse as jsp
from pygsp_tpu.core.operators import laplacian_op as j_laplacian_op
from pygsp_tpu.ops import chebyshev as jcheby
from pygsp_tpu.ops import eigen as jeigen
from pygsp_tpu.ops import lanczos as jlanczos
from pygsp_tpu_torch import convert
from pygsp_tpu_torch.core import _cuda, ell_kernel
from pygsp_tpu_torch.core import chunked as tck
from pygsp_tpu_torch.core import sparse as tsp
from pygsp_tpu_torch.ops import chebyshev as tcheby
from pygsp_tpu_torch.ops import eigen as teigen
from pygsp_tpu_torch.ops import lanczos as tlanczos

from test_chunked import _random_powerlaw

CPU64 = dict(device='cpu', dtype=torch.float64)
TOL = 1e-12


def _powerlaw(n=500, seed=3, **kw):
    return _random_powerlaw(n, np.random.default_rng(seed), **kw)


def _with_hubs(n=333, seed=4, hubs=(5, 6, 330)):
    """Dense hub rows next to each other and in the last rows: their edges
    spill into every overflow level."""
    rng = np.random.default_rng(seed)
    W = _random_powerlaw(n, rng).tolil()
    for h in hubs:
        W[h, :] = rng.random(n) + 0.5
        W[:, h] = W[h, :].T
        W[h, h] = 0
    return sps.csr_matrix(W)


def _rectangular():
    A = sps.random(300, 500, density=2e-2, random_state=7, format='csr')
    A.data[:] = np.random.default_rng(42).normal(size=A.nnz)
    return A


def _close(got, want, tol=TOL):
    """max |got - want| within ``tol`` of the largest |want| (at least 1)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


def _graphs(fmt, lap_type='combinatorial', W=None, **kw):
    """(JAX graph, port graph) of one power-law matrix with the Laplacian
    in ``fmt``, the port's λmax pinned to the JAX package's."""
    W = _with_hubs() if W is None else W
    J = jgsp.graphs.Graph(W)
    T = tgsp.graphs.Graph(W, **CPU64)
    if kw:
        J.compute_laplacian(lap_type)
        T.compute_laplacian(lap_type)
        J._L = getattr(J.L, f'to_{fmt}')(**kw)
        T._L = getattr(T.L, f'to_{fmt}')(**kw)
    else:
        J.compute_laplacian(lap_type, fmt=fmt)
        T.compute_laplacian(lap_type, fmt=fmt)
    J.estimate_lmax()
    T._lmax, T._lmax_method = J.lmax, 'pinned'
    return J, T


def _heat(lmax, scales=(5.0, 10.0, 25.0), m=30):
    lam_eval = lambda x: jnp.stack([jnp.exp(-s * x / lmax) for s in scales])
    return np.asarray(jcheby.cheby_coeff(lam_eval, lmax, m))


def check_recurrence(J, T, seed=0):
    """cheby_op, cheby_synthesis, Lanczos filtering and the fixed-graph VJP
    on the port's operator against the JAX package's, within 1e-12."""
    lmax = J.lmax
    n = T.N
    rng = np.random.default_rng(seed)
    c = _heat(lmax)
    x = rng.normal(size=(n, 3))
    _close(tcheby.cheby_op(T.L, lmax, torch.from_numpy(c),
                           torch.from_numpy(x)),
           jcheby.cheby_op(J.L, lmax, jnp.asarray(c), jnp.asarray(x)))
    bank = rng.normal(size=(n, 2, 3))
    _close(tcheby.cheby_synthesis(T.L, lmax, torch.from_numpy(c),
                                  torch.from_numpy(bank)),
           jcheby.cheby_synthesis(J.L, lmax, jnp.asarray(c),
                                  jnp.asarray(bank)))
    _close(tlanczos.lanczos_op(
        T.L, lambda e: torch.exp(-5 * e[None, :] / lmax),
        torch.from_numpy(x), order=20),
        jlanczos.lanczos_op(J.L, lambda e: jnp.exp(-5 * e[None, :] / lmax),
                            jnp.asarray(x), order=20))
    gbar = rng.normal(size=(3, n, 3))
    out, vjp = jax.vjp(lambda c_, x_: jcheby.cheby_op_fixed_graph(
        J.L, lmax, c_, x_), jnp.asarray(c), jnp.asarray(x))
    want_c, want_x = vjp(jnp.asarray(gbar))
    ct = torch.tensor(c, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    got = tcheby.cheby_op_fixed_graph(T.L, lmax, ct, xt)
    got.backward(torch.from_numpy(gbar))
    _close(got, out)
    _close(ct.grad, want_c)
    _close(xt.grad, want_x)


def check_residue_order(res, levels, level_rows, n_rows, n_cols, R):
    """The residue list keeps each row's live slots in ``level_rows``'
    order: row by row, its entries in level order, each entry's live slots
    in slot order, as global x rows."""
    want = {}
    off = 0
    for lev in levels:
        c = int(lev.src_chunk) if hasattr(lev, 'src_chunk') else 0
        lc, lv = lev.cols.numpy(), lev.vals.numpy()
        size = min(R, n_cols - c * R)
        for r, cols, vals in zip(level_rows[off:off + len(lc)], lc, lv):
            live = cols < size
            want.setdefault(int(r), []).append(
                (cols[live] + c * R, vals[live]))
        off += len(lc)
    rowptr, entptr = res.rowptr.numpy(), res.entptr.numpy()
    for r in range(n_rows):
        entries = want.get(r, [])
        assert rowptr[r + 1] - rowptr[r] == len(entries)
        for e, (cols, vals) in zip(range(rowptr[r], rowptr[r + 1]), entries):
            sl = slice(entptr[e], entptr[e + 1])
            assert np.array_equal(res.cols[sl].numpy(), cols)
            assert np.array_equal(res.vals[sl].numpy(), vals)
    slots = entptr[rowptr[1:]] - entptr[rowptr[:-1]]
    heavy = res.heavy.numpy()
    assert np.array_equal(np.sort(heavy),
                          np.flatnonzero(slots >= ell_kernel.HEAVY_SLOTS))
    assert np.all(np.diff(slots[heavy]) <= 0)


# ---------------------------------------------------------------------------
# the builder
# ---------------------------------------------------------------------------

# (matrix, builder keywords)
CASES = {
    'powerlaw': (_powerlaw, {}),
    'width8': (_powerlaw, dict(width=8)),
    'hubs-every-level': (_with_hubs, {}),
    'ragged-row-block': (lambda: _powerlaw(333, 23), dict(width=16)),
    'level-factor-3': (lambda: _powerlaw(400, 7, avg_deg=10),
                       dict(level_factor=3)),
    'rectangular': (_rectangular, {}),
}


def _build(case):
    make, kw = CASES[case]
    W = make()
    return W, jsp.ell_from_scipy(W, **kw), tsp.ell_from_scipy(
        W, device='cpu', **kw)


def _leaves(J):
    leaves = {k: np.asarray(getattr(J, k))
              for k in ('ell_cols', 'ell_vals', 'rowptr')}
    leaves['levels'] = [{k: np.asarray(getattr(lev, k))
                         for k in ('rows', 'cols', 'vals')}
                        for lev in J.levels]
    leaves.update({k: getattr(J, k) for k in convert._ELL_INTS})
    return leaves


def _same(got, want, k, vals_tol):
    assert got.dtype == torch.from_numpy(want[:0]).dtype, k
    if k.endswith('vals') and vals_tol:
        assert np.allclose(got.numpy(), want, rtol=0, atol=vals_tol), k
    else:
        assert np.array_equal(got.numpy(), want), k


def _assert_same_arrays(T, leaves, vals_tol=0.0):
    """The port's arrays equal to the JAX package's leaves (the values
    within ``vals_tol`` where the two computed them apart)."""
    for k in ('ell_cols', 'ell_vals', 'rowptr'):
        assert getattr(T, k).device.type == 'cpu'
        _same(getattr(T, k), leaves[k], k, vals_tol)
    assert len(T.levels) == len(leaves['levels'])
    for lev, want in zip(T.levels, leaves['levels']):
        for k in ('rows', 'cols', 'vals'):
            _same(getattr(lev, k), want[k], k, vals_tol)
    for k in convert._ELL_INTS:
        assert getattr(T, k) == leaves[k], k


@pytest.mark.parametrize('case', list(CASES))
def test_builder_packs_the_same_arrays_as_jax(case):
    _, J, T = _build(case)
    _assert_same_arrays(T, _leaves(J))
    assert T.shape == J.shape and T.dtype == torch.float64
    assert T.ell_cols.shape[0] % tsp.ROW_BLOCK == 0
    if case == 'hubs-every-level':
        assert len(T.levels) >= 4
        for lev in T.levels:
            assert np.unique(lev.rows.numpy()).size == lev.rows.numel()


def test_to_ell_from_csr_matches_jax():
    W = _with_hubs()
    J = jsp.to_ell(jsp.from_scipy(W), width=8)
    T = tsp.to_ell(tsp.from_scipy(W, **CPU64), width=8)
    _assert_same_arrays(T, _leaves(J))
    assert T.ell_width == 8


@pytest.mark.parametrize('case', list(CASES))
def test_residue_list_keeps_the_level_order(case):
    W, _, T = _build(case)
    if not T.levels:
        assert T.residue is None
        return
    rows = torch.cat([lev.rows for lev in T.levels]).numpy()
    check_residue_order(T.residue, T.levels, rows, T.n_rows, T.n_cols,
                        max(T.n_cols, 1))


def test_heavy_rows_are_the_kernels():
    """The kernel's row blocks skip a row with kHeavySlots overflow slots
    or more, and the upload lists as heavy the rows with HEAVY_SLOTS or
    more: the two numbers must agree."""
    with open(_cuda.CSRC + '/ell_spmm.cu') as f:
        found = re.findall(r'constexpr int kHeavySlots = (\d+);', f.read())
    assert found == [str(ell_kernel.HEAVY_SLOTS)]
    W = _with_hubs(n=700, hubs=(3,))
    T = tsp.ell_from_scipy(W, width=8, device='cpu')
    assert T.residue.heavy.tolist() == [3]


# ---------------------------------------------------------------------------
# the products
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('s', [1, 5])
@pytest.mark.parametrize('case', list(CASES))
def test_spmm_matches_jax_and_scipy(case, s):
    W, J, T = _build(case)
    x = np.random.default_rng(s).normal(size=(W.shape[1], s))
    got = T @ torch.from_numpy(x)
    _close(got, jsp.ell_spmm(J, jnp.asarray(x)))
    _close(got, W @ x)
    _close(tsp.spmm(T, torch.from_numpy(x[:, 0])), W @ x[:, 0])


@pytest.mark.parametrize('case', list(CASES))
def test_to_scipy_and_dense_round_trip(case):
    W, J, T = _build(case)
    assert abs(tsp.to_scipy(T) - W).max() <= TOL
    assert abs(tsp.to_scipy(T) - jsp.to_scipy(J)).max() == 0
    assert np.array_equal(tsp.to_dense(T).numpy(), W.toarray())


def test_scale_astype_abs_match_jax():
    W, J, T = _build('hubs-every-level')
    x = np.random.default_rng(1).normal(size=(W.shape[0], 2))
    for jm, tm in ((J.scale_vals(-0.5), T.scale_vals(-0.5)),
                   (J.astype(jnp.float32), T.astype(torch.float32))):
        _close(tm @ torch.from_numpy(x).to(tm.dtype),
               jsp.ell_spmm(jm, jnp.asarray(x, jm.dtype)), tol=1e-6)
        assert tm.residue.vals.dtype == tm.dtype
    A = T.abs_vals()
    _close(A @ torch.from_numpy(x), abs(W) @ x)


def test_mixed_and_narrow_operands_promote():
    """A float32 signal on a float64 matrix promotes to float64; bfloat16
    operands run in float32 and are cast to the requested dtype."""
    W, _, T = _build('powerlaw')
    x = np.random.default_rng(2).normal(size=(W.shape[0], 3))
    y = T @ torch.from_numpy(x).float()
    assert y.dtype == torch.float64
    _close(y, W @ x.astype(np.float32).astype(np.float64))
    Tb = T.astype(torch.bfloat16)
    yb = tsp.spmm(Tb, torch.from_numpy(x).bfloat16())
    assert yb.dtype == torch.bfloat16
    assert float((yb.double() - torch.from_numpy(W @ x)).abs().max()) < 0.2


# ---------------------------------------------------------------------------
# the Laplacian and the recurrence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('lap_type', ['combinatorial', 'normalized'])
@pytest.mark.parametrize('fmt', ['hybrid', 'auto'])
def test_compute_laplacian_matches_jax(fmt, lap_type):
    J, T = _graphs(fmt, lap_type)
    assert isinstance(T.L.offdiag, tsp.ELLMatrix)
    assert isinstance(J.L.offdiag, jsp.ELLMatrix)
    assert T.L.lap_type == lap_type
    assert abs(T.L.to_scipy() - J.L.to_scipy()).max() <= 1e-14
    # the normalized values are computed apart, in the last bits
    _assert_same_arrays(T.L.offdiag, _leaves(J.L.offdiag), vals_tol=1e-14)


@pytest.mark.parametrize('lap_type', ['combinatorial', 'normalized'])
def test_recurrence_and_vjp_match_jax(lap_type):
    check_recurrence(*_graphs('hybrid', lap_type), seed=1)


def test_to_hybrid_with_a_width_matches_jax():
    J, T = _graphs('hybrid', width=8)
    assert T.L.offdiag.ell_width == 8
    assert T.L.to_hybrid() is T.L
    check_recurrence(J, T, seed=2)


def test_filter_and_lmax_on_hybrid():
    J, T = _graphs('hybrid')
    x = np.random.default_rng(5).normal(size=(T.N, 2))
    _close(tgsp.filters.Heat(T, [1.0, 3.0]).filter(torch.from_numpy(x)),
           jgsp.filters.Heat(J, [1.0, 3.0]).filter(x))
    # Lanczos on the kernel's matvec: the same λmax to its tolerance
    T.estimate_lmax()
    assert T.lmax == pytest.approx(J.lmax, rel=1e-6)


def test_upper_bound_matches_jax():
    for lap_type in ('combinatorial', 'normalized'):
        J, T = _graphs('hybrid', lap_type)
        assert float(teigen.laplacian_upper_bound(T.L)) == pytest.approx(
            float(jeigen.laplacian_upper_bound(J.L)), rel=1e-14)


def test_hybrid_refuses_the_bf16_modes_with_jax_text():
    J, T = _graphs('hybrid')
    c = torch.from_numpy(_heat(J.lmax, m=6))
    x = torch.zeros(T.N, 2, dtype=torch.float64)
    for name in ('carry_dtype', 'vals_dtype'):
        with pytest.raises(ValueError) as jerr:
            jcheby.cheby_op(J.L, J.lmax, jnp.asarray(c.numpy()),
                            jnp.asarray(x.numpy()), **{name: jnp.bfloat16})
        with pytest.raises(ValueError) as terr:
            tcheby.cheby_op(T.L, J.lmax, c, x, **{name: torch.bfloat16})
        assert str(terr.value) == str(jerr.value)


def test_auto_picks_hybrid_at_the_chunk_size():
    n = tck.CHUNK_ROWS
    path = sps.diags([np.ones(n - 1), np.ones(n - 1)], [-1, 1], format='csr')
    J = jgsp.graphs.Graph(path)
    J.compute_laplacian(fmt='auto')
    T = tgsp.graphs.Graph(path, device='cpu')
    T.compute_laplacian(fmt='auto')
    assert isinstance(J.L.offdiag, jsp.ELLMatrix)
    assert isinstance(T.L.offdiag, tsp.ELLMatrix)
    assert T.L.offdiag.ell_width == J.L.offdiag.ell_width
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(n, 2)))
    assert torch.allclose(T.L @ x.float(), torch.from_numpy(
        (T.L.to_scipy() @ x.numpy())).float(), atol=1e-5)


# ---------------------------------------------------------------------------
# convert, the wrappers
# ---------------------------------------------------------------------------

def test_convert_takes_jax_leaves():
    W, J, T = _build('hubs-every-level')
    leaves = _leaves(J)
    M = convert.ell_from_numpy(leaves, device='cpu')
    _assert_same_arrays(M, leaves)
    x = np.random.default_rng(3).normal(size=(W.shape[0], 4))
    _close(M @ torch.from_numpy(x), J @ jnp.asarray(x))
    JL = j_laplacian_op(jsp.from_scipy(W), 'normalized').to_hybrid()
    L = convert.laplacian_from_numpy({
        'offdiag': _leaves(JL.offdiag), 'diag': np.asarray(JL.diag),
        'lap_type': JL.lap_type}, device='cpu')
    assert isinstance(L.offdiag, tsp.ELLMatrix)
    _close(L @ torch.from_numpy(x), JL @ jnp.asarray(x))


def _break(leaves, what):
    bad = dict(leaves, levels=[dict(lev) for lev in leaves['levels']])
    if what == 'col':
        bad['ell_cols'] = bad['ell_cols'].copy()
        bad['ell_cols'][0, 0] = bad['n_cols'] + 1
    elif what == 'negative':
        bad['ell_cols'] = bad['ell_cols'].copy()
        bad['ell_cols'][1, 0] = -1
    elif what == 'level_row':
        bad['levels'][0]['rows'] = bad['levels'][0]['rows'].copy()
        bad['levels'][0]['rows'][0] = bad['n_rows']
    elif what == 'repeated_row':
        bad['levels'][0]['rows'] = bad['levels'][0]['rows'].copy()
        bad['levels'][0]['rows'][1] = bad['levels'][0]['rows'][0]
    elif what == 'width':
        bad['ell_width'] = bad['ell_width'] + 1
    return bad


@pytest.mark.parametrize('what', ['col', 'negative', 'level_row',
                                  'repeated_row', 'width'])
def test_convert_refuses_bad_leaves(what):
    _, J, _ = _build('hubs-every-level')
    with pytest.raises(ValueError):
        convert.ell_from_numpy(_break(_leaves(J), what), device='cpu')


def _no_build(*args, **kwargs):
    raise AssertionError('a CPU tensor must not reach the CUDA build')


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    monkeypatch.setattr(_cuda, 'build', _no_build)
    monkeypatch.setattr(_cuda, 'function', _no_build)
    for k in ell_kernel.KERNELS:
        monkeypatch.setattr(k, 'launches', 0)
    J, T = _graphs('hybrid')
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(T.N, 2)))
    tcheby.cheby_op(T.L, J.lmax, torch.ones(2, 6, dtype=torch.float64), x)
    assert all(k.launches == 0 for k in ell_kernel.KERNELS)


def test_wrapper_refuses_bad_operands():
    _, _, T = _build('hubs-every-level')
    args = (T.table, T.ell_cols.reshape(-1), T.ell_vals.reshape(-1),
            T.residue)
    x = torch.zeros(T.n_cols, 3, dtype=torch.float64)
    with pytest.raises(ValueError, match='dtype pairs'):
        ell_kernel.ell_spmm(*args, x.float(), T.n_rows)
    with pytest.raises(ValueError, match='2-D'):
        ell_kernel.ell_spmm(*args, x[:, 0], T.n_rows)
    with pytest.raises(ValueError, match='int32'):
        ell_kernel.ell_spmm(args[0], args[1].long(), *args[2:], x, T.n_rows)
    with pytest.raises(ValueError, match='do not hold'):
        ell_kernel.ell_spmm(*args, x, T.n_rows + 1)
    with pytest.raises(ValueError, match='dtype pairs'):
        ell_kernel.ell_spmm(*args[:2], args[2].to(torch.bfloat16),
                            args[3]._replace(vals=args[3].vals.bfloat16()),
                            x.bfloat16(), T.n_rows)
    with pytest.raises(ValueError, match='contiguous'):
        ell_kernel.ell_spmm(*args, torch.zeros(3, T.n_cols,
                                               dtype=torch.float64).T,
                            T.n_rows)
