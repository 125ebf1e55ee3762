"""The windowed SpMM's tail on the CPU: the residue list made at upload and
the plain version of ``window_strip`` with the residue folded in.

The list is held against a reference built entry by entry from the JAX
package's tiers (through ``convert.windowed_from_numpy``); the tail's plain
version against a row-by-row loop in the order and the roundings it states
(bit for bit) and against the tiers' former path (``_slot_block_sum`` and
``index_add_``); the SpMM with the list against ``pygsp_tpu`` in float64.
The kernel itself is held against this plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import dataclasses
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygsp_tpu_torch as tgsp
from pygsp_tpu.core import windowed as jwd
from pygsp_tpu.ops import chebyshev as jcheby
from pygsp_tpu_torch import convert
from pygsp_tpu_torch.core import _cuda
from pygsp_tpu_torch.core import chunked as tck
from pygsp_tpu_torch.core import windowed as twd
from pygsp_tpu_torch.core import windowed_kernel as wk
from pygsp_tpu_torch.ops import chebyshev as tcheby

from test_torch_windowed import _build, _laplacians, _leaves

TOL = 1e-12
# matrices with residue tiers: hub rows (one in the ragged last chunk),
# span 4, window overflow only, a rectangular matrix
LEVEL_CASES = ['hubs-ragged-span4', 'hub-rows', 'span4-borrow-and-levels',
               'ragged', 'rectangular-span4']
# (x dtype, values dtype): the fold's pairs, which the tail shares
PAIRS = {'f64': (torch.float64, torch.float64),
         'f32': (torch.float32, torch.float32),
         'bf16': (torch.bfloat16, torch.bfloat16),
         'bf16-f32': (torch.bfloat16, torch.float32),
         'f32-bf16': (torch.float32, torch.bfloat16)}


def _flat_reference(leaves):
    """The residue list entry by entry, in plain Python: each tier entry's
    live slots (column inside its source chunk) as (global x row, value),
    the entries of a row in their order in ``level_rows``."""
    R, n_rows, n_cols = (leaves[k] for k in ('chunk_rows', 'n_rows',
                                             'n_cols'))
    by_row = [[] for _ in range(n_rows)]
    off = 0
    for lev in leaves['levels']:
        c = lev['src_chunk']
        size = min(R, n_cols - c * R)
        for k, (cols, vals) in enumerate(zip(lev['cols'], lev['vals'])):
            by_row[leaves['level_rows'][off + k]].append(
                [(c * R + int(col), val) for col, val in zip(cols, vals)
                 if col < size])
        off += lev['cols'].shape[0]
    rowptr, entptr, cols, vals = [0], [0], [], []
    for entries in by_row:
        for slots in entries:
            cols += [col for col, _ in slots]
            vals += [val for _, val in slots]
            entptr.append(len(cols))
        rowptr.append(len(entptr) - 1)
    heavy = sorted((r for r, entries in enumerate(by_row)
                    if len(entries) >= wk.TAIL_HEAVY_ENTRIES),
                   key=lambda r: (-len(by_row[r]), r))
    return by_row, dict(rowptr=rowptr, entptr=entptr, cols=cols, vals=vals,
                        heavy=heavy)


@pytest.mark.parametrize('case', LEVEL_CASES)
def test_residue_list_matches_a_reference_in_order(case):
    _, J, T = _build(case)
    leaves = _leaves(J)
    M = convert.windowed_from_numpy(leaves, device='cpu')
    by_row, want = _flat_reference(leaves)
    for res in (M.residue, T.residue):
        for k, values in want.items():
            got = getattr(res, k)
            assert got.dtype == (torch.float64 if k == 'vals'
                                 else torch.int32), k
            assert np.array_equal(got.numpy(), np.asarray(values)), k
    if case == 'hubs-ragged-span4':
        # rows repeat across entries, spill from several source chunks
        # and reach the ragged last chunk, and some rows are heavy
        R, n_src = M.chunk_rows, M.n_src_chunks
        assert M.n_cols % R
        assert any(len({col // R for slots in e for col, _ in slots}) >= 3
                   for e in by_row)
        assert max(len(e) for e in by_row) >= wk.TAIL_HEAVY_ENTRIES
        assert any(col >= (n_src - 1) * R for col in want['cols'])
        assert M.residue.heavy.numel() >= 3
        # dead slots were dropped: fewer slots than the tiers hold
        assert M.residue.cols.numel() < sum(lev.cols.numel()
                                            for lev in M.levels)


def test_matrix_without_levels_has_no_residue_list():
    W, J, T = _build('P64-no-permute')
    kw = dict(chunk_rows=128, window_rows=64, permute=None, slab_width=2000,
              hub_degree=10**9)
    J0 = jwd.windowed_from_scipy(W, **kw)
    T0 = twd.windowed_from_scipy(W, device='cpu', **kw)
    assert not J0.levels and not T0.levels and T0.residue is None
    x = np.random.default_rng(0).normal(size=(W.shape[1], 3))
    assert np.allclose((T0 @ torch.from_numpy(x)).numpy(),
                       np.asarray(J0 @ jnp.asarray(x)), rtol=0, atol=TOL)
    assert np.allclose((T0 @ torch.from_numpy(x)).numpy(), W @ x, rtol=0,
                       atol=TOL)


@pytest.mark.parametrize('case', LEVEL_CASES)
def test_map_vals_keeps_the_residue_list_in_step(case):
    """astype, scale_vals and abs_vals reach the list's values too (the
    fast mode casts the values to bf16 through astype): the list of the
    mapped matrix is the one its own tiers give."""
    _, _, T = _build(case)
    for mapped in (T.astype(torch.bfloat16), T.astype(torch.float32),
                   T.scale_vals(-2.5), T.abs_vals(),
                   T.astype(torch.bfloat16).scale_vals(0.5)):
        leaves = {k: getattr(mapped, k) for k in ('chunk_rows', 'n_rows',
                                                  'n_cols')}
        leaves['level_rows'] = mapped.level_rows.tolist()
        leaves['levels'] = [{'cols': lev.cols.numpy(),
                             'vals': lev.vals.double().numpy(),
                             'src_chunk': lev.src_chunk}
                            for lev in mapped.levels]
        _, want = _flat_reference(leaves)
        assert mapped.residue.vals.dtype == mapped.vals.dtype
        assert np.array_equal(mapped.residue.vals.double().numpy(),
                              np.asarray(want['vals']))
        assert torch.equal(mapped.residue.cols, T.residue.cols)


@pytest.mark.parametrize('case', LEVEL_CASES)
def test_stored_bytes_leave_out_the_residue_list(case):
    _, J, T = _build(case)
    bare = dataclasses.replace(T, residue=None)
    assert T.stored_bytes() == bare.stored_bytes()
    jax_bytes = sum(np.asarray(leaf).nbytes for leaf in (
        [J.cols, J.vals, J.rowid, J.rowptr, J.level_rows]
        + [a for lev in J.levels for a in (lev.cols, lev.vals)]
        + [a for a in (J.perm, J.iperm) if a is not None]))
    assert T.stored_bytes() == jax_bytes


def _operands(case, pair, s=5, seed=0):
    """The matrix with the pair's values, x in the internal order and the
    window tensor that the fold makes of them."""
    xd, vd = PAIRS[pair]
    _, _, T = _build(case)
    M = T.astype(vd)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(M.n_cols, s))).to(xd)
    t = wk.windowed_fold(M.cols, M.vals, M.rowid, x, M.chunk_rows,
                         M.borrow_span * M.window_rows)
    return M, x, t


def _tail_loop(y, M, x):
    """The tail's order and roundings, one row, entry and slot at a time."""
    acc = torch.promote_types(y.dtype, torch.float32)
    res = M.residue
    pdt = torch.promote_types(x.dtype, res.vals.dtype)
    rowptr, entptr = res.rowptr.tolist(), res.entptr.tolist()
    y = y.clone()
    for row in range(M.n_rows):
        for e in range(rowptr[row], rowptr[row + 1]):
            s = torch.zeros(y.shape[1], dtype=acc)
            for q in range(entptr[e], entptr[e + 1]):
                s = s + (res.vals[q].to(pdt) * x[res.cols[q]].to(pdt)
                         ).to(acc)
            y[row] = y[row] + s.to(y.dtype)
    return y


@pytest.mark.parametrize('pair', list(PAIRS))
@pytest.mark.parametrize('case', ['hubs-ragged-span4', 'ragged'])
def test_tail_plain_keeps_its_order_bit_for_bit(case, pair):
    M, x, t = _operands(case, pair)
    strip = wk.window_strip(t, M.n_rows, M.window_rows)
    want = _tail_loop(strip, M, x)
    got = wk.window_strip(t, M.n_rows, M.window_rows, M.residue, x)
    assert got.dtype == t.dtype
    assert torch.equal(got, want)
    assert torch.equal(got, wk.window_strip_plain(t, M.n_rows,
                                                  M.window_rows, M.residue,
                                                  x))


@pytest.mark.parametrize('pair', ['f64', 'f32', 'bf16-f32'])
@pytest.mark.parametrize('case', LEVEL_CASES)
def test_tail_matches_the_tiers_former_path(case, pair):
    """The tiers as the SpMM added them before: each tier's
    _slot_block_sum in float32 or wider, cast, then one index_add_."""
    M, x, t = _operands(case, pair, seed=1)
    dt = t.dtype
    acc = torch.promote_types(dt, torch.float32)
    R = M.chunk_rows
    want = wk.window_strip(t, M.n_rows, M.window_rows)
    ps = torch.cat([tck._slot_block_sum(lev.cols, lev.vals,
                                        x[lev.src_chunk * R:
                                          (lev.src_chunk + 1) * R],
                                        out_dtype=acc)
                    for lev in M.levels])
    want.index_add_(0, M.level_rows, ps.to(dt))
    got = wk.window_strip(t, M.n_rows, M.window_rows, M.residue, x)
    # the two sum each entry's slots in other orders (in float32 or
    # wider); in bf16 each of a row's entries then rounds once more
    per_row = int((M.residue.rowptr[1:] - M.residue.rowptr[:-1]).max())
    tol = {torch.float64: TOL, torch.float32: 1e-6,
           torch.bfloat16: (1 + per_row) * 2.0 ** -8}[dt]
    scale = float(want.abs().max())
    assert float((got.double() - want.double()).abs().max()) <= tol * scale


@pytest.mark.parametrize('s', [1, 3, 8])
@pytest.mark.parametrize('case', LEVEL_CASES)
def test_spmm_with_residue_matches_jax(case, s):
    W, J, T = _build(case)
    x = np.random.default_rng(s).normal(size=(W.shape[1], s))
    got = (T @ torch.from_numpy(x)).numpy()
    assert np.allclose(got, np.asarray(jwd.windowed_spmm(J, jnp.asarray(x))),
                       rtol=0, atol=TOL)


def test_cheby_op_on_hub_rows_matches_jax():
    """The heat bank on a windowed Laplacian whose hub rows spill into the
    residue tiers of every source chunk, λmax pinned."""
    from pygsp_tpu.core import sparse as jsp
    from pygsp_tpu.core.operators import laplacian_op as j_laplacian_op
    from pygsp_tpu_torch.core import sparse as tsp
    from pygsp_tpu_torch.core.operators import laplacian_op as t_laplacian_op
    from test_torch_windowed import _with_hubs
    W = _with_hubs()
    kw = dict(chunk_rows=64, window_rows=16)
    J = j_laplacian_op(jsp.from_scipy(W), 'normalized').to_windowed(**kw)
    T = t_laplacian_op(tsp.from_scipy(W, device='cpu', dtype=torch.float64),
                       'normalized').to_windowed(**kw)
    assert T.offdiag.residue.heavy.numel() >= 3
    lmax = 2.0
    rng = np.random.default_rng(5)
    c = rng.normal(size=(3, 25))
    x = rng.normal(size=(W.shape[0], 4))
    want = np.asarray(jcheby.cheby_op(J, lmax, jnp.asarray(c),
                                      jnp.asarray(x)))
    got = tcheby.cheby_op(T, lmax, torch.from_numpy(c), torch.from_numpy(x))
    assert np.allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize('mode', ['carry', 'vals', 'both'])
def test_bf16_modes_with_hub_rows_within_the_carry_estimate(mode):
    """The fast modes on the hub-row graph, against the float64 recurrence
    of the same operator, within carry_error_estimate."""
    modes = {'carry': ('carry_dtype',), 'vals': ('vals_dtype',),
             'both': ('carry_dtype', 'vals_dtype')}[mode]
    from test_torch_windowed import _with_hubs
    W = _with_hubs()
    G = tgsp.graphs.Graph(W, device='cpu', dtype=torch.float64)
    G.compute_laplacian(fmt='windowed')
    G.estimate_lmax(method='bounds')
    assert G.L.offdiag.residue is not None
    scales = [5.0, 10.0, 25.0, 50.0]
    g = tgsp.filters.Heat(G, scales)
    s = np.random.default_rng(2).normal(size=(G.N, 3))
    ref = g.filter(torch.from_numpy(s), order=30).numpy()
    G32 = tgsp.graphs.Graph(W, device='cpu')
    G32.compute_laplacian(fmt='windowed')
    G32._lmax, G32._lmax_method = G.lmax, 'pinned'
    got = tgsp.filters.Heat(G32, scales).filter(
        torch.from_numpy(s.astype(np.float32)), order=30,
        **{k: torch.bfloat16 for k in modes})
    c = tcheby.cheby_coeff(g.evaluate, G.lmax, m=30, dtype=torch.float64,
                           device='cpu')
    est = tcheby.carry_error_estimate(c, torch.bfloat16)
    err = float(np.abs(got.double().numpy() - ref).max())
    assert err <= 1.5 * est * float(np.abs(ref).max())


def test_cpu_tail_counts_its_plain_calls(monkeypatch):
    def no_build(*args, **kwargs):
        raise AssertionError('a CPU tensor must not reach the CUDA build')

    def no_tiers(*args, **kwargs):
        raise AssertionError('the SpMM must not sum the tiers one by one')

    monkeypatch.setattr(_cuda, 'build', no_build)
    monkeypatch.setattr(_cuda, 'function', no_build)
    monkeypatch.setattr(tck, '_slot_block_sum', no_tiers)
    monkeypatch.setattr(wk.window_strip, 'launches', 0)
    monkeypatch.setattr(wk.tail_plain, 'calls', 0)
    _, T, _, lmax = _laplacians('combinatorial')
    assert T.offdiag.residue is not None
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(500, 2)))
    tcheby.cheby_op(T, lmax, torch.ones(2, 6, dtype=torch.float64), x)
    # one tail per SpMM (the first term and 4 steps), none through the
    # tiers' former gather-sum
    assert wk.tail_plain.calls == 5
    assert wk.window_strip.launches == 0


def test_heavy_row_threshold_is_the_kernels():
    """The kernel's row blocks skip a row with kHeavyMin entries or more,
    and the upload lists as heavy the rows with TAIL_HEAVY_ENTRIES or
    more: the two must be one number, or a row gets no writer or two."""
    with open(os.path.join(_cuda.CSRC, 'windowed_fold.cu')) as f:
        found = re.findall(r'constexpr int kHeavyMin = (\d+);', f.read())
    assert found == [str(wk.TAIL_HEAVY_ENTRIES)]


@pytest.mark.parametrize('case', ['hubs-ragged-span4', 'hub-rows'])
def test_narrow_out_dtype_spmm_within_its_roundings_of_jax(case):
    """``out_dtype`` bfloat16 with x and values in float32. The JAX
    package rounds to bf16 each of the strip's K addends and its adds,
    each tier's sum and each add of it into y; the port sums in float32
    and rounds y once. A rounding moves a value by at most 2^-8 of its
    magnitude, and every partial sum of a row is at most that row of
    |A| |x|; so, per row with e residue entries, the two lie within
    (2K + 2e) · 2^-8 · (|A| |x|), and the port within one rounding of the
    float64 product (plus 1e-6 for float32's sums)."""
    _, J, T = _build(case)
    M = T.astype(torch.float32)
    R, K = M.chunk_rows, M.borrow_span
    x = np.random.default_rng(6).normal(size=(M.n_cols, 4)).astype(
        np.float32)
    got = tck.unchunk_signal(twd.windowed_spmm_chunks(
        M, tck.chunk_signal(torch.from_numpy(x), R),
        out_dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    want = np.asarray(jnp.concatenate(jwd.windowed_spmm_chunks(
        J.astype(jnp.float32), jwd.chunk_signal(jnp.asarray(x), R),
        out_dtype=jnp.bfloat16)).astype(jnp.float32), dtype=np.float64)
    M64, x64 = M.astype(torch.float64), torch.from_numpy(x).double()
    exact = twd.spmm_internal(M64, x64).numpy()
    scale = twd.spmm_internal(M64.abs_vals(), x64.abs()).numpy()
    e = (M.residue.rowptr[1:] - M.residue.rowptr[:-1]).numpy()[:, None]
    assert e.max() >= wk.TAIL_HEAVY_ENTRIES
    got = got.double().numpy()
    assert np.all(np.abs(got - want) <= (2 * K + 2 * e) * 2.0**-8 * scale)
    assert np.all(np.abs(got - exact) <= (2.0**-8 + 1e-6) * scale)


def test_window_strip_refuses_a_residue_it_cannot_take():
    M, x, t = _operands('hub-rows', 'f32')
    res = M.residue
    P = M.window_rows
    with pytest.raises(ValueError, match='with x'):
        wk.window_strip(t, M.n_rows, P, res)
    with pytest.raises(ValueError, match='with x'):
        wk.window_strip(t, M.n_rows, P, res, x[:, :2])
    with pytest.raises(ValueError, match='dtype'):
        wk.window_strip(t, M.n_rows, P, res, x.double())
    with pytest.raises(ValueError, match='dtype'):
        wk.window_strip(t, M.n_rows, P, res._replace(vals=res.vals.half()),
                        x)
    with pytest.raises(ValueError, match='int32'):
        wk.window_strip(t, M.n_rows, P, res._replace(cols=res.cols.long()),
                        x)
    with pytest.raises(ValueError, match='does not fit'):
        wk.window_strip(t, M.n_rows - 1, P, res, x)
    with pytest.raises(ValueError, match='contiguous'):
        wk.window_strip(t, M.n_rows, P, res, torch.zeros(
            5, M.n_cols).T)
