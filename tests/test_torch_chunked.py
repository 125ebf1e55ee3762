"""The port's chunked multi-level ELL format against pygsp_tpu, in float64 on
the CPU.

Sizes and graphs follow tests/test_chunked.py. The builder is the JAX
package's own NumPy code, so the same input must pack to the same arrays:
chunk sizes 64, 100 and 256 with a ragged last chunk, the degree
permutation, and a hub block that spills into every tier. The SpMM must
agree within 1e-12. The recurrence, synthesis, Lanczos and the fixed-graph
VJP are tests/test_torch_chunked_recurrence.py, the bf16 modes
tests/test_torch_chunked_bf16.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from pygsp_tpu.core import chunked as jck
from pygsp_tpu.core import sparse as jsp
from pygsp_tpu.core.operators import laplacian_op as j_laplacian_op
from pygsp_tpu.ops import eigen as jeigen
from pygsp_tpu_torch import convert
from pygsp_tpu_torch.core import _cuda, ell_kernel
from pygsp_tpu_torch.core import chunked as tck
from pygsp_tpu_torch.core import sparse as tsp
from pygsp_tpu_torch.ops import chebyshev as tcheby
from pygsp_tpu_torch.ops import eigen as teigen

from test_torch_ell import (TOL, _close, _graphs, _powerlaw, _rectangular,
                            _with_hubs, check_residue_order)


def _hub_block(n=400, seed=8, hub=7):
    """One hub row whose edges all land in source chunk 0 (chunk_rows 256):
    its block spills into every tier, the last one taking the rest."""
    rng = np.random.default_rng(seed)
    W = _powerlaw(n, seed).tolil()
    W[hub, :200] = rng.random(200) + 0.5
    W[:200, hub] = W[hub, :200].T
    W[hub, hub] = 0
    return sps.csr_matrix(W)


# (matrix, builder keywords)
CASES = {
    'R64': (_powerlaw, dict(chunk_rows=64)),
    'R100': (_powerlaw, dict(chunk_rows=100)),
    'R256-ragged': (_powerlaw, dict(chunk_rows=256)),
    'R64-degree': (_powerlaw, dict(chunk_rows=64, permute='degree')),
    'R256-degree-ragged': (lambda: _powerlaw(333, 23),
                           dict(chunk_rows=256, permute='degree')),
    'hub-block-every-tier': (_hub_block, dict(chunk_rows=256)),
    'hubs-ragged': (_with_hubs, dict(chunk_rows=64)),
    'tiers-factor-2': (_with_hubs, dict(chunk_rows=128, level_factor=2,
                                        min_level_width=1, max_tiers=6)),
    'rectangular': (_rectangular, dict(chunk_rows=128)),
}


def _coo(W):
    csr = W.tocsr()
    csr.sum_duplicates()
    coo = csr.tocoo()
    return coo.row, coo.col, coo.data, coo.shape[0], coo.shape[1]


def _build(case):
    make, kw = CASES[case]
    W = make()
    return (W, jck.chunked_from_host_coo(*_coo(W), **kw),
            tck.chunked_from_host_coo(*_coo(W), device='cpu', **kw))


def _leaves(J):
    leaves = {k: None if getattr(J, k) is None else np.asarray(getattr(J, k))
              for k in ('level_rows', 'rowptr', 'perm', 'iperm')}
    leaves['blocks'] = [{'cols': np.asarray(b.cols),
                         'vals': np.asarray(b.vals)} for b in J.blocks]
    leaves['block_keys'] = list(J.block_keys)
    leaves['levels'] = [{'cols': np.asarray(lev.cols),
                         'vals': np.asarray(lev.vals),
                         'src_chunk': lev.src_chunk} for lev in J.levels]
    leaves.update({k: getattr(J, k) for k in convert._CHUNKED_INTS})
    return leaves


def _assert_same_arrays(T, leaves, vals_tol=0.0):
    """The port's arrays equal to the JAX package's leaves (values within
    ``vals_tol`` where the two computed them apart); the port keeps its
    permutes as int64."""
    def same(got, want, what, vals=False):
        assert got.device.type == 'cpu'
        if vals and vals_tol:
            assert np.allclose(got.numpy(), want, rtol=0, atol=vals_tol), what
        else:
            assert np.array_equal(got.numpy(), want), what

    for k in ('level_rows', 'rowptr'):
        assert getattr(T, k).dtype == torch.int32, k
        same(getattr(T, k), leaves[k], k)
    for k in ('perm', 'iperm'):
        assert (getattr(T, k) is None) == (leaves[k] is None), k
        if leaves[k] is not None:
            assert getattr(T, k).dtype == torch.int64
            same(getattr(T, k), leaves[k], k)
    assert T.block_keys == tuple(tuple(k) for k in leaves['block_keys'])
    assert len(T.blocks) == len(leaves['blocks'])
    for blk, want in zip(T.blocks, leaves['blocks']):
        assert blk.cols.dtype == torch.int32
        same(blk.cols, want['cols'], 'block cols')
        same(blk.vals, want['vals'], 'block vals', vals=True)
    assert len(T.levels) == len(leaves['levels'])
    for lev, want in zip(T.levels, leaves['levels']):
        assert lev.src_chunk == want['src_chunk']
        same(lev.cols, want['cols'], 'level cols')
        same(lev.vals, want['vals'], 'level vals', vals=True)
    for k in convert._CHUNKED_INTS:
        assert getattr(T, k) == leaves[k], k


@pytest.mark.parametrize('case', list(CASES))
def test_builder_packs_the_same_arrays_as_jax(case):
    _, J, T = _build(case)
    _assert_same_arrays(T, _leaves(J))
    for name in ('n_out_chunks', 'n_src_chunks', 'shape'):
        assert getattr(T, name) == getattr(J, name), name
    last = T.n_src_chunks - 1
    assert T.src_chunk_size(last) == J.src_chunk_size(last)
    # the blocks are views of the one flat buffer the kernel reads
    for blk in T.blocks:
        if blk.vals.numel():
            assert blk.vals.untyped_storage().data_ptr() == (
                T.slot_vals.untyped_storage().data_ptr())
    if case == 'hub-block-every-tier':
        assert sum(lev.src_chunk == 0 for lev in T.levels) == 4
    if case.startswith('R256'):
        assert T.n_rows % T.chunk_rows        # a ragged last chunk
    if set(CASES[case][1]) <= {'chunk_rows', 'permute'}:
        _assert_same_arrays(tck.chunked_from_scipy(
            CASES[case][0](), device='cpu', **CASES[case][1]), _leaves(J))


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_choose_width_matches_jax(seed):
    rng = np.random.default_rng(seed)
    counts = (rng.pareto(1.5, size=300) * 3).astype(np.int64) + 1
    for r_rows in (64, 300, 4096):
        assert tck._choose_width(counts, r_rows) == jck._choose_width(
            counts, r_rows)
    assert tck._choose_width(np.zeros(0, np.int64), 10) == 0


@pytest.mark.parametrize('case', list(CASES))
def test_residue_list_keeps_the_level_order(case):
    _, _, T = _build(case)
    if not T.levels:
        assert T.residue is None
        return
    check_residue_order(T.residue, T.levels, T.level_rows.numpy(), T.n_rows,
                        T.n_cols, T.chunk_rows)


def test_residue_list_takes_the_ragged_sentinel():
    """On a ragged last source chunk the sentinel is the chunk's size, not
    chunk_rows: those slots are dead, and no live slot reads past x."""
    _, _, T = _build('R256-ragged')
    last = T.n_src_chunks - 1
    size = T.src_chunk_size(last)
    assert size < T.chunk_rows
    dead = [lev for lev in T.levels if lev.src_chunk == last
            and bool((lev.cols == size).any())]
    assert dead
    assert int(T.residue.cols.max()) < T.n_cols


# ---------------------------------------------------------------------------
# the products
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('s', [1, 4])
@pytest.mark.parametrize('case', list(CASES))
def test_spmm_matches_jax_and_scipy(case, s):
    W, J, T = _build(case)
    x = np.random.default_rng(s).normal(size=(W.shape[1], s))
    got = T @ torch.from_numpy(x)
    _close(got, jck.chunked_spmm(J, jnp.asarray(x)))
    _close(got, W @ x)
    _close(tsp.spmm(T, torch.from_numpy(x[:, 0])), W @ x[:, 0])


@pytest.mark.parametrize('case', ['R100', 'R64-degree', 'rectangular'])
def test_spmm_chunks_match_jax(case):
    W, J, T = _build(case)
    x = np.random.default_rng(7).normal(size=(W.shape[1], 3))
    xp = np.asarray(jck.permute_in(J, jnp.asarray(x)))
    want = J.spmm_chunks(jck.chunk_signal(jnp.asarray(xp), J.chunk_rows))
    got = T.spmm_chunks(tck.chunk_signal(torch.from_numpy(xp), T.chunk_rows))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize('case', list(CASES))
def test_to_scipy_round_trips(case):
    W, J, T = _build(case)
    assert abs(tck.chunked_to_scipy(T) - W).max() <= TOL
    assert abs(tsp.to_scipy(T) - jck.chunked_to_scipy(J)).max() == 0
    assert np.array_equal(tsp.to_dense(T).numpy(), W.toarray())


def test_scale_astype_abs_match_jax():
    W, J, T = _build('hubs-ragged')
    x = np.random.default_rng(1).normal(size=(W.shape[0], 2))
    for jm, tm in ((J.scale_vals(-0.5), T.scale_vals(-0.5)),
                   (J.abs_vals(), T.abs_vals())):
        _close(tm @ torch.from_numpy(x), jck.chunked_spmm(jm, jnp.asarray(x)))
        assert tm.residue.vals.dtype == tm.dtype
        _assert_same_arrays(tm, _leaves(jm))
    T32 = T.astype(torch.float32)
    assert T32.dtype == T32.blocks[0].vals.dtype == torch.float32
    _close(T32 @ torch.from_numpy(x).float(), W @ x, tol=1e-5)


# ---------------------------------------------------------------------------
# the Laplacian and the recurrence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('lap_type', ['combinatorial', 'normalized'])
def test_compute_laplacian_matches_jax(lap_type):
    J, T = _graphs('chunked', lap_type, W=_powerlaw())
    assert isinstance(T.L.offdiag, tck.ChunkedELLMatrix)
    assert T.L.lap_type == lap_type
    assert abs(T.L.to_scipy() - J.L.to_scipy()).max() <= 1e-14
    _assert_same_arrays(T.L.offdiag, _leaves(J.L.offdiag), vals_tol=1e-14)


def test_to_chunked_and_hoisting():
    J, T = _graphs('chunked', chunk_rows=64, permute='degree')
    assert T.L.to_chunked() is T.L
    op, pin, pout = T.L.hoisted()
    assert op.offdiag.perm is None
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(T.N, 2)))
    _close(pout(op @ pin(x)), T.L.to_scipy() @ x.numpy())


def test_upper_bound_matches_jax():
    for lap_type in ('combinatorial', 'normalized'):
        J, T = _graphs('chunked', lap_type, chunk_rows=128)
        assert float(teigen.laplacian_upper_bound(T.L)) == pytest.approx(
            float(jeigen.laplacian_upper_bound(J.L)), rel=1e-14)


def test_group_rule_counts_what_jax_counts():
    for case in ('R64', 'R64-degree', 'hubs-ragged'):
        _, J, T = _build(case)
        for jm, tm in ((J, T), (J.astype(jnp.bfloat16),
                                T.astype(torch.bfloat16))):
            jax_bytes = sum(np.asarray(leaf).nbytes
                            for leaf in jax.tree_util.tree_leaves(jm))
            assert tm.stored_bytes() == jax_bytes, case
            assert tcheby._operator_bytes(tm) == jax_bytes


# ---------------------------------------------------------------------------
# the kernel's operand pairs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('pair', sorted(
    ell_kernel.CHUNKED_OPERANDS, key=str))
def test_narrow_spmm_sums_in_float32(pair):
    """Each operand pair of the kernel: products in the promotion of the
    two dtypes, row sums in float32 or wider, y rounded once to x's
    dtype."""
    W, _, T = _build('hubs-ragged')
    xd, vd = pair
    M = T.astype(vd)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(W.shape[0],
                                                               3))).to(xd)
    y = tck.spmm_internal(M, x, out_dtype=xd)
    assert y.dtype == xd
    vals = tsp.to_scipy(M).tocsr()
    pdt = torch.promote_types(xd, vd)
    want = np.zeros((W.shape[0], 3))
    xs = x.double().numpy()
    for r in range(W.shape[0]):
        lo, hi = vals.indptr[r], vals.indptr[r + 1]
        p = (torch.from_numpy(vals.data[lo:hi]).to(vd)[:, None]
             * x[torch.from_numpy(vals.indices[lo:hi]).long()]).to(pdt)
        want[r] = p.double().sum(0).numpy()
    err = np.abs(y.double().numpy() - want)
    scale = np.abs(vals) @ np.abs(xs) + 1e-300
    ulp = 2.0 ** -8 if xd == torch.bfloat16 else 2.0 ** -23
    nnz = np.diff(vals.indptr).max()
    assert np.all(err <= (ulp + nnz * 2.0 ** -24) * scale + 1e-12)


# ---------------------------------------------------------------------------
# convert, the wrappers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('case', ['R256-degree-ragged',
                                  'hub-block-every-tier'])
def test_convert_takes_jax_leaves(case):
    W, J, _ = _build(case)
    leaves = _leaves(J)
    M = convert.chunked_from_numpy(leaves, device='cpu')
    _assert_same_arrays(M, leaves)
    x = np.random.default_rng(3).normal(size=(W.shape[0], 4))
    _close(M @ torch.from_numpy(x), J @ jnp.asarray(x))
    JL = j_laplacian_op(jsp.from_scipy(W), 'normalized').to_chunked(
        chunk_rows=64, permute='degree')
    L = convert.laplacian_from_numpy({
        'offdiag': _leaves(JL.offdiag), 'diag': np.asarray(JL.diag),
        'lap_type': JL.lap_type}, device='cpu')
    assert isinstance(L.offdiag, tck.ChunkedELLMatrix)
    _close(L @ torch.from_numpy(x), JL @ jnp.asarray(x))


def _break(leaves, what):
    bad = dict(leaves, blocks=[dict(b) for b in leaves['blocks']],
               levels=[dict(lev) for lev in leaves['levels']])
    if what == 'block_col':
        bad['blocks'][0]['cols'] = bad['blocks'][0]['cols'].copy()
        bad['blocks'][0]['cols'][0, 0] = -1
    elif what == 'level_col':
        bad['levels'][0]['cols'] = bad['levels'][0]['cols'].copy()
        bad['levels'][0]['cols'][0, 0] = bad['chunk_rows'] + 1
    elif what == 'level_row':
        bad['level_rows'] = bad['level_rows'].copy()
        bad['level_rows'][0] = bad['n_rows']
    elif what == 'key':
        bad['block_keys'] = [(99, 0)] + list(bad['block_keys'][1:])
    elif what == 'block_shape':
        bad['blocks'][0]['vals'] = bad['blocks'][0]['vals'][:-1]
    elif what == 'perm':
        bad['perm'] = bad['perm'][::-1].copy()
    return bad


@pytest.mark.parametrize('what', ['block_col', 'level_col', 'level_row',
                                  'key', 'block_shape', 'perm'])
def test_convert_refuses_bad_leaves(what):
    _, J, _ = _build('R64-degree')
    with pytest.raises(ValueError):
        convert.chunked_from_numpy(_break(_leaves(J), what), device='cpu')


def _no_build(*args, **kwargs):
    raise AssertionError('a CPU tensor must not reach the CUDA build')


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    monkeypatch.setattr(_cuda, 'build', _no_build)
    monkeypatch.setattr(_cuda, 'function', _no_build)
    for k in ell_kernel.KERNELS:
        monkeypatch.setattr(k, 'launches', 0)
    J, T = _graphs('chunked', chunk_rows=64)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(T.N, 2)))
    tcheby.cheby_op(T.L, J.lmax, torch.ones(2, 6, dtype=torch.float64), x)
    assert all(k.launches == 0 for k in ell_kernel.KERNELS)


def test_wrapper_refuses_bad_operands():
    _, _, T = _build('hubs-ragged')
    args = (T.table, T.slot_cols, T.slot_vals, T.residue)
    x = torch.zeros(T.n_cols, 3, dtype=torch.float64)
    with pytest.raises(ValueError, match='dtype pairs'):
        ell_kernel.chunked_spmm(*args, x.float(), T.n_rows)
    with pytest.raises(ValueError, match='residue values'):
        ell_kernel.chunked_spmm(*args[:3], args[3]._replace(
            vals=args[3].vals.float()), x, T.n_rows)
    with pytest.raises(ValueError, match='does not fit'):
        ell_kernel.chunked_spmm(*args, x, T.n_rows - 1)
    with pytest.raises(ValueError, match='slot table'):
        ell_kernel.chunked_spmm(args[0]._replace(pos=args[0].pos.int()),
                                *args[1:], x, T.n_rows)
    with pytest.raises(ValueError, match='one device'):
        ell_kernel.chunked_spmm(*args, x.to('meta'), T.n_rows)
