"""The fused multi-matrix SpMM in one launch (``fold_strip_multi``).

``core.windowed.spmm_multi_internal`` now takes ``y = Σ_m A_m @ x_m`` in
one kernel that folds each window's rows straight from the slabs and
writes y, where it took the fold ``windowed_fold_multi`` into a window
tensor and the tail ``window_strip``. On the CPU the wrapper runs its
plain version, held here in float64 within 1e-12 of the largest value to
the JAX package's ``windowed_spmm_chunks_multi`` on the 2-D engine's ring
groups: device (0, 0)'s plain-ring group of the 4 × 4 partition, both fold
positions' groups of the 2 × 2 interleaved ring, a borrow span of 4, and a
hub whose row has more residue entries than the kernel's heavy-row bound.

The kernel's walk is emulated (:func:`_emulate_kernel`): its grid (the
heavy rows' windows first, each window folded by one block), the slots a
row's part d sums (window w − d, row id d·P + r, matrix by matrix in slot
order: the stable sort by row id) and the strip's roundings; and so is
the two-launch route it replaces (:func:`_emulate_two_launches`, the fold's
queue order, then the strip). The two are bit-equal in every operand pair
of the fold, which is what the card's tests ask of the two CUDA routes.
"""

import os
import re

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

import pygsp_tpu as gsp
from pygsp_tpu import parallel as jpar
from pygsp_tpu.core import windowed as jwin

from pygsp_tpu_torch import parallel as tpar
from pygsp_tpu_torch.core import windowed as twin
from pygsp_tpu_torch.core import windowed_kernel as wk
from pygsp_tpu_torch.parallel.partition import shard_slice

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S = 5


@pytest.fixture(scope='module')
def W():
    return sps.csr_matrix(gsp.graphs.Sensor(200, seed=7).W)


@pytest.fixture(scope='module')
def W_hub(W):
    """The sensor graph with 8 hubs, each joined to 120 other vertices."""
    rng = np.random.default_rng(11)
    hubs = rng.choice(200, size=8, replace=False)
    rest = np.setdiff1d(np.arange(200), hubs)
    src = np.repeat(hubs, 120)
    dst = np.concatenate([rng.choice(rest, size=120, replace=False)
                          for _ in hubs])
    star = sps.csr_matrix((rng.uniform(0.5, 1.5, size=src.size),
                           (src, dst)), shape=W.shape)
    return sps.csr_matrix(W + star + star.T)


def _jax_local(e):
    """Device 0's local matrix of a JAX ShardedWindowed."""
    return jpar.ShardedWindowed(**{
        f: (getattr(e, f)[0:1] if f in ('cols', 'vals', 'rowid',
                                        'level_rows')
            else tuple(v[0:1] for v in getattr(e, f))
            if f in ('lvl_cols', 'lvl_vals') else getattr(e, f))
        for f in e.__dataclass_fields__}).local_matrix()


# (graph, partition shape, layout keywords, fold position or None)
CASES = {
    'ring_4x4': ('W', (4, 4), dict(chunk_rows=16, window_rows=8), None),
    'interleaved_2x2_pos0': ('W', (2, 2), dict(chunk_rows=16, window_rows=8,
                                               split_cols=True), 0),
    'interleaved_2x2_pos1': ('W', (2, 2), dict(chunk_rows=16, window_rows=8,
                                               split_cols=True), 1),
    'span4': ('W', (4, 4), dict(chunk_rows=16, window_rows=4,
                                borrow_span=4), None),
    'heavy': ('W_hub', (4, 4), dict(chunk_rows=8, window_rows=4,
                                    slab_width=1), None),
}


@pytest.fixture(scope='module')
def groups(W, W_hub):
    """Per case: device (0, 0)'s group of matrices in the JAX package and
    the port (f64), and one x per matrix."""
    graphs = dict(W=W, W_hub=W_hub)
    out = {}
    for name, (g, shape, kw, pos) in CASES.items():
        ja = jpar.twod_local_windowed(jpar.partition_graph_2d(
            graphs[g], *shape, dtype=np.float64), ring=True, **kw)
        tb = tpar.twod_local_windowed(tpar.partition_graph_2d(
            graphs[g], *shape, dtype=np.float64, device='cpu'), ring=True,
            **kw)
        if pos is not None:
            ja, tb = [row[pos] for row in ja], [row[pos] for row in tb]
        jm = [_jax_local(e) for e in ja]
        tm = [shard_slice(e, 0).local_matrix() for e in tb]
        rng = np.random.default_rng(len(out))
        xs = [rng.normal(size=(m.n_cols, S)) for m in tm]
        out[name] = (jm, tm, xs)
    return out


def _merged(mats):
    return wk.merge_residues([m.residue for m in mats], mats[0].n_rows)


def _args(mats):
    m0 = mats[0]
    return ([(m.cols, m.vals, m.rowid) for m in mats], m0.chunk_rows,
            m0.window_rows, m0.borrow_span, m0.n_rows)


def test_cases_take_what_the_kernel_must(groups):
    """Matrices of other slab widths or source-chunk counts, residue
    lists, a borrow span of 4 and a row with at least the heavy-row bound
    of residue entries."""
    for name, (_, tm, _) in groups.items():
        assert len(tm) >= 2 and _merged(tm) is not None, name
    _, tm, _ = groups['ring_4x4']
    assert len({tuple(m.cols.shape[2:]) for m in tm}) > 1
    assert groups['span4'][1][0].borrow_span == 4
    merged = _merged(groups['heavy'][1])
    counts = merged.rowptr[1:] - merged.rowptr[:-1]
    assert merged.heavy.numel() > 0
    assert int(counts.max()) >= wk.TAIL_HEAVY_ENTRIES


@pytest.mark.parametrize('case', list(CASES))
def test_plain_matches_jax(groups, case):
    jm, tm, xs = groups[case]
    R = tm[0].chunk_rows
    want = np.concatenate(jwin.windowed_spmm_chunks_multi(
        jm, [tuple(jnp.asarray(x[i:i + R]) for i in range(0, len(x), R))
             for x in xs]))
    slabs, R, P, K, n = _args(tm)
    got = wk.fold_strip_multi_plain(slabs, [torch.tensor(x) for x in xs],
                                    R, P, K, n, _merged(tm)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    fused = twin.windowed_spmm_chunks_multi(
        tm, [tuple(torch.tensor(x[i:i + R]) for i in range(0, len(x), R))
             for x in xs])
    assert np.array_equal(torch.cat(fused).numpy(), got)


def _operands(tm, xs, pair):
    xd, vd = pair
    mats = [m.astype(vd) for m in tm]
    return mats, [torch.tensor(x).to(xd) for x in xs]


@pytest.mark.parametrize('pair', [(torch.float32, torch.float32),
                                  (torch.bfloat16, torch.float32)],
                         ids=['f32', 'bf16_carry'])
@pytest.mark.parametrize('case', list(CASES))
def test_bit_equal_to_the_two_step_plain_route(groups, case, pair):
    _, tm, xs = groups[case]
    mats, x = _operands(tm, xs, pair)
    slabs, R, P, K, n = _args(mats)
    merged = _merged(mats)
    y = wk.fold_strip_multi(slabs, x, R, P, K, n, merged)
    assert y.dtype == pair[0] and y.shape == (n, S)
    assert torch.equal(y, wk.window_strip_plain(
        wk.windowed_fold_multi_plain(slabs, x, R, K * P), n, P, merged, x))


@pytest.mark.parametrize('case', list(CASES))
def test_spmm_multi_internal_before_and_after(groups, case):
    """The entry point's y is the two-launch route's (the fold and the
    strip wrappers, which run their plain versions here), and at one
    matrix that of ``spmm_internal``."""
    _, tm, xs = groups[case]
    mats, x = _operands(tm, xs, (torch.float32, torch.float32))
    merged = _merged(mats)
    slabs, R, P, K, n = _args(mats)
    before = wk.window_strip(wk.windowed_fold_multi(slabs, x, R, K * P), n,
                             P, merged, x)
    assert torch.equal(twin.spmm_multi_internal(mats, x, merged), before)
    for m, v in zip(mats, x):
        one = twin.spmm_multi_internal([m], [v], _merged([m]))
        assert torch.equal(one, twin.spmm_internal(m, v))


# ---------------------------------------------------------------------------
# the kernel's walk, emulated
# ---------------------------------------------------------------------------

def _window_slots(slab, x, R, win, lo, hi):
    """The live slots of window ``win`` (flat) of one matrix whose row ids
    lie in [lo, hi), in slot order: (row ids, x rows, values)."""
    cols, vals, rowid = slab
    nw = cols.shape[1]
    c = cols[win // nw, win % nw].reshape(-1).long()
    r = rowid[win // nw, win % nw].reshape(-1).long()
    v = vals[win // nw, win % nw].reshape(-1)
    L = cols.shape[3]
    g = torch.arange(c.numel()) // L * R + c
    live = (c >= 0) & (c < R) & (g < x.shape[0]) & (r >= lo) & (r < hi)
    return r[live], g[live], v[live]


def _fold_into(acc, slabs, xs, R, win, lo, hi):
    """Add the slots of window ``win`` with row ids in [lo, hi) into the
    sums ``acc`` (rows by row id), matrix by matrix in slot order: the
    fold kernel's queue order, one slot at a time."""
    for slab, x in zip(slabs, xs):
        r, g, v = _window_slots(slab, x, R, win, lo, hi)
        acc.index_add_(0, r, (v[:, None] * x[g]).to(acc.dtype))


def _emulate_two_launches(slabs, xs, R, P, K, n_rows, residue):
    """``windowed_fold_multi``'s kernel (every window's slots into one
    accumulator in queue order, rounded to x's dtype), then the strip."""
    n_out, nw = slabs[0][0].shape[:2]
    sdt = torch.promote_types(xs[0].dtype, torch.float32)
    t = torch.empty((n_out * nw, K * P, S), dtype=xs[0].dtype)
    for win in range(n_out * nw):
        acc = torch.zeros((K * P, S), dtype=sdt)
        _fold_into(acc, slabs, xs, R, win, 0, K * P)
        t[win] = acc.to(xs[0].dtype)
    return wk.window_strip_plain(t.reshape(n_out, nw, K * P, S), n_rows, P,
                                 residue, xs)


def _leading_heavy(counts, row0, P, n_rows):
    rows = range(row0, min(row0 + P, n_rows))
    heavy = [(int(counts[r]), -r) for r in rows
             if counts[r] >= wk.TAIL_HEAVY_ENTRIES]
    return -max(heavy)[1] if heavy else -1


def _emulate_kernel(slabs, xs, R, P, K, n_rows, residue):
    """``fold_strip_multi``'s kernel: its grid (a block per heavy row, the
    window's leading heavy row's block folding it; then a block per window,
    skipping the heavy rows' windows), each window's parts d = 0..nd-1 (the
    slots of window w − d with row ids in [d·P, (d+1)·P)), and its epilogue
    (the parts rounded to x's dtype and added in order, rounded once; then
    the residue entries in order, each sum and each add rounded)."""
    xd = xs[0].dtype
    sdt = torch.promote_types(xd, torch.float32)
    n_out, nw = slabs[0][0].shape[:2]
    if residue is None:
        counts, heavy = torch.zeros(n_rows, dtype=torch.long), []
    else:
        counts = (residue.rowptr[1:] - residue.rowptr[:-1]).long()
        heavy = residue.heavy.tolist()
    blocks = [(h // P, h) for h in heavy] + [(w, None)
                                            for w in range(n_out * nw)]
    owned = []
    for win, h in blocks:
        if win * P >= n_rows:
            continue
        lead = _leading_heavy(counts, win * P, P, n_rows)
        if (lead == h) if h is not None else lead < 0:
            owned.append(win)
    assert sorted(owned) == list(range(-(-n_rows // P)))
    y = torch.empty((n_rows, S), dtype=xd)
    for win in owned:
        nd = min(K, win % nw + 1)
        acc = torch.zeros((nd * P, S), dtype=sdt)
        for d in range(nd):
            _fold_into(acc, slabs, xs, R, win - d, d * P, d * P + P)
        for r in range(min(P, n_rows - win * P)):
            row = win * P + r
            v = acc[r].to(xd).to(sdt)
            for d in range(1, nd):
                v = v + acc[d * P + r].to(xd).to(sdt)
            v = v.to(xd)
            if residue is not None:
                for e in range(int(residue.rowptr[row]),
                               int(residue.rowptr[row + 1])):
                    x = xs[int(residue.emat[e])]
                    s = torch.zeros(S, dtype=sdt)
                    for q in range(int(residue.entptr[e]),
                                   int(residue.entptr[e + 1])):
                        # a 1-element vals: a 0-dim one would take x's
                        # dtype in the product
                        s = s + (residue.vals[q:q + 1]
                                 * x[residue.cols[q]]).to(sdt)
                    v = (v.to(sdt) + s.to(xd).to(sdt)).to(xd)
            y[row] = v
    return y


@pytest.mark.parametrize('pair', sorted(wk.FOLD_OPERANDS, key=str))
@pytest.mark.parametrize('case', list(CASES))
def test_emulated_kernel_is_the_two_launch_route(groups, case, pair):
    _, tm, xs = groups[case]
    mats, x = _operands(tm, xs, pair)
    slabs, R, P, K, n = _args(mats)
    merged = _merged(mats)
    got = _emulate_kernel(slabs, x, R, P, K, n, merged)
    assert torch.equal(got, _emulate_two_launches(slabs, x, R, P, K, n,
                                                  merged))
    if pair == (torch.float64, torch.float64):
        want = wk.fold_strip_multi_plain(slabs, x, R, P, K, n, merged)
        assert torch.allclose(got, want, rtol=0,
                              atol=1e-13 * float(want.abs().max()))


def test_emulated_kernel_without_residue(groups):
    _, tm, xs = groups['ring_4x4']
    mats, x = _operands(tm, xs, (torch.float32, torch.float32))
    slabs, R, P, K, n = _args(mats)
    assert torch.equal(_emulate_kernel(slabs, x, R, P, K, n, None),
                       _emulate_two_launches(slabs, x, R, P, K, n, None))
    assert torch.equal(wk.fold_strip_multi(slabs, x, R, P, K, n),
                       wk.window_strip_plain(wk.windowed_fold_multi_plain(
                           slabs, x, R, K * P), n, P))


# ---------------------------------------------------------------------------
# the wrapper's contract
# ---------------------------------------------------------------------------

def test_refusals(groups):
    _, tm, xs = groups['ring_4x4']
    x = [torch.tensor(v) for v in xs]
    slabs, R, P, K, n = _args(tm)
    with pytest.raises(ValueError, match='merged residue'):
        wk.fold_strip_multi(slabs, x, R, P, K, n, next(
            m.residue for m in tm if m.residue is not None))
    with pytest.raises(ValueError, match='do not hold'):
        wk.fold_strip_multi(slabs, x, R, P, K, 10**6, None)
    with pytest.raises(ValueError, match='1 to 16'):
        wk.fold_strip_multi(slabs * 5, x * 5, R, P, K, n)
    with pytest.raises(ValueError, match='does not fit'):
        wk.fold_strip_multi(slabs, x, R, P, K, n - 1, _merged(tm))
    with pytest.raises(ValueError, match='dtype'):
        wk.fold_strip_multi(slabs, x, R, P, K, n, _merged(
            [m.astype(torch.float32) for m in tm]))


def test_cpu_runs_the_plain_version(groups, monkeypatch):
    _, tm, xs = groups['span4']
    monkeypatch.setattr(wk.fold_strip_multi, 'launches', 0)
    twin.spmm_multi_internal(tm, [torch.tensor(v) for v in xs],
                             _merged(tm))
    assert wk.fold_strip_multi.launches == 0


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64,
                                   torch.bfloat16])
@pytest.mark.parametrize('vec', [True, False])
def test_layout_stages_a_window(dtype, vec):
    """A block's bytes: per raw slot its value in the sums' type and three
    ints, a round of heavy-row sums of the tile, the row ids' starts and
    cursors and the rows' first entries, the warps' counts; the tile is 32
    lanes of 16-byte pieces (8-byte pieces, 4 values, in bfloat16), or of
    one value."""
    item = torch.finfo(wk._sum_dtype(dtype)).bits // 8
    lay = wk.fold_strip_layout(128, 600, dtype, vec)
    piece = {torch.float32: 4, torch.float64: 2, torch.bfloat16: 4}[dtype]
    assert wk.strip_piece(dtype) == piece
    assert lay.tile == 32 * (piece if vec else 1)
    assert lay.smem_bytes == ((600 + wk.ENTRY_ROUND * lay.tile) * item
                              + (3 * 600 + 3 * 128 + 2 + wk.STRIP_WARPS + 1)
                              * 4)


def test_windows_that_do_not_fit_keep_the_two_launches(groups, monkeypatch):
    """A window of more raw slots than a block stages is refused by the
    one-launch kernel; ``spmm_multi_internal`` takes the fold and the strip
    there, with the same result."""
    _, tm, xs = groups['ring_4x4']
    mats, x = _operands(tm, xs, (torch.float32, torch.float32))
    merged = _merged(mats)
    slabs, R, P, K, n = _args(mats)
    assert wk.strip_capacity(slabs, K) == K * sum(
        c.shape[2] * c.shape[3] for c, _, _ in slabs)
    assert wk.fold_strip_fits(slabs, x, K, P)
    want = twin.spmm_multi_internal(mats, x, merged)
    monkeypatch.setattr(wk, 'SMEM_PER_BLOCK', 1024)
    assert not wk.fold_strip_fits(slabs, x, K, P)
    with pytest.raises(ValueError, match='do not fit'):
        wk.fold_strip_multi(slabs, x, R, P, K, n, merged)
    assert torch.equal(twin.spmm_multi_internal(mats, x, merged), want)


def test_source_constants_and_instances():
    with open(os.path.join(REPO, 'pygsp_tpu_torch', 'csrc',
                           'windowed_fold.cu')) as f:
        src = f.read()
    assert int(re.search(r'kEntryRound = (\d+);', src).group(1)) == \
        wk.ENTRY_ROUND
    assert int(re.search(r'kStripWarps = (\d+);', src).group(1)) == \
        wk.STRIP_WARPS
    assert 1 << int(re.search(r'kSrcBits = (\d+);', src).group(1)) == \
        wk._SRC_ROWS
    assert int(re.search(r'kHeavyMin = (\d+);', src).group(1)) == \
        wk.TAIL_HEAVY_ENTRIES
    for suffix in wk._FOLD_TYPES.values():
        for rowid in wk._ROWIDS.values():
            assert f'FOLD_STRIP_MULTI(fold_strip_multi_{suffix}_{rowid},' \
                in src
    for suffix in wk._DTYPES.values():
        assert f'(fold_strip_multi_smem_bytes_{suffix},' in src
    assert 'windowed_spmm_chunks_multi' in src
