"""What the port's redesigned kernels rest on, checked on the CPU.

- The shared-memory layout that ``windowed_fold``'s wrapper hands its
  kernel (accumulator, ring of x rows, live-slot queue) stays within what
  one block may ask for on an H100, for every (K·P, dtype, S) the port
  builds, and is refused where nothing fits.
- The 3×TF32 split of the float32 banded kernel: each float32 operand is
  ``big + small``, ``big`` rounded to TF32 (10 mantissa bits) as
  ``cvt.rna.tf32.f32`` rounds (nearest, ties away from zero) and ``small``
  the float32 remainder, which the TF32 multiply reads truncated to its top
  19 bits; the product is taken as ``small·big + big·small + big·big``.
  Emulated here in numpy, on the band tiles of small ``Grid2d`` Laplacians
  as the recurrence scales them, that product is within 1e-6 of the float64
  product, where a single TF32 pass, or a split without either cross term,
  misses by more than 1e-5 (the card tests' limit).
- The launch that ``fold_products``' wrapper computes (KP tile, blocks,
  shared memory): at least 4 blocks for TPU kernel #3's single window,
  within one block's shared memory, refused where the grid cannot hold it.
  And its split of float32 products into three bfloat16 terms, emulated
  with torch's round-to-nearest-even casts: ``hi + mid + lo`` holds each
  product to 2^-24 of itself, where a fold that drops ``lo`` misses by more
  than 1e-6 (the card's limit).
- The CSR kernel's merge-path segment table from ``torch.searchsorted``
  on star, empty row, rectangular and empty matrices, and the kernel's
  walk and join emulated warp by warp, with segments of a few steps,
  against the plain SpMM: every row written once, every partial read after
  it was written.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import pygsp_tpu_torch as tgsp
from pygsp_tpu_torch.core import banded_kernel, csr_kernel
from pygsp_tpu_torch.core import sparse as tsp
from pygsp_tpu_torch.core import windowed_kernel as wk


# (K·P, S, itemsize, the S tile or None): every K·P the port builds ×
# f32/f64 × S, then the cases whose S tile is known
LAYOUT_CASES = [(kp, s, itemsize, None) for kp in (64, 128, 256, 512)
                for itemsize in (4, 8) for s in (1, 5, 128, 300)] + [
    (128, 128, 4, 128), (128, 128, 8, 128), (512, 128, 4, 64),
    (512, 128, 8, 32), (256, 5, 4, 32), (128, 300, 4, 128),
    (16384, 128, 8, 1)]


@pytest.mark.parametrize('kp,s,itemsize,tile', LAYOUT_CASES)
def test_fold_layout_fits_one_block(kp, s, itemsize, tile):
    lay = wk.fold_layout(kp, s, itemsize)
    assert 1 <= lay.s_tile <= 128
    assert tile is None or lay.s_tile == tile
    assert lay.s_tile <= max(32, s)          # no wider than S needs
    assert lay.ring >= wk.RING_GROUPS and lay.ring % wk.RING_GROUPS == 0
    # the queue outlasts the ring plus one staging round, and wraps by mask
    assert lay.queue >= lay.ring + wk.STAGE_ROUND
    assert lay.queue & (lay.queue - 1) == 0
    acc = kp * lay.s_tile * itemsize
    assert acc <= wk.ACC_BYTES
    assert lay.smem_bytes == (20 * wk.RING_GROUPS + acc
                              + lay.ring * lay.s_tile * itemsize
                              + lay.queue * (2 * itemsize + 4))
    assert lay.smem_bytes <= wk.SMEM_PER_BLOCK


def test_fold_layout_at_the_bench_path_fits_two_blocks_per_sm():
    """f32, K·P = 128, S = 128: a 64 KB accumulator, a 64-row ring and a
    256-slot queue; two blocks (and their 1 KB reserve each) share an SM."""
    lay = wk.fold_layout(128, 128, 4)
    assert lay == wk.FoldLayout(s_tile=128, ring=64, queue=256,
                                smem_bytes=101_536)
    assert 2 * (lay.smem_bytes + 1024) <= wk.SMEM_PER_SM


@pytest.mark.parametrize('kp,s', [(kp, s) for kp in (64, 128, 256, 512, 1024)
                                  for s in (1, 5, 128, 300)])
def test_fold_layout_of_a_bf16_x(kp, s):
    """A bf16 x folded into float32 sums: the accumulator and the queue's
    values at 4 bytes, the ring's rows at 2, so the ring holds up to twice
    the rows of the float32 fold for the same bytes, and the S tile is the
    float32 fold's."""
    lay, f32 = wk.fold_layout(kp, s, 4, 2), wk.fold_layout(kp, s, 4)
    assert lay.s_tile == f32.s_tile
    assert lay.ring == min(2 * f32.ring, 256)
    assert lay.queue >= lay.ring + wk.STAGE_ROUND
    acc = kp * lay.s_tile * 4
    assert lay.smem_bytes == (20 * wk.RING_GROUPS + acc
                              + lay.ring * lay.s_tile * 2
                              + lay.queue * (2 * 4 + 4))
    assert lay.smem_bytes <= wk.SMEM_PER_BLOCK


def test_bf16_fold_at_the_bench_path_fits_two_blocks_per_sm():
    """The fast mode's fold at the bench path: a 128-row ring of bf16 rows
    takes the bytes of the float32 fold's 64 rows."""
    lay = wk.fold_layout(128, 128, 4, 2)
    assert lay == wk.FoldLayout(s_tile=128, ring=128, queue=256,
                                smem_bytes=101_536)
    assert 2 * (lay.smem_bytes + 1024) <= wk.SMEM_PER_SM


@pytest.mark.parametrize('kp,s,itemsize', [(1 << 16, 128, 4), (1 << 15, 1, 8),
                                           (wk.ACC_BYTES, 1, 8)])
def test_fold_layout_refuses_what_cannot_fit(kp, s, itemsize):
    with pytest.raises(ValueError, match='does not fit'):
        wk.fold_layout(kp, s, itemsize)


def _tf32_rna(a):
    """Round float32 values to TF32 as ``cvt.rna.tf32.f32`` does: to the
    nearest value with 10 explicit mantissa bits, ties away from zero (add
    half of the dropped unit to the magnitude, clear the low 13 bits)."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_trunc(a):
    """What a TF32 multiply reads of a float32 value: its top 19 bits."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    a = np.array([1.0, 1.0 + 2.0**-11, 1.0 + 2.0**-10 + 2.0**-11,
                  -(1.0 + 2.0**-11), 3.0e-3], dtype=np.float32)
    r = _tf32_rna(a)
    assert r[0] == 1.0
    assert r[1] == 1.0 + 2.0**-10                  # tie: away from zero
    assert r[2] == 1.0 + 2.0**-9
    assert r[3] == -(1.0 + 2.0**-10)
    assert abs(r[4] - a[4]) <= 2.0**-11 * abs(a[4])
    assert np.all(r.view(np.uint32) & np.uint32(0x1FFF) == 0)
    t = _tf32_trunc(a)
    assert t[1] == 1.0 and t[3] == -1.0            # toward zero
    assert np.all(np.abs(t) <= np.abs(a))


@pytest.mark.parametrize('lap_type', ['combinatorial', 'normalized'])
def test_three_tf32_products_hold_f32_accuracy(lap_type):
    """The banded kernel's f32 product on the band tiles of a Grid2d
    Laplacian, scaled by 2/λmax as the Chebyshev step scales it. Products
    and sums are taken in float64 here, so the error measured is the
    split's alone (the kernel's f32 accumulation adds f32 rounding)."""
    G = tgsp.graphs.Grid2d(20, 31, lap_type=lap_type, device='cpu')
    lmax = 7.93 if lap_type == 'combinatorial' else 1.97
    Lb = G.L.to_banded()
    tiles = (Lb.offdiag.tiles * (2.0 / lmax)).numpy().astype(np.float32)
    nb, n_diag = tiles.shape[:2]
    x = np.random.default_rng(0).normal(size=(G.N, 16)).astype(np.float32)
    xw = banded_kernel.band_windows(torch.from_numpy(x), nb,
                                    (n_diag - 1) // 2).numpy()

    def product(a, b):
        return np.einsum('ndab,ndbs->nas', a.astype(np.float64),
                         b.astype(np.float64))

    want = product(tiles, xw)
    a_big, x_big = _tf32_rna(tiles), _tf32_rna(xw)
    a_small = _tf32_trunc(tiles - a_big)
    x_small = _tf32_trunc(xw - x_big)
    three = (product(a_small, x_big) + product(a_big, x_small)
             + product(a_big, x_big))
    scale = np.abs(want).max()
    assert np.abs(three - want).max() <= 1e-6 * scale
    # the faults the card's 1e-5 limit must catch: one TF32 pass, or a
    # split that drops either cross term
    for fault in (product(a_big, x_big),
                  product(a_big, x_small) + product(a_big, x_big),
                  product(a_small, x_big) + product(a_big, x_big)):
        assert np.abs(fault - want).max() > 1e-5 * scale


# ---------------------------------------------------------------------------
# fold_products: layout and the three-bf16 split
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('itemsize', [2, 4])
@pytest.mark.parametrize('s', [1, 5, 128, 129, 300])
@pytest.mark.parametrize('kp', [40, 256, 512])
@pytest.mark.parametrize('nw', [1, 3, 1024])
def test_products_layout_covers_the_output_in_one_block_budget(nw, kp, s,
                                                               itemsize):
    lay = wk.products_layout(nw, kp, s, itemsize)
    assert lay.block_m in (64, 128, 256)
    assert (lay.m_tiles - 1) * lay.block_m < kp <= lay.m_tiles * lay.block_m
    assert ((lay.n_tiles - 1) * wk.PRODUCTS_N < s
            <= lay.n_tiles * wk.PRODUCTS_N)
    assert lay.blocks == nw * lay.m_tiles * lay.n_tiles
    stage = wk.PRODUCTS_K * (wk.PRODUCTS_N * itemsize + 16 + 4)
    planes = 0 if itemsize == 2 else 3 * wk.PRODUCTS_K * wk.PRODUCTS_PITCH * 2
    assert lay.smem_bytes == wk.PRODUCTS_STAGES * stage + planes
    assert lay.smem_bytes <= wk.SMEM_PER_BLOCK
    if nw == 1 and kp >= 256:
        assert lay.blocks >= 4


def test_products_layout_at_the_tpu_kernels_shapes():
    """#3 (NW 1, KP 256, S 128): four 64-row blocks, not one; #2's probe
    shape (NW 1024): one 256-row block per window, which reads its p once;
    128-row blocks where 256 rows would leave SMs idle."""
    assert wk.products_layout(1, 256, 128, 2)[:4] == (64, 4, 1, 4)
    assert wk.products_layout(1024, 256, 128, 2)[:4] == (256, 1, 1, 1024)
    assert wk.products_layout(200, 256, 128, 2)[:4] == (128, 2, 1, 400)
    assert wk.products_layout(1024, 40, 128, 4)[:4] == (64, 1, 1, 1024)


@pytest.mark.parametrize('nw,kp,s,itemsize', [
    (1, 256, 70_000 * 128, 2), (2**31, 256, 128, 2), (1, 0, 128, 2),
    (1, 256, 128, 8)])
def test_products_layout_refuses_what_cannot_fit(nw, kp, s, itemsize):
    with pytest.raises(ValueError, match='does not fit|no fold_products'):
        wk.products_layout(nw, kp, s, itemsize)


def _bf16_terms(p):
    """hi, mid, lo of float32 products as the kernel's staging splits
    them: each the round-to-nearest-even bfloat16 of what is left."""
    hi = p.to(torch.bfloat16).float()
    mid = (p - hi).to(torch.bfloat16).float()
    lo = (p - hi - mid).to(torch.bfloat16).float()
    return hi, mid, lo


def test_three_bf16_terms_hold_f32_products():
    gen = torch.Generator().manual_seed(0)
    p = torch.randn(4, 300, 129, generator=gen) * torch.logspace(
        -3, 3, 129)
    hi, mid, lo = _bf16_terms(p)
    exact = p.double()
    three = hi.double() + mid.double() + lo.double()
    assert float(((three - exact).abs() / exact.abs()).max()) <= 2.0**-24
    # the fault the card's 1e-6 limit must catch: a fold that drops lo
    rid = torch.randint(-2, 42, (4, 300), generator=gen, dtype=torch.int32)
    want = wk.fold_products_plain(rid, exact, 40)
    got = wk.fold_products_plain(rid, hi.double() + mid.double(), 40)
    assert float((got - want).abs().max() / want.abs().max()) > 1e-6
    got = wk.fold_products_plain(rid, three, 40)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-7


# ---------------------------------------------------------------------------
# csr_spmm: segment table and the kernel's walk
# ---------------------------------------------------------------------------

def _star(n_cols=5000):
    """Row 2 holds n_cols edges; rows 0 and 5 are empty, the rest few."""
    A = sps.lil_matrix((7, n_cols))
    A[2, :] = np.arange(1, n_cols + 1)
    A[1, [3, 9]] = 1.5
    A[3, 4] = A[4, 0] = A[6, 7] = -2.0
    return A.tocsr()


def _empty_rows():
    rng = np.random.default_rng(3)
    A = sps.random(60, 60, density=0.2, random_state=rng, format='lil')
    A[0] = A[29] = A[30] = A[59] = 0            # first, middle, last
    return A.tocsr()


CSR_CASES = {
    'star': _star,
    'empty_rows': _empty_rows,
    'rectangular': lambda: sps.random(
        90, 37, density=0.3, random_state=np.random.default_rng(4),
        format='csr'),
    'nnz0': lambda: sps.csr_matrix((12, 9)),
}


@pytest.mark.parametrize('case', list(CSR_CASES))
def test_csr_segment_table(case):
    """Each segment starts after w·SEGMENT_STEPS steps of the walk: the rows
    before its row have ended (their ends are steps before it), its row has
    not, and its edge is the steps less the rows; every edge lies in
    exactly one segment."""
    M = tsp.from_scipy(CSR_CASES[case](), dtype=torch.float64, device='cpu')
    seg = csr_kernel.csr_segments(M.rowptr, M.cols.shape[0])
    assert seg.dtype == torch.int32 and seg.shape[0] == 2
    n_seg, E = seg.shape[1], csr_kernel.SEGMENT_STEPS
    n_steps = M.n_rows + M.cols.shape[0]
    assert n_seg == csr_kernel.n_segments(n_steps)
    assert (n_seg - 1) * E < max(n_steps, 1) <= n_seg * E
    rowptr = M.rowptr.tolist()
    rows, edges = seg.tolist()
    for w, (r, e) in enumerate(zip(rows, edges)):
        d = w * E
        assert r + e == d
        assert all(rowptr[i + 1] + i < d for i in range(r))
        if r < M.n_rows:
            assert rowptr[r + 1] + r >= d
            assert rowptr[r] <= e <= rowptr[r + 1]   # the row of edge e, or
        else:                                        # one that ends at it
            assert e >= M.nnz
    starts = [min(e, M.nnz) for e in edges] + [M.nnz]
    assert starts == sorted(starts) and starts[0] == 0
    covered = [k for a, b in zip(starts, starts[1:]) for k in range(a, b)]
    assert covered == list(range(M.nnz))


def _emulate_csr_kernel(rowptr, cols, vals, x):
    """csrc/csr_spmm.cu's segment and join kernels, warp by warp, in
    float64. Returns y and how many times each row was written; partials
    start as NaN, so one read before it was written shows in y."""
    rp, cols, vals = rowptr.tolist(), cols.tolist(), vals.numpy()
    n_rows, nnz = len(rp) - 1, rp[-1]
    rows, edges = csr_kernel.csr_segments(rowptr, len(cols)).tolist()
    n_seg = len(rows)
    y = np.full((n_rows, x.shape[1]), np.nan)
    partials = np.full((2 * n_seg, x.shape[1]), np.nan)
    writes = np.zeros(n_rows, int)
    for w in range(n_seg):
        if rows[w] >= n_rows:
            continue
        e0 = min(edges[w], nnz)
        last = w + 1 == n_seg
        r_stop = n_rows if last else rows[w + 1]
        e1 = nnz if last else min(edges[w + 1], nnz)
        state = {'r': rows[w], 'rs': rp[rows[w]], 're': rp[rows[w] + 1],
                 'acc': np.zeros(x.shape[1])}

        def flush():
            r, rs, re = state['r'], state['rs'], state['re']
            if rs < e0:
                partials[w] = state['acc']
            elif r < r_stop:
                y[r] = state['acc']
                writes[r] += 1
            else:
                partials[n_seg + w] = state['acc']
            state.update(r=r + 1, rs=re, acc=np.zeros(x.shape[1]),
                         re=rp[r + 2] if r + 1 < n_rows else nnz)

        for e in range(e0, e1):
            while e >= state['re']:
                flush()
            state['acc'] = state['acc'] + vals[e] * x[cols[e]]
        while state['r'] < n_rows and (state['r'] < r_stop
                                       or state['rs'] < e1):
            flush()
    for b in range(1, n_seg):
        rc = rows[b]
        if rc >= n_rows or not edges[b - 1] <= rp[rc] < edges[b]:
            continue
        b_end = b + 1
        while b_end < n_seg and rows[b_end] == rc:
            b_end += 1
        acc = partials[n_seg + b - 1].copy()
        for k in range(b, b_end):
            acc = acc + partials[k]
        y[rc] = acc
        writes[rc] += 1
    return y, writes


def _hubs_alone():
    """Two rows of 900 edges among 3,000 empty rows: most of the walk is
    row ends, which segments of edges alone would give to one warp."""
    A = sps.lil_matrix((3000, 900))
    A[17] = A[2500] = np.arange(1, 901)
    return A.tocsr()


@pytest.mark.parametrize('seg_steps', [3, 16, 256])
@pytest.mark.parametrize('case', list(CSR_CASES) + ['hubs_alone'])
def test_csr_kernel_walk_writes_every_row_once(monkeypatch, case, seg_steps):
    monkeypatch.setattr(csr_kernel, 'SEGMENT_STEPS', seg_steps)
    A = _hubs_alone() if case == 'hubs_alone' else CSR_CASES[case]()
    M = tsp.from_scipy(A, dtype=torch.float64, device='cpu')
    x = np.random.default_rng(5).normal(size=(A.shape[1], 3))
    y, writes = _emulate_csr_kernel(M.rowptr, M.cols, M.vals, x)
    assert np.all(writes == 1)
    want = A @ x
    assert np.allclose(y, want, rtol=0,
                       atol=1e-12 * max(1.0, np.abs(want).max()))


def _narrow_lanes(s):
    """The narrow entry's lanes an edge for S columns of float64 (V = 2
    values a lane at most): ``next_pow2(ceil(S / V))``."""
    v = min(2, s)
    return 1 << (-(-s // v) - 1).bit_length()


def _emulate_csr_narrow(rowptr, cols, vals, x, steps):
    """csrc/csr_spmm.cu's narrow entry (float64 instance), warp by warp:
    per step the 32 / L edges' products by group, each edge's row from the
    32 row ends the warp holds, the segmented inclusive scan over the
    groups in the kernel's order (Kogge-Stone: at offset 1, 2, 4, ... a
    group adds the one that far below it, if of its row), the carried row
    added first to the step's first run; then the join kernel. Returns y
    and how many times each row was written; partials start as NaN, so one
    read before it was written shows in y."""
    rp, cols, vals = rowptr.tolist(), cols.tolist(), vals.numpy()
    n_rows, nnz, s = len(rp) - 1, rp[-1], x.shape[1]
    g = 32 // _narrow_lanes(s)
    rows, edges = csr_kernel.csr_segments(rowptr, len(cols), steps).tolist()
    n_seg = len(rows)
    y = np.full((n_rows, s), np.nan)
    partials = np.full((2 * n_seg, s), np.nan)
    writes = np.zeros(n_rows, int)
    big = 2**31 - 1
    for w in range(n_seg):
        r_begin = rows[w]
        if r_begin >= n_rows:
            continue
        e0 = min(edges[w], nnz)
        last = w + 1 == n_seg
        r_stop = n_rows if last else rows[w + 1]
        e1 = nnz if last else min(edges[w + 1], nnz)
        begun = rp[r_begin] < e0

        def store(r, value):
            if r == r_begin and begun:
                partials[w] = value
            elif r < r_stop:
                y[r] = value
                writes[r] += 1
            else:
                partials[n_seg + w] = value

        for r in range(r_begin, r_stop):
            if rp[r + 1] <= max(rp[r], e0):
                store(r, np.zeros(s))

        def window(base):
            return [rp[i] if i <= n_rows else big
                    for i in range(base + 1, base + 33)]

        rb, end = r_begin, window(r_begin)
        carry, cur, c = np.zeros(s), -1, e0
        while c < e1:
            while end[31] - c < min(g, e1 - c):
                done = sum(e <= c for e in end)
                if done == 0:
                    break
                rb += done
                end = window(rb)
            n = min(g, e1 - c, end[31] - c)
            # the kernel's binary search over the 32 ends: at most 31
            row = [rb + min(31, sum(e <= c + q for e in end))
                   for q in range(n)]
            v = [vals[c + q] * x[cols[c + q]] for q in range(n)]
            off = 1
            while off < g:
                v = [v[q] + v[q - off] if q >= off and row[q - off] == row[q]
                     else v[q] for q in range(n)]
                off *= 2
            v = [carry + v[q] if row[q] == cur else v[q] for q in range(n)]
            for q in range(n):
                tail = q == n - 1 or row[q + 1] != row[q]
                if tail and c + q + 1 == rp[row[q] + 1] and row[q] < r_stop:
                    store(row[q], v[q])
            ends = c + n == rp[row[-1] + 1] and row[-1] < r_stop
            carry, cur = v[-1], -1 if ends else row[-1]
            c += n
        if cur >= 0:
            store(cur, carry)
    for b in range(1, n_seg):
        rc = rows[b]
        if rc >= n_rows or not edges[b - 1] <= rp[rc] < edges[b]:
            continue
        b_end = b + 1
        while b_end < n_seg and rows[b_end] == rc:
            b_end += 1
        acc = partials[n_seg + b - 1].copy()
        for k in range(b, b_end):
            acc = acc + partials[k]
        y[rc] = acc
        writes[rc] += 1
    return y, writes


def _empty_runs():
    """Rows of 5 edges between runs of 40 empty rows: a step of the
    narrow entry spans more row ends than the 32 a warp holds."""
    A = sps.lil_matrix((410, 50))
    A[::41] = np.arange(1, 51) % 10 == 3
    return A.tocsr()


@pytest.mark.parametrize('s', [1, 3, 8])
@pytest.mark.parametrize('seg_steps', [5, 64, 256])
@pytest.mark.parametrize('case', list(CSR_CASES) + ['hubs_alone',
                                                    'empty_runs'])
def test_csr_narrow_walk_writes_every_row_once(case, seg_steps, s):
    """The narrow entry's walk (lanes over edges, a segmented reduction by
    row across the warp, the carried row, the window of 32 row ends that a
    run of empty rows cuts a step short at) with segments of a few steps:
    every row written once, y within 1e-12 of the plain SpMM in f64."""
    A = {'hubs_alone': _hubs_alone, 'empty_runs': _empty_runs,
         **CSR_CASES}[case]()
    M = tsp.from_scipy(A, dtype=torch.float64, device='cpu')
    x = np.random.default_rng(6).normal(size=(A.shape[1], s))
    y, writes = _emulate_csr_narrow(M.rowptr, M.cols, M.vals, x, seg_steps)
    assert np.all(writes == 1)
    want = csr_kernel.csr_spmm_plain(M.rowptr, M.cols, M.vals,
                                     torch.from_numpy(x)).numpy()
    assert np.allclose(y, want, rtol=0,
                       atol=1e-12 * max(1.0, np.abs(want).max()))


def test_segment_table_is_kept_per_rowptr_and_version():
    """segment_table keeps one table per rowptr tensor: another rowptr
    (same shape, other rows) gets its own, never this one's, and an
    in-place change of this one makes the table anew."""
    a = tsp.from_scipy(_empty_rows(), device='cpu')
    b = tsp.from_scipy(CSR_CASES['rectangular']()[:60], device='cpu')
    assert a.rowptr.shape == b.rowptr.shape
    n = a.cols.shape[0]
    seg_a, join_a = csr_kernel.segment_table(a.rowptr, n, 16)
    assert seg_a is csr_kernel.segment_table(a.rowptr, n, 16)[0]
    seg_b, _ = csr_kernel.segment_table(b.rowptr, n, 16)
    assert torch.equal(seg_b, csr_kernel.csr_segments(b.rowptr, n, 16))
    assert not torch.equal(seg_a, seg_b)
    assert torch.equal(csr_kernel.segment_table(a.rowptr, n, 5)[0],
                       csr_kernel.csr_segments(a.rowptr, n, 5))
    a.rowptr.copy_(b.rowptr)
    seg, join = csr_kernel.segment_table(a.rowptr, n, 16)
    assert torch.equal(seg, seg_b) and seg is not seg_a
    # join: some row is in progress, with edges before, at a segment start
    star = tsp.from_scipy(_star(), device='cpu')
    assert csr_kernel.segment_table(star.rowptr, star.cols.shape[0], 64)[1]
    diag = tsp.from_scipy(sps.eye(40, format='csr'), device='cpu')
    assert not csr_kernel.segment_table(diag.rowptr, diag.cols.shape[0],
                                        64)[1]


def test_csr_spmm_entry_by_width():
    """The wrapper's table: the narrow entry up to NARROW_WIDTH columns of
    each dtype, the wide one above, and an entry that is neither
    refused."""
    for dt, widest in csr_kernel.NARROW_WIDTH.items():
        assert 0 < widest <= csr_kernel.NARROW_MAX[dt]
        assert csr_kernel.entry_for(1, dt) == 'narrow'
        assert csr_kernel.entry_for(widest, dt) == 'narrow'
        assert csr_kernel.entry_for(widest + 1, dt) == 'wide'
        assert csr_kernel.entry_for(128, dt) == 'wide'
    M = tsp.from_scipy(_empty_rows(), device='cpu')
    with pytest.raises(ValueError, match='entry'):
        csr_kernel.csr_spmm(M.rowptr, M.cols, M.vals, torch.ones(60, 2),
                            entry='both')


@pytest.mark.parametrize('n_steps', [0, 100, 13_246, 131_072, 1_000_000,
                                     17_824_212])
def test_narrow_segment_length_by_walk(n_steps):
    """The narrow entry's segments: NARROW_SEGMENT_STEPS long on a large
    walk, halved while fewer than NARROW_MIN_SEGMENTS would cover it, never
    below NARROW_MIN_STEPS."""
    steps = csr_kernel.narrow_steps(n_steps)
    longest, shortest = (csr_kernel.NARROW_SEGMENT_STEPS,
                         csr_kernel.NARROW_MIN_STEPS)
    assert shortest <= steps <= longest
    assert longest % steps == 0
    if steps < longest:
        assert n_steps < 2 * steps * csr_kernel.NARROW_MIN_SEGMENTS
    if steps > shortest:
        assert n_steps >= steps * csr_kernel.NARROW_MIN_SEGMENTS
