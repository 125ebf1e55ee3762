"""The wide entry of the ELL and chunked SpMMs (csrc/ell_spmm.cu,
``slot_wide_kernel`` and the heavy rows' ``slot_heavy_kernel``), emulated
on the CPU in float32 with every product and sum rounded once, as the
kernel rounds them.

The kernel cannot run here, so its walk is emulated: warps of 32 / G
rows (a group of G lanes a row), each row's positions read 32 at a time
through the position table, the live ones added in order, then the row's
overflow slots; the heavy rows left to their blocks on the side stream,
which cut a row into units of kUnit slots summed by workers and added in
worker order. ``y`` starts as NaN and every write is counted,
so a row written twice or never shows. The emulation is held bit for bit
to the narrow entry's walk (the per-block table, tile by tile), which the
card holds to the wide entry wherever both take a width, and within 1e-5
to the plain version in float64. The launcher's choice of layout, the
heavy list and the wrapper's refusals are checked without a card.
"""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pygsp_tpu_torch.core import ell_kernel
from pygsp_tpu_torch.core import sparse as tsp

from test_torch_cuda import SLOT_FORMATS, _slot_hub_graph

SOURCE = Path(ell_kernel.__file__).parent.parent / 'csrc' / 'ell_spmm.cu'
# csrc/ell_spmm.cu's kWarps, kUnit and kThreads
# (test_constants_match_the_source)
WARPS, UNIT, THREADS = 8, 32, 256
WIDTHS = (36, 520)
# the card tests' formats, and an ELL level 0 of 40 positions a row: more
# than one batch of 32
FORMATS = {**SLOT_FORMATS,
           'ell-width40': lambda W, device: tsp.ell_from_scipy(
               W, width=40, device=device)}
f32 = np.float32


def _plan(s, itemsize, aligned=True):
    """The wide entry's layout as launch_slot_spmm chooses it for S columns
    of ``itemsize``-byte x: ``E`` values a lane (16 bytes where S is whole
    16-byte pieces and x and y are aligned, else one), the pieces ``nvec``
    a row, ``G`` lanes a row of slot_wide_kernel (0: the per-lane walk of
    slot_rows_kernel, under 8 pieces), the rows a block, and the heavy
    blocks' lanes a row (slot_args' ``group``)."""
    vec = aligned and s % (16 // itemsize) == 0
    e = 16 // itemsize if vec else 1
    nvec = s // e
    g = (0 if nvec < 8 else 32 if not vec or nvec > 16
         else 16 if nvec > 8 else 8)
    group = 32 if nvec >= 8 else 1 << (nvec - 1).bit_length()
    rows = WARPS * (32 // g) if g else THREADS // group
    return {'E': e, 'nvec': nvec, 'G': g, 'rows_per_block': rows,
            'heavy_group': group}


@functools.lru_cache(maxsize=None)
def _fixture(name):
    W = _slot_hub_graph(n=1500, hubs=(2, 7, 1499))
    M = FORMATS[name](W, 'cpu').astype(torch.float32)
    x = np.random.default_rng(len(name)).normal(
        size=(M.n_cols, max(WIDTHS))).astype(f32)
    return M, x


def _operands(M):
    if hasattr(M, 'ell_cols'):
        return (M.table, M.ell_cols.reshape(-1).numpy(),
                M.ell_vals.reshape(-1).numpy(), M.residue)
    return M.table, M.slot_cols.numpy(), M.slot_vals.numpy(), M.residue


def _spans(table, residue, n_rows):
    """Per row its positions [k0, k1) and overflow slots [q0, q1)."""
    R = table.chunk_rows
    cptr = table.chunk_ptr.numpy()
    i = np.arange(n_rows) // R
    q = np.zeros((n_rows, 2), np.int64)
    if residue is not None:
        rowptr, entptr = residue.rowptr.numpy(), residue.entptr.numpy()
        q[:, 0], q[:, 1] = entptr[rowptr[:-1]], entptr[rowptr[1:]]
    return cptr[i], cptr[i + 1], q[:, 0], q[:, 1]


def _add(acc, v, xrow):
    """acc + v · x row, the product and the sum each rounded to float32."""
    return (acc + (f32(v) * xrow).astype(f32)).astype(f32)


def _positions(table, cols, vals, row, k0, k1):
    """The live slots of row ``row``'s positions [k0, k1), in order, read
    through the position table: (x row, value)."""
    pos = table.pos.numpy()
    lr = row % table.chunk_rows
    out = []
    for base, stride, col_base, limit in pos[k0:k1]:
        q = base + lr * stride
        if cols[q] < limit:
            out.append((col_base + cols[q], vals[q]))
    return out


def _overflow(residue, q0, q1):
    if residue is None or q1 <= q0:
        return []
    return list(zip(residue.cols.numpy()[q0:q1], residue.vals.numpy()[q0:q1]))


def _heavy(table, cols, vals, residue, x, row, k0, k1, q0, q1, group):
    """spmm_heavy: units of UNIT positions, then of UNIT overflow slots;
    worker w of THREADS / group sums units w, w + W, ... in order, and the
    workers' sums are added in worker order."""
    workers = THREADS // group
    units = [_positions(table, cols, vals, row, k, min(k + UNIT, k1))
             for k in range(k0, k1, UNIT)]
    units += [_overflow(residue, q, min(q + UNIT, q1))
              for q in range(q0, q1, UNIT)]
    parts = []
    for w in range(workers):
        acc = np.zeros(x.shape[1], f32)
        for unit in units[w::workers]:
            for c, v in unit:
                acc = _add(acc, v, x[c])
        parts.append(acc)
    total = np.zeros(x.shape[1], f32)
    for part in parts:
        total = (total + part).astype(f32)
    return total


def _emulate_wide(table, cols, vals, residue, x, n_rows, plan):
    """slot_wide_kernel's grid, warp by warp, and the heavy blocks: y and
    the number of writes of each row."""
    g = plan['G']
    assert g in (8, 16, 32)
    k0s, k1s, q0s, q1s = _spans(table, residue, n_rows)
    y = np.full((n_rows, x.shape[1]), np.nan, f32)
    writes = np.zeros(n_rows, int)
    heavy = [] if residue is None else residue.heavy.tolist()
    for r in heavy:
        y[r] = _heavy(table, cols, vals, residue, x, r, k0s[r], k1s[r],
                      q0s[r], q1s[r], plan['heavy_group'])
        writes[r] += 1
    per_warp = 32 // g
    blocks = -(-n_rows // plan['rows_per_block'])
    for warp in range(blocks * WARPS):
        for sg in range(per_warp):
            row = warp * per_warp + sg
            if row >= n_rows or q1s[row] - q0s[row] >= ell_kernel.HEAVY_SLOTS:
                continue
            # rounds run from the positions into the overflow slots in
            # order: the adds are the positions', then the overflow slots'
            acc = np.zeros(x.shape[1], f32)
            for kb in range(k0s[row], k1s[row], 32):   # a batch
                for c, v in _positions(table, cols, vals, row, kb,
                                       min(kb + 32, k1s[row])):
                    acc = _add(acc, v, x[c])
            for c, v in _overflow(residue, q0s[row], q1s[row]):
                acc = _add(acc, v, x[c])
            y[row] = acc
            writes[row] += 1
    return y, writes


def _emulate_narrow(table, cols, vals, residue, x, n_rows, plan):
    """The narrow entry's order, row by row: the row's blocks from the
    per-block table, each block's slots in order, then the overflow slots;
    the heavy rows by the same heavy blocks."""
    R = table.chunk_rows
    bptr, btab = table.block_ptr.tolist(), table.block_table.tolist()
    k0s, k1s, q0s, q1s = _spans(table, residue, n_rows)
    heavy = set() if residue is None else set(residue.heavy.tolist())
    y = np.zeros((n_rows, x.shape[1]), f32)
    for row in range(n_rows):
        if row in heavy:
            y[row] = _heavy(table, cols, vals, residue, x, row, k0s[row],
                            k1s[row], q0s[row], q1s[row],
                            plan['heavy_group'])
            continue
        i, lr = divmod(row, R)
        acc = np.zeros(x.shape[1], f32)
        for off, width, col_base, limit in btab[bptr[i]:bptr[i + 1]]:
            at = off + lr * width
            for c, v in zip(cols[at:at + width], vals[at:at + width]):
                if c < limit:
                    acc = _add(acc, v, x[col_base + c])
        for c, v in _overflow(residue, q0s[row], q1s[row]):
            acc = _add(acc, v, x[c])
        y[row] = acc
    return y


@pytest.mark.parametrize('s', WIDTHS)
@pytest.mark.parametrize('name', list(FORMATS))
def test_wide_walk_writes_every_row_once(name, s):
    """Every row written once (the heavy rows by their blocks alone), y
    within 1e-5 of the plain version in float64, and bit-equal to the
    narrow entry's order."""
    M, x = _fixture(name)
    table, cols, vals, res = _operands(M)
    xs = np.ascontiguousarray(x[:, :s])
    plan = _plan(s, 4)
    y, writes = _emulate_wide(table, cols, vals, res, xs, M.n_rows, plan)
    assert np.all(writes == 1)
    r64 = res._replace(vals=res.vals.double())
    want = ell_kernel.slot_spmm_plain(
        table, torch.from_numpy(cols), torch.from_numpy(vals).double(), r64,
        torch.from_numpy(xs).double(), M.n_rows).numpy()
    assert np.abs(y - want).max() <= 1e-5 * np.abs(want).max()
    assert np.array_equal(y, _emulate_narrow(table, cols, vals, res, xs,
                                             M.n_rows, plan))


def test_fixtures_reach_every_case():
    """Heavy rows with positions and overflow slots of several units, a
    ragged last chunk, rows with no overflow slots, and rows of more than
    32 positions (a second batch) in the narrow ELL format."""
    for name in FORMATS:
        M, _ = _fixture(name)
        table, _, _, res = _operands(M)
        k0, k1, q0, q1 = _spans(table, res, M.n_rows)
        assert res.heavy.numel() >= 3, name
        assert ((q1 - q0)[res.heavy.numpy()] > 2 * UNIT).all(), name
        assert ((q1 - q0) == 0).any(), name
    M, _ = _fixture('chunked-R700-degree')
    assert M.n_rows % M.chunk_rows
    M, _ = _fixture('ell-width40')
    assert M.ell_width > 32


@pytest.mark.parametrize('itemsize', [2, 4, 8])
def test_plan_covers_every_wide_width(itemsize):
    """G lanes a row: the fewest of 8, 16 and 32 that cover a row of 8
    pieces or more (32 with one value a lane), so no lane of a group idles
    for want of a piece below 32 pieces; the per-lane walk below 8 pieces;
    a block 8 warps of 32 / G rows; the heavy blocks' group 32 lanes from
    8 pieces up, as before the wide kernel had row groups."""
    dtype = {2: torch.bfloat16, 4: torch.float32, 8: torch.float64}[itemsize]
    first = ell_kernel.SLOT_NARROW_WIDTH[dtype] + 1
    for s in range(first, 1100):
        for aligned in (True, False):
            p = _plan(s, itemsize, aligned)
            assert p['E'] * p['nvec'] == s or not aligned or s % (
                16 // itemsize)
            if p['G'] == 0:
                assert p['nvec'] < 8 and p['heavy_group'] >= p['nvec']
                assert p['rows_per_block'] * p['heavy_group'] == THREADS
                continue
            assert p['heavy_group'] == 32
            if p['E'] > 1:
                assert p['G'] >= min(p['nvec'], 32)
                assert p['G'] == 8 or p['G'] // 2 < p['nvec']
            else:
                assert p['G'] == 32
            assert p['rows_per_block'] == WARPS * (32 // p['G'])
    # the bench graph's instances
    assert _plan(128, 4)['G'] == 32 and _plan(512, 4)['nvec'] == 128
    assert _plan(128, 2)['G'] == 16 and _plan(64, 2)['G'] == 8
    assert _plan(128, 8)['nvec'] == 64


def test_constants_match_the_source():
    """The emulation's constants and layout rule are the kernel's."""
    source = SOURCE.read_text()

    def const(name):
        return int(re.search(rf'constexpr int {name} = (\d+);',
                             source).group(1))

    assert (const('kWarps'), const('kUnit')) == (WARPS, UNIT)
    assert const('kHeavySlots') == ell_kernel.HEAVY_SLOTS
    assert ('nvec < 8 ? 0 : !vec || nvec > 16 ? 32 : nvec > 8 ? 16 : 8'
            in source)
    assert 'if (nvec >= 8) group = 32;' in source
    # both entries fork the heavy rows onto the side stream, the wide
    # kernel skips them
    assert len(re.findall(r'heavy_fork\(a, ', source)) == 2
    assert 'r.q1 - r.q0 < kHeavySlots' in source


def test_heavy_list_is_every_heavy_row_most_first():
    """The side stream's blocks: every row with at least HEAVY_SLOTS live
    overflow slots, the most first (ties by row), and no other."""
    for name in FORMATS:
        M, _ = _fixture(name)
        res = M.residue
        rowptr, entptr = res.rowptr.numpy(), res.entptr.numpy()
        slots = entptr[rowptr[1:]] - entptr[rowptr[:-1]]
        heavy = res.heavy.numpy()
        assert set(heavy) == set(np.flatnonzero(
            slots >= ell_kernel.HEAVY_SLOTS)), name
        order = list(zip(-slots[heavy], heavy))
        assert order == sorted(order), name
        assert np.array_equal(heavy, ell_kernel.heavy_rows(rowptr, entptr))


def test_wide_entry_refusals():
    """spmm_entry launches the wide entry on the card only; the wrappers
    refuse x that is not 2-D, the wrong dtype pair, and residue values of
    another dtype, at wide widths too."""
    M, x = _fixture('chunked-R1024')
    table, cols, vals, res = M.table, M.slot_cols, M.slot_vals, M.residue
    xs = torch.from_numpy(x[:, :128].copy())
    with pytest.raises(ValueError, match='cuda'):
        ell_kernel.spmm_entry('chunked_spmm', 'wide', table, cols, vals, res,
                              xs, M.n_rows)
    with pytest.raises(ValueError, match='2-D'):
        ell_kernel.chunked_spmm(table, cols, vals, res, xs[:, 0], M.n_rows)
    with pytest.raises(ValueError, match='dtype pairs'):
        ell_kernel.chunked_spmm(table, cols, vals, res, xs.double(),
                                M.n_rows)
    with pytest.raises(ValueError, match='residue values'):
        ell_kernel.chunked_spmm(table, cols, vals, res._replace(
            vals=res.vals.double()), xs, M.n_rows)
    E, _ = _fixture('ell')
    with pytest.raises(ValueError, match='dtype pairs'):
        ell_kernel.ell_spmm(E.table, E.ell_cols.reshape(-1),
                            E.ell_vals.reshape(-1).bfloat16(), E.residue,
                            xs.bfloat16(), E.n_rows)
