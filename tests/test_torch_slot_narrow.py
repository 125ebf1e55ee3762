"""The narrow entry of the ELL and chunked SpMMs (csrc/ell_spmm.cu,
``slot_narrow_kernel``), emulated warp by warp on the CPU in float64.

The kernel cannot run here, so its walk is emulated in its own summation
order: tiles of consecutive rows of one out chunk, each owner walking its
row's positions block by block through the per-block table, then its
overflow slots, in order, the heavy rows left to their blocks. ``y`` starts as NaN and every write is counted, so a row written
twice or never shows. The result is held to the plain version and to the
JAX package's ``ell_spmm`` and ``chunked_spmm_chunks`` at 1e-12; the
wrapper's choice of entry and symbol is checked without a card.
"""

import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from pygsp_tpu.core import chunked as jck
from pygsp_tpu.core import sparse as jsp
from pygsp_tpu_torch.core import chunked as tck
from pygsp_tpu_torch.core import ell_kernel
from pygsp_tpu_torch.core import sparse as tsp

from test_torch_cuda import SLOT_FORMATS, _slot_hub_graph

TOL = 1e-12
WIDTHS = (1, 3, 8, 33)
SOURCE = Path(ell_kernel.__file__).parent.parent / 'csrc' / 'ell_spmm.cu'
# the launcher's kSlotMinTiles (test_layout_constants_match_the_source)
MIN_TILES = 2048


def _layout(s, dtype):
    """``(P, L)`` as launch_slot_narrow chooses them for S columns of x's
    ``dtype``: ``P = min(16 / itemsize, next_pow2(S))`` values a lane,
    ``L = next_pow2(ceil(S / P))`` lanes a row."""
    most = 16 // dtype.itemsize
    p = 1
    while p < most and p < s:
        p *= 2
    lanes = 1
    while lanes * p < s:
        lanes *= 2
    return p, lanes


def _tile_rows(n_rows, chunk_rows, s, dtype):
    """The launcher's rows a tile (narrow_tile_rows): ``32 / L``, halved
    while the matrix has fewer than MIN_TILES tiles, down to 1."""
    tile = 32 // _layout(s, dtype)[1]

    def tiles(t):
        full, rest = divmod(n_rows, chunk_rows)
        return full * -(-chunk_rows // t) + -(-rest // t)

    while tile > 1 and tiles(tile) < MIN_TILES:
        tile //= 2
    return tile


def _with_empty_rows(n=900, seed=2):
    """Rows with no entries between power-law rows, two dense hubs (heavy
    in every format) and rows of the ragged last chunk."""
    rng = np.random.default_rng(seed)
    W = sps.random(n, n, density=6e-3, random_state=seed, format='lil')
    for h in (4, n - 3):
        W[h, ::2] = rng.uniform(0.5, 1.5, W[h, ::2].shape)
    W = sps.csr_matrix(W)
    W = W + W.T
    W.setdiag(0)
    empty = rng.choice(n, n // 5, replace=False)
    keep = np.ones(n)
    keep[empty] = 0
    W = sps.diags(keep) @ W @ sps.diags(keep)
    W.eliminate_zeros()
    return sps.csr_matrix(W)


def _hub_graph():
    """The card tests' hub graph at half their size: three hub rows of 500
    entries, heavy in every format, one in the ragged last chunk."""
    return _slot_hub_graph(n=1500, hubs=(2, 7, 1499))


# fixture -> (matrix, builder); the builder takes (W, device)
FIXTURES = {
    **{name: (_hub_graph, build) for name, build in SLOT_FORMATS.items()},
    # level 0 of width 0: every row's slots are overflow slots
    'ell-width0': (_hub_graph,
                   lambda W, device: tsp.ell_from_scipy(W, width=0,
                                                        device=device)),
    'empty-rows-ell': (_with_empty_rows,
                       lambda W, device: tsp.ell_from_scipy(
                           W, width=4, device=device)),
    'empty-rows-R128': (_with_empty_rows,
                        lambda W, device: tck.chunked_from_scipy(
                            W, chunk_rows=128, device=device)),
}
# the fixtures held to the JAX package as well (its chunked scan compiles
# per block, some seconds each)
JAX_HELD = ('ell-width8', 'chunked-R700-degree')


@functools.lru_cache(maxsize=None)
def _fixture(name):
    make, build = FIXTURES[name]
    W = make()
    M = build(W, 'cpu').astype(torch.float64)
    x = np.random.default_rng(len(name)).normal(size=(M.n_cols, max(WIDTHS)))
    return W, M, x


def _operands(M):
    if isinstance(M, tsp.ELLMatrix):
        return M.table, M.ell_cols.reshape(-1), M.ell_vals.reshape(-1), \
            M.residue
    return M.table, M.slot_cols, M.slot_vals, M.residue


@functools.lru_cache(maxsize=None)
def _jax_y(name):
    """The JAX package's y at every column of the fixture's x, in the
    port's internal order."""
    W, M, x = _fixture(name)
    if isinstance(M, tsp.ELLMatrix):
        return np.asarray(jsp.ell_spmm(jsp.ell_from_scipy(W, width=M.ell_width),
                                       jnp.asarray(x)))
    J = jck.chunked_from_scipy(W, chunk_rows=M.chunk_rows,
                               permute='degree' if M.perm is not None
                               else None)
    assert np.array_equal(np.asarray(J.rowptr), M.rowptr.numpy())
    chunks = jck.chunked_spmm_chunks(J, jck.chunk_signal(jnp.asarray(x),
                                                         M.chunk_rows))
    return np.concatenate([np.asarray(c) for c in chunks])


def _emulate(table, cols, vals, residue, x, n_rows, tile):
    """csrc/ell_spmm.cu's narrow entry, float64 instance, tile by tile (one
    warp each): each owner walks its row's positions block by block through
    the per-block table, then its overflow slots, in order. The heavy rows
    are summed by the wide kernel's heavy blocks, here by the plain sum.
    Returns y and how many times each row was written."""
    s = x.shape[1]
    _, lanes = _layout(s, torch.float64)
    assert 1 <= tile <= 32 // lanes
    R = table.chunk_rows
    cols, vals = cols.numpy(), vals.numpy()
    bptr, btab = table.block_ptr.tolist(), table.block_table.tolist()
    y = np.full((n_rows, s), np.nan)
    writes = np.zeros(n_rows, int)
    if residue is not None:
        rowptr, entptr = residue.rowptr.numpy(), residue.entptr.numpy()
        rcols, rvals = residue.cols.numpy(), residue.vals.numpy()
        want = ell_kernel.slot_spmm_plain(table, torch.from_numpy(cols),
                                          torch.from_numpy(vals), residue,
                                          torch.from_numpy(x), n_rows)
        for r in residue.heavy.tolist():
            y[r] = want[r].numpy()
            writes[r] += 1
    per_chunk = -(-R // tile)
    for w in range(-(-n_rows // R) * per_chunk):
        i, lr0 = divmod(w, per_chunk)
        lr0 *= tile
        row0 = i * R + lr0
        if row0 >= n_rows:
            continue
        for q in range(min(tile, R - lr0, n_rows - row0)):
            q0 = q1 = 0
            if residue is not None:
                q0, q1 = entptr[rowptr[row0 + q]], entptr[rowptr[row0 + q + 1]]
            if q1 - q0 >= ell_kernel.HEAVY_SLOTS:
                continue
            acc = np.zeros(s)
            for off, width, col_base, limit in btab[bptr[i]:bptr[i + 1]]:
                at = off + (lr0 + q) * width
                for c, v in zip(cols[at:at + width], vals[at:at + width]):
                    if c < limit:
                        acc = acc + v * x[col_base + c]
            for c, v in zip(rcols[q0:q1] if q1 > q0 else (),
                            rvals[q0:q1] if q1 > q0 else ()):
                acc = acc + v * x[c]
            y[row0 + q] = acc
            writes[row0 + q] += 1
    return y, writes


def _tiles(M, s):
    """The launcher's tile, the full 32 / L rows and a quarter of them."""
    _, lanes = _layout(s, torch.float64)
    chosen = _tile_rows(M.n_rows, M.table.chunk_rows, s, torch.float64)
    return sorted({chosen, 32 // lanes, max(1, 8 // lanes)})


@pytest.mark.parametrize('s', WIDTHS)
@pytest.mark.parametrize('name', list(FIXTURES))
def test_narrow_walk_writes_every_row_once(name, s):
    """Every row written once, y within 1e-12 of the plain version (and of
    the JAX package's SpMM where held), at each tile size."""
    W, M, x = _fixture(name)
    table, cols, vals, res = _operands(M)
    xs = np.ascontiguousarray(x[:, :s])
    want = ell_kernel.slot_spmm_plain(table, cols, vals, res,
                                      torch.from_numpy(xs), M.n_rows).numpy()
    scale = max(1.0, np.abs(want).max())
    if name in JAX_HELD:
        assert np.abs(want - _jax_y(name)[:, :s]).max() <= TOL * scale
    for tile in _tiles(M, s):
        y, writes = _emulate(table, cols, vals, res, xs, M.n_rows, tile)
        assert np.all(writes == 1), tile
        assert np.abs(y - want).max() <= TOL * scale, tile


def test_fixtures_reach_every_case():
    """The fixtures hold what the walk must handle: heavy rows, a ragged
    last chunk, a block table with chunks of several blocks, a level 0 of
    width 0, empty rows and rows whose slots all overflow."""
    _, M, _ = _fixture('chunked-R700-degree')
    assert M.n_rows % M.chunk_rows and M.residue.heavy.numel() >= 3
    assert (M.table.block_ptr.diff() > 1).all()
    _, M, _ = _fixture('ell-width0')
    assert M.table.block_table.shape == (0, 4)
    assert (M.residue.rowptr.diff() > 0).all()
    _, M, _ = _fixture('empty-rows-R128')
    per_row = M.rowptr.diff()
    assert (per_row == 0).sum() > 100 and M.residue.heavy.numel() >= 2


def test_block_table_lists_each_chunks_blocks():
    """The per-block table: each out chunk's blocks of nonzero width, in
    the order the chunk sums them, as (offset, width, col_base, limit)."""
    for name in ('chunked-R1024', 'chunked-R700-degree', 'ell-width0'):
        _, M, _ = _fixture(name)
        t = M.table
        want = [[] for _ in range(t.chunk_ptr.numel() - 1)]
        for i, off, width, col_base, limit in t.blocks:
            if width:
                want[i].append([off, width, col_base, limit])
        ptr = t.block_ptr.tolist()
        assert ptr[0] == 0 and ptr[-1] == t.block_table.shape[0]
        for i, blocks in enumerate(want):
            assert t.block_table[ptr[i]:ptr[i + 1]].tolist() == blocks


def test_entry_and_symbol_by_width_and_dtype():
    """The wrappers' rule: the narrow entry up to SLOT_NARROW_WIDTH columns
    of x's dtype, the wide one above, and the symbol of each operand pair;
    every symbol is an instance in the source."""
    source = SOURCE.read_text()
    instances = set(re.findall(r'^SLOT_(?:SPMM|NARROW)\((\w+),', source,
                               re.M))
    pairs = [('ell_spmm', p) for p in ell_kernel.ELL_OPERANDS] + [
        ('chunked_spmm', p) for p in ell_kernel.CHUNKED_OPERANDS]
    for kind, (xd, vd) in pairs:
        widest = ell_kernel.SLOT_NARROW_WIDTH[xd]
        assert widest > 0 and _layout(widest, xd)[1] <= 32
        for s, entry in ((1, 'narrow'), (widest, 'narrow'),
                         (widest + 1, 'wide'), (512, 'wide')):
            assert ell_kernel.entry_for(s, xd) == entry
            name = ell_kernel.symbol(kind, entry, xd, vd)
            assert name in instances
            assert ('_narrow_' in name) == (entry == 'narrow')
    assert ell_kernel.symbol('chunked_spmm', 'narrow', torch.bfloat16,
                             torch.float32) == 'chunked_spmm_narrow_bf16_f32'
    assert len(instances) == 14


def test_heavy_threshold_matches_the_source():
    """The emulation's heavy rows are the kernel's."""
    heavy = re.search(r'kHeavySlots = (\d+);', SOURCE.read_text())
    assert int(heavy.group(1)) == ell_kernel.HEAVY_SLOTS


def test_layout_constants_match_the_source():
    """The emulation's tile rule is the launcher's: its kSlotMinTiles, a
    16-byte access and 32 lanes at most a row."""
    source = SOURCE.read_text()
    assert int(re.search(r'kSlotMinTiles = (\d+);', source).group(1)) == \
        MIN_TILES
    assert 'constexpr int kV = 16 / sizeof(T);' in source
    assert 'lanes > 32' in source


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_narrow_layout_and_tile(dtype):
    """P values a lane (at most 16 bytes), L lanes a slot covering S, a
    tile of 32 / L rows halved on small matrices; the widest S that fits
    32 lanes."""
    most = 16 // dtype.itemsize
    widest = 32 * most
    for s in range(1, widest + 1):
        p, lanes = _layout(s, dtype)
        assert p == min(most, 1 << (s - 1).bit_length())
        assert lanes * p >= s and (lanes == 1 or (lanes // 2) * p < s)
        assert lanes <= 32
    assert _layout(widest + 1, dtype)[1] == 64
    R = tck.CHUNK_ROWS
    assert _tile_rows(1 << 20, R, 1, dtype) == 32
    assert _tile_rows(2642, 2642, 1, dtype) == 1
    assert _tile_rows(1 << 16, 1 << 16, 1, dtype) == 32
    for n in (1, 700, 3000, 65_536, 100_000):
        t = _tile_rows(n, min(n, R), 8, dtype)
        full = 32 // _layout(8, dtype)[1]
        assert 1 <= t <= full and full % t == 0
        if t > 1:
            assert -(-n // t) >= MIN_TILES


def test_narrow_entry_refuses_cpu_and_unknown_entries():
    """spmm_entry launches on the card only, and only the two entries."""
    _, M, x = _fixture('ell-width8')
    with pytest.raises(ValueError, match='cuda'):
        ell_kernel.spmm_entry('ell_spmm', 'narrow', *_operands(M),
                              torch.from_numpy(x), M.n_rows)
    with pytest.raises(ValueError, match='dtype pairs'):
        ell_kernel.spmm_entry('ell_spmm', 'wide', *_operands(M),
                              torch.from_numpy(x).float(), M.n_rows)
