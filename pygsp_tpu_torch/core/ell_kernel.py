"""The ELL and chunked SpMMs, with their plain version.

Two CUDA kernels live in ``csrc/ell_spmm.cu`` (see its note for the
design); both compute ``y = A @ x`` for x (n_cols, S) from dense slot blocks
plus a list of overflow entries, and both take the place of XLA
compositions (the JAX package has no Pallas kernel for either):

- :func:`ell_spmm`: the multi-level ELL format
  (:class:`~pygsp_tpu_torch.core.sparse.ELLMatrix`), for
  ``pygsp_tpu/core/sparse.py:411-420``: level 0 a gather-sum of every
  row's ``ell_width`` slots, then each overflow level added to its unique
  rows;
- :func:`chunked_spmm`: the chunked format
  (:class:`~pygsp_tpu_torch.core.chunked.ChunkedELLMatrix`), for
  ``pygsp_tpu/core/chunked.py:206-250``: per output chunk the gather-sums
  of its (out, src) blocks, then the overflow tiers scatter-added onto
  ``level_rows``, in which rows repeat.

Both formats hand the kernel the same two operands:

- a :class:`SlotTable`: per output chunk, its slot positions. Row ``lr`` of
  out chunk ``i`` reads, at position ``k`` of ``[chunk_ptr[i],
  chunk_ptr[i + 1])``, the slot ``base + lr · stride`` of the flat slot
  arrays; the slot is live iff its column is below ``limit`` (the
  format's sentinel is ``limit`` itself), and then reads x row ``col_base
  + col``. A block of the chunked format is ``width`` positions, one per
  slot column, in ``block_keys`` order (ascending source chunk); the ELL
  format's level 0 is one block of ``ell_width`` positions;
- the overflow levels as one list sorted by output row, the windowed
  tail's :class:`~.windowed_kernel.Residue` made by the same builder
  (:func:`~pygsp_tpu_torch.core.chunked._flat_residue`). Here its
  ``heavy`` field lists the rows with at least :data:`HEAVY_SLOTS` live
  overflow slots (the most first), each of which the kernel gives a block
  of its own.

Each output row has one owner, which sums its positions in order and then
its overflow slots in order, in float32 (float64 for float64) and writes
the row once, in x's dtype: two launches are bit-equal. Products are
formed in the promotion of x's and the values' dtypes, so a bfloat16 ·
bfloat16 product rounds to bfloat16, as the JAX package forms it.

Each kernel has two entries. The wide one (``ell_spmm_f32``, ...) gives
each row a group of 8, 16 or 32 lanes (the fewest that cover its 16-byte
pieces, so rows of 128 bf16 columns share a warp two by two) that reads
the row's first 32 slot positions through the slot table and its first
32 overflow slots at once, then gathers the live ones in rounds that run
from the positions into the overflow slots; the heavy rows' blocks run on
a side stream beside it (below 8 pieces a row they lead its grid). The
narrow one (``ell_spmm_narrow_f32``,
``chunked_spmm_narrow_<pair>``) gives a warp a tile of consecutive rows
of one out chunk, ``L`` lanes a row and ``P`` values a lane (the launcher
in csrc/ell_spmm.cu chooses both and the tile): the warp reads the chunk's
blocks from the per-block table of :class:`SlotTable` once, and each row's
lanes walk its slots where the format keeps them, then its overflow slots,
with no table entry read per slot. Both entries sum a row in the same
order, so they give the same bits. Each wrapper picks the entry by ``(S,
dtype)`` alone (:func:`entry_for`, from :data:`SLOT_NARROW_WIDTH`).

Each wrapper launches its kernel for CUDA tensors and runs
:func:`slot_spmm_plain` for CPU tensors; there is no fallback from one to
the other. Each counts its launches, of both entries, in ``.launches``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pygsp_tpu_torch.core import _cuda
from pygsp_tpu_torch.core.windowed_kernel import Residue

_SOURCE = 'ell_spmm'
# (x dtype, values dtype) -> the kernels' suffix: the ELL format takes the
# exact modes (the JAX package refuses the bf16 modes on hybrid); the
# chunked one also the three bf16 pairs of the windowed fold
_ELL_TYPES = {(torch.float32, torch.float32): 'f32',
              (torch.float64, torch.float64): 'f64'}
_CHUNKED_TYPES = {**_ELL_TYPES,
                  (torch.bfloat16, torch.float32): 'bf16_f32',
                  (torch.bfloat16, torch.bfloat16): 'bf16',
                  (torch.float32, torch.bfloat16): 'f32_bf16'}
ELL_OPERANDS = frozenset(_ELL_TYPES)
CHUNKED_OPERANDS = frozenset(_CHUNKED_TYPES)

# A row with at least this many live overflow slots is summed by a block of
# its own (kHeavySlots in csrc/ell_spmm.cu, the same number: the kernel's
# row blocks skip such a row).
HEAVY_SLOTS = 256
# The widest S, by x's dtype, that takes the narrow entry; wider S takes
# the wide one (:func:`entry_for`). On an H100 (tools/slot_narrow_sweep.py,
# PERF.md) the narrow entry was the faster on path H's and path I's graphs
# at every f32 and f64 width up to 32 (at 48 f32 on path I the two tie);
# with bf16 x it was the faster at one column, and at 8 with bf16 values
# the slower. The narrow kernel takes at most 32 lanes of 16 bytes a row;
# its launcher refuses wider S.
SLOT_NARROW_WIDTH = {torch.float32: 32, torch.float64: 32,
                     torch.bfloat16: 1}
# The plain version's rows and overflow slots per pass, which bound its
# (rows, width, S) products on the card.
_PLAIN_ROWS = 1 << 14
_PLAIN_SLOTS = 1 << 20


class SlotTable(NamedTuple):
    """The dense slot blocks of a matrix as the kernel walks them (see the
    module docstring): per out chunk its slot positions (the wide entry's
    table) and its blocks (the narrow entry's). ``blocks`` holds, per
    block, the host ints ``(out_chunk, offset, width, col_base, limit)``
    that the table was made from, which the plain version reads."""
    chunk_ptr: torch.Tensor   # (n_out + 1,) int32
    pos: torch.Tensor         # (n_pos, 4) int64: base, stride, col_base, limit
    block_ptr: torch.Tensor   # (n_out + 1,) int32
    block_table: torch.Tensor  # (n_blk, 4) int64: off, width, col_base, limit
    blocks: tuple
    chunk_rows: int


def slot_table(blocks, n_out: int, chunk_rows: int, device) -> SlotTable:
    """The :class:`SlotTable` of ``blocks``, a sequence of ``(out_chunk,
    offset, width, col_base, limit)`` in the order each out chunk sums
    them. The per-block table keeps each out chunk's blocks of nonzero
    width in that order."""
    blocks = tuple(tuple(int(v) for v in b) for b in blocks)
    pos = [[] for _ in range(n_out)]
    per_chunk = [[] for _ in range(n_out)]
    for i, off, width, col_base, limit in blocks:
        pos[i].extend([off + j, width, col_base, limit] for j in range(width))
        if width:
            per_chunk[i].append([off, width, col_base, limit])

    def table(rows):
        ptr = np.zeros(n_out + 1, np.int32)
        np.cumsum([len(r) for r in rows], out=ptr[1:])
        flat = np.array([q for r in rows for q in r], np.int64).reshape(-1, 4)
        return torch.from_numpy(ptr).to(device), torch.from_numpy(flat).to(
            device)

    chunk_ptr, flat = table(pos)
    block_ptr, block_table = table(per_chunk)
    return SlotTable(chunk_ptr=chunk_ptr, pos=flat, block_ptr=block_ptr,
                     block_table=block_table, blocks=blocks,
                     chunk_rows=int(chunk_rows))


def heavy_rows(rowptr: np.ndarray, entptr: np.ndarray) -> np.ndarray:
    """The rows of a residue list with at least :data:`HEAVY_SLOTS` live
    slots, the most slots first (ties by row)."""
    slots = entptr[rowptr[1:]] - entptr[rowptr[:-1]]
    heavy = np.flatnonzero(slots >= HEAVY_SLOTS)
    return heavy[np.argsort(-slots[heavy], kind='stable')]


def entry_for(s: int, dtype) -> str:
    """The entry the wrappers take for S columns of x's ``dtype``:
    ``'narrow'`` up to :data:`SLOT_NARROW_WIDTH`, else ``'wide'``."""
    return 'narrow' if 0 < s <= SLOT_NARROW_WIDTH[dtype] else 'wide'


# (kind, entry, x dtype, values dtype) -> the C symbol
_SYMBOLS = {(kind, entry, xd, vd): (f'{kind}_narrow_{suffix}'
                                    if entry == 'narrow'
                                    else f'{kind}_{suffix}')
            for kind, types in (('ell_spmm', _ELL_TYPES),
                                ('chunked_spmm', _CHUNKED_TYPES))
            for (xd, vd), suffix in types.items()
            for entry in ('narrow', 'wide')}


def symbol(kind: str, entry: str, x_dtype, vals_dtype) -> str:
    """The C symbol of ``kind`` (``'ell_spmm'`` or ``'chunked_spmm'``) and
    ``entry`` (``'narrow'`` or ``'wide'``) for the operand pair, e.g.
    ``chunked_spmm_narrow_bf16_f32``."""
    return _SYMBOLS[kind, entry, x_dtype, vals_dtype]


def _sum_dtype(dtype):
    return torch.promote_types(dtype, torch.float32)


def slot_spmm_plain(table: SlotTable, cols, vals, residue, x, n_rows: int):
    """Plain PyTorch version of both kernels: per block, the live slots'
    products ``vals · x[col_base + col]`` (in the promotion of the two
    dtypes) summed per row in float32 or wider; then the residue's products
    ``index_add_``-ed onto their rows; ``y`` rounded once to x's dtype. Dead
    slots are masked, and x is not read for them. Counts its calls in
    ``.calls``."""
    slot_spmm_plain.calls += 1
    acc = _sum_dtype(x.dtype)
    dev = x.device
    R = table.chunk_rows
    y = torch.zeros((n_rows, x.shape[1]), dtype=acc, device=dev)
    zero = torch.zeros((), dtype=acc, device=dev)
    for i, off, width, col_base, limit in table.blocks:
        r0, r1 = i * R, min((i + 1) * R, n_rows)
        for a in range(r0, r1, _PLAIN_ROWS) if width else ():
            b = min(a + _PLAIN_ROWS, r1)
            q = off + (a - r0) * width
            c = cols[q:q + (b - a) * width].reshape(b - a, width).long()
            v = vals[q:q + (b - a) * width].reshape(b - a, width)
            live = c < limit
            p = (v[..., None] * x[col_base + torch.where(live, c, 0)]).to(acc)
            y[a:b] += torch.where(live[..., None], p, zero).sum(dim=1)
    if residue is not None:
        per_row = (residue.entptr[residue.rowptr[1:].long()]
                   - residue.entptr[residue.rowptr[:-1].long()]).long()
        n_slots = residue.cols.numel()
        row = torch.repeat_interleave(torch.arange(n_rows, device=dev),
                                      per_row, output_size=n_slots)
        for a in range(0, n_slots, _PLAIN_SLOTS):
            sl = slice(a, a + _PLAIN_SLOTS)
            p = residue.vals[sl, None] * x[residue.cols[sl].long()]
            y.index_add_(0, row[sl], p.to(acc))
    return y.to(x.dtype)


slot_spmm_plain.calls = 0


def _check(name, types, table, cols, vals, residue, x, n_rows):
    if x.ndim != 2:
        raise ValueError(f'{name}: x must be 2-D (n_cols, S), got '
                         f'{tuple(x.shape)}')
    if (x.dtype, vals.dtype) not in types:
        raise ValueError(f'{name} takes x and values of the dtype pairs '
                         f'{sorted(v for v in types.values())}, got '
                         f'{x.dtype} and {vals.dtype}')
    if cols.dtype != torch.int32 or cols.shape != vals.shape or cols.ndim != 1:
        raise ValueError(f'{name}: cols must be int32, 1-D, of the values\' '
                         f'shape')
    if any(ptr.dtype != torch.int32 or t.dtype != torch.int64
           or t.ndim != 2 or t.shape[1] != 4
           or ptr.shape != table.chunk_ptr.shape
           for ptr, t in ((table.chunk_ptr, table.pos),
                          (table.block_ptr, table.block_table))):
        raise ValueError(f'{name}: the slot table takes int32 chunk_ptr and '
                         f'block_ptr, and (n, 4) int64 positions and blocks')
    if n_rows > (table.chunk_ptr.numel() - 1) * table.chunk_rows:
        raise ValueError(f'{name}: {table.chunk_ptr.numel() - 1} out chunks '
                         f'of {table.chunk_rows} rows do not hold {n_rows}')
    tensors = [table.chunk_ptr, table.pos, table.block_ptr,
               table.block_table, cols, vals, x]
    if residue is not None:
        index = (residue.rowptr, residue.entptr, residue.cols, residue.heavy)
        if any(a.dtype != torch.int32 or a.ndim != 1 for a in index):
            raise ValueError(f'{name}: the residue list takes 1-D int32 '
                             f'index vectors')
        if residue.rowptr.numel() != n_rows + 1:
            raise ValueError(f'{name}: the residue list does not fit '
                             f'{n_rows} rows')
        if residue.vals.dtype != vals.dtype:
            raise ValueError(f'{name}: the residue values must have the '
                             f'slots\' dtype {vals.dtype}')
        tensors += [*index, residue.vals]
    dev = x.device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f'{name}: all operands must be on one device')
        if not t.is_contiguous():
            raise ValueError(f'{name}: all operands must be contiguous')
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'{name} runs on cuda or cpu, not {x.device}')


def spmm_entry(kind: str, entry: str, table: SlotTable, cols, vals,
               residue: Residue | None, x, n_rows: int):
    """One launch of ``kind``'s kernel (``'ell_spmm'`` or
    ``'chunked_spmm'``) through ``entry`` (``'narrow'`` or ``'wide'``) on
    CUDA operands: what the wrappers launch with :func:`entry_for`'s entry,
    here for the measurements and tests that hold the two entries against
    each other. Counts nothing."""
    _check(kind, _ELL_TYPES if kind == 'ell_spmm' else _CHUNKED_TYPES,
           table, cols, vals, residue, x, n_rows)
    if x.device.type != 'cuda' or entry not in ('narrow', 'wide'):
        raise ValueError(f'spmm_entry launches the narrow or wide entry on '
                         f'cuda, not {entry!r} on {x.device}')
    return _run(kind, entry, table, cols, vals, residue, x, n_rows)


def _run(kind, entry, table, cols, vals, residue, x, n_rows):
    residue_ops = (() if residue is None
                   else (residue.rowptr, residue.entptr, residue.cols,
                         residue.vals))
    _cuda.refuse_autograd(kind, vals, x, *residue_ops)
    s = x.shape[1]
    y = torch.empty((n_rows, s), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    if residue is None:
        lists, n_heavy = (0,) * 5, 0
    else:
        lists = tuple(t.data_ptr() for t in residue_ops + (residue.heavy,))
        n_heavy = residue.heavy.numel()
    tables = ((table.chunk_ptr.data_ptr(), table.pos.data_ptr(),
               table.block_ptr.data_ptr(), table.block_table.data_ptr())
              if entry == 'narrow'
              else (table.chunk_ptr.data_ptr(), table.pos.data_ptr()))
    _cuda.launch(_SOURCE, _SYMBOLS[kind, entry, x.dtype, vals.dtype],
                 len(tables) + 9, 4, x.get_device(), *tables,
                 cols.data_ptr(), vals.data_ptr(), *lists, x.data_ptr(),
                 y.data_ptr(), n_rows, s, table.chunk_rows, n_heavy)
    return y


def ell_spmm(table: SlotTable, cols, vals, residue: Residue | None, x,
             n_rows: int):
    """``y (n_rows, S)`` of an ELL matrix for x (n_cols, S): ``table`` its
    level 0 as one block over ``cols``/``vals`` (the flat
    ``ell_cols``/``ell_vals``), ``residue`` its overflow levels. float32 or
    float64, one dtype."""
    _check('ell_spmm', _ELL_TYPES, table, cols, vals, residue, x, n_rows)
    if x.device.type == 'cpu':
        return slot_spmm_plain(table, cols, vals, residue, x, n_rows)
    y = _run('ell_spmm', entry_for(x.shape[1], x.dtype), table, cols, vals,
             residue, x, n_rows)
    ell_spmm.launches += 1
    return y


ell_spmm.launches = 0


def chunked_spmm(table: SlotTable, cols, vals, residue: Residue | None, x,
                 n_rows: int):
    """``y (n_rows, S)`` of a chunked matrix for x (n_cols, S), in its
    internal order: ``table`` its blocks over the flat slot arrays
    ``cols``/``vals``, ``residue`` its overflow tiers. The exact modes and
    the bf16 pairs of :data:`CHUNKED_OPERANDS`; ``y`` in x's dtype."""
    _check('chunked_spmm', _CHUNKED_TYPES, table, cols, vals, residue, x,
           n_rows)
    if x.device.type == 'cpu':
        return slot_spmm_plain(table, cols, vals, residue, x, n_rows)
    y = _run('chunked_spmm', entry_for(x.shape[1], x.dtype), table, cols,
             vals, residue, x, n_rows)
    chunked_spmm.launches += 1
    return y


chunked_spmm.launches = 0

KERNELS = (ell_spmm, chunked_spmm)
