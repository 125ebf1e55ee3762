"""The windowed-compact SpMM kernels and the one-hot fold, with their plain
versions.

The CUDA kernels live in ``csrc/windowed_fold.cu`` (see its note for the
design):

- :func:`windowed_fold`: gather, product and one-hot fold of every window
  of a :class:`~pygsp_tpu_torch.core.windowed.WindowedELLMatrix` into the
  window tensor ``t (n_out, NW, K·P, S)``: the fold of TPU kernel #2
  (``benchmarks/pallas_fold_probe.py:make_pallas_fold``) fused with the
  slot gather of ``pygsp_tpu/core/windowed.py:298-303``. Besides float32
  and float64 it takes the bf16 operands of the recurrence's fast modes
  (:data:`FOLD_OPERANDS`), with float32 sums: #2's own regime;
- :func:`window_strip`: the windowed SpMM's tail, the overlap-add of ``t``
  into ``y (n_rows, S)`` (``pygsp_tpu/core/windowed.py:336-345``) with the
  residue tiers folded in (``:406-414``: one row-sorted list,
  :class:`Residue`), bf16 included;
- :func:`windowed_fold_multi`: the fold of several matrices' slabs, each
  against its own x, into one window tensor, the fused multi-matrix SpMM of
  ``pygsp_tpu/core/windowed.py:windowed_spmm_chunks_multi`` (``:201-418``);
  its tail is one :func:`window_strip` over every matrix's residue list
  (:func:`merge_residues`);
- :func:`fold_strip_multi`: that fused SpMM in one launch, fold and strip
  together, writing ``y`` and no window tensor (bit-equal to the two
  launches); the route of
  :func:`~pygsp_tpu_torch.core.windowed.spmm_multi_internal`;
- :func:`fold_products`: #2's function as it stands, ``rid (NW, Lt)`` and
  products ``p (NW, Lt, S)`` in, ``(NW, KP, S)`` float32 out; at NW = 1 it
  is TPU kernel #3 (``benchmarks/pallas_smoke.py`` ``fold_kernel``);
- :func:`double`: ``y = 2·x``, TPU kernel #4 (``pallas_smoke.py``
  ``dbl_kernel``), the toolchain canary.

Each wrapper launches its kernel for CUDA tensors and runs the plain
version beside it for CPU tensors; there is no fallback from one to the
other. Each counts its launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from pygsp_tpu_torch.core import _cuda

_SOURCE = 'windowed_fold'
_DTYPES = {torch.float32: 'f32', torch.float64: 'f64',
           torch.bfloat16: 'bf16'}
# windowed_fold's (x dtype, vals dtype) pairs, by their kernels' suffix: the
# exact modes, then a bf16 carry (x) alone, both, and bf16 values alone. The
# window tensor is written in x's dtype; products are formed in the two
# dtypes' promotion (bf16·bf16 rounds to bf16) and summed in float32 (in
# float64 for float64 x).
_FOLD_TYPES = {(torch.float32, torch.float32): 'f32',
               (torch.float64, torch.float64): 'f64',
               (torch.bfloat16, torch.float32): 'bf16_f32',
               (torch.bfloat16, torch.bfloat16): 'bf16',
               (torch.float32, torch.bfloat16): 'f32_bf16'}
FOLD_OPERANDS = frozenset(_FOLD_TYPES)
_ROWIDS = {torch.uint8: 'u8', torch.int32: 'i32'}
_PRODUCTS = {torch.bfloat16: 'bf16', torch.float32: 'f32'}

# Shared memory on an SM (228 KiB), the most one block may ask for, and
# the bytes the fold's (K·P, S_tile) accumulator may take: S_tile is the
# largest power of two up to 128 that fits, so K·P = 512 in float32 folds
# 64 columns at a time and float64 halves that again.
SMEM_PER_SM = 233_472
SMEM_PER_BLOCK = 232_448
ACC_BYTES = 128 * 1024
_MAX_TILE = 128
# The fold kernel's ring of x rows is cut into this many parts, and its
# producer warp stages this many raw slots at a time (kGroups and kRound in
# csrc/windowed_fold.cu); x rows in flight per SM it aims for.
RING_GROUPS = 8
STAGE_ROUND = 128
_RING_BYTES_PER_SM = 64 * 1024
_RING_ROWS = (16, 256)
# Shared bytes that the kernel's fold_smem_bytes counts beside the
# accumulator and the ring: two 8-byte mbarriers and a 4-byte count per
# ring part; per queue entry, a slot (offset and value, padded to two
# values) and its 4-byte x row (tests/test_torch_cuda.py holds the sum to
# the kernel's)
_PART_BYTES = 2 * 8 + 4
# fold_products' block: slots per stage, columns of S, stages in its ring,
# and the bf16 pitch of a split plane's row (kProdK, kProdN, kProdStages
# and kProdPitch in csrc/windowed_fold.cu); the card's SMs; the grid's
# limits in x and y
PRODUCTS_K = 32
PRODUCTS_N = 128
PRODUCTS_STAGES = 4
PRODUCTS_PITCH = PRODUCTS_N + 8
SMS = 132
_GRID_X = 2**31 - 1
_GRID_Y = 65_535


class FoldLayout(NamedTuple):
    """Shared-memory layout of one :func:`windowed_fold` block."""
    s_tile: int      # columns of S per block, one folding thread each
    ring: int        # x rows in the ring (a multiple of RING_GROUPS)
    queue: int       # live-slot queue entries (a power of two)
    smem_bytes: int  # mbarriers + part counts + accumulator + ring + queue


def _s_tile(kp: int, s: int, itemsize: int) -> int:
    """The S tile of a fold with ``kp`` accumulator rows of
    ``itemsize``-byte sums, one folding thread per column: the widest power
    of two up to 128 whose accumulator fits ``ACC_BYTES``, no wider than S
    rounded up to a warp. Raises if not even one column fits."""
    tile = _MAX_TILE
    while tile > 1 and kp * tile * itemsize > ACC_BYTES:
        tile //= 2
    if kp * tile * itemsize > ACC_BYTES:
        raise ValueError(f'a fold over {kp} rows does not fit the '
                         f'{ACC_BYTES}-byte shared accumulator')
    return min(tile, max(32, -(-s // 32) * 32))


def fold_layout(kp: int, s: int, itemsize: int,
                ring_itemsize: int | None = None,
                multi: bool = False) -> FoldLayout:
    """The :func:`windowed_fold` block layout for ``kp`` accumulator rows
    of ``itemsize``-byte sums, S = ``s`` and x rows of
    ``ring_itemsize``-byte values (by default ``itemsize``; 2 for a bf16 x
    folded into float32 sums): the accumulator, a ring deep enough to keep
    64 KB of x rows in flight per SM (two blocks share an SM when the
    accumulator takes at most half of ``ACC_BYTES``), and a queue of live
    slots, whose values are held in the sums' type, that outlasts the ring
    plus one staging round (with ``multi``, :func:`windowed_fold_multi`'s,
    whose queue entries also hold their matrix, 4 bytes). Raises if not
    even one column of the accumulator fits."""
    ring_itemsize = ring_itemsize or itemsize
    tile = _s_tile(kp, s, itemsize)
    acc = kp * tile * itemsize
    blocks_per_sm = 2 if 2 * acc <= ACC_BYTES else 1
    want = _RING_BYTES_PER_SM // blocks_per_sm // (tile * ring_itemsize)
    ring = min(max(1 << max(want, 1).bit_length() - 1, _RING_ROWS[0]),
               _RING_ROWS[1])
    queue = 1 << (ring + STAGE_ROUND - 1).bit_length()
    smem = (_PART_BYTES * RING_GROUPS + acc + ring * tile * ring_itemsize
            + queue * (2 * itemsize + 4 + (4 if multi else 0)))
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f'a fold over {kp} rows needs {smem} bytes of '
                         f'shared memory, more than {SMEM_PER_BLOCK}')
    return FoldLayout(tile, ring, queue, smem)


def _check_operands(name, tensors, x):
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f'{name}: all operands must be on one device')
        if not t.is_contiguous():
            raise ValueError(f'{name}: all operands must be contiguous')
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'{name} runs on cuda or cpu, not {x.device}')


# ---------------------------------------------------------------------------
# (a) windowed_fold
# ---------------------------------------------------------------------------

def _sum_dtype(dtype):
    """The dtype sums of ``dtype`` values are taken in: float32 at least."""
    return torch.promote_types(dtype, torch.float32)


def windowed_fold_plain(cols, vals, rowid, x, chunk_rows: int, kp: int):
    """Plain PyTorch version of :func:`windowed_fold`: per out chunk, the
    slot products ``vals · x[c·R + cols]`` (in the two dtypes' promotion)
    and an ``index_add_`` of them, in float32 or wider, onto their window
    rows. Dead slots (sentinel column, row id out of range) add nothing and
    x is not read for them."""
    return _fold_sums(cols, vals, rowid, x, chunk_rows, kp).to(x.dtype)


def _fold_sums(cols, vals, rowid, x, chunk_rows: int, kp: int):
    """:func:`windowed_fold_plain` before its window tensor is rounded to
    x's dtype: the sums, float32 or wider."""
    n_out, nw, n_src, _ = cols.shape
    n_cols, s = x.shape
    dev = x.device
    sdt = _sum_dtype(x.dtype)
    base = (torch.arange(n_src, device=dev) * chunk_rows)[:, None]
    win = (torch.arange(nw, device=dev) * kp)[:, None, None]
    t = torch.zeros((n_out, nw * kp, s), dtype=sdt, device=dev)
    for i in range(n_out):
        rid = rowid[i].long()
        row = base + cols[i].long()                         # (nw, n_src, L)
        live = (cols[i] < chunk_rows) & (row < n_cols) & (rid < kp)
        p = (vals[i][..., None] * x[torch.where(live, row, 0)]).to(sdt)
        p = torch.where(live[..., None], p, torch.zeros((), dtype=sdt,
                                                        device=dev))
        t[i].index_add_(0, (win + torch.where(live, rid, 0)).reshape(-1),
                        p.reshape(-1, s))
    return t.reshape(n_out, nw, kp, s)


def _check_fold(cols, vals, rowid, x, chunk_rows, kp):
    if x.ndim != 2 or cols.ndim != 4:
        raise ValueError(f'windowed_fold takes 4-D slabs and a 2-D x, got '
                         f'{tuple(cols.shape)} and {tuple(x.shape)}')
    if (x.dtype, vals.dtype) not in _FOLD_TYPES:
        raise ValueError(f'windowed_fold takes float32 or float64 vals and x '
                         f'of one dtype, or bfloat16 for either beside '
                         f'float32 ones, got {vals.dtype} and {x.dtype}')
    if cols.dtype != torch.int32 or rowid.dtype not in _ROWIDS:
        raise ValueError(f'windowed_fold takes int32 cols and uint8 or int32 '
                         f'row ids, got {cols.dtype} and {rowid.dtype}')
    if vals.shape != cols.shape or rowid.shape != cols.shape:
        raise ValueError('cols, vals and rowid must have one shape')
    n_src = cols.shape[2]
    if not (n_src - 1) * chunk_rows < max(x.shape[0], 1) <= n_src * chunk_rows:
        raise ValueError(f'{n_src} source chunks of {chunk_rows} rows do not '
                         f'cover x of {x.shape[0]} rows')
    if kp < 1:
        raise ValueError(f'kp must be positive, got {kp}')
    _check_operands('windowed_fold', (cols, vals, rowid, x), x)


def windowed_fold(cols, vals, rowid, x, chunk_rows: int, kp: int):
    """The window tensor ``t (n_out, NW, kp, S)`` of the slabs ``cols``,
    ``vals``, ``rowid`` (n_out, NW, n_src, L) and x (n_cols, S)::

        t[i, w, r, :] = Σ_{c, l: rowid[i,w,c,l] = r} vals[i,w,c,l]
                                                  · x[c·R + cols[i,w,c,l], :]

    with ``R = chunk_rows``; slots whose column is the sentinel ``R`` (or
    lies past x) are skipped. ``t`` has x's dtype; each product is formed
    in the promotion of the two dtypes (a bfloat16·bfloat16 product rounds
    to bfloat16, as in the JAX package's fold) and the sums are taken in
    float32, or float64 for float64 operands."""
    _check_fold(cols, vals, rowid, x, chunk_rows, kp)
    if x.device.type == 'cpu':
        return windowed_fold_plain(cols, vals, rowid, x, chunk_rows, kp)
    _cuda.refuse_autograd('windowed_fold', cols, vals, rowid, x)
    n_out, nw, n_src, L = cols.shape
    s = x.shape[1]
    t = torch.empty((n_out, nw, kp, s), dtype=x.dtype, device=x.device)
    if t.numel() == 0:
        return t
    lay = fold_layout(kp, s, torch.finfo(_sum_dtype(x.dtype)).bits // 8,
                      x.element_size())
    symbol = (f'windowed_fold_{_FOLD_TYPES[x.dtype, vals.dtype]}_'
              f'{_ROWIDS[rowid.dtype]}')
    _cuda.launch(_SOURCE, symbol, 5, 10, x.get_device(), cols.data_ptr(),
                 vals.data_ptr(), rowid.data_ptr(), x.data_ptr(),
                 t.data_ptr(), n_out * nw, n_src, L, chunk_rows, kp,
                 x.shape[0], s, lay.s_tile, lay.ring, lay.queue)
    windowed_fold.launches += 1
    return t


windowed_fold.launches = 0


# The most matrices one multi-matrix fold takes (kMaxMats in
# csrc/windowed_fold.cu: the kernel's parameter table).
MAX_MATS = 16


def windowed_fold_multi_plain(slabs, xs, chunk_rows: int, kp: int):
    """Plain version of :func:`windowed_fold_multi`: the sum over the
    matrices of :func:`windowed_fold_plain`'s sums, in float32 or wider,
    rounded once to x's dtype."""
    t = None
    for (cols, vals, rowid), x in zip(slabs, xs):
        tm = _fold_sums(cols, vals, rowid, x, chunk_rows, kp)
        t = tm if t is None else t + tm
    return t.to(xs[0].dtype)


def _check_fold_multi(slabs, xs, chunk_rows, kp):
    if not 0 < len(slabs) == len(xs) <= MAX_MATS:
        raise ValueError(f'windowed_fold_multi takes 1 to {MAX_MATS} '
                         f'matrices, each with its x, got {len(slabs)} and '
                         f'{len(xs)}')
    (c0, v0, r0), x0 = slabs[0], xs[0]
    for (cols, vals, rowid), x in zip(slabs, xs):
        _check_fold(cols, vals, rowid, x, chunk_rows, kp)
        if ((x.dtype, vals.dtype, rowid.dtype)
                != (x0.dtype, v0.dtype, r0.dtype)
                or cols.shape[:2] != c0.shape[:2]
                or x.shape[1] != x0.shape[1] or x.device != x0.device):
            raise ValueError('windowed_fold_multi: the matrices must share '
                             'their operand dtypes, their out chunking '
                             '(n_out, NW), S and the device')


def windowed_fold_multi(slabs, xs, chunk_rows: int, kp: int):
    """The window tensor ``t (n_out, NW, kp, S)`` of several matrices,
    ``t = Σ_m windowed_fold(*slabs[m], xs[m], ...)``, in one launch:
    ``slabs`` a sequence of ``(cols, vals, rowid)`` (n_out, NW, n_src_m,
    L_m), each matrix with its own x ``xs[m]`` (n_cols_m, S). The matrices
    share ``chunk_rows``, ``kp`` and (n_out, NW) and the operand dtypes (one
    pair of :data:`FOLD_OPERANDS`); their slab widths and source-chunk
    counts may differ. Each window's slots are folded matrix by matrix into
    one accumulator, in float32 (float64 for float64), and t is written
    once, in x's dtype: two launches are bit-equal."""
    slabs, xs = list(slabs), list(xs)
    _check_fold_multi(slabs, xs, chunk_rows, kp)
    x0 = xs[0]
    if x0.device.type == 'cpu':
        return windowed_fold_multi_plain(slabs, xs, chunk_rows, kp)
    _cuda.refuse_autograd('windowed_fold_multi', *xs,
                          *(v for _, v, _ in slabs))
    n_out, nw = slabs[0][0].shape[:2]
    s = x0.shape[1]
    t = torch.empty((n_out, nw, kp, s), dtype=x0.dtype, device=x0.device)
    if t.numel() == 0:
        return t
    lay = fold_layout(kp, s, torch.finfo(_sum_dtype(x0.dtype)).bits // 8,
                      x0.element_size(), multi=True)
    table = (ctypes.c_longlong * (7 * len(xs)))(*[
        v for (cols, vals, rowid), x in zip(slabs, xs)
        for v in (cols.data_ptr(), vals.data_ptr(), rowid.data_ptr(),
                  x.data_ptr(), cols.shape[2], cols.shape[3], x.shape[0])])
    cols0, vals0, rowid0 = slabs[0]
    symbol = (f'windowed_fold_multi_{_FOLD_TYPES[x0.dtype, vals0.dtype]}_'
              f'{_ROWIDS[rowid0.dtype]}')
    _cuda.launch(_SOURCE, symbol, 2, 8, x0.get_device(),
                 ctypes.addressof(table), t.data_ptr(), len(xs), n_out * nw,
                 chunk_rows, kp, s, lay.s_tile, lay.ring, lay.queue)
    windowed_fold_multi.launches += 1
    return t


windowed_fold_multi.launches = 0


# ---------------------------------------------------------------------------
# (b) window_strip: the windowed SpMM's tail
# ---------------------------------------------------------------------------

# Rows with at least this many residue entries are each taken by a block of
# their own in window_strip's kernel, whose warps sum the row's entries in
# parallel (kHeavyRound at a time) before adding them in order; other rows
# are taken by a group of lanes that adds its row's entries one after
# another. The kernel's kHeavyMin (csrc/windowed_fold.cu) is the same
# number: its row blocks skip the rows that the upload lists as heavy.
TAIL_HEAVY_ENTRIES = 8


class Residue(NamedTuple):
    """The residue tiers of a windowed matrix as one list sorted by output
    row, the operand of :func:`window_strip`'s tail::

        entries of row i:   [rowptr[i], rowptr[i + 1])
        live slots of e:    [entptr[e], entptr[e + 1])
        slot q:             x row cols[q] (source chunk · R + column), vals[q]

    A row's entries stand in the order of the matrix's ``level_rows``
    (source chunk, then the width-1 tier before the width-8 one); dead
    slots are dropped. ``heavy``: every row with at least
    :data:`TAIL_HEAVY_ENTRIES` entries, the most entries first (ties by
    row)."""
    rowptr: torch.Tensor    # (n_rows + 1,) int32
    entptr: torch.Tensor    # (n_entries + 1,) int32
    cols: torch.Tensor      # (n_live,) int32
    vals: torch.Tensor      # (n_live,) the matrix's value dtype
    heavy: torch.Tensor     # (n_heavy,) int32
    # the strip of a multi-matrix fold: each entry's matrix (int32), whose
    # x its slots read (:func:`merge_residues`); None for one matrix
    emat: torch.Tensor | None = None
    # each slot's index in the matrix's tiers' concatenated flat values
    # (int64), by which a replaced tier's values are gathered
    # (:func:`~.chunked.level_values`); None for a merged list
    src: torch.Tensor | None = None


def _strip_plain(t, n_rows: int, window_rows: int):
    """Part 0 of every window, plus part d shifted d windows forward inside
    its out chunk, summed in float32 or wider and rounded once to t's
    dtype."""
    n_out, nw, kp, s = t.shape
    P = window_rows
    y = t[:, :, :P].reshape(n_out, nw * P, s).to(_sum_dtype(t.dtype),
                                                 copy=True)
    for d in range(1, kp // P):
        if nw <= d:
            break                 # borrowing never crosses an out chunk
        a = t[:, :, d * P:(d + 1) * P].reshape(n_out, nw * P, s)
        y[:, d * P:] += a[:, :-d * P]
    return y.reshape(n_out * nw * P, s)[:n_rows].to(t.dtype)


def _by_rank(ptr):
    """For the CSR pointer ``ptr`` over items: each item's segment, and the
    items grouped by their rank inside their segment (a list, rank 0
    first; each group holds at most one item of a segment, in segment
    order)."""
    counts = ptr[1:] - ptr[:-1]
    n = int(ptr[-1])
    seg = torch.repeat_interleave(
        torch.arange(counts.numel(), device=ptr.device), counts.long(),
        output_size=n)
    rank = torch.arange(n, device=ptr.device) - ptr[:-1].long()[seg]
    order = torch.argsort(rank, stable=True)
    sizes = torch.bincount(rank, minlength=1).tolist() if n else []
    return seg, list(torch.split(order, sizes))


def tail_plain(y, residue: Residue, x):
    """Plain PyTorch version of the tail of :func:`window_strip`, in place
    on ``y``, in the order and the roundings the kernel keeps: each entry's
    sum ``s_e`` of its slots' products (formed in the promotion of x's and
    the values' dtypes, widened to float32 or wider), slot by slot; then,
    row by row, ``y = y + s_e`` in y's dtype, entry by entry. No index is
    repeated inside one step, so the result does not depend on the device.
    With ``residue.emat`` (a multi-matrix strip) ``x`` is the matrices'
    sequence of x's, each slot reading its entry's. Counts its calls in
    ``.calls``."""
    tail_plain.calls += 1
    acc = _sum_dtype(y.dtype)
    n_ent = residue.entptr.numel() - 1
    if n_ent == 0 or y.numel() == 0:
        return y
    cols = residue.cols.long()
    if residue.emat is None:
        p = (residue.vals[:, None] * x[cols]).to(acc)
    else:
        slot_mat = torch.repeat_interleave(
            residue.emat.long(), (residue.entptr[1:] - residue.entptr[:-1])
            .long(), output_size=cols.numel())
        p = torch.empty((cols.numel(), y.shape[1]), dtype=acc,
                        device=y.device)
        for m, xm in enumerate(x):
            sel = slot_mat == m
            p[sel] = (residue.vals[sel, None] * xm[cols[sel]]).to(acc)
    ent, slot_ranks = _by_rank(residue.entptr)
    sums = torch.zeros((n_ent, y.shape[1]), dtype=acc, device=y.device)
    for q in slot_ranks:
        sums[ent[q]] += p[q]
    sums = sums.to(y.dtype)
    row, ent_ranks = _by_rank(residue.rowptr)
    for e in ent_ranks:
        y[row[e]] += sums[e]
    return y


tail_plain.calls = 0


def window_strip_plain(t, n_rows: int, window_rows: int,
                       residue: Residue | None = None, x=None):
    """Plain PyTorch version of :func:`window_strip`: the overlap-add
    summed in float32 or wider and rounded once to t's dtype, then the
    residue entries (:func:`tail_plain`)."""
    y = _strip_plain(t, n_rows, window_rows)
    if residue is not None:
        tail_plain(y, residue, x)
    return y


def _check_residue(residue, x, t, n_rows, name='window_strip'):
    """Raise unless ``residue`` and x (a sequence of x's for a merged list)
    fit a strip of ``n_rows`` rows of ``t``'s columns, dtype and device
    (``t``: the window tensor, or any tensor of those)."""
    s = t.shape[-1]
    xs = (x,) if residue.emat is None else tuple(x)
    if residue.emat is not None and not 0 < len(xs) <= MAX_MATS:
        raise ValueError(f'a multi-matrix strip takes 1 to {MAX_MATS} x\'s, '
                         f'got {len(xs)}')
    for x in xs:
        if x is None or x.ndim != 2 or x.shape[1] != s:
            raise ValueError(f'{name} takes the residue with x (n_cols, '
                             f'{s}), got '
                             f'{None if x is None else tuple(x.shape)}')
        if (x.dtype != t.dtype
                or (x.dtype, residue.vals.dtype) not in _FOLD_TYPES):
            raise ValueError(f'{name} takes x in the window tensor\'s '
                             f'dtype {t.dtype} and residue values that the '
                             f'fold pairs with it, got {x.dtype} and '
                             f'{residue.vals.dtype}')
        _check_operands(name, (x, t), x)
    index = (residue.rowptr, residue.entptr, residue.cols, residue.heavy) + (
        () if residue.emat is None else (residue.emat,))
    if any(a.dtype != torch.int32 or a.ndim != 1 for a in index):
        raise ValueError('the residue list takes 1-D int32 index vectors')
    if (residue.rowptr.numel() != n_rows + 1
            or residue.vals.shape != residue.cols.shape):
        raise ValueError(f'the residue list does not fit {n_rows} rows')
    _check_operands(name, index + (residue.vals, t), t)


def window_strip(t, n_rows: int, window_rows: int,
                 residue: Residue | None = None, x=None):
    """``y (n_rows, S)`` from the window tensor ``t (n_out, NW, K·P, S)``,
    the windowed SpMM's whole tail::

        y[i·R + w·P + r, :] = Σ_{d < K, d <= w} t[i, w − d, d·P + r, :]

    with ``P = window_rows`` and ``R = NW·P``, summed in float32 (float64
    for float64) and rounded once to t's dtype; rows past ``n_rows`` (the
    ragged last chunk) are dropped. With the residue list (:class:`Residue`)
    and x (n_cols, S) in t's dtype, each row then adds its residue entries
    in order, each entry's sum of ``vals[q] · x[cols[q]]`` taken in float32
    or wider and rounded to t's dtype, and every add rounded to it: the
    order of the JAX package's ``index_add`` of the tiers
    (``pygsp_tpu/core/windowed.py:406-414``). A merged list of several
    matrices (:func:`merge_residues`, the tail of
    :func:`windowed_fold_multi`) takes ``x`` as their sequence of x's, each
    entry reading its matrix's. Each row of y is written once, by one
    owner: two launches are bit-equal. A bfloat16 ``t`` with
    K = 2 sums as the JAX package's bfloat16 add of the two addends; for
    K > 2 the JAX package rounds after each add, the kernel only at the
    end."""
    if t.ndim != 4 or t.dtype not in _DTYPES:
        raise ValueError(f'window_strip takes a 4-D float32, float64 or '
                         f'bfloat16 window tensor, got {tuple(t.shape)} '
                         f'{t.dtype}')
    n_out, nw, kp, s = t.shape
    if kp % window_rows or not 0 <= n_rows <= n_out * nw * window_rows:
        raise ValueError(f'window tensor {tuple(t.shape)} does not hold '
                         f'{n_rows} rows in windows of {window_rows}')
    _check_operands('window_strip', (t,), t)
    if residue is not None:
        _check_residue(residue, x, t, n_rows)
    if t.device.type == 'cpu':
        return window_strip_plain(t, n_rows, window_rows, residue, x)
    _cuda.refuse_autograd('window_strip', t, *(
        () if residue is None else (residue.vals,)
        + ((x,) if residue.emat is None else tuple(x))))
    y = torch.empty((n_rows, s), dtype=t.dtype, device=t.device)
    if y.numel() == 0:
        return y
    if residue is not None and residue.emat is not None:
        xs = tuple(x)
        table = (ctypes.c_longlong * len(xs))(*[v.data_ptr() for v in xs])
        _cuda.launch(_SOURCE, 'window_strip_multi_'
                     + _FOLD_TYPES[xs[0].dtype, residue.vals.dtype], 9, 7,
                     t.get_device(), t.data_ptr(), y.data_ptr(),
                     residue.rowptr.data_ptr(), residue.entptr.data_ptr(),
                     residue.cols.data_ptr(), residue.vals.data_ptr(),
                     residue.emat.data_ptr(), ctypes.addressof(table),
                     residue.heavy.data_ptr(), len(xs), n_rows, s, nw,
                     window_rows, kp // window_rows, residue.heavy.numel())
        window_strip.launches += 1
        return y
    if residue is None:
        symbol = f'window_strip_{_DTYPES[t.dtype]}'
        lists, n_heavy = (0,) * 6, 0
    else:
        symbol = f'window_strip_{_FOLD_TYPES[x.dtype, residue.vals.dtype]}'
        lists = (residue.rowptr.data_ptr(), residue.entptr.data_ptr(),
                 residue.cols.data_ptr(), residue.vals.data_ptr(),
                 x.data_ptr(), residue.heavy.data_ptr())
        n_heavy = residue.heavy.numel()
    _cuda.launch(_SOURCE, symbol, 8, 6, t.get_device(), t.data_ptr(),
                 y.data_ptr(), *lists, n_rows, s, nw, window_rows,
                 kp // window_rows, n_heavy)
    window_strip.launches += 1
    return y


window_strip.launches = 0


def merge_residues(residues, n_rows: int):
    """One row-sorted residue list of several matrices' (each a
    :class:`Residue` over the same ``n_rows`` output rows, or None), for
    the strip of :func:`windowed_fold_multi`: a row's entries of matrix 0
    first, then matrix 1's, ... (the order in which the JAX package adds
    each matrix's tiers), ``emat`` naming each entry's matrix (its index in
    ``residues``) and ``heavy`` recounted over the merged rows. None if no
    matrix has a residue."""
    present = [(m, r) for m, r in enumerate(residues) if r is not None]
    if not present:
        return None
    dev = present[0][1].rowptr.device
    counts = [(r.rowptr[1:] - r.rowptr[:-1]).long() for _, r in present]
    total = torch.stack(counts).sum(0)
    rowptr = torch.cat([total.new_zeros(1), total.cumsum(0)])
    before = torch.zeros_like(total)          # entries of earlier matrices
    n_ent = int(total.sum())
    ent_len = torch.zeros(n_ent, dtype=torch.long, device=dev)
    pos, lens, emat = [], [], torch.empty(n_ent, dtype=torch.int32,
                                          device=dev)
    for (m, r), cnt in zip(present, counts):
        n_m = r.entptr.numel() - 1
        row = torch.repeat_interleave(torch.arange(n_rows, device=dev), cnt,
                                      output_size=n_m)
        rank = torch.arange(n_m, device=dev) - r.rowptr[:-1].long()[row]
        p = rowptr[row] + before[row] + rank
        ln = (r.entptr[1:] - r.entptr[:-1]).long()
        ent_len[p] = ln
        emat[p] = m
        pos.append(p)
        lens.append(ln)
        before += cnt
    entptr = torch.cat([ent_len.new_zeros(1), ent_len.cumsum(0)])
    n_slots = int(entptr[-1])
    cols = torch.empty(n_slots, dtype=torch.int32, device=dev)
    vals = torch.empty(n_slots, dtype=present[0][1].vals.dtype, device=dev)
    for (m, r), p, ln in zip(present, pos, lens):
        start = torch.repeat_interleave(entptr[p] - r.entptr[:-1].long(), ln,
                                        output_size=r.cols.numel())
        dst = start + torch.arange(r.cols.numel(), device=dev)
        cols[dst] = r.cols
        vals[dst] = r.vals
    heavy = torch.nonzero(total >= TAIL_HEAVY_ENTRIES).flatten()
    heavy = heavy[torch.argsort(-total[heavy], stable=True)]
    return Residue(rowptr=rowptr.to(torch.int32),
                   entptr=entptr.to(torch.int32), cols=cols, vals=vals,
                   heavy=heavy.to(torch.int32), emat=emat)


# ---------------------------------------------------------------------------
# (e) fold_strip_multi: the fused multi-matrix SpMM in one launch
# ---------------------------------------------------------------------------

# fold_strip_multi's block: its warps, and the heavy row's entries it sums
# per round into shared memory (kStripWarps and kEntryRound in
# csrc/windowed_fold.cu); a staged slot keeps its x row below its matrix in
# one int, so an x has fewer rows than this (kSrcBits)
STRIP_WARPS = 8
ENTRY_ROUND = 16
_SRC_ROWS = 1 << 27


class StripLayout(NamedTuple):
    """Shared-memory layout of one :func:`fold_strip_multi` block."""
    tile: int        # columns of S per block: 32 lanes of E values each
    smem_bytes: int  # staged slots, heavy-row sums, row-id starts, counts


def strip_piece(dtype) -> int:
    """The values of x's dtype a lane of :func:`fold_strip_multi` loads at
    once: 16 bytes (4 float32 or 2 float64 values), and in bfloat16 8
    bytes, 4 values (kE in csrc/windowed_fold.cu)."""
    return 16 // max(torch.finfo(dtype).bits // 8, 4)


def strip_capacity(slabs, borrow_span: int) -> int:
    """The most raw slots a window of :func:`fold_strip_multi` stages:
    ``borrow_span`` windows of every matrix's slots."""
    return borrow_span * sum(cols.shape[2] * cols.shape[3]
                             for cols, _, _ in slabs)


def fold_strip_layout(kp: int, n_cap: int, dtype,
                      vec: bool = True) -> StripLayout:
    """The :func:`fold_strip_multi` block layout for ``kp`` row ids a
    window, windows of up to ``n_cap`` raw slots and x of ``dtype``: per
    raw slot its staged value (in the sums' type) and three ints (row id,
    x row, sorted place); :data:`ENTRY_ROUND` entry sums of the tile;
    three ints a row id and two more (the row ids' starts and cursors, the
    rows' first residue entries, a window holding at most ``kp`` rows), and
    one a warp and one more."""
    item = torch.finfo(_sum_dtype(dtype)).bits // 8
    tile = 32 * (strip_piece(dtype) if vec else 1)
    smem = ((n_cap + ENTRY_ROUND * tile) * item
            + (3 * n_cap + 3 * kp + 2 + STRIP_WARPS + 1) * 4)
    return StripLayout(tile, smem)


def fold_strip_fits(slabs, xs, borrow_span: int, window_rows: int) -> bool:
    """Whether :func:`fold_strip_multi` takes these matrices: a window's
    raw slots staged in one block's shared memory, and each x of fewer
    than 2^27 rows."""
    n_cap = strip_capacity(slabs, borrow_span)
    lay = fold_strip_layout(borrow_span * window_rows, n_cap, xs[0].dtype)
    return (lay.smem_bytes <= SMEM_PER_BLOCK
            and all(x.shape[0] <= _SRC_ROWS for x in xs))


def fold_strip_multi_plain(slabs, xs, chunk_rows: int, window_rows: int,
                           borrow_span: int, n_rows: int,
                           residue: Residue | None = None):
    """Plain version of :func:`fold_strip_multi`: the two-launch route's
    plain versions, :func:`window_strip_plain` of
    :func:`windowed_fold_multi_plain`."""
    xs = list(xs)
    t = windowed_fold_multi_plain(slabs, xs, chunk_rows,
                                  borrow_span * window_rows)
    return window_strip_plain(t, n_rows, window_rows, residue, xs)


def fold_strip_multi(slabs, xs, chunk_rows: int, window_rows: int,
                     borrow_span: int, n_rows: int,
                     residue: Residue | None = None):
    """``y (n_rows, S) = Σ_m A_m @ x_m`` of the matrices' slabs ``slabs``
    (as :func:`windowed_fold_multi` takes them, with ``kp = borrow_span ·
    window_rows``) and the merged residue list ``residue``
    (:func:`merge_residues`, or None), in one launch that writes y and no
    window tensor. The result is, bit for bit, ``window_strip(
    windowed_fold_multi(slabs, xs, chunk_rows, kp), n_rows, window_rows,
    residue, xs)``: every window's sums in float32 (float64 for float64)
    rounded to x's dtype, the overlap-add rounded once, each residue
    entry's sum and each add rounded. Two launches are bit-equal. Raises
    ``ValueError`` where a window's raw slots do not fit a block
    (:func:`fold_strip_fits`)."""
    slabs, xs = list(slabs), list(xs)
    kp = borrow_span * window_rows
    _check_fold_multi(slabs, xs, chunk_rows, kp)
    n_out, nw = slabs[0][0].shape[:2]
    x0 = xs[0]
    s = x0.shape[1]
    if window_rows < 1 or not 0 <= n_rows <= n_out * nw * window_rows:
        raise ValueError(f'{n_out} x {nw} windows of {window_rows} rows do '
                         f'not hold {n_rows} rows')
    if residue is not None:
        if residue.emat is None:
            raise ValueError('fold_strip_multi takes a merged residue list '
                             '(merge_residues)')
        _check_residue(residue, xs, x0, n_rows, 'fold_strip_multi')
    if not fold_strip_fits(slabs, xs, borrow_span, window_rows):
        raise ValueError(f'fold_strip_multi stages a window\'s raw slots in '
                         f'one block: {strip_capacity(slabs, borrow_span)} '
                         f'do not fit')
    if x0.device.type == 'cpu':
        return fold_strip_multi_plain(slabs, xs, chunk_rows, window_rows,
                                      borrow_span, n_rows, residue)
    _cuda.refuse_autograd('fold_strip_multi', *xs,
                          *(v for _, v, _ in slabs),
                          *(() if residue is None else (residue.vals,)))
    y = torch.empty((n_rows, s), dtype=x0.dtype, device=x0.device)
    if y.numel() == 0:
        return y
    piece = strip_piece(x0.dtype)
    vec = s % piece == 0 and all(
        x.data_ptr() % (piece * x.element_size()) == 0 for x in xs + [y])
    n_cap = strip_capacity(slabs, borrow_span)
    table = (ctypes.c_longlong * (7 * len(xs)))(*[
        v for (cols, vals, rowid), x in zip(slabs, xs)
        for v in (cols.data_ptr(), vals.data_ptr(), rowid.data_ptr(),
                  x.data_ptr(), cols.shape[2], cols.shape[3], x.shape[0])])
    if residue is None:
        lists, n_heavy = (0,) * 6, 0
    else:
        lists = tuple(a.data_ptr() for a in (
            residue.rowptr, residue.entptr, residue.cols, residue.vals,
            residue.emat, residue.heavy))
        n_heavy = residue.heavy.numel()
    _, vals0, rowid0 = slabs[0]
    symbol = (f'fold_strip_multi_{_FOLD_TYPES[x0.dtype, vals0.dtype]}_'
              f'{_ROWIDS[rowid0.dtype]}')
    _cuda.launch(_SOURCE, symbol, 8, 11, x0.get_device(),
                 ctypes.addressof(table), y.data_ptr(), *lists, len(xs),
                 n_heavy, n_out, nw, chunk_rows, window_rows, borrow_span,
                 n_rows, s, int(vec), n_cap)
    fold_strip_multi.launches += 1
    return y


fold_strip_multi.launches = 0


# ---------------------------------------------------------------------------
# (c) fold_products
# ---------------------------------------------------------------------------

def fold_products_plain(rid, p, kp: int):
    """Plain PyTorch version of :func:`fold_products`: one ``index_add_`` of
    the float32 products onto their window rows."""
    nw, _, s = p.shape
    live = (rid >= 0) & (rid < kp)
    dst = (torch.arange(nw, device=p.device)[:, None] * kp
           + torch.where(live, rid, 0).long())
    src = torch.where(live[..., None], p.float(),
                      torch.zeros((), dtype=torch.float32, device=p.device))
    out = torch.zeros((nw * kp, s), dtype=torch.float32, device=p.device)
    out.index_add_(0, dst.reshape(-1), src.reshape(-1, s))
    return out.reshape(nw, kp, s)


class ProductsLayout(NamedTuple):
    """Grid and shared memory of one :func:`fold_products` launch."""
    block_m: int     # KP rows per block (64, 128, 256: 4, 8, 16 warps)
    m_tiles: int     # blocks along KP per window
    n_tiles: int     # blocks along S (PRODUCTS_N columns each)
    blocks: int      # NW * m_tiles * n_tiles
    smem_bytes: int  # the ring of stages, their row ids, f32's planes


def products_layout(nw: int, kp: int, s: int, itemsize: int
                    ) -> ProductsLayout:
    """The :func:`fold_products` launch for ``nw`` windows of ``kp`` output
    rows, S = ``s`` and ``itemsize``-byte products (2: bf16, multiplied as
    loaded; 4: f32, split into three bf16 planes first). A block takes the
    most rows of KP, 256 or 128, that still leave two blocks for each SM
    (every block reads its window's p, so fewer KP tiles read less), else
    64, so that one window of 256 rows (TPU kernel #3) runs 4 blocks.
    Raises where the grid cannot hold the launch."""
    if itemsize not in (2, 4) or kp < 1 or nw < 0 or s < 0:
        raise ValueError(f'no fold_products layout for NW={nw}, KP={kp}, '
                         f'S={s} and {itemsize}-byte products')
    n_tiles = -(-s // PRODUCTS_N)
    block_m = next((bm for bm in (256, 128) if kp > bm // 2
                    and nw * -(-kp // bm) * n_tiles >= 2 * SMS), 64)
    m_tiles = -(-kp // block_m)
    if n_tiles > _GRID_Y or nw * m_tiles > _GRID_X:
        raise ValueError(f'a fold over NW={nw}, KP={kp}, S={s} does not fit '
                         f'the grid ({nw * m_tiles} x {n_tiles} blocks)')
    # per stage, its products as loaded (rows padded by 16 bytes) and row
    # ids; f32 products are split into three bf16 planes before the product
    stage = PRODUCTS_K * (PRODUCTS_N * itemsize + 16) + PRODUCTS_K * 4
    planes = 0 if itemsize == 2 else 3 * PRODUCTS_K * PRODUCTS_PITCH * 2
    smem = PRODUCTS_STAGES * stage + planes
    return ProductsLayout(block_m, m_tiles, n_tiles, nw * m_tiles * n_tiles,
                          smem)


def fold_products(rid, p, kp: int):
    """``out[w, k, :] = Σ_{l: rid[w, l] = k} p[w, l, :]``, float32, for
    ``rid (NW, Lt)`` int32 and bfloat16 or float32 products
    ``p (NW, Lt, S)``: the one-hot ``(kp, Lt)`` times ``p[w]`` of TPU
    kernel #2, with float32 accumulation, on the tensor cores (float32
    products as three exact bfloat16 terms). Row ids outside ``[0, kp)``
    match no one-hot row and add nothing, even where their product is not
    finite. A live product that is not finite spreads NaN over its
    window's column, as in the dense one-hot product of TPU kernel #2 and
    of the JAX package's einsum; the plain version (``index_add_``) keeps
    it to its own row. Returns (NW, kp, S)."""
    if rid.ndim != 2 or p.ndim != 3 or p.shape[:2] != rid.shape:
        raise ValueError(f'fold_products takes rid (NW, Lt) and p '
                         f'(NW, Lt, S), got {tuple(rid.shape)} and '
                         f'{tuple(p.shape)}')
    if rid.dtype != torch.int32 or p.dtype not in _PRODUCTS:
        raise ValueError(f'fold_products takes int32 row ids and bfloat16 or '
                         f'float32 products, got {rid.dtype} and {p.dtype}')
    _check_operands('fold_products', (rid, p), p)
    if p.device.type == 'cpu':
        return fold_products_plain(rid, p, kp)
    _cuda.refuse_autograd('fold_products', rid, p)
    nw, lt, s = p.shape
    out = torch.empty((nw, kp, s), dtype=torch.float32, device=p.device)
    if out.numel() == 0:
        return out
    lay = products_layout(nw, kp, s, p.element_size())
    _cuda.launch(_SOURCE, f'fold_products_{_PRODUCTS[p.dtype]}', 3, 5,
                 p.get_device(), rid.data_ptr(), p.data_ptr(),
                 out.data_ptr(), nw, lt, kp, s, lay.block_m)
    fold_products.launches += 1
    return out


fold_products.launches = 0


# ---------------------------------------------------------------------------
# (d) double
# ---------------------------------------------------------------------------

def double_plain(x):
    """Plain PyTorch version of :func:`double`."""
    return x * 2


def double(x):
    """``y = 2·x`` for a float32 tensor."""
    if x.dtype != torch.float32:
        raise ValueError(f'double takes float32, got {x.dtype}')
    _check_operands('double', (x,), x)
    if x.device.type == 'cpu':
        return double_plain(x)
    _cuda.refuse_autograd('double', x)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    _cuda.launch(_SOURCE, 'double_f32', 2, 1, x.get_device(), x.data_ptr(),
                 y.data_ptr(), x.numel())
    double.launches += 1
    return y


double.launches = 0


KERNELS = (windowed_fold, windowed_fold_multi, window_strip,
           fold_strip_multi, fold_products, double)
