"""Chunked multi-level ELL, and what the windowed-compact format shares.

Counterpart of :mod:`pygsp_tpu.core.chunked`. The JAX package splits the
source vertex axis into chunks of ``chunk_rows`` to keep every TPU gather
inside a window of 2^16 rows. For each (output chunk ``i``, source chunk
``c``) block with any edges, a dense main slot block ``(R_i, w)``: every
output row of chunk ``i`` owns ``w`` slots holding its first ``w``
neighbours inside source chunk ``c``, ``w`` chosen per block by the JAX
package's cost model (:func:`_choose_width`). Rows still spilling go to
geometrically wider slot tiers per (source chunk, tier)
(:class:`ChunkLevel`), whose entries are added onto ``level_rows``.

The host builder is the JAX package's, copied as NumPy, so the same input packs
to the same arrays. The upload keeps the blocks as views of one flat slot
buffer per field (``slot_cols``/``slot_vals``), makes the SpMM kernel's slot
table over them and lays the tiers out as one list sorted by output row, the
windowed tail's residue list (:func:`_flat_residue`). On the card the SpMM is
one launch of ``chunked_spmm`` (:mod:`~pygsp_tpu_torch.core.ell_kernel`) for
every block and tier. The signal stays one contiguous ``(N, S)`` tensor;
:meth:`ChunkedELLMatrix.spmm_chunks` takes and gives the JAX package's tuple of
chunks for API parity.

The windowed format (:mod:`.windowed`) shares the default chunk size, the
tiers, the signal chunking helpers, the permutes and the residue list.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sps
import torch

from pygsp_tpu_torch.core import ell_kernel, windowed_kernel

# Default source/output chunk size, the JAX package's (its TPU gather
# window). The windowed builder sizes its chunks from it.
CHUNK_ROWS = 1 << 16


@dataclasses.dataclass(frozen=True)
class ChunkBlock:
    """One (out-chunk, src-chunk) main slot block: ``cols``/``vals`` (R_i,
    w), column ids local to the source chunk with sentinel ``==
    src_chunk_size`` (zero value, never read). ``w`` may be 0 (a hub-only
    block): then all of the block's edges live in the levels."""

    cols: torch.Tensor
    vals: torch.Tensor


@dataclasses.dataclass(frozen=True)
class ChunkLevel:
    """Overflow slot tier for one source chunk.

    ``cols``/``vals``: (m, lw) slot arrays for the m spilling rows, in the
    order of the owning matrix's ``level_rows``; ``cols`` local to
    ``src_chunk``, with sentinel ``== src_chunk_size(src_chunk)``, which is
    ``chunk_rows`` except on a ragged last chunk (zero value, never read).
    """

    cols: torch.Tensor
    vals: torch.Tensor
    src_chunk: int


@dataclasses.dataclass(frozen=True)
class ChunkedELLMatrix:
    """Chunked multi-level ELL sparse matrix (see the module docstring),
    with the JAX package's field names and arrays.

    ``blocks[k]`` is the :class:`ChunkBlock` of ``block_keys[k] =
    (out_chunk, src_chunk)``, in the builder's order (source chunk major);
    empty blocks are omitted. ``levels``: the merged overflow tiers;
    ``level_rows`` (int32): the global output row of every tier entry, in
    level order (rows repeat). ``rowptr`` (int32): the true global row
    degrees as a CSR pointer, original row order. ``perm``/``iperm``
    (int64, optional): the degree-sort relabeling; the stored blocks hold
    ``A[perm][:, perm]`` and the ``A @ x`` contract stays in the original
    order.

    The port adds the operands of the SpMM kernel, made once at upload:
    ``slot_cols``/``slot_vals``, the flat buffers whose views the blocks
    are; ``table``, the kernel's slot table over them; ``residue``, the
    tiers as one list sorted by row (None without tiers).
    """

    blocks: tuple
    levels: tuple
    level_rows: torch.Tensor
    rowptr: torch.Tensor
    block_keys: tuple
    n_rows: int
    n_cols: int
    nnz: int
    chunk_rows: int
    perm: torch.Tensor | None = None
    iperm: torch.Tensor | None = None
    slot_cols: torch.Tensor = None
    slot_vals: torch.Tensor = None
    table: ell_kernel.SlotTable = None
    residue: windowed_kernel.Residue | None = None

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def dtype(self):
        return self.slot_vals.dtype

    @property
    def device(self):
        return self.slot_vals.device

    @property
    def n_out_chunks(self) -> int:
        return max(-(-self.n_rows // self.chunk_rows), 1)

    @property
    def n_src_chunks(self) -> int:
        return max(-(-self.n_cols // self.chunk_rows), 1)

    def out_chunk_size(self, i: int) -> int:
        return min(self.chunk_rows, self.n_rows - i * self.chunk_rows)

    def src_chunk_size(self, c: int) -> int:
        return min(self.chunk_rows, self.n_cols - c * self.chunk_rows)

    def _map_vals(self, fn) -> 'ChunkedELLMatrix':
        """The matrix with ``fn`` applied to every value: the flat slot
        buffer (the blocks become views of the new one), the tiers' and the
        residue list's, so that all stay in step."""
        slot_vals = fn(self.slot_vals)
        return dataclasses.replace(
            self, slot_vals=slot_vals,
            blocks=_block_views(self.slot_cols, slot_vals, self.table.blocks,
                                self),
            levels=tuple(dataclasses.replace(lev, vals=fn(lev.vals))
                         for lev in self.levels),
            residue=None if self.residue is None else self.residue._replace(
                vals=fn(self.residue.vals)))

    def leaves(self) -> tuple:
        """The float leaves of the JAX package's pytree, in its order:
        every block's ``vals``, then every tier's."""
        return (tuple(b.vals for b in self.blocks)
                + tuple(lev.vals for lev in self.levels))

    def with_leaves(self, leaves) -> 'ChunkedELLMatrix':
        """The matrix with :meth:`leaves` replaced (the same shapes): the
        flat slot buffer is the blocks' values laid end to end (the blocks
        become views of it) and the residue list's values are gathered
        from the tiers' by its map (:func:`level_values`), on the device,
        so that what the kernel reads is the new leaves."""
        nb = len(self.blocks)
        return self.with_buffers(
            (torch.cat([v.reshape(-1) for v in leaves[:nb]]) if nb
             else self.slot_vals,) + tuple(leaves[nb:]))

    def buffers(self) -> tuple:
        """The tensors that hold the values the kernel reads, in the flat
        order of :meth:`leaves`: the flat slot buffer (the blocks' values
        end to end, the blocks views of it) and every tier's ``vals``.
        Autograd's Functions take these as their inputs, so that the
        blocks' cotangent arrives as one tensor (a Function's input that
        is a view of a buffer gets a full-size copy of its cotangent)."""
        return (self.slot_vals,) + tuple(lev.vals for lev in self.levels)

    def with_buffers(self, buffers) -> 'ChunkedELLMatrix':
        """The matrix with :meth:`buffers` replaced (the same shapes)."""
        slot_vals = buffers[0]
        levels = tuple(dataclasses.replace(lev, vals=v)
                       for lev, v in zip(self.levels, buffers[1:]))
        return dataclasses.replace(
            self, slot_vals=slot_vals, levels=levels,
            blocks=_block_views(self.slot_cols, slot_vals, self.table.blocks,
                                self),
            residue=level_values(self.residue, levels))

    def live_slots(self):
        """``(rows, cols, index)`` (int64) of every stored slot that holds
        an edge, in the matrix's internal order, ``index`` counting the
        concatenated flat :meth:`leaves`."""
        R = self.chunk_rows
        parts = [(torch.arange(i * R, i * R + self.out_chunk_size(i),
                               device=self.device), b.cols, c * R,
                  self.src_chunk_size(c))
                 for (i, c), b in zip(self.block_keys, self.blocks)]
        return _live(parts + _tier_parts(self), self.device)

    def astype(self, dtype) -> 'ChunkedELLMatrix':
        return self._map_vals(lambda v: v.to(dtype))

    def scale_vals(self, scale) -> 'ChunkedELLMatrix':
        return self._map_vals(lambda v: v * scale)

    def abs_vals(self) -> 'ChunkedELLMatrix':
        return self._map_vals(torch.abs)

    def spmm_chunks(self, x_chunks, out_dtype=None) -> tuple:
        return chunked_spmm_chunks(self, x_chunks, out_dtype=out_dtype)

    def stored_bytes(self) -> int:
        """The bytes of the matrix's arrays as the JAX package stores them
        (its tree leaves: the blocks, the tiers, and int32 index vectors,
        where the port keeps int64 permutes), which the recurrence's
        accumulator-group rule counts, so that both packages pick the same
        group. The port's own operands (the table, the residue list) are
        not counted."""
        def nbytes(t, itemsize=None):
            return t.numel() * (itemsize or t.element_size())
        return (sum(nbytes(b.cols) + nbytes(b.vals) for b in self.blocks)
                + sum(nbytes(lev.cols) + nbytes(lev.vals)
                      for lev in self.levels)
                + nbytes(self.level_rows, 4) + nbytes(self.rowptr, 4)
                + sum(nbytes(p, 4) for p in (self.perm, self.iperm)
                      if p is not None))

    def __matmul__(self, x):
        from pygsp_tpu_torch.core.sparse import spmm   # imports this module
        return spmm(self, x)


def _block_views(slot_cols, slot_vals, blocks, mat) -> tuple:
    """The :class:`ChunkBlock` views of the flat slot buffers, one per
    ``(out_chunk, offset, width, col_base, limit)`` of the slot table."""
    out = []
    for i, off, width, _, _ in blocks:
        n = mat.out_chunk_size(i) * width
        out.append(ChunkBlock(
            cols=slot_cols[off:off + n].view(-1, width) if width
            else slot_cols[:0].view(mat.out_chunk_size(i), 0),
            vals=slot_vals[off:off + n].view(-1, width) if width
            else slot_vals[:0].view(mat.out_chunk_size(i), 0)))
    return tuple(out)


def level_values(residue, levels):
    """``residue`` (a :class:`~.windowed_kernel.Residue` or None) with its
    values gathered from the tiers' ``vals`` by its map ``src`` (each live
    slot's index in the tiers' concatenated flat values): how a replaced
    tier reaches the tail, on the device."""
    if residue is None:
        return None
    flat = torch.cat([lev.vals.reshape(-1) for lev in levels])
    return residue._replace(vals=flat[residue.src])


def _tier_parts(mat):
    """The tiers of a chunked or windowed matrix as :func:`_live`'s parts:
    each entry's row from ``level_rows``, its columns in its source
    chunk."""
    R, out, e = mat.chunk_rows, [], 0
    for lev in mat.levels:
        m = lev.cols.shape[0]
        out.append((mat.level_rows[e:e + m], lev.cols, lev.src_chunk * R,
                    mat.src_chunk_size(lev.src_chunk)))
        e += m
    return out


def _live(parts, device):
    """``(rows, cols, index)`` (int64) of the live slots of slot blocks,
    ``parts`` a sequence of ``(rows (m,), cols (m, w), col_base, limit)``
    whose values lie end to end in one flat buffer: slot ``q`` of a block
    is live where its column is below ``limit``, its matrix column is
    ``col_base + cols``, its index the block's offset plus ``q``."""
    rows, cols, index = [], [], []
    base = 0
    for r, c, col_base, limit in parts:
        m, w = c.shape
        q = torch.nonzero(c.reshape(-1) < limit).flatten()
        rows.append(r.long()[q // max(w, 1)])
        cols.append(c.reshape(-1)[q].long() + col_base)
        index.append(q + base)
        base += m * w
    if not rows:
        return tuple(torch.zeros(0, dtype=torch.long, device=device)
                     for _ in range(3))
    return torch.cat(rows), torch.cat(cols), torch.cat(index)


# ---------------------------------------------------------------------------
# Signal chunking helpers and the permutes
# ---------------------------------------------------------------------------

def chunk_signal(x: torch.Tensor, chunk_rows: int) -> tuple:
    """Split the leading axis into views of ``chunk_rows`` rows."""
    return tuple(torch.split(x, chunk_rows, dim=0))


def unchunk_signal(chunks, axis: int = 0) -> torch.Tensor:
    return chunks[0] if len(chunks) == 1 else torch.cat(chunks, dim=axis)


def permute_in(mat, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Original-order signal → the matrix's internal (relabeled) order."""
    if mat.perm is None:
        return x
    return torch.index_select(x, axis, mat.perm)


def permute_out(mat, y: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Internal (relabeled) order → original vertex order."""
    if mat.perm is None:
        return y
    return torch.index_select(y, axis, mat.iperm)


def _slot_block_sum(cols, vals, x, out_dtype=None) -> torch.Tensor:
    """``Σ_d vals[:, d] · x[cols[:, d]]`` for (m, w) slot arrays over x
    (n, S), one source chunk: (m, S) rows, the counterpart of
    ``pygsp_tpu/core/sparse.py:_slot_block_sum``. Each product is formed in
    the promotion of the two dtypes; ``out_dtype`` (default: that
    promotion) upcasts it before the sum, as the JAX package's does, so
    that the bf16 modes read narrow operands and still sum in float32. No
    SpMM of the package calls it: the kernels' plain version
    (:func:`~.ell_kernel.slot_spmm_plain`) sums the same way, and the tests
    hold the former plain paths with it.

    The JAX package scans over 8-wide width chunks to bound XLA's
    temporaries; here the (m, w, S) products are made at once. Sentinel
    slots (``cols >= n``) hold zero values; their index is clamped, as the
    JAX gather clamps it, and their product is masked to zero, so a
    non-finite row of x never leaks in.
    """
    n = x.shape[0]
    live = (cols < n)[..., None]
    idx = torch.clamp(cols, max=n - 1).to(torch.long)
    p = vals[..., None] * x[idx]                             # (m, w, S)
    if out_dtype is not None:
        p = p.to(out_dtype)
    return torch.where(live, p, torch.zeros((), dtype=p.dtype,
                                            device=p.device)).sum(dim=1)


# ---------------------------------------------------------------------------
# SpMM
# ---------------------------------------------------------------------------

def spmm_internal(mat: ChunkedELLMatrix, x: torch.Tensor,
                  out_dtype=None) -> torch.Tensor:
    """``y = A @ x`` in the matrix's internal order, for x (n_cols, S): one
    launch of the chunked SpMM kernel over every block and tier.

    The dtype rules of the windowed format: products in the promotion of
    x's and the values' dtypes (a bf16·bf16 product rounds to bf16); row
    sums in float32 or wider; ``y`` in ``out_dtype``, by default that
    promotion. The kernel's operand pairs
    (:data:`~.ell_kernel.CHUNKED_OPERANDS`, ``y`` in x's dtype) run as they
    are, with no wider copy of the slots; any other pair is promoted
    first. The JAX package sums a bf16 carry's rows in bf16 (its
    ``out_dtype`` reaches each product); the port sums them in float32."""
    pdt = torch.promote_types(x.dtype, mat.dtype)
    dt = out_dtype or pdt
    x = x.contiguous()
    if (x.dtype, mat.dtype) not in ell_kernel.CHUNKED_OPERANDS or (
            dt != x.dtype):
        if mat.dtype != pdt:
            mat = mat.astype(pdt)
        x = x.to(pdt)
    return ell_kernel.chunked_spmm(mat.table, mat.slot_cols, mat.slot_vals,
                                   mat.residue, x, mat.n_rows).to(dt)


def chunked_spmm_chunks(mat: ChunkedELLMatrix, x_chunks,
                        out_dtype=None) -> tuple:
    """``y_chunks = A @ x_chunks`` with tuple-of-chunk input and output, in
    the internal order (API parity with the JAX package; the chunks are
    joined into one tensor for the kernel). ``out_dtype``: see
    :func:`spmm_internal`."""
    x = unchunk_signal(tuple(torch.as_tensor(xk) for xk in x_chunks))
    y = spmm_internal(mat, x.reshape(x.shape[0], -1), out_dtype=out_dtype)
    return chunk_signal(y.reshape((mat.n_rows,) + x.shape[1:]),
                        mat.chunk_rows)


def chunked_spmm(mat: ChunkedELLMatrix, x, *, out_dtype=None) -> torch.Tensor:
    """``y = A @ x`` for x of shape (n_cols,) or (n_cols, ...), in the
    original vertex order (``out_dtype``: see :func:`spmm_internal`).
    Iterative callers hoist the two permutes out of their loops."""
    x = torch.as_tensor(x)
    if x.ndim == 0 or x.shape[0] != mat.n_cols:
        raise ValueError(f'x must have {mat.n_cols} rows, got shape '
                         f'{tuple(x.shape)}')
    xp = permute_in(mat, x)
    y = spmm_internal(mat, xp.reshape(mat.n_cols, -1), out_dtype=out_dtype)
    return permute_out(mat, y.reshape((mat.n_rows,) + x.shape[1:]))


# ---------------------------------------------------------------------------
# Builder (host-side NumPy, the JAX package's own)
# ---------------------------------------------------------------------------

# The JAX package's per-op cost model (ns, measured on its TPU), kept as it
# is so that every block width, and with it every array, comes out the same.
_GATHER_NS = 3.5       # one slot gather+mul+add below the cliff
_SCATTER_NS = 25.0     # one scatter row into the concatenated output
_LEVEL_PAD = 1.3       # average level slot padding factor


def _choose_width(counts: np.ndarray, r_rows: int, w_cap: int = 64) -> int:
    """Pick the main slot width minimising the cost model.

    ``counts``: per-row edge counts within the block (only rows that have
    edges). Cost(w) = r_rows*w*g + spill_edges(w)*g*pad + spill_rows(w)*s.
    """
    if counts.size == 0:
        return 0
    maxd = int(counts.max())
    hist = np.bincount(counts, minlength=maxd + 1).astype(np.float64)
    d = np.arange(maxd + 1, dtype=np.float64)
    rows_gt = np.cumsum(hist[::-1])[::-1]          # rows with count >= d
    edges_ge = np.cumsum((hist * d)[::-1])[::-1]   # edges in rows count >= d
    ws = np.arange(0, min(maxd, w_cap) + 1, dtype=np.int64)
    spill_rows = np.where(ws + 1 <= maxd, rows_gt[np.minimum(ws + 1, maxd)],
                          0.0)
    spill_edges = np.where(
        ws + 1 <= maxd,
        edges_ge[np.minimum(ws + 1, maxd)] - ws * spill_rows, 0.0)
    cost = (r_rows * ws * _GATHER_NS
            + spill_edges * _GATHER_NS * _LEVEL_PAD
            + spill_rows * _SCATTER_NS)
    return int(ws[int(np.argmin(cost))])


def chunked_from_host_coo(rows, cols, vals, n_rows: int, n_cols: int, *,
                          chunk_rows: int = CHUNK_ROWS,
                          level_factor: int = 4,
                          min_level_width: int = 2,
                          max_tiers: int = 4,
                          permute: str | None = None,
                          dtype=None, device='cuda') -> ChunkedELLMatrix:
    """Build a :class:`ChunkedELLMatrix` from host COO (deduplicated
    edges), with the JAX package's packer; the arrays go to ``device`` at
    the end. ``dtype`` (numpy or torch) is the value type; by default the
    values keep their own float type (float64 for integers).

    ``permute='degree'`` relabels vertices in descending-degree order
    before packing (square matrices only); the ``A @ x`` contract keeps the
    original order. Tiers per source chunk start ``min_level_width`` wide
    and grow ``level_factor``-fold; tier ``max_tiers`` takes the rest.
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals)
    if dtype is not None:
        vals = vals.astype(_numpy_dtype(dtype))
    if not np.issubdtype(vals.dtype, np.floating):
        vals = vals.astype(np.float64)
    R = int(chunk_rows)

    deg = np.bincount(rows, minlength=n_rows) if rows.size else np.zeros(
        n_rows, np.int64)
    rowptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(deg, out=rowptr[1:])

    perm = iperm = None
    if permute == 'degree' and n_rows == n_cols and n_rows > 0:
        # stable: equal-degree runs keep their order, so builds reproduce
        perm = np.argsort(-deg, kind='stable')
        iperm = np.empty_like(perm)
        iperm[perm] = np.arange(n_rows, dtype=perm.dtype)
        rows = iperm[rows]
        cols = iperm[cols]
    elif permute not in (None, 'degree'):
        raise ValueError(f'Unknown permute mode {permute!r}')

    # the packer needs row-grouped edges (block-local CSR ranges)
    o = np.lexsort((cols, rows))
    rows, cols, vals = rows[o], cols[o], vals[o]

    # edges by (src_chunk, out_chunk), stable to keep row order; source
    # chunk major, so each source chunk's tiers merge over adjacent blocks
    bid = (cols // R) * max(-(-n_rows // R), 1) + (rows // R)
    order = np.argsort(bid, kind='stable')
    rows_s, cols_s, vals_s, bid_s = (rows[order], cols[order], vals[order],
                                     bid[order])
    n_out = max(-(-n_rows // R), 1)
    blk_ids, blk_starts = np.unique(bid_s, return_index=True)
    blk_ends = np.append(blk_starts[1:], rows_s.size)

    blocks = []
    block_keys = []
    spill = {}   # c -> list of (urows_global, ucounts, base_w, sub, pack_fn)
    for b, s0, s1 in zip(blk_ids, blk_starts, blk_ends):
        c, i = int(b) // n_out, int(b) % n_out
        r_i = min(R, n_rows - i * R)
        s_c = min(R, n_cols - c * R)
        lr = (rows_s[s0:s1] - i * R).astype(np.int64)   # local out rows
        lc = (cols_s[s0:s1] - c * R).astype(np.int32)   # local src cols
        lv = vals_s[s0:s1]
        urows, ucounts = np.unique(lr, return_counts=True)
        ustarts = np.zeros(urows.size, np.int64)
        np.cumsum(ucounts[:-1], out=ustarts[1:])

        w = _choose_width(ucounts, r_i)

        def pack_rows(sub, base, width, *, _ustarts=ustarts,
                      _ucounts=ucounts, _lr=lr, _lc=lc, _lv=lv, _s_c=s_c):
            """Slots [base, base+width) of each row in ``sub`` (indices
            into urows): O(rows*width) CSR-range gathers."""
            st = _ustarts[sub] + base
            en = _ustarts[sub] + _ucounts[sub]
            idx = st[:, None] + np.arange(width)[None, :]
            valid = idx < en[:, None]
            idx = np.minimum(idx, max(_lr.size - 1, 0))
            pc = np.where(valid, _lc[idx], _s_c).astype(np.int32)
            pv = np.where(valid, _lv[idx], 0).astype(vals.dtype)
            return pc, pv

        if w > 0:
            pc, pv = pack_rows(np.arange(urows.size), 0, w)
            main_c = np.full((r_i, w), s_c, np.int32)
            main_v = np.zeros((r_i, w), vals.dtype)
            main_c[urows] = pc
            main_v[urows] = pv
        else:
            main_c = np.zeros((r_i, 0), np.int32)
            main_v = np.zeros((r_i, 0), vals.dtype)
        blocks.append((main_c, main_v))
        block_keys.append((i, c))

        if ucounts.size and int(ucounts.max()) > w:
            sub = np.flatnonzero(ucounts > w)
            spill.setdefault(c, []).append(
                (urows[sub] + i * R, ucounts[sub] - w, w, sub, pack_rows))

    levels = []
    level_rows_parts = []
    for c in sorted(spill):
        parts = spill[c]
        maxrem = max(int(p[1].max()) for p in parts)
        base_off = 0
        lw = min_level_width
        tier = 0
        while base_off < maxrem:
            tier += 1
            if tier >= max_tiers:
                lw = maxrem - base_off   # the last tier takes the rest
            lw = min(lw, maxrem - base_off)
            tier_c, tier_v, tier_rows = [], [], []
            for grows, grem, base_w, sub, pack_fn in parts:
                live = grem > base_off
                if not live.any():
                    continue
                pc, pv = pack_fn(sub[live], base_w + base_off, lw)
                tier_c.append(pc)
                tier_v.append(pv)
                tier_rows.append(grows[live])
            levels.append(ChunkLevel(cols=np.concatenate(tier_c),
                                     vals=np.concatenate(tier_v),
                                     src_chunk=c))
            level_rows_parts.append(np.concatenate(tier_rows))
            base_off += lw
            lw = max(lw * level_factor, min_level_width)

    level_rows = (np.concatenate(level_rows_parts).astype(np.int32)
                  if level_rows_parts else np.zeros(0, np.int32))
    return upload(dict(
        blocks=blocks, levels=levels, level_rows=level_rows,
        rowptr=rowptr.astype(np.int32), block_keys=tuple(block_keys),
        n_rows=int(n_rows), n_cols=int(n_cols), nnz=int(rows.size),
        chunk_rows=R, perm=perm, iperm=iperm), device)


def _numpy_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return torch.zeros(0, dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def _tensor(a, device, dtype=None):
    """A host array on ``device``. A bfloat16 array (the ``ml_dtypes`` type
    of the JAX package's arrays, which torch cannot read) goes across as
    its bits, viewed as int16 and back as ``torch.bfloat16``."""
    a = np.ascontiguousarray(a, dtype=dtype)
    if a.dtype.name == 'bfloat16':
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor on the host; bfloat16 widened to float32, which NumPy and
    SciPy read."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _flat_residue(levels, level_rows, n_rows, n_cols, R):
    """The residue tiers as one list sorted by output row, host arrays with
    the fields of :class:`~.windowed_kernel.Residue`, or None without
    tiers. The entries are sorted stably by row, so a row's entries keep
    their order in ``level_rows``, which is the order the tiers'
    ``index_add`` adds them in. A slot is live iff its column lies inside
    its source chunk (``src_chunk_size``); dead ones, the tiers' padding,
    are dropped, and an entry keeps its live slots in slot order. The
    heavy rows of the windowed tail
    (:data:`~.windowed_kernel.TAIL_HEAVY_ENTRIES` entries or more) come
    longest first, so that their blocks start first."""
    if not len(levels):
        return None
    counts, cols, vals, src = [], [], [], []
    base = 0
    for lev in levels:
        c = int(lev.src_chunk)
        lc, lv = np.asarray(lev.cols), np.asarray(lev.vals)
        live = lc < min(R, n_cols - c * R)
        counts.append(live.sum(axis=1))
        cols.append(lc[live].astype(np.int64) + c * R)
        vals.append(lv[live])
        src.append(base + np.flatnonzero(live))
        base += lc.size
    counts = np.concatenate(counts)
    rows = np.asarray(level_rows, dtype=np.int64)
    order = np.argsort(rows, kind='stable')
    start = np.zeros(counts.size + 1, np.int64)
    np.cumsum(counts, out=start[1:])
    entptr = np.zeros(counts.size + 1, np.int64)
    np.cumsum(counts[order], out=entptr[1:])
    slot = (np.repeat(start[:-1][order] - entptr[:-1], counts[order])
            + np.arange(entptr[-1]))
    per_row = np.bincount(rows, minlength=n_rows)
    rowptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(per_row, out=rowptr[1:])
    heavy = np.flatnonzero(per_row >= windowed_kernel.TAIL_HEAVY_ENTRIES)
    return dict(rowptr=rowptr, entptr=entptr,
                cols=np.concatenate(cols)[slot],
                vals=np.concatenate(vals)[slot],
                src=np.concatenate(src)[slot],
                heavy=heavy[np.argsort(-per_row[heavy], kind='stable')])


def upload_residue(levels, level_rows, n_rows, n_cols, R, device):
    """The SpMM kernel's residue list of host tiers on ``device``
    (:func:`_flat_residue`), with the kernel's heavy rows
    (:func:`~.ell_kernel.heavy_rows`) in place of the tail's; None without
    tiers."""
    host = _flat_residue(levels, level_rows, n_rows, n_cols, R)
    if host is None:
        return None
    return windowed_kernel.Residue(
        rowptr=_tensor(host['rowptr'], device, np.int32),
        entptr=_tensor(host['entptr'], device, np.int32),
        cols=_tensor(host['cols'], device, np.int32),
        vals=_tensor(host['vals'], device),
        heavy=_tensor(ell_kernel.heavy_rows(host['rowptr'], host['entptr']),
                      device, np.int32),
        src=_tensor(host['src'], device, np.int64))


def upload(host: dict, device) -> ChunkedELLMatrix:
    """The matrix on ``device`` from host arrays: ``blocks`` (a sequence of
    (cols, vals) pairs, or of :class:`ChunkBlock`), ``levels`` (of
    :class:`ChunkLevel` of arrays), ``level_rows``, ``rowptr``,
    ``block_keys``, the ints ``n_rows, n_cols, nnz, chunk_rows`` and
    ``perm``/``iperm`` (None or arrays). The blocks go across as one flat
    buffer per field; the kernel's slot table and residue list are made
    here."""
    R = int(host['chunk_rows'])
    n_rows, n_cols = int(host['n_rows']), int(host['n_cols'])
    n_out = max(-(-n_rows // R), 1)
    pairs = [(np.asarray(b.cols), np.asarray(b.vals)) if isinstance(
        b, ChunkBlock) else (np.asarray(b[0]), np.asarray(b[1]))
             for b in host['blocks']]
    levels = host['levels']
    vdtype = (pairs[0][1].dtype if pairs else
              np.asarray(levels[0].vals).dtype if len(levels) else
              np.float32)
    table_blocks, offset = [], 0
    for (i, c), (bc, _) in zip(host['block_keys'], pairs):
        width = bc.shape[1]
        table_blocks.append((int(i), offset, width, int(c) * R,
                             min(R, n_cols - int(c) * R)))
        offset += bc.size
    slot_cols = _tensor(np.concatenate([bc.ravel() for bc, _ in pairs])
                        if pairs else np.zeros(0, np.int32), device, np.int32)
    slot_vals = _tensor(np.concatenate([bv.ravel() for _, bv in pairs])
                        if pairs else np.zeros(0, vdtype), device)
    vec = {k: None if host[k] is None else _tensor(host[k], device, np.int64)
           for k in ('perm', 'iperm')}
    mat = ChunkedELLMatrix(
        blocks=(), block_keys=tuple((int(i), int(c))
                                    for i, c in host['block_keys']),
        levels=tuple(ChunkLevel(cols=_tensor(lev.cols, device, np.int32),
                                vals=_tensor(lev.vals, device),
                                src_chunk=int(lev.src_chunk))
                     for lev in levels),
        level_rows=_tensor(host['level_rows'], device, np.int32),
        rowptr=_tensor(host['rowptr'], device, np.int32),
        n_rows=n_rows, n_cols=n_cols, nnz=int(host['nnz']), chunk_rows=R,
        slot_cols=slot_cols, slot_vals=slot_vals,
        table=ell_kernel.slot_table(table_blocks, n_out, R, device),
        residue=upload_residue(levels, host['level_rows'], n_rows, n_cols, R,
                               device), **vec)
    return dataclasses.replace(mat, blocks=_block_views(
        slot_cols, slot_vals, mat.table.blocks, mat))


def chunked_from_scipy(mat, *, dtype=None, permute: str | None = None,
                       chunk_rows: int = CHUNK_ROWS,
                       device='cuda') -> ChunkedELLMatrix:
    """scipy sparse → chunked multi-level ELL on ``device``."""
    csr = mat.tocsr()
    csr.sum_duplicates()
    coo = csr.tocoo()
    return chunked_from_host_coo(coo.row, coo.col, coo.data,
                                 coo.shape[0], coo.shape[1],
                                 chunk_rows=chunk_rows, permute=permute,
                                 dtype=dtype, device=device)


def chunked_to_scipy(mat: ChunkedELLMatrix):
    """Export back to scipy CSR: unpack the block slabs and the tiers
    (dropping the sentinel padding) and invert the degree-sort relabeling
    (``A' = A[perm][:, perm]`` → original ids ``perm[r]``)."""
    R = mat.chunk_rows
    rows_l, cols_l, vals_l = [], [], []

    def emit(grows, lcols, vals, src_chunk):
        lcols = lcols.ravel()
        vals = vals.ravel()
        keep = lcols < mat.src_chunk_size(src_chunk)
        rows_l.append(grows[keep])
        cols_l.append(lcols[keep].astype(np.int64) + src_chunk * R)
        vals_l.append(vals[keep])

    for (i, c), blk in zip(mat.block_keys, mat.blocks):
        co = _host(blk.cols)
        if co.size == 0:
            continue
        grows = np.repeat(np.arange(co.shape[0], dtype=np.int64) + i * R,
                          co.shape[1])
        emit(grows, co, _host(blk.vals), c)

    lr = _host(mat.level_rows).astype(np.int64)
    off = 0
    for lev in mat.levels:
        co = _host(lev.cols)
        grows = np.repeat(lr[off:off + co.shape[0]], co.shape[1])
        off += co.shape[0]
        emit(grows, co, _host(lev.vals), lev.src_chunk)

    rows = np.concatenate(rows_l) if rows_l else np.zeros(0, np.int64)
    cols = np.concatenate(cols_l) if cols_l else np.zeros(0, np.int64)
    vals = (np.concatenate(vals_l) if vals_l
            else np.zeros(0, _host(mat.slot_vals[:0]).dtype))
    if mat.perm is not None:
        p = _host(mat.perm).astype(np.int64)
        rows, cols = p[rows], p[cols]
    return sps.csr_matrix((vals, (rows, cols)), shape=mat.shape)
