"""Windowed-compact local SpMM for the sharded (multi-device) engines.

Counterpart of :mod:`pygsp_tpu.parallel.windowed_shards`: each shard of a
:class:`~pygsp_tpu_torch.parallel.partition.ShardedGraph` gets the
single-device windowed-compact format
(:mod:`pygsp_tpu_torch.core.windowed`) for its local (extended-column)
edges, so that its local SpMM runs on the same two kernels as one device's
(kernel D, ``windowed_fold``, and kernel E, ``window_strip``).

The JAX package unifies every data-dependent size across shards at build
time (one slab width ``L`` from the pooled window demands of every shard;
residue tiers with row counts maxed over shards, padded with sentinel rows
``n_out*NW*P`` and sentinel slots), because ``shard_map`` needs one shape
on every shard. The port keeps those shapes, so that its arrays equal the
JAX package's; a rank's :meth:`ShardedWindowed.local_matrix` drops the
padding when it makes its shard's
:class:`~pygsp_tpu_torch.core.windowed.WindowedELLMatrix`.

Column ids live in the extended-local space ``[0, n_local + halo_total)``,
the same receive-slot layout as the COO and ELL paths.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pygsp_tpu_torch.core import windowed
from pygsp_tpu_torch.core.chunked import ChunkLevel, _tensor
from pygsp_tpu_torch.core.windowed import (WINDOW_ROWS, WindowedELLMatrix,
                                           _WIDE_TIER, _auto_span,
                                           _choose_slab_width, _pack_slabs,
                                           _window_counts, auto_chunk_rows,
                                           windowed_spmm, windowed_spmm_chunks)
from pygsp_tpu_torch.parallel.partition import (ShardedGraph, _cached,
                                                _host)


@dataclasses.dataclass(frozen=True)
class ShardedWindowed:
    """Stacked per-shard windowed-compact matrices (leading axis = shard).

    ``cols``/``vals``/``rowid``: ``(S, n_out, NW, n_src, L)`` slot slabs
    in the single-device layout (``rowid`` uint8, or int32 where the JAX
    package's is uint16). ``lvl_cols[k]``/``lvl_vals[k]``: ``(S, m_k,
    w_k)`` residue tier ``k`` (source chunk ``lvl_src[k]``);
    ``level_rows``: ``(S, M)`` local-row ids of every tier entry
    concatenated in tier order (sentinel ``n_out*NW*P`` = padding).
    """

    cols: torch.Tensor
    vals: torch.Tensor
    rowid: torch.Tensor
    lvl_cols: tuple
    lvl_vals: tuple
    level_rows: torch.Tensor
    lvl_src: tuple
    n_local: int
    n_ext: int
    nnz: int
    chunk_rows: int
    window_rows: int
    borrow_span: int = 2

    _META = ('lvl_src',)

    @property
    def dtype(self):
        return self.vals.dtype

    def astype(self, dtype) -> 'ShardedWindowed':
        """Cast the stored values (slabs and residue tiers), e.g. to bf16
        for the fast mode (pair with ``carry_dtype``)."""
        return dataclasses.replace(
            self, vals=self.vals.to(dtype),
            lvl_vals=tuple(v.to(dtype) for v in self.lvl_vals))

    def local_matrix(self) -> WindowedELLMatrix:
        """This shard's slice (leading axis 1, as one rank holds it, see
        :func:`~pygsp_tpu_torch.parallel.partition.shard_slice`) as a
        single-device matrix on its device, the sentinel tier entries
        dropped and the tail's residue list made; built once and kept."""
        return _cached(self, 'windowed', self._make_local)

    def _make_local(self) -> WindowedELLMatrix:
        if self.cols.shape[0] != 1:
            raise ValueError('local_matrix takes one shard: cut the stacked '
                             'layout with shard_slice first')
        rows = _host(self.level_rows[0]).astype(np.int64)
        levels, kept, off = [], [], 0
        for lc, lv, c in zip(self.lvl_cols, self.lvl_vals, self.lvl_src):
            m = lc.shape[1]
            # a sentinel row (n_out·NW·P, at least n_local) is padding
            live = rows[off:off + m] < self.n_local
            if live.any():
                levels.append(ChunkLevel(cols=_host(lc[0])[live],
                                         vals=_host(lv[0])[live],
                                         src_chunk=int(c)))
                kept.append(rows[off:off + m][live])
            off += m
        rowid = _host(self.rowid[0])
        mat = windowed.upload(dict(
            cols=_host(self.cols[0]), vals=_host(self.vals[0]),
            rowid=rowid, levels=tuple(levels),
            level_rows=(np.concatenate(kept) if kept
                        else np.zeros(0, np.int64)),
            rowptr=np.zeros(0, np.int32), n_rows=self.n_local,
            n_cols=self.n_ext, nnz=self.nnz, chunk_rows=self.chunk_rows,
            window_rows=self.window_rows, borrow_span=self.borrow_span,
            perm=None, iperm=None), self.vals.device)
        if self.vals.dtype == torch.bfloat16:
            mat = mat.astype(torch.bfloat16)
        return mat

    def local_spmm(self, x: torch.Tensor) -> torch.Tensor:
        """``y = A_shard @ x`` with full-array input and output."""
        return windowed_spmm(self.local_matrix(), x)

    def local_spmm_chunks(self, x_chunks, out_dtype=None) -> tuple:
        """``y_chunks = A_shard @ x_chunks``, tuple-of-chunk form (API
        parity with the JAX package's chunk-carried recurrence)."""
        return windowed_spmm_chunks(self.local_matrix(), x_chunks,
                                    out_dtype=out_dtype)


def _fixed_residue_tiers(per_shard_residue, R, n_src, vdtype, n_out_rows):
    """Pack every shard's residue COO into SHARED-shape level tiers.

    ``per_shard_residue``: list over shards of ``(rows, cols, vals)``
    (cols in extended-local space). Returns ``(lvl_cols, lvl_vals,
    level_rows, lvl_src)`` with stacked ``(S, m, w)`` host tiers, row counts
    maxed over shards, sentinel-padded (rows -> ``n_out_rows``, slots ->
    column ``R`` with 0 value).
    """
    S = len(per_shard_residue)
    W = _WIDE_TIER

    grouped = [dict() for _ in range(S)]
    m1 = np.zeros(n_src, np.int64)
    mw = np.zeros(n_src, np.int64)
    for s, (rr, rc, rv) in enumerate(per_shard_residue):
        if rr.size == 0:
            continue
        rchunk = rc // R
        o = np.lexsort((rr, rchunk))
        rr, rc, rv, rchunk = rr[o], rc[o], rv[o], rchunk[o]
        for c in np.unique(rchunk):
            msk = rchunk == c
            crows, ccols, cvals = rr[msk], rc[msk] % R, rv[msk]
            urows, ucounts = np.unique(crows, return_counts=True)
            grouped[s][int(c)] = (crows, ccols, cvals, urows, ucounts)
            m1[c] = max(m1[c], urows.size)
            mw[c] = max(mw[c], int((-(-(ucounts - 1) // W)).sum()))

    lvl_cols, lvl_vals, lvl_src = [], [], []
    level_rows_parts = [[] for _ in range(S)]
    for c in range(n_src):
        for width, m in ((1, int(m1[c])), (W, int(mw[c]))):
            if m == 0:
                continue
            tc = np.full((S, m, width), R, np.int32)
            tv = np.zeros((S, m, width), vdtype)
            tr = np.full((S, m), n_out_rows, np.int32)
            for s in range(S):
                g = grouped[s].get(c)
                if g is None:
                    continue
                crows, ccols, cvals, urows, ucounts = g
                ustarts = np.zeros(urows.size, np.int64)
                np.cumsum(ucounts[:-1], out=ustarts[1:])
                if width == 1:
                    tc[s, :urows.size, 0] = ccols[ustarts]
                    tv[s, :urows.size, 0] = cvals[ustarts]
                    tr[s, :urows.size] = urows
                else:
                    rem = ucounts - 1
                    n_ent = -(-rem // W)
                    wide = np.flatnonzero(n_ent > 0)
                    if not wide.size:
                        continue
                    tot = int(n_ent[wide].sum())
                    ent_row = np.repeat(wide, n_ent[wide])
                    ent_start = np.zeros(wide.size + 1, np.int64)
                    np.cumsum(n_ent[wide], out=ent_start[1:])
                    k = np.arange(tot, dtype=np.int64) - np.repeat(
                        ent_start[:-1], n_ent[wide])
                    st = ustarts[ent_row] + 1 + k * W
                    en = ustarts[ent_row] + ucounts[ent_row]
                    idx = st[:, None] + np.arange(W)[None, :]
                    valid = idx < en[:, None]
                    idx = np.minimum(idx, crows.size - 1)
                    tc[s, :tot] = np.where(valid, ccols[idx], R)
                    tv[s, :tot] = np.where(valid, cvals[idx], 0)
                    tr[s, :tot] = urows[ent_row]
            lvl_cols.append(tc)
            lvl_vals.append(tv)
            lvl_src.append(c)
            for s in range(S):
                level_rows_parts[s].append(tr[s])

    if lvl_cols:
        level_rows = np.stack([np.concatenate(p)
                               for p in level_rows_parts]).astype(np.int32)
    else:
        level_rows = np.zeros((S, 0), np.int32)
    return lvl_cols, lvl_vals, level_rows, tuple(lvl_src)


def shard_local_windowed(sg: ShardedGraph, *,
                         window_rows: int = WINDOW_ROWS,
                         chunk_rows: int | None = None,
                         slab_width: int | None = None,
                         hub_degree: int | None = None,
                         split_boundary: bool = False,
                         borrow_span: int | None = None,
                         max_chunk_rows: int | None = None):
    """Convert a ShardedGraph's per-shard COO into stacked windowed form,
    on the partition's device.

    With ``split_boundary=True``, returns ``(interior, boundary)``: the
    interior matrix references only owned vertices (applied to
    ``x_local``) and the boundary matrix only halo columns, rebased to
    ``[0, halo_total)`` (applied to the received block), with one shared
    chunk size.
    """
    n_local = sg.n_local
    n_ext = n_local + sg.halo_total
    rows, cols, vals = _host(sg.rows), _host(sg.cols), _host(sg.vals)
    dev = sg.device

    if split_boundary:
        def filtered(col_mask_fn, col_base, ncols):
            parts = []
            for s in range(rows.shape[0]):
                real = rows[s] < n_local
                keep = real & col_mask_fn(cols[s])
                parts.append((rows[s][keep], cols[s][keep] - col_base,
                              vals[s][keep]))
            return parts, ncols
        if chunk_rows is None:
            nnz_est = sum(int((rows[s] < n_local).sum())
                          for s in range(rows.shape[0]))
            chunk_rows = auto_chunk_rows(
                nnz_est // max(sg.n_shards, 1), n_local,
                max(n_ext, n_local), window_rows,
                max_rows=max_chunk_rows)
        interior = _build(sg.n_local, vals.dtype,
                          *filtered(lambda c: c < n_local, 0, n_local),
                          window_rows, chunk_rows, slab_width, hub_degree,
                          borrow_span=borrow_span, device=dev)
        boundary = _build(sg.n_local, vals.dtype,
                          *filtered(lambda c: c >= n_local, n_local,
                                    max(sg.halo_total, 1)),
                          window_rows, chunk_rows, slab_width, hub_degree,
                          borrow_span=borrow_span, device=dev)
        return interior, boundary

    parts = []
    for s in range(rows.shape[0]):
        real = rows[s] < n_local
        parts.append((rows[s][real], cols[s][real], vals[s][real]))
    return _build(sg.n_local, vals.dtype, parts, n_ext,
                  window_rows, chunk_rows, slab_width, hub_degree,
                  borrow_span=borrow_span, max_chunk_rows=max_chunk_rows,
                  device=dev)


def _build(n_local, vdtype_in, parts, n_ext, window_rows, chunk_rows,
           slab_width, hub_degree, borrow_span=None, max_chunk_rows=None,
           *, device='cuda'):
    """Stack per-device (rows, cols, vals) blocks — rows in
    ``[0, n_local)``, cols in ``[0, n_ext)``, rectangular allowed — into
    one uniform-shape :class:`ShardedWindowed` on ``device`` (also used by
    the 2-D edge partition, where each block is ``L[R_i, C_j]``)."""
    S = len(parts)
    P = int(window_rows)
    if chunk_rows is None:
        nnz_est = sum(int(p[0].size) for p in parts)
        R = auto_chunk_rows(max(nnz_est // max(S, 1), 1), n_local,
                            max(n_ext, n_local), P,
                            max_rows=max_chunk_rows)
    else:
        R = int(chunk_rows)
    if R % P:
        raise ValueError(f'chunk_rows ({R}) must be a multiple of '
                         f'window_rows ({P})')
    n_out = max(-(-n_local // R), 1)
    n_src = max(-(-n_ext // R), 1)
    NW = R // P
    vdtype = vdtype_in

    nnz_total = sum(int(p[0].size) for p in parts)
    if hub_degree is None:
        lam_w = P * (nnz_total / max(S * n_local, 1)) / n_src
        hub_degree = max(2 * P,
                         int(4.0 * np.sqrt(max(lam_w, 1.0)) * n_src))

    shard_data = []
    all_counts = []
    for r, c, v in parts:
        r = r.astype(np.int64)
        c = c.astype(np.int64)
        deg = (np.bincount(r, minlength=n_local) if r.size
               else np.zeros(n_local, np.int64))
        is_hub = deg[r] >= hub_degree
        counts = _window_counts(r, c, is_hub, n_local, n_ext, R, P)
        shard_data.append((r, c, v, is_hub, counts))
        all_counts.append(counts.reshape(-1, R // P).astype(np.float64))
    pooled = np.concatenate(all_counts, axis=0)
    if borrow_span is None:
        borrow_span = _auto_span(float(pooled.mean()) if pooled.size
                                 else 0.0, P)
    K = int(borrow_span)
    if K < 2 or K * P > 65536:
        raise ValueError(f'borrow_span must be in [2, {65536 // P}] for '
                         f'window_rows={P} (uint16 row ids)')
    if slab_width is None:
        L = _choose_slab_width(pooled, P, span=K)
    else:
        L = int(slab_width)

    cols4, vals4, rowid4, residue = [], [], [], []
    for r, c, v, is_hub, counts in shard_data:
        c4, v4, r4, rr, rc, rv = _pack_slabs(r, c, v, is_hub, n_local,
                                             n_ext, R, P, L, counts=counts,
                                             span=K)
        cols4.append(c4)
        vals4.append(v4)
        rowid4.append(r4)
        residue.append((rr, rc, rv))

    lvl_cols, lvl_vals, level_rows, lvl_src = _fixed_residue_tiers(
        residue, R, n_src, vdtype, n_out * NW * P)

    rowid = np.stack(rowid4)
    rid_dt = np.uint8 if rowid.dtype == np.uint8 else np.int32
    return ShardedWindowed(
        cols=_tensor(np.stack(cols4), device),
        vals=_tensor(np.stack(vals4), device),
        rowid=_tensor(rowid, device, rid_dt),
        lvl_cols=tuple(_tensor(a, device) for a in lvl_cols),
        lvl_vals=tuple(_tensor(a, device) for a in lvl_vals),
        level_rows=_tensor(level_rows, device), lvl_src=lvl_src,
        n_local=int(n_local), n_ext=int(n_ext), nnz=nnz_total,
        chunk_rows=R, window_rows=P, borrow_span=K)
