"""2-D edge-partitioned spectral ops: communication bounds that do not
depend on the graph.

Counterpart of :mod:`pygsp_tpu.parallel.twod`. Vertices are split into
``p = pr·pc`` slices; device ``(i, j)`` (rank ``i·pc + j`` of a
``('row', 'col')`` mesh) owns the Laplacian block ``L[R_i, C_j]``, where
the row group ``R_i`` is the union of slices ``{(i, j') : j'}`` and the
column group ``C_j`` is ``{(i', j) : i'}``. One matvec is then

1. the all-gather of the local ``x`` slice along the mesh's 'row' axis
   (every device of mesh column ``j`` assembles ``x[C_j]``),
2. a local SpMM ``L[R_i, C_j] @ x[C_j]``,
3. the reduce-scatter of the partial products along 'col', the sum
   landing on the owning slices.

The ring layouts (``twod_local_windowed(ring=True)``, the JAX package's
deployed layout) replace the all-gather by a chain of ``pr − 1`` ring
shifts along 'row', one matrix per source slice; with ``split_cols`` the
reduce-scatter becomes a ring along 'col' too. Their schedule is the JAX
package's ``_cheby_op_2d_ring``:

- the whole chain of row shifts is posted first
  (:func:`~.mesh.ppermute_chain_post`: on the card on a side stream, so
  that no link waits for the folds enqueued after it);
- ring step 0's matrix, which reads this rank's own slice, is folded
  under the chain, then, after the wait, steps 1..pr−1 in one launch of
  the fused SpMM, and the two are added (``first_separate``);
- each column hop is posted before the fold of its position and its
  partial added after that fold.

Every ring fold, a single matrix's too, is one launch of the fused SpMM
(:func:`~pygsp_tpu_torch.core.windowed.spmm_multi_internal`, two where a
window does not fit a block). The named ranges (``ring_shift``,
``ring_fold0``, ``ring_fold_fused``, ``col_ring_hop``, ``ring_fold_s<s>``,
``mono_fold*``) are the JAX package's scopes.

Signals are the calling rank's slice, ``n_local`` rows (the slice ``i·pc +
j`` of the padded signal); so are the results.

Departure by design: the port carries whole tensors, not tuples of
chunks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sps
import torch

from pygsp_tpu_torch.core import windowed
from pygsp_tpu_torch.core.windowed import WINDOW_ROWS, spmm_multi_internal
from pygsp_tpu_torch.core.windowed_kernel import merge_residues
from pygsp_tpu_torch.core import sparse as sp
from pygsp_tpu_torch.core.chunked import _tensor
from pygsp_tpu_torch.parallel.mesh import (Mesh, all_gather,
                                           ppermute_chain_post,
                                           ppermute_post, ppermute_wait,
                                           psum_scatter, scope)
from pygsp_tpu_torch.parallel.partition import (_cached, _host,
                                                _laplacian_entries,
                                                _np_dtype, _round_up,
                                                cluster_shards)
from pygsp_tpu_torch.parallel.sharded import (_Bank, _Matvec, _Side,
                                              _Synthesis, _analysis, _leaf,
                                              _local_windowed, _matvec,
                                              _prepare, _product, _records,
                                              _synthesis)
from pygsp_tpu_torch.parallel.windowed_shards import _build
from pygsp_tpu_torch.utils import check_device


@dataclasses.dataclass(frozen=True)
class TwoDGraph:
    """Stacked per-device edge blocks (leading axis = device, row-major
    over the ``(row, col)`` mesh: device ``(i, j)`` is index ``i·pc + j``).

    rows: (P, E) int32 — row of each edge within its device's row group
        ``R_i``, laid out as ``[slice (i,0) ‖ slice (i,1) ‖ ...]``
        (``pc·n_local`` ⇒ padding).
    cols: (P, E) int32 — column within the column group ``C_j``, in
        mesh-row order (the all-gather's concatenation order).
    vals: (P, E) — Laplacian off-diagonal values.
    diag: (P, n_local) — Laplacian diagonal, on the x distribution.
    perm: (N,) int32 — original vertex id → padded position.
    """

    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    diag: torch.Tensor
    perm: torch.Tensor
    pr: int
    pc: int
    n_local: int
    n_vertices: int
    lap_type: str

    @property
    def n_devices(self) -> int:
        return self.pr * self.pc

    @property
    def n_padded(self) -> int:
        return self.n_devices * self.n_local

    @property
    def comm_rows_per_step(self) -> int:
        """Rows moved per device per matvec (all-gather + reduce-scatter),
        whatever the graph: the point of the 2-D layout."""
        return (self.pr - 1 + self.pc - 1) * self.n_local

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self):
        return self.vals.device

    def pad_signal(self, x):
        """Reorder + zero-pad (N, ...) → (P·n_local, ...), on the
        partition's device."""
        x = torch.as_tensor(x, device=self.device)
        out = torch.zeros((self.n_padded,) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=self.device)
        out[self.perm.long()] = x
        return out

    def unpad_signal(self, y):
        y = torch.as_tensor(y)
        return y[self.perm.to(y.device).long()]


def make_mesh_2d(pr: int, pc: int, devices=None) -> Mesh:
    """('row', 'col') mesh over the first ``pr·pc`` ranks of the world
    (``devices`` as in :func:`~pygsp_tpu_torch.parallel.sharded.
    make_mesh`)."""
    return Mesh({'row': pr, 'col': pc}, devices)


def partition_graph_2d(W, pr: int, pc: int,
                       lap_type: str = 'combinatorial',
                       reorder: str = 'shuffle',
                       dtype=None, *, device='cuda') -> TwoDGraph:
    """Partition a symmetric scipy adjacency into 2-D edge blocks.

    Vertices are split into ``pr·pc`` nnz-balanced contiguous slices of the
    (optionally reordered) vertex sequence; edge ``(u, v)`` lands on device
    ``(i_u, j_v)``. ``reorder``: 'shuffle' (default, a seeded global
    shuffle: balanced edges and ``n_local ≈ N/p``), 'none', 'rcm',
    'cluster'. A second seeded shuffle inside each slice spreads hub rows
    over the windows. The JAX package's NumPy, so the same arrays;
    ``dtype`` (default float32) and ``device`` as in
    :func:`~pygsp_tpu_torch.parallel.partition.partition_graph`.
    """
    device = check_device(device, 'partition_graph_2d')
    W = sps.csr_matrix(W)
    N = W.shape[0]
    p = pr * pc
    dtype = _np_dtype(dtype)

    if reorder == 'rcm':
        order = sps.csgraph.reverse_cuthill_mckee(W, symmetric_mode=True)
    elif reorder == 'none':
        order = np.arange(N)
    elif reorder == 'shuffle':
        order = np.random.default_rng(0x5EED).permutation(N)
    elif reorder == 'cluster':
        labels = cluster_shards(W, p)
        order = np.argsort(labels, kind='stable')
    else:
        raise ValueError(f'Unknown reorder {reorder!r}')
    Wp = W[order][:, order].tocsr()

    deg_rank = np.diff(Wp.indptr)
    cum = np.cumsum(deg_rank + 1)
    targets = cum[-1] / p * np.arange(1, p)
    bounds = np.concatenate(
        [[0], np.searchsorted(cum, targets, side='left'), [N]]
    ).astype(np.int64)
    bounds = np.maximum.accumulate(bounds)
    range_len = np.diff(bounds)
    rl = int(range_len.max())
    align = 1024 if rl >= 65536 else (128 if rl >= 8192 else 8)
    n_local = max(_round_up(rl, align), align)

    slice_of_rank = np.searchsorted(bounds, np.arange(N), side='right') - 1
    sh_rng = np.random.default_rng(0x5EED ^ 0x9E3779B9)
    local_pos = np.empty(N, dtype=np.int64)
    for s_ in range(p):
        local_pos[bounds[s_]:bounds[s_ + 1]] = sh_rng.permutation(
            n_local)[:bounds[s_ + 1] - bounds[s_]]
    pos_of_rank = slice_of_rank * n_local + local_pos
    perm = np.empty(N, dtype=np.int64)
    perm[order] = pos_of_rank

    coo, vals_all, diag_all = _laplacian_entries(Wp, lap_type, dtype)
    q_row = pos_of_rank[coo.row]
    q_col = pos_of_rank[coo.col]
    s_row, r_row = q_row // n_local, q_row % n_local
    s_col, r_col = q_col // n_local, q_col % n_local
    dev = (s_row // pc) * pc + (s_col % pc)
    row_local = (s_row % pc) * n_local + r_row
    col_local = (s_col // pc) * n_local + r_col

    counts = np.bincount(dev, minlength=p)
    E = max(_round_up(int(counts.max()), 1024), 1024)
    n_row_ext = pc * n_local
    rows_arr = np.full((p, E), n_row_ext, dtype=np.int32)
    cols_arr = np.zeros((p, E), dtype=np.int32)
    vals_arr = np.zeros((p, E), dtype=dtype)
    dev_order = np.lexsort((row_local, dev))
    dev_s = dev[dev_order]
    starts = np.searchsorted(dev_s, np.arange(p))
    ends = np.searchsorted(dev_s, np.arange(p), side='right')
    for d_ in range(p):
        sl = dev_order[starts[d_]:ends[d_]]
        ne = len(sl)
        rows_arr[d_, :ne] = row_local[sl]
        cols_arr[d_, :ne] = col_local[sl]
        vals_arr[d_, :ne] = vals_all[sl]

    flat = np.zeros(p * n_local, dtype=dtype)
    flat[pos_of_rank] = diag_all
    diag_arr = flat.reshape(p, n_local)

    return TwoDGraph(
        rows=_tensor(rows_arr, device), cols=_tensor(cols_arr, device),
        vals=_tensor(vals_arr, device), diag=_tensor(diag_arr, device),
        perm=_tensor(perm, device, np.int32),
        pr=pr, pc=pc, n_local=n_local, n_vertices=N, lap_type=lap_type)


def twod_local_windowed(tg: TwoDGraph, *, window_rows=None,
                        chunk_rows=None, slab_width=None, hub_degree=None,
                        ring: bool = False, split_cols: bool = False,
                        borrow_span=None, max_chunk_rows=None,
                        mono: bool = False):
    """Windowed-compact layout of every device's edge block (kernels D and
    E), on the partition's device, with the JAX package's shapes.

    ``ring=True``: a tuple of ``pr`` matrices, one per ring step; device
    ``(i, j)``'s step-``k`` matrix holds the block column of source slice
    ``((i − k) mod pr, j)``, columns rebased to ``[0, n_local)``, all with
    one ``chunk_rows`` and one borrow span (the fused multi-matrix fold
    needs both). ``split_cols=True`` as well: ``mats[k][s]``, the step-k
    matrix split by output block in each device's col-ring schedule order
    (position ``s``: destination ``(i, (j − 1 − s) mod pc)``), rows rebased
    to ``[0, n_local)``. ``mono=True``: one matrix per device over the
    ring-ordered column space ``[0, pr·n_local)`` (its ``chunk_rows``
    divides ``n_local``), or with ``split_cols`` one per destination.
    """
    rows, cols, vals = _host(tg.rows), _host(tg.cols), _host(tg.vals)
    n_row_ext = tg.pc * tg.n_local
    dev = tg.device
    if not ring:
        parts = []
        for d_ in range(tg.n_devices):
            real = rows[d_] < n_row_ext
            parts.append((rows[d_][real], cols[d_][real], vals[d_][real]))
        return _build(n_row_ext, vals.dtype, parts, tg.pr * tg.n_local,
                      window_rows or WINDOW_ROWS, chunk_rows, slab_width,
                      hub_degree, borrow_span=borrow_span,
                      max_chunk_rows=max_chunk_rows, device=dev)

    P_ = window_rows or WINDOW_ROWS
    if mono:
        if chunk_rows is None:
            nnz_est = int(sum((rows[d_] < n_row_ext).sum()
                              for d_ in range(tg.n_devices)))
            r_auto = windowed.auto_chunk_rows(
                nnz_est // max(tg.n_devices, 1), n_row_ext,
                tg.pr * tg.n_local, P_, max_rows=max_chunk_rows)
            ns_loc = max(1, -(-tg.n_local // r_auto))
            while (tg.n_local % ns_loc
                   or (tg.n_local // ns_loc) % P_):
                ns_loc += 1
                if ns_loc > tg.n_local:
                    raise ValueError(
                        f'mono layout needs chunk_rows dividing n_local '
                        f'({tg.n_local}) in multiples of window_rows '
                        f'({P_}) — pass chunk_rows explicitly')
            chunk_rows = tg.n_local // ns_loc
        elif tg.n_local % int(chunk_rows):
            raise ValueError(f'mono layout: chunk_rows ({chunk_rows}) '
                             f'must divide n_local ({tg.n_local})')
        mono_parts = []
        for d_ in range(tg.n_devices):
            i = d_ // tg.pc
            real = rows[d_] < n_row_ext
            r, c_, v = rows[d_][real], cols[d_][real], vals[d_][real]
            k = (i - c_ // tg.n_local) % tg.pr
            mono_parts.append((r, k * tg.n_local + c_ % tg.n_local, v))
        if not split_cols:
            return (_build(n_row_ext, vals.dtype, mono_parts,
                           tg.pr * tg.n_local, P_, chunk_rows,
                           slab_width, hub_degree,
                           borrow_span=borrow_span, device=dev),)
        row_s, span = [], borrow_span
        for s in range(tg.pc):
            parts = []
            for d_, (r, cm, v) in enumerate(mono_parts):
                j = d_ % tg.pc
                dest = (j - 1 - s) % tg.pc
                seld = r // tg.n_local == dest
                parts.append((r[seld] - dest * tg.n_local, cm[seld],
                              v[seld]))
            row_s.append(_build(tg.n_local, vals.dtype, parts,
                                tg.pr * tg.n_local, P_, chunk_rows,
                                slab_width, hub_degree,
                                borrow_span=span, device=dev))
            if span is None:
                span = row_s[0].borrow_span
        return (tuple(row_s),)

    if chunk_rows is None:
        nnz_est = int(sum((rows[d_] < n_row_ext).sum()
                          for d_ in range(tg.n_devices)))
        chunk_rows = windowed.auto_chunk_rows(
            nnz_est // max(tg.n_devices * tg.pr, 1), n_row_ext,
            tg.n_local, P_, max_rows=max_chunk_rows)
    if not split_cols:
        mats = []
        for k in range(tg.pr):
            parts = []
            for d_ in range(tg.n_devices):
                i = d_ // tg.pc
                real = rows[d_] < n_row_ext
                r, c_, v = rows[d_][real], cols[d_][real], vals[d_][real]
                sel = (i - c_ // tg.n_local) % tg.pr == k
                parts.append((r[sel], c_[sel] % tg.n_local, v[sel]))
            mats.append(_build(n_row_ext, vals.dtype, parts, tg.n_local,
                               P_, chunk_rows, slab_width, hub_degree,
                               borrow_span=borrow_span, device=dev))
            if borrow_span is None:
                borrow_span = mats[0].borrow_span
        return tuple(mats)

    mats = []
    for k in range(tg.pr):
        row_k = []
        for s in range(tg.pc):
            parts = []
            for d_ in range(tg.n_devices):
                i, j = d_ // tg.pc, d_ % tg.pc
                dest = (j - 1 - s) % tg.pc
                real = rows[d_] < n_row_ext
                r, c_, v = rows[d_][real], cols[d_][real], vals[d_][real]
                sel = (((i - c_ // tg.n_local) % tg.pr == k)
                       & (r // tg.n_local == dest))
                parts.append((r[sel] - dest * tg.n_local,
                              c_[sel] % tg.n_local, v[sel]))
            row_k.append(_build(tg.n_local, vals.dtype, parts,
                                tg.n_local, P_, chunk_rows, slab_width,
                                hub_degree, borrow_span=borrow_span,
                                device=dev))
            if borrow_span is None:
                borrow_span = row_k[0].borrow_span
        mats.append(tuple(row_k))
    return tuple(mats)


def _csr_block(tg: TwoDGraph, d: int) -> sp.CSRMatrix:
    """Device ``d``'s edge block as a CSR (pc·n_local × pr·n_local), kernel
    A's operand; built once and kept."""
    def build():
        rows, cols = _leaf(tg.rows, d), _leaf(tg.cols, d)
        n_rows, n_cols = tg.pc * tg.n_local, tg.pr * tg.n_local
        real = rows < n_rows
        counts = torch.bincount(rows[real].long(), minlength=n_rows)
        rowptr = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
        return sp.CSRMatrix(rows=rows, cols=torch.where(real, cols, n_cols),
                            vals=_leaf(tg.vals, d),
                            rowptr=rowptr.to(torch.int32), n_rows=n_rows,
                            n_cols=n_cols, nnz=int(real.sum()))
    return _cached(tg, ('csr', d), build)


class _Device2D(_Side):
    """One rank's side of the 2-D operator: its diagonal and the
    off-diagonal product of its slice (the JAX package's ``_matvec_2d``,
    and with a ring layout ``_ring_body_setup``'s ``offdiag_apply``: the
    ring bodies ``collect_sources``, ``fused_fold``,
    ``offdiag_interleaved`` and ``offdiag_mono``)."""

    def __init__(self, tg: TwoDGraph, mesh: Mesh, ell, sdt=None):
        if (mesh.shape.get('row'), mesh.shape.get('col')) != (tg.pr, tg.pc):
            raise ValueError(f"the mesh's ('row', 'col') shape must be "
                             f'({tg.pr}, {tg.pc}), got {mesh.shape}')
        self.tg, self.mesh, self.ell, self.sdt = tg, mesh, ell, sdt
        self.n_devices = tg.n_devices
        d = self.d = mesh.index('row') * tg.pc + mesh.index('col')
        self.diag = _leaf(tg.diag, d)
        self.ring = isinstance(ell, tuple)
        if not self.ring:
            self.mat = (_csr_block(tg, d) if ell is None
                        else _local_windowed(ell, d))
            return
        self.interleave = isinstance(ell[0], tuple)
        self.mono = len(ell) == 1 and tg.pr > 1
        if self.mono and self.interleave:
            self.mats = tuple(_local_windowed(e, d) for e in ell[0])
        elif self.mono:
            self.mats = (_local_windowed(ell[0], d),)
        elif self.interleave:
            self.mats = tuple(tuple(_local_windowed(e, d) for e in row)
                              for row in ell)
        else:
            self.mats = tuple(_local_windowed(e, d) for e in ell)
        if self.mono:
            return
        # the ring folds, one group of matrices a fold position, each with
        # its residue lists merged for the fused SpMM once a layout and
        # device; at pr > 1 position 0's as ring step 0 alone and steps
        # 1..pr-1, folded apart
        groups = ([[row[s] for row in self.mats] for s in range(tg.pc)]
                  if self.interleave else [list(self.mats)])
        layout = ell[0][0] if self.interleave else ell[0]

        def merged(key, mats):
            return _cached(layout, ('merged', d, key), lambda: _merged(mats))

        self.first = ((merged('step0', groups[0][:1]),
                       merged('rest', groups[0][1:])) if tg.pr > 1 else None)
        self.groups = [None if s == 0 and self.first else merged(s, g)
                       for s, g in enumerate(groups)]

    def product(self, t, out_dtype):
        """The off-diagonal of this rank's slice times the distributed
        ``t``, in ``out_dtype``."""
        shape = t.shape
        t2 = t.reshape(shape[0], -1)
        odt = self.diag.dtype
        if self.ring:
            y = self._ring(t2, odt)
        else:
            xg = all_gather(self.mesh, 'row', t2)
            part = _product(self.mat, xg, torch.promote_types(odt, t2.dtype))
            y = psum_scatter(self.mesh, 'col', part)
        return y.to(out_dtype).reshape(shape)

    def _col_ring(self, r, fold_at, odt, name):
        """The ring reduce-scatter along 'col': ``r`` is position 0's
        partial; for each later position ``s`` the partial so far is
        posted to the rank ahead, this rank's fold of position ``s`` runs
        under the hop (range ``name + s``), and the partial received from
        the rank behind is added to it."""
        sdt = self.sdt
        for s in range(1, self.tg.pc):
            send = r if sdt is None else r.to(sdt)
            with scope('col_ring_hop'):
                hop = ppermute_post(self.mesh, 'col', [(1, send)])
            with scope(f'{name}{s}'):
                r = fold_at(s)
            r = r + ppermute_wait(hop)[0].to(odt)
        return r

    def _scatter(self, y, odt):
        if self.tg.pc == 1:
            return y
        if self.sdt is not None:
            return psum_scatter(self.mesh, 'col', y.to(self.sdt)).to(odt)
        return psum_scatter(self.mesh, 'col', y)

    def _ring(self, t2, odt):
        """The ring's off-diagonal product: every source slice collected
        by the row shifts (step k holds slice ``(i − k) mod pr``), folded
        as the JAX package's ``offdiag_apply`` schedules it."""
        dt = t2.dtype
        with scope('ring_shift'):
            chain = ppermute_chain_post(self.mesh, 'row', t2,
                                        self.tg.pr - 1)
        if self.mono:
            xcat = torch.cat([t2] + ppermute_wait(chain))
            if not self.interleave:
                with scope('mono_fold'):
                    y = _product(self.mats[0], xcat, dt)
                return self._scatter(y, odt)
            with scope('mono_fold_s0'):
                y = _product(self.mats[0], xcat, dt)
            return self._col_ring(
                y, lambda s: _product(self.mats[s], xcat, dt), odt,
                'mono_fold_s')
        if self.first is None:                   # pr = 1: no shift to hide
            srcs = [t2] + ppermute_wait(chain)
            with scope('ring_fold_fused'):
                y = _fold(self.groups[0], srcs, dt)
        else:
            step0, rest = self.first
            with scope('ring_fold0'):
                y0 = _fold(step0, [t2], dt)
            srcs = [t2] + ppermute_wait(chain)
            with scope('ring_fold_fused'):
                y = y0 + _fold(rest, srcs[1:], dt)
        if self.interleave:
            return self._col_ring(
                y, lambda s: _fold(self.groups[s], srcs, dt), odt,
                'ring_fold_s')
        return self._scatter(y, odt)


def _merged(mats):
    """``(mats, their residue lists merged)``: a fold of the ring."""
    return mats, merge_residues([m.residue for m in mats], mats[0].n_rows)


def _fold(group, srcs, dt):
    """``Σ_k mats[k] @ srcs[k]`` of a :func:`_merged` group, in ``dt``:
    one launch of the fused SpMM (two where a window does not fit a
    block)."""
    mats, residue = group
    return spmm_multi_internal(mats, srcs, residue, out_dtype=dt)


# the 2-D mesh's axes, over which c̄'s dots are summed
AXES_2D = ('row', 'col')


def matvec_2d(tg: TwoDGraph, x, mesh: Mesh, ell=None):
    """``L @ x`` for this rank's slice ``x`` (n_local, ...). Pass ``ell =
    twod_local_windowed(tg)`` (or a ring layout) to take kernels D and E;
    without, kernel A runs on the block's CSR. Under autograd x̄ is the
    matvec of the cotangent."""
    x = torch.as_tensor(x)
    dv = _Device2D(tg, mesh, ell)
    x = x.to(torch.promote_types(x.dtype, tg.dtype))
    if _records('matvec_2d', (x,), parts=(tg, ell)):
        return _Matvec.apply(dv, x)
    return _matvec(dv, x)


def cheby_op_2d(tg: TwoDGraph, lmax, c, x, mesh: Mesh, ell=None,
                carry_dtype=None, carry_tol=None, scatter_dtype=None):
    """Chebyshev filter bank on the 2-D edge partition.

    Same math as :func:`pygsp_tpu_torch.ops.chebyshev.cheby_op`; ``c``
    (Nf, m+1), ``x`` this rank's slice (n_local, ...); returns (Nf,
    n_local, ...). ``carry_dtype`` (e.g. bf16): the recurrence terms, and
    so the all-gather (ring shift) payload, move at half the bytes; gated
    by the single-device bound. ``scatter_dtype`` (ring layouts only): the
    dtype of the 'col' reduction's partial products on the wire; without
    it they move in the dtype the fold emits (the carry's, as in the JAX
    package). Under autograd the bank differentiates with respect to ``c``
    and ``x`` on every layout (the engines' ``_Bank``, c̄ summed over both
    mesh axes).
    """
    c, x, cdt = _prepare(c, x, tg.dtype, carry_dtype, carry_tol)
    if scatter_dtype is not None and not isinstance(ell, tuple):
        raise ValueError('scatter_dtype requires the ring layout '
                         '(twod_local_windowed(ring=True))')
    dv = _Device2D(tg, mesh, ell, scatter_dtype)
    if _records('cheby_op_2d', (c, x), lmax, (tg, ell),
                cdt is not None or scatter_dtype is not None):
        return _Bank.apply(dv, float(lmax), AXES_2D, c, x)
    return _analysis(dv.product, dv.diag, float(lmax), c, x, cdt,
                     dv.group(x, c.shape[0], cdt))


def cheby_synthesis_2d(tg: TwoDGraph, lmax, c, y, mesh: Mesh, ell=None,
                       carry_dtype=None, carry_tol=None,
                       scatter_dtype=None):
    """Synthesis on the 2-D edge partition: ``c`` (Nf, m+1), ``y`` this
    rank's slice (n_local, ..., Nf); returns (n_local, ...). The adjoint of
    :func:`cheby_op_2d` (the shifted operator is symmetric). Requires a ring
    layout (``twod_local_windowed(ring=True[, split_cols=True])``). Under
    autograd it differentiates with respect to ``c`` and ``y``."""
    y = torch.as_tensor(y)
    nf = torch.atleast_2d(torch.as_tensor(c)).shape[0]
    if y.shape[-1] != nf:
        raise ValueError(f'last axis of y ({y.shape[-1]}) must equal the '
                         f'number of filters ({nf})')
    if not isinstance(ell, tuple):
        raise ValueError('cheby_synthesis_2d requires a ring layout '
                         '(twod_local_windowed(ring=True))')
    c, y, cdt = _prepare(c, y, tg.dtype, carry_dtype, carry_tol)
    dv = _Device2D(tg, mesh, ell, scatter_dtype)
    if _records('cheby_synthesis_2d', (c, y), lmax, (tg, ell),
                cdt is not None or scatter_dtype is not None):
        return _Synthesis.apply(dv, float(lmax), AXES_2D, c, y)
    return _synthesis(dv.product, dv.diag, float(lmax), c, y, cdt)


def cheby_op_2d_fixed_graph(tg: TwoDGraph, lmax, c, x, mesh: Mesh,
                            ell=None):
    """:func:`cheby_op_2d` with a constant-memory backward, as the bank
    itself differentiates: x̄ by the synthesis of the cotangent, c̄ by one
    ring recurrence on x whose dots (``cheby_dot_group``) are summed by an
    ``all_reduce`` over both mesh axes. Gradients flow to ``c`` and ``x``
    only. Requires a ring layout, as the JAX package's does."""
    if not isinstance(ell, tuple):
        raise ValueError('cheby_op_2d_fixed_graph requires a ring layout '
                         '(twod_local_windowed(ring=True))')
    return cheby_op_2d(tg, lmax, c, x, mesh, ell=ell)
