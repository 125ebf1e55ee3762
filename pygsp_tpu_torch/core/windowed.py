"""Windowed-compact ELL: slot-exact SpMM storage, folded per output window.

Counterpart of :mod:`pygsp_tpu.core.windowed`, the JAX package's storage
format for large power-law graphs (``Graph.compute_laplacian(fmt='auto')``
picks it above :data:`~pygsp_tpu_torch.core.chunked.CHUNK_ROWS` vertices).
Slots are exact-packed per (P-row output window, source chunk), each with
its own row id relative to the window, so padding follows the per-window
variance (about 1.1x) rather than the per-row one (about 2x). Two safety
valves:

- **borrowed slack**: row ids live in ``[0, K·P)``; a window's overflow
  takes the free tail of up to ``K − 1`` earlier windows' slabs and
  addresses forward into its own rows;
- **residue levels**: whatever still spills (hub rows, the deep tail)
  goes to per-source-chunk tiers of width 1 and 8
  (:class:`~pygsp_tpu_torch.core.chunked.ChunkLevel`). The upload also
  lays them out as one list sorted by output row
  (:class:`~.windowed_kernel.Residue`), which the SpMM's tail adds in.

The host builder is the JAX package's, copied as NumPy, so the same input
packs to the same arrays; only the upload differs (tensors on ``device``,
``'cuda'`` by default; ``uint16`` row ids are widened to ``int32``, since
torch has few ``uint16`` operations).

On the card the SpMM is two CUDA kernels (:mod:`.windowed_kernel`):
``windowed_fold`` gathers, multiplies and folds every window into the
``(n_out, NW, K·P, S)`` window tensor in one pass, and ``window_strip``,
the tail, overlap-adds it into ``y`` and adds the residue list, writing
each row of ``y`` once. The fused SpMM of several matrices (the 2-D
engine's ring fold, :func:`spmm_multi_internal`) is one kernel,
``fold_strip_multi``, that folds each window's rows from the slabs and
writes ``y`` with no window tensor. The signal stays one contiguous ``(N, S)``
tensor: the kernel adds ``c·R`` to a slot's local column. The JAX package
carries it as a tuple of chunks only to stay under a TPU gather cliff, so
:func:`windowed_spmm_chunks` is a thin wrapper kept for API parity. Not
ported, because they only steer the TPU: ``FOLD_PRECISION`` and
``_FOLD_SPLIT2`` (how the MXU runs the fold) and the sub-chunking knobs
``PYGSP_WINDOW_STEP`` and ``PYGSP_WINDOWED_BODY_MB`` (which bound XLA
temporaries that the kernel never makes). The bf16 modes of the recurrence
run here too: a bf16 signal, bf16 values, and a narrow ``out_dtype``, with
the JAX package's dtype rules (:func:`spmm_internal`).

Same contract as every sparse format here: ``y = A @ x`` in the original
vertex order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sps
import torch

from pygsp_tpu_torch.core import windowed_kernel
from pygsp_tpu_torch.core.chunked import (CHUNK_ROWS, ChunkLevel,
                                          _flat_residue, _host, _live,
                                          _numpy_dtype, _tensor, _tier_parts,
                                          chunk_signal, level_values,
                                          permute_in, permute_out,
                                          unchunk_signal)

# Output rows per window (the JAX package's default).
WINDOW_ROWS = 64


@dataclasses.dataclass(frozen=True)
class WindowedELLMatrix:
    """Windowed-compact sparse matrix (see the module docstring).

    ``cols``/``vals``/``rowid``: ``(n_out, NW, n_src, L)`` slot slabs.
    ``cols`` is local to the source chunk (sentinel ``== chunk_rows``: zero
    value, never read); ``rowid`` (uint8, or int32 where ``K·P > 256``) is
    the output row relative to the slab's window, values in
    ``[d·P, (d+1)·P)`` addressing window ``w + d``. ``levels`` and
    ``level_rows``: the residue tiers and the global row of each tier
    entry (rows repeat across entries), int64. ``rowptr``: the global CSR
    row pointer. ``perm``/``iperm``: the optional vertex relabeling, int64
    (``perm[i']`` is the original id of stored row ``i'``); the contract
    stays in the original order. ``residue``: the same tiers as the tail
    kernel's one row-sorted list (:class:`~.windowed_kernel.Residue`, made
    by :func:`upload`; None without tiers).
    """

    cols: torch.Tensor
    vals: torch.Tensor
    rowid: torch.Tensor
    levels: tuple
    level_rows: torch.Tensor
    rowptr: torch.Tensor
    n_rows: int
    n_cols: int
    nnz: int
    chunk_rows: int
    window_rows: int
    borrow_span: int = 2
    perm: torch.Tensor | None = None
    iperm: torch.Tensor | None = None
    residue: windowed_kernel.Residue | None = None

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self):
        return self.vals.device

    @property
    def n_slots(self) -> int:
        return int(np.prod(self.cols.shape))

    @property
    def n_out_chunks(self) -> int:
        return self.cols.shape[0]

    @property
    def n_src_chunks(self) -> int:
        return self.cols.shape[2]

    def out_chunk_size(self, i: int) -> int:
        return min(self.chunk_rows, self.n_rows - i * self.chunk_rows)

    def src_chunk_size(self, c: int) -> int:
        return min(self.chunk_rows, self.n_cols - c * self.chunk_rows)

    def _map_vals(self, fn) -> 'WindowedELLMatrix':
        """The matrix with the elementwise ``fn`` applied to every value."""
        return self.with_leaves(tuple(fn(v) for v in self.leaves()))

    def leaves(self) -> tuple:
        """The float leaves of the JAX package's pytree, in its order: the
        slabs' ``vals``, then every tier's."""
        return (self.vals,) + tuple(lev.vals for lev in self.levels)

    def with_leaves(self, leaves) -> 'WindowedELLMatrix':
        """The matrix with :meth:`leaves` replaced (the same shapes), the
        residue list's values gathered from the new tiers by its map
        (:func:`~.chunked.level_values`), on the device."""
        levels = tuple(dataclasses.replace(lev, vals=v)
                       for lev, v in zip(self.levels, leaves[1:]))
        return dataclasses.replace(self, vals=leaves[0], levels=levels,
                                   residue=level_values(self.residue, levels))

    # the tensors the kernels read are the leaves themselves (the chunked
    # format's differ: :meth:`ChunkedELLMatrix.buffers`)
    buffers = leaves
    with_buffers = with_leaves

    def live_slots(self):
        """``(rows, cols, index)`` (int64) of every stored slot that holds
        an edge, in the matrix's internal order, ``index`` counting the
        concatenated flat :meth:`leaves`. A slab slot of out chunk i,
        window w and source chunk c is live where its column lies in the
        chunk; its row is ``i·R + w·P + rowid`` (a row id in
        ``[d·P, (d+1)·P)`` addresses window w + d) and its column
        ``c·R + cols``, as the JAX package's fold places it
        (``pygsp_tpu/core/windowed.py:294-345``)."""
        R, P = self.chunk_rows, self.window_rows
        dev = self.device
        i, w, c, _ = torch.meshgrid(*(torch.arange(k, device=dev)
                                      for k in self.cols.shape),
                                    indexing='ij')
        cols = self.cols.long() + c * R
        q = torch.nonzero(((self.cols < R) & (cols < self.n_cols))
                          .reshape(-1)).flatten()
        rows = ((i * R + w * P).reshape(-1)[q]
                + self.rowid.reshape(-1)[q].long())
        tiers = _live(_tier_parts(self), dev)
        base = self.n_slots
        return (torch.cat([rows, tiers[0]]),
                torch.cat([cols.reshape(-1)[q], tiers[1]]),
                torch.cat([q, tiers[2] + base]))

    def astype(self, dtype) -> 'WindowedELLMatrix':
        return self._map_vals(lambda v: v.to(dtype))

    def scale_vals(self, scale) -> 'WindowedELLMatrix':
        return self._map_vals(lambda v: v * scale)

    def abs_vals(self) -> 'WindowedELLMatrix':
        return self._map_vals(torch.abs)

    def spmm_chunks(self, x_chunks, out_dtype=None) -> tuple:
        return windowed_spmm_chunks(self, x_chunks, out_dtype=out_dtype)

    def stored_bytes(self) -> int:
        """The bytes of the matrix's arrays as the JAX package stores them
        (its index vectors int32, wide row ids uint16, where the port keeps
        int64 and int32), which the recurrence's accumulator-group rule
        counts, so that both packages pick the same group. The residue
        list, the port's own copy of the tiers, is not counted."""
        def nbytes(t, itemsize=None):
            return t.numel() * (itemsize or t.element_size())
        rowid = 1 if self.rowid.dtype == torch.uint8 else 2
        return (nbytes(self.cols) + nbytes(self.vals)
                + nbytes(self.rowid, rowid) + nbytes(self.rowptr)
                + nbytes(self.level_rows, 4)
                + sum(nbytes(lev.cols) + nbytes(lev.vals)
                      for lev in self.levels)
                + sum(nbytes(p, 4) for p in (self.perm, self.iperm)
                      if p is not None))

    def __matmul__(self, x):
        from pygsp_tpu_torch.core.sparse import spmm   # imports this module
        return spmm(self, x)


# ---------------------------------------------------------------------------
# SpMM
# ---------------------------------------------------------------------------

def spmm_internal(mat: WindowedELLMatrix, x: torch.Tensor,
                  out_dtype=None) -> torch.Tensor:
    """``y = A @ x`` in the matrix's internal (relabeled) order, for x
    (n_cols, S): the fold kernel, then the tail kernel (the overlap-add
    with the residue list added in, each row written once).

    The JAX package's dtype rules (``pygsp_tpu/core/windowed.py:234-249``):
    products in ``pdt``, the promotion of x's and the values' dtypes (so a
    bf16·bf16 product rounds to bf16); row sums in float32 or wider; ``y``
    in ``out_dtype``, by default ``pdt``. The operand pairs of the fold
    kernel (:data:`~.windowed_kernel.FOLD_OPERANDS`: the exact modes and the
    three bf16 ones, with ``y`` in x's dtype) run as they are, with no wider
    copy of the slabs; any other pair is promoted to ``pdt`` first. There
    the tail adds the residue in ``pdt`` and ``y`` is rounded to
    ``out_dtype`` once, after it (the JAX package rounds each tier's sum to
    ``out_dtype`` first)."""
    pdt = torch.promote_types(x.dtype, mat.dtype)
    dt = out_dtype or pdt
    x = x.contiguous()
    if (x.dtype, mat.dtype) not in windowed_kernel.FOLD_OPERANDS or (
            dt != x.dtype):
        if mat.dtype != pdt:
            mat = mat.astype(pdt)
        x = x.to(pdt)
    R, P = mat.chunk_rows, mat.window_rows
    t = windowed_kernel.windowed_fold(mat.cols, mat.vals, mat.rowid, x, R,
                                      mat.borrow_span * P)
    return windowed_kernel.window_strip(t, mat.n_rows, P, mat.residue,
                                        x).to(dt)


def windowed_spmm_chunks(mat: WindowedELLMatrix, x_chunks,
                         out_dtype=None) -> tuple:
    """``y_chunks = A @ x_chunks`` with tuple-of-chunk input and output, in
    the internal order (API parity with the JAX package; the chunks are
    joined into one tensor for the kernels). ``out_dtype``: see
    :func:`spmm_internal`."""
    x = unchunk_signal(tuple(torch.as_tensor(xk) for xk in x_chunks))
    y = spmm_internal(mat, x.reshape(x.shape[0], -1), out_dtype=out_dtype)
    return chunk_signal(y.reshape((mat.n_rows,) + x.shape[1:]),
                        mat.chunk_rows)


def _check_multi(mats):
    m0 = mats[0]
    for m in mats[1:]:
        if (m.chunk_rows != m0.chunk_rows or m.window_rows != m0.window_rows
                or m.borrow_span != m0.borrow_span
                or m.cols.shape[:2] != m0.cols.shape[:2]
                or m.n_rows != m0.n_rows):
            raise ValueError('fused SpMM requires matching chunk_rows/'
                             'window_rows/borrow_span/out chunking')


def spmm_multi_internal(mats, xs, residue,
                        out_dtype=None) -> torch.Tensor:
    """``y = Σ_m A_m @ x_m`` in the matrices' internal order, for x_m
    (n_cols_m, S): one launch of the fused SpMM
    (:func:`~.windowed_kernel.fold_strip_multi`: every matrix's slabs
    folded window by window, the overlap-add and every matrix's residue
    list, y written once and no window tensor; bit-equal to the multi-matrix
    fold :func:`~.windowed_kernel.windowed_fold_multi` followed by the tail
    :func:`~.windowed_kernel.window_strip`, which take windows of more raw
    slots than one block of it stages, :func:`~.windowed_kernel.
    fold_strip_fits`). ``residue``:
    the matrices' residue lists merged by
    :func:`~.windowed_kernel.merge_residues`, which a caller that applies
    the same matrices again makes once. The matrices
    share ``chunk_rows``, ``window_rows``, ``borrow_span`` and the output
    chunking (the JAX package's ``ValueError`` otherwise); their slab
    widths and source-chunk counts may differ. Dtypes: as
    :func:`spmm_internal`, over all the matrices (the operands promoted to
    one pair of :data:`~.windowed_kernel.FOLD_OPERANDS` where they differ)."""
    _check_multi(mats)
    m0 = mats[0]
    R, P, K = m0.chunk_rows, m0.window_rows, m0.borrow_span
    pdts = [torch.promote_types(x.dtype, m.dtype) for m, x in zip(mats, xs)]
    pdt = pdts[0]
    for d in pdts[1:]:
        pdt = torch.promote_types(pdt, d)
    dt = out_dtype or pdt
    pairs = {(x.dtype, m.dtype) for m, x in zip(mats, xs)}
    if (len(pairs) > 1 or next(iter(pairs))
            not in windowed_kernel.FOLD_OPERANDS or dt != xs[0].dtype):
        mats = [m if m.dtype == pdt else m.astype(pdt) for m in mats]
        xs = [x.to(pdt) for x in xs]
        if residue is not None:
            residue = residue._replace(vals=residue.vals.to(pdt))
    xs = [x.contiguous() for x in xs]
    slabs = [(m.cols, m.vals, m.rowid) for m in mats]
    if windowed_kernel.fold_strip_fits(slabs, xs, K, P):
        y = windowed_kernel.fold_strip_multi(slabs, xs, R, P, K, m0.n_rows,
                                             residue)
    else:
        # windows of more raw slots than a block stages: the fold into a
        # window tensor, then the strip (the same bits)
        t = windowed_kernel.windowed_fold_multi(slabs, xs, R, K * P)
        y = windowed_kernel.window_strip(t, m0.n_rows, P, residue,
                                         None if residue is None else xs)
    return y.to(dt)


def windowed_spmm_chunks_multi(mats, x_chunks_list, out_dtype=None):
    """``y_chunks = Σ_m A_m @ x_chunks_m``, the fused multi-matrix SpMM
    (:func:`spmm_multi_internal`), with tuple-of-chunk inputs and output
    in the internal order (API parity with the JAX package; each x is
    joined into one tensor for the kernels)."""
    xs = [unchunk_signal(tuple(torch.as_tensor(xk) for xk in xc))
          for xc in x_chunks_list]
    trailing = tuple(xs[0].shape[1:])
    mats = list(mats)
    _check_multi(mats)
    residue = windowed_kernel.merge_residues([m.residue for m in mats],
                                             mats[0].n_rows)
    y = spmm_multi_internal(mats, [x.reshape(x.shape[0], -1) for x in xs],
                            residue, out_dtype=out_dtype)
    return chunk_signal(y.reshape((mats[0].n_rows,) + trailing),
                        mats[0].chunk_rows)


def windowed_spmm(mat: WindowedELLMatrix, x, *,
                  out_dtype=None) -> torch.Tensor:
    """``y = A @ x`` for x of shape (n_cols,) or (n_cols, ...), in the
    original vertex order (``out_dtype``: see :func:`spmm_internal`).
    Iterative callers (``cheby_op``, Lanczos) hoist the two permutes out of
    their loops, so that here they are the identity."""
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

# The JAX package's per-op cost model (ns, measured on its TPU by
# benchmarks/windowed_compact_probe.py and gather_probe2.py), kept as it is
# so that the slab width, and with it every array, comes out the same.
_GATHER_NS = 3.6
_SCATTER_NS = 25.0
_WIDE_TIER = 8             # residue tier widths are {1, _WIDE_TIER}


def _residue_cost(n_slabs, L, residue, window_rows):
    """Shared slot+residue cost model (ns): slab gathers + level-tier
    gathers + per-residue-row scatter. ``residue``: per-slab residue
    edge counts."""
    res_edges = float(residue.sum())
    # residue rows <= min(residue, window rows); most carry 1 edge
    res_rows = float(np.minimum(residue, window_rows).sum())
    lvl_slots = res_rows + max(res_edges - res_rows, 0.0) * 1.6
    return (n_slabs * L * _GATHER_NS
            + lvl_slots * _GATHER_NS
            + res_rows * 1.3 * _SCATTER_NS)


def _greedy_borrow(counts2, L, span):
    """Span-K borrow chain on ``(n_blocks, NW)`` int window demands:
    window ``w``'s overflow spills into the free tails of slabs
    ``w-span+1 .. w-1``, OLDEST usable slack first (it expires soonest —
    the exchange argument makes this optimal). Returns
    ``(B, residue)``: ``B[:, w, d]`` = slots window ``w`` places in slab
    ``w-d``; ``residue[:, w]`` = edges that spill to the level tiers."""
    nb, NW = counts2.shape
    used = np.minimum(counts2, L)
    avail = (L - used).astype(np.int64)
    over = (counts2 - used).astype(np.int64)
    B = np.zeros((nb, NW, span), np.int64)
    residue = np.zeros((nb, NW), np.int64)
    for w in range(NW):
        o = over[:, w].copy()
        for d in range(span - 1, 0, -1):
            s = w - d
            if s < 0:
                continue
            take = np.minimum(o, avail[:, s])
            B[:, w, d] = take
            avail[:, s] -= take
            o -= take
        residue[:, w] = o
    return B, residue


def _choose_slab_width(counts: np.ndarray, window_rows: int,
                       span: int = 2, L_cap: int = 512) -> int:
    """Pick L minimising slots*gather + residue level cost.

    ``counts``: per-(out,src,window) slot demands with the window axis
    LAST (so ``counts[..., :-1]`` is each window's predecessor within
    the same block). Residues route to {1, 8}-wide level tiers plus a
    per-row scatter, so in the JAX package's cost model a residue edge
    costs about an order of magnitude more than a slab slot.

    The grid is fine below 32 (fragmented low-density blocks live at
    λ_w ≪ 64). ``span > 2`` scores the candidates with the greedy borrow
    chain on a sampled block subset.
    """
    lam = counts.mean() if counts.size else 0.0
    hi = min(L_cap, max(16, int(2 * lam + 96)))
    cand = [L for L in range(2, hi + 1)
            if L <= 32 or (L <= 96 and L % 4 == 0) or L % 8 == 0]

    def span2_cost(L):
        o = np.maximum(counts - L, 0)
        slack = np.maximum(L - counts, 0)
        b = np.minimum(o[..., 1:], slack[..., :-1])
        residue = o.astype(np.float64)
        residue[..., 1:] -= b
        return _residue_cost(counts.size, L, residue, window_rows)

    scored = sorted((span2_cost(L), L) for L in cand)
    if span <= 2:
        return scored[0][1]

    # deeper pooling shifts the optimum down — rescore a shortlist
    # (plus its downward neighbourhood) with the true greedy chain on a
    # block sample
    short = sorted({L for _, L in scored[:10]}
                   | {max(2, L - d) for _, L in scored[:4]
                      for d in (1, 2, 3, 4, 6)})
    c2 = counts.reshape(-1, counts.shape[-1])
    if c2.shape[0] > 4096:
        sel = np.random.default_rng(0).choice(c2.shape[0], 4096,
                                              replace=False)
        c2 = c2[sel]
    scale = counts.size / c2.size
    best_L, best_cost = short[0], np.inf
    for L in short:
        _, residue = _greedy_borrow(c2.astype(np.int64), L, span)
        cost = scale * _residue_cost(c2.size, L, residue, window_rows)
        if cost < best_cost:
            best_L, best_cost = L, cost
    return best_L


def _window_counts(rows, cols, is_hub, n_rows, n_cols, R, P):
    """Per-(out chunk, src chunk, window) non-hub slot demands, flat
    int64 of length ``n_out*n_src*NW``. Reshape to ``(n_out*n_src, NW)``
    for :func:`_choose_slab_width` (window axis last so the borrow
    relation sees each window's in-block predecessor); pass through to
    :func:`_pack_slabs` to avoid recounting. ``rows``/``cols`` must
    already be in PACKING order (post-relabel)."""
    NW = R // P
    n_out = max(-(-n_rows // R), 1)
    n_src = max(-(-n_cols // R), 1)
    slab = ((rows // R) * n_src + cols // R) * NW + (rows % R) // P
    return np.bincount(slab[~is_hub], minlength=n_out * n_src * NW)


def _pack_slabs(rows, cols, vals, is_hub, n_rows, n_cols, R, P, L,
                counts=None, span=2):
    """Exact-pack non-hub edges into ``(n_out, NW, n_src, L)`` slabs with
    borrowed slack (see module docstring); hub edges and window overflow
    come back as residue COO for the level tiers.

    ``span``: how many consecutive windows pool their slack — window
    ``w``'s overflow may occupy the free tails of slabs ``w-span+1 ..
    w-1`` of the SAME (out, src) block, carried with ``rowid ∈
    [d·P, (d+1)·P)`` for slab ``w-d``. ``span=2`` reproduces the
    original one-deep borrow.

    Returns ``(cols4, vals4, rowid4, res_rows, res_cols, res_vals)``.
    All inputs are host numpy in packing (post-relabel) order. ``counts``
    (optional) is :func:`_window_counts`'s output, forwarded to skip the
    recount on 100M-edge-scale builds.
    """
    NW = R // P
    n_out = max(-(-n_rows // R), 1)
    n_src = max(-(-n_cols // R), 1)
    K = int(span)

    i_e = rows // R
    c_e = cols // R
    w_e = (rows % R) // P
    slab_e = (i_e * n_src + c_e) * NW + w_e
    n_slabs = n_out * n_src * NW

    order = np.argsort(slab_e, kind='stable')
    rows_s, cols_s, vals_s = rows[order], cols[order], vals[order]
    slab_s = slab_e[order]
    hub_s = is_hub[order]

    if counts is None:
        counts = np.bincount(slab_s[~hub_s], minlength=n_slabs)

    nh = ~hub_s
    rows_w, cols_w, vals_w, slab_w = (rows_s[nh], cols_s[nh], vals_s[nh],
                                      slab_s[nh])
    run_start = np.zeros(n_slabs + 1, np.int64)
    np.cumsum(counts, out=run_start[1:])
    pos = np.arange(rows_w.size, dtype=np.int64) - run_start[slab_w]

    c2 = counts.reshape(n_out * n_src, NW).astype(np.int64)
    B, _ = _greedy_borrow(c2, L, K)

    # cumB_excl[:, w, d]: overflow ranks assigned to FARTHER slabs
    # (d' > d); window w's ranks [cumB_excl[d], cumB_excl[d] + B[d])
    # land in slab w-d
    cumB_excl = np.zeros_like(B)
    for d in range(K - 2, 0, -1):
        cumB_excl[:, :, d] = cumB_excl[:, :, d + 1] + B[:, :, d + 1]
    # consumed[:, w, d]: dest slab (w-d)'s tail already taken by EARLIER
    # borrowers (windows w-d+d', d' < d — processed first)
    consumed = np.zeros_like(B)
    for d in range(2, K):
        s_ = np.zeros_like(c2)
        for dp in range(1, d):
            sh = d - dp
            s_[:, sh:] += B[:, :-sh, dp]
        consumed[:, :, d] = s_

    borrow_tot = B[:, :, 1:].sum(axis=2).reshape(-1)
    q = pos - L
    in_main = pos < L
    in_residue = ~in_main & (q >= borrow_tot[slab_w])
    in_borrow = ~in_main & ~in_residue

    Bf = B.reshape(-1, K)
    Ef = cumB_excl.reshape(-1, K)
    Cf = consumed.reshape(-1, K)
    d_e = np.zeros(pos.size, np.int64)
    dest_slot = np.where(in_main, pos, 0)
    for d in range(1, K):
        lo = Ef[slab_w, d]
        m = in_borrow & (q >= lo) & (q < lo + Bf[slab_w, d])
        if not m.any():
            continue
        d_e[m] = d
        ds = slab_w[m] - d
        dest_slot[m] = (np.minimum(counts[ds], L)
                        + Cf[slab_w[m], d] + (q[m] - lo[m]))
    dest_slab = np.where(in_borrow, slab_w - d_e, slab_w)
    rel_row = (rows_w % P) + d_e * P

    keep = ~in_residue
    flat = dest_slab[keep] * L + dest_slot[keep]
    slab_cols = np.full(n_slabs * L, R, np.int32)
    slab_vals = np.zeros(n_slabs * L, vals.dtype)
    rid_dt = np.uint8 if K * P <= 256 else np.uint16
    slab_rowid = np.full(n_slabs * L, K * P - 1, rid_dt)
    slab_cols[flat] = (cols_w[keep] % R).astype(np.int32)
    slab_vals[flat] = vals_w[keep]
    slab_rowid[flat] = rel_row[keep].astype(rid_dt)

    # slab layout (n_out, NW, n_src, L): the SpMM stacks every src
    # chunk's slots along the contraction axis of ONE dot per out chunk
    def shape4(a):
        return np.ascontiguousarray(
            a.reshape(n_out, n_src, NW, L).transpose(0, 2, 1, 3))

    res_rows = np.concatenate([rows_w[in_residue], rows_s[hub_s]])
    res_cols = np.concatenate([cols_w[in_residue], cols_s[hub_s]])
    res_vals = np.concatenate([vals_w[in_residue], vals_s[hub_s]])
    return (shape4(slab_cols), shape4(slab_vals), shape4(slab_rowid),
            res_rows, res_cols, res_vals)


def auto_chunk_rows(nnz: int, n_rows: int, n_cols: int,
                    window_rows: int = WINDOW_ROWS,
                    max_rows: int | None = None) -> int:
    """Source-chunk size targeting window slot demand λ_w ≈ 64 (L ≈ 72).

    The JAX package's rule, kept as it is so that the port chunks a graph
    as it does: ``λ_w = P·deg/n_src`` near 64, the chunk capped at
    ``max_rows`` (default :data:`CHUNK_ROWS`, the TPU gather window) with
    a small slack, and floored at 4·P. The TPU measurements behind it are
    in ``pygsp_tpu/core/windowed.py:auto_chunk_rows``.
    """
    P = int(window_rows)
    deg = nnz / max(n_rows, 1)
    n_src_t = max(1, int(round(P * deg / 64.0)))
    # the cap must itself be a multiple of P; the 1.5% slack keeps an
    # nearly-empty extra chunk from appearing when n_cols is a hair over a
    # multiple of the cap
    cap = int(max_rows or CHUNK_ROWS)
    cap_eff = cap + max(P, cap // 64)
    # divide n_cols as evenly as possible: smallest chunk count that
    # respects both the λ_w target and the (slackened) cap
    n_src = max(n_src_t, -(-n_cols // cap_eff))
    R = -(-(-(-n_cols // n_src)) // P) * P
    return int(max(4 * P, R))


# Auto borrow-span rule (the JAX package's): below this pooled per-slab
# demand the 2-window borrow pad (~1+1/√λ_w) costs more than the extra
# one-hot width of a 4-window pool.
_SPAN4_LAMBDA = 24.0


def _auto_span(counts_mean: float, window_rows: int) -> int:
    if counts_mean >= _SPAN4_LAMBDA:
        return 2
    return max(2, min(4, 256 // int(window_rows)))


def windowed_from_host_coo(rows, cols, vals, n_rows: int, n_cols: int, *,
                           chunk_rows: int | None = None,
                           window_rows: int = WINDOW_ROWS,
                           slab_width: int | None = None,
                           hub_degree: int | None = None,
                           permute: str | None = 'shuffle',
                           borrow_span: int | None = None,
                           dtype=None, device='cuda') -> WindowedELLMatrix:
    """Build a :class:`WindowedELLMatrix` from host COO (deduped edges).

    All packing is vectorised NumPy; the arrays go to ``device`` at the
    end. ``dtype`` (numpy or torch) is the value type; by default the
    values keep their own float type (float64 for integers), as in the JAX
    package.

    ``hub_degree``: rows at least this dense bypass the windows and go
    straight to the level tiers (their per-block counts would dominate
    whole windows, skewing the slab-width choice and overflowing
    whatever L is picked; as compact per-row tiers they pack near 1x).
    Default: ``4 * sqrt(window λ) * n_src`` — rows whose per-block
    count exceeds 4 sigma of the window distribution.

    ``permute='shuffle'`` (default, square matrices only) relabels
    vertices by a seeded random permutation before packing. Generator
    vertex ids usually correlate with degree (a Barabási–Albert graph
    numbers its hubs first), so windows of CONSECUTIVE ids inherit the
    degree distribution's skew — measured pad 1.9 on the bench graph
    even with the width chosen 1.4x above the mean. Mixing ids makes
    every window an iid degree sample, concentrating window sums at
    sigma ~= sqrt(P*Var(deg))/n_src. The ``A @ x`` contract keeps
    ORIGINAL vertex order (entry/exit permutes, hoisted by iterative
    drivers).
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals)
    if dtype is not None:
        vals = vals.astype(_numpy_dtype(dtype))
    if not np.issubdtype(vals.dtype, np.floating):
        vals = vals.astype(np.float64)
    P = int(window_rows)
    if chunk_rows is None:
        chunk_rows = auto_chunk_rows(rows.size, n_rows, n_cols, P)
    R = int(chunk_rows)
    if R % P:
        raise ValueError(f'chunk_rows ({R}) must be a multiple of '
                         f'window_rows ({P})')
    if 2 * P > 65536:
        raise ValueError('window_rows > 32768 overflows the uint16 row ids')
    NW = R // P
    n_out = max(-(-n_rows // R), 1)
    n_src = max(-(-n_cols // R), 1)

    deg = np.bincount(rows, minlength=n_rows) if rows.size else np.zeros(
        n_rows, np.int64)
    rowptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(deg, out=rowptr[1:])

    if hub_degree is None:
        lam_w = P * (rows.size / max(n_rows, 1)) / n_src
        hub_degree = max(2 * P, int(4.0 * np.sqrt(max(lam_w, 1.0)) * n_src))
    is_hub_edge = deg[rows] >= hub_degree

    perm = iperm = None
    if permute == 'shuffle' and n_rows == n_cols and n_rows > 0:
        perm = np.random.default_rng(0x5EED).permutation(n_rows)
        iperm = np.empty_like(perm)
        iperm[perm] = np.arange(n_rows, dtype=perm.dtype)
        rows = iperm[rows]
        cols = iperm[cols]
    elif permute not in (None, 'shuffle'):
        raise ValueError(f'Unknown permute mode {permute!r}')

    counts = _window_counts(rows, cols, is_hub_edge, n_rows, n_cols, R, P)
    if borrow_span is None:
        borrow_span = _auto_span(float(counts.mean()) if counts.size
                                 else 0.0, P)
    K = int(borrow_span)
    if K < 2 or K * P > 65536:
        raise ValueError(f'borrow_span must be in [2, {65536 // P}] for '
                         f'window_rows={P} (uint16 row ids)')
    if slab_width is None:
        L = _choose_slab_width(
            counts.reshape(-1, R // P).astype(np.float64), P, span=K)
    else:
        L = int(slab_width)

    (cols4, vals4, rowid4, res_rows, res_cols, res_vals) = _pack_slabs(
        rows, cols, vals, is_hub_edge, n_rows, n_cols, R, P, L,
        counts=counts, span=K)
    # residue (window spill + hub rows) -> {1, 8}-wide level tiers per
    # src chunk, wide rows split over repeated tier entries
    levels, level_rows = _pack_residue_levels(
        res_rows, res_cols, res_vals, res_cols // R, R, vals.dtype)

    return upload(dict(
        cols=cols4, vals=vals4,
        rowid=rowid4, levels=levels,
        level_rows=level_rows, rowptr=rowptr.astype(np.int32),
        n_rows=int(n_rows), n_cols=int(n_cols), nnz=int(rows.size),
        chunk_rows=R, window_rows=P, borrow_span=K,
        perm=None if perm is None else perm.astype(np.int32),
        iperm=None if iperm is None else iperm.astype(np.int32)), device)


def upload(host: dict, device) -> WindowedELLMatrix:
    """The matrix on ``device`` from host arrays with the field names of
    :class:`WindowedELLMatrix` (levels as :class:`ChunkLevel` of arrays).
    Row ids stay ``uint8``; wider ones become ``int32``. ``level_rows``,
    ``perm`` and ``iperm`` become ``int64``. The residue list is made here
    from the tiers (:func:`_flat_residue`)."""
    rowid = np.asarray(host['rowid'])
    residue = _flat_residue(host['levels'], host['level_rows'],
                            int(host['n_rows']), int(host['n_cols']),
                            int(host['chunk_rows']))
    if residue is not None:
        residue = windowed_kernel.Residue(
            **{k: _tensor(residue[k], device, np.int32)
               for k in ('rowptr', 'entptr', 'cols', 'heavy')},
            vals=_tensor(residue['vals'], device),
            src=_tensor(residue['src'], device, np.int64))
    rid_dt = np.uint8 if rowid.dtype == np.uint8 else np.int32
    # the index vectors of index_add_ and index_select, int64 once here
    # rather than at every product
    vec = {k: None if host[k] is None else _tensor(host[k], device, np.int64)
           for k in ('level_rows', 'perm', 'iperm')}
    return WindowedELLMatrix(
        rowptr=_tensor(host['rowptr'], device, np.int32),
        cols=_tensor(host['cols'], device, np.int32),
        vals=_tensor(host['vals'], device),
        rowid=_tensor(rowid, device, rid_dt),
        levels=tuple(ChunkLevel(cols=_tensor(lev.cols, device, np.int32),
                                vals=_tensor(lev.vals, device),
                                src_chunk=int(lev.src_chunk))
                     for lev in host['levels']),
        residue=residue, **vec,
        **{k: int(host[k]) for k in ('n_rows', 'n_cols', 'nnz', 'chunk_rows',
                                     'window_rows', 'borrow_span')})


def _pack_residue_levels(rrows, rcols, rvals, rchunk, R, vdtype):
    """Residue edges -> TWO slot tiers per src chunk (widths 1 and
    ``_WIDE_TIER``), in the chunked format's level layout: one global
    scatter-add folds every tier. Rows wider than a tier entry repeat
    across entries (the scatter sums duplicates), so tier widths — and
    with them per-op compile cost — stay bounded no matter how dense a
    hub row is."""
    if rrows.size == 0:
        return (), np.zeros(0, np.int32)
    o = np.lexsort((rrows, rchunk))
    rrows, rcols, rvals, rchunk = (rrows[o], rcols[o], rvals[o], rchunk[o])
    W = _WIDE_TIER

    levels = []
    level_rows_parts = []
    for c in np.unique(rchunk):
        m = rchunk == c
        crows, ccols, cvals = rrows[m], rcols[m] % R, rvals[m]
        urows, ucounts = np.unique(crows, return_counts=True)
        ustarts = np.zeros(urows.size, np.int64)
        np.cumsum(ucounts[:-1], out=ustarts[1:])

        # width-1 tier: every residue row's first edge
        levels.append(ChunkLevel(
            cols=ccols[ustarts].astype(np.int32)[:, None],
            vals=cvals[ustarts].astype(vdtype)[:, None],
            src_chunk=int(c)))
        level_rows_parts.append(urows)

        # width-W tier: remaining edges, ceil((r-1)/W) entries per row
        rem = ucounts - 1
        n_ent = -(-rem // W)
        wide = np.flatnonzero(n_ent > 0)
        if wide.size:
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
            # sentinel == chunk_rows like the slabs (clamped gather x0)
            pc = np.where(valid, ccols[idx], R).astype(np.int32)
            pv = np.where(valid, cvals[idx], 0).astype(vdtype)
            levels.append(ChunkLevel(cols=pc, vals=pv, src_chunk=int(c)))
            level_rows_parts.append(urows[ent_row])

    level_rows = np.concatenate(level_rows_parts).astype(np.int32)
    return tuple(levels), level_rows


def windowed_from_scipy(mat, *, dtype=None,
                        chunk_rows: int | None = None,
                        window_rows: int = WINDOW_ROWS,
                        slab_width: int | None = None,
                        hub_degree: int | None = None,
                        permute: str | None = 'shuffle',
                        borrow_span: int | None = None,
                        device='cuda') -> WindowedELLMatrix:
    """scipy sparse → windowed-compact ELL on ``device``."""
    csr = mat.tocsr()
    csr.sum_duplicates()
    coo = csr.tocoo()
    return windowed_from_host_coo(coo.row, coo.col, coo.data,
                                  coo.shape[0], coo.shape[1],
                                  chunk_rows=chunk_rows,
                                  window_rows=window_rows,
                                  slab_width=slab_width,
                                  hub_degree=hub_degree,
                                  permute=permute,
                                  borrow_span=borrow_span, dtype=dtype,
                                  device=device)


def windowed_to_scipy(mat: WindowedELLMatrix):
    """Export back to scipy CSR: unpack the ``(n_out, NW, n_src, L)``
    slabs (global row ``i·R + w·P + rowid`` — borrowed slots carry
    ``rowid ∈ [P, 2P)`` addressing the next window, exactly as the fold
    shifts them) and the residue tiers, then invert the optional
    relabeling (same contract as the JAX package's
    ``chunked.chunked_to_scipy``)."""
    R, P = mat.chunk_rows, mat.window_rows
    co = _host(mat.cols)
    va = _host(mat.vals)
    ri = _host(mat.rowid).astype(np.int64)
    n_out, NW, n_src, L = co.shape

    grow = (np.arange(n_out, dtype=np.int64)[:, None, None, None] * R
            + np.arange(NW, dtype=np.int64)[None, :, None, None] * P + ri)
    gcol = (np.arange(n_src, dtype=np.int64)[None, None, :, None] * R
            + co.astype(np.int64))
    src_sizes = np.minimum(R, mat.n_cols - np.arange(n_src) * R)
    keep = co < src_sizes[None, None, :, None]
    rows_l = [grow[keep]]
    cols_l = [gcol[keep]]
    vals_l = [va[keep]]

    lr = _host(mat.level_rows).astype(np.int64)
    off = 0
    for lev in mat.levels:
        lc = _host(lev.cols)
        grows = np.repeat(lr[off:off + lc.shape[0]], lc.shape[1])
        off += lc.shape[0]
        lcf = lc.ravel()
        lkeep = lcf < mat.src_chunk_size(lev.src_chunk)
        rows_l.append(grows[lkeep])
        cols_l.append(lcf[lkeep].astype(np.int64) + lev.src_chunk * R)
        vals_l.append(_host(lev.vals).ravel()[lkeep])

    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    vals = np.concatenate(vals_l)
    if mat.perm is not None:
        p = _host(mat.perm).astype(np.int64)
        rows, cols = p[rows], p[cols]
    return sps.csr_matrix((vals, (rows, cols)), shape=mat.shape)
