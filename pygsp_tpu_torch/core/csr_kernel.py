"""CSR SpMM: ``y[r, :] = Σ_{e ∈ rowptr[r]:rowptr[r+1]} vals[e] · x[cols[e], :]``,
and its gradient with respect to ``vals``, the SDDMM
``out[e] += α·⟨u[rows[e], :], t[cols[e], :]⟩`` (:func:`csr_sddmm`).

The CUDA kernel (``csrc/csr_spmm.cu``) takes the place of the XLA gather +
``segment_sum`` in ``pygsp_tpu/core/sparse.py:spmm``. :func:`csr_spmm`
launches it for CUDA tensors and runs :func:`csr_spmm_plain` for CPU
tensors; there is no fallback from one to the other.

The kernel balances its warps by edges and rows, not by rows alone (merge
path): its walk over the matrix takes one step per row end and one per
edge, and is cut into segments of :data:`SEGMENT_STEPS` steps, one warp
each; :func:`csr_segments` gives each segment's start. A row that crosses a
segment boundary (every hub row does) leaves one partial sum per segment,
which a second kernel adds in segment order, so every row sums in a fixed
order and two launches are bit-equal.

The kernel has two entries, both on that walk and that join. The wide one
(``csr_spmm_f32``/``_f64``) puts a warp's lanes over the columns, 4 f32
or 2 f64 a lane, and walks the edges one at a time. The narrow one
(``csr_spmm_narrow_f32``/``_f64``) puts its lanes over the edges: a group
of ``L = next_pow2(ceil(S / V))`` lanes takes one edge (V values a lane,
up to 16 bytes), so a warp takes ``32 / L`` edges a step and adds them by
row with a segmented reduction across the warp. :func:`csr_spmm` chooses
by ``(S, dtype)`` alone, from :data:`NARROW_WIDTH`: the narrow entry up to
that many columns, the wide one above.

The segment table depends on ``rowptr`` alone, and at small sizes its
half-dozen launches took longer than the product: :func:`segment_table`
keeps it on the ``rowptr`` tensor, keyed by the segment length, the edge
count and the tensor's version counter, with whether any row crosses a
segment (the narrow entry skips the join kernel where none does).

The SDDMM (``csrc/csr_sddmm.cu``) takes the place of what ``jax.grad``
makes of the same ``spmm`` with respect to ``mat.vals``. Its edges are
independent, so a warp takes a run of them whatever the rows' lengths, and
the diagonal's cotangent rides in the same launch. :func:`csr_sddmm`
launches it for CUDA tensors and runs :func:`csr_sddmm_plain` for CPU
tensors.

The backward of ``A @ t`` through A's values needs both on A's edges:
``Aᵀ u`` (kernel A on the transpose) and the SDDMM, which gathers t's
rows where the SpMM gathers u's. :func:`csr_spmm_sddmm`, kernel A's fused
entry, walks the transpose once for both, above :data:`NARROW_WIDTH`
columns (:func:`fused_width`), with the two launches' bits;
:func:`csr_spmm_sddmm_plain` for CPU tensors.
"""

from __future__ import annotations

import torch

from pygsp_tpu_torch.core import _cuda

_SYMBOLS = {torch.float32: 'csr_spmm_f32', torch.float64: 'csr_spmm_f64'}
_NARROW_SYMBOLS = {torch.float32: 'csr_spmm_narrow_f32',
                   torch.float64: 'csr_spmm_narrow_f64'}

# Walk steps (row ends and edges) per warp of the wide entry (kSegSteps in
# csrc/csr_spmm.cu) and of the narrow one (the kernel reads its segments'
# bounds from the table, whatever their length). 512 for the narrow entry:
# on an H100 (tools/narrow_sweep.py, PERF.md) it was within 4 % of the
# best of 128-2048 at 1, 8 and 24 columns on path A's graph and on
# Sensor(2**20), where 256 lost up to 6 % and 1024 up to 15 %.
SEGMENT_STEPS = 256
NARROW_SEGMENT_STEPS = 512
# A walk too short for NARROW_MIN_SEGMENTS segments of that length takes
# shorter ones, halving down to NARROW_MIN_STEPS: a warp takes its steps
# one after another, so on a small matrix a few long segments leave the
# card idle while each warp waits on its gathers in turn.
NARROW_MIN_SEGMENTS = 2048
NARROW_MIN_STEPS = 32

# The widest S that takes the narrow entry, by dtype; wider S takes the
# wide one. On an H100 (tools/narrow_sweep.py, PERF.md) the narrow entry
# was the faster at every width up to 32 in f32 and f64, on path A's graph
# and on Sensor(2**20); at 48 f32 and at 64 f64 the wide one was, and at
# 64 f32 the two were within 3 %. The narrow entry takes at most 128 f32
# or 64 f64 columns (32 lanes of 16 bytes).
NARROW_WIDTH = {torch.float32: 32, torch.float64: 32}
NARROW_MAX = {torch.float32: 128, torch.float64: 64}


def csr_spmm_plain(rowptr, cols, vals, x):
    """Plain PyTorch version: ``index_add_`` of ``vals[:, None] * x[cols]``
    over the ``rowptr[-1]`` stored edges (padding is never read)."""
    n_rows = rowptr.shape[0] - 1
    counts = (rowptr[1:] - rowptr[:-1]).long()
    nnz = int(rowptr[-1])
    rows = torch.repeat_interleave(
        torch.arange(n_rows, device=x.device), counts, output_size=nnz)
    contrib = vals[:nnz, None] * x[cols[:nnz].long()]
    y = torch.zeros((n_rows, x.shape[1]), dtype=x.dtype, device=x.device)
    return y.index_add_(0, rows, contrib)


def n_segments(n_steps: int, steps: int | None = None) -> int:
    """Segments a walk of ``n_steps`` steps is cut into (at least one),
    ``steps`` (default :data:`SEGMENT_STEPS`) a segment."""
    return max(1, -(-n_steps // (steps or SEGMENT_STEPS)))


def csr_segments(rowptr, n_edges: int, steps: int | None = None):
    """Where each segment of the kernel's walk starts, int32
    ``(2, n_seg)``: ``[0, w]`` the row in progress (its end not yet
    taken) and ``[1, w]`` the next edge, after ``d = w · steps`` steps
    (default :data:`SEGMENT_STEPS`). Row r's end is step
    ``rowptr[r+1] + r`` of the walk, so the row is the count of row ends
    before ``d``, one ``torch.searchsorted``, and the edge ``d`` less
    that. ``n_edges``, the length of the (padded) edge arrays, bounds
    ``rowptr[-1]`` on the host, so the table needs no device-to-host copy;
    segments past the walk's end start at row ``n_rows``."""
    steps = steps or SEGMENT_STEPS
    n_rows = rowptr.shape[0] - 1
    ends = rowptr[1:] + torch.arange(n_rows, dtype=torch.int32,
                                     device=rowptr.device)
    d = torch.arange(n_segments(n_rows + n_edges, steps), dtype=torch.int32,
                     device=rowptr.device) * steps
    row = torch.searchsorted(ends, d, out_int32=True)
    return torch.stack([row, d - row])


def segment_table(rowptr, n_edges: int, steps: int):
    """``(seg, join)``: :func:`csr_segments` of ``rowptr`` at ``steps`` a
    segment, and whether any row is in progress, with edges before it, at
    a segment's start (so that the join kernel has work). Kept on the
    ``rowptr`` tensor by ``(steps, n_edges)`` with the tensor's version
    counter: another tensor has its own, and an in-place change of this
    one (which bumps its version counter) makes it anew. Making it reads
    ``join`` back to the host once."""
    tables = rowptr.__dict__.setdefault('_csr_segment_tables', {})
    version, seg, join = tables.get((steps, n_edges), (None, None, None))
    if version != rowptr._version:
        seg = csr_segments(rowptr, n_edges, steps)
        row, edge = seg[0, 1:], seg[1, 1:]
        inside = row < rowptr.shape[0] - 1
        begun = rowptr[torch.where(inside, row, 0).long()] < edge
        join = bool((inside & begun).any())
        tables[(steps, n_edges)] = (rowptr._version, seg, join)
    return seg, join


def narrow_steps(n_steps: int) -> int:
    """The narrow entry's segment length for a walk of ``n_steps`` steps:
    :data:`NARROW_SEGMENT_STEPS`, halved while that makes fewer than
    :data:`NARROW_MIN_SEGMENTS` segments, down to
    :data:`NARROW_MIN_STEPS`."""
    steps = NARROW_SEGMENT_STEPS
    while (steps > NARROW_MIN_STEPS
           and n_steps < steps * NARROW_MIN_SEGMENTS):
        steps //= 2
    return steps


def entry_for(s: int, dtype) -> str:
    """The kernel entry :func:`csr_spmm` takes for S columns of ``dtype``:
    ``'narrow'`` up to :data:`NARROW_WIDTH`, else ``'wide'``."""
    return 'narrow' if 0 < s <= NARROW_WIDTH[dtype] else 'wide'


def _check(rowptr, cols, vals, x):
    if x.ndim != 2:
        raise ValueError(f'x must be 2-D (n_cols, S), got {tuple(x.shape)}')
    if x.dtype not in _SYMBOLS or vals.dtype != x.dtype:
        raise ValueError(f'csr_spmm takes float32 or float64 vals and x of '
                         f'one dtype, got {vals.dtype} and {x.dtype}')
    if rowptr.dtype != torch.int32 or cols.dtype != torch.int32:
        raise ValueError('rowptr and cols must be int32')
    if rowptr.ndim != 1 or cols.ndim != 1 or vals.shape != cols.shape:
        raise ValueError('rowptr, cols and vals must be 1-D, cols and vals '
                         'of one length')
    for t in (rowptr, cols, vals, x):
        if t.device != x.device:
            raise ValueError('all operands must be on one device')
        if not t.is_contiguous():
            raise ValueError('all operands must be contiguous')


def csr_spmm(rowptr, cols, vals, x, *, entry=None):
    """``y = A @ x`` for a CSR ``A`` given by ``rowptr`` (n_rows + 1,),
    ``cols`` and ``vals`` (E_pad,), and x (n_cols, S). Returns (n_rows, S).
    ``entry`` (``'narrow'`` or ``'wide'``) overrides :func:`entry_for`'s
    choice of the kernel's entry on the card (for measurements and tests).

    Indices must lie inside x: :func:`pygsp_tpu_torch.core.sparse.from_coo`
    checks them when the matrix is built."""
    _check(rowptr, cols, vals, x)
    if entry not in (None, 'narrow', 'wide'):
        raise ValueError(f'entry must be None, narrow or wide, not {entry!r}')
    if x.device.type == 'cpu':
        return csr_spmm_plain(rowptr, cols, vals, x)
    if x.device.type != 'cuda':
        raise ValueError(f'csr_spmm runs on cuda or cpu, not {x.device}')
    _cuda.refuse_autograd('csr_spmm', rowptr, cols, vals, x)
    n_rows, s = rowptr.shape[0] - 1, x.shape[1]
    y = torch.empty((n_rows, s), dtype=x.dtype, device=x.device)
    if n_rows == 0 or s == 0:
        return y
    entry = entry or entry_for(s, x.dtype)
    if entry == 'narrow' and s > NARROW_MAX[x.dtype]:
        raise ValueError(f'the narrow entry takes at most '
                         f'{NARROW_MAX[x.dtype]} columns of {x.dtype}, '
                         f'not {s}')
    narrow = entry == 'narrow'
    seg, join = segment_table(
        rowptr, cols.shape[0],
        narrow_steps(n_rows + cols.shape[0]) if narrow else SEGMENT_STEPS)
    n_seg = seg.shape[1]
    # per segment, the partial sums of its first row (when that row began
    # in an earlier segment) and of its last row (when it goes on past it)
    partials = torch.empty((2 * n_seg, s), dtype=x.dtype, device=x.device)
    args = (rowptr.data_ptr(), cols.data_ptr(), vals.data_ptr(),
            x.data_ptr(), y.data_ptr(), seg.data_ptr(), partials.data_ptr(),
            n_rows, s, n_seg)
    if narrow:
        _cuda.launch('csr_spmm', _NARROW_SYMBOLS[x.dtype], 7, 4,
                     x.get_device(), *args, int(join))
    else:
        _cuda.launch('csr_spmm', _SYMBOLS[x.dtype], 7, 3, x.get_device(),
                     *args)
    csr_spmm.launches += 1
    return y


csr_spmm.launches = 0


# ---------------------------------------------------------------------------
# The SDDMM: the SpMM's gradient with respect to its stored values
# ---------------------------------------------------------------------------

_SDDMM_SYMBOLS = {torch.float32: 'csr_sddmm_f32',
                  torch.float64: 'csr_sddmm_f64'}
# Columns one launch of the SDDMM kernel takes; wider u and t take one
# launch per 512 columns, each adding its part of the dot products.
SDDMM_WIDTH = 512
# Edges the plain version gathers at once, so that its (chunk, S) products
# stay a few GB at path A's width.
SDDMM_PLAIN_CHUNK = 1 << 22


def csr_sddmm_plain(rows, cols, u, t, out, alpha, out_diag=None):
    """Plain PyTorch version of :func:`csr_sddmm`: the rows of u and t
    gathered for :data:`SDDMM_PLAIN_CHUNK` edges at a time, multiplied and
    summed over the columns, over the stored edges (the rows below
    ``n_rows``, counted by a read back to the host)."""
    n_rows = u.shape[0]
    nnz = int((rows < n_rows).sum())
    for a in range(0, nnz, SDDMM_PLAIN_CHUNK):
        b = min(nnz, a + SDDMM_PLAIN_CHUNK)
        dots = (u[rows[a:b].long()] * t[cols[a:b].long()]).sum(1)
        out[a:b] += alpha * dots
    if out_diag is not None:
        out_diag += alpha * (u * t).sum(1)
    return out


def _check_sddmm(rows, cols, u, t, out, out_diag):
    if u.ndim != 2 or t.ndim != 2 or u.shape[1] != t.shape[1]:
        raise ValueError(f'csr_sddmm: u (n_rows, S) and t (n_cols, S), got '
                         f'{tuple(u.shape)} and {tuple(t.shape)}')
    if u.dtype not in _SDDMM_SYMBOLS or not (
            t.dtype == out.dtype == u.dtype):
        raise ValueError(f'csr_sddmm takes float32 or float64 u, t and out '
                         f'of one dtype, got {u.dtype}, {t.dtype} and '
                         f'{out.dtype}')
    if rows.dtype != torch.int32 or cols.dtype != torch.int32:
        raise ValueError('rows and cols must be int32')
    if not rows.shape == cols.shape == out.shape or rows.ndim != 1:
        raise ValueError('rows, cols and out must be 1-D, of one length')
    operands = [rows, cols, u, t, out]
    if out_diag is not None:
        if (u.shape[0] != t.shape[0] or out_diag.shape != u.shape[:1]
                or out_diag.dtype != u.dtype):
            raise ValueError('out_diag: a square matrix and out_diag '
                             '(n_rows,) of the dtype of u')
        operands.append(out_diag)
    for x in operands:
        if x.device != u.device:
            raise ValueError('all operands must be on one device')
        if not x.is_contiguous():
            raise ValueError('all operands must be contiguous')


def csr_sddmm(rows, cols, u, t, out, alpha, out_diag=None):
    """``out[e] += alpha·⟨u[rows[e]], t[cols[e]]⟩`` for the stored edges
    of a CSR's row-sorted ``rows`` and ``cols`` (E_pad,), in place, and
    with ``out_diag`` (n_rows,) also
    ``out_diag[i] += alpha·⟨u[i], t[i]⟩`` in the same launch: the gradient
    of ``A @ t`` with respect to A's stored values for the cotangent u
    (n_rows, S), t (n_cols, S). Padding entries (``rows == n_rows``) are
    neither read nor written (the kernel skips an entry by its row).
    ``alpha``: a Python number or a 0-dim tensor of u's dtype. Returns
    ``out``.

    The CUDA kernel (``csrc/csr_sddmm.cu``) runs for CUDA tensors, a warp
    on a run of edges, every edge's dot product in a fixed order, so two
    launches are bit-equal; :func:`csr_sddmm_plain` for CPU tensors."""
    _check_sddmm(rows, cols, u, t, out, out_diag)
    if u.device.type == 'cpu':
        return csr_sddmm_plain(rows, cols, u, t, out, alpha, out_diag)
    if u.device.type != 'cuda':
        raise ValueError(f'csr_sddmm runs on cuda or cpu, not {u.device}')
    _cuda.refuse_autograd('csr_sddmm', rows, cols, u, t, out,
                          *(() if out_diag is None else (out_diag,)))
    n_rows, s = u.shape
    if n_rows == 0 or s == 0:
        return out
    if not isinstance(alpha, torch.Tensor):
        alpha = torch.full((), alpha, dtype=u.dtype, device=u.device)
    elif alpha.shape != () or alpha.dtype != u.dtype or (
            alpha.device != u.device):
        raise ValueError('csr_sddmm: alpha must be a number or a 0-dim '
                         'tensor of the dtype and device of u')
    item = u.element_size()
    diag_ptr = None if out_diag is None else out_diag.data_ptr()
    for a in range(0, s, SDDMM_WIDTH):      # each slice adds its columns
        _cuda.launch('csr_sddmm', _SDDMM_SYMBOLS[u.dtype], 7, 4,
                     u.get_device(), rows.data_ptr(), cols.data_ptr(),
                     u.data_ptr() + a * item, t.data_ptr() + a * item,
                     out.data_ptr(), diag_ptr, alpha.data_ptr(),
                     rows.shape[0], n_rows, min(SDDMM_WIDTH, s - a), s)
        csr_sddmm.launches += 1
    return out


csr_sddmm.launches = 0


# ---------------------------------------------------------------------------
# The fused entry: the transpose's SpMM and the weights' SDDMM in one walk
# ---------------------------------------------------------------------------

_FUSED_SYMBOLS = {torch.float32: 'csr_spmm_sddmm_f32',
                  torch.float64: 'csr_spmm_sddmm_f64'}


def fused_width(s: int, dtype) -> bool:
    """Whether :func:`csr_spmm_sddmm` takes S columns of ``dtype``: above
    :data:`NARROW_WIDTH`, where kernel A takes its wide entry, up to
    :data:`SDDMM_WIDTH`, one launch of the SDDMM. Elsewhere the backward
    keeps its two launches (:func:`csr_spmm` on the transpose and
    :func:`csr_sddmm`)."""
    return dtype in _FUSED_SYMBOLS and NARROW_WIDTH[dtype] < s <= SDDMM_WIDTH


def csr_spmm_sddmm_plain(rowptr, cols, vals, x, t, out, alpha,
                         out_diag=None):
    """Plain PyTorch version of :func:`csr_spmm_sddmm`:
    :func:`csr_spmm_plain`, then the dots of :func:`csr_sddmm_plain` in
    this matrix's edge order, each the same products summed as there."""
    y = csr_spmm_plain(rowptr, cols, vals, x)
    n_rows = rowptr.shape[0] - 1
    nnz = int(rowptr[-1])
    rows = torch.repeat_interleave(
        torch.arange(n_rows, device=x.device),
        (rowptr[1:] - rowptr[:-1]).long(), output_size=nnz)
    for a in range(0, nnz, SDDMM_PLAIN_CHUNK):
        b = min(nnz, a + SDDMM_PLAIN_CHUNK)
        dots = (x[cols[a:b].long()] * t[rows[a:b]]).sum(1)
        out[a:b] += alpha * dots
    if out_diag is not None:
        out_diag += alpha * (x * t).sum(1)
    return y


def _check_fused(rowptr, cols, vals, x, t, out, out_diag):
    _check(rowptr, cols, vals, x)
    n_rows = rowptr.shape[0] - 1
    if t.shape != (n_rows, x.shape[1]) or t.dtype != x.dtype:
        raise ValueError(f'csr_spmm_sddmm: t must be (n_rows, S) = '
                         f'{(n_rows, x.shape[1])} of {x.dtype}, got '
                         f'{tuple(t.shape)} of {t.dtype}')
    if out.shape != cols.shape or out.dtype != x.dtype:
        raise ValueError('csr_spmm_sddmm: out must be (E_pad,), of the '
                         'dtype of x')
    operands = [t, out]
    if out_diag is not None:
        if (x.shape[0] != n_rows or out_diag.shape != (n_rows,)
                or out_diag.dtype != x.dtype):
            raise ValueError('csr_spmm_sddmm: out_diag needs a square '
                             'matrix and is (n_rows,) of the dtype of x')
        operands.append(out_diag)
    for a in operands:
        if a.device != x.device:
            raise ValueError('all operands must be on one device')
        if not a.is_contiguous():
            raise ValueError('all operands must be contiguous')


def csr_spmm_sddmm(rowptr, cols, vals, x, t, out, alpha, out_diag=None):
    """``y = M @ x`` for a CSR ``M`` (``rowptr``, ``cols``, ``vals``) and,
    in the same pass over its edges,
    ``out[e] += alpha·⟨x[cols[e]], t[r]⟩`` for each stored edge e of row
    r, in place, and with ``out_diag`` (n_rows,) also
    ``out_diag[r] += alpha·⟨x[r], t[r]⟩``. Returns y (n_rows, S).

    The backward of ``A @ t`` through A's stored values calls it with
    ``M = Aᵀ`` and x the cotangent u: y is then ``Aᵀ u`` and ``out``, in
    Aᵀ's edge order, the values' cotangent ``⟨u[i], t[j]⟩`` of A's entry
    (i, j), which :func:`csr_sddmm` gives in A's order. ``alpha``: a
    Python number or a 0-dim tensor of x's dtype. Padding entries (past
    ``rowptr[-1]``) are neither read nor written.

    The CUDA kernel (the fused entry of ``csrc/csr_spmm.cu``) runs for
    CUDA tensors at the widths of :func:`fused_width`; its y is bit-equal
    to :func:`csr_spmm`'s and each entry of ``out`` and ``out_diag`` to
    :func:`csr_sddmm`'s on the same operands, and two launches are
    bit-equal. :func:`csr_spmm_sddmm_plain` runs for CPU tensors."""
    _check_fused(rowptr, cols, vals, x, t, out, out_diag)
    if x.device.type == 'cpu':
        return csr_spmm_sddmm_plain(rowptr, cols, vals, x, t, out, alpha,
                                    out_diag)
    if x.device.type != 'cuda':
        raise ValueError(f'csr_spmm_sddmm runs on cuda or cpu, not '
                         f'{x.device}')
    _cuda.refuse_autograd('csr_spmm_sddmm', rowptr, cols, vals, x, t, out,
                          *(() if out_diag is None else (out_diag,)))
    n_rows, s = rowptr.shape[0] - 1, x.shape[1]
    if not fused_width(s, x.dtype):
        raise ValueError(f'csr_spmm_sddmm takes {NARROW_WIDTH[x.dtype] + 1} '
                         f'to {SDDMM_WIDTH} columns of {x.dtype}, not {s} '
                         f'(fused_width)')
    y = torch.empty((n_rows, s), dtype=x.dtype, device=x.device)
    if n_rows == 0:
        return y
    if not isinstance(alpha, torch.Tensor):
        alpha = torch.full((), alpha, dtype=x.dtype, device=x.device)
    elif alpha.shape != () or alpha.dtype != x.dtype or (
            alpha.device != x.device):
        raise ValueError('csr_spmm_sddmm: alpha must be a number or a 0-dim '
                         'tensor of the dtype and device of x')
    seg, _ = segment_table(rowptr, cols.shape[0], SEGMENT_STEPS)
    n_seg = seg.shape[1]
    partials = torch.empty((2 * n_seg, s), dtype=x.dtype, device=x.device)
    _cuda.launch('csr_spmm', _FUSED_SYMBOLS[x.dtype], 11, 3, x.get_device(),
                 rowptr.data_ptr(), cols.data_ptr(), vals.data_ptr(),
                 x.data_ptr(), t.data_ptr(), y.data_ptr(), seg.data_ptr(),
                 partials.data_ptr(), out.data_ptr(),
                 None if out_diag is None else out_diag.data_ptr(),
                 alpha.data_ptr(), n_rows, s, n_seg)
    csr_spmm_sddmm.launches += 1
    return y


csr_spmm_sddmm.launches = 0
