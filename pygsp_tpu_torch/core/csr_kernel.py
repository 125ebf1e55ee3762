"""CSR SpMM: ``y[r, :] = Σ_{e ∈ rowptr[r]:rowptr[r+1]} vals[e] · x[cols[e], :]``.

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
"""

from __future__ import annotations

import torch

from pygsp_tpu_torch.core import _cuda

_SYMBOLS = {torch.float32: 'csr_spmm_f32', torch.float64: 'csr_spmm_f64'}

# Walk steps (row ends and edges) per warp (kSegSteps in csrc/csr_spmm.cu).
SEGMENT_STEPS = 256


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


def n_segments(n_steps: int) -> int:
    """Segments a walk of ``n_steps`` steps is cut into (at least one)."""
    return max(1, -(-n_steps // SEGMENT_STEPS))


def csr_segments(rowptr, n_edges: int):
    """Where each segment of the kernel's walk starts, int32
    ``(2, n_seg)``: ``[0, w]`` the row in progress (its end not yet
    taken) and ``[1, w]`` the next edge, after ``d = w · SEGMENT_STEPS``
    steps. Row r's end is step ``rowptr[r+1] + r`` of the walk, so the row
    is the count of row ends before ``d``, one ``torch.searchsorted``, and
    the edge ``d`` less that. ``n_edges``, the length of the (padded) edge
    arrays, bounds ``rowptr[-1]`` on the host, so the table needs no
    device-to-host copy; segments past the walk's end start at row
    ``n_rows``."""
    n_rows = rowptr.shape[0] - 1
    ends = rowptr[1:] + torch.arange(n_rows, dtype=torch.int32,
                                     device=rowptr.device)
    d = torch.arange(n_segments(n_rows + n_edges), dtype=torch.int32,
                     device=rowptr.device) * SEGMENT_STEPS
    row = torch.searchsorted(ends, d, out_int32=True)
    return torch.stack([row, d - row])


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


def csr_spmm(rowptr, cols, vals, x):
    """``y = A @ x`` for a CSR ``A`` given by ``rowptr`` (n_rows + 1,),
    ``cols`` and ``vals`` (E_pad,), and x (n_cols, S). Returns (n_rows, S).

    Indices must lie inside x: :func:`pygsp_tpu_torch.core.sparse.from_coo`
    checks them when the matrix is built."""
    _check(rowptr, cols, vals, x)
    if x.device.type == 'cpu':
        return csr_spmm_plain(rowptr, cols, vals, x)
    if x.device.type != 'cuda':
        raise ValueError(f'csr_spmm runs on cuda or cpu, not {x.device}')
    _cuda.refuse_autograd('csr_spmm', rowptr, cols, vals, x)
    n_rows, s = rowptr.shape[0] - 1, x.shape[1]
    y = torch.empty((n_rows, s), dtype=x.dtype, device=x.device)
    if n_rows == 0 or s == 0:
        return y
    seg = csr_segments(rowptr, cols.shape[0])
    n_seg = seg.shape[1]
    # per segment, the partial sums of its first row (when that row began
    # in an earlier segment) and of its last row (when it goes on past it)
    partials = torch.empty((2 * n_seg, s), dtype=x.dtype, device=x.device)
    _cuda.launch('csr_spmm', _SYMBOLS[x.dtype], 7, 3, x.get_device(),
                 rowptr.data_ptr(), cols.data_ptr(), vals.data_ptr(),
                 x.data_ptr(), y.data_ptr(), seg.data_ptr(),
                 partials.data_ptr(), n_rows, s, n_seg)
    csr_spmm.launches += 1
    return y


csr_spmm.launches = 0
