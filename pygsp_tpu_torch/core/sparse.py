"""Sparse matrices as small dataclasses of tensors: padded CSR, multi-level
ELL and block-banded.

Counterpart of :mod:`pygsp_tpu.core.sparse`, with the same field names so
that operators carry across (:mod:`pygsp_tpu_torch.convert`). Edges are
row-sorted COO triplets padded to a block multiple, beside a CSR row
pointer. Padding entries carry ``rows == n_rows``, ``cols == n_cols`` and
``val == 0``; the SpMM reads only the ``rowptr`` ranges, so it never touches
them.

The builders run on the host (NumPy in, tensors on ``device`` out). Entry
points default to ``device='cuda'``; the CPU is used only when asked for.
The chunked format lives in :mod:`.chunked` and the windowed-compact one
in :mod:`.windowed`; :func:`spmm`, :func:`to_scipy` and :func:`to_dense`
dispatch to them too.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple

import numpy as np
import scipy.sparse as sps
import torch

from pygsp_tpu_torch.core import (banded_kernel, chunked, csr_kernel,
                                  ell_kernel, windowed, windowed_kernel)
# Rows and columns of one dense tile of the block-banded format.
from pygsp_tpu_torch.core.banded_kernel import BAND_TILE
from pygsp_tpu_torch.core.chunked import ChunkedELLMatrix, ChunkLevel
from pygsp_tpu_torch.core.windowed import WindowedELLMatrix

# Edge arrays are padded to a multiple of this (the JAX package's layout).
EDGE_BLOCK = 1024
# The ELL format's level 0 rows are padded to a multiple of this.
ROW_BLOCK = 8

_FORMATS = ('CSRMatrix, ELLMatrix, BandedMatrix, ChunkedELLMatrix or '
            'WindowedELLMatrix')


def _unknown(mat):
    return TypeError(f'{type(mat).__name__} is not a sparse format of this '
                     f'package: expected a {_FORMATS}')


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _torch_dtype(dtype):
    """``None`` -> float32 (the operator default); numpy or torch -> torch."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype=dtype)).dtype


def _numpy_dtype(dtype: torch.dtype):
    return torch.zeros(0, dtype=dtype).numpy().dtype


@dataclasses.dataclass(frozen=True)
class CSRMatrix:
    """Row-sorted padded COO + CSR row pointers.

    Attributes
    ----------
    rows, cols : int32 tensors of shape (E_pad,), row-major sorted; padding
        entries sit at the end with ``rows == n_rows``/``cols == n_cols``.
    vals : float tensor of shape (E_pad,); zero on padding entries.
    rowptr : int32 tensor of shape (n_rows + 1,); ``rowptr[-1] == nnz``.
    n_rows, n_cols, nnz : Python ints.
    """

    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    rowptr: torch.Tensor
    n_rows: int
    n_cols: int
    nnz: int

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def n_edges_padded(self) -> int:
        return int(self.rows.shape[0])

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self):
        return self.vals.device

    def astype(self, dtype) -> 'CSRMatrix':
        return dataclasses.replace(self, vals=self.vals.to(dtype))

    def with_vals(self, vals: torch.Tensor) -> 'CSRMatrix':
        """Same sparsity pattern, new values (shape (E_pad,))."""
        return dataclasses.replace(self, vals=vals)

    def leaves(self) -> tuple:
        """The float leaves of the JAX package's pytree: ``(vals,)``."""
        return (self.vals,)

    def with_leaves(self, leaves) -> 'CSRMatrix':
        return self.with_vals(leaves[0])

    # the tensors the kernels read are the leaves themselves (the chunked
    # format's differ: :meth:`ChunkedELLMatrix.buffers`)
    buffers = leaves
    with_buffers = with_leaves

    def scale_vals(self, scale) -> 'CSRMatrix':
        return dataclasses.replace(self, vals=self.vals * scale)

    def __matmul__(self, x):
        return spmm(self, x)

    @property
    def T(self) -> 'CSRMatrix':
        """The transpose, on the matrix's device: a stable sort of the
        entries by column, so each new row keeps its entries in the old row
        order; padding (``cols == n_cols``, beyond every real column) sorts
        to the end. The row pointer comes from the column counts."""
        return _transpose(self)[0]


def _transpose(mat: CSRMatrix):
    """``(Aᵀ, order)``: :attr:`CSRMatrix.T` of ``mat`` and its edge order,
    entry p of the transpose being entry ``order[p]`` of ``mat``; a
    cotangent taken in the transpose's order goes back to ``mat``'s by
    one scatter, ``out.index_copy_(0, order, out_t)``."""
    order = torch.argsort(mat.cols, stable=True)
    real = mat.rows < mat.n_rows
    counts = torch.bincount(
        torch.where(real, mat.cols, mat.n_cols).long(),
        minlength=mat.n_cols + 1)[:mat.n_cols]
    rowptr = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
    return CSRMatrix(rows=mat.cols[order], cols=mat.rows[order],
                     vals=mat.vals[order], rowptr=rowptr.to(torch.int32),
                     n_rows=mat.n_cols, n_cols=mat.n_rows,
                     nnz=mat.nnz), order


# ---------------------------------------------------------------------------
# Builders (host-side; NumPy in, tensors out)
# ---------------------------------------------------------------------------

def from_coo(rows, cols, vals, n_rows: int, n_cols: int | None = None,
             *, dtype=None, sum_duplicates: bool = True,
             edge_block: int = EDGE_BLOCK, device='cuda') -> CSRMatrix:
    """Build a padded CSRMatrix from host COO triplets.

    Explicit zeros are dropped and the triplets sorted by row then column.
    With ``sum_duplicates`` (the default) entries at one place are summed
    into one; without it they stay separate stored entries, in their input
    order, as in the JAX package. The edge arrays are padded to a multiple
    of ``edge_block``. ``dtype`` defaults to float32.
    """
    if n_cols is None:
        n_cols = n_rows
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals).astype(_numpy_dtype(_torch_dtype(dtype)))
    if rows.shape != cols.shape or rows.shape != vals.shape:
        raise ValueError('rows/cols/vals must have identical shapes')
    if rows.size and (rows.min() < 0 or rows.max() >= n_rows
                      or cols.min() < 0 or cols.max() >= n_cols):
        raise ValueError(f'COO indices out of range for shape '
                         f'({n_rows}, {n_cols})')

    keep = vals != 0
    rows, cols, vals = rows[keep], cols[keep], vals[keep]

    if sum_duplicates and rows.size:
        key = rows * n_cols + cols
        order = np.argsort(key, kind='stable')
        key, rows, cols, vals = key[order], rows[order], cols[order], vals[order]
        uniq, inv = np.unique(key, return_inverse=True)
        if uniq.size != key.size:
            summed = np.zeros(uniq.size, dtype=vals.dtype)
            np.add.at(summed, inv, vals)
            rows = uniq // n_cols
            cols = uniq % n_cols
            vals = summed
    elif rows.size:
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]

    return _pad_and_build(rows, cols, vals, n_rows, n_cols, edge_block,
                          device)


def _pad_and_build(rows, cols, vals, n_rows, n_cols, edge_block,
                   device) -> CSRMatrix:
    nnz = int(rows.size)
    e_pad = max(_round_up(nnz, edge_block), edge_block)
    pad = e_pad - nnz
    rows_p = np.concatenate([rows, np.full(pad, n_rows, dtype=np.int64)])
    cols_p = np.concatenate([cols, np.full(pad, n_cols, dtype=np.int64)])
    vals_p = np.concatenate([vals, np.zeros(pad, dtype=vals.dtype)])

    counts = np.bincount(rows, minlength=n_rows) if nnz else np.zeros(n_rows, np.int64)
    rowptr = np.zeros(n_rows + 1, dtype=np.int32)
    np.cumsum(counts, out=rowptr[1:])

    return CSRMatrix(
        rows=torch.from_numpy(rows_p.astype(np.int32)).to(device),
        cols=torch.from_numpy(cols_p.astype(np.int32)).to(device),
        vals=torch.from_numpy(vals_p).to(device),
        rowptr=torch.from_numpy(rowptr).to(device),
        n_rows=int(n_rows), n_cols=int(n_cols), nnz=nnz,
    )


def from_scipy(mat, *, dtype=None, edge_block: int = EDGE_BLOCK,
               device='cuda') -> CSRMatrix:
    """Build from any scipy.sparse matrix."""
    coo = mat.tocoo()
    return from_coo(coo.row, coo.col, coo.data, coo.shape[0], coo.shape[1],
                    dtype=dtype, sum_duplicates=True, edge_block=edge_block,
                    device=device)


def from_dense(arr, *, dtype=None, edge_block: int = EDGE_BLOCK,
               device='cuda') -> CSRMatrix:
    arr = np.asarray(arr)
    rows, cols = np.nonzero(arr)
    return from_coo(rows, cols, arr[rows, cols], arr.shape[0], arr.shape[1],
                    dtype=dtype, edge_block=edge_block, device=device)


def to_scipy(mat):
    """Export any of the formats back to scipy CSR (padding dropped,
    original vertex order)."""
    if isinstance(mat, ELLMatrix):
        return _ell_to_scipy(mat)
    if isinstance(mat, BandedMatrix):
        return _banded_to_scipy(mat)
    if isinstance(mat, ChunkedELLMatrix):
        return chunked.chunked_to_scipy(mat)
    if isinstance(mat, WindowedELLMatrix):
        return windowed.windowed_to_scipy(mat)
    if not isinstance(mat, CSRMatrix):
        raise _unknown(mat)
    nnz = mat.nnz
    rows = mat.rows[:nnz].cpu().numpy()
    cols = mat.cols[:nnz].cpu().numpy()
    vals = mat.vals[:nnz].cpu().numpy()
    return sps.csr_matrix((vals, (rows, cols)), shape=mat.shape)


def _banded_to_scipy(mat: 'BandedMatrix'):
    """The tiles' nonzero entries at their places, without a dense N × N
    matrix (a 512 × 512 grid's would take 275 GB)."""
    tiles = mat.tiles.cpu().numpy()        # (nb, 2*half_bw+1, 128, 128)
    _, _, tr, tc = tiles.shape
    i, d, r, c = np.nonzero(tiles)
    rows = i * tr + r
    cols = (i + d - mat.half_bw) * tc + c
    keep = (rows < mat.n_rows) & (cols >= 0) & (cols < mat.n_cols)
    return sps.csr_matrix((tiles[i, d, r, c][keep], (rows[keep], cols[keep])),
                          shape=(mat.n_rows, mat.n_cols))


def to_dense(mat) -> torch.Tensor:
    """Densify on the matrix's device (small matrices only)."""
    if isinstance(mat, (ELLMatrix, BandedMatrix, ChunkedELLMatrix,
                        WindowedELLMatrix)):
        return torch.from_numpy(to_scipy(mat).toarray()).to(mat.device)
    if not isinstance(mat, CSRMatrix):
        raise _unknown(mat)
    out = torch.zeros(mat.shape, dtype=mat.dtype, device=mat.device)
    nnz = mat.nnz
    out.index_put_((mat.rows[:nnz].long(), mat.cols[:nnz].long()),
                   mat.vals[:nnz], accumulate=True)
    return out


# ---------------------------------------------------------------------------
# SpMM dispatch
# ---------------------------------------------------------------------------

def spmm(mat, x: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """``y = A @ x`` for x of shape (n_cols,) or (n_cols, ...).

    CSR goes to the CSR SpMM kernel, ELL to the ELL SpMM kernel, banded to
    the banded SpMM kernel, chunked to the chunked SpMM kernel, windowed to
    the windowed fold and strip kernels. Each wrapper launches its CUDA
    kernel for a CUDA tensor and runs its plain PyTorch version for a CPU
    tensor. Operands of mixed dtypes are promoted, as in the JAX package.
    It differentiates with respect to the value leaves (:meth:`leaves`) and
    ``x`` on every format and both devices, twice over: a CSR by
    :class:`_CSRSpmm`, an ELL, chunked or windowed matrix by
    :class:`_SlotSpmm`, a banded one by :class:`_BandedSpmm`. ``out_dtype``:
    the dtype of ``y`` (the chunked and windowed formats' bf16 modes emit
    the product narrow; the others cast it); under autograd a bf16 or
    float16 operand or ``out_dtype`` raises ``ValueError``. Any other
    operand raises ``TypeError``.
    """
    if isinstance(mat, (ELLMatrix, BandedMatrix, ChunkedELLMatrix,
                        WindowedELLMatrix)) and _spmm_records(mat, x):
        return _format_spmm(mat, torch.as_tensor(x), out_dtype)
    if isinstance(mat, WindowedELLMatrix):
        return windowed.windowed_spmm(mat, x, out_dtype=out_dtype)
    if isinstance(mat, ChunkedELLMatrix):
        return chunked.chunked_spmm(mat, x, out_dtype=out_dtype)
    if isinstance(mat, ELLMatrix):
        return ell_spmm(mat, x, out_dtype=out_dtype)
    if not isinstance(mat, (CSRMatrix, BandedMatrix)):
        raise _unknown(mat)
    x = torch.as_tensor(x)
    if x.ndim == 0 or x.shape[0] != mat.n_cols:
        raise ValueError(f'x must have {mat.n_cols} rows, got shape '
                         f'{tuple(x.shape)}')
    dtype = torch.promote_types(x.dtype, mat.dtype)
    lead = x.shape[1:]
    x2 = x.to(dtype).reshape(mat.n_cols, -1).contiguous()
    if isinstance(mat, CSRMatrix):
        vals = mat.vals.to(dtype)
        if torch.is_grad_enabled() and (vals.requires_grad
                                        or x2.requires_grad):
            y = _CSRSpmm.apply(mat, vals, x2)
        else:
            y = csr_kernel.csr_spmm(mat.rowptr, mat.cols, vals, x2)
    else:
        y = banded_kernel.banded_spmm(mat.tiles.to(dtype), x2, mat.n_rows)
    return y.reshape((mat.n_rows,) + lead).to(out_dtype or dtype)


class _CSRSpmm(torch.autograd.Function):
    """``A @ x`` on a CSR with its own backward, on both devices: the SpMM
    kernel (or its plain version) forward, and for the cotangent ȳ

    - ``x̄ = Aᵀ ȳ``, the same kernel on :attr:`CSRMatrix.T`;
    - ``vals̄[e] = ⟨ȳ[rows[e]], x[cols[e]]⟩``, the SDDMM
      (:func:`~pygsp_tpu_torch.core.csr_kernel.csr_sddmm`), 0 on padding.

    :func:`spmm` takes it under grad mode when ``vals`` or ``x`` requires
    grad; the kernels run inside, where autograd records nothing. The
    backward is itself made of :class:`_CSRSpmm` and :class:`_CSRSddmm`,
    so it differentiates again (``create_graph=True``). Where both are
    needed and the backward is not recorded, at the widths of
    :func:`~pygsp_tpu_torch.core.csr_kernel.fused_width`, one walk of the
    transpose gives both
    (:func:`~pygsp_tpu_torch.core.csr_kernel.csr_spmm_sddmm`, the same
    bits). ``x`` is kept only where ``vals`` requires grad, so that a
    caller may write into it once the product is taken (the recurrence's
    ring of terms)."""

    @staticmethod
    def forward(ctx, mat, vals, x):
        ctx.mat = mat
        ctx.save_for_backward(vals, x if ctx.needs_input_grad[1] else None)
        return csr_kernel.csr_spmm(mat.rowptr, mat.cols, vals, x)

    @staticmethod
    def backward(ctx, ybar):
        vals, x = ctx.saved_tensors
        ybar = ybar.contiguous()
        if (ctx.needs_input_grad[1] and ctx.needs_input_grad[2]
                and not torch.is_grad_enabled()
                and csr_kernel.fused_width(ybar.shape[1], ybar.dtype)):
            At, order = _transpose(ctx.mat.with_vals(vals))
            out_t = torch.zeros_like(vals)
            x_bar = csr_kernel.csr_spmm_sddmm(At.rowptr, At.cols, At.vals,
                                              ybar, x, out_t, 1.0)
            return (None, torch.empty_like(out_t).index_copy_(0, order, out_t),
                    x_bar)
        vals_bar = x_bar = None
        if ctx.needs_input_grad[1]:
            vals_bar = _CSRSddmm.apply(ctx.mat, ybar, x)
        if ctx.needs_input_grad[2]:
            At = ctx.mat.with_vals(vals).T
            x_bar = _CSRSpmm.apply(At, At.vals, ybar)
        return None, vals_bar, x_bar


class _CSRSddmm(torch.autograd.Function):
    """``out[e] = ⟨u[rows[e]], t[cols[e]]⟩`` on a CSR's stored entries, 0
    on padding: the SDDMM as a function of u and t, the weights' cotangent
    of :class:`_CSRSpmm`. Its own backward for ō is two SpMMs with ō as
    the values, ``ū = A(ō) t`` and ``t̄ = A(ō)ᵀ u``."""

    @staticmethod
    def forward(ctx, mat, u, t):
        ctx.mat = mat
        ctx.save_for_backward(u, t)
        out = u.new_zeros(mat.rows.shape)
        return csr_kernel.csr_sddmm(mat.rows, mat.cols, u, t, out, 1.0)

    @staticmethod
    def backward(ctx, obar):
        u, t = ctx.saved_tensors
        mat = ctx.mat.with_vals(obar.contiguous())
        u_bar = t_bar = None
        if ctx.needs_input_grad[1]:
            u_bar = _CSRSpmm.apply(mat, mat.vals, t)
        if ctx.needs_input_grad[2]:
            At = mat.T
            t_bar = _CSRSpmm.apply(At, At.vals, u)
        return None, u_bar, t_bar


# ---------------------------------------------------------------------------
# The other formats' SpMM under autograd
# ---------------------------------------------------------------------------

# the bf16 modes under autograd: ROADMAP.md §1 item 6
BF16_GRAD = ('{}: the bf16 modes (carry_dtype, vals_dtype, scatter_dtype, a '
             'bf16 operand or out_dtype) are not differentiated: the '
             'backward runs in the signal\'s dtype (ROADMAP.md §1 item 6, '
             'the bf16 modes under autograd); call it without them, or '
             'under torch.no_grad()')
_NARROW = (torch.bfloat16, torch.float16)


def _spmm_records(mat, x) -> bool:
    """Whether autograd would record ``mat @ x``: grad mode is on and x or
    one of the matrix's value leaves requires grad."""
    return torch.is_grad_enabled() and (
        getattr(x, 'requires_grad', False)
        or any(v.requires_grad for v in mat.leaves()))


def _format_spmm(mat, x, out_dtype):
    """:func:`spmm` on an ELL, chunked, windowed or banded matrix where
    autograd records it: the operands promoted to one float32 or float64
    dtype (a recorded cast), the relabeling's permutes outside the
    Function, so that it works in the matrix's internal order, as
    :func:`grad_edges` does."""
    if x.ndim == 0 or x.shape[0] != mat.n_cols:
        raise ValueError(f'x must have {mat.n_cols} rows, got shape '
                         f'{tuple(x.shape)}')
    if x.dtype in _NARROW or mat.dtype in _NARROW or out_dtype in _NARROW:
        raise ValueError(BF16_GRAD.format('spmm'))
    pdt = torch.promote_types(x.dtype, mat.dtype)
    if mat.dtype != pdt:
        mat = mat.astype(pdt)
    x2 = x.to(pdt).reshape(mat.n_cols, -1)
    if isinstance(mat, BandedMatrix):
        y = _BandedSpmm.apply(mat, x2.contiguous(), mat.tiles)
    else:
        if getattr(mat, 'perm', None) is None:
            y = _SlotSpmm.apply(mat, x2.contiguous(), *mat.buffers())
        else:
            inner = dataclasses.replace(mat, perm=None, iperm=None)
            y = chunked.permute_out(mat, _SlotSpmm.apply(
                inner, chunked.permute_in(mat, x2).contiguous(),
                *inner.buffers()))
    return y.reshape((mat.n_rows,) + x.shape[1:]).to(out_dtype or pdt)


def _slot_spmm_internal(mat, x):
    """The format's own kernel for ``y = A @ x`` in its internal order, x
    (n_cols, S) in the matrix's dtype: what :func:`spmm` launches."""
    if isinstance(mat, WindowedELLMatrix):
        return windowed.spmm_internal(mat, x)
    if isinstance(mat, ChunkedELLMatrix):
        return chunked.spmm_internal(mat, x)
    return ell_spmm(mat, x)


class _SlotSpmm(torch.autograd.Function):
    """``A @ x`` on an ELL, chunked or windowed matrix in its internal
    order, with its own backward on the CSR view of the live slots
    (:func:`entry_pair`), on both devices: the format's kernel forward
    (bit-equal to the unrecorded call), and for the cotangent ȳ

    - ``x̄ = Aᵀ ȳ``, :class:`_CSRSpmm` on the transpose, its values
      gathered from the leaves;
    - the leaves' cotangent ``⟨ȳ[i], x[j]⟩`` for the slot of entry (i, j),
      :class:`_CSRSddmm` on the entries, scattered to the leaves; a padding
      slot gets exactly 0 (the kernels never read it).

    Where both are needed and the backward is not recorded, at the widths
    of :func:`~pygsp_tpu_torch.core.csr_kernel.fused_width`, one walk of
    the transpose gives both (kernel A's fused entry, as in
    :class:`_CSRSpmm`). The backward is made of those Functions and
    recorded torch ops, so it differentiates again. ``*buffers`` are
    ``mat``'s ``buffers()`` (its leaves, or the chunked format's flat slot
    buffer and tiers), inputs of their own so that autograd carries their
    cotangents back; ``x`` is kept only where they require grad."""

    @staticmethod
    def forward(ctx, mat, x, *buffers):
        ctx.mat = mat
        ctx.save_for_backward(x if any(ctx.needs_input_grad[2:]) else None,
                              *buffers)
        return _slot_spmm_internal(mat, x)

    @staticmethod
    def backward(ctx, ybar):
        x, *buffers = ctx.saved_tensors
        need_x, need_v = ctx.needs_input_grad[1], any(ctx.needs_input_grad[2:])
        ybar = ybar.contiguous()
        pair = entry_pair(ctx.mat, ybar.dtype, buffers)
        if (need_v and need_x and not torch.is_grad_enabled()
                and csr_kernel.fused_width(ybar.shape[1], ybar.dtype)):
            At = pair.bwd
            out_t = torch.zeros(At.rows.shape, dtype=ybar.dtype,
                                device=ybar.device)
            x_bar = csr_kernel.csr_spmm_sddmm(At.rowptr, At.cols, At.vals,
                                              ybar, x, out_t, 1.0)
            return (None, x_bar) + pair.to_leaves_t(out_t)
        x_bar, buffers_bar = None, (None,) * len(buffers)
        if need_v:
            buffers_bar = pair.to_leaves(_CSRSddmm.apply(pair.fwd, ybar, x))
        if need_x:
            x_bar = _CSRSpmm.apply(pair.bwd, pair.bwd.vals, ybar)
        return (None, x_bar) + buffers_bar


class _BandedSpmm(torch.autograd.Function):
    """``A @ x`` on a banded matrix with its own backward, on both
    devices: the banded kernel forward, and for the cotangent ȳ

    - ``x̄ = Aᵀ ȳ``, the same kernel on the transposed tiles
      (:attr:`BandedMatrix.T`);
    - ``tiles̄[n, d] = ȳ[block n]·x[block n + d − b]ᵀ``, one batched
      product over the tile rows (:func:`band_operands`, float32 not TF32).

    Both are recorded ops and Functions, so the backward differentiates
    again."""

    @staticmethod
    def forward(ctx, mat, x, tiles):
        ctx.mat = mat
        ctx.save_for_backward(x if ctx.needs_input_grad[2] else None, tiles)
        return banded_kernel.banded_spmm(tiles, x, mat.n_rows)

    @staticmethod
    def backward(ctx, ybar):
        x, tiles = ctx.saved_tensors
        mat = ctx.mat.with_leaves((tiles,))
        ybar = ybar.contiguous()
        x_bar = tiles_bar = None
        if ctx.needs_input_grad[1]:
            At = mat.T
            x_bar = _BandedSpmm.apply(At, ybar, At.tiles)
        if ctx.needs_input_grad[2]:
            nb, b = mat.tiles.shape[0], mat.half_bw
            u, win = band_operands(ybar, x, b, nb)
            with fp32_matmul():
                acc = torch.bmm(u, win.transpose(1, 2))
            tiles_bar = band_tiles(acc, b)
        return None, x_bar, tiles_bar


@contextlib.contextmanager
def fp32_matmul():
    """float32 products in float32 (not TF32) on the card, whatever the
    caller's setting."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def band_operands(u, t, half_bw: int, nb: int):
    """``(ub, win)`` for the tiles' cotangent ``Σ_s u[row]·t[col]`` of a
    banded matrix of ``nb`` tile rows and half bandwidth b: ``ub`` (nb,
    128, S), u's tile rows, zero past its n rows; ``win`` (nb, (2b+1)·128,
    S), tile row n's 2b + 1 blocks of t around it, n − b .. n + b, which
    lie end to end in a zero-padded copy of t (a strided view, no copy per
    tile). ``ub[n] @ win[n]ᵀ`` is tile row n's (128, (2b+1)·128) product
    (:func:`band_tiles` lays it out as tiles)."""
    n, s = u.shape[0], u.numel() // max(u.shape[0], 1)
    ub = torch.zeros((nb * BAND_TILE, s), dtype=u.dtype, device=u.device)
    ub[:n] = u.reshape(n, s)
    tp = torch.zeros(((nb + 2 * half_bw) * BAND_TILE, s), dtype=u.dtype,
                     device=u.device)
    tp[half_bw * BAND_TILE:half_bw * BAND_TILE + n] = t.reshape(n, s)
    win = tp.as_strided((nb, (2 * half_bw + 1) * BAND_TILE, s),
                        (BAND_TILE * s, s, 1))
    return ub.view(nb, BAND_TILE, s), win


def band_tiles(acc, half_bw: int):
    """(nb, 128, (2b+1)·128) tile-row products → (nb, 2b+1, 128, 128)
    tiles."""
    nb = acc.shape[0]
    return acc.view(nb, BAND_TILE, 2 * half_bw + 1, BAND_TILE) \
        .permute(0, 2, 1, 3).contiguous()


def transpose_tiles(tiles, half_bw: int):
    """The tiles of the transposed banded matrix, ``out[n, d] = tiles[n + d
    − b, 2b − d]ᵀ`` (zero where that tile row is out of range). The map is
    its own inverse and its own adjoint, so a cotangent of the transposed
    tiles goes back to the tiles by it too. Recorded by autograd."""
    nb, nd = tiles.shape[:2]
    out = torch.zeros_like(tiles)
    for d in range(nd):
        lo, hi = max(0, half_bw - d), min(nb, nb + half_bw - d)
        out[lo:hi, d] = tiles[lo + d - half_bw:hi + d - half_bw,
                              2 * half_bw - d].transpose(-1, -2)
    return out


# ---------------------------------------------------------------------------
# A matrix's entries and its transpose as CSRs, for the backwards
# ---------------------------------------------------------------------------

class EntryPair(NamedTuple):
    """A matrix ``A`` as two matrices of one format, both with values:
    ``fwd``, A's stored entries, and ``bwd``, Aᵀ, and how a cotangent on
    either's entries (or tiles) reaches A's :meth:`leaves`:
    ``to_leaves(v)`` from fwd's order, ``to_leaves_t(v)`` from bwd's, each
    a tuple with one tensor a leaf. On a banded matrix both are
    :class:`BandedMatrix`. :meth:`swapped` is the same pair for Aᵀ, whose
    entries are A's: the synthesis's backward, the analysis bank on the
    transpose, takes it."""
    fwd: object
    bwd: object
    to_leaves: object
    to_leaves_t: object

    def swapped(self) -> 'EntryPair':
        return EntryPair(self.bwd, self.fwd, self.to_leaves_t,
                         self.to_leaves)


def entry_pair(mat, dt=None, leaves=None) -> EntryPair:
    """:class:`EntryPair` of ``mat`` (in its internal order) with values in
    ``dt`` (default the matrix's dtype), read from ``leaves`` (default
    ``mat.buffers()``: the leaves, or the chunked format's flat slot buffer
    and tiers, the same values in the same flat order), to whose tensors
    the pair's cotangents go: a CSR and :func:`_transpose`; an ELL,
    chunked or windowed matrix's live slots as the CSR view
    :func:`grad_edges` keeps (built once per structure), both matrices'
    values gathered from the leaves end to end; a banded matrix and
    :attr:`BandedMatrix.T`. The gathers and the transposes are recorded
    by autograd where it is on."""
    leaves = mat.buffers() if leaves is None else tuple(leaves)
    dt = dt or leaves[0].dtype
    if isinstance(mat, CSRMatrix):
        A = mat.with_vals(leaves[0].to(dt))
        At, order = _transpose(A)
        return EntryPair(A, At, lambda v: (v.to(leaves[0].dtype),),
                         lambda v: (torch.empty_like(v).index_copy_(
                             0, order, v).to(leaves[0].dtype),))
    if isinstance(mat, BandedMatrix):
        A = mat.with_leaves((leaves[0].to(dt),))
        b = mat.half_bw
        return EntryPair(A, A.T, lambda v: (v.to(leaves[0].dtype),),
                         lambda v: (transpose_tiles(v, b)
                                    .to(leaves[0].dtype),))
    edges = grad_edges(mat)
    # the leaves end to end and a zero, which the padding's index reads
    flat = torch.cat([v.reshape(-1).to(dt) for v in leaves]
                     + [torch.zeros(1, dtype=dt, device=leaves[0].device)])

    def place(index):
        """A cotangent in the order of ``index``'s entries, scattered to
        the leaves (padding to the zero past them, which is dropped)."""
        def to_leaves(v):
            out = torch.zeros_like(flat).index_copy(0, index, v)
            parts = torch.split(out[:-1], [t.numel() for t in leaves])
            return tuple(p.reshape(t.shape).to(t.dtype)
                         for p, t in zip(parts, leaves))
        return to_leaves

    return EntryPair(edges.csr.with_vals(flat[edges.csr.vals]),
                     edges.csr_t.with_vals(flat[edges.csr_t.vals]),
                     place(edges.csr.vals), place(edges.csr_t.vals))


# ---------------------------------------------------------------------------
# The slot formats' stored edges as a CSR, for the bank's backward
# ---------------------------------------------------------------------------

class GradEdges(NamedTuple):
    """The live slots of an ELL, chunked or windowed matrix as a CSR in the
    matrix's internal order, for the backward of the bank through its
    values (:func:`~pygsp_tpu_torch.ops.chebyshev._operator_grads`): the
    adjoint runs the CSR kernel on ``csr_t``, the transpose, and the
    values' cotangent comes from the SDDMM on ``csr``'s entries or in the
    transpose's SpMM. Both matrices hold, as their values, each entry's
    index in the concatenated flat leaves (:meth:`leaves`; int64, and
    ``n_flat`` on padding), so that the transpose's values are one
    gather of the leaves and a cotangent in either order reaches them by
    one scatter. Made once per structure by :func:`grad_edges`."""
    csr: CSRMatrix
    csr_t: CSRMatrix
    n_flat: int


def grad_edges(mat) -> GradEdges:
    """:class:`GradEdges` of ``mat`` (an ELL, chunked or windowed matrix,
    in its internal order), built on its device at the first call and kept
    on the structure's index tensor, so that matrices that share the
    structure (:meth:`with_leaves`, :meth:`astype`) share it: a loop that
    replaces the values builds nothing. Counts its builds in
    ``grad_edges.builds``."""
    key = {ELLMatrix: 'ell_cols', ChunkedELLMatrix: 'slot_cols',
           WindowedELLMatrix: 'cols'}[type(mat)]
    holder = getattr(mat, key)
    edges = getattr(holder, '_grad_edges', None)
    if edges is not None:
        return edges
    grad_edges.builds += 1
    rows, cols, index = mat.live_slots()
    n, nnz = mat.n_rows, int(rows.numel())
    n_flat = sum(v.numel() for v in mat.leaves())
    order = torch.argsort(rows * max(mat.n_cols, 1) + cols, stable=True)
    pad = max(_round_up(nnz, EDGE_BLOCK), EDGE_BLOCK) - nnz

    def padded(t, fill):
        return torch.cat([t[order], t.new_full((pad,), fill)])

    counts = torch.bincount(rows, minlength=n)
    rowptr = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
    csr = CSRMatrix(rows=padded(rows, n).to(torch.int32),
                    cols=padded(cols, mat.n_cols).to(torch.int32),
                    vals=padded(index, n_flat),
                    rowptr=rowptr.to(torch.int32), n_rows=n,
                    n_cols=mat.n_cols, nnz=nnz)
    edges = GradEdges(csr=csr, csr_t=_transpose(csr)[0], n_flat=n_flat)
    holder._grad_edges = edges
    return edges


grad_edges.builds = 0


# ---------------------------------------------------------------------------
# Multi-level ELL format ('hybrid')
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ELLLevel:
    """One overflow level: ``rows`` (R,) unique row ids (int32);
    ``cols``/``vals`` (R, w) slot blocks holding those rows' next w
    edges."""

    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor


@dataclasses.dataclass(frozen=True)
class ELLMatrix:
    """Multi-level ELL, the counterpart of the JAX package's ``ELLMatrix``
    (``fmt='hybrid'``), with its field names and arrays:

    - level 0: every row owns ``ell_width`` slots, ``ell_cols``/``ell_vals``
      of shape (n_pad, ell_width), ``n_pad`` rounded up to
      :data:`ROW_BLOCK`;
    - level ℓ ≥ 1 (:class:`ELLLevel`): the rows still overflowing, each
      level's rows unique, in geometrically wider slot blocks.

    Slot padding: ``col == n_cols``, ``val == 0``. ``rowptr``: the true
    degrees as a CSR pointer (int32). The port adds two operands of the
    SpMM kernel (:mod:`.ell_kernel`), made once at upload: ``table``, level
    0 as one block of the kernel's slot table over the flat ``ell_cols``
    and ``ell_vals``, and ``residue``, the levels as one list sorted by row
    (None without levels).
    """

    ell_cols: torch.Tensor
    ell_vals: torch.Tensor
    levels: tuple
    rowptr: torch.Tensor
    n_rows: int
    n_cols: int
    nnz: int
    ell_width: int
    table: ell_kernel.SlotTable = None
    residue: windowed_kernel.Residue | None = None

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def dtype(self):
        return self.ell_vals.dtype

    @property
    def device(self):
        return self.ell_vals.device

    def _map_vals(self, fn) -> 'ELLMatrix':
        """The matrix with the elementwise ``fn`` applied to every value."""
        return self.with_leaves(tuple(fn(v) for v in self.leaves()))

    def leaves(self) -> tuple:
        """The float leaves of the JAX package's pytree, in its order:
        ``ell_vals``, then every level's ``vals``."""
        return (self.ell_vals,) + tuple(lev.vals for lev in self.levels)

    def with_leaves(self, leaves) -> 'ELLMatrix':
        """The matrix with :meth:`leaves` replaced (the same shapes), the
        residue list's values gathered from the new levels by its map
        (:func:`~.chunked.level_values`), on the device."""
        levels = tuple(dataclasses.replace(lev, vals=v)
                       for lev, v in zip(self.levels, leaves[1:]))
        return dataclasses.replace(
            self, ell_vals=leaves[0], levels=levels,
            residue=chunked.level_values(self.residue, levels))

    # the tensors the kernels read are the leaves themselves (the chunked
    # format's differ: :meth:`ChunkedELLMatrix.buffers`)
    buffers = leaves
    with_buffers = with_leaves

    def live_slots(self):
        """``(rows, cols, index)`` (int64) of every stored slot that holds
        an edge (its column below ``n_cols``), ``index`` counting the
        concatenated flat :meth:`leaves`."""
        dev = self.device
        parts = [(torch.arange(self.ell_cols.shape[0], device=dev),
                  self.ell_cols, 0, self.n_cols)]
        parts += [(lev.rows, lev.cols, 0, self.n_cols) for lev in self.levels]
        return chunked._live(parts, dev)

    def astype(self, dtype) -> 'ELLMatrix':
        return self._map_vals(lambda v: v.to(dtype))

    def scale_vals(self, scale) -> 'ELLMatrix':
        return self._map_vals(lambda v: v * scale)

    def abs_vals(self) -> 'ELLMatrix':
        return self._map_vals(torch.abs)

    def __matmul__(self, x):
        return spmm(self, x)


def ell_spmm(mat: ELLMatrix, x, *, out_dtype=None) -> torch.Tensor:
    """``y = A @ x`` for the multi-level ELL format, x (n_cols,) or
    (n_cols, ...): one launch of the ELL SpMM kernel
    (:func:`~pygsp_tpu_torch.core.ell_kernel.ell_spmm`), which sums each
    row's level-0 slots and then its overflow slots and writes the row once.
    The kernel takes float32 or float64; other operands are computed in
    float32 and ``y`` cast to ``out_dtype`` (default the promotion of the
    two dtypes)."""
    x = torch.as_tensor(x)
    if x.ndim == 0 or x.shape[0] != mat.n_cols:
        raise ValueError(f'x must have {mat.n_cols} rows, got shape '
                         f'{tuple(x.shape)}')
    pdt = torch.promote_types(x.dtype, mat.dtype)
    kdt = pdt if pdt in (torch.float32, torch.float64) else torch.float32
    if mat.dtype != kdt:
        mat = mat.astype(kdt)
    x2 = x.to(kdt).reshape(mat.n_cols, -1).contiguous()
    y = ell_kernel.ell_spmm(mat.table, mat.ell_cols.reshape(-1),
                            mat.ell_vals.reshape(-1), mat.residue, x2,
                            mat.n_rows)
    return y.reshape((mat.n_rows,) + x.shape[1:]).to(out_dtype or pdt)


def to_ell(mat: CSRMatrix, width: int | None = None,
           row_block: int = ROW_BLOCK, level_factor: int = 2) -> ELLMatrix:
    """CSR → multi-level ELL on the matrix's device (the host packer)."""
    nnz = mat.nnz
    rows, cols, vals = (t[:nnz].cpu().numpy()
                        for t in (mat.rows, mat.cols, mat.vals))
    return ell_from_host_coo(rows, cols, vals, mat.n_rows, mat.n_cols,
                             width=width, level_factor=level_factor,
                             row_block=row_block, device=mat.device)


def ell_from_host_coo(rows, cols, vals, n_rows: int, n_cols: int, *,
                      width: int | None = None, level_factor: int = 2,
                      row_block: int = ROW_BLOCK,
                      device='cuda') -> ELLMatrix:
    """Build a multi-level ELL from host COO (row-sorted, deduplicated),
    with the JAX package's packer, so that the same input packs to the same
    arrays: level 0 ``width`` slots a row (by default the mean degree
    rounded up to 8), then levels of geometrically wider blocks (each
    ``level_factor`` times the last, rounded up to 8) for the rows still
    overflowing."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals)
    n = n_rows
    counts = (np.bincount(rows, minlength=n) if rows.size
              else np.zeros(n, np.int64))
    rowptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=rowptr[1:])
    deg = counts

    if width is None:
        if rows.size == 0 or n == 0:
            width = 8
        else:
            mean = max(1, int(np.ceil(rows.size / n)))
            width = max(_round_up(mean, 8), 8)

    n_pad = max(_round_up(n, row_block), row_block)

    def pack(row_subset, base, w):
        """Slot block [base, base+w) of each row: O(R*w) CSR-range
        gathers."""
        starts = rowptr[row_subset] + base
        ends = rowptr[row_subset + 1] if len(row_subset) < n else rowptr[1:]
        idx = starts[:, None] + np.arange(w)[None, :]
        valid = idx < ends[:, None]
        idx = np.minimum(idx, max(rows.size - 1, 0))
        pc = np.where(valid, cols[idx], n_cols).astype(np.int32)
        pv = np.where(valid, vals[idx], 0).astype(vals.dtype)
        return pc, pv

    all_rows = np.arange(n, dtype=np.int64)
    if rows.size:
        c0, v0 = pack(all_rows, 0, width)
    else:
        c0 = np.full((n, width), n_cols, np.int32)
        v0 = np.zeros((n, width), vals.dtype)
    ell_cols = np.full((n_pad, width), n_cols, dtype=np.int32)
    ell_vals = np.zeros((n_pad, width), dtype=vals.dtype)
    ell_cols[:n] = c0
    ell_vals[:n] = v0

    levels = []
    base = width
    w = max(_round_up(width, 8), 8)
    maxdeg = int(deg.max()) if n else 0
    while base < maxdeg:
        lrows = np.flatnonzero(deg > base)
        remaining_max = int((deg[lrows] - base).max())
        w = min(w, max(_round_up(remaining_max, 8), 8))
        lc, lv = pack(lrows, base, w)
        levels.append((lrows.astype(np.int32), lc, lv))
        base += w
        w = max(_round_up(w * level_factor, 8), 8)

    return _ell_upload(ell_cols, ell_vals, levels, rowptr.astype(np.int32),
                       n, n_cols, int(rows.size), width, device)


def _ell_upload(ell_cols, ell_vals, levels, rowptr, n_rows, n_cols, nnz,
                width, device) -> ELLMatrix:
    """The matrix on ``device`` from host arrays (``levels``: (rows, cols,
    vals) triples), with the kernel's slot table and residue list."""
    residue = chunked.upload_residue(
        [ChunkLevel(cols=c, vals=v, src_chunk=0) for _, c, v in levels],
        np.concatenate([r for r, _, _ in levels]) if levels
        else np.zeros(0, np.int64), n_rows, n_cols, max(n_cols, 1), device)
    return ELLMatrix(
        ell_cols=chunked._tensor(ell_cols, device, np.int32),
        ell_vals=chunked._tensor(ell_vals, device),
        levels=tuple(ELLLevel(rows=chunked._tensor(r, device, np.int32),
                              cols=chunked._tensor(c, device, np.int32),
                              vals=chunked._tensor(v, device))
                     for r, c, v in levels),
        rowptr=chunked._tensor(rowptr, device, np.int32),
        n_rows=int(n_rows), n_cols=int(n_cols), nnz=int(nnz),
        ell_width=int(width),
        table=ell_kernel.slot_table([(0, 0, width, 0, n_cols)], 1,
                                    max(n_rows, 1), device),
        residue=residue)


def ell_from_scipy(mat, *, dtype=None, width: int | None = None,
                   level_factor: int = 2, device='cuda') -> ELLMatrix:
    """scipy sparse → multi-level ELL on ``device`` (values in ``dtype``,
    by default the matrix's own)."""
    csr = mat.tocsr()
    csr.sum_duplicates()
    coo = csr.tocoo()
    vals = (coo.data if dtype is None
            else coo.data.astype(_numpy_dtype(_torch_dtype(dtype))))
    return ell_from_host_coo(coo.row, coo.col, vals, coo.shape[0],
                             coo.shape[1], width=width,
                             level_factor=level_factor, device=device)


def _ell_to_scipy(mat: ELLMatrix):
    co = mat.ell_cols.cpu().numpy()
    parts = [(np.repeat(np.arange(co.shape[0]), co.shape[1]), co.ravel(),
              chunked._host(mat.ell_vals).ravel())]
    for lev in mat.levels:
        lc = lev.cols.cpu().numpy()
        parts.append((np.repeat(lev.rows.cpu().numpy(), lc.shape[1]),
                      lc.ravel(), chunked._host(lev.vals).ravel()))
    rows, cols, vals = (np.concatenate([p[k] for p in parts])
                        for k in range(3))
    keep = (rows < mat.n_rows) & (cols < mat.n_cols)
    return sps.csr_matrix((vals[keep], (rows[keep], cols[keep])),
                          shape=mat.shape)


# ---------------------------------------------------------------------------
# Block-banded dense format (mesh-like graphs)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BandedMatrix:
    """Block-banded dense storage: 128-row tiles × (2·half_bw+1) col tiles.

    For graphs whose ordering confines every edge to a band of ``half_bw``
    128-wide tiles (meshes, grids), the SpMM becomes a batch of dense
    128×128 products.

    tiles: (nb, 2·half_bw+1, 128, 128); ``tiles[i, d]`` multiplies x block
    ``i + d - half_bw`` (out-of-range blocks are zero).
    """

    tiles: torch.Tensor
    n_rows: int
    n_cols: int
    nnz: int
    half_bw: int

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def dtype(self):
        return self.tiles.dtype

    @property
    def device(self):
        return self.tiles.device

    def leaves(self) -> tuple:
        """The float leaves of the JAX package's pytree: ``(tiles,)``."""
        return (self.tiles,)

    def with_leaves(self, leaves) -> 'BandedMatrix':
        return dataclasses.replace(self, tiles=leaves[0])

    # the tensors the kernels read are the leaves themselves (the chunked
    # format's differ: :meth:`ChunkedELLMatrix.buffers`)
    buffers = leaves
    with_buffers = with_leaves

    def astype(self, dtype) -> 'BandedMatrix':
        return dataclasses.replace(self, tiles=self.tiles.to(dtype))

    def scale_vals(self, scale) -> 'BandedMatrix':
        return dataclasses.replace(self, tiles=self.tiles * scale)

    @property
    def T(self) -> 'BandedMatrix':
        """The transpose, on the matrix's device: the same band, its tiles
        by :func:`transpose_tiles`."""
        return dataclasses.replace(
            self, tiles=transpose_tiles(self.tiles, self.half_bw),
            n_rows=self.n_cols, n_cols=self.n_rows)

    def __matmul__(self, x):
        return spmm(self, x)


def banded_spmm(mat: BandedMatrix, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` for the block-banded format (the banded SpMM kernel,
    :func:`spmm`)."""
    if not isinstance(mat, BandedMatrix):
        raise TypeError(f'banded_spmm takes a BandedMatrix, not '
                        f'{type(mat).__name__}')
    return spmm(mat, x)


def banded_from_scipy(mat, *, dtype=None, max_half_bw: int = 16,
                      device='cuda'):
    """scipy sparse (already in a banded vertex order) → BandedMatrix.

    Returns None if the matrix's block bandwidth exceeds ``max_half_bw``
    tiles (the dense band would waste too much memory and work).
    ``dtype`` defaults to float32.
    """
    coo = mat.tocoo()
    n = coo.shape[0]
    np_dtype = _numpy_dtype(_torch_dtype(dtype))
    if coo.nnz == 0:
        bw = 0
    else:
        bw = int(np.max(np.abs(coo.row.astype(np.int64) - coo.col)))
    b = -(-bw // BAND_TILE)  # ceil
    if b > max_half_bw:
        return None
    nb = max(-(-n // BAND_TILE), 1)
    tiles = np.zeros((nb, 2 * b + 1, BAND_TILE, BAND_TILE), dtype=np_dtype)
    ti = coo.row // BAND_TILE
    ri = coo.row % BAND_TILE
    tj = coo.col // BAND_TILE
    d = tj - ti + b
    cj = coo.col % BAND_TILE
    np.add.at(tiles, (ti, d, ri, cj), coo.data.astype(np_dtype))
    return BandedMatrix(tiles=torch.from_numpy(tiles).to(device), n_rows=n,
                        n_cols=n, nnz=int(coo.nnz), half_bw=b)
