"""Sparse matrices as small dataclasses of tensors: padded CSR and block-banded.

Counterpart of :mod:`pygsp_tpu.core.sparse`, with the same field names so
that operators carry across (:mod:`pygsp_tpu_torch.convert`). Edges are
row-sorted COO triplets padded to a block multiple, beside a CSR row
pointer. Padding entries carry ``rows == n_rows``, ``cols == n_cols`` and
``val == 0``; the SpMM reads only the ``rowptr`` ranges, so it never touches
them.

The builders run on the host (NumPy in, tensors on ``device`` out). Entry
points default to ``device='cuda'``; the CPU is used only when asked for.
The windowed-compact format lives in :mod:`.windowed`; :func:`spmm`,
:func:`to_scipy` and :func:`to_dense` dispatch to it too.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sps
import torch

from pygsp_tpu_torch.core import banded_kernel, csr_kernel, windowed
# Rows and columns of one dense tile of the block-banded format.
from pygsp_tpu_torch.core.banded_kernel import BAND_TILE
from pygsp_tpu_torch.core.windowed import WindowedELLMatrix

# Edge arrays are padded to a multiple of this (the JAX package's layout).
EDGE_BLOCK = 1024

_NOT_PORTED = ('{} storage is not ported yet: see ROADMAP.md, "Modules to '
               'port", item 4 (the ELL/hybrid and chunked formats)')


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
        order = torch.argsort(self.cols, stable=True)
        real = self.rows < self.n_rows
        counts = torch.bincount(
            torch.where(real, self.cols, self.n_cols).long(),
            minlength=self.n_cols + 1)[:self.n_cols]
        rowptr = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
        return CSRMatrix(rows=self.cols[order], cols=self.rows[order],
                         vals=self.vals[order],
                         rowptr=rowptr.to(torch.int32),
                         n_rows=self.n_cols, n_cols=self.n_rows,
                         nnz=self.nnz)


# ---------------------------------------------------------------------------
# Builders (host-side; NumPy in, tensors out)
# ---------------------------------------------------------------------------

def from_coo(rows, cols, vals, n_rows: int, n_cols: int | None = None,
             *, dtype=None, device='cuda') -> CSRMatrix:
    """Build a padded CSRMatrix from host COO triplets.

    Explicit zeros are dropped, duplicates summed, and the triplets sorted
    by row then column. ``dtype`` defaults to float32.
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

    if rows.size:
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

    return _pad_and_build(rows, cols, vals, n_rows, n_cols, device)


def _pad_and_build(rows, cols, vals, n_rows, n_cols, device) -> CSRMatrix:
    nnz = int(rows.size)
    e_pad = max(_round_up(nnz, EDGE_BLOCK), EDGE_BLOCK)
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


def from_scipy(mat, *, dtype=None, device='cuda') -> CSRMatrix:
    """Build from any scipy.sparse matrix."""
    coo = mat.tocoo()
    return from_coo(coo.row, coo.col, coo.data, coo.shape[0], coo.shape[1],
                    dtype=dtype, device=device)


def from_dense(arr, *, dtype=None, device='cuda') -> CSRMatrix:
    arr = np.asarray(arr)
    rows, cols = np.nonzero(arr)
    return from_coo(rows, cols, arr[rows, cols], arr.shape[0], arr.shape[1],
                    dtype=dtype, device=device)


def to_scipy(mat):
    """Export a CSR, banded or windowed matrix back to scipy CSR (padding
    dropped, original vertex order)."""
    if isinstance(mat, BandedMatrix):
        return _banded_to_scipy(mat)
    if isinstance(mat, WindowedELLMatrix):
        return windowed.windowed_to_scipy(mat)
    if not isinstance(mat, CSRMatrix):
        raise NotImplementedError(_NOT_PORTED.format(type(mat).__name__))
    nnz = mat.nnz
    rows = mat.rows[:nnz].cpu().numpy()
    cols = mat.cols[:nnz].cpu().numpy()
    vals = mat.vals[:nnz].cpu().numpy()
    return sps.csr_matrix((vals, (rows, cols)), shape=mat.shape)


def _banded_to_scipy(mat: 'BandedMatrix'):
    tiles = mat.tiles.cpu().numpy()        # (nb, 2*half_bw+1, 128, 128)
    nb, ndiag, tr, tc = tiles.shape
    dense = np.zeros((nb * tr, nb * tc), tiles.dtype)
    for i in range(nb):
        for d in range(ndiag):
            j = i + d - mat.half_bw
            if 0 <= j < nb:
                dense[i * tr:(i + 1) * tr, j * tc:(j + 1) * tc] = tiles[i, d]
    return sps.csr_matrix(dense[:mat.n_rows, :mat.n_cols])


def to_dense(mat) -> torch.Tensor:
    """Densify on the matrix's device (small matrices only)."""
    if isinstance(mat, (BandedMatrix, WindowedELLMatrix)):
        return torch.from_numpy(to_scipy(mat).toarray()).to(mat.device)
    if not isinstance(mat, CSRMatrix):
        raise NotImplementedError(_NOT_PORTED.format(type(mat).__name__))
    out = torch.zeros(mat.shape, dtype=mat.dtype, device=mat.device)
    nnz = mat.nnz
    out.index_put_((mat.rows[:nnz].long(), mat.cols[:nnz].long()),
                   mat.vals[:nnz], accumulate=True)
    return out


# ---------------------------------------------------------------------------
# SpMM dispatch
# ---------------------------------------------------------------------------

def spmm(mat, x: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """``y = A @ x`` for x of shape (n_cols,) or (n_cols, ...).

    CSR goes to the CSR SpMM kernel, banded to the banded SpMM kernel,
    windowed to the windowed fold and strip kernels. Each wrapper launches
    its CUDA kernel for a CUDA tensor and runs its plain PyTorch version for
    a CPU tensor. Operands of mixed dtypes are promoted, as in the JAX
    package. ``out_dtype``: the dtype of ``y`` (the windowed format's bf16
    modes emit the product narrow; the others cast it).
    """
    if isinstance(mat, WindowedELLMatrix):
        return windowed.windowed_spmm(mat, x, out_dtype=out_dtype)
    if not isinstance(mat, (CSRMatrix, BandedMatrix)):
        raise NotImplementedError(_NOT_PORTED.format(type(mat).__name__))
    x = torch.as_tensor(x)
    if x.ndim == 0 or x.shape[0] != mat.n_cols:
        raise ValueError(f'x must have {mat.n_cols} rows, got shape '
                         f'{tuple(x.shape)}')
    dtype = torch.promote_types(x.dtype, mat.dtype)
    lead = x.shape[1:]
    x2 = x.to(dtype).reshape(mat.n_cols, -1).contiguous()
    if isinstance(mat, CSRMatrix):
        y = csr_kernel.csr_spmm(mat.rowptr, mat.cols, mat.vals.to(dtype), x2)
    else:
        y = banded_kernel.banded_spmm(mat.tiles.to(dtype), x2, mat.n_rows)
    return y.reshape((mat.n_rows,) + lead).to(out_dtype or dtype)


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

    def astype(self, dtype) -> 'BandedMatrix':
        return dataclasses.replace(self, tiles=self.tiles.to(dtype))

    def scale_vals(self, scale) -> 'BandedMatrix':
        return dataclasses.replace(self, tiles=self.tiles * scale)

    def __matmul__(self, x):
        return spmm(self, x)


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
