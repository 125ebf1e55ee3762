"""Graph linear operators: the Laplacian as ``diag + offdiag``.

Counterpart of :mod:`pygsp_tpu.core.operators`. The Laplacian is kept as a
diagonal vector plus an off-diagonal sparse matrix holding **negated**
(possibly degree-normalized) weights:

    L @ x = diag * x + offdiag @ x

so the SpMM kernel stays Laplacian-agnostic and the Chebyshev operator
``(2/a1)(L - a2 I)`` is one scale of the same two terms.

What the iterative drivers (``cheby_op``, Lanczos) need to know about a
format sits here, behind :meth:`LaplacianOp.hoisted`,
:meth:`LaplacianOp.shifted_step`.
"""

from __future__ import annotations

import dataclasses
import functools

import scipy.sparse as sps
import torch

from pygsp_tpu_torch.core import cheby_kernel
from pygsp_tpu_torch.core import sparse as sp
from pygsp_tpu_torch.core.chunked import (ChunkedELLMatrix,
                                          chunked_from_host_coo, permute_in,
                                          permute_out)
from pygsp_tpu_torch.core.sparse import CSRMatrix, ELLMatrix
from pygsp_tpu_torch.core.windowed import (WindowedELLMatrix,
                                           windowed_from_host_coo)

# The formats that store their vertices relabeled and emit their SpMM in the
# carry dtype: the recurrence scales their product inside the step.
SCALED_OUTPUT = (ChunkedELLMatrix, WindowedELLMatrix)


def _identity(x, axis=0):
    return x


@dataclasses.dataclass(frozen=True)
class LaplacianOp:
    """Sparse symmetric Laplacian ``L = diag(diag) + offdiag``.

    ``offdiag`` (a :class:`CSRMatrix`, :class:`ELLMatrix`,
    :class:`BandedMatrix`,
    :class:`~pygsp_tpu_torch.core.chunked.ChunkedELLMatrix` or
    :class:`~pygsp_tpu_torch.core.windowed.WindowedELLMatrix`) stores
    ``-w`` or ``-w/sqrt(dw_i dw_j)``, so one SpMM plus the diagonal term
    applies L exactly.
    """

    offdiag: CSRMatrix
    diag: torch.Tensor
    lap_type: str

    @property
    def n_vertices(self) -> int:
        return self.offdiag.n_rows

    @property
    def dtype(self):
        return self.offdiag.dtype

    @property
    def device(self):
        return self.diag.device

    def astype(self, dtype) -> 'LaplacianOp':
        return LaplacianOp(offdiag=self.offdiag.astype(dtype),
                           diag=self.diag.to(dtype), lap_type=self.lap_type)

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return matvec(self, x)

    def dot(self, x) -> torch.Tensor:
        """scipy-style alias; numpy input is moved to the operator's device."""
        return matvec(self, torch.as_tensor(x, device=self.device))

    def shifted(self, scale, shift) -> 'LaplacianOp':
        """Operator ``scale * (L - shift*I)`` with the shift fused into diag."""
        return LaplacianOp(
            offdiag=self.offdiag.scale_vals(scale),
            diag=(self.diag - shift) * scale,
            lap_type=self.lap_type,
        )

    def hoisted(self):
        """``(op, pin, pout)`` for an iterative driver: this operator in its
        off-diagonal's internal vertex order, the permute of a signal into
        that order, and ``pout(y, axis=0)`` out of it. A windowed
        off-diagonal stores its vertices relabeled, a chunked one when it
        was built with ``permute='degree'``; the driver permutes once in and
        once out instead of at every product. Without a relabeling ``op`` is
        this operator and both permutes are the identity."""
        off = self.offdiag
        if not isinstance(off, SCALED_OUTPUT) or off.perm is None:
            return self, _identity, _identity
        op = LaplacianOp(
            offdiag=dataclasses.replace(off, perm=None, iperm=None),
            diag=permute_in(off, self.diag), lap_type=self.lap_type)
        return (op, functools.partial(permute_in, off),
                functools.partial(permute_out, off))

    def shifted_step(self, scale, shift):
        """The Chebyshev recurrence step ``step(t, t_old, out=None)``:
        ``scale·(L − shift·I)·t − t_old`` for t (N, ...) in the carry dtype,
        on the fused step kernel
        (:func:`~pygsp_tpu_torch.core.cheby_kernel.cheby_step`), in the JAX
        package's arithmetic for each format. The CSR, ELL and banded
        formats fold the scale into a scaled copy of the off-diagonal
        (:meth:`shifted`) and step with ``sc = 1``; the chunked and
        windowed formats emit their SpMM in the carry dtype and apply the
        scale to it inside the step, with no scaled copy of their slots
        (the JAX package's ``_cheby_op_chunked``). The arithmetic is in the
        diagonal's dtype."""
        if not isinstance(self.offdiag, SCALED_OUTPUT):
            factor = self.shifted(scale, shift)
            one = torch.ones((), dtype=factor.diag.dtype, device=self.device)

            def step(t, t_old, out=None):
                return cheby_kernel.cheby_step(
                    sp.spmm(factor.offdiag, t), t, t_old, factor.diag, one,
                    out)

            return step
        fdiag = (self.diag - shift) * scale
        sc = torch.tensor(scale, dtype=fdiag.dtype, device=self.device)

        def step(t, t_old, out=None):
            return cheby_kernel.cheby_step(
                sp.spmm(self.offdiag, t, out_dtype=t.dtype), t, t_old, fdiag,
                sc, out)

        return step

    def _host_coo(self):
        """The off-diagonal's stored entries as host arrays (a CSR
        off-diagonal, the format every other one is converted from)."""
        off = self.offdiag
        return tuple(t[:off.nnz].cpu().numpy()
                     for t in (off.rows, off.cols, off.vals))

    def to_hybrid(self, width: int | None = None) -> 'LaplacianOp':
        """Convert the off-diagonal block to the multi-level ELL format
        (:class:`~pygsp_tpu_torch.core.sparse.ELLMatrix`, ``'hybrid'``):
        ``width`` level-0 slots a row (default the mean degree rounded up
        to 8), the rest in levels of unique rows."""
        if isinstance(self.offdiag, ELLMatrix):
            return self
        return LaplacianOp(offdiag=sp.to_ell(self.offdiag, width=width),
                           diag=self.diag, lap_type=self.lap_type)

    def to_chunked(self, chunk_rows: int | None = None,
                   permute: str | None = None) -> 'LaplacianOp':
        """Convert the off-diagonal block to the chunked multi-level ELL
        format (:mod:`pygsp_tpu_torch.core.chunked`); ``permute='degree'``
        relabels the vertices by descending degree inside the format, and
        the operator keeps the original order."""
        if isinstance(self.offdiag, ChunkedELLMatrix):
            return self
        off = self.offdiag
        kw = {} if chunk_rows is None else {'chunk_rows': chunk_rows}
        return LaplacianOp(
            offdiag=chunked_from_host_coo(
                *self._host_coo(), off.n_rows, off.n_cols, permute=permute,
                device=self.device, **kw),
            diag=self.diag, lap_type=self.lap_type)

    def to_windowed(self, chunk_rows: int | None = None,
                    window_rows: int | None = None,
                    slab_width: int | None = None) -> 'LaplacianOp':
        """Convert the off-diagonal block to the windowed-compact format
        (:mod:`pygsp_tpu_torch.core.windowed`): exact-packed slots folded to
        rows per output window, the JAX package's large-graph default. The
        builder's defaults pick the chunk and slab sizes and shuffle the
        vertex order; the operator keeps the original order."""
        if isinstance(self.offdiag, WindowedELLMatrix):
            return self
        off = self.offdiag
        rows, cols, vals = self._host_coo()
        kw = {}
        if chunk_rows is not None:
            kw['chunk_rows'] = chunk_rows
        if window_rows is not None:
            kw['window_rows'] = window_rows
        return LaplacianOp(
            offdiag=windowed_from_host_coo(
                rows, cols, vals, off.n_rows, off.n_cols,
                slab_width=slab_width, device=self.device, **kw),
            diag=self.diag, lap_type=self.lap_type)

    def to_banded(self, max_half_bw: int = 16) -> 'LaplacianOp | None':
        """Convert the off-diagonal block to the block-banded format; None
        if the band is wider than ``max_half_bw`` 128-tiles. The caller must
        already hold the vertices in a banded order."""
        banded = sp.banded_from_scipy(
            sp.to_scipy(self.offdiag), dtype=self.offdiag.dtype,
            max_half_bw=max_half_bw, device=self.device)
        if banded is None:
            return None
        return LaplacianOp(offdiag=banded, diag=self.diag,
                           lap_type=self.lap_type)

    def to_dense(self) -> torch.Tensor:
        return sp.to_dense(self.offdiag) + torch.diag(self.diag)

    def to_scipy(self):
        return sp.to_scipy(self.offdiag) + sps.diags(self.diag.cpu().numpy())


def matvec(op: LaplacianOp, x: torch.Tensor) -> torch.Tensor:
    """``L @ x``: one SpMM plus the diagonal term."""
    diag = op.diag.reshape((-1,) + (1,) * (x.ndim - 1))
    return diag * x + sp.spmm(op.offdiag, x)


def degrees_from_adjacency(W: CSRMatrix):
    """(unweighted degree d, weighted degree dw) of a CSR adjacency."""
    nnz = W.nnz
    rows = W.rows[:nnz].long()
    d = torch.zeros(W.n_rows, dtype=W.dtype, device=W.device).index_add_(
        0, rows, torch.ones_like(W.vals[:nnz]))
    dw = torch.zeros(W.n_rows, dtype=W.dtype, device=W.device).index_add_(
        0, rows, W.vals[:nnz])
    return d, dw


def laplacian_op(W: CSRMatrix, lap_type: str = 'combinatorial') -> LaplacianOp:
    """Build the Laplacian operator from a symmetric adjacency ``W``.

    - combinatorial: ``L = D - W`` → diag = dw, offdiag = -W.
    - normalized: ``L = I - D^-1/2 W D^-1/2`` with rows/cols of isolated
      vertices zeroed (their diagonal is 0, not 1).
    Directed graphs must be symmetrized (average) before calling this.
    """
    _, dw = degrees_from_adjacency(W)
    if lap_type == 'combinatorial':
        return LaplacianOp(offdiag=W.with_vals(-W.vals), diag=dw,
                           lap_type=lap_type)
    if lap_type == 'normalized':
        connected = dw > 0
        dinv_sqrt = torch.where(connected, dw, torch.ones_like(dw)) ** -0.5
        dinv_sqrt = torch.where(connected, dinv_sqrt, torch.zeros_like(dw))
        # padding entries (index n) clamp to n - 1; their value is 0 anyway
        scale = (dinv_sqrt[W.rows.long().clamp(max=W.n_rows - 1)]
                 * dinv_sqrt[W.cols.long().clamp(max=W.n_cols - 1)])
        diag = connected.to(W.dtype)
        return LaplacianOp(offdiag=W.with_vals(-W.vals * scale), diag=diag,
                           lap_type=lap_type)
    raise ValueError(f'Unknown Laplacian type {lap_type!r}')
