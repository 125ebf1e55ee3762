"""SpMM dispatch, the primitive the Chebyshev recurrence reduces to.

Five storage formats, dispatched by operand type in
:func:`pygsp_tpu_torch.core.sparse.spmm`; any other operand raises
``TypeError``:

- :class:`~pygsp_tpu_torch.core.sparse.CSRMatrix` → the CSR SpMM kernel
  (:mod:`pygsp_tpu_torch.core.csr_kernel`);
- :class:`~pygsp_tpu_torch.core.sparse.ELLMatrix` → the ELL SpMM kernel
  (:mod:`pygsp_tpu_torch.core.ell_kernel`);
- :class:`~pygsp_tpu_torch.core.sparse.BandedMatrix` → the banded SpMM
  kernel (:mod:`pygsp_tpu_torch.core.banded_kernel`);
- :class:`~pygsp_tpu_torch.core.chunked.ChunkedELLMatrix` → the chunked
  SpMM kernel (:mod:`pygsp_tpu_torch.core.ell_kernel`);
- :class:`~pygsp_tpu_torch.core.windowed.WindowedELLMatrix` → the windowed
  fold and strip kernels (:mod:`pygsp_tpu_torch.core.windowed_kernel`).
"""

from __future__ import annotations

import torch

from pygsp_tpu_torch.core import sparse as sp


def spmm(mat, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` with x of shape (n_cols,) or (n_cols, ...)."""
    return sp.spmm(mat, x)
