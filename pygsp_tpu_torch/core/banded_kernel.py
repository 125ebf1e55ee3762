"""Block-banded SpMM, the port of ``pygsp_tpu/ops/pallas_banded.py``.

``y[i·128+a, :] = Σ_{d=0}^{2b} Σ_c tiles[i, d, a, c] · x[(i+d−b)·128+c, :]``,
with blocks ``i+d−b`` outside the matrix skipped. The CUDA kernels
(``csrc/banded_spmm.cu``: float32 on the tensor cores, three TF32 products
per product; float64 in FFMA) need neither the padding of S to 128 nor the
zero-padded copy of x that the Pallas kernel makes: they mask the ragged
edges themselves. :func:`banded_spmm` launches it for CUDA tensors and runs
:func:`banded_spmm_plain` (the einsum twin of
``pygsp_tpu/core/sparse.py:banded_spmm``) for CPU tensors.
"""

from __future__ import annotations

import torch

from pygsp_tpu_torch.core import _cuda

# Rows and columns of one dense tile, fixed in the CUDA kernel.
BAND_TILE = 128

_SYMBOLS = {torch.float32: 'banded_spmm_f32',
            torch.float64: 'banded_spmm_f64'}


def band_windows(x, nb: int, half_bw: int):
    """x (n, S) -> windows (nb, 2·half_bw+1, 128, S), window ``[i, d]``
    being x block ``i + d - half_bw`` (zero outside the matrix)."""
    n, s = x.shape
    xp = torch.zeros(((nb + 2 * half_bw) * BAND_TILE, s), dtype=x.dtype,
                     device=x.device)
    xp[half_bw * BAND_TILE:half_bw * BAND_TILE + n] = x
    xp = xp.reshape(nb + 2 * half_bw, BAND_TILE, s)
    return torch.stack([xp[d:d + nb] for d in range(2 * half_bw + 1)], dim=1)


def banded_spmm_plain(tiles, x, n_rows: int):
    """Plain PyTorch version: one einsum over the gathered band windows."""
    nb, n_diag = tiles.shape[:2]
    xw = band_windows(x, nb, (n_diag - 1) // 2)
    yb = torch.einsum('ndab,ndbs->nas', tiles, xw)
    return yb.reshape(nb * BAND_TILE, x.shape[1])[:n_rows]


def _check(tiles, x, n_rows):
    if x.ndim != 2:
        raise ValueError(f'x must be 2-D (n_cols, S), got {tuple(x.shape)}')
    if x.dtype not in _SYMBOLS or tiles.dtype != x.dtype:
        raise ValueError(f'banded_spmm takes float32 or float64 tiles and x '
                         f'of one dtype, got {tiles.dtype} and {x.dtype}')
    if (tiles.ndim != 4 or tiles.shape[1] % 2 != 1
            or tiles.shape[2:] != (BAND_TILE, BAND_TILE)):
        raise ValueError(f'tiles must be (nb, 2b+1, {BAND_TILE}, '
                         f'{BAND_TILE}), got {tuple(tiles.shape)}')
    nb = tiles.shape[0]
    if x.shape[0] > nb * BAND_TILE or not 0 <= n_rows <= nb * BAND_TILE:
        raise ValueError(f'{nb} tile rows hold at most {nb * BAND_TILE} '
                         f'rows, got x {tuple(x.shape)} and n_rows {n_rows}')
    for t in (tiles, x):
        if t.device != x.device:
            raise ValueError('all operands must be on one device')
        if not t.is_contiguous():
            raise ValueError('all operands must be contiguous')


def banded_spmm(tiles, x, n_rows: int):
    """``y = A @ x`` for a block-banded ``A`` given by its tiles
    (nb, 2b+1, 128, 128) and x (n_cols, S). Returns (n_rows, S)."""
    _check(tiles, x, n_rows)
    if x.device.type == 'cpu':
        return banded_spmm_plain(tiles, x, n_rows)
    if x.device.type != 'cuda':
        raise ValueError(f'banded_spmm runs on cuda or cpu, not {x.device}')
    _cuda.refuse_autograd('banded_spmm', tiles, x)
    nb, n_diag = tiles.shape[:2]
    s = x.shape[1]
    y = torch.empty((n_rows, s), dtype=x.dtype, device=x.device)
    if n_rows == 0 or s == 0:
        return y
    _cuda.launch('banded_spmm', _SYMBOLS[x.dtype], 3, 5, x.get_device(),
                 tiles.data_ptr(), x.data_ptr(), y.data_ptr(), nb,
                 (n_diag - 1) // 2, n_rows, x.shape[0], s)
    banded_spmm.launches += 1
    return y


banded_spmm.launches = 0
