"""What the port's redesigned kernels rest on, checked on the CPU.

- The shared-memory layout that ``windowed_fold``'s wrapper hands its
  kernel (accumulator, ring of x rows, live-slot queue) stays within what
  one block may ask for on an H100, for every (K·P, dtype, S) the port
  builds, and is refused where nothing fits.
- The 3×TF32 split of the float32 banded kernel: each float32 operand is
  ``big + small``, ``big`` rounded to TF32 (10 mantissa bits) as
  ``cvt.rna.tf32.f32`` rounds (nearest, ties away from zero) and ``small``
  the float32 remainder, which the TF32 multiply reads truncated to its top
  19 bits; the product is taken as ``small·big + big·small + big·big``.
  Emulated here in numpy, on the band tiles of small ``Grid2d`` Laplacians
  as the recurrence scales them, that product is within 1e-6 of the float64
  product, where a single TF32 pass, or a split without either cross term,
  misses by more than 1e-5 (the card tests' limit).
"""

import numpy as np
import pytest
import torch

import pygsp_tpu_torch as tgsp
from pygsp_tpu_torch.core import banded_kernel
from pygsp_tpu_torch.core import windowed_kernel as wk


# (K·P, S, itemsize, the S tile or None): every K·P the port builds ×
# f32/f64 × S, then the cases whose S tile is known
LAYOUT_CASES = [(kp, s, itemsize, None) for kp in (64, 128, 256, 512)
                for itemsize in (4, 8) for s in (1, 5, 128, 300)] + [
    (128, 128, 4, 128), (128, 128, 8, 128), (512, 128, 4, 64),
    (512, 128, 8, 32), (256, 5, 4, 32), (128, 300, 4, 128),
    (16384, 128, 8, 1)]


@pytest.mark.parametrize('kp,s,itemsize,tile', LAYOUT_CASES)
def test_fold_layout_fits_one_block(kp, s, itemsize, tile):
    lay = wk.fold_layout(kp, s, itemsize)
    assert 1 <= lay.s_tile <= 128
    assert tile is None or lay.s_tile == tile
    assert lay.s_tile <= max(32, s)          # no wider than S needs
    assert lay.ring >= wk.RING_GROUPS and lay.ring % wk.RING_GROUPS == 0
    # the queue outlasts the ring plus one staging round, and wraps by mask
    assert lay.queue >= lay.ring + wk.STAGE_ROUND
    assert lay.queue & (lay.queue - 1) == 0
    acc = kp * lay.s_tile * itemsize
    assert acc <= wk.ACC_BYTES
    assert lay.smem_bytes == (20 * wk.RING_GROUPS + acc
                              + lay.ring * lay.s_tile * itemsize
                              + lay.queue * (2 * itemsize + 4))
    assert lay.smem_bytes <= wk.SMEM_PER_BLOCK


def test_fold_layout_at_the_bench_path_fits_two_blocks_per_sm():
    """f32, K·P = 128, S = 128: a 64 KB accumulator, a 64-row ring and a
    256-slot queue; two blocks (and their 1 KB reserve each) share an SM."""
    lay = wk.fold_layout(128, 128, 4)
    assert lay == wk.FoldLayout(s_tile=128, ring=64, queue=256,
                                smem_bytes=101_536)
    assert 2 * (lay.smem_bytes + 1024) <= wk.SMEM_PER_SM


@pytest.mark.parametrize('kp,s,itemsize', [(1 << 16, 128, 4), (1 << 15, 1, 8),
                                           (wk.ACC_BYTES, 1, 8)])
def test_fold_layout_refuses_what_cannot_fit(kp, s, itemsize):
    with pytest.raises(ValueError, match='does not fit'):
        wk.fold_layout(kp, s, itemsize)


def _tf32_rna(a):
    """Round float32 values to TF32 as ``cvt.rna.tf32.f32`` does: to the
    nearest value with 10 explicit mantissa bits, ties away from zero (add
    half of the dropped unit to the magnitude, clear the low 13 bits)."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_trunc(a):
    """What a TF32 multiply reads of a float32 value: its top 19 bits."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    a = np.array([1.0, 1.0 + 2.0**-11, 1.0 + 2.0**-10 + 2.0**-11,
                  -(1.0 + 2.0**-11), 3.0e-3], dtype=np.float32)
    r = _tf32_rna(a)
    assert r[0] == 1.0
    assert r[1] == 1.0 + 2.0**-10                  # tie: away from zero
    assert r[2] == 1.0 + 2.0**-9
    assert r[3] == -(1.0 + 2.0**-10)
    assert abs(r[4] - a[4]) <= 2.0**-11 * abs(a[4])
    assert np.all(r.view(np.uint32) & np.uint32(0x1FFF) == 0)
    t = _tf32_trunc(a)
    assert t[1] == 1.0 and t[3] == -1.0            # toward zero
    assert np.all(np.abs(t) <= np.abs(a))


@pytest.mark.parametrize('lap_type', ['combinatorial', 'normalized'])
def test_three_tf32_products_hold_f32_accuracy(lap_type):
    """The banded kernel's f32 product on the band tiles of a Grid2d
    Laplacian, scaled by 2/λmax as the Chebyshev step scales it. Products
    and sums are taken in float64 here, so the error measured is the
    split's alone (the kernel's f32 accumulation adds f32 rounding)."""
    G = tgsp.graphs.Grid2d(20, 31, lap_type=lap_type, device='cpu')
    lmax = 7.93 if lap_type == 'combinatorial' else 1.97
    Lb = G.L.to_banded()
    tiles = (Lb.offdiag.tiles * (2.0 / lmax)).numpy().astype(np.float32)
    nb, n_diag = tiles.shape[:2]
    x = np.random.default_rng(0).normal(size=(G.N, 16)).astype(np.float32)
    xw = banded_kernel.band_windows(torch.from_numpy(x), nb,
                                    (n_diag - 1) // 2).numpy()

    def product(a, b):
        return np.einsum('ndab,ndbs->nas', a.astype(np.float64),
                         b.astype(np.float64))

    want = product(tiles, xw)
    a_big, x_big = _tf32_rna(tiles), _tf32_rna(xw)
    a_small = _tf32_trunc(tiles - a_big)
    x_small = _tf32_trunc(xw - x_big)
    three = (product(a_small, x_big) + product(a_big, x_small)
             + product(a_big, x_big))
    scale = np.abs(want).max()
    assert np.abs(three - want).max() <= 1e-6 * scale
    # the faults the card's 1e-5 limit must catch: one TF32 pass, or a
    # split that drops either cross term
    for fault in (product(a_big, x_big),
                  product(a_big, x_small) + product(a_big, x_big),
                  product(a_small, x_big) + product(a_big, x_big)):
        assert np.abs(fault - want).max() > 1e-5 * scale
