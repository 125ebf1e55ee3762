"""The one-hot fold and the windowed SpMM's kernels, in their plain
versions, against the JAX package's Pallas kernels and XLA code, on the CPU.

TPU kernel #2 (``benchmarks/pallas_fold_probe.py:make_pallas_fold``) runs
here in Pallas interpret mode, as its probe allows
(``PYGSP_PALLAS_INTERPRET=1``). TPU kernel #3 (``fold_kernel`` of
``benchmarks/pallas_smoke.py``) is nested in that script's ``main()`` and
cannot be imported, so the fold at NW = 1 is held against the script's
own reference, ``np.add.at`` (``pallas_smoke.py:59-60``). The CUDA
kernels themselves are held against these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import dataclasses
import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygsp_tpu.core import windowed as jwd
from pygsp_tpu_torch.core import _cuda, windowed_kernel as wk
from pygsp_tpu_torch.core import windowed as twd

from test_chunked import _random_powerlaw

BENCHMARKS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'benchmarks')
# float32 sums of the same products in another order
TOL_FOLD = 1e-6


def _bf16_products(rng, shape):
    """The same bf16 products for both packages: bf16-exact float32."""
    p = np.asarray(jnp.asarray(rng.normal(size=shape), dtype=jnp.bfloat16))
    return p.astype(np.float32)


def _rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture
def pallas_fold(monkeypatch):
    """``make_pallas_fold`` in Pallas interpret mode."""
    monkeypatch.setenv('PYGSP_PALLAS_INTERPRET', '1')
    monkeypatch.syspath_prepend(BENCHMARKS)
    return importlib.import_module('pallas_fold_probe').make_pallas_fold


@pytest.mark.parametrize('groups', [1, 8])
@pytest.mark.parametrize('dead_ids', [False, True])
def test_fold_products_matches_the_pallas_kernel(pallas_fold, groups,
                                                 dead_ids):
    """#2 at a small shape: NW=8, Lt=64, KP=32, S=128 (the probe's S), bf16
    products, f32 accumulation. Row ids outside [0, KP) match no one-hot
    row in the Pallas kernel and must add nothing here either."""
    nw, lt, kp = 8, 64, 32
    rng = np.random.default_rng(groups)
    rid = rng.integers(0, kp, size=(nw, lt)).astype(np.int32)
    if dead_ids:
        rid[:, ::7] = kp
        rid[:, 3::11] = -1
    p = _bf16_products(rng, (nw, lt, 128))
    want = np.asarray(pallas_fold(nw, lt, kp, G=groups)(
        jnp.asarray(rid), jnp.asarray(p, dtype=jnp.bfloat16)))
    got = wk.fold_products(torch.from_numpy(rid),
                           torch.from_numpy(p).to(torch.bfloat16), kp)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel_err(got.numpy(), want) <= TOL_FOLD


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_fold_at_one_window_matches_pallas_smoke_reference(dtype):
    """#3's shape: rid (512, 1), p (512, 128), KP=256, the reference of
    benchmarks/pallas_smoke.py:59-60."""
    lt, kp, s = 512, 256, 128
    rng = np.random.default_rng(0)
    rid = rng.integers(0, kp, size=(lt, 1)).astype(np.int32)
    p = _bf16_products(rng, (lt, s))
    ref = np.zeros((kp, s), np.float32)
    np.add.at(ref, rid[:, 0], p)
    got = wk.fold_products(torch.from_numpy(rid.T.copy()),
                           torch.from_numpy(p[None]).to(dtype), kp)
    assert got.shape == (1, kp, s)
    assert _rel_err(got[0].numpy(), ref) <= TOL_FOLD


def _no_levels(J):
    return dataclasses.replace(J, levels=(), level_rows=jnp.zeros(0,
                                                                  jnp.int32))


@pytest.mark.parametrize('kw', [
    dict(chunk_rows=64, window_rows=16),
    dict(chunk_rows=128, window_rows=32, slab_width=4, borrow_span=4),
    dict(chunk_rows=512, window_rows=256),
], ids=['P16', 'span4', 'P256'])
def test_fold_and_strip_match_jax_without_levels(kw):
    """The plain (a) windowed_fold + (b) window_strip against the JAX
    package's gather, one-hot einsum and overlap-add (its SpMM with the
    residue tiers taken out), in f64 and in the internal order."""
    W = _random_powerlaw(333, np.random.default_rng(23))
    J = jwd.windowed_from_scipy(W, **kw)
    T = twd.windowed_from_scipy(W, device='cpu', **kw)
    x = np.random.default_rng(1).normal(size=(333, 5))
    want = jwd.unchunk_signal(_no_levels(J).spmm_chunks(
        jwd.chunk_signal(jnp.asarray(x), J.chunk_rows)))
    kp = T.borrow_span * T.window_rows
    t = wk.windowed_fold(T.cols, T.vals, T.rowid, torch.from_numpy(x),
                         T.chunk_rows, kp)
    assert t.shape == T.cols.shape[:2] + (kp, 5)
    got = wk.window_strip(t, 333, T.window_rows)
    assert np.allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)


def test_fold_and_strip_match_fold_products_and_jax_overlap_add():
    """(a) + (b) in f32 against the fold of the same products made
    explicitly (fold_products, #2's function) and the JAX package's
    overlap-add (pygsp_tpu/core/windowed.py:338-344, concatenate with
    zeros), on a span-4 matrix."""
    W = _random_powerlaw(400, np.random.default_rng(7), avg_deg=10)
    T = twd.windowed_from_scipy(W, chunk_rows=128, window_rows=32,
                                slab_width=6, borrow_span=4, device='cpu',
                                dtype=np.float32)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(400, 3)).astype(np.float32))
    n_out, nw, n_src, L = T.cols.shape
    R, P, K = T.chunk_rows, T.window_rows, T.borrow_span
    got = wk.window_strip(wk.windowed_fold(T.cols, T.vals, T.rowid, x, R,
                                           K * P), 400, P)
    ys = []
    for i in range(n_out):
        row = (torch.arange(n_src) * R)[:, None] + T.cols[i].long()
        live = (T.cols[i] < R)[..., None]
        p = torch.where(live, T.vals[i][..., None] * x[row.clamp(max=399)],
                        torch.zeros(()))
        t = jnp.asarray(wk.fold_products(
            T.rowid[i].reshape(nw, n_src * L).int(),
            p.reshape(nw, n_src * L, 3), K * P).numpy())
        y = t[:, :P, :].reshape(nw * P, 3)
        for d in range(1, K):
            a = t[:, d * P:(d + 1) * P, :].reshape(nw * P, 3)
            y = y + jnp.concatenate([jnp.zeros((d * P, 3)), a[:-d * P]])
        ys.append(y)
    want = np.asarray(jnp.concatenate(ys))[:400]
    assert _rel_err(got.numpy(), want) <= TOL_FOLD


def test_wrappers_validate_arguments():
    W = _random_powerlaw(100, np.random.default_rng(1))
    T = twd.windowed_from_scipy(W, chunk_rows=64, window_rows=16,
                                device='cpu')
    x = torch.zeros(100, 2, dtype=torch.float64)
    args = (T.cols, T.vals, T.rowid)
    with pytest.raises(ValueError, match='one dtype'):
        wk.windowed_fold(*args, x.float(), 64, 32)
    with pytest.raises(ValueError, match='int32 cols'):
        wk.windowed_fold(T.cols.long(), T.vals, T.rowid, x, 64, 32)
    with pytest.raises(ValueError, match='do not cover'):
        wk.windowed_fold(*args, torch.zeros(300, 2, dtype=torch.float64),
                         64, 32)
    with pytest.raises(ValueError, match='contiguous'):
        wk.windowed_fold(*args, torch.zeros(2, 100, dtype=torch.float64).T,
                         64, 32)
    with pytest.raises(ValueError, match='runs on cuda or cpu'):
        wk.windowed_fold(*(a.to('meta') for a in args), x.to('meta'), 64, 32)
    t = torch.zeros(2, 4, 32, 2, dtype=torch.float64)
    with pytest.raises(ValueError, match='does not hold'):
        wk.window_strip(t, 200, 16)
    with pytest.raises(ValueError, match='4-D'):
        wk.window_strip(t.half(), 100, 16)
    rid = torch.zeros(2, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match='bfloat16 or float32'):
        wk.fold_products(rid, torch.zeros(2, 8, 4, dtype=torch.float64), 4)
    with pytest.raises(ValueError, match=r'rid \(NW, Lt\)'):
        wk.fold_products(rid, torch.zeros(2, 9, 4), 4)
    with pytest.raises(ValueError, match='float32'):
        wk.double(torch.zeros(3, dtype=torch.float64))


def test_double_is_twice_its_input():
    x = torch.arange(8 * 128, dtype=torch.float32).reshape(8, 128)
    assert torch.equal(wk.double(x), x * 2.0)


def test_kernel_source_names_what_it_replaces():
    with open(os.path.join(_cuda.CSRC, 'windowed_fold.cu')) as f:
        text = f.read()
    assert 'Replaces:' in text and 'pallas_fold_probe.py' in text
    assert 'pallas_smoke.py' in text
    for symbol in ('windowed_fold_f32_u8', 'windowed_fold_f32_i32',
                   'windowed_fold_f64_u8', 'windowed_fold_f64_i32',
                   'window_strip_f32', 'window_strip_f64',
                   'fold_products_bf16', 'fold_products_f32', 'double_f32'):
        assert f'extern "C" int {symbol}(' in text or f'({symbol},' in text
