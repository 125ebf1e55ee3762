"""Smoke run of the PyTorch/CUDA port (``pygsp_tpu_torch``) on one GPU.

Phases, each of which raises on failure:

1. build the CUDA kernels from ``pygsp_tpu_torch/csrc`` (one nvcc each, in
   parallel, printing registers and spills) into ``pygsp_tpu_torch/_build``,
   then launch ``double`` (TPU kernel #4, the toolchain canary) against
   ``x * 2``, its call time beside its device time (torch.profiler);
2. hold each kernel against its plain PyTorch version on the card, in f32
   (and once in f64): CSR (also a star row of 20,000 edges across many of
   the kernel's segments), banded (f32 on the tensor cores, 3×TF32, also
   on Grid2d tiles that TF32 does not hold exactly), the
   windowed fold and strip (including ``window_rows=256`` and a span-4
   matrix), and the one-hot fold at TPU kernel #3's shape (call and device
   time), and with dead slots holding ``inf``, which must add nothing;
3. path A, the README path at the bench size: Barabási–Albert N=2^20
   (m0 = m = 8, about 16.8M stored edges) → ``Graph`` → ``estimate_lmax`` →
   ``Heat(scale=[5, 10, 25, 50]).filter(x, order=30)`` with x (N, 128) f32,
   through the CSR SpMM kernel, checked against the SciPy f64 recurrence;
   the kernel's two launches bit-equal at this shape, and its time with the
   hub rows (above 1024 edges) emptied and on those rows alone;
4. path B, the banded path: ``Grid2d(512, 512)`` → ``L.to_banded()`` →
   ``cheby_op`` through the banded SpMM kernel, checked against the CSR
   path and the SciPy f64 recurrence;
5. path C, the bench path of the JAX package (``bench.py:162-185``): the
   same graph as path A with ``compute_laplacian(fmt='windowed')``, λmax
   and the heat bank through the windowed fold and strip kernels, checked
   against the SciPy f64 recurrence; the fold's two launches bit-equal at
   this shape; ``torch.nn.functional.fold`` as the strip's yardstick; then
   the one-hot fold at TPU kernel #2's probe shape, with row ids from this
   matrix;
6. one JSON line of per-kernel numbers (times from CUDA events, bounds
   from the H100 SXM data sheet: HBM, FP32, and TF32 for the banded
   kernel's f32 products), the card's name and power limit, and the final
   ``{"ok": true, ...}`` line.

Run: ``python3 chip_smoke.py``. It needs one CUDA device and exits
non-zero without one.
"""

import json
import subprocess
import sys
import time

import numpy as np
import scipy.sparse as sps
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import pygsp_tpu_torch as gsp
from pygsp_tpu_torch.core import _cuda, banded_kernel, csr_kernel
from pygsp_tpu_torch.core import chunked
from pygsp_tpu_torch.core import windowed as wd
from pygsp_tpu_torch.core import windowed_kernel as wk
from pygsp_tpu_torch.ops.chebyshev import cheby_coeff, cheby_op

# H100 SXM data sheet: HBM rate, FP32 rate outside the tensor cores, and
# the dense TF32 and bf16 tensor-core rates.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
TF32_PRODUCTS = 3       # the banded f32 kernel's TF32 products per product

N_BA = 1 << 20          # bench.py:53-58
M_ATTACH = 8
GRID_SIDE = 512         # 262,144 vertices, half bandwidth 4 tiles
HUB_DEGREE = 1024       # path A's hub rows: more edges than this
ORDER = 30
N_SIGNALS = 128
SCALES = [5.0, 10.0, 25.0, 50.0]
N_CHECK_COLS = 8

# Tolerances (relative to the largest reference magnitude): f32 sums in
# another order than the plain version; the recurrence is held against f64.
TOL_CSR = 1e-5
# the banded f32 kernel's three TF32 products err near 5e-7; one TF32 pass,
# or a split that drops either cross term, misses by 3.7e-5 or more on
# these inputs (tests/test_torch_kernel_budget.py emulates each)
TOL_BANDED = 1e-5
TOL_WINDOWED = 1e-5
TOL_FOLD = 1e-6         # f32 sums of bf16 products, another order
TOL_PATH = 1e-4
TOL_F64 = 1e-12

# TPU kernel #2's probe shape (PALLAS_FOLD_r5.json, p=4) and #3's shape
FOLD2_NW, FOLD2_LT, FOLD2_KP = 1024, 1152, 256
FOLD3_LT, FOLD3_KP = 512, 256

KERNELS = (csr_kernel.csr_spmm, banded_kernel.banded_spmm) + wk.KERNELS


def log(*args):
    print(*args, flush=True)


def reset_counts():
    for k in KERNELS:
        k.launches = 0


def counts():
    """Every kernel's launch count, by name."""
    return {k.__name__: k.launches for k in KERNELS}


def run_bank(bank):
    """One bank, with every kernel's launches on the path so far and in
    the bank alone, both read just after it: ``(out, launches,
    per_bank)``."""
    before = counts()
    out = bank()
    torch.cuda.synchronize()
    launches = counts()
    return out, launches, {k: launches[k] - before[k] for k in launches}


def time_ms(fn, iters):
    """Mean ms per call over ``iters`` calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters):
    """Device time of one launch of ``fn``, which launches one kernel per
    call: the mean time on the card of the kernels that torch.profiler
    records over ``iters`` calls (after one warm-up call). The mean is
    taken over the kernels recorded, so a record the profiler drops does
    not count as a launch that took no time."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = [ev.time_range.end - ev.time_range.start for ev in prof.events()
          if ev.device_type == DeviceType.CUDA]
    if not us or sum(us) <= 0:
        raise AssertionError('torch.profiler saw no device time')
    return sum(us) / len(us) / 1e3


def check(name, got, want, tol):
    """Relative error max|got - want| / max|want|; raises above ``tol``."""
    torch.cuda.synchronize()
    got = torch.as_tensor(got)
    want = torch.as_tensor(want).to(got.device, got.dtype)
    if got.shape != want.shape:
        raise AssertionError(f'{name}: shape {tuple(got.shape)} != '
                             f'{tuple(want.shape)}')
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f'{name}: non-finite values')
    err = float((got - want).abs().max() / want.abs().max())
    log(f'  {name}: rel err {err:.3e} (tol {tol:.0e})')
    if not err <= tol:
        raise AssertionError(f'{name}: rel err {err} > {tol}')
    return err


def scipy_recurrence(L, lmax, c, x):
    """The Chebyshev recurrence in SciPy f64 on the host: (Nf, N, S)."""
    L = L.astype(np.float64).tocsr()
    a1 = a2 = lmax / 2
    nf, m1 = c.shape
    t_old = x
    t_cur = (L @ x - a2 * x) / a1
    r = [0.5 * c[i, 0] * t_old + c[i, 1] * t_cur for i in range(nf)]
    for k in range(2, m1):
        t_new = (2.0 / a1) * (L @ t_cur - a2 * t_cur) - t_old
        for i in range(nf):
            r[i] += c[i, k] * t_new
        t_old, t_cur = t_cur, t_new
    return np.stack(r)


def bound(bytes_moved, flops, flops_per_s=FP32_FLOPS):
    """The least time for the work: the larger of bytes over the memory
    rate and operations over the rate of the unit that does them (FP32
    outside the tensor cores unless ``flops_per_s`` says otherwise)."""
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / flops_per_s * 1e3
    return {'bound_ms': max(bytes_ms, flops_ms),
            'bound_by': 'bytes' if bytes_ms >= flops_ms else 'operations'}


def seeded_normal(shape, seed, device='cuda', dtype=torch.float32):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device, dtype=dtype)


def symmetric_from_edges(src, tgt, n, weights=None):
    data = np.ones(2 * len(src)) if weights is None else np.concatenate(
        [weights, weights])
    W = sps.csr_matrix((data, (np.concatenate([src, tgt]),
                               np.concatenate([tgt, src]))), shape=(n, n))
    if weights is None:
        W.data[:] = 1.0
    return W


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build():
    log('phase 1: build, then the canary kernel #4')
    t0 = time.time()
    outputs = _cuda.build(['csr_spmm', 'banded_spmm', 'windowed_fold'],
                          extra_flags=('-Xptxas', '-v'))
    log(f'  built in {time.time() - t0:.1f} s')
    for name, out in outputs.items():
        for line in out.splitlines():
            if ('Compiling entry' in line or 'registers' in line
                    or 'spill' in line):
                log(f'  {name}: {line.strip()}')
    x = torch.arange(8 * 128, dtype=torch.float32, device='cuda').reshape(
        8, 128)
    y = wk.double(x)
    check('double (#4) vs x * 2', y, wk.double_plain(x), 0.0)
    max_abs_err = float((y - wk.double_plain(x)).abs().max())
    ms = time_ms(lambda: wk.double(x), 100)
    return {'max_abs_err': max_abs_err, 'ms': ms,
            'device_ms': device_ms(lambda: wk.double(x), 100),
            'library_device_ms': device_ms(lambda: torch.mul(x, 2), 100),
            'plain_ms': time_ms(lambda: wk.double_plain(x), 100),
            'library_ms': time_ms(lambda: torch.mul(x, 2), 100),
            'library': 'torch.mul(x, 2)',
            **bound(2 * x.numel() * 4, x.numel()), 'shape': list(x.shape)}


def phase_kernels():
    log('phase 2: kernels against their plain versions')
    n = 1 << 16
    rng = np.random.default_rng(1)
    src, tgt = gsp.graphs.ba_edges_fast(n, m0=8, m=8, seed=1)
    W = symmetric_from_edges(src, tgt, n, rng.uniform(0.5, 1.5, len(src)))
    for dtype, widths, tol in ((torch.float32, (128, 5, 1), TOL_CSR),
                               (torch.float64, (5,), TOL_F64)):
        A = gsp.core.from_scipy(W, dtype=dtype, device='cuda')
        for s in widths:
            x = seeded_normal((n, s), s, dtype=dtype)
            check(f'csr N=2^16 S={s} {dtype}',
                  csr_kernel.csr_spmm(A.rowptr, A.cols, A.vals, x),
                  csr_kernel.csr_spmm_plain(A.rowptr, A.cols, A.vals, x), tol)
    # a star row of 20,000 edges spans about 80 of the CSR kernel's
    # segments of 256 steps; held against the plain version in f64, whose
    # f32 index_add_ would sum the long row in no fixed order
    star = sps.random(64, 20_000, density=1e-3, random_state=rng,
                      format='lil')
    star[3] = rng.normal(size=20_000)
    A = gsp.core.from_scipy(star.tocsr(), dtype=torch.float32,
                            device='cuda')
    x = seeded_normal((20_000, 128), 9)
    check('csr star row of 20,000 edges S=128',
          csr_kernel.csr_spmm(A.rowptr, A.cols, A.vals, x),
          csr_kernel.csr_spmm_plain(A.rowptr, A.cols, A.vals.double(),
                                    x.double()), TOL_CSR)

    n = 128 * 64 + 37        # ragged last tile
    for offsets, b in (((1, 7, 100), 1), ((1, 128, 300, 500), 4)):
        M = sum(sps.diags(rng.normal(size=n - o), o) for o in offsets)
        M = (M + M.T).tocsr()
        for dtype, widths, tol in ((torch.float32, (128, 5), TOL_BANDED),
                                   (torch.float64, (5,), TOL_F64)):
            B = gsp.core.sparse.banded_from_scipy(M, dtype=dtype,
                                                  device='cuda')
            assert B.half_bw == b, B.half_bw
            for s in widths:
                x = seeded_normal((n, s), s, dtype=dtype)
                check(f'banded b={b} S={s} {dtype}',
                      banded_kernel.banded_spmm(B.tiles, x, n),
                      banded_kernel.banded_spmm_plain(B.tiles, x, n), tol)
    # Grid2d tiles scaled by 2/7.93: not exact in TF32 (unlike path B's
    # integer tiles), so both operands' small terms count
    G = gsp.graphs.Grid2d(64, 61)
    tiles = G.L.to_banded().offdiag.tiles * (2.0 / 7.93)
    for s in (128, 5):
        x = seeded_normal((G.N, s), s)
        check(f'banded Grid2d(64, 61) tiles * 2/7.93 S={s}',
              banded_kernel.banded_spmm(tiles, x, G.N),
              banded_kernel.banded_spmm_plain(tiles, x, G.N), TOL_BANDED)
    return phase_windowed_kernels(W)


def check_windowed(name, M, s, dtype, tol):
    """Fold and strip kernels of the windowed matrix M against their plain
    versions at width s."""
    kp = M.borrow_span * M.window_rows
    x = seeded_normal((M.n_cols, s), s, dtype=dtype)
    t = wk.windowed_fold(M.cols, M.vals, M.rowid, x, M.chunk_rows, kp)
    t_plain = wk.windowed_fold_plain(M.cols, M.vals, M.rowid, x,
                                     M.chunk_rows, kp)
    check(f'windowed_fold {name} S={s} {dtype}', t, t_plain, tol)
    check(f'window_strip {name} S={s} {dtype}',
          wk.window_strip(t, M.n_rows, M.window_rows),
          wk.window_strip_plain(t_plain, M.n_rows, M.window_rows), tol)


def phase_windowed_kernels(W):
    """The windowed kernels on the phase's BA 2^16 graph (default packing,
    ``window_rows=256`` for an S tile of 64 and int32 row ids, span 4), and
    the one-hot fold at #3's shape."""
    for dtype, widths, tol in ((torch.float32, (128, 5, 1), TOL_WINDOWED),
                               (torch.float64, (5,), TOL_F64)):
        M = wd.windowed_from_scipy(W, dtype=dtype, device='cuda')
        log(f'  windowed N=2^16 {dtype}: slabs {tuple(M.cols.shape)}, '
            f'span {M.borrow_span}, {len(M.levels)} level tiers')
        for s in widths:
            check_windowed('N=2^16', M, s, dtype, tol)
    for name, kw in (('P=256', dict(window_rows=256)),
                     ('span 4', dict(borrow_span=4))):
        M = wd.windowed_from_scipy(W, dtype=torch.float32, device='cuda',
                                   **kw)
        log(f'  windowed {name}: slabs {tuple(M.cols.shape)}, row ids '
            f'{M.rowid.dtype}, S tile '
            f'{wk.fold_layout(M.borrow_span * M.window_rows, 128, 4).s_tile}')
        check_windowed(name, M, 128, torch.float32, TOL_WINDOWED)
    gen = torch.Generator(device='cuda').manual_seed(3)
    rid = torch.randint(0, FOLD3_KP, (1, FOLD3_LT), dtype=torch.int32,
                        device='cuda', generator=gen)
    p = seeded_normal((1, FOLD3_LT, 128), 4).to(torch.bfloat16)
    fold3 = measure_fold(rid, p, FOLD3_KP, 100)
    # dead slots (ids on both sides of [0, KP)) holding inf add nothing
    dead = torch.rand(1, FOLD3_LT, device='cuda', generator=gen) < 0.2
    rid = torch.where(dead, torch.where(rid % 2 == 0, -1, FOLD3_KP + rid),
                      rid)
    for dtype in (torch.bfloat16, torch.float32):
        p_inf = torch.where(dead[..., None], float('inf'),
                            p.float()).to(dtype)
        check(f'fold_products with inf in dead slots {dtype}',
              wk.fold_products(rid, p_inf, FOLD3_KP),
              wk.fold_products_plain(rid, p_inf, FOLD3_KP), TOL_FOLD)
    return fold3


def measure_fold(rid, p, kp, iters):
    """``fold_products`` against its plain version, and its times beside
    the library yardstick: one ``index_add_`` of the products, cast to f32
    beforehand (the cast is not timed)."""
    nw, lt, s = p.shape
    out = wk.fold_products(rid, p, kp)
    out_plain = wk.fold_products_plain(rid, p, kp)
    max_abs_err = float((out - out_plain).abs().max())
    check(f'fold_products NW={nw} Lt={lt} KP={kp} {p.dtype}', out, out_plain,
          TOL_FOLD)
    del out_plain
    p32 = p.float().reshape(-1, s)
    dst = (torch.arange(nw, device=p.device)[:, None] * kp
           + rid).reshape(-1).long()
    acc = torch.zeros(nw * kp, s, device=p.device)
    # the dense one-hot product the kernel does, at the bf16 rate
    dense_flops = 2 * nw * kp * lt * s
    return {'max_abs_err': max_abs_err,
            'ms': time_ms(lambda: wk.fold_products(rid, p, kp), iters),
            'device_ms': device_ms(lambda: wk.fold_products(rid, p, kp),
                                   iters),
            'plain_ms': time_ms(lambda: wk.fold_products_plain(rid, p, kp),
                                max(iters // 10, 2)),
            'library_ms': time_ms(lambda: acc.index_add_(0, dst, p32), iters),
            'library': 'index_add_ of the products cast to f32 beforehand',
            **bound(rid.numel() * 4 + p.numel() * p.element_size()
                    + out.numel() * 4, p.numel()),
            'bound_tensor_ms': dense_flops / BF16_FLOPS * 1e3,
            'blocks': wk.products_layout(nw, kp, s, p.element_size()).blocks,
            'shape': {'NW': nw, 'Lt': lt, 'KP': kp, 'S': s}}


def measure_csr(A, x):
    """Kernel, plain and library times of one CSR SpMM at the path's shape."""
    args = (A.rowptr, A.cols, A.vals, x)
    y = csr_kernel.csr_spmm(*args)
    y_plain = csr_kernel.csr_spmm_plain(*args)
    max_abs_err = float((y - y_plain).abs().max())
    check('csr kernel at path A shape', y, y_plain, TOL_CSR)
    del y_plain
    if not torch.equal(y, csr_kernel.csr_spmm(*args)):
        raise AssertionError('csr_spmm: two launches differ at path A')
    log('  csr kernel at path A shape: two launches bit-equal')
    del y
    nnz, n, s = A.nnz, A.n_rows, x.shape[1]
    lib = torch.sparse_csr_tensor(A.rowptr, A.cols[:nnz], A.vals[:nnz],
                                  size=A.shape)
    ms = time_ms(lambda: csr_kernel.csr_spmm(*args), 20)
    plain_ms = time_ms(lambda: csr_kernel.csr_spmm_plain(*args), 3)
    library_ms = time_ms(lambda: torch.sparse.mm(lib, x), 20)
    item = x.element_size()
    bytes_min = 2 * n * s * item + nnz * (4 + item) + (n + 1) * 4
    bytes_gather = nnz * s * item + n * s * item + nnz * (4 + item)
    return {
        'max_abs_err': max_abs_err, 'ms': ms, 'plain_ms': plain_ms,
        'library_ms': library_ms,
        'library': 'torch.sparse.mm on a sparse CSR tensor',
        **bound(bytes_min, 2 * nnz * s),
        'bound_gather_ms': bytes_gather / HBM_BYTES_PER_S * 1e3,
        'nnz': nnz, 'n': n, 's': s,
    }


def measure_hub_tail(A, x):
    """How much of the CSR kernel's time the hub rows (above HUB_DEGREE
    edges) take: its ms per launch on ``A`` as it is, on ``A`` with those
    rows emptied, and on those rows alone (both made on the card from
    ``A``'s arrays)."""
    counts = A.rowptr[1:] - A.rowptr[:-1]
    hub = counts > HUB_DEGREE
    edge_hub = torch.repeat_interleave(hub, counts.long(),
                                       output_size=A.nnz)
    zero = torch.zeros(1, dtype=torch.int32, device=x.device)

    def rows(keep_hubs):
        kept = torch.where(hub == keep_hubs, counts, 0)
        mask = edge_hub == keep_hubs
        return (torch.cat([zero, kept.cumsum(0, dtype=torch.int32)]),
                A.cols[:A.nnz][mask].contiguous(),
                A.vals[:A.nnz][mask].contiguous(), x)

    out = {'hub_rows': int(hub.sum()),
           'hub_edges': int(edge_hub.sum()), 'nnz': A.nnz,
           'ms': time_ms(lambda: csr_kernel.csr_spmm(
               A.rowptr, A.cols, A.vals, x), 20)}
    for name, keep in (('ms_without_hubs', False), ('ms_hubs_only', True)):
        args = rows(keep)
        out[name] = time_ms(lambda: csr_kernel.csr_spmm(*args), 20)
        del args
    out['hub_tail_ms'] = out['ms'] - out['ms_without_hubs']
    return out


def measure_banded(B, x):
    """Kernel, plain and library times of one banded SpMM at the path's
    shape. The library yardstick is torch.bmm over band windows gathered
    beforehand (the gather is not timed). The bound counts the function's
    own products at the card's fastest rate for f32 operands (TF32, dense),
    beside the bytes. Two diagnostics stand beside it: the FP32 FFMA bound
    (``bound_fp32_ms``) and the time of the three TF32 products per product
    that the f32 kernel issues (``bound_tf32x3_ms``)."""
    tiles, n = B.tiles, B.n_rows
    y = banded_kernel.banded_spmm(tiles, x, n)
    y_plain = banded_kernel.banded_spmm_plain(tiles, x, n)
    max_abs_err = float((y - y_plain).abs().max())
    check('banded kernel at path B shape', y, y_plain, TOL_BANDED)
    del y, y_plain
    nb, n_diag = tiles.shape[:2]
    b, s = B.half_bw, x.shape[1]
    a_cat = tiles.permute(0, 2, 1, 3).reshape(nb, 128, n_diag * 128)
    x_cat = banded_kernel.band_windows(x, nb, b).reshape(nb, n_diag * 128, s)
    ms = time_ms(lambda: banded_kernel.banded_spmm(tiles, x, n), 20)
    plain_ms = time_ms(lambda: banded_kernel.banded_spmm_plain(tiles, x, n), 5)
    library_ms = time_ms(lambda: torch.bmm(a_cat, x_cat), 20)
    del a_cat, x_cat
    # tile pairs (i, d) whose x block lies inside the matrix
    pairs = nb * n_diag - b * (b + 1)
    item = x.element_size()
    bytes_min = tiles.numel() * item + 2 * n * s * item
    flops = 2 * pairs * 128 * 128 * s
    return {
        'max_abs_err': max_abs_err, 'ms': ms, 'plain_ms': plain_ms,
        'library_ms': library_ms,
        'library': 'torch.bmm over pre-gathered band windows',
        **bound(bytes_min, flops, TF32_FLOPS),
        'bound_fp32_ms': flops / FP32_FLOPS * 1e3,
        'bound_tf32x3_ms': TF32_PRODUCTS * flops / TF32_FLOPS * 1e3,
        'gflop': flops / 1e9, 'tf32_gflop': TF32_PRODUCTS * flops / 1e9,
        'n': n, 's': s, 'half_bw': b,
    }


def validate_path(name, L_host, lmax, evaluate, x, out):
    """8 columns of ``out`` (Nf, N, S) against the SciPy f64 recurrence on
    the scipy Laplacian ``L_host``."""
    c64 = cheby_coeff(evaluate, lmax, m=ORDER, dtype=torch.float64,
                      device='cpu').numpy()
    x8 = x[:, :N_CHECK_COLS].double().cpu().numpy()
    t0 = time.time()
    ref = scipy_recurrence(L_host, lmax, c64, x8)
    log(f'  scipy f64 reference: {time.time() - t0:.1f} s')
    return check(f'path {name} vs scipy f64', out[:, :, :N_CHECK_COLS].cpu(),
                 torch.from_numpy(ref), TOL_PATH)


# ---------------------------------------------------------------------------
# the three paths, set up through the entry points a user calls (also used
# by tools/profile_torch_port.py, so both measure the same work)
# ---------------------------------------------------------------------------

def bench_graph(fmt):
    """The BA graph of bench.py:53-58 with its Laplacian in ``fmt``, its
    λmax and the heat bank. Returns ``(G, g, x, bank)``, ``bank()``
    filtering x (N, 128) f32."""
    t0 = time.time()
    src, tgt = gsp.graphs.ba_edges_fast(N_BA, m0=M_ATTACH, m=M_ATTACH, seed=42)
    W = symmetric_from_edges(src, tgt, N_BA)
    log(f'  edges generated in {time.time() - t0:.1f} s: {W.nnz} stored')
    x = seeded_normal((N_BA, N_SIGNALS), 0)
    t0 = time.time()
    G = gsp.graphs.Graph(W)
    torch.cuda.synchronize()
    log(f'  Graph(W) in {time.time() - t0:.1f} s')
    if fmt != 'coo':
        t0 = time.time()
        G.compute_laplacian(fmt=fmt)
        torch.cuda.synchronize()
        log(f'  compute_laplacian(fmt={fmt!r}) in {time.time() - t0:.1f} s')
    t0 = time.time()
    G.estimate_lmax()
    log(f'  estimate_lmax: {G.lmax:.6f} in {time.time() - t0:.1f} s')
    g = gsp.filters.Heat(G, scale=SCALES)
    return G, g, x, lambda: g.filter(x, method='chebyshev', order=ORDER)


def path_a():
    """Path A: the bench graph in the CSR format (the default)."""
    return bench_graph('coo')


def path_c():
    """Path C: the bench graph in the windowed-compact format, as the JAX
    package's bench.py:162-185 runs it."""
    return bench_graph('windowed')


def path_b():
    """Path B: Grid2d(512, 512), its λmax, the banded Laplacian and the
    heat bank's coefficients. Returns ``(G, Lb, g, c, x, bank)``,
    ``bank()`` applying the bank to x (N, 128) f32 on the banded operator."""
    t0 = time.time()
    G = gsp.graphs.Grid2d(GRID_SIDE, GRID_SIDE)
    G.estimate_lmax()
    Lb = G.L.to_banded()
    if Lb is None:
        raise AssertionError('Grid2d(512, 512) did not fit the banded format')
    torch.cuda.synchronize()
    log(f'  graph, lmax {G.lmax:.6f}, banded (half_bw {Lb.offdiag.half_bw}, '
        f'tiles {tuple(Lb.offdiag.tiles.shape)}) in {time.time() - t0:.1f} s')
    g = gsp.filters.Heat(G, scale=SCALES)
    c = cheby_coeff(g.evaluate, G.lmax, m=ORDER)
    x = seeded_normal((G.N, N_SIGNALS), 1)
    return G, Lb, g, c, x, lambda: cheby_op(Lb, G.lmax, c, x)


def phase_path_a():
    log(f'phase 3: path A, BarabasiAlbert N={N_BA}, CSR kernel')
    reset_counts()
    G, g, x, bank = path_a()
    degree = G.d
    hubs = degree > HUB_DEGREE
    log(f'  row degrees: mean {degree.mean():.2f}, max {degree.max()}; '
        f'{hubs.sum()} rows above {HUB_DEGREE} hold '
        f'{degree[hubs].sum() / degree.sum():.2%} of the edges')
    out, launches, per_bank = run_bank(bank)
    log(f'  launches on the path {launches}, per bank {per_bank}')
    if per_bank['csr_spmm'] < ORDER:
        raise AssertionError(f'CSR kernel launched {per_bank["csr_spmm"]} < '
                             f'{ORDER} times in one bank')
    if tuple(out.shape) != (N_BA, N_SIGNALS, len(SCALES)):
        raise AssertionError(f'path A output shape {tuple(out.shape)}')
    rel_err = validate_path('A', G.L.to_scipy(), G.lmax, g.evaluate, x,
                            out.permute(2, 0, 1))
    del out

    ms_bank = time_ms(bank, 3)
    nnz = G.L.offdiag.nnz
    log(f'  {ms_bank:.3f} ms per bank, '
        f'{ORDER * nnz * N_SIGNALS / (ms_bank / 1e3):.4e} edge-ops/s')
    kernel = measure_csr(G.L.offdiag, x)
    kernel.update(max_row_nnz=int(degree.max()))
    hub_tail = measure_hub_tail(G.L.offdiag, x)
    log(f'  hub tail: {json.dumps(hub_tail)}')
    kernel.update(hub_tail=hub_tail)
    path = {'ms_per_bank': ms_bank, 'rel_err': rel_err, 'nnz': nnz,
            'edge_ops_per_s': ORDER * nnz * N_SIGNALS / (ms_bank / 1e3),
            'lmax': G.lmax}
    return kernel, path, (launches, per_bank)


def phase_path_b():
    log(f'phase 4: path B, Grid2d({GRID_SIDE}, {GRID_SIDE}), banded kernel')
    reset_counts()
    G, Lb, g, c, x, bank = path_b()
    out, launches, per_bank = run_bank(bank)
    log(f'  launches on the path {launches}, per bank {per_bank}')
    if per_bank['banded_spmm'] < ORDER:
        raise AssertionError(f'banded kernel launched '
                             f'{per_bank["banded_spmm"]} < {ORDER} times in '
                             f'one bank')
    if tuple(out.shape) != (len(SCALES), G.N, N_SIGNALS):
        raise AssertionError(f'path B output shape {tuple(out.shape)}')
    check('path B banded vs CSR path', out, cheby_op(G.L, G.lmax, c, x),
          TOL_PATH)
    rel_err = validate_path('B', G.L.to_scipy(), G.lmax, g.evaluate, x,
                            out)
    del out

    ms_bank = time_ms(bank, 3)
    log(f'  {ms_bank:.3f} ms per bank')
    kernel = measure_banded(Lb.offdiag, x)
    path = {'ms_per_bank': ms_bank, 'rel_err': rel_err, 'n': G.N,
            'lmax': G.lmax}
    return kernel, path, (launches, per_bank)


def measure_windowed(G, x):
    """Fold, strip and whole-SpMM times at path C's shape (x in the matrix's
    internal order, as the bank runs them), against their plain versions;
    the fold's determinism (two launches bit-equal); the yardsticks on the
    same shuffled matrix in CSR, ``torch.sparse.mm`` and the port's CSR
    kernel; and the strip's, ``torch.nn.functional.fold``."""
    M = G.L.offdiag
    R, P, K = M.chunk_rows, M.window_rows, M.borrow_span
    n, s = M.n_rows, x.shape[1]
    xp = chunked.permute_in(M, x)
    args = (M.cols, M.vals, M.rowid, xp, R, K * P)
    t = wk.windowed_fold(*args)
    t_plain = wk.windowed_fold_plain(*args)
    fold_err = float((t - t_plain).abs().max())
    check('windowed_fold at path C shape', t, t_plain, TOL_WINDOWED)
    del t_plain
    if not torch.equal(t, wk.windowed_fold(*args)):
        raise AssertionError('windowed_fold: two launches differ at path C')
    log('  windowed_fold at path C shape: two launches bit-equal')
    y_plain = wk.window_strip_plain(t, n, P)
    y = wk.window_strip(t, n, P)
    strip_err = float((y - y_plain).abs().max())
    check('window_strip at path C shape', y, y_plain, TOL_WINDOWED)
    del y_plain
    strip_lib, strip_lib_ms = measure_strip_library(t, y, n, P)
    del y
    fold_ms = time_ms(lambda: wk.windowed_fold(*args), 10)
    fold_plain_ms = time_ms(lambda: wk.windowed_fold_plain(*args), 2)
    strip_ms = time_ms(lambda: wk.window_strip(t, n, P), 20)
    strip_plain_ms = time_ms(lambda: wk.window_strip_plain(t, n, P), 5)
    spmm_ms = time_ms(lambda: wd.spmm_internal(M, xp), 10)

    # the same matrix in CSR, in the same shuffled order
    coo = G.W.tocoo()
    iperm = M.iperm.cpu().numpy()
    A = gsp.core.from_coo(iperm[coo.row], iperm[coo.col], -coo.data, n,
                          device='cuda')
    lib = torch.sparse_csr_tensor(A.rowptr, A.cols[:A.nnz], A.vals[:A.nnz],
                                  size=A.shape)
    check('torch.sparse.mm on the shuffled CSR vs the windowed SpMM',
          torch.sparse.mm(lib, xp), wd.spmm_internal(M, xp), TOL_WINDOWED)
    library_ms = time_ms(lambda: torch.sparse.mm(lib, xp), 10)
    csr_ms = time_ms(
        lambda: csr_kernel.csr_spmm(A.rowptr, A.cols, A.vals, xp), 10)
    del lib, A

    item = x.element_size()
    live = int((M.cols < R).sum())
    slot_bytes = M.n_slots * (4 + item + M.rowid.element_size())
    level_slots = sum(lev.cols.numel() for lev in M.levels)
    level_bytes = (level_slots * (4 + item)
                   + M.level_rows.numel() * M.level_rows.element_size())
    spmm_bytes = 2 * n * s * item + slot_bytes + level_bytes
    spmm = {'ms': spmm_ms, **bound(spmm_bytes, 2 * M.nnz * s),
            'bound_gather_ms': ((live + level_slots) * s * item + n * s * item
                                + slot_bytes + level_bytes)
            / HBM_BYTES_PER_S * 1e3,
            'library_ms': library_ms,
            'csr_spmm_same_matrix_ms': csr_ms}
    fold = {'max_abs_err': fold_err, 'ms': fold_ms, 'plain_ms': fold_plain_ms,
            'library_ms': library_ms,
            'library': 'torch.sparse.mm on the CSR of the same shuffled '
                       'matrix (the whole SpMM: fold + strip + levels)',
            **bound(n * s * item + slot_bytes + t.numel() * item,
                    2 * live * s),
            'bound_gather_ms': (live * s * item + slot_bytes
                                + t.numel() * item) / HBM_BYTES_PER_S * 1e3,
            'live_slots': live, 'slots': M.n_slots, 's': s}
    strip = {'max_abs_err': strip_err, 'ms': strip_ms,
             'plain_ms': strip_plain_ms, 'library_ms': strip_lib_ms,
             'library': strip_lib,
             **bound(t.numel() * item + n * s * item, (K - 1) * n * s),
             'window_tensor_bytes': t.numel() * item}
    return fold, strip, spmm


def measure_strip_library(t, y, n, P):
    """``torch.nn.functional.fold`` as the overlap-add's yardstick: the
    window tensor permuted beforehand (not timed) to (n_out, S·K·P, NW),
    window w a (K·P, 1) block at row w·P of each out chunk; rows below NW·P
    are y's. Checked once against the kernel's ``y``."""
    n_out, nw, kp, s = t.shape
    cols = t.permute(0, 3, 2, 1).reshape(n_out, s * kp, nw)

    def fold():
        return torch.nn.functional.fold(
            cols, output_size=((nw - 1) * P + kp, 1), kernel_size=(kp, 1),
            stride=(P, 1))

    y_lib = fold()[:, :, :nw * P, 0].permute(0, 2, 1).reshape(-1, s)[:n]
    check('torch.nn.functional.fold vs window_strip at path C', y_lib, y,
          TOL_WINDOWED)
    del y_lib
    ms = time_ms(fold, 20)
    del cols
    return ('torch.nn.functional.fold, kernel (K*P, 1), stride (P, 1), on '
            'the window tensor permuted beforehand'), ms


def measure_fold_products(M):
    """The one-hot fold at TPU kernel #2's probe shape: row ids of path C's
    first out chunk, bf16 products from a seed, f32 out."""
    nw, n_src, L = M.cols.shape[1:]
    lt = n_src * L
    if (nw, lt) != (FOLD2_NW, FOLD2_LT):
        raise AssertionError(f'path C windows are ({nw}, {lt}), not '
                             f'#2\'s ({FOLD2_NW}, {FOLD2_LT})')
    rid = M.rowid[0].reshape(nw, lt).to(torch.int32).contiguous()
    p = seeded_normal((nw, lt, 128), 5).to(torch.bfloat16)
    return measure_fold(rid, p, FOLD2_KP, 20)


def phase_path_c():
    log(f'phase 5: path C, BarabasiAlbert N={N_BA}, windowed kernels')
    reset_counts()
    G, g, x, bank = path_c()
    M = G.L.offdiag
    level_slots = sum(lev.cols.numel() for lev in M.levels)
    layout = {'slabs': list(M.cols.shape), 'slots': M.n_slots,
              'padding': M.n_slots / M.nnz, 'level_slots': level_slots,
              'level_tiers': len(M.levels),
              'level_rows': M.level_rows.numel(),
              'chunk_rows': M.chunk_rows, 'window_rows': M.window_rows,
              'borrow_span': M.borrow_span, 'rowid': str(M.rowid.dtype)}
    log(f'  layout: {json.dumps(layout)}')
    out, launches, per_bank = run_bank(bank)
    log(f'  launches on the path {launches}, per bank {per_bank}')
    for name in ('windowed_fold', 'window_strip'):
        if per_bank[name] < ORDER:
            raise AssertionError(f'{name} launched {per_bank[name]} < {ORDER} '
                                 f'times in one bank')
    if per_bank['csr_spmm']:
        raise AssertionError('the CSR kernel ran inside the windowed bank')
    if tuple(out.shape) != (N_BA, N_SIGNALS, len(SCALES)):
        raise AssertionError(f'path C output shape {tuple(out.shape)}')
    L_host = sps.diags(G.dw) - G.W         # independent of the windowed format
    rel_err = validate_path('C', L_host, G.lmax, g.evaluate, x,
                            out.permute(2, 0, 1))
    del out

    ms_bank = time_ms(bank, 3)
    nnz = M.nnz
    log(f'  {ms_bank:.3f} ms per bank, '
        f'{ORDER * nnz * N_SIGNALS / (ms_bank / 1e3):.4e} edge-ops/s')
    fold, strip, spmm = measure_windowed(G, x)
    log(f'  SpMM at path C: {json.dumps(spmm)}')
    fold2 = measure_fold_products(M)
    path = {'ms_per_bank': ms_bank, 'rel_err': rel_err, 'nnz': nnz,
            'edge_ops_per_s': ORDER * nnz * N_SIGNALS / (ms_bank / 1e3),
            'lmax': G.lmax, 'layout': layout, 'spmm': spmm}
    return fold, strip, fold2, path, (launches, per_bank)


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device available', file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
        f'{torch.cuda.get_device_name(0)}')
    t_start = time.time()

    double = phase_build()
    fold3 = phase_kernels()
    csr, path_a, counts_a = phase_path_a()
    torch.cuda.empty_cache()
    banded, path_b, counts_b = phase_path_b()
    torch.cuda.empty_cache()
    fold, strip, fold2, path_c, counts_c = phase_path_c()
    log(f'paths: {json.dumps({"A": path_a, "B": path_b, "C": path_c})}')
    log(f'peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} '
        f'GiB; total {time.time() - t_start:.1f} s')

    csr.update(name='csr_spmm', route='cuda',
               source='pygsp_tpu_torch/csrc/csr_spmm.cu',
               replaces='pygsp_tpu/core/sparse.py:282 (XLA gather + '
                        'segment_sum, no Pallas kernel)')
    banded.update(name='banded_spmm', route='cuda',
                  source='pygsp_tpu_torch/csrc/banded_spmm.cu',
                  replaces='pygsp_tpu/ops/pallas_banded.py:69')
    source = 'pygsp_tpu_torch/csrc/windowed_fold.cu'
    fold.update(name='windowed_fold', route='cuda', source=source,
                replaces='benchmarks/pallas_fold_probe.py:103 (#2, the '
                         'one-hot fold) with the gather of '
                         'pygsp_tpu/core/windowed.py:298-303')
    strip.update(name='window_strip', route='cuda', source=source,
                 replaces='pygsp_tpu/core/windowed.py:336-345 (XLA '
                          'overlap-add, no Pallas kernel)')
    fold2.update(name='fold_products', route='cuda', source=source,
                 at_shape_of_3=fold3,
                 replaces='benchmarks/pallas_fold_probe.py:103 (#2); at '
                          'NW=1 benchmarks/pallas_smoke.py:52 (#3)')
    double.update(name='double', route='cuda', source=source,
                  replaces='benchmarks/pallas_smoke.py:28 (#4)')
    # launches as counted in each path's own run; a kernel's `launches` is
    # that of the path it serves, or the sum over the three paths for the
    # kernels that serve none (fold_products, double)
    by_path = {'A': counts_a, 'B': counts_b, 'C': counts_c}
    for kernel, path in ((csr, 'A'), (banded, 'B'), (fold, 'C'),
                         (strip, 'C'), (fold2, None), (double, None)):
        name = kernel['name']
        paths = [path] if path else list(by_path)
        kernel.update(
            launches=sum(by_path[p][0][name] for p in paths),
            launches_per_bank=sum(by_path[p][1][name] for p in paths),
            launches_by_path={p: by_path[p][0][name] for p in by_path})
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    print(json.dumps({'kernels': [csr, banded, fold, strip, fold2, double]}),
          flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
