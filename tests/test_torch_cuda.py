"""The CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips where no CUDA device exists.
They import no JAX, so on a machine with a card and no JAX they run
without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

They cover what ``chip_smoke.py`` does not: empty rows, rectangular CSR,
S above one 128-column tile, a band of width 0, band tiles that TF32 does
not hold exactly (the float32 banded kernel's 3×TF32 error is printed),
and the wrappers' checks on CUDA tensors; and,
for the windowed-compact kernels, the cases of ``chip_smoke.py``'s phase 2
at a smaller size (S of 1, 5, 128, 129 and 300, ``window_rows=256`` for an
S tile under 128 and int32 row ids, span 4, both at once), the fold's
shared-memory budget against the kernel's own count, its determinism,
slabs that are mostly dead slots, the one-hot fold at TPU
kernel #2's and #3's shapes and at ragged ones (dead ids on both sides of
the range, dead slots holding ``inf``, f32 products, its shared-memory
count against the kernel's, two launches bit-equal), the CSR kernel on a
star row that spans many segments and on hub rows among many empty ones,
and #4's ``y = 2x``; the tail (``window_strip`` with the residue list) in
every instance against its plain version, with heavy rows, K = 2 and 4, S
of 3 (one value a lane), 128 and 600, unaligned rows, and inf where only
dead slots point; the bf16 instances of the fold and the strip (a bf16
carry, bf16 values, both) and a fast-mode bank against the CPU; the
fused Chebyshev step's first three entry points against their plain
versions, bit for bit, in f32, f64 and with a bf16 carry, and its fourth,
the coefficient gradient ``cheby_dot_group``, within its summation bound
and bit-equal across launches; the SDDMM ``csr_sddmm`` against its plain
version (1 to 600 columns, a star row, the padding untouched, two launches
bit-equal), kernel A's fused entry ``csr_spmm_sddmm`` bit-equal to its wide
entry plus ``csr_sddmm`` (33 to 512 columns, duplicates, padding, a star
row, empty rows) and its refusals, and the gradients through W's values on
the card against the CPU's, on both routes, and through each format's
SpMM and synthesis Functions (a Hessian-vector product of ``L @ x``); the
guard that makes every kernel wrapper
refuse an operand that requires grad, and the fixed-graph training path's
gradients against the CPU's; the ELL and chunked SpMMs against their plain
version (heavy rows, ragged chunks, the degree relabeling, S of 1 to 512,
every operand pair, dead slots holding ``inf``, two launches bit-equal),
their narrow entry either side of ``SLOT_NARROW_WIDTH``, in every pair and
against the wide entry, λmax on the narrow symbols alone, a bank on each
format against the CPU, and their refusals; and the
algorithms in f64 against the CPU (the learning solvers, ``prox_tv`` and
its launches, the dense Kron solve, the resistance sketch, the
spectrogram, a nearest-neighbour graph and its LOBPCG eigenmap).
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import pygsp_tpu_torch as tgsp
from pygsp_tpu_torch.core import sparse as tsp
from pygsp_tpu_torch.core import _cuda, banded_kernel, cheby_kernel, csr_kernel
from pygsp_tpu_torch.core import chunked as tck
from pygsp_tpu_torch.core import ell_kernel
from pygsp_tpu_torch.core import windowed as twd
from pygsp_tpu_torch.core import windowed_kernel as wk
from pygsp_tpu_torch.ops.chebyshev import carry_error_estimate, cheby_coeff

pytestmark = pytest.mark.cuda

# f32 sums in another order than the plain version; f64 likewise. The
# banded f32 kernel's 3xTF32 products (dropped terms of order 2^-22) err
# near 5e-7, where one TF32 pass or a split without either cross term
# misses by 3.7e-5 or more (test_torch_kernel_budget.py emulates each).
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _rel_err(got, want):
    torch.cuda.synchronize()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def _signal(shape, dtype, seed, device):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=shape)).to(device=device, dtype=dtype)


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('s', [1, 5, 127, 128, 129, 300])
def test_csr_kernel_matches_plain(cuda, dtype, s):
    rng = np.random.default_rng(s)
    A = sps.random(3000, 2500, density=0.002, random_state=rng, format='lil')
    A[5] = 0                                   # an empty row, and a hub row
    A[7, :2000] = rng.normal(size=2000)
    A = A.tocsr()
    M = tsp.from_scipy(A, dtype=dtype, device=cuda)
    x = _signal((2500, s), dtype, 1, cuda)
    before = csr_kernel.csr_spmm.launches
    y = csr_kernel.csr_spmm(M.rowptr, M.cols, M.vals, x)
    assert csr_kernel.csr_spmm.launches == before + 1
    want = csr_kernel.csr_spmm_plain(M.rowptr, M.cols, M.vals, x)
    assert y.shape == (3000, s) and y.dtype == dtype
    assert _rel_err(y, want) <= TOL[dtype]
    assert float(y[5].abs().max()) == 0.0


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('s', [1, 5, 127, 128, 129, 300])
def test_csr_kernel_star_row_spans_segments(cuda, dtype, s):
    """A row of 20,000 edges (about 80 of the kernel's segments of 256
    steps) among short rows, empty first and last rows; two launches
    bit-equal. Held against the plain version in float64: in float32 the
    plain version's ``index_add_`` sums the long row in no fixed order."""
    rng = np.random.default_rng(s + 1)
    A = sps.random(400, 20_000, density=0.001, random_state=rng,
                   format='lil')
    A[0] = A[399] = 0
    A[3] = rng.normal(size=20_000)
    A = A.tocsr()
    M = tsp.from_scipy(A, dtype=dtype, device=cuda)
    x = _signal((20_000, s), dtype, 7, cuda)
    args = (M.rowptr, M.cols, M.vals, x)
    y = csr_kernel.csr_spmm(*args)
    want = csr_kernel.csr_spmm_plain(M.rowptr, M.cols, M.vals.double(),
                                     x.double())
    assert _rel_err(y.double(), want) <= TOL[dtype]
    assert float(y[0].abs().max()) == float(y[399].abs().max()) == 0.0
    assert torch.equal(y, csr_kernel.csr_spmm(*args))


def _narrow_case(dtype, device):
    """Empty rows (among them the first and last, and a run of 40), a hub
    row of 3,000 edges, and entries kept as duplicates
    (``sum_duplicates=False``) that the kernel must sum like any others."""
    rng = np.random.default_rng(31)
    A = sps.random(5000, 4000, density=0.002, random_state=rng, format='lil')
    A[0] = A[4999] = 0
    A[100:140] = 0
    A[7, :3000] = rng.normal(size=3000)
    A = A.tocoo()
    dup = rng.choice(A.nnz, 500, replace=False)
    rows = np.concatenate([A.row, A.row[dup]])
    cols = np.concatenate([A.col, A.col[dup]])
    vals = np.concatenate([A.data, rng.normal(size=500)])
    M = tsp.from_coo(rows, cols, vals, 5000, 4000, sum_duplicates=False,
                     dtype=dtype, device=device)
    assert M.nnz == A.nnz + 500
    return M


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('s', [1, 2, 3, 5, 8, 16, 17])
def test_csr_narrow_entry_matches_plain(cuda, dtype, s):
    """The narrow entry (lanes over edges) against the plain version in
    float64, two launches bit-equal, empty rows 0; and the wrapper's
    choice by width launching it up to NARROW_WIDTH."""
    M = _narrow_case(dtype, cuda)
    x = _signal((4000, s), dtype, 32, cuda)
    args = (M.rowptr, M.cols, M.vals, x)
    y = csr_kernel.csr_spmm(*args, entry='narrow')
    want = csr_kernel.csr_spmm_plain(M.rowptr, M.cols, M.vals.double(),
                                     x.double())
    assert y.shape == (5000, s) and y.dtype == dtype
    assert _rel_err(y.double(), want) <= TOL[dtype]
    for r in (0, 4999, 100, 139):
        assert float(y[r].abs().max()) == 0.0
    assert torch.equal(y, csr_kernel.csr_spmm(*args, entry='narrow'))
    symbols = []
    launch = _cuda.launch

    def spy(name, symbol, *rest):
        symbols.append(symbol)
        return launch(name, symbol, *rest)

    _cuda.launch = spy
    try:
        csr_kernel.csr_spmm(*args)
    finally:
        _cuda.launch = launch
    narrow = s <= csr_kernel.NARROW_WIDTH[dtype]
    assert symbols == [('csr_spmm_narrow_' if narrow else 'csr_spmm_')
                       + ('f32' if dtype == torch.float32 else 'f64')]


def _sddmm_case(dtype, device):
    """A square CSR with a star row of 3,000 edges (many warps' runs), an
    empty row and the edge padding of ``from_coo`` (``n_edges_padded >
    nnz``)."""
    rng = np.random.default_rng(61)
    A = sps.random(4000, 4000, density=0.001, random_state=rng, format='lil')
    A[9] = 0
    A[11, :3000] = rng.normal(size=3000)
    M = tsp.from_scipy(A.tocsr(), dtype=dtype, device=device)
    assert M.n_edges_padded > M.nnz
    return M


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('s', [1, 8, 128, 512, 600])
def test_csr_sddmm_matches_plain(cuda, dtype, s):
    """The SDDMM and its fused diagonal against the plain version in
    float64, at one column to 512 (one launch) and 600 (two), the padding
    untouched, two launches bit-equal."""
    M = _sddmm_case(dtype, cuda)
    u, t = (_signal((4000, s), dtype, k, cuda) for k in (62, 63))
    out0 = torch.zeros_like(M.vals)
    out0[:M.nnz] = _signal((M.nnz,), dtype, 64, cuda)
    out0[M.nnz:] = 7.0                  # padding: never read nor written
    d0 = _signal((4000,), dtype, 65, cuda)
    runs = []
    for _ in range(2):
        out, dg = out0.clone(), d0.clone()
        before = csr_kernel.csr_sddmm.launches
        csr_kernel.csr_sddmm(M.rows, M.cols, u, t, out, 0.5, dg)
        assert csr_kernel.csr_sddmm.launches == before + -(-s // 512)
        runs.append((out, dg))
    want = out0.to(torch.float64, copy=True)
    want_d = d0.to(torch.float64, copy=True)
    csr_kernel.csr_sddmm_plain(M.rows, M.cols, u.double(), t.double(),
                               want, 0.5, want_d)
    assert _rel_err(runs[0][0].double(), want) <= TOL[dtype]
    assert _rel_err(runs[0][1].double(), want_d) <= TOL[dtype]
    assert bool((runs[0][0][M.nnz:] == 7.0).all())
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    # without the diagonal
    out = out0.clone()
    csr_kernel.csr_sddmm(M.rows, M.cols, u, t, out, 0.5)
    assert torch.equal(out, runs[0][0])


def _fused_case(dtype, device):
    """A square CSR with a star row of 3,000 edges (many segments of the
    walk), empty rows, entries kept as duplicates and the edge padding of
    ``from_coo``, not symmetric."""
    rng = np.random.default_rng(68)
    A = sps.random(4000, 4000, density=0.001, random_state=rng, format='lil')
    A[9] = A[3999] = 0
    A[11, :3000] = rng.normal(size=3000)
    A = A.tocoo()
    dup = rng.choice(A.nnz, 400, replace=False)
    M = tsp.from_coo(np.concatenate([A.row, A.row[dup]]),
                     np.concatenate([A.col, A.col[dup]]),
                     np.concatenate([A.data, rng.normal(size=400)]), 4000,
                     sum_duplicates=False, dtype=dtype, device=device)
    assert M.n_edges_padded > M.nnz == A.nnz + 400
    return M


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('s', [33, 64, 128, 200, 512])
def test_fused_entry_is_the_two_launches(cuda, dtype, s):
    """Kernel A's fused entry on the transpose bit-equal to its wide entry
    on the transpose plus ``csr_sddmm`` on the matrix (its cotangent taken
    back by the transpose's edge order), onto nonzero cotangents with the
    diagonal; the padding never written; two launches bit-equal, one
    launch a call; against the plain version in float64."""
    M = _fused_case(dtype, cuda)
    At, order = tsp._transpose(M)
    u, t = (_signal((4000, s), dtype, k, cuda) for k in (69, 70))
    out0 = torch.full_like(M.vals, 7.0)        # padding: never written
    out0[:M.nnz] = _signal((M.nnz,), dtype, 71, cuda)
    d0 = _signal((4000,), dtype, 72, cuda)
    alpha = torch.tensor(0.37, dtype=dtype, device=cuda)
    runs = []
    for _ in range(2):
        out_t, dg = out0[order], d0.clone()
        before = csr_kernel.csr_spmm_sddmm.launches
        y = csr_kernel.csr_spmm_sddmm(At.rowptr, At.cols, At.vals, u, t,
                                      out_t, alpha, dg)
        assert csr_kernel.csr_spmm_sddmm.launches == before + 1
        runs.append((y, torch.empty_like(out_t).index_copy_(0, order, out_t),
                     dg))
    out_a, d_a = out0.clone(), d0.clone()
    want = (csr_kernel.csr_spmm(At.rowptr, At.cols, At.vals, u,
                                entry='wide'), out_a, d_a)
    csr_kernel.csr_sddmm(M.rows, M.cols, u, t, out_a, alpha, d_a)
    for got, again, two in zip(runs[0], runs[1], want):
        assert torch.equal(got, again)
        assert torch.equal(got, two)
    assert bool((runs[0][1][M.nnz:] == 7.0).all())
    out_p, d_p = out0.double()[order], d0.double()
    y_p = csr_kernel.csr_spmm_sddmm_plain(
        At.rowptr, At.cols, At.vals.double(), u.double(), t.double(), out_p,
        alpha.double(), d_p)
    assert _rel_err(runs[0][0].double(), y_p) <= TOL[dtype]
    assert _rel_err(runs[0][1].double()[:M.nnz],
                    torch.empty_like(out_p).index_copy_(
                        0, order, out_p)[:M.nnz]) <= TOL[dtype]
    assert _rel_err(runs[0][2].double(), d_p) <= TOL[dtype]
    # without the diagonal: the same values
    out_t = out0[order]
    csr_kernel.csr_spmm_sddmm(At.rowptr, At.cols, At.vals, u, t, out_t,
                              alpha)
    assert torch.equal(torch.empty_like(out_t).index_copy_(0, order, out_t),
                       runs[0][1])


def test_fused_entry_refuses_what_it_does_not_take(cuda):
    """Widths the fused entry does not serve raise (the backward keeps its
    two launches there), and so does an operand that requires grad under
    grad mode."""
    M = _fused_case(torch.float32, cuda)
    At = M.T
    out = torch.zeros_like(M.vals)
    for s in (csr_kernel.NARROW_WIDTH[torch.float32],
              csr_kernel.SDDMM_WIDTH + 1):
        u, t = (_signal((4000, s), torch.float32, k, cuda) for k in (73, 74))
        with pytest.raises(ValueError, match='fused_width'):
            csr_kernel.csr_spmm_sddmm(At.rowptr, At.cols, At.vals, u, t, out,
                                      1.0)
    u, t = (_signal((4000, 40), torch.float32, k, cuda) for k in (75, 76))
    with pytest.raises(RuntimeError, match='cheby_op_fixed_graph'):
        csr_kernel.csr_spmm_sddmm(At.rowptr, At.cols, At.vals,
                                  u.requires_grad_(), t, out, 1.0)


def test_fused_weight_grads_on_the_card_match_the_cpu(cuda):
    """``cheby_op`` through W's values, c and x at 40 columns (the fused
    route: one ``csr_spmm_sddmm`` a step, no ``csr_sddmm``) and ``A @ x``
    through its values and x on the card against the CPU, float64."""
    W = tgsp.graphs.BarabasiAlbert(2000, seed=3, device='cpu').W
    rng = np.random.default_rng(77)
    c0, x0 = rng.normal(size=(3, 21)), rng.normal(size=(2000, 40))
    g0 = rng.normal(size=(3, 2000, 40))
    grads = []
    for device in (cuda, 'cpu'):
        M = tsp.from_scipy(W, dtype=torch.float64, device=device)
        w = M.vals.clone().requires_grad_()
        c = torch.tensor(c0, device=device, requires_grad=True)
        x = torch.tensor(x0, device=device, requires_grad=True)
        L = tgsp.core.operators.laplacian_op(M.with_vals(w))
        out = tgsp.ops.cheby_op(L, 2.05 * float(W.sum(1).max()), c, x)
        fused, sddmm = (csr_kernel.csr_spmm_sddmm.launches,
                        csr_kernel.csr_sddmm.launches)
        (out * torch.tensor(g0, device=device)).sum().backward()
        if device != 'cpu':
            assert csr_kernel.csr_spmm_sddmm.launches == fused + 20
            assert csr_kernel.csr_sddmm.launches == sddmm
        grads.append([v.grad.cpu() for v in (w, c, x)])
        v = M.vals.clone().requires_grad_()
        xx = torch.tensor(x0, device=device, requires_grad=True)
        (torch.tensor(g0[0], device=device)
         * tsp.spmm(M.with_vals(v), xx)).sum().backward()
        grads[-1] += [v.grad.cpu(), xx.grad.cpu()]
    for got, want in zip(*grads):
        assert float((got - want).abs().max()) <= 1e-10 * float(
            want.abs().max())
    assert not grads[0][0][M.nnz:].any()


def test_weight_grads_on_the_card_match_the_cpu(cuda):
    """``cheby_op`` through W's values (both Laplacian types), a tensor
    λmax, c and x on the card against the port on the CPU, float64, and
    ``L @ x`` through W; the SDDMM launched once a step."""
    W = tgsp.graphs.BarabasiAlbert(2000, seed=3, device='cpu').W
    rng = np.random.default_rng(66)
    c0, x0 = rng.normal(size=(3, 21)), rng.normal(size=(2000, 4))
    g0 = rng.normal(size=(3, 2000, 4))
    for lap_type, lmax in (('combinatorial', 2.05 * W.sum(1).max()),
                           ('normalized', 2.0)):
        grads = []
        for device in (cuda, 'cpu'):
            M = tsp.from_scipy(W, dtype=torch.float64, device=device)
            w = M.vals.clone().requires_grad_()
            c = torch.tensor(c0, device=device, requires_grad=True)
            x = torch.tensor(x0, device=device, requires_grad=True)
            lt = torch.tensor(float(lmax), dtype=torch.float64,
                              device=device, requires_grad=True)
            L = tgsp.core.operators.laplacian_op(M.with_vals(w), lap_type)
            out = tgsp.ops.cheby_op(L, lt, c, x)
            before = csr_kernel.csr_sddmm.launches
            (out * torch.tensor(g0, device=device)).sum().backward()
            if device != 'cpu':
                assert csr_kernel.csr_sddmm.launches == before + 20
            grads.append([t.grad.cpu() for t in (w, c, x, lt)])
            wx = M.vals.clone().requires_grad_()
            xx = torch.tensor(x0, device=device, requires_grad=True)
            Lx = tgsp.core.operators.laplacian_op(M.with_vals(wx), lap_type)
            (xx * (Lx @ xx)).sum().backward()
            grads[-1] += [wx.grad.cpu(), xx.grad.cpu()]
        for got, want in zip(*grads):
            scale = float(want.abs().max())
            assert float((got - want).abs().max()) <= 1e-10 * scale
        assert not grads[0][0][M.nnz:].any()


def test_weight_second_order_and_synthesis_refusal_on_the_card(cuda):
    """A Hessian-vector product through ``L @ x`` (W's values and x,
    ``create_graph=True``) on the card against the CPU's in float64; a
    synthesis through W's values differentiates on the card, its w̄
    against the CPU's in float64."""
    W = tgsp.graphs.BarabasiAlbert(2000, seed=3, device='cpu').W
    rng = np.random.default_rng(67)
    x0, dx0 = rng.normal(size=(2000, 3)), rng.normal(size=(2000, 3))
    dv0 = rng.normal(size=W.nnz)
    hvps = []
    for device in (cuda, 'cpu'):
        M = tsp.from_scipy(W, dtype=torch.float64, device=device)
        dv = torch.zeros_like(M.vals)
        dv[:M.nnz] = torch.from_numpy(dv0).to(device)
        v = M.vals.clone().requires_grad_()
        x = torch.tensor(x0, device=device, requires_grad=True)
        L = tgsp.core.operators.laplacian_op(M.with_vals(v), 'normalized')
        gv, gx = torch.autograd.grad(((L @ x) ** 2).sum(), (v, x),
                                     create_graph=True)
        dx = torch.tensor(dx0, device=device)
        hvps.append([h.cpu() for h in torch.autograd.grad(
            (gv * dv).sum() + (gx * dx).sum(), (v, x))])
    for got, want in zip(*hvps):
        assert float((got - want).abs().max()) <= 1e-10 * float(
            want.abs().max())
    w_bars = []
    for device in (cuda, 'cpu'):
        M = tsp.from_scipy(W, dtype=torch.float64, device=device)
        v = M.vals.clone().requires_grad_()
        L = tgsp.core.operators.laplacian_op(M.with_vals(v))
        c = torch.tensor(np.random.default_rng(68).normal(size=(2, 5)),
                         device=device)
        xs = torch.tensor(np.random.default_rng(69).normal(size=(2000, 3, 2)),
                          device=device)
        tgsp.ops.cheby_synthesis(L, 8.0, c, xs).backward(
            torch.tensor(dx0, device=device))
        w_bars.append(v.grad.cpu())
    assert float((w_bars[0] - w_bars[1]).abs().max()) <= 1e-10 * float(
        w_bars[1].abs().max())


@pytest.mark.parametrize('fmt', ['hybrid', 'chunked', 'windowed', 'banded'])
def test_format_spmm_and_synthesis_grads_on_the_card(cuda, fmt):
    """``L @ x`` (the leaves and x, a Hessian-vector product) and
    ``cheby_synthesis`` (the leaves, the diagonal, λmax, c and x) through
    each format's Functions on the card against the CPU's, in float64,
    within 1e-10 of the largest; the padding slots' cotangent exactly 0."""
    if fmt == 'banded':
        G = tgsp.graphs.Grid2d(40, 30, device='cpu', dtype=torch.float64)
        base = G.L.to_banded()
    else:
        G = tgsp.graphs.BarabasiAlbert(3000, seed=5, device='cpu',
                                       dtype=torch.float64)
        base = {'hybrid': G.L.to_hybrid, 'windowed': G.L.to_windowed,
                'chunked': lambda: G.L.to_chunked(permute='degree')}[fmt]()
    rng = np.random.default_rng(70)
    n = G.N
    x0, y0, d0 = (rng.normal(size=(n, 40)) for _ in range(3))
    xs0, ys0 = rng.normal(size=(n, 3, 2)), rng.normal(size=(n, 3))
    c0 = rng.normal(size=(2, 8))
    runs = []
    for device in (cuda, 'cpu'):
        off = _moved(base, device)
        leaves = [v.clone().requires_grad_() for v in off.offdiag.leaves()]
        diag = off.diag.clone().requires_grad_()
        L = tgsp.core.operators.LaplacianOp(
            offdiag=off.offdiag.with_leaves(leaves), diag=diag,
            lap_type=off.lap_type)
        x, y, d = (torch.tensor(a, device=device) for a in (x0, y0, d0))
        x.requires_grad_()
        first = torch.autograd.grad(((L @ x) ** 2 * y).sum(), leaves + [x],
                                    create_graph=True)
        hvp = torch.autograd.grad((first[-1] * d).sum(), leaves + [x])
        lt = torch.tensor(9.0, dtype=torch.float64, device=device,
                          requires_grad=True)
        c = torch.tensor(c0, device=device, requires_grad=True)
        xs = torch.tensor(xs0, device=device, requires_grad=True)
        syn = torch.autograd.grad(
            (tgsp.ops.cheby_synthesis(L, lt, c, xs)
             * torch.tensor(ys0, device=device)).sum(),
            leaves + [diag, lt, c, xs])
        runs.append([torch.cat([g.reshape(-1) for g in part]).cpu()
                     for part in (first, hvp, syn)])
    for got, want in zip(*runs):
        assert float((got - want).abs().max()) <= 1e-10 * float(
            want.abs().max())
    if fmt != 'banded':
        rows, cols, index = _internal_live(base.offdiag)
        k = sum(v.numel() for v in base.offdiag.leaves())
        dead = torch.ones(k, dtype=torch.bool)
        dead[index] = False
        assert not runs[0][0][:k][dead].any()
        assert not runs[0][2][:k][dead].any()


def _internal_live(off):
    if getattr(off, 'perm', None) is not None:
        off = dataclasses.replace(off, perm=None, iperm=None)
    return off.live_slots()


def _moved(v, device):
    """An operator (or any of its parts) with every tensor copied to
    ``device``: the same arrays, so the same matrix in the same layout."""
    if isinstance(v, torch.Tensor):
        return v.to(device)
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return dataclasses.replace(v, **{
            f.name: _moved(getattr(v, f.name), device)
            for f in dataclasses.fields(v) if f.init})
    if isinstance(v, tuple):
        parts = [_moved(w, device) for w in v]
        return type(v)(*parts) if hasattr(v, '_fields') else tuple(parts)
    return v


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_csr_kernel_hub_rows_among_empty_rows(cuda, dtype):
    """Three rows of 3,000 edges among 200,000 empty rows: the kernel's
    walk counts row ends as steps, so the empty rows are spread over its
    warps too."""
    A = sps.lil_matrix((200_000, 3000))
    rng = np.random.default_rng(13)
    for r in (0, 77_777, 199_999):
        A[r] = rng.normal(size=3000)
    M = tsp.from_scipy(A.tocsr(), dtype=dtype, device=cuda)
    x = _signal((3000, 128), dtype, 14, cuda)
    y = csr_kernel.csr_spmm(M.rowptr, M.cols, M.vals, x)
    want = csr_kernel.csr_spmm_plain(M.rowptr, M.cols, M.vals, x)
    assert _rel_err(y, want) <= TOL[dtype]
    assert int((y.abs().sum(1) > 0).sum()) == 3


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('s', [1, 5, 128, 200])
@pytest.mark.parametrize('offsets', [(0,), (1, 3), (1, 127, 200)])
def test_banded_kernel_matches_plain(cuda, dtype, s, offsets):
    n = 128 * 5 + 17                           # ragged last tile
    rng = np.random.default_rng(len(offsets) + s)
    A = sum(sps.diags(rng.normal(size=n - o), o) for o in offsets)
    A = (A + A.T).tocsr()
    B = tsp.banded_from_scipy(A, dtype=dtype, device=cuda)
    assert B.half_bw == -(-max(offsets) // 128)
    x = _signal((n, s), dtype, 2, cuda)
    before = banded_kernel.banded_spmm.launches
    y = banded_kernel.banded_spmm(B.tiles, x, n)
    assert banded_kernel.banded_spmm.launches == before + 1
    want = banded_kernel.banded_spmm_plain(B.tiles, x, n)
    assert y.shape == (n, s)
    err = _rel_err(y, want)
    print(f'banded {dtype} S={s} offsets={offsets}: rel err {err:.3e}')
    assert err <= TOL[dtype]


@pytest.mark.parametrize('s', [1, 5, 128, 200])
def test_banded_kernel_on_tiles_tf32_does_not_hold(cuda, s):
    """Grid2d tiles scaled by 2/7.93, as the recurrence scales them: unlike
    the integer tiles of a Grid2d Laplacian, not exact in TF32, so the
    small terms of both operands enter the f32 product."""
    G = tgsp.graphs.Grid2d(40, 37, device=cuda)
    tiles = G.L.to_banded().offdiag.tiles * (2.0 / 7.93)
    x = _signal((G.N, s), torch.float32, 3, cuda)
    y = banded_kernel.banded_spmm(tiles, x, G.N)
    err = _rel_err(y, banded_kernel.banded_spmm_plain(tiles, x, G.N))
    print(f'banded Grid2d tiles * 2/7.93 S={s}: rel err {err:.3e}')
    assert err <= TOL[torch.float32]


def test_wrappers_refuse_bad_cuda_operands(cuda):
    M = tsp.from_dense(np.eye(6) + np.eye(6, k=2), device=cuda)
    x = torch.zeros(6, 3, device=cuda)
    with pytest.raises(ValueError, match='one device'):
        csr_kernel.csr_spmm(M.rowptr.cpu(), M.cols, M.vals, x)
    with pytest.raises(ValueError, match='contiguous'):
        csr_kernel.csr_spmm(M.rowptr, M.cols, M.vals,
                            torch.zeros(3, 6, device=cuda).T)
    with pytest.raises(ValueError, match='one dtype'):
        csr_kernel.csr_spmm(M.rowptr, M.cols, M.vals, x.double())
    tiles = torch.zeros(1, 1, 128, 128, device=cuda)
    with pytest.raises(ValueError, match='one dtype'):
        banded_kernel.banded_spmm(tiles, x.half(), 6)
    with pytest.raises(ValueError, match='tile rows hold at most'):
        banded_kernel.banded_spmm(tiles, torch.zeros(200, 3, device=cuda),
                                  200)


def test_filter_on_the_card_matches_the_cpu(cuda):
    """The whole analysis path in f64 on the card against the CPU."""
    out = []
    for device in (cuda, 'cpu'):
        G = tgsp.graphs.BarabasiAlbert(700, m0=4, m=4, seed=5, device=device,
                                       dtype=torch.float64)
        G.estimate_lmax(method='bounds')
        g = tgsp.filters.Heat(G, [5.0, 50.0])
        s = np.random.default_rng(6).normal(size=(G.N, 3))
        csr = g.filter(s, order=30)
        Lb = tgsp.graphs.Grid2d(30, 23, device=device,
                                dtype=torch.float64).L.to_banded()
        x = torch.from_numpy(s[:690]).to(device)
        c = torch.ones(2, 12, dtype=torch.float64)
        band = tgsp.ops.cheby_op(Lb, 8.0, c, x)
        out.append((csr.cpu(), band.cpu()))
    (csr_gpu, band_gpu), (csr_cpu, band_cpu) = out
    assert torch.allclose(csr_gpu, csr_cpu, rtol=0, atol=1e-10)
    assert torch.allclose(band_gpu, band_cpu, rtol=0, atol=1e-10)


def _ba_windowed(dtype, device, **kw):
    """A weighted Barabási–Albert graph of 2^13 vertices, windowed."""
    n = 1 << 13
    src, tgt = tgsp.graphs.ba_edges_fast(n, m0=4, m=4, seed=3)
    w = np.random.default_rng(3).uniform(0.5, 1.5, len(src))
    W = sps.csr_matrix((np.concatenate([w, w]), (np.concatenate([src, tgt]),
                                                 np.concatenate([tgt, src]))),
                       shape=(n, n))
    return W, twd.windowed_from_scipy(W, dtype=dtype, device=device, **kw)


WINDOWED_CASES = {
    'default': dict(),
    'P256': dict(window_rows=256),               # S tile 64, int32 row ids
    'span4': dict(chunk_rows=2048, borrow_span=4, slab_width=120),
    'P256span4': dict(window_rows=256, borrow_span=4),  # K·P = 1024
}


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('s', [1, 5, 128, 129, 300])
@pytest.mark.parametrize('case', list(WINDOWED_CASES))
def test_windowed_kernels_match_plain(cuda, dtype, s, case):
    _, M = _ba_windowed(dtype, cuda, **WINDOWED_CASES[case])
    kp = M.borrow_span * M.window_rows
    x = _signal((M.n_cols, s), dtype, s, cuda)
    before = (wk.windowed_fold.launches, wk.window_strip.launches)
    t = wk.windowed_fold(M.cols, M.vals, M.rowid, x, M.chunk_rows, kp)
    y = wk.window_strip(t, M.n_rows, M.window_rows, M.residue, x)
    assert (wk.windowed_fold.launches, wk.window_strip.launches) == (
        before[0] + 1, before[1] + 1)
    t_plain = wk.windowed_fold_plain(M.cols, M.vals, M.rowid, x,
                                     M.chunk_rows, kp)
    assert t.shape == t_plain.shape and y.shape == (M.n_rows, s)
    assert _rel_err(t, t_plain) <= TOL[dtype]
    assert _rel_err(y, wk.window_strip_plain(t_plain, M.n_rows,
                                             M.window_rows, M.residue,
                                             x)) <= TOL[dtype]
    assert _rel_err(wk.window_strip_plain(t, M.n_rows, M.window_rows,
                                          M.residue, x),
                    y) == 0.0                    # same sums, same order


# ---------------------------------------------------------------------------
# the tail: window_strip with the residue list
# ---------------------------------------------------------------------------

# (x dtype, values dtype): the fold's pairs, each an instance of the tail
TAIL_PAIRS = {'f32': (torch.float32, torch.float32),
              'f64': (torch.float64, torch.float64),
              'bf16': (torch.bfloat16, torch.bfloat16),
              'bf16-f32': (torch.bfloat16, torch.float32),
              'f32-bf16': (torch.float32, torch.bfloat16)}
TAIL_CASES = {'K2': dict(chunk_rows=1024),
              'K4': dict(chunk_rows=2048, borrow_span=4, slab_width=120),
              'P256': dict(chunk_rows=1024, window_rows=256)}


def _hub_graph(n=(1 << 13) + 77, hubs=(7, 8, (1 << 13) + 70), seed=3,
               empty_cols=()):
    """A weighted Barabási–Albert graph with a ragged last chunk and three
    hub rows (two in one window, one in the last chunk) whose residue
    entries repeat across the tiers of every source chunk: heavy rows.
    ``empty_cols``: vertices left without edges."""
    src, tgt = tgsp.graphs.ba_edges_fast(n, m0=4, m=4, seed=seed)
    rng = np.random.default_rng(seed)
    for h in hubs:
        nb = np.flatnonzero(rng.random(n) < 0.3)
        src = np.concatenate([src, np.full(nb.size, h)])
        tgt = np.concatenate([tgt, nb])
    keep = (src != tgt) & ~np.isin(src, empty_cols) & ~np.isin(tgt,
                                                               empty_cols)
    src, tgt = src[keep], tgt[keep]
    w = rng.uniform(0.5, 1.5, len(src))
    W = sps.csr_matrix((np.concatenate([w, w]), (np.concatenate([src, tgt]),
                                                 np.concatenate([tgt, src]))),
                       shape=(n, n))
    W.sum_duplicates()
    return W


def _tail_check(y, want, dtype):
    """The kernel's y against the plain version's: float32/float64 within
    TOL (relative), bf16 within one ulp (both sum in one order and round
    alike, so they are expected to agree bit for bit)."""
    if dtype == torch.bfloat16:
        return _ulps(y, want) <= 1.0
    return _rel_err(y, want) <= TOL[dtype]


@pytest.mark.parametrize('levels', [True, False], ids=['levels', 'strip'])
@pytest.mark.parametrize('s', [3, 128, 600])
@pytest.mark.parametrize('case', list(TAIL_CASES))
@pytest.mark.parametrize('pair', list(TAIL_PAIRS))
def test_window_tail_matches_plain(cuda, pair, case, s, levels):
    """The tail against its plain version, K = 2 and 4, P = 64 and 256,
    S = 3 (one value a lane), 128 and 600 (a heavy row's two column
    passes), heavy rows among ordinary ones, the ragged last chunk; two
    launches bit-equal."""
    xd, vd = TAIL_PAIRS[pair]
    W = _hub_graph()
    wide = torch.float64 if xd == torch.float64 else torch.float32
    M = twd.windowed_from_scipy(W, dtype=wide, device=cuda,
                                **TAIL_CASES[case]).astype(vd)
    assert M.n_cols % M.chunk_rows and M.residue.heavy.numel() >= 3
    kp = M.borrow_span * M.window_rows
    x = _signal((M.n_cols, s), wide, s, cuda).to(xd)
    t = wk.windowed_fold(M.cols, M.vals, M.rowid, x, M.chunk_rows, kp)
    residue = M.residue if levels else None
    before = wk.window_strip.launches
    y = wk.window_strip(t, M.n_rows, M.window_rows, residue, x)
    assert wk.window_strip.launches == before + 1
    assert y.dtype == xd and y.shape == (M.n_rows, s)
    want = wk.window_strip_plain(t, M.n_rows, M.window_rows, residue, x)
    assert _tail_check(y, want, xd)
    assert torch.equal(y, wk.window_strip(t, M.n_rows, M.window_rows,
                                          residue, x))


@pytest.mark.parametrize('pair', list(TAIL_PAIRS))
def test_window_tail_unaligned_rows_take_the_scalar_path(cuda, pair):
    """x and t one value off a 16-byte boundary: the same kernel with one
    value a lane, which sums alike, so y is bit-equal to the aligned
    launch's."""
    xd, vd = TAIL_PAIRS[pair]
    W = _hub_graph()
    wide = torch.float64 if xd == torch.float64 else torch.float32
    M = twd.windowed_from_scipy(W, dtype=wide, device=cuda,
                                chunk_rows=1024).astype(vd)
    kp = M.borrow_span * M.window_rows
    x = _signal((M.n_cols, 128), wide, 4, cuda).to(xd)
    t = wk.windowed_fold(M.cols, M.vals, M.rowid, x, M.chunk_rows, kp)

    def shifted(a):
        buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=cuda)
        out = buf[1:].view(a.shape)
        out.copy_(a)
        assert out.data_ptr() % 16
        return out

    y = wk.window_strip(t, M.n_rows, M.window_rows, M.residue, x)
    y_off = wk.window_strip(shifted(t), M.n_rows, M.window_rows, M.residue,
                            shifted(x))
    assert torch.equal(y, y_off)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_window_tail_keeps_inf_of_dead_slots_out(cuda, dtype):
    """The last x row of each source chunk (where the JAX package's gather
    clamps a dead tier slot) holds inf and no live slot points at it: y
    stays finite and matches the plain version; in float32 the SpMM
    matches SciPy. (In bf16 a hub row adds hundreds of entries in bf16,
    as the JAX package's index_add does, so only the plain version is its
    reference.)"""
    R, n = 1024, (1 << 13) + 77
    clamp = [min((c + 1) * R, n) - 1 for c in range(-(-n // R))]
    W = _hub_graph(empty_cols=clamp)
    M = twd.windowed_from_scipy(W, dtype=torch.float32, device=cuda,
                                chunk_rows=R, permute=None)
    assert sum(lev.cols.numel() for lev in M.levels) > M.residue.cols.numel()
    x = _signal((n, 128), torch.float32, 5, cuda)
    x[clamp] = float('inf')
    M, x = M.astype(dtype), x.to(dtype)
    t = wk.windowed_fold(M.cols, M.vals, M.rowid, x, R,
                         M.borrow_span * M.window_rows)
    y = wk.window_strip(t, M.n_rows, M.window_rows, M.residue, x)
    assert bool(torch.isfinite(y).all())
    want = wk.window_strip_plain(t, M.n_rows, M.window_rows, M.residue, x)
    assert _tail_check(y, want, dtype)
    if dtype == torch.float32:
        ref = W @ np.where(np.isfinite(x.cpu().numpy()), x.cpu().numpy(),
                           0.0)
        got = (M @ x).cpu().numpy()
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_windowed_fold_is_deterministic(cuda, dtype):
    """Each row sums in slot order: two launches give bit-equal t."""
    _, M = _ba_windowed(dtype, cuda)
    kp = M.borrow_span * M.window_rows
    x = _signal((M.n_cols, 128), dtype, 8, cuda)
    args = (M.cols, M.vals, M.rowid, x, M.chunk_rows, kp)
    assert torch.equal(wk.windowed_fold(*args), wk.windowed_fold(*args))


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('kp,s', [(64, 1), (128, 128), (256, 5), (512, 300),
                                  (1024, 128)])
def test_fold_layout_bytes_are_the_kernels(cuda, dtype, kp, s):
    """The shared memory the wrapper budgets is what the kernel asks for."""
    lay = wk.fold_layout(kp, s, torch.empty(0, dtype=dtype).element_size())
    fn = getattr(_cuda.library('windowed_fold'),
                 f'windowed_fold_smem_bytes_{wk._DTYPES[dtype]}')
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    assert fn(kp, lay.s_tile, lay.ring, lay.queue) == lay.smem_bytes


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('rid_dtype', [torch.uint8, torch.int32])
@pytest.mark.parametrize('s', [1, 128, 300])
def test_windowed_fold_skips_mostly_dead_slots(cuda, dtype, rid_dtype, s):
    """Slabs whose slots are 95 % dead (sentinel column, column past x,
    row id past K·P): the live-slot queue refills many times per window."""
    rng = np.random.default_rng(9)
    n_out, nw, n_src, L, R, kp = 2, 5, 3, 300, 64, 128
    n_cols = n_src * R - 10                     # ragged last source chunk
    shape = (n_out, nw, n_src, L)
    cols = np.full(shape, R, np.int32)
    rowid = rng.integers(0, kp, size=shape)
    live = rng.random(shape) < 0.05
    cols[live] = rng.integers(0, R, size=int(live.sum()))
    cols[rng.random(shape) < 0.01] = R - 1      # dead past x in chunk 2
    if rid_dtype == torch.int32:
        rowid[rng.random(shape) < 0.01] = kp + 7
    x = _signal((n_cols, s), dtype, 10, cuda)
    args = (torch.from_numpy(cols).to(cuda),
            _signal(shape, dtype, 11, cuda),
            torch.from_numpy(rowid).to(cuda, rid_dtype), x, R, kp)
    t = wk.windowed_fold(*args)
    want = wk.windowed_fold_plain(*args)
    assert _rel_err(t, want) <= TOL[dtype]


def test_windowed_spmm_and_bank_on_the_card_match_the_cpu(cuda):
    """The whole SpMM (levels included) and a Chebyshev bank in f64."""
    W, M = _ba_windowed(torch.float64, cuda)
    assert M.levels, 'no residue tiers on this graph'
    x = np.random.default_rng(4).normal(size=(W.shape[0], 7))
    y = (M @ torch.from_numpy(x).to(cuda)).cpu().numpy()
    assert np.abs(y - W @ x).max() <= 1e-11 * np.abs(W @ x).max()
    out = []
    for device in (cuda, 'cpu'):
        G = tgsp.graphs.Graph(W, device=device, dtype=torch.float64)
        G.compute_laplacian(fmt='windowed')
        G.estimate_lmax(method='bounds')
        out.append(tgsp.filters.Heat(G, [5.0, 50.0]).filter(x, order=30).cpu())
    assert torch.allclose(out[0], out[1], rtol=0, atol=1e-10)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('nw,lt,kp', [(1, 512, 256), (64, 1152, 256),
                                      (3, 100, 40), (300, 100, 256)],
                         ids=['3', '2', 'ragged', 'rows256'])
def test_fold_products_matches_plain(cuda, dtype, nw, lt, kp):
    rng = np.random.default_rng(lt)
    rid = torch.from_numpy(rng.integers(-1, kp + 1, size=(nw, lt))
                           .astype(np.int32)).to(cuda)   # some dead ids
    p = _signal((nw, lt, 128), torch.float32, 5, cuda).to(dtype)
    before = wk.fold_products.launches
    out = wk.fold_products(rid, p, kp)
    assert wk.fold_products.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == (nw, kp, 128)
    assert _rel_err(out, wk.fold_products_plain(rid, p, kp)) <= 1e-6


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('s', [1, 5, 128, 129])
@pytest.mark.parametrize('nw', [1, 64, 3])
def test_fold_products_ragged_with_dead_inf_slots(cuda, nw, s, dtype):
    """KP = 40 and Lt = 100 (neither a whole tile), dead ids below 0 and
    at or past KP, and dead slots whose product is inf: they add nothing.
    Two launches bit-equal."""
    kp, lt = 40, 100
    rng = np.random.default_rng(nw * 1000 + s)
    rid = rng.integers(0, kp, size=(nw, lt))
    dead = rng.random((nw, lt)) < 0.2
    rid[dead] = rng.choice([-7, -1, kp, kp + 5], size=int(dead.sum()))
    p = _signal((nw, lt, s), torch.float32, 12, cuda)
    p[torch.from_numpy(dead).to(cuda) & (torch.rand(nw, lt, device=cuda)
                                         < 0.5)] = float('inf')
    rid = torch.from_numpy(rid.astype(np.int32)).to(cuda)
    p = p.to(dtype)
    out = wk.fold_products(rid, p, kp)
    want = wk.fold_products_plain(rid, p, kp)
    assert out.shape == (nw, kp, s) and bool(torch.isfinite(out).all())
    assert _rel_err(out, want) <= 1e-6
    assert torch.equal(out, wk.fold_products(rid, p, kp))


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_products_layout_bytes_are_the_kernels(cuda, dtype):
    lay = wk.products_layout(1, 256, 128, torch.empty(
        0, dtype=dtype).element_size())
    fn = getattr(_cuda.library('windowed_fold'),
                 f'fold_products_smem_bytes_{wk._PRODUCTS[dtype]}')
    fn.argtypes = []
    fn.restype = ctypes.c_int
    assert fn() == lay.smem_bytes


@pytest.mark.parametrize('shape', [(8, 128), (1000, 3)])
def test_double_matches_plain(cuda, shape):
    x = _signal(shape, torch.float32, 6, cuda)
    before = wk.double.launches
    assert torch.equal(wk.double(x), wk.double_plain(x))
    assert wk.double.launches == before + 1


def test_windowed_wrappers_refuse_bad_cuda_operands(cuda):
    _, M = _ba_windowed(torch.float32, cuda)
    x = torch.zeros(M.n_cols, 3, device=cuda)
    with pytest.raises(ValueError, match='one device'):
        wk.windowed_fold(M.cols.cpu(), M.vals, M.rowid, x, M.chunk_rows, 128)
    with pytest.raises(ValueError, match='one dtype'):
        wk.windowed_fold(M.cols, M.vals, M.rowid, x.double(), M.chunk_rows,
                         128)
    with pytest.raises(ValueError, match='does not fit'):
        wk.windowed_fold(M.cols, M.vals, M.rowid, x, M.chunk_rows, 1 << 16)
    with pytest.raises(ValueError, match='contiguous'):
        wk.fold_products(torch.zeros(4, 2, dtype=torch.int32, device=cuda).T,
                         torch.zeros(2, 4, 8, device=cuda), 4)


# ---------------------------------------------------------------------------
# the bf16 instances of the windowed kernels (the recurrence's fast modes)
# ---------------------------------------------------------------------------

# (x dtype, values dtype): a bf16 carry alone, both, bf16 values alone
BF16_FOLDS = {'carry': (torch.bfloat16, torch.float32),
              'both': (torch.bfloat16, torch.bfloat16),
              'vals': (torch.float32, torch.bfloat16)}


def _ulps(got, want):
    """The largest |got - want| in bf16 ulps of the larger of the two at
    each element, counted at 2^-8 of the largest |want| at least: a sum
    that cancels to near zero carries the f32 rounding of its addends,
    which two summation orders do not share."""
    got, want = got.float(), want.float()
    mag = torch.maximum(got.abs(), want.abs()).clamp(
        min=float(want.abs().max()) * 2.0**-8 + 1e-30)
    return float(((got - want).abs()
                  / torch.exp2(torch.floor(torch.log2(mag)) - 7)).max())


@pytest.mark.parametrize('combo', list(BF16_FOLDS))
@pytest.mark.parametrize('s', [1, 8, 128, 136])
@pytest.mark.parametrize('case', list(WINDOWED_CASES))
def test_bf16_windowed_kernels_match_plain(cuda, combo, s, case):
    """The fold's sums are float32 in both: the kernel's t and the plain
    version's differ by at most the one rounding of each sum (1 ulp where
    bf16 is written). The strip sums the same addends in the same order:
    bit-equal."""
    xd, vd = BF16_FOLDS[combo]
    _, M = _ba_windowed(torch.float32, cuda, **WINDOWED_CASES[case])
    M = M.astype(vd)
    kp = M.borrow_span * M.window_rows
    x = _signal((M.n_cols, s), torch.float32, s, cuda).to(xd)
    args = (M.cols, M.vals, M.rowid, x, M.chunk_rows, kp)
    before = wk.windowed_fold.launches
    t = wk.windowed_fold(*args)
    assert wk.windowed_fold.launches == before + 1 and t.dtype == xd
    t_plain = wk.windowed_fold_plain(*args)
    if xd == torch.bfloat16:
        assert _ulps(t, t_plain) <= 1.0
    else:
        assert _rel_err(t, t_plain) <= TOL[torch.float32]
    assert torch.equal(t, wk.windowed_fold(*args))
    y = wk.window_strip(t, M.n_rows, M.window_rows, M.residue, x)
    assert y.dtype == xd
    assert torch.equal(y, wk.window_strip_plain(t, M.n_rows, M.window_rows,
                                                M.residue, x))


@pytest.mark.parametrize('kp,s', [(64, 1), (128, 128), (256, 5), (512, 300),
                                  (1024, 128)])
def test_bf16_fold_layout_bytes_are_the_kernels(cuda, kp, s):
    lay = wk.fold_layout(kp, s, 4, 2)
    fn = getattr(_cuda.library('windowed_fold'),
                 'windowed_fold_smem_bytes_bf16')
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    assert fn(kp, lay.s_tile, lay.ring, lay.queue) == lay.smem_bytes


def test_bf16_bank_on_the_card_matches_the_cpu(cuda):
    """The fast mode (bf16 carry and values) on the card against the same
    bank on the CPU, within the carry bound of each other."""
    W, _ = _ba_windowed(torch.float32, 'cpu')
    out = []
    for device in (cuda, 'cpu'):
        G = tgsp.graphs.Graph(W, device=device)
        G.compute_laplacian(fmt='windowed')
        G.estimate_lmax(method='bounds')
        g = tgsp.filters.Heat(G, [5.0, 50.0])
        x = np.random.default_rng(5).normal(size=(G.N, 16)).astype(np.float32)
        out.append(g.filter(x, order=30, carry_dtype=torch.bfloat16,
                            vals_dtype=torch.bfloat16).cpu())
        c = cheby_coeff(g.evaluate, G.lmax, m=30, device='cpu')
    est = carry_error_estimate(c, torch.bfloat16)
    assert _rel_err(out[0], out[1]) <= 2 * est


# ---------------------------------------------------------------------------
# kernel B, the fused Chebyshev step
# ---------------------------------------------------------------------------

# (signal dtype, carry dtype) of its three instances
CHEBY_TYPES = [(torch.float32, torch.float32), (torch.float64, torch.float64),
               (torch.float32, torch.bfloat16)]
CHEBY_SHAPES = [(1000, 128, 4), (333, 5, 1), (77, 3, 6)]


@pytest.mark.parametrize('md,cd', CHEBY_TYPES)
@pytest.mark.parametrize('n,s,nf', CHEBY_SHAPES)
def test_cheby_step_is_bit_equal_to_plain(cuda, md, cd, n, s, nf):
    """Each operation rounded once, in the plain version's order (no FMA):
    bit-equal, also into a given ``out`` and on a misaligned view (the
    one-value route)."""
    y, t, t_old = (_signal((n, s), torch.float32, k, cuda).to(cd)
                   for k in range(3))
    fd = _signal((n,), md, 3, cuda)
    sc = torch.tensor(0.731, dtype=md, device=cuda)
    before = cheby_kernel.cheby_step.launches
    out = cheby_kernel.cheby_step(y, t, t_old, fd, sc)
    assert cheby_kernel.cheby_step.launches == before + 1
    want = cheby_kernel.cheby_step_plain(y, t, t_old, fd, sc,
                                         torch.empty_like(t))
    assert out.dtype == cd and torch.equal(out, want)
    given = torch.empty_like(t)
    assert cheby_kernel.cheby_step(y, t, t_old, fd, sc, given) is given
    assert torch.equal(given, want)
    # one value past a 16-byte boundary: the kernel's one-value route
    flat = torch.empty(n * s + 1, dtype=cd, device=cuda)
    view = flat[1:].view(n, s)
    cheby_kernel.cheby_step(y, t, t_old, fd, sc, view)
    assert torch.equal(view, want)


@pytest.mark.parametrize('md,cd', CHEBY_TYPES)
@pytest.mark.parametrize('n,s,nf', CHEBY_SHAPES)
@pytest.mark.parametrize('g,start', [(1, 0), (3, 4), (14, 9)])
def test_cheby_acc_group_is_bit_equal_to_plain(cuda, md, cd, n, s, nf, g,
                                               start):
    """A group of g terms from a ring of g + 2, wrapping past its end."""
    ring = _signal((g + 2, n, s), torch.float32, 20, cuda).to(cd)
    acc = _signal((nf, n, s), md, 21, cuda)
    cg = _signal((g, nf), md, 22, cuda)
    acc_plain = acc.clone()
    before = cheby_kernel.cheby_acc_group.launches
    cheby_kernel.cheby_acc_group(acc, ring, cg, start)
    assert cheby_kernel.cheby_acc_group.launches == before + 1
    cheby_kernel.cheby_acc_group_plain(acc_plain, ring, cg, start)
    assert torch.equal(acc, acc_plain)


@pytest.mark.parametrize('md,cd', CHEBY_TYPES)
@pytest.mark.parametrize('nf', [1, 4, 5, 6, 100, 500])
@pytest.mark.parametrize('g', [1, 13, 14])
def test_cheby_acc_group_any_filter_count_is_bit_equal(cuda, md, cd, nf, g):
    """The group's one pass over its terms for any Nf (the filters taken
    four at a time), bit-equal to the plain version; and a group above
    the kernel's 14 terms (the tests' override of the group rule), which
    takes the passes of four filters."""
    n, s = 513, 12
    ring = _signal((g + 2, n, s), torch.float32, 23, cuda).to(cd)
    acc = _signal((nf, n, s), md, 24, cuda)
    cg = _signal((g, nf), md, 25, cuda)
    acc_plain = acc.clone()
    cheby_kernel.cheby_acc_group(acc, ring, cg, g + 1)
    cheby_kernel.cheby_acc_group_plain(acc_plain, ring, cg, g + 1)
    assert torch.equal(acc, acc_plain)
    if g == 14:
        ring = _signal((20, n, s), torch.float32, 26, cuda).to(cd)
        cg = _signal((17, nf), md, 27, cuda)
        acc_plain = acc.clone()
        cheby_kernel.cheby_acc_group(acc, ring, cg, 5)
        cheby_kernel.cheby_acc_group_plain(acc_plain, ring, cg, 5)
        assert torch.equal(acc, acc_plain)


@pytest.mark.parametrize('md,cd', CHEBY_TYPES)
@pytest.mark.parametrize('n,s,nf', CHEBY_SHAPES)
def test_cheby_acc_contract_is_bit_equal_to_plain(cuda, md, cd, n, s, nf):
    t = _signal((n, s, nf), torch.float32, 30, cuda).to(cd)
    acc = _signal((n, s), md, 31, cuda)
    ck = _signal((nf,), md, 32, cuda)
    acc_plain = acc.clone()
    before = cheby_kernel.cheby_acc_contract.launches
    cheby_kernel.cheby_acc_contract(acc, t, ck)
    assert cheby_kernel.cheby_acc_contract.launches == before + 1
    cheby_kernel.cheby_acc_contract_plain(acc_plain, t, ck)
    assert torch.equal(acc, acc_plain)


def test_cheby_kernels_refuse_a_pair_they_lack(cuda):
    t = torch.zeros(8, 4, dtype=torch.float32, device=cuda)
    fd = torch.zeros(8, dtype=torch.float64, device=cuda)
    sc = torch.ones((), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match='has no kernel'):
        cheby_kernel.cheby_step(t, t, t, fd, sc)


def test_synthesis_on_the_card_matches_the_cpu(cuda):
    """cheby_synthesis through kernel B's step and contraction, in f64."""
    W, _ = _ba_windowed(torch.float64, 'cpu')
    out = []
    for device in (cuda, 'cpu'):
        G = tgsp.graphs.Graph(W, device=device, dtype=torch.float64)
        G.compute_laplacian(fmt='windowed')
        G.estimate_lmax(method='bounds')
        g = tgsp.filters.Heat(G, [5.0, 20.0, 50.0])
        s = np.random.default_rng(7).normal(size=(G.N, 2, 3))
        out.append(g.synthesize(s, order=20).cpu())
    assert torch.allclose(out[0], out[1], rtol=0, atol=1e-10)


# ---------------------------------------------------------------------------
# kernel B's coefficient gradient, and the training path on the card
# ---------------------------------------------------------------------------

DOT_SHAPES = [(1000, 128), (333, 5), (77, 3), (41,)]


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('shape', DOT_SHAPES)
@pytest.mark.parametrize('nf', [1, 2, 3, 4, 6])
@pytest.mark.parametrize('g,start', [(1, 0), (3, 4), (14, 9), (17, 2)])
def test_cheby_dot_group_matches_plain(cuda, dtype, shape, nf, g, start):
    """Within the summation bound of a float64 reference, and bit-equal
    across two launches; groups that wrap, more than 16 terms (two passes),
    more than 4 filters and odd widths (the one-value route)."""
    ring = _signal((g + 2,) + shape, dtype, 40, cuda)
    gbar = _signal(shape + (nf,), dtype, 41, cuda)
    out = torch.empty((g, nf), dtype=dtype, device=cuda)
    before = cheby_kernel.cheby_dot_group.launches
    cheby_kernel.cheby_dot_group(out, gbar, ring, start)
    assert cheby_kernel.cheby_dot_group.launches == before + 1
    want = cheby_kernel.cheby_dot_group_plain(
        torch.empty((g, nf), dtype=torch.float64, device=cuda),
        gbar.double(), ring.double(), start)
    bound = cheby_kernel.cheby_dot_group_bound(gbar, ring, start, g, dtype)
    assert bool(((out.double() - want).abs() <= bound).all())
    again = torch.empty_like(out)
    cheby_kernel.cheby_dot_group(again, gbar, ring, start)
    assert torch.equal(out, again)


def test_cheby_dot_group_off_a_16_byte_boundary(cuda):
    """A cotangent bank one value past an aligned address takes the
    one-value route and gives the same sums within the bound."""
    n, s, nf, g = 500, 8, 4, 5
    ring = _signal((g, n, s), torch.float32, 42, cuda)
    flat = torch.empty(n * s * nf + 1, dtype=torch.float32, device=cuda)
    gbar = flat[1:].view(n, s, nf)
    gbar.copy_(_signal((n, s, nf), torch.float32, 43, cuda))
    out = cheby_kernel.cheby_dot_group(
        torch.empty((g, nf), dtype=torch.float32, device=cuda), gbar, ring)
    want = cheby_kernel.cheby_dot_group_plain(
        torch.empty((g, nf), dtype=torch.float64, device=cuda),
        gbar.double(), ring.double())
    bound = cheby_kernel.cheby_dot_group_bound(gbar, ring, 0, g,
                                               torch.float32)
    assert bool(((out.double() - want).abs() <= bound).all())


def _requires_grad(t):
    return t.detach().clone().requires_grad_()


def test_every_kernel_route_refuses_autograd(cuda):
    """A CUDA operand that requires grad raises on each wrapper under grad
    mode, and the same call runs under torch.no_grad()."""
    f32 = torch.float32
    A = tsp.from_scipy(sps.random(50, 40, density=0.1, random_state=1,
                                  format='csr'), dtype=f32, device=cuda)
    At = tsp._transpose(A)[0]
    x = _signal((40, 3), f32, 50, cuda)
    _, M = _ba_windowed(f32, cuda)
    kp = M.borrow_span * M.window_rows
    xw = _signal((M.n_cols, 4), f32, 51, cuda)
    t = wk.windowed_fold(M.cols, M.vals, M.rowid, xw, M.chunk_rows, kp)
    y, tt = (_signal((64, 4), f32, k, cuda) for k in (52, 53))
    fd = _signal((64,), f32, 54, cuda)
    sc = torch.ones((), dtype=f32, device=cuda)
    acc = _signal((2, 64, 4), f32, 55, cuda)
    ring = _signal((3, 64, 4), f32, 56, cuda)
    rid = torch.zeros((1, 32), dtype=torch.int32, device=cuda)
    p = _signal((1, 32, 8), f32, 57, cuda)
    tiles = torch.zeros((1, 3, 128, 128), dtype=f32, device=cuda)
    calls = {
        'csr_spmm': lambda r: csr_kernel.csr_spmm(A.rowptr, A.cols, A.vals,
                                                  r(x)),
        'csr_sddmm': lambda r: csr_kernel.csr_sddmm(
            A.rows, A.cols, _signal((50, 3), f32, 60, cuda), r(x),
            torch.zeros_like(A.vals), 1.0),
        'csr_spmm_sddmm': lambda r: csr_kernel.csr_spmm_sddmm(
            At.rowptr, At.cols, At.vals, r(_signal((50, 40), f32, 61, cuda)),
            _signal((40, 40), f32, 62, cuda), torch.zeros_like(A.vals), 1.0),
        'banded_spmm': lambda r: banded_kernel.banded_spmm(
            r(tiles), _signal((128, 3), f32, 58, cuda), 128),
        'windowed_fold': lambda r: wk.windowed_fold(
            M.cols, M.vals, M.rowid, r(xw), M.chunk_rows, kp),
        'window_strip': lambda r: wk.window_strip(
            r(t), M.n_rows, M.window_rows, M.residue, xw),
        'fold_products': lambda r: wk.fold_products(rid, r(p), 16),
        'double': lambda r: wk.double(r(x)),
        'cheby_step': lambda r: cheby_kernel.cheby_step(y, r(tt), tt, fd, sc),
        'cheby_acc_group': lambda r: cheby_kernel.cheby_acc_group(
            r(acc), ring, _signal((3, 2), f32, 59, cuda)),
        'cheby_acc_contract': lambda r: cheby_kernel.cheby_acc_contract(
            r(acc[0]), ring.permute(1, 2, 0)[..., :2].contiguous(),
            fd[:2]),
        'cheby_dot_group': lambda r: cheby_kernel.cheby_dot_group(
            torch.empty((2, 2), dtype=f32, device=cuda),
            r(acc.permute(1, 2, 0)).contiguous(), ring),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match='cheby_op_fixed_graph'):
            call(_requires_grad)
        with torch.no_grad():
            call(_requires_grad)
    torch.cuda.synchronize()


def test_filter_refuses_autograd_and_fixed_graph_trains_on_the_card(cuda):
    """``g.filter(x)`` with x requiring grad runs on the card on the
    windowed format (the bank's own backward, on the CSR view of its
    slots), its x̄ and the kernel parameter's cotangent equal to
    ``fixed_graph=True``'s within 1e-10; with ``fixed_graph=True`` the
    gradients match the CPU's."""
    W, _ = _ba_windowed(torch.float64, 'cpu')
    x0 = np.random.default_rng(5).normal(size=(W.shape[0], 3))
    w = np.random.default_rng(6).normal(size=(W.shape[0], 3, 2))
    grads = []
    for device in (cuda, 'cpu'):
        G = tgsp.graphs.Graph(W, device=device, dtype=torch.float64)
        G.compute_laplacian(fmt='windowed')
        G.estimate_lmax(method='bounds')
        tau = torch.tensor([3.0, 20.0], dtype=torch.float64, device=device,
                           requires_grad=True)
        g = tgsp.filters.Filter(G, [
            lambda lam, i=i: torch.exp(-tau[i] * lam / G.lmax)
            for i in range(2)])
        x = torch.tensor(x0, device=device, requires_grad=True)
        if device != 'cpu':
            wt = torch.tensor(w, device=device)
            bank = torch.autograd.grad((g.filter(x, order=20) * wt).sum(),
                                       (tau, x))
            fixed = torch.autograd.grad(
                (g.filter(x, order=20, fixed_graph=True) * wt).sum(),
                (tau, x))
            for got, want in zip(bank, fixed):
                assert torch.allclose(got, want, rtol=0, atol=1e-10)
        out = g.filter(x, order=20, fixed_graph=True)
        (out * torch.tensor(w, device=device)).sum().backward()
        grads.append((tau.grad.cpu(), x.grad.cpu()))
    for got, want in zip(*grads):
        assert torch.allclose(got, want, rtol=0, atol=1e-10)


# ---------------------------------------------------------------------------
# the difference operator on kernel A, the filter zoo, LOBPCG
# ---------------------------------------------------------------------------

def _difference_pair(cuda, dtype, lap_type, directed=False):
    rng = np.random.default_rng(11)
    W = sps.random(600, 600, density=0.02, random_state=rng, format='csr')
    W = W + sps.diags(np.ones(599), 1)
    if not directed:
        W = W + W.T
    W.setdiag(0)
    W.eliminate_zeros()
    pair = []
    for device in (cuda, 'cpu'):
        G = tgsp.graphs.Graph(W, lap_type=lap_type, device=device,
                              dtype=dtype)
        G.compute_differential_operator()
        pair.append(G)
    return pair


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('lap_type,directed', [('combinatorial', False),
                                               ('normalized', False),
                                               ('normalized', True)])
@pytest.mark.parametrize('shape', [(), (7,), (130,), (2, 3)])
def test_grad_and_div_launch_kernel_a_once(cuda, dtype, lap_type, directed,
                                           shape):
    """grad and div on the card: one csr_spmm launch each, no plain
    version, against the CPU's plain products; two launches bit-equal."""
    Gc, Gh = _difference_pair(cuda, dtype, lap_type, directed)
    x = _signal((Gc.N,) + shape, dtype, 3, 'cpu')
    y = _signal((Gc.Ne,) + shape, dtype, 4, 'cpu')
    tol = TOL[dtype]
    for op, v in (('grad', x), ('div', y)):
        before = csr_kernel.csr_spmm.launches
        got = getattr(Gc, op)(v.to(cuda))
        assert csr_kernel.csr_spmm.launches == before + 1
        assert tuple(got.shape) == (
            (Gc.Ne if op == 'grad' else Gc.N),) + shape
        assert _rel_err(got.cpu(), getattr(Gh, op)(v)) <= tol
        assert torch.equal(got, getattr(Gc, op)(v.to(cuda)))
    assert _rel_err(Gc.div(Gc.grad(x.to(cuda))).cpu(),
                    Gh.L @ x) <= 10 * tol


def test_grad_and_div_differentiate_through_each_other(cuda):
    """A backward through grad is div on the card (and the reverse), one
    more launch each; and a second-order gradient runs."""
    Gc, _ = _difference_pair(cuda, torch.float64, 'combinatorial')
    x = _signal((Gc.N, 3), torch.float64, 5, cuda).requires_grad_()
    y = _signal((Gc.Ne, 3), torch.float64, 6, cuda).requires_grad_()
    ybar = _signal((Gc.Ne, 3), torch.float64, 7, cuda)
    xbar = _signal((Gc.N, 3), torch.float64, 8, cuda)
    before = csr_kernel.csr_spmm.launches
    (gx,) = torch.autograd.grad(Gc.grad(x), x, ybar)
    (gy,) = torch.autograd.grad(Gc.div(y), y, xbar)
    assert csr_kernel.csr_spmm.launches == before + 4
    assert torch.equal(gx, Gc.div(ybar)) and torch.equal(gy, Gc.grad(xbar))
    (g2,) = torch.autograd.grad((Gc.grad(x) ** 2).sum(), x,
                                create_graph=True)
    (h,) = torch.autograd.grad(g2.sum(), x)
    assert _rel_err(h, 2 * Gc.div(Gc.grad(torch.ones_like(x)))) <= 1e-12


def test_csr_transpose_on_the_card_equals_the_cpus(cuda):
    Gc, Gh = _difference_pair(cuda, torch.float32, 'combinatorial', True)
    for name in ('rows', 'cols', 'vals', 'rowptr'):
        assert torch.equal(getattr(Gc.D.D, name).cpu(),
                           getattr(Gh.D.D, name)), name


@pytest.mark.parametrize('name,kwargs', [('MexicanHat', dict(Nf=6)),
                                         ('Meyer', dict(Nf=6)),
                                         ('Regular', dict())])
def test_a_bank_of_six_on_the_card_matches_the_cpu(cuda, name, kwargs):
    """A bank of Nf = 6 (kernel B's groups take two passes of four
    filters) on CSR and windowed, against the CPU."""
    W, _ = _ba_windowed(torch.float64, 'cpu')
    for fmt in ('coo', 'windowed'):
        out = []
        for device in (cuda, 'cpu'):
            G = tgsp.graphs.Graph(W, device=device, dtype=torch.float64)
            G.compute_laplacian(fmt=fmt)
            G.estimate_lmax(method='bounds')
            g = getattr(tgsp.filters, name)(G, **kwargs)
            x = np.random.default_rng(5).normal(size=(G.N, 9))
            out.append(g.filter(x, order=30).cpu())
        assert _rel_err(out[0], out[1]) <= 1e-12


def test_upper_bound_power_iteration_and_lobpcg_on_the_card(cuda):
    from pygsp_tpu_torch.ops import eigen
    out = []
    for device in (cuda, 'cpu'):
        G = tgsp.graphs.Grid2d(60, 37, device=device, dtype=torch.float64)
        e, U = eigen.partial_fourier_basis(G.L, 3)
        out.append((float(eigen.laplacian_upper_bound(G.L)),
                    float(eigen.laplacian_upper_bound(G.L.to_banded())),
                    e.cpu(), U.cpu()))
        p = float(eigen.power_iteration_lmax(G.L))
        assert p <= out[-1][0]
    (ub, ubb, e, U), (ub_h, ubb_h, e_h, U_h) = out
    assert ub == ub_h == ubb == ubb_h
    assert float((e - e_h).abs().max()) <= 1e-8
    assert float((torch.diag(U.T @ U_h).abs() - 1).abs().max()) <= 1e-6


# ---------------------------------------------------------------------------
# the ELL and chunked SpMMs (csrc/ell_spmm.cu)
# ---------------------------------------------------------------------------

def _slot_hub_graph(n=3000, seed=6, hubs=(2, 7, 2999)):
    """A Barabási–Albert graph with three dense hub rows: each has over
    HEAVY_SLOTS overflow slots in both formats, so the kernel gives it a
    block of its own; the last one lies in the ragged last chunk."""
    src, tgt = tgsp.graphs.ba_edges_fast(n, m0=4, m=4, seed=seed)
    rng = np.random.default_rng(seed)
    W = sps.csr_matrix((rng.uniform(0.5, 1.5, len(src)), (src, tgt)),
                       shape=(n, n)).tolil()
    for h in hubs:
        W[h, ::3] = rng.uniform(0.5, 1.5, W[h, ::3].shape)
    W = sps.csr_matrix(W)
    W = W + W.T
    W.setdiag(0)
    W.eliminate_zeros()
    return W


SLOT_FORMATS = {
    'ell': lambda W, device: tsp.ell_from_scipy(W, device=device),
    'ell-width8': lambda W, device: tsp.ell_from_scipy(W, width=8,
                                                       device=device),
    'chunked-R1024': lambda W, device: tck.chunked_from_scipy(
        W, chunk_rows=1024, device=device),
    'chunked-R700-degree': lambda W, device: tck.chunked_from_scipy(
        W, chunk_rows=700, permute='degree', device=device),
}


def _slot_operands(M):
    if isinstance(M, tsp.ELLMatrix):
        return ell_kernel.ell_spmm, (M.table, M.ell_cols.reshape(-1),
                                     M.ell_vals.reshape(-1), M.residue)
    return ell_kernel.chunked_spmm, (M.table, M.slot_cols, M.slot_vals,
                                     M.residue)


@pytest.mark.parametrize('s', [1, 3, 128, 129, 512])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('fmt', list(SLOT_FORMATS))
def test_slot_kernels_match_plain(cuda, fmt, dtype, s):
    """Each kernel against its plain version in f64 (heavy rows, ragged
    chunks, one value a lane where S is odd), one launch, two launches
    bit-equal, and inf behind every dead slot adding nothing."""
    W = _slot_hub_graph()
    M = SLOT_FORMATS[fmt](W, cuda).astype(dtype)
    kernel, (table, cols, vals, res) = _slot_operands(M)
    assert res.heavy.numel() >= 3
    x = _signal((M.n_cols, s), dtype, s, cuda)
    before = kernel.launches
    y = kernel(table, cols, vals, res, x, M.n_rows)
    assert kernel.launches == before + 1 and y.dtype == dtype
    want = ell_kernel.slot_spmm_plain(
        table, cols, vals.double(), res._replace(vals=res.vals.double()),
        x.double(), M.n_rows)
    assert _rel_err(y.double(), want) <= TOL[dtype]
    assert torch.equal(y, kernel(table, cols, vals, res, x, M.n_rows))
    dead = vals.clone()
    for i, off, width, _, limit in table.blocks:
        rows = (M.n_rows if isinstance(M, tsp.ELLMatrix)
                else M.out_chunk_size(i))
        part = dead[off:off + rows * width]
        part[cols[off:off + rows * width] >= limit] = float('inf')
    assert torch.equal(y, kernel(table, cols, dead, res, x, M.n_rows))


@pytest.mark.parametrize('pair', sorted(ell_kernel.CHUNKED_OPERANDS,
                                        key=str))
def test_chunked_kernel_takes_every_pair(cuda, pair):
    """The chunked kernel in each operand pair against its plain version
    in the same dtypes (bf16 y within one bf16 ulp: the sums' order)."""
    xd, vd = pair
    M = tck.chunked_from_scipy(_slot_hub_graph(), chunk_rows=1024,
                               device=cuda).astype(vd)
    _, (table, cols, vals, res) = _slot_operands(M)
    x = _signal((M.n_cols, 128), torch.float32, 7, cuda).to(xd)
    y = ell_kernel.chunked_spmm(table, cols, vals, res, x, M.n_rows)
    want = ell_kernel.slot_spmm_plain(table, cols, vals, res, x, M.n_rows)
    assert y.dtype == xd
    if xd == torch.bfloat16:
        assert _ulps(y, want) <= 1.0
    else:
        assert _rel_err(y.double(), want.double()) <= TOL[xd]
    assert torch.equal(y, ell_kernel.chunked_spmm(table, cols, vals, res, x,
                                                  M.n_rows))


@pytest.mark.parametrize('fmt', ['hybrid', 'chunked'])
def test_a_bank_on_the_new_formats_matches_the_cpu(cuda, fmt):
    """compute_laplacian(fmt) and a heat bank on the card against the CPU
    in f64; the bank launches its format's kernel once per SpMM."""
    W = _slot_hub_graph()
    out = []
    for device in (cuda, 'cpu'):
        G = tgsp.graphs.Graph(W, device=device, dtype=torch.float64)
        G.compute_laplacian(fmt=fmt)
        G.estimate_lmax(method='bounds')
        kernel = (ell_kernel.ell_spmm if fmt == 'hybrid'
                  else ell_kernel.chunked_spmm)
        before = kernel.launches
        x = np.random.default_rng(5).normal(size=(G.N, 9))
        out.append(tgsp.filters.Heat(G, [2.0, 20.0]).filter(
            x, order=30).cpu())
        if device == cuda:
            assert kernel.launches - before == 30
    assert _rel_err(out[0], out[1]) <= 1e-12


def test_slot_kernels_refuse_autograd_and_mixed_devices(cuda):
    W = _slot_hub_graph()
    for M in (tsp.ell_from_scipy(W, device=cuda, dtype=torch.float32),
              tck.chunked_from_scipy(W, device=cuda, dtype=torch.float32)):
        kernel, (table, cols, vals, res) = _slot_operands(M)
        x = _signal((M.n_cols, 4), torch.float32, 3, cuda)
        with pytest.raises(RuntimeError, match='cheby_op_fixed_graph'):
            kernel(table, cols, vals, res, _requires_grad(x), M.n_rows)
        with torch.no_grad():
            kernel(table, cols, vals, res, _requires_grad(x), M.n_rows)
        with pytest.raises(ValueError, match='one device'):
            kernel(table, cols, vals, res, x.cpu(), M.n_rows)
    torch.cuda.synchronize()


def _launched(fn):
    """``(fn(), the C symbols it launched)``."""
    symbols = []
    launch = _cuda.launch

    def spy(name, symbol, *rest):
        symbols.append(symbol)
        return launch(name, symbol, *rest)

    _cuda.launch = spy
    try:
        out = fn()
    finally:
        _cuda.launch = launch
    return out, symbols


def _narrow_widths(dtype):
    widest = ell_kernel.SLOT_NARROW_WIDTH[dtype]
    return sorted({2, 8, 32, widest - 1, widest, widest + 1})


def _inf_behind_dead_slots(M, table, cols, vals):
    dead = vals.clone()
    for i, off, width, _, limit in table.blocks:
        rows = (M.n_rows if isinstance(M, tsp.ELLMatrix)
                else M.out_chunk_size(i))
        part = dead[off:off + rows * width]
        part[cols[off:off + rows * width] >= limit] = float('inf')
    return dead


@pytest.mark.parametrize('s', sorted(set(_narrow_widths(torch.float32)
                                         + _narrow_widths(torch.float64))))
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('fmt', list(SLOT_FORMATS))
def test_slot_narrow_entry_matches_plain(cuda, fmt, dtype, s):
    """The wrappers at the narrow widths and either side of the crossover:
    the entry SLOT_NARROW_WIDTH gives (its symbol launched), within TOL of
    the plain version in f64, two launches bit-equal, inf behind every dead
    slot adding nothing."""
    if s not in _narrow_widths(dtype):
        pytest.skip('not a width of this dtype')
    M = SLOT_FORMATS[fmt](_slot_hub_graph(), cuda).astype(dtype)
    kernel, (table, cols, vals, res) = _slot_operands(M)
    x = _signal((M.n_cols, s), dtype, s, cuda)
    y, symbols = _launched(lambda: kernel(table, cols, vals, res, x,
                                          M.n_rows))
    entry = ell_kernel.entry_for(s, dtype)
    assert symbols == [ell_kernel.symbol(kernel.__name__, entry, dtype,
                                         dtype)]
    want = ell_kernel.slot_spmm_plain(
        table, cols, vals.double(), res._replace(vals=res.vals.double()),
        x.double(), M.n_rows)
    assert _rel_err(y.double(), want) <= TOL[dtype]
    assert torch.equal(y, kernel(table, cols, vals, res, x, M.n_rows))
    dead = _inf_behind_dead_slots(M, table, cols, vals)
    assert torch.equal(y, kernel(table, cols, dead, res, x, M.n_rows))


@pytest.mark.parametrize('fmt', list(SLOT_FORMATS))
def test_slot_entries_agree_at_the_crossover(cuda, fmt):
    """In f64 the narrow and the wide entry sum each row in the same order,
    so they give the same bits, at the widest narrow width and at one
    column, with x aligned and not (the narrow entry's scalar path)."""
    M = SLOT_FORMATS[fmt](_slot_hub_graph(), cuda).astype(torch.float64)
    kernel, ops = _slot_operands(M)
    for s in (1, ell_kernel.SLOT_NARROW_WIDTH[torch.float64]):
        for lead in (0, 1):
            x = _signal((M.n_cols * s + lead,), torch.float64, 11, cuda)
            x = x[lead:].reshape(M.n_cols, s)
            narrow, wide = (ell_kernel.spmm_entry(kernel.__name__, e, *ops,
                                                  x, M.n_rows)
                            for e in ('narrow', 'wide'))
            assert torch.equal(narrow, wide), (s, lead)


@pytest.mark.parametrize('s', [1, 8])
@pytest.mark.parametrize('pair', sorted(ell_kernel.CHUNKED_OPERANDS,
                                        key=str))
def test_chunked_narrow_entry_takes_every_pair(cuda, pair, s):
    """The narrow entry in each operand pair against its plain version in
    the same dtypes (bf16 y within one bf16 ulp), two launches bit-equal;
    the wrapper launches the symbol of the entry entry_for gives."""
    xd, vd = pair
    M = tck.chunked_from_scipy(_slot_hub_graph(), chunk_rows=700,
                               permute='degree', device=cuda).astype(vd)
    _, (table, cols, vals, res) = _slot_operands(M)
    x = _signal((M.n_cols, s), torch.float32, 7, cuda).to(xd)
    ops = (table, cols, vals, res, x, M.n_rows)
    y = ell_kernel.spmm_entry('chunked_spmm', 'narrow', *ops)
    want = ell_kernel.slot_spmm_plain(*ops)
    assert y.dtype == xd
    if xd == torch.bfloat16:
        assert _ulps(y, want) <= 1.0
    else:
        assert _rel_err(y.double(), want.double()) <= TOL[xd]
    assert torch.equal(y, ell_kernel.spmm_entry('chunked_spmm', 'narrow',
                                                *ops))
    _, symbols = _launched(lambda: ell_kernel.chunked_spmm(*ops))
    assert symbols == [ell_kernel.symbol(
        'chunked_spmm', ell_kernel.entry_for(s, xd), xd, vd)]


# Widths both entries take (the narrow one up to 32 lanes of 16 bytes) by
# x's dtype: the wide entry's row groups of 8, 16 and 32 lanes, one value a
# lane where S is not whole 16-byte pieces, and its per-lane walk below 8
# pieces a row.
WIDE_AND_NARROW = {torch.float32: (33, 36, 64, 100, 128),
                   torch.float64: (34, 64),
                   torch.bfloat16: (2, 16, 64, 72, 128, 136, 256)}
# and an ELL level 0 of 40 positions a row: the wide entry reads a row's
# positions 32 at a time
WIDE_FORMATS = {**SLOT_FORMATS,
                'ell-width40': lambda W, device: tsp.ell_from_scipy(
                    W, width=40, device=device)}


@pytest.mark.parametrize('fmt', list(WIDE_FORMATS))
def test_slot_wide_entry_agrees_with_the_narrow_one(cuda, fmt):
    """The wide entry sums each row in the narrow entry's order, so the two
    give the same bits wherever both take the width, in every operand pair
    of the format, with x aligned and not; the heavy rows on the side
    stream included."""
    base = WIDE_FORMATS[fmt](_slot_hub_graph(), cuda)
    kind = 'ell_spmm' if fmt.startswith('ell') else 'chunked_spmm'
    pairs = (ell_kernel.ELL_OPERANDS if kind == 'ell_spmm'
             else ell_kernel.CHUNKED_OPERANDS)
    for xd, vd in sorted(pairs, key=str):
        M = base.astype(vd)
        _, ops = _slot_operands(M)
        for s in WIDE_AND_NARROW[xd]:
            assert ell_kernel.entry_for(s, xd) == 'wide'
            for lead in (0, 1):
                x = _signal((M.n_cols * s + lead,), torch.float32, s,
                            cuda).to(xd)
                x = x[lead:].reshape(M.n_cols, s)
                narrow, wide = (ell_kernel.spmm_entry(kind, e, *ops, x,
                                                      M.n_rows)
                                for e in ('narrow', 'wide'))
                assert torch.equal(narrow, wide), (xd, vd, s, lead)


@pytest.mark.parametrize('s', [520, 1000])
@pytest.mark.parametrize('fmt', list(WIDE_FORMATS))
def test_slot_wide_entry_takes_many_passes(cuda, fmt, s):
    """Past 32 pieces a row the wide entry's groups walk a row once for
    each 32 pieces, the last in part: every operand pair against its plain
    version (f32 and f64 against f64, bf16 y within one bf16 ulp of the
    plain version in the same dtypes), two launches bit-equal."""
    base = WIDE_FORMATS[fmt](_slot_hub_graph(), cuda)
    kernel, _ = _slot_operands(base)
    pairs = (ell_kernel.ELL_OPERANDS if kernel is ell_kernel.ell_spmm
             else ell_kernel.CHUNKED_OPERANDS)
    for xd, vd in sorted(pairs, key=str):
        M = base.astype(vd)
        _, (table, cols, vals, res) = _slot_operands(M)
        x = _signal((M.n_cols, s), torch.float32, s, cuda).to(xd)
        y = kernel(table, cols, vals, res, x, M.n_rows)
        if xd == torch.bfloat16:
            want = ell_kernel.slot_spmm_plain(table, cols, vals, res, x,
                                              M.n_rows)
            assert _ulps(y, want) <= 1.0, (xd, vd)
        else:
            want = ell_kernel.slot_spmm_plain(
                table, cols, vals.double(),
                res._replace(vals=res.vals.double()), x.double(), M.n_rows)
            assert _rel_err(y.double(), want) <= TOL[xd], (xd, vd)
        assert torch.equal(y, kernel(table, cols, vals, res, x, M.n_rows))


@pytest.mark.parametrize('fmt', ['hybrid', 'chunked'])
def test_estimate_lmax_takes_the_narrow_entry(cuda, fmt):
    """λmax's Lanczos products at one column launch only narrow symbols of
    the format's kernel."""
    G = tgsp.graphs.Graph(_slot_hub_graph(), device=cuda,
                          dtype=torch.float64)
    G.compute_laplacian(fmt=fmt)
    _, symbols = _launched(G.estimate_lmax)
    kind = 'ell_spmm' if fmt == 'hybrid' else 'chunked_spmm'
    slot = [name for name in symbols if name.startswith(kind)]
    assert slot and all(name == f'{kind}_narrow_f64' for name in slot)
    assert not any(name.startswith('csr_spmm') for name in symbols)
    assert np.isfinite(G.lmax) and G.lmax > 0


def _sensor_pair(cuda, n=512):
    return [tgsp.graphs.Sensor(n, seed=42, device=device, dtype=torch.float64)
            for device in (cuda, 'cpu')]


def test_learning_on_the_card_matches_the_cpu(cuda):
    """The learning solvers in f64 on the card against the CPU: one CG
    over the block (one csr_spmm launch an operator application), the
    simplex loop (one a step). The card sums its dot products and rows in
    another order, which CG carries through its iterations: 2.8e-10 on an
    H100, held to 1e-8."""
    from pygsp_tpu_torch import learning
    Gc, Gh = _sensor_pair(cuda)
    Gh.estimate_lmax()
    Gc._lmax = Gh._lmax
    mask = np.random.default_rng(1).random(Gh.N) < 0.1
    labels = (np.arange(Gh.N) % 4).astype(float)
    y = np.random.default_rng(2).normal(size=(Gh.N, 3))
    for call in (lambda G: learning.regression_tikhonov(G, y, mask, 0.5),
                 lambda G: learning.regression_tikhonov(G, y[:, 0], mask, 0),
                 lambda G: learning.classification_tikhonov(G, labels, mask,
                                                            0.2),
                 lambda G: learning.classification_tikhonov_simplex(
                     G, labels, mask, maxit=60)):
        before = csr_kernel.csr_spmm.launches
        got = call(Gc)
        assert csr_kernel.csr_spmm.launches - before > 1
        assert _rel_err(got.cpu(), call(Gh)) <= 1e-8


def test_prox_tv_on_the_card_matches_the_cpu(cuda):
    """Two csr_spmm launches an iteration (div, grad) and one div after."""
    from pygsp_tpu_torch import optimization
    Gc, Gh = _sensor_pair(cuda)
    Gh.estimate_lmax()
    Gc._lmax = Gh._lmax
    x = np.random.default_rng(3).normal(size=Gh.N)
    before = csr_kernel.csr_spmm.launches
    got = optimization.prox_tv(x, 0.3, Gc, maxit=25)
    assert csr_kernel.csr_spmm.launches - before == 2 * 25 + 1
    assert _rel_err(got.cpu(), optimization.prox_tv(x, 0.3, Gh,
                                                    maxit=25)) <= 1e-10


def test_reduction_and_features_on_the_card_match_the_cpu(cuda):
    """The dense Kron solve, the CG sketch of the resistances and the
    spectrogram's bank of 100 filters on the card against the CPU."""
    from pygsp_tpu_torch import features, reduction
    Gc, Gh = _sensor_pair(cuda, 256)
    keep = np.flatnonzero(np.random.default_rng(4).random(256) < 0.5)
    Wc = reduction.kron_reduction(Gc, keep, method='exact').W
    Wh = reduction.kron_reduction(Gh, keep, method='exact').W
    assert abs(Wc - Wh).max() <= 1e-10 * abs(Wh).max()
    Rc = reduction.effective_resistances_sketch(Gc)[2]
    Rh = reduction.effective_resistances_sketch(Gh)[2]
    assert np.abs(Rc - Rh).max() <= 1e-10 * np.abs(Rh).max()
    Gh.estimate_lmax()
    Gc._lmax = Gh._lmax
    Sc = features.compute_spectrogram(Gc)
    Sh = features.compute_spectrogram(Gh)
    assert np.abs(Sc - Sh).max() <= 1e-10 * np.abs(Sh).max()


def test_nn_graphs_and_eigenmap_on_the_card(cuda):
    """A nearest-neighbour graph on the card has the host's W; the LOBPCG
    eigenmap in f64 on the card matches the CPU's eigenvalues."""
    Gc, Gh = [tgsp.graphs.Sensor(2500, seed=42, device=device,
                                 dtype=torch.float64)
              for device in (cuda, 'cpu')]
    assert abs(Gc.W - Gh.W).max() == 0
    for G in (Gc, Gh):
        G.set_coordinates('laplacian_eigenmap2D')
    assert torch.allclose(Gc.e.cpu(), Gh.e, rtol=0, atol=1e-10)
    align = np.abs(np.sum(Gc.coords * Gh.coords, axis=0))
    assert np.abs(align - 1).max() <= 1e-6


# ---------------------------------------------------------------------------
# the fused multi-matrix fold and the multi-device engines at one rank
# ---------------------------------------------------------------------------

def _ring_mats(dtype, device, shape=(4, 4), **kw):
    """Device (0, 0)'s pr ring matrices of the ``shape`` (4 × 4 by default)
    edge partition of ``_ba_windowed``'s graph: slab widths and
    source-chunk counts that differ, residue tiers (the graph's hubs)."""
    from pygsp_tpu_torch import parallel as par
    from pygsp_tpu_torch.parallel.partition import shard_slice
    W, _ = _ba_windowed(torch.float64, 'cpu')
    tg = par.partition_graph_2d(W, *shape, dtype=dtype, device=device)
    ell = par.twod_local_windowed(tg, ring=True, **kw)
    return [shard_slice(e, 0).local_matrix() for e in ell]


MULTI_CASES = {'default': dict(chunk_rows=512),
               'P8': dict(chunk_rows=64, window_rows=8)}


@pytest.mark.parametrize('pair', sorted(wk.FOLD_OPERANDS, key=str))
@pytest.mark.parametrize('s', [1, 5, 128, 136])
@pytest.mark.parametrize('case', list(MULTI_CASES))
def test_windowed_fold_multi_matches_plain(cuda, pair, s, case):
    """One launch over four matrices against the plain sum of their folds
    (float32 or float64 sums, rounded once): within the sums' tolerance,
    1 bf16 ulp where bf16 is written; two launches bit-equal; the strip
    over the merged residue lists bit-equal to its plain version."""
    xd, vd = pair
    mats = [m.astype(vd) for m in _ring_mats(
        torch.float64 if xd == torch.float64 else torch.float32, cuda,
        **MULTI_CASES[case])]
    xs = [_signal((m.n_cols, s), torch.float64, 20 + i, cuda).to(xd)
          for i, m in enumerate(mats)]
    R, P, K = mats[0].chunk_rows, mats[0].window_rows, mats[0].borrow_span
    slabs = [(m.cols, m.vals, m.rowid) for m in mats]
    before = wk.windowed_fold_multi.launches
    t = wk.windowed_fold_multi(slabs, xs, R, K * P)
    assert wk.windowed_fold_multi.launches == before + 1 and t.dtype == xd
    want = wk.windowed_fold_multi_plain(slabs, xs, R, K * P)
    if xd == torch.bfloat16:
        assert _ulps(t, want) <= 1.0
    else:
        assert _rel_err(t, want) <= TOL[xd]
    assert torch.equal(t, wk.windowed_fold_multi(slabs, xs, R, K * P))
    merged = wk.merge_residues([m.residue for m in mats], mats[0].n_rows)
    assert merged is not None and merged.emat is not None
    y = wk.window_strip(t, mats[0].n_rows, P, merged, xs)
    assert torch.equal(y, wk.window_strip_plain(t, mats[0].n_rows, P,
                                                merged, xs))


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64,
                                   torch.bfloat16])
@pytest.mark.parametrize('kp,s', [(128, 128), (256, 5), (512, 300)])
def test_fold_multi_layout_bytes_are_the_kernels(cuda, dtype, kp, s):
    item = torch.finfo(wk._sum_dtype(dtype)).bits // 8
    lay = wk.fold_layout(kp, s, item, torch.finfo(dtype).bits // 8,
                         multi=True)
    fn = getattr(_cuda.library('windowed_fold'),
                 f'windowed_fold_multi_smem_bytes_{wk._DTYPES[dtype]}')
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    assert fn(kp, lay.s_tile, lay.ring, lay.queue) == lay.smem_bytes


# the fused SpMM in one launch (fold_strip_multi): K = 2 and 4, windows of
# 8 rows, and rows of more residue entries than the heavy-row bound (up to
# 35, three rounds of ENTRY_ROUND), on the 4 x 4 and 2 x 2 partitions
FOLD_STRIP_CASES = {
    'K2': ((4, 4), dict(chunk_rows=512, borrow_span=2)),
    'K4': ((4, 4), dict(chunk_rows=512, borrow_span=4)),
    'P8': ((4, 4), dict(chunk_rows=64, window_rows=8)),
    'heavyK2': ((2, 2), dict(chunk_rows=256, slab_width=4, borrow_span=2)),
    'heavyK4': ((2, 2), dict(chunk_rows=256, slab_width=4, borrow_span=4)),
}


def _fold_strip_operands(case, pair, s, device):
    xd, vd = pair
    shape, kw = FOLD_STRIP_CASES[case]
    mats = [m.astype(vd) for m in _ring_mats(
        torch.float64 if xd == torch.float64 else torch.float32, device,
        shape=shape, **kw)]
    xs = [_signal((m.n_cols, s), torch.float64, 40 + i, device).to(xd)
          for i, m in enumerate(mats)]
    m0 = mats[0]
    merged = wk.merge_residues([m.residue for m in mats], m0.n_rows)
    return ([(m.cols, m.vals, m.rowid) for m in mats], xs, m0.chunk_rows,
            m0.window_rows, m0.borrow_span, m0.n_rows, merged)


@pytest.mark.parametrize('pair', sorted(wk.FOLD_OPERANDS, key=str))
@pytest.mark.parametrize('s', [1, 5, 128, 136])
@pytest.mark.parametrize('case', list(FOLD_STRIP_CASES))
def test_fold_strip_multi_matches_plain(cuda, pair, s, case):
    """One launch against the two launches it replaces (the multi-matrix
    fold, then the strip of the merged residue lists), bit for bit; two
    launches bit-equal; against its plain version within the sums'
    tolerance (float32, float64 y), or within the roundings to bf16 of a
    bf16 y (the K parts, y, and each residue entry's sum and add, and the
    products of bf16 · bf16) of the float64 sum of |terms|."""
    slabs, xs, R, P, K, n, merged = _fold_strip_operands(case, pair, s, cuda)
    assert K == {'K2': 2, 'heavyK2': 2}.get(case, 4)
    counts = merged.rowptr[1:] - merged.rowptr[:-1]
    if case.startswith('heavy'):
        assert int(counts.max()) > 2 * wk.ENTRY_ROUND
    before = wk.fold_strip_multi.launches
    y = wk.fold_strip_multi(slabs, xs, R, P, K, n, merged)
    assert wk.fold_strip_multi.launches == before + 1
    assert y.dtype == pair[0] and y.shape == (n, s)
    t = wk.windowed_fold_multi(slabs, xs, R, K * P)
    assert torch.equal(y, wk.window_strip(t, n, P, merged, xs))
    assert torch.equal(y, wk.fold_strip_multi(slabs, xs, R, P, K, n, merged))
    if pair[0] != torch.bfloat16:
        want = wk.fold_strip_multi_plain(slabs, xs, R, P, K, n, merged)
        assert _rel_err(y, want) <= TOL[pair[0]]
        return
    f64 = [(c, v.double(), r) for c, v, r in slabs]
    want = wk.fold_strip_multi_plain(
        f64, [x.double() for x in xs], R, P, K, n,
        merged._replace(vals=merged.vals.double()))
    scale = wk.fold_strip_multi_plain(
        [(c, v.abs(), r) for c, v, r in f64],
        [x.double().abs() for x in xs], R, P, K, n,
        merged._replace(vals=merged.vals.double().abs())).max()
    roundings = K + 3 + 2 * int(counts.max())
    assert float((y.double() - want).abs().max()) <= \
        roundings * 2.0**-9 * float(scale)


@pytest.mark.parametrize('pair', [(torch.float32, torch.float32),
                                  (torch.bfloat16, torch.float32)])
def test_fold_strip_multi_without_residue(cuda, pair):
    slabs, xs, R, P, K, n, _ = _fold_strip_operands('K2', pair, 128, cuda)
    y = wk.fold_strip_multi(slabs, xs, R, P, K, n)
    assert torch.equal(y, wk.window_strip(
        wk.windowed_fold_multi(slabs, xs, R, K * P), n, P))


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('case', list(WINDOWED_CASES))
def test_fold_strip_multi_at_one_matrix(cuda, dtype, case):
    """At one matrix: bit-equal to the single-matrix fold and strip (the
    windowed SpMM's two launches), heavy rows included; a matrix whose
    windows a block cannot stage is refused."""
    _, M = _ba_windowed(dtype, cuda, **WINDOWED_CASES[case])
    x = _signal((M.n_cols, 128), dtype, 9, cuda)
    R, P, K = M.chunk_rows, M.window_rows, M.borrow_span
    slabs = [(M.cols, M.vals, M.rowid)]
    args = (slabs, [x], R, P, K, M.n_rows,
            wk.merge_residues([M.residue], M.n_rows))
    if not wk.fold_strip_fits(slabs, [x], K, P):
        with pytest.raises(ValueError, match='do not fit'):
            wk.fold_strip_multi(*args)
        return
    y = wk.fold_strip_multi(*args)
    t = wk.windowed_fold(M.cols, M.vals, M.rowid, x, R, K * P)
    assert torch.equal(y, wk.window_strip(t, M.n_rows, P, M.residue, x))


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64,
                                   torch.bfloat16])
@pytest.mark.parametrize('kp,n_cap', [(128, 600), (256, 2304), (512, 40)])
@pytest.mark.parametrize('vec', [True, False])
def test_fold_strip_layout_bytes_are_the_kernels(cuda, dtype, kp, n_cap, vec):
    lay = wk.fold_strip_layout(kp, n_cap, dtype, vec)
    fn = getattr(_cuda.library('windowed_fold'),
                 f'fold_strip_multi_smem_bytes_{wk._DTYPES[dtype]}')
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    assert fn(kp, n_cap, lay.tile) == lay.smem_bytes


def test_fold_strip_multi_refuses_grad(cuda):
    slabs, xs, R, P, K, n, merged = _fold_strip_operands(
        'K2', (torch.float32, torch.float32), 8, cuda)
    xs[1] = xs[1].clone().requires_grad_()
    with pytest.raises(RuntimeError, match='requires grad'):
        wk.fold_strip_multi(slabs, xs, R, P, K, n, merged)


def test_fused_spmm_on_the_card_matches_the_cpu(cuda):
    """``windowed_spmm_chunks_multi`` (fold and strip) in float64 on the
    card against the CPU's plain version, and the single matrix's SpMM
    where one matrix is given."""
    out = []
    for device in (cuda, 'cpu'):
        mats = _ring_mats(torch.float64, device, chunk_rows=512)
        xs = [_signal((m.n_cols, 7), torch.float64, 30 + i, device)
              for i, m in enumerate(mats)]
        merged = wk.merge_residues([m.residue for m in mats],
                                   mats[0].n_rows)
        out.append(twd.spmm_multi_internal(mats, xs, merged).cpu())
    assert torch.allclose(out[0], out[1], rtol=0, atol=1e-12)


def test_engines_at_one_rank_on_the_card_match_the_cpu(cuda):
    """The 1-D engine (windowed split and COO layouts) and the 2-D engine
    (interleaved ring) on a one-rank mesh with no process group, f64 on
    the card against the CPU, and the fixed-graph VJP's c̄ and x̄."""
    from pygsp_tpu_torch import parallel as par
    W, _ = _ba_windowed(torch.float64, 'cpu')
    x = np.random.default_rng(5).normal(size=(W.shape[0], 6))
    c = np.random.default_rng(6).normal(size=(2, 12)) * 0.6 ** np.arange(12)
    lmax = 2.0 * float(W.sum(axis=1).max())
    res = {}
    for device in (cuda, 'cpu'):
        sg = par.partition_graph(W, 1, dtype=torch.float64, device=device)
        mesh = par.make_mesh(1, 1, devices=device)
        xp = sg.pad_signal(torch.from_numpy(x).to(device))
        cd = torch.from_numpy(c).to(device)
        for name, ell in (('win', par.shard_local_windowed(
                sg, split_boundary=True)), ('coo', None)):
            res[device, name] = par.sharded_cheby_op(sg, lmax, cd, xp, mesh,
                                                     ell=ell).cpu()
        cg, xg = cd.clone().requires_grad_(), xp.clone().requires_grad_()
        par.sharded_cheby_op_fixed_graph(sg, lmax, cg, xg, mesh,
                                         ell=ell).sum().backward()
        res[device, 'grads'] = (cg.grad.cpu(), xg.grad.cpu())
        tg = par.partition_graph_2d(W, 1, 1, dtype=torch.float64,
                                    device=device)
        ell2 = par.twod_local_windowed(tg, ring=True, split_cols=True)
        res[device, '2d'] = par.cheby_op_2d(
            tg, lmax, cd, tg.pad_signal(torch.from_numpy(x).to(device)),
            par.make_mesh_2d(1, 1, devices=device), ell=ell2).cpu()
    for key in ('win', 'coo', '2d'):
        assert torch.allclose(res[cuda, key], res['cpu', key], rtol=0,
                              atol=1e-10 * float(res['cpu', key].abs().max()))
    for a, b in zip(res[cuda, 'grads'], res['cpu', 'grads']):
        assert torch.allclose(a, b, rtol=0, atol=1e-10 * float(b.abs().max()))
