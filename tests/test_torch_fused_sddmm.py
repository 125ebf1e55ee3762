"""The weights' SDDMM fused into the transpose's SpMM, and the recurrence
under autograd off the CSR format, on the CPU in float64.

- ``cheby_op`` with ``c``, ``x`` or both requiring grad on the hybrid,
  chunked, windowed and banded operators, whose plain recurrence runs
  under autograd: each term a tensor of its own, so a term that the grouped
  accumulation saved is never overwritten (it was, once the ring of terms
  wrapped, at m+1 = 31). c̄ and x̄ against ``jax.grad`` of the JAX
  package's ``cheby_op`` within 1e-12 of the largest value, with the
  group rule's own g; the forward bit-equal with and without grad.
- ``csr_spmm_sddmm_plain`` on Aᵀ, its cotangent scattered back by the
  transpose's edge order, bit-equal to ``csr_spmm_plain`` on Aᵀ plus
  ``csr_sddmm_plain`` on A: duplicate entries, padding (cotangent 0), a
  matrix that is not symmetric, one that is not square.
- ``_operator_grads`` through the fused route (S above ``NARROW_WIDTH``)
  against ``jax.grad`` within 1e-12 on both Laplacian types, with its
  launches counted, and bit-equal to the two-launch route; ``_CSRSpmm``'s
  fused backward bit-equal to its composed one, and ``create_graph=True``
  still giving second derivatives (against ``jax.hessian``).
- The fused kernel's walk emulated segment by segment (every edge's dot
  and every diagonal entry taken once, by the warp the kernel gives it),
  and its reduction of K edges' lane partials against the SDDMM's
  butterfly, bit for bit in float32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import pygsp_tpu as jgsp
from pygsp_tpu.core import operators as jops
from pygsp_tpu.core import sparse as jsp
from pygsp_tpu.ops import chebyshev as jcheby
from pygsp_tpu_torch.core import csr_kernel
from pygsp_tpu_torch.core import operators as tops
from pygsp_tpu_torch.core import sparse as tsp
from pygsp_tpu_torch.ops import chebyshev as tcheby

TOL = 1e-12
CPU64 = dict(device='cpu', dtype=torch.float64)
FORMATS = ('to_hybrid', 'to_chunked', 'to_windowed', 'to_banded')
# graph -> (host adjacency, pinned λmax)
GRAPHS = {'ring16': (lambda: jgsp.graphs.Ring(16).W, 4.0),
          'grid12x10': (lambda: jgsp.graphs.Grid2d(12, 10).W, 8.0)}


def _close(got, want, tol=TOL):
    """max |got − want| within ``tol`` of the largest |want|."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-300)
    assert float(np.abs(got - want).max()) <= tol * scale


def _inputs(n, nf, s, m1, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(nf, m1)), rng.normal(size=(n, s)),
            rng.normal(size=(nf, n, s)))


# ---------------------------------------------------------------------------
# the recurrence under autograd off the CSR format
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_cx_grads(graph, m1):
    """c̄ and x̄ of ⟨ḡ, cheby_op⟩ by ``jax.grad`` of the JAX package on its
    CSR Laplacian, and the inputs."""
    make, lmax = GRAPHS[graph]
    W = make()
    c, x, gbar = _inputs(W.shape[0], 2, 3, m1, seed=m1)
    L = jops.laplacian_op(jsp.from_scipy(W, dtype=jnp.float64))
    grads = jax.grad(lambda c_, x_: jnp.sum(
        jnp.asarray(gbar) * jcheby.cheby_op(L, lmax, c_, x_)),
        argnums=(0, 1))(jnp.asarray(c), jnp.asarray(x))
    return W, lmax, (c, x, gbar), [np.asarray(g) for g in grads]


@pytest.mark.parametrize('need', ['c', 'x', 'both'])
@pytest.mark.parametrize('m1', [10, 31])
@pytest.mark.parametrize('graph', list(GRAPHS))
@pytest.mark.parametrize('fmt', FORMATS)
def test_recurrence_under_autograd_matches_jax(fmt, graph, m1, need,
                                               monkeypatch):
    """The call that failed: ``cheby_op`` off the CSR format with c and/or x
    requiring grad, at the group rule's g (one group of 8 at m+1 = 10; a
    head of one and groups of 14 at 31, where the ring wrapped)."""
    monkeypatch.delenv('PYGSP_CHEBY_ACC_GROUP', raising=False)
    W, lmax, (c, x, gbar), want = _jax_cx_grads(graph, m1)
    L = getattr(tops.laplacian_op(tsp.from_scipy(W, **CPU64)), fmt)()
    ct = torch.tensor(c, requires_grad=need in ('c', 'both'))
    xt = torch.tensor(x, requires_grad=need in ('x', 'both'))
    out = tcheby.cheby_op(L, lmax, ct, xt)
    (out * torch.from_numpy(gbar)).sum().backward()
    if need in ('c', 'both'):
        _close(ct.grad.numpy(), want[0])
    if need in ('x', 'both'):
        _close(xt.grad.numpy(), want[1])
    with torch.no_grad():
        plain = tcheby.cheby_op(L, lmax, ct, xt)
    assert torch.equal(out.detach(), plain)


@pytest.mark.parametrize('fmt', FORMATS + ('csr',))
def test_forward_without_grad_keeps_the_ring(fmt, monkeypatch):
    """Without autograd the bank runs on the ring of g + 2 buffers, as
    before: its bits equal a recurrence written out here with the same
    steps and groups (term by term into the ring, each group added by
    ``cheby_acc_group``), and so does the recorded bank's."""
    monkeypatch.delenv('PYGSP_CHEBY_ACC_GROUP', raising=False)
    W, lmax = GRAPHS['grid12x10'][0](), 8.0
    L = tops.laplacian_op(tsp.from_scipy(W, **CPU64))
    L = L if fmt == 'csr' else getattr(L, fmt)()
    c, x, _ = _inputs(W.shape[0], 3, 2, 31, seed=3)
    ct, xt = torch.from_numpy(c), torch.from_numpy(x)
    op, pin, pout = L.hoisted()
    xin = pin(xt)
    t_old, t_cur, step = tcheby._start(op, lmax, xin)
    g = tcheby.acc_group(29, xin.numel(), xin.dtype, t_cur.dtype,
                         tcheby._operator_bytes(L.offdiag), 3)
    cT = ct.T.contiguous()
    acc = (0.5 * ct[:, 0]).reshape(3, 1, 1) * xin[None]
    tcheby.cheby_kernel.cheby_acc_group(acc, t_cur[None], cT[1:2])
    ring = torch.empty((g + 2,) + t_cur.shape, dtype=torch.float64)
    head = 2 + 29 % g
    for k in range(2, 31):
        t_old, t_cur = t_cur, step(t_cur, t_old, ring[(k - 2) % (g + 2)])
        size = 1 if k < head else g
        if size == 1 or (k - head) % g == g - 1:
            tcheby.cheby_kernel.cheby_acc_group(
                acc, ring, cT[k + 1 - size:k + 1], (k - 1 - size) % (g + 2))
    want = pout(acc, axis=1)
    assert torch.equal(tcheby.cheby_op(L, lmax, ct, xt), want)
    xg = xt.clone().requires_grad_()
    assert torch.equal(tcheby.cheby_op(L, lmax, ct, xg).detach(), want)


# ---------------------------------------------------------------------------
# the fused entry's plain version against the two launches it replaces
# ---------------------------------------------------------------------------

def _matrix(case):
    """A host COO ``(rows, cols, vals, shape, sum_duplicates)``."""
    rng = np.random.default_rng(41)
    if case == 'duplicates':
        A = sps.random(70, 70, density=0.08, random_state=rng).tocoo()
        dup = rng.choice(A.nnz, 60, replace=False)
        return (np.concatenate([A.row, A.row[dup]]),
                np.concatenate([A.col, A.col[dup]]),
                np.concatenate([A.data, rng.normal(size=60)]), A.shape, False)
    if case == 'not_symmetric':
        A = sps.random(90, 90, density=0.06, random_state=rng, format='lil')
        A[4] = 0                                    # an empty row
        A[6, :80] = rng.normal(size=80)             # a hub row
        A = A.tocoo()
    else:                                           # not square
        A = sps.random(50, 80, density=0.1, random_state=rng).tocoo()
    return A.row, A.col, A.data, A.shape, True


@pytest.mark.parametrize('s', [33, 64, 200])
@pytest.mark.parametrize('case', ['duplicates', 'not_symmetric',
                                  'rectangular'])
def test_fused_plain_is_the_two_launches(case, s):
    rows, cols, vals, (n_rows, n_cols), summed = _matrix(case)
    A = tsp.from_coo(rows, cols, vals, n_rows, n_cols,
                     sum_duplicates=summed, **CPU64)
    assert A.n_edges_padded > A.nnz
    if case == 'duplicates':
        assert A.nnz == len(rows)
    At, order = tsp._transpose(A)
    rng = np.random.default_rng(s)
    u = torch.from_numpy(rng.normal(size=(n_rows, s)))
    t = torch.from_numpy(rng.normal(size=(n_cols, s)))
    square = n_rows == n_cols
    d0 = torch.from_numpy(rng.normal(size=n_rows)) if square else None
    out_a = torch.zeros_like(A.vals)
    out_a[:A.nnz] = torch.from_numpy(rng.normal(size=A.nnz))
    out_t = torch.empty_like(out_a).index_copy_(
        0, torch.argsort(order), out_a)         # the same, in Aᵀ's order
    d_a = None if d0 is None else d0.clone()
    d_t = None if d0 is None else d0.clone()
    alpha = torch.tensor(0.37, dtype=torch.float64)
    launches = csr_kernel.csr_spmm_sddmm.launches
    y = csr_kernel.csr_spmm_sddmm(At.rowptr, At.cols, At.vals, u, t, out_t,
                                  alpha, d_t)
    assert csr_kernel.csr_spmm_sddmm.launches == launches   # the CPU: plain
    y_want = csr_kernel.csr_spmm_plain(At.rowptr, At.cols, At.vals, u)
    csr_kernel.csr_sddmm_plain(A.rows, A.cols, u, t, out_a, alpha, d_a)
    assert torch.equal(y, y_want)
    assert torch.equal(torch.empty_like(out_t).index_copy_(0, order, out_t),
                       out_a)
    assert not out_t[A.nnz:].any()              # padding keeps 0
    if square:
        assert torch.equal(d_t, d_a)


def test_fused_wrapper_refuses_bad_operands():
    A = tsp.from_scipy(sps.random(20, 30, density=0.2, random_state=1,
                                  format='csr'), **CPU64)
    At = A.T
    u, t = torch.zeros((20, 40), dtype=torch.float64), torch.zeros(
        (30, 40), dtype=torch.float64)
    out = torch.zeros_like(A.vals)
    args = (At.rowptr, At.cols, At.vals)
    with pytest.raises(ValueError, match='t must be'):
        csr_kernel.csr_spmm_sddmm(*args, u, t[:, :39], out, 1.0)
    with pytest.raises(ValueError, match='out must be'):
        csr_kernel.csr_spmm_sddmm(*args, u, t, out[:-1], 1.0)
    with pytest.raises(ValueError, match='square'):
        csr_kernel.csr_spmm_sddmm(*args, u, t, out, 1.0,
                                  torch.zeros(30, dtype=torch.float64))
    with pytest.raises(ValueError, match='one dtype'):
        csr_kernel.csr_spmm_sddmm(*args, u.float(), t, out, 1.0)


def test_fused_width():
    """Above kernel A's narrow widths, up to one SDDMM launch."""
    for dt, widest in csr_kernel.NARROW_WIDTH.items():
        assert not csr_kernel.fused_width(widest, dt)
        assert csr_kernel.fused_width(widest + 1, dt)
        assert csr_kernel.fused_width(csr_kernel.SDDMM_WIDTH, dt)
        assert not csr_kernel.fused_width(csr_kernel.SDDMM_WIDTH + 1, dt)
    assert not csr_kernel.fused_width(128, torch.bfloat16)


# ---------------------------------------------------------------------------
# the backward through the weights on the fused route
# ---------------------------------------------------------------------------

def _pair(W):
    coo = sps.coo_matrix(W)
    J = jsp.from_coo(coo.row, coo.col, coo.data.astype(np.float64),
                     W.shape[0], dtype=jnp.float64)
    return J, tsp.from_scipy(W, **CPU64)


def _count(monkeypatch, names):
    """Count calls of csr_kernel's ``names`` from here on."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(csr_kernel, name)

        def spy(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(csr_kernel, name, spy)
    return calls


def _weight_loss(T, lap_type, lmax, c, x, gbar, w):
    L = tops.laplacian_op(T.with_vals(w), lap_type)
    return (torch.from_numpy(gbar) * tcheby.cheby_op(L, lmax, c, x)).sum()


@pytest.mark.parametrize('need_x', [True, False])
@pytest.mark.parametrize('lap_type', ['combinatorial', 'normalized'])
def test_operator_grads_on_the_fused_route_match_jax(lap_type, need_x,
                                                     monkeypatch):
    """w̄, c̄, x̄ and λ̄ at 40 columns against ``jax.grad``: m − 1 fused
    launches and u_1's share in x̄'s step (m in all) or in one
    ``csr_sddmm``; and bit-equal to the two-launch route."""
    W = jgsp.graphs.Sensor(64, seed=1).W
    J, T = _pair(W)
    m1, s = 11, 40
    lmax = 2.0 if lap_type == 'normalized' else 1.05 * float(
        np.linalg.eigvalsh(np.diag(np.ravel(W.sum(1))) - W.toarray())[-1])
    c, x, gbar = _inputs(64, 3, s, m1, seed=17)

    def jloss(w, c_, x_, lmax_):
        L = jops.laplacian_op(J.with_vals(w), lap_type)
        return jnp.sum(jnp.asarray(gbar) * jcheby.cheby_op(L, lmax_, c_, x_))

    want = [np.asarray(g) for g in jax.grad(jloss, argnums=(0, 1, 2, 3))(
        J.vals, jnp.asarray(c), jnp.asarray(x), jnp.float64(lmax))]

    def grads():
        w = T.vals.clone().requires_grad_()
        ct = torch.tensor(c, requires_grad=True)
        xt = torch.tensor(x, requires_grad=need_x)
        lt = torch.tensor(lmax, dtype=torch.float64, requires_grad=True)
        _weight_loss(T, lap_type, lt, ct, xt, gbar, w).backward()
        return [w.grad, ct.grad, xt.grad, lt.grad]

    calls = _count(monkeypatch, ['csr_spmm_sddmm', 'csr_sddmm'])
    got = grads()
    assert calls['csr_spmm_sddmm'] == m1 - 1 - (not need_x)
    assert calls['csr_sddmm'] == (not need_x)
    for g, w in zip(got[:3], want[:3]):
        if g is not None:
            _close(g.numpy(), w)
    assert abs(float(got[3]) - float(want[3])) <= 1e-10 * abs(float(want[3]))
    assert not got[0][T.nnz:].any()
    monkeypatch.setattr(csr_kernel, 'fused_width', lambda s, dtype: False)
    for a, b in zip(got, grads()):
        assert (a is None and b is None) or torch.equal(a, b)
    assert calls['csr_sddmm'] == m1 - 1 + (not need_x)


@pytest.mark.parametrize('s', [33, 100])
def test_spmm_fused_backward_is_the_composed_one(s, monkeypatch):
    """``A @ x`` through A's values and x: one fused call, bit-equal to
    the composed backward (kernel A on the transpose and the SDDMM), on a
    matrix that is not symmetric, with kept duplicates."""
    rows, cols, vals, (n, _), _ = _matrix('duplicates')
    A = tsp.from_coo(rows, cols, vals, n, sum_duplicates=False, **CPU64)
    rng = np.random.default_rng(s)
    x0, ybar = rng.normal(size=(n, s)), torch.from_numpy(
        rng.normal(size=(n, s)))

    def grads():
        v = A.vals.clone().requires_grad_()
        x = torch.tensor(x0, requires_grad=True)
        (ybar * tsp.spmm(A.with_vals(v), x)).sum().backward()
        return v.grad, x.grad

    calls = _count(monkeypatch, ['csr_spmm_sddmm', 'csr_sddmm'])
    fused = grads()
    assert calls == {'csr_spmm_sddmm': 1, 'csr_sddmm': 0}
    monkeypatch.setattr(csr_kernel, 'fused_width', lambda s, dtype: False)
    composed = grads()
    assert calls == {'csr_spmm_sddmm': 1, 'csr_sddmm': 1}
    assert all(torch.equal(a, b) for a, b in zip(fused, composed))
    assert not fused[0][A.nnz:].any()


def test_spmm_second_derivatives_at_fused_widths(monkeypatch):
    """``create_graph=True`` keeps the composed backward (no fused call),
    which differentiates again: a Hessian-vector product through ``L @ x``
    at 40 columns against ``jax.hessian``."""
    W = jgsp.graphs.Ring(16).W
    J, T = _pair(W)
    s, e = 40, T.n_edges_padded
    rng = np.random.default_rng(25)
    x, dx = rng.normal(size=(16, s)), rng.normal(size=(16, s))
    dv = np.zeros(e)
    dv[:T.nnz] = rng.normal(size=T.nnz)

    def jloss(z):
        L = jops.laplacian_op(J.with_vals(z[:e]), 'normalized')
        return jnp.sum(jops.matvec(L, z[e:].reshape(16, s)) ** 2)

    z0 = np.concatenate([np.asarray(J.vals), x.ravel()])
    want = np.asarray(jax.hessian(jloss)(jnp.asarray(z0))) @ np.concatenate(
        [dv, dx.ravel()])
    calls = _count(monkeypatch, ['csr_spmm_sddmm'])
    v = T.vals.clone().requires_grad_()
    xt = torch.tensor(x, requires_grad=True)
    loss = ((tops.laplacian_op(T.with_vals(v), 'normalized') @ xt) ** 2).sum()
    gv, gx = torch.autograd.grad(loss, (v, xt), create_graph=True)
    assert calls['csr_spmm_sddmm'] == 0
    hv, hx = torch.autograd.grad(
        (gv * torch.from_numpy(dv)).sum() + (gx * torch.from_numpy(dx)).sum(),
        (v, xt))
    _close(np.concatenate([hv.numpy(), hx.numpy().ravel()]), want)


# ---------------------------------------------------------------------------
# the kernel's walk and its reduction, emulated
# ---------------------------------------------------------------------------

def _emulate_fused_walk(rowptr, cols, n_edges, steps, with_diag):
    """csrc/csr_spmm.cu's csr_spmm_sddmm_kernel, segment by segment: which
    warp takes each edge's dot and each diagonal entry, and the row of t
    the dot reads (the row in progress when the walk reaches the edge).
    Returns (edge -> [(warp, row)], row -> [warp])."""
    rp = rowptr.tolist()
    n_rows, nnz = len(rp) - 1, rp[-1]
    rows, edges = csr_kernel.csr_segments(rowptr, n_edges, steps).tolist()
    n_seg = len(rows)
    dots, diag = {}, {}
    for w in range(n_seg):
        if rows[w] >= n_rows:
            continue
        e0 = min(edges[w], nnz)
        last = w + 1 == n_seg
        r_stop = n_rows if last else rows[w + 1]
        e1 = nnz if last else min(edges[w + 1], nnz)
        st = {'r': rows[w], 'rs': rp[rows[w]], 're': rp[rows[w] + 1]}

        def flush():
            r, rs = st['r'], st['rs']
            if with_diag and rs >= e0:
                diag.setdefault(r, []).append(w)
            st.update(r=r + 1, rs=st['re'],
                      re=rp[r + 2] if r + 1 < n_rows else nnz)

        for e in range(e0, e1):
            while e >= st['re']:
                flush()
            dots.setdefault(e, []).append((w, st['r']))
        while st['r'] < n_rows and (st['r'] < r_stop or st['rs'] < e1):
            flush()
    return dots, diag


@pytest.mark.parametrize('steps', [3, 16, 256])
@pytest.mark.parametrize('case', ['duplicates', 'not_symmetric',
                                  'rectangular', 'empty_runs'])
def test_fused_walk_takes_every_dot_once(case, steps):
    if case == 'empty_runs':      # runs of empty rows, an empty first/last
        A = sps.lil_matrix((300, 300))
        A[17] = A[250] = np.arange(1, 301)
        A[20:23, 5] = 1.0
        A = A.tocoo()
        rows, cols, vals, shape, summed = A.row, A.col, A.data, A.shape, True
    else:
        rows, cols, vals, shape, summed = _matrix(case)
    M = tsp.from_coo(rows, cols, vals, *shape, sum_duplicates=summed, **CPU64)
    square = shape[0] == shape[1]
    dots, diag = _emulate_fused_walk(M.rowptr, M.cols, M.n_edges_padded,
                                     steps, square)
    want_rows = M.rows[:M.nnz].tolist()
    assert sorted(dots) == list(range(M.nnz))
    assert all(len(v) == 1 and v[0][1] == want_rows[e]
               for e, v in dots.items())
    if square:
        assert sorted(diag) == list(range(shape[0]))
        assert all(len(v) == 1 for v in diag.values())


def _butterfly(p, half):
    """csr_sddmm.cu's butterfly of the lanes' partials ``p`` (32,): lane
    k adds lane k ^ off, off from ``half`` down to 1; lane 0's value."""
    v = p.copy()
    off = half
    while off:
        v = v + v[np.arange(32) ^ off]
        off //= 2
    return v[0]


def _split_then_butterfly(d, half):
    """csr_spmm.cu's split_dots then butterfly on d (32 lanes, K edges):
    each lane's value and where edge u lands, lane u · 2·half / K."""
    d = d.copy()
    lane = np.arange(32)
    k, h = d.shape[1], half
    while k > 1:
        upper = (lane & h) != 0
        lo, hi = d[:, :k // 2], d[:, k // 2:k]
        send = np.where(upper[:, None], lo, hi)
        recv = send[lane ^ h]
        d[:, :k // 2] = np.where(upper[:, None], hi, lo) + recv
        k //= 2
        h //= 2
    v = d[:, 0]
    while h:
        v = v + v[lane ^ h]
        h //= 2
    return v


@pytest.mark.parametrize('half', [4, 8, 16])
@pytest.mark.parametrize('k', [1, 2, 4, 8])
def test_split_reduction_is_the_sddmm_butterfly(k, half):
    """In float32 and bit for bit: the fused entry's reduction of K
    edges' partials gives each edge the SDDMM's sum, lanes past 2·half
    holding zeros as the fused entry's lanes past S do."""
    rng = np.random.default_rng(k * 100 + half)
    for _ in range(20):
        d = np.zeros((32, k), np.float32)
        d[:2 * half] = rng.normal(size=(2 * half, k)).astype(np.float32)
        got = _split_then_butterfly(d, half)
        for u in range(k):
            assert got[u * 2 * half // k] == _butterfly(d[:, u], half)
