"""Gradients through the graph's weights on the CSR path, against
``jax.grad`` of the JAX package, in float64 on the CPU.

The loss is ``⟨ḡ, cheby_op(laplacian_op(W.with_vals(w), lap_type), λmax, c,
x)⟩`` with ḡ, c and x made with numpy from a seed; λmax is pinned. The port
differentiates it through ``_ChebyOp`` (the terms kept, a Clenshaw adjoint,
one SDDMM a step); JAX through its scan. The two take their sums in other
orders, so they are held within 1e-12 of the largest |gradient|, on every
stored entry, with the padding's cotangent exactly 0 in both. Also here:
λmax as a tensor against a central difference and against JAX, a
directional difference along a seeded δw (no JAX), the SpMM's own backward
against ``jax.grad`` of ``pygsp_tpu.core.sparse.spmm``, the SDDMM's plain
version against a numpy loop, the forward bit-equal with and without
grad, the synthesis on CSR through the weights (and its ``ValueError``
on the other formats, where ``cheby_op`` matches the CSR route), second
derivatives (``create_graph=True``) through
``L @ x`` against ``jax.hessian`` and through a bank in ``x`` alone, and
``_ChebyOp`` keeping no slab where ``x`` alone requires grad."""

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


def _graph(name):
    """A host scipy adjacency from the JAX package's graph zoo."""
    if name == 'ring16':
        return jgsp.graphs.Ring(16).W
    if name == 'sensor64':
        return jgsp.graphs.Sensor(64, seed=1).W
    return jgsp.graphs.BarabasiAlbert(300, seed=2).W


def _pair(W, dup=False):
    """The JAX and port CSR adjacencies of ``W``; with ``dup`` every
    stored entry is split into two stored entries (70 % and 30 % of its
    weight) and duplicates are kept (``sum_duplicates=False``)."""
    coo = sps.coo_matrix(W)
    rows, cols, vals = coo.row, coo.col, coo.data.astype(np.float64)
    if dup:
        rows = np.concatenate([rows, rows])
        cols = np.concatenate([cols, cols])
        vals = np.concatenate([0.7 * vals, 0.3 * vals])
    n = W.shape[0]
    J = jsp.from_coo(rows, cols, vals, n, dtype=jnp.float64,
                     sum_duplicates=not dup)
    T = tsp.from_coo(rows, cols, vals, n, sum_duplicates=not dup, **CPU64)
    assert np.array_equal(np.asarray(J.rows), T.rows.numpy())
    assert np.array_equal(np.asarray(J.cols), T.cols.numpy())
    return J, T


def _lmax(W, lap_type):
    if lap_type == 'normalized':
        return 2.0
    L = np.diag(np.ravel(W.sum(axis=1))) - W.toarray()
    return 1.05 * float(np.linalg.eigvalsh(L)[-1])


def _inputs(n, nf, s, m1, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(nf, m1)), rng.normal(size=(n, s)),
            rng.normal(size=(nf, n, s)))


def _jax_grads(J, lap_type, lmax, c, x, gbar):
    def loss(w, c_, x_, lmax_):
        L = jops.laplacian_op(J.with_vals(w), lap_type)
        return jnp.sum(jnp.asarray(gbar)
                       * jcheby.cheby_op(L, lmax_, c_, x_))
    grads = jax.grad(loss, argnums=(0, 1, 2, 3))(
        J.vals, jnp.asarray(c), jnp.asarray(x), jnp.float64(lmax))
    return [np.asarray(g) for g in grads]


def _port_loss(T, lap_type, lmax, c, x, gbar, w=None):
    L = tops.laplacian_op(T.with_vals(T.vals if w is None else w), lap_type)
    return (torch.as_tensor(gbar) * tcheby.cheby_op(L, lmax, c, x)).sum()


def _port_grads(T, lap_type, lmax, c, x, gbar):
    w = T.vals.clone().requires_grad_()
    ct = torch.tensor(c, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    lt = torch.tensor(lmax, dtype=torch.float64, requires_grad=True)
    _port_loss(T, lap_type, lt, ct, xt, gbar, w).backward()
    return [t.grad.numpy() for t in (w, ct, xt, lt)]


def _close(got, want, tol=TOL):
    """max |got − want| within ``tol`` of the largest |want|."""
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-300)
    assert float(np.abs(got - want).max()) <= tol * scale


# (graph, m + 1, S, Nf): every order with both widths and both bank sizes
CASES = [('ring16', 2, 1, 1), ('sensor64', 3, 3, 4), ('ba300', 4, 3, 1),
         ('sensor64', 31, 1, 4), ('ba300', 31, 3, 4), ('ring16', 4, 1, 4)]


@pytest.mark.parametrize('lap_type', ['combinatorial', 'normalized'])
@pytest.mark.parametrize('graph,m1,s,nf', CASES)
def test_weight_grads_match_jax(graph, m1, s, nf, lap_type):
    W = _graph(graph)
    J, T = _pair(W)
    lmax = _lmax(W, lap_type)
    c, x, gbar = _inputs(W.shape[0], nf, s, m1, seed=m1 + s)
    want = _jax_grads(J, lap_type, lmax, c, x, gbar)
    got = _port_grads(T, lap_type, lmax, c, x, gbar)
    for g, w in zip(got[:3], want[:3]):
        _close(g, w)
    # λmax: to rounding of the sum of the terms' dots
    assert abs(got[3] - want[3]) <= 1e-10 * max(abs(float(want[3])), 1.0)
    # every stored entry gets a cotangent, the padding exactly 0 in both
    nnz = T.nnz
    assert T.n_edges_padded > nnz
    assert not np.any(got[0][nnz:]) and not np.any(want[0][nnz:])
    assert np.all(got[0][:nnz] != 0)


@pytest.mark.parametrize('lap_type', ['combinatorial', 'normalized'])
def test_duplicate_entries_keep_their_own_cotangents(lap_type):
    W = _graph('sensor64')
    J, T = _pair(W, dup=True)
    assert T.nnz == 2 * W.nnz
    lmax = _lmax(W, lap_type)
    c, x, gbar = _inputs(W.shape[0], 2, 3, 6, seed=7)
    want = _jax_grads(J, lap_type, lmax, c, x, gbar)
    got = _port_grads(T, lap_type, lmax, c, x, gbar)
    for g, w in zip(got[:3], want[:3]):
        _close(g, w)
    assert not np.any(got[0][T.nnz:])


@pytest.mark.parametrize('lap_type', ['combinatorial', 'normalized'])
def test_weights_that_are_not_symmetric_match_jax(lap_type):
    """Weights off symmetry (as an optimizer's step leaves them): the
    adjoint runs on the transpose, so the gradient stays JAX's."""
    W = _graph('sensor64').tocoo()
    factor = np.random.default_rng(8).uniform(0.5, 1.5, size=W.nnz)
    W = sps.coo_matrix((W.data * factor, (W.row, W.col)), shape=W.shape)
    J, T = _pair(W)
    lmax = 1.1 * _lmax(W, lap_type)
    c, x, gbar = _inputs(64, 3, 2, 11, seed=13)
    want = _jax_grads(J, lap_type, lmax, c, x, gbar)
    got = _port_grads(T, lap_type, lmax, c, x, gbar)
    for g, w in zip(got[:3], want[:3]):
        _close(g, w)


@pytest.mark.parametrize('lap_type', ['combinatorial', 'normalized'])
def test_lmax_grad_against_a_central_difference(lap_type):
    W = _graph('sensor64')
    _, T = _pair(W)
    lmax = _lmax(W, lap_type) * 1.1
    c, x, gbar = _inputs(W.shape[0], 3, 2, 12, seed=3)
    ct, xt = torch.from_numpy(c), torch.from_numpy(x)
    lt = torch.tensor(lmax, dtype=torch.float64, requires_grad=True)
    _port_loss(T, lap_type, lt, ct, xt, gbar).backward()
    h = 1e-6 * lmax
    with torch.no_grad():
        fd = (_port_loss(T, lap_type, lmax + h, ct, xt, gbar)
              - _port_loss(T, lap_type, lmax - h, ct, xt, gbar)) / (2 * h)
    assert abs(float(lt.grad) - float(fd)) <= 1e-7 * abs(float(fd))


@pytest.mark.parametrize('lap_type', ['combinatorial', 'normalized'])
def test_weight_grad_along_a_direction(lap_type):
    """⟨w̄, δw⟩ against a central difference of the loss along a seeded
    δw on the stored entries, without JAX."""
    W = _graph('ba300')
    _, T = _pair(W)
    lmax = _lmax(W, lap_type) * 1.2     # room for the step in w
    c, x, gbar = _inputs(W.shape[0], 2, 3, 16, seed=11)
    ct, xt = torch.from_numpy(c), torch.from_numpy(x)
    w = T.vals.clone().requires_grad_()
    _port_loss(T, lap_type, lmax, ct, xt, gbar, w).backward()
    rng = np.random.default_rng(12)
    dw = torch.zeros_like(T.vals)
    dw[:T.nnz] = torch.from_numpy(rng.normal(size=T.nnz))
    h = 1e-6
    with torch.no_grad():
        fd = (_port_loss(T, lap_type, lmax, ct, xt, gbar, T.vals + h * dw)
              - _port_loss(T, lap_type, lmax, ct, xt, gbar,
                           T.vals - h * dw)) / (2 * h)
    got = float((w.grad * dw).sum())
    assert abs(got - float(fd)) <= 1e-7 * abs(float(fd))


@pytest.mark.parametrize('graph,m1', [('ring16', 10), ('sensor64', 4)])
def test_the_fault_reproduction_now_runs(graph, m1):
    """The call that failed with autograd's in-place error: the ring of
    terms overwrote a slot that the plain SpMM had saved for the weights'
    gradient."""
    W = _graph(graph)
    M = tsp.from_scipy(W, **CPU64)
    v = M.vals.clone().requires_grad_()
    L = tops.laplacian_op(M.with_vals(v))
    rng = np.random.default_rng(0)
    c = torch.from_numpy(rng.normal(size=(2, m1)))
    x = torch.from_numpy(rng.normal(size=(W.shape[0], 3)))
    tcheby.cheby_op(L, 4.0, c, x).sum().backward()
    assert v.grad is not None and torch.isfinite(v.grad).all()
    assert not v.grad[M.nnz:].any()


@pytest.mark.parametrize('group', ['1', '4'])
def test_forward_is_bit_equal_with_and_without_grad(group, monkeypatch):
    """The slab that the backward keeps changes no bit of the bank, at a
    group of one and of four terms."""
    monkeypatch.setenv('PYGSP_CHEBY_ACC_GROUP', group)
    W = _graph('sensor64')
    _, T = _pair(W)
    c, x, _ = _inputs(W.shape[0], 3, 4, 15, seed=5)
    ct, xt = torch.from_numpy(c), torch.from_numpy(x)
    L = tops.laplacian_op(T)
    plain = tcheby.cheby_op(L, 3.0, ct, xt)
    w = T.vals.clone().requires_grad_()
    recorded = tcheby.cheby_op(tops.laplacian_op(T.with_vals(w)), 3.0, ct,
                               xt)
    assert recorded.requires_grad
    assert torch.equal(recorded.detach(), plain)


@pytest.mark.parametrize('need', ['x', 'c', 'lmax', 'w'])
def test_each_input_alone(need):
    """One input requiring grad at a time gives that input's gradient, the
    same as when all of them require it."""
    W = _graph('ring16')
    _, T = _pair(W)
    c, x, gbar = _inputs(16, 2, 3, 7, seed=9)
    full = _port_grads(T, 'combinatorial', 5.0, c, x, gbar)
    w = T.vals.clone().requires_grad_(need == 'w')
    ct = torch.tensor(c, requires_grad=need == 'c')
    xt = torch.tensor(x, requires_grad=need == 'x')
    lt = torch.tensor(5.0, dtype=torch.float64, requires_grad=need == 'lmax')
    _port_loss(T, 'combinatorial', lt, ct, xt, gbar, w).backward()
    got = {'w': w, 'c': ct, 'x': xt, 'lmax': lt}[need].grad.numpy()
    want = full[['w', 'c', 'x', 'lmax'].index(need)]
    _close(got, want, 1e-14)


@pytest.mark.parametrize('s', [1, 3])
def test_spmm_backward_matches_jax(s):
    W = _graph('ba300')
    J, T = _pair(W)
    rng = np.random.default_rng(s)
    x = rng.normal(size=(W.shape[0], s))
    ybar = rng.normal(size=(W.shape[0], s))
    want = jax.grad(lambda v, x_: jnp.sum(jnp.asarray(ybar)
                                          * jsp.spmm(J.with_vals(v), x_)),
                    argnums=(0, 1))(J.vals, jnp.asarray(x))
    v = T.vals.clone().requires_grad_()
    xt = torch.tensor(x, requires_grad=True)
    (torch.from_numpy(ybar) * tsp.spmm(T.with_vals(v), xt)).sum().backward()
    _close(v.grad.numpy(), np.asarray(want[0]))
    _close(xt.grad.numpy(), np.asarray(want[1]))
    assert not v.grad[T.nnz:].any()


def test_matvec_and_dirichlet_energy_differentiate():
    """``L @ x`` through W's values and x, against JAX's."""
    W = _graph('sensor64')
    J, T = _pair(W)
    x = np.random.default_rng(4).normal(size=(64, 2))
    want = jax.grad(lambda v, x_: jnp.sum(
        x_ * jops.matvec(jops.laplacian_op(J.with_vals(v)), x_)),
        argnums=(0, 1))(J.vals, jnp.asarray(x))
    v = T.vals.clone().requires_grad_()
    xt = torch.tensor(x, requires_grad=True)
    (xt * (tops.laplacian_op(T.with_vals(v)) @ xt)).sum().backward()
    _close(v.grad.numpy(), np.asarray(want[0]))
    _close(xt.grad.numpy(), np.asarray(want[1]))


@pytest.mark.parametrize('s', [1, 3, 17])
@pytest.mark.parametrize('diag', [False, True])
def test_sddmm_plain_against_a_numpy_loop(s, diag):
    W = _graph('sensor64')
    _, T = _pair(W)
    rng = np.random.default_rng(s)
    n = W.shape[0]
    u, t = rng.normal(size=(n, s)), rng.normal(size=(n, s))
    out0 = rng.normal(size=T.n_edges_padded)
    out0[T.nnz:] = 0.0
    d0 = rng.normal(size=n)
    out = torch.from_numpy(out0.copy())
    dg = torch.from_numpy(d0.copy()) if diag else None
    got = csr_kernel.csr_sddmm(T.rows, T.cols, torch.from_numpy(u),
                               torch.from_numpy(t), out, 0.75, dg)
    assert got is out
    rows, cols = T.rows.numpy(), T.cols.numpy()
    want = out0.copy()
    for e in range(T.nnz):
        want[e] += 0.75 * sum(u[rows[e], k] * t[cols[e], k]
                              for k in range(s))
    assert np.allclose(out.numpy(), want, rtol=1e-14, atol=1e-14)
    assert not out[T.nnz:].any()
    if diag:
        want_d = d0 + 0.75 * np.einsum('ik,ik->i', u, t)
        assert np.allclose(dg.numpy(), want_d, rtol=1e-14, atol=1e-14)
    # a 0-dim alpha: the same result
    out2 = torch.from_numpy(out0.copy())
    csr_kernel.csr_sddmm(T.rows, T.cols, torch.from_numpy(u),
                         torch.from_numpy(t), out2,
                         torch.tensor(0.75, dtype=torch.float64))
    assert torch.equal(out2, out)


def test_sddmm_refuses_bad_operands():
    _, T = _pair(_graph('ring16'))
    u = torch.zeros(16, 2, dtype=torch.float64)
    out = torch.zeros_like(T.vals)
    with pytest.raises(ValueError, match='u \\(n_rows, S\\)'):
        csr_kernel.csr_sddmm(T.rows, T.cols, u, u[:, :1], out, 1.0)
    with pytest.raises(ValueError, match='one dtype'):
        csr_kernel.csr_sddmm(T.rows, T.cols, u, u.float(), out, 1.0)
    with pytest.raises(ValueError, match='int32'):
        csr_kernel.csr_sddmm(T.rows.long(), T.cols, u, u, out, 1.0)
    with pytest.raises(ValueError, match='out_diag'):
        csr_kernel.csr_sddmm(T.rows, T.cols, u, u, out, 1.0,
                             torch.zeros(3, dtype=torch.float64))
    with pytest.raises(ValueError, match='runs on cuda or cpu'):
        csr_kernel.csr_sddmm(*(a.to('meta') for a in (T.rows, T.cols, u, u,
                                                      out)), 1.0)


@pytest.mark.parametrize('lap_type', ['combinatorial', 'normalized'])
def test_synthesis_through_the_weights_matches_jax(lap_type):
    """``cheby_synthesis`` on CSR differentiates through W by the plain
    recurrence on the CPU, its buffers no longer reused under autograd."""
    W = _graph('sensor64')
    J, T = _pair(W)
    lmax = _lmax(W, lap_type)
    rng = np.random.default_rng(2)
    c = rng.normal(size=(3, 9))
    bank = rng.normal(size=(64, 2, 3))
    ybar = rng.normal(size=(64, 2))
    want = jax.grad(lambda v: jnp.sum(jnp.asarray(ybar) * jcheby
                                      .cheby_synthesis(jops.laplacian_op(
                                          J.with_vals(v), lap_type), lmax,
                                          jnp.asarray(c),
                                          jnp.asarray(bank))))(J.vals)
    v = T.vals.clone().requires_grad_()
    out = tcheby.cheby_synthesis(tops.laplacian_op(T.with_vals(v), lap_type),
                                 lmax, torch.from_numpy(c),
                                 torch.from_numpy(bank))
    (torch.from_numpy(ybar) * out).sum().backward()
    _close(v.grad.numpy(), np.asarray(want))


@pytest.mark.parametrize('fmt', ['hybrid', 'chunked', 'windowed', 'banded'])
def test_other_formats_refuse_a_gradient_through_the_operator(fmt):
    """``cheby_op`` differentiates through the operator on every format: a
    grad-requiring diagonal, value leaves or λmax give the cotangents of a
    CSR operator with the same entries (within 1e-12 of the largest);
    so does ``cheby_synthesis`` through a grad-requiring diagonal (its
    diag̅ against the CSR route's); ``x`` alone still differentiates by
    the plain recurrence on the CPU."""
    import pygsp_tpu_torch as tgsp
    G = tgsp.graphs.Grid2d(12, 10, **CPU64)
    L = {'hybrid': lambda: G.L.to_hybrid(),
         'chunked': lambda: G.L.to_chunked(),
         'windowed': lambda: G.L.to_windowed(),
         'banded': lambda: G.L.to_banded()}[fmt]()
    c = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 6)))
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(G.N, 2)))
    g = torch.from_numpy(np.random.default_rng(2).normal(size=(2, G.N, 2)))

    def grads(off):
        diag = L.diag.clone().requires_grad_()
        leaves = [v.clone().requires_grad_() for v in off.leaves()]
        lt = torch.tensor(8.0, dtype=torch.float64, requires_grad=True)
        Lg = tops.LaplacianOp(offdiag=off.with_leaves(leaves), diag=diag,
                              lap_type=L.lap_type)
        (tcheby.cheby_op(Lg, lt, c, x) * g).sum().backward()
        return diag.grad.numpy(), lt.grad.numpy(), leaves

    C = tsp.from_scipy(tsp.to_scipy(L.offdiag), **CPU64)
    want = grads(C)
    got = grads(L.offdiag)
    _close(got[0], want[0])
    assert abs(float(got[1]) - float(want[1])) <= 1e-10 * abs(float(want[1]))
    entries = sps.csr_matrix((want[2][0].grad[:C.nnz].numpy(),
                              (C.rows[:C.nnz].numpy(),
                               C.cols[:C.nnz].numpy())), shape=C.shape)
    if fmt == 'banded':          # the tiles' cotangent at the edges' places
        tiles = got[2][0].grad.numpy()
        i, d, a, b = np.nonzero(L.offdiag.tiles.numpy())
        rows, cols = i * 128 + a, (i + d - L.offdiag.half_bw) * 128 + b
        _close(tiles[i, d, a, b], np.asarray(entries[rows, cols]).ravel())
    else:
        off = tcheby._internal(L.offdiag)
        rows, cols, index = off.live_slots()
        perm = getattr(L.offdiag, 'perm', None)
        if perm is not None:
            rows, cols = perm[rows], perm[cols]
        flat = torch.cat([v.grad.reshape(-1) for v in got[2]])
        _close(flat[index].numpy(),
               np.asarray(entries[np.array(rows), np.array(cols)]).ravel())
    xs = x[..., None].expand(G.N, 2, 2).contiguous()
    ys = g[0]

    def synthesis_diag_bar(off):
        diag = L.diag.clone().requires_grad_()
        Lg = tops.LaplacianOp(offdiag=off, diag=diag, lap_type=L.lap_type)
        (tcheby.cheby_synthesis(Lg, 8.0, c, xs) * ys).sum().backward()
        return diag.grad.numpy()

    _close(synthesis_diag_bar(L.offdiag), synthesis_diag_bar(C))
    Lg = tops.LaplacianOp(offdiag=L.offdiag, diag=L.diag, lap_type=L.lap_type)
    xt = x.clone().requires_grad_()
    tcheby.cheby_op(L, 8.0, c, xt).sum().backward()
    assert torch.isfinite(xt.grad).all()
    with torch.no_grad():                       # unrecorded
        tcheby.cheby_synthesis(Lg, 8.0, c, x[..., None].expand(G.N, 2, 2)
                               .contiguous())


def _hvp_case(lap_type):
    W = _graph('ring16')
    J, T = _pair(W)
    rng = np.random.default_rng(12)
    x = rng.normal(size=(16, 2))
    dv = np.zeros(T.n_edges_padded)
    dv[:T.nnz] = rng.normal(size=T.nnz)
    return J, T, x, dv, rng.normal(size=(16, 2))


@pytest.mark.parametrize('lap_type', ['combinatorial', 'normalized'])
def test_matvec_differentiates_twice(lap_type):
    """A Hessian-vector product through ``L @ x`` (``create_graph=True``):
    the SpMM's backward is made of the SpMM and the SDDMM as functions of
    their own, so it differentiates again; held against ``jax.hessian`` of
    the JAX package's loss over (W's values, x)."""
    J, T, x, dv, dx = _hvp_case(lap_type)
    e = T.n_edges_padded

    def jloss(z):
        L = jops.laplacian_op(J.with_vals(z[:e]), lap_type)
        return jnp.sum(jops.matvec(L, z[e:].reshape(16, 2)) ** 2)

    z0 = np.concatenate([np.asarray(J.vals), x.ravel()])
    want = np.asarray(jax.hessian(jloss)(jnp.asarray(z0))) @ np.concatenate(
        [dv, dx.ravel()])
    v = T.vals.clone().requires_grad_()
    xt = torch.tensor(x, requires_grad=True)
    loss = ((tops.laplacian_op(T.with_vals(v), lap_type) @ xt) ** 2).sum()
    gv, gx = torch.autograd.grad(loss, (v, xt), create_graph=True)
    hv, hx = torch.autograd.grad(
        (gv * torch.from_numpy(dv)).sum() + (gx * torch.from_numpy(dx)).sum(),
        (v, xt))
    _close(np.concatenate([hv.numpy(), hx.numpy().ravel()]), want)
    assert not hv[T.nnz:].any()


def test_cheby_op_through_x_alone_differentiates_twice():
    """On the CPU a bank through ``x`` alone runs the plain recurrence
    under autograd, so a Hessian-vector product of ``‖cheby_op‖²`` in x
    holds against JAX's."""
    W = _graph('sensor64')
    J, T = _pair(W)
    c, x, _ = _inputs(64, 3, 2, 9, seed=21)
    dx = np.random.default_rng(22).normal(size=x.shape)
    jL = jops.laplacian_op(J)

    def jloss(x_):
        return jnp.sum(jcheby.cheby_op(jL, 3.0, jnp.asarray(c), x_) ** 2)

    want = jax.jvp(jax.grad(jloss), (jnp.asarray(x),),
                   (jnp.asarray(dx),))[1]
    xt = torch.tensor(x, requires_grad=True)
    out = tcheby.cheby_op(tops.laplacian_op(T), 3.0, torch.from_numpy(c), xt)
    gx, = torch.autograd.grad((out ** 2).sum(), xt, create_graph=True)
    hx, = torch.autograd.grad((gx * torch.from_numpy(dx)).sum(), xt)
    _close(hx.numpy(), np.asarray(want))


def test_chebyop_through_x_alone_keeps_no_slab():
    """``_ChebyOp`` (the card's route) with ``x`` alone requiring grad
    keeps the ring, not the (m+1)-term slab: x̄ reads no term. Its x̄
    against the plain recurrence's under autograd."""
    W = _graph('ba300')
    _, T = _pair(W)
    c, x, gbar = _inputs(300, 2, 3, 12, seed=23)
    L = tops.laplacian_op(T)
    ct, g = torch.from_numpy(c), torch.from_numpy(gbar)
    xt = torch.tensor(x, requires_grad=True)
    out = tcheby._ChebyOp.apply(L, L.offdiag.vals, L.diag, 7.0, ct, xt)
    assert out.grad_fn.saved_tensors[3] is None
    (out * g).sum().backward()
    xp = torch.tensor(x, requires_grad=True)
    (tcheby.cheby_op(L, 7.0, ct, xp) * g).sum().backward()
    _close(xt.grad.numpy(), xp.grad.numpy())


def test_c_alone_at_31_terms_matches_jax():
    """``c`` alone requiring grad at m+1 = 31: the plain recurrence under
    autograd failed here (the ring overwrote the terms that the grouped
    accumulation had saved); ``_ChebyOp`` gives c̄ as JAX does."""
    W = _graph('ring16')
    J, T = _pair(W)
    c, x, gbar = _inputs(16, 2, 3, 31, seed=24)
    want = _jax_grads(J, 'combinatorial', 5.0, c, x, gbar)[1]
    ct = torch.tensor(c, requires_grad=True)
    _port_loss(T, 'combinatorial', 5.0, ct, torch.from_numpy(x),
               gbar).backward()
    _close(ct.grad.numpy(), want)
