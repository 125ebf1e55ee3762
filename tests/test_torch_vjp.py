"""The training path against pygsp_tpu, in float64 on the CPU:
``cheby_op_fixed_graph`` (its forward, and c̄ and x̄ against ``jax.vjp``
through the JAX package's custom VJP, on the CSR, banded and windowed
formats, the windowed one with a shuffled vertex order), the coefficient
gradient's plain version (``cheby_dot_group_plain``),
``Filter.filter(fixed_graph=True)`` and its errors, three SGD steps of the
filter-learning model, and the guard that keeps the CUDA kernels out of
autograd. λmax is pinned from the JAX side; inputs come from numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygsp_tpu as jgsp
import pygsp_tpu_torch as tgsp
from pygsp_tpu.ops import chebyshev as jcheby
from pygsp_tpu_torch.core import _cuda, cheby_kernel
from pygsp_tpu_torch.ops import chebyshev as tcheby

from test_torch_synthesis import CPU64, _pair

TOL = 1e-12
FORMATS = ['csr', 'banded', 'windowed']


def _close(got, want, tol=TOL):
    """max |got - want| within ``tol`` of the largest |want| (at least 1)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


def _case(fmt, nf=3, s=4, m=30, seed=0):
    """(JAX operator, port operator, λmax, c, x, ḡ) in ``fmt``."""
    J, T, lmax = _pair(fmt)
    rng = np.random.default_rng(seed)
    n = T.n_vertices
    return (J, T, lmax, rng.normal(size=(nf, m + 1)), rng.normal(size=(n, s)),
            rng.normal(size=(nf, n, s)))


def _jax_vjp(J, lmax, c, x, gbar):
    out, vjp = jax.vjp(lambda c_, x_: jcheby.cheby_op_fixed_graph(
        J, lmax, c_, x_), jnp.asarray(c), jnp.asarray(x))
    c_bar, x_bar = vjp(jnp.asarray(gbar))
    return np.asarray(out), np.asarray(c_bar), np.asarray(x_bar)


def _port_vjp(T, lmax, c, x, gbar):
    ct = torch.tensor(c, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    out = tcheby.cheby_op_fixed_graph(T, lmax, ct, xt)
    out.backward(torch.from_numpy(gbar))
    return out, ct.grad, xt.grad


@pytest.mark.parametrize('fmt', FORMATS)
def test_forward_is_cheby_op(fmt):
    _, T, lmax, c, x, _ = _case(fmt)
    ct, xt = torch.from_numpy(c), torch.from_numpy(x)
    assert torch.equal(tcheby.cheby_op_fixed_graph(T, lmax, ct, xt),
                       tcheby.cheby_op(T, lmax, ct, xt))


@pytest.mark.parametrize('order', [1, 2, 30])
@pytest.mark.parametrize('fmt', FORMATS)
def test_gradients_match_jax_vjp(fmt, order):
    J, T, lmax, c, x, gbar = _case(fmt, m=order, seed=order)
    if fmt == 'windowed':
        assert T.offdiag.perm is not None          # a shuffled vertex order
    want_out, want_c, want_x = _jax_vjp(J, lmax, c, x, gbar)
    out, c_bar, x_bar = _port_vjp(T, lmax, c, x, gbar)
    _close(out, want_out)
    _close(c_bar, want_c)
    _close(x_bar, want_x)


@pytest.mark.parametrize('fmt', FORMATS)
def test_one_dimensional_c_and_x(fmt):
    J, T, lmax, c, x, gbar = _case(fmt, nf=1, s=1, m=12, seed=3)
    c1, x1, g1 = c[0], x[:, 0], gbar[:, :, 0]
    _, want_c, want_x = _jax_vjp(J, lmax, c1, x1, g1)
    out, c_bar, x_bar = _port_vjp(T, lmax, c1, x1, g1)
    assert out.shape == g1.shape and c_bar.shape == (13,)
    assert x_bar.shape == (T.n_vertices,)
    _close(c_bar, want_c)
    _close(x_bar, want_x)


@pytest.mark.parametrize('fmt', ['csr', 'windowed'])
def test_a_sliced_loss_hands_a_strided_cotangent(fmt):
    """The loss reads every other signal of a permuted output: autograd
    hands the backward a cotangent that is not contiguous."""
    J, T, lmax, c, x, gbar = _case(fmt, seed=5)
    w = gbar[:, :, ::2].transpose(1, 2, 0).copy()          # (N, S/2, Nf)

    def jloss(c_, x_):
        out = jnp.moveaxis(jcheby.cheby_op_fixed_graph(J, lmax, c_, x_), 0, -1)
        return jnp.sum(out[:, ::2] * w)

    want_c, want_x = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(c),
                                                      jnp.asarray(x))
    ct = torch.tensor(c, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    out = torch.movedim(tcheby.cheby_op_fixed_graph(T, lmax, ct, xt), 0, -1)
    (out[:, ::2] * torch.from_numpy(w)).sum().backward()
    _close(ct.grad, want_c)
    _close(xt.grad, want_x)


def test_the_context_keeps_c_and_x_only():
    _, T, lmax, c, x, _ = _case('windowed')
    ct = torch.tensor(c, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    out = tcheby.cheby_op_fixed_graph(T, lmax, ct, xt)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 2
    assert saved[0].data_ptr() == ct.data_ptr()
    assert saved[1].data_ptr() == xt.data_ptr()


@pytest.mark.parametrize('fmt', FORMATS)
def test_backward_runs_one_dot_group_per_forward_group_and_t0(
        fmt, monkeypatch):
    """At K = 30 and g = 14: the forward adds its terms in 4 groups (T_1,
    T_2, then two of 14), the c̄ pass contracts 5 (T_0 besides); and x̄'s
    synthesis does not run for an x that does not require grad."""
    monkeypatch.setenv('PYGSP_CHEBY_ACC_GROUP', '14')
    _, T, lmax, c, x, gbar = _case(fmt, nf=4)
    calls = {'group': 0, 'dot': 0, 'contract': 0}
    for name, key in (('cheby_acc_group_plain', 'group'),
                      ('cheby_dot_group_plain', 'dot'),
                      ('cheby_acc_contract_plain', 'contract')):
        plain = getattr(cheby_kernel, name)
        monkeypatch.setattr(cheby_kernel, name,
                            lambda *a, plain=plain, key=key: (
                                calls.__setitem__(key, calls[key] + 1)
                                or plain(*a)))
    ct = torch.tensor(c, requires_grad=True)
    out = tcheby.cheby_op_fixed_graph(T, lmax, ct, torch.from_numpy(x))
    assert calls == {'group': 4, 'dot': 0, 'contract': 0}
    out.backward(torch.from_numpy(gbar))
    assert calls == {'group': 4, 'dot': 5, 'contract': 0}


@pytest.mark.parametrize('start', [0, 5, 9])
@pytest.mark.parametrize('nf', [1, 3, 4, 6])
@pytest.mark.parametrize('shape', [(37, 5), (41,)])
def test_dot_group_plain_matches_an_f64_einsum(shape, nf, start):
    """Groups that wrap around the ring, every filter count."""
    rng = np.random.default_rng(nf * 10 + start)
    g, slots = 7, 11
    terms = rng.normal(size=(slots,) + shape)
    gbar = rng.normal(size=shape + (nf,))
    out = torch.empty((g, nf), dtype=torch.float64)
    cheby_kernel.cheby_dot_group(out, torch.from_numpy(gbar),
                                 torch.from_numpy(terms), start)
    idx = [(start + j) % slots for j in range(g)]
    want = np.einsum('jn,nf->jf', terms[idx].reshape(g, -1),
                     gbar.reshape(-1, nf))
    assert np.allclose(out.numpy(), want, rtol=0, atol=1e-12)


def test_dot_group_refuses_bad_operands():
    terms = torch.zeros(4, 10, 3, dtype=torch.float64)
    gbar = torch.zeros(10, 3, 2, dtype=torch.float64)
    for out, gb, t in ((torch.zeros(5, 2, dtype=torch.float64), gbar, terms),
                       (torch.zeros(2, 3, dtype=torch.float64), gbar, terms),
                       (torch.zeros(2, 2, dtype=torch.float64),
                        gbar.float(), terms),
                       (torch.zeros(2, dtype=torch.float64), gbar, terms)):
        with pytest.raises(ValueError, match='cheby_dot_group'):
            cheby_kernel.cheby_dot_group(out, gb, t)


# ---------------------------------------------------------------------------
# Filter.filter(fixed_graph=True) and the filter-learning model
# ---------------------------------------------------------------------------

def _grid_pair():
    J = jgsp.graphs.Grid2d(9, 7)
    J.estimate_lmax(method='bounds')
    T = tgsp.graphs.Grid2d(9, 7, **CPU64)
    T._lmax, T._lmax_method = J.lmax, 'pinned'
    return J, T


def test_filter_gradient_reaches_a_kernel_parameter():
    """A kernel that closes over a parameter: its gradient flows through
    cheby_coeff and the VJP, as the JAX package's does."""
    J, T = _grid_pair()
    lmax = J.lmax
    rng = np.random.default_rng(8)
    x, w = rng.normal(size=(T.N, 3)), rng.normal(size=(T.N, 3, 2))
    tau0 = np.array([2.0, 7.0])

    def jloss(tau):
        c = jcheby.cheby_coeff(
            lambda lam: jnp.exp(-tau[:, None] * lam[None, :] / lmax), lmax,
            m=30)
        out = jnp.moveaxis(jcheby.cheby_op_fixed_graph(
            J.L, lmax, c, jnp.asarray(x)), 0, -1)
        return jnp.sum(out * w)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(tau0)))
    tau = torch.tensor(tau0, requires_grad=True)
    g = tgsp.filters.Filter(T, [lambda lam, i=i: torch.exp(-tau[i] * lam / lmax)
                                for i in range(2)])
    out = g.filter(x, fixed_graph=True)
    assert out.shape == (T.N, 3, 2)
    (out * torch.from_numpy(w)).sum().backward()
    _close(tau.grad, want)


def test_filter_fixed_graph_keeps_the_jax_errors():
    J, T = _grid_pair()
    jg, tg = jgsp.filters.Heat(J, [1.0, 3.0]), tgsp.filters.Heat(T, [1.0, 3.0])
    s = np.zeros((T.N, 2, 2))
    for kw, sig in ((dict(vals_dtype=(jnp.bfloat16, torch.bfloat16)), s[:, 0]),
                    (dict(method=('lanczos', 'lanczos')), s[:, 0]),
                    (dict(method=('exact', 'exact')), s[:, 0]),
                    ({}, s)):                         # synthesis direction
        with pytest.raises(ValueError) as jerr:
            jg.filter(sig, fixed_graph=True,
                      **{k: v[0] for k, v in kw.items()})
        with pytest.raises(ValueError) as terr:
            tg.filter(sig, fixed_graph=True,
                      **{k: v[1] for k, v in kw.items()})
        assert str(terr.value) == str(jerr.value)


def _softplus_inv(y):
    return np.log(np.expm1(y))


def test_three_sgd_steps_of_filter_learning_match_jax():
    """examples/filter_learning.py's model (softplus heat scales, a mix,
    MSE against a teacher bank), three plain SGD steps in both packages
    from the same parameters."""
    J, T = _grid_pair()
    lmax, K, lr = J.lmax, 20, 0.05
    x = np.random.default_rng(0).normal(size=(T.N, 6))
    teacher = (np.array([3.0, 25.0]), np.array([0.7, 0.3]))
    start = (_softplus_inv(np.array([1.0, 10.0])), np.array([0.5, 0.5]))

    def jbank(raw, mix):
        sc = jax.nn.softplus(raw)
        c = jcheby.cheby_coeff(
            lambda lam: jnp.exp(-sc[:, None] * lam[None, :] / lmax), lmax,
            m=K)
        out = jcheby.cheby_op_fixed_graph(J.L, lmax, c, jnp.asarray(x))
        return jnp.einsum('f,fns->ns', mix, out)

    y = jbank(jnp.asarray(_softplus_inv(teacher[0])), jnp.asarray(teacher[1]))
    jgrad = jax.jit(jax.grad(lambda raw, mix: jnp.mean(
        (jbank(raw, mix) - y) ** 2), argnums=(0, 1)))
    jp = [jnp.asarray(p) for p in start]
    for _ in range(3):
        jp = [p - lr * g for p, g in zip(jp, jgrad(*jp))]

    def tbank(raw, mix):
        sc = torch.nn.functional.softplus(raw)
        c = tcheby.cheby_coeff(
            lambda lam: torch.exp(-sc[:, None] * lam[None, :] / lmax), lmax,
            m=K, dtype=torch.float64, device='cpu')
        out = tcheby.cheby_op_fixed_graph(T.L, lmax, c, torch.from_numpy(x))
        return torch.einsum('f,fns->ns', mix, out)

    ty = torch.from_numpy(np.asarray(y))
    tp = [torch.tensor(p, requires_grad=True) for p in start]
    losses = []
    for _ in range(3):
        loss = torch.mean((tbank(*tp) - ty) ** 2)
        losses.append(float(loss))
        grads = torch.autograd.grad(loss, tp)
        tp = [(p - lr * g).detach().requires_grad_() for p, g in zip(tp,
                                                                    grads)]
    assert losses[-1] < losses[0]
    for got, want in zip(tp, jp):
        assert np.allclose(got.detach().numpy(), np.asarray(want), rtol=0,
                           atol=1e-10)


# ---------------------------------------------------------------------------
# the guard on the kernel routes
# ---------------------------------------------------------------------------

def test_refuse_autograd_raises_under_grad_mode_only():
    a = torch.zeros(3, requires_grad=True)
    b = torch.zeros(3)
    with pytest.raises(RuntimeError, match='cheby_op_fixed_graph'):
        _cuda.refuse_autograd('csr_spmm', b, a)
    _cuda.refuse_autograd('csr_spmm', b, b)          # nothing requires grad
    with torch.no_grad():
        _cuda.refuse_autograd('csr_spmm', b, a)


def test_refuse_autograd_passes_inside_an_autograd_function():
    """The fixed-graph VJP calls the kernels from an autograd.Function's
    forward and backward, where grad mode is off."""
    seen = []

    class Probe(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a):
            _cuda.refuse_autograd('probe', a)
            seen.append(torch.is_grad_enabled())
            return a * 2

        @staticmethod
        def backward(ctx, g):
            _cuda.refuse_autograd('probe', g, torch.ones(1,
                                                         requires_grad=True))
            seen.append(torch.is_grad_enabled())
            return g * 2

    a = torch.ones(3, requires_grad=True)
    Probe.apply(a).sum().backward()
    assert seen == [False, False]
    assert torch.equal(a.grad, torch.full((3,), 2.0))
