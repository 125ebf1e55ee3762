"""``cheby_synthesis`` and ``cheby_rect`` under autograd on every format,
against ``jax.grad`` of the JAX package, in float64 on the CPU.

The operators are ``tests/test_torch_format_spmm_grad.py``'s (CSR,
hybrid, chunked relabeled by degree, windowed shuffled, banded; value
leaves perturbed on the live slots, so not symmetric), at order 6. One
jitted ``jax.grad`` per format takes the cotangents of
``⟨ȳ, cheby_synthesis(L, λmax, c, x)⟩`` with respect to every float leaf,
the diagonal, λmax, c and x (N, S, Nf) at once; the port's come from
``_ChebySynthesis``, whose backward is the analysis bank of ȳ on the
transpose (other summation orders), so the leaves on live slots, diag̅,
c̄ and x̄ are held within 1e-12 of the largest |gradient| and λ̄ within
1e-10 relative. The padding slots get exactly 0 and the recorded forward
is bit-equal to the unrecorded one. Also here: the synthesis through W's
values by ``laplacian_op`` for both Laplacian types, ``Filter.synthesize``
with a grad-requiring signal, ``cheby_rect`` through x and the leaves,
the forward's saved tensors (no (N, S, Nf) term), the CPU's x-alone
route differentiating twice, and the bf16 modes' refusal.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygsp_tpu as jgsp
import pygsp_tpu_torch as tgsp
from pygsp_tpu.core import operators as jops
from pygsp_tpu.ops import chebyshev as jcheby
from pygsp_tpu_torch.core import operators as tops
from pygsp_tpu_torch.ops import chebyshev as tcheby
from test_torch_format_grad import _close
from test_torch_format_spmm_grad import (FORMATS, grad_inputs, live_close,
                                         operator, padding_is_zero)
from test_torch_weight_grad import _graph, _lmax, _pair

TOL = 1e-12
TOL_LMAX = 1e-10
M1 = 7                       # order 6: m + 1 terms
NF, S = 2, 3
RECT_ORDER = M1 - 1
CPU64 = dict(device='cpu', dtype=torch.float64)


@dataclasses.dataclass
class Case:
    """One format's inputs and JAX's cotangents: the synthesis's (leaves,
    diag, λmax, c, x) and ``cheby_rect``'s (leaves, x)."""
    op: object
    c: np.ndarray
    x: np.ndarray
    ybar: np.ndarray
    bounds: list
    xr: np.ndarray
    want: tuple
    want_rect: tuple


_CASES = {}


def _case(fmt):
    if fmt in _CASES:
        return _CASES[fmt]
    op = operator(fmt)
    n = op.JL.diag.shape[0]
    rng = np.random.default_rng(31)
    c = rng.normal(size=(NF, M1))
    x = rng.normal(size=(n, S, NF))
    ybar = rng.normal(size=(n, S))
    xr = rng.normal(size=(n, S))
    bounds = [0.2 * op.lmax, 0.6 * op.lmax]

    def loss(floats, diag, lmax_, c_, x_):
        return jnp.sum(jnp.asarray(ybar) * jcheby.cheby_synthesis(
            op.jax_op(floats, diag), lmax_, c_, x_))

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(
        op.floats, op.JL.diag, jnp.float64(op.lmax), jnp.asarray(c),
        jnp.asarray(x))

    def rect(floats, x_):
        return jnp.sum(jnp.asarray(ybar) * jcheby.cheby_rect(
            op.jax_op(floats, op.JL.diag), op.lmax, bounds, x_,
            order=RECT_ORDER))

    want_rect = jax.jit(jax.grad(rect, argnums=(0, 1)))(op.floats,
                                                         jnp.asarray(xr))
    _CASES[fmt] = Case(
        op, c, x, ybar, bounds, xr,
        ([np.asarray(g) for g in want[0]],)
        + tuple(np.asarray(g) for g in want[1:]),
        ([np.asarray(g) for g in want_rect[0]], np.asarray(want_rect[1])))
    return _CASES[fmt]


_PORT = {}


def _port_grads(fmt):
    """The port's synthesis and its cotangents (leaves, diag, λmax, c,
    x), taken once for the module."""
    if fmt not in _PORT:
        k = _case(fmt)
        L = k.op.port()
        leaves, diag, Lg = grad_inputs(L)
        lt = torch.tensor(k.op.lmax, dtype=torch.float64, requires_grad=True)
        ct = torch.tensor(k.c, requires_grad=True)
        xt = torch.tensor(k.x, requires_grad=True)
        y = tcheby.cheby_synthesis(Lg, lt, ct, xt)
        (y * torch.from_numpy(k.ybar)).sum().backward()
        _PORT[fmt] = (k, L, y.detach(), (
            [v.grad.numpy() for v in leaves], diag.grad.numpy(),
            float(lt.grad), ct.grad.numpy(), xt.grad.numpy()))
    return _PORT[fmt]


@pytest.fixture(scope='module', params=FORMATS)
def grads(request):
    return _port_grads(request.param)


def test_synthesis_leaf_cotangents_match_jax(grads):
    k, _, _, got = grads
    live_close(got[0], k.want[0], k.op.masks)


def test_synthesis_diag_c_x_and_lmax_match_jax(grads):
    k, _, _, got = grads
    for i in (1, 3, 4):
        _close(got[i], k.want[i])
    assert abs(got[2] - float(k.want[2])) <= TOL_LMAX * abs(float(k.want[2]))


@pytest.mark.parametrize('fmt', FORMATS[:-1])
def test_synthesis_padding_slots_get_exactly_zero(fmt):
    k, _, _, got = _port_grads(fmt)
    padding_is_zero(got[0], k.op.masks)


def test_recorded_synthesis_is_bit_equal(grads):
    k, L, y, _ = grads
    assert torch.equal(y, tcheby.cheby_synthesis(
        L, k.op.lmax, torch.from_numpy(k.c), torch.from_numpy(k.x)))


@pytest.mark.parametrize('fmt', FORMATS)
def test_forward_keeps_no_filter_term(fmt):
    """The recorded forward saves x once (the operator's cotangents read
    it) and no (N, ..., Nf) term of the recurrence: every saved tensor of
    N rows and more than one axis, together, is x."""
    k = _case(fmt)
    leaves, diag, Lg = grad_inputs(k.op.port())
    ct = torch.tensor(k.c, requires_grad=True)
    xt = torch.tensor(k.x, requires_grad=True)
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        tcheby.cheby_synthesis(Lg, k.op.lmax, ct, xt)
    n = k.x.shape[0]
    rows = [s for s in saved if len(s) > 1 and s[0] == n]
    assert sum(math.prod(s) for s in rows) == k.x.size


@pytest.mark.parametrize('lap_type', ['combinatorial', 'normalized'])
def test_synthesis_through_the_weights_by_laplacian_op(lap_type):
    """W's values, c, x and λmax of a synthesis on ``laplacian_op(W)``
    (the CSR route, its backward on the transpose) against ``jax.grad``."""
    W = _graph('sensor64')
    J, T = _pair(W)
    lmax = _lmax(W, lap_type)
    rng = np.random.default_rng(37)
    c = rng.normal(size=(NF, M1))
    x = rng.normal(size=(64, S, NF))
    ybar = rng.normal(size=(64, S))

    def loss(w, c_, x_, lmax_):
        return jnp.sum(jnp.asarray(ybar) * jcheby.cheby_synthesis(
            jops.laplacian_op(J.with_vals(w), lap_type), lmax_, c_, x_))

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(
        J.vals, jnp.asarray(c), jnp.asarray(x), jnp.float64(lmax))
    w = T.vals.clone().requires_grad_()
    ct = torch.tensor(c, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    lt = torch.tensor(lmax, dtype=torch.float64, requires_grad=True)
    out = tcheby.cheby_synthesis(tops.laplacian_op(T.with_vals(w), lap_type),
                                 lt, ct, xt)
    (torch.from_numpy(ybar) * out).sum().backward()
    for got, wnt in zip((w, ct, xt), want[:3]):
        _close(got.grad.numpy(), np.asarray(wnt))
    assert abs(float(lt.grad) - float(want[3])) <= TOL_LMAX * abs(
        float(want[3]))


def test_filter_synthesize_differentiates_through_s():
    """``Filter.synthesize`` of a grad-requiring (N, S, Nf) signal: its
    cotangent against the JAX package's."""
    J = jgsp.graphs.Logo()
    T = tgsp.graphs.Logo(**CPU64)
    J.estimate_lmax(method='bounds')
    T._lmax, T._lmax_method = J.lmax, 'pinned'
    gj = jgsp.filters.Heat(J, scale=[5.0, 20.0])
    gt = tgsp.filters.Heat(T, scale=[5.0, 20.0])
    rng = np.random.default_rng(41)
    s = rng.normal(size=(J.N, 2, 2))
    st = torch.tensor(s, requires_grad=True)
    out = gt.synthesize(st, order=20)
    ybar = rng.normal(size=tuple(out.shape))
    (out * torch.from_numpy(ybar)).sum().backward()
    want = jax.grad(lambda s_: jnp.sum(jnp.asarray(ybar).reshape(-1)
                                       * gj.synthesize(s_, order=20)
                                       .reshape(-1)))(jnp.asarray(s))
    _close(st.grad.numpy(), np.asarray(want))


@pytest.mark.parametrize('fmt', FORMATS)
def test_cheby_rect_through_x_and_the_leaves(fmt):
    """``cheby_rect``'s x̄ and leaves̄ against ``jax.grad``: through
    ``cheby_op`` on the chunked and windowed formats, through the SpMM's
    Functions on the others; exactly 0 on the padding slots."""
    k = _case(fmt)
    leaves, _, Lg = grad_inputs(k.op.port())
    xt = torch.tensor(k.xr, requires_grad=True)
    out = tcheby.cheby_rect(Lg, k.op.lmax, k.bounds, xt, order=RECT_ORDER)
    (out * torch.from_numpy(k.ybar)).sum().backward()
    got = [v.grad.numpy() for v in leaves]
    live_close(got, k.want_rect[0], k.op.masks)
    _close(xt.grad.numpy(), k.want_rect[1])
    if fmt != 'banded':                  # the tiles hold no padding
        padding_is_zero(got, k.op.masks)
    with torch.no_grad():
        plain = tcheby.cheby_rect(k.op.port(), k.op.lmax, k.bounds,
                                  torch.from_numpy(k.xr), order=RECT_ORDER)
    _close(out.detach().numpy(), plain.numpy())


@pytest.mark.parametrize('fmt', ['csr', 'windowed'])
def test_cpu_x_alone_differentiates_twice(fmt):
    """On the CPU x alone takes the plain recurrence under autograd, whose
    SpMMs are Functions that differentiate again: ``Σ w·y²``'s Hessian
    along dx against ``jax.jvp(jax.grad(...))`` within 1e-10."""
    k = _case(fmt)
    L = k.op.port()
    rng = np.random.default_rng(43)
    w, dx = rng.normal(size=k.ybar.shape), rng.normal(size=k.x.shape)
    xt = torch.tensor(k.x, requires_grad=True)
    y = tcheby.cheby_synthesis(L, k.op.lmax, torch.from_numpy(k.c), xt)
    assert y.grad_fn is not None and 'ChebySynthesis' not in type(
        y.grad_fn).__name__
    (g,) = torch.autograd.grad((torch.from_numpy(w) * y * y).sum(), xt,
                               create_graph=True)
    (hvp,) = torch.autograd.grad((g * torch.from_numpy(dx)).sum(), xt)

    def square(x_):
        y_ = jcheby.cheby_synthesis(k.op.JL, k.op.lmax, jnp.asarray(k.c), x_)
        return jnp.sum(jnp.asarray(w) * y_ * y_)

    _, want = jax.jit(lambda p, t: jax.jvp(jax.grad(square), (p,), (t,)))(
        jnp.asarray(k.x), jnp.asarray(dx))
    _close(hvp.numpy(), np.asarray(want), 1e-10)


@pytest.mark.parametrize('mode', ['carry_dtype', 'vals_dtype'])
def test_bf16_modes_raise(mode):
    """The bf16 modes raise where the Function's route would run (c
    requiring grad), naming ROADMAP.md §1 item 6; unrecorded they run."""
    k = _case('windowed')
    L = k.op.port()
    c = torch.tensor(k.c, requires_grad=True)
    x = torch.from_numpy(k.x)
    kw = {mode: torch.bfloat16, 'carry_tol': 1.0}
    with pytest.raises(ValueError, match='§1 item 6'):
        tcheby.cheby_synthesis(L, k.op.lmax, c, x, **kw)
    with torch.no_grad():
        assert torch.isfinite(tcheby.cheby_synthesis(L, k.op.lmax, c, x,
                                                     **kw)).all()
