"""``L @ x`` under autograd on every format, against ``jax.grad`` of the JAX
package, in float64 on the CPU.

The operators are those of ``tests/test_torch_format_grad.py`` (BA(300)
as CSR, hybrid, chunked relabeled by degree and windowed shuffled, and a
Grid2d(24, 12) as banded), built by the JAX package, their value leaves
perturbed on the live slots with numpy from a seed (so the values are not
symmetric) and carried across. The loss ``⟨ȳ, L @ x⟩`` gives the
cotangents of every float leaf, the diagonal and x; the port's come from
``_CSRSpmm`` on a CSR, ``_SlotSpmm`` (the CSR view of the live slots) on
the slot formats and ``_BandedSpmm`` on the banded one. Both packages sum
in other orders, so the leaves on live slots, diag̅ and x̄ are held within
1e-12 of the largest |gradient|, and a Hessian-vector product of
``Σ w·(L @ x)²`` through the leaves and x within 1e-10 of the largest
entry of ``jax.jvp(jax.grad(...))``'s. The padding slots get exactly 0
(the departure by design recorded for the bank). Also here: the recorded
product is bit-equal to the unrecorded one, and the bf16 modes raise.

The operators are shared with ``tests/test_torch_synthesis_grad.py``
(:func:`operator`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygsp_tpu.core import operators as jops
from pygsp_tpu_torch import convert
from pygsp_tpu_torch.core import operators as tops
from pygsp_tpu_torch.core import sparse as tsp
from test_torch_format_grad import (BUILD as _BUILD, _ba, _close,
                                    _float_leaves, _leaves_dict, _live_masks,
                                    _with_floats)

TOL = 1e-12
TOL_HVP = 1e-10
S = 3
FORMATS = ('csr', 'hybrid', 'chunked', 'windowed', 'banded')
BUILD = {'csr': (_ba, lambda L: L), **_BUILD}


@dataclasses.dataclass
class Operator:
    """One format's operator on both sides: the JAX operator with its
    leaves perturbed, the graph's λmax, and where the leaves' slots hold
    an edge."""
    fmt: str
    JL: object
    lmax: float
    masks: list

    @property
    def floats(self):
        flat = jax.tree_util.tree_leaves(self.JL.offdiag)
        return [flat[i] for i in _float_leaves(self.JL.offdiag)[2]]

    def jax_op(self, floats, diag):
        return jops.LaplacianOp(offdiag=_with_floats(self.JL.offdiag, floats),
                                diag=diag, lap_type=self.JL.lap_type)

    def port(self, device='cpu'):
        J = self.JL.offdiag
        if self.fmt == 'csr':
            off = {k: np.asarray(getattr(J, k))
                   for k in ('rows', 'cols', 'vals', 'rowptr')}
            off.update(n_rows=J.n_rows, n_cols=J.n_cols, nnz=J.nnz)
        else:
            off = _leaves_dict(self.fmt, J)
        return convert.laplacian_from_numpy({
            'offdiag': off, 'diag': np.asarray(self.JL.diag),
            'lap_type': self.JL.lap_type}, device=device)


_OPERATORS = {}


def operator(fmt) -> Operator:
    """The operator of ``fmt``, built once for the module."""
    if fmt not in _OPERATORS:
        make, convert_to = BUILD[fmt]
        G = make()
        G.estimate_lmax()
        JL = convert_to(G.L)
        J = JL.offdiag
        masks = ([np.asarray(J.rows) < J.n_rows] if fmt == 'csr'
                 else _live_masks(fmt, J))
        rng = np.random.default_rng(17)
        flat = jax.tree_util.tree_leaves(J)
        floats = []
        for i, mask in zip(_float_leaves(J)[2], masks):
            v = np.asarray(flat[i]).copy()
            live = mask & (v != 0)
            v[live] *= 1.0 + 0.05 * rng.normal(size=int(live.sum()))
            floats.append(jnp.asarray(v))
        JL = jops.LaplacianOp(offdiag=_with_floats(J, floats), diag=JL.diag,
                              lap_type=JL.lap_type)
        _OPERATORS[fmt] = Operator(fmt, JL, float(G.lmax), masks)
    return _OPERATORS[fmt]


def grad_inputs(L):
    """Grad-requiring copies of L's leaves and diagonal, and the operator
    made of them."""
    leaves = [v.clone().requires_grad_() for v in L.offdiag.leaves()]
    diag = L.diag.clone().requires_grad_()
    return leaves, diag, tops.LaplacianOp(
        offdiag=L.offdiag.with_leaves(leaves), diag=diag, lap_type=L.lap_type)


def live_close(got, want, masks, tol=TOL):
    """Each leaf's cotangent on its live slots within ``tol`` of the
    largest live |want|, all leaves together and each alone."""
    live_got = np.concatenate([g[m] for g, m in zip(got, masks)])
    live_want = np.concatenate([w[m] for w, m in zip(want, masks)])
    assert np.abs(live_want).max() > 0
    _close(live_got, live_want, tol)


def padding_is_zero(got, masks):
    n_pad = 0
    for g, m in zip(got, masks):
        assert not np.any(g[~m])
        n_pad += int((~m).sum())
    assert n_pad > 0


@dataclasses.dataclass
class Case:
    op: Operator
    x: np.ndarray
    ybar: np.ndarray
    w: np.ndarray
    dv: list
    dx: np.ndarray
    want: tuple
    want_hvp: tuple


_CASES = {}


def _case(fmt):
    if fmt in _CASES:
        return _CASES[fmt]
    op = operator(fmt)
    n = op.JL.diag.shape[0]
    rng = np.random.default_rng(23)
    x, ybar, w = (rng.normal(size=(n, S)) for _ in range(3))
    # tangents: zero on the padding slots, whose cotangents differ by design
    dv = [np.where(m, rng.normal(size=m.shape), 0.0) for m in op.masks]
    dx = rng.normal(size=(n, S))

    def loss(floats, diag, x_):
        return jnp.sum(jnp.asarray(ybar) * jops.matvec(op.jax_op(floats, diag),
                                                       x_))

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        op.floats, op.JL.diag, jnp.asarray(x))

    def square(floats, x_):
        y = jops.matvec(op.jax_op(floats, op.JL.diag), x_)
        return jnp.sum(jnp.asarray(w) * y * y)

    _, hvp = jax.jit(lambda p, t: jax.jvp(
        jax.grad(square, argnums=(0, 1)), p, t))(
        (op.floats, jnp.asarray(x)),
        ([jnp.asarray(d) for d in dv], jnp.asarray(dx)))
    _CASES[fmt] = Case(op, x, ybar, w, dv, dx,
                       ([np.asarray(g) for g in want[0]],
                        np.asarray(want[1]), np.asarray(want[2])),
                       ([np.asarray(h) for h in hvp[0]], np.asarray(hvp[1])))
    return _CASES[fmt]


_PORT = {}


def _port_grads(fmt):
    """The port's product and cotangents (leaves, diag, x) on one format,
    taken once for the module."""
    if fmt not in _PORT:
        k = _case(fmt)
        L = k.op.port()
        leaves, diag, Lg = grad_inputs(L)
        xt = torch.tensor(k.x, requires_grad=True)
        y = Lg @ xt
        (y * torch.from_numpy(k.ybar)).sum().backward()
        _PORT[fmt] = (k, L, y.detach(), ([v.grad.numpy() for v in leaves],
                                         diag.grad.numpy(), xt.grad.numpy()))
    return _PORT[fmt]


@pytest.fixture(scope='module', params=FORMATS)
def grads(request):
    return _port_grads(request.param)


def test_leaf_cotangents_on_live_slots_match_jax(grads):
    k, _, _, got = grads
    live_close(got[0], k.want[0], k.op.masks)
    for g, w, m in zip(got[0], k.want[0], k.op.masks):
        if m.any():
            _close(g[m], w[m])


def test_diag_and_x_match_jax(grads):
    k, _, _, got = grads
    _close(got[1], k.want[1])
    _close(got[2], k.want[2])


@pytest.mark.parametrize('fmt', FORMATS[:-1])
def test_padding_slots_get_exactly_zero(fmt):
    """Banded tiles hold no padding of their own: every tile entry gets
    the JAX package's cotangent there."""
    k, _, _, got = _port_grads(fmt)
    padding_is_zero(got[0], k.op.masks)


def test_recorded_product_is_bit_equal(grads):
    k, L, y, _ = grads
    assert torch.equal(y, L @ torch.from_numpy(k.x))
    assert torch.equal(y, tops.matvec(L, torch.from_numpy(k.x)))


@pytest.mark.parametrize('fmt', FORMATS)
def test_hessian_vector_product_matches_jax(fmt):
    """``Σ w·(L @ x)²``'s gradient, taken with ``create_graph=True``, then
    differentiated along (dv, dx): the backward is made of Functions and
    recorded ops, so it differentiates again."""
    k = _case(fmt)
    leaves, _, Lg = grad_inputs(k.op.port())
    xt = torch.tensor(k.x, requires_grad=True)
    y = Lg @ xt
    first = torch.autograd.grad((torch.from_numpy(k.w) * y * y).sum(),
                                leaves + [xt], create_graph=True)
    along = sum((g * torch.from_numpy(d)).sum()
                for g, d in zip(first, k.dv + [k.dx]))
    hvp = [h.numpy() for h in torch.autograd.grad(along, leaves + [xt])]
    live_close(hvp[:-1], k.want_hvp[0], k.op.masks, TOL_HVP)
    _close(hvp[-1], k.want_hvp[1], TOL_HVP)
    if fmt != 'banded':                  # the tiles hold no padding
        padding_is_zero(hvp[:-1], k.op.masks)


@pytest.mark.parametrize('fmt', FORMATS[1:])
def test_spmm_entry_points_differentiate_alike(fmt):
    """``spmm``, the matrix's own ``@`` and the format's ``leaves`` as the
    only grad-requiring operand give one cotangent."""
    k = _case(fmt)
    L = k.op.port()
    ybar = torch.from_numpy(k.ybar)
    out = []
    for call in (lambda m, x: tsp.spmm(m, x), lambda m, x: m @ x):
        leaves = [v.clone().requires_grad_() for v in L.offdiag.leaves()]
        (call(L.offdiag.with_leaves(leaves), torch.from_numpy(k.x))
         * ybar).sum().backward()
        out.append([v.grad for v in leaves])
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.parametrize('fmt', FORMATS[1:])
def test_bf16_modes_raise(fmt):
    """Under autograd a bf16 ``out_dtype`` or bf16 values raise the
    ValueError that names ROADMAP.md §1 item 6; unrecorded they run."""
    off = operator(fmt).port().offdiag
    x = torch.ones((off.n_cols, 2), dtype=torch.float64, requires_grad=True)
    with pytest.raises(ValueError, match='§1 item 6'):
        tsp.spmm(off, x, out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='§1 item 6'):
        tsp.spmm(off.astype(torch.bfloat16), x.float())
    with torch.no_grad():
        assert tsp.spmm(off, x, out_dtype=torch.bfloat16).dtype \
            == torch.bfloat16
