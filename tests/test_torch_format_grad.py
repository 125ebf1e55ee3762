"""Gradients through the operator on the ELL ('hybrid'), chunked, windowed
and banded formats, against ``jax.grad`` of the JAX package, in float64
on the CPU.

Each format's operator is built by the JAX package and carried across
(``convert.*_from_numpy``), its value leaves first perturbed on their live
slots (so the values are not symmetric) with numpy from a seed. The loss
is ``⟨ḡ, cheby_op(L, λmax, c, x)⟩`` with λmax a tensor pinned at the
graph's own estimate; one ``jax.grad`` per format takes the cotangents of
every float leaf of the JAX pytree, the diagonal, λmax, c and x at once.
The port's come from ``_ChebyOp`` (the CSR view of the live slots, or the
banded tiles' products). Both take their sums in other orders, so the
leaves on live slots, diag̅, c̄ and x̄ are held within 1e-12 of the largest
|gradient| and λ̄ within 1e-10 relative (the CSR tests' tolerances).

The padding slots are a departure by design: the JAX package's clamped
gathers read a real row there and give them a cotangent, the port's
kernels skip them, so the gradient of the function the port computes is
exactly 0 there. Banded tiles hold no padding: every tile entry gets the
JAX package's dense cotangent. Also here: padding values of 1 leave the
bank bit-unchanged, the recorded bank is bit-equal to the unrecorded one,
the CSR view is built once over a loop of value replacements, and the
bf16 modes refuse autograd's route.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygsp_tpu as jgsp
from pygsp_tpu.core import operators as jops
from pygsp_tpu.ops import chebyshev as jcheby
from pygsp_tpu_torch import convert
from pygsp_tpu_torch.core import operators as tops
from pygsp_tpu_torch.core import sparse as tsp
from pygsp_tpu_torch.ops import chebyshev as tcheby

TOL = 1e-12
TOL_LMAX = 1e-10
M1 = 7                       # order 6: m + 1 terms
NF, S = 2, 3
FORMATS = ('hybrid', 'chunked', 'windowed', 'banded')
SLOTS = FORMATS[:3]          # the formats with padding slots


def _ba():
    return jgsp.graphs.BarabasiAlbert(300, m0=3, m=3, seed=1)


# (graph, the JAX operator in the format); the chunked one relabeled by
# degree over three chunks, the windowed one shuffled (its default), the
# banded one of three tile rows
BUILD = {
    'hybrid': (_ba, lambda L: L.to_hybrid()),
    'chunked': (_ba, lambda L: L.to_chunked(chunk_rows=128,
                                            permute='degree')),
    'windowed': (_ba, lambda L: L.to_windowed()),
    'banded': (lambda: jgsp.graphs.Grid2d(24, 12),
               lambda L: L.to_banded()),
}


def _float_leaves(J):
    """``(flat, treedef, positions)``: the JAX pytree's leaves and where
    its float ones stand, in the pytree's order."""
    flat, tree = jax.tree_util.tree_flatten(J)
    pos = [i for i, v in enumerate(flat)
           if jnp.issubdtype(jnp.asarray(v).dtype, jnp.floating)]
    return flat, tree, pos


def _with_floats(J, floats):
    flat, tree, pos = _float_leaves(J)
    flat = list(flat)
    for i, v in zip(pos, floats):
        flat[i] = v
    return jax.tree_util.tree_unflatten(tree, flat)


def _live_masks(fmt, J):
    """Per float leaf, where a stored slot holds an edge (numpy bools)."""
    if fmt == 'banded':
        return [np.ones(np.shape(J.tiles), bool)]
    if fmt == 'hybrid':
        return ([np.asarray(J.ell_cols) < J.n_cols]
                + [np.asarray(lev.cols) < J.n_cols for lev in J.levels])
    R = J.chunk_rows

    def size(c):
        return min(R, J.n_cols - c * R)

    if fmt == 'chunked':
        blocks = [np.asarray(b.cols) < size(c)
                  for (_, c), b in zip(J.block_keys, J.blocks)]
    else:
        src = np.arange(np.shape(J.cols)[2])
        blocks = [np.asarray(J.cols)
                  < np.minimum(R, J.n_cols - src * R)[None, None, :, None]]
    return blocks + [np.asarray(lev.cols) < size(lev.src_chunk)
                     for lev in J.levels]


def _leaves_dict(fmt, J):
    """The JAX matrix's leaves as numpy, in convert's layout."""
    arr = np.asarray
    if fmt == 'banded':
        return {'tiles': arr(J.tiles), 'n_rows': J.n_rows,
                'n_cols': J.n_cols, 'nnz': J.nnz, 'half_bw': J.half_bw}
    if fmt == 'hybrid':
        out = {k: arr(getattr(J, k)) for k in ('ell_cols', 'ell_vals',
                                                'rowptr')}
        out['levels'] = [{k: arr(getattr(lev, k))
                          for k in ('rows', 'cols', 'vals')}
                         for lev in J.levels]
        out.update({k: getattr(J, k) for k in convert._ELL_INTS})
        return out
    keys = (('level_rows', 'rowptr', 'perm', 'iperm') if fmt == 'chunked'
            else ('cols', 'vals', 'rowid', 'level_rows', 'rowptr', 'perm',
                  'iperm'))
    out = {k: None if getattr(J, k) is None else arr(getattr(J, k))
           for k in keys}
    out['levels'] = [{'cols': arr(lev.cols), 'vals': arr(lev.vals),
                      'src_chunk': lev.src_chunk} for lev in J.levels]
    if fmt == 'chunked':
        out['blocks'] = [{'cols': arr(b.cols), 'vals': arr(b.vals)}
                         for b in J.blocks]
        out['block_keys'] = list(J.block_keys)
        out.update({k: getattr(J, k) for k in convert._CHUNKED_INTS})
    else:
        out.update({k: getattr(J, k) for k in convert._WINDOWED_INTS})
    return out


@dataclasses.dataclass
class Case:
    """One format's operator on both sides, the inputs and JAX's
    cotangents (leaves, diag, λmax, c, x)."""
    fmt: str
    JL: object
    lmax: float
    masks: list
    c: np.ndarray
    x: np.ndarray
    gbar: np.ndarray
    want: tuple

    def port(self, device='cpu'):
        J = self.JL.offdiag
        return convert.laplacian_from_numpy({
            'offdiag': _leaves_dict(self.fmt, J),
            'diag': np.asarray(self.JL.diag),
            'lap_type': self.JL.lap_type}, device=device)


_CASES = {}


def _case(fmt):
    """The case of ``fmt``, built once for the module."""
    if fmt not in _CASES:
        _CASES[fmt] = _build(fmt)
    return _CASES[fmt]


def _build(fmt):
    make, convert_to = BUILD[fmt]
    G = make()
    G.estimate_lmax()
    lmax = float(G.lmax)                # the graph's own, never below
    JL = convert_to(G.L)
    J = JL.offdiag
    masks = _live_masks(fmt, J)
    rng = np.random.default_rng(7)
    _, _, pos = _float_leaves(J)
    flat = jax.tree_util.tree_leaves(J)
    floats = []
    for i, mask in zip(pos, masks):
        v = np.asarray(flat[i]).copy()
        live = mask & (v != 0)
        v[live] *= 1.0 + 0.05 * rng.normal(size=int(live.sum()))
        floats.append(jnp.asarray(v))
    JL = jops.LaplacianOp(offdiag=_with_floats(J, floats), diag=JL.diag,
                          lap_type=JL.lap_type)
    n = G.N
    c = rng.normal(size=(NF, M1))
    x = rng.normal(size=(n, S))
    gbar = rng.normal(size=(NF, n, S))

    def loss(floats_, diag, lmax_, c_, x_):
        L = jops.LaplacianOp(offdiag=_with_floats(JL.offdiag, floats_),
                             diag=diag, lap_type=JL.lap_type)
        return jnp.sum(jnp.asarray(gbar) * jcheby.cheby_op(L, lmax_, c_, x_))

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        floats, JL.diag, jnp.float64(lmax), jnp.asarray(c), jnp.asarray(x))
    return Case(fmt=fmt, JL=JL, lmax=lmax, masks=masks, c=c, x=x,
                gbar=gbar, want=([np.asarray(w) for w in want[0]],)
                + tuple(np.asarray(w) for w in want[1:]))


@pytest.fixture(scope='module', params=FORMATS)
def case(request):
    return request.param, _case(request.param)


def _port_grads(L, lmax, c, x, gbar):
    """The port's bank and its cotangents (leaves, diag, λmax, c, x)."""
    leaves = [v.clone().requires_grad_() for v in L.offdiag.leaves()]
    diag = L.diag.clone().requires_grad_()
    lt = torch.tensor(lmax, dtype=torch.float64, requires_grad=True)
    ct = torch.tensor(c, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    Lg = tops.LaplacianOp(offdiag=L.offdiag.with_leaves(leaves), diag=diag,
                          lap_type=L.lap_type)
    out = tcheby.cheby_op(Lg, lt, ct, xt)
    (out * torch.from_numpy(gbar)).sum().backward()
    return out.detach(), ([v.grad.numpy() for v in leaves],
                          diag.grad.numpy(), float(lt.grad),
                          ct.grad.numpy(), xt.grad.numpy())


@pytest.fixture(scope='module')
def grads(case):
    fmt, k = case
    L = k.port()
    return fmt, k, L, _port_grads(L, k.lmax, k.c, k.x, k.gbar)


def _close(got, want, tol=TOL):
    """max |got − want| within ``tol`` of the largest |want|."""
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-300)
    assert float(np.abs(got - want).max()) <= tol * scale


def test_leaves_have_the_jax_shapes(grads):
    fmt, k, L, _ = grads
    want = [np.shape(v) for v in jax.tree_util.tree_leaves(k.JL.offdiag)
            if jnp.issubdtype(jnp.asarray(v).dtype, jnp.floating)]
    assert [tuple(v.shape) for v in L.offdiag.leaves()] == want


def test_leaf_cotangents_on_live_slots_match_jax(grads):
    """Every leaf's cotangent on its live slots, against ``jax.grad``."""
    fmt, k, L, (_, got) = grads
    live_got = np.concatenate([g[m] for g, m in zip(got[0], k.masks)])
    live_want = np.concatenate([w[m] for w, m in zip(k.want[0], k.masks)])
    assert np.abs(live_want).max() > 0
    _close(live_got, live_want)
    for g, w, m in zip(got[0], k.want[0], k.masks):
        if m.any():
            _close(g[m], w[m])


def test_diag_c_x_and_lmax_match_jax(grads):
    fmt, k, L, (_, got) = grads
    for g, w in zip((got[1], got[3], got[4]),
                    (k.want[1], k.want[3], k.want[4])):
        _close(g, w)
    assert abs(got[2] - float(k.want[2])) <= TOL_LMAX * abs(float(k.want[2]))


@pytest.mark.parametrize('fmt', SLOTS)
def test_padding_slots_get_exactly_zero(fmt):
    """The port's cotangent is 0 on every padding slot; the JAX package's
    clamped gathers give some of them one (the departure by design)."""
    k = _case(fmt)
    got = _port_grads(k.port(), k.lmax, k.c, k.x, k.gbar)[1][0]
    n_pad = 0
    for g, w, m in zip(got, k.want[0], k.masks):
        assert not np.any(g[~m])
        n_pad += int((~m).sum())
    assert n_pad > 0
    assert any(np.any(w[~m]) for w, m in zip(k.want[0], k.masks))


@pytest.mark.parametrize('fmt', SLOTS)
def test_padding_values_leave_the_bank_unchanged(fmt):
    """Padding slots set to 1 change no bit of the bank, recorded or
    not."""
    k = _case(fmt)
    L = k.port()
    leaves = [v.clone() for v in L.offdiag.leaves()]
    for v, m in zip(leaves, k.masks):
        v[torch.from_numpy(~m)] = 1.0
    Lp = tops.LaplacianOp(offdiag=L.offdiag.with_leaves(leaves), diag=L.diag,
                          lap_type=L.lap_type)
    c, x = torch.from_numpy(k.c), torch.from_numpy(k.x)
    want = tcheby.cheby_op(L, k.lmax, c, x)
    assert torch.equal(tcheby.cheby_op(Lp, k.lmax, c, x), want)
    xt = x.clone().requires_grad_()
    assert torch.equal(tcheby.cheby_op(Lp, k.lmax, c.clone()
                                       .requires_grad_(), xt).detach(), want)


def test_recorded_bank_is_bit_equal(grads):
    fmt, k, L, (out, _) = grads
    plain = tcheby.cheby_op(L, k.lmax, torch.from_numpy(k.c),
                            torch.from_numpy(k.x))
    assert torch.equal(out, plain)


@pytest.mark.parametrize('fmt', SLOTS)
def test_the_csr_view_is_built_once(fmt):
    """Three steps of replacing the values and taking the gradient build
    the structure's CSR view once; the values' cotangents follow the
    values (each step's against a fresh operator's)."""
    k = _case(fmt)
    L = k.port()
    c, x = torch.from_numpy(k.c), torch.from_numpy(k.x)
    g = torch.from_numpy(k.gbar)
    before = tsp.grad_edges.builds
    leaves = [v.clone().requires_grad_() for v in L.offdiag.leaves()]
    for step in range(3):
        Lg = tops.LaplacianOp(offdiag=L.offdiag.with_leaves(leaves),
                              diag=L.diag, lap_type=L.lap_type)
        (tcheby.cheby_op(Lg, k.lmax, c, x) * g).sum().backward()
        with torch.no_grad():
            leaves = [(v - 1e-4 * v.grad / float(v.grad.abs().max()))
                      .requires_grad_() for v in leaves]
    assert tsp.grad_edges.builds - before == 1
    fresh = k.port()
    fresh = tops.LaplacianOp(
        offdiag=fresh.offdiag.with_leaves([v.detach() for v in leaves]),
        diag=fresh.diag, lap_type=fresh.lap_type)
    got = _port_grads(fresh, k.lmax, k.c, k.x, k.gbar)[1][0]
    ref = [v.detach().clone().requires_grad_() for v in leaves]
    Lg = tops.LaplacianOp(offdiag=L.offdiag.with_leaves(ref), diag=L.diag,
                          lap_type=L.lap_type)
    (tcheby.cheby_op(Lg, k.lmax, c, x) * g).sum().backward()
    for a, b in zip(got, ref):
        assert np.array_equal(a, b.grad.numpy())


@pytest.mark.parametrize('mode', ['carry_dtype', 'vals_dtype'])
def test_bf16_modes_refuse_autograd(mode):
    """The bf16 modes raise where autograd's route would run (c requiring
    grad), naming the roadmap's item; under no_grad they run."""
    k = _case('windowed')
    L = k.port()
    c = torch.tensor(k.c, requires_grad=True)
    x = torch.from_numpy(k.x)
    kw = {mode: torch.bfloat16, 'carry_tol': 1.0}
    with pytest.raises(ValueError, match='§1 item 6'):
        tcheby.cheby_op(L, k.lmax, c, x, **kw)
    with torch.no_grad():
        assert torch.isfinite(tcheby.cheby_op(L, k.lmax, c, x, **kw)).all()
