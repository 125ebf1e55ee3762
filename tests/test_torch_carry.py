"""The recurrence's bf16 modes against pygsp_tpu on the CPU.

``carry_dtype`` (the terms carried narrow), ``vals_dtype`` (the edge values
stored narrow) and the windowed SpMM's ``out_dtype``, the carry gate, the
grouped accumulation on every format, and the plain versions of the fused
Chebyshev step. The bf16 outputs are held to JAX's in the same
mode and to the float64 recurrence within the a-priori bound
(``carry_error_estimate``), never to a chunked-format bf16 output.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygsp_tpu as jgsp
import pygsp_tpu_torch as tgsp
from pygsp_tpu.core import windowed as jwd
from pygsp_tpu.core.operators import LaplacianOp as JLaplacianOp
from pygsp_tpu.ops import chebyshev as jcheby
from pygsp_tpu_torch import convert
from pygsp_tpu_torch.core import _cuda, cheby_kernel, windowed_kernel
from pygsp_tpu_torch.core import chunked as tck
from pygsp_tpu_torch.core import sparse as tsp
from pygsp_tpu_torch.core.operators import matvec
from pygsp_tpu_torch.ops import chebyshev as tcheby

from test_torch_windowed import _build, _laplacians, _leaves, _powerlaw

BF16 = (torch.bfloat16, jnp.bfloat16)
MODES = {'carry': ('carry_dtype',), 'vals': ('vals_dtype',),
         'both': ('carry_dtype', 'vals_dtype')}


def _heat(lmax, scales=(5.0, 10.0, 25.0, 50.0), m=30):
    """The heat bank's coefficients (numpy f64) on [0, lmax]."""
    s = jnp.asarray(scales)
    return np.asarray(jcheby.cheby_coeff(
        lambda lam: jnp.exp(-s[:, None] * lam[None, :] / lmax), lmax, m=m))


def _f32(J):
    """A JAX Laplacian in float32, values and diagonal."""
    return JLaplacianOp(offdiag=J.offdiag.astype(jnp.float32),
                        diag=J.diag.astype(jnp.float32), lap_type=J.lap_type)


def _bf16_ulps(got, want, n=2):
    """|got - want| within n bf16 ulps of the largest |want|."""
    top = float(np.abs(want).max())
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    err = float(np.abs(got - want).max())
    assert err <= n * ulp, (err, n * ulp)


# ---------------------------------------------------------------------------
# the carry gate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('dtype', ['bfloat16', 'float16', 'float32'])
@pytest.mark.parametrize('bank', ['heat', 'random'])
def test_carry_error_estimate_matches_jax(bank, dtype):
    if bank == 'heat':
        c = _heat(7.3)
    else:
        rng = np.random.default_rng(5)
        c = rng.normal(size=(3, 21)) * 0.7 ** np.arange(21)
    want = jcheby.carry_error_estimate(c, getattr(jnp, dtype))
    for arg in (c, torch.from_numpy(c), torch.from_numpy(c).float()):
        got = tcheby.carry_error_estimate(arg, getattr(torch, dtype))
        tol = 1e-12 if torch.as_tensor(arg).dtype == torch.float64 else 1e-6
        assert abs(got - want) <= tol * want, (got, want)
    # a single filter as a 1-D vector
    assert abs(tcheby.carry_error_estimate(c[0], getattr(torch, dtype))
               - jcheby.carry_error_estimate(c[0], getattr(jnp, dtype))) \
        <= 1e-12 * want


def _slow_bank():
    """Coefficients that do not decay: the bf16 gate refuses them."""
    return np.random.default_rng(3).normal(size=(2, 31))


@pytest.mark.parametrize('case', ['refused', 'accepted', 'carry_tol',
                                  'env', 'float16'])
def test_carry_gate_matches_jax(case, monkeypatch):
    c = _slow_bank() if case in ('refused', 'carry_tol') else _heat(7.3)
    tdt, jdt = (torch.float16, jnp.float16) if case == 'float16' else BF16
    tol = None
    if case == 'carry_tol':
        tol = 1.1 * jcheby.carry_error_estimate(c, jnp.bfloat16)
    if case == 'env':
        monkeypatch.setenv('PYGSP_CARRY_TOL', '1e-6')
    refused = case in ('refused', 'env')
    if refused:
        with pytest.raises(ValueError) as jerr:
            jcheby._check_carry_budget(c, jdt, tol)
        with pytest.raises(ValueError) as terr:
            tcheby._check_carry_budget(torch.from_numpy(c), tdt, tol)
        assert str(terr.value) == str(jerr.value)
        assert 'refused' in str(terr.value)
    else:
        jcheby._check_carry_budget(c, jdt, tol)
        tcheby._check_carry_budget(torch.from_numpy(c), tdt, tol)


def test_cheby_op_gates_the_carry_like_jax():
    J, T, _, lmax = _laplacians('combinatorial')
    c = _slow_bank()
    x = np.random.default_rng(2).normal(size=(500, 2)).astype(np.float32)
    with pytest.raises(ValueError) as jerr:
        jcheby.cheby_op(_f32(J), lmax, jnp.asarray(c, jnp.float32),
                        jnp.asarray(x), carry_dtype=jnp.bfloat16)
    with pytest.raises(ValueError) as terr:
        tcheby.cheby_op(T.astype(torch.float32), lmax,
                        torch.from_numpy(c).float(), torch.from_numpy(x),
                        carry_dtype=torch.bfloat16)
    assert str(terr.value) == str(jerr.value)
    # carry_tol lets it through
    est = tcheby.carry_error_estimate(c, torch.bfloat16)
    out = tcheby.cheby_op(T.astype(torch.float32), lmax,
                          torch.from_numpy(c).float(), torch.from_numpy(x),
                          carry_dtype=torch.bfloat16, carry_tol=2 * est)
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())


def test_csr_and_banded_refuse_the_modes_with_jax_text():
    J = jgsp.graphs.Grid2d(8, 7)
    T = tgsp.graphs.Grid2d(8, 7, device='cpu', dtype=torch.float64)
    J.estimate_lmax(method='bounds')
    T.estimate_lmax(method='bounds')
    x = torch.zeros(T.N, 2, dtype=torch.float64)
    c = torch.from_numpy(_heat(T.lmax, m=6))
    for name in ('carry_dtype', 'vals_dtype'):
        with pytest.raises(ValueError) as jerr:
            jcheby.cheby_op(J.L, J.lmax, jnp.asarray(c.numpy()),
                            jnp.asarray(x.numpy()), **{name: jnp.bfloat16})
        for L in (T.L, T.L.to_banded()):
            with pytest.raises(ValueError) as terr:
                tcheby.cheby_op(L, T.lmax, c, x, **{name: torch.bfloat16})
            assert str(terr.value) == str(jerr.value)
        # and through the filter, after the gate
        with pytest.raises(ValueError) as terr:
            tgsp.filters.Heat(T, [1.0, 2.0]).filter(x, order=6,
                                                    **{name: torch.bfloat16})
        assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# the narrow SpMM
# ---------------------------------------------------------------------------

# (x dtype, values dtype, out_dtype): the three operand pairs of the bf16
# modes, then float32 operands emitted narrow
COMBOS = {'carry': ('bfloat16', 'float32', 'bfloat16'),
          'both': ('bfloat16', 'bfloat16', 'bfloat16'),
          'vals': ('float32', 'bfloat16', None),
          'out': ('float32', 'float32', 'bfloat16')}


@pytest.mark.parametrize('combo', list(COMBOS))
@pytest.mark.parametrize('case', ['span4-borrow-and-levels', 'hub-rows',
                                  'P256-int32-rowid'])
def test_narrow_windowed_spmm_matches_jax(case, combo):
    W, J, T = _build(case)
    xd, vd, od = COMBOS[combo]
    x = np.random.default_rng(7).normal(size=(W.shape[1], 5))
    x = x.astype(np.float32)
    jx = jwd.chunk_signal(jnp.asarray(x).astype(getattr(jnp, xd)),
                          J.chunk_rows)
    tx = tck.chunk_signal(torch.from_numpy(x).to(getattr(torch, xd)),
                          T.chunk_rows)
    want = jwd.windowed_spmm_chunks(
        J.astype(getattr(jnp, vd)), jx,
        out_dtype=None if od is None else getattr(jnp, od))
    got = T.astype(getattr(torch, vd)).spmm_chunks(
        tx, out_dtype=None if od is None else getattr(torch, od))
    assert len(got) == len(want)
    want = np.concatenate([np.asarray(w.astype(jnp.float64)) for w in want])
    assert all(g.dtype == getattr(torch, od or 'float32') for g in got)
    _bf16_ulps(torch.cat(got).double().numpy(), want)


def test_fold_plain_takes_the_bf16_operands():
    """The plain fold forms each product in the operands' promotion (bf16
    by bf16 rounds to bf16) and sums it in float32; its window tensor is
    in x's dtype."""
    W, _, T = _build('span4-borrow-and-levels')
    M = T.astype(torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(W.shape[1], 3))).to(torch.bfloat16)
    kp = M.borrow_span * M.window_rows
    t = windowed_kernel.windowed_fold_plain(M.cols, M.vals, M.rowid, x,
                                            M.chunk_rows, kp)
    assert t.dtype == torch.bfloat16
    # the same fold with each product rounded to bf16 by hand, in f64
    p64 = windowed_kernel.windowed_fold_plain(
        M.cols, M.vals.double(), M.rowid, x.double(), M.chunk_rows, kp)
    _bf16_ulps(t.double().numpy(), p64.numpy())
    with pytest.raises(ValueError, match='bfloat16'):
        windowed_kernel.windowed_fold(M.cols, M.vals.half(), M.rowid, x,
                                      M.chunk_rows, kp)


def test_window_strip_plain_rounds_once():
    """A bf16 window tensor is summed in float32 and rounded once: at K = 2
    that is bf16's own add of the two addends."""
    gen = torch.Generator().manual_seed(0)
    t = torch.randn(2, 4, 2 * 8, 5, generator=gen).to(torch.bfloat16)
    y = windowed_kernel.window_strip_plain(t, 2 * 4 * 8 - 3, 8)
    a = t[:, :, :8].reshape(2, 32, 5)
    b = torch.cat([torch.zeros(2, 8, 5, dtype=torch.bfloat16),
                   t[:, :-1, 8:].reshape(2, 24, 5)], dim=1)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, (a + b).reshape(64, 5)[:61])


def test_convert_carries_bf16_values_across():
    _, J, _ = _build('hub-rows')
    leaves = _leaves(J.astype(jnp.bfloat16))
    assert leaves['vals'].dtype.name == 'bfloat16'
    M = convert.windowed_from_numpy(leaves, device='cpu')
    assert M.vals.dtype == torch.bfloat16
    assert all(lev.vals.dtype == torch.bfloat16 for lev in M.levels)
    assert np.array_equal(M.vals.float().numpy(),
                          leaves['vals'].astype(np.float32))
    x = np.random.default_rng(3).normal(size=(M.n_cols, 4))
    x = x.astype(np.float32)
    _bf16_ulps((M @ torch.from_numpy(x)).double().numpy(),
               np.asarray(J.astype(jnp.bfloat16) @ jnp.asarray(x),
                          np.float64))


# ---------------------------------------------------------------------------
# the recurrence in the bf16 modes
# ---------------------------------------------------------------------------

def _bound(out, want, ref, est):
    top = float(np.abs(ref).max())
    assert float(np.abs(out - want).max()) <= 2 * est * top
    assert float(np.abs(out - ref).max()) <= 1.5 * est * top


@pytest.mark.parametrize('mode', list(MODES))
def test_cheby_op_bf16_modes_match_jax(mode):
    J, T, _, lmax = _laplacians('combinatorial')
    c = _heat(lmax)
    x = np.random.default_rng(11).normal(size=(500, 4)).astype(np.float32)
    ref = np.asarray(jcheby.cheby_op(J, lmax, jnp.asarray(c),
                                     jnp.asarray(x, jnp.float64)))
    want = np.asarray(jcheby.cheby_op(
        _f32(J), lmax, jnp.asarray(c, jnp.float32), jnp.asarray(x),
        **{k: jnp.bfloat16 for k in MODES[mode]}))
    got = tcheby.cheby_op(T.astype(torch.float32), lmax,
                          torch.from_numpy(c).float(), torch.from_numpy(x),
                          **{k: torch.bfloat16 for k in MODES[mode]})
    assert got.dtype == torch.float32 and got.shape == ref.shape
    _bound(got.double().numpy(), want, ref,
           tcheby.carry_error_estimate(c, torch.bfloat16))


def _graphs(n=700, seed=11):
    """(JAX graph, port graph) of one power-law matrix in the windowed
    format, λmax pinned; the port's in float32."""
    W = _powerlaw(n, seed)
    J = jgsp.graphs.Graph(W)
    J.compute_laplacian(fmt='windowed')
    J.estimate_lmax()
    T = tgsp.graphs.Graph(W, device='cpu')
    T.compute_laplacian(fmt='windowed')
    T._lmax, T._lmax_method = J.lmax, 'pinned'
    return J, T


@pytest.mark.parametrize('mode', list(MODES))
def test_filter_bf16_modes_match_jax(mode):
    J, T = _graphs()
    scales = [5.0, 10.0, 25.0, 50.0]
    s = np.random.default_rng(1).normal(size=(J.N, 3)).astype(np.float32)
    ref = np.asarray(jgsp.filters.Heat(J, scales).filter(
        s.astype(np.float64), order=30))
    # JAX in float32 throughout (its vals_dtype mode alone needs the
    # operator in the signal's dtype)
    J._L = _f32(J.L)
    want = np.asarray(jgsp.filters.Heat(J, scales).filter(
        s, order=30, **{k: jnp.bfloat16 for k in MODES[mode]}))
    got = tgsp.filters.Heat(T, scales).filter(
        torch.from_numpy(s), order=30,
        **{k: torch.bfloat16 for k in MODES[mode]})
    assert got.shape == want.shape == (J.N, 3, 4)
    assert got.dtype == torch.float32
    c = _heat(J.lmax, scales)
    _bound(got.double().numpy(), want, ref,
           tcheby.carry_error_estimate(c, torch.bfloat16))


def test_vals_mode_runs_where_the_graph_is_wider_than_the_signal():
    """A float64 operator with a float32 signal and bf16 values: the port
    computes in the signal's dtype (the JAX package's scan refuses the
    mixed carry there, ROADMAP.md faults)."""
    J, T, _, lmax = _laplacians('normalized')
    c = _heat(lmax, m=12)
    x = np.random.default_rng(4).normal(size=(500, 2)).astype(np.float32)
    ref = np.asarray(jcheby.cheby_op(J, lmax, jnp.asarray(c),
                                     jnp.asarray(x, jnp.float64)))
    got = tcheby.cheby_op(T, lmax, torch.from_numpy(c).float(),
                          torch.from_numpy(x), vals_dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    est = tcheby.carry_error_estimate(c, torch.bfloat16)
    assert float(np.abs(got.double().numpy() - ref).max()) <= (
        1.5 * est * float(np.abs(ref).max()))


def test_fixed_graph_refuses_the_modes_first():
    J, T = _graphs(300, 2)
    s = np.zeros(J.N, np.float32)
    with pytest.raises(ValueError) as jerr:
        jgsp.filters.Heat(J, 5.0).filter(s, carry_dtype=jnp.bfloat16,
                                         fixed_graph=True)
    with pytest.raises(ValueError) as terr:
        tgsp.filters.Heat(T, 5.0).filter(s, carry_dtype=torch.bfloat16,
                                         fixed_graph=True)
    assert str(terr.value) == str(jerr.value)
    s = np.random.default_rng(2).normal(size=J.N).astype(np.float32)
    want = tgsp.filters.Heat(T, 5.0).filter(s)
    got = tgsp.filters.Heat(T, 5.0).filter(s, fixed_graph=True)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the grouped accumulation
# ---------------------------------------------------------------------------

def _grouped_case(fmt):
    """(JAX Laplacian, port Laplacian in ``fmt``, λmax): the windowed
    Laplacians of the 500-vertex test graph, or a Grid2d's in CSR (JAX) and
    in CSR or banded (port)."""
    if fmt == 'windowed':
        J, T, _, lmax = _laplacians('normalized')
        return J, T, lmax
    J, T = jgsp.graphs.Grid2d(19, 14), tgsp.graphs.Grid2d(
        19, 14, device='cpu', dtype=torch.float64)
    return J.L, T.L if fmt == 'csr' else T.L.to_banded(), 7.93


@pytest.mark.parametrize('fmt', ['windowed', 'csr', 'banded'])
@pytest.mark.parametrize('g', [1, 3, 5, 14])
def test_grouped_accumulation_matches_jax(fmt, g, monkeypatch):
    """m = 20: 19 steps after the first two terms, not a multiple of 3, 5
    or 14, so the head remainder runs one step at a time first. The port
    groups on the CSR and banded formats too, where the JAX package adds
    each term as it comes: the same sums in another order."""
    J, T, lmax = _grouped_case(fmt)
    c = _heat(lmax, m=20)
    x = np.random.default_rng(13).normal(size=(T.n_vertices, 3))
    monkeypatch.setenv('PYGSP_CHEBY_ACC_GROUP', str(g))
    want = np.asarray(jcheby.cheby_op(J, lmax, jnp.asarray(c),
                                      jnp.asarray(x)))
    sizes = []
    plain = cheby_kernel.cheby_acc_group_plain

    def counted(acc, terms, cg, start=0):
        sizes.append(cg.shape[0])
        return plain(acc, terms, cg, start)

    monkeypatch.setattr(cheby_kernel, 'cheby_acc_group_plain', counted)
    got = tcheby.cheby_op(T, lmax, torch.from_numpy(c), torch.from_numpy(x))
    assert np.allclose(got.numpy(), want, rtol=0, atol=1e-12)
    # T̃_1, then the head one step at a time, then groups of g
    assert sizes == [1] * (1 + 19 % g) + [g] * (19 // g)


def test_group_rule_counts_what_jax_counts(monkeypatch):
    """The default g: the slabs' bytes as the JAX package stores them,
    and the cap of 14 at the bench graph."""
    monkeypatch.delenv('PYGSP_CHEBY_ACC_GROUP', raising=False)
    for case in ('hub-rows', 'P256-int32-rowid', 'auto'):
        _, J, T = _build(case)
        for jm, tm in ((J, T), (J.astype(jnp.bfloat16),
                                T.astype(torch.bfloat16))):
            jax_bytes = sum(np.asarray(leaf).nbytes
                            for leaf in jax.tree_util.tree_leaves(jm))
            assert tm.stored_bytes() == jax_bytes, case
    n = (1 << 20) * 128
    for carry in (torch.float32, torch.bfloat16):
        assert tcheby.acc_group(29, n, torch.float32, carry, 200 << 20,
                                4) == 14
    # a budget that leaves room for 3 f32 terms after the rest
    term = n * 4
    monkeypatch.setenv('PYGSP_CHEBY_DEVICE_MB',
                       str((200 << 20) / 2**20 + 8 * term / 2**20 + 3.5
                           * term / 2**20))
    assert tcheby.acc_group(29, n, torch.float32, torch.float32, 200 << 20,
                            4) == 3
    monkeypatch.setenv('PYGSP_CHEBY_ACC_GROUP', '40')
    assert tcheby.acc_group(29, n, torch.float32, torch.float32, 0, 4) == 29


# ---------------------------------------------------------------------------
# the fused step's plain versions against the eager passes they replace
# ---------------------------------------------------------------------------

def _rand(*shape, dtype=torch.float64, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=gen, dtype=torch.float64).to(dtype)


@pytest.mark.parametrize('fmt', ['csr', 'banded', 'windowed'])
def test_step_is_the_eager_step(fmt):
    G = tgsp.graphs.Grid2d(16, 12, device='cpu', dtype=torch.float64)
    L = {'csr': G.L, 'banded': G.L.to_banded(),
         'windowed': G.L.to_windowed(chunk_rows=64, window_rows=16)}[fmt]
    op, pin, _ = L.hoisted()
    scale, shift = 2.0 / 3.7, 3.7
    t, t_old = _rand(G.N, 3, seed=1), _rand(G.N, 3, seed=2)
    out = torch.empty_like(t)
    assert op.shifted_step(scale, shift)(t, t_old, out) is out
    if fmt == 'windowed':      # the scale on the SpMM's output
        fd = ((op.diag - shift) * scale)[:, None]
        want = fd * t + scale * tsp.spmm(op.offdiag, t) - t_old
    else:                      # a scaled copy of the values
        want = matvec(op.shifted(scale, shift), t) - t_old
    assert torch.equal(out, want)


def test_step_carries_bf16_rounded_once():
    y, t, t_old = (_rand(50, 8, seed=s, dtype=torch.bfloat16)
                   for s in (5, 6, 7))
    fd, sc = _rand(50, seed=8, dtype=torch.float32), torch.tensor(0.37)
    out = cheby_kernel.cheby_step(y, t, t_old, fd, sc)
    want = (fd[:, None] * t.float() + sc * y.float() - t_old.float()).to(
        torch.bfloat16)
    assert out.dtype == torch.bfloat16 and torch.equal(out, want)


@pytest.mark.parametrize('carry', [torch.float64, torch.bfloat16])
def test_acc_group_is_the_grouped_sum(carry):
    md = torch.float64 if carry == torch.float64 else torch.float32
    ring = _rand(5, 30, 4, seed=11, dtype=carry)
    acc, cg = _rand(3, 30, 4, seed=12, dtype=md), _rand(3, 3, seed=13,
                                                        dtype=md)
    want = acc.clone()
    cheby_kernel.cheby_acc_group(acc, ring, cg, start=4)   # slots 4, 0, 1
    for f in range(3):
        want[f] = want[f] + sum(cg[j, f] * ring[(4 + j) % 5].to(md)
                                for j in range(3))
    assert torch.equal(acc, want)


def test_acc_contract_is_the_synthesis_sum():
    t, acc, ck = _rand(40, 3, 5, seed=14), _rand(40, 3, seed=15), _rand(
        5, seed=16)
    want = acc + (ck * t).sum(-1)
    cheby_kernel.cheby_acc_contract(acc, t, ck)
    assert torch.allclose(acc, want, rtol=0, atol=1e-14)


def test_kernel_b_wrappers_refuse_what_they_cannot_run():
    t = torch.zeros(6, 2)
    fd, sc = torch.zeros(6), torch.tensor(1.0)
    with pytest.raises(ValueError, match='float32 or float64'):
        cheby_kernel.cheby_step(t.half(), t.half(), t.half(), fd.half(),
                                sc.half())
    with pytest.raises(ValueError, match='fdiag'):
        cheby_kernel.cheby_step(t, t, t, torch.zeros(5), sc)
    with pytest.raises(ValueError, match='expected'):
        cheby_kernel.cheby_step(t, t.double(), t, fd, sc)
    with pytest.raises(ValueError, match='contiguous'):
        cheby_kernel.cheby_step(t, t.T.contiguous().T, t, fd, sc)
    with pytest.raises(ValueError, match='R >= g'):
        cheby_kernel.cheby_acc_group(torch.zeros(2, 6, 2), t[None],
                                     torch.zeros(2, 2))
    with pytest.raises(ValueError, match='Nf'):
        cheby_kernel.cheby_acc_contract(torch.zeros(6), t,
                                        torch.zeros(3))
    meta = torch.zeros(6, 2, device='meta')
    with pytest.raises(ValueError, match='runs on cuda or cpu'):
        cheby_kernel.cheby_step(meta, meta, meta, fd.to('meta'),
                                sc.to('meta'))


def _no_build(*args, **kwargs):
    raise AssertionError('a CPU tensor must not reach the CUDA build')


@pytest.mark.parametrize('mode', ['exact', 'carry'])
def test_cpu_banks_launch_no_kernel(mode, monkeypatch):
    monkeypatch.setattr(_cuda, 'build', _no_build)
    monkeypatch.setattr(_cuda, 'function', _no_build)
    for k in windowed_kernel.KERNELS + cheby_kernel.KERNELS:
        monkeypatch.setattr(k, 'launches', 0)
    _, T = _graphs(400, 5)
    s = torch.from_numpy(np.random.default_rng(6).normal(
        size=(T.N, 2)).astype(np.float32))
    kw = {'carry_dtype': torch.bfloat16} if mode == 'carry' else {}
    tgsp.filters.Heat(T, [2.0, 9.0]).filter(s, order=10, **kw)
    assert all(k.launches == 0 for k in windowed_kernel.KERNELS
               + cheby_kernel.KERNELS)


def test_kernel_b_source_names_its_entry_points():
    with open(os.path.join(_cuda.CSRC, 'cheby_step.cu')) as f:
        text = f.read()
    assert 'Replaces:' in text and 'pygsp_tpu/ops/chebyshev.py' in text
    for suffix in sorted(set(cheby_kernel._TYPES.values())):
        for entry in ('cheby_step', 'cheby_acc_group', 'cheby_acc_contract'):
            assert f'{entry}_##SUFFIX(' in text
        assert f'CHEBY_STEP({suffix},' in text
    with open(os.path.join(_cuda.CSRC, 'windowed_fold.cu')) as f:
        text = f.read()
    for suffix in windowed_kernel._FOLD_TYPES.values():
        for rowid in windowed_kernel._ROWIDS.values():
            assert f'(windowed_fold_{suffix}_{rowid},' in text
    for suffix in windowed_kernel._DTYPES.values():
        assert f'(windowed_fold_smem_bytes_{suffix},' in text
    # the tail has an instance for each of the fold's pairs; without the
    # residue list the wrapper takes the one named by t's dtype alone
    for suffix in (set(windowed_kernel._FOLD_TYPES.values())
                   | set(windowed_kernel._DTYPES.values())):
        assert f'WINDOW_STRIP(window_strip_{suffix},' in text
