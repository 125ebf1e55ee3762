"""The port's Chebyshev filtering against pygsp_tpu, in float64 on the CPU.

λmax is pinned from the JAX graph: the two packages draw their Lanczos
start vectors from different generators.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygsp_tpu as jgsp
import pygsp_tpu_torch as tgsp
from pygsp_tpu.ops import chebyshev as jcheby
from pygsp_tpu_torch.ops import chebyshev as tcheby

CPU64 = dict(device='cpu', dtype=torch.float64)


def _pinned(make, method='lanczos'):
    """(JAX graph, port graph) with the port's λmax pinned to JAX's.
    ``method='bounds'`` spares a Lanczos compile where the value of λmax
    does not matter to the test."""
    J, T = make(jgsp), make(tgsp, **CPU64)
    J.estimate_lmax(method=method)
    T._lmax, T._lmax_method = J.lmax, 'pinned'
    return J, T


def _logo(pkg, **kw):
    return pkg.graphs.Logo(**kw)


def _grid(width, height):
    return lambda pkg, **kw: pkg.graphs.Grid2d(width, height, **kw)


@pytest.mark.parametrize('scales', [[50.0], [5.0, 10.0, 25.0, 50.0]])
def test_cheby_coeff_matches_jax(scales):
    J, T = _pinned(_logo)
    want = np.asarray(jcheby.cheby_coeff(jgsp.filters.Heat(J, scales).evaluate,
                                         J.lmax, m=30))
    got = tcheby.cheby_coeff(tgsp.filters.Heat(T, scales).evaluate, T.lmax,
                             m=30, dtype=torch.float64, device='cpu')
    assert got.shape == want.shape
    assert np.allclose(got.numpy(), want, rtol=0, atol=1e-13)   # f64 order


def test_config1_logo_heat_matches_jax():
    """Config 1, the README example: Logo, Heat(scale=50), K=30, a delta
    at vertex 20 (tests/test_baseline_configs.py:22-30)."""
    J, T = _pinned(_logo)
    s = np.zeros(J.N)
    s[20] = 1
    want = np.asarray(jgsp.filters.Heat(J, scale=50).filter(s, order=30))
    got = tgsp.filters.Heat(T, scale=50).filter(s, order=30)
    assert got.shape == want.shape and got.device.type == 'cpu'
    assert np.allclose(got.numpy(), want, rtol=0, atol=1e-12)  # f64 order
    assert abs(float(got.sum()) - 1.0) < 1e-6         # heat conserves mass


def test_intermediates_match_per_order():
    J, T = _pinned(_logo)
    x = np.random.default_rng(0).normal(size=(J.N, 2))
    c = np.asarray(jcheby.cheby_coeff(jgsp.filters.Heat(J, 50).evaluate,
                                      J.lmax, m=30))
    jacc, jterms = jcheby.cheby_op_intermediates(J.L, J.lmax, jnp.asarray(c),
                                                 jnp.asarray(x))
    tacc, tterms = tcheby.cheby_op_intermediates(T.L, T.lmax,
                                                 torch.from_numpy(c),
                                                 torch.from_numpy(x))
    assert tterms.shape == (31, J.N, 2)
    for k in range(31):    # f64, summation order of the SpMM: 1e-10
        assert np.allclose(tterms[k].numpy(), np.asarray(jterms[k]),
                           rtol=0, atol=1e-10), k
    assert np.allclose(tacc.numpy(), np.asarray(jacc), rtol=0, atol=1e-10)
    # cheby_op is the same recurrence without the stacked terms
    acc = tcheby.cheby_op(T.L, T.lmax, torch.from_numpy(c),
                          torch.from_numpy(x))
    assert np.allclose(acc.numpy(), tacc.numpy(), rtol=0, atol=1e-13)


@pytest.mark.parametrize('make', [
    _logo,
    lambda pkg, **kw: pkg.graphs.BarabasiAlbert(150, m0=3, m=3, seed=1,
                                                **kw),
], ids=['logo', 'ba'])
def test_heat_bank_on_signal_block_matches_jax(make):
    J, T = _pinned(make)
    scales = [5.0, 10.0, 25.0, 50.0]
    s = np.random.default_rng(1).normal(size=(J.N, 3))
    want = np.asarray(jgsp.filters.Heat(J, scales).filter(s, order=30))
    got = tgsp.filters.Heat(T, scales).filter(torch.from_numpy(s), order=30)
    assert got.shape == want.shape == (J.N, 3, 4)
    assert np.allclose(got.numpy(), want, rtol=0, atol=1e-12)  # f64 order
    # analyze is the same analysis, and a rank-3 signal with one feature
    got3 = tgsp.filters.Heat(T, scales).analyze(s[:, :, None], order=30)
    assert np.allclose(got3.numpy(), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize('order', [1, 2, 7])
def test_low_orders_match_jax(order):
    J, T = _pinned(_grid(9, 8), 'bounds')
    s = np.random.default_rng(2).normal(size=J.N)
    want = np.asarray(jgsp.filters.Heat(J, [3.0, 30.0]).filter(s,
                                                                order=order))
    got = tgsp.filters.Heat(T, [3.0, 30.0]).filter(s, order=order)
    assert np.allclose(got.numpy(), want, rtol=0, atol=1e-12)  # f64 order


def test_banded_operator_matches_jax_csr_path():
    """Mirrors tests/test_core.py::test_banded_laplacian_cheby."""
    J, T = (pkg.graphs.Grid2d(12, 10, **kw)
            for pkg, kw in ((jgsp, {}), (tgsp, CPU64)))
    J.estimate_lmax(method='bounds')
    T.estimate_lmax(method='bounds')
    Lb = T.L.to_banded()
    assert Lb is not None and Lb.offdiag.half_bw == 1
    rng = np.random.default_rng(3)
    x = rng.normal(size=(J.N, 3))
    c = rng.normal(size=(2, 15))
    want = np.asarray(jcheby.cheby_op(J.L, J.lmax, jnp.asarray(c),
                                      jnp.asarray(x)))
    got = tcheby.cheby_op(Lb, T.lmax, torch.from_numpy(c),
                          torch.from_numpy(x))
    assert np.allclose(got.numpy(), want, rtol=0, atol=1e-8)
    assert abs(Lb.to_scipy() - J.L.to_scipy()).max() <= 1e-14


def test_mixed_dtypes_promote_like_jax():
    """A float32 signal on a float64 operator is promoted once."""
    J, T = _pinned(_grid(6, 6), 'bounds')
    x = np.random.default_rng(4).normal(size=(J.N, 2)).astype(np.float32)
    c = np.random.default_rng(5).normal(size=(1, 6))
    want = np.asarray(jcheby.cheby_op(J.L, J.lmax, jnp.asarray(c),
                                      jnp.asarray(x)))
    got = tcheby.cheby_op(T.L, T.lmax, torch.from_numpy(c),
                          torch.from_numpy(x))
    assert got.dtype == torch.float64
    assert np.allclose(got.numpy(), want, rtol=0, atol=1e-12)


def test_errors_match_jax():
    J, T = _pinned(_logo)
    x = torch.zeros(T.N, 2, dtype=torch.float64)
    c = torch.ones(1, 5, dtype=torch.float64)
    for kw in (dict(carry_dtype=torch.float32), dict(vals_dtype=torch.float32)):
        jkw = {k: jnp.float32 for k in kw}
        with pytest.raises(ValueError) as jerr:
            jcheby.cheby_op(J.L, J.lmax, jnp.asarray(c.numpy()),
                            jnp.asarray(x.numpy()), **jkw)
        with pytest.raises(ValueError) as terr:
            tcheby.cheby_op(T.L, T.lmax, c, x, **kw)
        assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match='order >= 1'):
        tcheby.cheby_op(T.L, T.lmax, c[:, :1], x)
    # a carry in the signal's own dtype is the exact path, as in JAX
    tcheby.cheby_op(T.L, T.lmax, c, x, carry_dtype=torch.float64)

    g = tgsp.filters.Heat(T, [1.0, 2.0])
    jg = jgsp.filters.Heat(J, [1.0, 2.0])
    for s in (np.zeros((T.N, 2, 3)), np.zeros((T.N, 2, 2, 1, 1))):
        with pytest.raises(ValueError) as jerr:
            jg.filter(s)
        with pytest.raises(ValueError) as terr:
            g.filter(s)
        assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match='Unknown method'):
        g.filter(np.zeros(T.N), method='bogus')
    with pytest.raises(ValueError, match='Last dimension'):
        g.analyze(np.zeros((T.N, 1, 2)))


@pytest.mark.parametrize('call', ['to_hybrid', 'to_chunked'])
def test_unported_options_name_their_roadmap_item(call):
    """``to_hybrid`` and ``to_chunked``, which raised until the formats of
    ROADMAP.md's "Modules to port" item 4 were ported, now convert as the
    JAX package does: the same operator, and a heat bank on it within
    1e-12."""
    T = tgsp.graphs.Grid2d(4, 4, **CPU64)
    J = jgsp.graphs.Grid2d(4, 4)
    J.estimate_lmax(method='bounds')
    TL, JL = getattr(T.L, call)(), getattr(J.L, call)()
    assert type(TL.offdiag).__name__ == type(JL.offdiag).__name__
    assert abs(TL.to_scipy() - JL.to_scipy()).max() == 0
    x = np.random.default_rng(1).normal(size=(T.N, 2))
    c = np.asarray(jcheby.cheby_coeff(
        lambda lam: jnp.exp(-2.0 * lam)[None], J.lmax, 30))
    want = np.asarray(jcheby.cheby_op(JL, J.lmax, jnp.asarray(c),
                                      jnp.asarray(x)))
    got = tcheby.cheby_op(TL, J.lmax, torch.from_numpy(c),
                          torch.from_numpy(x))
    assert np.abs(got.numpy() - want).max() <= 1e-12


def test_filter_bank_algebra():
    T = tgsp.graphs.Grid2d(5, 5, **CPU64)
    T.estimate_lmax(method='bounds')
    g = tgsp.filters.Heat(T, [1.0, 2.0]) + tgsp.filters.Filter(
        T, lambda x: 1.0 / (1.0 + x))
    assert g.Nf == len(g) == 3 and g[2].Nf == 1 and g[:2].Nf == 2
    lam = torch.linspace(0, T.lmax, 7, dtype=torch.float64)
    resp = g(lam)
    assert resp.shape == (3, 7)
    assert torch.allclose(resp[2], 1.0 / (1.0 + lam))
    assert torch.allclose(resp[0], torch.exp(-lam / T.lmax))
    H = tgsp.graphs.Grid2d(3, 3, **CPU64)
    assert g(H).G is H
    assert repr(tgsp.filters.Heat(T, [1.0, 2.0])) == (
        'Heat(in=1, out=2, scale=[1.00, 2.00], normalize=False)')
