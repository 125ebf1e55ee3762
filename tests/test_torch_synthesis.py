"""The recurrence's other forward functions against pygsp_tpu, in float64 on
the CPU: ``cheby_synthesis`` on every format, ``Filter.synthesize`` and
``filter`` with Nf input features, ``cheby_rect`` and
``jackson_cheby_coeff``. λmax is pinned from the JAX side."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygsp_tpu as jgsp
import pygsp_tpu_torch as tgsp
from pygsp_tpu.ops import chebyshev as jcheby
from pygsp_tpu_torch.core import cheby_kernel
from pygsp_tpu_torch.ops import chebyshev as tcheby

from test_torch_carry import MODES, _f32, _heat
from test_torch_windowed import _laplacians

CPU64 = dict(device='cpu', dtype=torch.float64)
TOL = 1e-12


def _pair(fmt):
    """(JAX operator, port operator, λmax) in ``fmt``."""
    if fmt == 'windowed':
        J, T, _, lmax = _laplacians('normalized')
        return J, T, lmax
    J = jgsp.graphs.Logo() if fmt == 'csr' else jgsp.graphs.Grid2d(14, 11)
    T = (tgsp.graphs.Logo(**CPU64) if fmt == 'csr'
         else tgsp.graphs.Grid2d(14, 11, **CPU64))
    J.estimate_lmax(method='bounds')
    if fmt == 'banded':
        return J.L.to_banded(), T.L.to_banded(), J.lmax
    return J.L, T.L, J.lmax


@pytest.mark.parametrize('order', [1, 2, 30])
@pytest.mark.parametrize('fmt', ['csr', 'banded', 'windowed'])
def test_cheby_synthesis_matches_jax(fmt, order):
    J, T, lmax = _pair(fmt)
    n = T.n_vertices
    c = _heat(lmax, (3.0, 8.0, 20.0), m=order)
    bank = np.random.default_rng(order).normal(size=(n, 4, 3))
    want = np.asarray(jcheby.cheby_synthesis(J, lmax, jnp.asarray(c),
                                             jnp.asarray(bank)))
    got = tcheby.cheby_synthesis(T, lmax, torch.from_numpy(c),
                                 torch.from_numpy(bank))
    assert got.shape == want.shape == (n, 4)
    assert np.allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_cheby_synthesis_refuses_a_bank_of_the_wrong_width():
    J, T, lmax = _pair('csr')
    c = _heat(lmax, (3.0, 8.0), m=5)
    bank = np.zeros((T.n_vertices, 3))
    with pytest.raises(ValueError) as jerr:
        jcheby.cheby_synthesis(J, lmax, jnp.asarray(c), jnp.asarray(bank))
    with pytest.raises(ValueError) as terr:
        tcheby.cheby_synthesis(T, lmax, torch.from_numpy(c),
                               torch.from_numpy(bank))
    assert str(terr.value) == str(jerr.value)


def test_cheby_synthesis_contracts_once_per_step(monkeypatch):
    """Each step after the first two terms is one contraction of the
    filter axis (kernel B's third entry point)."""
    _, T, lmax = _pair('windowed')
    calls = []
    plain = cheby_kernel.cheby_acc_contract_plain
    monkeypatch.setattr(cheby_kernel, 'cheby_acc_contract_plain',
                        lambda acc, t, ck: calls.append(1) or plain(acc, t,
                                                                    ck))
    c = torch.from_numpy(_heat(lmax, (3.0, 8.0), m=9))
    tcheby.cheby_synthesis(T, lmax, c, torch.zeros(T.n_vertices, 2, 2,
                                                   dtype=torch.float64))
    assert len(calls) == 8


@pytest.mark.parametrize('mode', list(MODES))
def test_cheby_synthesis_bf16_modes(mode):
    """The narrow modes of synthesis on the windowed format, within the
    carry bound of JAX's output in the same mode and of the f64 one."""
    J, T, lmax = _pair('windowed')
    c = _heat(lmax, (3.0, 8.0, 20.0))
    bank = np.random.default_rng(5).normal(size=(500, 2, 3))
    bank = bank.astype(np.float32)
    ref = np.asarray(jcheby.cheby_synthesis(J, lmax, jnp.asarray(c),
                                            jnp.asarray(bank, jnp.float64)))
    want = np.asarray(jcheby.cheby_synthesis(
        _f32(J), lmax, jnp.asarray(c, jnp.float32), jnp.asarray(bank),
        **{k: jnp.bfloat16 for k in MODES[mode]}))
    got = tcheby.cheby_synthesis(
        T.astype(torch.float32), lmax, torch.from_numpy(c).float(),
        torch.from_numpy(bank), **{k: torch.bfloat16 for k in MODES[mode]})
    assert got.dtype == torch.float32
    est = tcheby.carry_error_estimate(c, torch.bfloat16)
    top = float(np.abs(ref).max())
    assert float(np.abs(got.double().numpy() - want).max()) <= 2 * est * top
    assert float(np.abs(got.double().numpy() - ref).max()) <= (
        1.5 * est * top)


def _graphs():
    J, T = jgsp.graphs.Logo(), tgsp.graphs.Logo(**CPU64)
    J.estimate_lmax(method='bounds')
    T._lmax, T._lmax_method = J.lmax, 'pinned'
    return J, T


@pytest.mark.parametrize('shape', [(2, 3), (3,), (1, 3)])
def test_synthesize_matches_jax(shape):
    """``synthesize`` and ``filter`` of an (N, [S,] Nf) signal, and the
    round trip analysis → synthesis."""
    J, T = _graphs()
    scales = [5.0, 10.0, 20.0]
    s = np.random.default_rng(len(shape)).normal(size=(J.N,) + shape)
    jg, tg = jgsp.filters.Heat(J, scales), tgsp.filters.Heat(T, scales)
    want = np.asarray(jg.synthesize(s, order=30))
    got = tg.synthesize(s, order=30)
    assert got.shape == want.shape
    assert np.allclose(got.numpy(), want, rtol=0, atol=TOL)
    assert np.allclose(tg.filter(torch.from_numpy(s), order=30).numpy(),
                       want, rtol=0, atol=TOL)
    x = np.random.default_rng(9).normal(size=J.N)
    want2 = np.asarray(jg.synthesize(jg.analyze(x, order=30), order=30))
    got2 = tg.synthesize(tg.analyze(x, order=30), order=30)
    assert np.allclose(got2.numpy(), want2, rtol=0, atol=TOL)


def test_synthesize_refuses_like_jax():
    J, T = _graphs()
    s = np.zeros((J.N, 2))
    with pytest.raises(ValueError) as jerr:
        jgsp.filters.Heat(J, [1.0, 2.0, 3.0]).synthesize(s)
    with pytest.raises(ValueError) as terr:
        tgsp.filters.Heat(T, [1.0, 2.0, 3.0]).synthesize(s)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize('fmt', ['csr', 'banded', 'windowed'])
def test_cheby_rect_matches_jax(fmt):
    J, T, lmax = _pair(fmt)
    x = np.random.default_rng(2).normal(size=(T.n_vertices, 3))
    for bounds, order in (([0.2 * lmax, 0.7 * lmax], 30),
                          ([0.1 * lmax, 0.6 * lmax], 7)):
        want = np.asarray(jcheby.cheby_rect(J, lmax, bounds, jnp.asarray(x),
                                            order=order))
        got = tcheby.cheby_rect(T, lmax, bounds, torch.from_numpy(x),
                                order=order)
        assert got.shape == want.shape
        assert np.allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize('m', [5, 30])
def test_jackson_cheby_coeff_matches_jax(m):
    for bounds, spectrum in (([0.5, 3.0], [0.0, 13.9]),
                             ([0.0, 1.0], [-1.0, 2.0])):
        want = jcheby.jackson_cheby_coeff(bounds, spectrum, m)
        got = tcheby.jackson_cheby_coeff(bounds, spectrum, m,
                                         dtype=torch.float64, device='cpu')
        for w, g in zip(want, got):
            assert g.shape == (m + 1,)
            assert np.allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL)
