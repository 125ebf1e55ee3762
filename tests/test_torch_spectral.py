"""The spectral side against pygsp_tpu, in float64 on the CPU: the Fourier
basis (``fourier_basis``, ``Graph.compute_fourier_basis``, ``e``, ``U`` up
to the sign of each eigenvector, ``coherence``, ``gft``/``igft``), the
filter methods ``'exact'`` and ``'lanczos'`` in both directions,
``lanczos_basis``/``lanczos_op``/``lanczos_synthesis_op`` on the CSR and
windowed formats, and ``Heat(normalize=True)``. λmax is pinned from the
JAX side wherever a kernel reads it."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import pygsp_tpu as jgsp
import pygsp_tpu_torch as tgsp
from pygsp_tpu.ops import eigen as jeigen
from pygsp_tpu.ops import lanczos as jlanczos
from pygsp_tpu_torch.ops import eigen as teigen
from pygsp_tpu_torch.ops import lanczos as tlanczos

from test_torch_synthesis import CPU64, _pair

TOL = 1e-10


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol * max(
        1.0, float(np.abs(want).max()))


def _weighted(n=60, seed=1):
    """A connected graph with random weights: distinct eigenvalues, so each
    eigenvector is fixed up to its sign."""
    rng = np.random.default_rng(seed)
    W = sps.random(n, n, density=0.15, random_state=rng)
    W = W + W.T + sps.diags(np.ones(n - 1), 1) + sps.diags(np.ones(n - 1), -1)
    W.setdiag(0)
    W = sps.csr_matrix(W)
    W.eliminate_zeros()
    return jgsp.graphs.Graph(W), tgsp.graphs.Graph(W, **CPU64)


def _pin(J, T):
    J.estimate_lmax(method='bounds')
    T._lmax, T._lmax_method = J.lmax, 'pinned'
    return J, T


def _logo():
    return _pin(jgsp.graphs.Logo(), tgsp.graphs.Logo(**CPU64))


def _windowed_graphs():
    """A power-law graph in the windowed format in both packages, its
    vertex order shuffled (tests/test_torch_windowed.py's matrix)."""
    from test_torch_windowed import _powerlaw
    W = _powerlaw(500, 17)
    J, T = jgsp.graphs.Graph(W), tgsp.graphs.Graph(W, **CPU64)
    J.compute_laplacian(fmt='windowed')
    T.compute_laplacian(fmt='windowed')
    assert T.L.offdiag.perm is not None
    return _pin(J, T)


def test_fourier_basis_matches_jax_up_to_signs():
    J, T = _weighted()
    J.compute_fourier_basis()
    T.compute_fourier_basis()
    e, U = T.e, T.U
    assert float(e[0]) == 0.0 and U.shape == (T.N, T.N)
    _close(e, J.e)
    # each eigenvector up to its sign
    sign = np.sign(np.sum(U.numpy() * np.asarray(J.U), axis=0))
    _close(U * torch.from_numpy(sign), J.U, 1e-8)
    assert abs(T.coherence - J.coherence) <= 1e-8
    assert T._lmax_method == J._lmax_method == 'fourier'
    assert T.lmax == pytest.approx(J.lmax, abs=TOL)
    s = np.random.default_rng(2).normal(size=(T.N, 3))
    s_hat = T.gft(s)
    _close(s_hat * torch.from_numpy(sign)[:, None], J.gft(s), 1e-8)
    _close(T.igft(s_hat), s)
    e_k, U_k = teigen.fourier_basis(T.L, 7)
    je_k, _ = jeigen.fourier_basis(J.L, 7)
    assert U_k.shape == (T.N, 7)
    _close(e_k, je_k)


def test_fourier_basis_is_computed_on_first_use_and_dropped_with_the_type():
    _, T = _weighted(40, 3)
    assert T._U is None
    assert T.U.shape == (40, 40)                  # computed with a warning
    T.compute_fourier_basis(10)                   # already there: kept
    assert T.U.shape == (40, 40)
    T.compute_laplacian('normalized')
    assert T._U is None and T._e is None and T._coherence is None
    T.compute_fourier_basis()
    assert float(T.e[-1]) <= 2.0 + 1e-12


@pytest.mark.parametrize('nf_in', [1, 2])
def test_exact_filtering_matches_jax(nf_in):
    """Analysis (1 feature in) and synthesis (Nf in): U f(Λ) Uᵀ, which
    does not depend on the basis eigh picks inside a degenerate space."""
    J, T = _logo()
    J.compute_fourier_basis()
    T.compute_fourier_basis()
    rng = np.random.default_rng(nf_in)
    s = rng.normal(size=(T.N, 3, nf_in))
    jg = jgsp.filters.Heat(J, scale=[10.0, 50.0])
    tg = tgsp.filters.Heat(T, scale=[10.0, 50.0])
    want = np.asarray(jg.filter(s, method='exact'))
    got = tg.filter(s, method='exact')
    assert got.shape == want.shape
    _close(got, want)


def test_heat_normalize_matches_jax():
    J, T = _logo()
    J.compute_fourier_basis()
    T.compute_fourier_basis()
    jg = jgsp.filters.Heat(J, scale=[5, 9], normalize=True)
    tg = tgsp.filters.Heat(T, scale=[5, 9], normalize=True)
    lam = np.linspace(0, J.lmax, 40)
    _close(tg.evaluate(torch.from_numpy(lam)), jg.evaluate(lam))
    assert np.allclose(np.linalg.norm(tg.evaluate(T.e).numpy(), axis=1), 1)
    s = np.random.default_rng(4).normal(size=T.N)
    _close(tg.filter(s, method='exact'),
           np.asarray(jg.filter(s, method='exact')))
    assert repr(tg) == repr(jg)


@pytest.mark.parametrize('fmt', ['csr', 'windowed'])
def test_lanczos_ops_match_jax(fmt):
    """tests/test_chebyshev.py::test_lanczos_windowed_parity's shapes."""
    J, T, lmax = _pair(fmt)
    scales = torch.tensor([5.0, 20.0], dtype=torch.float64)

    def tev(lam):
        return torch.exp(-scales[:, None] * lam[None, :] / lmax)

    def jev(lam):
        return jnp.exp(-jnp.asarray(scales.numpy())[:, None]
                       * lam[None, :] / lmax)

    rng = np.random.default_rng(17)
    n = T.n_vertices
    x = rng.normal(size=(n, 3))
    got = tlanczos.lanczos_op(T, tev, torch.from_numpy(x), order=25)
    assert got.shape == (2, n, 3)
    _close(got, jlanczos.lanczos_op(J, jev, jnp.asarray(x), order=25))
    got1 = tlanczos.lanczos_op(T, tev, torch.from_numpy(x[:, 0]), order=25)
    _close(got1, jlanczos.lanczos_op(J, jev, jnp.asarray(x[:, 0]), order=25))
    s = rng.normal(size=(n, 2, 2))
    _close(tlanczos.lanczos_synthesis_op(T, tev, torch.from_numpy(s),
                                         order=25),
           jlanczos.lanczos_synthesis_op(J, jev, jnp.asarray(s), order=25))


@pytest.mark.parametrize('fmt', ['csr', 'windowed'])
def test_lanczos_basis_matches_jax(fmt):
    J, T, _ = _pair(fmt)
    x = np.random.default_rng(6).normal(size=(T.n_vertices, 2))
    V, H = tlanczos.lanczos_basis(T, torch.from_numpy(x), 12)
    jV, jH = jlanczos.lanczos_basis(J, jnp.asarray(x), 12)
    assert V.shape == (2, T.n_vertices, 12) and H.shape == (2, 12, 12)
    _close(V, jV, 1e-9)
    _close(H, jH)
    v1, h1 = tlanczos.lanczos_basis(T, torch.from_numpy(x[:, 0]), 12)
    jv1, jh1 = jlanczos.lanczos_basis(J, jnp.asarray(x[:, 0]), 12)
    assert v1.shape == (T.n_vertices, 12) and h1.shape == (12, 12)
    _close(v1, jv1, 1e-9)


@pytest.mark.parametrize('graphs', ['logo', 'windowed'])
@pytest.mark.parametrize('nf_in', [1, 2])
def test_lanczos_filtering_matches_jax(graphs, nf_in):
    J, T = _logo() if graphs == 'logo' else _windowed_graphs()
    s = np.random.default_rng(9).normal(size=(T.N, 3, nf_in))
    jg = jgsp.filters.Heat(J, scale=[10.0, 50.0])
    tg = tgsp.filters.Heat(T, scale=[10.0, 50.0])
    want = np.asarray(jg.filter(s, method='lanczos', order=30))
    got = tg.filter(s, method='lanczos', order=30)
    assert got.shape == want.shape
    _close(got, want)


def test_lanczos_matches_exact():
    """tests/test_chebyshev.py::test_lanczos_matches_exact on the port."""
    _, T = _logo()
    T.compute_fourier_basis()
    g = tgsp.filters.Heat(T, scale=[10, 50])
    s = np.random.default_rng(42).normal(size=(T.N,))
    out_l = g.filter(s, method='lanczos', order=30)
    out_e = g.filter(s, method='exact')
    assert np.allclose(out_l.numpy(), out_e.numpy(), atol=1e-6)
