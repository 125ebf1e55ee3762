"""Conjugate gradients, learning and ``prox_tv`` against pygsp_tpu, at
float64 on the CPU.

``ops.cg.cg`` follows ``jax.scipy.sparse.linalg.cg`` (jax 0.9.0): one CG
over the whole block, α and β from dot products over all of its elements,
stopping when ``‖r‖² ≤ max(tol²‖b‖², atol²)``. Its result is held within
1e-10 of JAX's and its iteration count must equal JAX's. JAX's is counted
by a ``jax.debug.callback`` in the operator, which runs once before the
loop and once an iteration on the device; the learning and ``prox_tv``
loops are counted likewise, by the Laplacian products (``matvec``) or the
divergences (``D.div``) each package runs, so each must stop at the JAX
package's iteration. λmax is the JAX package's in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygsp_tpu as jgsp
import pygsp_tpu_torch as tgsp
from pygsp_tpu import learning as jlearning
from pygsp_tpu import optimization as joptimization
from pygsp_tpu_torch import learning as tlearning
from pygsp_tpu_torch import optimization as toptimization
from pygsp_tpu_torch.ops.cg import cg

CPU64 = dict(device='cpu', dtype=torch.float64)
TOL = 1e-10


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1.0)


class _Counter:
    """Counts the calls of a function on either side: a Python counter for
    the port, a ``jax.debug.callback`` (run on every execution, inside a
    while loop too) for JAX."""

    def __init__(self):
        self.n = 0

    def bump(self):
        self.n += 1

    def jax(self, fn):
        def counted(*args):
            jax.debug.callback(self.bump)
            return fn(*args)
        return counted

    def torch(self, fn):
        def counted(*args):
            self.bump()
            return fn(*args)
        return counted


@pytest.fixture(scope='module')
def graphs():
    """The Sensor graph on both sides, with the JAX package's λmax."""
    J = jgsp.graphs.Sensor(256, seed=42)
    T = tgsp.graphs.Sensor(256, seed=42, **CPU64)
    J.estimate_lmax()
    T._lmax, T._lmax_method = float(J.lmax), J._lmax_method
    return J, T


def _mask(n, share, seed):
    return np.random.default_rng(seed).random(n) < share


@pytest.mark.parametrize('kw', [dict(), dict(tol=1e-8), dict(maxiter=7),
                                dict(atol=1e-3, tol=0.0)])
def test_cg_matches_jax_and_its_iteration_count(graphs, kw):
    J, T = graphs
    mask = _mask(T.N, 0.2, 1).astype(float)
    b = np.random.default_rng(2).normal(size=(T.N, 5))
    cj, ct = _Counter(), _Counter()

    def op_j(x):
        return mask[:, None] * x + 0.5 * (J.L @ x)

    def op_t(x):
        return torch.from_numpy(mask)[:, None] * x + 0.5 * (T.L @ x)

    want, _ = jax.scipy.sparse.linalg.cg(cj.jax(op_j), jnp.asarray(b), **kw)
    got, n = cg(ct.torch(op_t), torch.from_numpy(b), **kw)
    _close(got, want)
    assert n + 1 == ct.n == cj.n
    if 'maxiter' in kw:
        assert n == kw['maxiter']


def test_cg_is_one_solve_over_the_block():
    """A block's iteration count is the whole block's, not its columns':
    two columns of different difficulty stop together."""
    A = np.diag(np.linspace(1.0, 50.0, 40))
    b = np.zeros((40, 2))
    b[0, 0] = 1.0                         # one eigenvector: one iteration
    b[:, 1] = 1.0
    cj = _Counter()
    want, _ = jax.scipy.sparse.linalg.cg(cj.jax(lambda x: jnp.asarray(A) @ x),
                                         jnp.asarray(b))
    got, n = cg(lambda x: torch.from_numpy(A) @ x, torch.from_numpy(b))
    _close(got, want)
    assert n + 1 == cj.n and n > 1
    _, n0 = cg(lambda x: torch.from_numpy(A) @ x, torch.from_numpy(b[:, :1]))
    assert n0 == 1


def test_cg_takes_a_start_and_refuses_its_shape():
    A = np.diag(np.arange(1.0, 9.0))
    b = np.ones(8)
    x0 = np.full(8, 0.3)
    want, _ = jax.scipy.sparse.linalg.cg(lambda x: jnp.asarray(A) @ x,
                                         jnp.asarray(b), x0=jnp.asarray(x0))
    got, _ = cg(lambda x: torch.from_numpy(A) @ x, torch.from_numpy(b),
                x0=torch.from_numpy(x0))
    _close(got, want)
    with pytest.raises(ValueError, match='matching shapes'):
        cg(lambda x: x, torch.ones(3), x0=torch.ones(4))


def _count_matvec(monkeypatch):
    cj, ct = _Counter(), _Counter()
    monkeypatch.setattr(jlearning, 'matvec', cj.jax(jlearning.matvec))
    monkeypatch.setattr(tlearning, 'matvec', ct.torch(tlearning.matvec))
    return cj, ct


@pytest.mark.parametrize('tau', [0.5, 0])
@pytest.mark.parametrize('cols', [None, 3])
def test_regression_tikhonov_matches_jax(graphs, monkeypatch, tau, cols):
    J, T = graphs
    M = _mask(T.N, 0.3, 3)
    shape = (T.N,) if cols is None else (T.N, cols)
    y = np.random.default_rng(4).normal(size=shape)
    cj, ct = _count_matvec(monkeypatch)
    want = jlearning.regression_tikhonov(J, y.copy(), M, tau=tau)
    got = tlearning.regression_tikhonov(T, y.copy(), M, tau=tau)
    _close(got, want)
    assert ct.n == cj.n > 2


def test_regression_tikhonov_refuses_a_wrong_mask(graphs):
    J, T = graphs
    y = np.zeros(T.N)
    with pytest.raises(ValueError) as jerr:
        jlearning.regression_tikhonov(J, y, np.ones(T.N - 1, bool), tau=0)
    with pytest.raises(ValueError) as terr:
        tlearning.regression_tikhonov(T, y, np.ones(T.N - 1, bool), tau=0)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize('tau', [0.1, 0])
def test_classification_tikhonov_matches_jax(graphs, monkeypatch, tau):
    J, T = graphs
    M = _mask(T.N, 0.25, 5)
    labels = (np.arange(T.N) * 7 % 3).astype(float)
    cj, ct = _count_matvec(monkeypatch)
    want = jlearning.classification_tikhonov(J, labels, M, tau=tau)
    got = tlearning.classification_tikhonov(T, labels, M, tau=tau)
    assert tuple(got.shape) == (T.N, 3)
    _close(got, want)
    assert ct.n == cj.n


@pytest.mark.parametrize('kw', [dict(), dict(tau=0.5, maxit=40),
                                dict(tol=1e-4)])
def test_classification_tikhonov_simplex_matches_jax(graphs, monkeypatch,
                                                     kw):
    J, T = graphs
    M = _mask(T.N, 0.3, 6)
    labels = (np.arange(T.N) % 4).astype(float)
    cj, ct = _count_matvec(monkeypatch)
    want = jlearning.classification_tikhonov_simplex(J, labels, M, **kw)
    got = tlearning.classification_tikhonov_simplex(T, labels, M, **kw)
    _close(got, want)
    assert ct.n == cj.n > 1
    if 'maxit' in kw:
        assert ct.n == kw['maxit']
    assert torch.allclose(got.sum(dim=1), torch.ones(T.N, **{
        'dtype': torch.float64}), atol=1e-12)
    assert bool((got >= 0).all())


def test_classification_tikhonov_simplex_refuses_tau_zero(graphs):
    J, T = graphs
    with pytest.raises(ValueError) as jerr:
        jlearning.classification_tikhonov_simplex(J, np.zeros(T.N),
                                                  np.ones(T.N), tau=0)
    with pytest.raises(ValueError) as terr:
        tlearning.classification_tikhonov_simplex(T, np.zeros(T.N),
                                                  np.ones(T.N), tau=0)
    assert str(terr.value) == str(jerr.value)


def _count_div(monkeypatch, J, T):
    J.compute_differential_operator()
    T.compute_differential_operator()
    cj, ct = _Counter(), _Counter()
    monkeypatch.setattr(J.D, 'div', cj.jax(J.D.div))
    monkeypatch.setattr(T.D, 'div', ct.torch(T.D.div))
    return cj, ct


@pytest.mark.parametrize('kw', [dict(gamma=0.3), dict(gamma=2.0, maxit=15),
                                dict(gamma=0.5, tol=1e-6),
                                dict(gamma=0.4, nu=2)])
def test_prox_tv_matches_jax(graphs, monkeypatch, kw):
    J, T = graphs
    x = np.where(T.coords[:, 0] > 0.5, 1.0, -1.0)
    x = x + 0.3 * np.random.default_rng(7).normal(size=T.N)
    cj, ct = _count_div(monkeypatch, J, T)
    want = joptimization.prox_tv(x, G=J, **kw)
    got = toptimization.prox_tv(x, G=T, **kw)
    _close(got, want)
    assert ct.n == cj.n > 2
    if 'maxit' in kw:
        assert ct.n == kw['maxit'] + 1


def test_prox_tv_with_operator_hooks_and_columns(graphs, monkeypatch):
    J, T = graphs
    x = np.random.default_rng(8).normal(size=(T.N, 2))
    cj, ct = _count_div(monkeypatch, J, T)
    want = joptimization.prox_tv(x, 0.2, J, A=lambda z: 2 * z,
                                 At=lambda z: 2 * z)
    got = toptimization.prox_tv(x, 0.2, T, A=lambda z: 2 * z,
                                At=lambda z: 2 * z)
    _close(got, want)
    assert ct.n == cj.n


def test_prox_tv_lowers_the_total_variation(graphs):
    _, T = graphs
    x = np.random.default_rng(9).normal(size=T.N)
    z = toptimization.prox_tv(x, 0.5, T)
    tv = lambda v: float(torch.sum(torch.abs(T.grad(v))))  # noqa: E731
    assert tv(z) < tv(torch.from_numpy(x))
