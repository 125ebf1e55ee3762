"""The filter zoo, the rest of ``Filter`` and the approximations façade
against pygsp_tpu, in float64 on the CPU.

λmax is pinned from the JAX side, and so is the Fourier basis where a test
reads it (``method='exact'``, ``Gabor``, ``Modulation``): the port's
eigenvectors agree with the JAX package's only up to their signs, and
``Modulation``'s responses depend on those signs.

Tolerances: 1e-12 of the largest reference magnitude everywhere (the same
f64 arithmetic in another order; the kernels' responses agree to 1e-15,
the filtered signals to 1e-14 on these graphs).

The JAX package's own ``filter(method='chebyshev')`` raises for the four
quadrature-mirror pairs (``Regular``, ``Held``, ``Simoncelli``,
``Papadakis``): their ``complement(frame_bound=1)`` converts a traced
value to a float under its ``jax.jit``. So the Chebyshev reference of
every design is the JAX recurrence (``ops.chebyshev.cheby_op``) on the
coefficients the JAX package computes eagerly from the same kernels, which
is what its ``filter`` computes for the other designs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from unittest import mock

import pygsp_tpu as jgsp
import pygsp_tpu_torch as tgsp
from pygsp_tpu.ops import chebyshev as jcheby
from pygsp_tpu_torch.filters import filter as tfilter

CPU64 = dict(device='cpu', dtype=torch.float64)
TOL = 1e-12

# tests/test_filters.py's list
DESIGNS = [
    ('Heat', dict(scale=[10, 50])),
    ('Heat', dict(scale=5, normalize=False)),
    ('Wave', dict(time=[5, 10], speed=[1])),
    ('MexicanHat', dict(Nf=6)),
    ('MexicanHat', dict(Nf=5, normalize=True)),
    ('Meyer', dict(Nf=6)),
    ('Itersine', dict(Nf=6)),
    ('SimpleTight', dict(Nf=6)),
    ('Abspline', dict(Nf=6)),
    ('HalfCosine', dict(Nf=6)),
    ('Regular', dict()),
    ('Regular', dict(degree=0)),
    ('Regular', dict(degree=5)),
    ('Held', dict()),
    ('Simoncelli', dict()),
    ('Papadakis', dict()),
    ('Expwin', dict()),
    ('Expwin', dict(band_min=0.1, band_max=0.7)),
    ('Expwin', dict(band_min=0.1, band_max=None)),
    ('Rectangular', dict(band_min=0.1, band_max=0.5)),
]
IDS = [f'{name}-{i}' for i, (name, _) in enumerate(DESIGNS)]
SPECTRAL = ['Gabor', 'Modulation', 'Modulation-first']


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    got, want = np.nan_to_num(got), np.nan_to_num(want)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


def _pin(J, T, basis=False):
    """λmax (and the Fourier basis, which sets λmax to its largest
    eigenvalue) of the port's graph set to the JAX graph's."""
    if basis:
        J.compute_fourier_basis()
        T._U = torch.from_numpy(np.array(J.U))
        T._e = torch.from_numpy(np.array(J.e))
        T._coherence = J.coherence
    else:
        J.estimate_lmax(method='bounds')
    T._lmax, T._lmax_method = J.lmax, 'pinned'
    return J, T


@pytest.fixture(scope='module')
def logo():
    return _pin(jgsp.graphs.Logo(), tgsp.graphs.Logo(**CPU64))


@pytest.fixture(scope='module')
def small():
    """A 24-vertex weighted graph (tests/test_filters.py's Gabor and
    Modulation graph) with its Fourier basis pinned."""
    rng = np.random.default_rng(42)
    W = rng.uniform(0.1, 1, (24, 24)) * (rng.uniform(size=(24, 24)) < 0.3)
    W = np.triu(W, 1)
    W = W + W.T
    return _pin(jgsp.graphs.Graph(W), tgsp.graphs.Graph(W, **CPU64),
                basis=True)


def _make(pkg, G, name, kwargs):
    if name == 'Gabor':
        return pkg.filters.Gabor(G, pkg.filters.Heat(G, scale=20))
    if name.startswith('Modulation'):
        return pkg.filters.Modulation(G, pkg.filters.Heat(G, scale=20),
                                      modulation_first=name.endswith('first'))
    return getattr(pkg.filters, name)(G, **kwargs)


def _signal(n, s=3, seed=0):
    return np.random.default_rng(seed).normal(size=(n, s))


def _jax_cheby(J, g, s, order=30):
    """The JAX recurrence on the JAX package's coefficients: (N, S, Nf)."""
    c = jcheby.cheby_coeff(g.evaluate, J.lmax, m=order)
    r = np.asarray(jcheby.cheby_op(J.L, J.lmax, c, jnp.asarray(s)))
    return np.moveaxis(r, 0, -1)


# ---------------------------------------------------------------------------
# the designs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('name,kwargs', DESIGNS, ids=IDS)
def test_evaluate_matches_jax(logo, name, kwargs):
    J, T = logo
    gj, gt = _make(jgsp, J, name, kwargs), _make(tgsp, T, name, kwargs)
    assert gt.Nf == gj.Nf and repr(gt) == repr(gj)
    lam = np.linspace(0, J.lmax, 137)
    _close(gt.evaluate(torch.from_numpy(lam)), gj.evaluate(jnp.asarray(lam)))
    # the kernels are functions of λ of any shape, in its dtype
    lam2 = torch.from_numpy(lam[:12].reshape(3, 4))
    assert gt.evaluate(lam2).shape == (gt.Nf, 3, 4)
    assert gt.evaluate(lam2.float()).dtype == torch.float32


@pytest.mark.parametrize('name', SPECTRAL)
def test_spectral_designs_evaluate_like_jax(small, name):
    J, T = small
    gj, gt = _make(jgsp, J, name, {}), _make(tgsp, T, name, {})
    assert gt.Nf == gj.Nf == T.N
    e = np.asarray(J.e)
    lam = np.concatenate([e, np.linspace(0, J.lmax, 9)])  # on and off it
    _close(gt.evaluate(torch.from_numpy(lam)), gj.evaluate(jnp.asarray(lam)))
    if name.startswith('Modulation'):
        # looked up in G.e exactly: NaN anywhere else
        off = gt.evaluate(torch.tensor([0.5 * (e[1] + e[2])]))
        assert bool(torch.isnan(off).all())


@pytest.mark.parametrize('name,kwargs', DESIGNS, ids=IDS)
def test_chebyshev_filter_matches_jax(logo, name, kwargs):
    J, T = logo
    gj, gt = _make(jgsp, J, name, kwargs), _make(tgsp, T, name, kwargs)
    s = _signal(T.N)
    want = _jax_cheby(J, gj, s)
    _close(gt.filter(s, method='chebyshev', order=30), want.squeeze())
    # synthesis of the bank's own analysis
    want_syn = np.asarray(jcheby.cheby_synthesis(
        J.L, J.lmax, jcheby.cheby_coeff(gj.evaluate, J.lmax, m=30),
        jnp.asarray(want)))
    if gt.Nf > 1:
        _close(gt.synthesize(torch.from_numpy(want), order=30), want_syn)


@pytest.mark.parametrize('fmt,name,kwargs', [
    ('banded', 'SimpleTight', dict(Nf=6)),
    ('windowed', 'Meyer', dict(Nf=6)),
])
def test_design_on_the_other_formats(fmt, name, kwargs):
    if fmt == 'banded':
        J, T = _pin(jgsp.graphs.Grid2d(14, 11),
                    tgsp.graphs.Grid2d(14, 11, **CPU64))
        J._L, T._L = J.L.to_banded(), T.L.to_banded()
    else:
        from test_torch_windowed import _powerlaw
        W = _powerlaw(500, 17)
        J, T = jgsp.graphs.Graph(W), tgsp.graphs.Graph(W, **CPU64)
        J.compute_laplacian(fmt='windowed')
        T.compute_laplacian(fmt='windowed')
        _pin(J, T)
    assert type(T.L.offdiag).__name__ == type(J.L.offdiag).__name__
    gj, gt = _make(jgsp, J, name, kwargs), _make(tgsp, T, name, kwargs)
    s = _signal(T.N)
    _close(gt.filter(s, order=30), _jax_cheby(J, gj, s))


@pytest.mark.parametrize('name,kwargs',
                         DESIGNS + [(n, {}) for n in SPECTRAL],
                         ids=IDS + SPECTRAL)
def test_exact_filter_matches_jax(small, name, kwargs):
    J, T = small
    gj, gt = _make(jgsp, J, name, kwargs), _make(tgsp, T, name, kwargs)
    s = _signal(T.N, 1)[:, 0]
    _close(gt.filter(s, method='exact'), gj.filter(s, method='exact'))
    if not name.startswith('Modulation'):
        coeffs = np.asarray(gj.filter(s, method='exact'))
        if gt.Nf > 1:
            _close(gt.synthesize(coeffs, method='exact'),
                   gj.synthesize(coeffs, method='exact'))


def test_design_errors_match_jax(logo, small):
    J, T = logo
    cases = [('MexicanHat', dict(Nf=4, scales=[1.0, 2.0])),
             ('Meyer', dict(Nf=4, scales=[1.0])),
             ('SimpleTight', dict(Nf=3, scales=[1.0])),
             ('HalfCosine', dict(Nf=2)),
             ('Wave', dict(time=[1, 2], speed=[1, 1, 1])),
             ('Wave', dict(speed=2))]
    for name, kwargs in cases:
        with pytest.raises(ValueError) as jerr:
            getattr(jgsp.filters, name)(J, **kwargs)
        with pytest.raises(ValueError) as terr:
            getattr(tgsp.filters, name)(T, **kwargs)
        assert str(terr.value) == str(jerr.value)
    Js, Ts = small
    for cls in ('Gabor', 'Modulation'):
        with pytest.raises(ValueError, match='one filter'):
            getattr(tgsp.filters, cls)(Ts, tgsp.filters.Heat(Ts, [1, 2]))
        with pytest.raises(ValueError, match='mother kernel'):
            getattr(tgsp.filters, cls)(Ts, tgsp.filters.Heat(T, 1))


def test_kernels_read_lmax_when_evaluated():
    T = tgsp.graphs.Grid2d(5, 5, **CPU64)
    T._lmax = 4.0
    g = tgsp.filters.Wave(T, time=3)
    lam = torch.linspace(0, 4, 5, dtype=torch.float64)
    before = g.evaluate(lam)
    T._lmax = 8.0                                  # a refined λmax
    J = jgsp.graphs.Grid2d(5, 5)
    J._lmax = 8.0
    _close(g.evaluate(lam), jgsp.filters.Wave(J, time=3).evaluate(
        jnp.asarray(lam.numpy())))
    assert not torch.equal(before, g.evaluate(lam))


def test_lazy_exports_match_jax():
    names = sorted(n for n in dir(jgsp.filters) if not n.startswith('_'))
    ported = set(dir(tgsp.filters))
    for name in ('Filter', 'Heat', *(n for n, _ in DESIGNS), 'Gabor',
                 'Modulation', 'compute_cheby_coeff', 'cheby_op',
                 'cheby_rect', 'compute_jackson_cheby_coeff', 'lanczos',
                 'lanczos_op'):
        assert name in names and name in ported, name
        assert callable(getattr(tgsp.filters, name))
    assert tgsp.filters.mexicanhat.MexicanHat is tgsp.filters.MexicanHat
    with pytest.raises(AttributeError):
        tgsp.filters.NoSuchFilter


# ---------------------------------------------------------------------------
# the rest of Filter
# ---------------------------------------------------------------------------

def test_localize_matches_jax(logo, small):
    J, T = logo
    gj, gt = jgsp.filters.Heat(J, [5, 20]), tgsp.filters.Heat(T, [5, 20])
    _close(gt.localize(42, order=30), gj.localize(42, order=30))
    J, T = small
    gj, gt = jgsp.filters.MexicanHat(J, Nf=4), tgsp.filters.MexicanHat(T, Nf=4)
    _close(gt.localize(3, method='exact'), gj.localize(3, method='exact'))


@pytest.mark.parametrize('name,kwargs', [('Itersine', dict(Nf=6)),
                                         ('MexicanHat', dict(Nf=4)),
                                         ('Regular', dict())])
def test_frame_bounds_match_jax(logo, name, kwargs):
    J, T = logo
    gj, gt = _make(jgsp, J, name, kwargs), _make(tgsp, T, name, kwargs)
    _close(np.array(gt.estimate_frame_bounds()),
           np.array(gj.estimate_frame_bounds()))
    lam = np.linspace(0.5, 3.0, 11)
    A, B = gt.estimate_frame_bounds(lam)
    assert isinstance(A, float) and isinstance(B, float)
    _close(np.array([A, B]), np.array(gj.estimate_frame_bounds(lam)))


def test_compute_frame_matches_jax(small):
    J, T = small
    for kwargs in (dict(scale=[5, 20]), dict(scale=5)):
        gj, gt = jgsp.filters.Heat(J, **kwargs), tgsp.filters.Heat(T, **kwargs)
        for method in ('exact', 'chebyshev'):
            _close(gt.compute_frame(method=method),
                   gj.compute_frame(method=method))
        _close(gt.toarray(), gj.toarray())
    with mock.patch.object(tfilter._logger, 'warning') as warn:
        tgsp.filters.Heat(T).compute_frame()
    warn.assert_not_called()


def test_compute_frame_warns_on_a_big_graph():
    T = tgsp.graphs.Grid2d(45, 45, **CPU64)
    T._lmax = 8.0
    with mock.patch.object(tfilter._logger, 'warning') as warn:
        frame = tgsp.filters.Heat(T).compute_frame(order=2)
    assert tuple(frame.shape) == (T.N, T.N)
    warn.assert_called_once_with('Creating a big matrix. '
                                 'You should prefer the filter method.')


def test_complement_matches_jax(logo):
    J, T = logo
    gj, gt = jgsp.filters.MexicanHat(J, Nf=4), tgsp.filters.MexicanHat(T, Nf=4)
    lam = np.linspace(0, J.lmax, 57)
    _close(gt.complement().evaluate(torch.from_numpy(lam)),
           gj.complement().evaluate(jnp.asarray(lam)))
    _close(gt.complement(frame_bound=3.0).evaluate(torch.from_numpy(lam)),
           gj.complement(frame_bound=3.0).evaluate(jnp.asarray(lam)))
    tight = gt + gt.complement()
    A, B = tight.estimate_frame_bounds()
    assert abs(A - B) <= 1e-12 * B
    with pytest.raises(ValueError) as jerr:
        gj.complement(frame_bound=0.1).evaluate(jnp.asarray(lam))
    with pytest.raises(ValueError) as terr:
        gt.complement(frame_bound=0.1).evaluate(torch.from_numpy(lam))
    assert str(terr.value) == str(jerr.value)


def test_inverse_matches_jax(small):
    J, T = small
    gj, gt = jgsp.filters.Itersine(J, Nf=5), tgsp.filters.Itersine(T, Nf=5)
    hj, ht = gj.inverse(), gt.inverse()
    lam = np.linspace(0, J.lmax, 41)
    _close(ht.evaluate(torch.from_numpy(lam)), hj.evaluate(jnp.asarray(lam)))
    s = _signal(T.N, 1)[:, 0]
    coeffs = gt.analyze(s, method='exact')
    _close(ht.synthesize(coeffs, method='exact'), s, 1e-12)


@pytest.mark.parametrize('case', ['not_a_frame', 'badly_conditioned',
                                  'a_frame'])
def test_inverse_warns_like_jax(logo, case):
    J, T = logo

    def bank(pkg, G):
        if case == 'not_a_frame':       # zero on the upper half
            return pkg.filters.Rectangular(G, band_max=0.5)
        if case == 'badly_conditioned':
            return pkg.filters.Heat(G, scale=100)
        return pkg.filters.Itersine(G, Nf=4)

    from pygsp_tpu.filters import filter as jfilter
    with mock.patch.object(jfilter._logger, 'warning') as jwarn, \
            mock.patch.object(tfilter._logger, 'warning') as twarn:
        bank(jgsp, J).inverse()
        bank(tgsp, T).inverse()
    assert twarn.call_args_list == jwarn.call_args_list
    assert len(twarn.call_args_list) == (case != 'a_frame')


# ---------------------------------------------------------------------------
# the approximations façade
# ---------------------------------------------------------------------------

def test_compute_cheby_coeff_matches_jax(logo):
    J, T = logo
    for scale in ([5, 10, 25], 5):
        gj, gt = jgsp.filters.Heat(J, scale), tgsp.filters.Heat(T, scale)
        cj = jgsp.filters.compute_cheby_coeff(gj, m=20)
        ct = tgsp.filters.compute_cheby_coeff(gt, m=20)
        assert isinstance(ct, list) == isinstance(cj, list)
        _close(torch.stack(ct) if isinstance(ct, list) else ct,
               np.stack(cj) if isinstance(cj, list) else cj)
    gj = jgsp.filters.MexicanHat(J, Nf=4)
    gt = tgsp.filters.MexicanHat(T, Nf=4)
    _close(tgsp.filters.compute_cheby_coeff(gt, m=12, N=40, i=2),
           jgsp.filters.compute_cheby_coeff(gj, m=12, N=40, i=2))


def test_cheby_op_facade_matches_jax(logo):
    J, T = logo
    c = np.random.default_rng(3).normal(size=(3, 16))
    for s in (_signal(T.N, 1)[:, 0], _signal(T.N, 4)):
        want = jgsp.filters.cheby_op(J, jnp.asarray(c), jnp.asarray(s))
        got = tgsp.filters.cheby_op(T, c, s)
        assert tuple(got.shape) == tuple(want.shape)
        _close(got, want)
    _close(tgsp.filters.cheby_op(T, c[0], s), jgsp.filters.cheby_op(J, c[0], s))
    with pytest.raises(TypeError, match='invalid shape'):
        tgsp.filters.cheby_op(T, c[:, :1], s)


def test_cheby_rect_and_jackson_facade_match_jax(logo):
    J, T = logo
    s = _signal(T.N, 2)
    bounds = [0.2 * J.lmax, 0.6 * J.lmax]
    _close(tgsp.filters.cheby_rect(T, bounds, s, order=20),
           jgsp.filters.cheby_rect(J, bounds, jnp.asarray(s), order=20))
    got = tgsp.filters.compute_jackson_cheby_coeff([1.0, 3.0], [0.0, 10.0],
                                                   25)
    want = jgsp.filters.compute_jackson_cheby_coeff([1.0, 3.0], [0.0, 10.0],
                                                    25)
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.dtype == np.float64
        _close(g, w)


def test_lanczos_facade_matches_jax(logo):
    J, T = logo
    s = _signal(T.N, 2)
    Vj, Hj = jgsp.filters.lanczos(J.L, 12, jnp.asarray(s))
    Vt, Ht = tgsp.filters.lanczos(T.L, 12, s)
    _close(Ht, Hj)
    _close(Vt, Vj)
    gj, gt = jgsp.filters.Heat(J, [5, 20]), tgsp.filters.Heat(T, [5, 20])
    want = jgsp.filters.lanczos_op(gj, jnp.asarray(s), order=12)
    got = tgsp.filters.lanczos_op(gt, s, order=12)
    assert tuple(got.shape) == tuple(want.shape) == (2 * T.N, 2)
    _close(got, want)
