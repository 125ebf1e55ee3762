"""The port's plotting, in the manner of ``tests/test_plotting.py``: every
graph class with coordinates renders, with the options, signals as sizes
and colours, the errors, filters and the spectrogram, on the CPU with the
Agg backend."""

import matplotlib

matplotlib.use('Agg')

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import pygsp_tpu_torch as tgsp  # noqa: E402
from pygsp_tpu_torch import plotting  # noqa: E402

CPU = dict(device='cpu')


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plotting.close_all()


COORD_GRAPHS = [
    ('Logo', dict()),
    ('Grid2d', dict(N1=4, N2=5)),
    ('Path', dict(N=8)),
    ('Ring', dict(N=8)),
    ('Torus', dict(Nv=4, Mv=4)),          # 3-D coords
    ('Comet', dict(N=10, k=3)),
    ('LowStretchTree', dict(k=2)),
    ('RandomRing', dict(N=10, seed=1)),
    ('DavidSensorNet', dict(N=64)),
    ('SwissRoll', dict(N=40, seed=1)),    # 3-D coords
    ('Sensor', dict(N=20, seed=1)),
    ('Cube', dict(nb_pts=30, seed=1)),
    ('Sphere', dict(nb_pts=30, seed=1)),
    ('TwoMoons', dict(moontype='synthesized', N=40, seed=1)),
]


@pytest.mark.parametrize('name,kwargs', COORD_GRAPHS)
def test_plot_every_graph(name, kwargs):
    G = getattr(tgsp.graphs, name)(**kwargs, **CPU)
    ax = G.plot()
    assert ax.figure is not None
    ax2 = G.plot(vertex_color=np.arange(G.N, dtype=float))
    assert ax2 is not None


def test_plot_options():
    G = tgsp.graphs.Sensor(20, seed=1, **CPU)
    ax = G.plot(edges=False, vertex_size=10, indices=True, highlight=[0, 3],
                title='custom', limits=[0, 1])
    assert ax.get_title() == 'custom'


def test_plot_signal_sized_and_colored():
    """vertex_size as a signal scales to [0.5, 2]x the default; per-edge
    colour and width signals normalize into alpha and width."""
    G = tgsp.graphs.Sensor(20, seed=1, **CPU)
    _, _, w = G.get_edge_list()
    sig = np.arange(G.N, dtype=float)
    ax = G.plot(vertex_color=sig, vertex_size=G.dw, edge_color=w,
                edge_width=w)
    sizes = ax.collections[-1].get_sizes()  # vertex scatter drawn last
    assert sizes.min() >= 0.5 * 0.98 * 100 * 0.25  # intercept**2 * 4 * 100
    assert sizes.max() <= 4 * 100 + 1e-6
    # constant signal -> all sizes equal (normalize returns 0.5)
    ax2 = G.plot(vertex_size=np.ones(G.N))
    assert np.ptp(ax2.collections[-1].get_sizes()) == 0


def test_plot_tensor_signals():
    """Signals given as tensors are drawn from their host copies."""
    G = tgsp.graphs.Sensor(20, seed=1, **CPU)
    sig = torch.arange(G.N, dtype=torch.float64)
    ax = G.plot_signal(sig)
    assert np.array_equal(ax.collections[-1].get_array(), sig.numpy())


def test_plot_errors():
    G = tgsp.graphs.Sensor(20, seed=1, **CPU)
    with pytest.raises(ValueError):
        G.plot(vertex_color=np.arange(G.N - 1, dtype=float))
    with pytest.raises(ValueError):
        G.plot(vertex_size=np.ones(3))
    with pytest.raises(ValueError):
        G.plot(edge_width=np.ones(G.Ne - 1))


def test_plot_1d_coords():
    G = tgsp.graphs.Ring(12, **CPU)
    G.set_coordinates('line1D')
    ax = G.plot(np.sin(np.arange(12.0)), highlight=2)
    assert ax is not None
    assert G.plot() is not None


def test_plot_signal_alias():
    G = tgsp.graphs.Ring(12, **CPU)
    ax = G.plot_signal(np.sin(np.arange(12.0)))
    assert ax is not None


def test_plot_requires_coords():
    G = tgsp.graphs.Graph([[0, 1], [1, 0]], **CPU)
    with pytest.raises(AttributeError):
        G.plot()


def test_plot_filters():
    G = tgsp.graphs.Logo(**CPU)
    G.estimate_lmax(method='bounds')
    for g in (tgsp.filters.Heat(G, [5, 10]),
              tgsp.filters.Itersine(G, Nf=4)):
        ax = g.plot()
        assert len(ax.lines) >= g.Nf


def test_plot_filter_with_eigenvalues():
    G = tgsp.graphs.Ring(16, **CPU)
    G.compute_fourier_basis()
    ax = tgsp.filters.Heat(G, 5).plot()
    assert len(ax.lines) > 10      # response + eigenvalue markers


def test_plot_spectrogram():
    G = tgsp.graphs.Ring(24, device='cpu', dtype=torch.float64)
    G.estimate_lmax(method='bounds')
    ax = G.plot_spectrogram(M=10)
    assert ax.images          # imshow artist present
    assert G.spectr.shape == (24, 10)
