"""Plotting of graphs, signals, filters and spectrograms with matplotlib.

Counterpart of :mod:`pygsp_tpu.plotting`, with its functions, parameters
and single backend. matplotlib is imported only inside the functions
(:func:`_import_plt`), so the package loads without it. Tensors on the card
are copied to the host first; the figures are drawn from host arrays only.
"""

from __future__ import annotations

import numpy as np

import torch

from pygsp_tpu_torch import utils

_logger = utils.build_logger(__name__)

BACKEND = 'matplotlib'
_plt_figures = []


def _import_plt():
    try:
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise ImportError(f'Cannot import matplotlib. Original exception: {e}')
    return plt


def close_all():
    """Close all opened figures (reference ``plotting.py:125``)."""
    plt = _import_plt()
    plt.close('all')


def show(*args, **kwargs):
    _import_plt().show(*args, **kwargs)


def close(*args, **kwargs):
    _import_plt().close(*args, **kwargs)


def _coerce(x):
    """A tensor (on any device) or array-like as a host NumPy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _normalize(G, x):
    """Scale values into [normalize_intercept, 1] (0.5 when constant) —
    the reference's signal→size/alpha map (``plotting.py:452-463``)."""
    ptp = np.ptp(x)
    if ptp == 0:
        return np.full(np.shape(x), 0.5)
    intercept = G.plotting.get('normalize_intercept', 0.25)
    return (1.0 - intercept) * (x - x.min()) / ptp + intercept


def _is_color(value):
    import matplotlib
    if matplotlib.colors.is_color_like(value):
        return True
    try:
        return all(map(matplotlib.colors.is_color_like, value))
    except TypeError:
        return False


def plot_graph(G, vertex_color=None, vertex_size=None, highlight=[],
               edges=None, edge_color=None, edge_width=None, indices=False,
               colorbar=True, limits=None, ax=None, title=None, backend=None):
    """Plot a graph with signals as vertex color, vertex size, edge color
    and/or edge width (reference ``_plot_graph``, ``plotting.py:326-640``).

    - ``vertex_color``: per-vertex signal mapped through the colormap
      (``limits`` = [vmin, vmax], default 1.05× signal range), or any
      matplotlib color (list).
    - ``vertex_size``: per-vertex signal → sizes in [0.5, 2]× the
      ``plotting['vertex_size']`` default (reference ``:497-500``), or a
      scalar.
    - ``edge_color``: per-edge signal → base edge color with alpha
      0.9·normalize (reference ``:505-513``), or a color.
    - ``edge_width``: per-edge signal → widths ≤ 2× default, or a scalar.

    Returns the axes (deviation: the reference returns ``(fig, ax)``).

    Examples
    --------
    >>> import matplotlib
    >>> matplotlib.use('Agg')
    >>> from pygsp_tpu_torch import graphs, plotting
    >>> G = graphs.Ring(8, device='cpu')
    >>> ax = plotting.plot_graph(G)
    >>> type(ax).__name__
    'Axes'

    """
    if G.coords is None:
        raise AttributeError('Graph has no coordinate set. '
                             'Please run G.set_coordinates() first.')
    coords = _coerce(G.coords)
    dim1 = coords.ndim == 1
    dim = 1 if dim1 else coords.shape[1]
    if not dim1 and dim not in (2, 3):
        raise AttributeError('Coordinates should be in 1D, 2D or 3D space.')

    plt = _import_plt()
    if ax is None:
        fig = plt.figure()
        ax = fig.add_subplot(
            111, projection='3d' if dim == 3 else None)
        _plt_figures.append(fig)

    def check_shape(signal, name, length):
        if signal.ndim == 0 or signal.shape[0] != length:
            raise ValueError(f'{name}: signal should have length {length}.')
        if signal.ndim != 1 and not dim1:
            raise ValueError(f'{name}: can plot only one signal '
                             f'(not {signal.shape[1]}).')

    # ---- vertex color / limits (joint with size, reference :480-495) ----
    c = None
    if vertex_color is None:
        limits = [0, 0] if limits is None else limits
        colorbar = False
        c = [G.plotting.get('vertex_color', (0.12, 0.47, 0.71, 0.5))]
    elif _is_color(vertex_color):
        limits = [0, 0] if limits is None else limits
        colorbar = False
        c = vertex_color
    else:
        c = np.asanyarray(_coerce(vertex_color)).squeeze()
        check_shape(c, 'Vertex color', G.n_vertices)
        if limits is None:
            limits = [1.05 * c.min(), 1.05 * c.max()]

    # ---- vertex size as a signal (reference :497-500) --------------------
    if vertex_size is None:
        vertex_size = G.plotting.get('vertex_size', 100)
    elif not np.isscalar(vertex_size):
        vertex_size = np.asanyarray(_coerce(vertex_size)).squeeze()
        check_shape(vertex_size, 'Vertex size', G.n_vertices)
        vertex_size = (G.plotting.get('vertex_size', 100) * 4
                       * _normalize(G, vertex_size) ** 2)

    if edges is None:
        edges = G.Ne < 10e3  # edge-drawing guardrail (reference :501)

    # ---- edge color as a signal (reference :505-513) ---------------------
    base_edge_color = G.plotting.get('edge_color', (0.5, 0.5, 0.5, 0.5))
    if edge_color is None:
        edge_color = base_edge_color
    elif not _is_color(edge_color):
        edge_color = np.asanyarray(_coerce(edge_color)).squeeze()
        check_shape(edge_color, 'Edge color', G.n_edges)
        alpha = 0.9 * _normalize(G, edge_color)
        edge_color = np.concatenate(
            [np.tile(np.asarray(base_edge_color)[:3], (len(alpha), 1)),
             alpha[:, None]], axis=1)

    # ---- edge width as a signal (reference :515-520) ---------------------
    if edge_width is None:
        edge_width = G.plotting.get('edge_width', 2)
    elif not np.isscalar(edge_width):
        edge_width = np.asarray(_coerce(edge_width)).squeeze()
        check_shape(edge_width, 'Edge width', G.n_edges)
        edge_width = (G.plotting.get('edge_width', 2) * 2
                      * _normalize(G, edge_width))

    # ---- 1-D coordinate path (reference :603-608) -------------------------
    if dim1:
        sig = c if isinstance(c, np.ndarray) else np.zeros(G.N)
        ax.plot(coords, sig, alpha=0.5)
        if limits != [0, 0]:
            ax.set_ylim(limits)
        hls = highlight if np.iterable(highlight) else [highlight]
        for i in hls:
            ax.axvline(x=coords[i],
                       color=G.plotting.get('highlight_color', 'C1'),
                       linewidth=2)
        ax.set_title(title if title is not None else repr(G))
        return ax

    if edges:
        sources, targets, _ = G.get_edge_list()
        segments = np.stack([coords[sources], coords[targets]], axis=1)
        style = G.plotting.get('edge_style', '-')
        if dim == 2:
            from matplotlib.collections import LineCollection
            lc = LineCollection(segments, colors=edge_color,
                                linewidths=edge_width, linestyles=style,
                                zorder=1)
            ax.add_collection(lc)
        else:
            from mpl_toolkits.mplot3d.art3d import Line3DCollection
            lc = Line3DCollection(segments, colors=edge_color,
                                  linewidths=edge_width, linestyles=style)
            ax.add_collection3d(lc)

    signal_colored = isinstance(c, np.ndarray) and c.dtype != object
    sc = ax.scatter(*coords.T, s=vertex_size,
                    c=c, marker='o', linewidths=0, alpha=0.5, zorder=2,
                    vmin=limits[0] if signal_colored else None,
                    vmax=limits[1] if signal_colored else None)
    if signal_colored and colorbar and dim == 2:
        plt.colorbar(sc, ax=ax)

    hls = highlight if np.iterable(highlight) else [highlight]
    hl_size = (vertex_size if np.isscalar(vertex_size)
               else np.asarray(vertex_size)[hls])
    if len(list(hls)):
        ax.scatter(*coords[hls].T, s=2 * hl_size, zorder=3, marker='o',
                   c='None',
                   edgecolors=G.plotting.get('highlight_color', 'C1'),
                   linewidths=2)

    if indices:
        for i in range(G.N):
            ax.annotate(str(i), (coords[i, 0], coords[i, 1]), zorder=4)

    ax.set_title(title if title is not None else repr(G))
    if dim == 2:
        ax.set_aspect('equal', adjustable='datalim')
    elif dim == 3:
        try:
            ax.view_init(elev=G.plotting['elevation'],
                         azim=G.plotting['azimuth'])
            ax.dist = G.plotting['distance']
        except KeyError:
            pass
    return ax


def plot_filter(g, n=500, eigenvalues=None, sum=None, labels=None, title=None,
                ax=None, **kwargs):
    """Plot kernel response curves and their squared sum
    (reference ``_plot_filter``, ``plotting.py:199-323``).

    Examples
    --------
    >>> import matplotlib
    >>> matplotlib.use('Agg')
    >>> from pygsp_tpu_torch import graphs, filters, plotting
    >>> G = graphs.Ring(8, device='cpu')
    >>> G.estimate_lmax()
    >>> ax = plotting.plot_filter(filters.Heat(G, scale=5))
    >>> type(ax).__name__
    'Axes'

    """
    G = g.G
    if eigenvalues is None:
        eigenvalues = G._e is not None
    if sum is None:
        sum = g.n_filters > 1
    if labels is None:
        labels = g.n_filters > 1

    plt = _import_plt()
    if ax is None:
        fig = plt.figure()
        ax = fig.add_subplot(111)
        _plt_figures.append(fig)

    x = np.linspace(0, G.lmax, n)
    resp = _coerce(g.evaluate(torch.as_tensor(x, dtype=G.dtype,
                                              device=G.device)))
    y = resp.T.squeeze()
    lines = ax.plot(x, y, **kwargs)

    if eigenvalues:
        for e in _coerce(G.e):
            ax.axvline(x=e, color=[0.9] * 3, linewidth=1, zorder=0)
    if sum:
        ax.plot(x, np.sum(resp ** 2, axis=0), 'k', linewidth=1)
    if labels and y.ndim > 1:
        for i, line in enumerate(lines):
            line.set_label(f'g{i}')
        ax.legend()

    ax.set_xlabel(r"laplacian's eigenvalues / graph frequencies")
    ax.set_ylabel(r'filter response')
    ax.set_title(title if title is not None else repr(g))
    return ax


def plot_spectrogram(G, node_idx=None, ax=None, **kwargs):
    """Heatmap of the graph spectrogram
    (reference ``_plot_spectrogram``, ``plotting.py:722-787`` —
    pyqtgraph there, matplotlib here). The spectrogram is computed on the
    graph's device (:func:`pygsp_tpu_torch.features.compute_spectrogram`,
    which keeps it as a host array); the figure from the host array."""
    from pygsp_tpu_torch import features

    if not hasattr(G, 'spectr') or G.spectr is None:
        features.compute_spectrogram(G, **kwargs)

    M = G.spectr.shape[1]
    spectr = _coerce(G.spectr)
    spectr = spectr[node_idx] if node_idx is not None else spectr
    spectr = np.ravel(spectr).reshape(-1, M)
    spectr = spectr / spectr.max()

    plt = _import_plt()
    if ax is None:
        fig = plt.figure()
        ax = fig.add_subplot(111)
        _plt_figures.append(fig)
    ax.imshow(spectr.T, origin='lower', aspect='auto')
    ax.set_xlabel('nodes')
    ax.set_ylabel('frequencies')
    ax.set_title(f'spectrogram of {type(G).__name__}')
    return ax


# pygsp-compatible aliases
_plot_graph = plot_graph
_plot_filter = plot_filter
_plot_spectrogram = plot_spectrogram
