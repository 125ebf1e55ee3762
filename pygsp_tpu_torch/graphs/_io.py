"""Graph import and export (counterpart of ``pygsp_tpu/graphs/_io.py``).

NetworkX interop and the GraphML, GML and GEXF file formats, on the host.
networkx (and graph-tool, an optional backend) is imported inside the
functions that use it, never when this module is imported. A graph read
back is built on ``device`` (default ``'cuda'``) with ``dtype``, as every
entry point of the port.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from pygsp_tpu_torch.utils import to_numpy


def _import_networkx():
    try:
        import networkx as nx
    except ImportError as e:
        raise ImportError('Cannot import networkx. Use graph-tool or try to '
                          'install it with pip (or conda) install networkx. '
                          f'Original exception: {e}')
    return nx


def _break_signals(signals):
    """Split N-d signals into 1-d ones named ``name_i``."""
    out = {}
    for name, sig in signals.items():
        sig = to_numpy(sig)
        if sig.ndim == 2:
            for i, col in enumerate(sig.T):
                out[f'{name}_{i}'] = col
        else:
            out[name] = sig
    return out


def _join_signals(signals):
    """Rejoin ``name_i`` 1-d signals into N-d ones."""
    groups = {}
    for name in signals:
        base = name.rsplit('_', 1)[0]
        groups.setdefault(base, []).append(name)
    for base, names in groups.items():
        if len(names) > 1:
            names = sorted(names)
            signals[base] = np.stack([signals[n] for n in names], axis=1)
            for n in names:
                del signals[n]
    return signals


def to_networkx(G):
    """Export to a networkx (Di)Graph, with edge attribute 'weight' and one
    node attribute per (column of a) signal.

    Examples
    --------
    >>> from pygsp_tpu_torch import graphs
    >>> from pygsp_tpu_torch.graphs import _io
    >>> nx_graph = _io.to_networkx(graphs.Ring(8, device='cpu'))
    >>> nx_graph.number_of_nodes(), nx_graph.number_of_edges()
    (8, 8)
    """
    nx = _import_networkx()

    def convert(x):
        if issubclass(np.asarray(x).dtype.type, (np.integer, np.bool_)):
            return int(x)
        return float(x)

    signals = _break_signals(G.signals)
    graph = nx.DiGraph() if G.is_directed() else nx.Graph()
    graph.name = type(G).__name__
    for vertex in range(G.n_vertices):
        attrs = {name: convert(sig[vertex]) for name, sig in signals.items()}
        graph.add_node(vertex, **attrs)
    for source, target, weight in zip(*G.get_edge_list()):
        graph.add_edge(int(source), int(target), weight=convert(weight))
    return graph


def from_networkx(graph, weight='weight', *, device='cuda',
                  dtype=torch.float32):
    """Import from networkx: node attributes become signals (NaN where a
    node lacks one), multiedges are summed.

    Examples
    --------
    >>> from pygsp_tpu_torch import graphs
    >>> from pygsp_tpu_torch.graphs import _io
    >>> G = _io.from_networkx(_io.to_networkx(graphs.Ring(8, device='cpu')),
    ...                       device='cpu')
    >>> G.N, G.Ne
    (8, 8)
    """
    nx = _import_networkx()
    from pygsp_tpu_torch.graphs.graph import Graph

    adjacency = nx.to_scipy_sparse_array(graph, weight=weight)
    G = Graph(adjacency, device=device, dtype=dtype)

    signals = {}
    for i, node in enumerate(graph.nodes()):
        for name, value in graph.nodes[node].items():
            if name not in signals:
                signals[name] = np.full(G.n_vertices, np.nan)
            signals[name][i] = value
    G.signals.update(_join_signals(signals))
    return G


def to_graphtool(G):
    """Export to graph-tool (an optional dependency)."""
    try:
        import graph_tool as gt
    except ImportError as e:
        raise ImportError('Cannot import graph-tool. Use networkx or try to '
                          f'install it. Original exception: {e}')
    graph = gt.Graph(directed=G.is_directed())
    graph.add_vertex(G.n_vertices)
    sources, targets, weights = G.get_edge_list()
    graph.add_edge_list(np.stack([sources, targets], axis=1))
    prop = graph.new_edge_property('double')
    prop.a = weights
    graph.edge_properties['weight'] = prop
    for name, signal in _break_signals(G.signals).items():
        vprop = graph.new_vertex_property('double')
        vprop.a = signal
        graph.vertex_properties[name] = vprop
    return graph


def from_graphtool(graph, weight='weight', *, device='cuda',
                   dtype=torch.float32):
    """Import from graph-tool (an optional dependency)."""
    import scipy.sparse as sps
    from pygsp_tpu_torch.graphs.graph import Graph

    edges = graph.get_edges()
    n = graph.num_vertices()
    prop = graph.edge_properties.get(weight, None)
    w = prop.a if prop is not None else np.ones(len(edges))
    W = sps.csr_matrix((w, (edges[:, 0], edges[:, 1])), shape=(n, n))
    if not graph.is_directed():
        W = W + sps.triu(W, 1).T
    G = Graph(W, device=device, dtype=dtype)
    signals = {name: np.asarray(vprop.a)
               for name, vprop in graph.vertex_properties.items()}
    G.signals.update(_join_signals(signals))
    return G


_NX_FORMATS = {
    'graphml': ('read_graphml', 'write_graphml'),
    'gml': ('read_gml', 'write_gml'),
    'gexf': ('read_gexf', 'write_gexf'),
}


def _check_format(path, fmt):
    if fmt is None:
        fmt = os.path.splitext(path)[1][1:]
    if fmt not in _NX_FORMATS:
        raise ValueError(f'Unsupported format {fmt}. '
                         f'Supported: {sorted(_NX_FORMATS)}.')
    return fmt


def save(G, path, fmt=None, backend=None):
    """Save to GraphML, GML or GEXF (``fmt`` from the path's extension by
    default). ``backend``: 'networkx', 'graph-tool', or None (networkx,
    else graph-tool); an ``ImportError`` if the backend asked for is
    missing.

    Examples
    --------
    >>> import os, tempfile
    >>> from pygsp_tpu_torch import graphs
    >>> from pygsp_tpu_torch.graphs import _io
    >>> G = graphs.Ring(8, device='cpu')
    >>> with tempfile.TemporaryDirectory() as d:
    ...     path = os.path.join(d, 'ring.graphml')
    ...     _io.save(G, path)
    ...     H = _io.load(path, device='cpu')
    >>> H.N, H.Ne
    (8, 8)
    """
    fmt = _check_format(path, fmt)

    def save_networkx():
        nx = _import_networkx()
        getattr(nx, _NX_FORMATS[fmt][1])(to_networkx(G), path)

    def save_graphtool():
        to_graphtool(G).save(path, fmt=fmt)

    if backend == 'networkx':
        save_networkx()
    elif backend == 'graph-tool':
        save_graphtool()
    elif backend is None:
        try:
            save_networkx()
        except ImportError:
            try:
                save_graphtool()
            except ImportError:
                raise ImportError('Cannot import networkx nor graph-tool.')
    else:
        raise ValueError(f'Unknown backend {backend}.')


def load(path, fmt=None, backend=None, *, device='cuda', dtype=torch.float32):
    """Load from GraphML, GML or GEXF, with :func:`save`'s backends. A
    round trip is lossless only through one backend."""
    fmt = _check_format(path, fmt)

    def load_networkx():
        nx = _import_networkx()
        return from_networkx(getattr(nx, _NX_FORMATS[fmt][0])(path),
                             device=device, dtype=dtype)

    def load_graphtool():
        import graph_tool as gt
        return from_graphtool(gt.load_graph(path, fmt=fmt), device=device,
                              dtype=dtype)

    if backend == 'networkx':
        return load_networkx()
    if backend == 'graph-tool':
        return load_graphtool()
    if backend is None:
        try:
            return load_networkx()
        except ImportError:
            try:
                return load_graphtool()
            except ImportError:
                raise ImportError('Cannot import networkx nor graph-tool.')
    raise ValueError(f'Unknown backend {backend}.')
