"""Checkpoint and resume of graphs with their precomputed spectral state.

Counterpart of :mod:`pygsp_tpu.checkpoint`: one ``.npz`` with the edge
arrays, the cached λmax, the Fourier basis and the signals, under the JAX
package's keys (``rows``, ``cols``, ``vals``, ``n_vertices``, ``lap_type``,
``coords``, ``lmax``, ``lmax_method``, ``U``, ``e``, ``signal__<name>``),
so that a file written by either package loads in the other. Tensors on the
card are copied to the host before saving. ``save_sharded`` and
``load_sharded`` come with the multi-device engines' ``ShardedGraph``.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sps
import torch


def _host(a):
    """A tensor (on any device) or array-like as a host NumPy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def save_graph(path: str, G, include_fourier: bool = True) -> None:
    """Persist the adjacency, coordinates, signals and cached spectral
    state (λmax, and with ``include_fourier`` the Fourier basis).

    Examples
    --------
    >>> import os, tempfile, torch
    >>> from pygsp_tpu_torch import graphs, checkpoint
    >>> G = graphs.Ring(8, device='cpu', dtype=torch.float64)
    >>> G.estimate_lmax()
    >>> with tempfile.TemporaryDirectory() as d:
    ...     path = os.path.join(d, 'g.npz')
    ...     checkpoint.save_graph(path, G)
    ...     H = checkpoint.load_graph(path, device='cpu',
    ...                               dtype=torch.float64)
    >>> H.N, bool(abs(H.lmax - G.lmax) < 1e-12)   # lmax survives
    (8, True)
    """
    coo = G.W.tocoo()
    data = {
        'rows': coo.row, 'cols': coo.col, 'vals': coo.data,
        'n_vertices': np.array(G.n_vertices),
        'lap_type': np.array(G.lap_type),
    }
    if G.coords is not None:
        data['coords'] = _host(G.coords)
    if G._lmax is not None:
        data['lmax'] = np.array(G._lmax)
        data['lmax_method'] = np.array(G._lmax_method or 'unknown')
    if include_fourier and G._U is not None:
        data['U'] = _host(G._U)
        data['e'] = _host(G._e)
    for name, sig in G.signals.items():
        data[f'signal__{name}'] = _host(sig)
    np.savez_compressed(path, **data)


def load_graph(path: str, *, device='cuda', dtype=torch.float32):
    """Rebuild a :class:`~pygsp_tpu_torch.graphs.Graph` on ``device`` in
    ``dtype``, with its cached λmax and Fourier basis, from a file of
    :func:`save_graph` (or of the JAX package's). Signals come back as host
    arrays, as in the JAX package."""
    from pygsp_tpu_torch.graphs import Graph

    with np.load(path, allow_pickle=False) as d:
        n = int(d['n_vertices'])
        W = sps.csr_matrix((d['vals'], (d['rows'], d['cols'])), shape=(n, n))
        coords = d['coords'] if 'coords' in d else None
        G = Graph(W, lap_type=str(d['lap_type']), coords=coords,
                  device=device, dtype=dtype)
        if 'lmax' in d:
            G._lmax = float(d['lmax'])
            G._lmax_method = str(d['lmax_method'])
        if 'U' in d:
            G._U = torch.as_tensor(d['U'], dtype=dtype, device=G.device)
            G._e = torch.as_tensor(d['e'], dtype=dtype, device=G.device)
            G._coherence = float(np.max(np.abs(d['U'])))
        for key in d.files:
            if key.startswith('signal__'):
                G.signals[key[len('signal__'):]] = d[key]
    return G
