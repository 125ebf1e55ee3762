"""Checkpoint and resume of graphs with their precomputed spectral state.

Counterpart of :mod:`pygsp_tpu.checkpoint`: one ``.npz`` with the edge
arrays, the cached λmax, the Fourier basis and the signals, under the JAX
package's keys (``rows``, ``cols``, ``vals``, ``n_vertices``, ``lap_type``,
``coords``, ``lmax``, ``lmax_method``, ``U``, ``e``, ``signal__<name>``),
so that a file written by either package loads in the other. Tensors on the
card are copied to the host before saving. ``save_sharded`` and
``load_sharded`` do the same for the multi-device engines' partition
(:class:`~pygsp_tpu_torch.parallel.partition.ShardedGraph`): a metadata
file and one file per shard, the JAX package's names and keys.
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


def save_sharded(path_prefix: str, sg) -> None:
    """Persist a ShardedGraph partition: ``<prefix>.meta.npz`` and one
    ``<prefix>.shard<s>.npz`` per shard, the JAX package's names and keys.
    ``sg`` must hold every shard (as :func:`~pygsp_tpu_torch.parallel.
    partition.partition_graph` makes it, not one rank's
    ``put_sharded_graph``)."""
    if sg.rows.shape[0] != sg.n_shards:
        raise ValueError(f'save_sharded needs all {sg.n_shards} shards, got '
                         f'{sg.rows.shape[0]} (one rank\'s put_sharded_graph'
                         f'?)')
    np.savez_compressed(
        f'{path_prefix}.meta.npz',
        n_shards=np.array(sg.n_shards), n_local=np.array(sg.n_local),
        halo_dists=np.asarray(sg.halo_dists, dtype=np.int64),
        halo_sizes=np.asarray(sg.halo_sizes, dtype=np.int64),
        n_vertices=np.array(sg.n_vertices),
        lap_type=np.array(sg.lap_type), perm=_host(sg.perm))
    for s in range(sg.n_shards):
        send = {f'send_idx{k}': _host(a[s])
                for k, a in enumerate(sg.send_idx)}
        np.savez_compressed(
            f'{path_prefix}.shard{s}.npz',
            rows=_host(sg.rows[s]), cols=_host(sg.cols[s]),
            vals=_host(sg.vals[s]), diag=_host(sg.diag[s]), **send)


def load_sharded(path_prefix: str, *, device='cuda'):
    """Rebuild a ShardedGraph from :func:`save_sharded` files (or the JAX
    package's), its tensors on ``device`` in the files' dtypes."""
    from pygsp_tpu_torch.parallel.partition import ShardedGraph
    from pygsp_tpu_torch.utils import check_device

    device = check_device(device, 'load_sharded')
    with np.load(f'{path_prefix}.meta.npz') as m:
        n_shards = int(m['n_shards'])
        halo_dists = tuple(int(d) for d in m['halo_dists'])
        meta = dict(n_shards=n_shards, n_local=int(m['n_local']),
                    halo_dists=halo_dists,
                    halo_sizes=tuple(int(h) for h in m['halo_sizes']),
                    n_vertices=int(m['n_vertices']),
                    lap_type=str(m['lap_type']))
        perm = torch.as_tensor(m['perm'], device=device)
    keys = ['rows', 'cols', 'vals', 'diag'] + [
        f'send_idx{k}' for k in range(len(halo_dists))]
    parts = {k: [] for k in keys}
    for s in range(n_shards):
        with np.load(f'{path_prefix}.shard{s}.npz') as d:
            for k in parts:
                parts[k].append(d[k])

    def stack(k):
        return torch.as_tensor(np.stack(parts[k]), device=device)

    return ShardedGraph(
        rows=stack('rows'), cols=stack('cols'), vals=stack('vals'),
        diag=stack('diag'),
        send_idx=tuple(stack(f'send_idx{k}')
                       for k in range(len(halo_dists))),
        perm=perm, **meta)
