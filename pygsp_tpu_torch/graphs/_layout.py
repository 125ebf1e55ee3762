"""Vertex layouts (counterpart of ``pygsp_tpu/graphs/_layout.py``).

The closed-form layouts, ``'spring'`` (the JAX package's vectorized
Fruchterman–Reingold solver) and ``'community2D'`` run on the host in
NumPy, as in the JAX package, and give its coordinates for the same seed.
The Laplacian eigenmaps take the graph's partial Fourier basis
(:meth:`Graph.compute_fourier_basis`): LOBPCG on the CSR SpMM kernel above
2000 vertices, ``eigh`` on ``device`` below.
"""

from __future__ import annotations

import numpy as np


def set_coordinates(G, kind='spring', seed=None, **kwargs):
    """Set ``G.coords`` from an array or by the name of a layout;
    ``kwargs`` go to the spring layout.

    Examples
    --------
    >>> from pygsp_tpu_torch import graphs
    >>> G = graphs.Ring(6, device='cpu')
    >>> set_coordinates(G, 'spring', seed=0)
    >>> G.coords.shape
    (6, 2)
    """
    if not isinstance(kind, str):
        coords = np.asanyarray(kind).squeeze()
        ok_1d = coords.ndim == 1
        ok_2d3d = coords.ndim == 2 and 2 <= coords.shape[1] <= 3
        if coords.shape[0] != G.N or not (ok_1d or ok_2d3d):
            raise ValueError('Expecting coordinates to be of size N, Nx2, '
                             'or Nx3.')
        G.coords = coords
    elif kind == 'line1D':
        G.coords = np.arange(G.N)
    elif kind == 'line2D':
        G.coords = np.stack([np.arange(G.N), np.zeros(G.N)], axis=1)
    elif kind == 'ring2D':
        angle = np.arange(G.N) * 2 * np.pi / G.N
        G.coords = np.stack([np.cos(angle), np.sin(angle)], axis=1)
    elif kind == 'random2D':
        G.coords = np.random.default_rng(seed).uniform(size=(G.N, 2))
    elif kind == 'random3D':
        G.coords = np.random.default_rng(seed).uniform(size=(G.N, 3))
    elif kind == 'spring':
        G.coords = _fruchterman_reingold(G, seed=seed, **kwargs)
    elif kind == 'community2D':
        if not hasattr(G, 'info') or 'node_com' not in G.info:
            raise ValueError('Missing arguments to the graph to be able to '
                             'compute community coordinates.')
        info = G.info
        if 'world_rad' not in info:
            info['world_rad'] = np.sqrt(G.N)
        if 'comm_sizes' not in info:
            info['comm_sizes'] = np.bincount(info['node_com'])
        nc = info['comm_sizes'].shape[0]
        angles = 2 * np.pi * np.arange(1, nc + 1) / nc
        info['com_coords'] = info['world_rad'] * np.stack(
            [np.cos(angles), np.sin(angles)], axis=1)
        rng = np.random.default_rng(seed)
        rad_ang = rng.uniform(size=(G.N, 2))
        coords = np.stack(
            [rad_ang[:, 0] * np.cos(2 * np.pi * rad_ang[:, 1]),
             rad_ang[:, 0] * np.sin(2 * np.pi * rad_ang[:, 1])], axis=1)
        comm_rad = np.sqrt(info['comm_sizes'])[info['node_com']]
        G.coords = info['com_coords'][info['node_com']] + \
            comm_rad[:, None] * coords
    elif kind == 'laplacian_eigenmap2D':
        G.compute_fourier_basis(n_eigenvectors=3)
        G.coords = G.U[:, 1:3].cpu().numpy()
    elif kind == 'laplacian_eigenmap3D':
        G.compute_fourier_basis(n_eigenvectors=4)
        G.coords = G.U[:, 1:4].cpu().numpy()
    else:
        raise ValueError(f'Unexpected argument kind={kind}.')


def _fruchterman_reingold(G, dim=2, k=None, pos=None, fixed=None,
                          iterations=50, scale=1.0, center=None, seed=None):
    """Force-directed layout: every pair of vertices up to 2048 vertices,
    beyond that repulsion from 256 sampled vertices and attraction along
    the edges."""
    fixed = [] if fixed is None else list(fixed)
    n = G.N
    if center is None:
        center = np.zeros((1, dim))
    center = np.asarray(center).reshape(1, dim)

    rng = np.random.default_rng(seed)
    if pos is None:
        pos_arr = rng.uniform(size=(n, dim))
    else:
        dom_size = np.max(pos) if len(pos) else 1
        pos_arr = rng.uniform(size=(n, dim)) * dom_size + center
        for i, p in enumerate(pos):
            pos_arr[i] = np.asanyarray(p)

    if k is None:
        k = np.sqrt(1.0 / n)

    A = G.W.toarray() if n <= 2048 else None
    rows, cols, w = G.get_edge_list()

    t = max(np.ptp(pos_arr, axis=0).max(), 1.0) * 0.1
    dt = t / (iterations + 1)

    for _ in range(iterations):
        if A is not None:
            delta = pos_arr[:, None, :] - pos_arr[None, :, :]
            dist = np.linalg.norm(delta, axis=-1)
            np.clip(dist, 0.01, None, out=dist)
            force = k * k / dist ** 2 - A * dist / k
            displacement = np.einsum('ijd,ij->id', delta, force)
        else:
            sample = rng.integers(0, n, size=min(n, 256))
            delta_s = pos_arr[:, None, :] - pos_arr[sample][None, :, :]
            dist_s = np.clip(np.linalg.norm(delta_s, axis=-1), 0.01, None)
            displacement = np.einsum('ijd,ij->id', delta_s,
                                     k * k / dist_s ** 2) * (n / len(sample))
            dvec = pos_arr[rows] - pos_arr[cols]
            dd = np.clip(np.linalg.norm(dvec, axis=-1), 0.01, None)
            f = w * dd / k
            np.add.at(displacement, rows, -dvec * (f / dd)[:, None])
            np.add.at(displacement, cols, dvec * (f / dd)[:, None])
        length = np.clip(np.linalg.norm(displacement, axis=-1), 0.01, None)
        step = displacement * (t / length)[:, None]
        if fixed:
            step[fixed] = 0
        pos_arr = pos_arr + step
        t -= dt

    if not fixed:
        pos_arr -= pos_arr.mean(axis=0)
        lim = np.abs(pos_arr).max()
        if lim > 0:
            pos_arr *= scale / lim
        pos_arr += center
    return pos_arr
