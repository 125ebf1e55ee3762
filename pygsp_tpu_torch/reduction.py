"""Graph reduction: Kron reduction, sparsification, multiresolution
pyramids (counterpart of :mod:`pygsp_tpu.reduction`).

The host-side parts are the JAX package's NumPy and SciPy code. The device
work: ``kron_reduction('exact')`` solves its dropped block densely with
``torch.linalg.solve`` on the graph's device; the sketched resistances run
one conjugate-gradient solve over all probes
(:func:`~pygsp_tpu_torch.ops.cg.cg`, CSR SpMM kernel launches at the
probes' width); the pyramid filters through the Chebyshev recurrence
(kernel A and kernel B) and estimates λmax or the largest eigenvector by
Lanczos. A graph this module builds lies on the device and has the dtype
of the graph it came from; from a bare matrix, on ``device`` with ``dtype``
(default ``'cuda'`` and float32).

As in the JAX package: ``graph_sparsify`` counts samples with
``np.bincount``; the pyramid synthesizes directly; ``kron_reduction`` solves
densely up to 4000 dropped vertices and eliminates above.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sps
import torch
from scipy.sparse import linalg as spslinalg

from pygsp_tpu_torch import filters as _filters
from pygsp_tpu_torch import graphs as _graphs
from pygsp_tpu_torch import utils
from pygsp_tpu_torch.core.operators import matvec
from pygsp_tpu_torch.ops.cg import cg

logger = utils.build_logger(__name__)

_DENSE_SOLVE_MAX = 4000  # complement size up to which we solve on device


def _on(G, device, dtype):
    """``{device, dtype}`` for a graph built from ``G``: G's own when it is
    a Graph, else the caller's (default ``'cuda'``, float32)."""
    if isinstance(G, _graphs.Graph):
        return {'device': G.device, 'dtype': G.dtype}
    return {'device': 'cuda' if device is None else device,
            'dtype': torch.float32 if dtype is None else dtype}


def _without_diagonal(W):
    """W (CSR) with its diagonal entries removed."""
    W = sps.csr_matrix(W)
    W = W - sps.diags(W.diagonal())
    W.eliminate_zeros()
    return W


def _analysis(g, s, **kwargs):
    """Filter, then stack the features Fortran-style (host NumPy)."""
    s = g.filter(s, **kwargs).cpu().numpy()
    while s.ndim < 3:
        s = np.expand_dims(s, 1)
    return s.swapaxes(1, 2).reshape(-1, s.shape[1], order='F')


def kron_reduction(G, ind, method: str = 'auto', seed=None, *, device=None,
                   dtype=None):
    """Schur complement of L onto the kept indices ``ind``; a Graph with
    the implied weights for a Graph, the reduced Laplacian (CSR) for a
    sparse Laplacian.

    method:
      'exact'      — a linear solve against the dropped block: dense, with
                     ``torch.linalg.solve`` on the graph's device (or on
                     ``device`` in ``dtype`` for a matrix) while the dropped
                     set is at most %d, SciPy's sparse LU above. The Schur
                     complement of a sparse Laplacian fills in.
      'eliminate'  — star-mesh elimination of the dropped vertices with
                     unbiased clique sampling (:func:`_schur_by_elimination`,
                     seeded by ``seed``).
      'auto'       — 'exact' while the dropped set is at most %d, else
                     'eliminate'.

    Examples
    --------
    >>> import numpy as np
    >>> from pygsp_tpu_torch import graphs, reduction
    >>> G = graphs.Path(8, device='cpu')
    >>> Gk = reduction.kron_reduction(G, np.arange(0, 8, 2))
    >>> Gk.N, Gk.Ne                       # a path reduces to a path
    (4, 3)
    """
    if isinstance(G, _graphs.Graph):
        if G.lap_type != 'combinatorial':
            raise NotImplementedError(
                f'Unknown reduction for {G.lap_type} Laplacian.')
        if G.is_directed():
            raise NotImplementedError(
                'This method only work for undirected graphs.')
        L = sps.csr_matrix(G.L.to_scipy())
    else:
        L = sps.csr_matrix(G)
    on = _on(G, device, dtype)

    N = L.shape[0]
    keep = np.asarray(ind)
    drop = np.setdiff1d(np.arange(N, dtype=int), keep)
    if method == 'auto':
        method = 'exact' if len(drop) <= _DENSE_SOLVE_MAX else 'eliminate'

    if method == 'eliminate':
        Lnew = _schur_by_elimination(L, keep, drop, seed=seed)
    elif method == 'exact':
        L_kk = L[np.ix_(keep, keep)]             # kept block
        L_kd = L[np.ix_(keep, drop)]             # kept x dropped coupling
        L_dk = L[np.ix_(drop, keep)].tocsc()
        L_dd = L[np.ix_(drop, drop)].tocsc()     # dropped block

        if len(drop) <= _DENSE_SOLVE_MAX:
            # one dense LU of the dropped block on the device
            X = torch.linalg.solve(
                torch.as_tensor(L_dd.toarray(), **on),
                torch.as_tensor(L_dk.toarray(), **on)).cpu().numpy()
            Lnew = sps.csr_matrix(L_kk.toarray() - L_kd.toarray() @ X)
        else:
            Lnew = sps.csr_matrix(L_kk - L_kd.dot(
                spslinalg.spsolve(L_dd, L_dk)))

        # symmetrize tiny asymmetries from the solve
        if np.abs(Lnew - Lnew.T).sum() < np.spacing(1) * np.abs(Lnew).sum():
            Lnew = (Lnew + Lnew.T) / 2.0
    else:
        raise ValueError(f'Unknown method {method!r}')

    if isinstance(G, _graphs.Graph):
        Wnew = sps.diags(Lnew.diagonal(), 0) - Lnew
        # re-inject any diagonal slack the solve left behind (vertices
        # whose Schur row no longer sums to zero keep a self-term)
        slack = Lnew.diagonal() - np.ravel(Wnew.sum(0))
        if np.linalg.norm(slack, 2) >= np.spacing(1000):
            Wnew = Wnew + sps.diags(slack, 0)
        Wnew = _without_diagonal(Wnew)

        coords = G.coords[np.asarray(ind)] if G.coords is not None else None
        return _graphs.Graph(Wnew, coords=coords, lap_type=G.lap_type,
                             plotting=G.plotting, **on)
    return Lnew


kron_reduction.__doc__ %= (_DENSE_SOLVE_MAX, _DENSE_SOLVE_MAX)


def _schur_by_elimination(L, keep, drop, seed=None, exact_degree: int = 6):
    """Approximate Schur complement by star-mesh elimination (host).

    Eliminating vertex v from a Laplacian replaces its star by the clique
    with weights ``w_i w_j / W`` (W = Σ w), one Gaussian elimination step.
    Vertices go in approximate-min-degree order; a star of more than
    ``exact_degree`` neighbours is *sampled*: each neighbour i takes one
    partner j ∼ w_j/(W − w_i) and an edge of weight ``w_i (W − w_i) / (2
    W)``, the exact clique in expectation. Returns the reduced Laplacian
    over ``keep`` (CSR, in keep's order).
    """
    rng = np.random.default_rng(seed)
    n = L.shape[0]
    W = sps.diags(L.diagonal()) - L       # adjacency (+ no self loops)
    W = sps.csr_matrix(W)
    W.setdiag(0)
    W.eliminate_zeros()
    # diagonal slack (e.g. the +eps*I of the regularized green kernel) is
    # an edge to a virtual ground vertex; star-mesh must route through it
    slack = np.asarray(L.diagonal() - np.ravel(W.sum(1)))

    adj = [dict() for _ in range(n)]
    coo = W.tocoo()
    for i, j, w in zip(coo.row, coo.col, coo.data):
        if i != j and w != 0:
            adj[i][j] = adj[i].get(j, 0.0) + w

    import heapq
    heap = [(len(adj[v]), v) for v in drop]
    heapq.heapify(heap)
    alive = np.ones(n, dtype=bool)

    def add_edge(a, b, w):
        adj[a][b] = adj[a].get(b, 0.0) + w
        adj[b][a] = adj[b].get(a, 0.0) + w

    while heap:
        d, v = heapq.heappop(heap)
        if not alive[v]:
            continue
        if d != len(adj[v]):                  # stale degree: re-queue
            heapq.heappush(heap, (len(adj[v]), v))
            continue
        alive[v] = False
        nbrs = adj[v]
        ids = np.fromiter(nbrs.keys(), dtype=np.int64, count=len(nbrs))
        ws = np.fromiter(nbrs.values(), dtype=np.float64, count=len(nbrs))
        for u in ids:
            del adj[u][v]
        adj[v] = {}
        w_real = ws.sum()
        total = w_real + slack[v]             # ground edge joins the star
        if total <= 0 or len(ids) < 1:
            continue
        # ground coupling is deterministic: neighbor i inherits slack
        # w_i * s_v / total (kept exact — it is only d updates)
        if slack[v] != 0:
            slack[ids] += ws * slack[v] / total
        if len(ids) < 2:
            continue
        if len(ids) <= exact_degree:
            scale = 1.0 / total
            for a in range(len(ids)):
                for b in range(a + 1, len(ids)):
                    add_edge(ids[a], ids[b], ws[a] * ws[b] * scale)
        else:
            p = ws / w_real
            partners = rng.choice(len(ids), size=len(ids), p=p)
            # redraw collisions j == anchor (rejection, expected O(1))
            bad = partners == np.arange(len(ids))
            while bad.any():
                partners[bad] = rng.choice(len(ids), size=int(bad.sum()),
                                           p=p)
                bad = partners == np.arange(len(ids))
            wt = ws * (w_real - ws) / (2.0 * total)
            for a, j, w in zip(range(len(ids)), partners, wt):
                add_edge(ids[a], ids[j], w)

    # assemble reduced Laplacian over keep (in keep order)
    pos = np.full(n, -1, dtype=np.int64)
    pos[keep] = np.arange(len(keep))
    rows, cols, vals = [], [], []
    for v in keep:
        pv = pos[v]
        for u, w in adj[v].items():
            pu = pos[u]
            if pu >= 0:
                rows.append(pv)
                cols.append(pu)
                vals.append(w)
    Wred = sps.csr_matrix((vals, (rows, cols)),
                          shape=(len(keep), len(keep)))
    Wred = (Wred + Wred.T) / 2.0
    return sps.csr_matrix(sps.diags(np.ravel(Wred.sum(1)) + slack[keep])
                          - Wred)


# below this many vertices the exact dense pseudo-inverse of L is cheaper
# than sketching; above it graph_sparsify switches to CG-probe sketches
_DENSE_RESISTANCE_MAX = 3000


def _resample_by_resistance(srcs, tgts, weights, Re, N, epsilon, maxiter,
                            rng):
    """Importance-resample the edge list ∝ w·R (leverage scores) and
    reweight so the sampled Laplacian is unbiased; shrink epsilon and
    retry while the sample is disconnected. Returns the sampled symmetric
    adjacency (CSC)."""
    weights = np.maximum(0, np.asarray(weights))
    Re = np.maximum(0, np.asarray(Re))
    leverage = weights * Re
    leverage = leverage / leverage.sum()

    sampledW = None
    for attempt in range(maxiter):
        # Spielman–Srivastava sample count q = O(N log N / eps^2) with the
        # JAX package's constant 9·(4/30)²
        q = int(round(N * np.log(N) * 9 * (4 / 30.0) ** 2 / epsilon ** 2))
        hits = np.bincount(rng.choice(len(leverage), size=q, p=leverage),
                           minlength=len(leverage))
        resampled = hits * weights / (q * leverage)
        sampledW = sps.csc_matrix((resampled, (srcs, tgts)), shape=(N, N))
        sampledW = sampledW + sampledW.T
        n_comp, _ = sps.csgraph.connected_components(sampledW,
                                                     directed=False)
        if n_comp == 1:
            break
        if attempt == maxiter - 1:
            logger.warning('Despite attempts to reduce epsilon, sparsified '
                           'graph is disconnected')
        else:
            epsilon -= (epsilon - 1 / np.sqrt(N)) / 2.0
    return sampledW


def graph_sparsify(M, epsilon, maxiter=10, seed=None, n_probes=24, *,
                   device=None, dtype=None):
    """Spectral sparsification by effective-resistance sampling.

    ``M`` is a Graph (combinatorial Laplacian) or a sparse Laplacian, for
    which a Graph is built on ``device`` in ``dtype``. The resistances come
    from the dense pseudo-inverse on the host up to %d vertices, and from
    the conjugate-gradient sketch (:func:`effective_resistances_sketch`,
    its probes seeded with 0) above. The sample is drawn from
    ``numpy.random.default_rng(seed)``. Returns a Graph for a Graph, a
    sparse (LIL) Laplacian for a matrix.

    Examples
    --------
    >>> from pygsp_tpu_torch import graphs, reduction
    >>> G = graphs.Sensor(64, seed=42, device='cpu')
    >>> Gs = reduction.graph_sparsify(G, epsilon=0.7, seed=1)
    >>> bool(Gs.Ne <= G.Ne)               # spectrally similar, fewer edges
    True
    """
    if isinstance(M, _graphs.Graph):
        if M.lap_type != 'combinatorial':
            raise NotImplementedError
        G = M
    else:
        L = sps.csc_matrix(M)
        W = sps.diags(L.diagonal()) - L
        W = W.tocsr()
        W.data[W.data < 1e-10] = 0
        W.eliminate_zeros()
        G = _graphs.Graph(W, **_on(M, device, dtype))

    N = G.N
    if not 1.0 / np.sqrt(N) <= epsilon < 1:
        raise ValueError('GRAPH_SPARSIFY: Epsilon out of required range')

    srcs, tgts, weights = (np.asarray(a) for a in G.get_edge_list())
    if N <= _DENSE_RESISTANCE_MAX:
        # in float64 whatever the graph's dtype: a float32 pseudo-inverse
        # gives some edges a resistance at or below 0, and 0/0 weights
        R_all = utils.resistance_distance(
            sps.csc_matrix(G.L.to_scipy(), dtype=np.float64)).toarray()
        Re = R_all[srcs, tgts]
    else:
        _, _, Re = effective_resistances_sketch(G, n_probes=n_probes,
                                                seed=0)

    rng = np.random.default_rng(seed)
    sampledW = _resample_by_resistance(srcs, tgts, weights, Re, N, epsilon,
                                       maxiter, rng)

    if isinstance(M, _graphs.Graph):
        sampledW = (sampledW + sampledW.T) / 2.0
        return _graphs.Graph(_without_diagonal(sampledW), **_on(G, None,
                                                                 None))
    return sps.lil_matrix(sps.diags(np.ravel(sampledW.sum(0)))
                          - sampledW)


graph_sparsify.__doc__ %= _DENSE_RESISTANCE_MAX


def interpolate(G, f_subsampled, keep_inds, order=100, reg_eps=0.005,
                **kwargs):
    """Regularized green-kernel interpolation of a subsampled signal: the
    Kron-reduced regularized Laplacian times the samples, filtered by
    ``1/(reg_eps + λ)`` at ``order`` (host NumPy result). ``G.mr``'s
    ``K_reg`` and ``green_kernel`` are used when
    :func:`graph_multiresolution` set them."""
    L_reg = sps.csr_matrix(G.L.to_scipy()) + reg_eps * sps.eye(G.N)
    mr = G.mr if isinstance(G.mr, dict) else {}
    K_reg = mr.get('K_reg')
    if K_reg is None:
        K_reg = kron_reduction(L_reg, keep_inds, device=G.device,
                               dtype=G.dtype)
    green_kernel = mr.get('green_kernel')
    if green_kernel is None:
        green_kernel = _filters.Filter(G, lambda x: 1.0 / (reg_eps + x))

    alpha = K_reg.dot(np.asarray(f_subsampled))

    if np.asarray(f_subsampled).ndim > 1:
        f_interpolated = np.zeros((G.N, np.shape(f_subsampled)[1]))
    else:
        f_interpolated = np.zeros(G.N)
    f_interpolated[np.asarray(keep_inds)] = alpha

    return _analysis(green_kernel, f_interpolated, order=order, **kwargs)


def graph_multiresolution(G, levels, sparsify=True, sparsify_eps=None,
                          downsampling_method='largest_eigenvector',
                          reduction_method='kron', compute_full_eigen=False,
                          reg_eps=0.005, *, generator=None):
    """Multiresolution pyramid: downsample by the largest eigenvector's
    sign, Kron-reduce, optionally sparsify (the sample unseeded, as in the
    JAX package), ``levels`` times.

    Without ``compute_full_eigen`` the largest eigenvector comes from 40
    Lanczos steps (at most N) started from a normal vector drawn with
    ``generator`` (a ``torch.Generator`` on the graph's device; by default
    one seeded with the level's index). The JAX package draws it from
    ``jax.random.PRNGKey(level)``, which torch cannot reproduce: the two
    agree in the eigenvector, not in the start vector.

    Examples
    --------
    >>> import torch
    >>> from pygsp_tpu_torch import graphs, reduction
    >>> G = graphs.Sensor(64, seed=42, device='cpu', dtype=torch.float64)
    >>> G.estimate_lmax()
    >>> Gs = reduction.graph_multiresolution(G, levels=2, sparsify=False)
    >>> len(Gs), Gs[0].N, Gs[1].N         # one graph per level
    (3, 64, 32)
    """
    if sparsify_eps is None:
        sparsify_eps = min(10.0 / np.sqrt(G.N), 0.3)

    if compute_full_eigen:
        G.compute_fourier_basis()
    else:
        G.estimate_lmax()

    Gs = [G]
    Gs[0].mr = {'idx': np.arange(G.N), 'orig_idx': np.arange(G.N)}

    for i in range(levels):
        if downsampling_method == 'largest_eigenvector':
            if Gs[i]._U is not None:
                V = Gs[i].U[:, -1].cpu().numpy()
            else:
                gen = generator
                if gen is None:
                    gen = torch.Generator(
                        device=Gs[i].device).manual_seed(i)
                V = _largest_eigenvector(Gs[i], gen)
            V = V * np.sign(V[0]) if V[0] != 0 else V
            ind = np.nonzero(V >= 0)[0]
        else:
            raise NotImplementedError('Unknown graph downsampling method.')

        if reduction_method == 'kron':
            Gs.append(kron_reduction(Gs[i], ind))
        else:
            raise NotImplementedError('Unknown graph reduction method.')

        if sparsify and Gs[i + 1].N > 2:
            Gs[i + 1] = graph_sparsify(
                Gs[i + 1],
                min(max(sparsify_eps, 2.0 / np.sqrt(Gs[i + 1].N)), 1.0 - 1e-12))

        if compute_full_eigen:
            Gs[i + 1].compute_fourier_basis()
        else:
            Gs[i + 1].estimate_lmax()

        Gs[i + 1].mr = {'idx': ind, 'orig_idx': Gs[i].mr['orig_idx'][ind],
                        'level': i}

        L_reg = sps.csr_matrix(Gs[i].L.to_scipy()) + reg_eps * sps.eye(Gs[i].N)
        Gs[i].mr['K_reg'] = kron_reduction(L_reg, ind, device=Gs[i].device,
                                           dtype=Gs[i].dtype)
        Gs[i].mr['green_kernel'] = _filters.Filter(
            Gs[i], lambda x, e=reg_eps: 1.0 / (e + x))

    return Gs


def _largest_eigenvector(G, generator):
    """The Ritz vector of L's largest eigenvalue after 40 Lanczos steps (at
    most N) from a normal start vector drawn with ``generator``, on the
    host."""
    from pygsp_tpu_torch.ops.lanczos import _lanczos_single

    v0 = torch.randn(G.N, generator=generator, dtype=G.dtype,
                     device=G.device)
    Vb, H = _lanczos_single(G.L, v0, min(40, G.N))
    _, u_h = torch.linalg.eigh(H)
    return (Vb @ u_h[:, -1]).cpu().numpy()


def pyramid_analysis(Gs, f, **kwargs):
    """Coarse approximations and prediction errors per level (host NumPy).
    ``f`` is one signal, (N,); ``kwargs`` (``order`` among them) go to the
    filtering and to :func:`interpolate`, whose default ``order=100`` is
    not :func:`pyramid_synthesis`'s 30: pass the same ``order`` to both
    for an exact reconstruction.

    Examples
    --------
    >>> import numpy as np, torch
    >>> from pygsp_tpu_torch import graphs, reduction
    >>> G = graphs.Sensor(64, seed=42, device='cpu', dtype=torch.float64)
    >>> Gs = reduction.graph_multiresolution(G, levels=2, sparsify=False)
    >>> f = np.random.default_rng(1).normal(size=64)
    >>> ca, pe = reduction.pyramid_analysis(Gs, f, order=30)
    >>> len(ca), len(pe)                  # coarse approxs + error per level
    (3, 2)
    >>> f_rec, _ = reduction.pyramid_synthesis(Gs, ca[-1], pe)
    >>> bool(np.abs(f_rec - f).max() < 1e-10)
    True
    """
    if np.shape(f)[0] != Gs[0].N:
        raise ValueError('PYRAMID ANALYSIS: The signal to analyze should '
                         'have the same dimension as the first graph.')
    levels = len(Gs) - 1
    h_filters = kwargs.pop('h_filters', lambda x: 1.0 / (2 * x + 1))
    if not isinstance(h_filters, list):
        if callable(h_filters):
            h_filters = [h_filters]
        else:
            raise ValueError('Filters must be a list of functions.')
    if len(h_filters) == 1:
        h_filters = h_filters * levels
    elif len(h_filters) != levels:
        raise ValueError(f'The number of filters must be one or equal '
                         f'to {levels}.')

    ca = [np.asarray(f, dtype=float)]
    pe = []
    for i in range(levels):
        s_low = _analysis(_filters.Filter(Gs[i], h_filters[i]), ca[i],
                          **kwargs)
        ca.append(s_low[Gs[i + 1].mr['idx']])
        s_pred = interpolate(Gs[i], ca[i + 1], Gs[i + 1].mr['idx'], **kwargs)
        pe.append(ca[i] - s_pred.reshape(np.shape(ca[i])))

    return ca, pe


def pyramid_synthesis(Gs, cap, pe, order=30, **kwargs):
    """Reconstruct from the coarsest approximation ``cap`` and the
    prediction errors ``pe`` (direct interpolation): ``(f, ca)``, the
    signal and the approximations of every level, finest first."""
    reg_eps = float(kwargs.pop('reg_eps', 0.005))
    levels = len(Gs) - 1
    if len(pe) != levels:
        raise ValueError('Gs and pe have different shapes.')

    ca = [np.asarray(cap, dtype=float)]
    for i in range(levels):
        s_pred = interpolate(Gs[levels - i - 1], ca[i],
                             Gs[levels - i].mr['idx'], order=order,
                             reg_eps=reg_eps, **kwargs)
        ca.append(s_pred.reshape(np.shape(pe[levels - i - 1]))
                  + pe[levels - i - 1])

    ca.reverse()
    return ca[0], ca


def tree_multiresolution(G, Nlevel, reduction_method='resistance_distance',
                         compute_full_eigen=False, root=None):
    """Tree multiresolution by depth parity: keep the even-depth vertices
    of a BFS tree, join each to its grandparent (a series resistance, or
    weight 1 for ``'unweighted'``), ``Nlevel`` times. Returns the graphs
    and the kept vertices of each level.

    Examples
    --------
    >>> from pygsp_tpu_torch import graphs, reduction
    >>> T = graphs.Comet(15, k=4, device='cpu')    # a tree
    >>> Gs, subs = reduction.tree_multiresolution(T, Nlevel=2, root=0)
    >>> [g.N for g in Gs]
    [15, 6, 3]
    """
    if root is None:
        root = getattr(G, 'root', 0)

    Gs = [G]
    subsampled = [np.arange(G.N)]
    for _ in range(Nlevel):
        Gi = Gs[-1]
        order, preds = sps.csgraph.breadth_first_order(
            Gi.W, min(root, Gi.N - 1), directed=False)
        depth = np.full(Gi.N, -1)
        depth[order[0]] = 0
        for v in order[1:]:
            depth[v] = depth[preds[v]] + 1
        keep = np.flatnonzero((depth % 2 == 0) & (depth >= 0))
        keep_set = {int(v): i for i, v in enumerate(keep)}
        rows, cols, vals = [], [], []
        for v in keep:
            p = preds[v]
            if p < 0:
                continue
            gp = preds[p] if preds[p] >= 0 else p
            if int(gp) in keep_set and gp != v:
                rows.append(keep_set[int(v)])
                cols.append(keep_set[int(gp)])
                w = Gi.W[v, p]
                if reduction_method == 'resistance_distance':
                    w2 = Gi.W[p, gp] if Gi.W[p, gp] != 0 else w
                    val = 1.0 / (1.0 / w + 1.0 / w2)  # series resistance
                elif reduction_method == 'unweighted':
                    val = 1.0
                else:
                    raise NotImplementedError('Unknown graph reduction method.')
                vals.append(val)
        n_new = len(keep)
        W = sps.csr_matrix((vals, (rows, cols)), shape=(n_new, n_new))
        W = utils.symmetrize(W, method='maximum')
        coords = Gi.coords[keep] if Gi.coords is not None else None
        Gnew = _graphs.Graph(W, coords=coords, device=Gi.device,
                             dtype=Gi.dtype)
        if compute_full_eigen:
            Gnew.compute_fourier_basis()
        root = keep_set.get(int(order[0]), 0)
        Gs.append(Gnew)
        subsampled.append(keep)

    return Gs, subsampled


def effective_resistances_sketch(G, n_probes: int = 24, seed: int = 0,
                                 maxiter: int = 300, tol: float = 1e-6):
    """Per-edge effective resistances by Johnson–Lindenstrauss sketching:
    ``R_e ≈ ‖Z(e_u − e_v)‖²`` with ``Z = Q W^{1/2} B L⁺`` and Q a ±1/√k
    projection drawn from ``numpy.random.default_rng(seed)`` (the JAX
    package's probes), from one conjugate-gradient solve of ``L Z = Y``
    over all ``n_probes`` columns on the graph's device. Returns
    ``(sources, targets, R)`` for the undirected edge list, R on the host.
    """
    if G.lap_type != 'combinatorial':
        raise NotImplementedError('Need a combinatorial Laplacian.')

    sources, targets, weights = G.get_edge_list()
    e = len(sources)
    rng = np.random.default_rng(seed)
    # Y = (Q W^{1/2} B)ᵀ : (N, k) — B has ±1 rows per edge, summed on the
    # device in float64 (the JAX package's np.add.at on the host)
    q = (rng.integers(0, 2, size=(n_probes, e)) * 2 - 1) / np.sqrt(n_probes)
    qw = torch.as_tensor((q * np.sqrt(np.asarray(weights))[None, :]).T,
                         device=G.device)
    src = torch.as_tensor(sources, device=G.device)
    tgt = torch.as_tensor(targets, device=G.device)
    Y = torch.zeros((G.N, n_probes), dtype=torch.float64, device=G.device)
    Y.index_add_(0, src, qw).index_add_(0, tgt, -qw)
    del qw

    L = G.L
    # deflate the constant null-space so CG converges on the pseudo-inverse
    Y = Y.to(L.dtype)
    Y = Y - torch.mean(Y, dim=0, keepdim=True)

    Z, _ = cg(lambda x: matvec(L, x), Y, tol=tol, maxiter=maxiter)
    Z = Z - torch.mean(Z, dim=0, keepdim=True)
    R = torch.sum((Z[src] - Z[tgt]) ** 2, dim=1)
    return sources, targets, R.cpu().numpy()


def graph_sparsify_sketch(G, epsilon, n_probes: int = 24, maxiter: int = 10,
                          seed=None):
    """Sparsify with sketched resistances whatever the size (the path
    :func:`graph_sparsify` takes above %d vertices)."""
    N = G.N
    if not 1.0 / np.sqrt(N) <= epsilon < 1:
        raise ValueError('GRAPH_SPARSIFY: Epsilon out of required range')
    srcs, tgts, weights = (np.asarray(a) for a in G.get_edge_list())
    _, _, Re = effective_resistances_sketch(G, n_probes=n_probes, seed=0)
    sampledW = _resample_by_resistance(
        srcs, tgts, weights, Re, N, epsilon, maxiter,
        np.random.default_rng(seed))
    return _graphs.Graph(_without_diagonal(sampledW), device=G.device,
                         dtype=G.dtype)


graph_sparsify_sketch.__doc__ %= _DENSE_RESISTANCE_MAX
