"""Community graph — Nc dense/NN communities plus sparse world edges.

Counterpart of ``pygsp_tpu/graphs/community.py``, the same NumPy and SciPy code
on the host, so that a seed gives the same graph. Vectorized construction
matching the reference's ensemble (``pygsp/graphs/community.py:59-296``):
per-community edges by density / kNN / epsilon-NN over sampled disc
coordinates, plus uniformly sampled inter-community "world" edges.
"""

import numpy as np
import scipy.sparse as sps
from scipy import spatial

from pygsp_tpu_torch import utils
from pygsp_tpu_torch.graphs.graph import Graph

_logger = utils.build_logger(__name__)


class Community(Graph):
    """Communities laid out on a circle; intra edges dense/kNN/epsNN,
    inter edges sampled at ``world_density``.

    Examples
    --------
    >>> from pygsp_tpu_torch import graphs
    >>> G = graphs.Community(N=60, Nc=3, seed=4, device='cpu')
    >>> G.N
    60
    >>> G.coords.shape               # communities laid out on a disc
    (60, 2)

    """

    def __init__(self, N=256, Nc=None, min_comm=None, min_deg=None,
                 comm_sizes=None, size_ratio=1, world_density=None,
                 comm_density=None, k_neigh=None, epsilon=None, seed=None,
                 **kwargs):
        if Nc is None:
            Nc = int(round(np.sqrt(N) / 2))
        if min_comm is None:
            min_comm = int(round(N / (3 * Nc)))
        if min_deg is not None:
            raise NotImplementedError
        if world_density is None:
            world_density = 1 / N
        if not 0 <= world_density <= 1:
            raise ValueError('World density should be in [0, 1].')
        if epsilon is None:
            epsilon = np.sqrt(2 * np.sqrt(N)) / 2

        self.Nc, self.min_comm = Nc, min_comm
        self.comm_sizes, self.size_ratio = comm_sizes, size_ratio
        self.world_density, self.comm_density = world_density, comm_density
        self.k_neigh, self.epsilon, self.seed = k_neigh, epsilon, seed

        rng = np.random.default_rng(seed)
        if min_comm * Nc > N:
            raise ValueError('The constraint on minimum size for communities '
                             'is unsolvable.')

        info = {'world_density': world_density, 'min_comm': min_comm}

        if comm_sizes is None:
            labels = np.concatenate([
                np.tile(np.arange(Nc), min_comm),
                rng.choice(Nc, N - min_comm * Nc)])
            info['node_com'] = np.sort(labels)
        else:
            if len(comm_sizes) != Nc:
                raise ValueError('There should be Nc community sizes.')
            if np.sum(comm_sizes) != N:
                raise ValueError('The sum of community sizes should be N.')
            info['node_com'] = np.repeat(np.arange(Nc), comm_sizes)

        sizes = np.bincount(info['node_com'], minlength=Nc)
        info['comm_sizes'] = sizes
        info['world_rad'] = size_ratio * np.sqrt(N)
        angles = 2 * np.pi * np.arange(1, Nc + 1) / Nc
        info['com_coords'] = info['world_rad'] * np.stack(
            [np.cos(angles), np.sin(angles)], axis=1)

        # polar-uniform points inside each community disc
        rad_ang = rng.uniform(size=(N, 2))
        coords = np.stack([rad_ang[:, 0] * np.cos(2 * np.pi * rad_ang[:, 1]),
                           rad_ang[:, 0] * np.sin(2 * np.pi * rad_ang[:, 1])],
                          axis=1)
        comm_rad = np.sqrt(sizes)[info['node_com']]
        coords = info['com_coords'][info['node_com']] + \
            comm_rad[:, None] * coords

        rows, cols = [], []
        first = 0
        for i in range(Nc):
            size = sizes[i]
            block = coords[first:first + size]
            npairs = size * (size - 1) // 2
            if comm_density is not None:
                if not 0 <= comm_density <= 1:
                    raise ValueError('comm_density should be between 0 and 1.')
                n_edges = int(comm_density * npairs)
                sel = rng.permutation(npairs)[:n_edges]
                r = ((1 + np.sqrt(1 + 8 * sel.astype(np.float64)))
                     / 2).astype(np.int64)
                r = np.where(r * (r - 1) // 2 > sel, r - 1, r)
                r = np.where((r + 1) * r // 2 <= sel, r + 1, r)
                c = sel - r * (r - 1) // 2
                rows.append(first + r)
                cols.append(first + c)
            elif k_neigh is not None:
                if k_neigh < 0:
                    raise ValueError('k_neigh cannot be negative.')
                if size > 1:
                    tree = spatial.KDTree(block)
                    _, nn = tree.query(block, k=min(k_neigh + 1, size))
                    src = np.repeat(np.arange(size), nn.shape[1] - 1)
                    dst = nn[:, 1:].reshape(-1)
                    lo, hi = np.minimum(src, dst), np.maximum(src, dst)
                    keys = np.unique(lo * size + hi)
                    rows.append(first + keys // size)
                    cols.append(first + keys % size)
            else:
                if size > 1:
                    tree = spatial.KDTree(block)
                    pairs = tree.query_pairs(epsilon, output_type='ndarray')
                    if len(pairs):
                        rows.append(first + pairs[:, 0])
                        cols.append(first + pairs[:, 1])
            first += size

        # inter-community world edges: sample pairs uniformly, keep
        # cross-community ones until the target count is reached
        n_cross = int((N ** 2 - np.sum(sizes ** 2)) // 2)
        nb_edges = int(world_density * n_cross)
        chosen = set()
        node_com = info['node_com']
        while len(chosen) < nb_edges:
            cand = rng.integers(
                0, N, size=(max(64, 2 * (nb_edges - len(chosen))), 2))
            lo = cand.min(axis=1)
            hi = cand.max(axis=1)
            ok = node_com[lo] != node_com[hi]
            for key in (lo[ok].astype(np.int64) * N + hi[ok]):
                if len(chosen) >= nb_edges:
                    break
                chosen.add(int(key))
        if chosen:
            keys = np.fromiter(chosen, dtype=np.int64, count=len(chosen))
            rows.append(keys // N)
            cols.append(keys % N)

        if rows:
            r = np.concatenate(rows)
            c = np.concatenate(cols)
        else:
            r = c = np.empty(0, dtype=np.int64)
        W = sps.csr_matrix(
            (np.ones(2 * len(r)),
             (np.concatenate([r, c]), np.concatenate([c, r]))), shape=(N, N))
        W.data[:] = 1.0

        self.info = info
        super().__init__(W, coords=coords, **kwargs)

    def _get_extra_repr(self):
        return dict(Nc=self.Nc, seed=self.seed)
