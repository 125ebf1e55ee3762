"""Host-side graph partitioner for the multi-device engines.

Counterpart of :mod:`pygsp_tpu.parallel.partition`. Builds a
:class:`ShardedGraph`: a 1-D contiguous vertex partition (optionally after
a bandwidth-reducing reverse Cuthill–McKee order, or community clustering)
with, per shard,

- the local Laplacian slice in padded COO (local rows, *extended* column
  indexing: ``[0, n_local)`` = owned vertices, ``[n_local, ...)`` =
  received halo slots),
- distance-bucketed halo send maps: for each ring distance ``d`` with any
  traffic, ``send_idx[k]`` of shape ``(S, H_d)`` holds the local vertex ids
  shard ``s`` ships to shard ``(s + d) % S`` each SpMM step, each bucket
  sized to its own worst sender.

The packing is the JAX package's NumPy, line for line, so the same graph
partitions to the same arrays; only the result differs: tensors on
``device`` (``'cuda'`` by default) instead of JAX arrays. The arrays keep
the JAX package's leading shard axis: every rank builds the whole
partition (the partitioner is deterministic), and
:func:`~pygsp_tpu_torch.parallel.launch.put_sharded_graph` keeps a rank's
own shard on its device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sps
import torch

from pygsp_tpu_torch.core import sparse as sp
from pygsp_tpu_torch.core.chunked import _numpy_dtype, _tensor
from pygsp_tpu_torch.utils import check_device


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def _np_dtype(dtype):
    """A numpy or torch dtype as numpy's; None is float32 (the card's)."""
    return np.dtype(np.float32) if dtype is None else _numpy_dtype(dtype)


def _host(t) -> np.ndarray:
    """A tensor or array as a host array (bfloat16 kept as its bits read
    back by :func:`_tensor`: widened to float32)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t)


def shard_slice(obj, s: int):
    """``obj`` (a dataclass of stacked per-shard tensors, or a tuple of
    them) cut to shard ``s``, keeping a leading axis of 1: what one rank
    holds, as the JAX package's ``shard_map`` bodies see their leaves.
    Leaves whose leading axis is already 1 stay as they are."""
    if isinstance(obj, torch.Tensor):
        return obj if obj.shape[0] == 1 else obj[s:s + 1]
    if isinstance(obj, tuple):
        return tuple(shard_slice(o, s) for o in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: shard_slice(getattr(obj, f.name), s)
            for f in dataclasses.fields(obj) if f.init and isinstance(
                getattr(obj, f.name), (torch.Tensor, tuple))
            and f.name not in getattr(obj, '_META', ())})
    return obj


def _cached(obj, key, build):
    """A value kept on the frozen dataclass ``obj`` under ``key``, built
    once (the engines' per-shard local matrices)."""
    cache = obj.__dict__.setdefault('_local_cache', {})
    if key not in cache:
        cache[key] = build()
    return cache[key]


@dataclasses.dataclass(frozen=True)
class ShardedGraph:
    """Stacked per-shard tensors (leading axis = shard = the mesh's
    'graph' axis).

    rows: (S, E) int32 — local row of each edge (n_local ⇒ padding).
    cols: (S, E) int32 — extended-local column index of each edge.
    vals: (S, E) — Laplacian off-diagonal values (−w, possibly normalized).
    diag: (S, n_local) — Laplacian diagonal of owned vertices.
    send_idx: tuple of (S, H_d) int32, one per ring distance in
        ``halo_dists`` — send_idx[k][s] = local ids shard s ships to shard
        ``(s + halo_dists[k]) % S`` (n_local ⇒ padding slot, unreferenced).
    perm: (N,) int32 — vertex reordering applied (original → position).
    halo_dists / halo_sizes: ring distances with traffic and their bucket
        widths H_d; receive slot layout is ``[owned ‖ bucket_0 ‖ bucket_1
        ‖ ...]`` in ``halo_dists`` order.

    After :func:`~pygsp_tpu_torch.parallel.launch.put_sharded_graph` the
    per-shard tensors hold one rank's shard only (leading axis 1).
    """

    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    diag: torch.Tensor
    send_idx: tuple
    perm: torch.Tensor
    n_shards: int
    n_local: int
    halo_dists: tuple
    halo_sizes: tuple
    n_vertices: int
    lap_type: str

    _META = ('perm',)        # replicated, never cut by shard_slice

    @property
    def n_padded(self) -> int:
        return self.n_shards * self.n_local

    @property
    def halo_total(self) -> int:
        """Halo slots received per shard per step (sum of bucket widths)."""
        return int(sum(self.halo_sizes))

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self):
        return self.vals.device

    def pad_signal(self, x):
        """Reorder + zero-pad a (N, ...) signal to (S*n_local, ...), on the
        partition's device."""
        x = torch.as_tensor(x, device=self.device)
        out = torch.zeros((self.n_padded,) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=self.device)
        out[self.perm.long()] = x
        return out

    def unpad_signal(self, y):
        """Inverse of :meth:`pad_signal`."""
        y = torch.as_tensor(y)
        return y[self.perm.to(y.device).long()]


def _lpa_communities(indptr, indices, n_shards, rounds=20):
    """Community detection by plain label propagation (labels start as
    vertex ids; each round every vertex adopts its most frequent neighbor
    label, ties to the smallest). Vectorized as a run-length count over
    ``(row, label)``-sorted edge labels — O(E log E) per round.

    Collapse guard: stop (returning the PREVIOUS labeling) as soon as the
    heaviest community outgrows one shard's capacity.
    """
    N = len(indptr) - 1
    deg = np.diff(indptr).astype(np.int64)
    w = (deg + 1).astype(np.float64)
    cap = w.sum() / n_shards
    rows = np.repeat(np.arange(N, dtype=np.int64), deg)
    labels = np.arange(N, dtype=np.int64)
    for _ in range(rounds):
        lab_e = labels[indices]
        order = np.lexsort((lab_e, rows))
        r_s, l_s = rows[order], lab_e[order]
        new_run = np.concatenate(
            [[True], (r_s[1:] != r_s[:-1]) | (l_s[1:] != l_s[:-1])])
        run_id = np.cumsum(new_run) - 1
        run_counts = np.bincount(run_id)
        run_row = r_s[new_run]
        run_lab = l_s[new_run]
        o2 = np.lexsort((run_lab, -run_counts, run_row))
        rr = run_row[o2]
        first = np.concatenate([[True], rr[1:] != rr[:-1]])
        newlab = labels.copy()
        newlab[rr[first]] = run_lab[o2][first]
        lw = np.bincount(np.unique(newlab, return_inverse=True)[1],
                         weights=w)
        if lw.max() > cap:
            return labels
        changed = int((newlab != labels).sum())
        labels = newlab
        if changed < max(N // 1000, 1):
            break
    return labels


def _pack_communities(labels, deg, n_shards, cap_slack=1.05):
    """Bin-pack communities into shards: heaviest community first into
    the least-loaded shard (LPT greedy), splitting any community that
    does not fit the remaining capacity by cumulative degree."""
    N = len(labels)
    w = deg + 1
    cap = w.sum() / n_shards * cap_slack
    uniq, inv = np.unique(labels, return_inverse=True)
    cw = np.bincount(inv, weights=w.astype(np.float64))
    order = np.argsort(inv, kind='stable')
    shard = np.empty(N, np.int32)
    loads = np.zeros(n_shards)
    starts = np.zeros(len(uniq) + 1, np.int64)
    np.cumsum(np.bincount(inv), out=starts[1:])
    for ci in np.argsort(-cw):
        verts = order[starts[ci]:starts[ci + 1]]
        cum = np.cumsum(w[verts].astype(np.float64))
        lo = 0
        while lo < len(verts):
            s = int(np.argmin(loads))
            room = cap - loads[s]
            base = cum[lo - 1] if lo else 0.0
            hi = int(np.searchsorted(
                cum, base + max(room, w[verts[lo]]), side='right'))
            hi = max(hi, lo + 1)
            shard[verts[lo:hi]] = s
            loads[s] += cum[hi - 1] - base
            lo = hi
    return shard


def _refine_labels(indptr, indices, labels, n_shards, rounds=15,
                   slack=1.05):
    """Capacity-constrained k-way refinement: each round every vertex
    scores shards by neighbor count and the highest-gain movers are
    accepted per target shard until its capacity (nnz·slack/S) fills."""
    N = len(indptr) - 1
    S = n_shards
    deg = np.diff(indptr).astype(np.int64)
    rows = np.repeat(np.arange(N, dtype=np.int64), deg)
    w = deg + 1
    cap = w.sum() / S * slack
    ar = np.arange(N)
    labels = labels.astype(np.int32).copy()
    for _ in range(rounds):
        counts = np.bincount(rows * S + labels[indices],
                             minlength=N * S).reshape(N, S)
        load = np.bincount(labels, weights=w.astype(np.float64),
                           minlength=S)
        best = np.argmax(counts.astype(np.float64)
                         - 1e-9 * load[None, :], axis=1).astype(np.int32)
        gain = counts[ar, best] - counts[ar, labels]
        movers = np.flatnonzero((gain > 0) & (best != labels))
        if not len(movers):
            break
        order = movers[np.lexsort((-gain[movers], best[movers]))]
        tgt = best[order]
        grp = np.searchsorted(tgt, np.arange(S))
        cumw = np.cumsum(w[order].astype(np.float64))
        prev = np.concatenate([[0.0], cumw])[grp]
        accept = cumw - prev[tgt] + load[tgt] <= cap
        moved = order[accept]
        if not len(moved):
            break
        labels[moved] = best[moved]
    return labels


def _halo_pairs(indptr, indices, labels):
    """The partition objective: unique (receiving shard, remote column)
    pairs — exactly the rows shipped per SpMM step."""
    N = len(indptr) - 1
    deg = np.diff(indptr).astype(np.int64)
    rows = np.repeat(np.arange(N, dtype=np.int64), deg)
    sr = labels[rows].astype(np.int64)
    mask = sr != labels[indices]
    return int(np.unique(sr[mask] * N + indices[mask]).size)


def cluster_shards(W, n_shards: int, slack: float = 1.05,
                   lpa_rounds: int = 20,
                   refine_rounds: int = 15) -> np.ndarray:
    """Shard labels by community clustering: guarded label-propagation
    community detection → LPT bin-packing into ``n_shards`` →
    capacity-constrained k-way refinement, all vectorized NumPy.

    Returns the best of three candidates by the true objective (unique
    halo pairs): the contiguous nnz-balanced split, its refinement, and
    the refined LPA packing.
    """
    W = sps.csr_matrix(W)
    N = W.shape[0]
    deg = np.diff(W.indptr).astype(np.int64)

    cum = np.cumsum(deg + 1)
    targets = cum[-1] / n_shards * np.arange(1, n_shards)
    bounds = np.concatenate([[0], np.searchsorted(cum, targets), [N]])
    contig = np.zeros(N, np.int32)
    for s in range(n_shards):
        contig[bounds[s]:bounds[s + 1]] = s

    comm = _lpa_communities(W.indptr, W.indices, n_shards,
                            rounds=lpa_rounds)
    packed = _pack_communities(comm, deg, n_shards, cap_slack=slack)
    candidates = [
        contig,
        _refine_labels(W.indptr, W.indices, contig, n_shards,
                       rounds=refine_rounds, slack=slack),
        _refine_labels(W.indptr, W.indices, packed, n_shards,
                       rounds=refine_rounds, slack=slack),
    ]
    return min(candidates,
               key=lambda l: _halo_pairs(W.indptr, W.indices, l))


def _laplacian_entries(Wp, lap_type, dtype):
    """``(coo, vals, diag)`` of the Laplacian of the reordered adjacency
    ``Wp``: its off-diagonal values at ``coo``'s entries and its diagonal,
    in ``dtype`` (the JAX package's arithmetic)."""
    dw = np.ravel(Wp.sum(axis=1))
    coo = Wp.tocoo()
    if lap_type == 'combinatorial':
        return coo, -coo.data.astype(dtype), dw.astype(dtype)
    if lap_type == 'normalized':
        d = np.where(dw > 0, dw, 1.0) ** -0.5
        d = np.where(dw > 0, d, 0.0)
        return (coo, (-coo.data * d[coo.row] * d[coo.col]).astype(dtype),
                np.where(dw > 0, 1.0, 0.0).astype(dtype))
    raise ValueError(f'Unknown lap_type {lap_type!r}')


def partition_graph(W, n_shards: int, lap_type: str = 'combinatorial',
                    reorder: str = 'rcm', balance: str = 'nnz',
                    dtype=None, *, device='cuda') -> ShardedGraph:
    """Partition a symmetric scipy adjacency into a :class:`ShardedGraph`.

    reorder: 'rcm' (reverse Cuthill–McKee), 'none' (keep order), 'cluster'
    (community clustering via :func:`cluster_shards`; shard boundaries then
    follow the clusters and ``balance`` is ignored).

    balance: 'nnz' splits the (reordered) vertex sequence at degree-
    weighted boundaries so every shard owns ~nnz/S edges; 'vertex' is the
    plain equal-vertex-count split. Shards own contiguous vertex ranges,
    each padded to a common ``n_local``, with a seeded shuffle inside each
    shard (hub rows spread over the windows of the windowed layout).

    ``dtype``: the values' (numpy or torch; default float32). The tensors
    go to ``device``.

    Examples
    --------
    >>> from pygsp_tpu_torch import graphs
    >>> from pygsp_tpu_torch.parallel import partition_graph
    >>> G = graphs.Sensor(64, seed=42, device='cpu')
    >>> sg = partition_graph(G.W, 4, device='cpu')
    >>> sg.n_shards, sg.n_local * 4 >= G.N
    (4, True)
    >>> sg.halo_total > 0                # remote rows each shard receives
    True
    """
    device = check_device(device, 'partition_graph')
    W = sps.csr_matrix(W)
    N = W.shape[0]
    dtype = _np_dtype(dtype)

    cluster_bounds = None
    if reorder == 'rcm':
        order = sps.csgraph.reverse_cuthill_mckee(W, symmetric_mode=True)
    elif reorder == 'none':
        order = np.arange(N)
    elif reorder == 'cluster':
        labels = cluster_shards(W, n_shards)
        order = np.argsort(labels, kind='stable')
        cluster_bounds = np.concatenate(
            [[0], np.cumsum(np.bincount(labels, minlength=n_shards))]
        ).astype(np.int64)
    else:
        raise ValueError(f'Unknown reorder {reorder!r}')
    Wp = W[order][:, order].tocsr()

    deg_rank = np.diff(Wp.indptr)
    if cluster_bounds is not None:
        bounds = cluster_bounds
    elif balance == 'nnz' and deg_rank.sum() > 0:
        cum = np.cumsum(deg_rank + 1)
        targets = cum[-1] / n_shards * np.arange(1, n_shards)
        bounds = np.searchsorted(cum, targets, side='left')
        bounds = np.concatenate([[0], bounds, [N]]).astype(np.int64)
        bounds = np.maximum.accumulate(bounds)
    elif balance in ('vertex', 'nnz'):
        even = int(np.ceil(N / n_shards))
        bounds = np.minimum(np.arange(n_shards + 1) * even, N)
    else:
        raise ValueError(f'Unknown balance {balance!r}')
    range_len = np.diff(bounds)
    n_local = max(_round_up(int(range_len.max()), 8), 8)
    n_pad = n_shards * n_local

    # rank -> padded slot, with the JAX package's seeded within-shard
    # shuffle (its draws, in its order)
    shard_of_rank = np.searchsorted(bounds, np.arange(N), side='right') - 1
    sh_rng = np.random.default_rng(0x5EED)
    local_pos = np.empty(N, dtype=np.int64)
    for s in range(n_shards):
        local_pos[bounds[s]:bounds[s + 1]] = sh_rng.permutation(
            n_local)[:range_len[s]]
    pos_of_rank = shard_of_rank * n_local + local_pos
    perm = np.empty(N, dtype=np.int64)
    perm[order] = pos_of_rank

    coo, vals_all, diag_all = _laplacian_entries(Wp, lap_type, dtype)
    rows_all = pos_of_rank[coo.row]
    cols_all = pos_of_rank[coo.col]
    shard_of = rows_all // n_local

    per = []
    halo_ids = []
    for s in range(n_shards):
        msk = shard_of == s
        r = rows_all[msk] - s * n_local
        c = cols_all[msk]
        v = vals_all[msk]
        srt = np.argsort(r, kind='stable')
        r, c, v = r[srt], c[srt], v[srt]
        is_local = (c >= s * n_local) & (c < (s + 1) * n_local)
        per.append((r, c, v, is_local))
        halo_ids.append(np.unique(c[~is_local]))

    pair_counts = np.zeros((n_shards, n_shards), dtype=np.int64)
    for s in range(n_shards):
        if len(halo_ids[s]):
            pair_counts[:, s] = np.bincount(halo_ids[s] // n_local,
                                            minlength=n_shards)
    dist_max = np.zeros(n_shards, dtype=np.int64)
    for src in range(n_shards):
        for dst in range(n_shards):
            if pair_counts[src, dst]:
                dist_max[(dst - src) % n_shards] = max(
                    dist_max[(dst - src) % n_shards], pair_counts[src, dst])
    halo_dists = tuple(int(d) for d in np.flatnonzero(dist_max))
    halo_sizes = tuple(max(_round_up(int(dist_max[d]), 8), 8)
                       for d in halo_dists)
    k_of_dist = {d: k for k, d in enumerate(halo_dists)}
    offsets = np.concatenate([[0], np.cumsum(halo_sizes)]).astype(np.int64)

    E = max((len(p_[0]) for p_ in per), default=0)
    E = max(_round_up(E, 1024), 1024)
    rows_arr = np.full((n_shards, E), n_local, dtype=np.int32)
    cols_arr = np.zeros((n_shards, E), dtype=np.int32)
    vals_arr = np.zeros((n_shards, E), dtype=dtype)
    send_arrs = [np.full((n_shards, h), n_local, dtype=np.int32)
                 for h in halo_sizes]

    for s in range(n_shards):
        r, c, v, is_local = per[s]
        remote = halo_ids[s]
        c_ext = np.where(is_local, c - s * n_local, 0)
        if len(remote):
            src = remote // n_local
            group_start = np.searchsorted(src, np.arange(n_shards))
            j = np.arange(len(remote)) - group_start[src]
            k = np.array([k_of_dist[(s - sr) % n_shards] for sr in src],
                         dtype=np.int64)
            slot = n_local + offsets[k] + j
            ridx = np.searchsorted(remote, c[~is_local])
            c_ext[~is_local] = slot[ridx]
            for kk in np.unique(k):
                m = k == kk
                send_arrs[kk][src[m], j[m]] = remote[m] - src[m] * n_local
        ne = len(r)
        rows_arr[s, :ne] = r
        cols_arr[s, :ne] = c_ext
        vals_arr[s, :ne] = v

    flat = np.zeros(n_pad, dtype=dtype)
    flat[pos_of_rank] = diag_all
    diag_arr = flat.reshape(n_shards, n_local)

    return ShardedGraph(
        rows=_tensor(rows_arr, device), cols=_tensor(cols_arr, device),
        vals=_tensor(vals_arr, device), diag=_tensor(diag_arr, device),
        send_idx=tuple(_tensor(a, device) for a in send_arrs),
        perm=_tensor(perm, device, np.int32),
        n_shards=n_shards, n_local=n_local, halo_dists=halo_dists,
        halo_sizes=halo_sizes, n_vertices=N, lap_type=lap_type)


@dataclasses.dataclass(frozen=True)
class ShardedELL:
    """Per-shard multi-level ELL of the local (extended-column) edges.

    The layout of the port's :class:`~pygsp_tpu_torch.core.sparse.ELLMatrix`
    with a leading shard axis and a level structure shared across shards:
    shards with fewer overflow rows pad with sentinel rows (``n_local``).
    Column ids live in the extended-local space ``[0, n_local +
    halo_total)``; sentinel slots point one past it.
    :meth:`local_matrix` is one shard's slice as an ``ELLMatrix`` for the
    ELL SpMM kernel.
    """

    ell_cols: torch.Tensor       # (S, n_local, w0)
    ell_vals: torch.Tensor       # (S, n_local, w0)
    lvl_rows: tuple              # per level: (S, R) int32, sentinel n_local
    lvl_cols: tuple              # per level: (S, R, w)
    lvl_vals: tuple
    ell_width: int

    def local_matrix(self, n_cols: int) -> sp.ELLMatrix:
        """This (one-shard) slice as an :class:`ELLMatrix` over ``n_cols``
        columns: slots at or past ``n_cols`` (the sentinels) dead, sentinel
        level rows dropped; built once and kept."""
        return _cached(self, ('ell', n_cols), lambda: _ell_local(self,
                                                                 n_cols))


def _ell_local(e: ShardedELL, n_ext: int):
    ec = _host(e.ell_cols[0]).astype(np.int64)
    n_local, width = ec.shape
    ev = _host(e.ell_vals[0])

    def fix(c):
        return np.where(c >= n_ext, n_ext, c).astype(np.int32)

    levels, nnz = [], int((ec < n_ext).sum())
    for lr, lc, lv in zip(e.lvl_rows, e.lvl_cols, e.lvl_vals):
        r = _host(lr[0]).astype(np.int64)
        keep = r < n_local
        c = _host(lc[0])[keep].astype(np.int64)
        levels.append((r[keep].astype(np.int32), fix(c), _host(lv[0])[keep]))
        nnz += int((c < n_ext).sum())
    n_pad = max(_round_up(n_local, sp.ROW_BLOCK), sp.ROW_BLOCK)
    cols0 = np.full((n_pad, width), n_ext, np.int32)
    vals0 = np.zeros((n_pad, width), ev.dtype)
    cols0[:n_local] = fix(ec)
    vals0[:n_local] = ev
    counts = (cols0[:n_local] < n_ext).sum(axis=1)
    for r, c, _ in levels:
        np.add.at(counts, r, (c < n_ext).sum(axis=1))
    rowptr = np.zeros(n_local + 1, np.int32)
    np.cumsum(counts, out=rowptr[1:])
    return sp._ell_upload(cols0, vals0, [lev for lev in levels if len(lev[0])],
                          rowptr, n_local, n_ext, nnz, width,
                          e.ell_vals.device)


def _split_coo(sg: ShardedGraph, mask):
    """``sg`` with only the edges where ``mask`` holds, each shard's kept
    edges first (stably row-sorted), the rest turned into padding rows."""
    n_local = sg.n_local
    rows, cols, vals = _host(sg.rows), _host(sg.cols), _host(sg.vals)
    r = np.where(mask, rows, n_local)
    out_rows = np.empty_like(rows)
    out_cols = np.empty_like(cols)
    out_vals = np.empty_like(vals)
    for s_ in range(rows.shape[0]):
        order = np.argsort(r[s_], kind='stable')
        out_rows[s_] = r[s_][order]
        out_cols[s_] = cols[s_][order]
        out_vals[s_] = vals[s_][order]
    dev = sg.device
    return dataclasses.replace(sg, rows=_tensor(out_rows, dev),
                               cols=_tensor(out_cols, dev),
                               vals=_tensor(out_vals, dev))


def shard_local_ell(sg: ShardedGraph, width: int | None = None,
                    level_factor: int = 2, split_boundary: bool = False):
    """Convert a ShardedGraph's per-shard COO into stacked multi-level ELL.

    With ``split_boundary=True``, returns ``(interior, boundary)``: the
    interior ELL references only owned vertices (cols < n_local) and the
    boundary ELL only halo slots, so the interior product needs nothing
    from the halo exchange. Otherwise returns one combined ELL. The
    tensors stay on the partition's device.
    """
    if split_boundary:
        rows, cols = _host(sg.rows), _host(sg.cols)
        interior_mask = cols < sg.n_local
        real = rows < sg.n_local
        return (shard_local_ell(_split_coo(sg, interior_mask & real), width,
                                level_factor),
                shard_local_ell(_split_coo(sg, ~interior_mask & real), width,
                                level_factor))

    rows, cols, vals = _host(sg.rows), _host(sg.cols), _host(sg.vals)
    S = rows.shape[0]
    n_local = sg.n_local
    n_ext = n_local + sg.halo_total

    degs = np.stack([np.bincount(rows[s][rows[s] < n_local],
                                 minlength=n_local) for s in range(S)])
    nnz_total = int(degs.sum())
    if width is None:
        mean = max(1, int(np.ceil(nnz_total / max(S * n_local, 1))))
        width = max(_round_up(mean, 8), 8)
    maxdeg = int(degs.max()) if degs.size else 0

    bases, widths = [], []
    base, w = width, max(_round_up(width, 8), 8)
    while base < maxdeg:
        w = min(w, max(_round_up(maxdeg - base, 8), 8))
        bases.append(base)
        widths.append(w)
        base += w
        w = max(_round_up(w * level_factor, 8), 8)

    lvl_row_counts = [max(int((degs > b).sum(axis=1).max()), 1)
                      for b in bases]

    ell_cols = np.full((S, n_local, width), n_ext, dtype=np.int32)
    ell_vals = np.zeros((S, n_local, width), dtype=vals.dtype)
    lvl_rows = [np.full((S, r), n_local, np.int32) for r in lvl_row_counts]
    lvl_cols = [np.full((S, r, w), n_ext, np.int32)
                for r, w in zip(lvl_row_counts, widths)]
    lvl_vals = [np.zeros((S, r, w), vals.dtype)
                for r, w in zip(lvl_row_counts, widths)]

    for s in range(S):
        real = rows[s] < n_local
        r, c, v = rows[s][real], cols[s][real], vals[s][real]
        order = np.argsort(r, kind='stable')
        r, c, v = r[order], c[order], v[order]
        rowptr = np.zeros(n_local + 1, np.int64)
        np.cumsum(np.bincount(r, minlength=n_local), out=rowptr[1:])
        deg = degs[s]

        def pack(row_subset, b, w):
            starts = rowptr[row_subset] + b
            ends = rowptr[row_subset + 1]
            idx = starts[:, None] + np.arange(w)[None, :]
            valid = idx < ends[:, None]
            idx = np.minimum(idx, max(len(r) - 1, 0))
            pc = np.where(valid, c[idx], n_ext).astype(np.int32)
            pv = np.where(valid, v[idx], 0).astype(vals.dtype)
            return pc, pv

        if len(r):
            pc, pv = pack(np.arange(n_local), 0, width)
            ell_cols[s], ell_vals[s] = pc, pv
        for li, (b, w) in enumerate(zip(bases, widths)):
            lr = np.flatnonzero(deg > b)
            if not len(lr):
                continue
            pc, pv = pack(lr, b, w)
            lvl_rows[li][s, :len(lr)] = lr
            lvl_cols[li][s, :len(lr)] = pc
            lvl_vals[li][s, :len(lr)] = pv

    dev = sg.device
    return ShardedELL(
        ell_cols=_tensor(ell_cols, dev), ell_vals=_tensor(ell_vals, dev),
        lvl_rows=tuple(_tensor(a, dev) for a in lvl_rows),
        lvl_cols=tuple(_tensor(a, dev) for a in lvl_cols),
        lvl_vals=tuple(_tensor(a, dev) for a in lvl_vals),
        ell_width=width)
