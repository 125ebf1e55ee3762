"""Carry operators across from the JAX package.

The operators are this system's state: a graph's Laplacian, held by the
JAX package as pytrees of arrays plus static ints. These functions take
those leaves as numpy arrays (``np.asarray`` of each JAX leaf) and the
ints, and build the port's :class:`CSRMatrix`, :class:`ELLMatrix`,
:class:`BandedMatrix`, :class:`ChunkedELLMatrix`,
:class:`WindowedELLMatrix` and :class:`LaplacianOp` on ``device``, a
graph's difference operator (``G.D``) from its edge arrays, and the
multi-device engines' partitions and local layouts (``ShardedGraph``,
``ShardedELL``, ``ShardedWindowed``, ``TwoDGraph``) from theirs. Nothing
here imports JAX. The kernels read without bounds checks, so leaves from
outside are checked first.

Example::

    L = laplacian_from_numpy({
        'offdiag': {'rows': ..., 'cols': ..., 'vals': ..., 'rowptr': ...,
                    'n_rows': n, 'n_cols': n, 'nnz': nnz},
        'diag': ..., 'lap_type': 'combinatorial'}, device='cuda')
"""

from __future__ import annotations

import numpy as np
import torch

from pygsp_tpu_torch.core import chunked, sparse, windowed
from pygsp_tpu_torch.core.chunked import ChunkedELLMatrix, ChunkLevel
from pygsp_tpu_torch.core.operators import LaplacianOp
from pygsp_tpu_torch.core.sparse import BandedMatrix, CSRMatrix, ELLMatrix
from pygsp_tpu_torch.core.windowed import WindowedELLMatrix


def _tensor(a, device, dtype=None):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)


def _check_csr(leaves: dict):
    """The CSR kernel reads x at ``cols[rowptr[0]:rowptr[-1]]`` without
    bounds checks, so leaves from outside are checked here."""
    rowptr = np.asarray(leaves['rowptr'])
    cols = np.asarray(leaves['cols'])
    n_rows, n_cols, nnz = (int(leaves[k]) for k in ('n_rows', 'n_cols', 'nnz'))
    if rowptr.shape != (n_rows + 1,) or rowptr[0] != 0 or rowptr[-1] != nnz:
        raise ValueError(f'rowptr must have {n_rows + 1} entries from 0 to '
                         f'nnz = {nnz}')
    if np.any(np.diff(rowptr) < 0):
        raise ValueError('rowptr must not decrease')
    if cols.shape != np.shape(leaves['vals']) or cols.shape[0] < nnz:
        raise ValueError('cols and vals must have one length, at least nnz')
    if nnz and (cols[:nnz].min() < 0 or cols[:nnz].max() >= n_cols):
        raise ValueError(f'cols out of range for {n_cols} columns')


def csr_from_numpy(leaves: dict, device='cuda') -> CSRMatrix:
    """CSR leaves ``rows, cols, vals, rowptr, n_rows, n_cols, nnz``."""
    _check_csr(leaves)
    return CSRMatrix(
        rows=_tensor(leaves['rows'], device, np.int32),
        cols=_tensor(leaves['cols'], device, np.int32),
        vals=_tensor(leaves['vals'], device),
        rowptr=_tensor(leaves['rowptr'], device, np.int32),
        n_rows=int(leaves['n_rows']), n_cols=int(leaves['n_cols']),
        nnz=int(leaves['nnz']))


def banded_from_numpy(leaves: dict, device='cuda') -> BandedMatrix:
    """Banded leaves ``tiles, n_rows, n_cols, nnz, half_bw``."""
    return BandedMatrix(
        tiles=_tensor(leaves['tiles'], device),
        n_rows=int(leaves['n_rows']), n_cols=int(leaves['n_cols']),
        nnz=int(leaves['nnz']), half_bw=int(leaves['half_bw']))


_WINDOWED_INTS = ('n_rows', 'n_cols', 'nnz', 'chunk_rows', 'window_rows',
                  'borrow_span')


def _check_local_cols(cols, src_chunk, R, n_cols, what):
    """Slot columns local to a source chunk: the sentinel ``R`` or a row of
    the chunk (``c·R + col < n_cols``); ``src_chunk`` broadcasts to cols."""
    if cols.size and (cols.min() < 0 or cols.max() > R):
        raise ValueError(f'{what} cols must lie in [0, chunk_rows = {R}]')
    if np.any((cols < R) & (src_chunk * R + cols >= n_cols)):
        raise ValueError(f'{what} cols out of range for {n_cols} columns')


def _check_windowed(leaves: dict, levels):
    n_rows, n_cols, _, R, P, K = (int(leaves[k]) for k in _WINDOWED_INTS)
    cols = np.asarray(leaves['cols'])
    if (cols.ndim != 4 or np.shape(leaves['vals']) != cols.shape
            or np.shape(leaves['rowid']) != cols.shape):
        raise ValueError('cols, vals and rowid must be (n_out, NW, n_src, L) '
                         'slabs of one shape')
    n_out, nw, n_src = cols.shape[:3]
    if P < 1 or K < 2 or R != nw * P:
        raise ValueError(f'chunk_rows = {R} must be NW·window_rows = '
                         f'{nw}·{P}, with borrow_span = {K} >= 2')
    if (n_out, n_src) != (max(-(-n_rows // R), 1), max(-(-n_cols // R), 1)):
        raise ValueError(f'{n_out} out and {n_src} source chunks of {R} rows '
                         f'do not cover a ({n_rows}, {n_cols}) matrix')
    _check_local_cols(cols, np.arange(n_src)[:, None], R, n_cols, 'slab')
    rowid = np.asarray(leaves['rowid'])
    if rowid.size and (rowid.min() < 0 or rowid.max() >= K * P):
        raise ValueError(f'rowid must lie in [0, borrow_span·window_rows = '
                         f'{K * P})')
    level_rows = np.asarray(leaves['level_rows'])
    if level_rows.shape != (sum(lev.cols.shape[0] for lev in levels),):
        raise ValueError('level_rows must hold one row per tier entry')
    if level_rows.size and (level_rows.min() < 0
                            or level_rows.max() >= n_rows):
        raise ValueError(f'level_rows out of range for {n_rows} rows')
    for lev in levels:
        if (lev.cols.ndim != 2 or lev.vals.shape != lev.cols.shape
                or not 0 <= lev.src_chunk < n_src):
            raise ValueError('each level needs 2-D cols and vals of one shape '
                             'and a src_chunk among the source chunks')
        _check_local_cols(lev.cols, lev.src_chunk, R, n_cols, 'level')
    if np.shape(leaves['rowptr']) != (n_rows + 1,):
        raise ValueError(f'rowptr must have {n_rows + 1} entries')
    _check_perm(leaves, n_rows, n_cols)


def _check_perm(leaves, n_rows, n_cols):
    perm, iperm = leaves.get('perm'), leaves.get('iperm')
    if (perm is None) != (iperm is None):
        raise ValueError('perm and iperm come together')
    if perm is not None:
        perm, iperm = np.asarray(perm), np.asarray(iperm)
        if (n_rows != n_cols or perm.shape != (n_rows,)
                or iperm.shape != (n_rows,)
                or not np.array_equal(np.sort(perm), np.arange(n_rows))
                or not np.array_equal(iperm[perm], np.arange(n_rows))):
            raise ValueError('perm must be a permutation of the vertices of '
                             'a square matrix and iperm its inverse')


def windowed_from_numpy(leaves: dict, device='cuda') -> WindowedELLMatrix:
    """Windowed leaves ``cols, vals, rowid`` (the slabs), ``levels`` (a list
    of ``{cols, vals, src_chunk}``), ``level_rows, rowptr, perm, iperm``
    (``perm``/``iperm`` may be None) and the ints ``n_rows, n_cols, nnz,
    chunk_rows, window_rows, borrow_span``. ``uint8`` row ids stay so,
    wider ones become ``int32``."""
    levels = [ChunkLevel(cols=np.asarray(lev['cols']),
                         vals=np.asarray(lev['vals']),
                         src_chunk=int(lev['src_chunk']))
              for lev in leaves['levels']]
    _check_windowed(leaves, levels)
    host = {k: leaves.get(k) for k in ('cols', 'vals', 'rowid', 'level_rows',
                                       'rowptr', 'perm', 'iperm')}
    host.update({k: leaves[k] for k in _WINDOWED_INTS}, levels=levels)
    return windowed.upload(host, device)


_ELL_INTS = ('n_rows', 'n_cols', 'nnz', 'ell_width')


def _check_rows(rows, n_rows, what):
    if rows.size and (rows.min() < 0 or rows.max() >= n_rows):
        raise ValueError(f'{what} out of range for {n_rows} rows')


def ell_from_numpy(leaves: dict, device='cuda') -> ELLMatrix:
    """ELL leaves ``ell_cols, ell_vals`` (level 0, (n_pad, ell_width)),
    ``levels`` (a list of ``{rows, cols, vals}``), ``rowptr`` and the ints
    ``n_rows, n_cols, nnz, ell_width``. The kernel's slot table and residue
    list are made as at a build."""
    n_rows, n_cols, nnz, width = (int(leaves[k]) for k in _ELL_INTS)
    c0 = np.asarray(leaves['ell_cols'])
    if (c0.ndim != 2 or c0.shape[1] != width or c0.shape[0] < n_rows
            or np.shape(leaves['ell_vals']) != c0.shape):
        raise ValueError(f'ell_cols and ell_vals must be (n_pad >= {n_rows}, '
                         f'ell_width = {width}) of one shape')
    levels = [tuple(np.asarray(lev[k]) for k in ('rows', 'cols', 'vals'))
              for lev in leaves['levels']]
    for cols in [c0] + [c for _, c, _ in levels]:
        if cols.size and (cols.min() < 0 or cols.max() > n_cols):
            raise ValueError(f'ELL cols must lie in [0, n_cols = {n_cols}]')
    for rows, cols, vals in levels:
        if (rows.ndim != 1 or cols.ndim != 2 or cols.shape[0] != rows.size
                or vals.shape != cols.shape):
            raise ValueError('each level needs 1-D rows and (rows, w) cols '
                             'and vals')
        _check_rows(rows, n_rows, 'level rows')
        if np.unique(rows).size != rows.size:
            raise ValueError('each level\'s rows must be unique')
    if np.shape(leaves['rowptr']) != (n_rows + 1,):
        raise ValueError(f'rowptr must have {n_rows + 1} entries')
    return sparse._ell_upload(c0, np.asarray(leaves['ell_vals']), levels,
                              np.asarray(leaves['rowptr'], np.int32), n_rows,
                              n_cols, nnz, width, device)


_CHUNKED_INTS = ('n_rows', 'n_cols', 'nnz', 'chunk_rows')


def chunked_from_numpy(leaves: dict, device='cuda') -> ChunkedELLMatrix:
    """Chunked leaves ``blocks`` (a list of ``{cols, vals}``),
    ``block_keys`` (a list of (out_chunk, src_chunk)), ``levels`` (a list of
    ``{cols, vals, src_chunk}``), ``level_rows, rowptr, perm, iperm``
    (``perm``/``iperm`` may be None) and the ints ``n_rows, n_cols, nnz,
    chunk_rows``. Every slot column must lie in ``[0, src_chunk_size]``
    (the sentinel is the chunk's size)."""
    n_rows, n_cols, _, R = (int(leaves[k]) for k in _CHUNKED_INTS)
    if R < 1:
        raise ValueError(f'chunk_rows must be positive, got {R}')
    n_out, n_src = max(-(-n_rows // R), 1), max(-(-n_cols // R), 1)
    keys = [tuple(int(v) for v in k) for k in leaves['block_keys']]
    blocks = [(np.asarray(b['cols']), np.asarray(b['vals']))
              for b in leaves['blocks']]
    levels = [ChunkLevel(cols=np.asarray(lev['cols']),
                         vals=np.asarray(lev['vals']),
                         src_chunk=int(lev['src_chunk']))
              for lev in leaves['levels']]

    def check_cols(cols, c, what):
        size = min(R, n_cols - c * R)
        if cols.size and (cols.min() < 0 or cols.max() > size):
            raise ValueError(f'{what} cols must lie in [0, {size}], the '
                             f'size of source chunk {c}')

    if len(keys) != len(blocks) or len(set(keys)) != len(keys):
        raise ValueError('blocks and block_keys must pair up, one block a '
                         'key')
    for (i, c), (cols, vals) in zip(keys, blocks):
        if not (0 <= i < n_out and 0 <= c < n_src):
            raise ValueError(f'block key {(i, c)} outside the {n_out} x '
                             f'{n_src} chunks')
        if (cols.ndim != 2 or cols.shape[0] != min(R, n_rows - i * R)
                or vals.shape != cols.shape):
            raise ValueError(f'block {(i, c)} must hold (rows of out chunk '
                             f'{i}, w) cols and vals of one shape')
        check_cols(cols, c, f'block {(i, c)}')
    for lev in levels:
        if (lev.cols.ndim != 2 or lev.vals.shape != lev.cols.shape
                or not 0 <= lev.src_chunk < n_src):
            raise ValueError('each level needs 2-D cols and vals of one shape '
                             'and a src_chunk among the source chunks')
        check_cols(lev.cols, lev.src_chunk, 'level')
    level_rows = np.asarray(leaves['level_rows'])
    if level_rows.shape != (sum(lev.cols.shape[0] for lev in levels),):
        raise ValueError('level_rows must hold one row per tier entry')
    _check_rows(level_rows, n_rows, 'level_rows')
    if np.shape(leaves['rowptr']) != (n_rows + 1,):
        raise ValueError(f'rowptr must have {n_rows + 1} entries')
    _check_perm(leaves, n_rows, n_cols)
    host = {k: leaves.get(k) for k in ('level_rows', 'rowptr', 'perm',
                                       'iperm')}
    host.update({k: leaves[k] for k in _CHUNKED_INTS}, blocks=blocks,
                block_keys=keys, levels=levels)
    return chunked.upload(host, device)


def laplacian_from_numpy(leaves: dict, device='cuda') -> LaplacianOp:
    """``{'offdiag': <CSR, ELL, banded, chunked or windowed leaves>, 'diag':
    array, 'lap_type': str}`` → :class:`LaplacianOp`. The off-diagonal
    format is told by its leaves: ELL ones have ``ell_cols``, banded ones
    ``tiles``, chunked ones ``block_keys``, windowed ones ``rowid``."""
    off = leaves['offdiag']
    if 'ell_cols' in off:
        offdiag = ell_from_numpy(off, device)
    elif 'block_keys' in off:
        offdiag = chunked_from_numpy(off, device)
    elif 'tiles' in off:
        offdiag = banded_from_numpy(off, device)
    elif 'rowid' in off:
        offdiag = windowed_from_numpy(off, device)
    else:
        offdiag = csr_from_numpy(off, device)
    return LaplacianOp(offdiag=offdiag, diag=_tensor(leaves['diag'], device),
                       lap_type=str(leaves['lap_type']))


def difference_from_numpy(leaves: dict, device='cuda'):
    """A difference operator (``Graph.D``) from the JAX package's
    ``_DifferenceOp`` leaves: ``sources, targets`` (vertex ids), ``v_src,
    v_tgt`` (the values at each end of each edge, whose dtype it keeps)
    and the int ``n_vertices``. The kernel gathers x rows at the edge ends
    without bounds checks, so the ids are checked here."""
    from pygsp_tpu_torch.graphs.graph import _DifferenceOp
    n = int(leaves['n_vertices'])
    arrays = [np.asarray(leaves[k])
              for k in ('sources', 'targets', 'v_src', 'v_tgt')]
    if any(a.ndim != 1 or a.shape != arrays[0].shape for a in arrays):
        raise ValueError('sources, targets, v_src and v_tgt must be 1-D, '
                         'of one length')
    sources, targets, v_src, v_tgt = arrays
    for ids in (sources, targets):
        if ids.size and (ids.min() < 0 or ids.max() >= n):
            raise ValueError(f'edge ends out of range for {n} vertices')
    return _DifferenceOp(n, sources, targets, v_src, v_tgt, device=device,
                         dtype=torch.from_numpy(v_src[:0]).dtype)


# ---------------------------------------------------------------------------
# the multi-device engines' partitions and local layouts
# ---------------------------------------------------------------------------

def _ints(leaves, names):
    return {k: int(leaves[k]) for k in names}


def _check_edges(rows, cols, vals, n_rows, n_cols, lead, what):
    """Stacked padded edges ``(lead, E)``: rows in ``[0, n_rows]``
    (``n_rows`` is padding), real edges' cols in ``[0, n_cols)``."""
    if (rows.ndim != 2 or rows.shape[0] != lead or cols.shape != rows.shape
            or vals.shape != rows.shape):
        raise ValueError(f'{what} rows, cols and vals must be ({lead}, E) of '
                         f'one shape')
    if rows.size and (rows.min() < 0 or rows.max() > n_rows):
        raise ValueError(f'{what} rows must lie in [0, {n_rows}]')
    real = rows < n_rows
    if np.any(real & ((cols < 0) | (cols >= n_cols))):
        raise ValueError(f'{what} cols out of range for {n_cols} columns')


def _check_vertex_perm(perm, n, n_padded):
    perm = np.asarray(perm)
    if (perm.shape != (n,) or (perm.size and (perm.min() < 0
                                              or perm.max() >= n_padded))
            or np.unique(perm).size != n):
        raise ValueError(f'perm must send the {n} vertices to distinct '
                         f'places of the {n_padded} padded ones')


def sharded_graph_from_numpy(leaves: dict, device='cuda'):
    """ShardedGraph leaves ``rows, cols, vals, diag`` ((S, E), (S, E),
    (S, E), (S, n_local)), ``send_idx`` (a list of (S, H_d)), ``perm`` and
    the ints ``n_shards, n_local, n_vertices``, the tuples ``halo_dists,
    halo_sizes`` and ``lap_type``."""
    from pygsp_tpu_torch.parallel.partition import ShardedGraph
    meta = _ints(leaves, ('n_shards', 'n_local', 'n_vertices'))
    S, n = meta['n_shards'], meta['n_local']
    dists = tuple(int(d) for d in leaves['halo_dists'])
    sizes = tuple(int(h) for h in leaves['halo_sizes'])
    rows, cols, vals = (np.asarray(leaves[k]) for k in ('rows', 'cols',
                                                        'vals'))
    _check_edges(rows, cols, vals, n, n + sum(sizes), S, 'ShardedGraph')
    if np.shape(leaves['diag']) != (S, n):
        raise ValueError(f'diag must be ({S}, {n})')
    send = [np.asarray(a) for a in leaves['send_idx']]
    if len(send) != len(dists) or len(sizes) != len(dists) or any(
            not 0 < d < S for d in dists):
        raise ValueError('send_idx, halo_dists and halo_sizes must pair up, '
                         'each distance in [1, n_shards)')
    for a, h in zip(send, sizes):
        if a.shape != (S, h) or (a.size and (a.min() < 0 or a.max() > n)):
            raise ValueError(f'each send_idx must be ({S}, H_d) local ids in '
                             f'[0, n_local = {n}]')
    _check_vertex_perm(leaves['perm'], meta['n_vertices'], S * n)
    return ShardedGraph(
        rows=_tensor(rows, device, np.int32),
        cols=_tensor(cols, device, np.int32), vals=_tensor(vals, device),
        diag=_tensor(leaves['diag'], device),
        send_idx=tuple(_tensor(a, device, np.int32) for a in send),
        perm=_tensor(leaves['perm'], device, np.int32), halo_dists=dists,
        halo_sizes=sizes, lap_type=str(leaves['lap_type']), **meta)


def sharded_ell_from_numpy(leaves: dict, n_cols: int, device='cuda'):
    """ShardedELL leaves ``ell_cols, ell_vals`` ((S, n_local, w0)),
    ``lvl_rows, lvl_cols, lvl_vals`` (lists of (S, R), (S, R, w)) and the
    int ``ell_width``, for the extended space of ``n_cols`` columns (the
    partition's ``n_local + halo_total``; ``n_cols`` is the sentinel)."""
    from pygsp_tpu_torch.parallel.partition import ShardedELL
    c0 = np.asarray(leaves['ell_cols'])
    width = int(leaves['ell_width'])
    if (c0.ndim != 3 or c0.shape[2] != width
            or np.shape(leaves['ell_vals']) != c0.shape):
        raise ValueError(f'ell_cols and ell_vals must be (S, n_local, '
                         f'{width}) of one shape')
    S, n = c0.shape[:2]
    parts = [[np.asarray(a) for a in leaves[k]]
             for k in ('lvl_rows', 'lvl_cols', 'lvl_vals')]
    for cols in [c0] + parts[1]:
        if cols.size and (cols.min() < 0 or cols.max() > n_cols):
            raise ValueError(f'ELL cols must lie in [0, n_cols = {n_cols}]')
    for r, c, v in zip(*parts):
        if (r.ndim != 2 or r.shape[0] != S or c.shape[:2] != r.shape
                or v.shape != c.shape):
            raise ValueError('each level needs (S, R) rows and (S, R, w) '
                             'cols and vals')
        if r.size and (r.min() < 0 or r.max() > n):
            raise ValueError(f'level rows must lie in [0, n_local = {n}]')
    return ShardedELL(
        ell_cols=_tensor(c0, device, np.int32),
        ell_vals=_tensor(leaves['ell_vals'], device),
        lvl_rows=tuple(_tensor(a, device, np.int32) for a in parts[0]),
        lvl_cols=tuple(_tensor(a, device, np.int32) for a in parts[1]),
        lvl_vals=tuple(_tensor(a, device) for a in parts[2]),
        ell_width=width)


_SHARDED_WINDOWED_INTS = ('n_local', 'n_ext', 'nnz', 'chunk_rows',
                          'window_rows', 'borrow_span')


def sharded_windowed_from_numpy(leaves: dict, device='cuda'):
    """ShardedWindowed leaves ``cols, vals, rowid`` ((S, n_out, NW, n_src,
    L)), ``lvl_cols, lvl_vals`` (lists of (S, m, w)), ``level_rows`` ((S,
    M), the sentinel ``n_out·NW·P`` for padding), ``lvl_src`` and the ints
    ``n_local, n_ext, nnz, chunk_rows, window_rows, borrow_span``; each
    shard is checked as :func:`windowed_from_numpy` checks a matrix."""
    from pygsp_tpu_torch.parallel.windowed_shards import ShardedWindowed
    meta = _ints(leaves, _SHARDED_WINDOWED_INTS)
    cols = np.asarray(leaves['cols'])
    if cols.ndim != 5:
        raise ValueError('cols, vals and rowid must be (S, n_out, NW, n_src, '
                         'L) slabs')
    src = tuple(int(c) for c in leaves['lvl_src'])
    lc = [np.asarray(a) for a in leaves['lvl_cols']]
    lv = [np.asarray(a) for a in leaves['lvl_vals']]
    level_rows = np.asarray(leaves['level_rows'])
    n_out, nw = cols.shape[1:3]
    sentinel = n_out * nw * meta['window_rows']
    if len(lc) != len(src) or len(lv) != len(src):
        raise ValueError('lvl_cols, lvl_vals and lvl_src must pair up')
    for s in range(cols.shape[0]):
        rows_s = level_rows[s] if level_rows.ndim == 2 else level_rows
        keep = rows_s < sentinel
        off, levels = 0, []
        for c, v, k in zip(lc, lv, src):
            m = c.shape[1]
            levels.append(ChunkLevel(cols=c[s], vals=v[s], src_chunk=k))
            off += m
        if level_rows.shape != (cols.shape[0], off):
            raise ValueError('level_rows must hold one row per tier entry '
                             'of each shard')
        one = {'cols': cols[s], 'vals': np.asarray(leaves['vals'])[s],
               'rowid': np.asarray(leaves['rowid'])[s],
               'level_rows': np.where(keep, rows_s, 0),
               'rowptr': np.zeros(meta['n_local'] + 1),
               'n_rows': meta['n_local'], 'n_cols': meta['n_ext'],
               'nnz': meta['nnz'], 'chunk_rows': meta['chunk_rows'],
               'window_rows': meta['window_rows'],
               'borrow_span': meta['borrow_span']}
        _check_windowed(one, levels)
    rowid = np.asarray(leaves['rowid'])
    return ShardedWindowed(
        cols=_tensor(cols, device, np.int32),
        vals=chunked._tensor(leaves['vals'], device),
        rowid=_tensor(rowid, device,
                      np.uint8 if rowid.dtype == np.uint8 else np.int32),
        lvl_cols=tuple(_tensor(a, device, np.int32) for a in lc),
        lvl_vals=tuple(chunked._tensor(a, device) for a in lv),
        level_rows=_tensor(level_rows, device, np.int32), lvl_src=src,
        **meta)


def twod_graph_from_numpy(leaves: dict, device='cuda'):
    """TwoDGraph leaves ``rows, cols, vals`` ((P, E)), ``diag`` ((P,
    n_local)), ``perm`` and the ints ``pr, pc, n_local, n_vertices`` and
    ``lap_type``."""
    from pygsp_tpu_torch.parallel.twod import TwoDGraph
    meta = _ints(leaves, ('pr', 'pc', 'n_local', 'n_vertices'))
    p, n = meta['pr'] * meta['pc'], meta['n_local']
    rows, cols, vals = (np.asarray(leaves[k]) for k in ('rows', 'cols',
                                                        'vals'))
    _check_edges(rows, cols, vals, meta['pc'] * n, meta['pr'] * n, p,
                 'TwoDGraph')
    if np.shape(leaves['diag']) != (p, n):
        raise ValueError(f'diag must be ({p}, {n})')
    _check_vertex_perm(leaves['perm'], meta['n_vertices'], p * n)
    return TwoDGraph(
        rows=_tensor(rows, device, np.int32),
        cols=_tensor(cols, device, np.int32), vals=_tensor(vals, device),
        diag=_tensor(leaves['diag'], device),
        perm=_tensor(leaves['perm'], device, np.int32),
        lap_type=str(leaves['lap_type']), **meta)
