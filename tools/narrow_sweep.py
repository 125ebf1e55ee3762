"""Kernel A's two entries across widths and the narrow entry's segment
length, on one card: what ``csr_kernel.NARROW_WIDTH``,
``NARROW_SEGMENT_STEPS`` and ``NARROW_MIN_SEGMENTS`` are set from.

Usage::

    python3 tools/narrow_sweep.py

On path A's graph (``ba_edges_fast(2**20, 8, 8, seed=42)``, 16.8M stored
entries) and on ``Sensor(2**20, k=6)`` (7.4M), in f32 at 1 to 128 columns
and in f64 at 1 to 64: each entry's ms per call (CUDA events, mean of 20
after a warm-up call) and ``torch.sparse.mm``'s, and up to 32 columns the
device time of a call of the wrapper's entry and of the library (a CUDA
graph of 20 calls, replayed: the host's launch costs left out); then the
narrow entry at segment lengths of 128 to 2048 walk steps, at 1, 8 and 24
columns, and of 16 to 512 on two small f64 graphs (``Grid2d(100, 27)``,
``Sensor(16384)``) at 1, 4 and 12; then LOBPCG's products, ``Grid2d(100, 27)`` in f64 at 1, 4 and
12 columns, with their device times. One JSON line each, after the card's
name and power limit.
"""

import json
import os
import subprocess
import sys

import numpy as np
import scipy.sparse as sps
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import pygsp_tpu_torch as gsp  # noqa: E402
from pygsp_tpu_torch.core import csr_kernel  # noqa: E402

F32 = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128)
F64 = (1, 2, 4, 8, 12, 16, 24, 32, 64)
STEPS = (128, 256, 512, 1024, 2048)
SMALL_STEPS = (16, 32, 64, 128, 256, 512)


def time_ms(fn, iters=20):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=20):
    """Device ms of one call of ``fn``: a CUDA graph of ``iters`` calls,
    replayed 5 times between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (5 * iters)


def normal(shape, seed, dtype):
    gen = torch.Generator(device='cuda').manual_seed(seed)
    return torch.randn(shape, generator=gen, device='cuda', dtype=dtype)


def entries(name, M):
    for dtype, widths in ((torch.float32, F32), (torch.float64, F64)):
        A = M.astype(dtype)
        lib = torch.sparse_csr_tensor(A.rowptr, A.cols[:A.nnz],
                                      A.vals[:A.nnz], size=A.shape)
        for s in widths:
            x = normal((A.n_cols, s), s, dtype)
            row = {'graph': name, 'dtype': str(dtype), 's': s,
                   'chosen': csr_kernel.entry_for(s, dtype),
                   'library_ms': time_ms(lambda: torch.sparse.mm(lib, x))}
            for entry in ('narrow', 'wide'):
                if entry == 'wide' or s <= csr_kernel.NARROW_MAX[dtype]:
                    row[f'{entry}_ms'] = time_ms(
                        lambda: csr_kernel.csr_spmm(A.rowptr, A.cols, A.vals,
                                                    x, entry=entry))
            if s <= 32:
                row['device_ms'] = graph_ms(lambda: csr_kernel.csr_spmm(
                    A.rowptr, A.cols, A.vals, x))
                row['library_device_ms'] = graph_ms(
                    lambda: torch.sparse.mm(lib, x))
            print(json.dumps(row), flush=True)
        del A, lib
        torch.cuda.empty_cache()


def segment_lengths(name, M, dtype, widths, lengths):
    """The narrow entry at each segment length (``csr_kernel.narrow_steps``
    held at it), ms a call."""
    chosen = csr_kernel.narrow_steps
    for s in widths:
        x = normal((M.n_cols, s), s, dtype)
        row = {'graph': name, 's': s, 'dtype': str(dtype),
               'chosen': chosen(M.n_rows + M.cols.shape[0])}
        for steps in lengths:
            csr_kernel.narrow_steps = lambda n_steps: steps
            row[str(steps)] = time_ms(lambda: csr_kernel.csr_spmm(
                M.rowptr, M.cols, M.vals, x, entry='narrow'))
        csr_kernel.narrow_steps = chosen
        print(json.dumps({'segment_steps_ms': row}), flush=True)


def main():
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    n = 1 << 20
    src, tgt = gsp.graphs.ba_edges_fast(n, m0=8, m=8, seed=42)
    W = sps.csr_matrix((np.ones(2 * len(src)), (np.concatenate([src, tgt]),
                                                np.concatenate([tgt, src]))),
                       shape=(n, n))
    W.data[:] = 1.0
    graphs = {'A': gsp.graphs.Graph(W).L.offdiag,
              'Sensor': gsp.graphs.Sensor(N=n, k=6, seed=42).L.offdiag}
    for name, M in graphs.items():
        entries(name, M)
        segment_lengths(name, M, torch.float32, (1, 8, 24), STEPS)
    del graphs
    f64 = torch.float64
    small = {'Grid2d(100, 27)': gsp.graphs.Grid2d(100, 27, dtype=f64),
             'Sensor(16384)': gsp.graphs.Sensor(N=16384, seed=42, dtype=f64)}
    for name, G in small.items():
        segment_lengths(name, G.L.offdiag, torch.float64, (1, 4, 12),
                        SMALL_STEPS)
    grid = small['Grid2d(100, 27)'].L.offdiag
    lib = torch.sparse_csr_tensor(grid.rowptr, grid.cols[:grid.nnz],
                                  grid.vals[:grid.nnz], size=grid.shape)
    for s in (1, 4, 12):
        x = normal((grid.n_cols, s), s, torch.float64)
        print(json.dumps({'graph': 'Grid2d(100, 27)', 's': s,
                          'dtype': 'torch.float64', 'ms': time_ms(
                              lambda: csr_kernel.csr_spmm(
                                  grid.rowptr, grid.cols, grid.vals, x)),
                          'device_ms': graph_ms(
                              lambda: csr_kernel.csr_spmm(
                                  grid.rowptr, grid.cols, grid.vals, x)),
                          'library_ms': time_ms(
                              lambda: torch.sparse.mm(lib, x)),
                          'library_device_ms': graph_ms(
                              lambda: torch.sparse.mm(lib, x))}),
              flush=True)


if __name__ == '__main__':
    main()
