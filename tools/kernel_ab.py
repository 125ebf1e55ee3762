"""Kernel A (``csr_spmm``) and kernel B's group (``cheby_acc_group``) of two
or more copies of the package, timed in one call on one card.

Usage::

    python3 tools/kernel_ab.py TREE [TREE ...]

Each TREE is the root of a copy of the repository, for example the parent
commit unpacked with ``git archive`` into ``.smoke_tree/parent`` (a
git-ignored directory) beside ``.`` for this one. Each runs in a process of
its own, importing that copy's ``pygsp_tpu_torch`` and building its kernels
into that copy's ``_build/``, in the order given: give them as parent,
change, change, parent to see the drift of the card between runs. Each
prints one JSON line of milliseconds per call (CUDA events, mean of 20
after a warm-up call; a shape's inputs are the same in every run):

- ``csr_spmm`` through the wrapper's own choice of entry, on path A's graph
  (``ba_edges_fast(2**20, 8, 8, seed=42)``, 16.8M stored entries) at 1 to
  128 columns in f32 and 1 and 12 in f64; on ``Sensor(2**20, k=6)`` at
  one column, and as its ``grad`` and ``div``; on ``Grid2d(100, 27)`` in
  f64 at 1, 4 and 12 columns (LOBPCG's products);
- ``cheby_acc_group`` at path A's shape (2^20, 128) with Nf = 4 in f32
  and with bf16 terms and Nf = 6, each for a group of the rule's g (14,
  13 at Nf = 6) and of one term, and at the spectrogram's (2048, 2048)
  with Nf = 100, g = 14.

The card's name and power limit come first.
"""

import json
import os
import subprocess
import sys

CSR_F32 = (1, 2, 4, 8, 16, 24, 32, 128)
CSR_F64 = (1, 12)
GRID_F64 = (1, 4, 12)
GROUPS = (('A_nf4_g14', 1 << 20, 128, 4, 'f32', 14),
          ('A_nf4_g1', 1 << 20, 128, 4, 'f32', 1),
          ('A_nf4_g14_bf16', 1 << 20, 128, 4, 'bf16', 14),
          ('A_nf4_g1_bf16', 1 << 20, 128, 4, 'bf16', 1),
          ('A_nf6_g13', 1 << 20, 128, 6, 'f32', 13),
          ('A_nf6_g1', 1 << 20, 128, 6, 'f32', 1),
          ('J5_nf100_g14', 2048, 2048, 100, 'f32', 14))


def time_ms(fn, iters=20):
    import torch
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


def run_tree(tree):
    """Measure one copy (this process imports it first on the path)."""
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import scipy.sparse as sps
    import torch
    import pygsp_tpu_torch as gsp
    from pygsp_tpu_torch.core import cheby_kernel, csr_kernel
    assert gsp.__file__.startswith(os.path.abspath(tree)), gsp.__file__

    def normal(shape, seed, dtype=torch.float32):
        gen = torch.Generator(device='cuda').manual_seed(seed)
        return torch.randn(shape, generator=gen, device='cuda', dtype=dtype)

    def spmm_ms(M, s, dtype, seed):
        x = normal((M.n_cols, s), seed, dtype)
        return time_ms(lambda: csr_kernel.csr_spmm(M.rowptr, M.cols, M.vals,
                                                   x))

    out = {'tree': tree, 'csr_spmm': {}, 'cheby_acc_group': {}}
    src, tgt = gsp.graphs.ba_edges_fast(1 << 20, m0=8, m=8, seed=42)
    W = sps.csr_matrix((np.ones(2 * len(src)), (np.concatenate([src, tgt]),
                                                np.concatenate([tgt, src]))),
                       shape=(1 << 20, 1 << 20))
    W.data[:] = 1.0
    A = gsp.graphs.Graph(W).L.offdiag
    for s in CSR_F32:
        out['csr_spmm'][f'A_{s}_f32'] = spmm_ms(A, s, torch.float32, s)
    A64 = A.astype(torch.float64)
    for s in CSR_F64:
        out['csr_spmm'][f'A_{s}_f64'] = spmm_ms(A64, s, torch.float64, s)
    del A, A64, W
    G = gsp.graphs.Sensor(N=1 << 20, k=6, seed=42)
    out['csr_spmm']['J_1_f32'] = spmm_ms(G.L.offdiag, 1, torch.float32, 1)
    G.compute_differential_operator()
    out['csr_spmm']['J_grad_1_f32'] = spmm_ms(G.D.DT, 1, torch.float32, 2)
    out['csr_spmm']['J_div_1_f32'] = spmm_ms(G.D.D, 1, torch.float32, 3)
    del G
    grid = gsp.graphs.Grid2d(100, 27, dtype=torch.float64).L.offdiag
    for s in GRID_F64:
        out['csr_spmm'][f'grid_{s}_f64'] = spmm_ms(grid, s, torch.float64, s)
    torch.cuda.empty_cache()
    for name, n, s, nf, terms, g in GROUPS:
        cd = torch.bfloat16 if terms == 'bf16' else torch.float32
        ring = normal((g + 2, n, s), 5).to(cd)
        acc = normal((nf, n, s), 6)
        cg = normal((g, nf), 7)
        out['cheby_acc_group'][name] = time_ms(
            lambda: cheby_kernel.cheby_acc_group(acc, ring, cg, 9))
        del ring, acc
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main():
    if len(sys.argv) > 2 and sys.argv[1] == '--one':
        run_tree(sys.argv[2])
        return
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for tree in sys.argv[1:]:
        subprocess.run([sys.executable, os.path.abspath(__file__), '--one',
                        tree], check=True)


if __name__ == '__main__':
    main()
