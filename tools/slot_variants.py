"""Times the ELL and chunked SpMM kernels (``csrc/ell_spmm.cu``) at the bench
graph's shapes on the card.

For the package found first on the import path (so that copies of it that
differ in the kernel, each run with its own ``PYTHONPATH``, can be
compared in one call), on ``chip_smoke.py``'s bench graph (Barabási–Albert
N = 2^20, m0 = m = 8, seed 42, unit weights) in the hybrid ELL and the
chunked formats, f32 values: the kernel's registers and spills (``nvcc
-Xptxas -v``, if this copy is not built yet); each kernel at S = 1, 8, 128
and 512 f32 columns held against its plain version in f64 (1e-5 of the
largest value) and across two launches, then its ms per launch (CUDA
events, 20 launches, 10 at 512 columns); the chunked kernel with bf16 x
and values at 128 columns. Prints one JSON line.

Run: ``PYTHONPATH=<copy> python3 tools/slot_variants.py`` on a machine with
one CUDA device, for example a copy built with another launch bound::

    mkdir -p .smoke_tree/lb4
    cp -r pygsp_tpu_torch .smoke_tree/lb4/
    sed -i 's/__launch_bounds__(kThreads, 3)/__launch_bounds__(kThreads, 4)/' \\
        .smoke_tree/lb4/pygsp_tpu_torch/csrc/ell_spmm.cu
    PYTHONPATH=$PWD/.smoke_tree/lb4 python3 tools/slot_variants.py
"""

import json
import os
import sys

import numpy as np
import torch

# the repo root last, so that a copy of the package on PYTHONPATH wins
sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
import pygsp_tpu_torch as gsp  # noqa: E402
from pygsp_tpu_torch.core import _cuda, ell_kernel  # noqa: E402
from pygsp_tpu_torch.core import chunked, sparse  # noqa: E402


def held_ms(M, x, iters):
    """The kernel of M on x against its plain version in f64, two launches
    bit-equal, then its ms per launch."""
    kernel, args = chip_smoke.slot_operands(M)
    y = kernel(*args, x, M.n_rows)
    table, cols, vals, res = args
    want = ell_kernel.slot_spmm_plain(
        table, cols, vals.double(), res._replace(vals=res.vals.double()),
        x.double(), M.n_rows)
    chip_smoke.check(f'{type(M).__name__} S={x.shape[1]}', y, want,
                     chip_smoke.TOL_SLOT)
    if not torch.equal(y, kernel(*args, x, M.n_rows)):
        raise AssertionError('two launches differ')
    return chip_smoke.time_ms(lambda: kernel(*args, x, M.n_rows), iters)


def main():
    if not torch.cuda.is_available():
        print('slot_variants: no CUDA device available', file=sys.stderr)
        sys.exit(1)
    built = _cuda.build(['ell_spmm'], extra_flags=('-Xptxas', '-v'))
    out = {'package': os.path.dirname(gsp.__file__),
           'ptxas': [line.strip() for line in built.get('ell_spmm', '')
                     .splitlines() if 'registers' in line or 'spill' in line]}
    n = chip_smoke.N_BA
    src, tgt = gsp.graphs.ba_edges_fast(n, m0=chip_smoke.M_ATTACH,
                                        m=chip_smoke.M_ATTACH, seed=42)
    W = chip_smoke.symmetric_from_edges(src, tgt, n)
    mats = {'ell': sparse.ell_from_scipy(W, dtype=torch.float32),
            'chunked': chunked.chunked_from_scipy(W, dtype=np.float32)}
    for s in (1, 8, 128, 512):
        x = chip_smoke.seeded_normal((n, s), s)
        for name, M in mats.items():
            out[f'{name}_ms_s{s}'] = held_ms(M, x, 10 if s == 512 else 20)
    Mb = mats['chunked'].astype(torch.bfloat16)
    xb = chip_smoke.seeded_normal((n, 128), 7).bfloat16()
    kernel, args = chip_smoke.slot_operands(Mb)
    out['chunked_bf16_ms_s128'] = chip_smoke.time_ms(
        lambda: kernel(*args, xb, n), 20)
    print(json.dumps(out), flush=True)


if __name__ == '__main__':
    main()
