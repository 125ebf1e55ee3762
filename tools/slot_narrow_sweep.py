"""The ELL and chunked SpMMs' two entries across narrow widths, on one card:
what ``ell_kernel.SLOT_NARROW_WIDTH`` is set from.

Usage::

    python3 tools/slot_narrow_sweep.py [quick]

On path H's graph (``ba_edges_fast(2**20, 8, 8, seed=42)`` with
``compute_laplacian(fmt='hybrid')``, the ELL kernel) in f32 at 1, 2, 4, 8,
16, 24, 32, 48 and 64 columns and in f64 at 1, 5, 8, 16 and 32; on path
I's (the same graph, ``fmt='chunked'``) at those widths and in its three
bf16 operand pairs at 1 and 8; on BA(2^16) and ``Minnesota`` under
``fmt='auto'`` (the ELL kernel) at 1 and 8 f32 columns. At each shape, in
one process: the narrow and the wide entry (``ell_kernel.spmm_entry``),
timed in turns (narrow, wide, wide, narrow; CUDA events, mean of 20 after a
warm-up call) and each by its device time (a CUDA graph of 20 calls,
replayed); the narrow result held against the wide one (1e-5 of the
largest value in f32, 1e-12 in f64, one bf16 ulp); ``torch.sparse.mm`` on
the same off-diagonal in CSR (x's dtype; null for the two mixed bf16 pairs,
which no single call computes, or where it has no kernel for the dtype);
the bound and the gather model of ``chip_smoke.slot_work``. One JSON
line a shape, after the card's name and power limit. ``quick``: f32 at 1
and 8 columns and f64 at 1 and 5 on paths H and I, the bf16 pairs at one
column on path I, and the two small graphs at 1 and 8 (to compare copies
of the package, each run from its own root).
"""

import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
import pygsp_tpu_torch as gsp  # noqa: E402
from pygsp_tpu_torch.core import ell_kernel  # noqa: E402

F32 = (1, 2, 4, 8, 16, 24, 32, 48, 64)
F64 = (1, 5, 8, 16, 32)
SMALL = (1, 8)
N = cs.N_BA
N_SMALL = 1 << 16


def laplacian_offdiag(fmt, n):
    src, tgt = gsp.graphs.ba_edges_fast(n, m0=cs.M_ATTACH, m=cs.M_ATTACH,
                                        seed=42)
    G = gsp.graphs.Graph(cs.symmetric_from_edges(src, tgt, n))
    G.compute_laplacian(fmt=fmt)
    return G.L.offdiag


def library_ms(lib, x):
    """``torch.sparse.mm``'s call and device time, or None where no single
    call computes the pair (``lib`` None) or it has no kernel for x's
    dtype."""
    if lib is None:
        return None, None
    try:
        torch.sparse.mm(lib, x)
    except RuntimeError:
        return None, None
    return (cs.time_ms(lambda: torch.sparse.mm(lib, x), 20),
            cs.graph_ms(lambda: torch.sparse.mm(lib, x), 20))


def agreement(narrow, wide):
    """The narrow entry's distance from the wide one: relative error, or
    bf16 ulps; raises past the limit."""
    if narrow.dtype == torch.bfloat16:
        err = cs.ulps(narrow, wide)
        limit = 1.0
    else:
        err = float((narrow.double() - wide.double()).abs().max()
                    / wide.double().abs().max())
        limit = 1e-12 if narrow.dtype == torch.float64 else 1e-5
    if not err <= limit:
        raise AssertionError(f'narrow entry {err} from the wide one')
    return err


def sweep(name, M, widths, pairs):
    """One JSON line per (pair, width) of ``M``."""
    kind = cs.slot_operands(M)[0].__name__
    for xd, vd in pairs:
        Mv = M.astype(vd)
        _, ops = cs.slot_operands(Mv)
        # torch.sparse.mm takes x and values of one dtype
        lib = cs.slot_csr(M, xd) if xd == vd else None
        for s in widths:
            x = cs.seeded_normal((M.n_cols, s), s).to(xd)

            def run(entry):
                return ell_kernel.spmm_entry(kind, entry, *ops, x, M.n_rows)

            row = {'graph': name, 'kernel': kind, 'x': str(xd),
                   'vals': str(vd), 's': s,
                   'chosen': ell_kernel.entry_for(s, xd),
                   'rel_err_or_ulps': agreement(run('narrow'), run('wide'))}
            times = {'narrow': [], 'wide': []}
            for entry in ('narrow', 'wide', 'wide', 'narrow'):
                times[entry].append(cs.time_ms(lambda: run(entry), 20))
            for entry in ('narrow', 'wide'):
                row[f'{entry}_ms'] = sum(times[entry]) / 2
                row[f'{entry}_device_ms'] = cs.graph_ms(lambda: run(entry),
                                                        20)
            row['library_ms'], row['library_device_ms'] = library_ms(lib, x)
            row.update(cs.slot_work(Mv, s, x.element_size()))
            print(json.dumps(row), flush=True)
            del x
        del Mv, lib
        torch.cuda.empty_cache()


def main():
    if not torch.cuda.is_available():
        print('slot_narrow_sweep: no CUDA device available', file=sys.stderr)
        sys.exit(1)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    quick = sys.argv[1:] == ['quick']
    f32, f64 = (torch.float32,) * 2, (torch.float64,) * 2
    for name, fmt in (('H', 'hybrid'), ('I', 'chunked')):
        M = laplacian_offdiag(fmt, N)
        sweep(name, M, (1, 8) if quick else F32, [f32])
        sweep(name, M, (1, 5) if quick else F64, [f64])
        if fmt == 'chunked':
            sweep(name, M, (1,) if quick else SMALL,
                  [(torch.bfloat16, torch.float32),
                   (torch.bfloat16, torch.bfloat16),
                   (torch.float32, torch.bfloat16)])
        del M
        torch.cuda.empty_cache()
    sweep('BA(2^16) auto', laplacian_offdiag('auto', N_SMALL), SMALL, [f32])
    G = gsp.graphs.Minnesota()
    G.compute_laplacian(fmt='auto')
    sweep('Minnesota auto', G.L.offdiag, SMALL, [f32])


if __name__ == '__main__':
    main()
