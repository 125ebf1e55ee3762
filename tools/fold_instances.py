"""Times the windowed fold's instances at path C's shape on the card and,
with ``--multi``, the fused multi-matrix SpMM at path L's shapes.

For the package found first on the import path (so that two copies of it
can be compared, each run with its own ``PYTHONPATH``), on ``chip_smoke.py``'s
path C (the bench graph in the windowed format, x (N, 128)), in the
matrix's internal order: ms per launch (CUDA events, 20 launches) of the
fold with x and values in bf16 (path D's instance), with a bf16 x and f32
values, and in f32; the bf16 instance's largest distance from its plain
version in bf16 ulps; a hash of each instance's window tensor (two copies
that round alike give the same hashes); and ms per bank of path D.

With ``--multi`` (and a copy that has ``fold_strip_multi``), also the
fused SpMM in one launch and the two launches it replaces
(``windowed_fold_multi``, then ``window_strip``), each timed (CUDA events,
20 calls) and its y hashed, in f32, with the x's in bf16 (the carry) and
in f32 without the residue list, on these operand sets of path A's graph
(``ba_edges_fast(2**20, 8, 8, seed=42)``) with x of 128 f32 columns from a
seed:

- ``L3``: device (0, 0)'s ring group of ``partition_graph_2d(W, 4, 4)``,
  four matrices, as ``chip_smoke.py``'s L3;
- ``L4_pos0``, ``L4_pos1``: both fold positions' groups of device (0, 0)
  of the 2 × 2 interleaved ring (``split_cols=True``), as its L4;
- ``C_one_matrix``: path C's windowed Laplacian, one matrix (f32 only).

Prints one JSON line.

Run: ``PYTHONPATH=<copy> python3 tools/fold_instances.py [--multi]`` on a
machine with one CUDA device; give the copies as A, B, B, A in one call to
see the card's drift between runs.
"""

import hashlib
import json
import os
import sys

import torch

# the repo root last, so that a copy of the package on PYTHONPATH wins
sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
import pygsp_tpu_torch  # noqa: E402
from pygsp_tpu_torch.core import chunked  # noqa: E402
from pygsp_tpu_torch.core import windowed_kernel as wk  # noqa: E402


def sha(t):
    return hashlib.sha256(
        t.cpu().view(torch.uint8).numpy().tobytes()).hexdigest()[:16]


def multi_operands(M, xp):
    """The fused SpMM's operand sets: name to (slabs, xs, R, P, K, n_rows,
    the merged residue list)."""
    from pygsp_tpu_torch import parallel as par
    from pygsp_tpu_torch.parallel.partition import shard_slice

    def entry(mats, xs):
        m0 = mats[0]
        return ([(m.cols, m.vals, m.rowid) for m in mats], xs,
                m0.chunk_rows, m0.window_rows, m0.borrow_span, m0.n_rows,
                wk.merge_residues([m.residue for m in mats], m0.n_rows))

    src, tgt = chip_smoke.gsp.graphs.ba_edges_fast(
        chip_smoke.N_BA, m0=chip_smoke.M_ATTACH, m=chip_smoke.M_ATTACH,
        seed=42)
    W = chip_smoke.symmetric_from_edges(src, tgt, chip_smoke.N_BA)
    out = {}
    for part, shape, kw in (('L3', (4, 4), {}),
                            ('L4', (2, 2), dict(split_cols=True))):
        ell = par.twod_local_windowed(par.partition_graph_2d(W, *shape),
                                      ring=True, **kw)
        groups = ([[shard_slice(row[s], 0).local_matrix() for row in ell]
                   for s in range(shape[1])] if kw else
                  [[shard_slice(e, 0).local_matrix() for e in ell]])
        for s, mats in enumerate(groups):
            xs = [chip_smoke.seeded_normal((m.n_cols, 128), 80 + 10 * s + k)
                  for k, m in enumerate(mats)]
            out[part if len(groups) == 1 else f'{part}_pos{s}'] = entry(
                mats, xs)
    out['C_one_matrix'] = entry([M], [xp])
    return out


def two_launches(slabs, xs, R, P, K, n, res):
    return wk.window_strip(wk.windowed_fold_multi(slabs, xs, R, K * P), n, P,
                           res, xs)


def time_multi(M, xp):
    """The fused SpMM and the two launches it replaces on every operand
    set: hashes and ms by set and mode."""
    out = {}
    for name, (slabs, xs, R, P, K, n, res) in multi_operands(M, xp).items():
        for mode in ('f32', 'bf16_carry', 'f32_no_residue'):
            if mode == 'bf16_carry' and len(slabs) == 1:
                continue
            x = ([v.to(torch.bfloat16) for v in xs] if mode == 'bf16_carry'
                 else xs)
            args = (slabs, x, R, P, K, n,
                    None if mode == 'f32_no_residue' else res)
            out[f'{name}_{mode}_sha'] = sha(wk.fold_strip_multi(*args))
            out[f'{name}_{mode}_ms'] = chip_smoke.time_ms(
                lambda: wk.fold_strip_multi(*args), 20)
            if mode != 'f32_no_residue':
                out[f'{name}_{mode}_two_launch_sha'] = sha(
                    two_launches(*args))
                out[f'{name}_{mode}_two_launch_ms'] = chip_smoke.time_ms(
                    lambda: two_launches(*args), 20)
    return out


def main():
    if not torch.cuda.is_available():
        sys.exit('fold_instances: no CUDA device available')
    _, g, x, _ = chip_smoke.path_c()
    M = g.G.L.offdiag
    xp = chunked.permute_in(M, x)
    out = {'package': os.path.dirname(pygsp_tpu_torch.__file__)}
    for name, xd, vd in (('both', torch.bfloat16, torch.bfloat16),
                         ('carry', torch.bfloat16, torch.float32),
                         ('f32', torch.float32, torch.float32)):
        args = (M.cols, M.vals.to(vd), M.rowid, xp.to(xd).contiguous(),
                M.chunk_rows, M.borrow_span * M.window_rows)
        t = wk.windowed_fold(*args)
        out['sha' if name == 'both' else f'{name}_sha'] = sha(t)
        if name == 'both':
            out['ulps_vs_plain'] = chip_smoke.ulps(
                t, wk.windowed_fold_plain(*args))
        del t
        out[f'{name}_ms'] = chip_smoke.time_ms(
            lambda: wk.windowed_fold(*args), 20)
    out['bank_D_ms'] = chip_smoke.time_ms(chip_smoke.fast_bank(g, x), 3)
    if '--multi' in sys.argv[1:] and hasattr(wk, 'fold_strip_multi'):
        out.update(time_multi(M, xp))
    print(json.dumps(out), flush=True)


if __name__ == '__main__':
    main()
