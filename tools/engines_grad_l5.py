"""Path L5 of ``chip_smoke.py`` alone on one card: the multi-device engines
under autograd at one rank on path A's graph.

Builds the kernels, path A's graph (``ba_edges_fast(2**20, m0=8, m=8,
seed=42)``), its λmax, the heat bank of order 30 and x (N, 128) f32,
joins a one-rank NCCL group, builds L1's and L2's partitions (the 1-D
production layout ``shard_local_windowed(split_boundary=True)`` and the
2-D ``twod_local_windowed(ring=True, split_cols=True)`` at 1 × 1), then
runs ``chip_smoke.phase_path_l5`` (each engine's forward and backward
counted, timed and held against the single-device route) and, with the
process group destroyed, ``chip_smoke.engines_small_f64`` (BA(2^16) in
f64, card against CPU). Prints the card's name and power limit and one
JSON line; with ``--out DIR`` it writes the whole result to
``DIR/l5.json``. About three minutes with the build; a quick check of the
engines' gradients without the full script.

Run from the repository's root: ``python3 tools/engines_grad_l5.py [--out
DIR]``.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from pygsp_tpu_torch import parallel as par  # noqa: E402
from pygsp_tpu_torch.core import windowed_kernel as wk  # noqa: E402
from pygsp_tpu_torch.parallel.partition import shard_slice  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--out', help='a directory for l5.json')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('engines_grad_l5: no CUDA device available', file=sys.stderr)
        sys.exit(1)
    t_all = time.time()
    c.count_symbols()
    c.count_plain_calls()
    c.phase_build()
    src, tgt = c.gsp.graphs.ba_edges_fast(c.N_BA, m0=c.M_ATTACH,
                                          m=c.M_ATTACH, seed=42)
    W = c.symmetric_from_edges(src, tgt, c.N_BA)
    G = c.gsp.graphs.Graph(W)
    G.estimate_lmax()
    lmax = float(G.lmax)
    del G
    x = c.seeded_normal((c.N_BA, c.N_SIGNALS), 0)
    coef = c.heat_coeff(torch.tensor(c.SCALES, device='cuda'), lmax)
    par.initialize(f'tcp://localhost:{c.free_port()}', 1, 0)
    t0 = time.time()
    sg = par.partition_graph(W, 1)
    split = par.shard_local_windowed(sg, split_boundary=True)
    tg = par.partition_graph_2d(W, 1, 1)
    ell2 = par.twod_local_windowed(tg, ring=True, split_cols=True)
    m2 = shard_slice(ell2[0][0], 0).local_matrix()
    fits = wk.fold_strip_fits([(m2.cols, m2.vals, m2.rowid)],
                              [tg.pad_signal(x)], m2.borrow_span,
                              m2.window_rows)
    del m2
    setup_s = time.time() - t0
    t0 = time.time()
    result, launches = c.phase_path_l5(W, lmax, coef, x, sg, split,
                                       par.make_mesh(1, 1), tg, ell2,
                                       par.make_mesh_2d(1, 1), fits)
    result['phase_s'] = time.time() - t0
    torch.distributed.destroy_process_group()
    t0 = time.time()
    result['small_f64'] = c.engines_small_f64()
    result['small_f64_s'] = time.time() - t0
    result.update(setup_s=setup_s, fold_strip_fits=fits,
                  total_s=time.time() - t_all)
    card = c.card()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, 'l5.json'), 'w') as f:
            json.dump({'L5': result, 'launches': launches, 'card': card}, f)
    print(card)
    print(json.dumps({k: v['ms'] if isinstance(v, dict) and 'ms' in v
                      else v for k, v in result.items()
                      if k != 'small_f64'}))


if __name__ == '__main__':
    main()
