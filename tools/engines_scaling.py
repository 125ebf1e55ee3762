"""The multi-device engines across cards at path A's size: ms per bank.

Each of ``world`` processes (one card each, NCCL) builds path A's graph of
``chip_smoke.py`` (``ba_edges_fast(2**20, m0=8, m=8, seed=42)``, 16.8M
stored edges), its λmax, heat bank (order 30, four scales) and x (N, 128)
f32, then runs

- the 1-D engine on ``world`` shards with the production layout
  (``shard_local_windowed(split_boundary=True)``, ``put_sharded_graph``),
- the 2-D engine on a ``pr × pc`` mesh (2 × 2 at four cards, 2 × 1 at two)
  with ``twod_local_windowed(ring=True, split_cols=True)``,

checks its slice of each bank against the single-device bank on its own
card (CSR, f32; within 1e-4 of the largest value) and times each bank with
CUDA events (mean of 3 after a warm-up; the slowest rank's). Rank 0 prints
one JSON line with the times, the halo and ring traffic per step, and the
card's name and power limit.

Run: ``python3 tools/engines_scaling.py [world]`` (default 4; needs that
many cards).
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import scipy.sparse as sps
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import pygsp_tpu_torch as gsp  # noqa: E402
from pygsp_tpu_torch import parallel as par  # noqa: E402
from pygsp_tpu_torch.ops.chebyshev import cheby_coeff, cheby_op  # noqa: E402

N = 1 << 20
SCALES = [5.0, 10.0, 25.0, 50.0]
ORDER = 30
S = 128
TOL = 1e-4
DEADLINE_S = 900


def time_ms(fn, iters=3):
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


def rel_err(out, perm, n_local, part, ref):
    """This rank's slice of a bank (Nf, n_local, S) against the
    single-device bank's rows that it owns."""
    pos = perm.long()
    mine = torch.nonzero(pos // n_local == part).flatten()
    got = out[:, pos[mine] - part * n_local]
    want = ref[:, mine]
    return float((got - want).abs().max() / ref.abs().max())


def rank_main(rank, world, port):
    torch.cuda.set_device(rank)
    par.initialize(f'tcp://localhost:{port}', world, rank)
    src, tgt = gsp.graphs.ba_edges_fast(N, m0=8, m=8, seed=42)
    W = sps.csr_matrix((np.ones(2 * len(src)), (np.concatenate([src, tgt]),
                                                 np.concatenate([tgt, src]))),
                       shape=(N, N))
    W.data[:] = 1.0
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (N, S), dtype=np.float32)).cuda()
    G = gsp.graphs.Graph(W)
    G.estimate_lmax()
    lmax = G.lmax
    c = cheby_coeff(gsp.filters.Heat(G, scale=SCALES).evaluate, lmax,
                    m=ORDER)
    ref = cheby_op(G.L, lmax, c, x)
    single_ms = time_ms(lambda: cheby_op(G.L, lmax, c, x))
    del G
    out = {'single_card_ms': single_ms}

    t0 = time.time()
    mesh = par.make_mesh(world, 1)
    sg = par.partition_graph(W, world)
    ell = par.shard_local_windowed(sg, split_boundary=True)
    sg = par.put_sharded_graph(sg, mesh)
    g = mesh.index('graph')
    xl = sg.pad_signal(x)[g * sg.n_local:(g + 1) * sg.n_local].contiguous()
    build_s = time.time() - t0

    def bank_1d():
        return par.sharded_cheby_op(sg, lmax, c, xl, mesh, ell=ell)

    out['1d'] = {'ms': time_ms(bank_1d), 'build_s': build_s,
                 'n_local': sg.n_local, 'halo_total': sg.halo_total,
                 'rel_err': rel_err(bank_1d(), sg.perm, sg.n_local, g, ref)}
    del sg, ell, xl

    pr = 2
    pc = world // pr
    t0 = time.time()
    mesh2 = par.make_mesh_2d(pr, pc)
    tg = par.partition_graph_2d(W, pr, pc)
    ell2 = par.twod_local_windowed(tg, ring=True, split_cols=True)
    d = mesh2.rank
    xl2 = tg.pad_signal(x)[d * tg.n_local:(d + 1) * tg.n_local].contiguous()
    build_s = time.time() - t0

    def bank_2d():
        return par.cheby_op_2d(tg, lmax, c, xl2, mesh2, ell=ell2)

    out['2d'] = {'ms': time_ms(bank_2d), 'build_s': build_s,
                 'mesh': [pr, pc], 'n_local': tg.n_local,
                 'comm_rows_per_step': tg.comm_rows_per_step,
                 'rel_err': rel_err(bank_2d(), tg.perm, tg.n_local, d, ref)}
    # the slowest rank's numbers
    vals = torch.tensor([out['single_card_ms'], out['1d']['ms'],
                         out['1d']['rel_err'], out['2d']['ms'],
                         out['2d']['rel_err']], dtype=torch.float64,
                        device='cuda')
    torch.distributed.all_reduce(vals, op=torch.distributed.ReduceOp.MAX)
    if rank == 0:
        out['single_card_ms'], out['1d']['ms'], out['1d']['rel_err'], \
            out['2d']['ms'], out['2d']['rel_err'] = vals.tolist()
        card = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
        ok = out['1d']['rel_err'] <= TOL and out['2d']['rel_err'] <= TOL
        print(json.dumps({'world': world, 'card': card, 'n': N,
                          'stored_edges': int(W.nnz), 'columns': S,
                          'ok': ok, **out}), flush=True)
    torch.distributed.destroy_process_group()


def main():
    if len(sys.argv) > 2 and sys.argv[1] == '--rank':
        rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return
    world = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    if torch.cuda.device_count() < world:
        print(f'engines_scaling: {world} ranks need {world} cards',
              file=sys.stderr)
        sys.exit(1)
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        port = str(sock.getsockname()[1])
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               '--rank', str(r), str(world), port])
             for r in range(world)]
    try:
        rcs = [p.wait(timeout=DEADLINE_S) for p in procs]
    except subprocess.TimeoutExpired:
        rcs = [1]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    sys.exit(max(rcs))


if __name__ == '__main__':
    main()
