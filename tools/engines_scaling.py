"""The multi-device engines across cards at path A's size: ms per bank.

Each of ``world`` processes (one card each, NCCL) builds path A's graph of
``chip_smoke.py`` (``ba_edges_fast(2**20, m0=8, m=8, seed=42)``, 16.8M
stored edges), its λmax, heat bank (order 30, four scales) and x (N, 128)
f32, then runs

- the 1-D engine on ``world`` shards with the production layout
  (``shard_local_windowed(split_boundary=True)``, ``put_sharded_graph``),
- the 2-D engine with ``twod_local_windowed(ring=True, split_cols=True)``
  on a ``2 × world/2`` mesh and on a ``world × 1`` one (2 × 2 and 4 × 1 at
  four cards, 2 × 1 at two),

checks its slice of each bank against the single-device bank on its own
card (CSR, f32; within 1e-4 of the largest value) and times each bank with
CUDA events (mean of 3 after a warm-up; the slowest rank's). Rank 0 prints
one JSON line with the times, the halo and ring traffic per step, and the
card's name and power limit.

``--against DIR``: DIR is another checkout of the repository (a ``git
archive`` of the parent, say). Its engines' modules
(``pygsp_tpu_torch/parallel/sharded.py`` and ``twod.py``, loaded under
names of their own beside this checkout's package, whose kernels and
collectives they then call) run each bank too, in turns with this
checkout's: theirs, ours, ours, theirs, twice, on the same cards in one
process.

``--profile DIR``: one bank of each engine and version under
``torch.profiler`` on every rank; rank 0 writes this checkout's traces
to DIR (gzipped Chrome traces) and prints, for each bank, the device time
of the kernels launched in each named range of the engines
(``halo_exchange``, ``ring_shift``, ``ring_fold0``, ``ring_fold_fused``,
``col_ring_hop``, ``ring_fold_s<s>``, ``mono_fold*``), the NCCL kernels'
time, the fold kernels' time (``fold_strip_multi``, ``windowed_fold``,
``window_strip``), and the share of NCCL kernel time that runs while a
fold kernel runs. The JSON line also gives the host cost of an empty
range with no profiler on (the engines' ``scope``, which then enters
none, and ``record_function``).

Run: ``python3 tools/engines_scaling.py [world] [--against DIR] [--profile
DIR]`` (world 4 by default; needs that many cards).
"""

import argparse
import gzip
import importlib.util
import json
import os
import shutil
import socket
import subprocess
import sys
import time

import numpy as np
import scipy.sparse as sps
import torch
from torch.profiler import ProfilerActivity, profile, record_function

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import pygsp_tpu_torch as gsp  # noqa: E402
from pygsp_tpu_torch import parallel as par  # noqa: E402
from pygsp_tpu_torch.ops.chebyshev import cheby_coeff, cheby_op  # noqa: E402
from pygsp_tpu_torch.parallel import sharded, twod  # noqa: E402
from pygsp_tpu_torch.parallel.mesh import scope  # noqa: E402

N = 1 << 20
SCALES = [5.0, 10.0, 25.0, 50.0]
ORDER = 30
S = 128
TOL = 1e-4
DEADLINE_S = 1500
# the engines' named ranges (the JAX package's scopes), by prefix
RANGES = ('halo_exchange', 'ring_shift', 'ring_fold', 'col_ring_hop',
          'mono_fold')
FOLDS = ('fold_strip_kernel', 'windowed_fold_kernel', 'window_strip_kernel')


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


def load_engines(root):
    """``(sharded, twod)`` of the checkout at ``root``, loaded as modules
    of their own names (they import this checkout's package)."""
    mods = []
    for name in ('sharded', 'twod'):
        path = os.path.join(root, 'pygsp_tpu_torch', 'parallel', f'{name}.py')
        spec = importlib.util.spec_from_file_location(f'against_{name}', path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
        mods.append(mod)
    return tuple(mods)


def merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def length(merged):
    return sum(b - a for a, b in merged)


def overlap(x, y):
    """The length of the intersection of two merged interval lists."""
    i = j = 0
    total = 0.0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        total += max(0.0, b - a)
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return total


def read_trace(trace):
    """A bank's named ranges and kernels from its Chrome trace (ms). Each
    kernel is charged to the innermost named range open on the host
    thread that launched it (its launch found by correlation id; NCCL
    launches its kernels through the driver API, so both APIs count)."""
    events = trace['traceEvents']
    kernels = [e for e in events
               if e.get('cat') in ('kernel', 'gpu_memcpy', 'gpu_memset')]
    launches = {e['args'].get('correlation'): e for e in events
                if e.get('cat') in ('cuda_runtime', 'cuda_driver')}
    opened = [e for e in events if e.get('cat') == 'user_annotation'
              and e['name'].startswith(RANGES)]
    ranges = {}
    for e in opened:
        r = ranges.setdefault(e['name'], {'count': 0, 'device_ms': 0.0,
                                          'host_ms': 0.0})
        r['count'] += 1
        r['host_ms'] += e['dur'] / 1e3
    for k in kernels:
        launch = launches.get(k['args'].get('correlation'))
        if launch is None:
            continue
        inside = [e for e in opened if e['tid'] == launch['tid']
                  and e['ts'] <= launch['ts'] <= e['ts'] + e['dur']]
        if inside:
            ranges[min(inside, key=lambda e: e['dur'])['name']][
                'device_ms'] += k['dur'] / 1e3
    spans = [(k['ts'], k['ts'] + k['dur']) for k in kernels]
    nccl = merge(s for s, k in zip(spans, kernels)
                 if 'nccl' in k['name'].lower())
    fold = merge(s for s, k in zip(spans, kernels)
                 if any(f in k['name'] for f in FOLDS))
    busy = merge(spans)
    under = overlap(nccl, fold)
    return {'ranges': ranges, 'kernels': len(kernels),
            'device_busy_ms': length(busy) / 1e3,
            'device_span_ms': ((busy[-1][1] - busy[0][0]) / 1e3
                               if busy else 0.0),
            'nccl_ms': length(nccl) / 1e3, 'fold_ms': length(fold) / 1e3,
            'nccl_under_fold_ms': under / 1e3,
            'nccl_under_fold_share': under / length(nccl) if nccl else None}


def profile_bank(fn, rank, raw, keep):
    """One bank under torch.profiler on every rank (the collectives need
    all of them); rank 0 writes its Chrome trace to ``raw``, reads it
    (:func:`read_trace`), and keeps it gzipped where ``keep``."""
    fn()
    torch.cuda.synchronize()
    if rank:
        fn()
        torch.cuda.synchronize()
        return None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(raw)
    with open(raw) as f:
        out = read_trace(json.load(f))
    if keep:
        with open(raw, 'rb') as f, gzip.open(raw + '.gz', 'wb') as g:
            shutil.copyfileobj(f, g)
        out['trace'] = os.path.basename(raw) + '.gz'
    os.remove(raw)
    return out


def empty_range_us(iters=100_000):
    """Host µs of one empty range with no profiler on: the engines'
    ``scope`` (which enters no range then) and ``record_function``."""
    out = {}
    for name, enter in (('scope', scope), ('record_function',
                                           record_function)):
        t0 = time.perf_counter()
        for _ in range(iters):
            with enter('halo_exchange'):
                pass
        out[name] = (time.perf_counter() - t0) / iters * 1e6
    return out


def run_engine(name, banks, check, rank, order, profile_dir):
    """Time each version's bank in ``order``, check each, and profile
    each where asked: ``{version: numbers}`` of this rank."""
    out = {v: {'ms': []} for v in banks}
    for v in order:
        out[v]['ms'].append(time_ms(banks[v]))
    for v, fn in banks.items():
        out[v]['rel_err'] = check(fn())
        if profile_dir is not None:
            out[v]['profile'] = profile_bank(
                fn, rank, os.path.join(profile_dir, f'{name}_{v}.json'),
                keep=v == 'this')
    return out


def slowest(results):
    """Every rank's times and errors, the largest of each."""
    flat = [x for eng in results.values() for v in eng.values()
            for x in v['ms'] + [v['rel_err']]]
    vals = torch.tensor(flat, dtype=torch.float64, device='cuda')
    torch.distributed.all_reduce(vals, op=torch.distributed.ReduceOp.MAX)
    vals = iter(vals.tolist())
    for eng in results.values():
        for v in eng.values():
            v['ms'] = [next(vals) for _ in v['ms']]
            v['rel_err'] = next(vals)
            v['ms_mean'] = sum(v['ms']) / len(v['ms'])


def rank_main(rank, world, port, against, profile_dir):
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
    versions = {'this': (sharded, twod)}
    order = ['this']
    if against:
        versions['against'] = load_engines(against)
        order = ['against', 'this', 'this', 'against'] * 2
    out = {'single_card_ms': single_ms, 'turns': order}
    results = {}

    t0 = time.time()
    mesh = par.make_mesh(world, 1)
    sg = par.partition_graph(W, world)
    ell = par.shard_local_windowed(sg, split_boundary=True)
    sg = par.put_sharded_graph(sg, mesh)
    g = mesh.index('graph')
    xl = sg.pad_signal(x)[g * sg.n_local:(g + 1) * sg.n_local].contiguous()
    out['1d'] = {'build_s': time.time() - t0, 'shards': world,
                 'n_local': sg.n_local, 'halo_total': sg.halo_total}
    results['1d'] = run_engine(
        '1d', {v: (lambda m=m: m[0].sharded_cheby_op(sg, lmax, c, xl, mesh,
                                                     ell=ell))
               for v, m in versions.items()},
        lambda o: rel_err(o, sg.perm, sg.n_local, g, ref), rank, order,
        profile_dir)
    del sg, ell, xl
    torch.cuda.empty_cache()

    for pr, pc in dict.fromkeys([(2, world // 2), (world, 1)]):
        key = f'2d_{pr}x{pc}'
        t0 = time.time()
        mesh2 = par.make_mesh_2d(pr, pc)
        tg = par.partition_graph_2d(W, pr, pc)
        ell2 = par.twod_local_windowed(tg, ring=True, split_cols=True)
        d = mesh2.rank
        xl2 = tg.pad_signal(x)[d * tg.n_local:(d + 1) * tg.n_local]
        xl2 = xl2.contiguous()
        out[key] = {'build_s': time.time() - t0, 'mesh': [pr, pc],
                    'n_local': tg.n_local,
                    'comm_rows_per_step': tg.comm_rows_per_step}
        results[key] = run_engine(
            key, {v: (lambda m=m: m[1].cheby_op_2d(tg, lmax, c, xl2, mesh2,
                                                   ell=ell2))
                  for v, m in versions.items()},
            lambda o: rel_err(o, tg.perm, tg.n_local, d, ref), rank, order,
            profile_dir)
        del tg, ell2, xl2
        torch.cuda.empty_cache()
    slowest(results)
    if rank == 0:
        for key, eng in results.items():
            out[key].update(eng)
        card = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
        ok = all(v['rel_err'] <= TOL for eng in results.values()
                 for v in eng.values())
        print(json.dumps({'world': world, 'card': card, 'n': N,
                          'stored_edges': int(W.nnz), 'columns': S,
                          'against': against,
                          'empty_range_us': empty_range_us(),
                          'ok': ok, **out}), flush=True)
    torch.distributed.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('world', nargs='?', type=int, default=4)
    ap.add_argument('--against')
    ap.add_argument('--profile')
    ap.add_argument('--rank', type=int)
    ap.add_argument('--port')
    args = ap.parse_args()
    against = args.against and os.path.abspath(args.against)
    profile_dir = args.profile and os.path.abspath(args.profile)
    if args.rank is not None:
        rank_main(args.rank, args.world, args.port, against, profile_dir)
        return
    if torch.cuda.device_count() < args.world:
        print(f'engines_scaling: {args.world} ranks need {args.world} cards',
              file=sys.stderr)
        sys.exit(1)
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        port = str(sock.getsockname()[1])
    extra = (['--against', against] if against else []) + (
        ['--profile', profile_dir] if profile_dir else [])
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               str(args.world), '--rank', str(r),
                               '--port', port] + extra)
             for r in range(args.world)]
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
