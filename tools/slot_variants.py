"""Compares builds of the ELL and chunked SpMM kernels (``csrc/ell_spmm.cu``)
bit for bit and by time, at the bench graph's shapes on the card.

Usage::

    python3 tools/slot_variants.py [--against NAME=PATH ...] [--narrow]
                                   [--banks] [--out DIR]

Each ``PATH`` is another version of ``csrc/ell_spmm.cu`` (the parent
commit's, unpacked by ``git archive`` into a git-ignored directory, or a
copy with a constant changed). It is built with the package's nvcc flags
and swapped in for the package's own build through the library cache of
``core/_cuda.py``, so every build runs through the same wrappers on the
same operands in one process: its C symbols must take the package's
arguments.

On ``chip_smoke.py``'s bench graph (Barabási–Albert N = 2^20, m0 = m = 8,
seed 42, unit weights) in the hybrid ELL and the chunked formats, every
operand pair of both wrappers at 128 and 512 columns (ELL f32 and f64;
chunked f32, f64, bf16 x · f32 values, bf16 · bf16, f32 x · bf16 values)
and, beside them, chunked f32 at 64 and bf16 at 16 columns (the wide
entry's narrower row groups). For each instance and build: a hash of y
(``sha``; ``equal``: y equal to the package build's bit for bit), ms per
launch (CUDA events, 20 launches, 10 at 512 columns) with the builds
timed in turns (the package's, the others, then the same in reverse), the
gather rate (the stored entries' x rows, nnz · S · item bytes, over the
time) beside the bound and the gather model of ``chip_smoke.slot_work``.
The package's build is held against the plain version first
(``chip_smoke.hold_slot``: f32 and f64 within TOL_SLOT and TOL_F64 of the
plain version in f64, bf16 y within TOL_BF16_ULPS of it in the same types;
two launches bit-equal; inf behind the dead slots adding nothing). Kernel
A's wide entry on the same graph in CSR at 128 and 512 f32 columns is
timed as the yardstick. ``--banks`` also times, with each build in turns,
``chip_smoke.py``'s bank on path H and on path I, path I's fast mode and a
training step on I. ``--narrow`` also times the narrow entry where it
takes the shape (the 128-column f32 and bf16 instances). Every build's
registers and spills (``nvcc -Xptxas -v``) come first.

Prints the card's name and power limit, one JSON line per instance, then
a summary line; ``--out DIR`` also writes them to ``DIR/slot_variants.jsonl``.
Run on a machine with one CUDA device, e.g. against the parent commit::

    mkdir -p .smoke_tree/parent
    git archive HEAD~1 pygsp_tpu_torch/csrc/ell_spmm.cu | tar -x -C .smoke_tree/parent
    python3 tools/slot_variants.py \\
        --against parent=.smoke_tree/parent/pygsp_tpu_torch/csrc/ell_spmm.cu
"""

import argparse
import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
import pygsp_tpu_torch as gsp  # noqa: E402
from pygsp_tpu_torch.core import _cuda, chunked, csr_kernel  # noqa: E402
from pygsp_tpu_torch.core import ell_kernel, sparse  # noqa: E402

SOURCE = 'ell_spmm'
PAIRS = (('ell', torch.float32, torch.float32),
         ('ell', torch.float64, torch.float64),
         ('chunked', torch.float32, torch.float32),
         ('chunked', torch.float64, torch.float64),
         ('chunked', torch.bfloat16, torch.float32),
         ('chunked', torch.bfloat16, torch.bfloat16),
         ('chunked', torch.float32, torch.bfloat16))
EXTRA = (('chunked', torch.float32, torch.float32, 64),
         ('chunked', torch.bfloat16, torch.bfloat16, 16))


def ptxas_lines(text):
    """Each kernel's registers and spills from ``-Xptxas -v``: one line a
    kernel, its name demangled where ``c++filt`` is found."""
    out, name = [], None
    for line in text.splitlines():
        if 'Function properties for' in line:
            name = line.split('Function properties for', 1)[1].strip()
        elif 'spill stores' in line and name:
            spill = line.strip()
        elif 'Used' in line and 'registers' in line and name:
            regs = line.split('Used', 1)[1].split(',')[0].strip()
            out.append((name, f'{regs}, {spill}'))
            name = None
    names = [n for n, _ in out]
    if names and shutil.which('c++filt'):
        names = subprocess.run(['c++filt'], input='\n'.join(names),
                               capture_output=True,
                               text=True).stdout.splitlines()
    return [f'{n}: {v}' for n, (_, v) in zip(names, out)]


def build_variants(against):
    """Compile each ``NAME=PATH`` source (in parallel), load it: name to
    ``(CDLL, ptxas lines)``."""
    os.makedirs(_cuda.BUILD, exist_ok=True)
    jobs = []
    for item in against:
        name, path = item.split('=', 1)
        with open(path, 'rb') as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:12]
        lib = os.path.join(_cuda.BUILD, f'lib{SOURCE}-{name}-{digest}.so')
        proc = subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, '-Xptxas', '-v', '-o', lib,
             path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        jobs.append((name, lib, proc))
    out = {}
    for name, lib, proc in jobs:
        text = proc.communicate()[0].decode(errors='replace')
        if proc.returncode:
            raise RuntimeError(f'nvcc failed for {name}:\n{text}')
        out[name] = (ctypes.CDLL(lib), ptxas_lines(text))
    return out


def select(lib):
    """Make ``lib`` the build that the wrappers launch."""
    _cuda._libraries[SOURCE] = lib
    for key in [k for k in _cuda._functions if k[0] == SOURCE]:
        del _cuda._functions[key]


def digest(y):
    """A hash of y's bits, reduced on the card: per 2^24 words a weighted
    sum of the 64-bit words (weights odd and distinct), then SHA-256."""
    w = y.contiguous().view(-1).view(torch.int64)
    parts = []
    step = 1 << 24
    for a in range(0, w.numel(), step):
        idx = torch.arange(a, min(a + step, w.numel()), device=w.device,
                           dtype=torch.int64)
        parts.append(((idx * -7046029254386353131 + 1) * w[a:a + step])
                     .sum())
    raw = torch.stack(parts).cpu().numpy().tobytes()
    return hashlib.sha256(raw).hexdigest()[:16]


def matrices(W):
    ell = sparse.ell_from_scipy(W, dtype=torch.float32)
    ch = chunked.chunked_from_scipy(W, dtype=np.float32)
    return {('ell', torch.float32): ell,
            ('ell', torch.float64): ell.astype(torch.float64),
            ('chunked', torch.float32): ch,
            ('chunked', torch.float64): ch.astype(torch.float64),
            ('chunked', torch.bfloat16): ch.astype(torch.bfloat16)}


def short(dtype):
    return str(dtype).replace('torch.', '').replace('float', 'f')


def run_instance(label, M, x, builds, narrow):
    kernel, args = cs.slot_operands(M)
    iters = 10 if x.shape[1] >= 512 else 20
    out = {'instance': label, 's': x.shape[1], 'n_rows': M.n_rows,
           'nnz': M.nnz, 'dense_slots': args[1].numel(),
           **cs.slot_work(M, x.shape[1], x.element_size())}
    first = next(iter(builds))
    select(builds[first][0])
    out['held'] = {k: v for k, v in cs.hold_slot(label, M, x).items()
                   if k != 'ms'}
    ref = None
    numbers = {name: {'ms': []} for name in builds}
    for name in list(builds) + list(reversed(builds)):
        select(builds[name][0])
        if 'sha' not in numbers[name]:
            y = kernel(*args, x, M.n_rows)
            if ref is None:
                ref = y
            numbers[name].update(sha=digest(y), equal=torch.equal(y, ref))
            del y
        numbers[name]['ms'].append(cs.time_ms(
            lambda: kernel(*args, x, M.n_rows), iters))
    del ref
    gathered = M.nnz * x.shape[1] * x.element_size()
    for v in numbers.values():
        v['mean_ms'] = sum(v['ms']) / len(v['ms'])
        v['gather_tb_per_s'] = gathered / (v['mean_ms'] / 1e3) / 1e12
    out['builds'] = numbers
    if narrow:
        s, xd = x.shape[1], x.dtype
        lanes_ok = s * x.element_size() <= 32 * 16
        if ell_kernel.entry_for(s, xd) == 'wide' and lanes_ok:
            select(builds[first][0])

            def run():
                return ell_kernel.spmm_entry(kernel.__name__, 'narrow',
                                             *args, x, M.n_rows)
            y = run()
            out['narrow'] = {'sha': digest(y),
                             'equal_to_wide': torch.equal(
                                 y, kernel(*args, x, M.n_rows)),
                             'ms': cs.time_ms(run, iters)}
            del y
    print(json.dumps(out), flush=True)
    return out


def banks(builds):
    """chip_smoke.py's banks on the bench graph with each build, in turns
    after a warm-up run: path H's (``fmt='hybrid'``), path I's
    (``fmt='chunked'``), its fast mode and a training step on I
    (``chip_smoke.train``, two Adam steps a turn): ms by build."""
    out = {}
    for fmt in ('hybrid', 'chunked'):
        G, g, x, bank = cs.bench_graph(fmt)
        runs = {f'{fmt}_bank': lambda: cs.time_ms(bank, 3)}
        if fmt == 'chunked':
            fast = cs.fast_bank(g, x)
            runs.update(fast_bank=lambda: cs.time_ms(fast, 3),
                        train_step=lambda: cs.train('I', G, None, x, 2)[
                            'ms_per_step'])
        for key, run in runs.items():
            run()   # a warm-up: the first training step allocates
            times = {name: [] for name in builds}
            for name in list(builds) + list(reversed(builds)):
                select(builds[name][0])
                times[name].append(run())
            out[key] = {name: sum(t) / len(t) for name, t in times.items()}
            print(json.dumps({key: times}), flush=True)
        del G, g, x, bank
        torch.cuda.empty_cache()
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--against', action='append', default=[])
    parser.add_argument('--narrow', action='store_true')
    parser.add_argument('--banks', action='store_true')
    parser.add_argument('--out', default=None)
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit('slot_variants: no CUDA device available')
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    # the package's own source too, so that its registers are listed
    builds = build_variants([f'package={_cuda._paths(SOURCE)[0]}']
                            + opts.against)
    print(json.dumps({'ptxas': {k: v[1] for k, v in builds.items()}}),
          flush=True)

    n = cs.N_BA
    src, tgt = gsp.graphs.ba_edges_fast(n, m0=cs.M_ATTACH, m=cs.M_ATTACH,
                                        seed=42)
    W = cs.symmetric_from_edges(src, tgt, n)
    mats = matrices(W)
    lines = []
    widths = (128, 512)
    for s in widths:
        for fmt, xd, vd in PAIRS:
            x = cs.seeded_normal((n, s), s).to(xd)
            lines.append(run_instance(
                f'{fmt} {short(xd)}.{short(vd)} S={s}', mats[fmt, vd], x,
                builds, opts.narrow and s == 128))
            del x
    for fmt, xd, vd, s in EXTRA:
        x = cs.seeded_normal((n, s), s).to(xd)
        lines.append(run_instance(f'{fmt} {short(xd)}.{short(vd)} S={s}',
                                  mats[fmt, vd], x, builds, False))
        del x
    A = sparse.from_scipy(W, dtype=torch.float32)
    yardstick = {}
    for s in widths:
        x = cs.seeded_normal((n, s), s)
        yardstick[f'kernel_a_wide_ms_s{s}'] = cs.time_ms(
            lambda: csr_kernel.csr_spmm(A.rowptr, A.cols, A.vals, x),
            10 if s >= 512 else 20)
        del x
    del mats, A
    torch.cuda.empty_cache()
    summary = {'summary': {
        'kernel_a': yardstick,
        'banks_ms': banks(builds) if opts.banks else None,
        'all_equal': all(b['equal'] for line in lines
                         for b in line['builds'].values()),
        'mean_ms': {line['instance']: {k: b['mean_ms'] for k, b in
                                       line['builds'].items()}
                    for line in lines}}}
    print(json.dumps(summary), flush=True)
    if opts.out:
        os.makedirs(opts.out, exist_ok=True)
        with open(os.path.join(opts.out, 'slot_variants.jsonl'), 'w') as f:
            for line in lines + [summary]:
                f.write(json.dumps(line) + '\n')


if __name__ == '__main__':
    main()
