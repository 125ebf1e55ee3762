"""Benchmark of the PyTorch/CUDA port: K=30 Chebyshev heat filter bank
throughput (edge-ops/s) on one GPU.

The port's mirror of ``bench.py``, with its configuration (N = 2^20
Barabási–Albert, m0 = m = 8, 128 float32 signals, heat scales 5, 10, 25
and 50, order 30; ``bench.py:52-58``), its host relabel of the vertices
(``:154-155``), its windowed format built without the builder's own
permute (``:169-170``) and its λmax = 2·max(dw) (``:160``). It runs the
exact float32 bank, then the fast mode (``carry_dtype`` and
``vals_dtype`` bfloat16, ``:332-334``), and validates each against the
SciPy float64 recurrence on 8 columns, with ``bench.py``'s gates on its
first filter (``:242-246``, ``:345-351``): 1e-2 for float32 and 1.5e-2
for the fast mode; the error over all four filters is reported beside.
A failed fast-mode pass fails the run (there is no fallback to float32).

Prints one JSON line with ``bench.py``'s keys that apply: ``value`` and
``per_bank_ms``, ``rel_err`` and ``carry`` of the headline mode (the fast
mode when it validates and is the faster), the float32 series under
``*_f32``, the fast mode's under ``*_bf16``, ``pct_roofline`` against the
card's HBM rate (3.35e12 B/s, the H100 SXM data sheet) for the format-
independent least bytes of one bank in the headline mode (``bench.py:258``
for float32; the fast mode's bf16 rows, values and outputs for it), and
the card's name and power limit from ``nvidia-smi``. Timings are CUDA events, the
median of 3 repetitions of 3 banks.

Run: ``python3 bench_torch.py``. It needs one CUDA device and exits
non-zero without one.
"""

import json
import subprocess
import sys
import time

import numpy as np
import scipy.sparse as sps
import torch

START = time.time()

N = 1 << 20
M_ATTACH = 8
K_ORDER = 30
N_SIGNALS = 128
SCALES = [5.0, 10.0, 25.0, 50.0]
N_CHECK_COLS = 8
GATE_F32 = 1e-2          # bench.py:245
GATE_BF16 = 1.5e-2       # bench.py:351
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
N_ITER, REPS = 3, 3


def log(*args):
    print(f'[{time.time() - START:7.1f}s]', *args, file=sys.stderr,
          flush=True)


def bench_graph():
    """bench.py's graph, relabeled on the host: (W, dw, lmax)."""
    from pygsp_tpu_torch.graphs import ba_edges_fast
    t0 = time.time()
    src, tgt = ba_edges_fast(N, m0=M_ATTACH, m=M_ATTACH, seed=42)
    W = sps.csr_matrix(
        (np.ones(2 * len(src), dtype=np.float32),
         (np.concatenate([src, tgt]), np.concatenate([tgt, src]))),
        shape=(N, N))
    W.data[:] = 1.0
    W.sum_duplicates()
    relperm = np.random.default_rng(0x5EED).permutation(N)
    W = W[relperm][:, relperm].tocsr()
    dw = np.ravel(W.sum(axis=1)).astype(np.float32)
    log(f'graph: N={N}, nnz={W.nnz} (host-relabeled) in '
        f'{time.time() - t0:.1f}s')
    return W, dw, float(2 * dw.max())


def reference(W, dw, lmax, c, x):
    """The SciPy float64 recurrence on the host for x (N, 8): ``(out (Nf, N,
    8), edge-ops/s)``."""
    L = (sps.diags(dw.astype(np.float64)) - W.astype(np.float64)).tocsr()
    a1 = a2 = lmax / 2
    nf, m1 = c.shape
    t0 = time.time()
    t_old = x
    t_cur = (L @ x - a2 * x) / a1
    r = [0.5 * c[i, 0] * t_old + c[i, 1] * t_cur for i in range(nf)]
    for k in range(2, m1):
        t_new = (2.0 / a1) * (L @ t_cur - a2 * t_cur) - t_old
        for i in range(nf):
            r[i] += c[i, k] * t_new
        t_old, t_cur = t_cur, t_new
    dt = time.time() - t0
    return np.stack(r), (m1 - 1) * L.nnz * x.shape[1] / dt


def rel_err(out, ref):
    """max |out − ref| / max |ref| over the checked columns, of the first
    filter (bench.py's gate) and of all filters; ``out`` is (Nf, N, S)."""
    got = out[:, :, :N_CHECK_COLS].double().cpu().numpy()
    return tuple(float(np.abs(g - r).max() / np.abs(r).max())
                 for g, r in ((got[0], ref[0]), (got, ref)))


def time_bank(bank):
    """ms per bank: the median over REPS of N_ITER banks, CUDA events."""
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(N_ITER):
            bank()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / N_ITER)
    return float(np.median(times))


def run_mode(name, bank, ref, gate):
    """First call (kernels built at first use), validation against the
    reference, then the timed banks: ``(per_bank_ms, (rel_err,
    rel_err over all filters), first_call_s)``. Raises if the output
    misses the gate."""
    t0 = time.time()
    out = bank()
    torch.cuda.synchronize()
    first_call_s = time.time() - t0
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError(f'{name}: non-finite output')
    err = rel_err(out, ref)
    log(f'{name}: first call {first_call_s:.1f}s, rel err {err[0]:.3e} '
        f'(gate {gate:.1e}), over all filters {err[1]:.3e}')
    if not err[0] <= gate:
        raise RuntimeError(f'{name}: rel err {err[0]} misses the gate '
                           f'{gate}; refusing to report throughput')
    del out
    ms = time_bank(bank)
    log(f'{name}: {ms:.3f} ms/bank')
    return ms, err, first_call_s


def main():
    if not torch.cuda.is_available():
        print('bench_torch: no CUDA device available', file=sys.stderr)
        sys.exit(1)
    from pygsp_tpu_torch.core.operators import LaplacianOp
    from pygsp_tpu_torch.core.windowed import windowed_from_scipy
    from pygsp_tpu_torch.ops import chebyshev as cheby

    W, dw, lmax = bench_graph()
    nnz = W.nnz
    t0 = time.time()
    Wneg = W.copy()
    Wneg.data = -Wneg.data
    H = windowed_from_scipy(Wneg, dtype=torch.float32, permute=None,
                            device='cuda')
    L = LaplacianOp(offdiag=H, diag=torch.from_numpy(dw).to('cuda'),
                    lap_type='combinatorial')
    torch.cuda.synchronize()
    log(f'windowed format built and staged in {time.time() - t0:.1f}s; '
        f'slabs {tuple(H.cols.shape)}, {len(H.levels)} level tiers')

    scales = torch.tensor(SCALES, dtype=torch.float32, device='cuda')
    c = cheby.cheby_coeff(
        lambda lam: torch.exp(-scales[:, None] * lam[None, :] / lmax), lmax,
        m=K_ORDER, dtype=torch.float32)
    gen = torch.Generator(device='cuda').manual_seed(0)
    x = torch.randn((N, N_SIGNALS), generator=gen, device='cuda')
    t0 = time.time()
    ref, cpu_eps = reference(W, dw, lmax, c.double().cpu().numpy(),
                             x[:, :N_CHECK_COLS].double().cpu().numpy())
    log(f'reference scipy f64: {cpu_eps:.3e} edge-ops/s '
        f'({time.time() - t0:.1f}s)')

    edge_ops = K_ORDER * nnz * N_SIGNALS

    def roofline_ms(item, val_item):
        """bench.py:258: per step, every stored edge's x row (``item``
        bytes a value) and its column and value read, and one output row
        written, at the HBM rate."""
        least = K_ORDER * (nnz * (item * N_SIGNALS + 4 + val_item)
                           + N * N_SIGNALS * item)
        return least / HBM_BYTES_PER_S * 1e3

    ms32, err32, first32 = run_mode(
        'f32', lambda: cheby.cheby_op(L, lmax, c, x), ref, GATE_F32)
    ms16, err16, first16 = run_mode(
        'bf16 fast mode', lambda: cheby.cheby_op(
            L, lmax, c, x, carry_dtype=torch.bfloat16,
            vals_dtype=torch.bfloat16), ref, GATE_BF16)
    fast = ms16 < ms32
    ms, err = (ms16, err16) if fast else (ms32, err32)
    roof32, roof16 = roofline_ms(4, 4), roofline_ms(2, 2)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    card, power = (s.strip() for s in smi.splitlines()[0].rsplit(',', 1))
    print(json.dumps({
        'metric': 'cheby_K30_heatbank_edge_ops_per_s',
        'unit': 'edge-ops/s/gpu',
        'value': edge_ops / (ms / 1e3),
        'vs_baseline': edge_ops / (ms / 1e3) / cpu_eps,
        'baseline': 'SciPy CSR float64 recurrence on the host, 8 columns',
        'pct_roofline': 100.0 * (roof16 if fast else roof32) / ms,
        'roofline_bytes_per_s': HBM_BYTES_PER_S,
        'roofline_note': 'the least bytes of one bank in the headline mode '
                         '(bench.py:258; bf16 rows, values and outputs in '
                         'the fast mode) at the H100 SXM HBM rate',
        'per_bank_ms': ms, 'carry': 'bf16' if fast else 'f32',
        'rel_err': err[0],
        'value_f32_exact': edge_ops / (ms32 / 1e3),
        'pct_roofline_f32': 100.0 * roof32 / ms32,
        'pct_roofline_bf16': 100.0 * roof16 / ms16,
        'per_bank_ms_f32': ms32, 'rel_err_f32': err32[0],
        'rel_err_f32_all_filters': err32[1],
        'per_bank_ms_bf16': ms16, 'rel_err_bf16': err16[0],
        'rel_err_bf16_all_filters': err16[1],
        'carry_error_estimate_bf16': cheby.carry_error_estimate(
            c, torch.bfloat16),
        'first_call_s_f32': first32, 'first_call_s_bf16': first16,
        'peak_device_gib': torch.cuda.max_memory_allocated() / 2**30,
        'nnz': nnz, 'lmax': lmax, 'card': card, 'power_limit': power,
    }), flush=True)


if __name__ == '__main__':
    main()
