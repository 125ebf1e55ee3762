"""Where one filter bank's time goes on the card, for the PyTorch port.

Runs the port's four paths as ``chip_smoke.py`` sets them up (its
``path_a``, ``path_b``, ``path_c`` and ``fast_bank``, imported from
there): path A, the Barabási–Albert graph of ``bench.py`` (N = 2^20, m0 =
m = 8) through the CSR SpMM kernel; path B, ``Grid2d(512, 512)`` through
the banded SpMM kernel; path C, the same BA graph in the windowed-compact
format through the windowed fold and tail kernels; path D, path C in the
bf16 fast mode (``carry_dtype`` and ``vals_dtype`` bfloat16) through their
bf16 instances; each a 4-scale heat bank at order 30 on 128 float32
signals, with the fused Chebyshev step (kernel B) on every path. For
each path it runs one bank as a warm-up, then one bank under
``torch.profiler`` and prints one JSON line: the bank's
host time, the sum of kernel times on the card (busy), the idle share, and
kernel time by group (the port's SpMM kernels, the other kernels by name),
and "everything else", PyTorch's own kernels in the bank, counted and timed
by class (``index_add_``, ``index_select`` (the hoisted permutes),
gathers, reductions, elementwise and casts).
It also times a 1 GiB device-to-device copy, the memory rate the card
reaches, and, first, the host's cost of each step on a kernel's launch path
(``double`` at (8, 128), TPU kernel #4, beside ``torch.mul``): microseconds
per call of the wrapper and of each step it takes, and of the steps that
the launch path took before it was cut to PyTorch's own dispatch; and
``fold_products``' device time at TPU kernel #2's probe shape with each of
the KP tiles its kernel takes.

Run: ``python3 tools/profile_torch_port.py [--out DIR]`` on a machine with
one CUDA device; ``--out`` also writes each path's profiler table there.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the paths' one definition)
from pygsp_tpu_torch.core import _cuda  # noqa: E402
from pygsp_tpu_torch.core import windowed_kernel as wk  # noqa: E402


def products_tiles(iters=20):
    """Device ms per launch of ``fold_products`` at TPU kernel #2's probe
    shape (NW 1024, Lt 1152, KP 256, S 128, bf16 products, row ids from a
    seed) with each KP tile the kernel takes, 64, 128 and 256 rows: every
    block reads its window's products, so fewer tiles read fewer bytes."""
    gen = torch.Generator(device='cuda').manual_seed(5)
    nw, lt, kp = chip_smoke.FOLD2_NW, chip_smoke.FOLD2_LT, chip_smoke.FOLD2_KP
    rid = torch.randint(0, kp, (nw, lt), dtype=torch.int32, device='cuda',
                        generator=gen)
    p = chip_smoke.seeded_normal((nw, lt, 128), 6).to(torch.bfloat16)
    out = torch.empty(nw, kp, 128, device='cuda')
    times = {}
    for block_m in (64, 128, 256):
        times[block_m] = chip_smoke.device_ms(lambda: _cuda.launch(
            'windowed_fold', 'fold_products_bf16', 3, 5, out.get_device(),
            rid.data_ptr(), p.data_ptr(), out.data_ptr(), nw, lt, kp, 128,
            block_m), iters)
    return times


def launch_path(iters=20_000):
    """Microseconds of host time per call of ``double`` at (8, 128), of
    ``torch.mul(x, 2)``, and of each step of the wrapper's launch path;
    the steps marked ``old`` are those the path took before (a ctypes
    lookup with its signature declared on every call, the device entered
    on every call, the stream read as a Stream object)."""
    x = torch.arange(8 * 128, dtype=torch.float32, device='cuda').reshape(
        8, 128)
    y = torch.empty_like(x)
    dev = x.get_device()
    fn = _cuda.function('windowed_fold', 'double_f32', 2, 1)
    raw = torch._C._cuda_getCurrentRawStream(dev)
    lib = _cuda.library('windowed_fold')

    def old_lookup():
        f = getattr(lib, 'double_f32')
        f.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
        f.restype = ctypes.c_int

    def old_device():
        with torch.cuda.device(x.device):
            pass

    steps = {
        'double (the wrapper)': lambda: wk.double(x),
        'torch.mul(x, 2)': lambda: torch.mul(x, 2),
        'dtype and operand checks': lambda: (
            x.dtype != torch.float32,
            wk._check_operands('double', (x,), x), x.device.type == 'cpu'),
        'torch.empty_like': lambda: torch.empty_like(x),
        'data_ptr x2 and numel': lambda: (x.data_ptr(), y.data_ptr(),
                                          x.numel()),
        'cached ctypes function': lambda: _cuda.function(
            'windowed_fold', 'double_f32', 2, 1),
        'torch.cuda.current_device': torch.cuda.current_device,
        'raw current stream': lambda: torch._C._cuda_getCurrentRawStream(
            dev),
        'ctypes call (kernel launch)': lambda: fn(x.data_ptr(), y.data_ptr(),
                                                  x.numel(), raw),
        'old: getattr + argtypes': old_lookup,
        'old: with torch.cuda.device': old_device,
        'old: current_stream().cuda_stream':
            lambda: torch.cuda.current_stream().cuda_stream,
    }
    out = {}
    for name, step in steps.items():
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / iters * 1e6
    return out


def copy_rate():
    """Bytes moved per second by a 1 GiB device copy (read + write)."""
    src = torch.empty(2**28, dtype=torch.float32, device='cuda').normal_()
    dst = torch.empty_like(src)
    dst.copy_(src)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    iters = 20
    start.record()
    for _ in range(iters):
        dst.copy_(src)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / iters
    return 2 * src.numel() * 4 / (ms / 1e3)


# PyTorch's own kernels in a bank, by what they do (a substring of the
# kernel's name): the residue tiers' former plain path was made of these
LAUNCH_CLASSES = (('index_add', ('indexFuncLargeIndex', 'indexFuncSmallIndex',
                                 'index_add')),
                  ('index_select', ('indexSelect',)),
                  ('gather', ('index_elementwise', 'gather')),
                  ('reduction', ('reduce_kernel',)),
                  ('elementwise', ('elementwise',)))


def launch_class(name):
    """The class of a PyTorch kernel by its name, else 'other'."""
    return next((cls for cls, keys in LAUNCH_CLASSES
                 if any(k in name for k in keys)), 'other')


def profile_bank(name, kernels, bank, out_dir):
    bank()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bank()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    groups = {}
    others = {}     # PyTorch's kernels outside the port's, by class
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        ms_ev = (ev.time_range.end - ev.time_range.start) / 1e3
        key = next((k for k in kernels if k in ev.name), None)
        if key is None:
            cls = launch_class(ev.name)
            ms, count = others.get(cls, (0.0, 0))
            others[cls] = (ms + ms_ev, count + 1)
            key = ev.name[:90]
        ms, count = groups.get(key, (0.0, 0))
        groups[key] = (ms + ms_ev, count + 1)
    busy_ms = sum(ms for ms, _ in groups.values())
    top = sorted(groups.items(), key=lambda kv: -kv[1][0])[:12]
    if out_dir:
        with open(os.path.join(out_dir, f'profile_{name}.txt'), 'w') as f:
            f.write(prof.key_averages().table(
                sort_by='self_device_time_total', row_limit=40))
    return {
        'path': name, 'host_ms': host_ms, 'busy_ms': busy_ms,
        'idle_share': 1.0 - busy_ms / host_ms,
        'kernels': [{'name': k, 'ms': ms, 'count': count}
                    for k, (ms, count) in top],
        'everything_else_ms': sum(ms for ms, _ in others.values()),
        'everything_else': {cls: {'ms': ms, 'count': count}
                            for cls, (ms, count) in sorted(others.items())},
    }


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--out', help='directory for the profiler tables')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit('profile_torch_port: no CUDA device available')
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip()
    print(json.dumps({'card': smi, 'launch_path_us': launch_path(),
                      'products_tile_ms': products_tiles(),
                      'copy_bytes_per_s': copy_rate()}), flush=True)
    step = ('cheby_step', 'cheby_acc_group')
    windowed = ('windowed_fold', 'window_strip') + step
    # kernel A's device functions, its fused entry (the backward through
    # the weights' transpose SpMM and SDDMM) among them
    csr = ('csr_spmm_segment', 'csr_spmm_join', 'csr_spmm_narrow',
           'csr_spmm_sddmm')
    for name, kernels, make in (
            ('A', csr + step, chip_smoke.path_a),
            ('B', ('banded_spmm',) + step, chip_smoke.path_b)):
        bank = make()[-1]
        print(json.dumps(profile_bank(name, kernels, bank, args.out)),
              flush=True)
        del bank
        torch.cuda.empty_cache()
    # path D is path C's graph and signal in the bf16 fast mode
    _, g, x, bank = chip_smoke.path_c()
    for name, bank in (('C', bank), ('D', chip_smoke.fast_bank(g, x))):
        print(json.dumps(profile_bank(name, windowed, bank, args.out)),
              flush=True)


if __name__ == '__main__':
    main()
