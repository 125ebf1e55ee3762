"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` into a shared library under ``_build/`` at first
use and loaded with ``ctypes``. The library's file name carries a hash of
the source text, so an edited source is rebuilt and an unchanged one reused.
Nothing here runs at import time.

:func:`launch` is every wrapper's way to its kernel, and keeps the host's
cost per call near PyTorch's own dispatch: the configured ctypes function
is looked up once per (source, symbol), the device is switched only when
the tensors lie on another than the current one, and the current stream
is read once, as a raw handle.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD = os.path.join(_PKG, '_build')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC']

_libraries: dict = {}
_functions: dict = {}


def _nvcc() -> str:
    path = os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                        'bin', 'nvcc')
    if os.path.exists(path):
        return path
    path = shutil.which('nvcc')
    if path is None:
        raise RuntimeError('nvcc not found: set CUDA_HOME or put nvcc on '
                           'PATH to build the CUDA kernels')
    return path


def _paths(name: str):
    src = os.path.join(CSRC, name + '.cu')
    with open(src, 'rb') as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return src, os.path.join(BUILD, f'lib{name}-{digest}.so')


def build(names, extra_flags=()) -> dict:
    """Compile the named sources that are not built yet, one ``nvcc`` for
    each, all started together. Returns the compiler's output by name
    (``extra_flags=('-Xptxas', '-v')`` makes it list registers and spills);
    raises with that output if any build fails."""
    os.makedirs(BUILD, exist_ok=True)
    jobs = []
    for name in names:
        src, lib = _paths(name)
        if os.path.exists(lib):
            continue
        tmp = f'{lib}.{os.getpid()}.tmp'
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, *extra_flags, '-o', tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        jobs.append((name, lib, tmp, proc))
    outputs, errors = {}, []
    for name, lib, tmp, proc in jobs:
        outputs[name] = proc.communicate()[0].decode(errors='replace')
        if proc.returncode:
            errors.append(f'{name}:\n{outputs[name]}')
        else:
            os.replace(tmp, lib)
    if errors:
        raise RuntimeError('nvcc failed for ' + '\n'.join(errors))
    return outputs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libraries.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(_paths(name)[1])
        _libraries[name] = lib
    return lib


def function(name: str, symbol: str, n_pointers: int, n_ints: int):
    """A C function ``int symbol(void*..., int..., void* stream)`` of the
    library ``name``, with its ctypes signature declared once."""
    fn = _functions.get((name, symbol))
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.argtypes = ([ctypes.c_void_p] * n_pointers
                       + [ctypes.c_int] * n_ints + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _functions[(name, symbol)] = fn
    return fn


def refuse_autograd(name: str, *tensors):
    """Raise where autograd would record the kernel's call: grad mode is on
    and an operand requires grad. A kernel reads and writes raw pointers,
    so autograd sees none of its work; a gradient taken through it would
    come back wrong, with no error. Inside a ``torch.autograd.Function``'s
    forward and backward grad mode is off, so the kernels run there."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f'{name}: an operand requires grad, and the CUDA kernel is '
            f'invisible to autograd. Differentiate the Chebyshev filter '
            f'through pygsp_tpu_torch.ops.cheby_op_fixed_graph or '
            f'Filter.filter(fixed_graph=True), or run the call under '
            f'torch.no_grad()')


def launch(name: str, symbol: str, n_pointers: int, n_ints: int,
           device: int, *args):
    """Call ``symbol`` of ``csrc/<name>.cu`` with ``args`` (pointers, then
    ints) and the current stream of CUDA device ``device`` (an index), on
    that device. Raises if the C function returns a CUDA error."""
    fn = function(name, symbol, n_pointers, n_ints)
    if device == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(device))
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(device))
    if err:
        raise RuntimeError(f'{symbol} launch failed with CUDA error {err}')
