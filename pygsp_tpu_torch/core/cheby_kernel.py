"""The fused Chebyshev step (kernel B), with its plain versions.

Four CUDA kernels live in ``csrc/cheby_step.cu`` (see its note for the
design); they take the place of the XLA fusions inside the JAX package's
``lax.scan`` bodies (``pygsp_tpu/ops/chebyshev.py:186-190``, ``:264-272``,
``:323-334``, ``:621``), which eager PyTorch would run as one pass over
memory per operator:

- :func:`cheby_step`: ``out = carry((fd ⊙ t + sc·y) − t_old)``;
- :func:`cheby_acc_group`: ``acc[f] += Σ_j cg[j, f]·terms[j]``, the
  accumulation of g steps at once;
- :func:`cheby_acc_contract`: ``acc += Σ_f ck[f]·t[..., f]``, synthesis;
- :func:`cheby_dot_group`: ``out[j, f] = ⟨ḡ_f, terms[j]⟩``, the coefficient
  gradient of the fixed-graph VJP, a group of terms at a time (the JAX
  package's ``dot_all``, ``pygsp_tpu/ops/chebyshev.py:431-433``).

The arithmetic is in the signal's dtype (``fdiag``'s, float32 or float64);
the terms may be carried narrower (bfloat16 beside float32). Each plain
version of the first three is the same single operations in the same
order, so on the card a kernel and its plain version agree bit for bit; the
fourth sums in float64 in its own order. Each wrapper launches its
kernel for CUDA tensors, runs the plain version for CPU tensors, and counts
its launches in ``.launches``. The accumulators are updated in place.
"""

from __future__ import annotations

import torch

from pygsp_tpu_torch.core import _cuda

_SOURCE = 'cheby_step'
# (signal dtype, carry dtype) -> the kernels' suffix
_TYPES = {(torch.float32, torch.float32): 'f32',
          (torch.float64, torch.float64): 'f64',
          (torch.float32, torch.bfloat16): 'f32_bf16'}


def _check(name, md, tensors, dtypes):
    """One device, contiguity, and each tensor's dtype; raises on the
    first that does not hold."""
    dev = tensors[0].device
    for t, dt in zip(tensors, dtypes):
        if t.device != dev:
            raise ValueError(f'{name}: all operands must be on one device')
        if not t.is_contiguous():
            raise ValueError(f'{name}: all operands must be contiguous')
        if t.dtype != dt:
            raise ValueError(f'{name}: expected {dt}, got {t.dtype}')
    if dev.type not in ('cpu', 'cuda'):
        raise ValueError(f'{name} runs on cuda or cpu, not {dev}')
    if md not in (torch.float32, torch.float64):
        raise ValueError(f'{name} computes in float32 or float64, not {md}')


def _suffix(name, md, cd):
    suffix = _TYPES.get((md, cd))
    if suffix is None:
        raise ValueError(f'{name} has no kernel for {md} arithmetic with a '
                         f'{cd} carry (it has {sorted(_TYPES.values())})')
    return suffix


# ---------------------------------------------------------------------------
# (a) cheby_step
# ---------------------------------------------------------------------------

def cheby_step_plain(y, t, t_old, fdiag, sc, out):
    """Plain PyTorch version of :func:`cheby_step`, in single operations."""
    md = fdiag.dtype
    fd = fdiag.reshape((-1,) + (1,) * (t.ndim - 1))
    v = fd * t.to(md)
    v = v + sc * y.to(md)
    v = v - t_old.to(md)
    return out.copy_(v)


def cheby_step(y, t, t_old, fdiag, sc, out=None):
    """One Chebyshev step ``out = ((fd ⊙ t) + (sc·y)) − t_old`` with
    ``fd = fdiag[:, None]``, computed in ``fdiag``'s dtype and stored in
    ``t``'s (a bfloat16 carry is rounded to nearest even, as
    ``.to(torch.bfloat16)`` does). ``y``, ``t``, ``t_old`` and ``out``
    (N, ...) share the carry dtype; ``sc`` is a 0-dim tensor of the signal
    dtype. ``out`` may be given (it must not alias an input) or is
    allocated. Returns ``out``."""
    md, cd = fdiag.dtype, t.dtype
    if out is None:
        out = torch.empty_like(t)
    _check('cheby_step', md, [y, t, t_old, out, fdiag, sc],
           [cd, cd, cd, cd, md, md])
    if (t.ndim == 0 or not y.shape == t_old.shape == out.shape == t.shape
            or fdiag.shape != t.shape[:1] or sc.ndim != 0):
        raise ValueError(f'cheby_step: y, t, t_old, out (N, ...), fdiag (N,) '
                         f'and a 0-dim sc, got {tuple(y.shape)}, '
                         f'{tuple(t.shape)}, {tuple(t_old.shape)}, '
                         f'{tuple(out.shape)}, {tuple(fdiag.shape)}, '
                         f'{tuple(sc.shape)}')
    if t.device.type == 'cpu':
        return cheby_step_plain(y, t, t_old, fdiag, sc, out)
    _cuda.refuse_autograd('cheby_step', y, t, t_old, fdiag, sc, out)
    n_rows = t.shape[0]
    _cuda.launch(_SOURCE, 'cheby_step_' + _suffix('cheby_step', md, cd), 6, 2,
                 t.get_device(), y.data_ptr(), t.data_ptr(), t_old.data_ptr(),
                 fdiag.data_ptr(), sc.data_ptr(), out.data_ptr(), n_rows,
                 t.numel() // max(n_rows, 1))
    cheby_step.launches += 1
    return out


cheby_step.launches = 0


# ---------------------------------------------------------------------------
# (b) cheby_acc_group
# ---------------------------------------------------------------------------

def cheby_acc_group_plain(acc, terms, cg, start: int = 0):
    """Plain PyTorch version of :func:`cheby_acc_group`."""
    md = acc.dtype
    slots = terms.shape[0]
    for f in range(cg.shape[1]):
        s = None
        for j in range(cg.shape[0]):
            p = cg[j, f] * terms[(start + j) % slots].to(md)
            s = p if s is None else s + p
        acc[f] = acc[f] + s
    return acc


def cheby_acc_group(acc, terms, cg, start: int = 0):
    """``acc[f] = acc[f] + Σ_j cg[j, f]·terms[(start + j) % R]`` for the
    ``g`` rows of ``cg (g, Nf)``, in place: each filter's sum runs over j
    left to right and ``acc`` is added last, as the JAX package's grouped
    accumulation does. ``terms (R, N, ...)`` is a ring of ``R >= g`` terms
    in the carry dtype; ``acc (Nf, N, ...)`` and ``cg`` are in the signal
    dtype. Returns ``acc``."""
    md, cd = acc.dtype, terms.dtype
    g, nf = cg.shape
    if (terms.shape[1:] != acc.shape[1:] or acc.shape[0] != nf
            or not 0 < g <= terms.shape[0] or start < 0):
        raise ValueError(f'cheby_acc_group: acc (Nf, N, ...), a ring of '
                         f'terms (R >= g, N, ...) and cg (g, Nf), got '
                         f'{tuple(acc.shape)}, {tuple(terms.shape)}, '
                         f'{tuple(cg.shape)}')
    _check('cheby_acc_group', md, [acc, terms, cg], [md, cd, md])
    if acc.device.type == 'cpu':
        return cheby_acc_group_plain(acc, terms, cg, start)
    _cuda.refuse_autograd('cheby_acc_group', acc, terms, cg)
    n_rows = acc.shape[1]
    _cuda.launch(_SOURCE, 'cheby_acc_group_' + _suffix('cheby_acc_group', md,
                                                       cd),
                 3, 6, acc.get_device(), acc.data_ptr(), terms.data_ptr(),
                 cg.data_ptr(), n_rows, acc[0].numel() // max(n_rows, 1),
                 terms.shape[0], start % terms.shape[0], g, nf)
    cheby_acc_group.launches += 1
    return acc


cheby_acc_group.launches = 0


# ---------------------------------------------------------------------------
# (c) cheby_acc_contract
# ---------------------------------------------------------------------------

def cheby_acc_contract_plain(acc, t, ck):
    """Plain PyTorch version of :func:`cheby_acc_contract`."""
    md = acc.dtype
    s = ck[0] * t[..., 0].to(md)
    for f in range(1, ck.shape[0]):
        s = s + ck[f] * t[..., f].to(md)
    acc.copy_(acc + s)
    return acc


def cheby_acc_contract(acc, t, ck):
    """``acc = acc + Σ_f ck[f]·t[..., f]`` in place, the sum over the
    filters left to right, for ``t (N, ..., Nf)`` in the carry dtype and
    ``acc (N, ...)`` and ``ck (Nf,)`` in the signal dtype. Returns
    ``acc``."""
    md, cd = acc.dtype, t.dtype
    if (t.shape[:-1] != acc.shape or ck.shape != t.shape[-1:] or acc.ndim == 0
            or ck.shape[0] == 0):
        raise ValueError(f'cheby_acc_contract: acc (N, ...), t (N, ..., Nf) '
                         f'and ck (Nf,), got {tuple(acc.shape)}, '
                         f'{tuple(t.shape)}, {tuple(ck.shape)}')
    _check('cheby_acc_contract', md, [acc, t, ck], [md, cd, md])
    if acc.device.type == 'cpu':
        return cheby_acc_contract_plain(acc, t, ck)
    _cuda.refuse_autograd('cheby_acc_contract', acc, t, ck)
    n_rows = acc.shape[0]
    _cuda.launch(_SOURCE, 'cheby_acc_contract_'
                 + _suffix('cheby_acc_contract', md, cd),
                 3, 3, acc.get_device(), acc.data_ptr(), t.data_ptr(),
                 ck.data_ptr(), n_rows, acc.numel() // max(n_rows, 1),
                 ck.shape[0])
    cheby_acc_contract.launches += 1
    return acc


cheby_acc_contract.launches = 0


# ---------------------------------------------------------------------------
# (d) cheby_dot_group
# ---------------------------------------------------------------------------

# Rows of the float64 partials a cheby_dot_group launch may fill: pass 1
# runs as many blocks as fit the card at once (for a group of more than one
# term, 3 blocks of 128 threads on each of an H100's 132 SMs), at most this
# many.
DOT_MAX_BLOCKS = 1024
_DOT_TYPES = {torch.float32: 'f32', torch.float64: 'f64'}


def cheby_dot_group_plain(out, gbar, terms, start: int = 0):
    """Plain PyTorch version of :func:`cheby_dot_group`: one einsum per
    term of the group, in the operands' dtype."""
    slots, nf = terms.shape[0], gbar.shape[-1]
    gb = gbar.reshape(-1, nf)
    for j in range(out.shape[0]):
        out[j] = torch.einsum('nf,n->f', gb,
                              terms[(start + j) % slots].reshape(-1))
    return out


def cheby_dot_group_bound(gbar, terms, start: int, g: int, out_dtype):
    """``(g, Nf)`` float64: how far :func:`cheby_dot_group` may lie from a
    float64 reference, ``((2n + 2)·2^-53 + u)·Σ|ḡ_f||t_j|`` over the n
    values, u the unit roundoff of ``out_dtype``: the summation bounds of
    the kernel and of the reference, whatever their orders, and the
    output's one rounding."""
    slots, nf = terms.shape[0], gbar.shape[-1]
    gb = gbar.reshape(-1, nf).abs().double()
    n = gb.shape[0]
    mass = torch.stack([terms[(start + j) % slots].reshape(-1).abs().double()
                        @ gb for j in range(g)])
    return ((2 * n + 2) * 2.0**-53 + torch.finfo(out_dtype).eps / 2) * mass


def cheby_dot_group(out, gbar, terms, start: int = 0):
    """``out[j, f] = ⟨gbar[..., f], terms[(start + j) % R]⟩`` over all
    values, for the ``g`` rows of ``out (g, Nf)``: the coefficient gradient
    of :func:`~pygsp_tpu_torch.ops.chebyshev.cheby_op_fixed_graph`, one
    group of recurrence terms at a time. ``gbar (N, ..., Nf)`` is the
    cotangent bank with the filter axis last, ``terms (R, N, ...)`` a ring
    of ``R >= g`` terms; all in one dtype, float32 or float64. The kernel
    sums in float64 and rounds once to ``out``'s dtype; two launches are
    bit-equal. Returns ``out``."""
    g, nf = out.shape if out.ndim == 2 else (0, 0)
    if (gbar.shape != terms.shape[1:] + (nf,) or not 0 < g <= terms.shape[0]
            or start < 0):
        raise ValueError(f'cheby_dot_group: out (g, Nf), gbar (N, ..., Nf) '
                         f'and a ring of terms (R >= g, N, ...), got '
                         f'{tuple(out.shape)}, {tuple(gbar.shape)}, '
                         f'{tuple(terms.shape)}')
    md = gbar.dtype
    _check('cheby_dot_group', md, [out, gbar, terms], [md, md, md])
    if out.device.type == 'cpu':
        return cheby_dot_group_plain(out, gbar, terms, start)
    _cuda.refuse_autograd('cheby_dot_group', out, gbar, terms)
    n_rows = terms.shape[1]
    partials = torch.empty((DOT_MAX_BLOCKS, g, nf), dtype=torch.float64,
                           device=out.device)
    _cuda.launch(_SOURCE, 'cheby_dot_group_' + _DOT_TYPES[md], 4, 7,
                 out.get_device(), out.data_ptr(), partials.data_ptr(),
                 gbar.data_ptr(), terms.data_ptr(), n_rows,
                 terms[0].numel() // max(n_rows, 1), terms.shape[0],
                 start % terms.shape[0], g, nf, DOT_MAX_BLOCKS)
    cheby_dot_group.launches += 1
    return out


cheby_dot_group.launches = 0


KERNELS = (cheby_step, cheby_acc_group, cheby_acc_contract, cheby_dot_group)
