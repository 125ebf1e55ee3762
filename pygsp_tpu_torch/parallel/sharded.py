"""Sharded spectral ops: the 1-D engine, a halo exchange a step, and the
Chebyshev recurrence on each rank's slice.

Counterpart of :mod:`pygsp_tpu.parallel.sharded`. Per SpMM step each rank
(its shard of the mesh axis ``'graph'``):

1. gathers the rows its neighbours need (``send_idx``) and posts their
   exchange, one ring shift per distance with traffic, all at once
   (:func:`_halo_post`, :func:`~.mesh.ppermute_post`);
2. multiplies its local off-diagonal block by ``[x_local ‖ received]``:
   kernel A on a CSR of the shard's rows (the COO layout), the ELL kernel
   (:func:`~pygsp_tpu_torch.parallel.partition.shard_local_ell`, whole or
   split), or kernels D and E (the windowed layouts of
   :mod:`.windowed_shards`). The split layouts fold the interior on
   ``x_local`` between the post and the wait, so that it runs under the
   exchange (the JAX package's ``_local_matvec``: that fold has no data
   dependency on the collective), and the boundary, after the wait, on the
   received block (windowed) or on ``[x_local ‖ received]`` (ELL); the
   whole layouts have no fold that does not read the halo, and wait at
   once;
3. adds the diagonal term, in the fused step kernel (kernel B).

Under autograd (grad mode on, ``c`` or the signal requiring grad) the bank,
the synthesis and the matvec go through autograd Functions (:class:`_Bank`,
:class:`_Synthesis`, :class:`_Matvec`, which the 2-D engine shares): the
forward is the engine's own, unrecorded, so that on the card the kernels
launch as they do without autograd; the backward runs fresh engine calls
of its own, through the same exchanges: the bank's x̄ is the synthesis of
its cotangent and the synthesis's ȳ the bank of its cotangent (the shifted
operator is symmetric), and c̄ is one more recurrence whose dots are summed
over the mesh (``psum``), so that every rank holds the whole c̄, as
``jax.grad`` gives each device of a ``shard_map`` with ``c`` replicated.
What autograd cannot reach raises ``ValueError``: a bf16 mode (ROADMAP.md
§1 item 6), a λmax tensor or a partition tensor that requires grad (§1
item 7).

The recurrence is the single-device one (:mod:`pygsp_tpu_torch.ops.
chebyshev`): kernel B's ``cheby_step`` a step and ``cheby_acc_group``
once per group of terms, the group chosen by the JAX package's sharded
rule (:func:`_sharded_acc_group`). Signals are the calling rank's slice:
``x`` is its ``n_local`` rows (its column block too when the mesh's
``'batch'`` axis is larger than one), and so is every result; a (1, 1)
mesh takes the whole padded signal.

Departure by design: the JAX package carries its windowed-shard
recurrence as tuples of per-chunk buffers (``_chunkcarried_scan``), a
device for XLA's memory; the port carries whole tensors, as its
single-device windowed path does, and sums the same terms.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from pygsp_tpu_torch.core import cheby_kernel, windowed
from pygsp_tpu_torch.core import sparse as sp
from pygsp_tpu_torch.core.sparse import BF16_GRAD
from pygsp_tpu_torch.ops.chebyshev import (_MAX_GROUP, _check_carry_budget,
                                           _grouped_steps)
from pygsp_tpu_torch.parallel.mesh import (Mesh, ppermute_post,
                                           ppermute_wait, psum, scope)
from pygsp_tpu_torch.parallel.partition import (ShardedELL, ShardedGraph,
                                                _cached, shard_slice)
from pygsp_tpu_torch.parallel.windowed_shards import ShardedWindowed


def make_mesh(n_graph: int, n_batch: int = 1, devices=None) -> Mesh:
    """('graph', 'batch') mesh over the first ``n_graph * n_batch`` ranks
    of the world, graph axis major. ``devices``: one per rank (a list), or
    one for this rank; by default the card ``rank % device_count``. With
    no process group, ``make_mesh(1, 1)`` is a one-rank mesh."""
    return Mesh({'graph': n_graph, 'batch': n_batch}, devices)


# what the engines do not differentiate: ROADMAP.md §1 item 7
ENGINE_GRAD = ('{}: {} requires grad, and the engines differentiate with '
               'respect to c and the signal only (ROADMAP.md §1 item 7, λ̄ '
               'and the partition\'s cotangents on the engines); detach it, '
               'or call the engine under torch.no_grad()')


def _tensors(obj):
    """Every tensor of a partition or a layout: a tensor, a tuple's items
    and a dataclass's fields, recursively."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, tuple):
        for item in obj:
            yield from _tensors(item)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))


def _records(name: str, inputs, lmax=None, parts=(),
             narrow: bool = False) -> bool:
    """Whether autograd records the engine call ``name``: grad mode is on
    and one of ``inputs`` (``c``, the signal) requires grad. Where grad
    mode is on it raises ``ValueError`` for what the engines' Functions
    would leave out: a λmax tensor or a tensor of the partition or its
    layout (``parts``) that requires grad (ROADMAP.md §1 item 7), and,
    where it records, a bf16 mode (``narrow``; §1 item 6)."""
    if not torch.is_grad_enabled():
        return False
    if getattr(lmax, 'requires_grad', False):
        raise ValueError(ENGINE_GRAD.format(name, 'λmax'))
    if any(t.requires_grad for t in _tensors(parts)):
        raise ValueError(ENGINE_GRAD.format(
            name, 'a tensor of the partition or its layout'))
    if not any(t.requires_grad for t in inputs):
        return False
    if narrow:
        raise ValueError(BF16_GRAD.format(name))
    return True


def _leaf(t: torch.Tensor, s: int) -> torch.Tensor:
    """Shard ``s`` of a stacked leaf, or the one shard a rank holds."""
    return t[0] if t.shape[0] == 1 else t[s]


def _halo_post(x_local, send_idx, dists, mesh):
    """Gather send rows and post their exchange per ring distance (the
    ``halo_exchange`` range, as the JAX package's scope): returns the
    handle that :func:`_halo_join` takes. ``send_idx``: this shard's
    (H_d,) int64 id maps, padding clamped into range (the padding slots
    carry a copy of some row, which no edge references). On one shard
    nothing is posted."""
    with scope('halo_exchange'):
        return ppermute_post(mesh, 'graph', [
            (d, x_local.index_select(0, sidx))
            for d, sidx in zip(dists, send_idx)])


def _halo_join(x_local, handle):
    """Wait for the halo that :func:`_halo_post` posted: the ``(Σ H_d,
    ...)`` received block in ``dists`` order."""
    blocks = ppermute_wait(handle)
    if not blocks:
        return x_local.new_zeros((0,) + tuple(x_local.shape[1:]))
    return torch.cat(blocks) if len(blocks) > 1 else blocks[0]


def _csr_local(sg: ShardedGraph, s: int) -> sp.CSRMatrix:
    """Shard ``s``'s COO slice as a CSR over the extended columns (kernel
    A's operand); built once and kept."""
    def build():
        rows, cols = _leaf(sg.rows, s), _leaf(sg.cols, s)
        n, n_ext = sg.n_local, sg.n_local + sg.halo_total
        real = rows < n
        counts = torch.bincount(rows[real].long(), minlength=n)
        rowptr = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
        return sp.CSRMatrix(rows=rows, cols=torch.where(real, cols, n_ext),
                            vals=_leaf(sg.vals, s),
                            rowptr=rowptr.to(torch.int32), n_rows=n,
                            n_cols=n_ext, nnz=int(real.sum()))
    return _cached(sg, ('csr', s), build)


def _local_windowed(ell: ShardedWindowed, s: int):
    return _cached(ell, ('local', s),
                   lambda: shard_slice(ell, s).local_matrix())


def _local_ell(ell: ShardedELL, s: int, n_cols: int):
    return _cached(ell, ('local', s, n_cols),
                   lambda: shard_slice(ell, s).local_matrix(n_cols))


def _product(mat, x, out_dtype):
    """``mat @ x`` (x 2-D) on the matrix's kernel, in ``out_dtype``."""
    if isinstance(mat, windowed.WindowedELLMatrix):
        return windowed.spmm_internal(mat, x, out_dtype=out_dtype)
    return sp.spmm(mat, x, out_dtype=out_dtype)


class _Side:
    """One rank's side of an engine's operator: ``diag`` (its slice of the
    diagonal), ``product(t, out_dtype)`` (the off-diagonal times the
    distributed ``t``, exchanges included), ``mesh``, ``ell`` (the local
    layout) and ``n_devices``; what the recurrence and the Functions
    take."""

    def group(self, x, nf: int, cdt=None) -> int:
        """The accumulator group of a recurrence on ``x`` with ``nf``
        (n, ...) blocks held beside its terms
        (:func:`_sharded_acc_group`)."""
        return _sharded_acc_group(x, nf, self.ell, cdt, self.n_devices)


class _Shard(_Side):
    """One rank's side of the 1-D operator (the JAX package's
    ``_local_matvec``): its diagonal, and the off-diagonal product of its
    rows with the halo exchange, in the four branches of the local
    layouts."""

    def __init__(self, sg: ShardedGraph, mesh: Mesh, ell):
        if mesh.shape['graph'] != sg.n_shards:
            raise ValueError(f"the mesh's 'graph' axis ({mesh.shape['graph']}"
                             f") must equal the partition's shards "
                             f'({sg.n_shards})')
        self.sg, self.mesh, self.ell = sg, mesh, ell
        self.n_devices = sg.n_shards
        s = self.s = mesh.index('graph')
        self.diag = _leaf(sg.diag, s)
        self.send = _cached(sg, ('send', s), lambda: [
            _leaf(t, s).long().clamp(max=sg.n_local - 1)
            for t in sg.send_idx])
        n_ext = sg.n_local + sg.halo_total
        if ell is None:
            self.mats = (_csr_local(sg, s),)
        elif isinstance(ell, ShardedWindowed):
            self.mats = (_local_windowed(ell, s),)
        elif isinstance(ell, ShardedELL):
            self.mats = (_local_ell(ell, s, n_ext),)
        elif (isinstance(ell, tuple) and len(ell) == 2
              and all(isinstance(e, ShardedWindowed) for e in ell)):
            self.mats = (_local_windowed(ell[0], s),
                         _local_windowed(ell[1], s) if ell[1].nnz else None)
        elif (isinstance(ell, tuple) and len(ell) == 2
              and all(isinstance(e, ShardedELL) for e in ell)):
            self.mats = (_local_ell(ell[0], s, sg.n_local),
                         _local_ell(ell[1], s, n_ext))
        else:
            raise TypeError(f'unknown local layout {type(ell).__name__}')

    def post(self, t):
        return _halo_post(t, self.send, self.sg.halo_dists, self.mesh)

    def product(self, t, out_dtype):
        """The off-diagonal of this rank's rows times the distributed
        ``t`` (its local slice), in ``out_dtype``: the halo posted, the
        split layouts' interior folded under it, then what reads the
        halo."""
        shape = t.shape
        t2 = t.reshape(shape[0], -1)
        handle = self.post(t2)
        if isinstance(self.ell, tuple):
            interior, boundary = self.mats
            y = _product(interior, t2, out_dtype)
            recv = _halo_join(t2, handle)
            if boundary is not None:
                if isinstance(self.ell[0], ShardedELL):
                    recv = torch.cat([t2, recv])
                y = y + _product(boundary, recv, out_dtype)
        else:
            recv = _halo_join(t2, handle)
            y = _product(self.mats[0], torch.cat([t2, recv]), out_dtype)
        return y.reshape(shape)


def _matvec(side: _Side, x):
    """``L @ x`` on a rank's side of an engine, ``x`` in the promoted
    dtype."""
    d = side.diag.to(x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))
    return d * x + side.product(x, x.dtype)


def sharded_matvec(sg: ShardedGraph, x, mesh: Mesh, ell=None):
    """``L @ x`` for this rank's slice ``x`` (``n_local`` rows, its column
    block on a batch-sharded mesh). Pass ``ell = shard_local_ell(sg)`` or
    a windowed layout to take their kernels; without, kernel A runs on the
    shard's CSR. Under autograd x̄ is the matvec of the cotangent
    (:class:`_Matvec`)."""
    x = torch.as_tensor(x)
    sh = _Shard(sg, mesh, ell)
    x = x.to(torch.promote_types(x.dtype, sg.dtype))
    if _records('sharded_matvec', (x,), parts=(sg, ell)):
        return _Matvec.apply(sh, x)
    return _matvec(sh, x)


# ---------------------------------------------------------------------------
# the recurrence on one rank's slice
# ---------------------------------------------------------------------------

def _layout_bytes(ell) -> int:
    """Bytes of one shard of a layout (its stacked tensors over their
    shard axis)."""
    return sum(t.nbytes // max(t.shape[0], 1) for t in _tensors(ell)
               if t.ndim)


def _sharded_acc_group(x, nf, ell, cdt, n_shards):
    """Accumulator-group size for the sharded recurrence: the JAX
    package's rule on what one rank holds — the largest g (up to 14) whose
    g recurrence terms fit the device budget ``PYGSP_CHEBY_DEVICE_MB``
    after the layout's slabs and the Nf accumulators."""
    per_shard = max(x.numel(), 1)
    odt_b = x.element_size()
    term_bytes = per_shard * (cdt.itemsize if cdt is not None else odt_b)
    acc_bytes = per_shard * odt_b
    budget = float(os.environ.get('PYGSP_CHEBY_DEVICE_MB', 12288)) * 2**20
    avail = (budget - _layout_bytes(ell) - nf * acc_bytes
             - 4 * max(term_bytes, acc_bytes))
    return max(1, min(_MAX_GROUP, int(avail // max(term_bytes, 1))))


def _start(product, diag, lmax: float, x, cdt):
    """``(t_old, t_cur, step)``: ``T̃_0 x`` and ``T̃_1 x`` on [0, lmax] in
    the carry dtype, and the step ``fd ⊙ t + sc·(A t) − t_old`` on kernel B
    with ``A t = product(t, dtype)``: the single-device windowed format's
    arithmetic (``pygsp_tpu_torch/ops/chebyshev.py:_start``)."""
    a1 = a2 = lmax / 2
    t_old = x if cdt is None else x.to(cdt)
    d = diag.to(x.dtype)
    db = d.reshape((-1,) + (1,) * (x.ndim - 1))
    y0 = product(t_old, t_old.dtype)
    t_cur = (((db * x + y0) - a2 * x) / a1).to(t_old.dtype)
    sc = 2.0 / a1
    fdiag = ((d - a2) * sc).contiguous()
    sct = torch.tensor(sc, dtype=x.dtype, device=x.device)

    def step(t, t_prev, out=None):
        return cheby_kernel.cheby_step(product(t, t.dtype), t, t_prev,
                                       fdiag, sct, out)

    return t_old, t_cur, step


def _analysis(product, diag, lmax, c, x, cdt, g):
    """The bank ``(Nf, n, ...)`` of the recurrence on this rank's slice."""
    nf, m1 = c.shape
    t_old, t_cur, step = _start(product, diag, lmax, x, cdt)
    cT = c.T.contiguous()
    acc = (0.5 * c[:, 0]).reshape((nf,) + (1,) * x.ndim) * x[None]
    cheby_kernel.cheby_acc_group(acc, t_cur[None], cT[1:2])
    if m1 > 2:
        _grouped_steps(step, m1, t_old, t_cur, min(g, m1 - 2),
                       lambda ring, k, size, start: cheby_kernel
                       .cheby_acc_group(acc, ring, cT[k:k + size], start))
    return acc


def _synthesis(product, diag, lmax, c, y, cdt):
    """``Σ_f Σ_k c[f, k] T̃_k y[..., f]`` on this rank's slice ``y (n, ...,
    Nf)``: each step's term contracted over the filter axis
    (``cheby_acc_contract``)."""
    t_old, t_cur, step = _start(product, diag, lmax, y, cdt)
    odt = y.dtype
    acc = (0.5 * c[:, 0] * t_old.to(odt) + c[:, 1] * t_cur.to(odt)).sum(-1)
    cT = c.T.contiguous()
    free = None
    for k in range(2, c.shape[1]):
        out = torch.empty_like(t_cur) if free is None else free
        t_new = step(t_cur, t_old, out)
        cheby_kernel.cheby_acc_contract(acc, t_new, cT[k])
        free = t_old if k > 2 else None
        t_old, t_cur = t_cur, t_new
    return acc


def _coeff_grads(product, diag, lmax, m1, x, gin, g, reduce):
    """``c̄ (Nf, m1)``, ``c̄[f, k] = ⟨T̃_k x, ḡ_f⟩`` (0.5 at k = 0): this
    rank's dots of each group of terms with its slice of the cotangents
    (``cheby_dot_group``), then ``reduce`` (the ``all_reduce`` over the
    axes that split the vertices, and the batch)."""
    nf = gin.shape[-1]
    cbar_t = torch.empty((m1, nf), dtype=x.dtype, device=x.device)
    t_old, t_cur, step = _start(product, diag, lmax, x, None)
    cheby_kernel.cheby_dot_group(cbar_t[0:1], gin, t_old[None].contiguous())
    cheby_kernel.cheby_dot_group(cbar_t[1:2], gin, t_cur[None])
    if m1 > 2:
        _grouped_steps(step, m1, t_old, t_cur, min(g, m1 - 2),
                       lambda ring, k, size, start: cheby_kernel
                       .cheby_dot_group(cbar_t[k:k + size], gin, ring, start))
    reduce(cbar_t)
    cbar_t[0] *= 0.5
    return cbar_t.T


def _prepare(c, x, sg_dtype, carry_dtype, carry_tol):
    """The JAX package's entry rules: ``(c (Nf, m+1), x, carry dtype or
    None)``, x promoted with the values' dtype unless it is carried narrow,
    a narrow carry gated by its error estimate."""
    x = torch.as_tensor(x)
    c = torch.atleast_2d(torch.as_tensor(c))
    if c.shape[1] < 2:
        raise ValueError('Chebyshev coefficients need order >= 1')
    cdt = carry_dtype
    if cdt is not None and cdt == x.dtype:
        cdt = None
    if cdt is not None:
        _check_carry_budget(c, cdt, carry_tol)
    else:
        x = x.to(torch.promote_types(x.dtype, sg_dtype))
    return c.to(dtype=x.dtype, device=x.device), x.contiguous(), cdt


def sharded_cheby_op(sg: ShardedGraph, lmax, c, x, mesh: Mesh, ell=None,
                     carry_dtype=None, carry_tol=None):
    """Chebyshev filter bank on the sharded graph.

    ``c`` (Nf, m+1); ``x`` this rank's slice, (n_local, ...). Returns
    (Nf, n_local, ...), the same math as
    :func:`pygsp_tpu_torch.ops.chebyshev.cheby_op` on the rank's rows.

    ``carry_dtype`` (e.g. ``torch.bfloat16``): the dtype of the carried
    recurrence terms, and so of the halo payload; row sums, the diagonal
    term and the accumulators stay in the signal's dtype. Gated by
    :func:`~pygsp_tpu_torch.ops.chebyshev.carry_error_estimate` against
    ``carry_tol``.

    Under autograd the bank differentiates with respect to ``c`` and
    ``x`` (:class:`_Bank`, a constant-memory backward); every rank gets
    the whole c̄.
    """
    c, x, cdt = _prepare(c, x, sg.dtype, carry_dtype, carry_tol)
    sh = _Shard(sg, mesh, ell)
    if _records('sharded_cheby_op', (c, x), lmax, (sg, ell),
                cdt is not None):
        return _Bank.apply(sh, float(lmax), _axes_1d(x.ndim), c, x)
    return _analysis(sh.product, sh.diag, float(lmax), c, x, cdt,
                     sh.group(x, c.shape[0], cdt))


def sharded_cheby_synthesis(sg: ShardedGraph, lmax, c, y, mesh: Mesh,
                            ell=None, carry_dtype=None, carry_tol=None):
    """Synthesis on the sharded graph: per-filter signals, summed.

    ``c``: (Nf, m+1); ``y``: this rank's slice (n_local, ..., Nf), feature
    axis last. Returns ``Σ_f Σ_k c[f,k] T̃_k(L) y[..., f]`` of shape
    (n_local, ...), the recurrence running Nf× wide through the halo
    exchange. ``carry_dtype``: as in :func:`sharded_cheby_op`. Under
    autograd it differentiates with respect to ``c`` and ``y``
    (:class:`_Synthesis`).
    """
    y = torch.as_tensor(y)
    nf = torch.atleast_2d(torch.as_tensor(c)).shape[0]
    if y.shape[-1] != nf:
        raise ValueError(f'last axis of y ({y.shape[-1]}) must equal the '
                         f'number of filters ({nf})')
    c, y, cdt = _prepare(c, y, sg.dtype, carry_dtype, carry_tol)
    sh = _Shard(sg, mesh, ell)
    if _records('sharded_cheby_synthesis', (c, y), lmax, (sg, ell),
                cdt is not None):
        return _Synthesis.apply(sh, float(lmax), _axes_1d(y.ndim - 1), c, y)
    return _synthesis(sh.product, sh.diag, float(lmax), c, y, cdt)


def sharded_cheby_op_fixed_graph(sg: ShardedGraph, lmax, c, x, mesh: Mesh,
                                 ell=None):
    """:func:`sharded_cheby_op` with a constant-memory backward, as the
    bank itself differentiates (:class:`_Bank`): the adjoint synthesis for
    x̄ (the shifted operator is symmetric) and a term-contraction pass for
    c̄, whose dots (``cheby_dot_group``) are summed by an ``all_reduce``
    over 'graph', and over 'batch' when the batch is sharded. Gradients
    flow to ``c`` and ``x`` only."""
    return sharded_cheby_op(sg, lmax, c, x, mesh, ell=ell)


# ---------------------------------------------------------------------------
# the engines under autograd (both engines: ``side`` is a rank's _Side)
# ---------------------------------------------------------------------------

def _axes_1d(ndim: int) -> tuple:
    """The 1-D mesh's axes that c̄'s dots are summed over for a signal of
    ``ndim`` dimensions (without the filter axis): 'batch' too where the
    signal has columns to shard."""
    return ('graph', 'batch') if ndim > 1 else ('graph',)


def _cbar(side: _Side, lmax: float, axes, m1: int, t, gin):
    """``c̄ (Nf, m1)``, ``c̄[f, k] = ⟨T̃_k t, gin[..., f]⟩`` (0.5 at k = 0)
    summed over the mesh's ``axes``: one recurrence on ``t`` with the
    (n, ..., Nf) block ``gin`` and the backward's cotangent held beside
    its terms."""
    nf = gin.shape[-1]
    return _coeff_grads(side.product, side.diag, lmax, m1, t, gin,
                        side.group(t, 2 * nf + 1),
                        lambda v: psum(side.mesh, axes, v))


class _Bank(torch.autograd.Function):
    """The engines' bank under autograd, with respect to ``c`` (Nf, m+1)
    and ``x`` (``sharded_cheby_op``, ``cheby_op_2d`` and their fixed-graph
    VJPs). The context keeps the side, λmax, c and x, nothing of the
    recurrence. Backward: x̄ the synthesis of the cotangent ḡ (moved to
    the last axis), c̄ the dots of x's terms with ḡ summed over ``axes``."""

    @staticmethod
    def forward(ctx, side, lmax, axes, c, x):
        ctx.side, ctx.lmax, ctx.axes = side, lmax, axes
        ctx.save_for_backward(c, x)
        return _analysis(side.product, side.diag, lmax, c, x, None,
                         side.group(x, c.shape[0]))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gout):
        c, x = ctx.saved_tensors
        side, lmax = ctx.side, ctx.lmax
        gin = gout.movedim(0, -1).contiguous()
        c_bar = x_bar = None
        if ctx.needs_input_grad[4]:
            x_bar = _synthesis(side.product, side.diag, lmax, c, gin, None)
        if ctx.needs_input_grad[3]:
            c_bar = _cbar(side, lmax, ctx.axes, c.shape[1], x, gin)
        return None, None, None, c_bar, x_bar


class _Synthesis(torch.autograd.Function):
    """The engines' synthesis under autograd, with respect to ``c`` and
    ``y`` (n, ..., Nf). The context keeps the side, λmax, c and y.
    Backward: ȳ the bank of the cotangent s̄ (filter axis moved last), c̄
    the dots of s̄'s terms with y summed over ``axes``."""

    @staticmethod
    def forward(ctx, side, lmax, axes, c, y):
        ctx.side, ctx.lmax, ctx.axes = side, lmax, axes
        ctx.save_for_backward(c, y)
        return _synthesis(side.product, side.diag, lmax, c, y, None)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gout):
        c, y = ctx.saved_tensors
        side, lmax = ctx.side, ctx.lmax
        sbar = gout.contiguous()
        c_bar = y_bar = None
        if ctx.needs_input_grad[3]:
            c_bar = _cbar(side, lmax, ctx.axes, c.shape[1], sbar, y)
        if ctx.needs_input_grad[4]:
            nf = c.shape[0]
            y_bar = _analysis(side.product, side.diag, lmax, c, sbar, None,
                              side.group(sbar, 2 * nf + 1)).movedim(0, -1)
        return None, None, None, c_bar, y_bar


class _Matvec(torch.autograd.Function):
    """The engines' ``L @ x`` under autograd: x̄ is the matvec of the
    cotangent (L is symmetric)."""

    @staticmethod
    def forward(ctx, side, x):
        ctx.side = side
        return _matvec(side, x)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gout):
        return None, _matvec(ctx.side, gout.contiguous())
