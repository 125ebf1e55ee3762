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


class _Shard:
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


def sharded_matvec(sg: ShardedGraph, x, mesh: Mesh, ell=None):
    """``L @ x`` for this rank's slice ``x`` (``n_local`` rows, its column
    block on a batch-sharded mesh). Pass ``ell = shard_local_ell(sg)`` or
    a windowed layout to take their kernels; without, kernel A runs on the
    shard's CSR."""
    x = torch.as_tensor(x)
    sh = _Shard(sg, mesh, ell)
    pdt = torch.promote_types(x.dtype, sg.dtype)
    x = x.to(pdt)
    d = sh.diag.to(pdt).reshape((-1,) + (1,) * (x.ndim - 1))
    return d * x + sh.product(x, pdt)


# ---------------------------------------------------------------------------
# the recurrence on one rank's slice
# ---------------------------------------------------------------------------

def _layout_bytes(ell) -> int:
    """Bytes of one shard of a layout (its stacked tensors over their
    shard axis)."""
    if isinstance(ell, tuple):
        return sum(_layout_bytes(e) for e in ell)
    if isinstance(ell, torch.Tensor):
        return ell.nbytes // max(ell.shape[0], 1) if ell.ndim else 0
    if dataclasses.is_dataclass(ell):
        return sum(_layout_bytes(getattr(ell, f.name))
                   for f in dataclasses.fields(ell))
    return 0


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
    """
    c, x, cdt = _prepare(c, x, sg.dtype, carry_dtype, carry_tol)
    sh = _Shard(sg, mesh, ell)
    g = _sharded_acc_group(x, c.shape[0], ell, cdt, sg.n_shards)
    return _analysis(sh.product, sh.diag, float(lmax), c, x, cdt, g)


def sharded_cheby_synthesis(sg: ShardedGraph, lmax, c, y, mesh: Mesh,
                            ell=None, carry_dtype=None, carry_tol=None):
    """Synthesis on the sharded graph: per-filter signals, summed.

    ``c``: (Nf, m+1); ``y``: this rank's slice (n_local, ..., Nf), feature
    axis last. Returns ``Σ_f Σ_k c[f,k] T̃_k(L) y[..., f]`` of shape
    (n_local, ...), the recurrence running Nf× wide through the halo
    exchange. ``carry_dtype``: as in :func:`sharded_cheby_op`.
    """
    y = torch.as_tensor(y)
    nf = torch.atleast_2d(torch.as_tensor(c)).shape[0]
    if y.shape[-1] != nf:
        raise ValueError(f'last axis of y ({y.shape[-1]}) must equal the '
                         f'number of filters ({nf})')
    c, y, cdt = _prepare(c, y, sg.dtype, carry_dtype, carry_tol)
    sh = _Shard(sg, mesh, ell)
    return _synthesis(sh.product, sh.diag, float(lmax), c, y, cdt)


def sharded_cheby_op_fixed_graph(sg: ShardedGraph, lmax, c, x, mesh: Mesh,
                                 ell=None):
    """:func:`sharded_cheby_op` with a constant-memory backward: the bank
    is linear in ``c`` and ``x``, so the backward is two fresh sharded
    recurrences, the adjoint synthesis for x̄ (the shifted operator is
    symmetric) and a term-contraction pass for c̄, whose dots
    (``cheby_dot_group``) are summed by an ``all_reduce`` over 'graph',
    and over 'batch' when the batch is sharded. Gradients flow to ``c``
    and ``x`` only."""
    return _ShardedFixedGraph.apply(sg, mesh, ell, lmax,
                                    torch.as_tensor(c), x)


class _ShardedFixedGraph(torch.autograd.Function):
    """The context keeps the partition, λmax, c and x, nothing of the
    recurrence."""

    @staticmethod
    def forward(ctx, sg, mesh, ell, lmax, c, x):
        ctx.sg, ctx.mesh, ctx.ell, ctx.lmax = sg, mesh, ell, lmax
        ctx.save_for_backward(c, x)
        return sharded_cheby_op(sg, lmax, c, x, mesh, ell=ell)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gout):
        c, x = ctx.saved_tensors
        sg, mesh, ell = ctx.sg, ctx.mesh, ctx.ell
        c2 = torch.atleast_2d(c)
        pdt = torch.promote_types(x.dtype, sg.dtype)
        gin = gout.to(pdt).movedim(0, -1).contiguous()
        c_bar = x_bar = None
        if ctx.needs_input_grad[5]:
            x_bar = sharded_cheby_synthesis(sg, ctx.lmax, c2, gin, mesh,
                                            ell=ell).to(x.dtype)
        if ctx.needs_input_grad[4]:
            sh = _Shard(sg, mesh, ell)
            xp = x.to(pdt).contiguous()
            axes = ('graph', 'batch') if x.ndim > 1 else ('graph',)
            c_bar = _coeff_grads(sh.product, sh.diag, float(ctx.lmax),
                                 c2.shape[1], xp, gin,
                                 _sharded_acc_group(xp, c2.shape[0], ell,
                                                    None, sg.n_shards),
                                 lambda t: psum(mesh, axes, t))
            c_bar = c_bar.to(c).reshape(c.shape)
        return None, None, None, None, c_bar, x_bar
