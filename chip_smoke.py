"""Smoke run of the PyTorch/CUDA port (``pygsp_tpu_torch``) on one GPU.

Phases, each of which raises on failure:

1. build the CUDA kernels from ``pygsp_tpu_torch/csrc`` (one nvcc each, in
   parallel, printing registers and spills) into ``pygsp_tpu_torch/_build``,
   then launch ``double`` (TPU kernel #4, the toolchain canary) against
   ``x * 2``, its call time beside its device time (torch.profiler);
2. hold each kernel against its plain PyTorch version on the card, in f32
   (and once in f64): CSR (its wide entry at 128 columns, its narrow one
   at 1 and 5; a star row of 20,000 edges across many of the kernel's
   segments at 1 and 128; a tenth of the entries repeated and kept as
   separate stored entries, against the matrix with them summed), banded
   (f32 on the tensor cores, 3×TF32, also on Grid2d tiles that TF32 does
   not hold exactly), the
   windowed fold and the tail, the strip with the residue list (including
   ``window_rows=256`` and a span-4 matrix, and the bf16 instances: a bf16
   carry, bf16 values, both), the
   one-hot fold at TPU kernel #3's shape (call and device time), and with
   dead slots holding ``inf``, which must add nothing; then the fused
   Chebyshev step (kernel B: step, grouped accumulation, synthesis
   contraction) in f32, f64 and with a bf16 carry, bit for bit, the group
   also at Nf = 1, 5, 8 and 13 with g = 13 and 14, and its fourth entry
   point, the coefficient gradient ``cheby_dot_group``, in
   f32 and f64 within its summation bound against a float64 reference,
   two launches bit-equal;
3. path A, the README path at the bench size: Barabási–Albert N=2^20
   (m0 = m = 8, about 16.8M stored edges) → ``Graph`` → ``estimate_lmax`` →
   ``Heat(scale=[5, 10, 25, 50]).filter(x, order=30)`` with x (N, 128) f32,
   through the CSR SpMM kernel and kernel B (step and grouped
   accumulation, as on every path), checked against the SciPy f64
   recurrence; λmax's 32 products at one column on kernel A's narrow
   entry and the bank's 30 on its wide one (counted by symbol), and
   ``estimate_lmax``'s time; the kernel's two launches bit-equal at this
   shape, and its time with the hub rows (above 1024 edges) emptied and on
   those rows alone; kernel A's width sweep on this graph, S in
   ``SWEEP_F32`` and ``SWEEP_F64``, each entry that takes the width held
   against the plain version, two launches bit-equal, timed beside its
   bound and ``torch.sparse.mm`` (up to 32 columns also both device
   times, from CUDA graphs of 20 calls); each SpMM kernel (here and in
   phases 4 and 5) also at the x̄ synthesis's width, S·Nf = 512 columns,
   against its plain version;
4. path B, the banded path: ``Grid2d(512, 512)`` → ``L.to_banded()`` →
   ``cheby_op`` through the banded SpMM kernel and kernel B, checked
   against the CSR path and the SciPy f64 recurrence;
5. path C, the bench path of the JAX package (``bench.py:162-185``): the
   same graph as path A with ``compute_laplacian(fmt='windowed')``, λmax
   and the heat bank through the windowed fold and tail kernels and
   kernel B's step and grouped accumulation, checked against the SciPy f64
   recurrence; one tail launch per SpMM and no plain residue sum in the
   bank; the fold's and the tail's two launches bit-equal at this shape,
   the tail held against its plain version and timed beside the strip
   alone and the residue tiers' former plain path;
   ``torch.nn.functional.fold`` as the strip part's yardstick; then the
   one-hot fold at TPU kernel #2's probe shape, with row ids from this
   matrix;
6. path D, the JAX package's headline fast mode (``bench.py:332-334``):
   path C's graph, signal and SciPy reference, ``filter(x, order=30,
   carry_dtype=torch.bfloat16, vals_dtype=torch.bfloat16)``, through the
   bf16 fold and tail instances (checked by the symbols launched; one
   tail per SpMM, no plain residue sum; the tail at this shape against its
   plain version and timed as on path C) and
   kernel B with a bf16 carry, its first filter held within 1.5e-2 (the
   gate ``bench.py:345-351`` puts on the fast mode) and all four within
   twice ``carry_error_estimate`` (the carried term and the SpMM's narrow
   output are each rounded once per step);
E. path E, training through the fixed-graph VJP
   (``cheby_op_fixed_graph``, ``Filter.filter(fixed_graph=True)``) on path
   A's graph and signal after path A, on path B's banded operator after
   path B (one step) and on path C's windowed one after path D: one
   forward and backward of the bench bank with a seeded ḡ (the adjoint
   identities ⟨ḡ, out⟩ = Σ c̄ ⊙ c and ⟨x̄, x⟩ = ⟨ḡ, out⟩, each relative to
   its own terms' magnitude; the backward's launches, 5
   ``cheby_dot_group`` at g = 14; its peak memory above what is held, at
   most 2× the forward's, beside the 3K terms plain autograd would keep;
   c̄ and x̄ for a ḡ nonzero on 8 columns against the SciPy f64
   recurrence and x̄ exactly 0 elsewhere; the forward, the x̄ synthesis
   and the c̄ pass timed apart), then Adam steps (lr 0.2) of
   examples/filter_learning.py's model, softplus heat scales from [1, 5,
   10, 20] and a softmax mix against a teacher at the bench bank's
   scales: the loss must fall;
F. path F, the other filter methods: ``method='lanczos'`` (order 30) of
   the bench bank on path A's graph and signal (S = 128, halved while the
   basis does not fit), and its synthesis direction at 32 signals × 4
   filters, against a host f64 Lanczos (beside it, the error of the same
   recurrence without reorthogonalization, shown); ``method='exact'`` on
   ``Grid2d(64, 64)`` in f32 against host f64 ``numpy.linalg.eigh``
   filtering; and ``g.filter(x)`` with x requiring grad on that CSR
   operator, which now differentiates on the card: its x̄ against the
   fixed-graph VJP's within 1e-5, no SDDMM launched (x alone requires
   grad); the grid with its Fourier basis through ``save_graph`` and
   ``load_graph``, back on the card bit for bit. A grad-requiring
   ``g.filter(x)`` on path C's windowed operator is path M's first check;
G. path G, the filter zoo and the rest of the spectral and graph side:
   on path A's graph and signal a ``MexicanHat`` bank of 6 (CSR kernel,
   kernel B's groups at the g its rule gives, the group at Nf = 6 timed
   beside its bound and ``addmm_``), ``laplacian_upper_bound`` against the
   host Gershgorin bound, ``power_iteration_lmax`` below it beside
   Lanczos's λmax, and the difference operator for both Laplacian types:
   ``grad`` and ``div`` at 128 columns, one ``csr_spmm`` launch each,
   ``grad`` against a host Dᵀ built from the edge list, ``div(grad(x))``
   against the host Laplacian, two launches bit-equal, each product timed
   beside its bound, its plain version and ``torch.sparse.mm``, and a
   backward through ``grad`` equal to ``div(ȳ)``; on path B's banded
   operator a ``SimpleTight`` bank of 6 and the synthesis of its output
   (the contraction's symbol counted); on path C's windowed operator a
   ``Meyer`` bank of 6 (fold and tail); ``partial_fourier_basis`` (LOBPCG,
   k = 4, f64) and ``compute_fourier_basis(4)`` on ``Grid2d(100, 27)``
   against host ``eigsh``; and every design at tests/test_filters.py's
   parameters on ``Grid2d(64, 64)`` against the SciPy f64 recurrence of
   its own coefficients, ``Gabor`` against host f64 ``eigh`` filtering and
   ``Modulation`` against its formula in f64 on the card's basis;
H. path H, the hybrid ELL format on its kernel ``ell_spmm``:
   ``compute_laplacian(fmt='auto')`` on BA(2^16), the largest graph that
   ``'auto'`` sends to hybrid, then path A's graph with ``fmt='hybrid'``,
   each with λmax and the heat bank against the SciPy f64 recurrence, 30
   ``ell_spmm`` launches a bank and no CSR kernel, plain SpMM or
   ``index_add_``, λmax's 32 products at one column on the kernel's narrow
   entry and the bank's 30 on its wide one (counted by symbol); the kernel
   against its plain version in f64 at the bank's shape (heavy rows in
   blocks of their own), two launches bit-equal, ``inf`` behind every dead
   slot adding nothing, timed beside its bound, its gather model, its
   plain version and ``torch.sparse.mm``, in f32 and in f64 (the layout
   line: each row's positions and overflow slots, mean and largest, and
   the live share of them); its narrow entry held the same
   way at 1 and 8 columns and in f64 at 5 (on BA(2^16) at 1 and 8), timed
   beside the wide entry in turns (each also by the device time of a CUDA
   graph of 20 calls), its bound and ``torch.sparse.mm``;
   ``laplacian_upper_bound`` against the host Gershgorin bound; and
   ``fmt='auto'`` on ``Minnesota``, ``Airfoil``,
   ``StochasticBlockModel(N=1024)`` and ``Community(N=256)`` at a fixed
   seed, λmax on the narrow entry alone, a one-filter bank each against
   SciPy f64, the narrow entry held and timed at 1 and 8 columns;
I. path I, the chunked format on its kernel ``chunked_spmm``: path A's
   graph with ``fmt='chunked'``, the bank and its checks as on path H; the
   kernel held and timed as there at the bank's shape in every operand
   pair (f32, f64 and the three bf16 pairs, each beside its bound and
   gather model in its own element sizes and ``torch.sparse.mm`` where one
   call computes it: none for the mixed pairs) and held at the x̄
   synthesis's 512 columns, its narrow entry as on path H at
   1 and 8 columns, in f64 at 5 and in each bf16 pair at one; the fast mode
   (``carry_dtype`` and ``vals_dtype`` bf16, the ``chunked_spmm_bf16``
   symbol counted) within 1.5e-2 on the first filter and twice
   ``carry_error_estimate`` on all four; then the fixed-graph VJP's checks
   of path E and one Adam step through ``Filter.filter(fixed_graph=True)``;
J. path J, the algorithms on the nearest-neighbour graphs: J1,
   ``Sensor(N=2**20, k=6, seed=42)`` built on the card, 8 classes by
   angular sector, 5 % labelled: ``classification_tikhonov(tau=0.5)`` (one
   CG over the (N, 8) block), ``regression_tikhonov(tau=0)`` on one column
   and ``classification_tikhonov_simplex(tau=0.5, maxit=500)``, each CG held
   by its true relative residual in f64 on the host (≤ 1e-3), the simplex
   rows within 1e-5 of the simplex, the one-column CG on kernel A's
   narrow entry alone; J2, ``prox_tv`` (its ``grad`` and ``div`` on the
   narrow entry alone) of a noisy
   piecewise-constant signal against the same dual iterations in f64 on
   the host for the card's count (read from kernel A's launches), within
   1e-4 of max|x|, its objective lower; J3,
   ``effective_resistances_sketch(n_probes=24)`` held by Foster's theorem
   within 5 %, then ``graph_sparsify(epsilon=0.5)``, connected with fewer
   edges; J4, ``graph_multiresolution(levels=2)`` on ``Sensor(N=8000)``
   (the Kron method of each level), the (N, 8) block refused as in the JAX
   package and each column analysed and synthesized back within 1e-5 of
   ‖f‖, level 0's low-pass bank against the SciPy f64 recurrence; J5,
   ``compute_spectrogram(Sensor(N=2048), M=100)``, 64 columns against
   SciPy f64; J6, the 8 nearest-neighbour classes on the card, a heat bank
   each against SciPy f64, and ``laplacian_eigenmap2D`` on
   ``Sensor(N=16384)`` in f64 (LOBPCG), its Rayleigh quotients within 1e-4
   of ``eigsh``'s eigenvalues and its residuals within 1e-3 of ‖L‖, and the
   same in f32 (the float32 operator solved in float64). Kernel A held
   against its plain version at 1, 8 and 24 columns on J1's graph, as
   ``grad`` and ``div`` at one column and at the spectrogram's 2048;
   kernel B's step and group at the spectrogram's shape (Nf = 100);
K. path K, gradients through the graph's weights, on path A's graph
   after path F's Lanczos (before path G leaves the graph on the
   normalized Laplacian): W's CSR values as a leaf that requires grad →
   ``laplacian_op`` → ``cheby_op`` of the heat bank (order 30, λmax path
   A's, c and x requiring grad too) → the VJP of ⟨ḡ, out⟩ for a seeded ḡ
   nonzero on 8 columns. The backward's peak memory at most m+1 + Nf + 8
   (N, S) units above what is held (plain autograd's 3K beside it), 30
   launches a backward of kernel A's fused entry ``csr_spmm_sddmm`` (the
   transpose's SpMM with the weights' SDDMM and the diagonal in one pass,
   u_1's share in x̄'s step) and none of ``csr_sddmm`` or ``csr_spmm``
   (counted by wrapper and by symbol), no plain SpMM or SDDMM, two
   backward passes bit-equal; w̄, x̄ and c̄ against a host
   SciPy f64 computation on those 8 columns (the terms, the Clenshaw
   adjoint, the per-edge dots, the chain through ``laplacian_op``) within
   1e-4 of their largest value, x̄ exactly 0 on the other columns and w̄ on
   the padding; the forward, the backward and its parts (the fused
   adjoint step, beside it the unfused adjoint step and SDDMM, the c̄ pass)
   timed; the fused entry on the transpose of path A's off-diagonal at 128
   and 200 (two passes) f32 and 64 f64 columns bit-equal to kernel A's
   wide entry plus ``csr_sddmm`` (its cotangent taken back by the
   transpose's edge order), held against its plain version, two launches
   bit-equal, timed beside those two launches, its bound, its gather
   model, its plain version and ``torch.sparse.mm`` of the transpose plus
   ``torch.sparse.sampled_addmm`` (a yardstick only); ``csr_sddmm`` with
   the diagonal at 128
   and 1 columns against its plain version, two launches bit-equal, timed
   beside its bound, its gather model, its plain version and
   ``torch.sparse.sampled_addmm`` (a yardstick only); three Adam steps on
   the weights towards a teacher (the graph with each edge's weight
   scaled by a seeded factor in [0.9, 1.1]): the loss must fall, each
   step timed (and the fused entry's, the adjoint step's, the backward's
   and an Adam step's ms printed with the card's name and power limit);
   on BA(2^16) in f64 with the normalized Laplacian, w̄, c̄,
   x̄ and λ̄ on the card against the port on the CPU within 1e-10, and λ̄
   against a central difference within 1e-7. Then the auxiliaries on the
   card: BA(2^16) with its λmax and a signal through ``save_graph`` and
   ``load_graph`` (its Laplacian's product bit for bit), a ``Throughput``
   around each of three banks of path A within 2 % of the CUDA events
   around the same bank, and ``trace`` over one bank, whose file must
   name the CSR kernel (``csr_spmm_segment_kernel``);
M. path M, gradients through the operator on the other formats: on path
   C's windowed operator (after path E on C), path H's ``'hybrid'`` one,
   path I's chunked one (each at the end of its path) and path B's banded
   one (after path G on B), the bank (ḡ on 8 columns, as path K)
   differentiated through the format's value leaves (``leaves()``,
   replaced by ``with_leaves``), diagonal, λmax as a tensor, c and x:
   the format's SpMM 30 times forward; the backward 30 launches of kernel
   A's fused entry on the CSR view of the live slots (``grad_edges``), or
   30 of kernel C on the transposed tiles, and no other SpMM or SDDMM; no
   plain version; the padding slots' cotangent exactly 0; every cotangent
   (the leaves mapped to their edges, diag̅, λ̄, c̄, x̄) against the CSR
   route's (``_ChebyOp`` on a CSR with the same values and diagonal)
   within 1e-4 of the largest; the forward and the backward timed, the
   peak in (N, S) units. On C first ``g.filter(x)`` with x requiring grad
   (its x̄ against the fixed-graph VJP's within 1e-5: kernel A on the
   transpose, no SDDMM), then three Adam steps on the windowed leaves
   (the loss falls; the CSR view built once on C in all). On B also
   ``Grid2d(64, 64)`` in f64, every tile entry's cotangent (those off the
   grid's edges included), diag̅, λ̄, c̄ and x̄, card against CPU within
   1e-10;
N. path N, first-order gradients of ``L @ x``, the synthesis and
   ``cheby_rect`` on every format, each after path M on the same operator
   (path A's after path K's auxiliaries): N1, ``L @ x`` with x (N, 128)
   f32 on path C's windowed, H's hybrid, I's chunked and B's banded
   operators through the leaves, the diagonal and x: one launch of the
   format's SpMM forward, backward one of kernel A's fused entry on the
   CSR view's transpose or kernel C on the transposed tiles (and the
   tiles' FP32 product); N2, ``cheby_synthesis`` of x (N, 128, 4) f32,
   ȳ on 8 columns, on those four operators through the leaves, the
   diagonal, λmax (a tensor), c and x, and on path A through W's values
   by ``laplacian_op``: 30 SpMMs forward at 512 columns, backward the bank
   of ȳ on the transpose (30 SpMMs at 128 columns: kernel A on the
   transpose or the CSR view's, kernel C on the transposed tiles), then
   29 of kernel A's fused entry and one ``csr_sddmm``, or 29 of kernel C;
   x̄ against ``cheby_op(L, λmax, c, ȳ)`` without autograd within 1e-5;
   BA(2^16) in f64, w̄, c̄, x̄, λ̄ card against CPU within 1e-10 and λ̄
   against a central difference within 1e-7; N3, ``cheby_rect`` of x
   requiring grad on path C's operator, x̄ against ``cheby_rect`` of ȳ
   within 1e-5. Each with no plain version, the padding slots' cotangent
   exactly 0, every cotangent against the CSR route's (the same values
   as a CSR, ``edge_csr``) within 1e-4, the forward's and the backward's
   ms, N2's peak in (N, S) units, and path N's line with the card's name
   and power limit;
7. kernel B's entry points at each path's shape and at path E's (the step
   at 512 columns, the contraction at (N, 128, 4), ``cheby_dot_group`` at
   paths A's and B's N), held bit for bit against
   their plain versions (``cheby_dot_group`` within its summation bound),
   then timed beside them, the eager passes they replace and the one
   library call where there is one (``addmm_`` for the grouped
   accumulation of f32 terms, ``addmv_`` for the synthesis contraction,
   ``torch.mm`` for the coefficient gradient);
L. path L, the multi-device engines (``pygsp_tpu_torch.parallel``) at one
   rank on path A's graph, signal, λmax and SciPy reference: L1, a
   one-rank NCCL group from ``launch.initialize``, ``partition_graph(W,
   1)`` with the production layout (``shard_local_windowed(
   split_boundary=True)``, kernels D and E) and the COO one (kernel A on
   the shard's CSR), each bank's 8 columns within 1e-4 of the reference,
   its launches counted and its time beside path A's; one fixed-graph VJP
   step (``sharded_cheby_op_fixed_graph``) with its two c̄ ``all_reduce``
   calls ('graph', 'batch') counted and the adjoint identities held; L2,
   the 2-D engine at 1 × 1 (``partition_graph_2d``,
   ``twod_local_windowed(ring=True, split_cols=True)``, ``cheby_op_2d``),
   checked the same way, its one fold a step one ``fold_strip_multi``
   launch where a window fits a block; L3, the fused multi-matrix SpMM on
   device (0, 0)'s four ring matrices of ``partition_graph_2d(W, 4, 4)``,
   and L4 on both fold positions' groups of device (0, 0) of the 2 × 2
   interleaved ring: through ``windowed_spmm_chunks_multi`` (one
   ``fold_strip_multi`` launch, no fold and no strip), L4 also split as
   the engine folds position 0 at pr > 1 (ring step 0 alone, the rest in
   a second launch, the add; held against the group's f64 plain version
   and timed beside the one launch), then the former fold
   ``windowed_fold_multi`` held against its plain version in f64 and in
   the bf16 carry (ulps), two launches bit-equal, its strip over the
   merged residue lists bit-equal to its plain version and timed alone,
   and ``fold_strip_multi`` bit-equal to the two (f32 and bf16 carry),
   against its f64 plain version, timed beside them, the matrices'
   separate fold and strip launches, ``torch.sparse.mm`` of the stacked
   matrices (CUDA events and device time) and its bound and gather model
   (path C also times it at one matrix, bit-equal to its fold and tail);
   L5, the engines under autograd on L1's and L2's partitions: the
   backward with ``c`` and the signal requiring grad through
   ``sharded_cheby_op`` (production layout and COO), ``cheby_op_2d`` at
   1 × 1 on the ring layout, ``sharded_cheby_synthesis`` of y (N, 128, 4)
   and ``sharded_matvec`` on COO, each forward's and backward's launches
   counted exactly (kernel B's four entries, the fold and the tail, the
   fused SpMM, kernel A; no plain version), x̄, ȳ and c̄ within 1e-5 of
   the single-device route's on the CSR (``cheby_op``, ``cheby_synthesis``,
   ``L @ x`` under autograd) in the engine's vertex order, the padding
   rows' cotangents exactly 0, the forward and the backward timed, the
   backward's peak in (N, S) units; then, with no process group, the same
   calls in f64 on BA(2^16) on the card against the CPU within 1e-12;
   a ``save_sharded``/``load_sharded`` round trip (BA(2^16), 4 shards);
   and one log line saying whether NCCL takes two ranks on one
   card (two processes, each killed at 90 s; the run does not depend on
   it). Paths A, C, H, I and L share one SciPy reference of the bench
   bank (computed once per N and λmax);
8. one JSON line of per-kernel numbers (kernel A's entry with ``grad`` and
   ``div``, its narrow entry with the width sweep and the narrow shapes of
   paths G and J, ``csr_sddmm`` at path K's 128 columns and at one, the
   fused entry ``csr_spmm_sddmm`` at 128 with 200 f32 and 64 f64 beside,
   the fused multi-matrix fold ``windowed_fold_multi`` and the fused SpMM
   ``fold_strip_multi`` at L3's shape (L4's groups and path C's one
   matrix beside),
   kernel B's group with Nf = 6, ``ell_spmm`` and
   ``chunked_spmm`` with the shapes paths H and I held them at under
   ``at_paths``, their narrow entries ``ell_spmm_narrow`` and
   ``chunked_spmm_narrow`` at one column on paths H and I's graph with
   their other narrow shapes there, kernels A and B at path J's shapes
   there too; times from CUDA events, bounds
   from the H100 SXM data sheet: HBM, FP32, and TF32 for the banded
   kernel's f32 products), the card's name and power limit, and the final
   ``{"ok": true, ...}`` line.

Run: ``python3 chip_smoke.py``. It needs one CUDA device and exits
non-zero without one.
"""

import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import scipy.sparse as sps
import scipy.sparse.linalg as spl
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import pygsp_tpu_torch as gsp
from pygsp_tpu_torch.core import _cuda, banded_kernel, cheby_kernel
from pygsp_tpu_torch.core import chunked, csr_kernel, ell_kernel
from pygsp_tpu_torch.core import windowed as wd
from pygsp_tpu_torch.core import windowed_kernel as wk
from pygsp_tpu_torch.ops import lanczos as lz
from pygsp_tpu_torch.ops.eigen import (estimate_lmax_lanczos,
                                       laplacian_upper_bound,
                                       partial_fourier_basis,
                                       power_iteration_lmax)
from pygsp_tpu_torch.ops.chebyshev import (_adjoint, _bank,
                                           _fixed_graph_grads, _internal,
                                           _operator_bytes, acc_group,
                                           carry_error_estimate, cheby_coeff,
                                           cheby_op, cheby_op_fixed_graph,
                                           cheby_synthesis)

# kernel A's width sweep on path A's graph (it sets the wrapper's crossover
# from its narrow entry to its wide one)
SWEEP_F32 = (1, 2, 3, 4, 8, 12, 16, 24, 32, 64, 128)
SWEEP_F64 = (1, 4, 12)
# kernel B's group at more filter counts, at (2^16, 128)
GROUP_NFS = (1, 5, 8, 13)

# H100 SXM data sheet: HBM rate, FP32 and FP64 rates outside the tensor
# cores, and the dense TF32 and bf16 tensor-core rates.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
FP64_FLOPS = 34e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
TF32_PRODUCTS = 3       # the banded f32 kernel's TF32 products per product

N_BA = 1 << 20          # bench.py:53-58
M_ATTACH = 8
GRID_SIDE = 512         # 262,144 vertices, half bandwidth 4 tiles
HUB_DEGREE = 1024       # path A's hub rows: more edges than this
ORDER = 30
N_SIGNALS = 128
SCALES = [5.0, 10.0, 25.0, 50.0]
N_CHECK_COLS = 8
# x̄'s host reference: its first 2 columns (each the synthesis of Nf)
N_CHECK_XBAR = 2
HOST_THREADS = 8        # the host references' SpMMs, split by rows
N_CHECK_LANCZOS = 4     # path F's signals in the host Lanczos
# path E: the student's scales start at __graft_entry__.py:84's, the
# teacher's are the bench bank's (SCALES)
STUDENT_SCALES = [1.0, 5.0, 10.0, 20.0]
TEACHER_MIX = [0.4, 0.3, 0.2, 0.1]
TRAIN_STEPS = 5
TRAIN_LR = 0.2
EXACT_SIDE = 64         # Grid2d(64, 64), __graft_entry__.entry's graph
# path G: the filter zoo's banks of 6 on paths A-C, every design on
# Grid2d(64, 64) at tests/test_filters.py:36-57's parameters, and LOBPCG's
# 4 smallest eigenpairs on a 2700-vertex grid whose 5 smallest eigenvalues
# are simple (unequal sides)
NF_ZOO = 6
ZOO = (('Heat', dict(scale=[10, 50])), ('Heat', dict(scale=5)),
       ('Wave', dict(time=[5, 10], speed=[1])), ('MexicanHat', dict(Nf=6)),
       ('MexicanHat', dict(Nf=5, normalize=True)), ('Meyer', dict(Nf=6)),
       ('Itersine', dict(Nf=6)), ('SimpleTight', dict(Nf=6)),
       ('Abspline', dict(Nf=6)), ('HalfCosine', dict(Nf=6)),
       ('Regular', dict()), ('Regular', dict(degree=0)),
       ('Regular', dict(degree=5)), ('Held', dict()), ('Simoncelli', dict()),
       ('Papadakis', dict()), ('Expwin', dict()),
       ('Expwin', dict(band_min=0.1, band_max=0.7)),
       ('Expwin', dict(band_min=0.1, band_max=None)),
       ('Rectangular', dict(band_min=0.1, band_max=0.5)))
LOBPCG_GRID = (100, 27)
LOBPCG_K = 4
# LOBPCG against eigsh(which='SM') (tests/test_graphs.py:100-112): the
# eigenvalues, and each eigenvector's alignment |Uᵀ U_ref| against 1
TOL_LOBPCG_E = 1e-6
TOL_LOBPCG_U = 1e-4
# the f32 Chebyshev coefficients filter() computes on the card against f64
# ones on the host, relative to the largest: read 1.5e-6 or less on an H100
# for every design but Regular. Regular's complement √(1 − g²) rounds in
# f32 to within √eps ≈ 3.5e-4 where g → 1: read 1.0e-5 on an H100 (and
# 1.7e-5 on a CPU for degree 5, whose λmax estimate puts the nodes
# elsewhere), so it is held to its own limit
TOL_COEFF = 1e-5
TOL_COEFF_REGULAR = 1e-4
# power iteration (100 steps) against Lanczos's λmax on path A: read 3.4e-6
# on an H100
TOL_POWER = 1e-4
# the Gabor bank's filters held against the host (every 512th of 4096)
GABOR_STRIDE = 512
# the backward's x̄ synthesis runs every SpMM and the step at S·Nf columns
WIDE = N_SIGNALS * len(SCALES)

# path J: the algorithms on the nearest-neighbour graphs. J1-J3 on
# Sensor(N=2^20, k=6): 8 classes by angular sector, 5 % labelled; CG's
# true residual held to 100 × its tol (room for f32's floor on it)
J_SENSOR_N = 1 << 20
J_SENSOR_K = 6
J_CLASSES = 8
J_LABEL_SHARE = 0.05
J_SEED = 7
J_TAU = 0.5
J_MAXITER_TAU0 = 1000   # regression_tikhonov's own cap at tau = 0
J_SIMPLEX_MAXIT = 500
J_TV_GAMMA = 0.1
J_TV_NOISE = 0.1
J_TV_MAXIT = 200
J_PROBES = 24
J_SPARSIFY_EPS = 0.5
J_WIDTHS = (1, 8, 24)   # kernel A's widths in CG: tau = 0, the classes, probes
J_PYRAMID_N = 8000
J_SPECTRO_N = 2048
J_SPECTRO_M = 100
J_SPECTRO_COLS = 64
J_EIGENMAP_N = 16384
TOL_CG_RESIDUAL = 1e-3
TOL_SIMPLEX = 1e-5
TOL_TV = 1e-4           # of max|x|
TOL_FOSTER = 0.05
TOL_PYRAMID = 1e-5      # of ‖f‖
TOL_EIGENMAP_E = 1e-4   # relative
TOL_EIGENMAP_RES = 1e-3  # of ‖L‖

# Tolerances (relative to the largest reference magnitude): f32 sums in
# another order than the plain version; the recurrence is held against f64.
TOL_CSR = 1e-5
# the banded f32 kernel's three TF32 products err near 5e-7; one TF32 pass,
# or a split that drops either cross term, misses by 3.7e-5 or more on
# these inputs (tests/test_torch_kernel_budget.py emulates each)
TOL_BANDED = 1e-5
TOL_WINDOWED = 1e-5
TOL_SLOT = 1e-5         # the ELL and chunked kernels against f64
TOL_FOLD = 1e-6         # f32 sums of bf16 products, another order
TOL_PATH = 1e-4
TOL_F64 = 1e-12
# path K: gradients through the graph's weights. w̄, x̄ and c̄ at full width
# against the host f64 reference within the exact modes' limit (TOL_PATH);
# the f64 graph on the card against the port on the CPU; λmax as a tensor
# against a central difference (h = 1e-6 λmax); path F's x̄ of a
# grad-requiring g.filter on CSR against the fixed-graph x̄
K_SMALL_N = 1 << 16
K_SMALL_S = 16
K_TRAIN_STEPS = 3
K_TRAIN_LR = 0.005
K_TEACHER = (0.9, 1.1)
TOL_K_F64 = 1e-10
TOL_K_LMAX_FD = 1e-7
TOL_F_XBAR = 1e-5
# path M: the formats' gradients through the operator; Adam on the windowed
# leaves
M_TRAIN_STEPS = 3
M_TRAIN_LR = 0.005
# the fixed-graph VJP's adjoint identities at full width, each relative to
# the magnitude of its own terms (f32 terms summed in f64): ⟨ḡ, out⟩ =
# Σ c̄ ⊙ c to Σ |c̄ ⊙ c|, read 6.0e-9 to 4.2e-8 on paths A-C on an H100;
# ⟨x̄, x⟩ = ⟨ḡ, out⟩ to Σ |x̄ ⊙ x|, read 2.9e-11 to 1.1e-10 (an x̄ scaled
# by 1 + 2e-4 fails it on B, by 1 + 7.5e-6 on A)
TOL_ADJOINT_C = 5e-7
TOL_ADJOINT_X = 1e-9
# Lanczos in f32 against the same algorithm in f64 on the host: read
# 1.3e-5 and 1.9e-5 on an H100; without the reorthogonalization 1.1e-2
TOL_LANCZOS = 1e-4
# path D, the bf16 fast mode: bench.py's gate for it, on the first filter
# (bench.py:345-351)
TOL_PATH_BF16 = 1.5e-2
# a bf16 window tensor: kernel and plain version round the same f32 sum,
# taken in two orders, once each
TOL_BF16_ULPS = 1.0

# the bf16 instances of the fold, (x dtype, values dtype): a bf16 carry
# alone, both (the fast mode), bf16 values alone
BF16_FOLDS = {'carry': (torch.bfloat16, torch.float32),
              'both': (torch.bfloat16, torch.bfloat16),
              'vals': (torch.float32, torch.bfloat16)}
# kernel B's instances, (arithmetic dtype, carry dtype)
CHEBY_TYPES = ((torch.float32, torch.float32), (torch.float64, torch.float64),
               (torch.float32, torch.bfloat16))

# TPU kernel #2's probe shape (PALLAS_FOLD_r5.json, p=4) and #3's shape
FOLD2_NW, FOLD2_LT, FOLD2_KP = 1024, 1152, 256
FOLD3_LT, FOLD3_KP = 512, 256

KERNELS = ((csr_kernel.csr_spmm, csr_kernel.csr_sddmm,
            csr_kernel.csr_spmm_sddmm, banded_kernel.banded_spmm)
           + wk.KERNELS
           + cheby_kernel.KERNELS + ell_kernel.KERNELS)


def log(*args):
    print(*args, flush=True)


# launches by C symbol, counted by count_symbols' spy on _cuda.launch and
# set to 0 with the wrappers' counts
SYMBOLS = {}


def count_symbols():
    """Count every launch by its C symbol from now on (``SYMBOLS``): kernel
    A's wrapper launches one of two entries, told apart by symbol."""
    launch = _cuda.launch

    def spy(name, symbol, *args):
        SYMBOLS[symbol] = SYMBOLS.get(symbol, 0) + 1
        return launch(name, symbol, *args)

    _cuda.launch = spy


def reset_counts():
    for k in KERNELS:
        k.launches = 0
    wk.tail_plain.calls = 0
    ell_kernel.slot_spmm_plain.calls = 0
    SYMBOLS.clear()


def counts():
    """Every kernel's launch count, kernels A, ELL and chunked by entry
    (narrow, wide; by C symbol; kernel A's fused entry is
    ``csr_spmm_sddmm``, its own wrapper), and the calls of two plain
    versions that the banks must not call, by name: the tail's (the
    windowed residue sum) and the ELL and chunked SpMMs' (``slot_plain``)."""
    by_entry = {}
    for kernel in ('csr_spmm', 'ell_spmm', 'chunked_spmm'):
        for entry in ('narrow', 'wide'):
            head = f'{kernel}_narrow_' if entry == 'narrow' else f'{kernel}_'
            by_entry[f'{kernel}_{entry}'] = sum(
                n for symbol, n in SYMBOLS.items()
                if symbol.startswith(head)
                and not symbol.startswith('csr_spmm_sddmm_')
                and (entry == 'narrow') == ('_narrow_' in symbol))
    return {**{k.__name__: k.launches for k in KERNELS}, **by_entry,
            'tail_plain': wk.tail_plain.calls,
            'slot_plain': ell_kernel.slot_spmm_plain.calls}


def require_narrow(part, c, kernel='csr_spmm'):
    """Raise unless every launch of ``kernel`` (A, ELL or chunked) in a
    part took the narrow entry."""
    narrow = c[f'{kernel}_narrow']
    if not c[kernel] or narrow != c[kernel]:
        raise AssertionError(f'{part}: {c[kernel]} {kernel} launches, '
                             f'{narrow} of them narrow')
    log(f'  {part}: all {c[kernel]} {kernel} launches narrow')


def require_tail(path, per_bank):
    """Raise unless the bank ran one tail launch per SpMM and no plain
    residue sum."""
    if per_bank['window_strip'] != ORDER:
        raise AssertionError(f'path {path}: {per_bank["window_strip"]} tail '
                             f'launches in one bank, not {ORDER}')
    if per_bank['tail_plain']:
        raise AssertionError(f'path {path}: tail_plain ran '
                             f'{per_bank["tail_plain"]} times in the bank')


def require_launches(path, per_bank, **least):
    """Raise unless each named kernel launched at least its count in the
    path's bank."""
    for name, n in least.items():
        if per_bank[name] < n:
            raise AssertionError(f'path {path}: {name} launched '
                                 f'{per_bank[name]} < {n} times in one bank')


def run_bank(bank):
    """One bank, with every kernel's launches on the path so far and in
    the bank alone, both read just after it: ``(out, launches,
    per_bank)``."""
    before = counts()
    out = bank()
    torch.cuda.synchronize()
    launches = counts()
    return out, launches, {k: launches[k] - before[k] for k in launches}


def time_ms(fn, iters):
    """Mean ms per call over ``iters`` calls, after one warm-up call."""
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


def device_ms(fn, iters, key='device_ms', tries=3, per_call=False):
    """Device time of one launch of ``fn``, which launches one kernel per
    call, as ``{key: ms, key + '_by': how}``: the mean time on the card of
    the kernels that torch.profiler records over ``iters`` calls (after one
    warm-up call). The mean is taken over the kernels recorded, so a record
    the profiler drops does not count as a launch that took no time. With
    ``per_call`` (``fn`` may launch several kernels, as a library call
    does) it is the device time of all records over ``iters`` instead. CUPTI
    may deliver no record at all for a whole profile; after ``tries`` such
    profiles each launch is timed between two CUDA events instead, and
    ``how`` says so."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = [ev.time_range.end - ev.time_range.start
              for ev in prof.events() if ev.device_type == DeviceType.CUDA]
        if us and sum(us) > 0:
            return {key: sum(us) / (iters if per_call else len(us)) / 1e3,
                    key + '_by': 'torch.profiler'}
    log(f'  torch.profiler recorded no device time in {tries} profiles; '
        'timing each launch between two CUDA events')
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return {key: sum(a.elapsed_time(b) for a, b in pairs) / iters,
            key + '_by': 'CUDA events around each launch'}


def graph_ms(fn, iters):
    """Device time of one call of ``fn`` (which may launch several
    kernels), the host's launch costs left out: a CUDA graph of ``iters``
    calls, captured after a warm-up call and replayed 5 times between two
    CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (5 * iters)


def check(name, got, want, tol):
    """Relative error max|got - want| / max|want|; raises above ``tol``."""
    torch.cuda.synchronize()
    got = torch.as_tensor(got)
    want = torch.as_tensor(want).to(got.device, got.dtype)
    if got.shape != want.shape:
        raise AssertionError(f'{name}: shape {tuple(got.shape)} != '
                             f'{tuple(want.shape)}')
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f'{name}: non-finite values')
    err = float((got - want).abs().max() / want.abs().max())
    log(f'  {name}: rel err {err:.3e} (tol {tol:.3g})')
    if not err <= tol:
        raise AssertionError(f'{name}: rel err {err} > {tol}')
    return err


def host_blocks(L):
    """L in f64 CSR, cut into HOST_THREADS blocks of rows."""
    L = L.astype(np.float64).tocsr()
    cuts = np.linspace(0, L.shape[0], HOST_THREADS + 1).astype(int)
    return [L[a:b] for a, b in zip(cuts[:-1], cuts[1:])]


def host_product(pool, blocks, v):
    """``L @ v`` from L's row blocks, one thread each (SciPy's product
    releases the interpreter lock; every row's sum is SciPy's own)."""
    return np.concatenate(list(pool.map(lambda block: block @ v, blocks)))


def host_terms(L, lmax, x, m1):
    """Yields the recurrence terms T̃_k x, k < m1, in SciPy f64 on the
    host."""
    blocks = host_blocks(L)
    a1 = a2 = lmax / 2
    with ThreadPoolExecutor(HOST_THREADS) as pool:
        t_old = x
        t_cur = (host_product(pool, blocks, x) - a2 * x) / a1
        yield t_old
        yield t_cur
        for _ in range(2, m1):
            t_old, t_cur = t_cur, ((2.0 / a1) * (host_product(
                pool, blocks, t_cur) - a2 * t_cur) - t_old)
            yield t_cur


def scipy_recurrence(L, lmax, c, x):
    """The Chebyshev recurrence in SciPy f64 on the host: (Nf, N, S)."""
    nf, m1 = c.shape
    r = np.zeros((nf,) + x.shape)
    for k, t in enumerate(host_terms(L, lmax, x, m1)):
        for i in range(nf):
            r[i] += (0.5 if k == 0 else 1.0) * c[i, k] * t
    return r


def bound(bytes_moved, flops, flops_per_s=FP32_FLOPS):
    """The least time for the work: the larger of bytes over the memory
    rate and operations over the rate of the unit that does them (FP32
    outside the tensor cores unless ``flops_per_s`` says otherwise)."""
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / flops_per_s * 1e3
    return {'bound_ms': max(bytes_ms, flops_ms),
            'bound_by': 'bytes' if bytes_ms >= flops_ms else 'operations'}


def seeded_normal(shape, seed, device='cuda', dtype=torch.float32):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device, dtype=dtype)


def symmetric_from_edges(src, tgt, n, weights=None):
    data = np.ones(2 * len(src)) if weights is None else np.concatenate(
        [weights, weights])
    W = sps.csr_matrix((data, (np.concatenate([src, tgt]),
                               np.concatenate([tgt, src]))), shape=(n, n))
    if weights is None:
        W.data[:] = 1.0
    return W


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build():
    log('phase 1: build, then the canary kernel #4')
    t0 = time.time()
    outputs = _cuda.build(['csr_spmm', 'csr_sddmm', 'banded_spmm',
                           'windowed_fold', 'cheby_step', 'ell_spmm'],
                          extra_flags=('-Xptxas', '-v'))
    log(f'  built in {time.time() - t0:.1f} s')
    for name, out in outputs.items():
        for line in out.splitlines():
            if ('Compiling entry' in line or 'registers' in line
                    or 'spill' in line):
                log(f'  {name}: {line.strip()}')
    x = torch.arange(8 * 128, dtype=torch.float32, device='cuda').reshape(
        8, 128)
    y = wk.double(x)
    check('double (#4) vs x * 2', y, wk.double_plain(x), 0.0)
    max_abs_err = float((y - wk.double_plain(x)).abs().max())
    ms = time_ms(lambda: wk.double(x), 100)
    # an empty kernel's device time: the least any launch takes, double's
    # bound on the card beside its bytes' (csrc/windowed_fold.cu)
    floor = device_ms(lambda: _cuda.launch(
        'windowed_fold', 'launch_floor', 0, 0, torch.cuda.current_device()),
        100, 'launch_floor_ms')
    return {'max_abs_err': max_abs_err, 'ms': ms, **floor,
            **device_ms(lambda: wk.double(x), 100),
            **device_ms(lambda: torch.mul(x, 2), 100, 'library_device_ms'),
            'plain_ms': time_ms(lambda: wk.double_plain(x), 100),
            'library_ms': time_ms(lambda: torch.mul(x, 2), 100),
            'library': 'torch.mul(x, 2)',
            **bound(2 * x.numel() * 4, x.numel()), 'shape': list(x.shape)}


def phase_kernels():
    log('phase 2: kernels against their plain versions')
    n = 1 << 16
    rng = np.random.default_rng(1)
    src, tgt = gsp.graphs.ba_edges_fast(n, m0=8, m=8, seed=1)
    W = symmetric_from_edges(src, tgt, n, rng.uniform(0.5, 1.5, len(src)))
    for dtype, widths, tol in ((torch.float32, (128, 5, 1), TOL_CSR),
                               (torch.float64, (5,), TOL_F64)):
        A = gsp.core.from_scipy(W, dtype=dtype, device='cuda')
        for s in widths:
            x = seeded_normal((n, s), s, dtype=dtype)
            check(f'csr N=2^16 S={s} {dtype}',
                  csr_kernel.csr_spmm(A.rowptr, A.cols, A.vals, x),
                  csr_kernel.csr_spmm_plain(A.rowptr, A.cols, A.vals, x), tol)
    # a star row of 20,000 edges spans about 80 of the CSR kernel's
    # segments of 256 steps; held against the plain version in f64, whose
    # f32 index_add_ would sum the long row in no fixed order
    star = sps.random(64, 20_000, density=1e-3, random_state=rng,
                      format='lil')
    star[3] = rng.normal(size=20_000)
    A = gsp.core.from_scipy(star.tocsr(), dtype=torch.float32,
                            device='cuda')
    for s in (128, 1):
        x = seeded_normal((20_000, s), 9)
        check(f'csr star row of 20,000 edges S={s}',
              csr_kernel.csr_spmm(A.rowptr, A.cols, A.vals, x),
              csr_kernel.csr_spmm_plain(A.rowptr, A.cols, A.vals.double(),
                                        x.double()), TOL_CSR)
    # a tenth of the entries repeated and kept as separate stored entries
    # (from_coo(sum_duplicates=False)): both entries sum them like any
    # others, against the matrix with the repeats summed, in f64
    coo = W.tocoo()
    dup = rng.choice(coo.nnz, coo.nnz // 10, replace=False)
    rows = np.concatenate([coo.row, coo.row[dup]])
    cols = np.concatenate([coo.col, coo.col[dup]])
    vals = np.concatenate([coo.data, rng.normal(size=len(dup))])
    A = gsp.core.from_coo(rows, cols, vals, n, sum_duplicates=False,
                          dtype=torch.float32, device='cuda')
    A64 = gsp.core.from_coo(rows, cols, vals, n, dtype=torch.float64,
                            device='cuda')
    if A.nnz != A64.nnz + len(dup):
        raise AssertionError(f'{A.nnz} stored entries with the repeats '
                             f'kept, {A64.nnz} summed')
    for s in (1, 128):
        x = seeded_normal((n, s), 10 + s)
        check(f'csr with {len(dup)} repeated entries kept, S={s} '
              f'({csr_kernel.entry_for(s, torch.float32)} entry)',
              csr_kernel.csr_spmm(A.rowptr, A.cols, A.vals, x),
              csr_kernel.csr_spmm_plain(A64.rowptr, A64.cols, A64.vals,
                                        x.double()), TOL_CSR)
    del A, A64

    n = 128 * 64 + 37        # ragged last tile
    for offsets, b in (((1, 7, 100), 1), ((1, 128, 300, 500), 4)):
        M = sum(sps.diags(rng.normal(size=n - o), o) for o in offsets)
        M = (M + M.T).tocsr()
        for dtype, widths, tol in ((torch.float32, (128, 5), TOL_BANDED),
                                   (torch.float64, (5,), TOL_F64)):
            B = gsp.core.sparse.banded_from_scipy(M, dtype=dtype,
                                                  device='cuda')
            assert B.half_bw == b, B.half_bw
            for s in widths:
                x = seeded_normal((n, s), s, dtype=dtype)
                check(f'banded b={b} S={s} {dtype}',
                      banded_kernel.banded_spmm(B.tiles, x, n),
                      banded_kernel.banded_spmm_plain(B.tiles, x, n), tol)
    # Grid2d tiles scaled by 2/7.93: not exact in TF32 (unlike path B's
    # integer tiles), so both operands' small terms count
    G = gsp.graphs.Grid2d(64, 61)
    tiles = G.L.to_banded().offdiag.tiles * (2.0 / 7.93)
    for s in (128, 5):
        x = seeded_normal((G.N, s), s)
        check(f'banded Grid2d(64, 61) tiles * 2/7.93 S={s}',
              banded_kernel.banded_spmm(tiles, x, G.N),
              banded_kernel.banded_spmm_plain(tiles, x, G.N), TOL_BANDED)
    return phase_windowed_kernels(W)


def check_windowed(name, M, s, dtype, tol):
    """Fold and tail kernels of the windowed matrix M against their plain
    versions at width s (the tail with the residue list)."""
    kp = M.borrow_span * M.window_rows
    x = seeded_normal((M.n_cols, s), s, dtype=dtype)
    t = wk.windowed_fold(M.cols, M.vals, M.rowid, x, M.chunk_rows, kp)
    t_plain = wk.windowed_fold_plain(M.cols, M.vals, M.rowid, x,
                                     M.chunk_rows, kp)
    check(f'windowed_fold {name} S={s} {dtype}', t, t_plain, tol)
    check(f'window_strip (tail) {name} S={s} {dtype}',
          wk.window_strip(t, M.n_rows, M.window_rows, M.residue, x),
          wk.window_strip_plain(t_plain, M.n_rows, M.window_rows, M.residue,
                                x), tol)


def ulps(got, want):
    """The largest |got - want| in bf16 ulps of the larger magnitude at each
    element, counted at 2^-8 of the largest |want| at least: a sum that
    cancels to near zero carries the f32 rounding of its addends, which two
    summation orders do not share."""
    got, want = got.float(), want.float()
    mag = torch.maximum(got.abs(), want.abs()).clamp(
        min=float(want.abs().max()) * 2.0**-8 + 1e-30)
    return float(((got - want).abs()
                  / torch.exp2(torch.floor(torch.log2(mag)) - 7)).max())


def check_windowed_bf16(combo, M, s, xd):
    """The bf16 instances of the fold and the tail against their plain
    versions. Both sum the fold in f32 (in another order), so a bf16 window
    tensor may differ by the one rounding of each sum: at most 1 ulp. The
    tail adds the same addends in the same order, with the same roundings:
    bit-equal."""
    kp = M.borrow_span * M.window_rows
    x = seeded_normal((M.n_cols, s), s).to(xd)
    args = (M.cols, M.vals, M.rowid, x, M.chunk_rows, kp)
    t, t_plain = wk.windowed_fold(*args), wk.windowed_fold_plain(*args)
    name = f'windowed_fold bf16 {combo} S={s} (x {xd}, vals {M.vals.dtype})'
    if xd == torch.bfloat16:
        err = ulps(t, t_plain)
        log(f'  {name}: {err:.2f} bf16 ulps (tol {TOL_BF16_ULPS})')
        if not err <= TOL_BF16_ULPS:
            raise AssertionError(f'{name}: {err} ulps > {TOL_BF16_ULPS}')
    else:
        check(name, t, t_plain, TOL_WINDOWED)
    check(f'window_strip (tail) bf16 {combo} S={s} {xd}',
          wk.window_strip(t, M.n_rows, M.window_rows, M.residue, x),
          wk.window_strip_plain(t, M.n_rows, M.window_rows, M.residue, x),
          0.0)


def phase_kernel_b():
    """Kernel B's three entry points against their plain versions, each
    instance (f32, f64, f32 with a bf16 carry) at a ragged and a full
    width: bit for bit (both round every operation once, in one order)."""
    log('phase 2b: kernel B (the fused Chebyshev step) against its plain '
        'versions')
    n, nf, g = (1 << 16) + 3, 4, 14
    def equal(name, got, want):
        if not torch.equal(got, want):
            err = float((got.double() - want.double()).abs().max())
            raise AssertionError(f'{name}: kernel and plain differ by {err}')

    for md, cd in CHEBY_TYPES:
        for s in (128, 5):
            y, t, t_old = (seeded_normal((n, s), 40 + k).to(cd)
                           for k in range(3))
            fd = seeded_normal((n,), 43, dtype=md)
            sc = torch.tensor(0.731, dtype=md, device='cuda')
            acc = seeded_normal((nf, n, s), 44, dtype=md)
            ck = seeded_normal((nf,), 45, dtype=md)
            out = cheby_kernel.cheby_step(y, t, t_old, fd, sc)
            want = cheby_kernel.cheby_step_plain(y, t, t_old, fd, sc,
                                                 torch.empty_like(t))
            equal('cheby_step', out, want)
            ring = seeded_normal((g + 2, n, s), 46).to(cd)
            cg = seeded_normal((g, nf), 47, dtype=md)
            acc_plain = acc.clone()
            cheby_kernel.cheby_acc_group(acc, ring, cg, 9)     # wraps
            cheby_kernel.cheby_acc_group_plain(acc_plain, ring, cg, 9)
            equal('cheby_acc_group', acc, acc_plain)
            del ring
            tf = seeded_normal((n, s, nf), 48).to(cd)
            a, a_plain = acc[0].clone(), acc[0].clone()
            cheby_kernel.cheby_acc_contract(a, tf, ck)
            cheby_kernel.cheby_acc_contract_plain(a_plain, tf, ck)
            equal('cheby_acc_contract', a, a_plain)
            log(f'  kernel B {md} arithmetic, {cd} carry, S={s}: step, '
                f'group (g={g}) and contraction bit-equal')
    # the group at more filter counts (its one pass over the terms for any
    # Nf), f32 and bf16 terms, groups of 13 and 14
    s = 128
    for md, cd in ((torch.float32, torch.float32),
                   (torch.float32, torch.bfloat16)):
        ring = seeded_normal((g + 2, 1 << 16, s), 70).to(cd)
        for nf_k in GROUP_NFS:
            acc = seeded_normal((nf_k, 1 << 16, s), 71, dtype=md)
            for size in (13, 14):
                cg = seeded_normal((size, nf_k), 72, dtype=md)
                acc_plain = acc.clone()
                cheby_kernel.cheby_acc_group(acc, ring, cg, 9)
                cheby_kernel.cheby_acc_group_plain(acc_plain, ring, cg, 9)
                equal(f'cheby_acc_group Nf={nf_k} g={size} {cd} terms', acc,
                      acc_plain)
        log(f'  cheby_acc_group at (2^16, {s}), {cd} terms, Nf in '
            f'{GROUP_NFS}, g in (13, 14): bit-equal')
        del ring, acc, acc_plain
    for dt in (torch.float32, torch.float64):
        for s in (128, 5):
            ring = seeded_normal((g + 2, n, s), 61, dtype=dt)
            gbar = seeded_normal((n, s, nf), 62, dtype=dt)
            for size, start in ((g, 9), (1, 0)):
                check_dot(f'cheby_dot_group {dt} S={s} g={size}', gbar, ring,
                          start, size)


def check_dot(name, gbar, ring, start, g):
    """``cheby_dot_group`` against its plain version run on float64
    copies of the operands, within its summation bound
    (``cheby_kernel.cheby_dot_group_bound``: both sums' worst case
    ``(2n + 2)·2^-53·Σ|ḡ_f||t_j|`` plus the output's one rounding), and two
    launches bit-equal. Returns the largest |error| and its largest share
    of the bound."""
    nf = gbar.shape[-1]
    out = torch.empty((g, nf), dtype=gbar.dtype, device='cuda')
    cheby_kernel.cheby_dot_group(out, gbar, ring, start)
    again = cheby_kernel.cheby_dot_group(torch.empty_like(out), gbar, ring,
                                         start)
    if not torch.equal(out, again):
        raise AssertionError(f'{name}: two launches differ')
    want = cheby_kernel.cheby_dot_group_plain(
        torch.empty((g, nf), dtype=torch.float64, device='cuda'),
        gbar.double(), ring.double(), start)
    err = (out.double() - want).abs()
    del want
    share = float((err / cheby_kernel.cheby_dot_group_bound(
        gbar, ring, start, g, gbar.dtype)).max())
    log(f'  {name}: max |err| {float(err.max()):.3e}, {share:.3e} of the '
        f'summation bound; two launches bit-equal')
    if not share <= 1.0:
        raise AssertionError(f'{name}: error {share} x the summation bound')
    return float(err.max()), share


def kernel_b_operands(n, s, md, cd, slots=0):
    """Seeded operands of kernel B at (n, s) with a ring of ``slots``
    terms."""
    ops = {name: seeded_normal((n, s), 50 + k).to(cd)
           for k, name in enumerate(('y', 't', 't_old'))}
    ops.update(fd=seeded_normal((n,), 53, dtype=md),
               sc=torch.tensor(0.731, dtype=md, device='cuda'),
               out=torch.empty((n, s), dtype=cd, device='cuda'))
    if slots:
        ops['ring'] = seeded_normal((slots, n, s), 56).to(cd)
    return ops


def require_equal(name, got, want):
    """Raise unless kernel and plain version agree bit for bit; returns
    their largest |difference| (0)."""
    torch.cuda.synchronize()
    err = float((got.double() - want.double()).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f'{name}: kernel and plain differ by {err}')
    log(f'  {name}: kernel and plain version bit-equal')
    return err


def measure_step(n, s, md, cd, windowed):
    """``cheby_step`` at a path's shape, held bit for bit against its plain
    version on the same operands, then timed. ``unfused_eager_ms``: the
    eager passes it replaces, the port's step before kernel B
    (``matvec(factor, t) - t_old`` on CSR and banded;
    ``spmm.mul_(sc).addcmul_(fd, t).sub_(t_old)`` on the windowed format, in
    f32 arithmetic with the carry cast around it for a bf16 carry)."""
    o = kernel_b_operands(n, s, md, cd)
    fd2 = o['fd'][:, None]
    args = (o['y'], o['t'], o['t_old'], o['fd'], o['sc'])
    out_plain = torch.empty_like(o['out'])
    cheby_kernel.cheby_step(*args, o['out'])
    cheby_kernel.cheby_step_plain(*args, out_plain)
    err = require_equal(f'cheby_step at ({n}, {s}) {md}, {cd} carry',
                        o['out'], out_plain)
    del out_plain
    if not windowed:
        def eager():
            return (fd2 * o['t'] + o['y']) - o['t_old']
    elif cd == md:
        y = o['y'].clone()

        def eager():
            y.mul_(o['sc']).addcmul_(fd2, o['t']).sub_(o['t_old'])
    else:
        def eager():
            o['out'].copy_(o['y'].to(md).mul_(o['sc'])
                           .addcmul_(fd2, o['t'].to(md))
                           .sub_(o['t_old'].to(md)))

    ci, mi = torch.finfo(cd).bits // 8, torch.finfo(md).bits // 8
    return {'max_abs_err': err,
            'ms': time_ms(lambda: cheby_kernel.cheby_step(*args, o['out']),
                          20),
            'plain_ms': time_ms(lambda: cheby_kernel.cheby_step_plain(
                *args, o['out']), 3),
            'unfused_eager_ms': time_ms(eager, 10), 'library_ms': None,
            'library': 'none: no one PyTorch call computes the step',
            **bound(4 * n * s * ci + n * mi, 4 * n * s), 'shape': [n, s],
            'dtypes': [str(md), str(cd)]}


def measure_group(n, s, nf, md, cd, g):
    """``cheby_acc_group`` at a path's shape: g terms from a ring of g + 2,
    wrapping, into nf accumulators, held bit for bit against its plain
    version, then timed. ``unfused_eager_ms``: the g per-step
    ``acc.addcmul_`` passes it replaces. ``library_ms``: one ``addmm_`` of
    a contiguous group into the accumulators, where the terms are in the
    accumulators' dtype (no PyTorch call mixes a bf16 ring into f32
    accumulators)."""
    o = kernel_b_operands(n, s, md, cd, slots=g + 2)
    ring = o['ring']
    acc = seeded_normal((nf, n, s), 54, dtype=md)
    cg = seeded_normal((g, nf), 57, dtype=md)
    acc_plain = acc.clone()
    cheby_kernel.cheby_acc_group(acc, ring, cg, 9)
    cheby_kernel.cheby_acc_group_plain(acc_plain, ring, cg, 9)
    err = require_equal(f'cheby_acc_group at ({n}, {s}) g={g} {md}, {cd} '
                        f'terms', acc, acc_plain)
    del acc_plain
    ckb = [cg[j].reshape(nf, 1, 1) for j in range(g)]

    def eager():
        for j in range(g):
            acc.addcmul_(ckb[j], ring[j].to(md)[None])

    library_ms, library = None, ('none: no PyTorch call mixes bf16 terms '
                                 'into f32 accumulators')
    if md == cd:
        acc2, terms2, cgT = acc.view(nf, -1), ring[:g].view(g, -1), cg.T
        want = acc2.clone()
        cheby_kernel.cheby_acc_group(want.view(acc.shape), ring, cg, 0)
        check(f'addmm_ vs cheby_acc_group at ({n}, {s}) g={g}',
              acc2.clone().addmm_(cgT, terms2), want, TOL_CSR)
        del want
        library_ms = time_ms(lambda: acc2.addmm_(cgT, terms2), 20)
        library = 'addmm_(cg.T, terms) on the accumulators, (Nf, N*S)'
    ci, mi = torch.finfo(cd).bits // 8, torch.finfo(md).bits // 8
    return {'max_abs_err': err,
            'ms': time_ms(lambda: cheby_kernel.cheby_acc_group(
                acc, ring, cg, 9), 20),
            'plain_ms': time_ms(lambda: cheby_kernel.cheby_acc_group_plain(
                acc, ring, cg, 9), 2),
            'unfused_eager_ms': time_ms(eager, 5), 'library_ms': library_ms,
            'library': library,
            **bound(g * n * s * ci + 2 * nf * n * s * mi, 2 * g * nf * n * s),
            'shape': [n, s], 'nf': nf, 'g': g,
            'dtypes': [str(md), str(cd)]}


def measure_contract(n, s, nf):
    """``cheby_acc_contract`` at synthesis of nf filters on (n, s) f32, held
    bit for bit against its plain version, then timed. ``unfused_eager_ms``:
    ``acc += (ck * t).sum(-1)``; ``library_ms``: one ``addmv_``."""
    t = seeded_normal((n, s, nf), 58)
    acc = seeded_normal((n, s), 59)
    ck = seeded_normal((nf,), 60)
    acc_plain = acc.clone()
    cheby_kernel.cheby_acc_contract(acc, t, ck)
    cheby_kernel.cheby_acc_contract_plain(acc_plain, t, ck)
    err = require_equal(f'cheby_acc_contract at ({n}, {s}) Nf={nf}', acc,
                        acc_plain)
    check('addmv_ vs cheby_acc_contract', acc_plain.view(-1).addmv_(
        t.view(-1, nf), ck), cheby_kernel.cheby_acc_contract(acc, t, ck)
        .view(-1), TOL_CSR)
    del acc_plain
    flat, tf = acc.view(-1), t.view(-1, nf)
    return {'max_abs_err': err,
            'ms': time_ms(lambda: cheby_kernel.cheby_acc_contract(acc, t, ck),
                          20),
            'plain_ms': time_ms(lambda: cheby_kernel.cheby_acc_contract_plain(
                acc, t, ck), 3),
            'unfused_eager_ms': time_ms(lambda: acc.add_((ck * t).sum(-1)),
                                        10),
            'library_ms': time_ms(lambda: flat.addmv_(tf, ck), 20),
            'library': 'addmv_(t as (N*S, Nf), ck) on the accumulator',
            **bound(n * s * nf * 4 + 2 * n * s * 4, 2 * nf * n * s),
            'shape': [n, s], 'nf': nf, 'dtypes': ['torch.float32'] * 2}


def measure_dot(n, s, nf, g):
    """``cheby_dot_group`` at a path's shape (f32, a group of g wrapping
    around a ring of g + 2 terms), held against its float64 reference
    within the summation bound, then timed beside its plain version and
    the one library call, ``torch.mm`` of a group that does not wrap."""
    ring = seeded_normal((g + 2, n, s), 63)
    gbar = seeded_normal((n, s, nf), 64)
    err, share = check_dot(f'cheby_dot_group at ({n}, {s}) Nf={nf} g={g}',
                           gbar, ring, 9, g)
    out = torch.empty((g, nf), device='cuda')
    terms, gb = ring[:g].view(g, -1), gbar.view(-1, nf)
    lib = torch.mm(terms, gb)
    want = cheby_kernel.cheby_dot_group(torch.empty_like(out), gbar, ring, 0)
    lib_err = float(((lib.double() - want.double()).abs()
                     / cheby_kernel.cheby_dot_group_bound(
                         gbar, ring, 0, g, torch.float32)).max())
    log(f'  torch.mm vs cheby_dot_group: {lib_err:.3e} of the summation '
        f'bound')
    del lib, want
    return {'max_abs_err': err, 'bound_share': share,
            'ms': time_ms(lambda: cheby_kernel.cheby_dot_group(
                out, gbar, ring, 9), 20),
            'plain_ms': time_ms(lambda: cheby_kernel.cheby_dot_group_plain(
                out, gbar, ring, 9), 3),
            'library_ms': time_ms(lambda: torch.mm(terms, gb), 20),
            'library': 'torch.mm(terms of the group as (g, N*S), gbar as '
                       '(N*S, Nf)), a group that does not wrap',
            'library_bound_share': lib_err,
            **bound((g + nf) * n * s * 4 + g * nf * 4, 2 * g * nf * n * s),
            'shape': [n, s], 'nf': nf, 'g': g, 'dtypes': ['torch.float32']}


def phase_kernel_b_times(groups):
    """Kernel B's entry points at each path's shape (the f32 bank of 4
    filters on 128 signals; path D with a bf16 carry), each held bit for
    bit against its plain version and timed beside it, the eager passes it
    replaces and the library call where there is one; and each path's
    kernel-B time per bank: 29 steps, and the groups of g (one for T_1,
    the head one step at a time, then groups of g). ``groups``: each
    path's g. Path A's shape and types are path C's, so A reuses C's
    numbers. Path E's shapes beside them: the step at the x̄ synthesis's
    width (``A_synthesis``, ``B_synthesis``), the synthesis contraction at
    (N, S, Nf) and the coefficient gradient, each at paths A's (and C's)
    and B's N."""
    log('phase 7: kernel B at the paths\' shapes, against its plain versions')
    nf, s, f32, bf16 = len(SCALES), N_SIGNALS, torch.float32, torch.bfloat16
    shape = {'A': (N_BA, f32), 'B': (GRID_SIDE * GRID_SIDE, f32),
             'C': (N_BA, f32), 'D': (N_BA, bf16)}
    steps = ORDER - 1
    step, group, one = {}, {}, {}
    for p in 'BCD':
        n, cd = shape[p]
        step[p] = measure_step(n, s, f32, cd, windowed=p in 'CD')
        torch.cuda.empty_cache()
    step['A'] = measure_step(N_BA, s, f32, f32, windowed=False)
    torch.cuda.empty_cache()
    for p in 'AB':
        step[f'{p}_synthesis'] = measure_step(shape[p][0], WIDE, f32, f32,
                                              windowed=False)
        torch.cuda.empty_cache()
    for p in 'BCD':
        n, cd = shape[p]
        group[p] = measure_group(n, s, nf, f32, cd, groups[p])
        torch.cuda.empty_cache()
        one[p] = measure_group(n, s, nf, f32, cd, 1)
        torch.cuda.empty_cache()
    if groups['A'] != groups['C']:
        raise AssertionError(f'path A groups {groups["A"]} terms, path C '
                             f'{groups["C"]}: A cannot take C\'s numbers')
    group['A'], one['A'] = group['C'], one['C']
    per_bank = {}
    for p in 'ABCD':
        head, full = steps % groups[p], steps // groups[p]
        per_bank[p] = {
            'g': groups[p],
            'kernel_ms': (steps * step[p]['ms'] + (1 + head) * one[p]['ms']
                          + full * group[p]['ms']),
            'unfused_eager_ms': (steps * step[p]['unfused_eager_ms']
                                 + (1 + steps) * one[p]['unfused_eager_ms'])}
    log(f'  kernel B per bank: {json.dumps(per_bank)}')
    contract, dot = {}, {}
    for p in 'AB':
        contract[p] = measure_contract(shape[p][0], s, nf)
        torch.cuda.empty_cache()
        # the c̄ pass (A's shape and types are C's): groups of g, and the
        # groups of one (T_0, T_1 and the head)
        g = groups[p]
        dot[p] = {f'g{size}': measure_dot(shape[p][0], s, nf, size)
                  for size in (g, 1)}
        torch.cuda.empty_cache()
        dot[p]['per_backward_ms'] = (steps // g * dot[p][f'g{g}']['ms']
                                     + (dot_groups(g) - steps // g)
                                     * dot[p]['g1']['ms'])
        log(f'  cheby_dot_group per backward at {p}: '
            f'{dot[p]["per_backward_ms"]:.3f} ms')
    return step, group, one, contract, per_bank, dot


def phase_windowed_kernels(W):
    """The windowed kernels on the phase's BA 2^16 graph (default packing,
    ``window_rows=256`` for an S tile of 64 and int32 row ids, span 4), and
    the one-hot fold at #3's shape."""
    for dtype, widths, tol in ((torch.float32, (128, 5, 1), TOL_WINDOWED),
                               (torch.float64, (5,), TOL_F64)):
        M = wd.windowed_from_scipy(W, dtype=dtype, device='cuda')
        log(f'  windowed N=2^16 {dtype}: slabs {tuple(M.cols.shape)}, '
            f'span {M.borrow_span}, {len(M.levels)} level tiers')
        for s in widths:
            check_windowed('N=2^16', M, s, dtype, tol)
    for name, kw in (('P=256', dict(window_rows=256)),
                     ('span 4', dict(borrow_span=4))):
        M = wd.windowed_from_scipy(W, dtype=torch.float32, device='cuda',
                                   **kw)
        log(f'  windowed {name}: slabs {tuple(M.cols.shape)}, row ids '
            f'{M.rowid.dtype}, S tile '
            f'{wk.fold_layout(M.borrow_span * M.window_rows, 128, 4).s_tile}')
        check_windowed(name, M, 128, torch.float32, TOL_WINDOWED)
    M = wd.windowed_from_scipy(W, dtype=torch.float32, device='cuda')
    for combo, (xd, vd) in BF16_FOLDS.items():
        for s in (128, 5):
            check_windowed_bf16(combo, M.astype(vd), s, xd)
    gen = torch.Generator(device='cuda').manual_seed(3)
    rid = torch.randint(0, FOLD3_KP, (1, FOLD3_LT), dtype=torch.int32,
                        device='cuda', generator=gen)
    p = seeded_normal((1, FOLD3_LT, 128), 4).to(torch.bfloat16)
    fold3 = measure_fold(rid, p, FOLD3_KP, 100)
    # dead slots (ids on both sides of [0, KP)) holding inf add nothing
    dead = torch.rand(1, FOLD3_LT, device='cuda', generator=gen) < 0.2
    rid = torch.where(dead, torch.where(rid % 2 == 0, -1, FOLD3_KP + rid),
                      rid)
    for dtype in (torch.bfloat16, torch.float32):
        p_inf = torch.where(dead[..., None], float('inf'),
                            p.float()).to(dtype)
        check(f'fold_products with inf in dead slots {dtype}',
              wk.fold_products(rid, p_inf, FOLD3_KP),
              wk.fold_products_plain(rid, p_inf, FOLD3_KP), TOL_FOLD)
    return fold3


def measure_fold(rid, p, kp, iters):
    """``fold_products`` against its plain version, and its times beside
    the library yardstick: one ``index_add_`` of the products, cast to f32
    beforehand (the cast is not timed)."""
    nw, lt, s = p.shape
    out = wk.fold_products(rid, p, kp)
    out_plain = wk.fold_products_plain(rid, p, kp)
    max_abs_err = float((out - out_plain).abs().max())
    check(f'fold_products NW={nw} Lt={lt} KP={kp} {p.dtype}', out, out_plain,
          TOL_FOLD)
    del out_plain
    p32 = p.float().reshape(-1, s)
    dst = (torch.arange(nw, device=p.device)[:, None] * kp
           + rid).reshape(-1).long()
    acc = torch.zeros(nw * kp, s, device=p.device)
    # the dense one-hot product the kernel does, at the bf16 rate
    dense_flops = 2 * nw * kp * lt * s
    return {'max_abs_err': max_abs_err,
            'ms': time_ms(lambda: wk.fold_products(rid, p, kp), iters),
            **device_ms(lambda: wk.fold_products(rid, p, kp), iters),
            'plain_ms': time_ms(lambda: wk.fold_products_plain(rid, p, kp),
                                max(iters // 10, 2)),
            'library_ms': time_ms(lambda: acc.index_add_(0, dst, p32), iters),
            'library': 'index_add_ of the products cast to f32 beforehand',
            **bound(rid.numel() * 4 + p.numel() * p.element_size()
                    + out.numel() * 4, p.numel()),
            'bound_tensor_ms': dense_flops / BF16_FLOPS * 1e3,
            'blocks': wk.products_layout(nw, kp, s, p.element_size()).blocks,
            'shape': {'NW': nw, 'Lt': lt, 'KP': kp, 'S': s}}


def measure_wide(name, kernel, plain, tol, work, width=WIDE, library=None,
                 library_name=None):
    """A kernel at a width above N_SIGNALS (WIDE columns, the x̄ synthesis's,
    as the backward runs it, unless ``width`` says otherwise) against its
    plain version on the same inputs, run on blocks of N_SIGNALS columns
    (an output column reads its own input column alone; the CSR plain
    version would gather 69 GB at once) and joined along the last axis; two
    launches bit-equal; then timed. ``kernel()`` returns the output,
    ``plain(cols)`` that of a column slice; ``tol`` is ``check``'s (0.0: bit
    for bit); ``work`` the bound dict at ``width``; ``library()``, where
    given, the one PyTorch call for the same product, timed beside it."""
    y = kernel()
    want = torch.cat([plain(slice(i, i + N_SIGNALS))
                      for i in range(0, width, N_SIGNALS)], dim=-1)
    rel_err = check(f'{name} at {width} columns', y, want, tol)
    max_abs_err = float((y.float() - want.float()).abs().max())
    del want
    if not torch.equal(y, kernel()):
        raise AssertionError(f'{name}: two launches differ at {width} '
                             f'columns')
    log(f'  {name} at {width} columns: two launches bit-equal')
    del y
    out = {'max_abs_err': max_abs_err, 'rel_err': rel_err,
           'ms': time_ms(kernel, 10), 's': width, **work}
    if library is not None:
        out.update(library_ms=time_ms(library, 10), library=library_name)
    return out


def csr_work(M, s, item, flops_per_s=FP32_FLOPS):
    """The bound of one CSR product ``M @ v``, v (n_cols, s): v read once,
    the output (n_rows, s) written once, the CSR's columns, values and row
    pointers read once; two operations per stored entry and column."""
    return bound((M.n_cols + M.n_rows) * s * item + M.nnz * (4 + item)
                 + (M.n_rows + 1) * 4, 2 * M.nnz * s, flops_per_s)


def measure_spmm(name, M, v, flops_per_s=FP32_FLOPS, tol=TOL_CSR,
                 entry=None):
    """One CSR product ``M @ v`` on kernel A (the entry the wrapper's width
    table gives, or ``entry``), held against its plain version within
    ``tol``, two launches bit-equal, then timed beside its plain version
    and ``torch.sparse.mm`` of the same CSR, with its bound; the symbol
    launched; at up to 32 columns also the device time of a call and of
    the library's."""
    args = (M.rowptr, M.cols, M.vals, v)
    before = dict(SYMBOLS)
    y = csr_kernel.csr_spmm(*args, entry=entry)
    symbol = [k for k, n in SYMBOLS.items() if n != before.get(k, 0)]
    y_plain = csr_kernel.csr_spmm_plain(*args)
    max_abs_err = float((y - y_plain).abs().max())
    check(f'{name} kernel vs plain', y, y_plain, tol)
    del y_plain
    if not torch.equal(y, csr_kernel.csr_spmm(*args, entry=entry)):
        raise AssertionError(f'{name}: two launches differ')
    log(f'  {name}: two launches bit-equal ({", ".join(symbol)})')
    del y
    nnz, s = M.nnz, v.shape[1]
    lib = torch.sparse_csr_tensor(M.rowptr, M.cols[:nnz], M.vals[:nnz],
                                  size=M.shape)
    out = {'max_abs_err': max_abs_err,
           'ms': time_ms(lambda: csr_kernel.csr_spmm(*args, entry=entry), 20),
           'plain_ms': time_ms(lambda: csr_kernel.csr_spmm_plain(*args), 3),
           'library_ms': time_ms(lambda: torch.sparse.mm(lib, v), 20),
           'library': 'torch.sparse.mm on a sparse CSR tensor',
           **csr_work(M, s, v.element_size(), flops_per_s),
           'shape': [M.n_rows, M.n_cols], 'nnz': nnz, 's': s,
           'dtype': str(v.dtype), 'symbol': symbol}
    if s <= 32:
        out.update(device_ms=graph_ms(
            lambda: csr_kernel.csr_spmm(*args, entry=entry), 20),
                   library_device_ms=graph_ms(
                       lambda: torch.sparse.mm(lib, v), 20),
                   device_ms_by='a CUDA graph of 20 calls, replayed')
    del lib
    return out


def measure_width_sweep(A):
    """Kernel A on path A's graph at each width of the sweep, f32 and f64:
    each entry that takes the width held and timed by ``measure_spmm``
    (the narrow one up to its 128 f32 or 64 f64 columns), the wrapper's
    choice named. The crossover of ``csr_kernel.NARROW_WIDTH`` comes from
    these times."""
    out = {}
    for dtype, widths, tol, flops in (
            (torch.float32, SWEEP_F32, TOL_CSR, FP32_FLOPS),
            (torch.float64, SWEEP_F64, TOL_F64, FP64_FLOPS)):
        M = A if dtype == torch.float32 else A.astype(dtype)
        for s in widths:
            v = seeded_normal((M.n_cols, s), 120 + s, dtype=dtype)
            row = {'chosen': csr_kernel.entry_for(s, dtype)}
            for entry in ('narrow', 'wide'):
                if entry == 'narrow' and s > csr_kernel.NARROW_MAX[dtype]:
                    continue
                row[entry] = measure_spmm(
                    f'csr_spmm ({entry}) on path A\'s graph, S={s} {dtype}',
                    M, v, flops, tol, entry=entry)
            torch.cuda.empty_cache()
            out[f'{s}_{str(dtype)[6:]}'] = row
        del M
    log(f'  width sweep (ms narrow / wide / library): ' + ', '.join(
        f'{k} {r.get("narrow", {}).get("ms", float("nan")):.4f} / '
        f'{r["wide"]["ms"]:.4f} / {r["wide"]["library_ms"]:.4f}'
        for k, r in out.items()))
    return out


def measure_csr(A, x):
    """Kernel, plain and library times of one CSR SpMM at the path's shape,
    and the kernel at the x̄ synthesis's width (``at_backward_width``)."""
    out = measure_spmm('csr_spmm at path A', A, x)
    nnz, n, s, item = A.nnz, A.n_rows, x.shape[1], x.element_size()
    bytes_gather = nnz * s * item + n * s * item + nnz * (4 + item)
    x_wide = seeded_normal((n, WIDE), 80)
    lib = torch.sparse_csr_tensor(A.rowptr, A.cols[:nnz], A.vals[:nnz],
                                  size=A.shape)
    wide = measure_wide(
        'csr_spmm', lambda: csr_kernel.csr_spmm(A.rowptr, A.cols, A.vals,
                                                x_wide),
        lambda c: csr_kernel.csr_spmm_plain(A.rowptr, A.cols, A.vals,
                                            x_wide[:, c]), TOL_CSR,
        csr_work(A, WIDE, item), library=lambda: torch.sparse.mm(lib, x_wide),
        library_name='torch.sparse.mm on a sparse CSR tensor')
    del x_wide, lib
    return {**out, 'bound_gather_ms': bytes_gather / HBM_BYTES_PER_S * 1e3,
            'n': n, 'at_backward_width': wide}


def measure_hub_tail(A, x):
    """How much of the CSR kernel's time the hub rows (above HUB_DEGREE
    edges) take: its ms per launch on ``A`` as it is, on ``A`` with those
    rows emptied, and on those rows alone (both made on the card from
    ``A``'s arrays)."""
    counts = A.rowptr[1:] - A.rowptr[:-1]
    hub = counts > HUB_DEGREE
    edge_hub = torch.repeat_interleave(hub, counts.long(),
                                       output_size=A.nnz)
    zero = torch.zeros(1, dtype=torch.int32, device=x.device)

    def rows(keep_hubs):
        kept = torch.where(hub == keep_hubs, counts, 0)
        mask = edge_hub == keep_hubs
        return (torch.cat([zero, kept.cumsum(0, dtype=torch.int32)]),
                A.cols[:A.nnz][mask].contiguous(),
                A.vals[:A.nnz][mask].contiguous(), x)

    out = {'hub_rows': int(hub.sum()),
           'hub_edges': int(edge_hub.sum()), 'nnz': A.nnz,
           'ms': time_ms(lambda: csr_kernel.csr_spmm(
               A.rowptr, A.cols, A.vals, x), 20)}
    for name, keep in (('ms_without_hubs', False), ('ms_hubs_only', True)):
        args = rows(keep)
        out[name] = time_ms(lambda: csr_kernel.csr_spmm(*args), 20)
        del args
    out['hub_tail_ms'] = out['ms'] - out['ms_without_hubs']
    return out


def measure_banded(B, x):
    """Kernel, plain and library times of one banded SpMM at the path's
    shape, and the kernel at the x̄ synthesis's width
    (``at_backward_width``). The library yardstick is torch.bmm over band windows gathered
    beforehand (the gather is not timed). The bound counts the function's
    own products at the card's fastest rate for f32 operands (TF32, dense),
    beside the bytes. Two diagnostics stand beside it: the FP32 FFMA bound
    (``bound_fp32_ms``) and the time of the three TF32 products per product
    that the f32 kernel issues (``bound_tf32x3_ms``)."""
    tiles, n = B.tiles, B.n_rows
    y = banded_kernel.banded_spmm(tiles, x, n)
    y_plain = banded_kernel.banded_spmm_plain(tiles, x, n)
    max_abs_err = float((y - y_plain).abs().max())
    check('banded kernel at path B shape', y, y_plain, TOL_BANDED)
    del y, y_plain
    nb, n_diag = tiles.shape[:2]
    b, s = B.half_bw, x.shape[1]
    a_cat = tiles.permute(0, 2, 1, 3).reshape(nb, 128, n_diag * 128)
    x_cat = banded_kernel.band_windows(x, nb, b).reshape(nb, n_diag * 128, s)
    ms = time_ms(lambda: banded_kernel.banded_spmm(tiles, x, n), 20)
    plain_ms = time_ms(lambda: banded_kernel.banded_spmm_plain(tiles, x, n), 5)
    library_ms = time_ms(lambda: torch.bmm(a_cat, x_cat), 20)
    del a_cat, x_cat
    flops = 2 * banded_pairs(B) * 128 * 128 * s
    return {
        'max_abs_err': max_abs_err, 'ms': ms, 'plain_ms': plain_ms,
        'library_ms': library_ms,
        'library': 'torch.bmm over pre-gathered band windows',
        **banded_work(B, s, x.element_size()),
        'at_backward_width': measure_banded_wide(B, WIDE),
        'bound_fp32_ms': flops / FP32_FLOPS * 1e3,
        'bound_tf32x3_ms': TF32_PRODUCTS * flops / TF32_FLOPS * 1e3,
        'gflop': flops / 1e9, 'tf32_gflop': TF32_PRODUCTS * flops / 1e9,
        'n': n, 's': s, 'half_bw': b,
    }


def banded_pairs(B):
    """The tile pairs (i, d) of a banded matrix whose x block lies inside
    the matrix."""
    nb, n_diag = B.tiles.shape[:2]
    return nb * n_diag - B.half_bw * (B.half_bw + 1)


def banded_work(B, s, item):
    """The bound of one banded product on s columns: the tiles read once, x
    read and the output written once; the products at the TF32 rate."""
    return bound(B.tiles.numel() * item + 2 * B.n_rows * s * item,
                 2 * banded_pairs(B) * 128 * 128 * s, TF32_FLOPS)


def measure_banded_wide(B, width):
    """The banded kernel at ``width`` columns against its plain version
    (``measure_wide``)."""
    tiles, n = B.tiles, B.n_rows
    x_wide = seeded_normal((n, width), 81)
    lib = slot_csr(B, x_wide.dtype)
    out = measure_wide(
        'banded_spmm', lambda: banded_kernel.banded_spmm(tiles, x_wide, n),
        lambda c: banded_kernel.banded_spmm_plain(
            tiles, x_wide[:, c].contiguous(), n), TOL_BANDED,
        banded_work(B, width, x_wide.element_size()), width,
        library=lambda: torch.sparse.mm(lib, x_wide),
        library_name='torch.sparse.mm on a sparse CSR tensor of the same '
                     'off-diagonal')
    del x_wide, lib
    return out


# the bench bank's SciPy references, by ('bench', N, λmax): paths A, C, H,
# I and L filter the same graph's signal with the same bank
REFERENCES = {}


def reference(L_host, lmax, evaluate, x, key=None):
    """The SciPy f64 recurrence on the scipy Laplacian ``L_host`` for 8
    columns of x: (Nf, N, 8). With ``key`` it is computed once and kept
    under it."""
    if key is not None and key in REFERENCES:
        log(f'  scipy f64 reference: the one of {key}')
        return REFERENCES[key]
    c64 = cheby_coeff(evaluate, lmax, m=ORDER, dtype=torch.float64,
                      device='cpu').numpy()
    x8 = x[:, :N_CHECK_COLS].double().cpu().numpy()
    t0 = time.time()
    ref = torch.from_numpy(scipy_recurrence(L_host, lmax, c64, x8))
    log(f'  scipy f64 reference: {time.time() - t0:.1f} s')
    if key is not None:
        REFERENCES[key] = ref
    return ref


def validate_path(name, ref, out, tol=TOL_PATH):
    """8 columns of ``out`` (Nf, N, S) against the reference."""
    return check(f'path {name} vs scipy f64', out[:, :, :N_CHECK_COLS].cpu(),
                 ref, tol)


# ---------------------------------------------------------------------------
# the paths, set up through the entry points a user calls (also used
# by tools/profile_torch_port.py, so both measure the same work)
# ---------------------------------------------------------------------------

def bench_graph(fmt, n=N_BA):
    """The BA graph of bench.py:53-58 (at ``n`` vertices) with its
    Laplacian in ``fmt``, its λmax and the heat bank. Returns ``(G, g, x,
    bank)``, ``bank()`` filtering x (n, 128) f32."""
    t0 = time.time()
    src, tgt = gsp.graphs.ba_edges_fast(n, m0=M_ATTACH, m=M_ATTACH, seed=42)
    W = symmetric_from_edges(src, tgt, n)
    log(f'  edges generated in {time.time() - t0:.1f} s: {W.nnz} stored')
    x = seeded_normal((n, N_SIGNALS), 0)
    t0 = time.time()
    G = gsp.graphs.Graph(W)
    torch.cuda.synchronize()
    log(f'  Graph(W) in {time.time() - t0:.1f} s')
    if fmt != 'coo':
        t0 = time.time()
        G.compute_laplacian(fmt=fmt)
        torch.cuda.synchronize()
        log(f'  compute_laplacian(fmt={fmt!r}) in {time.time() - t0:.1f} s')
    t0 = time.time()
    G.estimate_lmax()
    log(f'  estimate_lmax: {G.lmax:.6f} in {time.time() - t0:.1f} s')
    g = gsp.filters.Heat(G, scale=SCALES)
    return G, g, x, lambda: g.filter(x, method='chebyshev', order=ORDER)


def path_a():
    """Path A: the bench graph in the CSR format (the default)."""
    return bench_graph('coo')


def path_c():
    """Path C: the bench graph in the windowed-compact format, as the JAX
    package's bench.py:162-185 runs it."""
    return bench_graph('windowed')


def path_b():
    """Path B: Grid2d(512, 512), its λmax, the banded Laplacian and the
    heat bank's coefficients. Returns ``(G, Lb, g, c, x, bank)``,
    ``bank()`` applying the bank to x (N, 128) f32 on the banded operator."""
    t0 = time.time()
    G = gsp.graphs.Grid2d(GRID_SIDE, GRID_SIDE)
    G.estimate_lmax()
    Lb = G.L.to_banded()
    if Lb is None:
        raise AssertionError('Grid2d(512, 512) did not fit the banded format')
    torch.cuda.synchronize()
    log(f'  graph, lmax {G.lmax:.6f}, banded (half_bw {Lb.offdiag.half_bw}, '
        f'tiles {tuple(Lb.offdiag.tiles.shape)}) in {time.time() - t0:.1f} s')
    g = gsp.filters.Heat(G, scale=SCALES)
    c = cheby_coeff(g.evaluate, G.lmax, m=ORDER)
    x = seeded_normal((G.N, N_SIGNALS), 1)
    return G, Lb, g, c, x, lambda: cheby_op(Lb, G.lmax, c, x)


def phase_path_a():
    log(f'phase 3: path A, BarabasiAlbert N={N_BA}, CSR kernel')
    reset_counts()
    G, g, x, bank = path_a()
    degree = G.d
    hubs = degree > HUB_DEGREE
    log(f'  row degrees: mean {degree.mean():.2f}, max {degree.max()}; '
        f'{hubs.sum()} rows above {HUB_DEGREE} hold '
        f'{degree[hubs].sum() / degree.sum():.2%} of the edges')
    torch.cuda.reset_peak_memory_stats()
    out, launches, per_bank = run_bank(bank)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f'  launches on the path {launches}, per bank {per_bank}; peak '
        f'device memory {peak:.2f} GiB')
    require_launches('A', per_bank, csr_spmm=ORDER, cheby_step=ORDER - 1,
                     cheby_acc_group=1)
    # λmax's Lanczos products at one column take the narrow entry, the
    # bank's at 128 columns the wide one
    lmax_launches = {k: launches[k] - per_bank[k] for k in launches}
    require_narrow('A (estimate_lmax)', lmax_launches)
    if (per_bank['csr_spmm_wide'] != ORDER
            or per_bank['csr_spmm_narrow']):
        raise AssertionError(f'path A bank: {per_bank["csr_spmm_wide"]} '
                             f'wide and {per_bank["csr_spmm_narrow"]} '
                             f'narrow csr_spmm launches')
    if tuple(out.shape) != (N_BA, N_SIGNALS, len(SCALES)):
        raise AssertionError(f'path A output shape {tuple(out.shape)}')
    rel_err = validate_path('A', reference(G.L.to_scipy(), G.lmax,
                                           g.evaluate, x,
                                           key=('bench', N_BA, G.lmax)),
                            out.permute(2, 0, 1))
    del out

    ms_bank = time_ms(bank, 3)
    nnz = G.L.offdiag.nnz
    log(f'  {ms_bank:.3f} ms per bank, '
        f'{ORDER * nnz * N_SIGNALS / (ms_bank / 1e3):.4e} edge-ops/s')
    lmax_ms = time_ms(lambda: estimate_lmax_lanczos(G.L), 3)
    log(f'  estimate_lmax (32 Lanczos products of one column): '
        f'{lmax_ms:.3f} ms')
    kernel = measure_csr(G.L.offdiag, x)
    kernel.update(max_row_nnz=int(degree.max()))
    kernel['width_sweep'] = measure_width_sweep(G.L.offdiag)
    hub_tail = measure_hub_tail(G.L.offdiag, x)
    log(f'  hub tail: {json.dumps(hub_tail)}')
    kernel.update(hub_tail=hub_tail)
    path = {'ms_per_bank': ms_bank, 'rel_err': rel_err, 'nnz': nnz,
            'edge_ops_per_s': ORDER * nnz * N_SIGNALS / (ms_bank / 1e3),
            'lmax': G.lmax, 'acc_group': group_of(G.L, x),
            'peak_bank_gib': peak, 'estimate_lmax_ms': lmax_ms,
            'estimate_lmax_launches': {
                k: lmax_launches[k] for k in ('csr_spmm', 'csr_spmm_narrow',
                                              'csr_spmm_wide')}}
    return kernel, path, (launches, per_bank), (G, x)


def phase_path_b():
    log(f'phase 4: path B, Grid2d({GRID_SIDE}, {GRID_SIDE}), banded kernel')
    reset_counts()
    G, Lb, g, c, x, bank = path_b()
    out, launches, per_bank = run_bank(bank)
    log(f'  launches on the path {launches}, per bank {per_bank}')
    require_launches('B', per_bank, banded_spmm=ORDER, cheby_step=ORDER - 1,
                     cheby_acc_group=1)
    if tuple(out.shape) != (len(SCALES), G.N, N_SIGNALS):
        raise AssertionError(f'path B output shape {tuple(out.shape)}')
    check('path B banded vs CSR path', out, cheby_op(G.L, G.lmax, c, x),
          TOL_PATH)
    rel_err = validate_path('B', reference(G.L.to_scipy(), G.lmax,
                                           g.evaluate, x), out)
    del out

    ms_bank = time_ms(bank, 3)
    log(f'  {ms_bank:.3f} ms per bank')
    kernel = measure_banded(Lb.offdiag, x)
    path = {'ms_per_bank': ms_bank, 'rel_err': rel_err, 'n': G.N,
            'lmax': G.lmax, 'acc_group': group_of(Lb, x)}
    return kernel, path, (launches, per_bank), (G, Lb, x)


def measure_windowed(G, x):
    """Fold, tail and whole-SpMM times at path C's shape (x in the matrix's
    internal order, as the bank runs them), against their plain versions;
    the fold's and the tail's determinism (two launches bit-equal); the
    yardsticks on the same shuffled matrix in CSR, ``torch.sparse.mm`` and
    the port's CSR kernel; and the strip part's,
    ``torch.nn.functional.fold``; and the fold and the tail at the x̄
    synthesis's width (``at_backward_width``: the fold's S tile is 64)."""
    M = G.L.offdiag
    R, P, K = M.chunk_rows, M.window_rows, M.borrow_span
    n, s = M.n_rows, x.shape[1]
    xp = chunked.permute_in(M, x)
    args = (M.cols, M.vals, M.rowid, xp, R, K * P)
    t = wk.windowed_fold(*args)
    t_plain = wk.windowed_fold_plain(*args)
    fold_err = float((t - t_plain).abs().max())
    check('windowed_fold at path C shape', t, t_plain, TOL_WINDOWED)
    del t_plain
    if not torch.equal(t, wk.windowed_fold(*args)):
        raise AssertionError('windowed_fold: two launches differ at path C')
    log('  windowed_fold at path C shape: two launches bit-equal')
    y_strip = wk.window_strip(t, n, P)
    strip_lib, strip_lib_ms = measure_strip_library(t, y_strip, n, P)
    del y_strip
    strip = measure_tail('path C', M, xp, t)
    strip.update(library_ms=strip_lib_ms,
                 library=strip_lib + ' (the strip part alone)')
    fold_ms = time_ms(lambda: wk.windowed_fold(*args), 10)
    fold_plain_ms = time_ms(lambda: wk.windowed_fold_plain(*args), 2)
    spmm_ms = time_ms(lambda: wd.spmm_internal(M, xp), 10)
    one = measure_fold_strip_one(M, xp, t)

    # the same matrix in CSR, in the same shuffled order
    coo = G.W.tocoo()
    iperm = M.iperm.cpu().numpy()
    A = gsp.core.from_coo(iperm[coo.row], iperm[coo.col], -coo.data, n,
                          device='cuda')
    lib = torch.sparse_csr_tensor(A.rowptr, A.cols[:A.nnz], A.vals[:A.nnz],
                                  size=A.shape)
    check('torch.sparse.mm on the shuffled CSR vs the windowed SpMM',
          torch.sparse.mm(lib, xp), wd.spmm_internal(M, xp), TOL_WINDOWED)
    library_ms = time_ms(lambda: torch.sparse.mm(lib, xp), 10)
    csr_ms = time_ms(
        lambda: csr_kernel.csr_spmm(A.rowptr, A.cols, A.vals, xp), 10)
    del A

    item = x.element_size()
    live = int((M.cols < R).sum())
    slot_bytes = M.n_slots * (4 + item + M.rowid.element_size())
    level_slots = sum(lev.cols.numel() for lev in M.levels)
    level_bytes = (level_slots * (4 + item)
                   + M.level_rows.numel() * M.level_rows.element_size())
    spmm_bytes = 2 * n * s * item + slot_bytes + level_bytes
    spmm = {'ms': spmm_ms, **bound(spmm_bytes, 2 * M.nnz * s),
            'bound_gather_ms': ((live + level_slots) * s * item + n * s * item
                                + slot_bytes + level_bytes)
            / HBM_BYTES_PER_S * 1e3,
            'library_ms': library_ms,
            'csr_spmm_same_matrix_ms': csr_ms,
            'fold_strip_one_matrix': dict(one, fold_and_strip_ms=spmm_ms,
                                          library_ms=library_ms)}
    t_rows = t.numel() // s               # the window tensor's rows

    def fold_work(s):
        return bound(n * s * item + slot_bytes + t_rows * s * item,
                     2 * live * s)

    fold = {'max_abs_err': fold_err, 'ms': fold_ms, 'plain_ms': fold_plain_ms,
            'library_ms': library_ms,
            'library': 'torch.sparse.mm on the CSR of the same shuffled '
                       'matrix (the whole SpMM: fold + strip + levels)',
            **fold_work(s),
            'bound_gather_ms': (live * s * item + slot_bytes
                                + t.numel() * item) / HBM_BYTES_PER_S * 1e3,
            'live_slots': live, 'slots': M.n_slots, 's': s}
    del t
    xw = chunked.permute_in(M, seeded_normal((n, WIDE), 82))
    args = (M.cols, M.vals, M.rowid, xw, R, K * P)
    fold['at_backward_width'] = measure_wide(
        'windowed_fold', lambda: wk.windowed_fold(*args),
        lambda c: wk.windowed_fold_plain(*args[:3], xw[:, c].contiguous(),
                                         R, K * P), TOL_WINDOWED,
        fold_work(WIDE), library=lambda: torch.sparse.mm(lib, xw),
        library_name='torch.sparse.mm on the CSR of the same shuffled '
                     'matrix (the whole SpMM)')
    del lib
    tw = wk.windowed_fold(*args)
    strip['at_backward_width'] = measure_wide(
        'window_strip (tail)', lambda: wk.window_strip(tw, n, P, M.residue,
                                                       xw),
        lambda c: wk.window_strip_plain(tw[..., c].contiguous(), n, P,
                                        M.residue, xw[:, c].contiguous()),
        0.0, bound(*tail_work(M, tw, WIDE)))
    return fold, strip, spmm


def measure_fold_strip_one(M, xp, t):
    """``fold_strip_multi`` at one matrix, path C's (not its route, which
    keeps the fold and the tail): bit-equal to the fold's ``t`` through the
    tail, two launches bit-equal, and timed (CUDA events, as the fold and
    the whole SpMM beside it)."""
    R, P, K, n = M.chunk_rows, M.window_rows, M.borrow_span, M.n_rows
    args = ([(M.cols, M.vals, M.rowid)], [xp], R, P, K, n,
            wk.merge_residues([M.residue], n))
    y = wk.fold_strip_multi(*args)
    require_same('fold_strip_multi at path C (one matrix) vs the fold and '
                 'the tail', y, wk.window_strip(t, n, P, M.residue, xp))
    require_same('fold_strip_multi at path C, two launches',
                 wk.fold_strip_multi(*args), y)
    out = {'ms': time_ms(lambda: wk.fold_strip_multi(*args), 10),
           **fold_strip_work([M], [xp], y, args[-1])}
    log(f'  fold_strip_multi at path C (one matrix): {json.dumps(out)}')
    return out


def former_tiers(M, x, y):
    """The residue tiers as the SpMM added them before the tail took them:
    per tier a ``_slot_block_sum`` in float32 or wider, the cat, the cast
    and one ``index_add_`` into y, in place."""
    R = M.chunk_rows
    acc = torch.promote_types(y.dtype, torch.float32)
    ps = torch.cat([chunked._slot_block_sum(lev.cols, lev.vals,
                                            x[lev.src_chunk * R:
                                              (lev.src_chunk + 1) * R],
                                            out_dtype=acc)
                    for lev in M.levels])
    return y.index_add_(0, M.level_rows, ps.to(y.dtype))


def tail_work(M, t, s):
    """What the tail must move and compute on these inputs: each row's
    addends of t (rows below n_rows, min(K, w + 1) each), y once, one x
    row per live residue slot and the list once; the strip's adds and
    each slot's product and sum."""
    R, P, K, n = M.chunk_rows, M.window_rows, M.borrow_span, M.n_rows
    item = t.element_size()
    w = (torch.arange(n, device=t.device) % R) // P
    addends = int(torch.clamp(w + 1, max=K).sum())
    res = M.residue
    live = res.cols.numel()
    list_bytes = sum(a.numel() * a.element_size() for a in (
        res.rowptr, res.entptr, res.cols, res.vals, res.heavy))
    return ((addends + n + live) * s * item + list_bytes,
            (addends - n + 2 * live + res.entptr.numel() - 1) * s)


def measure_tail(name, M, x, t):
    """The tail (``window_strip`` with the residue list) at a path's shape
    bit-equal to its plain version (the same order and roundings: tol 0.0,
    as in phase 2) and across two launches, then timed beside its plain
    version, the strip alone, and the path it replaces
    (``replaced_eager_ms``: the strip, then the tiers as the SpMM added
    them before, ``former_tiers``; ``tiers_eager_ms``: those tiers
    alone)."""
    n, P, s = M.n_rows, M.window_rows, x.shape[1]
    res = M.residue
    args = (t, n, P, res, x)
    y = wk.window_strip(*args)
    want = wk.window_strip_plain(*args)
    bf16 = t.dtype == torch.bfloat16
    check(f'window_strip (tail) at {name} shape', y, want, 0.0)
    max_abs_err = float((y.float() - want.float()).abs().max())
    bit_equal = torch.equal(y, want)
    del want
    if not bit_equal:
        raise AssertionError(f'window_strip: the tail and its plain version '
                             f'differ at {name}')
    if not torch.equal(y, wk.window_strip(*args)):
        raise AssertionError(f'window_strip: two launches differ at {name}')
    log(f'  window_strip (tail) at {name} shape: bit-equal to the plain '
        f'version and across two launches')
    # the tiers' former path sums each entry in another order; in bf16 a
    # hub row's hundreds of entries each round once more, so it is shown,
    # not held
    former = former_tiers(M, x, wk.window_strip(t, n, P))
    former_err = float((former.double() - y.double()).abs().max()
                       / y.double().abs().max())
    log(f'  {name}: the tiers\' former path differs from the tail by '
        f'{former_err:.3e} (relative)')
    if not bf16 and not former_err <= TOL_WINDOWED:
        raise AssertionError(f'{name}: former tiers differ by {former_err}')
    del former, y
    y_pre = wk.window_strip(t, n, P)
    bytes_moved, flops = tail_work(M, t, s)
    out = {'max_abs_err': max_abs_err, 'bit_equal_to_plain': bit_equal,
           'ms': time_ms(lambda: wk.window_strip(*args), 20),
           'strip_only_ms': time_ms(lambda: wk.window_strip(t, n, P), 20),
           'plain_ms': time_ms(lambda: wk.window_strip_plain(*args), 3),
           'replaced_eager_ms': time_ms(lambda: former_tiers(
               M, x, wk.window_strip(t, n, P)), 5),
           'tiers_eager_ms': time_ms(lambda: former_tiers(M, x, y_pre), 5),
           'former_tiers_rel_diff': former_err,
           **bound(bytes_moved, flops), 'bytes': bytes_moved,
           'window_tensor_bytes': t.numel() * t.element_size(),
           'live_residue_slots': res.cols.numel(),
           'residue_entries': res.entptr.numel() - 1,
           'heavy_rows': res.heavy.numel(), 'dtype': str(t.dtype),
           'values_dtype': str(res.vals.dtype)}
    log(f'  tail at {name}: {json.dumps(out)}')
    return out


def measure_strip_library(t, y, n, P):
    """``torch.nn.functional.fold`` as the overlap-add's yardstick: the
    window tensor permuted beforehand (not timed) to (n_out, S·K·P, NW),
    window w a (K·P, 1) block at row w·P of each out chunk; rows below NW·P
    are y's. Checked once against the kernel's ``y``."""
    n_out, nw, kp, s = t.shape
    cols = t.permute(0, 3, 2, 1).reshape(n_out, s * kp, nw)

    def fold():
        return torch.nn.functional.fold(
            cols, output_size=((nw - 1) * P + kp, 1), kernel_size=(kp, 1),
            stride=(P, 1))

    y_lib = fold()[:, :, :nw * P, 0].permute(0, 2, 1).reshape(-1, s)[:n]
    check('torch.nn.functional.fold vs window_strip at path C', y_lib, y,
          TOL_WINDOWED)
    del y_lib
    ms = time_ms(fold, 20)
    del cols
    return ('torch.nn.functional.fold, kernel (K*P, 1), stride (P, 1), on '
            'the window tensor permuted beforehand'), ms


def measure_fold_products(M):
    """The one-hot fold at TPU kernel #2's probe shape: row ids of path C's
    first out chunk, bf16 products from a seed, f32 out."""
    nw, n_src, L = M.cols.shape[1:]
    lt = n_src * L
    if (nw, lt) != (FOLD2_NW, FOLD2_LT):
        raise AssertionError(f'path C windows are ({nw}, {lt}), not '
                             f'#2\'s ({FOLD2_NW}, {FOLD2_LT})')
    rid = M.rowid[0].reshape(nw, lt).to(torch.int32).contiguous()
    p = seeded_normal((nw, lt, 128), 5).to(torch.bfloat16)
    return measure_fold(rid, p, FOLD2_KP, 20)


def phase_path_c():
    log(f'phase 5: path C, BarabasiAlbert N={N_BA}, windowed kernels')
    reset_counts()
    G, g, x, bank = path_c()
    M = G.L.offdiag
    level_slots = sum(lev.cols.numel() for lev in M.levels)
    layout = {'slabs': list(M.cols.shape), 'slots': M.n_slots,
              'padding': M.n_slots / M.nnz, 'level_slots': level_slots,
              'level_tiers': len(M.levels),
              'level_rows': M.level_rows.numel(),
              'chunk_rows': M.chunk_rows, 'window_rows': M.window_rows,
              'borrow_span': M.borrow_span, 'rowid': str(M.rowid.dtype)}
    log(f'  layout: {json.dumps(layout)}')
    torch.cuda.reset_peak_memory_stats()
    out, launches, per_bank = run_bank(bank)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f'  launches on the path {launches}, per bank {per_bank}; peak '
        f'device memory {peak:.2f} GiB')
    require_launches('C', per_bank, windowed_fold=ORDER, window_strip=ORDER,
                     cheby_step=ORDER - 1, cheby_acc_group=1)
    require_tail('C', per_bank)
    if per_bank['csr_spmm']:
        raise AssertionError('the CSR kernel ran inside the windowed bank')
    if tuple(out.shape) != (N_BA, N_SIGNALS, len(SCALES)):
        raise AssertionError(f'path C output shape {tuple(out.shape)}')
    L_host = sps.diags(G.dw) - G.W         # independent of the windowed format
    ref = reference(L_host, G.lmax, g.evaluate, x,
                    key=('bench', G.N, G.lmax))
    rel_err = validate_path('C', ref, out.permute(2, 0, 1))
    del out

    ms_bank = time_ms(bank, 3)
    nnz = M.nnz
    log(f'  {ms_bank:.3f} ms per bank, '
        f'{ORDER * nnz * N_SIGNALS / (ms_bank / 1e3):.4e} edge-ops/s')
    fold, strip, spmm = measure_windowed(G, x)
    log(f'  SpMM at path C: {json.dumps(spmm)}')
    fold2 = measure_fold_products(M)
    path = {'ms_per_bank': ms_bank, 'rel_err': rel_err, 'nnz': nnz,
            'edge_ops_per_s': ORDER * nnz * N_SIGNALS / (ms_bank / 1e3),
            'lmax': G.lmax, 'layout': layout, 'spmm': spmm,
            'peak_bank_gib': peak, 'acc_group': group_of(G.L, x)}
    return fold, strip, fold2, path, (launches, per_bank), (G, g, x, ref)


def group_of(L, x, carry=torch.float32, nf=len(SCALES)):
    """The accumulator group a bank of ``nf`` filters takes on the
    Laplacian ``L``."""
    return acc_group(ORDER - 1, x.numel(), x.dtype, carry,
                     _operator_bytes(L.offdiag), nf)


def group_launches(g):
    """``cheby_acc_group`` launches in one bank that groups by g: T_1's,
    the head's one term at a time, then the groups of g."""
    return 1 + (ORDER - 1) % g + (ORDER - 1) // g


def fast_bank(g, x):
    """The JAX package's headline fast mode (bench.py:332-334): the terms
    carried in bf16 and the edge values stored in bf16."""
    return lambda: g.filter(x, method='chebyshev', order=ORDER,
                            carry_dtype=torch.bfloat16,
                            vals_dtype=torch.bfloat16)


def phase_path_d(G, g, x, ref):
    """Path D on path C's graph, signal and SciPy reference: the bf16 fold
    and strip instances (the symbols launched are counted, so that a bf16
    request that ran in f32 would fail) and kernel B with a bf16 carry."""
    log(f'phase 6: path D, path C\'s graph in the bf16 fast mode')
    bank = fast_bank(g, x)
    c = cheby_coeff(g.evaluate, G.lmax, m=ORDER, device='cpu')
    est = carry_error_estimate(c, torch.bfloat16)
    symbols = {}
    launch = _cuda.launch

    def spy(name, symbol, *args):
        symbols[symbol] = symbols.get(symbol, 0) + 1
        return launch(name, symbol, *args)

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    _cuda.launch = spy
    try:
        out, launches, per_bank = run_bank(bank)
    finally:
        _cuda.launch = launch
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f'  launches on the path {launches}, per bank {per_bank}; symbols '
        f'{symbols}; peak device memory {peak:.2f} GiB')
    require_launches('D', per_bank, windowed_fold=ORDER, window_strip=ORDER,
                     cheby_step=ORDER - 1, cheby_acc_group=1)
    require_tail('D', per_bank)
    if per_bank['csr_spmm']:
        raise AssertionError('the CSR kernel ran inside the windowed bank')
    rowid = wk._ROWIDS[G.L.offdiag.rowid.dtype]
    for symbol, least in ((f'windowed_fold_bf16_{rowid}', ORDER),
                          ('window_strip_bf16', ORDER),
                          ('cheby_step_f32_bf16', ORDER - 1)):
        if symbols.get(symbol, 0) < least:
            raise AssertionError(f'path D: {symbol} launched '
                                 f'{symbols.get(symbol, 0)} < {least} times')
    if any(s.startswith('windowed_fold_f32') for s in symbols):
        raise AssertionError('path D: an f32 fold ran in the fast mode')
    if out.dtype != torch.float32 or tuple(out.shape) != (
            N_BA, N_SIGNALS, len(SCALES)):
        raise AssertionError(f'path D output {out.dtype} '
                             f'{tuple(out.shape)}')
    log(f'  carry_error_estimate of the bank in bf16: {est:.4e}')
    out = out.permute(2, 0, 1)
    rel_err = validate_path('D (first filter, bench.py\'s gate)', ref[:1],
                            out[:1], TOL_PATH_BF16)
    rel_err_all = validate_path('D (all filters, 2 x the estimate)', ref,
                                out, 2 * est)
    del out
    ms_bank = time_ms(bank, 3)
    nnz = G.L.offdiag.nnz
    log(f'  {ms_bank:.3f} ms per bank, '
        f'{ORDER * nnz * N_SIGNALS / (ms_bank / 1e3):.4e} edge-ops/s')
    fold = measure_fast_fold(G, x)
    path = {'ms_per_bank': ms_bank, 'rel_err': rel_err,
            'rel_err_all_filters': rel_err_all,
            'carry_error_estimate': est, 'nnz': nnz,
            'edge_ops_per_s': ORDER * nnz * N_SIGNALS / (ms_bank / 1e3),
            'symbols': symbols, 'peak_bank_gib': peak,
            'acc_group': group_of(G.L, x, torch.bfloat16)}
    return fold, path, (launches, per_bank)


def measure_fast_fold(G, x):
    """The bf16 fold and strip instances at path D's shape (x and values in
    bf16, the matrix's internal order), against their plain versions, with
    their bounds: the same slots as the f32 fold, at 2 bytes a value."""
    M = G.L.offdiag.astype(torch.bfloat16)
    R, P, K = M.chunk_rows, M.window_rows, M.borrow_span
    n, s = M.n_rows, x.shape[1]
    xp = chunked.permute_in(M, x).to(torch.bfloat16)
    args = (M.cols, M.vals, M.rowid, xp, R, K * P)
    t = wk.windowed_fold(*args)
    t_plain = wk.windowed_fold_plain(*args)
    err = ulps(t, t_plain)
    max_abs_err = float((t.float() - t_plain.float()).abs().max())
    log(f'  bf16 windowed_fold at path D shape: {err:.2f} bf16 ulps from '
        f'the plain version (tol {TOL_BF16_ULPS})')
    if not err <= TOL_BF16_ULPS:
        raise AssertionError(f'bf16 windowed_fold: {err} ulps')
    del t_plain
    strip = measure_tail('path D', M, xp, t)
    strip.update(library_ms=None, library='none: no PyTorch call sums a '
                                          'bf16 window tensor in f32')
    live = int((M.cols < R).sum())
    slot_bytes = M.n_slots * (4 + 2 + M.rowid.element_size())
    fold = {'max_abs_err': max_abs_err, 'ulps': err,
            'ms': time_ms(lambda: wk.windowed_fold(*args), 10),
            'plain_ms': time_ms(lambda: wk.windowed_fold_plain(*args), 2),
            **bound(n * s * 2 + slot_bytes + t.numel() * 2, 2 * live * s),
            'bound_gather_ms': (live * s * 2 + slot_bytes + t.numel() * 2)
            / HBM_BYTES_PER_S * 1e3}
    del t
    # the one PyTorch call that computes the same function: torch.sparse.mm
    # of bf16 values on a bf16 x, the same shuffled matrix in CSR (the
    # whole SpMM); the mixed pairs below have none
    coo = G.W.tocoo()
    iperm = M.iperm.cpu().numpy()
    A = gsp.core.from_coo(iperm[coo.row], iperm[coo.col], -coo.data, n,
                          device='cuda')
    lib = torch.sparse_csr_tensor(A.rowptr, A.cols[:A.nnz],
                                  A.vals[:A.nnz].to(torch.bfloat16),
                                  size=A.shape)
    del A
    fold['library_ms'] = time_ms(lambda: torch.sparse.mm(lib, xp), 10)
    fold['library'] = ('torch.sparse.mm, bf16 values on a bf16 x, on the '
                       'CSR of the same shuffled matrix (the whole SpMM: '
                       'fold + strip + levels); the mixed pairs: none')
    del lib
    # the other two instances at this shape: a bf16 x with f32 values (no
    # product rounding) and f32 x with bf16 values
    M32 = G.L.offdiag
    for combo, (xd, vd) in BF16_FOLDS.items():
        if combo != 'both':
            a = (M32.cols, M32.vals.to(vd), M32.rowid, xp.to(xd), R, K * P)
            fold[f'ms_{combo}'] = time_ms(lambda: wk.windowed_fold(*a), 10)
    return {'fold': fold, 'strip': strip}


# ---------------------------------------------------------------------------
# path E: training through the fixed-graph VJP (examples/filter_learning.py's
# model at the bench width); path F: Lanczos and exact filtering
# ---------------------------------------------------------------------------

def inv_softplus(v):
    return np.log(np.expm1(np.asarray(v, dtype=np.float64)))


def heat_coeff(scales, lmax):
    """The heat bank's coefficients for a tensor of ``scales``, as a
    differentiable function of them."""
    return cheby_coeff(lambda lam: torch.exp(-scales[:, None] * lam[None, :]
                                             / lmax), lmax, m=ORDER)


def model(G, L, x, raw, logits):
    """``mix · bank(x)`` (N, S) through the fixed-graph VJP, the bank's
    scales ``softplus(raw)`` and the mix ``softmax(logits)`` (weights that
    one Adam step of 0.2 moves by a few hundredths, where a raw mix would
    move by 0.2 and overshoot): on G's own Laplacian through
    ``Filter.filter(fixed_graph=True)``, a Filter whose kernels close over
    the scales; on another operator ``L`` (path B's banded one) through
    ``cheby_op_fixed_graph``, as examples/filter_learning.py does."""
    mix = torch.softmax(logits, 0)
    if L is None:
        g = gsp.filters.Filter(G, [
            lambda lam, i=i: torch.exp(-torch.nn.functional.softplus(raw)[i]
                                       * lam / G.lmax)
            for i in range(len(SCALES))])
        return g.filter(x, order=ORDER, fixed_graph=True) @ mix
    c = heat_coeff(torch.nn.functional.softplus(raw), G.lmax)
    return torch.einsum('f,fns->ns', mix, cheby_op_fixed_graph(L, G.lmax, c,
                                                               x))


def dot_groups(g):
    """cheby_dot_group launches per backward at group size g: the
    forward's accumulator groups (T_1, the head one step at a time, then
    groups of g) and one for T_0."""
    steps = ORDER - 1
    return 2 + steps % g + steps // g


def train(name, G, L, x, steps):
    """Adam (lr 0.2) over the scales (from __graft_entry__.py:84's
    [1, 5, 10, 20]) and the mix (from equal weights), against a teacher at
    the bench bank's scales and TEACHER_MIX. The signal requires grad too,
    as in
    __graft_entry__.py's fixed-graph gate, so each backward runs both
    passes. Returns the losses, ms per step and launches per step."""
    dev = x.device
    with torch.no_grad():
        y = model(G, L, x, torch.tensor(inv_softplus(SCALES), device=dev,
                                        dtype=torch.float32),
                  torch.log(torch.tensor(TEACHER_MIX, device=dev)))
    raw = torch.tensor(inv_softplus(STUDENT_SCALES), device=dev,
                       dtype=torch.float32, requires_grad=True)
    logits = torch.zeros(len(SCALES), device=dev, requires_grad=True)
    xg = x.detach().requires_grad_()
    opt = torch.optim.Adam([raw, logits], lr=TRAIN_LR)
    losses = []
    torch.cuda.synchronize()
    reset_counts()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        xg.grad = None
        loss = torch.mean((model(G, L, xg, raw, logits) - y) ** 2)
        loss.backward()
        opt.step()
        losses.append(float(loss))
    end.record()
    end.synchronize()
    launches = counts()
    out = {'losses': losses, 'ms_per_step': start.elapsed_time(end) / steps,
           'peak_step_gib': (torch.cuda.max_memory_allocated() - held) / 2**30,
           'launches': launches,
           'scales': torch.nn.functional.softplus(raw).tolist(),
           'mix': torch.softmax(logits, 0).tolist(), 'x_grad_finite': bool(
               torch.isfinite(xg.grad).all())}
    log(f'  path E on {name}, {steps} Adam steps: {json.dumps(out)}')
    if not all(np.isfinite(losses)) or not (steps == 1
                                            or losses[-1] < losses[0]):
        raise AssertionError(f'path E on {name}: losses {losses}')
    if not out['x_grad_finite']:
        raise AssertionError(f'path E on {name}: x.grad is not finite')
    g = group_of(G.L if L is None else L, x)
    if launches['cheby_dot_group'] != steps * dot_groups(g):
        raise AssertionError(f'path E on {name}: {launches["cheby_dot_group"]}'
                             f' cheby_dot_group launches in {steps} steps, '
                             f'not {steps * dot_groups(g)}')
    return out


def scipy_vjp(L, lmax, c, x, gbar, cols):
    """c̄ (Nf, m+1) and the first ``cols`` columns of x̄ of the bank on the
    host in SciPy f64, for the cotangent ``gbar`` (Nf, N, S): c̄ from the
    recurrence on x, each term dotted with every ḡ_f (0.5 at k = 0); x̄
    from the recurrence on the ḡ_f, each term contracted with the
    coefficients (0.5·c0)."""
    nf, m1 = c.shape
    n = x.shape[0]
    cbar = np.empty((nf, m1))
    for k, t in enumerate(host_terms(L, lmax, x, m1)):
        cbar[:, k] = np.einsum('fns,ns->f', gbar, t)
    cbar[:, 0] *= 0.5
    x_bar = np.zeros((n, cols))
    g = np.moveaxis(gbar[:, :, :cols], 0, -1).reshape(n, cols * nf)
    for k, u in enumerate(host_terms(L, lmax, g, m1)):
        x_bar += ((0.5 if k == 0 else 1.0)
                  * (u.reshape(n, cols, nf) * c[:, k]).sum(-1))
    return cbar, x_bar


def fingerprint(L_host, *arrays):
    """A digest of a host Laplacian (its canonical f64 CSR) and arrays (or
    floats): paths share a host reference only where its inputs are the
    same bits."""
    digest = hashlib.sha256()
    L = sps.csr_matrix(L_host, dtype=np.float64)
    L.sum_duplicates()
    L.sort_indices()
    for a in (L.indptr, L.indices, L.data) + arrays:
        a = np.ascontiguousarray(a)
        digest.update(str((a.dtype, a.shape)).encode())
        digest.update(a.tobytes())
    return digest.hexdigest()


def dot64(a, b, absolute=False):
    """⟨a, b⟩ (with ``absolute``, Σ |a ⊙ b|) in float64 on the card, a
    filter at a time."""
    return sum(float((a[i].double() * b[i].double()).abs().sum() if absolute
                     else (a[i].double() * b[i].double()).sum())
               for i in range(a.shape[0]))


def check_vjp(name, L, lmax, x, L_host=None):
    """One forward and backward of ``cheby_op_fixed_graph`` at the path's
    width, for the bench bank and a seeded ḡ: the two adjoint identities,
    each to its limit relative to its own terms' magnitude, the launches of the backward, its peak memory above what
    is held when it starts against the forward's (and what plain autograd
    would keep, 3K (N, S) terms), nothing of the recurrence saved, and the
    forward, x̄ synthesis and c̄ pass timed apart. With ``L_host``, c̄ and x̄
    for a ḡ nonzero on 8 columns against the SciPy f64 recurrence (x̄ on
    its first N_CHECK_XBAR columns, and exactly 0 beyond the 8)."""
    n, s = x.shape
    nf = len(SCALES)
    c = heat_coeff(torch.tensor(SCALES, device='cuda'), lmax)
    c.requires_grad_()
    xg = x.detach().requires_grad_()
    gbar = seeded_normal((nf, n, s), 70)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = cheby_op_fixed_graph(L, lmax, c, xg)
    torch.cuda.synchronize()
    fwd_peak = torch.cuda.max_memory_allocated() - held
    saved = out.grad_fn.saved_tensors
    if [t.data_ptr() for t in saved] != [c.data_ptr(), xg.data_ptr()]:
        raise AssertionError(f'{name}: the VJP saved more than c and x')
    reset_counts()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    c_bar, x_bar = torch.autograd.grad(out, (c, xg), gbar, retain_graph=True)
    torch.cuda.synchronize()
    bwd_peak = torch.cuda.max_memory_allocated() - held
    launches = counts()
    g = group_of(L, x)
    if (launches['cheby_dot_group'] != dot_groups(g)
            or launches['cheby_acc_contract'] != ORDER - 1):
        raise AssertionError(f'{name}: the backward launched {launches}')
    unit = n * s * x.element_size()
    mem = {'forward_peak_gib': fwd_peak / 2**30,
           'backward_peak_gib': bwd_peak / 2**30,
           'forward_units': fwd_peak / unit, 'backward_units': bwd_peak / unit,
           'autograd_3k_terms_gib': 3 * ORDER * unit / 2**30}
    log(f'  {name}: VJP memory {json.dumps(mem)}')
    if not bwd_peak <= 2 * fwd_peak:
        raise AssertionError(f'{name}: backward peak {bwd_peak} > 2 x the '
                             f'forward\'s {fwd_peak}')
    # c̄ carries the 0.5 of k = 0, so Σ c̄ ⊙ c is Σ_k ⟨ḡ_f, T̃_k x⟩ c'_k.
    # Each identity is held relative to the magnitude of its own terms
    # (Σ |c̄ ⊙ c|, Σ |x̄ ⊙ x|), which a bank that damps x strongly (path
    # B's) cancels far below |⟨ḡ, out⟩|
    prod = c_bar.detach().double() * c.detach().double()
    g_out = dot64(gbar, out.detach())
    ident = {'<gbar, out>': g_out, 'sum c_bar c': float(prod.sum()),
             '<x_bar, x>': dot64(x_bar[None], x[None]),
             'sum |c_bar c|': float(prod.abs().sum()),
             'sum |x_bar x|': dot64(x_bar[None], x[None], absolute=True)}
    diff = {'c_bar': abs(ident['sum c_bar c'] - g_out),
            'x_bar': abs(ident['<x_bar, x>'] - g_out)}
    errs = {'c_bar': diff['c_bar'] / ident['sum |c_bar c|'],
            'x_bar': diff['x_bar'] / ident['sum |x_bar x|']}
    tols = {'c_bar': TOL_ADJOINT_C, 'x_bar': TOL_ADJOINT_X}
    log(f'  {name}: adjoint identities {json.dumps(ident)}, rel err '
        f'{json.dumps(errs)} (tol {json.dumps(tols)}); relative to '
        f'|<gbar, out>| instead: '
        f'{json.dumps({k: v / abs(g_out) for k, v in diff.items()})}')
    if not all(errs[k] <= tols[k] for k in tols):
        raise AssertionError(f'{name}: adjoint identities off by {errs}')
    del x_bar
    result = {'memory': mem, 'adjoint_rel_err': errs,
              'adjoint_rel_err_to_g_out': {k: v / abs(g_out)
                                           for k, v in diff.items()},
              'acc_group': g,
              'backward_launches': launches}
    if L_host is not None:
        g8 = torch.zeros_like(gbar)
        g8[:, :, :N_CHECK_COLS] = gbar[:, :, :N_CHECK_COLS]
        c_bar8, x_bar8 = torch.autograd.grad(out, (c, xg), g8,
                                             retain_graph=True)
        if bool((x_bar8[:, N_CHECK_COLS:] != 0).any()):
            raise AssertionError(f'{name}: x_bar is not 0 where gbar is')
        t0 = time.time()
        args = (L_host, lmax, c.detach().double().cpu().numpy(),
                x[:, :N_CHECK_COLS].double().cpu().numpy(),
                gbar[:, :, :N_CHECK_COLS].double().cpu().numpy())
        key = ('vjp', fingerprint(*args))
        if key not in REFERENCES:
            REFERENCES[key] = scipy_vjp(*args, N_CHECK_XBAR)
            log(f'  scipy f64 VJP (c_bar on {N_CHECK_COLS} columns, x_bar '
                f'on {N_CHECK_XBAR}): {time.time() - t0:.1f} s')
        else:
            log(f'  scipy f64 VJP: the one of the same inputs (paths A, C '
                f'and I share the graph, the signal and ḡ), matched in '
                f'{time.time() - t0:.1f} s')
        cbar_ref, xbar_ref = REFERENCES[key]
        result['scipy_rel_err'] = {
            'c_bar': check(f'{name} c_bar vs scipy f64', c_bar8.cpu(),
                           torch.from_numpy(cbar_ref), TOL_PATH),
            'x_bar': check(f'{name} x_bar vs scipy f64',
                           x_bar8[:, :N_CHECK_XBAR].cpu(),
                           torch.from_numpy(xbar_ref), TOL_PATH)}
        del c_bar8, x_bar8, g8
    cd = c.detach()
    result['ms'] = {
        'forward': time_ms(lambda: cheby_op(L, lmax, cd, x), 3),
        'backward': time_ms(lambda: torch.autograd.grad(
            out, (c, xg), gbar, retain_graph=True), 3),
        'x_bar_synthesis': time_ms(lambda: _fixed_graph_grads(
            L, lmax, cd, x, gbar, False, True), 3),
        'c_bar_pass': time_ms(lambda: _fixed_graph_grads(
            L, lmax, cd, x, gbar, True, False), 3)}
    log(f'  {name}: ms {json.dumps(result["ms"])}')
    return result


def train_kernels(steps):
    """Kernel B's launches that ``steps`` training steps need at least: in
    each, three recurrences' steps (forward, x̄ synthesis, c̄ pass), one
    accumulator group, the synthesis contractions and one coefficient
    group."""
    return {'cheby_step': 3 * (ORDER - 1) * steps, 'cheby_acc_group': steps,
            'cheby_acc_contract': (ORDER - 1) * steps,
            'cheby_dot_group': steps}


def phase_path_e(name, G, L, x, steps, L_host=None):
    """Path E on one path's graph and signal: the VJP's checks, then
    ``steps`` Adam steps of the filter-learning model."""
    log(f'phase E: path E (training) on {name}')
    vjp = check_vjp(f'path E on {name}', G.L if L is None else L, G.lmax, x,
                    L_host)
    torch.cuda.empty_cache()
    trained = train(name, G, L, x, steps)
    torch.cuda.empty_cache()
    return {'vjp': vjp, 'train': trained}, trained['launches']


def host_lanczos(L, x, order, kernels):
    """Lanczos filtering of each column of ``x`` (N, C) on the host in f64,
    the port's algorithm (full reorthogonalization, Ritz values clamped at
    0), through each of ``kernels`` (NumPy functions of λ): (N, C, Nf)."""
    blocks = host_blocks(L)
    n, cols = x.shape
    norm = np.linalg.norm(x, axis=0)
    V = np.zeros((cols, order, n))
    alphas, betas = np.zeros((order, cols)), np.zeros((order, cols))
    q = x / norm
    with ThreadPoolExecutor(HOST_THREADS) as pool:
        r = host_product(pool, blocks, q)
        alphas[0] = (q * r).sum(0)
        r -= alphas[0] * q
        V[:, 0] = q.T
        for k in range(1, order):
            betas[k] = np.linalg.norm(r, axis=0)
            q_new = r / betas[k]
            V[:, k] = q_new.T
            r = host_product(pool, blocks, q_new) - betas[k] * q
            alphas[k] = (q_new * r).sum(0)
            r -= alphas[k] * q_new
            for col in range(cols):
                basis = V[col, :k + 1]
                r[:, col] -= basis.T @ (basis @ r[:, col])
            q = q_new
    out = np.empty((n, cols, len(kernels)))
    for col in range(cols):
        H = (np.diag(alphas[:, col]) + np.diag(betas[1:, col], 1)
             + np.diag(betas[1:, col], -1))
        e, U = np.linalg.eigh(H)
        e = np.maximum(e, 0.0)
        w = np.stack([U @ (kernel(e) * U[0]) for kernel in kernels], axis=1)
        out[:, col] = V[col].T @ (w * norm[col])
    return out


def phase_path_f_lanczos(G, x):
    """Lanczos filtering on path A's graph: the bench bank on x (N, S), S
    the widest power of two up to 128 whose basis fits the card, and the
    synthesis direction at 32 signals x 4 filters, checked against a host
    f64 Lanczos of the same order on N_CHECK_LANCZOS signals and on one
    signal's 4 filter columns."""
    log('phase F: path F (Lanczos) on path A\'s graph')
    g = gsp.filters.Heat(G, scale=SCALES)
    lmax = G.lmax
    nf = len(SCALES)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    s = N_SIGNALS
    while True:
        try:
            xs = x[:, :s]
            t0 = time.time()
            out = g.filter(xs, method='lanczos', order=ORDER)
            torch.cuda.synchronize()
            first_s = time.time() - t0
            break
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
            log(f'  Lanczos at S={s} does not fit the card; halving S')
            s //= 2
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = counts()
    log(f'  Lanczos at S={s}: {first_s:.2f} s, peak {peak:.2f} GiB, '
        f'launches {launches}')
    bank = seeded_normal((G.N, 32, nf), 71)
    syn = g.filter(bank, method='lanczos', order=ORDER)
    if tuple(out.shape) != (G.N, s, nf) or tuple(syn.shape) != (G.N, 32):
        raise AssertionError(f'path F shapes {tuple(out.shape)}, '
                             f'{tuple(syn.shape)}')
    cols = np.concatenate([x[:, :N_CHECK_LANCZOS].double().cpu().numpy(),
                           bank[:, 0].double().cpu().numpy()], axis=1)
    t0 = time.time()
    ref = host_lanczos(G.L.to_scipy(), cols, ORDER,
                       [heat_np(sc, lmax) for sc in SCALES])
    log(f'  host f64 Lanczos on {cols.shape[1]} columns: '
        f'{time.time() - t0:.1f} s')
    err = check(f'path F Lanczos ({N_CHECK_LANCZOS} signals) vs host f64',
                out[:, :N_CHECK_LANCZOS].cpu(),
                torch.from_numpy(ref[:, :N_CHECK_LANCZOS]), TOL_LANCZOS)
    syn_ref = sum(ref[:, N_CHECK_LANCZOS + f, f] for f in range(nf))
    err_syn = check('path F Lanczos synthesis (signal 0) vs host f64',
                    syn[:, 0].cpu(), torch.from_numpy(syn_ref), TOL_LANCZOS)
    del out, syn
    bare = lanczos_without_reorth(G.L, g.evaluate, x[:, :N_CHECK_LANCZOS],
                                  ORDER).permute(1, 2, 0).cpu().double()
    want = torch.from_numpy(ref[:, :N_CHECK_LANCZOS])
    err_bare = float((bare - want).abs().max() / want.abs().max())
    log(f'  the same Lanczos without reorthogonalization (f32, on the card) '
        f'vs host f64: rel err {err_bare:.3e} (shown, not held)')
    del bare
    ms = time_ms(lambda: g.filter(xs, method='lanczos', order=ORDER), 1)
    ms_syn = time_ms(lambda: g.filter(bank, method='lanczos', order=ORDER), 1)
    return {'s': s, 'first_call_s': first_s, 'ms': ms, 'synthesis_ms': ms_syn,
            'peak_gib': peak, 'rel_err': err, 'synthesis_rel_err': err_syn,
            'without_reorth_rel_err': err_bare,
            'launches': launches}, launches


def lanczos_without_reorth(L, evaluate, x, order):
    """``lanczos_op`` (Nf, N, S) with the reorthogonalization left out:
    the three-term recurrence alone, whose f32 basis loses orthogonality,
    and the same Ritz filter. A reading of what the check of path F would
    see from such a basis (logged, not held)."""
    mv, xp, pout = lz._hoisted(L, x)
    n, s = xp.shape
    V = torch.zeros((order, n, s), dtype=xp.dtype, device=xp.device)
    alphas = torch.zeros((order, s), dtype=xp.dtype, device=xp.device)
    betas = torch.zeros_like(alphas)
    q, q_old = xp / torch.linalg.norm(xp, dim=0), torch.zeros_like(xp)
    for k in range(order):
        V[k] = q
        r = mv(q) - betas[k] * q_old
        alphas[k] = (q * r).sum(0)
        r -= alphas[k] * q
        if k + 1 < order:
            betas[k + 1] = torch.linalg.norm(r, dim=0)
            q_old, q = q, r / betas[k + 1]
    H = (torch.diag_embed(alphas.T) + torch.diag_embed(betas.T[:, 1:], 1)
         + torch.diag_embed(betas.T[:, 1:], -1))
    uh, fe = lz._ritz(H, evaluate)
    proj = torch.einsum('soj,os->sj', uh, lz._dots(V, xp, order))
    w = torch.einsum('soj,fsj->fos', uh, fe * proj[None])
    return pout(torch.stack([lz._combine(V, w[f]) for f in range(len(w))]),
                axis=1)


def heat_np(scale, lmax):
    return lambda lam: np.exp(-scale * lam / lmax)


def phase_path_f_exact():
    """``method='exact'`` on Grid2d(64, 64), the graph of
    __graft_entry__.entry, in f32 on the card against host f64
    numpy.linalg.eigh filtering; and ``g.filter(x)`` with x requiring grad
    on this CSR operator: its x̄ against the fixed-graph VJP's."""
    log('phase F: path F (exact) on Grid2d(64, 64)')
    G = gsp.graphs.Grid2d(EXACT_SIDE, EXACT_SIDE)
    reset_counts()
    t0 = time.time()
    G.compute_fourier_basis()
    torch.cuda.synchronize()
    basis_s = time.time() - t0
    g = gsp.filters.Heat(G, scale=SCALES)
    x = seeded_normal((G.N, N_SIGNALS), 72)
    out = g.filter(x, method='exact')
    t0 = time.time()
    e, U = np.linalg.eigh(G.L.to_scipy().toarray())
    x8 = x[:, :N_CHECK_COLS].double().cpu().numpy()
    ref = np.stack([U @ (np.exp(-sc * np.maximum(e, 0) / G.lmax)[:, None]
                         * (U.T @ x8)) for sc in SCALES], axis=-1)
    log(f'  host f64 eigh filtering: {time.time() - t0:.1f} s')
    err = check('path F exact vs host f64 eigh', out[:, :N_CHECK_COLS].cpu(),
                torch.from_numpy(ref), TOL_PATH)
    ms = time_ms(lambda: g.filter(x, method='exact'), 3)
    # a grad-requiring g.filter(x) on the CSR operator differentiates (the
    # bank's own backward): its x̄ against the fixed-graph VJP's
    gbar = seeded_normal((G.N, N_SIGNALS, len(SCALES)), 73)
    x_bars = []
    for fixed in (False, True):
        xr = x.clone().requires_grad_()
        before = counts()
        g.filter(xr, order=ORDER, fixed_graph=fixed).backward(gbar)
        torch.cuda.synchronize()
        if not fixed and counts()['csr_sddmm'] != before['csr_sddmm']:
            raise AssertionError('path F: an SDDMM ran with only x '
                                 'requiring grad')
        x_bars.append(xr.grad)
    xbar_err = check('path F: x̄ of a grad-requiring g.filter on CSR vs the '
                     'fixed-graph VJP', x_bars[0], x_bars[1], TOL_F_XBAR)
    launches = counts()
    from pygsp_tpu_torch import checkpoint
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save_graph(f'{d}/grid.npz', G)
        G2 = checkpoint.load_graph(f'{d}/grid.npz')
    if (G2.U.device.type != 'cuda' or not torch.equal(G2.U, G.U)
            or not torch.equal(G2.e, G.e) or G2.lmax != G.lmax
            or (G2.W != G.W).nnz):
        raise AssertionError('checkpoint: Grid2d(64, 64) with its basis did '
                             'not round-trip')
    log('  Grid2d(64, 64) with its Fourier basis round-trips to the card')
    return {'basis_s': basis_s, 'ms': ms, 'rel_err': err,
            'x_bar_vs_fixed_graph': xbar_err, 'lmax': G.lmax}, launches


def xbar_on_windowed(G, x):
    """``g.filter(x)`` with x requiring grad on the windowed operator (the
    bank's own backward, on the CSR view of its slots): its x̄ against the
    fixed-graph VJP's, and the launches of the first (kernel A on the
    transpose, no SDDMM: only x requires grad)."""
    g = gsp.filters.Heat(G, scale=SCALES)
    x8 = x[:, :N_CHECK_COLS].contiguous()
    gbar = seeded_normal((G.N, N_CHECK_COLS, len(SCALES)), 74)
    x_bars = []
    reset_counts()
    for fixed in (False, True):
        xr = x8.clone().requires_grad_()
        g.filter(xr, order=ORDER, fixed_graph=fixed).backward(gbar)
        torch.cuda.synchronize()
        if not fixed:
            launches = counts()
        x_bars.append(xr.grad)
    if (launches['csr_sddmm'] or launches['csr_spmm_sddmm']
            or launches['csr_spmm'] != ORDER
            or launches['windowed_fold'] != ORDER):
        raise AssertionError(f'path M: a grad-requiring g.filter(x) on the '
                             f'windowed operator launched {launches}')
    err = check('path M: x̄ of a grad-requiring g.filter on the windowed '
                'operator vs the fixed-graph VJP', x_bars[0], x_bars[1],
                TOL_F_XBAR)
    return {'rel_err': err}, launches


# ---------------------------------------------------------------------------
# path K: gradients through the graph's weights (the CSR bank's backward)
# ---------------------------------------------------------------------------

def count_plain_calls():
    """Count calls of the CSR SpMM's, the SDDMM's and the fused entry's
    plain versions from now on (``PLAIN_CALLS``): on the card the path
    must run none."""
    for name in ('csr_spmm_plain', 'csr_sddmm_plain',
                 'csr_spmm_sddmm_plain'):
        plain = getattr(csr_kernel, name)

        def spy(*args, _plain=plain, _name=name, **kwargs):
            PLAIN_CALLS[_name] = PLAIN_CALLS.get(_name, 0) + 1
            return _plain(*args, **kwargs)

        setattr(csr_kernel, name, spy)


PLAIN_CALLS = {}


def sddmm_work(M, s, item):
    """The bound of one SDDMM with the diagonal fused, u and t (N, s): u
    and t read once, the rows and columns read once, the values' and the
    diagonal's cotangents read and written once; two operations per entry
    and column. ``gather_ms``: the gather model, one row of t read per
    stored entry (and per diagonal entry) instead of t once."""
    n, nnz = M.n_rows, M.nnz
    rest = nnz * 8 + 2 * (nnz + n) * item
    work = bound(2 * n * s * item + rest, 2 * (nnz + n) * s)
    work['gather_ms'] = ((nnz + 2 * n) * s * item + rest) / HBM_BYTES_PER_S * 1e3
    return work


def measure_sddmm(name, M, s, seed):
    """``csr_sddmm`` with the diagonal fused on M's pattern at ``s``
    columns: held against its plain version on the same f32 inputs within
    TOL_CSR, two launches bit-equal, then timed beside its bound, its
    gather model, its plain version and ``torch.sparse.sampled_addmm`` on
    the same CSR (a yardstick that the port never calls; where it refuses
    the shape, its error is kept instead of a time)."""
    n, nnz = M.n_rows, M.nnz
    u, t = seeded_normal((n, s), seed), seeded_normal((n, s), seed + 1)

    def run(fn):
        out = torch.zeros_like(M.vals)
        dg = torch.zeros(n, dtype=M.vals.dtype, device=M.device)
        fn(M.rows, M.cols, u, t, out, 1.0, dg)
        return out, dg

    got = run(csr_kernel.csr_sddmm)
    want = run(csr_kernel.csr_sddmm_plain)
    max_abs_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    rel_err = max(check(f'{name} kernel vs plain ({part})', a, b, TOL_CSR)
                  for part, a, b in zip(('values', 'diagonal'), got, want))
    if bool(got[0][nnz:].any()):
        raise AssertionError(f'{name}: the padding\'s cotangent is not 0')
    again = run(csr_kernel.csr_sddmm)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f'{name}: two launches differ')
    log(f'  {name}: two launches bit-equal')
    del want, again
    out, dg = got
    library = {'library': 'torch.sparse.sampled_addmm on a sparse CSR '
                          'tensor (the values only, no diagonal)'}
    pattern = torch.sparse_csr_tensor(M.rowptr, M.cols[:nnz],
                                      torch.zeros_like(M.vals[:nnz]),
                                      size=M.shape)

    def lib():
        return torch.sparse.sampled_addmm(pattern, u, t.T, beta=0.0)

    try:
        library['library_rel_diff'] = float(
            (lib().values() - out[:nnz]).abs().max() / out[:nnz].abs().max())
        library['library_ms'] = time_ms(lib, 10)
    except RuntimeError as exc:       # the yardstick only, never the path
        library.update(library_ms=None, library_refused=str(exc)[:300])
    result = {'max_abs_err': max_abs_err, 'rel_err': rel_err,
              'ms': time_ms(lambda: csr_kernel.csr_sddmm(
                  M.rows, M.cols, u, t, out, 1.0, dg), 20),
              'plain_ms': time_ms(lambda: csr_kernel.csr_sddmm_plain(
                  M.rows, M.cols, u, t, out, 1.0, dg), 2),
              **sddmm_work(M, s, u.element_size()), 's': s, 'nnz': nnz,
              **library}
    log(f'  {name}: {json.dumps(result)}')
    return result


def card():
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def fused_work(M, s, item, flops_per_s=FP32_FLOPS):
    """The bound of one launch of the fused entry on ``M`` (the
    transpose, square) at ``s`` columns with the diagonal: u and t read
    once, y written once, the CSR's columns, values and row pointers read
    once, the values' and the diagonal's cotangents read and written once;
    two operations per entry and column for the product and two for each
    dot (entries and diagonal). ``gather_ms``: the gather model, one row
    of u read per stored entry instead of u once."""
    n, nnz = M.n_rows, M.nnz
    rest = nnz * (4 + item) + (n + 1) * 4 + 2 * (nnz + n) * item
    work = bound(3 * n * s * item + rest, 2 * nnz * s + 2 * (nnz + n) * s,
                 flops_per_s)
    work['gather_ms'] = ((nnz + 2 * n) * s * item + rest) / HBM_BYTES_PER_S \
        * 1e3
    return work


def measure_fused(M, lmax):
    """Kernel A's fused entry (``csr_spmm_sddmm``) on the transpose of
    path A's off-diagonal at 128 and 200 (two passes) f32 columns and 64
    f64 columns, with the diagonal and α = 2/a1 onto seeded cotangents:
    bit-equal to the two launches it replaces (kernel A's wide entry on
    the transpose, ``csr_sddmm`` on the matrix, its cotangent taken back
    by the transpose's edge order), held against its plain version, two
    launches bit-equal; timed beside the two launches, its bound, its
    gather model, its plain version and the library pair
    ``torch.sparse.mm`` of the transpose plus
    ``torch.sparse.sampled_addmm`` (a yardstick that the port never
    calls)."""
    off32 = gsp.core.operators.laplacian_op(M).offdiag
    out = {}
    for dtype, s, tol, flops in ((torch.float32, N_SIGNALS, TOL_CSR,
                                  FP32_FLOPS),
                                 (torch.float32, 200, TOL_CSR, FP32_FLOPS),
                                 (torch.float64, 64, TOL_F64, FP64_FLOPS)):
        name = f'csr_spmm_sddmm on path A\'s transpose, S={s} {dtype}'
        A = off32 if dtype == torch.float32 else off32.astype(dtype)
        At, order = gsp.core.sparse._transpose(A)
        n, nnz = A.n_rows, A.nnz
        u, t = (seeded_normal((n, s), 130 + s + i, dtype=dtype)
                for i in range(2))
        alpha = torch.full((), 4.0 / lmax, dtype=dtype, device='cuda')
        out0 = torch.zeros_like(A.vals)
        out0[:nnz] = seeded_normal((nnz,), 133, dtype=dtype)
        d0 = seeded_normal((n,), 134, dtype=dtype)
        args = (At.rowptr, At.cols, At.vals, u, t)

        def fused():
            o, d = out0[order], d0.clone()
            y = csr_kernel.csr_spmm_sddmm(*args, o, alpha, d)
            return y, torch.empty_like(o).index_copy_(0, order, o), d

        def two_launches():
            o, d = out0.clone(), d0.clone()
            y = csr_kernel.csr_spmm(At.rowptr, At.cols, At.vals, u)
            csr_kernel.csr_sddmm(A.rows, A.cols, u, t, o, alpha, d)
            return y, o, d

        def plain():
            o, d = out0[order], d0.clone()
            y = csr_kernel.csr_spmm_sddmm_plain(*args, o, alpha, d)
            return y, torch.empty_like(o).index_copy_(0, order, o), d

        got = fused()
        parts = ('y', 'values', 'diagonal')
        for part, a, b in zip(parts, got, two_launches()):
            if not torch.equal(a, b):
                raise AssertionError(f'{name}: {part} differs from the two '
                                     f'launches')
        log(f'  {name}: bit-equal to kernel A\'s wide entry and csr_sddmm')
        if not all(torch.equal(a, b) for a, b in zip(got, fused())):
            raise AssertionError(f'{name}: two launches differ')
        log(f'  {name}: two launches bit-equal')
        want = plain()
        rel_err = max(check(f'{name} vs plain ({part})', a, b, tol)
                      for part, a, b in zip(parts, got, want))
        max_abs_err = max(float((a - b).abs().max())
                          for a, b in zip(got, want))
        if bool(got[1][nnz:].any()):
            raise AssertionError(f'{name}: the padding\'s cotangent moved')
        del got, want
        o_t, d = out0[order], d0.clone()
        lib_t = torch.sparse_csr_tensor(At.rowptr, At.cols[:nnz],
                                        At.vals[:nnz], size=At.shape)
        pattern = torch.sparse_csr_tensor(A.rowptr, A.cols[:nnz],
                                          torch.zeros_like(A.vals[:nnz]),
                                          size=A.shape)
        row = {'max_abs_err': max_abs_err, 'rel_err': rel_err,
               'ms': time_ms(lambda: csr_kernel.csr_spmm_sddmm(
                   *args, o_t, alpha, d), 20),
               'two_launches_ms': time_ms(two_launches, 10),
               'plain_ms': time_ms(plain, 2),
               **fused_work(At, s, u.element_size(), flops),
               'library': 'torch.sparse.mm of the transpose plus '
                          'torch.sparse.sampled_addmm (the values only, '
                          'no diagonal)',
               's': s, 'dtype': str(dtype), 'nnz': nnz}
        try:
            row['library_ms'] = time_ms(lambda: (
                torch.sparse.mm(lib_t, u),
                torch.sparse.sampled_addmm(pattern, u, t.T, beta=0.0)), 10)
        except RuntimeError as exc:   # the yardstick only, never the path
            row.update(library_ms=None, library_refused=str(exc)[:300])
        log(f'  {name}: {json.dumps(row)}')
        out[f'{s}_{str(dtype)[6:]}'] = row
        del A, At, order, u, t, out0, d0, o_t, d, lib_t, pattern
        torch.cuda.empty_cache()
    return out


def host_weight_grads(W, rows, cols, lmax, c, x, gbar):
    """The bank's gradients on the host in SciPy f64 for the combinatorial
    Laplacian of the symmetric ``W``: the terms T̃_k x, the Clenshaw
    adjoint u_k = G_k + 2 L̃ u_{k+1} − u_{k+2} (G_k = Σ_f c'[f, k] ḡ_f),
    the per-edge dots Σ_k α_k ⟨u_{k+1}[i], t_k[j]⟩ (α = 2/a1, 1/a1 at
    k = 0) of the off-diagonal and the diagonal, chained through
    ``laplacian_op`` (off-diagonal −w, diagonal Σ_row w):
    ``(w̄ (nnz,), x̄ (N, S), c̄ (Nf, m1))``. x (N, S), gbar (Nf, N, S)."""
    L = (sps.diags(np.ravel(W.sum(axis=1))) - W).tocsr()
    blocks = host_blocks(L)
    nf, m1 = c.shape
    m = m1 - 1
    a1 = a2 = lmax / 2
    terms = list(host_terms(L, lmax, x, m1))
    cp = c.copy()
    cp[:, 0] *= 0.5
    c_bar = np.array([[np.vdot(gbar[f], t) for t in terms]
                      for f in range(nf)])
    c_bar[:, 0] *= 0.5
    rows_t = torch.from_numpy(rows.astype(np.int64))
    cols_t = torch.from_numpy(cols.astype(np.int64))
    off = torch.zeros(len(rows), dtype=torch.float64)
    diag = torch.zeros(L.shape[0], dtype=torch.float64)

    def g_k(k):
        return np.einsum('f,fns->ns', cp[:, k], gbar)

    def dots(u, k):
        alpha = 2.0 / a1 if k else 1.0 / a1
        ut, tt = torch.from_numpy(u), torch.from_numpy(terms[k])
        off.add_(torch.einsum('ec,ec->e', torch.index_select(ut, 0, rows_t),
                              torch.index_select(tt, 0, cols_t)), alpha=alpha)
        diag.add_(torch.einsum('ic,ic->i', ut, tt), alpha=alpha)

    with ThreadPoolExecutor(HOST_THREADS) as pool:
        u_next2, u_next = np.zeros_like(x), g_k(m)
        dots(u_next, m - 1)
        for k in range(m - 1, 0, -1):
            u = (g_k(k) + (2.0 / a1) * (host_product(pool, blocks, u_next)
                                        - a2 * u_next) - u_next2)
            dots(u, k - 1)
            u_next2, u_next = u_next, u
        x_bar = (g_k(0) + (host_product(pool, blocks, u_next)
                           - a2 * u_next) / a1 - u_next2)
    w_bar = -off + diag[rows_t]
    return w_bar.numpy(), x_bar, c_bar


def teacher_weights(W, seed):
    """W with every undirected edge's weight scaled by a seeded factor in
    K_TEACHER, the same on both of its stored entries."""
    up = sps.triu(W, k=1).tocoo()
    f = np.random.default_rng(seed).uniform(*K_TEACHER, size=up.nnz)
    F = sps.coo_matrix((f, (up.row, up.col)), shape=W.shape).tocsr()
    F = F + F.T + sps.diags(np.ones(W.shape[0]))
    return W.multiply(F).tocsr()


def phase_path_k(G, x):
    """Path K: the heat bank of path A through its graph's weights on the
    card, at full width (see the module's docstring)."""
    log('phase K: path K, gradients through the weights on path A\'s '
        'graph')
    n, s = x.shape
    nf, m1 = len(SCALES), ORDER + 1
    unit = n * s * x.element_size()
    units = m1 + nf + 8
    free, total = torch.cuda.mem_get_info()
    log(f'  device memory free {free / 2**30:.2f} of {total / 2**30:.2f} GiB; '
        f'the backward may hold {units} units of {unit / 2**30:.3f} GiB')
    if free < (units + 4) * unit:
        raise AssertionError(f'path K: {free} bytes free, under '
                             f'{units + 4} units')
    lmax = G.lmax                                  # path A's, pinned
    t0 = time.time()
    M = gsp.core.sparse.from_scipy(G.W)
    torch.cuda.synchronize()
    log(f'  W on the card ({M.nnz} stored entries) in {time.time() - t0:.1f} '
        f's')
    w = M.vals.clone().requires_grad_()
    c = heat_coeff(torch.tensor(SCALES, device='cuda'), lmax).detach()
    c.requires_grad_()
    xr = x.detach().requires_grad_()
    gbar = torch.zeros((nf, n, s), device='cuda')
    gbar[:, :, :N_CHECK_COLS] = seeded_normal((nf, n, N_CHECK_COLS), 80)

    def forward(vals=w):
        L = gsp.core.operators.laplacian_op(M.with_vals(vals))
        return cheby_op(L, lmax, c, xr)

    def backward(out):
        return torch.autograd.grad(out, (w, xr, c), gbar, retain_graph=True)

    result = {'lmax': lmax, 'nnz': M.nnz, 'units_allowed': units}
    torch.cuda.synchronize()
    reset_counts()
    PLAIN_CALLS.clear()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = forward()
    fwd = counts()
    grads = backward(out)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    launches = counts()
    per_backward = {k: launches[k] - fwd[k] for k in launches}
    symbols = dict(SYMBOLS)
    result.update(peak_units=peak / unit, peak_gib=peak / 2**30,
                  autograd_3k_units=3 * ORDER, forward_launches=fwd,
                  backward_launches=per_backward, symbols=symbols,
                  plain_calls=dict(PLAIN_CALLS))
    log(f'  one forward and backward: peak {peak / unit:.2f} units '
        f'({peak / 2**30:.2f} GiB) above what is held, at most {units} '
        f'(plain autograd would keep 3K = {3 * ORDER}); backward launches '
        f'{per_backward}; symbols {symbols}')
    if peak > units * unit:
        raise AssertionError(f'path K: peak {peak / unit:.2f} units > {units}')
    # the weights' SDDMM rides in the transpose's SpMM: ORDER fused
    # launches (u_1's share in x̄'s step), no csr_sddmm and no csr_spmm
    fused = {k: per_backward[k] for k in ('csr_spmm_sddmm', 'csr_sddmm',
                                          'csr_spmm')}
    fused_symbols = {k: symbols.get(k, 0) for k in (
        'csr_spmm_sddmm_f32', 'csr_sddmm_f32', 'csr_spmm_f32')}
    if (fused != {'csr_spmm_sddmm': ORDER, 'csr_sddmm': 0, 'csr_spmm': 0}
            or fused_symbols != {'csr_spmm_sddmm_f32': ORDER,
                                 'csr_sddmm_f32': 0,
                                 'csr_spmm_f32': fwd['csr_spmm']}):
        raise AssertionError(f'path K: backward launches {fused}, symbols '
                             f'{fused_symbols}, not {ORDER} fused and no '
                             f'csr_sddmm or csr_spmm')
    if PLAIN_CALLS:
        raise AssertionError(f'path K: plain versions ran: {PLAIN_CALLS}')
    again = backward(out)
    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
        raise AssertionError('path K: two backward passes differ')
    log('  two backward passes bit-equal')
    del again
    w_bar, x_bar, c_bar = grads
    if bool(w_bar[M.nnz:].any()):
        raise AssertionError('path K: the padding\'s cotangent is not 0')
    if bool((x_bar[:, N_CHECK_COLS:] != 0).any()):
        raise AssertionError('path K: x̄ is not 0 where ḡ is')
    t0 = time.time()
    ref = host_weight_grads(
        G.W, M.rows[:M.nnz].cpu().numpy(), M.cols[:M.nnz].cpu().numpy(),
        lmax, c.detach().double().cpu().numpy(),
        x[:, :N_CHECK_COLS].double().cpu().numpy(),
        gbar[:, :, :N_CHECK_COLS].double().cpu().numpy())
    result['host_reference_s'] = time.time() - t0
    log(f'  host f64 reference on {N_CHECK_COLS} columns: '
        f'{result["host_reference_s"]:.1f} s')
    result['rel_err'] = {
        'w_bar': check('path K w̄ vs host f64', w_bar[:M.nnz].cpu(),
                       torch.from_numpy(ref[0]), TOL_PATH),
        'x_bar': check('path K x̄ vs host f64',
                       x_bar[:, :N_CHECK_COLS].cpu(),
                       torch.from_numpy(ref[1]), TOL_PATH),
        'c_bar': check('path K c̄ vs host f64', c_bar.cpu(),
                       torch.from_numpy(ref[2]), TOL_PATH)}
    del ref, grads, w_bar, x_bar, c_bar
    result['ms'] = {'backward': time_ms(lambda: backward(out), 3)}
    del out
    torch.cuda.empty_cache()
    result['ms']['forward'] = time_ms(forward, 2)
    result['ms'].update(backward_parts(M, lmax, c.detach(), x, gbar))
    result['sddmm'] = {
        str(k): measure_sddmm(f'csr_sddmm on path A\'s graph at {k} '
                              f'column{"s" if k > 1 else ""}', M, k, 90 + k)
        for k in (s, 1)}
    result['fused'] = measure_fused(M, lmax)
    result['train'] = train_weights(M, G.W, lmax, c.detach(), x)
    result['summary_ms'] = {
        'fused_128_f32': result['fused'][f'{s}_float32']['ms'],
        'fused_adjoint_step': result['ms']['fused_adjoint_step'],
        'backward': result['ms']['backward'],
        'adam_step': result['train']['ms_per_step']}
    log(f'  path K on {card()}: {json.dumps(result["summary_ms"])}')
    result['small_f64'] = weights_small_f64()
    log(f'path K: {json.dumps(result)}')
    return result, launches


def phase_auxiliaries(G, x):
    """Checkpoint and profiling on the card: ``save_graph``/``load_graph``
    of BA(2^16) with its λmax and a signal, loaded to the card; a
    ``Throughput`` around each of three banks of path A against the CUDA
    events around the same bank (within 2 %: its clock waits for the card);
    ``trace`` over one bank, whose file must name the CSR kernel."""
    import tempfile
    from pygsp_tpu_torch import checkpoint, profiling
    log('phase aux: checkpoint and profiling')
    result = {}
    src, tgt = gsp.graphs.ba_edges_fast(K_SMALL_N, m0=M_ATTACH, m=M_ATTACH,
                                        seed=42)
    H = gsp.graphs.Graph(symmetric_from_edges(src, tgt, K_SMALL_N))
    H.estimate_lmax()
    H.set_signal('s', np.random.default_rng(85).normal(size=(H.N, 3)))
    with tempfile.TemporaryDirectory() as d:
        path = f'{d}/ba.npz'
        checkpoint.save_graph(path, H)
        H2 = checkpoint.load_graph(path)
        if (H2.device.type != 'cuda' or (H2.W != H.W).nnz
                or H2.lmax != H.lmax or H2.lap_type != H.lap_type
                or not np.array_equal(H2.signals['s'], H.signals['s'])):
            raise AssertionError('checkpoint: BA(2^16) did not round-trip')
        v = seeded_normal((H.N, 4), 86)
        if not torch.equal(H2.L @ v, H.L @ v):
            raise AssertionError('checkpoint: the loaded Laplacian differs')
    log(f'  BA(2^16) with λmax {H.lmax:.6f} round-trips to the card')
    g = gsp.filters.Heat(G, scale=SCALES)
    meter = profiling.Throughput(G.L.offdiag.nnz, ORDER, x.shape[1])
    runs = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with meter:
            start.record()
            g.filter(x, order=ORDER)
            end.record()
        runs.append((meter.last_s * 1e3, start.elapsed_time(end)))
    diff = max(abs(a - b) / b for a, b in runs)
    result['throughput'] = {'runs_ms_meter_events': runs, 'rel_diff': diff,
                            'report': meter.report()}
    log(f'  Throughput: {json.dumps(result["throughput"])}')
    if not diff <= 0.02:
        raise AssertionError(f'Throughput off the CUDA events by {diff}')
    with tempfile.TemporaryDirectory() as d:
        with profiling.trace(d):
            g.filter(x, order=ORDER)
            torch.cuda.synchronize()
        files = [f'{root}/{f}' for root, _, fs in os.walk(d) for f in fs]
        text = ''.join(open(f, errors='replace').read() for f in files)
        result['trace'] = {'files': len(files), 'bytes': len(text),
                           'names_csr_spmm': 'csr_spmm' in text}
    log(f'  trace: {json.dumps(result["trace"])}')
    if not result['trace']['names_csr_spmm']:
        raise AssertionError('the trace of a bank does not name csr_spmm')
    return result


def backward_parts(M, lmax, c, x, gbar):
    """The backward's parts at path K's shape, each timed alone: the fused
    adjoint step as the backward runs it (the transpose's SpMM with the
    SDDMM and the diagonal in one launch, the shifted step and the G_k
    group, 30 a backward), and beside it the two parts it fuses, the adjoint
    step without the SDDMM and the SDDMM with the diagonal; and the c̄ pass
    (ḡ's copy with its filter axis last and one ``cheby_dot_group`` over
    the slab)."""
    a1 = a2 = lmax / 2
    L = gsp.core.operators.laplacian_op(M)
    Lt = gsp.core.operators.LaplacianOp(offdiag=L.offdiag.T, diag=L.diag,
                                        lap_type=L.lap_type)
    step2 = Lt.shifted_step(2.0 / a1, a2)
    u, u_old, u_new, t = (seeded_normal(x.shape, 95 + i) for i in range(4))
    cg = c.T.contiguous()[5].reshape(-1, 1)
    factor = Lt.shifted(2.0 / a1, a2)
    f_off, one = factor.offdiag, torch.ones((), device='cuda')
    out_t, diag = torch.zeros_like(M.vals), torch.zeros_like(L.diag)
    alpha = torch.full((), 2.0 / a1, device='cuda')

    def fused_step():
        y = csr_kernel.csr_spmm_sddmm(f_off.rowptr, f_off.cols, f_off.vals,
                                      u, t, out_t, alpha, diag)
        cheby_kernel.cheby_step(y, u, u_old, factor.diag, one, u_new)
        cheby_kernel.cheby_acc_group(u_new[None], gbar, cg)

    parts = {'fused_adjoint_step': time_ms(fused_step, 10),
             'adjoint_step': time_ms(lambda: cheby_kernel.cheby_acc_group(
                 step2(u, u_old, u_new)[None], gbar, cg), 10)}
    parts['sddmm'] = time_ms(lambda: csr_kernel.csr_sddmm(
        M.rows, M.cols, u, u_old, torch.zeros_like(M.vals), 2.0 / a1,
        torch.zeros_like(L.diag)), 10)
    del u, u_old, u_new, t, out_t
    with torch.no_grad():
        _, slab = _bank(L, L, lmax, c, x, keep_terms=True)
    cbar = torch.empty((ORDER + 1, len(SCALES)), device='cuda')
    parts['c_bar_pass'] = time_ms(lambda: cheby_kernel.cheby_dot_group(
        cbar, gbar.movedim(0, -1).contiguous(), slab), 3)
    del slab
    torch.cuda.empty_cache()
    parts['sum_of_parts'] = (ORDER * parts['fused_adjoint_step']
                             + parts['c_bar_pass'])
    parts['sum_of_parts_two_launches'] = (
        ORDER * (parts['adjoint_step'] + parts['sddmm'])
        + parts['c_bar_pass'])
    log(f'  backward parts (ms): {json.dumps(parts)}')
    return parts


def train_weights(M, W, lmax, c, x):
    """K_TRAIN_STEPS Adam steps on the weights (from W's) towards a teacher,
    the same graph with weights scaled by a seeded factor: the loss must
    fall. Returns the losses and the ms of a whole step (forward, loss,
    backward, update) from CUDA events."""
    with torch.no_grad():
        vt = gsp.core.sparse.from_scipy(teacher_weights(W, 83)).vals
        y = cheby_op(gsp.core.operators.laplacian_op(M.with_vals(vt)), lmax,
                     c, x)
    del vt
    w = M.vals.clone().requires_grad_()
    opt = torch.optim.Adam([w], lr=K_TRAIN_LR)
    losses, ms = [], []
    for _ in range(K_TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        opt.zero_grad(set_to_none=True)
        out = cheby_op(gsp.core.operators.laplacian_op(M.with_vals(w)), lmax,
                       c, x)
        loss = torch.mean((out - y) ** 2)
        del out
        loss.backward()
        opt.step()
        end.record()
        end.synchronize()
        losses.append(float(loss.detach()))
        ms.append(start.elapsed_time(end))
    result = {'losses': losses, 'ms_per_step': ms, 'lr': K_TRAIN_LR}
    log(f'  {K_TRAIN_STEPS} Adam steps on the weights: {json.dumps(result)}')
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f'path K: Adam on the weights, losses {losses}')
    return result


def weights_small_f64():
    """On BA(2^16) in f64 with the normalized Laplacian: the bank's w̄, c̄,
    x̄ and λ̄ on the card against the port on the CPU (TOL_K_F64), and λ̄
    against a central difference of the loss on the card."""
    n = K_SMALL_N
    src, tgt = gsp.graphs.ba_edges_fast(n, m0=M_ATTACH, m=M_ATTACH, seed=42)
    W = symmetric_from_edges(src, tgt, n)
    lmax = 2.0
    f64 = torch.float64
    c0 = cheby_coeff(lambda lam: torch.exp(-torch.tensor(
        SCALES, dtype=f64)[:, None] * lam[None, :] / lmax), lmax, m=ORDER,
        dtype=f64, device='cpu').numpy()
    rng = np.random.default_rng(84)
    x0 = rng.normal(size=(n, K_SMALL_S))
    g0 = rng.normal(size=(len(SCALES), n, K_SMALL_S))
    grads, t = {}, {}
    for device in ('cuda', 'cpu'):
        t0 = time.time()
        M = gsp.core.sparse.from_scipy(W, dtype=f64, device=device)
        w = M.vals.clone().requires_grad_()
        c = torch.tensor(c0, device=device, requires_grad=True)
        x = torch.tensor(x0, device=device, requires_grad=True)
        lt = torch.tensor(lmax, dtype=f64, device=device, requires_grad=True)
        L = gsp.core.operators.laplacian_op(M.with_vals(w), 'normalized')
        cheby_op(L, lt, c, x).backward(torch.tensor(g0, device=device))
        grads[device] = [v.grad.cpu() for v in (w, c, x, lt)]
        t[device] = time.time() - t0
    errs = {name: check(f'path K f64 {name} card vs CPU', a, b, TOL_K_F64)
            for name, a, b in zip(('w_bar', 'c_bar', 'x_bar', 'lmax_bar'),
                                  grads['cuda'], grads['cpu'])}
    M = gsp.core.sparse.from_scipy(W, dtype=f64)
    L = gsp.core.operators.laplacian_op(M, 'normalized')
    c, x, g = (torch.tensor(a, device='cuda') for a in (c0, x0, g0))
    h = 1e-6 * lmax
    with torch.no_grad():
        fd = float(((cheby_op(L, lmax + h, c, x) - cheby_op(L, lmax - h, c,
                                                            x)) * g).sum()
                   / (2 * h))
    got = float(grads['cuda'][3])
    fd_err = abs(got - fd) / abs(fd)
    log(f'  λ̄ {got:.12e} against the central difference {fd:.12e}: rel '
        f'err {fd_err:.3e} (tol {TOL_K_LMAX_FD})')
    if not fd_err <= TOL_K_LMAX_FD:
        raise AssertionError(f'path K: λ̄ off its central difference by '
                             f'{fd_err}')
    return {'rel_err': errs, 'lmax_bar': got, 'lmax_fd': fd,
            'lmax_fd_rel_err': fd_err, 'nnz': M.nnz, 's': K_SMALL_S,
            'seconds': t}


# ---------------------------------------------------------------------------
# path M: gradients through the operator on the ELL, chunked, windowed and
# banded formats
# ---------------------------------------------------------------------------

def edge_csr(L):
    """The off-diagonal of ``L`` (ELL, chunked, windowed or banded) as a
    CSR on the card with the same stored values, in the original vertex
    order, sorted by row, padded as ``from_coo`` pads; and each entry's
    index in the concatenated flat leaves (a slot format's live slots,
    the banded tiles' nonzero entries)."""
    off = L.offdiag
    if isinstance(off, gsp.core.sparse.BandedMatrix):
        nb, nd, tile, _ = off.tiles.shape
        index = torch.nonzero(off.tiles.reshape(-1)).flatten()
        i, d = index // (nd * tile * tile), (index // (tile * tile)) % nd
        rows = i * tile + (index // tile) % tile
        cols = (i + d - off.half_bw) * tile + index % tile
    else:
        rows, cols, index = _internal(off).live_slots()
        perm = getattr(off, 'perm', None)
        if perm is not None:
            rows, cols = perm[rows], perm[cols]
    n = off.n_rows
    order = torch.argsort(rows * n + cols)
    rows, cols, index = rows[order], cols[order], index[order]
    flat = torch.cat([v.reshape(-1) for v in off.leaves()])
    nnz = int(rows.numel())
    pad = -nnz % gsp.core.sparse.EDGE_BLOCK or gsp.core.sparse.EDGE_BLOCK

    def padded(t, fill):
        return torch.cat([t, t.new_full((pad,), fill)])

    counts_ = torch.bincount(rows, minlength=n)
    rowptr = torch.cat([counts_.new_zeros(1), counts_.cumsum(0)])
    M = gsp.core.sparse.CSRMatrix(
        rows=padded(rows, n).int(), cols=padded(cols, n).int(),
        vals=padded(flat[index], 0), rowptr=rowptr.int(), n_rows=n,
        n_cols=n, nnz=nnz)
    return M, index


def bank_grads(L, lmax, c, x, gbar):
    """One forward and backward of the heat bank on ``L`` through its value
    leaves, diagonal, λmax (a tensor), c and x: the cotangents (leaves
    joined flat, diag̅, λ̄, c̄, x̄), the launches of the forward and of the
    backward, the peak above what is held in (N, S) units, and the
    forward's and the backward's ms (:func:`counted_grads`)."""
    n, s = x.shape
    leaves, diag, Lg = leaf_inputs(L)
    lt = torch.tensor(lmax, device='cuda', requires_grad=True)
    ct = c.detach().clone().requires_grad_()
    xr = x.detach().clone().requires_grad_()
    grads, fwd, bwd, peak, ms = counted_grads(
        'path M', lambda: cheby_op(Lg, lt, ct, xr),
        (*leaves, diag, lt, ct, xr), gbar, n * s * x.element_size())
    flat = torch.cat([v.reshape(-1) for v in grads[:len(leaves)]])
    return ((flat,) + tuple(grads[len(leaves):]), fwd, bwd, peak, ms)


def format_parts(L, lmax, x):
    """The backward's parts that depend on the format, each timed alone at
    the bank's shape (CUDA events): ``setup_ms``, what a backward makes
    before its first step (the leaves gathered into the CSR view's
    transpose; the transposed tiles and the tiles' accumulator);
    ``adjoint_step_ms``, one step of the adjoint (kernel A's fused entry
    with its SDDMM share, or kernel C on the transposed tiles) and kernel
    B's step; on banded ``tiles_product_ms``, a step's share of the tiles'
    cotangent (the FP32 ``baddbmm``); ``finish_ms``, the cotangent taken
    to the leaves (one scatter; on banded the tiles' layout); off banded
    ``view_build_ms``, the CSR view's build (host clock around a
    synchronised call)."""
    op = L.hoisted()[0]
    n, s = x.shape
    a1 = lmax / 2
    slab = seeded_normal((2, n, s), 87)
    u, out = seeded_normal((n, s), 88), torch.empty_like(x)
    parts = {'setup_ms': time_ms(lambda: _adjoint(op, slab, x.shape, x.dtype,
                                                  True, a1), 3)}
    adj = _adjoint(op, slab, x.shape, x.dtype, True, a1)
    step = adj.step(2.0 / a1, a1)
    parts['adjoint_step_ms'] = time_ms(lambda: step(u, u, out, 1), 5)
    if isinstance(L.offdiag, gsp.core.sparse.BandedMatrix):
        parts['tiles_product_ms'] = time_ms(lambda: adj.share(u, 1), 5)
    parts['finish_ms'] = time_ms(adj.finish, 3)
    del adj, step, slab
    if not isinstance(L.offdiag, gsp.core.sparse.BandedMatrix):
        # the CSR view's build, once a structure: on a copy of the index
        # tensor that holds it, so that this build is not the path's
        off = dataclasses.replace(op.offdiag, **{
            k: getattr(op.offdiag, k).clone() for k in (
                'ell_cols', 'slot_cols', 'cols') if hasattr(op.offdiag, k)})
        torch.cuda.synchronize()
        t0 = time.time()
        gsp.core.sparse.grad_edges(off)
        torch.cuda.synchronize()
        parts['view_build_ms'] = (time.time() - t0) * 1e3
        gsp.core.sparse.grad_edges.builds -= 1
        del off
    torch.cuda.empty_cache()
    return parts


def phase_path_m(path, L, lmax, x):
    """Path M on ``path``'s operator ``L`` (the bench graph's windowed,
    hybrid or chunked one, or path B's banded one): the bank
    differentiated through the format's leaves, diagonal, λmax, c and x
    (ḡ on N_CHECK_COLS columns, as path K), its launches (the format's
    SpMM 30 times forward; the backward 30 of kernel A's fused entry on
    the CSR view, or 30 of kernel C on the transposed tiles), no plain
    version, the padding slots' cotangent exactly 0; every cotangent
    against the CSR route's on a CSR with the same values and diagonal
    (leaves mapped to its entries) within TOL_PATH; the forward's and the
    backward's ms and the peak in (N, S) units."""
    log(f'phase M: path M on path {path}\'s {type(L.offdiag).__name__}')
    n, s = x.shape
    nf = len(SCALES)
    c = heat_coeff(torch.tensor(SCALES, device='cuda'), lmax).detach()
    gbar = torch.zeros((nf, n, s), device='cuda')
    gbar[:, :, :N_CHECK_COLS] = seeded_normal((nf, n, N_CHECK_COLS), 85)
    builds = gsp.core.sparse.grad_edges.builds
    got, fwd, bwd, peak, ms = bank_grads(L, lmax, c, x, gbar)
    builds = gsp.core.sparse.grad_edges.builds - builds
    banded = isinstance(L.offdiag, gsp.core.sparse.BandedMatrix)
    kernel = {'WindowedELLMatrix': 'windowed_fold', 'ELLMatrix': 'ell_spmm',
              'ChunkedELLMatrix': 'chunked_spmm',
              'BandedMatrix': 'banded_spmm'}[type(L.offdiag).__name__]
    want_bwd = ({'banded_spmm': ORDER, 'csr_spmm_sddmm': 0} if banded
                else {'csr_spmm_sddmm': ORDER, 'banded_spmm': 0})
    seen = {k: bwd[k] for k in want_bwd}
    if (fwd[kernel] != ORDER or seen != want_bwd or bwd['csr_sddmm']
            or bwd['csr_spmm'] or bwd[kernel] != (ORDER if banded else 0)):
        raise AssertionError(f'path M on {path}: forward launches {fwd}, '
                             f'backward {bwd}')
    log(f'  launches: forward {kernel} {fwd[kernel]}, backward '
        f'{json.dumps({k: v for k, v in bwd.items() if v})}; CSR views '
        f'built {builds}')
    LC, index = csr_route(L)
    C = LC.offdiag
    want = bank_grads(LC, lmax, c, x, gbar)[0]
    rel = {}
    rel['leaves_on_edges'], n_dead = leaves_against(
        f'path M {path}', got[:1], want[0], C, index, banded)
    for name, a, b in zip(('diag', 'lmax', 'c', 'x'), got[1:], want[1:]):
        rel[name] = check(f'path M {path}: {name} cotangent vs the CSR '
                          f'route', a.reshape(-1), b.reshape(-1), TOL_PATH)
    result = {'rel_err': rel, 'ms': ms, 'peak_units': peak,
              'forward_launches': launched(fwd),
              'backward_launches': launched(bwd),
              'csr_views_built': builds, 'edges': C.nnz,
              'padding_slots': n_dead,
              'leaves': [tuple(v.shape) for v in L.offdiag.leaves()]}
    del got, want, C, LC
    torch.cuda.empty_cache()
    result['parts'] = format_parts(L, lmax, x)
    log(f'  path M on {path} ({card()}): {json.dumps(result)}')
    return result, {k: fwd[k] + bwd[k] for k in fwd}


def train_leaves(L, lmax, x):
    """M_TRAIN_STEPS Adam steps on the windowed operator's value leaves
    towards the bank of its own values, from values scaled by 0.9: the loss
    must fall, and the CSR view of the slots is built at most once over the
    steps (none where an earlier backward built it). Returns the losses,
    each step's ms (CUDA events: forward, loss, backward, update) and the
    views built."""
    c = heat_coeff(torch.tensor(SCALES, device='cuda'), lmax).detach()
    with torch.no_grad():
        y = cheby_op(L, lmax, c, x)
    leaves = [(0.9 * v.detach()).requires_grad_()
              for v in L.offdiag.leaves()]
    opt = torch.optim.Adam(leaves, lr=M_TRAIN_LR)
    builds = gsp.core.sparse.grad_edges.builds
    losses, ms = [], []
    for _ in range(M_TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        opt.zero_grad(set_to_none=True)
        Lg = gsp.core.operators.LaplacianOp(
            offdiag=L.offdiag.with_leaves(leaves), diag=L.diag,
            lap_type=L.lap_type)
        loss = torch.mean((cheby_op(Lg, lmax, c, x) - y) ** 2)
        loss.backward()
        opt.step()
        end.record()
        end.synchronize()
        losses.append(float(loss.detach()))
        ms.append(start.elapsed_time(end))
    builds = gsp.core.sparse.grad_edges.builds - builds
    result = {'losses': losses, 'ms_per_step': ms, 'lr': M_TRAIN_LR,
              'csr_views_built': builds}
    log(f'  {M_TRAIN_STEPS} Adam steps on the windowed leaves: '
        f'{json.dumps(result)}')
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f'path M: Adam on the leaves, losses {losses}')
    if builds:
        raise AssertionError(f'path M: the CSR view was built {builds} '
                             f'times over the Adam steps')
    return result


def banded_small_f64():
    """Grid2d(64, 64)'s banded operator in f64: the tiles' cotangent (every
    entry, those outside the grid's edges included), diag̅, λ̄, c̄ and x̄
    on the card against the port on the CPU (its plain versions) within
    TOL_K_F64."""
    G = gsp.graphs.Grid2d(EXACT_SIDE, EXACT_SIDE, device='cpu',
                          dtype=torch.float64)
    Lb = G.L.to_banded()
    f64 = torch.float64
    rng = np.random.default_rng(86)
    c0 = rng.normal(size=(len(SCALES), ORDER + 1)) / (ORDER + 1)
    x0 = rng.normal(size=(G.N, K_SMALL_S))
    g0 = rng.normal(size=(len(SCALES), G.N, K_SMALL_S))
    grads = {}
    for device in ('cuda', 'cpu'):
        tiles = Lb.offdiag.tiles.to(device, copy=True).requires_grad_()
        diag = Lb.diag.to(device, copy=True).requires_grad_()
        lt = torch.tensor(8.0, dtype=f64, device=device, requires_grad=True)
        c = torch.tensor(c0, device=device, requires_grad=True)
        x = torch.tensor(x0, device=device, requires_grad=True)
        L = gsp.core.operators.LaplacianOp(
            offdiag=Lb.offdiag.with_leaves((tiles,)), diag=diag,
            lap_type=Lb.lap_type)
        cheby_op(L, lt, c, x).backward(torch.tensor(g0, device=device))
        grads[device] = [v.grad.cpu() for v in (tiles, diag, lt, c, x)]
    off_edges = Lb.offdiag.tiles == 0
    errs = {name: check(f'path M banded f64 {name} card vs CPU', a, b,
                        TOL_K_F64)
            for name, a, b in zip(('tiles', 'diag', 'lmax', 'c', 'x'),
                                  grads['cuda'], grads['cpu'])}
    errs['tiles_off_edges'] = check(
        'path M banded f64 tiles off the edges card vs CPU',
        grads['cuda'][0][off_edges], grads['cpu'][0][off_edges], TOL_K_F64)
    return {'rel_err': errs, 'tiles': tuple(Lb.offdiag.tiles.shape),
            'entries_off_edges': int(off_edges.sum())}


# ---------------------------------------------------------------------------
# path N: L @ x, the synthesis and cheby_rect differentiated on every format
# ---------------------------------------------------------------------------

N_RECT_BOUNDS = (0.2, 0.6)     # cheby_rect's band, in units of λmax


def format_kernel(L):
    """The counter of the wrapper that ``L``'s off-diagonal launches for
    its SpMM."""
    return {'CSRMatrix': 'csr_spmm', 'WindowedELLMatrix': 'windowed_fold',
            'ELLMatrix': 'ell_spmm', 'ChunkedELLMatrix': 'chunked_spmm',
            'BandedMatrix': 'banded_spmm'}[type(L.offdiag).__name__]


def leaf_inputs(L):
    """Grad-requiring copies of ``L``'s value leaves and diagonal, and the
    operator made of them (``with_leaves``)."""
    leaves = [v.detach().clone().requires_grad_() for v in L.offdiag.leaves()]
    diag = L.diag.detach().clone().requires_grad_()
    return leaves, diag, gsp.core.operators.LaplacianOp(
        offdiag=L.offdiag.with_leaves(leaves), diag=diag, lap_type=L.lap_type)


def counted_grads(name, fn, inputs, cot, unit, backward_peak=False):
    """One forward ``fn()`` and its backward for the cotangent ``cot``
    with respect to ``inputs``, counted: ``(grads, forward launches,
    backward launches, peak above what is held in units of ``unit``
    bytes, ms)``, the ms from CUDA events (mean of 2 after a warm-up
    call). The peak is the forward's and the backward's above what was
    held before the forward, or with ``backward_peak`` the backward's
    alone above what was held when it started (the forward's output and
    what it saved included). Raises where a plain version ran."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    PLAIN_CALLS.clear()
    out = fn()
    torch.cuda.synchronize()
    fwd = counts()
    if backward_peak:
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    grads = torch.autograd.grad(out, inputs, cot, retain_graph=True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    total = counts()
    bwd = {k: total[k] - fwd[k] for k in total}
    if PLAIN_CALLS or total['slot_plain'] or total['tail_plain']:
        raise AssertionError(f'{name}: plain versions ran: {PLAIN_CALLS}, '
                             f'{total}')
    ms = {'backward': time_ms(lambda: torch.autograd.grad(
        out, inputs, cot, retain_graph=True), 2)}
    del out
    torch.cuda.empty_cache()
    ms['forward'] = time_ms(fn, 2)
    return grads, fwd, bwd, peak / unit, ms


def launched(c):
    return {k: v for k, v in c.items() if v}


def require_counts(name, got, want):
    """Raise unless each kernel in ``want`` launched exactly its count."""
    seen = {k: got[k] for k in want}
    if seen != want:
        raise AssertionError(f'{name}: launches {launched(got)}, not {want}')


def csr_route(L):
    """``L`` as a CSR operator on the card with the same stored values and
    diagonal (:func:`edge_csr`), and each CSR entry's index in the flat
    leaves."""
    C, index = edge_csr(L)
    return gsp.core.operators.LaplacianOp(offdiag=C, diag=L.diag,
                                          lap_type=L.lap_type), index


def leaves_against(name, got, want, C, index, banded):
    """The leaves' cotangents (joined flat) against the CSR route's on its
    entries, within TOL_PATH; the padding slots' exactly 0."""
    flat = torch.cat([v.reshape(-1) for v in got])
    dead = torch.ones_like(flat, dtype=torch.bool)
    dead[index] = False
    if not banded and bool(flat[dead].any()):
        raise AssertionError(f'{name}: a padding slot\'s cotangent is not 0')
    err = check(f'{name}: the leaves\' cotangents on the edges vs the CSR '
                f'route', flat[index], want[:C.nnz], TOL_PATH)
    return err, 0 if banded else int(dead.sum())


def phase_path_n_spmm(path, L, x):
    """N1 on ``path``'s operator: ``L @ x`` with x (N, 128) f32 through the
    value leaves, the diagonal and x (``⟨ȳ, L @ x⟩``, ȳ seeded): one
    launch of the format's SpMM forward; backward one of kernel A's fused
    entry on the CSR view's transpose (x̄ and the leaves' SDDMM in one
    walk), or kernel C on the transposed tiles and the tiles' FP32
    product; no plain version; the padding slots' cotangent exactly 0;
    each cotangent against the CSR route's within TOL_PATH; ms."""
    name = f'path N1 on {path}'
    n, s = x.shape
    banded = isinstance(L.offdiag, gsp.core.sparse.BandedMatrix)
    kernel = format_kernel(L)
    ybar = seeded_normal((n, s), 101)
    leaves, diag, Lg = leaf_inputs(L)
    xr = x.detach().clone().requires_grad_()
    got, fwd, bwd, _, ms = counted_grads(
        name, lambda: Lg @ xr, (*leaves, diag, xr), ybar,
        n * s * x.element_size())
    require_counts(f'{name} forward', fwd, {kernel: 1})
    require_counts(f'{name} backward', bwd, {
        'csr_spmm_sddmm': 0 if banded else 1, 'csr_spmm': 0, 'csr_sddmm': 0,
        'banded_spmm': 1 if banded else 0, **({} if banded else {kernel: 0})})
    LC, index = csr_route(L)
    cleaves, cdiag, LCg = leaf_inputs(LC)
    xc = x.detach().clone().requires_grad_()
    want = torch.autograd.grad(LCg @ xc, (*cleaves, cdiag, xc), ybar)
    rel, n_dead = {}, 0
    rel['leaves_on_edges'], n_dead = leaves_against(
        name, got[:len(leaves)], want[0], LC.offdiag, index, banded)
    for key, a, b in zip(('diag', 'x'), got[len(leaves):], want[1:]):
        rel[key] = check(f'{name}: {key} cotangent vs the CSR route', a, b,
                         TOL_PATH)
    result = {'rel_err': rel, 'ms': ms, 'forward_launches': launched(fwd),
              'backward_launches': launched(bwd), 'padding_slots': n_dead}
    log(f'  {name}: {json.dumps(result)}')
    return result, {k: fwd[k] + bwd[k] for k in fwd}


def synthesis_inputs(n, s, lmax):
    """The synthesis's signal x (N, S, Nf) and cotangent ȳ (N, S) nonzero on
    N_CHECK_COLS columns, seeded, and the heat bank's coefficients."""
    nf = len(SCALES)
    xs = seeded_normal((n, s, nf), 102)
    ybar = torch.zeros((n, s), device='cuda')
    ybar[:, :N_CHECK_COLS] = seeded_normal((n, N_CHECK_COLS), 103)
    c = heat_coeff(torch.tensor(SCALES, device='cuda'), lmax).detach()
    return xs, ybar, c


def phase_path_n_synthesis(path, L, lmax, x, W=None):
    """N2 on ``path``'s operator: ``cheby_synthesis`` of x (N, 128, 4) f32
    (:func:`synthesis_inputs`) differentiated through the value leaves,
    the diagonal, λmax (a tensor), c and x; with ``W`` (path A) through
    W's values by ``laplacian_op`` instead of the leaves. Forward the
    format's SpMM 30 times at 512 columns; backward the bank of ȳ on Lᵀ
    (30 SpMMs at 128 columns: kernel A on the transpose or on the CSR
    view's, kernel C on the transposed tiles), then the adjoint on
    (Lᵀ)ᵀ = L: 29 of kernel A's fused entry and one ``csr_sddmm`` (u_1's
    share; no x̄ step), or 29 of kernel C; no plain version; the padding
    slots' cotangent exactly 0; x̄ within TOL_F_XBAR of ``cheby_op(L, λmax,
    c, ȳ)`` without autograd through the format's forward kernels (L is
    symmetric); off CSR each cotangent against the CSR route's within
    TOL_PATH; the ms and the peak in (N, S) units."""
    name = f'path N2 on {path}'
    n, s = x.shape
    unit = n * s * x.element_size()
    banded = isinstance(L.offdiag, gsp.core.sparse.BandedMatrix)
    kernel = format_kernel(L)
    xs, ybar, c = synthesis_inputs(n, s, lmax)

    def inputs_of(L):
        lt = torch.tensor(lmax, device='cuda', requires_grad=True)
        ct = c.clone().requires_grad_()
        xr = xs.clone().requires_grad_()
        if W is not None:
            w = W.vals.clone().requires_grad_()
            return (w, lt, ct, xr), lambda: cheby_synthesis(
                gsp.core.operators.laplacian_op(W.with_vals(w)), lt, ct, xr)
        leaves, diag, Lg = leaf_inputs(L)
        return (*leaves, diag, lt, ct, xr), lambda: cheby_synthesis(
            Lg, lt, ct, xr)

    inputs, fn = inputs_of(L)
    got, fwd, bwd, peak, ms = counted_grads(name, fn, inputs, ybar, unit)
    del inputs, fn
    torch.cuda.empty_cache()
    require_counts(f'{name} forward', fwd, {kernel: ORDER})
    if banded:
        require_counts(f'{name} backward', bwd, {
            'banded_spmm': 2 * ORDER - 1, 'csr_spmm': 0,
            'csr_spmm_sddmm': 0, 'csr_sddmm': 0})
    else:
        require_counts(f'{name} backward', bwd, {
            'csr_spmm': ORDER, 'csr_spmm_sddmm': ORDER - 1, 'csr_sddmm': 1,
            'banded_spmm': 0, **({} if kernel == 'csr_spmm'
                                 else {kernel: 0})})
    with torch.no_grad():
        want_x = cheby_op(L if W is None else gsp.core.operators.laplacian_op(
            W), lmax, c, ybar).movedim(0, -1)
    rel = {'x_vs_bank_of_ybar': check(
        f'{name}: x̄ vs cheby_op(L, λmax, c, ȳ) through the format\'s '
        f'kernels', got[-1], want_x, TOL_F_XBAR)}
    del want_x
    n_dead = 0
    if W is not None:
        if bool(got[0][W.nnz:].any()):
            raise AssertionError(f'{name}: the padding\'s w̄ is not 0')
    else:
        LC, index = csr_route(L)
        cin, cfn = inputs_of(LC)
        want = torch.autograd.grad(cfn(), cin, ybar)
        del cin, cfn
        k = len(L.offdiag.leaves())
        rel['leaves_on_edges'], n_dead = leaves_against(
            name, got[:k], want[0], LC.offdiag, index, banded)
        for key, a, b in zip(('diag', 'lmax', 'c', 'x'), got[k:], want[1:]):
            rel[key] = check(f'{name}: {key} cotangent vs the CSR route',
                             a.reshape(-1), b.reshape(-1), TOL_PATH)
        del want, LC, index
    result = {'rel_err': rel, 'ms': ms, 'peak_units': peak,
              'forward_launches': launched(fwd),
              'backward_launches': launched(bwd), 'padding_slots': n_dead}
    del got
    torch.cuda.empty_cache()
    log(f'  {name} ({card()}): {json.dumps(result)}')
    return result, {k: fwd[k] + bwd[k] for k in fwd}


def synthesis_small_f64():
    """N2 on BA(2^16) in f64 with the normalized Laplacian, x (N, 4, Nf): the
    synthesis's w̄, c̄, x̄ and λ̄ on the card against the port on the CPU
    (TOL_K_F64), and λ̄ against a central difference of the loss on the
    card."""
    n = K_SMALL_N
    src, tgt = gsp.graphs.ba_edges_fast(n, m0=M_ATTACH, m=M_ATTACH, seed=42)
    W = symmetric_from_edges(src, tgt, n)
    lmax = 2.0
    f64 = torch.float64
    nf = len(SCALES)
    c0 = cheby_coeff(lambda lam: torch.exp(-torch.tensor(
        SCALES, dtype=f64)[:, None] * lam[None, :] / lmax), lmax, m=ORDER,
        dtype=f64, device='cpu').numpy()
    # x (N, S/Nf, Nf): the recurrence is as wide as path K's bank's
    s = K_SMALL_S // nf
    rng = np.random.default_rng(104)
    x0 = rng.normal(size=(n, s, nf))
    g0 = rng.normal(size=(n, s))
    grads, t = {}, {}
    for device in ('cuda', 'cpu'):
        t0 = time.time()
        M = gsp.core.sparse.from_scipy(W, dtype=f64, device=device)
        w = M.vals.clone().requires_grad_()
        c = torch.tensor(c0, device=device, requires_grad=True)
        x = torch.tensor(x0, device=device, requires_grad=True)
        lt = torch.tensor(lmax, dtype=f64, device=device, requires_grad=True)
        L = gsp.core.operators.laplacian_op(M.with_vals(w), 'normalized')
        cheby_synthesis(L, lt, c, x).backward(torch.tensor(g0, device=device))
        grads[device] = [v.grad.cpu() for v in (w, c, x, lt)]
        t[device] = time.time() - t0
    errs = {name: check(f'path N2 f64 {name} card vs CPU', a, b, TOL_K_F64)
            for name, a, b in zip(('w_bar', 'c_bar', 'x_bar', 'lmax_bar'),
                                  grads['cuda'], grads['cpu'])}
    M = gsp.core.sparse.from_scipy(W, dtype=f64)
    L = gsp.core.operators.laplacian_op(M, 'normalized')
    c, x, g = (torch.tensor(a, device='cuda') for a in (c0, x0, g0))
    h = 1e-6 * lmax
    with torch.no_grad():
        fd = float(((cheby_synthesis(L, lmax + h, c, x)
                     - cheby_synthesis(L, lmax - h, c, x)) * g).sum()
                   / (2 * h))
    got = float(grads['cuda'][3])
    fd_err = abs(got - fd) / abs(fd)
    log(f'  synthesis λ̄ {got:.12e} against the central difference '
        f'{fd:.12e}: rel err {fd_err:.3e} (tol {TOL_K_LMAX_FD})')
    if not fd_err <= TOL_K_LMAX_FD:
        raise AssertionError(f'path N2: λ̄ off its central difference by '
                             f'{fd_err}')
    return {'rel_err': errs, 'lmax_bar': got, 'lmax_fd': fd,
            'lmax_fd_rel_err': fd_err, 'nnz': M.nnz, 's': s, 'nf': nf,
            'seconds': t}


def phase_path_n_rect(L, lmax, x):
    """N3 on path C's windowed operator: ``cheby_rect`` (order 30, the band
    N_RECT_BOUNDS) of x (N, 128) requiring grad, routed through
    ``cheby_op``: its x̄ for a seeded ȳ within TOL_F_XBAR of ``cheby_rect``
    of ȳ without autograd (L is symmetric); launches and ms."""
    name = 'path N3 on C'
    n, s = x.shape
    bounds = [b * lmax for b in N_RECT_BOUNDS]
    ybar = seeded_normal((n, s), 105)
    xr = x.detach().clone().requires_grad_()
    (got,), fwd, bwd, _, ms = counted_grads(
        name, lambda: gsp.ops.cheby_rect(L, lmax, bounds, xr, order=ORDER),
        (xr,), ybar, n * s * x.element_size())
    kernel = format_kernel(L)
    require_counts(f'{name} forward', fwd, {kernel: ORDER})
    require_counts(f'{name} backward', bwd, {'csr_spmm': ORDER, kernel: 0,
                                             'csr_spmm_sddmm': 0,
                                             'csr_sddmm': 0})
    with torch.no_grad():
        want = gsp.ops.cheby_rect(L, lmax, bounds, ybar, order=ORDER)
    result = {'rel_err': check(f'{name}: x̄ vs cheby_rect of ȳ', got, want,
                               TOL_F_XBAR),
              'ms': ms, 'forward_launches': launched(fwd),
              'backward_launches': launched(bwd)}
    log(f'  {name}: {json.dumps(result)}')
    return result, {k: fwd[k] + bwd[k] for k in fwd}


def phase_path_n(path, L, lmax, x, W=None):
    """Path N on ``path``'s operator: N1 and N2 (N2 alone through W on
    path A), and N3 on path C; each part's launches as counted in its own
    run. Returns the results and the launches summed over the parts."""
    log(f'phase N: path N on path {path}\'s {type(L.offdiag).__name__}')
    t0 = time.time()
    result, total = {}, {}
    parts = [('synthesis', lambda: phase_path_n_synthesis(path, L, lmax, x,
                                                          W))]
    if W is None:
        parts.insert(0, ('spmm', lambda: phase_path_n_spmm(path, L, x)))
    if path == 'C':
        parts.append(('cheby_rect', lambda: phase_path_n_rect(L, lmax, x)))
    for key, part in parts:
        result[key], c = part()
        total = {k: total.get(k, 0) + v for k, v in c.items()}
        torch.cuda.empty_cache()
    if W is not None:
        result['small_f64'] = synthesis_small_f64()
    result['phase_s'] = time.time() - t0
    log(f'path N on {path} ({card()}): {json.dumps(result)}')
    return result, total


# ---------------------------------------------------------------------------
# path G: the filter zoo at full width, the difference operator, the spectral
# helpers and LOBPCG
# ---------------------------------------------------------------------------

def zoo_bank(path, per_bank, g_rule, spmm='csr_spmm'):
    """Raise unless a bank launched the path's SpMM kernel and the step once
    per order and the accumulator groups the rule's g gives."""
    want = {spmm: ORDER, 'cheby_step': ORDER - 1,
            'cheby_acc_group': group_launches(g_rule)}
    got = {k: per_bank[k] for k in want}
    if got != want:
        raise AssertionError(f'path {path}: launches {got}, not {want}')


def timed(phase, *args):
    """``phase(*args)`` -> ``(result, launches)``, with the phase's seconds
    on the host clock added to the result as ``phase_s``."""
    t0 = time.time()
    out, launches = phase(*args)
    out['phase_s'] = time.time() - t0
    return out, launches


def phase_path_g_bank(path, G, x, name, L_host):
    """A bank of NF_ZOO filters (``name``) on a path's graph and signal,
    through ``Filter.filter``: its launches, 8 columns against the SciPy
    f64 recurrence of its own coefficients, its time."""
    g = getattr(gsp.filters, name)(G, Nf=NF_ZOO)
    g_rule = group_of(G.L, x, nf=NF_ZOO)

    def bank():
        return g.filter(x, method='chebyshev', order=ORDER)

    reset_counts()
    out, launches, per_bank = run_bank(bank)
    log(f'  {name}(Nf={NF_ZOO}) on path {path}: per bank {per_bank}, '
        f'group g = {g_rule}')
    spmm = 'csr_spmm' if path == 'A' else 'windowed_fold'
    zoo_bank(path, per_bank, g_rule, spmm)
    if path == 'C':
        require_tail('G on C', per_bank)
        if per_bank['csr_spmm']:
            raise AssertionError('the CSR kernel ran inside the windowed '
                                 'bank')
    if tuple(out.shape) != (G.N, x.shape[1], NF_ZOO):
        raise AssertionError(f'path G on {path}: shape {tuple(out.shape)}')
    rel_err = validate_path(f'G ({name} on {path})',
                            reference(L_host, G.lmax, g.evaluate, x),
                            out.permute(2, 0, 1))
    del out
    ms = time_ms(bank, 3)
    log(f'  {ms:.3f} ms per bank of {NF_ZOO}')
    return {'design': name, 'nf': NF_ZOO, 'ms_per_bank': ms,
            'rel_err': rel_err, 'acc_group': g_rule}, launches


def measure_difference(G, x):
    """The difference operator on path A's graph for both Laplacian types:
    ``grad`` and ``div`` at 128 columns, one CSR launch each, ``grad``
    against the host SciPy Dᵀ (built from the edge list) on 8 columns and
    ``div(grad(x))`` against the host Laplacian, each bit-equal across two
    launches; for the combinatorial type, each product timed and a backward
    through ``grad`` equal to ``div(ȳ)``."""
    tri = sps.triu(G.W, format='coo')
    src, tgt, w = tri.row, tri.col, tri.data
    e = np.arange(len(w))
    x8 = x[:, :N_CHECK_COLS].double().cpu().numpy()
    out = {}
    launches = dict.fromkeys(counts(), 0)
    for lap_type in ('combinatorial', 'normalized'):
        G.compute_laplacian(lap_type)
        t0 = time.time()
        G.compute_differential_operator()
        torch.cuda.synchronize()
        build_s = time.time() - t0
        dw = np.ravel(G.W.sum(axis=0))
        if lap_type == 'combinatorial':
            v_src, v_tgt = -np.sqrt(w), np.sqrt(w)
            L_host = sps.diags(dw) - G.W
        else:
            v_src, v_tgt = -np.sqrt(w / dw[src]), np.sqrt(w / dw[tgt])
            dm = sps.diags(1 / np.sqrt(dw))
            L_host = sps.eye(G.N) - dm @ G.W @ dm
        DT = sps.csr_matrix((np.concatenate([v_src, v_tgt]),
                             (np.concatenate([e, e]),
                              np.concatenate([src, tgt]))),
                            shape=(len(w), G.N))
        reset_counts()
        y = G.grad(x)
        grad_launches = counts()
        reset_counts()
        z = G.div(y)
        div_launches = counts()
        for op, n in (('grad', grad_launches['csr_spmm']),
                      ('div', div_launches['csr_spmm'])):
            if n != 1:
                raise AssertionError(f'{op}: {n} csr_spmm launches, not 1')
        for k in launches:
            launches[k] += grad_launches[k] + div_launches[k]
        res = {'build_s': build_s, 'n_edges': G.D.n_edges,
               'grad_rel_err': check(
                   f'grad ({lap_type}) vs host Dᵀ x', y[:, :N_CHECK_COLS],
                   torch.from_numpy(DT @ x8), TOL_CSR),
               'div_grad_rel_err': check(
                   f'div(grad(x)) ({lap_type}) vs host L x',
                   z[:, :N_CHECK_COLS], torch.from_numpy(L_host @ x8),
                   TOL_CSR)}
        if not torch.equal(y, G.grad(x)) or not torch.equal(z, G.div(y)):
            raise AssertionError(f'{lap_type}: two launches of grad or div '
                                 f'differ')
        log(f'  grad and div ({lap_type}): one csr_spmm launch each, two '
            f'launches bit-equal; D built in {build_s:.1f} s')
        del z
        if lap_type == 'combinatorial':
            res['grad'] = measure_spmm('grad at path A', G.D.DT, x)
            res['div'] = measure_spmm('div at path A', G.D.D, y)
            res['grad']['ms_call'] = time_ms(lambda: G.grad(x), 10)
            res['div']['ms_call'] = time_ms(lambda: G.div(y), 10)
            del y
            xr = x.clone().requires_grad_()
            ybar = seeded_normal((G.D.n_edges, x.shape[1]), 90)
            reset_counts()
            G.grad(xr).backward(ybar)
            backward = counts()
            launches['csr_spmm'] += backward['csr_spmm']
            n = backward['csr_spmm']
            if n != 2:
                raise AssertionError(f'grad forward and backward: {n} '
                                     f'csr_spmm launches, not 2')
            if not torch.equal(xr.grad, G.div(ybar)):
                raise AssertionError('the backward of grad is not div(ȳ)')
            log('  backward through grad: one more csr_spmm launch, '
                'equal to div(ȳ)')
            del xr, ybar
        else:
            del y
        out[lap_type] = res
        torch.cuda.empty_cache()
    return out, launches


def phase_path_g_a(G, x):
    """Path G on path A's graph and signal: a MexicanHat bank of 6, the
    spectral helpers on A's Laplacian, then the difference operator (which
    leaves the graph on the normalized Laplacian)."""
    log('phase G: path G on path A\'s graph')
    bank, launches = phase_path_g_bank('A', G, x, 'MexicanHat',
                                       G.L.to_scipy())
    other = {'G_A_bank': launches}
    # the accumulator groups at Nf = 6 (of g, and of one term) against
    # their bound and addmm_
    group6 = {g: measure_group(G.N, x.shape[1], NF_ZOO, torch.float32,
                               torch.float32, g)
              for g in (bank['acc_group'], 1)}
    torch.cuda.empty_cache()

    reset_counts()
    ub = float(laplacian_upper_bound(G.L))
    L_host = abs(G.L.to_scipy().astype(np.float64))
    ub_host = float(np.max(np.ravel(L_host.sum(axis=1))))
    log(f'  laplacian_upper_bound {ub} against the host Gershgorin bound '
        f'{ub_host}')
    if abs(ub - ub_host) > 1e-6 * ub_host:
        raise AssertionError(f'laplacian_upper_bound {ub} != {ub_host}')
    t0 = time.time()
    power = float(power_iteration_lmax(G.L))
    power_s = time.time() - t0
    lanczos = float(estimate_lmax_lanczos(G.L)) / 1.01
    other['G_A_spectral'] = counts()
    gap = (lanczos - power) / lanczos
    log(f'  power_iteration_lmax (100 iterations) {power} in {power_s:.2f} '
        f's; Lanczos λmax {lanczos}: gap {gap:.3e}')
    if not power <= ub * (1 + 1e-6):
        raise AssertionError(f'power iteration {power} above the bound {ub}')
    if not abs(gap) <= TOL_POWER:
        raise AssertionError(f'power iteration {power} is {gap} from '
                             f'Lanczos\'s λmax {lanczos} (tol {TOL_POWER})')
    # the helpers' SpMM: one column
    one_column = measure_spmm('csr_spmm at path A, one column',
                              G.L.offdiag, seeded_normal((G.N, 1), 92))

    diff, other['G_A_difference'] = measure_difference(G, x)
    return {'bank': bank, 'acc_group_nf6': group6[bank['acc_group']],
            'acc_group_nf6_g1': group6[1],
            'upper_bound': ub, 'upper_bound_host': ub_host,
            'power_iteration_lmax': power, 'power_s': power_s,
            'lanczos_lmax': lanczos, 'power_gap': gap,
            'spmm_one_column': one_column, 'difference': diff}, other


def phase_path_g_b(G, Lb, x):
    """Path G on path B's banded operator: a SimpleTight bank of 6 through
    ``cheby_op``, then ``cheby_synthesis`` of its output, each against the
    SciPy f64 recurrence; the symbols launched are counted, so that the
    synthesis contraction at Nf = 6 is seen to run."""
    log('phase G: path G on path B\'s banded operator')
    g = gsp.filters.SimpleTight(G, Nf=NF_ZOO)
    c = cheby_coeff(g.evaluate, G.lmax, m=ORDER)
    g_rule = group_of(Lb, x, nf=NF_ZOO)
    symbols = {}
    launch = _cuda.launch

    def spy(name, symbol, *args):
        symbols[symbol] = symbols.get(symbol, 0) + 1
        return launch(name, symbol, *args)

    reset_counts()
    _cuda.launch = spy
    try:
        out, launches, per_bank = run_bank(
            lambda: cheby_op(Lb, G.lmax, c, x))
        zoo_bank('G on B', per_bank, g_rule, 'banded_spmm')
        coeffs = out.permute(1, 2, 0).contiguous()           # (N, S, Nf)
        syn, launches, per_syn = run_bank(
            lambda: cheby_synthesis(Lb, G.lmax, c, coeffs))
    finally:
        _cuda.launch = launch
    log(f'  analysis {per_bank}; synthesis {per_syn}; symbols {symbols}')
    want = {'banded_spmm': ORDER, 'cheby_step': ORDER - 1,
            'cheby_acc_contract': ORDER - 1}
    if any(per_syn[k] != n for k, n in want.items()):
        raise AssertionError(f'path G on B, synthesis: {per_syn}')
    if symbols.get('cheby_acc_contract_f32', 0) != ORDER - 1:
        raise AssertionError(f'path G on B: symbols {symbols}')
    L_host = G.L.to_scipy()
    c64 = cheby_coeff(g.evaluate, G.lmax, m=ORDER, dtype=torch.float64,
                      device='cpu').numpy()
    rel_err = validate_path('G (SimpleTight on B)',
                            reference(L_host, G.lmax, g.evaluate, x), out)
    # the synthesis of the kernel's own analysis, 8 signals: filter f's
    # coefficients applied to filter f's columns, summed
    cols = coeffs[:, :N_CHECK_COLS].double().cpu().numpy()
    r = scipy_recurrence(L_host, G.lmax, c64,
                         cols.transpose(0, 2, 1).reshape(G.N, -1))
    syn_ref = sum(r[f][:, f * N_CHECK_COLS:(f + 1) * N_CHECK_COLS]
                  for f in range(NF_ZOO))
    syn_err = check('path G synthesis on B vs scipy f64',
                    syn[:, :N_CHECK_COLS], torch.from_numpy(syn_ref),
                    TOL_PATH)
    del out, syn
    ms = time_ms(lambda: cheby_op(Lb, G.lmax, c, x), 3)
    ms_syn = time_ms(lambda: cheby_synthesis(Lb, G.lmax, c, coeffs), 3)
    log(f'  {ms:.3f} ms per bank of {NF_ZOO}, synthesis {ms_syn:.3f} ms')
    del coeffs
    torch.cuda.empty_cache()
    # each kernel at the shapes this path gave it that no other phase
    # holds: the groups at Nf = 6, the contraction, and the synthesis's
    # SpMM and step on (N, S·Nf)
    s, f32 = x.shape[1], torch.float32
    held = {f'cheby_acc_group_g{g}': measure_group(G.N, s, NF_ZOO, f32, f32, g)
            for g in (g_rule, 1)}
    held['cheby_acc_contract'] = measure_contract(G.N, s, NF_ZOO)
    held['cheby_step'] = measure_step(G.N, s * NF_ZOO, f32, f32,
                                      windowed=False)
    held['banded_spmm'] = measure_banded_wide(Lb.offdiag, s * NF_ZOO)
    torch.cuda.empty_cache()
    return {'design': 'SimpleTight', 'nf': NF_ZOO, 'ms_per_bank': ms,
            'synthesis_ms': ms_syn, 'rel_err': rel_err,
            'synthesis_rel_err': syn_err, 'acc_group': g_rule,
            'symbols': symbols, 'kernels': held}, launches


def phase_path_g_lobpcg():
    """``partial_fourier_basis`` (LOBPCG, k = 4) in f64 on the card, and
    ``compute_fourier_basis(4)``, which dispatches to it, against host
    ``eigsh(which='SM')``."""
    log(f'phase G: LOBPCG on Grid2d{LOBPCG_GRID}, f64')
    G = gsp.graphs.Grid2d(*LOBPCG_GRID, dtype=torch.float64)
    t0 = time.time()
    er, Ur = spl.eigsh(G.L.to_scipy(), LOBPCG_K + 1, which='SM')
    eigsh_s = time.time() - t0
    if not np.diff(er).min() > 1e-4:
        raise AssertionError(f'the smallest eigenvalues are not simple: {er}')
    er, Ur = er[:LOBPCG_K], Ur[:, :LOBPCG_K]
    reset_counts()
    t0 = time.time()
    e, U = partial_fourier_basis(G.L, LOBPCG_K)
    torch.cuda.synchronize()
    first_s = time.time() - t0
    launches = counts()
    G.compute_fourier_basis(n_eigenvectors=LOBPCG_K)
    out = {'n': G.N, 'k': LOBPCG_K, 'first_call_s': first_s,
           'eigsh_s': eigsh_s}
    for name, (ee, UU) in (('partial_fourier_basis', (e, U)),
                           ('compute_fourier_basis', (G.e, G.U))):
        ee, UU = ee.cpu().numpy(), UU.cpu().numpy()
        err_e = float(np.abs(ee - er).max())
        err_u = float(np.abs(np.diag(np.abs(UU.T @ Ur)) - 1).max())
        log(f'  {name}: eigenvalues {err_e:.3e} from eigsh (tol '
            f'{TOL_LOBPCG_E}), alignment {err_u:.3e} (tol {TOL_LOBPCG_U})')
        if not (err_e <= TOL_LOBPCG_E and err_u <= TOL_LOBPCG_U
                and ee[0] == 0.0):
            raise AssertionError(f'{name}: {err_e}, {err_u}, {ee}')
        out[f'{name}_err'] = [err_e, err_u]
    out['ms'] = time_ms(lambda: partial_fourier_basis(G.L, LOBPCG_K), 1)
    log(f'  {out["ms"]:.1f} ms a call; launches {launches}')
    # its SpMM in f64 at the widths it takes: the probe and the bound (1),
    # the block (k) and the Rayleigh-Ritz basis (3k)
    out['spmm'] = {
        str(w): measure_spmm(f'csr_spmm at LOBPCG\'s shape, {w} columns f64',
                             G.L.offdiag, seeded_normal(
                                 (G.N, w), 93, dtype=torch.float64),
                             FP64_FLOPS, TOL_F64)
        for w in (1, LOBPCG_K, 3 * LOBPCG_K)}
    return out, launches


def heat_host(e, scale, lmax):
    return np.minimum(np.exp(-scale * e / lmax), 1.0)


def coefficients(g, lmax, edges, tol):
    """The f32 Chebyshev coefficients ``filter()`` computes on the card,
    held against f64 ones on the host within ``tol`` (relative to the
    largest). A quadrature node where the f32 and f64 kernels differ by a
    jump (more than 1/2) must lie within f32 rounding (1e-6 · lmax) of one
    of ``edges``, the band edges of a discontinuous kernel (Rectangular's),
    where the f32 node may fall on the other side: there the f64 reference
    takes the f32 kernel's value. Returns ``(c, gap, nodes at a jump)``."""
    sampled = {}

    def at(dtype):
        def evaluate(lam):
            sampled[dtype] = (lam, torch.atleast_2d(g.evaluate(lam)))
            return sampled[dtype][1]
        return evaluate

    c = cheby_coeff(at(torch.float32), lmax, m=ORDER, dtype=torch.float32)
    cheby_coeff(at(torch.float64), lmax, m=ORDER, dtype=torch.float64,
                device='cpu')
    lam, k64 = sampled[torch.float64]
    k32 = sampled[torch.float32][1].cpu().double()
    jump = (k32 - k64).abs() > 0.5
    for v in (lam[jump.any(0)] / lmax).tolist():
        if not any(abs(v - e) <= 1e-6 for e in edges):
            raise AssertionError(f'the f32 kernel jumps at λ/lmax = {v}, not '
                                 f'at a band edge {edges}')
    k64 = torch.where(jump, k32, k64)
    c64 = cheby_coeff(lambda _: k64, lmax, m=ORDER, dtype=torch.float64,
                      device='cpu')
    gap = float((c.cpu().double() - c64).abs().max() / c64.abs().max())
    log(f'    f32 coefficients {gap:.3e} from f64 (tol {tol}), '
        f'{int(jump.sum())} nodes at a band edge')
    if not gap <= tol:
        raise AssertionError(f'f32 coefficients {gap} from f64 (tol {tol})')
    return c, gap, int(jump.sum())


def phase_path_g_designs():
    """Every design at tests/test_filters.py's parameters on Grid2d(64, 64)
    in f32, through ``Filter.filter``, each against the SciPy f64
    recurrence of its own (f32) coefficients, and those against f64 ones
    (``coefficients``); the kernels at the shapes the designs gave them;
    then ``Gabor`` (exact) against host f64 ``eigh`` filtering, and
    ``Modulation`` against the same formula in f64 on the host, on the
    card's own Fourier basis (a basis of the square grid is fixed only up
    to rotations within its repeated eigenvalues, and Modulation's atoms
    depend on it)."""
    log(f'phase G: the filter zoo on Grid2d({EXACT_SIDE}, {EXACT_SIDE})')
    G = gsp.graphs.Grid2d(EXACT_SIDE, EXACT_SIDE)
    G.estimate_lmax()
    x = seeded_normal((G.N, N_SIGNALS), 91)
    x8 = x[:, :N_CHECK_COLS].double().cpu().numpy()
    L_host = G.L.to_scipy()
    reset_counts()
    errs, groups = {}, set()
    for name, kwargs in ZOO:
        g = getattr(gsp.filters, name)(G, **kwargs)
        g_rule = group_of(G.L, x, nf=g.Nf)
        groups.update({(g.Nf, g_rule), (g.Nf, 1)})
        out, _, per_bank = run_bank(lambda: g.filter(x, order=ORDER))
        zoo_bank(f'G ({name})', per_bank, g_rule)
        out = out.reshape(G.N, N_SIGNALS, g.Nf).permute(2, 0, 1)
        # the recurrence is held to f64 on the coefficients filter()
        # computes, in f32: a kernel such as Regular's complement √(1 − g²)
        # rounds in f32 well above the recurrence's error
        edges = ([b for b in (g.band_min, g.band_max) if b is not None]
                 if name == 'Rectangular' else [])
        label = f'{name} {json.dumps(kwargs)}'
        c, gap, at_edge = coefficients(
            g, G.lmax, edges,
            TOL_COEFF_REGULAR if name == 'Regular' else TOL_COEFF)
        ref = scipy_recurrence(L_host, G.lmax, c.double().cpu().numpy(), x8)
        errs[label] = [validate_path(f'G ({label})', torch.from_numpy(ref),
                                     out), gap, at_edge]
    launches = counts()
    f32 = torch.float32
    held = {'csr_spmm': measure_spmm(
                f'csr_spmm at Grid2d({EXACT_SIDE}, {EXACT_SIDE})',
                G.L.offdiag, x),
            'cheby_step': measure_step(G.N, N_SIGNALS, f32, f32,
                                       windowed=False),
            'cheby_acc_group': {f'nf{nf}_g{gr}': measure_group(
                G.N, N_SIGNALS, nf, f32, f32, gr)
                for nf, gr in sorted(groups)}}

    t0 = time.time()
    G.compute_fourier_basis()
    basis_s = time.time() - t0
    e, U = np.linalg.eigh(L_host.astype(np.float64).toarray())
    mother = gsp.filters.Heat(G, scale=20)
    out = gsp.filters.Gabor(G, mother).filter(x[:, :N_CHECK_COLS],
                                              method='exact')
    cols = np.arange(0, G.N, GABOR_STRIDE)
    x_hat = U.T @ x8
    ref = np.stack([U @ (heat_host(e - e[j], 20, G.lmax)[:, None] * x_hat)
                    for j in cols], axis=-1)
    errs['Gabor (exact)'] = check('path G Gabor vs host f64 eigh',
                                  out[:, :, cols].cpu(),
                                  torch.from_numpy(ref), TOL_PATH)
    del out
    Uc = G.U.double().cpu().numpy()
    ec = G.e.double().cpu().numpy()
    out = gsp.filters.Modulation(G, mother).filter(x[:, 0])
    gL = Uc @ (heat_host(ec, 20, G.lmax)[:, None] * Uc.T)
    ref = (x8[None, :, 0] * (np.sqrt(G.N) * gL.T)) @ Uc * np.sqrt(G.N)
    errs['Modulation (exact)'] = check(
        'path G Modulation vs the host f64 formula on the card\'s basis',
        out.cpu(), torch.from_numpy(ref), TOL_PATH)
    return {'n': G.N, 'designs': len(ZOO) + 2, 'rel_err': errs,
            'basis_s': basis_s, 'kernels': held}, launches


# ---------------------------------------------------------------------------
# paths H and I: the hybrid ELL and chunked formats, on their SpMM kernels
# ---------------------------------------------------------------------------

def slot_operands(M):
    """The SpMM kernel of an ELL or chunked matrix and its operands
    ``(table, cols, vals, residue)``."""
    if isinstance(M, gsp.core.sparse.ELLMatrix):
        return ell_kernel.ell_spmm, (M.table, M.ell_cols.reshape(-1),
                                     M.ell_vals.reshape(-1), M.residue)
    return ell_kernel.chunked_spmm, (M.table, M.slot_cols, M.slot_vals,
                                     M.residue)


def slot_bytes(M):
    """The bytes of the kernel's operands that a product reads once: the
    slots' columns and values (padding included) and the overflow list."""
    _, (_, cols, vals, res) = slot_operands(M)
    out = cols.numel() * (4 + vals.element_size())
    if res is not None:
        out += ((res.rowptr.numel() + res.entptr.numel() + res.cols.numel())
                * 4 + res.vals.numel() * res.vals.element_size())
    return out


def slot_work(M, s, item):
    """The bound of one product ``M @ v``, v (n_cols, s) of ``item``-byte
    values: v read once, y written once, the operands once, two operations
    per stored entry and column; beside it the gather model, in which each
    stored entry reads its x row."""
    ops = slot_bytes(M)
    return {**bound((M.n_cols + M.n_rows) * s * item + ops, 2 * M.nnz * s),
            'bound_gather_ms': ((M.nnz + M.n_rows) * s * item + ops)
            / HBM_BYTES_PER_S * 1e3}


def slot_csr(M, dtype):
    """The off-diagonal of a sparse matrix of the port (ELL, chunked,
    banded) as a sparse CSR tensor on the card: ``torch.sparse.mm``'s
    operand, the library yardstick (the port never calls it)."""
    csr = sps.csr_matrix(gsp.core.to_scipy(M))
    return torch.sparse_csr_tensor(
        torch.from_numpy(csr.indptr.astype(np.int64)).to('cuda'),
        torch.from_numpy(csr.indices.astype(np.int64)).to('cuda'),
        torch.from_numpy(csr.data).to('cuda', dtype), size=csr.shape)


def slot_yardsticks(M, x, lib):
    """The bound and gather model of ``M @ x`` on its slot kernel, in x's
    and the values' element sizes, and ``torch.sparse.mm``'s time for it on
    ``lib`` (:func:`slot_csr`); None where no single PyTorch call computes
    it (x and values of two dtypes)."""
    if lib is None:
        return {**slot_work(M, x.shape[1], x.element_size()),
                'library_ms': None,
                'library': 'none: no single PyTorch call takes x and values '
                           'of two dtypes'}
    return {**slot_work(M, x.shape[1], x.element_size()),
            'library_ms': time_ms(lambda: torch.sparse.mm(lib, x), 20),
            'library': 'torch.sparse.mm on a sparse CSR tensor of the same '
                       'off-diagonal'}


def slot_layout(M):
    """What the wide entry walks a row: its positions (dense slots, dead
    padding included) and overflow slots, their mean and largest count a
    row, and the share of them that are live (the stored entries)."""
    _, (table, cols, _, res) = slot_operands(M)
    rows = torch.arange(M.n_rows, device=cols.device) // table.chunk_rows
    per_row = (table.chunk_ptr[rows + 1] - table.chunk_ptr[rows]).long()
    if res is not None:
        ent = res.entptr.long()
        per_row = per_row + ent[res.rowptr[1:].long()] - ent[
            res.rowptr[:-1].long()]
    walked = int(per_row.sum())
    return {'positions_per_row_mean': walked / M.n_rows,
            'positions_per_row_max': int(per_row.max()),
            'live_share': M.nnz / walked}


def dead_to_inf(M):
    """A copy of the kernel's slot values with every dead (sentinel) slot's
    value set to inf."""
    _, (table, cols, vals, res) = slot_operands(M)
    vals = vals.clone()
    for i, off, width, _, limit in table.blocks:
        n = (M.n_rows if isinstance(M, gsp.core.sparse.ELLMatrix)
             else M.out_chunk_size(i)) * width
        part = vals[off:off + n]
        part[cols[off:off + n] >= limit] = float('inf')
    return vals


def hold_slot(name, M, x, want_dtype=None):
    """The SpMM kernel of ``M`` on x (the matrix's internal order) against
    its plain version: outputs in f32 or f64 within TOL_SLOT of the plain
    version in f64 (on the card it sums in no fixed order), bf16 outputs
    within TOL_BF16_ULPS of the plain version in the same types; two
    launches bit-equal; inf behind every dead slot changes nothing.
    Returns ``{'max_abs_err', 'rel_err' or 'ulps', 's', 'dtype'}``."""
    kernel, (table, cols, vals, res) = slot_operands(M)
    y = kernel(table, cols, vals, res, x, M.n_rows)
    out = {'s': x.shape[1], 'dtype': f'{x.dtype}/{vals.dtype}'}
    if x.dtype == torch.bfloat16:
        want = ell_kernel.slot_spmm_plain(table, cols, vals, res, x,
                                          M.n_rows)
        out['ulps'] = ulps(y, want)
        log(f'  {name} {out["dtype"]} S={x.shape[1]}: {out["ulps"]:.2f} '
            f'bf16 ulps from the plain version (tol {TOL_BF16_ULPS})')
        if not out['ulps'] <= TOL_BF16_ULPS:
            raise AssertionError(f'{name}: {out["ulps"]} bf16 ulps')
    else:
        r64 = None if res is None else res._replace(vals=res.vals.double())
        want = ell_kernel.slot_spmm_plain(table, cols, vals.double(), r64,
                                          x.double(), M.n_rows)
        tol = TOL_F64 if x.dtype == torch.float64 else TOL_SLOT
        out['rel_err'] = check(f'{name} {out["dtype"]} S={x.shape[1]} vs '
                               f'plain (f64)', y, want, tol)
    out['max_abs_err'] = float((y.double() - want.double()).abs().max())
    del want
    if not torch.equal(y, kernel(table, cols, vals, res, x, M.n_rows)):
        raise AssertionError(f'{name}: two launches differ')
    if not torch.equal(y, kernel(table, cols, dead_to_inf(M), res, x,
                                 M.n_rows)):
        raise AssertionError(f'{name}: inf behind the dead slots changed y')
    log(f'  {name} S={x.shape[1]}: two launches bit-equal, dead slots of '
        f'inf add nothing')
    out['ms'] = time_ms(lambda: kernel(table, cols, vals, res, x, M.n_rows),
                        10)
    return out


def measure_slot(name, M, x, lib):
    """The SpMM kernel of ``M`` at x's shape: held against its plain
    version (``hold_slot``), then timed beside it, its device time, its
    bound and gather model, and ``torch.sparse.mm`` on ``lib``, the same
    off-diagonal in CSR, or None (:func:`slot_yardsticks`)."""
    kernel, args = slot_operands(M)
    out = hold_slot(name, M, x)
    # the device time of a call (the heavy rows' kernel on the side stream
    # runs beside the rows')
    out.update(
        ms=time_ms(lambda: kernel(*args, x, M.n_rows), 20),
        device_ms=graph_ms(lambda: kernel(*args, x, M.n_rows), 20),
        device_ms_by='a CUDA graph of 20 calls, replayed',
        plain_ms=time_ms(lambda: ell_kernel.slot_spmm_plain(
            *args, x, M.n_rows), 2),
        **slot_yardsticks(M, x, lib),
        shape=[M.n_rows, M.n_cols], nnz=M.nnz, dense_slots=args[1].numel(),
        overflow_slots=0 if args[3] is None else args[3].cols.numel(),
        heavy_rows=0 if args[3] is None else args[3].heavy.numel())
    log(f'  {name}: {json.dumps(out)}')
    return out


def measure_narrow(name, M, x, lib=None):
    """The narrow entry of ``M``'s kernel at x's width (the entry the
    wrapper takes there): held against the plain version (``hold_slot``),
    then timed beside the wide entry (the kernel at every width before the
    narrow entry) in turns, each also by its device time (``graph_ms``),
    beside ``torch.sparse.mm`` on ``lib`` (None: no single PyTorch call
    computes the pair, x and values of two dtypes) and the bound.
    """
    kernel, args = slot_operands(M)
    if ell_kernel.entry_for(x.shape[1], x.dtype) != 'narrow':
        raise AssertionError(f'{name}: S={x.shape[1]} of {x.dtype} is not '
                             f'a narrow width')
    out = hold_slot(name, M, x)

    def run(entry):
        return ell_kernel.spmm_entry(kernel.__name__, entry, *args, x,
                                     M.n_rows)

    # the host's launch costs, which set a small graph's call time, vary
    # between calls: more calls there
    iters = 200 if M.n_rows <= 1 << 16 else 20
    times = {'narrow': [], 'wide': []}
    for entry in ('narrow', 'wide', 'wide', 'narrow'):
        times[entry].append(time_ms(lambda: run(entry), iters))
    out.update(ms=sum(times['narrow']) / 2, wide_ms=sum(times['wide']) / 2,
               device_ms=graph_ms(lambda: run('narrow'), 20),
               wide_device_ms=graph_ms(lambda: run('wide'), 20),
               plain_ms=time_ms(lambda: ell_kernel.slot_spmm_plain(
                   *args, x, M.n_rows), 2),
               **slot_work(M, x.shape[1], x.element_size()))
    out.update(library_ms=None, library_device_ms=None, library=None)
    if lib is not None:
        out.update(library_ms=time_ms(lambda: torch.sparse.mm(lib, x), 20),
                   library_device_ms=graph_ms(
                       lambda: torch.sparse.mm(lib, x), 20),
                   library='torch.sparse.mm on a sparse CSR tensor of the '
                           'same off-diagonal')
    log(f'  {name}: {json.dumps(out)}')
    return out


def measure_narrow_widths(path, M, x, lib, widths=(1, 8)):
    """``measure_narrow`` at each width, x's first columns: ``{'<s>_<dtype>':
    numbers}``."""
    return {f'{s}_{str(x.dtype)[6:]}': measure_narrow(
        f'{path} narrow', M, x[:, :s].contiguous(), lib) for s in widths}


def count_index_add(bank):
    """``run_bank(bank)``, with every ``index_add_`` and ``index_add``
    that PyTorch runs in it counted: ``(out, launches, per_bank,
    n_index_add)``."""
    calls = [0]
    method, function = torch.Tensor.index_add_, torch.index_add

    def spy_method(self, *args, **kwargs):
        calls[0] += 1
        return method(self, *args, **kwargs)

    def spy_function(*args, **kwargs):
        calls[0] += 1
        return function(*args, **kwargs)

    torch.Tensor.index_add_, torch.index_add = spy_method, spy_function
    try:
        out, launches, per_bank = run_bank(bank)
    finally:
        torch.Tensor.index_add_, torch.index_add = method, function
    return out, launches, per_bank, calls[0]


def require_slot_bank(path, kernel, per_bank, n_index_add):
    """Raise unless the bank launched ``kernel`` once per SpMM (ORDER) and
    no other SpMM: no CSR kernel, no plain version, no index_add_."""
    if per_bank[kernel] != ORDER:
        raise AssertionError(f'path {path}: {per_bank[kernel]} {kernel} '
                             f'launches in one bank, not {ORDER}')
    if per_bank['csr_spmm'] or per_bank['slot_plain'] or n_index_add:
        raise AssertionError(
            f'path {path}: the bank ran csr_spmm {per_bank["csr_spmm"]}, '
            f'the plain SpMM {per_bank["slot_plain"]} and index_add_ '
            f'{n_index_add} times')
    require_launches(path, per_bank, cheby_step=ORDER - 1, cheby_acc_group=1)


def slot_bank_path(path, fmt, kernel, n=N_BA):
    """A bank path on BA(n) with ``compute_laplacian(fmt=fmt)``: the bank
    through ``kernel`` against the SciPy f64 recurrence, timed. Returns
    ``(G, g, x, ref, path_numbers, (launches, per_bank))``."""
    G, g, x, bank = bench_graph(fmt, n)
    torch.cuda.reset_peak_memory_stats()
    out, launches, per_bank, n_add = count_index_add(bank)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f'  launches on the path {launches}, per bank {per_bank}, '
        f'index_add_ {n_add}; peak device memory {peak:.2f} GiB')
    require_slot_bank(path, kernel, per_bank, n_add)
    # λmax's Lanczos products at one column take the narrow entry, the
    # bank's at 128 columns the wide one
    lmax_launches = {k: launches[k] - per_bank[k] for k in launches}
    require_narrow(f'{path} (estimate_lmax)', lmax_launches, kernel)
    if per_bank[f'{kernel}_wide'] != ORDER:
        raise AssertionError(f'path {path} bank: {per_bank[kernel]} '
                             f'launches, {per_bank[kernel + "_wide"]} wide')
    if tuple(out.shape) != (n, N_SIGNALS, len(SCALES)):
        raise AssertionError(f'path {path} output shape {tuple(out.shape)}')
    ref = reference(sps.diags(G.dw) - G.W, G.lmax, g.evaluate, x,
                    key=('bench', G.N, G.lmax))
    rel_err = validate_path(path, ref, out.permute(2, 0, 1))
    del out
    ms_bank = time_ms(bank, 3)
    nnz = G.L.offdiag.nnz
    log(f'  {ms_bank:.3f} ms per bank, '
        f'{ORDER * nnz * N_SIGNALS / (ms_bank / 1e3):.4e} edge-ops/s')
    numbers = {'ms_per_bank': ms_bank, 'rel_err': rel_err, 'nnz': nnz,
               'n': n, 'lmax': G.lmax, 'peak_bank_gib': peak,
               'edge_ops_per_s': ORDER * nnz * N_SIGNALS / (ms_bank / 1e3),
               'acc_group': group_of(G.L, x),
               'estimate_lmax_launches': {
                   k: lmax_launches[k] for k in (kernel, f'{kernel}_narrow',
                                                 f'{kernel}_wide')},
               **lmax_timing(G.L, kernel)}
    return G, g, x, ref, numbers, (launches, per_bank)


def lmax_timing(L, kernel, repeats=5):
    """``estimate_lmax_lanczos(L)`` timed ``repeats`` times, one call each
    after a warm-up call (``estimate_lmax_ms``: the median;
    ``estimate_lmax_ms_all``: every time, sorted), and in one more call the
    device time of its ``kernel`` launches, each between two CUDA events
    (``lmax_products_ms``: their sum; ``lmax_products``: how many)."""
    def run():
        return estimate_lmax_lanczos(L)

    times = sorted(time_ms(run, 1) for _ in range(repeats))
    events = []
    launch = _cuda.launch

    def spy(name, symbol, *args):
        if not symbol.startswith(kernel):
            return launch(name, symbol, *args)
        pair = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        pair[0].record()
        out = launch(name, symbol, *args)
        pair[1].record()
        events.append(pair)
        return out

    _cuda.launch = spy
    try:
        run()
    finally:
        _cuda.launch = launch
    torch.cuda.synchronize()
    out = {'estimate_lmax_ms': times[repeats // 2],
           'estimate_lmax_ms_all': times,
           'lmax_products_ms': sum(a.elapsed_time(b) for a, b in events),
           'lmax_products': len(events)}
    log(f'  estimate_lmax: {json.dumps(out)}')
    return out


def phase_path_h():
    """Path H, the hybrid ELL format: (a) ``fmt='auto'`` on BA(2^16), the
    largest graph it sends to hybrid; (b) path A's graph with
    ``fmt='hybrid'``; both banks against SciPy f64, 30 ``ell_spmm``
    launches and no other SpMM a bank; the kernel held and timed at the
    bank's shape, at one column (λmax's Lanczos, the upper bound) and in
    f64 at 5; (c) ``fmt='auto'`` on four zoo graphs at their default
    sizes, a one-filter bank each against SciPy f64 and the kernel held at
    its shape."""
    log('phase H: path H, the hybrid ELL format (ell_spmm)')
    result, held, counts_h = {}, {}, {}
    reset_counts()
    G, _, x, _, result['auto_2^16'], (counts_h['H_auto'], _) = (
        slot_bank_path('H (auto, 2^16)', 'auto', 'ell_spmm', n=1 << 16))
    if not isinstance(G.L.offdiag, gsp.core.sparse.ELLMatrix):
        raise AssertionError(f'fmt=auto on 2^16 vertices gave '
                             f'{type(G.L.offdiag).__name__}')
    held['auto_2^16'] = hold_slot('ell_spmm at 2^16', G.L.offdiag, x)
    lib = slot_csr(G.L.offdiag, x.dtype)
    held['auto_2^16'].update(slot_yardsticks(G.L.offdiag, x, lib))
    narrow = {'auto_2^16': measure_narrow_widths('H at 2^16', G.L.offdiag,
                                                 x, lib)}
    del G, x, lib
    torch.cuda.empty_cache()

    reset_counts()
    G, _, x, _, result['hybrid'], bank_counts = slot_bank_path(
        'H', 'hybrid', 'ell_spmm')
    M = G.L.offdiag
    result['layout'] = {
        'ell_width': M.ell_width, 'level_widths': [
            lev.cols.shape[1] for lev in M.levels],
        'level_rows': [lev.rows.numel() for lev in M.levels],
        'slots': M.ell_cols.numel() + sum(lev.cols.numel()
                                          for lev in M.levels),
        'overflow_live_slots': M.residue.cols.numel(),
        'heavy_rows': M.residue.heavy.numel(), **slot_layout(M)}
    log(f'  layout: {json.dumps(result["layout"])}')
    lib = slot_csr(M, x.dtype)
    kernel = measure_slot('ell_spmm at path H', M, x, lib)
    narrow['H'] = measure_narrow_widths('H', M, x, lib)
    del lib
    M64 = M.astype(torch.float64)
    lib64 = slot_csr(M64, torch.float64)
    # the wide entry's other operand pair at the bank's width
    held['f64'] = measure_slot('ell_spmm f64 at path H', M64, x.double(),
                               lib64)
    narrow['H'].update(measure_narrow_widths(
        'H', M64, x[:, :5].double(), lib64, widths=(5,)))
    del M64, lib64
    ub = float(laplacian_upper_bound(G.L))
    ub_host = float(np.max(np.ravel(abs(G.L.to_scipy().astype(
        np.float64)).sum(axis=1))))
    if abs(ub - ub_host) > 1e-6 * ub_host:
        raise AssertionError(f'laplacian_upper_bound {ub} != {ub_host}')
    result['upper_bound'] = ub
    del M
    torch.cuda.empty_cache()
    result['M'], counts_h['M_H'] = phase_path_m('H', G.L, G.lmax, x)
    result['N'], counts_h['N_H'] = phase_path_n('H', G.L, G.lmax, x)
    del G, x
    torch.cuda.empty_cache()

    # the zoo's launches: each graph's λmax and bank, without the holds and
    # timings after them
    zoo, zoo_launches = {}, {}
    reset_counts()
    for name, kw in (('Minnesota', {}), ('Airfoil', {}),
                     ('StochasticBlockModel', dict(N=1024, seed=42)),
                     ('Community', dict(N=256, seed=42))):
        before = counts()
        Gz = getattr(gsp.graphs, name)(**kw)
        Gz.compute_laplacian(fmt='auto')
        if not isinstance(Gz.L.offdiag, gsp.core.sparse.ELLMatrix):
            raise AssertionError(f'{name}: fmt=auto gave '
                                 f'{type(Gz.L.offdiag).__name__}')
        _, _, lmax_launches = run_bank(Gz.estimate_lmax)
        require_narrow(f'H ({name}, estimate_lmax)', lmax_launches,
                       'ell_spmm')
        gz = gsp.filters.Heat(Gz, scale=10)
        xz = seeded_normal((Gz.N, N_CHECK_COLS), 95)
        out = gz.filter(xz, method='chebyshev', order=ORDER)
        torch.cuda.synchronize()
        after = counts()
        zoo_launches = {k: zoo_launches.get(k, 0) + after[k] - before[k]
                        for k in after}
        ref = reference(sps.diags(Gz.dw) - Gz.W, Gz.lmax, gz.evaluate, xz)
        zoo[name] = {'n': Gz.N, 'nnz': Gz.L.offdiag.nnz,
                     'rel_err': validate_path(
                         f'H ({name})', ref, out.reshape(
                             Gz.N, N_CHECK_COLS, -1).permute(2, 0, 1)),
                     'held': hold_slot(f'ell_spmm on {name}',
                                       Gz.L.offdiag, xz)}
        narrow[name] = measure_narrow_widths(
            f'H ({name})', Gz.L.offdiag, xz,
            slot_csr(Gz.L.offdiag, xz.dtype))
    counts_h['H_zoo'] = zoo_launches
    result['zoo'] = zoo
    kernel['at_paths'] = held
    return kernel, narrow, result, bank_counts, counts_h


def phase_path_i():
    """Path I, the chunked format: path A's graph with
    ``fmt='chunked'``; the bank against SciPy f64, 30 ``chunked_spmm``
    launches and no other SpMM; the kernel held and timed at the bank's
    shape, held at one column (the upper bound, λmax's Lanczos), in every
    bf16 pair and at the x̄ synthesis's 512 columns; the fast mode
    (``carry_dtype`` and ``vals_dtype`` bf16) within TOL_PATH_BF16 on the
    first filter and 2 × ``carry_error_estimate`` on all four; then one
    forward and backward through the fixed-graph VJP with its checks (as
    on path E) and one Adam step through ``Filter.filter(fixed_graph=
    True)``."""
    log('phase I: path I, the chunked format (chunked_spmm)')
    reset_counts()
    G, g, x, ref, result, bank_counts = slot_bank_path('I', 'chunked',
                                                       'chunked_spmm')
    M = G.L.offdiag
    result['layout'] = {
        'blocks': len(M.blocks), 'block_widths': sorted(
            {b.cols.shape[1] for b in M.blocks}),
        'slots': M.slot_cols.numel(), 'tiers': len(M.levels),
        'tier_slots': sum(lev.cols.numel() for lev in M.levels),
        'tier_entries': M.level_rows.numel(),
        'overflow_live_slots': M.residue.cols.numel(),
        'heavy_rows': M.residue.heavy.numel(), **slot_layout(M)}
    log(f'  layout: {json.dumps(result["layout"])}')
    lib = slot_csr(M, x.dtype)
    kernel = measure_slot('chunked_spmm at path I', M, x, lib)
    narrow = {'I': measure_narrow_widths('I', M, x, lib)}
    held = {}
    for combo, (xd, vd) in BF16_FOLDS.items():
        # every wide operand pair at the bank's width, timed; torch.sparse.mm
        # takes bf16 x on bf16 values, no call takes the mixed pairs
        lib_pair = slot_csr(M, xd) if xd == vd else None
        held[f'bf16_{combo}'] = measure_slot(f'chunked_spmm bf16 {combo}',
                                             M.astype(vd), x.to(xd),
                                             lib_pair)
        narrow['I'][f'bf16_{combo}_1'] = measure_narrow(
            f'I narrow bf16 {combo}', M.astype(vd),
            x[:, :1].to(xd).contiguous(), lib_pair)
        del lib_pair
    M64 = M.astype(torch.float64)
    lib64 = slot_csr(M64, torch.float64)
    held['f64'] = measure_slot('chunked_spmm f64 at path I', M64,
                               x.double(), lib64)
    narrow['I'].update(measure_narrow_widths(
        'I', M64, x[:, :5].double(), lib64, widths=(5,)))
    del M64, lib64
    xw = seeded_normal((M.n_cols, WIDE), 96)
    held['x_bar_width'] = hold_slot('chunked_spmm at the x_bar width', M, xw)
    held['x_bar_width'].update(slot_yardsticks(M, xw, lib))
    del xw, lib
    ub = float(laplacian_upper_bound(G.L))
    ub_host = float(np.max(np.ravel(abs(G.L.to_scipy().astype(
        np.float64)).sum(axis=1))))
    if abs(ub - ub_host) > 1e-6 * ub_host:
        raise AssertionError(f'laplacian_upper_bound {ub} != {ub_host}')
    result['upper_bound'] = ub
    torch.cuda.empty_cache()

    # the fast mode: the bf16 instance and a bf16 carry through kernel B
    c = cheby_coeff(g.evaluate, G.lmax, m=ORDER, device='cpu')
    est = carry_error_estimate(c, torch.bfloat16)
    symbols = {}
    launch = _cuda.launch

    def spy(name, symbol, *args):
        symbols[symbol] = symbols.get(symbol, 0) + 1
        return launch(name, symbol, *args)

    bank = fast_bank(g, x)
    reset_counts()
    _cuda.launch = spy
    try:
        out, fast_launches, fast_per_bank, n_add = count_index_add(bank)
    finally:
        _cuda.launch = launch
    log(f'  fast mode: per bank {fast_per_bank}, symbols {symbols}')
    require_slot_bank('I (fast mode)', 'chunked_spmm', fast_per_bank, n_add)
    if symbols.get('chunked_spmm_bf16', 0) != ORDER or any(
            s.startswith('chunked_spmm_f32') for s in symbols):
        raise AssertionError(f'path I fast mode: symbols {symbols}')
    out = out.permute(2, 0, 1)
    result['fast'] = {
        'carry_error_estimate': est,
        'rel_err': validate_path('I fast (first filter)', ref[:1], out[:1],
                                 TOL_PATH_BF16),
        'rel_err_all_filters': validate_path('I fast (all, 2 x the '
                                             'estimate)', ref, out, 2 * est),
        'ms_per_bank': time_ms(bank, 3), 'symbols': symbols}
    del out
    log(f'  fast mode: {json.dumps(result["fast"])}')
    torch.cuda.empty_cache()
    result['E'], counts_e = phase_path_e('I', G, None, x, 1,
                                         sps.diags(G.dw) - G.W)
    require_launches('E on I', counts_e, chunked_spmm=3 * ORDER,
                     **train_kernels(1))
    if counts_e['csr_spmm'] or counts_e['slot_plain']:
        raise AssertionError(f'path E on I ran csr_spmm or the plain SpMM: '
                             f'{counts_e}')
    torch.cuda.empty_cache()
    result['M'], counts_m = phase_path_m('I', G.L, G.lmax, x)
    result['N'], counts_n = phase_path_n('I', G.L, G.lmax, x)
    kernel['at_paths'] = held
    return kernel, narrow, result, bank_counts, {'I_fast': fast_launches,
                                                 'E_I': counts_e,
                                                 'M_I': counts_m,
                                                 'N_I': counts_n}


# ---------------------------------------------------------------------------
# path J: the algorithms (learning, optimization, reduction, features), the
# nearest-neighbour graphs and the solved layouts
# ---------------------------------------------------------------------------

def sensor_labels(G):
    """J_CLASSES labels by the angular sector around (0.5, 0.5), and a mask
    of J_LABEL_SHARE of the vertices drawn from a seeded generator."""
    xy = G.coords - 0.5
    angle = np.arctan2(xy[:, 1], xy[:, 0]) + np.pi
    labels = np.minimum((angle / (2 * np.pi) * J_CLASSES).astype(int),
                        J_CLASSES - 1)
    mask = np.random.default_rng(J_SEED).random(G.N) < J_LABEL_SHARE
    return labels, mask


def host_laplacian(G):
    """G's combinatorial Laplacian in f64 from the host adjacency."""
    return (sps.diags(G.dw) - G.W).tocsr()


def relative_residual(name, A, b, x, limit):
    """``‖b − A x‖ / ‖b‖`` over the whole block in f64 on the host; raises
    above ``limit``."""
    r = float(np.linalg.norm(b - A @ x) / np.linalg.norm(b))
    log(f'  {name}: true relative residual {r:.3e} (limit {limit:g})')
    if not r <= limit:
        raise AssertionError(f'{name}: relative residual {r} > {limit}')
    return r


def run_part(fn):
    """``fn()`` with every kernel's count set to 0 just before and read
    just after: ``(out, counts, ms)``, ms on the host clock."""
    reset_counts()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, counts(), (time.time() - t0) * 1e3


def phase_path_j_learning(G, labels, mask):
    """J1: the three learning solvers on the million-vertex sensor graph,
    each CG held by its true relative residual on the host in f64, the
    simplex rows on the simplex."""
    from pygsp_tpu_torch import learning
    L64 = host_laplacian(G)
    out, parts = {}, {}
    unknown = ~mask
    # classification_tikhonov: one CG over the (N, 8) block, M + τL
    y = np.where(mask, labels, 0)
    scores, c, ms = run_part(lambda: learning.classification_tikhonov(
        G, y, mask, tau=J_TAU))
    Y = np.zeros((G.N, J_CLASSES))
    Y[np.arange(G.N), y] = 1.0
    Y *= mask[:, None]
    A = sps.diags(mask.astype(float)) + J_TAU * L64
    iters = c['csr_spmm'] - 1
    out['classification'] = {
        'ms': ms, 'iterations': iters, 'csr_spmm_launches': c['csr_spmm'],
        'width': J_CLASSES, 'rel_residual': relative_residual(
            'classification_tikhonov', A, Y,
            scores.double().cpu().numpy(), TOL_CG_RESIDUAL)}
    parts['J1_classification'] = c
    # regression_tikhonov, τ = 0, one column: L_uu x_u = W_ul y_l
    f = np.sin(2 * np.pi * G.coords[:, 0]) * np.cos(2 * np.pi * G.coords[:, 1])
    sol, c, ms = run_part(lambda: learning.regression_tikhonov(
        G, f, mask, tau=0))
    sol = sol.double().cpu().numpy()
    if not np.array_equal(sol[mask], f[mask].astype(np.float32)):
        raise AssertionError('regression_tikhonov changed a labelled value')
    Luu = L64[unknown][:, unknown]
    b = -(L64[unknown][:, mask] @ sol[mask])
    require_narrow('J1 regression_tikhonov(tau=0), one column', c)
    iters = c['csr_spmm'] - 2
    if iters >= J_MAXITER_TAU0:
        raise AssertionError(f'regression_tikhonov stopped at maxiter '
                             f'{J_MAXITER_TAU0}')
    out['regression_tau0'] = {
        'ms': ms, 'iterations': iters, 'csr_spmm_launches': c['csr_spmm'],
        'width': 1, 'rel_residual': relative_residual(
            'regression_tikhonov(tau=0)', Luu, b, sol[unknown],
            TOL_CG_RESIDUAL)}
    parts['J1_regression'] = c
    # classification_tikhonov_simplex: projected FBS, one matvec a step
    simplex, c, ms = run_part(lambda: learning.classification_tikhonov_simplex(
        G, y, mask, tau=J_TAU, maxit=J_SIMPLEX_MAXIT))
    rows = simplex.double()
    off = float(max((rows.sum(dim=1) - 1).abs().max(), -rows.min()))
    log(f'  classification_tikhonov_simplex: {c["csr_spmm"]} iterations, '
        f'{ms:.0f} ms, rows off the simplex by {off:.3e} (tol '
        f'{TOL_SIMPLEX:g})')
    if not off <= TOL_SIMPLEX:
        raise AssertionError(f'simplex rows off by {off}')
    agree = float((rows.argmax(dim=1).cpu().numpy() == labels).mean())
    # what an iteration spends outside kernel A: the projection's sort and
    # cumsum of the (N, 8) rows, in plain PyTorch
    proj_ms = time_ms(lambda: learning._proj_simplex(simplex), 5)
    log(f'  the projection onto the simplex alone: {proj_ms:.3f} ms')
    out['simplex'] = {'ms': ms, 'iterations': c['csr_spmm'],
                      'csr_spmm_launches': c['csr_spmm'], 'width': J_CLASSES,
                      'off_simplex': off, 'label_agreement': agree,
                      'projection_ms': proj_ms}
    parts['J1_simplex'] = c
    for name in ('classification', 'regression_tau0'):
        log(f'  {name}: {json.dumps(out[name])}')
    return out, parts


def host_prox_tv(D, x, gamma, step, iters):
    """``iters`` iterations of prox_tv's dual projected gradient in SciPy f64
    with the host D (N, Ne), then z; the products split over HOST_THREADS
    threads by rows."""
    D_blocks, DT_blocks = host_blocks(D), host_blocks(D.T)
    p = np.zeros(D.shape[1])
    with ThreadPoolExecutor(HOST_THREADS) as pool:
        for _ in range(iters):
            z = x - host_product(pool, D_blocks, p)
            p = np.clip(p + step * host_product(pool, DT_blocks, z), -gamma,
                        gamma)
        return x - host_product(pool, D_blocks, p)


def phase_path_j_tv(G, labels):
    """J2: ``prox_tv`` of a noisy piecewise-constant signal on J1's graph,
    held against the same dual iterations in f64 on the host, for the
    card's count (two ``csr_spmm`` launches an iteration, and one)."""
    from pygsp_tpu_torch import optimization
    x = labels / (J_CLASSES - 1.0) + J_TV_NOISE * np.random.default_rng(
        J_SEED + 1).normal(size=G.N)
    t0 = time.time()
    G.compute_differential_operator()
    torch.cuda.synchronize()
    build_s = time.time() - t0
    z, c, ms = run_part(lambda: optimization.prox_tv(
        x, J_TV_GAMMA, G, maxit=J_TV_MAXIT))
    if (c['csr_spmm'] - 1) % 2:
        raise AssertionError(f'prox_tv launched csr_spmm {c["csr_spmm"]} '
                             f'times, not 2 an iteration and 1')
    require_narrow('J2 prox_tv (grad and div at one column)', c)
    iters = (c['csr_spmm'] - 1) // 2
    src, tgt, w = G.get_edge_list()
    e = np.arange(len(src))
    D = sps.csr_matrix((np.concatenate([-np.sqrt(w), np.sqrt(w)]),
                        (np.concatenate([src, tgt]), np.concatenate([e, e]))),
                       shape=(G.N, len(src)))
    step = 1.0 / (2.0 * G.lmax)
    t0 = time.time()
    z_host = host_prox_tv(D, x, J_TV_GAMMA, step, iters)
    host_s = time.time() - t0
    z = z.double().cpu().numpy()
    err = float(np.abs(z - z_host).max() / np.abs(x).max())
    log(f'  prox_tv: {iters} iterations, {ms:.0f} ms, against the host f64 '
        f'iterations ({host_s:.1f} s): {err:.3e} of max|x| (tol '
        f'{TOL_TV:g})')
    if not err <= TOL_TV:
        raise AssertionError(f'prox_tv: {err} > {TOL_TV}')

    def objective(v):
        return (0.5 * np.sum((x - v) ** 2)
                + J_TV_GAMMA * np.abs(D.T @ v).sum())

    obj_x, obj_z = objective(x), objective(z)
    log(f'  TV objective {obj_x:.6e} at x, {obj_z:.6e} at the prox')
    if not obj_z < obj_x:
        raise AssertionError('prox_tv did not lower the TV objective')
    return {'ms': ms, 'iterations': iters, 'csr_spmm_launches': c['csr_spmm'],
            'width': 1, 'rel_err': err, 'objective': [obj_x, obj_z],
            'D_build_s': build_s, 'edges': int(len(src))}, c


def phase_path_j_sketch(G):
    """J3: the sketched resistances on J1's graph held by Foster's theorem,
    then ``graph_sparsify`` (connected, fewer edges)."""
    from pygsp_tpu_torch import reduction
    (src, tgt, R), c_sketch, ms_sketch = run_part(
        lambda: reduction.effective_resistances_sketch(G,
                                                       n_probes=J_PROBES))
    w = G.get_edge_list()[2]
    n_comp, _ = sps.csgraph.connected_components(G.W, directed=False)
    foster = float(np.sum(w * R) / (G.N - n_comp))
    log(f'  effective_resistances_sketch: {ms_sketch:.0f} ms, '
        f'{c_sketch["csr_spmm"]} csr_spmm launches at {J_PROBES} columns; '
        f'Σ w_e R_e / (N − {n_comp}) = {foster:.6f} (tol {TOL_FOSTER:g})')
    if not abs(foster - 1) <= TOL_FOSTER:
        raise AssertionError(f"Foster's theorem: {foster}")
    Gs, c_sparse, ms_sparse = run_part(
        lambda: reduction.graph_sparsify(G, epsilon=J_SPARSIFY_EPS, seed=1))
    log(f'  graph_sparsify(epsilon={J_SPARSIFY_EPS}): {ms_sparse:.0f} ms, '
        f'{G.Ne} → {Gs.Ne} edges, connected {Gs.is_connected()}')
    if not (Gs.is_connected() and Gs.Ne < G.Ne):
        raise AssertionError('graph_sparsify gave a disconnected graph or '
                             'no fewer edges')
    return {'sketch': {'ms': ms_sketch, 'iterations': c_sketch['csr_spmm'] - 1,
                       'csr_spmm_launches': c_sketch['csr_spmm'],
                       'width': J_PROBES, 'foster_ratio': foster,
                       'n_components': int(n_comp)},
            'sparsify': {'ms': ms_sparse, 'edges': [int(G.Ne), int(Gs.Ne)],
                         'csr_spmm_launches': c_sparse['csr_spmm']}}, {
                'J3_sketch': c_sketch, 'J3_sparsify': c_sparse}


def phase_path_j_pyramid():
    """J4: a two-level pyramid on ``Sensor(N=8000)``: the Kron method of
    each level, the (N, 8) block refused as the JAX package refuses it,
    each column analysed and synthesized back exactly, and level 0's
    low-pass bank against the SciPy f64 recurrence."""
    from pygsp_tpu_torch import reduction
    G = gsp.graphs.Sensor(N=J_PYRAMID_N, seed=42)
    f = seeded_normal((G.N, N_CHECK_COLS), 97).double().cpu().numpy()
    Gs, c_levels, ms_levels = run_part(
        lambda: reduction.graph_multiresolution(G, levels=2))
    levels = []
    for Gi, Gj in zip(Gs[:-1], Gs[1:]):
        drop = Gi.N - len(Gj.mr['idx'])
        levels.append({'n': int(Gj.N), 'edges': int(Gj.Ne),
                       'dropped': int(drop),
                       'kron': 'exact' if drop <= reduction._DENSE_SOLVE_MAX
                       else 'eliminate'})
    log(f'  graph_multiresolution: {ms_levels:.0f} ms, levels '
        f'{json.dumps(levels)}')
    try:
        reduction.pyramid_analysis(Gs, f)
    except ValueError as err:
        log(f'  an (N, {N_CHECK_COLS}) block: ValueError, as in the JAX '
            f'package ({err})')
    else:
        raise AssertionError('pyramid_analysis took an (N, 8) block')

    def pyramid():
        return [reduction.pyramid_synthesis(Gs, ca[-1], pe)[0] for ca, pe in (
            reduction.pyramid_analysis(Gs, f[:, j], order=ORDER)
            for j in range(N_CHECK_COLS))]

    recs, c_pyr, ms_pyr = run_part(pyramid)
    err = max(float(np.linalg.norm(r - f[:, j]) / np.linalg.norm(f[:, j]))
              for j, r in enumerate(recs))
    log(f'  pyramid analysis and synthesis of {N_CHECK_COLS} columns: '
        f'{ms_pyr:.0f} ms, reconstruction {err:.3e} of ‖f‖ (tol '
        f'{TOL_PYRAMID:g})')
    if not err <= TOL_PYRAMID:
        raise AssertionError(f'pyramid reconstruction {err}')
    h = gsp.filters.Filter(G, lambda x: 1.0 / (2 * x + 1))
    x = torch.from_numpy(f).float().cuda()
    low = h.filter(x, order=ORDER)
    rel = validate_path('J (pyramid level 0 low-pass)',
                        reference(host_laplacian(G), G.lmax, h.evaluate, x),
                        low[None])
    return {'levels': levels, 'ms_levels': ms_levels, 'ms_pyramid': ms_pyr,
            'reconstruction': err, 'lowpass_rel_err': rel,
            'csr_spmm_launches': c_levels['csr_spmm'] + c_pyr['csr_spmm']}, {
                'J4_levels': c_levels, 'J4_pyramid': c_pyr}


def phase_path_j_spectrogram():
    """J5: ``compute_spectrogram(Sensor(N=2048), M=100)``: one bank of 100
    filters on the identity, 64 of its columns against the SciPy f64
    recurrence; kernel A at 2048 columns and kernel B at Nf = 100 held
    against their plain versions."""
    from pygsp_tpu_torch import features
    G = gsp.graphs.Sensor(N=J_SPECTRO_N, seed=42)
    G.estimate_lmax()
    spectr, c, ms = run_part(lambda: features.compute_spectrogram(
        G, M=J_SPECTRO_M))
    if spectr.shape != (G.N, J_SPECTRO_M) or not np.isfinite(spectr).all():
        raise AssertionError(f'spectrogram {spectr.shape}')
    cols = np.arange(0, G.N, G.N // J_SPECTRO_COLS)[:J_SPECTRO_COLS]
    lmax, M = G.lmax, J_SPECTRO_M
    scale = np.linspace(0, lmax, M)
    c64 = cheby_coeff(
        lambda x: torch.stack([torch.exp(-M * ((x - s) / lmax) ** 2)
                               for s in scale]),
        lmax, m=ORDER, dtype=torch.float64, device='cpu').numpy()
    X = np.zeros((G.N, len(cols)))
    X[cols, np.arange(len(cols))] = 1.0
    t0 = time.time()
    ref = (scipy_recurrence(host_laplacian(G), lmax, c64, X) ** 2).sum(1).T
    log(f'  scipy f64 reference of {len(cols)} columns: '
        f'{time.time() - t0:.1f} s')
    rel = check('J (spectrogram) vs scipy f64', torch.from_numpy(
        spectr[cols]), torch.from_numpy(ref), TOL_PATH)
    g = group_of(G.L, torch.empty((G.N, G.N)), nf=M)
    log(f'  compute_spectrogram(M={M}): {ms:.0f} ms, launches {c}, group '
        f'g = {g}')
    held = {'csr_spmm': measure_spmm(
                f'csr_spmm at the spectrogram ({G.N} columns)',
                G.L.offdiag, seeded_normal((G.N, G.N), 98)),
            'cheby_step': measure_step(G.N, G.N, torch.float32,
                                       torch.float32, False),
            'cheby_acc_group': measure_group(G.N, G.N, M, torch.float32,
                                             torch.float32, g)}
    return {'ms': ms, 'nf': M, 'rel_err': rel, 'group': g,
            'launches': {k: c[k] for k in ('csr_spmm', 'cheby_step',
                                            'cheby_acc_group')}}, c, held


def nn_zoo():
    """The 8 nearest-neighbour classes at their default sizes on the card
    (NNGraph on a seeded 300-point cloud, the image classes on a seeded
    64 × 64 image)."""
    rng = np.random.default_rng(J_SEED)
    pts, img = rng.normal(size=(300, 3)), rng.random((64, 64))
    return (('NNGraph', lambda: gsp.graphs.NNGraph(pts)),
            ('Sensor', gsp.graphs.Sensor), ('Sphere', gsp.graphs.Sphere),
            ('Cube', gsp.graphs.Cube), ('TwoMoons', gsp.graphs.TwoMoons),
            ('Bunny', gsp.graphs.Bunny),
            ('ImgPatches', lambda: gsp.graphs.ImgPatches(img)),
            ('Grid2dImgPatches', lambda: gsp.graphs.Grid2dImgPatches(img)))


def eigenmap_check(G, name):
    """``laplacian_eigenmap2D``'s two columns: their Rayleigh quotients
    against host ``eigsh``'s eigenvalues 1 and 2, and their residuals
    against ‖L‖, in f64 on the host; raises outside the limits."""
    L = host_laplacian(G)
    ev = np.sort(spl.eigsh(L, k=4, sigma=-1e-3, which='LM')[0])[1:3]
    norm_L = float(spl.eigsh(L, k=1, which='LA')[0][0])
    u = G.coords.astype(np.float64)
    rq = np.einsum('ij,ij->j', u, L @ u) / np.einsum('ij,ij->j', u, u)
    rq_err = np.abs(rq - ev) / ev
    res = np.linalg.norm(L @ u - rq * u, axis=0) / np.linalg.norm(u, axis=0)
    log(f'  {name}: Rayleigh quotients {rq} against eigsh {ev}: '
        f'{rq_err} relative (tol {TOL_EIGENMAP_E:g}); residuals {res} '
        f'(tol {TOL_EIGENMAP_RES:g} × ‖L‖ = '
        f'{TOL_EIGENMAP_RES * norm_L:.3e})')
    if not (rq_err.max() <= TOL_EIGENMAP_E
            and res.max() <= TOL_EIGENMAP_RES * norm_L):
        raise AssertionError(f'{name}: {rq_err}, {res}')
    return {'rq_rel_err': rq_err.tolist(), 'residual': res.tolist(),
            'norm_L': norm_L}


def phase_path_j_zoo():
    """J6: each nearest-neighbour class on the card with a heat bank
    against the SciPy f64 recurrence, then ``laplacian_eigenmap2D`` on
    ``Sensor(N=16384)`` in f64 and in f32 (solved in f64), each held by
    its Rayleigh quotients and residuals."""
    zoo = {}

    def banks():
        for name, make in nn_zoo():
            t0 = time.time()
            Gz = make()
            Gz.estimate_lmax()
            gz = gsp.filters.Heat(Gz, scale=10)
            xz = seeded_normal((Gz.N, N_CHECK_COLS), 99)
            out = gz.filter(xz, method='chebyshev', order=ORDER)
            zoo[name] = {'n': int(Gz.N), 'edges': int(Gz.Ne),
                         'build_and_bank_s': time.time() - t0,
                         'rel_err': validate_path(
                             f'J ({name})', reference(
                                 host_laplacian(Gz), Gz.lmax, gz.evaluate,
                                 xz), out[None])}

    _, c_zoo, ms_zoo = run_part(banks)
    Ge = gsp.graphs.Sensor(N=J_EIGENMAP_N, seed=42, dtype=torch.float64)
    _, c_map, ms_map = run_part(
        lambda: Ge.set_coordinates('laplacian_eigenmap2D'))
    log(f'  laplacian_eigenmap2D on Sensor({J_EIGENMAP_N}), f64: '
        f'{ms_map:.0f} ms, {c_map["csr_spmm"]} csr_spmm launches')
    eigenmap = {'ms': ms_map, 'csr_spmm_launches': c_map['csr_spmm'],
                **eigenmap_check(Ge, 'laplacian_eigenmap2D f64')}
    # a float32 graph's eigenmap is solved in float64 and cast back
    G32 = gsp.graphs.Sensor(N=J_EIGENMAP_N, seed=42)
    G32.set_coordinates('laplacian_eigenmap2D')
    eigenmap['f32'] = eigenmap_check(G32, 'laplacian_eigenmap2D f32')
    return {'zoo': zoo, 'ms_zoo': ms_zoo, 'eigenmap': eigenmap}, {
        'J6_zoo': c_zoo, 'J6_eigenmap': c_map}


def phase_path_j():
    """Path J: J1-J6 (see the module's docstring); each part's launches
    counted from 0, summed under 'J'. Kernel A is held against its plain
    version at each new shape: 1, 8 and 24 columns on J1's graph and D,
    Dᵀ at one column."""
    log(f'phase J: path J, the algorithms on Sensor(N={J_SENSOR_N})')
    result, parts, held = {}, {}, {}
    t0 = time.time()
    G = gsp.graphs.Sensor(N=J_SENSOR_N, k=J_SENSOR_K, seed=42)
    torch.cuda.synchronize()
    result['build_s'] = time.time() - t0
    result['stored_edges'] = int(G.W.nnz)
    log(f'  Sensor(N={J_SENSOR_N}, k={J_SENSOR_K}) in '
        f'{result["build_s"]:.1f} s: {G.W.nnz} stored edges')
    G.estimate_lmax()
    labels, mask = sensor_labels(G)
    # one small solve first, so that J1's first part does not carry the
    # set-up of the library calls the solver makes (cuBLAS's dot)
    from pygsp_tpu_torch import learning
    small = gsp.graphs.Sensor(N=64, seed=42)
    learning.regression_tikhonov(small, np.ones(64), np.arange(64) < 8, 0.5)
    t0 = time.time()
    result['J1'], p = phase_path_j_learning(G, labels, mask)
    result['J1']['phase_s'] = time.time() - t0
    parts.update(p)
    t0 = time.time()
    result['J2'], parts['J2'] = phase_path_j_tv(G, labels)
    result['J2']['phase_s'] = time.time() - t0
    t0 = time.time()
    result['J3'], p = phase_path_j_sketch(G)
    result['J3']['phase_s'] = time.time() - t0
    parts.update(p)
    A = G.L.offdiag
    for s in J_WIDTHS:
        held[f'J1_{s}_columns'] = measure_spmm(
            f'csr_spmm on J1\'s graph at {s} columns', A,
            seeded_normal((G.N, s), 100 + s))
    DT, D = G.D.DT, G.D.D
    held['J2_grad_one_column'] = measure_spmm(
        'csr_spmm as grad (Dᵀ) at one column', DT, seeded_normal((G.N, 1),
                                                                 110))
    held['J2_div_one_column'] = measure_spmm(
        'csr_spmm as div (D) at one column', D, seeded_normal((G.Ne, 1), 111))
    # kernel A's share of each part: its launches there times its ms at the
    # part's width (held above), over the part's ms on the host clock
    j1, j2 = result['J1'], result['J2']
    kernel_a_ms = {
        'J1_classification': (j1['classification']['csr_spmm_launches']
                              * held['J1_8_columns']['ms'],
                              j1['classification']['ms']),
        'J1_regression': (j1['regression_tau0']['csr_spmm_launches']
                          * held['J1_1_columns']['ms'],
                          j1['regression_tau0']['ms']),
        'J1_simplex': (j1['simplex']['csr_spmm_launches']
                       * held['J1_8_columns']['ms'], j1['simplex']['ms']),
        'J2': (j2['iterations'] * held['J2_grad_one_column']['ms']
               + (j2['iterations'] + 1) * held['J2_div_one_column']['ms'],
               j2['ms']),
        'J3_sketch': (result['J3']['sketch']['csr_spmm_launches']
                      * held['J1_24_columns']['ms'],
                      result['J3']['sketch']['ms'])}
    result['kernel_a_share'] = {part: {'kernel_a_ms': a, 'part_ms': b,
                                       'share': a / b}
                                for part, (a, b) in kernel_a_ms.items()}
    log(f'  kernel A in path J: {json.dumps(result["kernel_a_share"])}')
    del G, A, DT, D
    torch.cuda.empty_cache()
    t0 = time.time()
    result['J4'], p = phase_path_j_pyramid()
    result['J4']['phase_s'] = time.time() - t0
    parts.update(p)
    torch.cuda.empty_cache()
    t0 = time.time()
    result['J5'], parts['J5'], held_b = phase_path_j_spectrogram()
    result['J5']['phase_s'] = time.time() - t0
    torch.cuda.empty_cache()
    t0 = time.time()
    result['J6'], p = phase_path_j_zoo()
    result['J6']['phase_s'] = time.time() - t0
    parts.update(p)
    total = {k: sum(c[k] for c in parts.values()) for k in counts()}
    for name in ('tail_plain', 'slot_plain'):
        if total[name]:
            raise AssertionError(f'path J ran {name} {total[name]} times')
    result['launches'] = {part: {k: v for k, v in c.items() if v}
                          for part, c in parts.items()}
    held['J5_spectrogram'] = held_b.pop('csr_spmm')
    log(f'path J: {json.dumps(result)}')
    return result, total, held, held_b


# ---------------------------------------------------------------------------
# path L: the multi-device engines at one rank, and the fused SpMM
# ---------------------------------------------------------------------------

# L3: device (0, 0)'s ring matrices of the L_RING × L_RING edge partition
L_RING = 4
L_SMALL_N = 1 << 16     # the sharded checkpoint's graph
L_NCCL_PAIR_S = 90      # the deadline of the two-rank NCCL probe
TOL_MULTI = 1e-5        # the fused fold against its plain version in f64

# two ranks of one NCCL group on card 0, one all_reduce (run as two
# processes by nccl_two_ranks_one_card)
NCCL_PAIR = r"""
import sys, torch, torch.distributed as dist
rank, port = int(sys.argv[1]), sys.argv[2]
torch.cuda.set_device(0)
dist.init_process_group('nccl', init_method=f'tcp://localhost:{port}',
                        world_size=2, rank=rank)
t = torch.full((4,), float(rank + 1), device='cuda')
dist.all_reduce(t)
torch.cuda.synchronize()
print('sum', float(t[0]), flush=True)
dist.destroy_process_group()
"""


def free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        return sock.getsockname()[1]


def nccl_two_ranks_one_card():
    """Whether NCCL takes two ranks on one card: two processes on card 0
    join one group and sum a tensor; each is killed at its deadline. The
    run does not depend on the answer."""
    port = free_port()
    procs = [subprocess.Popen([sys.executable, '-c', NCCL_PAIR, str(r),
                               str(port)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    ranks = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=L_NCCL_PAIR_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, err = p.communicate()
            err = f'killed at {L_NCCL_PAIR_S} s; {err}'
        ranks.append({'rc': p.returncode, 'stdout': out.strip()[-200:],
                      'stderr_tail': err.strip()[-300:]})
    accepted = all(r['rc'] == 0 and 'sum 3.0' in r['stdout'] for r in ranks)
    return {'accepted': accepted, 'ranks': ranks}


def require_same(name, got, want):
    """Raise unless two tensors are bit-equal (two launches, a round
    trip)."""
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f'{name}: not bit-equal')
    log(f'  {name}: bit-equal')


def live_slots(mats):
    """The slab slots of the matrices that hold an edge (this run's)."""
    return sum(int(((m.cols < m.chunk_rows)
                    & (m.cols + torch.arange(m.cols.shape[2], device='cuda')[
                        :, None] * m.chunk_rows < m.n_cols)).sum())
               for m in mats)


def slab_bytes(mats):
    return sum(m.cols.numel() * (4 + m.vals.element_size()
                                 + m.rowid.element_size()) for m in mats)


def multi_work(mats, xs, t):
    """The fused fold's bound: every slab (column, value, row id) and every
    x read once, the window tensor written once; two operations a live
    slot and column (this run's live slots)."""
    live = live_slots(mats)
    s = xs[0].shape[1]
    moved = slab_bytes(mats) + sum(x.numel() * x.element_size()
                                   for x in xs) + t.numel() * t.element_size()
    return live, bound(moved, 2.0 * live * s)


def fold_strip_work(mats, xs, y, merged):
    """The fused SpMM's bound (``fold_strip_multi``): every slab, every x
    and the merged residue list read once (the residue slots' x rows are
    rows of those x's, already counted), y written once; two operations a
    live slot (slab or residue) and column. Beside it the gather model: one
    x row per live slot, slab or residue, from wherever it lies."""
    live = live_slots(mats)
    s, item = xs[0].shape[1], xs[0].element_size()
    res = 0 if merged is None else merged.cols.numel()
    lists = 0 if merged is None else sum(
        a.numel() * a.element_size() for a in (
            merged.rowptr, merged.entptr, merged.cols, merged.vals,
            merged.emat, merged.heavy))
    moved = (slab_bytes(mats) + sum(x.numel() * x.element_size() for x in xs)
             + y.numel() * y.element_size() + lists)
    return {**bound(moved, 2.0 * (live + res) * s), 'bytes': moved,
            'gather_model_ms': (live + res) * s * item / HBM_BYTES_PER_S
            * 1e3, 'live_slots': live, 'live_residue_slots': res}


def fold_strip_plain64(slabs, xs, R, P, K, n, merged, absolute=False):
    """``fold_strip_multi``'s plain version in float64 on the same values
    (of |values| and |x| with ``absolute``: the scale of the sums)."""
    f = torch.abs if absolute else (lambda v: v)
    return wk.fold_strip_multi_plain(
        [(c, f(v.double()), r) for c, v, r in slabs],
        [f(x.double()) for x in xs], R, P, K, n,
        None if merged is None else merged._replace(
            vals=f(merged.vals.double())))


def measure_fold_strip(name, mats, xs, xb, merged, t, tb):
    """The fused SpMM in one launch (``fold_strip_multi``) at a group's
    shape: bit-equal to the two launches it replaces (the fold's ``t``,
    ``tb`` and the strip) in f32 and in the bf16 carry, two launches
    bit-equal; against its f64 plain version within TOL_MULTI (f32), and
    the bf16 carry within its roundings to bf16 (the K parts, y, each
    residue entry's sum and add) of the f64 sum of |terms|; its device
    time, the entry point's, the two launches' and its plain version's,
    beside its bound and gather model."""
    m0 = mats[0]
    R, P, K, n = m0.chunk_rows, m0.window_rows, m0.borrow_span, m0.n_rows
    slabs = [(m.cols, m.vals, m.rowid) for m in mats]
    args = (slabs, xs, R, P, K, n, merged)
    y = wk.fold_strip_multi(*args)
    require_same(f'{name} fold_strip_multi vs the fold and the strip', y,
                 wk.window_strip(t, n, P, merged, xs))
    require_same(f'{name} fold_strip_multi, two launches',
                 wk.fold_strip_multi(*args), y)
    want = fold_strip_plain64(*args)
    err = check(f'{name} fold_strip_multi vs its plain version (f64)',
                y.double(), want, TOL_MULTI)
    max_abs = float((y.double() - want).abs().max())
    del want
    argsb = (slabs, xb, R, P, K, n, merged)
    yb = wk.fold_strip_multi(*argsb)
    require_same(f'{name} fold_strip_multi (bf16 carry) vs the fold and the '
                 'strip', yb, wk.window_strip(tb, n, P, merged, xb))
    require_same(f'{name} fold_strip_multi (bf16 carry), two launches',
                 wk.fold_strip_multi(*argsb), yb)
    errb = float((yb.double() - fold_strip_plain64(*argsb)).abs().max())
    scale = float(fold_strip_plain64(*argsb, absolute=True).max())
    entries = 0 if merged is None else int(
        (merged.rowptr[1:] - merged.rowptr[:-1]).max())
    limit = (K + 3 + 2 * entries) * 2.0**-9 * scale
    log(f'  {name} fold_strip_multi (bf16 carry): {errb:.3e} from its f64 '
        f'plain version (limit {limit:.3e}: the roundings to bf16)')
    if not errb <= limit:
        raise AssertionError(f'{name} fold_strip_multi (bf16 carry): '
                             f'{errb} > {limit}')
    del y, yb
    y = wk.fold_strip_multi(*args)
    out = {'ms': device_ms(lambda: wk.fold_strip_multi(*args),
                           10)['device_ms'],
           'events_ms': time_ms(lambda: wk.fold_strip_multi(*args), 10),
           'entry_point_ms': time_ms(
               lambda: wd.spmm_multi_internal(mats, xs, merged), 10),
           'two_launch_ms': time_ms(lambda: wk.window_strip(
               wk.windowed_fold_multi(slabs, xs, R, K * P), n, P, merged,
               xs), 10),
           'plain_ms': time_ms(lambda: wk.fold_strip_multi_plain(*args), 3),
           'bf16_carry_ms': device_ms(lambda: wk.fold_strip_multi(*argsb),
                                      10)['device_ms'],
           'max_abs_err': max_abs, 'rel_err_f64': err,
           'bf16_carry_abs_err': errb, 'bf16_carry_limit': limit,
           'borrow_span': K, 'window_rows': P, 'n_rows': n,
           'heavy_rows': 0 if merged is None else merged.heavy.numel(),
           'residue_entries_max': entries,
           **fold_strip_work(mats, xs, y, merged)}
    log(f'  {name} fold_strip_multi: {json.dumps(out)}')
    return out


def measure_multi(name, mats, xs):
    """The fused SpMM at a group's shape, both routes. The fold
    (``windowed_fold_multi``): against its plain version in f64 (f32 x), in
    ulps (bf16 carry), two launches bit-equal; the strip over the merged
    residue list bit-equal to its plain version; the fold's device time
    beside its plain version's, its bound, the strip's, the two launches
    together, the matrices' separate fold and strip launches, and
    ``torch.sparse.mm`` of the stacked matrices against the stacked x's
    (CUDA events, and the device time of all its kernels a call).
    Then the one launch that replaces the two (:func:`measure_fold_strip`).
    Returns the two routes' numbers."""
    m0 = mats[0]
    R, KP = m0.chunk_rows, m0.borrow_span * m0.window_rows
    slabs = [(m.cols, m.vals, m.rowid) for m in mats]
    t = wk.windowed_fold_multi(slabs, xs, R, KP)
    want = wk.windowed_fold_multi_plain(
        [(c_, v.double(), r) for c_, v, r in slabs],
        [x.double() for x in xs], R, KP)
    err = check(f'{name} fused fold vs its plain version (f64)', t.double(),
                want, TOL_MULTI)
    max_abs = float((t.double() - want).abs().max())
    del want
    require_same(f'{name} fused fold, two launches',
                 wk.windowed_fold_multi(slabs, xs, R, KP), t)
    xb = [x.to(torch.bfloat16) for x in xs]
    tb = wk.windowed_fold_multi(slabs, xb, R, KP)
    u = ulps(tb, wk.windowed_fold_multi_plain(slabs, xb, R, KP))
    log(f'  {name} fused fold, bf16 carry: {u:.2f} ulps from its plain '
        'version')
    if u > 1.0:
        raise AssertionError(f'{name} fused fold (bf16 carry): {u} ulps')
    require_same(f'{name} fused fold (bf16 carry), two launches',
                 wk.windowed_fold_multi(slabs, xb, R, KP), tb)
    merged = wk.merge_residues([m.residue for m in mats], m0.n_rows)
    P = m0.window_rows
    y = wk.window_strip(t, m0.n_rows, P, merged, xs)
    require_same(f'{name} merged strip vs its plain version', y,
                 wk.window_strip_plain(t, m0.n_rows, P, merged, xs))
    require_same(f'{name} merged strip (bf16 carry) vs its plain version',
                 wk.window_strip(tb, m0.n_rows, P, merged, xb),
                 wk.window_strip_plain(tb, m0.n_rows, P, merged, xb))
    y_sep = sum(wd.spmm_internal(m, x) for m, x in zip(mats, xs))
    check(f'{name} fused SpMM vs the separate SpMMs', y, y_sep, TOL_MULTI)
    live, work = multi_work(mats, xs, t)
    dense = sps.hstack([wd.windowed_to_scipy(m) for m in mats]).tocsr()
    A = torch.sparse_csr_tensor(
        torch.from_numpy(dense.indptr).cuda(),
        torch.from_numpy(dense.indices).cuda(),
        torch.from_numpy(dense.data.astype(np.float32)).cuda(),
        size=dense.shape)
    del dense
    X = torch.cat(xs)
    check(f'{name} torch.sparse.mm of the stacked matrices',
          torch.sparse.mm(A, X), y_sep, TOL_MULTI)
    del y, y_sep
    library_ms = time_ms(lambda: torch.sparse.mm(A, X), 10)
    # on the clock of the kernels' device_ms too: all of its kernels a call
    library_device = device_ms(lambda: torch.sparse.mm(A, X), 10,
                               'library_device_ms', per_call=True)
    out = {'ms': device_ms(lambda: wk.windowed_fold_multi(slabs, xs, R, KP),
                           10)['device_ms'],
           'plain_ms': time_ms(lambda: wk.windowed_fold_multi_plain(
               slabs, xs, R, KP), 3),
           'strip_ms': device_ms(lambda: wk.window_strip(
               t, m0.n_rows, P, merged, xs), 10)['device_ms'],
           'fold_and_strip_ms': time_ms(lambda: wk.window_strip(
               wk.windowed_fold_multi(slabs, xs, R, KP), m0.n_rows, P,
               merged, xs), 10),
           'separate_fold_strip_ms': time_ms(
               lambda: [wd.spmm_internal(m, x) for m, x in zip(mats, xs)], 10),
           'library_ms': library_ms, **library_device,
           'bf16_carry_ms': device_ms(
               lambda: wk.windowed_fold_multi(slabs, xb, R, KP),
               10)['device_ms'],
           'max_abs_err': max_abs, 'rel_err_f64': err, 'bf16_ulps': u,
           'live_slots': live, 'matrices': len(mats),
           'slab_shapes': [list(m.cols.shape) for m in mats],
           'n_rows': m0.n_rows, 'n_cols': [m.n_cols for m in mats],
           'columns': xs[0].shape[1], **work}
    log(f'  {name} fused fold: {json.dumps(out)}')
    fused = measure_fold_strip(name, mats, xs, xb, merged, t, tb)
    fused.update(library_ms=library_ms, **library_device,
                 library='torch.sparse.mm of the stacked matrices against '
                         'the stacked x\'s (the whole SpMM)',
                 fold_and_strip_ms=out['fold_and_strip_ms'])
    return out, fused


def fused_entry_point(name, mats, xs):
    """``windowed_spmm_chunks_multi`` on a group, its launches counted from
    0: one ``fold_strip_multi``, no fold and no strip; y against the
    matrices' separate SpMMs."""
    reset_counts()
    y = wd.windowed_spmm_chunks_multi(mats, [(v,) for v in xs])
    torch.cuda.synchronize()
    launches = counts()
    if (launches['fold_strip_multi'] != 1 or launches['windowed_fold_multi']
            or launches['window_strip'] or launches['windowed_fold']):
        raise AssertionError(f'{name}: launches {launches}')
    y_sep = sum(wd.spmm_internal(m, v) for m, v in zip(mats, xs))
    err = check(f'{name} fused SpMM (entry point)', torch.cat(y), y_sep,
                TOL_MULTI)
    return launches, err


def measure_split(name, mats, xs):
    """A fold position's group split as the 2-D engine folds position 0
    at pr > 1 (``twod._merged``, ``twod._fold``): ring step 0's matrix
    alone, the fold that runs under the row shifts, then the other steps
    in one launch, and the add. Its launches counted from 0 (two
    ``fold_strip_multi``, no fold and no strip); y against the group's f64
    plain version within TOL_MULTI; its device time (both launches and the
    add, torch.profiler) and CUDA events beside the single launch's that
    folds the whole group, and each launch's alone."""
    from pygsp_tpu_torch.parallel import twod
    dt = xs[0].dtype
    first, rest, whole = (twod._merged(mats[:1]), twod._merged(mats[1:]),
                          twod._merged(mats))

    def step0():
        return twod._fold(first, xs[:1], dt)

    def others():
        return twod._fold(rest, xs[1:], dt)

    def split():
        return step0() + others()

    def single():
        return twod._fold(whole, xs, dt)

    reset_counts()
    y = split()
    torch.cuda.synchronize()
    launches = counts()
    if (launches['fold_strip_multi'] != 2 or launches['windowed_fold_multi']
            or launches['window_strip'] or launches['windowed_fold']):
        raise AssertionError(f'{name} split: launches {launches}')
    m0 = mats[0]
    want = fold_strip_plain64([(m.cols, m.vals, m.rowid) for m in mats], xs,
                              m0.chunk_rows, m0.window_rows, m0.borrow_span,
                              m0.n_rows, whole[1])
    err = check(f'{name} split (step 0, the rest, the add) vs the f64 plain '
                'version', y.double(), want, TOL_MULTI)
    max_abs = float((y.double() - want).abs().max())
    del y, want
    out = {'device_ms': device_ms(split, 10, per_call=True)['device_ms'],
           'events_ms': time_ms(split, 10),
           'single_device_ms': device_ms(single, 10)['device_ms'],
           'single_events_ms': time_ms(single, 10),
           'step0_device_ms': device_ms(step0, 10)['device_ms'],
           'rest_device_ms': device_ms(others, 10)['device_ms'],
           'rel_err_f64': err, 'max_abs_err': max_abs,
           'launches': launches['fold_strip_multi']}
    log(f'  {name} split fold: {json.dumps(out)}')
    return launches, out


def padding_zero(name, grad, perm):
    """Raise unless the padding rows (those no vertex maps to) of an
    engine's cotangent are exactly 0."""
    dead = torch.ones(grad.shape[0], dtype=torch.bool, device=grad.device)
    dead[perm] = False
    if bool(grad[dead].any()):
        raise AssertionError(f'{name}: a padding row\'s cotangent is not 0')
    return int(dead.sum())


def l5_part(name, fn, inputs, cot, unit, want, perms, fwd_want, bwd_want):
    """One L5 part: the engine's forward ``fn()`` and backward for ``cot``
    with respect to ``inputs`` (``c`` and the signal), counted and timed
    (:func:`counted_grads`, the backward's own peak); each gradient
    against ``want`` (the single-device route's, in the original vertex
    order) within TOL_F_XBAR, the signal's taken there by ``perms`` (None
    for c̄), its padding rows exactly 0; the launches exactly
    ``fwd_want`` and ``bwd_want``, with every kernel there launched at
    least once (the counts that are 0 are kernels that must not run)."""
    got, fwd, bwd, peak, ms = counted_grads(name, fn, inputs, cot, unit,
                                            backward_peak=True)
    require_counts(f'{name} forward', fwd, fwd_want)
    require_counts(f'{name} backward', bwd, bwd_want)
    rel, pad = {}, 0
    for key, g, w, perm in zip(('c_bar', 'x_bar'), got, want, perms):
        if perm is not None:
            pad = padding_zero(f'{name} {key}', g, perm)
            g = g[perm]
        rel[key] = check(f'{name}: {key} vs the single-device route', g, w,
                         TOL_F_XBAR)
    result = {'rel_err': rel, 'ms': ms, 'backward_peak_units': peak,
              'padding_rows': pad, 'forward_launches': launched(fwd),
              'backward_launches': launched(bwd)}
    log(f'  {name} ({card()}): {json.dumps(result)}')
    return result, {k: fwd[k] + bwd[k] for k in fwd}


def phase_path_l5(W, lmax, c, x, sg, split, mesh, tg, ell2, mesh2, fits):
    """L5, the engines under autograd at one rank on path A's graph (x (N,
    128) f32, the heat bank, K = 30): the backward with ``c`` and the
    signal requiring grad through ``sharded_cheby_op`` on the production
    layout and on COO, ``cheby_op_2d`` at 1 × 1 on ``ring=True,
    split_cols=True`` (one fused SpMM a product where ``fits``),
    ``sharded_cheby_synthesis`` of y (N, 128, 4) on the production layout
    and ``sharded_matvec`` on COO. Each forward and backward runs the
    engine's kernels (their launches exactly counted, at least one each,
    no plain version) and its gradients agree with the single-device
    route's on the CSR (``cheby_op``'s ``_ChebyOp``, ``cheby_synthesis``'s
    ``_ChebySynthesis``, ``L @ x``), taken to the engine's vertex order by
    ``perm``, within TOL_F_XBAR of the largest value; the forward and the
    backward timed (CUDA events), the backward's peak in (N, S) units.
    Returns ``(results, launches by part)``."""
    from pygsp_tpu_torch import parallel as par
    n, s = x.shape
    nf = c.shape[0]
    unit = n * s * x.element_size()
    L = gsp.core.operators.laplacian_op(gsp.core.sparse.from_scipy(W))
    c = c.detach()
    gbar = seeded_normal((nf, n, s), 111)
    y = seeded_normal((n, s, nf), 112)
    sbar = seeded_normal((n, s), 113)
    mbar = seeded_normal((n, s), 114)

    def ref(fn, *args, cot):
        inputs = [a.detach().clone().requires_grad_() for a in args]
        return torch.autograd.grad(fn(*inputs), inputs, cot)

    want_bank = ref(lambda c_, x_: cheby_op(L, lmax, c_, x_), c, x,
                    cot=gbar)
    want_syn = ref(lambda c_, y_: cheby_synthesis(L, lmax, c_, y_), c, y,
                   cot=sbar)
    want_mv = ref(lambda x_: L @ x_, x, cot=mbar)
    del L
    torch.cuda.empty_cache()

    def pad(sig, part):
        return part.pad_signal(sig)

    def padded_bank_cot(part):
        return part.pad_signal(gbar.movedim(0, -1)).movedim(-1, 0)

    steps, products = ORDER - 1, ORDER
    win = dict(windowed_fold=products, window_strip=products, csr_spmm=0)
    win2 = dict(windowed_fold=2 * products, window_strip=2 * products,
                csr_spmm=0)
    coo = dict(csr_spmm=products, windowed_fold=0)
    coo2 = dict(csr_spmm=2 * products, windowed_fold=0)
    ring = (dict(fold_strip_multi=products, windowed_fold_multi=0)
            if fits else dict(windowed_fold_multi=products,
                              window_strip=products))
    ring2 = {k: 2 * v for k, v in ring.items()}
    bank_bwd = dict(cheby_step=2 * steps, cheby_acc_contract=steps,
                    cheby_acc_group=0)
    result, parts = {}, {}
    for key, part, ell, fwd_k, bwd_k, engine in (
            ('bank_windowed_split', sg, split, win, win2,
             lambda p, c_, x_: par.sharded_cheby_op(
                 p, lmax, c_, x_, mesh, ell=split)),
            ('bank_coo', sg, None, coo, coo2,
             lambda p, c_, x_: par.sharded_cheby_op(p, lmax, c_, x_, mesh)),
            ('bank_2d_ring', tg, ell2, ring, ring2,
             lambda p, c_, x_: par.cheby_op_2d(p, lmax, c_, x_, mesh2,
                                               ell=ell2))):
        cg = c.clone().requires_grad_()
        xg = pad(x, part).requires_grad_()
        gl = padded_bank_cot(part)
        result[key], parts[key] = l5_part(
            f'L5 {key}', lambda: engine(part, cg, xg), (cg, xg), gl, unit,
            want_bank, (None, part.perm.long()),
            dict(cheby_step=steps, **fwd_k),
            dict(bank_bwd, cheby_dot_group=dot_groups(
                 acc_group_of(xg, ell, 2 * nf + 1)), **bwd_k))
        del cg, xg, gl
        torch.cuda.empty_cache()
    cg = c.clone().requires_grad_()
    yg = pad(y, sg).requires_grad_()
    g = acc_group_of(pad(sbar, sg), split, 2 * nf + 1)
    result['synthesis_windowed_split'], parts['synthesis_windowed_split'] = \
        l5_part('L5 synthesis_windowed_split',
                lambda: par.sharded_cheby_synthesis(sg, lmax, cg, yg, mesh,
                                                    ell=split),
                (cg, yg), pad(sbar, sg), unit, want_syn,
                (None, sg.perm.long()),
                dict(cheby_step=steps, cheby_acc_contract=steps, **win),
                dict(cheby_step=2 * steps, cheby_acc_contract=0,
                     cheby_acc_group=group_launches(g),
                     cheby_dot_group=dot_groups(g), **win2))
    del cg, yg
    torch.cuda.empty_cache()
    xg = pad(x, sg).requires_grad_()
    (mv_bar,), fwd, bwd, peak, ms = counted_grads(
        'L5 matvec_coo', lambda: par.sharded_matvec(sg, xg, mesh), (xg,),
        pad(mbar, sg), unit, backward_peak=True)
    require_counts('L5 matvec_coo forward', fwd, dict(csr_spmm=1))
    require_counts('L5 matvec_coo backward', bwd, dict(csr_spmm=1))
    perm = sg.perm.long()
    result['matvec_coo'] = {
        'rel_err': {'x_bar': check('L5 matvec_coo: x̄ vs L @ x\'s',
                                   mv_bar[perm], want_mv[0], TOL_F_XBAR)},
        'padding_rows': padding_zero('L5 matvec_coo', mv_bar, perm),
        'ms': ms, 'backward_peak_units': peak,
        'forward_launches': launched(fwd),
        'backward_launches': launched(bwd)}
    parts['matvec_coo'] = {k: fwd[k] + bwd[k] for k in fwd}
    log(f'  L5 matvec_coo ({card()}): {json.dumps(result["matvec_coo"])}')
    return result, parts


def acc_group_of(t, ell, held):
    """The engines' accumulator group for a recurrence on ``t`` (a rank's
    padded signal) with ``held`` blocks of its size beside its terms (the
    rule of ``parallel/sharded.py:_sharded_acc_group``)."""
    from pygsp_tpu_torch.parallel.sharded import _sharded_acc_group
    return _sharded_acc_group(t, held, ell, None, 1)


def engines_small_f64():
    """L5 in f64 on BA(2^16) (x (N, 2), the heat bank of order 30): the
    bank's c̄ and x̄ on the production layout, on COO and on the 1 × 1
    ring, the synthesis's c̄ and ȳ on the production layout and the
    matvec's x̄ on COO, on the card against the same calls on the CPU,
    within TOL_F64 of the largest value. One rank and no process group
    (the CPU's engines issue no collective then)."""
    from pygsp_tpu_torch import parallel as par
    n = K_SMALL_N
    src, tgt = gsp.graphs.ba_edges_fast(n, m0=M_ATTACH, m=M_ATTACH, seed=42)
    W = symmetric_from_edges(src, tgt, n)
    f64 = torch.float64
    lmax = 2.0 * float(W.sum(axis=1).max())       # Gershgorin's bound
    c0 = cheby_coeff(lambda lam: torch.exp(-torch.tensor(
        SCALES, dtype=f64)[:, None] * lam[None, :] / lmax), lmax, m=ORDER,
        dtype=f64, device='cpu').numpy()
    nf, s = len(SCALES), 2     # the CPU side's plain SpMMs set the time
    rng = np.random.default_rng(115)
    x0, y0 = rng.normal(size=(n, s)), rng.normal(size=(n, s, nf))
    g0, s0 = rng.normal(size=(nf, n, s)), rng.normal(size=(n, s))
    grads, t = {}, {}
    for device in ('cuda', 'cpu'):
        t0 = time.time()
        sg = par.partition_graph(W, 1, dtype=np.float64, device=device)
        split = par.shard_local_windowed(sg, split_boundary=True)
        tg = par.partition_graph_2d(W, 1, 1, dtype=np.float64, device=device)
        ring = par.twod_local_windowed(tg, ring=True, split_cols=True)
        mesh = par.make_mesh(1, 1, devices=device)
        mesh2 = par.make_mesh_2d(1, 1, devices=device)

        def run(part, fn, sig, cot, with_c=True):
            cg = torch.tensor(c0, device=device, requires_grad=True)
            xg = part.pad_signal(torch.tensor(sig, device=device))
            xg.requires_grad_()
            out = fn(cg, xg)
            inputs = (cg, xg) if with_c else (xg,)
            cot = torch.as_tensor(cot, device=device)
            cot = (part.pad_signal(cot.movedim(0, -1)).movedim(-1, 0)
                   if out.ndim == 3 else part.pad_signal(cot))
            got = torch.autograd.grad(out, inputs, cot)
            perm = part.perm.long()
            return [v.cpu() for v in got[:-1]] + [got[-1][perm].cpu()]

        grads[device] = {
            'bank_windowed_split': run(sg, lambda c_, x_: par.sharded_cheby_op(
                sg, lmax, c_, x_, mesh, ell=split), x0, g0),
            'bank_coo': run(sg, lambda c_, x_: par.sharded_cheby_op(
                sg, lmax, c_, x_, mesh), x0, g0),
            'bank_2d_ring': run(tg, lambda c_, x_: par.cheby_op_2d(
                tg, lmax, c_, x_, mesh2, ell=ring), x0, g0),
            'synthesis_windowed_split': run(
                sg, lambda c_, y_: par.sharded_cheby_synthesis(
                    sg, lmax, c_, y_, mesh, ell=split), y0, s0),
            'matvec_coo': run(sg, lambda c_, x_: par.sharded_matvec(
                sg, x_, mesh), x0, s0, with_c=False)}
        t[device] = time.time() - t0
    errs = {}
    for key, got in grads['cuda'].items():
        names = ('c_bar', 'x_bar') if len(got) == 2 else ('x_bar',)
        for name, a, b in zip(names, got, grads['cpu'][key]):
            errs[f'{key}_{name}'] = check(f'L5 f64 {key} {name} card vs CPU',
                                          a, b, TOL_F64)
    return {'rel_err': errs, 'n': n, 's': s, 'nf': nf, 'seconds': t}


def phase_path_l(lmax, ref, ms_a):
    """Path L on path A's graph, signal and SciPy reference (``ref``, at
    path A's λmax ``lmax``): L1, the 1-D engine on a one-rank NCCL group
    (``launch.initialize``) with the production layout
    (``shard_local_windowed(split_boundary=True)``) and the COO one, and
    one fixed-graph VJP step with its c̄ all_reduce; L2, the 2-D engine at
    1 × 1 (``ring=True, split_cols=True``); L3, the fused SpMM on device
    (0, 0)'s ring matrices of the 4 × 4 partition, and L4 on both fold
    positions' groups of device (0, 0) of the 2 × 2 interleaved ring
    (``split_cols=True``), each through the entry point (one
    ``fold_strip_multi`` launch) and then both routes measured
    (:func:`measure_multi`); a sharded checkpoint round trip; and whether NCCL takes two ranks on one card. Returns
    ``(path, launches by part, the two-launch route's numbers and
    fold_strip_multi's, each by group)``."""
    import tempfile
    from pygsp_tpu_torch import checkpoint, parallel as par
    from pygsp_tpu_torch.parallel.partition import shard_slice
    log('phase L: path L, the multi-device engines at one rank on path A\'s '
        'graph')
    path, other = {}, {}
    src, tgt = gsp.graphs.ba_edges_fast(N_BA, m0=M_ATTACH, m=M_ATTACH,
                                        seed=42)
    W = symmetric_from_edges(src, tgt, N_BA)
    par.initialize(f'tcp://localhost:{free_port()}', 1, 0)
    backend = torch.distributed.get_backend()
    if backend != 'nccl':
        raise AssertionError(f'path L: a {backend} group, not NCCL')
    mesh = par.make_mesh(1, 1)
    x = seeded_normal((N_BA, N_SIGNALS), 0)
    c = heat_coeff(torch.tensor(SCALES, device='cuda'), lmax)

    # L1: the 1-D engine
    t0 = time.time()
    sg = par.partition_graph(W, 1)
    t1 = time.time()
    split = par.shard_local_windowed(sg, split_boundary=True)
    l1 = {'partition_s': t1 - t0, 'layout_s': time.time() - t1,
          'n_local': sg.n_local, 'halo_total': sg.halo_total,
          'path_a_ms_per_bank': ms_a}
    xp, perm = sg.pad_signal(x), sg.perm.long()
    for name, ell, want in (
            ('windowed_split', split, dict(windowed_fold=ORDER,
                                           window_strip=ORDER)),
            ('coo', None, dict(csr_spmm=ORDER))):
        def bank(ell=ell):
            return par.sharded_cheby_op(sg, lmax, c, xp, mesh, ell=ell)
        reset_counts()
        out, launches, per_bank = run_bank(bank)
        require_launches(f'L1 ({name})', per_bank, cheby_step=ORDER - 1,
                         cheby_acc_group=1, **want)
        if ell is not None:
            require_tail('L1', per_bank)
            if per_bank['csr_spmm']:
                raise AssertionError('the CSR kernel ran in L1\'s windowed '
                                     'bank')
        rel = validate_path(f'L1 ({name})', ref, out[:, perm])
        del out
        ms = time_ms(bank, 3)
        log(f'  L1 ({name}): {ms:.3f} ms per bank (path A {ms_a:.3f})')
        l1[name] = {'ms_per_bank': ms, 'rel_err': rel, 'per_bank': per_bank}
        other[f'L1_{name}'] = launches
    # one fixed-graph VJP step: c̄'s dots all_reduced over 'graph' and
    # 'batch' (on the one-rank NCCL groups)
    reduces = []
    all_reduce = torch.distributed.all_reduce

    def spy(t, *args, **kw):
        reduces.append(tuple(t.shape))
        return all_reduce(t, *args, **kw)

    cg = c.detach().clone().requires_grad_()
    xg = xp.detach().clone().requires_grad_()
    gbar = seeded_normal((len(SCALES),) + tuple(xp.shape), 71)
    reset_counts()
    torch.distributed.all_reduce = spy
    try:
        t0 = time.time()
        out = par.sharded_cheby_op_fixed_graph(sg, lmax, cg, xg, mesh,
                                               ell=split)
        c_bar, x_bar = torch.autograd.grad(out, (cg, xg), gbar)
        torch.cuda.synchronize()
        step_s = time.time() - t0
    finally:
        torch.distributed.all_reduce = all_reduce
    launches = counts()
    other['L1_vjp'] = launches
    if (launches['cheby_dot_group'] < 1 or launches['cheby_acc_contract']
            != ORDER - 1 or launches['window_strip'] != 3 * ORDER):
        raise AssertionError(f'L1 VJP: launches {launches}')
    if reduces != [tuple(c_bar.T.shape)] * 2:
        raise AssertionError(f'L1 VJP: all_reduce of {reduces}')
    prod = c_bar.double() * c.double()
    g_out = dot64(gbar, out.detach())
    errs = {'c_bar': abs(float(prod.sum()) - g_out)
            / float(prod.abs().sum()),
            'x_bar': abs(dot64(x_bar[None], xp[None]) - g_out)
            / dot64(x_bar[None], xp[None], absolute=True)}
    log(f'  L1 VJP: adjoint identities rel err {json.dumps(errs)}; '
        f'all_reduce {reduces}; {step_s:.2f} s')
    if not (errs['c_bar'] <= TOL_ADJOINT_C and errs['x_bar'] <= TOL_ADJOINT_X):
        raise AssertionError(f'L1 VJP: adjoint identities off by {errs}')
    # the step again, warm: forward and backward, CUDA events
    step_ms = time_ms(lambda: torch.autograd.grad(
        par.sharded_cheby_op_fixed_graph(sg, lmax, cg, xg, mesh, ell=split),
        (cg, xg), gbar), 2)
    log(f'  L1 VJP: a warm step {step_ms:.2f} ms')
    l1['vjp'] = {'adjoint_rel_err': errs, 'all_reduce': reduces,
                 'first_step_s': step_s, 'step_ms': step_ms,
                 'launches': launches}
    del out, c_bar, x_bar, gbar, cg, xg, xp
    torch.cuda.empty_cache()
    path['L1'] = l1

    # L2: the 2-D engine at 1 x 1, interleaved ring layout
    t0 = time.time()
    tg = par.partition_graph_2d(W, 1, 1)
    t1 = time.time()
    ell2 = par.twod_local_windowed(tg, ring=True, split_cols=True)
    l2 = {'partition_s': t1 - t0, 'layout_s': time.time() - t1}
    mesh2 = par.make_mesh_2d(1, 1)
    xp2, perm2 = tg.pad_signal(x), tg.perm.long()

    def bank2():
        return par.cheby_op_2d(tg, lmax, c, xp2, mesh2, ell=ell2)

    # at pr = 1 the ring's one fold a step is one launch of the fused SpMM
    # (its two launches, the fold into a window tensor and the strip, where
    # a window does not fit a block)
    m2 = shard_slice(ell2[0][0], 0).local_matrix()
    fits = wk.fold_strip_fits([(m2.cols, m2.vals, m2.rowid)], [xp2],
                              m2.borrow_span, m2.window_rows)
    reset_counts()
    out, launches, per_bank = run_bank(bank2)
    require_launches('L2', per_bank, cheby_step=ORDER - 1, cheby_acc_group=1,
                     **(dict(fold_strip_multi=ORDER) if fits else
                        dict(windowed_fold_multi=ORDER, window_strip=ORDER)))
    if per_bank['windowed_fold'] or per_bank['tail_plain'] or (
            fits and (per_bank['window_strip']
                      or per_bank['windowed_fold_multi'])):
        raise AssertionError(f'L2: launches {per_bank}')
    l2['fold_strip_fits'] = fits
    l2['rel_err'] = validate_path('L2', ref, out[:, perm2])
    del out
    l2['ms_per_bank'] = time_ms(bank2, 3)
    l2['per_bank'] = per_bank
    other['L2'] = launches
    log(f'  L2: {l2["ms_per_bank"]:.3f} ms per bank')
    del xp2, m2
    torch.cuda.empty_cache()
    path['L2'] = l2

    # L5: the engines under autograd on L1's and L2's partitions
    t0_l5 = time.time()
    path['L5'], l5 = phase_path_l5(W, lmax, c, x, sg, split, mesh, tg, ell2,
                                   mesh2, fits)
    path['L5']['phase_s'] = time.time() - t0_l5
    other.update({f'L5_{k}': v for k, v in l5.items()})
    del sg, split, tg, ell2
    torch.cuda.empty_cache()

    # L3: the fused SpMM on device (0, 0)'s ring matrices of the 4 x 4
    # partition, through the entry point, then both routes measured; L4:
    # the same on both fold positions' groups of device (0, 0) of the 2 x 2
    # interleaved ring (the 4-card 2-D engine's matrices)
    multi, fused = {}, {}
    for part, shape, kw in (('L3', (L_RING, L_RING), {}),
                            ('L4', (2, 2), dict(split_cols=True))):
        t0 = time.time()
        tgp = par.partition_graph_2d(W, *shape)
        ell = par.twod_local_windowed(tgp, ring=True, **kw)
        groups = ([[shard_slice(row[s], 0).local_matrix() for row in ell]
                   for s in range(shape[1])] if kw else
                  [[shard_slice(e, 0).local_matrix() for e in ell]])
        path[part] = {'build_s': time.time() - t0}
        del tgp, ell
        for s, mats in enumerate(groups):
            key = part if len(groups) == 1 else f'{part}_pos{s}'
            xs = [seeded_normal((m.n_cols, N_SIGNALS), 80 + 10 * s + k)
                  for k, m in enumerate(mats)]
            other[key], err = fused_entry_point(key, mats, xs)
            path[part][f'rel_err_vs_separate_{key}'] = err
            multi[key], fused[key] = measure_multi(key, mats, xs)
            if part == 'L4':
                other[f'{key}_split'], path[part][f'split_{key}'] = \
                    measure_split(key, mats, xs)
            del xs
        del groups, mats
        torch.cuda.empty_cache()

    # the sharded checkpoint, and the two-rank probe
    s_src, s_tgt = gsp.graphs.ba_edges_fast(L_SMALL_N, m0=M_ATTACH,
                                            m=M_ATTACH, seed=42)
    sg4 = par.partition_graph(symmetric_from_edges(s_src, s_tgt, L_SMALL_N),
                              4)
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save_sharded(os.path.join(d, 'sg'), sg4)
        back = checkpoint.load_sharded(os.path.join(d, 'sg'))
    for name in ('rows', 'cols', 'vals', 'diag', 'perm'):
        require_same(f'load_sharded {name}', getattr(back, name),
                      getattr(sg4, name))
    for a, b in zip(back.send_idx, sg4.send_idx):
        require_same('load_sharded send_idx', a, b)
    if (back.halo_dists, back.halo_sizes) != (sg4.halo_dists, sg4.halo_sizes):
        raise AssertionError('load_sharded: the halo buckets differ')
    log(f'  sharded checkpoint of BA({L_SMALL_N}) at 4 shards: round trip '
        'equal')
    path['nccl_two_ranks_one_card'] = nccl_two_ranks_one_card()
    log(f'  NCCL, two ranks on one card: '
        f'{json.dumps(path["nccl_two_ranks_one_card"])}')
    torch.distributed.destroy_process_group()
    # L5 in f64, card against CPU: one rank without a process group
    t0_l5 = time.time()
    path['L5']['small_f64'] = engines_small_f64()
    path['L5']['phase_s'] += time.time() - t0_l5
    log(f'path L5 ({card()}): {json.dumps(path["L5"])}')
    return path, other, multi, fused


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device available', file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    count_symbols()
    count_plain_calls()
    log(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
        f'{torch.cuda.get_device_name(0)}')
    t_start = time.time()

    double = phase_build()
    fold3 = phase_kernels()
    phase_kernel_b()
    path_e, path_f, path_g, path_m, path_n, other = {}, {}, {}, {}, {}, {}
    csr, path_a, counts_a, (G, x) = phase_path_a()
    path_e['A'], other['E_A'] = phase_path_e('A', G, None, x, TRAIN_STEPS,
                                             G.L.to_scipy())
    require_launches('E on A', other['E_A'], csr_spmm=3 * ORDER * TRAIN_STEPS,
                     **train_kernels(TRAIN_STEPS))
    path_f['lanczos'], other['F_lanczos'] = phase_path_f_lanczos(G, x)
    require_launches('F (Lanczos)', other['F_lanczos'], csr_spmm=ORDER)
    torch.cuda.empty_cache()
    t0 = time.time()
    path_k, other['K'] = phase_path_k(G, x)
    path_k['phase_s'] = time.time() - t0
    torch.cuda.empty_cache()
    path_k['auxiliaries'] = phase_auxiliaries(G, x)
    torch.cuda.empty_cache()
    path_n['A'], other['N_A'] = phase_path_n(
        'A', G.L, G.lmax, x, W=gsp.core.sparse.from_scipy(G.W))
    torch.cuda.empty_cache()
    path_g['A'], other_g = timed(phase_path_g_a, G, x)
    other.update(other_g)
    del G, x
    torch.cuda.empty_cache()
    banded, path_b, counts_b, (G, Lb, x) = phase_path_b()
    path_e['B'], other['E_B'] = phase_path_e('B', G, Lb, x, 1,
                                             G.L.to_scipy())
    require_launches('E on B', other['E_B'], banded_spmm=3 * ORDER,
                     **train_kernels(1))
    path_g['B'], other['G_B'] = timed(phase_path_g_b, G, Lb, x)
    path_m['B'], other['M_B'] = phase_path_m('B', Lb, G.lmax, x)
    path_m['B']['small_f64'] = banded_small_f64()
    torch.cuda.empty_cache()
    path_n['B'], other['N_B'] = phase_path_n('B', Lb, G.lmax, x)
    del G, Lb, x
    torch.cuda.empty_cache()
    fold, strip, fold2, path_c, counts_c, shared = phase_path_c()
    fast, path_d, counts_d = phase_path_d(*shared)
    G, _, x, _ = shared
    del shared
    torch.cuda.empty_cache()
    # the host's Laplacian from the adjacency, as path C's reference
    path_e['C'], other['E_C'] = phase_path_e('C', G, None, x, TRAIN_STEPS,
                                             sps.diags(G.dw) - G.W)
    require_launches('E on C', other['E_C'],
                     windowed_fold=3 * ORDER * TRAIN_STEPS,
                     window_strip=3 * ORDER * TRAIN_STEPS,
                     **train_kernels(TRAIN_STEPS))
    if other['E_C']['csr_spmm']:
        raise AssertionError('the CSR kernel ran in path E on C')
    # the windowed slots' CSR view: built by the first backward (x̄'s), then
    # shared by every later one, the Adam steps' included
    builds = gsp.core.sparse.grad_edges.builds
    path_m['xbar_windowed'], other['M_xbar'] = xbar_on_windowed(G, x)
    path_m['C'], other['M_C'] = phase_path_m('C', G.L, G.lmax, x)
    path_m['C']['train'] = train_leaves(G.L, G.lmax, x)
    builds = gsp.core.sparse.grad_edges.builds - builds
    path_m['C']['csr_views_built_on_c'] = builds
    if builds != 1:
        raise AssertionError(f'path M on C: the CSR view built {builds} '
                             f'times, not once')
    torch.cuda.empty_cache()
    path_n['C'], other['N_C'] = phase_path_n('C', G.L, G.lmax, x)
    path_g['C'], other['G_C'] = timed(phase_path_g_bank, 'C', G, x, 'Meyer',
                                      sps.diags(G.dw) - G.W)
    del G, x
    torch.cuda.empty_cache()
    path_f['exact'], other['F_exact'] = phase_path_f_exact()
    torch.cuda.empty_cache()
    path_g['lobpcg'], other['G_lobpcg'] = timed(phase_path_g_lobpcg)
    path_g['designs'], other['G_designs'] = timed(phase_path_g_designs)
    torch.cuda.empty_cache()
    t0 = time.time()
    ell, narrow_h, path_h, counts_h, other_h = phase_path_h()
    path_h['phase_s'] = time.time() - t0
    path_m['H'] = path_h.pop('M')
    path_n['H'] = path_h.pop('N')
    other.update(other_h)
    torch.cuda.empty_cache()
    t0 = time.time()
    chunked_k, narrow_i, path_i, counts_i, other_i = phase_path_i()
    path_i['phase_s'] = time.time() - t0
    path_m['I'] = path_i.pop('M')
    path_n['I'] = path_i.pop('N')
    other.update(other_i)
    torch.cuda.empty_cache()
    t0 = time.time()
    path_j, other['J'], held_j, held_jb = phase_path_j()
    path_j['phase_s'] = time.time() - t0
    torch.cuda.empty_cache()
    t0 = time.time()
    path_l, other_l, multi, fused_l = phase_path_l(
        path_a['lmax'], REFERENCES[('bench', N_BA, path_a['lmax'])],
        path_a['ms_per_bank'])
    path_l['phase_s'] = time.time() - t0
    other.update(other_l)
    REFERENCES.clear()
    torch.cuda.empty_cache()
    paths = {'A': path_a, 'B': path_b, 'C': path_c, 'D': path_d}
    step, group, one, contract, kb_bank, dot = phase_kernel_b_times(
        {p: path['acc_group'] for p, path in paths.items()})
    for p, path in paths.items():
        path['kernel_b_per_bank'] = kb_bank[p]
    sddmm = path_k.pop('sddmm')
    paths.update(E=path_e, F=path_f, G=path_g, H=path_h, I=path_i,
                 J=path_j, K=path_k, L=path_l, M=path_m, N=path_n)
    log(f'paths: {json.dumps(paths)}')
    log(f'peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} '
        f'GiB; total {time.time() - t_start:.1f} s')

    # kernel A: grad (Dᵀ x) and div (D y) on path A's graph beside the
    # bank's SpMM
    difference = path_g['A']['difference']['combinatorial']
    csr.update(grad=difference['grad'], div=difference['div'])
    # each kernel at path G's other shapes, where it was held against its
    # plain version
    held_b, held_z = (path_g['B'].pop('kernels'),
                      path_g['designs'].pop('kernels'))
    # kernel A's narrow entry: its headline at one column on path A's graph
    # (estimate_lmax's product), the width sweep and the narrow shapes of
    # paths G and J under at_paths; the wide entry keeps the rest
    sweep = csr.pop('width_sweep')
    csr_narrow = dict(
        sweep['1_float32']['narrow'], name='csr_spmm_narrow', route='cuda',
        source='pygsp_tpu_torch/csrc/csr_spmm.cu',
        replaces='pygsp_tpu/core/sparse.py:282 (XLA gather + segment_sum, '
                 'no Pallas kernel), at up to '
                 f'{csr_kernel.NARROW_WIDTH[torch.float32]} f32 and '
                 f'{csr_kernel.NARROW_WIDTH[torch.float64]} f64 columns',
        at_paths={'A_width_sweep': sweep,
                  'G_A_one_column': path_g['A'].pop('spmm_one_column'),
                  'G_lobpcg_f64': path_g['lobpcg'].pop('spmm'),
                  **{k: held_j.pop(k) for k in list(held_j)
                     if k.startswith(('J1_', 'J2_'))}})
    csr.update(at_paths={'G_designs': held_z['csr_spmm'], **held_j})
    banded.update(at_synthesis_nf6=held_b['banded_spmm'])
    step.update(B_synthesis_nf6=held_b['cheby_step'],
                G_designs=held_z['cheby_step'],
                J5_spectrogram=held_jb['cheby_step'])
    contract.update(B_nf6=held_b['cheby_acc_contract'])
    csr.update(name='csr_spmm', route='cuda',
               source='pygsp_tpu_torch/csrc/csr_spmm.cu',
               replaces='pygsp_tpu/core/sparse.py:282 (XLA gather + '
                        'segment_sum, no Pallas kernel)')
    banded.update(name='banded_spmm', route='cuda',
                  source='pygsp_tpu_torch/csrc/banded_spmm.cu',
                  replaces='pygsp_tpu/ops/pallas_banded.py:69')
    source = 'pygsp_tpu_torch/csrc/windowed_fold.cu'
    fold.update(name='windowed_fold', route='cuda', source=source,
                replaces='benchmarks/pallas_fold_probe.py:103 (#2, the '
                         'one-hot fold) with the gather of '
                         'pygsp_tpu/core/windowed.py:298-303')
    strip.update(name='window_strip', route='cuda', source=source,
                 replaces='pygsp_tpu/core/windowed.py:336-345 (XLA '
                          'overlap-add) and :406-414 (the residue tiers, '
                          'core/sparse.py:363 _slot_block_sum, and their '
                          'scatter-add); no Pallas kernel')
    fold2.update(name='fold_products', route='cuda', source=source,
                 at_shape_of_3=fold3,
                 replaces='benchmarks/pallas_fold_probe.py:103 (#2); at '
                          'NW=1 benchmarks/pallas_smoke.py:52 (#3)')
    double.update(name='double', route='cuda', source=source,
                  replaces='benchmarks/pallas_smoke.py:28 (#4)')
    fold.update(bf16_at_path_d=fast['fold'])
    strip.update(bf16_at_path_d=fast['strip'])
    # kernel B: each entry point's headline numbers at path A's shape (the
    # group's are path C's, the same shape and types), the others under
    # at_paths; max_abs_err from the bit-equality check at that shape
    source = 'pygsp_tpu_torch/csrc/cheby_step.cu'
    g_b = path_g['B']['acc_group']
    kb_step = dict(step['A'], name='cheby_step', route='cuda', source=source,
                   at_paths=step,
                   replaces='pygsp_tpu/ops/chebyshev.py:186-190 and '
                            ':264-268 (XLA fusions of the lax.scan bodies, '
                            'no Pallas kernel)')
    kb_group = dict(group['C'], name='cheby_acc_group', route='cuda',
                    source=source,
                    at_paths={**{p: group[p] for p in 'BCD'},
                              **{f'g1_{p}': one[p] for p in 'BCD'},
                              'A_nf6': path_g['A']['acc_group_nf6'],
                              'g1_A_nf6': path_g['A'].pop('acc_group_nf6_g1'),
                              'B_nf6': held_b[f'cheby_acc_group_g{g_b}'],
                              'g1_B_nf6': held_b['cheby_acc_group_g1'],
                              'G_designs': held_z['cheby_acc_group'],
                              'J5_nf100': held_jb['cheby_acc_group']},
                    replaces='pygsp_tpu/ops/chebyshev.py:189 and :323-334 '
                             '(XLA fusions, no Pallas kernel)')
    g = path_a['acc_group']
    kb_dot = dict(dot['A'][f'g{g}'], name='cheby_dot_group', route='cuda',
                  source=source, at_paths={'A and C': dot['A'], 'B': dot['B']},
                  launches_per_backward=dot_groups(g),
                  replaces='pygsp_tpu/ops/chebyshev.py:431-433 (dot_all of '
                           'the fixed-graph VJP) and :707-723 (its chunked '
                           'form); XLA dot_general, no Pallas kernel')
    kb_contract = dict(contract['A'], name='cheby_acc_contract',
                       route='cuda', source=source, at_paths=contract,
                       replaces='pygsp_tpu/ops/chebyshev.py:621 and :697 '
                                '(XLA fusions, no Pallas kernel; synthesis, '
                                'not on the bench path)')
    # launches as counted in each path's own run, its counts set to 0 just
    # before it and read just after: `launches` sums them over every path
    # (A-D, the banks; E, training on A, B and C; F, Lanczos and exact;
    # G-I; J, the algorithms, each of its parts counted from 0 and summed);
    # `launches_per_bank` sums a bank path's bank over the paths the kernel
    # serves (all four for the kernels that serve none)
    ell.update(name='ell_spmm', route='cuda',
               source='pygsp_tpu_torch/csrc/ell_spmm.cu',
               replaces='pygsp_tpu/core/sparse.py:411-420 (ell_spmm: XLA '
                        'gather-sums of _slot_block_sum and unique-row '
                        'scatter-adds, no Pallas kernel)')
    chunked_k.update(name='chunked_spmm', route='cuda',
                     source='pygsp_tpu_torch/csrc/ell_spmm.cu',
                     replaces='pygsp_tpu/core/chunked.py:206-250 '
                              '(chunked_spmm_chunks: XLA gather-sums per '
                              'block and one scatter-add of the tiers, no '
                              'Pallas kernel)')
    # the narrow entries: their headline at one column on paths H
    # and I's graph (estimate_lmax's product), every narrow shape of the
    # paths under at_paths
    source = 'pygsp_tpu_torch/csrc/ell_spmm.cu'
    widths = (f'{ell_kernel.SLOT_NARROW_WIDTH[torch.float32]} f32, '
              f'{ell_kernel.SLOT_NARROW_WIDTH[torch.float64]} f64 and '
              f'{ell_kernel.SLOT_NARROW_WIDTH[torch.bfloat16]} bf16 columns')
    ell_narrow = dict(
        narrow_h['H']['1_float32'], name='ell_spmm_narrow', route='cuda',
        source=source, at_paths=narrow_h,
        replaces=f'{ell["replaces"]}, at up to {widths}')
    chunked_narrow = dict(
        narrow_i['I']['1_float32'], name='chunked_spmm_narrow',
        route='cuda', source=source, at_paths=narrow_i,
        replaces=f'{chunked_k["replaces"]}, at up to {widths}')
    # the SDDMM: its headline at path K's 128 columns, one column beside
    kernel_sddmm = dict(
        sddmm[str(N_SIGNALS)], name='csr_sddmm', route='cuda',
        source='pygsp_tpu_torch/csrc/csr_sddmm.cu',
        replaces='pygsp_tpu/core/sparse.py:282-289 under jax.grad with '
                 'respect to mat.vals (the transposes of the gather and '
                 'segment_sum, XLA, no Pallas kernel)',
        at_one_column=sddmm['1'],
        launches_per_backward=path_k['backward_launches']['csr_sddmm'])
    # kernel A's fused entry: its headline at path K's 128 columns on the
    # transpose of path A's off-diagonal, 200 f32 and 64 f64 beside
    fused = path_k.pop('fused')
    head = f'{N_SIGNALS}_float32'
    kernel_fused = dict(
        fused[head], name='csr_spmm_sddmm', route='cuda',
        source='pygsp_tpu_torch/csrc/csr_spmm.cu',
        replaces='pygsp_tpu/core/sparse.py:282-289 under jax.grad with '
                 'respect to mat.vals and x (the transposes of the gather '
                 'and segment_sum, XLA, no Pallas kernel), in one pass',
        at_shapes={k: v for k, v in fused.items() if k != head},
        launches_per_backward=path_k['backward_launches']['csr_spmm_sddmm'])
    # the fused fold: its headline at L3's 128 f32 columns (four ring
    # matrices of device (0, 0) of the 4 x 4 partition of path A's graph),
    # L4's groups beside; since fold_strip_multi took its place on the
    # path, it runs in the measurements alone
    replaces = ('pygsp_tpu/core/windowed.py:201-418 '
                '(windowed_spmm_chunks_multi: XLA gathers, one-hot einsums '
                'summed per out chunk, one strip; no Pallas kernel), called '
                'by pygsp_tpu/parallel/twod.py:659-673')
    kernel_multi = dict(
        multi.pop('L3'), name='windowed_fold_multi', route='cuda',
        source='pygsp_tpu_torch/csrc/windowed_fold.cu', at_shapes=multi,
        replaces=replaces + ' (the fold, into a window tensor)')
    # the fused SpMM in one launch: its headline at L3, L4's two groups
    # and path C's one matrix beside
    kernel_fold_strip = dict(
        fused_l.pop('L3'), name='fold_strip_multi', route='cuda',
        source='pygsp_tpu_torch/csrc/windowed_fold.cu',
        at_shapes={**fused_l, 'C_one_matrix': path_c['spmm'].pop(
            'fold_strip_one_matrix')},
        replaces=replaces + ' (fold, overlap-add and residue tiers in one '
                            'launch, no window tensor)')
    by_path = {'A': counts_a, 'B': counts_b, 'C': counts_c, 'D': counts_d,
               'H': counts_h, 'I': counts_i}
    for kernel, served in ((csr, 'A'), (csr_narrow, None), (banded, 'B'),
                           (fold, 'CD'),
                           (strip, 'CD'), (fold2, None), (double, None),
                           (kb_step, 'ABCDHI'), (kb_group, 'ABCDHI'),
                           (kb_dot, None), (kb_contract, None),
                           (ell, 'H'), (chunked_k, 'I'), (ell_narrow, 'H'),
                           (chunked_narrow, 'I'), (kernel_sddmm, None),
                           (kernel_fused, None), (kernel_multi, None),
                           (kernel_fold_strip, None)):
        name = kernel['name']
        served = list(served or by_path)
        launches = {**{p: by_path[p][0][name] for p in by_path},
                    **{p: other[p][name] for p in other}}
        kernel.update(
            launches=sum(launches.values()),
            launches_per_bank=sum(by_path[p][1][name] for p in served),
            launches_by_path=launches)
    print(card(), flush=True)
    csr['launches_wide'] = sum(
        [by_path[p][0]['csr_spmm_wide'] for p in by_path]
        + [other[p]['csr_spmm_wide'] for p in other])
    print(json.dumps({'kernels': [csr, csr_narrow, banded, fold, strip,
                                  fold2, double,
                                  kb_step, kb_group, kb_contract, kb_dot,
                                  ell, chunked_k, ell_narrow,
                                  chunked_narrow, kernel_sddmm,
                                  kernel_fused, kernel_multi,
                                  kernel_fold_strip]}),
          flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
