"""Multi-device execution on ``torch.distributed``: graph partitioning and
the sharded spectral engines.

Counterpart of :mod:`pygsp_tpu.parallel`, the JAX package's scale-out
layer: a 1-D vertex/edge partition of the graph over a mesh axis with a
halo exchange of boundary rows each Chebyshev step (:mod:`.partition`,
:mod:`.windowed_shards`, :mod:`.sharded`), the 2-D edge partition whose
traffic does not depend on the graph (:mod:`.twod`), and the launch
helpers (:mod:`.launch`).

How ``shard_map`` translates to PyTorch:

- **The mesh.** :class:`~.mesh.Mesh` lays the world's ranks out row-major
  over named axes (``('graph', 'batch')`` for the 1-D engine,
  ``('row', 'col')`` for the 2-D one), with one ``torch.distributed``
  process group per line of each axis; :func:`make_mesh`,
  :func:`make_mesh_2d` and :func:`global_mesh` build it from the world.
- **One process needs no init.** Without ``init_process_group``,
  ``make_mesh(1, 1)`` is a mesh that issues no collective, as the JAX
  package skips its ``ppermute`` for one shard.
- **What each rank holds.** Every rank builds the identical host
  partition (the partitioner is deterministic);
  :func:`put_sharded_graph` keeps only the rank's own shard on its
  device. The engines take either.
- **Signals are local.** ``x`` and every result are the calling rank's
  slice: its ``n_local`` rows, and its column block when ``n_batch > 1``.
  A (1, 1) mesh takes the whole padded signal.
- **Collectives** (:mod:`.mesh`): ``lax.ppermute`` →
  ``dist.batch_isend_irecv``, one pair per ring distance, posted in
  ``halo_dists`` order on every rank and waited for in a second step, so
  that a fold runs under it; ``psum`` → ``all_reduce``;
  ``all_gather(tiled=True)`` → ``all_gather_into_tensor``;
  ``psum_scatter`` → ``reduce_scatter_tensor``. NCCL on the card, gloo on
  the CPU. gloo cannot send to its own rank, so an exchange whose peer is
  the rank itself (``p = 1``, ``pr = 1``, ``pc = 1``) is skipped, as in the
  JAX package.
- **Local products** on the port's kernels: kernel A on each shard's CSR
  (the COO layout), the ELL kernel, kernels D and E (the windowed
  layouts), and the fused multi-matrix fold (the 2-D ring layouts); the
  recurrence on kernel B.
- **What stays the JAX package's.** Its chunk-carried tuples
  (``_chunkcarried_scan``) are XLA's memory device; the port runs the
  recurrence on whole tensors and sums the same terms.
- **Under autograd** the bank, the synthesis and the matvec of both
  engines are autograd Functions: the forward is the engine's own, the
  backward runs engine calls of its own through the same exchanges
  (x̄ the synthesis of the cotangent, ȳ the bank of it, c̄ one more
  recurrence summed over the mesh, so every rank holds the whole c̄, as
  ``jax.grad`` gives a replicated ``c``). λ̄ and the partition's
  cotangents are not taken: a λmax or partition tensor that requires
  grad raises, as do the bf16 modes and an exchange given a tensor that
  requires grad.
- **Its schedules are the port's.** Each exchange is posted before the
  fold that does not read it and waited for after: the 1-D halo under the
  interior fold of the split layouts, the 2-D ring's row shifts under
  ring step 0's fold, each column hop under its position's fold.

Layout choice (the JAX package's, measured on its TPU): the 1-D partition
with ``shard_local_windowed(split_boundary=True)`` for mesh- or
community-local graphs; the 2-D partition with
``twod_local_windowed(ring=True, split_cols=True)`` for expanders.
"""

from pygsp_tpu_torch.parallel.partition import (ShardedGraph, ShardedELL,
                                                cluster_shards,
                                                partition_graph,
                                                shard_local_ell)
from pygsp_tpu_torch.parallel.sharded import (
    sharded_matvec, sharded_cheby_op, sharded_cheby_op_fixed_graph,
    sharded_cheby_synthesis, make_mesh)
from pygsp_tpu_torch.parallel.windowed_shards import (ShardedWindowed,
                                                      shard_local_windowed)
from pygsp_tpu_torch.parallel.launch import (global_mesh, initialize,
                                             load_edge_shard,
                                             process_shard_range,
                                             put_sharded_graph)
from pygsp_tpu_torch.parallel.twod import (TwoDGraph, cheby_op_2d,
                                           cheby_op_2d_fixed_graph,
                                           cheby_synthesis_2d, make_mesh_2d,
                                           matvec_2d, partition_graph_2d,
                                           twod_local_windowed)
from pygsp_tpu_torch.parallel.mesh import Mesh

__all__ = ['ShardedGraph', 'ShardedELL', 'ShardedWindowed',
           'cluster_shards',
           'partition_graph', 'shard_local_ell', 'shard_local_windowed',
           'sharded_matvec', 'sharded_cheby_op',
           'sharded_cheby_op_fixed_graph', 'sharded_cheby_synthesis',
           'make_mesh', 'initialize', 'global_mesh', 'process_shard_range',
           'load_edge_shard', 'put_sharded_graph',
           'TwoDGraph', 'partition_graph_2d', 'make_mesh_2d', 'matvec_2d',
           'cheby_op_2d', 'cheby_op_2d_fixed_graph',
           'cheby_synthesis_2d', 'twod_local_windowed']
