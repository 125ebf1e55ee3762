"""Multi-process launch helpers on ``torch.distributed``.

Counterpart of :mod:`pygsp_tpu.parallel.launch`. A multi-process run is:
every process calls :func:`initialize` (which wires ``torch.distributed``:
NCCL on the card, gloo on the CPU), builds the same partition on the host
(the partitioner is deterministic) or slices its own rows of a shared
edge file (:func:`load_edge_shard`), keeps its shard on its device
(:func:`put_sharded_graph`), and then calls the same engine on its slice
of the signal. Nothing tells a program of a cluster: the address, the
number of processes and this process's rank are passed in.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from pygsp_tpu_torch.parallel.mesh import Mesh, _world
from pygsp_tpu_torch.parallel.partition import shard_slice


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *, device='cuda') -> None:
    """Wire up ``torch.distributed`` when there is more than one process
    or an address is given (a no-op otherwise, as in the JAX package).

    ``coordinator_address``: ``'host:port'`` (TCP), or an ``init_method``
    URL (``'tcp://...'``, ``'file://...'``). ``device``: ``'cuda'`` (NCCL,
    this process on card ``process_id % device_count``) or ``'cpu'``
    (gloo)."""
    if not ((num_processes is not None and num_processes > 1)
            or coordinator_address):
        return
    if dist.is_initialized():
        return
    url = coordinator_address or 'tcp://localhost:29500'
    if '://' not in url:
        url = f'tcp://{url}'
    rank = int(process_id or 0)
    if torch.device(device).type == 'cuda':
        torch.cuda.set_device(rank % torch.cuda.device_count())
        backend = 'nccl'
    else:
        backend = 'gloo'
    dist.init_process_group(backend, init_method=url,
                            world_size=int(num_processes or 1), rank=rank)


def global_mesh(n_graph: int | None = None, n_batch: int = 1, *,
                device=None) -> Mesh:
    """('graph', 'batch') mesh over all the processes' ranks, graph axis
    major (by default every rank on the graph axis). ``device``: this
    rank's (default its card, ``rank % device_count``)."""
    _, total = _world()
    if n_graph is None:
        n_graph = total // n_batch
    if n_graph * n_batch > total:
        raise ValueError(f'{n_graph} x {n_batch} > {total} ranks')
    return Mesh({'graph': n_graph, 'batch': n_batch}, device)


def process_shard_range(n_items: int) -> tuple[int, int]:
    """[lo, hi) slice of a globally shared work list owned by this
    process (by its rank and the world's size)."""
    p, n = _world()
    per = -(-n_items // n)
    return p * per, min((p + 1) * per, n_items)


def put_sharded_graph(sg, mesh: Mesh):
    """Keep this rank's shard of a host-built partition on its device.

    Every process calls this with the identical partition; the result
    holds the rank's shard of each per-shard tensor (leading axis 1) on
    ``mesh.device``, and ``perm`` whole. The engines take either."""
    s = mesh.index('graph')
    part = shard_slice(sg, s)
    return dataclasses.replace(
        part, **{f.name: _to(getattr(part, f.name), mesh.device)
                 for f in dataclasses.fields(part)
                 if isinstance(getattr(part, f.name), (torch.Tensor, tuple))})


def _to(v, device):
    if isinstance(v, tuple):
        return tuple(_to(w, device) for w in v)
    return v.to(device) if isinstance(v, torch.Tensor) else v


def load_edge_shard(path: str, n_vertices: int):
    """Load this process's contiguous row-range slice of an edge-list file.

    The file is an ``.npz`` with ``src``/``tgt`` (and optional ``weight``)
    arrays; returns ``(src, tgt, weight, (lo, hi))`` for the rows in this
    process's range (:func:`process_shard_range`)."""
    lo, hi = process_shard_range(n_vertices)
    with np.load(path) as d:
        src, tgt = d['src'], d['tgt']
        w = d['weight'] if 'weight' in d else np.ones(len(src))
    mask = (src >= lo) & (src < hi)
    return src[mask], tgt[mask], w[mask], (lo, hi)
