"""A mesh of ranks with named axes, and the collectives the engines use.

The JAX package runs its engines inside ``jax.shard_map`` over a
``jax.sharding.Mesh`` of devices. The port runs one process per device
(``torch.distributed``), so its :class:`Mesh` is a grid of ranks: the
world's ranks in row-major order over the named axes (the JAX package's
``devices.reshape(...)``), one process group per line of each axis, and
this rank's place in the grid. The collectives translate as:

- ``lax.ppermute`` by a ring shift → :func:`ppermute`, one
  ``batch_isend_irecv`` for all the shifts of a step, posted in the same
  order on every rank (a shift whose peer is the rank itself, as on an
  axis of size 1, is no exchange: gloo cannot send to its own rank);
- ``psum`` → :func:`psum` (``all_reduce``);
- ``all_gather(tiled=True)`` → :func:`all_gather`
  (``all_gather_into_tensor``);
- ``psum_scatter(tiled=True)`` → :func:`psum_scatter`
  (``reduce_scatter_tensor``).

Without a process group a mesh (of one rank) issues no collective, as the
JAX package skips its ``ppermute`` when there is one shard; with one,
:func:`psum` runs its ``all_reduce`` on an axis of one rank too. Backends:
NCCL on the card, gloo on the CPU
(:func:`~pygsp_tpu_torch.parallel.launch.initialize`).
"""

from __future__ import annotations

import warnings

import torch
import torch.distributed as dist


def _world():
    """``(rank, world size)`` of this process; (0, 1) without a process
    group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _default_device(rank: int, device) -> torch.device:
    """This rank's device: ``devices[rank]`` of a list, the one device
    given, or by default the card ``rank % device_count``."""
    if isinstance(device, (list, tuple)):
        device = device[rank]
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and device.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError('make_mesh: no CUDA device is available; '
                               "pass devices='cpu' to run on the CPU")
        device = torch.device('cuda', rank % torch.cuda.device_count())
    return device


class Mesh:
    """Ranks ``0 .. n-1`` of the world laid out row-major over the named
    axes ``shape`` (an ordered ``{name: size}``), with one process group per
    line of each axis where the world has a process group. ``coords`` is
    this rank's place, ``device`` its device. Every rank of the world builds
    the mesh (process groups are made collectively); a rank past the mesh's
    size has ``coords`` None and runs no engine."""

    def __init__(self, shape: dict, devices=None):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)
        self.size = 1
        for n in self.shape.values():
            self.size *= int(n)
        self.rank, world = _world()
        if self.size > world:
            raise ValueError(f'a mesh of {self.size} ranks needs as many '
                             f'processes; the world has {world}')
        self.coords = (self._coords(self.rank) if self.rank < self.size
                       else None)
        self.device = _default_device(self.rank, devices)
        # with a process group, every axis gets its groups, one of a rank
        # too: psum then runs its all_reduce on every axis, as it does on
        # the card at one rank
        self.groups = {}
        if not (dist.is_available() and dist.is_initialized()):
            return
        for a, name in enumerate(self.axis_names):
            for line in self._lines(a):
                group = dist.new_group(line)
                if self.rank in line:
                    self.groups[name] = group

    def _coords(self, rank: int) -> tuple:
        out = []
        for name in reversed(self.axis_names):
            rank, c = divmod(rank, self.shape[name])
            out.append(c)
        return tuple(reversed(out))

    def _rank_of(self, coords) -> int:
        r = 0
        for name, c in zip(self.axis_names, coords):
            r = r * self.shape[name] + c
        return r

    def _lines(self, a: int) -> list:
        """Every line of ranks along axis ``a``, in rank order."""
        name = self.axis_names[a]
        lines = {}
        for r in range(self.size):
            c = list(self._coords(r))
            c[a] = 0
            lines.setdefault(tuple(c), []).append(r)
        return [lines[k] for k in sorted(lines)]

    def index(self, name: str) -> int:
        """This rank's coordinate along axis ``name``."""
        return self.coords[self.axis_names.index(name)]

    def peer(self, name: str, shift: int) -> int:
        """The global rank ``shift`` steps along axis ``name``."""
        a = self.axis_names.index(name)
        c = list(self.coords)
        c[a] = (c[a] + shift) % self.shape[name]
        return self._rank_of(c)

    def __repr__(self):
        return (f'Mesh({self.shape}, rank={self.rank}, coords={self.coords}, '
                f'device={self.device})')


def ppermute(mesh: Mesh, name: str, sends) -> list:
    """``lax.ppermute`` by ring shifts along axis ``name``: for each
    ``(shift, tensor)`` of ``sends``, the tensor goes to the rank ``shift``
    ahead and the one ``shift`` behind sends this rank its own; returns the
    received tensors in order. All the exchanges are posted at once, in
    ``sends`` order; one whose peer is this rank returns its tensor."""
    out, ops = [], []
    for shift, t in sends:
        if shift % mesh.shape[name] == 0:
            out.append(t)
            continue
        t = t.contiguous()
        recv = torch.empty_like(t)
        tag = shift % mesh.shape[name]
        ops.append(dist.P2POp(dist.isend, t, mesh.peer(name, shift),
                              tag=tag))
        ops.append(dist.P2POp(dist.irecv, recv, mesh.peer(name, -shift),
                              tag=tag))
        out.append(recv)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def psum(mesh: Mesh, names, t: torch.Tensor) -> torch.Tensor:
    """``psum`` over the axes ``names``, in place on ``t`` (an
    ``all_reduce`` on each axis's group, where there is a process
    group)."""
    for name in (names,) if isinstance(names, str) else names:
        if name in mesh.groups:
            dist.all_reduce(t, group=mesh.groups[name])
    return t


def all_gather(mesh: Mesh, name: str, t: torch.Tensor) -> torch.Tensor:
    """``all_gather(tiled=True)`` along axis ``name``: the ranks' tensors
    concatenated along dim 0 in axis order."""
    n = mesh.shape[name]
    if n == 1:
        return t
    t = t.contiguous()
    out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')      # newer torch prefers *_single
        dist.all_gather_into_tensor(out, t, group=mesh.groups[name])
    return out


def psum_scatter(mesh: Mesh, name: str, t: torch.Tensor) -> torch.Tensor:
    """``psum_scatter(scatter_dimension=0, tiled=True)`` along axis
    ``name``: the sum over the axis, this rank's dim-0 block of it."""
    n = mesh.shape[name]
    if n == 1:
        return t
    t = t.contiguous()
    out = torch.empty((t.shape[0] // n,) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        dist.reduce_scatter_tensor(out, t, group=mesh.groups[name])
    return out
