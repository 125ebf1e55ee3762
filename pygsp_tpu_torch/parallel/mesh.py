"""A mesh of ranks with named axes, and the collectives the engines use.

The JAX package runs its engines inside ``jax.shard_map`` over a
``jax.sharding.Mesh`` of devices. The port runs one process per device
(``torch.distributed``), so its :class:`Mesh` is a grid of ranks: the
world's ranks in row-major order over the named axes (the JAX package's
``devices.reshape(...)``), one process group per line of each axis, and
this rank's place in the grid. The collectives translate as:

- ``lax.ppermute`` by a ring shift → :func:`ppermute_post`, one
  ``batch_isend_irecv`` for all the shifts of a step, posted in the same
  order on every rank (a shift whose peer is the rank itself, as on an
  axis of size 1, is no exchange: gloo cannot send to its own rank), and
  :func:`ppermute_wait`, which hands out what was received. Work the
  caller enqueues between the two runs under the transfer, as XLA
  schedules the JAX package's folds under its ``ppermute``;
  :func:`ppermute` is the two at once, and :func:`ppermute_chain_post` a
  chain of single shifts, each sending what the one before received (the
  2-D ring's all-gather along 'row');
- ``psum`` → :func:`psum` (``all_reduce``);
- ``all_gather(tiled=True)`` → :func:`all_gather`
  (``all_gather_into_tensor``);
- ``psum_scatter(tiled=True)`` → :func:`psum_scatter`
  (``reduce_scatter_tensor``).

The exchanges are invisible to autograd: a received tensor has no history,
so a cotangent would never return to the rank that sent it. Under grad
mode :func:`ppermute_post`, :func:`ppermute_chain_post`, :func:`all_gather`
and :func:`psum_scatter` refuse a tensor that requires grad; the engines
differentiate through autograd Functions whose forward and backward run
their exchanges with grad mode off.

Without a process group a mesh (of one rank) issues no collective, as the
JAX package skips its ``ppermute`` when there is one shard; with one,
:func:`psum` runs its ``all_reduce`` on an axis of one rank too. Backends:
NCCL on the card, gloo on the CPU
(:func:`~pygsp_tpu_torch.parallel.launch.initialize`).
"""

from __future__ import annotations

import contextlib
import warnings

import torch
import torch.distributed as dist
from torch.profiler import record_function


def scope(name: str):
    """A ``torch.profiler`` range of the name of the JAX package's
    ``jax.named_scope``, entered only while a profiler records: with none,
    the check costs the host a fraction of the microseconds that entering
    an empty range does."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return contextlib.nullcontext()


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
        self._side = {}          # CUDA device index -> the chains' stream
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

    def side_stream(self, device: torch.device) -> torch.cuda.Stream:
        """The stream on which this mesh posts its chains of shifts on
        ``device`` (:func:`ppermute_chain_post`), made at first use."""
        if device.index not in self._side:
            self._side[device.index] = torch.cuda.Stream(device)
        return self._side[device.index]

    def __repr__(self):
        return (f'Mesh({self.shape}, rank={self.rank}, coords={self.coords}, '
                f'device={self.device})')


class Exchange:
    """The exchanges that :func:`ppermute_post` or
    :func:`ppermute_chain_post` posted, until :func:`ppermute_wait`: the
    requests (``dist.Work``), the received tensors, and every tensor the
    transfers use, kept alive until then. ``then``: what the wait runs
    after the requests (the rest of a chain, a stream's wait)."""

    def __init__(self, works, recvs, keep=(), then=None):
        self.works, self.recvs, self.keep, self.then = works, recvs, keep, then


def _refuse_grad(name: str, *tensors):
    """Raise where grad mode is on and a tensor to send requires grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f'{name}: a tensor it sends requires grad, and the exchange is '
            f'invisible to autograd (its cotangent would not return to this '
            f'rank). Differentiate through the engines (sharded_cheby_op, '
            f'sharded_cheby_synthesis, sharded_matvec, cheby_op_2d, '
            f'cheby_synthesis_2d, matvec_2d), whose backward runs exchanges '
            f'of its own, or call it under torch.no_grad()')


def _post(mesh: Mesh, name: str, sends, recvs=None) -> Exchange:
    out, ops, keep = [], [], []
    for i, (shift, t) in enumerate(sends):
        if shift % mesh.shape[name] == 0:
            out.append(t)
            continue
        t = t.contiguous()
        recv = torch.empty_like(t) if recvs is None else recvs[i]
        tag = shift % mesh.shape[name]
        ops.append(dist.P2POp(dist.isend, t, mesh.peer(name, shift),
                              tag=tag))
        ops.append(dist.P2POp(dist.irecv, recv, mesh.peer(name, -shift),
                              tag=tag))
        keep.append(t)
        out.append(recv)
    works = dist.batch_isend_irecv(ops) if ops else []
    return Exchange(works, out, keep)


def _complete(works):
    for w in works:
        if w.wait() is False:
            raise RuntimeError('ppermute: an exchange did not complete')


def ppermute_post(mesh: Mesh, name: str, sends) -> Exchange:
    """Post ``lax.ppermute`` by ring shifts along axis ``name``: for each
    ``(shift, tensor)`` of ``sends`` the tensor goes to the rank ``shift``
    ahead, and the one ``shift`` behind sends this rank its own. All the
    exchanges are posted at once, in ``sends`` order; one whose peer is
    this rank posts nothing. Returns the handle that
    :func:`ppermute_wait` takes. Under grad mode a tensor that requires
    grad raises ``RuntimeError``.

    On NCCL the transfers run on NCCL's stream once the current stream's
    work so far is done, so what the caller enqueues after the post and
    before the wait runs under them. On gloo they run on gloo's threads."""
    _refuse_grad('ppermute_post', *(t for _, t in sends))
    return _post(mesh, name, sends)


def ppermute_chain_post(mesh: Mesh, name: str, t: torch.Tensor,
                        links: int) -> Exchange:
    """Post a chain of ``links`` single shifts along axis ``name``: link k
    sends what link k − 1 received (link 0 sends ``t``), so after the
    wait the k-th received tensor is ``t`` of the rank k + 1 behind (the
    JAX package's ``collect_sources``). Returns the handle that
    :func:`ppermute_wait` takes.

    On a CUDA tensor the whole chain is posted now on the mesh's side
    stream (:meth:`Mesh.side_stream`), which waits for the current
    stream's work so far and, before each link, for the link before: so
    work enqueued on the current stream after the post runs under the
    whole chain, and no link waits for it. The wait makes the current
    stream wait for the side stream. On the CPU (gloo, whose waits block
    the host) link 0 is posted now and each later one at the wait, once
    the buffer it sends has arrived. Under grad mode a ``t`` that requires
    grad raises ``RuntimeError``."""
    _refuse_grad('ppermute_chain_post', t)
    if links == 0 or mesh.shape[name] == 1:
        return Exchange([], [t] * links)
    recvs = [torch.empty_like(t) for _ in range(links)]
    if t.device.type != 'cuda':
        def rest():
            for k in range(1, links):
                _complete(_post(mesh, name, [(1, recvs[k - 1])],
                                [recvs[k]]).works)
        first = _post(mesh, name, [(1, t)], recvs[:1])
        return Exchange(first.works, recvs, (t,), rest)
    side = mesh.side_stream(t.device)
    current = torch.cuda.current_stream(t.device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        src = t
        for recv in recvs:
            _complete(_post(mesh, name, [(1, src)], [recv]).works)
            src = recv
    return Exchange([], recvs, (t,),
                    lambda: torch.cuda.current_stream(
                        t.device).wait_stream(side))


def ppermute_wait(handle: Exchange) -> list:
    """Wait for what :func:`ppermute_post` or :func:`ppermute_chain_post`
    posted and return the received tensors in order (a shift's own tensor
    where its peer is this rank). On NCCL the current stream waits and the
    host does not; on gloo the host blocks. A handle is waited for once;
    an exchange that failed raises."""
    if handle.recvs is None:
        raise RuntimeError('ppermute_wait: this exchange was already '
                           'waited for')
    _complete(handle.works)
    if handle.then is not None:
        handle.then()
    recvs = handle.recvs
    handle.works = handle.recvs = handle.keep = handle.then = None
    return recvs


def ppermute(mesh: Mesh, name: str, sends) -> list:
    """:func:`ppermute_post` and :func:`ppermute_wait` at once: the
    received tensors, for a caller that needs them now."""
    return ppermute_wait(ppermute_post(mesh, name, sends))


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
    concatenated along dim 0 in axis order. Under grad mode a ``t`` that
    requires grad raises ``RuntimeError``."""
    _refuse_grad('all_gather', t)
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
    ``name``: the sum over the axis, this rank's dim-0 block of it. Under
    grad mode a ``t`` that requires grad raises ``RuntimeError``."""
    _refuse_grad('psum_scatter', t)
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
