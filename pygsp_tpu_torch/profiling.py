"""Tracing and throughput counters.

Counterpart of :mod:`pygsp_tpu.profiling`:

- :func:`trace` records a ``torch.profiler`` trace of the CPU and, where
  there is one, the card, written for TensorBoard under ``log_dir``;
- :class:`Throughput` measures the achieved edge operations a second
  around any block, with the JAX package's fields and ``report()`` keys.

Departure by design: the port's calls return before the card has done
their work, so a bare host clock would read the time it takes to queue the
launches. :class:`Throughput`'s clock synchronizes the CUDA device of the
work (``device``; by default the current one where there is a card) when
it starts and when it stops, and so reads the card's time to finish the
block.
"""

from __future__ import annotations

import contextlib
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a CPU and CUDA trace viewable in TensorBoard (the
    ``torch.profiler`` plugin) under ``log_dir``; yields the profiler, so
    that ``key_averages()`` can be read after the block."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


class Throughput:
    """edges/s (and derived) counter for repeated filtering steps.

    >>> meter = Throughput(n_edges=1000, k_order=30, n_signals=8)
    >>> with meter:
    ...     pass  # run one filterbank application
    >>> meter.edge_ops >= 0
    True
    """

    def __init__(self, n_edges: int, k_order: int = 1, n_signals: int = 1,
                 *, device=None):
        self.edge_ops = n_edges * k_order * n_signals
        self.times = []
        if device is None:
            device = 'cuda' if torch.cuda.is_available() else 'cpu'
        device = torch.device(device)
        self._device = device if device.type == 'cuda' else None

    def _sync(self):
        if self._device is not None:
            torch.cuda.synchronize(self._device)

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.times.append(time.perf_counter() - self._t0)
        return False

    @property
    def last_s(self) -> float:
        return self.times[-1]

    @property
    def best_edge_ops_per_s(self) -> float:
        return self.edge_ops / min(self.times)

    def report(self) -> dict:
        best = min(self.times)
        return {'edge_ops': self.edge_ops,
                'best_ms': best * 1e3,
                'edge_ops_per_s': self.edge_ops / max(best, 1e-12),
                'runs': len(self.times)}
