"""What the windowed-compact format shares with the chunked one.

Counterpart of the parts of :mod:`pygsp_tpu.core.chunked` that
:mod:`pygsp_tpu_torch.core.windowed` uses: the default chunk size, the
residue tiers (:class:`ChunkLevel`), the signal chunking helpers and the
vertex-relabeling permutes; and the per-tier gather-sum
(:func:`_slot_block_sum`, the counterpart of
``pygsp_tpu/core/sparse.py:_slot_block_sum``), a plain version kept for
the ELL and chunked formats to come (the windowed SpMM adds its tiers in
its tail kernel, ``windowed_kernel.window_strip``). The chunked format
itself (``ChunkedELLMatrix``) is not ported yet: see ROADMAP.md, "Modules
to port", item 4.
"""

from __future__ import annotations

import dataclasses

import torch

# Default source/output chunk size, the JAX package's (its TPU gather
# window). The windowed builder sizes its chunks from it.
CHUNK_ROWS = 1 << 16


@dataclasses.dataclass(frozen=True)
class ChunkLevel:
    """Overflow slot tier for one source chunk.

    ``cols``/``vals``: (m, lw) slot arrays for the m spilling rows, in the
    order of the owning matrix's ``level_rows``; ``cols`` local to
    ``src_chunk``, with sentinel ``== chunk_rows`` (zero value, never read).
    """

    cols: torch.Tensor
    vals: torch.Tensor
    src_chunk: int


def chunk_signal(x: torch.Tensor, chunk_rows: int) -> tuple:
    """Split the leading axis into views of ``chunk_rows`` rows."""
    return tuple(torch.split(x, chunk_rows, dim=0))


def unchunk_signal(chunks, axis: int = 0) -> torch.Tensor:
    return chunks[0] if len(chunks) == 1 else torch.cat(chunks, dim=axis)


def permute_in(mat, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Original-order signal → the matrix's internal (relabeled) order."""
    if mat.perm is None:
        return x
    return torch.index_select(x, axis, mat.perm)


def permute_out(mat, y: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Internal (relabeled) order → original vertex order."""
    if mat.perm is None:
        return y
    return torch.index_select(y, axis, mat.iperm)


def _slot_block_sum(cols, vals, x, out_dtype=None) -> torch.Tensor:
    """``Σ_d vals[:, d] · x[cols[:, d]]`` for (m, w) slot arrays over x
    (n, S), one source chunk: (m, S) rows. Each product is formed in the
    promotion of the two dtypes; ``out_dtype`` (default: that promotion)
    upcasts it before the sum, as the JAX package's does, so that the bf16
    modes read narrow operands and still sum in float32.

    The JAX package scans over 8-wide width chunks to bound XLA's
    temporaries; the windowed format's tiers are at most 8 wide, so here
    the (m, w, S) products are made at once (four launches a tier, not
    four per slot column). Sentinel slots (``cols >= n``) hold zero
    values; their index is clamped, as the JAX gather clamps it, and their
    product is masked to zero, so a non-finite row of x never leaks in.
    """
    n = x.shape[0]
    live = (cols < n)[..., None]
    idx = torch.clamp(cols, max=n - 1).to(torch.long)
    p = vals[..., None] * x[idx]                             # (m, w, S)
    if out_dtype is not None:
        p = p.to(out_dtype)
    return torch.where(live, p, torch.zeros((), dtype=p.dtype,
                                            device=p.device)).sum(dim=1)
