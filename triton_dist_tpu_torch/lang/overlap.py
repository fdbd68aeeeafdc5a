"""Rank-swizzled chunk schedules (counterpart of the schedule generator of
``triton_dist_tpu/lang/overlap.py``: ``SWIZZLE_MODES``, ``chunk_at``,
``step_of``, ``schedule`` and ``ring_chunk``).

Pure index arithmetic on Python ints, equal to the JAX functions. The
fused-GEMM kernels (``csrc/ag_gemm.cu``, ``csrc/gemm_rs.cu``) compute the
same arithmetic in CUDA; the plain versions of the ops
(:mod:`triton_dist_tpu_torch.ops`) walk these functions. The panel
stager, stream planner and ring pumps of the JAX module drive TPU DMA
semaphores and have no counterpart here.

- ``"ag"`` (all-gather consumer): chunk ``(rank - step) % world``, the
  local chunk first, then ring-arrival order.
- ``"rs"`` (reduce-scatter producer): chunk ``(rank - step - 1) % world``,
  so each chunk's running sum visits ranks in ring order and ends at its
  owner.
- ``"a2a"`` (all-to-all consumer): chunk ``(rank + step) % world``.
- ``"identity"``: chunk ``step``.

The hierarchical (outer x inner) fused GEMMs walk the two 2D schedules
:func:`ag_2d_step` and :func:`rs_2d_step`, the index maps of JAX's
``_ag_gemm_2d`` (``ops/ag_gemm.py:616-620``, ``:807-814``) and
``_gemm_rs_2d`` (``ops/gemm_rs.py:462-469``); the CUDA kernels
(``csrc/ag_gemm.cu``, ``csrc/gemm_rs.cu``) compute the same arithmetic.
"""

from __future__ import annotations

SWIZZLE_MODES = ("ag", "rs", "a2a", "identity")


def _check_mode(mode: str) -> None:
    if mode not in SWIZZLE_MODES:
        raise ValueError(f"unknown swizzle_mode {mode!r} "
                         f"(expected one of {SWIZZLE_MODES})")


def chunk_at(step: int, rank: int, world: int, mode: str) -> int:
    """Chunk id computed at grid ``step`` by ``rank`` under ``mode``."""
    _check_mode(mode)
    if mode == "ag":
        return (rank - step) % world
    if mode == "rs":
        return (rank - step - 1) % world
    if mode == "a2a":
        return (rank + step) % world
    return step


def step_of(chunk: int, rank: int, world: int, mode: str) -> int:
    """Inverse of :func:`chunk_at`: the step at which ``rank`` computes
    ``chunk``."""
    _check_mode(mode)
    if mode == "ag":
        return (rank - chunk) % world
    if mode == "rs":
        return (rank - chunk - 1) % world
    if mode == "a2a":
        return (chunk - rank) % world
    return chunk


def schedule(rank: int, world: int, n_chunks: int, mode: str) -> tuple:
    """The whole traversal order of ``rank``. ``n_chunks`` must equal
    ``world`` for the ring modes; ``"identity"`` takes any count."""
    _check_mode(mode)
    if mode != "identity" and n_chunks != world:
        raise ValueError(f"mode {mode!r} schedules exactly world="
                         f"{world} chunks (got n_chunks={n_chunks})")
    return tuple(chunk_at(s, rank, world, mode) for s in range(n_chunks))


def ring_chunk(event: int, rank: int, world: int) -> int:
    """Chunk delivered to ``rank`` by ring event ``event`` of a rightward
    all-gather ring: 0 is the local chunk, event ``r >= 1`` the chunk that
    left rank ``rank - r``."""
    return (rank - event) % world


def ag_2d_step(q: int, o: int, i: int, n_o: int, n_in: int) -> tuple:
    """Step ``q = s·n_in + t`` of the hierarchical AG+GEMM on rank (o, i):
    super-step s walks outer column ``col = (o - s) % n_o``, inner ring
    step t its chunk from inner rank ``src = (i - t) % n_in``. Returns
    ``(col, src, col·n_in + src)``, the last the global chunk."""
    s, t = divmod(q, n_in)
    col, src = (o - s) % n_o, (i - t) % n_in
    return col, src, col * n_in + src


def rs_2d_step(q: int, o: int, i: int, n_o: int, n_in: int) -> tuple:
    """Step ``q = t·n_in + s`` of the hierarchical GEMM+RS on rank (o, i):
    super-step t reduces the chunks bound for outer group ``o_dst = (o +
    n_o - 1 - t) % n_o`` (the rank's own group last), inner ring step s
    its inner chunk ``(i - s - 1) % n_in``. Returns ``(o_dst,
    o_dst·n_in + chunk)``, the last the global chunk."""
    t, s = divmod(q, n_in)
    o_dst = (o + n_o - 1 - t) % n_o
    return o_dst, o_dst * n_in + (i - s - 1) % n_in
