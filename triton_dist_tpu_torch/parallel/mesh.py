"""Simulated ranks on one device (counterpart of
``triton_dist_tpu/parallel/mesh.py``: ``make_mesh``, ``MeshContext``,
``logical_device_id`` and ``flat_axis_rank``).

The JAX package lays a :class:`jax.sharding.Mesh` over devices and runs
one SPMD program per device. The port runs every rank of a mesh inside
one process on one device: each rank's activations and weight shard are
one slice of a tensor whose leading dimension is the rank, and each fused
op or collective is one kernel launch in which every rank's thread blocks
run the JAX kernel's put → signal → wait protocol against each other
through a symmetric workspace (:mod:`triton_dist_tpu_torch.shmem`). Each
rank computes only its own shard, so the results are the real ones.

The canonical axes are kept, outer → inner (``dp, pp, ep, sp, tp``), and
a rank's flat index is row-major over them, as JAX linearizes logical
device ids: on ``make_mesh(dp=n_o, tp=n_in)`` rank ``r = o·n_in + i`` has
outer coordinate o and inner coordinate i, the order in which
``shard_map`` cuts a ``P(("dp", "tp"))`` dimension. An op over one axis
runs independently in each group of ranks that share their other
coordinates (:meth:`MeshContext.device_id`); an op over an ``(outer,
inner)`` tuple spans both (the hierarchical forms). ``dp``, ``sp`` and
``tp`` may exceed 1. The expert-parallel regime runs over the ``tp`` ranks
(``Engine(..., moe_impl="ep")``, as JAX's engine builds its ``EPContext``
over its ``tp`` axis) or over the ``("dp", "tp")`` pair (JAX's
``EP2DContext``); an ``ep`` axis of its own is ROADMAP.md queue A item 5.
The sequence-parallel ops and layer (:mod:`~triton_dist_tpu_torch.ops.
ulysses`, :mod:`~triton_dist_tpu_torch.ops.sp_ag_attention`,
:mod:`~triton_dist_tpu_torch.layers.ulysses_sp`) run over the ``sp`` axis
of ``make_mesh(sp=n)`` (or, as JAX's tests run them, the ``tp`` axis of
``make_mesh(tp=n)``): each rank holds one slice of the sequence. The
pipeline layer (:mod:`~triton_dist_tpu_torch.layers.pp_comm`) and its
one-sided puts (:mod:`~triton_dist_tpu_torch.ops.p2p`) run over the ``pp``
axis of ``make_mesh(pp=n)``: rank r is stage r.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from triton_dist_tpu_torch.utils.device import resolve_device

AXIS_ORDER = ("dp", "pp", "ep", "sp", "tp")
_NOT_PORTED = {"ep": "the expert-parallel regime runs over the tp axis "
                     "or the ('dp', 'tp') pair, Engine(moe_impl='ep'); an "
                     "ep axis of its own is ROADMAP.md queue A item 5"}


def axis_names(axis) -> tuple:
    """``axis`` as a tuple of names: one name, or an ``(outer, inner)``
    tuple."""
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


@dataclasses.dataclass(frozen=True)
class MeshContext:
    """The mesh as the ops see it: axis names (outer → inner), their
    sizes, and the one device every simulated rank lives on."""

    axes: tuple
    sizes: tuple
    device: torch.device

    def size(self, axis) -> int:
        """Ranks along ``axis``; a tuple of axes spans the product of
        their sizes (JAX's ``flat_axis_rank`` total)."""
        return math.prod(self.sizes[self.axes.index(a)]
                         for a in axis_names(axis))

    @property
    def tp(self) -> int:
        return self.size("tp")

    @property
    def n_ranks(self) -> int:
        """Every rank of the mesh: the leading dimension of an operand."""
        return math.prod(self.sizes)

    def stride(self, axis: str) -> int:
        """Flat-rank distance between neighbours along ``axis``: the
        product of the sizes of the axes inside it."""
        return math.prod(self.sizes[self.axes.index(axis) + 1:])

    def rank(self, axis, r: int) -> int:
        """Flat rank ``r``'s coordinate along ``axis``; for a tuple, its
        outer-major index over them (JAX's ``flat_axis_rank``)."""
        me = 0
        for a in axis_names(axis):
            me = me * self.size(a) + (r // self.stride(a)) % self.size(a)
        return me

    def device_id(self, axis: str, target: int, r: int) -> int:
        """The flat rank with coordinate ``target`` along ``axis`` and
        ``r``'s coordinates along every other axis (JAX's
        ``logical_device_id``: where a put to "my peer ``target``"
        lands)."""
        return r + (target - self.rank(axis, r)) * self.stride(axis)


def make_mesh(*, dp: int = 1, pp: int = 1, ep: int = 1, sp: int = 1,
              tp: int = 1, device=None) -> MeshContext:
    """``dp x pp x sp x tp`` simulated ranks on ``device`` (``None``: the
    card, as :func:`~triton_dist_tpu_torch.utils.device.resolve_device` has
    it; ``"cpu"`` runs every op's plain version). ``ep`` must be 1."""
    sizes = {"dp": dp, "pp": pp, "ep": ep, "sp": sp, "tp": tp}
    for axis, size in sizes.items():
        if size < 1:
            raise ValueError(f"mesh axis {axis}={size} must be >= 1")
        if axis in _NOT_PORTED and size > 1:
            raise ValueError(f"mesh axis {axis}={size}: the port simulates "
                             f"dp x pp x sp x tp ranks only "
                             f"({_NOT_PORTED[axis]})")
    return MeshContext(axes=AXIS_ORDER,
                       sizes=tuple(sizes[a] for a in AXIS_ORDER),
                       device=resolve_device(device))
