"""Simulated tensor-parallel ranks on one device (counterpart of
``triton_dist_tpu/parallel/mesh.py``: ``make_mesh`` and ``MeshContext``).

The JAX package lays a :class:`jax.sharding.Mesh` over devices and runs
one SPMD program per device. The port runs the ``tp`` ranks of a mesh
inside one process on one device: each rank's activations and weight
shard are one slice of a tensor whose leading dimension is the rank, and
each fused op is one kernel launch in which every rank's thread blocks
run the JAX kernel's put → signal → wait protocol against each other
through a symmetric workspace (:mod:`triton_dist_tpu_torch.shmem`). Each
rank computes only its own shard, so the results are the real tp = n
results. The canonical axes are kept; only ``tp`` may exceed 1. The
expert-parallel regime runs over the ``tp`` ranks (``Engine(...,
moe_impl="ep")``, as JAX's engine builds its ``EPContext`` over its ``tp``
axis); a mesh with an ``ep`` axis of its own (a two-axis simulated mesh)
is ROADMAP.md queue A item 5, sequence parallelism item 6, and data and
pipeline parallelism have no port yet.
"""

from __future__ import annotations

import dataclasses

import torch

from triton_dist_tpu_torch.utils.device import resolve_device

AXIS_ORDER = ("dp", "pp", "ep", "sp", "tp")
_NOT_PORTED = {"dp": "data parallelism is not ported",
               "pp": "pipeline parallelism is not ported",
               "ep": "the expert-parallel regime runs over the tp axis, "
                     "Engine(moe_impl='ep'); an ep axis of its own is "
                     "ROADMAP.md queue A item 5",
               "sp": "sequence parallelism is ROADMAP.md queue A item 6"}


@dataclasses.dataclass(frozen=True)
class MeshContext:
    """The mesh as the ops see it: axis names (outer → inner), their
    sizes, and the one device every simulated rank lives on."""

    axes: tuple
    sizes: tuple
    device: torch.device

    def size(self, axis: str) -> int:
        return self.sizes[self.axes.index(axis)]

    @property
    def tp(self) -> int:
        return self.size("tp")


def make_mesh(*, dp: int = 1, pp: int = 1, ep: int = 1, sp: int = 1,
              tp: int = 1, device=None) -> MeshContext:
    """``tp`` simulated ranks on ``device`` (``None``: the card, as
    :func:`~triton_dist_tpu_torch.utils.device.resolve_device` has it;
    ``"cpu"`` runs every op's plain version). Every other axis must be 1."""
    sizes = {"dp": dp, "pp": pp, "ep": ep, "sp": sp, "tp": tp}
    for axis, size in sizes.items():
        if size < 1:
            raise ValueError(f"mesh axis {axis}={size} must be >= 1")
        if axis != "tp" and size > 1:
            raise ValueError(f"mesh axis {axis}={size}: the port simulates "
                             f"tp ranks only ({_NOT_PORTED[axis]})")
    return MeshContext(axes=AXIS_ORDER,
                       sizes=tuple(sizes[a] for a in AXIS_ORDER),
                       device=resolve_device(device))
