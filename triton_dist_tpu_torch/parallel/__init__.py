"""Mesh conventions (counterpart of ``triton_dist_tpu/parallel``)."""

from triton_dist_tpu_torch.parallel.mesh import (AXIS_ORDER, MeshContext,
                                                 make_mesh)

__all__ = ["AXIS_ORDER", "MeshContext", "make_mesh"]
