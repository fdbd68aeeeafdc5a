"""PyTorch/CUDA port of ``triton_dist_tpu`` for NVIDIA Hopper.

Module paths mirror the JAX package (``triton_dist_tpu_torch/serving/
blocks.py`` is the counterpart of ``triton_dist_tpu/serving/blocks.py``).
The port imports ``torch`` and numpy, never JAX and nothing of the JAX
package. Hand-written Hopper kernels live under ``csrc/`` and are built
by :mod:`triton_dist_tpu_torch.utils.build` on first launch.

Entry points run on the card unless the caller passes ``device="cpu"``;
on CPU tensors every kernel wrapper takes its plain PyTorch version.
``Engine(cfg, mesh=make_mesh(tp=n), mode="fused")`` runs n simulated
tensor-parallel ranks on the one device (:mod:`triton_dist_tpu_torch.
parallel.mesh`); ``Engine(cfg, mesh=make_mesh(dp=2, tp=2), axis=("dp",
"tp"))`` shards over both axes of a two-axis mesh (the hierarchical
forms).
"""

from triton_dist_tpu_torch.models import Engine, ModelConfig
from triton_dist_tpu_torch.parallel.mesh import MeshContext, make_mesh
from triton_dist_tpu_torch.serving import ServingEngine

__all__ = ["Engine", "MeshContext", "ModelConfig", "ServingEngine",
           "make_mesh"]
