"""Layers (counterpart of ``triton_dist_tpu/layers``). The
sequence-parallel layers and the pipeline layer are importable from here
under JAX's module names, ``ulysses_sp``, ``sp_flash_decode`` (which
raises: ROADMAP.md queue A item 6) and ``pp_comm``; the other modules are
imported by path."""

from triton_dist_tpu_torch.layers import (  # noqa: F401
    pp_comm, sp_flash_decode, ulysses_sp)
