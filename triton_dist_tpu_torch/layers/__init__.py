"""Layers (counterpart of ``triton_dist_tpu/layers``). The
sequence-parallel layers are importable from here under JAX's module names,
``ulysses_sp`` and ``sp_flash_decode`` (the latter raises: ROADMAP.md queue
A item 6); the other modules are imported by path."""

from triton_dist_tpu_torch.layers import sp_flash_decode, ulysses_sp  # noqa: F401
