"""Kernel-language helpers (counterpart of ``triton_dist_tpu/lang``)."""
