"""Symmetric workspaces of the simulated ranks (counterpart of
``triton_dist_tpu/shmem``)."""
