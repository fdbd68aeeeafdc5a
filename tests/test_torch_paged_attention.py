"""Paged attention of the PyTorch port held against the JAX package's
Pallas kernels. The JAX side runs ``paged_flash_decode`` (local form)
and ``paged_flash_qblock`` as its own tests do on the CPU, in Pallas
interpret mode; the port's wrappers get CPU tensors, so they run their
plain versions. Cases: ragged lengths, a page-boundary length, a parked
slot (all-zero table row, length clamped to one), padded chunk rows
clamped to the last valid position, GQA rep > 1. fp32, atol 1e-5.

The CUDA kernels themselves are held against the same plain versions on
the card by ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_dist_tpu.ops.paged_flash_decode import (
    paged_flash_decode as jax_decode,
)
from triton_dist_tpu.ops.paged_flash_qblock import (
    paged_flash_qblock as jax_qblock,
)
from triton_dist_tpu_torch.ops.paged_flash_decode import paged_flash_decode
from triton_dist_tpu_torch.ops.paged_flash_qblock import paged_flash_qblock

KVH, HD, PAGE, P_MAX = 2, 8, 8, 4
ATOL = 1e-5


def _pool(rng, b):
    """Random pool + shuffled per-slot tables (page 0 = scratch)."""
    num_pages = 1 + b * P_MAX
    kp = rng.randn(num_pages, KVH, PAGE, HD).astype(np.float32)
    vp = rng.randn(num_pages, KVH, PAGE, HD).astype(np.float32)
    tbl = (1 + rng.permutation(num_pages - 1)).reshape(b, P_MAX)
    return kp, vp, tbl.astype(np.int32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("rep", [2, 4])
def test_paged_decode_matches_jax_kernel(rep):
    rng = np.random.RandomState(rep)
    b, h = 4, KVH * rep
    kp, vp, tbl = _pool(rng, b)
    tbl[0] = 0                                  # parked slot: scratch row
    kv_len = np.array([1, PAGE, 2 * PAGE + 3, P_MAX * PAGE], np.int32)
    q = rng.randn(b, h, HD).astype(np.float32)
    want = jax.jit(lambda *a: jax_decode(*a, axis=None))(
        *map(jnp.asarray, (q, kp, vp, tbl, kv_len)))
    got = paged_flash_decode(*_t(q, kp, vp, tbl, kv_len))
    assert got.shape == (b, h, HD) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("rep", [2, 4])
def test_paged_qblock_matches_jax_kernel(rep):
    rng = np.random.RandomState(10 + rep)
    b, c, h = 3, 8, KVH * rep
    kp, vp, tbl = _pool(rng, b)
    tbl[2] = 0                                  # parked slot
    start, valid = 5, 5                         # chunk with 3 padded rows
    chunk = start + np.arange(c)
    chunk[valid:] = start + valid - 1
    pos = np.stack([chunk,
                    16 + np.arange(c),          # crosses a page boundary
                    np.zeros(c, np.int64)]).astype(np.int32)
    q = rng.randn(b, c, h, HD).astype(np.float32)
    want = jax.jit(jax_qblock)(*map(jnp.asarray, (q, kp, vp, tbl, pos)))
    got = paged_flash_qblock(*_t(q, kp, vp, tbl, pos))
    assert got.shape == (b, c, h, HD) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_unported_forms_raise():
    rng = np.random.RandomState(0)
    kp, vp, tbl = _pool(rng, 1)
    q, kpt, vpt, tblt = _t(rng.randn(1, 4, HD).astype(np.float32), kp, vp,
                           tbl)
    lens = torch.tensor([3], dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        paged_flash_decode(q, kpt, vpt, tblt, lens, axis="sp")
    # Quantized pools are ported: a scaleless read of one, and scales
    # beside an unquantized pool, raise (the JAX readers' contract).
    with pytest.raises(ValueError, match="QUANTIZED"):
        paged_flash_decode(q, kpt.to(torch.int8), vpt.to(torch.int8), tblt,
                           lens)
    with pytest.raises(ValueError, match="unquantized"):
        paged_flash_qblock(q[:, None], kpt, vpt, tblt,
                           torch.zeros(1, 1, dtype=torch.int32),
                           k_scale=torch.ones(1), v_scale=torch.ones(1))
