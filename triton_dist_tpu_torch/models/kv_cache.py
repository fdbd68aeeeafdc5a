"""Dense KV cache (counterpart of ``triton_dist_tpu/models/kv_cache.py``).

Layout ``(num_layers, batch, max_len, kv_heads, head_dim)``, the global
one at every tp: at tp = 1 a rank holds every KV head; at tp = n
simulated ranks (:mod:`~triton_dist_tpu_torch.parallel.mesh`) rank r owns
KV heads ``[r·KV/n, (r+1)·KV/n)`` (``k[..., r·KV/n:(r+1)·KV/n, :]``), so
the tensor equals the JAX cache's global view under its
``cache_specs`` (KV heads sharded along ``tp``). The JAX cache is immutable and its engine
donates it to each decode step; here every write lands IN PLACE and the
methods return the cache itself, so a caller can keep JAX's
``cache = cache.append_decode(...)`` form. ``length`` is a host int (JAX
keeps a device scalar): decode reads it without a device sync.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor          # (L, B, T, KV, hd)
    v: torch.Tensor
    length: int = 0          # tokens currently cached

    @classmethod
    def empty(cls, num_layers: int, batch: int, max_len: int,
              kv_heads: int, head_dim: int, *, device=None,
              dtype=torch.float32) -> "KVCache":
        shape = (num_layers, batch, max_len, kv_heads, head_dim)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))

    def write_prefill(self, layer: int, k: torch.Tensor,
                      v: torch.Tensor) -> "KVCache":
        """k/v: (B, S, KV, hd) from a prefill, written at positions
        ``0..S-1`` of ``layer``, in place."""
        s = k.shape[1]
        self.k[layer, :, :s] = k
        self.v[layer, :, :s] = v
        return self

    def append_decode(self, layer: int, k_tok: torch.Tensor,
                      v_tok: torch.Tensor) -> "KVCache":
        """Write one decode token's K/V (B, 1, KV, hd) into ``layer`` at
        ``length``, in place. The position does not advance here: every
        layer of a step writes the same position; call :meth:`advance`
        once per step."""
        if self.length >= self.k.shape[2]:
            raise ValueError(f"KV cache full ({self.k.shape[2]})")
        self.k[layer, :, self.length] = k_tok[:, 0]
        self.v[layer, :, self.length] = v_tok[:, 0]
        return self

    def advance(self, steps: int = 1) -> "KVCache":
        """Bump ``length`` after every layer of a decode step appended."""
        self.length += steps
        return self
