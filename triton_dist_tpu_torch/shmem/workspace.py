"""Symmetric workspaces of the simulated ranks (counterpart of
``triton_dist_tpu/shmem/workspace.py``: ``symm_tensor``).

The JAX package's symmetric buffer is a global array sharded over a mesh
axis, one shard per device, which a Pallas kernel reaches on a peer by
remote DMA. The port's ranks share one device (:mod:`~triton_dist_tpu_torch.
parallel.mesh`), so a symmetric buffer is one allocation with a leading
rank dimension (:func:`symm_tensor`): rank r's slice is the buffer that
the kernels of rank r's thread blocks read, and that its peers' blocks
put into.

The signals that order those puts are int64 flag words, one per (rank,
slot), in a :class:`Workspace` that persists across calls and is cached
by (op, the shapes its flags depend on, ranks, device). Every call takes a new **epoch**
(:meth:`Workspace.next_epoch`, one count shared by every workspace, so
an epoch also names its launch); a signal stores the epoch with release
semantics and a wait spins until ``flag >= epoch`` with acquire
semantics (``csrc/shmem_device.cuh``). Flags are never cleared between
calls: a flag written by call e holds e and cannot satisfy a wait of
any later call. The epoch is an unsigned 64-bit count and cannot wrap (at a
million calls a second it would take 584,000 years). This value-compare
design takes the place of the TPU's per-call DMA-semaphore rendezvous.

The JAX ``barrier_all`` has no counterpart: the ranks' kernels are
launches on one stream, which the stream already orders, so no call can
start while a peer is still inside the previous one.

A wait is bounded (``timeout_s``). On expiry the kernel records (rank,
step, slot, epoch) in host-mapped memory, raises the workspace's abort word (the
epoch) so that every other wait of the launch gives up at once, and the
launch runs to its end. :func:`check_errors` turns the record into a
:class:`CommTimeoutError` naming the op, the rank and the slot; each op
calls it before every launch (a record left by an earlier launch raises
there) and, with ``check=True``, after synchronising on its own launch.
``Engine.prefill`` and ``Engine.decode`` at tp > 1 call it after each
step, so a timed-out wait raises from the step it happened in.

A kernel whose puts cross two hops (the hierarchical fused GEMMs over an
``(outer, inner)`` mesh) keeps one flag range per hop (``hops``: name →
flag count, in order), all under the call's one epoch, and signals each
flag once a launch; its error names the hop of the signal that never
came (:meth:`Workspace.unsignalled`, :meth:`Workspace.hop_of`), which a
wait downstream of it may have outwaited.
"""

from __future__ import annotations

import ctypes
import itertools
from collections import OrderedDict
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

from triton_dist_tpu_torch.utils import build

TIMEOUT_S = 2.0


class CommTimeoutError(RuntimeError):
    """A wait inside a fused op's kernel passed its bound (the counterpart
    of the JAX watchdog's ``CommTimeoutError``): names the op, the waiting
    rank, the ring step and the flag slot it waited on."""


def symm_tensor(shape, dtype, n: int, device) -> torch.Tensor:
    """One allocation holding every rank's copy of a ``shape`` buffer:
    ``(n, *shape)``, rank r's at ``[r]`` (uninitialised)."""
    return torch.empty((n, *shape), dtype=dtype, device=device)


_EPOCHS = itertools.count(1)


class Workspace:
    """The persistent part of one op's symmetric workspace: ``n_flags``
    flag words (int64, starting at 0) plus the abort word after them, an
    optional persistent data buffer (``data``) and optional named ones
    (``buffers``: the low-latency all-to-all's inbound codes and scales)."""

    def __init__(self, n_flags: int, device,
                 data: Optional[torch.Tensor] = None,
                 buffers: Optional[Dict[str, torch.Tensor]] = None,
                 hops: Optional[Dict[str, int]] = None):
        self.n_flags = n_flags
        self.hops = dict(hops or {"": n_flags})
        if sum(self.hops.values()) != n_flags:
            raise ValueError(f"hop flag ranges {self.hops} do not add up "
                             f"to {n_flags} flags")
        self.flags = torch.zeros(n_flags + 1, dtype=torch.int64,
                                 device=device)
        self.data = data
        self.buffers = buffers or {}

    @staticmethod
    def next_epoch() -> int:
        """The epoch of a new call: larger than every earlier call's, on
        every workspace."""
        return next(_EPOCHS)

    @property
    def abort_ptr(self) -> int:
        return self.flags.data_ptr() + 8 * self.n_flags

    def unsignalled(self) -> list:
        """The flag slots that the launch which raised the abort word (the
        one whose wait timed out) never signalled, read once it has ended:
        for a kernel that signals every flag once a launch, the signals
        that never came (a wait downstream of one may time out first)."""
        f = self.flags.cpu()
        return (f[:-1] < f[-1]).nonzero().flatten().tolist()

    def hop_of(self, slot: int) -> Tuple[str, int]:
        """The hop whose range holds flag ``slot``, and the slot's index
        inside that range."""
        for name, count in self.hops.items():
            if slot < count:
                return name, slot
            slot -= count
        raise IndexError(f"flag slot past the {self.n_flags} flags")


_CACHE: Dict[Tuple, Workspace] = {}


def workspace(op: str, key: Tuple, *, n: int, device,
              n_flags: Optional[int] = None,
              hops: Optional[Dict[str, int]] = None,
              data_shape=None, data_dtype=torch.float32,
              buffers: Optional[Dict[str, Tuple]] = None) -> Workspace:
    """The cached :class:`Workspace` of ``op`` at ``key`` (the shapes its
    flags and data depend on) on ``device``, made on first use: ``n_flags``
    flags, or one range per hop (``hops``: name → count). ``data_shape``:
    the persistent per-rank data buffer, allocated by :func:`symm_tensor`
    as ``(n, *data_shape)``; ``buffers``: more of them by name, each
    ``name: (shape, dtype)``."""
    ck = (op, key, n, str(device))
    ws = _CACHE.get(ck)
    if ws is None:
        if n_flags is None:
            n_flags = sum(hops.values())
        data = (symm_tensor(data_shape, data_dtype, n, device)
                if data_shape is not None else None)
        named = {name: symm_tensor(shape, dtype, n, device)
                 for name, (shape, dtype) in (buffers or {}).items()}
        ws = _CACHE[ck] = Workspace(n_flags, device, data, named, hops)
    return ws


def release_all() -> None:
    """Drop every cached workspace (their device memory goes back to the
    caching allocator)."""
    _CACHE.clear()


# (source, epoch) -> describe(rank, step, slot) of the latest launches
_WATCHED: "OrderedDict[Tuple[str, int], Callable[[int, int, int], str]]" = \
    OrderedDict()
_WATCH_LIMIT = 4096
_SOURCES: Dict[str, None] = {}    # every source launched, in order


def watch(source: str, epoch: int,
          describe: Callable[[int, int, int], str]) -> None:
    """Name the flag slots of ``source``'s launch at ``epoch`` for
    :func:`check_errors` (the latest ``_WATCH_LIMIT`` launches are kept)."""
    _SOURCES[source] = None
    _WATCHED[(source, epoch)] = describe
    if len(_WATCHED) > _WATCH_LIMIT:
        _WATCHED.popitem(last=False)


def check_errors(device=None, *, sync: bool = False,
                 sources: Optional[Iterable[str]] = None) -> None:
    """Raise :class:`CommTimeoutError` if a fused op's wait timed out.
    ``sync``: first wait for ``device``'s current stream, so that every
    launch so far has ended (a record found without it waits there
    before it is cleared). ``sources``: the kernel sources to look at
    (default: every one launched)."""
    if sync:
        torch.cuda.current_stream(device).synchronize()
    for source in (list(_SOURCES) if sources is None else sources):
        lib = build.loaded(source)
        if lib is None:
            continue
        read, clear = lib.tdt_shmem_error, lib.tdt_shmem_clear_error
        read.argtypes, read.restype = [ctypes.POINTER(ctypes.c_int)], ctypes.c_int
        clear.argtypes, clear.restype = [], None
        rec = (ctypes.c_int * 6)()
        if read(rec):
            # Let the launches still in flight end first, so that none of
            # them records a timeout after the clear.
            torch.cuda.current_stream(device).synchronize()
            clear()
            epoch = (rec[4] & 0xFFFFFFFF) | (rec[5] & 0xFFFFFFFF) << 32
            describe = _WATCHED.get(
                (source, epoch),
                lambda r, s, f: f"{source} (launch {epoch}): rank {r}, "
                                f"step {s}, flag slot {f}")
            raise CommTimeoutError(describe(rec[1], rec[2], rec[3]))
