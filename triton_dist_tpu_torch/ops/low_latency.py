"""The low-latency all-to-all with the quantization on the wire
(counterpart of the wire half of ``triton_dist_tpu/ops/low_latency.py``:
``wire_max``, ``quantize_rows``, ``wire_roundtrip`` and ``ll_a2a``), and
its hierarchical two-hop form (counterpart of
``triton_dist_tpu/ops/ll_a2a_2d.py``: ``record_dispatch_puts``,
``hop_put_counts``, ``_hop`` and ``ll_a2a_2d``), kept here beside the
flat exchange whose two single-axis calls it composes.

:func:`ll_a2a` takes the ranks as its leading dimension
(:mod:`~triton_dist_tpu_torch.parallel.mesh`): ``x`` (n, n, C, d), ``x[s]
[d]`` the chunk rank s sends rank d, and returns (n, n, C, d), ``out[d][s]``
what rank d received from rank s, each row quantized on the way (int8 or
fp8 e4m3 codes and an fp32 per-row scale, :func:`quantize_rows`) and
dequantized on arrival into ``x``'s dtype. Over one axis of a two-axis
mesh every group along that axis exchanges at once: ``x`` (R, n, C, d)
holds every rank's chunks by the receiver's position along the axis, and
``out[r][p]`` is what rank r received from the member at position p of
its group. On a CUDA tensor it is one cooperative launch of
``ll_a2a_kernel`` (``csrc/ll_a2a.cu``): every rank's blocks quantize their
chunks straight into the receiver's inbound slot (the slot parity is
``step % 2``, as in JAX), signal, and the receiver's blocks wait and
dequantize. The inbound slots (two parities of codes and scales) persist
in the op's workspace; each call's epoch keeps calls of one parity apart.
On a CPU tensor it runs :func:`ll_a2a_ref`: quantize, transpose,
dequantize. At one rank it is the wire round trip, as JAX's ``n == 1``
form.

:func:`ll_a2a_2d` factors the exchange over an ``(outer, inner)`` mesh
into two such calls: the inner hop regroups every rank's chunks by inner
index, then one slab a peer crosses the outer axis, so the outer hop's
puts drop from ``(n_out - 1)·n_in`` to ``n_out - 1`` a rank. Each hop
quantizes once (``impl="kernel"``: row 23; ``"xla"``: the same wire
payload through the plain transport, JAX's ``lax.all_to_all`` path). The
kernel counts its puts by hop (``puts=``), and a lost signal names the
hop it was lost on.

``fast_allgather`` and ``ll_a2a_steps`` (rows 22 and 24) have no caller on
the port's paths and are not ported yet (ROADMAP.md queue B); nor is
JAX's ``force_kernel`` (a one-chip lowering check), nor its per-hop fault
scopes (``resilience.faults``, queue A item 7), nor its ``_resolve_impl``,
which degrades ``"kernel"`` to ``"xla"`` where interpret-mode remote DMA
cannot cross two real axes: the port's kernel runs on any mesh.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Optional

import torch

from triton_dist_tpu_torch.ops import tp_gemm
from triton_dist_tpu_torch.parallel.mesh import MeshContext
from triton_dist_tpu_torch.shmem import workspace as shmem
from triton_dist_tpu_torch.utils.build import CudaKernel

FAULTS = {"wrong_parity": 1, "lost_signal": 2, "wrong_scale_row": 3}
WIRE_DTYPES = (torch.int8, torch.float8_e4m3fn)
ROWS_PER_ITEM = 8              # csrc/ll_a2a.cu kRows: one warp a row

# ``KERNEL.launches`` counts launches of the CUDA kernel.
KERNEL = CudaKernel("ll_a2a.cu", "tdt_ll_a2a",
                    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                    + [ctypes.c_void_p] * 3 + [ctypes.c_uint64] * 2
                    + [ctypes.c_int])


def wire_max(dtype) -> float:
    """Largest representable magnitude of the wire dtype."""
    if dtype == torch.int8:
        return 127.0
    return float(torch.finfo(dtype).max)


def quantize_rows(v: torch.Tensor, wire_dtype):
    """Per-row absmax quantization: v (…, d) float → (codes, scale (…, 1)
    fp32). JAX's recipe: ``scale = max(absmax / wire_max, 1e-12)``, codes
    ``v / scale`` (a true division), rounded half to even for int8."""
    v = v.float()
    amax = v.abs().amax(dim=-1, keepdim=True)
    # A tensor divisor: PyTorch multiplies by the reciprocal of a Python
    # scalar divisor on the card, which rounds differently.
    scale = torch.clamp_min(amax / torch.full_like(amax, wire_max(wire_dtype)),
                            1e-12)
    q = v / scale
    if wire_dtype == torch.int8:
        q = torch.round(q)
    return q.to(wire_dtype), scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor,
                    dtype) -> torch.Tensor:
    """``(q · scale)`` in fp32, rounded once to ``dtype``."""
    return (q.float() * scale).to(dtype)


def wire_roundtrip(x: torch.Tensor, wire_dtype) -> torch.Tensor:
    """Quantize + immediately dequantize (the one-rank form)."""
    q, scale = quantize_rows(x, wire_dtype)
    return dequantize_rows(q, scale, x.dtype)


def ll_a2a_ref(x: torch.Tensor, wire_dtype=torch.int8,
               stride: int = 1) -> torch.Tensor:
    """Plain version: every row's wire round trip, then the all-to-all's
    transpose over the two rank dimensions, in every group of members
    ``stride`` flat ranks apart (1: the flat form)."""
    r, n = x.shape[:2]
    v = tp_gemm.group_view(wire_roundtrip(x, wire_dtype), n, stride)
    return v.transpose(1, 3).contiguous().view(x.shape)


def ll_a2a(x: torch.Tensor, *, ctx: MeshContext, axis: str = "ep", step=0,
           wire_dtype=torch.int8, fault: int = 0,
           timeout_s: float = shmem.TIMEOUT_S, check: bool = False,
           puts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Slot-parity low-latency all-to-all with the quantization in the
    kernel: ``x`` (n, n, C, d), or (R, n, C, d) over one axis of a larger
    mesh (module docstring) → the same shape; ``step`` is the caller's step
    counter, whose parity picks the inbound slot; ``wire_dtype`` torch.int8
    or torch.float8_e4m3fn. ``fault`` (a value of :data:`FAULTS`),
    ``timeout_s`` and ``check`` as in
    :func:`~triton_dist_tpu_torch.ops.tp_gemm.launch`. ``puts``: on a CUDA
    tensor, an int64 counter on the card to which the kernel adds one for
    every chunk put to another rank."""
    n = ctx.size(axis)
    if x.shape[0] not in (n, ctx.n_ranks) or x.dim() != 4 or x.shape[1] != n:
        raise ValueError(f"x {tuple(x.shape)}: expected (n={n}, n, C, d), or "
                         f"(R={ctx.n_ranks}, n, C, d) over every rank")
    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(f"wire_dtype {wire_dtype}: one of {WIRE_DTYPES}")
    r_all, _, c, d = x.shape
    st = ctx.stride(axis) if r_all > n else 1
    grouped = r_all > n
    parity = int(step) % 2
    if n == 1:
        return wire_roundtrip(x, wire_dtype)
    if x.device.type == "cpu":
        return ll_a2a_ref(x, wire_dtype, st)
    dev = x.device
    if dev.type != "cuda":
        raise RuntimeError(f"ll_a2a runs on CUDA tensors (got {dev}); only "
                           "CPU tensors take the plain version")
    if x.dtype != torch.bfloat16 or not x.is_contiguous() or d % 8:
        raise ValueError("ll_a2a: x must be contiguous bf16 with d a "
                         f"multiple of 8 (got {x.dtype}, d={d})")
    if c == 0:
        return torch.empty_like(x)
    if puts is not None and (puts.device != dev or puts.dtype != torch.int64):
        raise TypeError(f"puts must be an int64 counter on {dev}")
    n_rb = -(-c // ROWS_PER_ITEM)
    ws = shmem.workspace(
        "ll_a2a", (c, d, str(wire_dtype), n, st), n=r_all,
        n_flags=r_all * 2 * n * n_rb, device=dev,
        buffers={"q": ((2, n, c, d), torch.uint8),
                 "scale": ((2, n, c), torch.float32)})
    out = torch.empty_like(x)
    where = f" over {tp_gemm.hop_name(ctx, axis)}" if grouped else ""
    sender = "the rank at position {} of its group" if grouped else "rank {}"

    def describe(rank, step_, slot):
        rb = slot % n_rb
        return (f"ll_a2a{where}: rank {rank} waited for row block {rb} of "
                f"{sender.format(step_)}'s chunk at parity {parity} (flag "
                f"slot {slot}) past {timeout_s} s")

    tp_gemm.launch(KERNEL, ws, describe, x.data_ptr(), out.data_ptr(),
                   ws.buffers["q"].data_ptr(), ws.buffers["scale"].data_ptr(),
                   r_all, n, st, c, d, parity, int(wire_dtype != torch.int8),
                   None if puts is None else puts.data_ptr(),
                   device=dev, timeout_s=timeout_s, fault=fault, check=check)
    return out


# ---- the hierarchical two-hop form (JAX's ops/ll_a2a_2d.py) ----------------

# ll_a2a_2d notes each hop it runs here while a record_dispatch_puts scope
# is open, so a caller can count what one dispatch puts on each fabric.
_PUT_LEDGER: Optional[list] = None


@contextlib.contextmanager
def record_dispatch_puts():
    """Collect one entry per hop of every :func:`ll_a2a_2d` call inside the
    scope: ``{"hop", "axis", "peers", "payload_puts", "wire_puts"}`` (a
    rank's puts; ``wire_puts`` counts the payload and scale puts of JAX's
    wire protocol, which the port's kernel issues as one)."""
    global _PUT_LEDGER
    prev, _PUT_LEDGER = _PUT_LEDGER, []
    try:
        yield _PUT_LEDGER
    finally:
        _PUT_LEDGER = prev


def _note(hop: str, axis: str, n_peers: int) -> None:
    if _PUT_LEDGER is not None:
        _PUT_LEDGER.append({"hop": hop, "axis": axis, "peers": n_peers,
                            "payload_puts": n_peers,
                            "wire_puts": 2 * n_peers})


def hop_put_counts(ctx: MeshContext, *, outer_axis: str = "dcn",
                   inner_axis: str = "ici") -> dict:
    """A rank's puts per dispatch on each hop of the two-hop schedule, and
    what a flat exchange over the same mesh would push across the outer
    axis (``(n_out - 1)·n_in``)."""
    n_out, n_in = ctx.size(outer_axis), ctx.size(inner_axis)
    return {"ici": n_in - 1, "dcn": n_out - 1,
            "flat_dcn": (n_out - 1) * n_in}


def _hop(x: torch.Tensor, *, ctx: MeshContext, axis: str, step: int,
         wire_dtype, impl: str, fault: int = 0,
         timeout_s: float = shmem.TIMEOUT_S,
         puts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One single-axis exchange of every rank's x (R, n, C, d).
    ``"kernel"``: :func:`ll_a2a` (row 23 on a CUDA tensor); ``"xla"``: the
    same codes and scales through the plain transport, numerically the
    same."""
    if impl == "kernel":
        return ll_a2a(x, ctx=ctx, axis=axis, step=step,
                      wire_dtype=wire_dtype, fault=fault,
                      timeout_s=timeout_s, puts=puts)
    n = ctx.size(axis)
    if n == 1:
        return wire_roundtrip(x, wire_dtype)
    q, scale = quantize_rows(x, wire_dtype)
    st = ctx.stride(axis)

    def move(a):
        v = tp_gemm.group_view(a, n, st)
        return v.transpose(1, 3).contiguous().view(a.shape)

    return dequantize_rows(move(q.view(torch.uint8)).view(q.dtype),
                           move(scale), x.dtype)


def ll_a2a_2d(x: torch.Tensor, *, ctx: MeshContext, outer_axis: str = "dcn",
              inner_axis: str = "ici", step=0, wire_dtype=torch.int8,
              impl: str = "kernel", faults: Optional[dict] = None,
              timeout_s: float = shmem.TIMEOUT_S,
              puts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Two-hop low-latency all-to-all: x (R, n, C, d), every rank's chunks
    by outer-major destination rank (``x[r][o·n_in + i]`` goes to rank (o,
    i)), over a mesh whose R ranks are exactly ``(outer, inner)`` → (R, n,
    C, d) received, the flat :func:`ll_a2a` contract. ``step`` passes to
    both hops unchanged (they use different workspaces); its parity keeps
    a layer's dispatch and return apart. ``faults``: a planted fault by hop
    name (``{"dcn": FAULTS["lost_signal"]}``); ``puts``: an int64 (2,)
    counter on the card, [inner, outer] chunk puts."""
    tp_gemm.check_axis("ll_a2a_2d", ctx, (outer_axis, inner_axis))
    n_out, n_in = ctx.size(outer_axis), ctx.size(inner_axis)
    n = n_out * n_in
    if x.dim() != 4 or tuple(x.shape[:2]) != (n, n):
        raise ValueError(
            f"x {tuple(x.shape)}: expected (R, {outer_axis}x{inner_axis}="
            f"{n_out}x{n_in}={n}, C, d), R = {n}")
    r_all, _, c, d = x.shape
    if impl not in ("kernel", "xla"):
        raise ValueError(f"unknown ll2d hop impl {impl!r}")
    faults = faults or {}
    kw = dict(ctx=ctx, step=step, wire_dtype=wire_dtype, impl=impl,
              timeout_s=timeout_s)
    # Inner hop: chunk for rank (o, i) rides to my inner peer i, at outer
    # position o of its n_out·C slab.
    inner_send = (x.reshape(r_all, n_out, n_in, c, d).transpose(1, 2)
                  .reshape(r_all, n_in, n_out * c, d))
    _note("ici", inner_axis, n_in - 1)
    inner_recv = _hop(inner_send, axis=inner_axis, fault=faults.get("ici", 0),
                      puts=None if puts is None else puts[0:], **kw)
    # Outer hop: inner_recv[j] is peer j's slab of chunks bound for my inner
    # index, one per node; regrouped outer-major, each peer node gets one
    # n_in·C slab.
    outer_send = (inner_recv.view(r_all, n_in, n_out, c, d).transpose(1, 2)
                  .reshape(r_all, n_out, n_in * c, d))
    _note("dcn", outer_axis, n_out - 1)
    outer_recv = _hop(outer_send, axis=outer_axis, fault=faults.get("dcn", 0),
                      puts=None if puts is None else puts[1:], **kw)
    # outer_recv[o] is node o's slab for me, inner-major inside: global
    # rank order after the flatten.
    return outer_recv.reshape(r_all, n, c, d)
