// Low-latency all-to-all with the quantization on the wire, across simulated
// ranks on Hopper (sm_90a): bf16 rows in and out, int8 or fp8 (e4m3) codes
// and an fp32 scale per row on the wire.
//
// ll_a2a_kernel replaces triton_dist_tpu/ops/low_latency.py _ll_a2a_kernel
// (:290) and its wire protocol _wire_exchange (:227): the EP "ll" decode's
// two exchanges a layer (layers/ep_moe.py _fwd_decode_ll :287-383). Sender s
// holds n chunks of C rows, chunk d bound for receiver d; receiver d ends
// with
//
//   out[d][s] = dequantize(quantize(x[s][d]))
//
// quantize_rows' recipe (low_latency.py :189), per row in fp32:
// scale = max(absmax / wire_max, 1e-12) (wire_max 127 for int8, 448 for
// e4m3), code = v / scale rounded half to even for int8 (rintf, jnp.round),
// converted with saturation for e4m3; dequantize is bf16(code * scale).
// Both divisions are true IEEE divisions (__fdiv_rn): a product with a
// reciprocal rounds differently and would flip int8 codes against the plain
// version.
//
// The protocol is the JAX kernel's, with the port's persistent workspace: a
// sender quantizes each chunk straight into the receiver's inbound slot
// (payload and scales, slot parity = step % 2, slot index = sender) and
// publishes each row block with one flag (receiver, parity, sender, row
// block), which stands for the TPU's two DMA-semaphore arrivals (payload and
// scales) of that block; the receiver waits for the flag, then dequantizes
// the block into its output. The two parity slots keep step 2 * layer and
// step 2 * layer + 1 apart as in JAX; the call's epoch (a new one every call)
// is what keeps step 2 * layer apart from step 2 * layer + 2, which share a
// parity.
//
// Over one axis of a two-axis mesh (the hops of ll_a2a_2d, JAX's
// ops/ll_a2a_2d.py _hop :109) every group of ranks along the axis exchanges
// in the same launch: R ranks, groups of n whose members lie st flat ranks
// apart, chunks and inbound slots indexed by the position along the axis.
// The flat call is R = n, st = 1. An optional counter adds one for every
// chunk put to another rank (the per-hop put count of ll_a2a_2d).
//
// Work items, in the order every block walks them (each waits only on a
// lower-numbered item, see shmem_device.cuh): the quantize-and-put items
// (sender, peer offset, row block), then the dequantize items (receiver,
// sender position, row block). A warp handles one row: a shuffle reduction
// for the absmax, then 8 elements (16 bytes of bf16) a lane per step.
//
// What bounds it on the H100: launch latency and bytes. At the Qwen3-30B-A3B
// decode (4 ranks x 4 peers x 32 rows x 2048) it reads 1 MB of bf16, writes
// and reads 0.5 MB of codes and writes 1 MB of bf16: about 1 us at
// 3.35 TB/s, well under a launch. This first design runs 8 rows an item.

#include <cuda_fp8.h>

#include "shmem_device.cuh"

namespace {

using namespace tdt;

enum Fault { kNoFault = 0, kWrongParity = 1, kLostSignal = 2, kWrongScaleRow = 3 };

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps;          // rows an item: one warp each

struct Params {
  const bf16* x;        // (R, n, C, d): [sender][receiver position]
  bf16* out;            // (R, n, C, d): [receiver][sender position]
  unsigned char* q;     // inbound codes (R, 2, n, C, d): [receiver][parity][sender position]
  float* scale;         // inbound scales (R, 2, n, C)
  unsigned long long* puts;   // chunks put to another rank, or null
  int R, n, st, C, d, parity, fp8, n_rb, fault;
  Sync sync;
};

// Inbound slot (receiver rank d, parity, sender position s).
__device__ __forceinline__ long long slot(const Params& P, int d, int par, int s) {
  return ((long long)d * 2 + par) * P.n + s;
}

__device__ __forceinline__ long long flag(const Params& P, int d, int s, int rb) {
  return slot(P, d, P.parity, s) * P.n_rb + rb;
}

__device__ __forceinline__ unsigned char encode(float v, int fp8) {
  if (fp8) return (unsigned char)__nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3);
  return (unsigned char)(signed char)(int)rintf(v);
}

__device__ __forceinline__ float decode(unsigned char c, int fp8) {
  if (fp8) {
    __nv_fp8_e4m3 v;
    v.__x = c;
    return static_cast<float>(v);
  }
  return (float)(signed char)c;
}

// Rows of row block rb of sender s's chunk for the rank at position pd of
// its group: quantize into that receiver's inbound slot, then signal it.
__device__ void put_item(const Params& P, int s, int pd, int rb) {
  const int lane = threadIdx.x % 32, i = rb * kRows + threadIdx.x / 32;
  const int ps = axis_pos(s, P.n, P.st), d = axis_peer(s, pd, P.n, P.st);
  const bool faulted = s == 0 && pd == 1 % P.n;
  if (rb == 0 && threadIdx.x == 0 && P.puts != nullptr && d != s) atomicAdd(P.puts, 1ULL);
  if (i < P.C) {
    const bf16* row = P.x + (((long long)s * P.n + pd) * P.C + i) * P.d;
    float amax = 0.f;
    for (int c = lane * 8; c < P.d; c += 256) {
      const uint4 raw = *reinterpret_cast<const uint4*>(row + c);
      const bf16* b = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int k = 0; k < 8; ++k) amax = fmaxf(amax, fabsf(__bfloat162float(b[k])));
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float sc = fmaxf(__fdiv_rn(amax, P.fp8 ? 448.f : 127.f), 1e-12f);
    // A planted fault writes rank 0's codes for rank 1 into the other parity.
    const int par = (P.fault == kWrongParity && faulted) ? 1 - P.parity : P.parity;
    unsigned char* qrow = P.q + (slot(P, d, par, ps) * P.C + i) * P.d;
    for (int c = lane * 8; c < P.d; c += 256) {
      const uint4 raw = *reinterpret_cast<const uint4*>(row + c);
      const bf16* b = reinterpret_cast<const bf16*>(&raw);
      uint2 packed;
      unsigned char* p = reinterpret_cast<unsigned char*>(&packed);
#pragma unroll
      for (int k = 0; k < 8; ++k) p[k] = encode(__fdiv_rn(__bfloat162float(b[k]), sc), P.fp8);
      *reinterpret_cast<uint2*>(qrow + c) = packed;
    }
    // A planted fault stores each scale at the row next to its own.
    const int si = (P.fault == kWrongScaleRow && faulted && (i ^ 1) < P.C) ? (i ^ 1) : i;
    if (lane == 0) P.scale[slot(P, d, P.parity, ps) * P.C + si] = sc;
  }
  if (P.fault == kLostSignal && faulted && rb == 0) return;
  signal_block(P.sync, flag(P, d, ps, rb));
}

// Receiver d: wait for row block rb of the sender at position s of its
// group, then dequantize it.
__device__ void dequant_item(const Params& P, int d, int s, int rb) {
  wait_arrivals(P.sync, flag(P, d, s, rb), 0, 1, d, s);
  const int lane = threadIdx.x % 32, i = rb * kRows + threadIdx.x / 32;
  if (i >= P.C) return;
  const long long in = slot(P, d, P.parity, s) * P.C + i;
  const float sc = __ldcg(P.scale + in);
  const unsigned char* qrow = P.q + in * P.d;
  bf16* orow = P.out + (((long long)d * P.n + s) * P.C + i) * P.d;
  for (int c = lane * 8; c < P.d; c += 256) {
    const uint2 packed = __ldcg(reinterpret_cast<const uint2*>(qrow + c));
    const unsigned char* p = reinterpret_cast<const unsigned char*>(&packed);
    uint4 raw;
    bf16* b = reinterpret_cast<bf16*>(&raw);
#pragma unroll
    for (int k = 0; k < 8; ++k) b[k] = __float2bfloat16_rn(decode(p[k], P.fp8) * sc);
    *reinterpret_cast<uint4*>(orow + c) = raw;
  }
}

__global__ void __launch_bounds__(kThreads) ll_a2a_kernel(Params P) {
  const long long puts = (long long)P.R * P.n * P.n_rb;
  for (long long item = blockIdx.x; item < 2 * puts; item += gridDim.x) {
    const bool put = item < puts;
    const long long rem = put ? item : item - puts;
    const int rb = (int)(rem % P.n_rb);
    const long long pair = rem / P.n_rb;
    const int a = (int)(pair / P.n), b = (int)(pair % P.n);
    if (put)   // sender a, peer offset b
      put_item(P, a, (axis_pos(a, P.n, P.st) + b) % P.n, rb);
    else       // receiver a, sender position b
      dequant_item(P, a, b, rb);
    __syncthreads();
  }
}

}  // namespace

// Plain C interface for ctypes. R ranks in groups of n along the axis
// (members st flat ranks apart; R = n, st = 1 for a flat mesh). x: (R, n,
// C, d) bf16 contiguous, [sender][receiver position]; out: (R, n, C, d)
// bf16, [receiver][sender position]; q: the inbound codes (R, 2, n, C, d)
// uint8 and scale: the inbound scales (R, 2, n, C) fp32 of the workspace,
// [receiver][parity][sender position]; parity = step % 2; fp8: 0 for int8
// codes, 1 for e4m3; d a multiple of 8; puts: a uint64 counter of the
// chunks put to another rank, or null. flags: the workspace's
// R * 2 * n * ceil(C / 8) words then its abort word. epoch: this call's
// (>= 1); timeout_ns bounds every wait; fault: 0, or a planted fault in
// rank 0's chunk for position 1 of its group (1: its codes go to the other
// parity's slot; 2: its first signal is never sent; 3: each scale is stored
// at the row next to its own). Returns a cudaError_t code (0 = launched).
extern "C" int tdt_ll_a2a(const void* x, void* out, void* q, void* scale, int R, int n, int st,
                          int C, int d, int parity, int fp8, void* puts, void* flags,
                          void* abort_word, unsigned long long epoch,
                          unsigned long long timeout_ns, int fault, int device, void* stream) {
  if (n < 1 || st < 1 || R < n * st || R % (n * st) || C < 1 || d < 8 || d % 8 ||
      (parity != 0 && parity != 1) || (fp8 != 0 && fp8 != 1) || epoch == 0 || timeout_ns == 0 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out) |
       reinterpret_cast<uintptr_t>(q)) % 16)
    return (int)cudaErrorInvalidValue;
  Params P;
  P.x = static_cast<const bf16*>(x);
  P.out = static_cast<bf16*>(out);
  P.q = static_cast<unsigned char*>(q);
  P.scale = static_cast<float*>(scale);
  P.puts = static_cast<unsigned long long*>(puts);
  P.R = R;
  P.n = n;
  P.st = st;
  P.C = C;
  P.d = d;
  P.parity = parity;
  P.fp8 = fp8;
  P.n_rb = (C + kRows - 1) / kRows;
  P.fault = fault;
  P.sync.flags = static_cast<u64*>(flags);
  P.sync.abort = static_cast<u64*>(abort_word);
  P.sync.epoch = epoch;
  P.sync.timeout_ns = timeout_ns;
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = ensure_error_record();
  if (e != cudaSuccess) return (int)e;
  P.sync.err = g_err_dev;
  void* args[] = {&P};
  const long long items = 2LL * R * n * P.n_rb;
  return (int)cooperative_launch(reinterpret_cast<const void*>(ll_a2a_kernel), kThreads, 0, items,
                                 args, device, static_cast<cudaStream_t>(stream));
}
