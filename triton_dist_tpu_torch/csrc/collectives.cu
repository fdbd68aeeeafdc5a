// Ring all-gather, ring reduce-scatter and one-shot all-reduce across
// simulated ranks on Hopper (sm_90a).
//
//   all_gather_kernel      replaces triton_dist_tpu/ops/allgather.py
//                          _ring_kernel (:49): rows of any type, as bytes
//   reduce_scatter_kernel  replaces triton_dist_tpu/ops/reduce_scatter.py
//                          _ring_kernel (:32): bf16
//   all_reduce_kernel      replaces triton_dist_tpu/ops/allreduce.py
//                          _one_shot_kernel (:50): bf16
//
// Each runs over one axis of a mesh (parallel/mesh.py): R ranks in all, the
// axis of size n with neighbours st flat ranks apart, so the collective runs
// independently in each of the R / n groups of ranks that share their other
// coordinates (on make_mesh(dp=2, tp=2) an op over "dp" pairs ranks 0-2 and
// 1-3). me = axis_pos(r), right = the group's position me + 1.
//
// All-gather (JAX's ring): rank r writes its chunk into its own output slot
// me, and at step k = 0 .. n - 2 puts the chunk it holds for step k
// (chunk (me - k) mod n: its own at k = 0, else the one that arrived from
// the left at step k - 1) into the same slot of the right neighbour's
// output, then signals it. Step n - 1 only waits for the last arrival, as
// the JAX kernel's copy.wait() certifies every receive.
//
// Reduce-scatter (JAX's ring): at step k = 0 .. n - 2 rank r sends the
// running sum of chunk (me - k - 1) mod n to the right neighbour's receive
// slot k: its own chunk at k = 0, else bf16(own + received), the sum
// rounded to bf16 at every hop as JAX's x.dtype receive buffers round it.
// At step n - 1 it adds the last arrival to its own chunk me: its output.
//
// One-shot all-reduce: every rank puts its whole buffer into gather slot me
// of every peer and signals; then each rank waits for its n - 1 arrivals
// and sums the n buffers in fp32 in a fixed order, positions 0 .. n - 1
// (its own read from its input), rounded to bf16 once, so every rank of a
// group holds the same bits (JAX adds in bf16 from each rank's own buffer
// round the ring; at n = 2 the two agree).
//
// A chunk moves in pieces of kPieceVecs 16-byte vectors (8 KiB), each with
// its own flag, so a piece waits only for its own data. Work items, in the
// order every block walks them (each waits only on a lower-numbered item,
// see shmem_device.cuh): the rings by (step, rank, piece); the one-shot
// all-reduce its puts (rank, piece), then its reduces (rank, piece).
//
// What bounds them on the H100: bytes, each input read once and each output
// written once (plus the rings' forwarded pieces). This first design is a
// grid-stride copy of 16-byte vectors per piece: no TMA bulk copies
// (PERF.md).

#include "shmem_device.cuh"

namespace {

using namespace tdt;

enum Fault { kNoFault = 0, kWrongChunk = 1, kDropPartial = 1, kLostSignal = 2 };

constexpr int kThreads = 256;
constexpr long long kPieceVecs = 512;   // 16-byte vectors a work item moves

struct Params {
  const char* x;        // (R, x_rank) bytes: every rank's input
  char* out;            // (R, out_rank) bytes: every rank's output
  char* buf;            // receive slots (reduce-scatter) / gather slots
  long long c_vecs;     // 16-byte vectors of one chunk
  long long n_pc;       // pieces of one chunk
  int R, n, st, fault;
  Sync sync;
};

__device__ __forceinline__ const uint4* vec_at(const char* base, long long chunk, long long c_vecs) {
  return reinterpret_cast<const uint4*>(base) + chunk * c_vecs;
}

__device__ __forceinline__ uint4* vec_at(char* base, long long chunk, long long c_vecs) {
  return reinterpret_cast<uint4*>(base) + chunk * c_vecs;
}

// Eight bf16 lanes added in fp32, rounded to bf16.
__device__ __forceinline__ uint4 add_bf16x8(uint4 a, uint4 b) {
  const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
  uint4 r;
  __nv_bfloat162* pr = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 fa = __bfloat1622float2(pa[k]), fb = __bfloat1622float2(pb[k]);
    pr[k] = __floats2bfloat162_rn(fa.x + fb.x, fa.y + fb.y);
  }
  return r;
}

// Piece p of a chunk: its first vector and its vector count.
__device__ __forceinline__ void piece(const Params& P, long long p, long long* v0, int* nv) {
  *v0 = p * kPieceVecs;
  *nv = (int)min(kPieceVecs, P.c_vecs - *v0);
}

// Flag of piece p that rank r receives at ring step k.
__device__ __forceinline__ long long ring_flag(const Params& P, int r, int k, long long p) {
  return ((long long)r * (P.n - 1) + k) * P.n_pc + p;
}

// -- all-gather --------------------------------------------------------------

// x (R, c); out (R, n * c): rank r's slot c at out[r] + c * c_vecs vectors.
__device__ void all_gather_item(const Params& P, int k, int r, long long p) {
  const int n = P.n, me = axis_pos(r, n, P.st);
  const int right = axis_peer(r, (me + 1) % n, n, P.st);
  const int c = ((me - k) % n + n) % n;
  long long v0;
  int nv;
  piece(P, p, &v0, &nv);
  const long long out_chunks = n;   // slots a rank's output holds
  const uint4* src;
  if (k == 0) {
    src = vec_at(P.x, r, P.c_vecs) + v0;
    uint4* own = vec_at(P.out, r * out_chunks + me, P.c_vecs) + v0;
    for (int e = threadIdx.x; e < nv; e += blockDim.x) own[e] = __ldcg(src + e);
    if (P.fault == kWrongChunk)   // the put reads the right neighbour's input
      src = vec_at(P.x, right, P.c_vecs) + v0;
  } else {
    wait_arrivals(P.sync, ring_flag(P, r, k - 1, p), 0, 1, r, k);
    src = vec_at(P.out, r * out_chunks + c, P.c_vecs) + v0;
  }
  if (k < n - 1) {
    uint4* dst = vec_at(P.out, right * out_chunks + c, P.c_vecs) + v0;
    for (int e = threadIdx.x; e < nv; e += blockDim.x) dst[e] = __ldcg(src + e);
    if (P.fault == kLostSignal && r == 0 && k == 0 && p == 0) {
      __syncthreads();
      return;
    }
    signal_block(P.sync, ring_flag(P, right, k, p));
  }
}

// -- reduce-scatter -----------------------------------------------------------

// x (R, n * c) bf16; out (R, c); buf (R, n - 1, c): receive slot k of rank r.
__device__ void reduce_scatter_item(const Params& P, int k, int r, long long p) {
  const int n = P.n, me = axis_pos(r, n, P.st);
  const int right = axis_peer(r, (me + 1) % n, n, P.st);
  const int c = ((me - k - 1) % n + n) % n;
  long long v0;
  int nv;
  piece(P, p, &v0, &nv);
  const uint4* own = vec_at(P.x, (long long)r * n + c, P.c_vecs) + v0;
  const uint4* in = nullptr;
  if (k > 0) {
    wait_arrivals(P.sync, ring_flag(P, r, k - 1, p), 0, 1, r, k);
    if (!(P.fault == kDropPartial && k == n - 1))
      in = vec_at(P.buf, (long long)r * (n - 1) + k - 1, P.c_vecs) + v0;
  }
  uint4* dst = k < n - 1 ? vec_at(P.buf, (long long)right * (n - 1) + k, P.c_vecs) + v0
                         : vec_at(P.out, r, P.c_vecs) + v0;
  for (int e = threadIdx.x; e < nv; e += blockDim.x) {
    const uint4 v = __ldcg(own + e);
    dst[e] = in != nullptr ? add_bf16x8(v, __ldcg(in + e)) : v;
  }
  if (k < n - 1) {
    if (P.fault == kLostSignal && r == 0 && k == 0 && p == 0) {
      __syncthreads();
      return;
    }
    signal_block(P.sync, ring_flag(P, right, k, p));
  }
}

// -- one-shot all-reduce ------------------------------------------------------

// Flag of piece p that rank r receives from group position q.
__device__ __forceinline__ long long gather_flag(const Params& P, int r, int q, long long p) {
  return ((long long)r * P.n + q) * P.n_pc + p;
}

// x (R, c) bf16; buf (R, n, c): gather slot q of rank r.
__device__ void all_reduce_put_item(const Params& P, int r, long long p) {
  const int n = P.n, me = axis_pos(r, n, P.st);
  long long v0;
  int nv;
  piece(P, p, &v0, &nv);
  const uint4* src = vec_at(P.x, r, P.c_vecs) + v0;
  for (int e = threadIdx.x; e < nv; e += blockDim.x) {
    const uint4 v = __ldcg(src + e);
    for (int q = 0; q < n; ++q)
      if (q != me) vec_at(P.buf, (long long)axis_peer(r, q, n, P.st) * n + me, P.c_vecs)[v0 + e] = v;
  }
  fence();
  __syncthreads();
  if (threadIdx.x == 0)
    for (int q = 0; q < n; ++q) {
      if (q == me || (P.fault == kLostSignal && r == 0 && p == 0 && q == (me + 1) % n)) continue;
      signal_op(P.sync, gather_flag(P, axis_peer(r, q, n, P.st), me, p));
    }
}

__device__ void all_reduce_sum_item(const Params& P, int r, long long p) {
  const int n = P.n, me = axis_pos(r, n, P.st);
  long long v0;
  int nv;
  piece(P, p, &v0, &nv);
  // Thread 0 waits for the n - 1 arrivals (a timed-out wait is recorded
  // and the sum goes on over whatever is there: the host raises).
  if (threadIdx.x == 0) {
    for (int q = 0; q < n; ++q)
      if (q != me) signal_wait_until(P.sync, gather_flag(P, r, q, p), r, q);
    fence();
  }
  __syncthreads();
  const int dropped = P.fault == kDropPartial ? (me + 1) % n : -1;
  uint4* dst = vec_at(P.out, r, P.c_vecs) + v0;
  for (int e = threadIdx.x; e < nv; e += blockDim.x) {
    float acc[8];
#pragma unroll
    for (int l = 0; l < 8; ++l) acc[l] = 0.f;
    for (int q = 0; q < n; ++q) {
      if (q == dropped) continue;
      const uint4 v = q == me ? __ldcg(vec_at(P.x, r, P.c_vecs) + v0 + e)
                              : __ldcg(vec_at(P.buf, (long long)r * n + q, P.c_vecs) + v0 + e);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const float2 f = __bfloat1622float2(h[l]);
        acc[2 * l] += f.x;
        acc[2 * l + 1] += f.y;
      }
    }
    uint4 o;
    __nv_bfloat162* ho = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int l = 0; l < 4; ++l) ho[l] = __floats2bfloat162_rn(acc[2 * l], acc[2 * l + 1]);
    dst[e] = o;
  }
}

// -- kernels ------------------------------------------------------------------

enum Op { kAllGather = 0, kReduceScatter = 1, kAllReduce = 2 };

template <int OP>
__global__ void __launch_bounds__(kThreads) collective_kernel(Params P) {
  const long long per_step = (long long)P.R * P.n_pc;
  const long long total = (OP == kAllReduce ? 2 : P.n) * per_step;
  for (long long item = blockIdx.x; item < total; item += gridDim.x) {
    const int k = (int)(item / per_step);
    const long long rem = item % per_step;
    const int r = (int)(rem / P.n_pc);
    const long long p = rem % P.n_pc;
    if (OP == kAllGather) {
      all_gather_item(P, k, r, p);
    } else if (OP == kReduceScatter) {
      reduce_scatter_item(P, k, r, p);
    } else if (k == 0) {
      all_reduce_put_item(P, r, p);
    } else {
      all_reduce_sum_item(P, r, p);
    }
    __syncthreads();
  }
}

template <int OP>
int launch(const void* x, void* out, void* buf, long long c_bytes, int R, int n, int st,
           void* flags, void* abort_word, unsigned long long epoch, unsigned long long timeout_ns,
           int fault, int device, void* stream) {
  if (R < 1 || n < 1 || st < 1 || R % (n * st) || c_bytes < 16 || c_bytes % 16 || epoch == 0 ||
      timeout_ns == 0 || (OP != kAllGather && n < 2))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = ensure_error_record();
  if (e != cudaSuccess) return (int)e;
  Params P;
  P.x = static_cast<const char*>(x);
  P.out = static_cast<char*>(out);
  P.buf = static_cast<char*>(buf);
  P.c_vecs = c_bytes / 16;
  P.n_pc = (P.c_vecs + kPieceVecs - 1) / kPieceVecs;
  P.R = R;
  P.n = n;
  P.st = st;
  P.fault = fault;
  P.sync.flags = static_cast<u64*>(flags);
  P.sync.abort = static_cast<u64*>(abort_word);
  P.sync.err = g_err_dev;
  P.sync.epoch = epoch;
  P.sync.timeout_ns = timeout_ns;
  const long long items = (OP == kAllReduce ? 2 : n) * (long long)R * P.n_pc;
  void* args[] = {&P};
  return (int)cooperative_launch(reinterpret_cast<const void*>(collective_kernel<OP>), kThreads,
                                 0, items, args, device, static_cast<cudaStream_t>(stream));
}

}  // namespace

// Plain C interfaces for ctypes. Every rank's operand and output are
// contiguous with a leading rank dimension of R; the axis has size n and
// stride st (R a multiple of n * st); c_bytes is one chunk's bytes (a
// multiple of 16, the buffers 16-byte aligned). flags: the workspace's
// R * (n - 1) * n_pc (rings) or R * n * n_pc (all-reduce) flag words, n_pc
// = ceil(c_bytes / 8 KiB), then its abort word. epoch: this call's (>= 1);
// timeout_ns bounds every wait; fault: 0, or a planted fault (1: all-gather
// puts the right neighbour's input at step 0 / the reductions drop the
// partial received last, 2: rank 0's first piece never signalled). Return a
// cudaError_t code (0 = launched).

// x (R, c) any type; out (R, n * c).
extern "C" int tdt_all_gather_ring(const void* x, void* out, long long c_bytes, int R, int n,
                                   int st, void* flags, void* abort_word,
                                   unsigned long long epoch, unsigned long long timeout_ns,
                                   int fault, int device, void* stream) {
  return launch<kAllGather>(x, out, nullptr, c_bytes, R, n, st, flags, abort_word, epoch,
                            timeout_ns, fault, device, stream);
}

// x (R, n * c) bf16; out (R, c); recv (R, n - 1, c) bf16 receive slots.
extern "C" int tdt_reduce_scatter_ring_bf16(const void* x, void* out, void* recv,
                                            long long c_bytes, int R, int n, int st, void* flags,
                                            void* abort_word, unsigned long long epoch,
                                            unsigned long long timeout_ns, int fault, int device,
                                            void* stream) {
  return launch<kReduceScatter>(x, out, recv, c_bytes, R, n, st, flags, abort_word, epoch,
                                timeout_ns, fault, device, stream);
}

// x (R, c) bf16; out (R, c); gather (R, n, c) bf16 gather slots.
extern "C" int tdt_all_reduce_one_shot_bf16(const void* x, void* out, void* gather,
                                            long long c_bytes, int R, int n, int st, void* flags,
                                            void* abort_word, unsigned long long epoch,
                                            unsigned long long timeout_ns, int fault, int device,
                                            void* stream) {
  return launch<kAllReduce>(x, out, gather, c_bytes, R, n, st, flags, abort_word, epoch,
                            timeout_ns, fault, device, stream);
}
