// All-to-all fused into a GEMM across simulated ranks on Hopper (sm_90a):
// bf16 in and out, fp32 sums.
//
// a2a_gemm_kernel replaces triton_dist_tpu/ops/a2a_gemm.py _a2a_gemm_kernel
// (:90, a2a_gemm_fused :212). Sender s holds n chunks of C rows, x[s][d]
// bound for rank d; every rank d multiplies the chunks it receives, stacked
// by source, by its weight:
//
//   out[d][s * C + i] = x[s][d][i] . w_d^T        (w_d: N x K, stored (out, in))
//
// and (write_recv) leaves the received chunks in recv[d] (n * C x K), the
// local one included. The protocol is JAX's: every put is issued before any
// wait, then each GEMM item walks its chunk in the swizzle's order, chunk
// src = (d + k) mod n at step k ("a2a": the local chunk first, read straight
// from the input) or src = k ("identity"), and waits only for the row block
// of the one source it reads.
//
// Work items, in the order every block walks them (each waits only on a
// lower-numbered item, see shmem_device.cuh):
//   1. the puts (sender s, peer offset off, row block): off > 0 copies the
//      row block of x[s][(s + off) mod n] into the peer's recv slot s and
//      raises one flag per (receiver, sender, row block); off = 0 is the
//      local copy into recv (write_recv only, no flag);
//   2. the GEMM items (step k, rank d, row block, column block): every rank's
//      step-0 tiles first, so the local products run while the later steps'
//      rows are the ones still being put.
//
// What bounds it on the H100: operations. At Qwen3-8B width over 4 ranks (4
// x 4 chunks of 2048 x 4096, w 4096 x 4096) it does 1.10 TFLOP (1.11 ms at
// 989 TFLOP/s) against 570 MB read and written. This first design runs the
// wmma tile GEMM of tile_gemm.cuh (128 x 128 tiles) with the puts as
// separate copy items: no wgmma, no TMA (PERF.md).

#include "shmem_device.cuh"
#include "tile_gemm.cuh"

namespace {

using namespace tdt;

enum Fault { kNoFault = 0, kWrongChunk = 1, kLostSignal = 2 };
enum Mode { kA2A = 0, kIdentity = 1 };

typedef BigTile T;

struct Params {
  const bf16* x;     // (n, n, C, K): [sender][receiver]
  const bf16* w;     // rank d's weight at w + d * w_rank, N rows ldw apart
  bf16* out;         // (n, n * C, N)
  bf16* recv;        // (n, n * C, K): [receiver][sender]
  long long w_rank, ldw;
  int n, C, K, N, n_rb, n_cb, write_recv, mode, fault;
  Sync sync;
};

// Flag of row block rb of sender s's chunk at receiver d.
__device__ __forceinline__ long long flag_of(const Params& P, int d, int s, int rb) {
  return ((long long)d * P.n + s) * P.n_rb + rb;
}

__device__ __forceinline__ int chunk_at(const Params& P, int k, int d) {
  return P.mode == kIdentity ? k : (d + k) % P.n;
}

// Row block rb of sender s's chunk for rank d = (s + off) mod n.
__device__ void put_item(const Params& P, int s, int off, int rb) {
  const int n = P.n, d = (s + off) % n;
  const long long K = P.K;
  const int rows = min(T::BM, P.C - rb * T::BM);
  // A planted fault: rank 0 sends rank 1 the chunk it holds for rank 2.
  const int chunk = (P.fault == kWrongChunk && s == 0 && d == 1 % n) ? (d + 1) % n : d;
  const bf16* src = P.x + (((long long)s * n + chunk) * P.C + (long long)rb * T::BM) * K;
  bf16* dst = P.recv + (((long long)d * n + s) * P.C + (long long)rb * T::BM) * K;
  remote_put(dst, K, src, K, rows, P.K);
  if (off == 0) return;                  // the local copy: nothing to signal
  if (P.fault == kLostSignal && s == 0 && d == 1 % n && rb == 0) return;
  signal_block(P.sync, flag_of(P, d, s, rb));
}

// Rank d's output tile (row block rb of the chunk it computes at step k,
// column block cb).
__device__ void gemm_item(const Params& P, int k, int d, int rb, int cb, unsigned char* smem) {
  const int n = P.n, s = chunk_at(P, k, d);
  const long long K = P.K;
  const bf16* A;
  if (s == d) {
    A = P.x + (((long long)d * n + d) * P.C + (long long)rb * T::BM) * K;
  } else {
    wait_arrivals(P.sync, flag_of(P, d, s, rb), 0, 1, d, s);
    A = P.recv + (((long long)d * n + s) * P.C + (long long)rb * T::BM) * K;
  }
  const int rows = min(T::BM, P.C - rb * T::BM);
  const int cols = min(T::BN, P.N - cb * T::BN);
  const float* C = tile_mma<T>(A, K, rows, P.w + d * P.w_rank + (long long)cb * T::BN * P.ldw,
                               P.ldw, cols, P.K, smem);
  store_tile_bf16<T>(P.out + (((long long)d * n + s) * P.C + (long long)rb * T::BM) * P.N +
                         (long long)cb * T::BN,
                     P.N, C, rows, cols);
}

__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks) a2a_gemm_kernel(Params P) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n = P.n, first = P.write_recv ? 0 : 1;
  const long long puts = (long long)n * (n - first) * P.n_rb;
  const long long per_step = (long long)n * P.n_rb * P.n_cb;
  const long long items = puts + n * per_step;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    if (item < puts) {
      const int rb = (int)(item % P.n_rb);
      const long long pair = item / P.n_rb;
      put_item(P, (int)(pair / (n - first)), first + (int)(pair % (n - first)), rb);
    } else {
      long long rem = item - puts;
      const int k = (int)(rem / per_step);
      rem %= per_step;
      const int cb = (int)(rem % P.n_cb);
      rem /= P.n_cb;
      gemm_item(P, k, (int)(rem / P.n_rb), (int)(rem % P.n_rb), cb, smem);
    }
    __syncthreads();   // shared memory is free for the next item
  }
}

}  // namespace

// Plain C interface for ctypes. x (n, n, C, K) [sender][receiver]; rank d's
// weight (N rows of K, row pitch ldw) at w + d * w_rank elements (w_rank = 0:
// one weight for every rank); out (n, n * C, N); recv (n, n * C, K); flags:
// the workspace's n * n * ceil(C / 128) flag words then its abort word; mode
// 0 "a2a", 1 "identity". K, ldw and w_rank multiples of 8, tensors 16-byte
// aligned. epoch: this call's (>= 1); timeout_ns bounds every wait; fault: 0,
// or a planted fault in rank 0's chunk for rank 1 (1: the chunk for rank 2
// is sent in its place; 2: its first row block is never signalled). Returns
// a cudaError_t code (0 = launched).
extern "C" int tdt_a2a_gemm(const void* x, const void* w, void* out, void* recv,
                            long long w_rank, long long ldw, int n, int C, int K, int N,
                            int write_recv, int mode, void* flags, void* abort_word,
                            unsigned long long epoch, unsigned long long timeout_ns, int fault,
                            int device, void* stream) {
  if (n < 1 || C < 1 || K < 8 || K % 8 || N < 1 || ldw % 8 || w_rank % 8 || mode < 0 ||
      mode > 1 || flags == nullptr || abort_word == nullptr || epoch == 0 || timeout_ns == 0 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(recv)) % 16)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = ensure_error_record();
  if (e != cudaSuccess) return (int)e;
  Params P;
  P.x = static_cast<const bf16*>(x);
  P.w = static_cast<const bf16*>(w);
  P.out = static_cast<bf16*>(out);
  P.recv = static_cast<bf16*>(recv);
  P.w_rank = w_rank;
  P.ldw = ldw;
  P.n = n;
  P.C = C;
  P.K = K;
  P.N = N;
  P.n_rb = (C + T::BM - 1) / T::BM;
  P.n_cb = (N + T::BN - 1) / T::BN;
  P.write_recv = write_recv;
  P.mode = mode;
  P.fault = fault;
  P.sync.flags = static_cast<u64*>(flags);
  P.sync.abort = static_cast<u64*>(abort_word);
  P.sync.err = g_err_dev;
  P.sync.epoch = epoch;
  P.sync.timeout_ns = timeout_ns;
  void* args[] = {&P};
  const int first = write_recv ? 0 : 1;
  const long long items =
      (long long)n * (n - first) * P.n_rb + (long long)n * n * P.n_rb * P.n_cb;
  if (items == 0) return (int)cudaSuccess;
  return (int)cooperative_launch(reinterpret_cast<const void*>(a2a_gemm_kernel), T::kThreads,
                                 T::kSmem, items, args, device, static_cast<cudaStream_t>(stream));
}

// The row block of the kernel (its flag granularity): rows a GEMM item takes.
extern "C" int tdt_a2a_gemm_row_block() { return T::BM; }
