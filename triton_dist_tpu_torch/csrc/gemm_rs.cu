// Fused GEMM + reduce-scatter across simulated tensor-parallel ranks on
// Hopper (sm_90a): bf16 in and out, fp32 running sums.
//
// gemm_rs_kernel replaces triton_dist_tpu/ops/gemm_rs.py _gemm_rs_kernel
// (:98, swizzle "rs"). Rank r holds the K-shard a[r] (M x k_loc) of the
// activations and the row-parallel weight shard b[r] (N x k_loc, stored
// (out, in): a column slice of the full weight); rank r ends with
//
//   out[r] = sum over ranks s of (a[s] . b[s]^T)[rows of chunk r]
//
// (m_loc = M / n rows). The ring follows the JAX kernel: at step s rank r
// computes its partial of chunk c = (r - s - 1) mod n, adds the running sum
// that rank r - 1 sent at step s - 1 (in fp32), and at s < n - 1 puts the
// new running sum into rank r + 1's receive slot s and signals it; at
// s = n - 1 (c = r) it rounds the sum to bf16 once and writes its output.
// A chunk's sum thus visits ranks c + 1, c + 2, ..., c in ring order (the
// order the plain version adds in). Signals go by output tile, so a tile
// waits only for its own upstream tile.
//
// Work items, in the order every block walks them (each waits only on a
// lower-numbered item, see shmem_device.cuh): (step, rank, row block,
// column block).
//
// What bounds it on the H100: operations at prefill. Qwen3-8B at tp = 4 over
// 2048 tokens: 4 ranks x 2 x 2048 x 1024 x 4096 = 68.7 GFLOP for wo (0.070
// ms at 989 TFLOP/s), three times that for w_down; the ring moves 3 x 8 MB
// of fp32 sums per rank. First design: the tile GEMM of tile_gemm.cuh, the
// add and the put in its epilogue (PERF.md).

#include "shmem_device.cuh"
#include "tile_gemm.cuh"

namespace {

using namespace tdt;

enum Fault { kNoFault = 0, kDropPartial = 1, kLostSignal = 2 };

struct Params {
  const bf16* a;        // (n, M, k_loc)
  const bf16* b;        // rank r's shard at b + r * b_rank, rows ldb apart
  bf16* out;            // (n, m_loc, N)
  float* recv;          // (n, max(n - 1, 1), m_loc, N): receive slots
  long long b_rank, ldb;
  int n, m_loc, N, k_loc, n_rb, n_cb, fault;
  Sync sync;
};

// Flag of tile (i, j) in rank r's receive slot s.
__device__ __forceinline__ long long flag_of(const Params& P, int r, int s, int i, int j) {
  return (((long long)r * (P.n - 1) + s) * P.n_rb + i) * P.n_cb + j;
}

__device__ __forceinline__ float* slot_of(const Params& P, int r, int s) {
  return P.recv + ((long long)r * (P.n - 1) + s) * P.m_loc * P.N;
}

template <class T>
__device__ void tile_item(const Params& P, int s, int r, int i, int j, unsigned char* smem) {
  const int n = P.n, c = ((r - s - 1) % n + n) % n;
  const int rows = min(T::BM, P.m_loc - i * T::BM);
  const int cols = min(T::BN, P.N - j * T::BN);
  const bf16* A = P.a + ((long long)r * n * P.m_loc + (long long)c * P.m_loc + i * T::BM) * P.k_loc;
  float* C = tile_mma<T>(A, P.k_loc, rows, P.b + r * P.b_rank + (long long)j * T::BN * P.ldb,
                         P.ldb, cols, P.k_loc, smem);
  const long long off = (long long)i * T::BM * P.N + (long long)j * T::BN;
  const bool add = s > 0 && !(P.fault == kDropPartial && s == 1);
  if (s > 0) wait_arrivals(P.sync, flag_of(P, r, s - 1, i, j), 0, 1, r, s);
  const float* in = s > 0 ? slot_of(P, r, s - 1) + off : nullptr;
  if (s < n - 1) {
    const int right = (r + 1) % n;
    float* dst = slot_of(P, right, s) + off;
    for (int e = threadIdx.x; e < T::BM * T::BN; e += T::kThreads) {
      const int row = e / T::BN, col = e % T::BN;
      if (row < rows && col < cols) {
        float v = C[row * T::kCLd + col];
        if (add) v += __ldcg(in + (long long)row * P.N + col);
        dst[(long long)row * P.N + col] = v;
      }
    }
    if (P.fault == kLostSignal && r == 0 && s == 0) {
      __syncthreads();
      return;
    }
    signal_block(P.sync, flag_of(P, right, s, i, j));
  } else {
    bf16* o = P.out + (long long)r * P.m_loc * P.N + off;
    for (int e = threadIdx.x; e < T::BM * T::BN; e += T::kThreads) {
      const int row = e / T::BN, col = e % T::BN;
      if (row < rows && col < cols) {
        float v = C[row * T::kCLd + col];
        if (add) v += __ldcg(in + (long long)row * P.N + col);
        o[(long long)row * P.N + col] = __float2bfloat16(v);
      }
    }
  }
  __syncthreads();   // C is read before the next item reuses shared memory
}

template <class T>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks) gemm_rs_kernel(Params P) {
  extern __shared__ __align__(128) unsigned char smem[];
  const long long per_rank = (long long)P.n_rb * P.n_cb, per_step = per_rank * P.n;
  const long long total = per_step * P.n;
  for (long long item = blockIdx.x; item < total; item += gridDim.x) {
    const int s = (int)(item / per_step);
    const long long rem = item % per_step;
    const int r = (int)(rem / per_rank);
    const long long t = rem % per_rank;
    tile_item<T>(P, s, r, (int)(t / P.n_cb), (int)(t % P.n_cb), smem);
  }
}

template <class T>
cudaError_t launch(Params& P, int device, cudaStream_t s) {
  P.n_rb = (P.m_loc + T::BM - 1) / T::BM;
  P.n_cb = (P.N + T::BN - 1) / T::BN;
  const long long items = (long long)P.n * P.n * P.n_rb * P.n_cb;
  void* args[] = {&P};
  return cooperative_launch(reinterpret_cast<const void*>(gemm_rs_kernel<T>), T::kThreads,
                            T::kSmem, items, args, device, s);
}

}  // namespace

// Plain C interface for ctypes. a (n, n * m_loc, k_loc) contiguous; rank r's
// weight shard (N, k_loc) at b + r * b_rank elements with row pitch ldb; out
// (n, m_loc, N); recv (n, max(n - 1, 1), m_loc, N) fp32; flags: the
// workspace's n * max(n - 1, 1) * n_rb * n_cb flag words (tiles of
// tdt_tp_tile) then its abort word; k_loc a multiple of 8. epoch: this
// call's (>= 1); timeout_ns bounds every wait; fault: 0, or a planted fault
// (1: step 1 drops the running sum it received, 2: rank 0's first put never
// signalled). Returns a cudaError_t code (0 = launched).
extern "C" int tdt_gemm_rs_bf16(const void* a, const void* b, void* out, void* recv,
                                long long b_rank, long long ldb, int n, int m_loc, int N,
                                int k_loc, void* flags, void* abort_word,
                                unsigned long long epoch, unsigned long long timeout_ns,
                                int fault, int device, void* stream) {
  if (n < 1 || m_loc < 1 || N < 1 || k_loc < 8 || k_loc % 8 || ldb % 8 || b_rank % 8 ||
      epoch == 0 || timeout_ns == 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = ensure_error_record();
  if (e != cudaSuccess) return (int)e;
  Params P;
  P.a = static_cast<const bf16*>(a);
  P.b = static_cast<const bf16*>(b);
  P.out = static_cast<bf16*>(out);
  P.recv = static_cast<float*>(recv);
  P.b_rank = b_rank;
  P.ldb = ldb;
  P.n = n;
  P.m_loc = m_loc;
  P.N = N;
  P.k_loc = k_loc;
  P.fault = fault;
  P.sync.flags = static_cast<u64*>(flags);
  P.sync.abort = static_cast<u64*>(abort_word);
  P.sync.err = g_err_dev;
  P.sync.epoch = epoch;
  P.sync.timeout_ns = timeout_ns;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (small_rows(m_loc)) return (int)launch<SmallTile>(P, device, s);
  return (int)launch<BigTile>(P, device, s);
}
