// Fused GEMM + all-reduce across simulated tensor-parallel ranks on Hopper
// (sm_90a): bf16 in and out, fp32 partials.
//
// gemm_ar_kernel replaces triton_dist_tpu/ops/gemm_ar.py _gemm_ar_kernel
// (:131, variant "one_shot") and _gemm_ar_ll_kernel (:162, variant "ll").
// Rank r holds the K-shard a[r] (M x k_loc) and the row-parallel weight
// shard b[r] (N x k_loc, stored (out, in)); every rank ends with
//
//   out[r] = sum over ranks s = 0 .. n - 1 of a[s] . b[s]^T      (M x N)
//
// added in slot order in fp32 and rounded to bf16 once (the plain version's
// order). As in the JAX kernels (_ar_push_tile, _ar_sum_tile), a rank
// computes each output tile's partial and pushes it into slot r of every
// rank's gather buffer (its own included) with a signal per (rank, slot,
// tile); a reduce of tile t on rank r waits for the n slots of t, then sums
// them. The gather buffer is fp32 in device memory, so the (M, tile) partial
// of a 2048-row prefill never has to fit in shared memory.
//
//   one_shot: every tile's pushes, then every tile's reduce.
//   ll:       the reduce of column block j - 1 right after the pushes of
//             column block j (the JAX kernel's one-tile lag; the lag goes by
//             the kernel's column block, not JAX's block_n).
//
// The ranks may be part of a larger mesh (parallel/mesh.py): R ranks in all,
// the reduction running over an axis of size n whose neighbours lie st flat
// ranks apart, in each group of ranks that share their other coordinates.
// The hierarchical GEMM+AR (ops/gemm_ar.py, JAX :237-247) runs this kernel
// over the inner axis of an (outer x inner) mesh, every group in one
// launch, then the one-shot all-reduce (collectives.cu) over the outer one.
// "Rank" below is a flat rank r, "slot" a position in r's group.
//
// Work items, in the order every block walks them (each waits only on a
// lower-numbered item, see shmem_device.cuh): compute items (column block,
// rank, row block) and reduce items, interleaved as above.
//
// What bounds it on the H100: bytes at decode (M = 4): the weight shards,
// 4 x 4096 x 1024 bf16 = 33.6 MB for wo (0.010 ms at 3.35 TB/s), three
// times that for w_down. Operations at a 2048-row prefill, where the
// n^2 fp32 partial copies (512 MB for wo) also cost. Decode rows run the
// 16-row tile of tile_gemm.cuh (four cp.async stages to keep the weight
// stream in flight), prefill rows the 128-row one (PERF.md).

#include "shmem_device.cuh"
#include "tile_gemm.cuh"

namespace {

using namespace tdt;

enum Fault { kNoFault = 0, kDropPartial = 1, kLostSignal = 2 };

struct Params {
  const bf16* a;        // (R, M, k_loc)
  const bf16* b;        // rank r's shard at b + r * b_rank, rows ldb apart
  bf16* out;            // (R, M, N)
  float* gather;        // (R, n, M, N): gather[dst rank][src slot]
  long long b_rank, ldb;
  int R, n, st, M, N, k_loc, n_rb, n_cb, ll, fault;
  Sync sync;
};

__device__ __forceinline__ long long flag_of(const Params& P, int dst, int src, int t) {
  return ((long long)dst * P.n + src) * P.n_rb * P.n_cb + t;
}

__device__ __forceinline__ float* slot_of(const Params& P, int dst, int src) {
  return P.gather + ((long long)dst * P.n + src) * P.M * P.N;
}

// Rank r's partial of tile (i, j), pushed to slot me of every rank of its
// group.
template <class T>
__device__ void compute_item(const Params& P, int r, int i, int j, unsigned char* smem) {
  const int rows = min(T::BM, P.M - i * T::BM);
  const int cols = min(T::BN, P.N - j * T::BN);
  const float* C = tile_mma<T>(P.a + ((long long)r * P.M + i * T::BM) * P.k_loc, P.k_loc, rows,
                               P.b + r * P.b_rank + (long long)j * T::BN * P.ldb, P.ldb, cols,
                               P.k_loc, smem);
  const long long off = (long long)i * T::BM * P.N + (long long)j * T::BN;
  const int me = axis_pos(r, P.n, P.st);
  for (int e = threadIdx.x; e < T::BM * T::BN; e += T::kThreads) {
    const int row = e / T::BN, col = e % T::BN;
    if (row < rows && col < cols) {
      const float v = C[row * T::kCLd + col];
      for (int p = 0; p < P.n; ++p)
        slot_of(P, axis_peer(r, p, P.n, P.st), me)[off + (long long)row * P.N + col] = v;
    }
  }
  fence();
  __syncthreads();   // every push landed, and C is read
  if (threadIdx.x == 0) {
    const int t = i * P.n_cb + j;
    for (int p = 0; p < P.n; ++p) {
      if (P.fault == kLostSignal && r == 0 && p == 1 % P.n && t == 0) continue;
      signal_op(P.sync, flag_of(P, axis_peer(r, p, P.n, P.st), me, t));
    }
  }
}

// Rank r's sum of tile (i, j) over the n slots, in slot order.
template <class T>
__device__ void reduce_item(const Params& P, int r, int i, int j) {
  const int t = i * P.n_cb + j;
  wait_arrivals(P.sync, flag_of(P, r, 0, t), (long long)P.n_rb * P.n_cb, P.n, r, j);
  const int rows = min(T::BM, P.M - i * T::BM);
  const int cols = min(T::BN, P.N - j * T::BN);
  const long long off = (long long)i * T::BM * P.N + (long long)j * T::BN;
  const int dropped = P.fault == kDropPartial ? (axis_pos(r, P.n, P.st) + 1) % P.n : -1;
  bf16* o = P.out + (long long)r * P.M * P.N + off;
  for (int e = threadIdx.x; e < T::BM * T::BN; e += T::kThreads) {
    const int row = e / T::BN, col = e % T::BN;
    if (row < rows && col < cols) {
      const long long x = off + (long long)row * P.N + col;
      float acc = 0.f;
      for (int s = 0; s < P.n; ++s)
        if (s != dropped) acc += __ldcg(slot_of(P, r, s) + x);
      o[(long long)row * P.N + col] = __float2bfloat16(acc);
    }
  }
}

// No kMinBlocks cap: at 128 registers this kernel holds two prefill blocks
// an SM already, so the cap would only add spills (PERF.md §6).
template <class T>
__global__ void __launch_bounds__(T::kThreads) gemm_ar_kernel(Params P) {
  extern __shared__ __align__(128) unsigned char smem[];
  // One column block's items: R ranks x n_rb row blocks, computes or
  // reduces alike.
  const long long col = (long long)P.R * P.n_rb;
  const long long total = 2 * col * P.n_cb;
  for (long long item = blockIdx.x; item < total; item += gridDim.x) {
    // ll: group g < n_cb holds column block g's computes then column block
    // g - 1's reduces (g >= 1); group n_cb the last reduces.
    // one_shot: every compute (column-major), then every reduce.
    bool reduce;
    int j;
    long long rem;
    if (P.ll) {
      const long long g = item < col ? 0 : (item - col) / (2 * col) + 1;
      rem = g == 0 ? item : (item - col) % (2 * col);
      if (g == 0) {
        reduce = false;
        j = 0;
      } else if (g == P.n_cb) {
        reduce = true;
        j = P.n_cb - 1;
      } else {
        reduce = rem >= col;
        j = reduce ? (int)g - 1 : (int)g;
        if (reduce) rem -= col;
      }
    } else {
      reduce = item >= col * P.n_cb;
      rem = reduce ? item - col * P.n_cb : item;
      j = (int)(rem / col);
      rem %= col;
    }
    const int r = (int)(rem / P.n_rb), i = (int)(rem % P.n_rb);
    if (reduce) {
      reduce_item<T>(P, r, i, j);
    } else {
      compute_item<T>(P, r, i, j, smem);
    }
    __syncthreads();   // shared memory is free for the next item
  }
}

template <class T>
cudaError_t launch(Params& P, int device, cudaStream_t s) {
  P.n_rb = (P.M + T::BM - 1) / T::BM;
  P.n_cb = (P.N + T::BN - 1) / T::BN;
  const long long items = 2LL * P.R * P.n_rb * P.n_cb;
  void* args[] = {&P};
  return cooperative_launch(reinterpret_cast<const void*>(gemm_ar_kernel<T>), T::kThreads,
                            T::kSmem, items, args, device, s);
}

}  // namespace

// Plain C interface for ctypes. a (R, M, k_loc) contiguous; rank r's weight
// shard (N, k_loc) at b + r * b_rank elements with row pitch ldb; out
// (R, M, N); gather (R, n, M, N) fp32; the reduction over an axis of size n
// and stride st (R a multiple of n * st); flags: the workspace's
// R * n * n_rb * n_cb flag words (tiles of tdt_tp_tile) then its abort
// word; k_loc a multiple of 8; ll: 1 for the "ll" variant, 0 for
// "one_shot". epoch: this call's (>= 1); timeout_ns bounds every wait;
// fault: 0, or a planted fault (1: every rank's reduce drops slot me + 1,
// 2: rank 0's first tile never signals its group's slot 1). Returns a
// cudaError_t code (0 = launched).
extern "C" int tdt_gemm_ar_bf16(const void* a, const void* b, void* out, void* gather,
                                long long b_rank, long long ldb, int R, int n, int st, int M,
                                int N, int k_loc, int ll, void* flags, void* abort_word,
                                unsigned long long epoch, unsigned long long timeout_ns,
                                int fault, int device, void* stream) {
  if (R < 1 || n < 1 || st < 1 || R % (n * st) || M < 1 || N < 1 || k_loc < 8 || k_loc % 8 ||
      ldb % 8 || b_rank % 8 || epoch == 0 || timeout_ns == 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = ensure_error_record();
  if (e != cudaSuccess) return (int)e;
  Params P;
  P.a = static_cast<const bf16*>(a);
  P.b = static_cast<const bf16*>(b);
  P.out = static_cast<bf16*>(out);
  P.gather = static_cast<float*>(gather);
  P.b_rank = b_rank;
  P.ldb = ldb;
  P.R = R;
  P.n = n;
  P.st = st;
  P.M = M;
  P.N = N;
  P.k_loc = k_loc;
  P.ll = ll;
  P.fault = fault;
  P.sync.flags = static_cast<u64*>(flags);
  P.sync.abort = static_cast<u64*>(abort_word);
  P.sync.err = g_err_dev;
  P.sync.epoch = epoch;
  P.sync.timeout_ns = timeout_ns;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (small_rows(M)) return (int)launch<SmallTile>(P, device, s);
  return (int)launch<BigTile>(P, device, s);
}
