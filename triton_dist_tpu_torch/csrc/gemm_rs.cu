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

//
// gemm_rs_2d_kernel replaces _gemm_rs_2d_kernel (:307), the hierarchical
// form over an (outer x inner) mesh of R = n_o * n_in ranks, rank
// r = o * n_in + i, with the flat result (rank r ends with chunk r's sum).
// Step q = t * n_in + s (lang/overlap.py rs_2d_step): super-step t
// ring-reduces, through the GEMM as the flat ring does, the chunks bound for
// outer group o_dst = (o + n_o - 1 - t) mod n_o, inner chunk
// (i - s - 1) mod n_in. At s < n_in - 1 the running sum goes to the inner
// neighbour (o, i + 1); at s = n_in - 1 it is the group sum of chunk
// o_dst * n_in + i, which crosses the outer hop once, to rank (o_dst, i)'s
// outer slot t, except in the last super-step, where o_dst = o: the rank
// then adds the n_o - 1 group sums it received, in slot order, and writes
// its output. So a rank makes n_o * (n_in - 1) inner puts and n_o - 1 outer
// puts of a group sum, and the host checks those counts (`puts`). The inner
// hop's flags come first in the workspace, the outer hop's after them, each
// per (receiving rank, slot, tile). Work items: (step, rank, row block,
// column block); every wait is on a lower step's item.

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

// -- the hierarchical form ------------------------------------------------

enum Fault2D {
  kWrongChunkInner = 1,   // inner puts carry the sum of another chunk's rows
  kLostSignalInner = 2,   // rank 0's first inner put never signalled
  kWrongChunkOuter = 3,   // outer puts carry the sum of another chunk's rows
  kLostSignalOuter = 4,   // rank 0's first outer put never signalled
};

struct Params2D {
  const bf16* a;        // (R, R * m_loc, k_loc)
  const bf16* b;        // rank r's shard at b + r * b_rank, rows ldb apart
  bf16* out;            // (R, m_loc, N)
  float* irecv;         // (R, max(n_o * (n_in - 1), 1), m_loc, N)
  float* orecv;         // (R, n_o - 1, m_loc, N)
  unsigned long long* puts;   // [inner, outer] group-sum puts, or null
  long long b_rank, ldb;
  int n_o, n_in, m_loc, N, k_loc, n_rb, n_cb, fault;
  Sync sync;
};

__device__ __forceinline__ long long tiles_2d(const Params2D& P) {
  return (long long)P.n_rb * P.n_cb;
}

__device__ __forceinline__ long long inner_flag(const Params2D& P, int r, int u, long long tile) {
  return ((long long)r * P.n_o * (P.n_in - 1) + u) * tiles_2d(P) + tile;
}

__device__ __forceinline__ long long outer_flag(const Params2D& P, int r, int h, long long tile) {
  const long long inner = (long long)P.n_o * P.n_in * P.n_o * (P.n_in - 1) * tiles_2d(P);
  return inner + ((long long)r * (P.n_o - 1) + h) * tiles_2d(P) + tile;
}

__device__ __forceinline__ float* islot(const Params2D& P, int r, int u) {
  return P.irecv + ((long long)r * max(P.n_o * (P.n_in - 1), 1) + u) * P.m_loc * P.N;
}

__device__ __forceinline__ float* oslot(const Params2D& P, int r, int h) {
  return P.orecv + ((long long)r * (P.n_o - 1) + h) * P.m_loc * P.N;
}

template <class T>
__device__ void tile_item_2d(const Params2D& P, int q, int r, int i, int j, unsigned char* smem) {
  const Coord2 me = coords_of(r, P.n_in);
  const int t = q / P.n_in, s = q % P.n_in, R = P.n_o * P.n_in;
  const int o_dst = (me.o + P.n_o - 1 - t) % P.n_o;
  const int chunk = o_dst * P.n_in + ((me.i - s - 1) % P.n_in + P.n_in) % P.n_in;
  const bool inner_put = s < P.n_in - 1, outer_put = !inner_put && t < P.n_o - 1;
  const bool wrong = (inner_put && P.fault == kWrongChunkInner) ||
                     (outer_put && P.fault == kWrongChunkOuter);
  const int rows = min(T::BM, P.m_loc - i * T::BM);
  const int cols = min(T::BN, P.N - j * T::BN);
  const long long tile = (long long)i * P.n_cb + j;
  const bf16* A = P.a + ((long long)r * R * P.m_loc +
                         (long long)((wrong ? chunk + 1 : chunk) % R) * P.m_loc + i * T::BM) *
                            P.k_loc;
  float* C = tile_mma<T>(A, P.k_loc, rows, P.b + r * P.b_rank + (long long)j * T::BN * P.ldb,
                         P.ldb, cols, P.k_loc, smem);
  const long long off = (long long)i * T::BM * P.N + (long long)j * T::BN;
  const float* in = nullptr;
  if (s > 0) {
    const int u = t * (P.n_in - 1) + s - 1;
    wait_arrivals(P.sync, inner_flag(P, r, u, tile), 0, 1, r, q);
    in = islot(P, r, u) + off;
  }
  if (inner_put || outer_put) {
    const int dst = inner_put ? rank_of(me.o, (me.i + 1) % P.n_in, P.n_in)
                              : rank_of(o_dst, me.i, P.n_in);
    float* d = (inner_put ? islot(P, dst, t * (P.n_in - 1) + s) : oslot(P, dst, t)) + off;
    for (int e = threadIdx.x; e < T::BM * T::BN; e += T::kThreads) {
      const int row = e / T::BN, col = e % T::BN;
      if (row < rows && col < cols) {
        float v = C[row * T::kCLd + col];
        if (in != nullptr) v += __ldcg(in + (long long)row * P.N + col);
        d[(long long)row * P.N + col] = v;
      }
    }
    if (tile == 0 && threadIdx.x == 0 && P.puts != nullptr) atomicAdd(P.puts + !inner_put, 1ULL);
    const bool lost = r == 0 && tile == 0 &&
                      ((inner_put && q == 0 && P.fault == kLostSignalInner) ||
                       (outer_put && t == 0 && P.fault == kLostSignalOuter));
    if (lost) {
      __syncthreads();
    } else {
      signal_block(P.sync, inner_put ? inner_flag(P, dst, t * (P.n_in - 1) + s, tile)
                                     : outer_flag(P, dst, t, tile));
    }
  } else {
    // The rank's own chunk: the n_o - 1 group sums that crossed the outer
    // hop, added in slot order after the inner ring's sum.
    if (P.n_o > 1 && threadIdx.x == 0) {
      for (int h = 0; h < P.n_o - 1; ++h) signal_wait_until(P.sync, outer_flag(P, r, h, tile), r, q);
      fence();
    }
    __syncthreads();
    bf16* o = P.out + (long long)r * P.m_loc * P.N + off;
    for (int e = threadIdx.x; e < T::BM * T::BN; e += T::kThreads) {
      const int row = e / T::BN, col = e % T::BN;
      if (row < rows && col < cols) {
        const long long x = (long long)row * P.N + col;
        float v = C[row * T::kCLd + col];
        if (in != nullptr) v += __ldcg(in + x);
        for (int h = 0; h < P.n_o - 1; ++h) v += __ldcg(oslot(P, r, h) + off + x);
        o[x] = __float2bfloat16(v);
      }
    }
  }
  __syncthreads();   // C is read before the next item reuses shared memory
}

template <class T>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks) gemm_rs_2d_kernel(Params2D P) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int R = P.n_o * P.n_in;
  const long long per_rank = tiles_2d(P), per_step = per_rank * R;
  const long long total = per_step * R;
  for (long long item = blockIdx.x; item < total; item += gridDim.x) {
    const int q = (int)(item / per_step);
    const long long rem = item % per_step;
    const int r = (int)(rem / per_rank);
    const long long t = rem % per_rank;
    tile_item_2d<T>(P, q, r, (int)(t / P.n_cb), (int)(t % P.n_cb), smem);
  }
}

template <class T>
cudaError_t launch_2d(Params2D& P, int device, cudaStream_t s) {
  P.n_rb = (P.m_loc + T::BM - 1) / T::BM;
  P.n_cb = (P.N + T::BN - 1) / T::BN;
  const long long R = (long long)P.n_o * P.n_in;
  const long long items = R * R * P.n_rb * P.n_cb;
  void* args[] = {&P};
  return cooperative_launch(reinterpret_cast<const void*>(gemm_rs_2d_kernel<T>), T::kThreads,
                            T::kSmem, items, args, device, s);
}

}  // namespace

// Plain C interface of the hierarchical form: as tdt_gemm_rs_bf16 over
// R = n_o * n_in ranks (a (R, R * m_loc, k_loc), out (R, m_loc, N)); irecv
// (R, max(n_o * (n_in - 1), 1), m_loc, N) and orecv (R, n_o - 1, m_loc, N)
// fp32 receive slots of the two hops; flags: the workspace's inner-hop flags
// R * n_o * (n_in - 1) * n_rb * n_cb, then its outer-hop flags
// R * (n_o - 1) * n_rb * n_cb, then its abort word; puts: two uint64
// counters [inner, outer] that every group-sum put adds one to, or null;
// fault: 0 or a Fault2D. n_o >= 2, n_in >= 1. Returns a cudaError_t code
// (0 = launched).
extern "C" int tdt_gemm_rs_2d_bf16(const void* a, const void* b, void* out, void* irecv,
                                   void* orecv, void* puts, long long b_rank, long long ldb,
                                   int n_o, int n_in, int m_loc, int N, int k_loc, void* flags,
                                   void* abort_word, unsigned long long epoch,
                                   unsigned long long timeout_ns, int fault, int device,
                                   void* stream) {
  if (n_o < 2 || n_in < 1 || m_loc < 1 || N < 1 || k_loc < 8 || k_loc % 8 || ldb % 8 ||
      b_rank % 8 || epoch == 0 || timeout_ns == 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = ensure_error_record();
  if (e != cudaSuccess) return (int)e;
  Params2D P;
  P.a = static_cast<const bf16*>(a);
  P.b = static_cast<const bf16*>(b);
  P.out = static_cast<bf16*>(out);
  P.irecv = static_cast<float*>(irecv);
  P.orecv = static_cast<float*>(orecv);
  P.puts = static_cast<unsigned long long*>(puts);
  P.b_rank = b_rank;
  P.ldb = ldb;
  P.n_o = n_o;
  P.n_in = n_in;
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
  if (small_rows(m_loc)) return (int)launch_2d<SmallTile>(P, device, s);
  return (int)launch_2d<BigTile>(P, device, s);
}

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
