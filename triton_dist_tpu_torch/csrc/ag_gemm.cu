// Fused all-gather + GEMM across simulated tensor-parallel ranks on Hopper
// (sm_90a): bf16 in and out, fp32 sums.
//
// ag_gemm_kernel replaces triton_dist_tpu/ops/ag_gemm.py _ag_gemm_kernel
// (:143, variant "panel", swizzle "ag"). Rank r holds a row chunk
// a[r] (m_loc x K) and a column-parallel weight shard b[r] (n_loc x K, stored
// (out, in)); every rank computes
//
//   out[r] = concat_c(a[c]) . b[r]^T        (n * m_loc x n_loc)
//
// with rows placed in chunk order, and (write_ag) leaves the gathered A in
// its slice of the gather buffer ws[r] (n * m_loc x K). The ring follows
// the JAX kernel: at step k rank r computes chunk c = (r - k) mod n (its own
// chunk at step 0, read from its input), and forwards the chunk it holds for
// step k to rank r + 1 (remote_put into ws[r + 1], then a signal), for
// k = 0 .. n - 2. A chunk's tiles start only once its flag reaches the
// epoch. Forwarding and flags go by row blocks of the tile height, so a
// tile waits only for its own rows.
//
// Work items, in the order every block walks them (each waits only on a
// lower-numbered item, see shmem_device.cuh): for each step k, the forward
// items (r, row block) of step k, then the tile items (r, row block, column
// block) of step k.
//
// What bounds it on the H100: operations at prefill. Qwen3-8B at tp = 4 over
// a 2048-token prefill: 4 ranks x 2 x 2048 x 4096 x 1024 = 68.7 GFLOP for wq
// (0.070 ms at 989 TFLOP/s), three times that for w_gate; the ring moves
// 3 x 4 MB per rank. This first design runs the tile GEMM of tile_gemm.cuh
// (wmma, cp.async) with the copies as separate items: no wgmma, no TMA, no
// overlap inside a block (PERF.md).

//
// ag_gemm_2d_kernel replaces _ag_gemm_2d_kernel (:588), the hierarchical
// form over an (outer x inner) mesh of R = n_o * n_in ranks, rank
// r = o * n_in + i. The result is the flat one (the same rows in global
// chunk order); what differs is which rank puts which chunk over which hop,
// and when. Step q = s * n_in + t computes global chunk col * n_in + src,
// col = (o - s) mod n_o and src = (i - t) mod n_in (lang/overlap.py
// ag_2d_step): super-step s runs outer column col's chunks through the inner
// ring while that column's seed chunk (col * n_in + i) crosses the outer hop
// toward rank (o + 1, i), where it seeds super-step s + 1. So a rank makes
// n_o * (n_in - 1) inner puts (to (o, i + 1)) and n_o - 1 outer puts, and
// the host checks those counts (`puts`). The inner hop's flags come first in
// the workspace, the outer hop's after them, each per (receiving rank, slot,
// row block): inner slot s * (n_in - 1) + t carries the chunk for step t + 1
// of super-step s, outer slot s the seed of super-step s + 1.
//
// Work items: for each step q, the forward items (rank, row block: wait for
// the chunk of step q, then its inner put, its outer put at t = 0, the own
// chunk into the gather buffer at q = 0), then the tile items (rank, row
// block, column block) of step q; every wait is on a lower step's item.

#include "shmem_device.cuh"
#include "tile_gemm.cuh"

namespace {

using namespace tdt;

enum Fault { kNoFault = 0, kWrongChunk = 1, kLostSignal = 2 };

struct Params {
  const bf16* a;        // (n, m_loc, K)
  const bf16* b;        // rank r's shard at b + r * b_rank, rows ldb apart
  bf16* out;            // (n, n * m_loc, n_loc)
  bf16* ws;             // (n, n * m_loc, K): the gather buffer
  long long b_rank, ldb;
  int n, m_loc, n_loc, K, n_rb, n_cb, write_ag, fault;
  Sync sync;
};

// Flag of row block i of chunk c in rank r's gather buffer.
__device__ __forceinline__ long long flag_of(const Params& P, int r, int c, int i) {
  return ((long long)r * P.n + c) * P.n_rb + i;
}

__device__ __forceinline__ bool forwards(const Params& P, int k) {
  return (P.n > 1 && k < P.n - 1) || (k == 0 && P.write_ag);
}

// Rank r's forward of row block i at step k.
template <class T>
__device__ void forward_item(const Params& P, int k, int r, int i) {
  const int n = P.n, c = ((r - k) % n + n) % n;
  const int rows = min(T::BM, P.m_loc - i * T::BM);
  const long long K = P.K, chunk_rows = (long long)n * P.m_loc;
  const bf16* own = P.a + ((long long)r * P.m_loc + i * T::BM) * K;
  const bf16* src = own;
  if (k > 0) {
    wait_arrivals(P.sync, flag_of(P, r, c, i), 0, 1, r, k);
    if (P.fault != kWrongChunk)
      src = P.ws + (r * chunk_rows + (long long)c * P.m_loc + i * T::BM) * K;
  }
  if (k == 0 && P.write_ag)   // my own chunk into my gather buffer
    remote_put(P.ws + (r * chunk_rows + (long long)r * P.m_loc + i * T::BM) * K, K, src, K,
               rows, P.K);
  if (n > 1 && k < n - 1) {
    const int right = (r + 1) % n;
    remote_put(P.ws + (right * chunk_rows + (long long)c * P.m_loc + i * T::BM) * K, K, src, K,
               rows, P.K);
    if (P.fault == kLostSignal && r == 0 && k == 0) return;
    signal_block(P.sync, flag_of(P, right, c, i));
  }
}

// Rank r's output tile (row block i of chunk c, column block j) at step k.
template <class T>
__device__ void tile_item(const Params& P, int k, int r, int i, int j, unsigned char* smem) {
  const int n = P.n, c = ((r - k) % n + n) % n;
  const long long K = P.K, chunk_rows = (long long)n * P.m_loc;
  const bf16* A = P.a + ((long long)r * P.m_loc + i * T::BM) * K;
  if (k > 0) {
    wait_arrivals(P.sync, flag_of(P, r, c, i), 0, 1, r, k);
    A = P.ws + (r * chunk_rows + (long long)c * P.m_loc + i * T::BM) * K;
  }
  const int rows = min(T::BM, P.m_loc - i * T::BM);
  const int cols = min(T::BN, P.n_loc - j * T::BN);
  const float* C = tile_mma<T>(A, K, rows, P.b + r * P.b_rank + (long long)j * T::BN * P.ldb,
                               P.ldb, cols, P.K, smem);
  store_tile_bf16<T>(P.out + (r * chunk_rows + (long long)c * P.m_loc + i * T::BM) * P.n_loc +
                         (long long)j * T::BN,
                     P.n_loc, C, rows, cols);
  __syncthreads();   // C is read before the next item reuses shared memory
}

template <class T>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks) ag_gemm_kernel(Params P) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n = P.n;
  const long long fwd = (long long)n * P.n_rb, tiles = fwd * P.n_cb;
  long long total = 0;
  for (int k = 0; k < n; ++k) total += (forwards(P, k) ? fwd : 0) + tiles;
  for (long long item = blockIdx.x; item < total; item += gridDim.x) {
    long long rem = item;
    int k = 0;
    for (;; ++k) {
      const long long cnt = (forwards(P, k) ? fwd : 0) + tiles;
      if (rem < cnt) break;
      rem -= cnt;
    }
    if (forwards(P, k)) {
      if (rem < fwd) {
        forward_item<T>(P, k, (int)(rem / P.n_rb), (int)(rem % P.n_rb));
        continue;
      }
      rem -= fwd;
    }
    const int r = (int)(rem / (P.n_rb * (long long)P.n_cb));
    const long long t = rem % (P.n_rb * (long long)P.n_cb);
    tile_item<T>(P, k, r, (int)(t / P.n_cb), (int)(t % P.n_cb), smem);
  }
}

template <class T>
cudaError_t launch(Params& P, int device, cudaStream_t s) {
  P.n_rb = (P.m_loc + T::BM - 1) / T::BM;
  P.n_cb = (P.n_loc + T::BN - 1) / T::BN;
  const long long items = (long long)P.n * P.n_rb * (P.n_cb * (long long)P.n + P.n);
  void* args[] = {&P};
  return cooperative_launch(reinterpret_cast<const void*>(ag_gemm_kernel<T>), T::kThreads,
                            T::kSmem, items, args, device, s);
}

// -- the hierarchical form ------------------------------------------------

enum Fault2D {
  kWrongChunkInner = 1,   // every inner put sends another rank's input chunk
  kLostSignalInner = 2,   // rank 0's first inner put never signalled
  kWrongChunkOuter = 3,   // every outer put sends another rank's input chunk
  kLostSignalOuter = 4,   // rank 0's first outer put never signalled
};

struct Params2D {
  const bf16* a;        // (R, m_loc, K)
  const bf16* b;        // rank r's shard at b + r * b_rank, rows ldb apart
  bf16* out;            // (R, R * m_loc, n_loc)
  bf16* ws;             // (R, R * m_loc, K): the gather buffer
  unsigned long long* puts;   // [inner, outer] chunk puts, or null
  long long b_rank, ldb;
  int n_o, n_in, m_loc, n_loc, K, n_rb, n_cb, write_ag, fault;
  Sync sync;
};

__device__ __forceinline__ long long inner_flag(const Params2D& P, int r, int u, int i) {
  return ((long long)r * P.n_o * (P.n_in - 1) + u) * P.n_rb + i;
}

__device__ __forceinline__ long long outer_flag(const Params2D& P, int r, int h, int i) {
  const long long inner = (long long)P.n_o * P.n_in * P.n_o * (P.n_in - 1) * P.n_rb;
  return inner + ((long long)r * (P.n_o - 1) + h) * P.n_rb + i;
}

__device__ __forceinline__ bool forwards_2d(const Params2D& P, int q) {
  const int s = q / P.n_in, t = q % P.n_in;
  return t < P.n_in - 1 || (t == 0 && s < P.n_o - 1) || (q == 0 && P.write_ag);
}

// Row block i of rank r's chunk for step q: wait for it (q > 0) and return
// where it lies (rank r's input at q = 0, else its gather buffer).
template <class T>
__device__ const bf16* chunk_rows_2d(const Params2D& P, int q, int r, int i, int* cidx) {
  const Coord2 me = coords_of(r, P.n_in);
  const int s = q / P.n_in, t = q % P.n_in;
  const int col = ((me.o - s) % P.n_o + P.n_o) % P.n_o;
  const int src = ((me.i - t) % P.n_in + P.n_in) % P.n_in;
  const int R = P.n_o * P.n_in;
  *cidx = col * P.n_in + src;
  const long long K = P.K;
  if (q == 0) return P.a + ((long long)r * P.m_loc + i * T::BM) * K;
  if (t > 0)
    wait_arrivals(P.sync, inner_flag(P, r, s * (P.n_in - 1) + t - 1, i), 0, 1, r, q);
  else
    wait_arrivals(P.sync, outer_flag(P, r, s - 1, i), 0, 1, r, q);
  return P.ws + ((long long)r * R * P.m_loc + (long long)*cidx * P.m_loc + i * T::BM) * K;
}

template <class T>
__device__ void forward_item_2d(const Params2D& P, int q, int r, int i) {
  const Coord2 me = coords_of(r, P.n_in);
  const int s = q / P.n_in, t = q % P.n_in, R = P.n_o * P.n_in;
  const int rows = min(T::BM, P.m_loc - i * T::BM);
  const long long K = P.K, chunk_rows = (long long)R * P.m_loc;
  int c;
  const bf16* src = chunk_rows_2d<T>(P, q, r, i, &c);
  const long long off = (long long)c * P.m_loc + i * T::BM;
  // Another rank's input rows: what a wrong-chunk fault puts instead.
  const bf16* wrong = P.a + ((long long)((c + 1) % R) * P.m_loc + i * T::BM) * K;
  if (q == 0 && P.write_ag) remote_put(P.ws + (r * chunk_rows + off) * K, K, src, K, rows, P.K);
  if (t < P.n_in - 1) {
    const int dst = rank_of(me.o, (me.i + 1) % P.n_in, P.n_in);
    remote_put(P.ws + (dst * chunk_rows + off) * K, K,
               P.fault == kWrongChunkInner ? wrong : src, K, rows, P.K);
    if (i == 0 && threadIdx.x == 0 && P.puts != nullptr) atomicAdd(P.puts, 1ULL);
    if (!(P.fault == kLostSignalInner && r == 0 && q == 0))
      signal_block(P.sync, inner_flag(P, dst, s * (P.n_in - 1) + t, i));
  }
  if (t == 0 && s < P.n_o - 1) {
    const int dst = rank_of((me.o + 1) % P.n_o, me.i, P.n_in);
    remote_put(P.ws + (dst * chunk_rows + off) * K, K,
               P.fault == kWrongChunkOuter ? wrong : src, K, rows, P.K);
    if (i == 0 && threadIdx.x == 0 && P.puts != nullptr) atomicAdd(P.puts + 1, 1ULL);
    if (!(P.fault == kLostSignalOuter && r == 0 && s == 0))
      signal_block(P.sync, outer_flag(P, dst, s, i));
  }
  __syncthreads();
}

template <class T>
__device__ void tile_item_2d(const Params2D& P, int q, int r, int i, int j, unsigned char* smem) {
  const int R = P.n_o * P.n_in;
  int c;
  const bf16* A = chunk_rows_2d<T>(P, q, r, i, &c);
  const int rows = min(T::BM, P.m_loc - i * T::BM);
  const int cols = min(T::BN, P.n_loc - j * T::BN);
  const float* C = tile_mma<T>(A, P.K, rows, P.b + r * P.b_rank + (long long)j * T::BN * P.ldb,
                               P.ldb, cols, P.K, smem);
  store_tile_bf16<T>(P.out + ((long long)r * R * P.m_loc + (long long)c * P.m_loc + i * T::BM) *
                                 P.n_loc +
                         (long long)j * T::BN,
                     P.n_loc, C, rows, cols);
  __syncthreads();   // C is read before the next item reuses shared memory
}

template <class T>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks) ag_gemm_2d_kernel(Params2D P) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int R = P.n_o * P.n_in;
  const long long fwd = (long long)R * P.n_rb, tiles = fwd * P.n_cb;
  long long total = 0;
  for (int q = 0; q < R; ++q) total += (forwards_2d(P, q) ? fwd : 0) + tiles;
  for (long long item = blockIdx.x; item < total; item += gridDim.x) {
    long long rem = item;
    int q = 0;
    for (;; ++q) {
      const long long cnt = (forwards_2d(P, q) ? fwd : 0) + tiles;
      if (rem < cnt) break;
      rem -= cnt;
    }
    if (forwards_2d(P, q)) {
      if (rem < fwd) {
        forward_item_2d<T>(P, q, (int)(rem / P.n_rb), (int)(rem % P.n_rb));
        continue;
      }
      rem -= fwd;
    }
    const int r = (int)(rem / (P.n_rb * (long long)P.n_cb));
    const long long t = rem % (P.n_rb * (long long)P.n_cb);
    tile_item_2d<T>(P, q, r, (int)(t / P.n_cb), (int)(t % P.n_cb), smem);
  }
}

template <class T>
cudaError_t launch_2d(Params2D& P, int device, cudaStream_t s) {
  P.n_rb = (P.m_loc + T::BM - 1) / T::BM;
  P.n_cb = (P.n_loc + T::BN - 1) / T::BN;
  const long long R = (long long)P.n_o * P.n_in;
  const long long items = R * P.n_rb * (P.n_cb * R + R);
  void* args[] = {&P};
  return cooperative_launch(reinterpret_cast<const void*>(ag_gemm_2d_kernel<T>), T::kThreads,
                            T::kSmem, items, args, device, s);
}

}  // namespace

// Plain C interface of the hierarchical form: as tdt_ag_gemm_bf16 over
// R = n_o * n_in ranks (a (R, m_loc, K), out (R, R * m_loc, n_loc), ws
// (R, R * m_loc, K)); flags: the workspace's inner-hop flags
// R * n_o * (n_in - 1) * n_rb, then its outer-hop flags R * (n_o - 1) * n_rb,
// then its abort word; puts: two uint64 counters [inner, outer] that every
// chunk put adds one to, or null; fault: 0 or a Fault2D. n_o >= 2,
// n_in >= 1. Returns a cudaError_t code (0 = launched).
extern "C" int tdt_ag_gemm_2d_bf16(const void* a, const void* b, void* out, void* ws,
                                   void* puts, long long b_rank, long long ldb, int n_o,
                                   int n_in, int m_loc, int n_loc, int K, int write_ag,
                                   void* flags, void* abort_word, unsigned long long epoch,
                                   unsigned long long timeout_ns, int fault, int device,
                                   void* stream) {
  if (n_o < 2 || n_in < 1 || m_loc < 1 || n_loc < 1 || K < 8 || K % 8 || ldb % 8 ||
      b_rank % 8 || epoch == 0 || timeout_ns == 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = ensure_error_record();
  if (e != cudaSuccess) return (int)e;
  Params2D P;
  P.a = static_cast<const bf16*>(a);
  P.b = static_cast<const bf16*>(b);
  P.out = static_cast<bf16*>(out);
  P.ws = static_cast<bf16*>(ws);
  P.puts = static_cast<unsigned long long*>(puts);
  P.b_rank = b_rank;
  P.ldb = ldb;
  P.n_o = n_o;
  P.n_in = n_in;
  P.m_loc = m_loc;
  P.n_loc = n_loc;
  P.K = K;
  P.write_ag = write_ag;
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

// Plain C interface for ctypes. a (n, m_loc, K) contiguous; rank r's weight
// shard (n_loc, K) at b + r * b_rank elements with row pitch ldb; out
// (n, n * m_loc, n_loc); ws (n, n * m_loc, K); flags: the workspace's
// n * n * n_rb flag words (n_rb = ceil(m_loc / row block), the row block
// tdt_tp_tile's rows) then its abort word; K a multiple of 8. epoch: this
// call's (>= 1); timeout_ns bounds every wait; fault: 0, or a planted fault
// (1: forward a rank's own chunk in place of the one it received, 2: rank
// 0's first forward never signalled). Returns a cudaError_t code
// (0 = launched).
extern "C" int tdt_ag_gemm_bf16(const void* a, const void* b, void* out, void* ws,
                                long long b_rank, long long ldb, int n, int m_loc, int n_loc,
                                int K, int write_ag, void* flags, void* abort_word,
                                unsigned long long epoch, unsigned long long timeout_ns,
                                int fault, int device, void* stream) {
  if (n < 1 || m_loc < 1 || n_loc < 1 || K < 8 || K % 8 || ldb % 8 || b_rank % 8 ||
      epoch == 0 || timeout_ns == 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = ensure_error_record();
  if (e != cudaSuccess) return (int)e;
  Params P;
  P.a = static_cast<const bf16*>(a);
  P.b = static_cast<const bf16*>(b);
  P.out = static_cast<bf16*>(out);
  P.ws = static_cast<bf16*>(ws);
  P.b_rank = b_rank;
  P.ldb = ldb;
  P.n = n;
  P.m_loc = m_loc;
  P.n_loc = n_loc;
  P.K = K;
  P.write_ag = write_ag;
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
