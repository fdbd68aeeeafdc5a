// The MoE combine epilogue across simulated tensor-parallel ranks on Hopper
// (sm_90a): the weighted top-k combine of every rank's expert outputs fused
// into a reduce-scatter (moe_reduce_rs_kernel) or an all-reduce
// (moe_reduce_ar_kernel). bf16 expert outputs, fp32 weights and sums.
//
// Rank r holds y[r] (T x K x d), its ffn shard's partial output of every
// (token, top-k slot), and the top-k weights w[r] (T x K, the same on every
// rank). Its partial of token t is
//
//   p_r[t] = sum_k w[r][t][k] * y[r][t][k]      (fp32, k in order)
//
// moe_reduce_rs_kernel replaces triton_dist_tpu/ops/moe_reduce.py
// _moe_rs_kernel (:148): rank r ends with the sum over ranks of rows
// [r * t_loc, (r + 1) * t_loc), t_loc = T / n. GEMM+RS's ring (gemm_rs.cu,
// row 10) with the combine as the producer: at step s rank r combines its
// partial of chunk c = (r - s - 1) mod n, adds the fp32 running sum rank r - 1
// sent at step s - 1, and at s < n - 1 puts the new running sum into rank
// r + 1's receive slot s and signals it; at s = n - 1 (c = r) it rounds the
// sum to bf16 once and writes its output. Chunk c's sum visits ranks c + 1,
// c + 2, ..., c (the order the plain version adds in). The partials travel
// in fp32, as the JAX kernel's recv_hbm / send_hbm.
//
// moe_reduce_ar_kernel replaces the same file's _moe_ar_kernel (:42): every
// rank ends with the whole sum (T x d). GEMM+AR's one-shot form (gemm_ar.cu,
// row 13): a rank combines each output tile's partial and puts it into
// slot r of every rank's fp32 gather buffer (its own included), signalling
// each; after every push, a rank's reduce of a tile waits for its n slots
// and sums them in rank order 0 .. n - 1, rounding once.
//
// Work items, in the order every block walks them (each waits only on a
// lower-numbered item, see shmem_device.cuh): RS (step, rank, row block,
// column block); AR every (rank, row block, column block) push, then every
// reduce.
//
// What bounds it on the H100: bytes. At Qwen3-30B-A3B tp = 4 over 512 tokens
// a rank (T = 2048, K = 8, d = 2048) a rank reads 64 MB of y, 256 MB in all
// (0.08 ms at 3.35 TB/s), against 0.27 GFLOP. This first design runs one
// tile of at most 16 rows x 256 columns per item, 8 columns of 16 bytes a
// thread, the weights read from L1 (PERF.md).

#include "shmem_device.cuh"

namespace {

using namespace tdt;

enum Fault { kNoFault = 0, kWrongChunk = 1, kLostSignal = 2, kWrongWeight = 3 };

constexpr int kThreads = 256;
constexpr int kMaxTile = 16 * 256;                  // elements of one item's tile
constexpr int kVecs = kMaxTile / 8 / kThreads;      // 8-column vectors a thread

struct Params {
  const bf16* y;    // rank r at y + r * y_rank: (T, K, d)
  const float* w;   // rank r at w + r * w_rank: (T, K)
  bf16* out;        // RS (n, t_loc, d); AR (n, T, d)
  float* buf;       // RS receive slots (n, n - 1, t_loc, d); AR gather (n, n, T, d)
  long long y_rank, w_rank;
  int n, T, K, d, rows, tm, tn, n_rb, n_cb, fault;   // rows: t_loc (RS) or T (AR)
  Sync sync;
};

// v[0..8) = sum_k w[t][k] * y[t][k][col .. col + 8) of rank r, in fp32.
__device__ __forceinline__ void combine(const Params& P, int r, long long t, int col, float* v) {
  const bf16* y = P.y + r * P.y_rank + t * P.K * P.d + col;
  const float* w = P.w + r * P.w_rank + t * P.K;
#pragma unroll
  for (int q = 0; q < 8; ++q) v[q] = 0.f;
  for (int k = 0; k < P.K; ++k) {
    const float wk = __ldg(w + (P.fault == kWrongWeight ? (k + 1) % P.K : k));
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(y + (long long)k * P.d));
    const bf16* b = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] += wk * __bfloat162float(b[q]);
  }
}

// The vectors of tile (i, j) that thread threadIdx.x owns: vector q of the
// tile is row q / (tn / 8), columns (q % (tn / 8)) * 8 .. + 8.
struct TileVecs {
  int rows, vpr;      // real rows of the tile, vectors a row
  long long row0;     // first row in the output rows
  int col0;
  __device__ bool get(int slot, int* r, int* c) const {
    const int q = threadIdx.x + slot * kThreads;
    if (q >= rows * vpr) return false;
    *r = q / vpr;
    *c = col0 + (q % vpr) * 8;
    return true;
  }
};

__device__ __forceinline__ TileVecs tile_vecs(const Params& P, int i, int j) {
  TileVecs tv;
  tv.rows = min(P.tm, P.rows - i * P.tm);
  tv.vpr = min(P.tn, P.d - j * P.tn) / 8;
  tv.row0 = (long long)i * P.tm;
  tv.col0 = j * P.tn;
  return tv;
}

__device__ __forceinline__ void add4(float* v, const float* p) {
  const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcg(reinterpret_cast<const float4*>(p + 4));
  v[0] += a.x; v[1] += a.y; v[2] += a.z; v[3] += a.w;
  v[4] += b.x; v[5] += b.y; v[6] += b.z; v[7] += b.w;
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(bf16* p, const float* v) {
  uint4 raw;
  bf16* b = reinterpret_cast<bf16*>(&raw);
#pragma unroll
  for (int q = 0; q < 8; ++q) b[q] = __float2bfloat16(v[q]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// ---- reduce-scatter --------------------------------------------------------

__device__ __forceinline__ long long rs_flag(const Params& P, int r, int s, int i, int j) {
  return (((long long)r * (P.n - 1) + s) * P.n_rb + i) * P.n_cb + j;
}

__device__ __forceinline__ float* rs_slot(const Params& P, int r, int s) {
  return P.buf + ((long long)r * (P.n - 1) + s) * P.rows * P.d;
}

__device__ void rs_item(const Params& P, int s, int r, int i, int j) {
  const int n = P.n;
  int c = ((r - s - 1) % n + n) % n;
  const TileVecs tv = tile_vecs(P, i, j);
  // The combine first: it needs nothing from the other ranks.
  const int src_chunk = (P.fault == kWrongChunk && s == 0) ? (c + 1) % n : c;
  float v[kVecs][8];
#pragma unroll
  for (int q = 0; q < kVecs; ++q) {
    int row, col;
    if (tv.get(q, &row, &col))
      combine(P, r, (long long)src_chunk * P.rows + tv.row0 + row, col, v[q]);
  }
  if (s > 0) wait_arrivals(P.sync, rs_flag(P, r, s - 1, i, j), 0, 1, r, s);
  const float* in = s > 0 ? rs_slot(P, r, s - 1) : nullptr;
  const int right = (r + 1) % n;
#pragma unroll
  for (int q = 0; q < kVecs; ++q) {
    int row, col;
    if (!tv.get(q, &row, &col)) continue;
    const long long off = (tv.row0 + row) * P.d + col;
    if (s > 0) add4(v[q], in + off);
    if (s < n - 1)
      store8(rs_slot(P, right, s) + off, v[q]);
    else
      store8(P.out + (long long)r * P.rows * P.d + off, v[q]);
  }
  if (s < n - 1) {
    if (P.fault == kLostSignal && r == 0 && s == 0 && i == 0 && j == 0) {
      __syncthreads();
      return;
    }
    signal_block(P.sync, rs_flag(P, right, s, i, j));
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) moe_reduce_rs_kernel(Params P) {
  const long long per_rank = (long long)P.n_rb * P.n_cb, per_step = per_rank * P.n;
  const long long total = per_step * P.n;
  for (long long item = blockIdx.x; item < total; item += gridDim.x) {
    const int s = (int)(item / per_step);
    const long long rem = item % per_step;
    const long long t = rem % per_rank;
    rs_item(P, s, (int)(rem / per_rank), (int)(t / P.n_cb), (int)(t % P.n_cb));
  }
}

// ---- all-reduce ------------------------------------------------------------

__device__ __forceinline__ long long ar_flag(const Params& P, int dst, int src, int t) {
  return ((long long)dst * P.n + src) * P.n_rb * P.n_cb + t;
}

__device__ __forceinline__ float* ar_slot(const Params& P, int dst, int src) {
  return P.buf + ((long long)dst * P.n + src) * P.rows * P.d;
}

// Rank r's partial of tile (i, j), put into slot r of every rank.
__device__ void ar_push(const Params& P, int r, int i, int j) {
  const TileVecs tv = tile_vecs(P, i, j);
#pragma unroll
  for (int q = 0; q < kVecs; ++q) {
    int row, col;
    if (!tv.get(q, &row, &col)) continue;
    float v[8];
    combine(P, r, tv.row0 + row, col, v);
    const long long off = (tv.row0 + row) * P.d + col;
    for (int p = 0; p < P.n; ++p) store8(ar_slot(P, p, r) + off, v);
  }
  fence();
  __syncthreads();   // every put landed
  if (threadIdx.x == 0) {
    const int t = i * P.n_cb + j;
    for (int p = 0; p < P.n; ++p) {
      if (P.fault == kLostSignal && r == 0 && p == 1 % P.n && t == 0) continue;
      signal_op(P.sync, ar_flag(P, p, r, t));
    }
  }
}

// Rank r's sum of tile (i, j) over the n slots, in rank order.
__device__ void ar_reduce(const Params& P, int r, int i, int j) {
  const int t = i * P.n_cb + j;
  wait_arrivals(P.sync, ar_flag(P, r, 0, t), (long long)P.n_rb * P.n_cb, P.n, r, j);
  const TileVecs tv = tile_vecs(P, i, j);
  // A planted fault reads the slot one rank over in place of its own.
  const int own = P.fault == kWrongChunk ? (r + 1) % P.n : r;
#pragma unroll
  for (int q = 0; q < kVecs; ++q) {
    int row, col;
    if (!tv.get(q, &row, &col)) continue;
    const long long off = (tv.row0 + row) * P.d + col;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int s = 0; s < P.n; ++s) add4(v, ar_slot(P, r, s == r ? own : s) + off);
    store8(P.out + (long long)r * P.rows * P.d + off, v);
  }
}

__global__ void __launch_bounds__(kThreads) moe_reduce_ar_kernel(Params P) {
  const long long per_rank = (long long)P.n_rb * P.n_cb, pushes = per_rank * P.n;
  for (long long item = blockIdx.x; item < 2 * pushes; item += gridDim.x) {
    const bool reduce = item >= pushes;
    const long long rem = reduce ? item - pushes : item;
    const int r = (int)(rem / per_rank);
    const long long t = rem % per_rank;
    if (reduce)
      ar_reduce(P, r, (int)(t / P.n_cb), (int)(t % P.n_cb));
    else
      ar_push(P, r, (int)(t / P.n_cb), (int)(t % P.n_cb));
    __syncthreads();
  }
}

int fill(Params& P, const void* y, const void* w, void* out, void* buf, long long y_rank,
         long long w_rank, int n, int T, int K, int d, int rows, int tm, int tn, void* flags,
         void* abort_word, unsigned long long epoch, unsigned long long timeout_ns, int fault) {
  if (n < 1 || T < 1 || K < 1 || d < 8 || d % 8 || rows < 1 || tm < 1 || tn < 8 || tn % 8 ||
      tm * tn > kMaxTile || y_rank % 8 || epoch == 0 || timeout_ns == 0)
    return (int)cudaErrorInvalidValue;
  P.y = static_cast<const bf16*>(y);
  P.w = static_cast<const float*>(w);
  P.out = static_cast<bf16*>(out);
  P.buf = static_cast<float*>(buf);
  P.y_rank = y_rank;
  P.w_rank = w_rank;
  P.n = n;
  P.T = T;
  P.K = K;
  P.d = d;
  P.rows = rows;
  P.tm = tm;
  P.tn = tn;
  P.n_rb = (rows + tm - 1) / tm;
  P.n_cb = (d + tn - 1) / tn;
  P.fault = fault;
  P.sync.flags = static_cast<u64*>(flags);
  P.sync.abort = static_cast<u64*>(abort_word);
  P.sync.err = g_err_dev;
  P.sync.epoch = epoch;
  P.sync.timeout_ns = timeout_ns;
  return 0;
}

}  // namespace

// Plain C interfaces for ctypes. y: rank r's (T, K, d) bf16 at
// y + r * y_rank elements, contiguous inside; w: rank r's (T, K) fp32 at
// w + r * w_rank (0: one copy for every rank); d a multiple of 8; tile
// tm x tn (tn a multiple of 8, tm * tn <= 4096). epoch: this call's (>= 1);
// timeout_ns bounds every wait; fault: 0, or a planted fault (1: RS step 0
// combines the chunk one rank over, AR reduces read the slot one rank over
// in place of their own; 2: rank 0's first signal never sent; 3: every
// combine takes weight column k + 1 for slot k). Each returns a
// cudaError_t code (0 = launched).
//
// RS: out (n, T / n, d); recv (n, max(n - 1, 1), T / n, d) fp32; flags: the
// workspace's n * max(n - 1, 1) * ceil(T / n / tm) * ceil(d / tn) words then
// its abort word.
extern "C" int tdt_moe_reduce_rs_bf16(const void* y, const void* w, void* out, void* recv,
                                      long long y_rank, long long w_rank, int n, int T, int K,
                                      int d, int tm, int tn, void* flags, void* abort_word,
                                      unsigned long long epoch, unsigned long long timeout_ns,
                                      int fault, int device, void* stream) {
  if (n < 1 || T % n) return (int)cudaErrorInvalidValue;
  Params P;
  int rc = fill(P, y, w, out, recv, y_rank, w_rank, n, T, K, d, T / n, tm, tn, flags, abort_word,
                epoch, timeout_ns, fault);
  if (rc) return rc;
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = ensure_error_record();
  if (e != cudaSuccess) return (int)e;
  P.sync.err = g_err_dev;
  void* args[] = {&P};
  const long long items = (long long)n * n * P.n_rb * P.n_cb;
  return (int)cooperative_launch(reinterpret_cast<const void*>(moe_reduce_rs_kernel), kThreads,
                                 0, items, args, device, static_cast<cudaStream_t>(stream));
}

// AR: out (n, T, d); gather (n, n, T, d) fp32; flags: the workspace's
// n * n * ceil(T / tm) * ceil(d / tn) words then its abort word.
extern "C" int tdt_moe_reduce_ar_bf16(const void* y, const void* w, void* out, void* gather,
                                      long long y_rank, long long w_rank, int n, int T, int K,
                                      int d, int tm, int tn, void* flags, void* abort_word,
                                      unsigned long long epoch, unsigned long long timeout_ns,
                                      int fault, int device, void* stream) {
  Params P;
  int rc = fill(P, y, w, out, gather, y_rank, w_rank, n, T, K, d, T, tm, tn, flags, abort_word,
                epoch, timeout_ns, fault);
  if (rc) return rc;
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = ensure_error_record();
  if (e != cudaSuccess) return (int)e;
  P.sync.err = g_err_dev;
  void* args[] = {&P};
  const long long items = 2LL * n * P.n_rb * P.n_cb;
  return (int)cooperative_launch(reinterpret_cast<const void*>(moe_reduce_ar_kernel), kThreads,
                                 0, items, args, device, static_cast<cudaStream_t>(stream));
}
