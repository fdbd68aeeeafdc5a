// Grouped expert GEMM over an expert-major, row-tile-aligned layout for
// Hopper (sm_90a): bf16 in and out, fp32 sums.
//
// group_gemm_kernel replaces triton_dist_tpu/ops/group_gemm.py
// _gg_tiles_kernel (:51, grouped_gemm_tiles) and, at one rank, the per-tile
// product of ops/ag_moe.py ag_group_gemm (:285). Rows come sorted by expert
// with every expert's segment padded to the row tile tm
// (ag_moe.prepare_grouped_tokens), so row tile i belongs to one expert,
// tile_expert[i]:
//
//   out[r, c] = sum_k x[r, k] * W[tile_expert[r / tm]][c, k]
//
// The weights are stored (out, in) as the port keeps them, (E, f, d), so a
// weight row is one output column's K vector: the kernel reads B column-
// major from it, with no transposed copy. A second weight (E, f1, d) may
// follow the first: columns [f0, f0 + f1) come from it. The MoE gate and up
// projections run as one launch that way, with no concatenated copy of the
// two weights. Each weight is addressed by its own expert stride and row
// stride (unit stride along d), so a tensor-parallel rank's ffn shard of
// w_gate / w_up (rows [r * F, (r + 1) * F) of every expert) or of w_down
// (columns [r * F, (r + 1) * F): a row pitch of f, not F) runs as the view
// it is, with no copy. A third grid dimension runs n simulated ranks in one
// launch: rank z reads x[z], writes out[z] and takes its weight shard at a
// rank stride, with one tile map for every rank (the tensor-parallel down
// projection) or a map of its own (te_rank apart: the expert-parallel
// experts, where each rank received other rows). The weight may be every
// rank's expert slice of the one weight, e_loc experts a rank, at a rank
// stride of e_loc * f * d.
//
// Used tiles: with a `used` count, the map's tiles are cut into equal chunks
// of chunk_tiles tiles, and tile t of rank z is computed only while
// t % chunk_tiles < used[z * used_rank + t / chunk_tiles]; the tiles past it
// hold only the zero rows of a padded tail and store zeros, as ag_moe_kernel
// does. The tensor-parallel down projection passes row 19's per-chunk counts
// (one for every rank); the expert-parallel experts pass each rank's count of
// the tiles its received rows fill (one chunk a rank), so the grid skips the
// tail of the drop-free receive envelope (n * T * K rows a rank, a quarter
// of them real at tp = 4).
//
// What bounds it on the H100: bytes at small row counts, operations at
// prefill. Per tile it reads one expert's (f, d) weight slice; over a
// prefill every expert that owns a tile is read, and the rows are 2 * d
// flops per output element each. At Qwen3-30B-A3B's prefill of 2048 tokens
// (32,640 sorted rows, gate/up 2 x 768 columns from d = 2048) that is
// 205 GFLOP against ~1 GB, about 0.2 ms of tensor-core time.
//
// What this first design does about it: one block of four warps per
// (row block, 64-column tile). A row block is min(tm, 64) rows of one tile,
// padded to 16 in shared memory (tm = 8 for a short prompt's routing); the
// padding rows are zeros and are never stored. Each block reads its own
// tile_expert entry and loops over K in steps of 64: A (rows x 64) and B
// (64 columns x 64) are staged in shared memory with 16-byte loads, then
// nvcuda::wmma bf16 16x16x16 fragments accumulate in fp32 registers. The
// epilogue rounds each output to bf16 once. No cp.async/TMA pipelining or
// wgmma yet (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kBN = 64;               // output columns per block
constexpr int kBK = 64;               // K per stage
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kALd = kBK + 8;         // padded bf16 rows of the A stage
constexpr int kBLd = kBK + 8;         // padded bf16 rows of the B stage
constexpr int kCLd = kBN + 4;         // padded fp32 rows of the epilogue

// RB: rows per block in shared memory (16, 32 or 64); rv <= RB of them are
// real rows of the tile. Warps split the (RB / 16) x 4 output fragments.
// A weight's addressing: rank z, expert e, row c at p + z * rank + e * ex + c * row.
// Weights and x are read through the read-only path (__ldg): the kernel
// never writes them.
struct W {
  const bf16* p;
  long long rank, ex;
  int row;
};

// Five blocks an SM (registers capped at 96, no spills): the strided
// addressing alone took 128 registers at 64 rows, four blocks an SM, and
// ran 10 % slower than a contiguous-only kernel; at five it runs 6-8 %
// faster than that kernel (PERF.md §6, row 17).
template <int RB>
__global__ void __launch_bounds__(kThreads, 5)
    group_gemm_kernel(const bf16* __restrict__ x, W w0, W w1,
                      const int* __restrict__ tile_expert, long long te_rank,
                      const int* __restrict__ used, int used_rank, int chunk_tiles,
                      bf16* __restrict__ out, int S, int d, int E, int f0, int f1, int tm, int rv,
                      int vec) {
  constexpr int FR = RB / 16;          // row fragments
  constexpr int WPR = kWarps / FR;     // warps per row fragment
  constexpr int CF = (kBN / 16) / WPR; // column fragments per warp
  __shared__ __align__(128) bf16 As[RB * kALd];
  __shared__ __align__(128) bf16 Bs[kBN * kBLd];
  __shared__ __align__(128) float Cs[RB * kCLd];

  const int N = f0 + f1;
  const long long r0 = (long long)blockIdx.x * rv;
  const int c0 = blockIdx.y * kBN;
  const int z = blockIdx.z;
  const int tile = (int)(r0 / tm);
  const int e = tile_expert[z * te_rank + tile];
  x += (long long)z * S * d;
  out += (long long)z * S * N;
  const int tid = threadIdx.x, warp = tid / 32;
  const int rf = warp / WPR, cf0 = (warp % WPR) * CF;

  if (used != nullptr &&
      tile % chunk_tiles >= used[(long long)z * used_rank + tile / chunk_tiles]) {
    for (int i = tid; i < rv * kBN; i += kThreads) {   // a padded tail tile
      const int r = i / kBN, c = c0 + i % kBN;
      if (c < N) out[(r0 + r) * N + c] = __float2bfloat16(0.f);
    }
    return;
  }

  if (e < 0 || e >= E) {               // a corrupt map: make it visible
    for (int i = tid; i < rv * kBN; i += kThreads) {
      const int r = i / kBN, c = c0 + i % kBN;
      if (c < N) out[(r0 + r) * N + c] = __float2bfloat16(__int_as_float(0x7fc00000));
    }
    return;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[CF];
#pragma unroll
  for (int j = 0; j < CF; ++j) wmma::fill_fragment(acc[j], 0.f);

  // Expert e's rows of rank z's shards.
  const bf16* b0 = w0.p + z * w0.rank + e * w0.ex;
  const bf16* b1 = w1.p + z * w1.rank + e * w1.ex;
  for (int k0 = 0; k0 < d; k0 += kBK) {
    __syncthreads();                   // the last stage is consumed
    if (vec) {
      for (int i = tid; i < RB * (kBK / 8); i += kThreads) {
        const int r = i / (kBK / 8), c8 = i % (kBK / 8), k = k0 + c8 * 8;
        uint4 a = make_uint4(0, 0, 0, 0);
        if (r < rv && k < d)
          a = __ldg(reinterpret_cast<const uint4*>(x + (r0 + r) * d + k));
        *reinterpret_cast<uint4*>(As + r * kALd + c8 * 8) = a;
      }
      for (int i = tid; i < kBN * (kBK / 8); i += kThreads) {
        const int n = i / (kBK / 8), c8 = i % (kBK / 8), k = k0 + c8 * 8;
        const int c = c0 + n;
        uint4 b = make_uint4(0, 0, 0, 0);
        if (k < d && c < N) {
          const bf16* wr = c < f0 ? b0 + c * w0.row : b1 + (c - f0) * w1.row;
          b = __ldg(reinterpret_cast<const uint4*>(wr + k));
        }
        *reinterpret_cast<uint4*>(Bs + n * kBLd + c8 * 8) = b;
      }
    } else {
      for (int i = tid; i < RB * kBK; i += kThreads) {
        const int r = i / kBK, k = k0 + i % kBK;
        As[r * kALd + i % kBK] =
            (r < rv && k < d) ? __ldg(x + (r0 + r) * d + k) : __float2bfloat16(0.f);
      }
      for (int i = tid; i < kBN * kBK; i += kThreads) {
        const int n = i / kBK, k = k0 + i % kBK, c = c0 + n;
        bf16 b = __float2bfloat16(0.f);
        if (k < d && c < N)
          b = __ldg(c < f0 ? b0 + c * w0.row + k : b1 + (c - f0) * w1.row + k);
        Bs[n * kBLd + i % kBK] = b;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::load_matrix_sync(af, As + rf * 16 * kALd + kk, kALd);
#pragma unroll
      for (int j = 0; j < CF; ++j) {
        // Bs[n][k] holds W[c0 + n][k0 + k]: the K x N operand, column-major.
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
        wmma::load_matrix_sync(bfr, Bs + (cf0 + j) * 16 * kBLd + kk, kBLd);
        wmma::mma_sync(acc[j], af, bfr, acc[j]);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < CF; ++j)
    wmma::store_matrix_sync(Cs + rf * 16 * kCLd + (cf0 + j) * 16, acc[j], kCLd,
                            wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < rv * kBN; i += kThreads) {
    const int r = i / kBN, cc = i % kBN, c = c0 + cc;
    if (c < N) out[(r0 + r) * N + c] = __float2bfloat16(Cs[r * kCLd + cc]);
  }
}

struct Map {
  const int* te;
  long long te_rank;
  const int* used;
  int used_rank, chunk_tiles;
};

template <int RB>
cudaError_t launch(const void* x, W w0, W w1, Map m, void* out, int n, int S, int d, int E, int f0,
                   int f1, int tm, int rv, int vec, cudaStream_t stream) {
  const dim3 grid(S / rv, (f0 + f1 + kBN - 1) / kBN, n);
  group_gemm_kernel<RB><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(x), w0, w1, m.te, m.te_rank, m.used, m.used_rank, m.chunk_tiles,
      static_cast<bf16*>(out), S, d, E, f0, f1, tm, rv, vec);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes. x (n, S, d) contiguous; weight 0 of rank z,
// expert e, row c (f0 rows of d) at w0 + z * w0_rank + e * w0_e + c * w0_row
// elements, unit stride along d; weight 1 likewise (f1 rows), or null with
// f1 = 0; tile_expert: rank z's map of S / tm int32 at tile_expert + z *
// te_rank (te_rank 0: one map for every rank); used: null, or rank z's
// counts at used + z * used_rank (used_rank 0: one set for every rank), one
// per chunk of chunk_tiles tiles (chunk_tiles divides S / tm); out
// (n, S, f0 + f1); device pointers on `device`, `stream` a cudaStream_t.
// tm must be at most 64 or a multiple of 64. Rows load 16 bytes at a time
// when d and every stride are multiples of 8 and both weights 16-byte
// aligned, else one element at a time. Returns a cudaError_t code
// (0 = launched).
extern "C" int tdt_group_gemm_bf16(const void* x, const void* w0, const void* w1,
                                   const void* tile_expert, long long te_rank, const void* used,
                                   int used_rank, int chunk_tiles, void* out, int n, int S,
                                   int d, int E, int f0, int f1, int tm, long long w0_rank,
                                   long long w0_e, long long w0_row, long long w1_rank,
                                   long long w1_e, long long w1_row, int device,
                                   void* stream) {
  if (n <= 0 || S <= 0 || d <= 0 || E <= 0 || f0 <= 0 || f1 < 0 || tm <= 0 || S % tm != 0 ||
      (tm > 64 && tm % 64 != 0) || (f1 > 0 && w1 == nullptr) || n > 65535 || te_rank < 0 ||
      used_rank < 0 || chunk_tiles <= 0 || (S / tm) % chunk_tiles != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int rv = tm < 64 ? tm : 64;
  const int* te = static_cast<const int*>(tile_expert);
  if (w0_row > (1 << 30) || w1_row > (1 << 30)) return (int)cudaErrorInvalidValue;
  const W a{static_cast<const bf16*>(w0), w0_rank, w0_e, (int)w0_row};
  const W b = f1 > 0 ? W{static_cast<const bf16*>(w1), w1_rank, w1_e, (int)w1_row} : a;
  const int vec = d % 8 == 0 && (w0_rank | w0_e | w0_row) % 8 == 0 &&
                  (b.rank | b.ex | b.row) % 8 == 0 &&
                  reinterpret_cast<uintptr_t>(a.p) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(b.p) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const Map m{te, te_rank, static_cast<const int*>(used), used_rank, chunk_tiles};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rv <= 16) return (int)launch<16>(x, a, b, m, out, n, S, d, E, f0, f1, tm, rv, vec, s);
  if (rv <= 32) return (int)launch<32>(x, a, b, m, out, n, S, d, E, f0, f1, tm, rv, vec, s);
  return (int)launch<64>(x, a, b, m, out, n, S, d, E, f0, f1, tm, rv, vec, s);
}

extern "C" const char* tdt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
