// One output tile of a bf16 GEMM with fp32 sums, shared by the fused GEMM
// kernels (ag_gemm.cu, gemm_rs.cu, gemm_ar.cu, ag_moe.cu, ep_fused.cu,
// a2a_gemm.cu, ulysses_fused.cu) on Hopper (sm_90a).
//
//   C (BM x BN, fp32, in shared memory) = A (BM x K) . B (BN x K)^T
//
// A is row-major; B is a weight stored (out, in) as the port keeps it, so a
// row of B is one output column's K vector and the kernel reads it as the
// column-major K x N operand, with no transposed copy. Both may be strided
// views (row pitches lda, ldb): a row-parallel weight shard is a column
// slice of the full weight.
//
// Design: K runs in stages of 64 through a ring of kStages shared-memory
// buffers filled by cp.async.cg (16 bytes a thread, L2 only: the fused
// kernels read rows that other blocks of the launch wrote, and L1 is not
// coherent); rows past the matrix and K past its end are zero-filled by the
// copy. Warps own WM x WN sub-tiles of nvcuda::wmma 16x16x16 bf16 fragments
// accumulating in fp32 registers. No wgmma or TMA yet (PERF.md).

#pragma once

#include <cuda_bf16.h>
#include <mma.h>

#include "shmem_device.cuh"

namespace tdt {

constexpr int kBK = 64;        // K per pipeline stage
constexpr int kLd = kBK + 8;   // padded bf16 row of a stage (144 bytes)

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A tile shape: BM x BN outputs, warps of WM x WN, kStages K stages.
template <int BM_, int BN_, int WM_, int WN_, int STAGES_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_, kStages = STAGES_;
  static constexpr int kWarpsN = BN / WN;
  static constexpr int kThreads = (BM / WM) * kWarpsN * 32;
  static constexpr int FM = WM / 16, FN = WN / 16;
  static constexpr int kStageElems = (BM + BN) * kLd;
  static constexpr int kPipeBytes = kStages * kStageElems * 2;
  static constexpr int kCLd = BN + 4;   // padded fp32 row of C
  static constexpr int kCBytes = BM * kCLd * 4;
  static constexpr int kSmem = kPipeBytes > kCBytes ? kPipeBytes : kCBytes;
  // Blocks an SM should hold (__launch_bounds__): two 256-thread blocks
  // cap registers at 128, which AG+GEMM and GEMM+RS take with a few spills
  // and still run faster than one block at 168 registers (PERF.md §6).
  static constexpr int kMinBlocks = kThreads >= 256 ? 2 : 1;
};

// Prefill rows: 8 warps of 32 x 64, three stages (110,592 bytes of shared
// memory). Decode rows (at most 16 a rank): 4 warps of 16 x 16, four
// stages to keep the weight stream in flight.
typedef Tile<128, 128, 32, 64, 3> BigTile;
typedef Tile<16, 64, 16, 16, 4> SmallTile;

// Whether a launch of `rows` rows a rank runs the decode tile.
inline bool small_rows(int rows) { return rows <= SmallTile::BM; }

// The rows of a weight with one row pitch: row r at base + r * ld.
struct StridedRows {
  const bf16* base;
  long long ld;
  __device__ __forceinline__ const bf16* operator()(int r) const { return base + r * ld; }
};

// C = A (a_rows x K) . B (b_rows x K)^T into shared memory, B's row r at
// b_row(r) (a functor: the MoE gate/up tiles take each row from one of two
// weights); rows past a_rows / b_rows read as zeros. K a multiple of 8,
// rows 16-byte aligned. Returns C (row pitch T::kCLd), readable by every
// thread of the block; the caller must __syncthreads() before the next
// tile_mma overwrites it.
template <class T, class BRows>
__device__ float* tile_mma_rows(const bf16* A, long long lda, int a_rows, BRows b_row,
                                int b_rows, int K, unsigned char* smem) {
  using namespace nvcuda;
  bf16* stages = reinterpret_cast<bf16*>(smem);
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / T::kWarpsN, wn = warp % T::kWarpsN;
  const int n_k = (K + kBK - 1) / kBK;

  // Stage `stage` <- K block kt: rows [0, BM) of A, then rows [0, BN) of B.
  auto load = [&](int stage, int kt) {
    bf16* dst = stages + stage * T::kStageElems;
    const int k0 = kt * kBK;
    for (int i = tid; i < (T::BM + T::BN) * (kBK / 8); i += T::kThreads) {
      const int row = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
      const bool is_a = row < T::BM;
      const int r = is_a ? row : row - T::BM;
      const bool ok = (is_a ? r < a_rows : r < b_rows) && k0 + c < K;
      const bf16* src = A;
      if (ok) src = (is_a ? A + r * lda : b_row(r)) + k0 + c;
      cp_async16(dst + row * kLd + c, src, ok);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T::FM][T::FN];
#pragma unroll
  for (int i = 0; i < T::FM; ++i)
#pragma unroll
    for (int j = 0; j < T::FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

#pragma unroll
  for (int s = 0; s < T::kStages - 1; ++s) {
    if (s < n_k) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<T::kStages - 2>();   // K block kt has landed
    __syncthreads();                   // and block kt - 1's buffer is free
    if (kt + T::kStages - 1 < n_k) load((kt + T::kStages - 1) % T::kStages, kt + T::kStages - 1);
    cp_async_commit();
    const bf16* As = stages + (kt % T::kStages) * T::kStageElems;
    const bf16* Bs = As + T::BM * kLd;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[T::FM];
#pragma unroll
      for (int i = 0; i < T::FM; ++i)
        wmma::load_matrix_sync(af[i], As + (wm * T::WM + i * 16) * kLd + kk, kLd);
#pragma unroll
      for (int j = 0; j < T::FN; ++j) {
        // Bs[n][k] holds B[n][k0 + k]: the K x N operand, column-major.
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
        wmma::load_matrix_sync(bfr, Bs + (wn * T::WN + j * 16) * kLd + kk, kLd);
#pragma unroll
        for (int i = 0; i < T::FM; ++i) wmma::mma_sync(acc[i][j], af[i], bfr, acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                     // the stages are dead: C reuses them
  float* C = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < T::FM; ++i)
#pragma unroll
    for (int j = 0; j < T::FN; ++j)
      wmma::store_matrix_sync(C + (wm * T::WM + i * 16) * T::kCLd + wn * T::WN + j * 16,
                              acc[i][j], T::kCLd, wmma::mem_row_major);
  __syncthreads();
  return C;
}

// C = sum over segments s < n_seg of A_s (a_rows x K) . B_s (b_rows x K)^T:
// one contraction whose K runs through n_seg operand pairs in turn, summed in
// the same fp32 fragments (the Ulysses O projection: one partial product per
// source rank). `seg` gives segment s's A (seg.a(s), row pitch seg.lda(s)),
// row r of its B (seg.b(s, r)), and seg.ready(s), which every thread of the
// block calls once before the first load of segment s (a block-wide arrival
// wait: the pipeline prefetches kStages - 1 K stages ahead, so it waits
// that far ahead of segment s's first product). Rows past a_rows / b_rows
// read as zeros; K a multiple of 8, rows 16-byte aligned. Returns C (row
// pitch T::kCLd), readable by every thread of the block; the caller must
// __syncthreads() before the next tile overwrites it. It repeats
// tile_mma_rows' pipeline rather than serving as its body: as the body it
// moved the other kernels' register allocation (GEMM+AR's 128 x 128 tile
// from 128 to 172 registers, 1.6x slower at 2048 rows on an H100, PERF.md).
template <class T, class Seg>
__device__ float* tile_mma_segments(const Seg& seg, int n_seg, int a_rows, int b_rows, int K,
                                    unsigned char* smem) {
  using namespace nvcuda;
  bf16* stages = reinterpret_cast<bf16*>(smem);
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / T::kWarpsN, wn = warp % T::kWarpsN;
  const int n_k = (K + kBK - 1) / kBK, n_g = n_seg * n_k;

  // Stage `stage` <- global K block g: K block g % n_k of segment g / n_k.
  auto load = [&](int stage, int g) {
    const int s = g / n_k, k0 = (g % n_k) * kBK;
    if (k0 == 0) seg.ready(s);
    const bf16* A = seg.a(s);
    const long long lda = seg.lda(s);
    bf16* dst = stages + stage * T::kStageElems;
    for (int i = tid; i < (T::BM + T::BN) * (kBK / 8); i += T::kThreads) {
      const int row = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
      const bool is_a = row < T::BM;
      const int r = is_a ? row : row - T::BM;
      const bool ok = (is_a ? r < a_rows : r < b_rows) && k0 + c < K;
      const bf16* src = A;
      if (ok) src = (is_a ? A + r * lda : seg.b(s, r)) + k0 + c;
      cp_async16(dst + row * kLd + c, src, ok);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T::FM][T::FN];
#pragma unroll
  for (int i = 0; i < T::FM; ++i)
#pragma unroll
    for (int j = 0; j < T::FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

#pragma unroll
  for (int s = 0; s < T::kStages - 1; ++s) {
    if (s < n_g) load(s, s);
    cp_async_commit();
  }
  for (int g = 0; g < n_g; ++g) {
    cp_async_wait<T::kStages - 2>();   // K block g has landed
    __syncthreads();                   // and block g - 1's buffer is free
    if (g + T::kStages - 1 < n_g) load((g + T::kStages - 1) % T::kStages, g + T::kStages - 1);
    cp_async_commit();
    const bf16* As = stages + (g % T::kStages) * T::kStageElems;
    const bf16* Bs = As + T::BM * kLd;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[T::FM];
#pragma unroll
      for (int i = 0; i < T::FM; ++i)
        wmma::load_matrix_sync(af[i], As + (wm * T::WM + i * 16) * kLd + kk, kLd);
#pragma unroll
      for (int j = 0; j < T::FN; ++j) {
        // Bs[n][k] holds B[n][k0 + k]: the K x N operand, column-major.
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
        wmma::load_matrix_sync(bfr, Bs + (wn * T::WN + j * 16) * kLd + kk, kLd);
#pragma unroll
        for (int i = 0; i < T::FM; ++i) wmma::mma_sync(acc[i][j], af[i], bfr, acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                     // the stages are dead: C reuses them
  float* C = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < T::FM; ++i)
#pragma unroll
    for (int j = 0; j < T::FN; ++j)
      wmma::store_matrix_sync(C + (wm * T::WM + i * 16) * T::kCLd + wn * T::WN + j * 16,
                              acc[i][j], T::kCLd, wmma::mem_row_major);
  __syncthreads();
  return C;
}

// tile_mma_rows with B (b_rows x K) of row pitch ldb.
template <class T>
__device__ float* tile_mma(const bf16* A, long long lda, int a_rows, const bf16* B,
                           long long ldb, int b_rows, int K, unsigned char* smem) {
  return tile_mma_rows<T>(A, lda, a_rows, StridedRows{B, ldb}, b_rows, K, smem);
}

// out[r][c] = bf16(C[r][c]) for r < rows, c < cols (row pitch ld).
template <class T>
__device__ inline void store_tile_bf16(bf16* out, long long ld, const float* C, int rows,
                                       int cols) {
  for (int i = threadIdx.x; i < T::BM * T::BN; i += T::kThreads) {
    const int r = i / T::BN, c = i % T::BN;
    if (r < rows && c < cols) out[r * ld + c] = __float2bfloat16(C[r * T::kCLd + c]);
  }
}

}  // namespace tdt

// The output tile (rows, columns) a launch of `rows` rows a rank runs:
// out = [BM, BN]. The host sizes flags and work items by it.
extern "C" void tdt_tp_tile(int rows, int* out) {
  out[0] = tdt::small_rows(rows) ? tdt::SmallTile::BM : tdt::BigTile::BM;
  out[1] = tdt::small_rows(rows) ? tdt::SmallTile::BN : tdt::BigTile::BN;
}
