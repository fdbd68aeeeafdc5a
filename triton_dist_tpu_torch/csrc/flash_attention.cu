// Prefill flash attention for Hopper (sm_90a): bf16 in and out, fp32 sums.
//
// flash_attention_kernel replaces the Pallas flash attention JAX bundles
// (jax.experimental.pallas.ops.tpu.flash_attention), which
// triton_dist_tpu/layers/tp_attn.py sdpa takes for a causal prefill
// (:177-188). It is not one of the package's own kernels, but it is on the
// dense-cache prefill path (Engine.prefill, monolithic serving admission).
//
// Layout (sdpa's): q and out (B, S, H, hd), k and v (B, S, KV, hd), all
// contiguous. Query head h reads KV head h / (H / KV) in place: no K/V
// repeat in device memory. Query i attends keys j <= i (causal) or every
// key (causal = 0).
//
// What bounds it on the H100: operations once S is long. A causal pass does
// 4 * hd * S * (S + 1) / 2 flops per (batch, head) against 2 * S * hd bytes
// of K and V per KV head, so at S = 1000, hd = 128 it sits near 1000 flops
// per byte, above the ~295 where the bf16 tensor cores become the limit.
//
// What this first design does about it: one block of four warps per
// (64-query tile, query head, batch). The block stages its Q tile once and
// walks 64-key tiles up to the diagonal; S = Q K^T and O += P V run on the
// tensor cores (nvcuda::wmma bf16 16x16x16, fp32 sums). Each warp owns 16
// query rows; a lane pair owns one row's online softmax (running max m and
// sum l in fp32 registers) and rescales that row of the fp32 output
// accumulator, which lives in shared memory. The output is divided by l and
// rounded to bf16 once. head_dim up to 256 is zero-padded to a multiple of
// 16 in shared memory; rows past S (the ragged last tile) load as zeros,
// their keys are masked and their outputs are never stored. No cp.async,
// TMA or wgmma yet, and K/V tiles are not double-buffered (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kBM = 64;               // query rows per block, 16 per warp
constexpr int kBN = 64;               // keys per step
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxHeadDim = 256;
constexpr int kSLd = kBN + 4;         // fp32 scores, padded rows
constexpr int kPLd = kBN + 8;         // bf16 probabilities, padded rows
constexpr unsigned kFull = 0xffffffffu;

// Leading dimensions for a head_dim padded to hdp (a multiple of 16): every
// 16-row fragment starts on a 32-byte boundary, as wmma requires.
__host__ __device__ inline int ld_bf16(int hdp) { return hdp + 8; }
__host__ __device__ inline int ld_f32(int hdp) { return hdp + 4; }

// Shared memory: O (kBM x hdp fp32) | S (kBM x kBN fp32) | Q (kBM x hdp) |
// K (kBN x hdp) | V (kBN x hdp) | P (kBM x kBN), bf16 past the fp32 part.
size_t smem_bytes(int hdp) {
  return (size_t)kBM * ld_f32(hdp) * sizeof(float) +
         (size_t)kBM * kSLd * sizeof(float) +
         (size_t)(kBM + 2 * kBN) * ld_bf16(hdp) * sizeof(bf16) +
         (size_t)kBM * kPLd * sizeof(bf16);
}

// Rows [row0, row0 + rows) of one head of a (B, S, nh, hd) tensor into
// dst[rows][ld], zero past S and past hd.
__device__ void load_rows(bf16* dst, int ld, const bf16* __restrict__ src, int b,
                          int row0, int rows, int S, int nh, int head, int hd,
                          int hdp) {
  if (hd % 8 == 0) {
    const int per = hdp / 8;
    for (int e = threadIdx.x; e < rows * per; e += kThreads) {
      const int r = e / per, c8 = e % per, s = row0 + r;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (s < S && c8 * 8 < hd)
        v = *reinterpret_cast<const uint4*>(
            src + (((long long)b * S + s) * nh + head) * hd + c8 * 8);
      *reinterpret_cast<uint4*>(dst + r * ld + c8 * 8) = v;
    }
  } else {
    for (int e = threadIdx.x; e < rows * hdp; e += kThreads) {
      const int r = e / hdp, c = e % hdp, s = row0 + r;
      bf16 v = __float2bfloat16(0.f);
      if (s < S && c < hd) v = src[(((long long)b * S + s) * nh + head) * hd + c];
      dst[r * ld + c] = v;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ out,
                           int S, int H, int KV, int hd, int hdp, float scale,
                           int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lo = ld_f32(hdp), lb = ld_bf16(hdp);
  float* Os = reinterpret_cast<float*>(smem);
  float* Ss = Os + kBM * lo;
  bf16* Qs = reinterpret_cast<bf16*>(Ss + kBM * kSLd);
  bf16* Ks = Qs + kBM * lb;
  bf16* Vs = Ks + kBN * lb;
  bf16* Ps = Vs + kBN * lb;

  const int q0 = blockIdx.x * kBM, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  load_rows(Qs, lb, q, b, q0, kBM, S, H, h, hd, hdp);
  for (int e = threadIdx.x; e < kBM * lo; e += kThreads) Os[e] = 0.f;

  // Lanes 2r and 2r + 1 of warp w own query row 16 w + r, 32 keys each.
  const int row = warp * 16 + lane / 2, half = lane % 2, qpos = q0 + row;
  float m = -INFINITY, l = 0.f;
  const int last_key = causal ? min(q0 + kBM, S) - 1 : S - 1;
  const int n_tiles = last_key / kBN + 1;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBN;
    __syncthreads();  // the last tile's K, V and P are consumed
    load_rows(Ks, lb, k, b, k0, kBN, S, KV, kvh, hd, hdp);
    load_rows(Vs, lb, v, b, k0, kBN, S, KV, kvh, hd, hdp);
    __syncthreads();

    // This warp's 16 x kBN scores S = Q K^T (K row-major is K^T column-major).
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kBN / 16];
#pragma unroll
      for (int j = 0; j < kBN / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
      for (int kk = 0; kk < hdp; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
        wmma::load_matrix_sync(af, Qs + warp * 16 * lb + kk, lb);
#pragma unroll
        for (int j = 0; j < kBN / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
          wmma::load_matrix_sync(bfr, Ks + j * 16 * lb + kk, lb);
          wmma::mma_sync(acc[j], af, bfr, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kBN / 16; ++j)
        wmma::store_matrix_sync(Ss + warp * 16 * kSLd + j * 16, acc[j], kSLd,
                                wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax of this lane's 32 keys of its row.
    const float* srow = Ss + row * kSLd + half * 32;
    float sv[32];
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int key = k0 + half * 32 + c;
      const bool ok = key < S && (!causal || key <= qpos);
      sv[c] = ok ? srow[c] * scale : -INFINITY;
      mx = fmaxf(mx, sv[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = (m == -INFINITY) ? 0.f : expf(m - m_new);
    float sum = 0.f;
    bf16* prow = Ps + row * kPLd + half * 32;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float p = (sv[c] == -INFINITY) ? 0.f : expf(sv[c] - m_new);
      sum += p;
      prow[c] = __float2bfloat16(p);
    }
    sum += __shfl_xor_sync(kFull, sum, 1);
    l = l * alpha + sum;
    m = m_new;
    float* orow = Os + row * lo;
    for (int c = half; c < hdp; c += 2) orow[c] *= alpha;
    __syncwarp();

    // O += P V for this warp's 16 rows.
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf[kBN / 16];
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      wmma::load_matrix_sync(pf[kk], Ps + warp * 16 * kPLd + kk * 16, kPLd);
    for (int j = 0; j < hdp / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
      float* op = Os + warp * 16 * lo + j * 16;
      wmma::load_matrix_sync(o, op, lo, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(vf, Vs + kk * 16 * lb + j * 16, lb);
        wmma::mma_sync(o, pf[kk], vf, o);
      }
      wmma::store_matrix_sync(op, o, lo, wmma::mem_row_major);
    }
    __syncwarp();
  }

  // Each lane pair stores its row, divided by l, rounded to bf16 once.
  if (qpos < S) {
    const float inv = 1.f / l;
    const float* orow = Os + row * lo;
    bf16* dst = out + (((long long)b * S + qpos) * H + h) * hd;
    for (int c = half; c < hd; c += 2) dst[c] = __float2bfloat16(orow[c] * inv);
  }
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers on `device`;
// `stream` is a cudaStream_t. Returns a cudaError_t code (0 = launched).
extern "C" int tdt_flash_attention_bf16(const void* q, const void* k, const void* v,
                                        void* out, int B, int S, int H, int KV,
                                        int hd, float scale, int causal, int device,
                                        void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || hd <= 0 || hd > kMaxHeadDim)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int hdp = (hd + 15) / 16 * 16;
  const size_t smem = smem_bytes(hdp);
  err = cudaFuncSetAttribute(flash_attention_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_attention_kernel<<<dim3((S + kBM - 1) / kBM, H, B), kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), S, H, KV, hd, hdp, scale,
      causal);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of one block at head_dim `hd`.
extern "C" int tdt_flash_attention_smem_bytes(int hd) {
  return (int)smem_bytes((hd + 15) / 16 * 16);
}

extern "C" const char* tdt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
