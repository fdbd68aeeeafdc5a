// Paged GQA attention for Hopper (sm_90a): bf16, int8 or fp8 (e4m3) pools,
// fp32 accumulation, bf16 queries and outputs.
//
// Two kernels share one body (attend_rows):
//
//   paged_decode_kernel  replaces triton_dist_tpu/ops/paged_flash_decode.py
//                        _decode_kernel (local form, axis=None): one query
//                        per slot, keys at positions < kv_len[b].
//   paged_qblock_kernel  replaces triton_dist_tpu/ops/paged_flash_qblock.py
//                        _qblock_kernel (chunk form): Cq queries per slot,
//                        query i attends keys at positions <= positions[b,i].
//
// The pool is head-major, (num_pages, KV, page, hd): each page's (page, hd)
// block of one KV head is contiguous. Query head h reads KV head
// h / (H / KV) (the JAX package's jnp.repeat(..., rep) mapping).
//
// Quantized pools (the int8 and fp8 instantiations) replace the same Pallas
// kernels' fused-dequant form (paged_flash_decode.py _decode_kernel with
// quantized=True, scale operands at :362-368; paged_flash_qblock.py
// _qblock_kernel, :249). Each page carries one fp32 scale per KV head in
// the layer's (num_pages, KV) table; the staging loop reads the scale of
// every key row's page through the block table (no host-side gather of
// the scales, which the TPU kernel needed to stage them in VMEM) and the
// math dequantizes each element to fp32 as it loads it from shared memory,
// as page_attend (paged_flash_decode.py:54-59) does. The pool bytes halve
// against bf16, and so does the floor.
//
// What bounds them on the H100: bytes. Decode does 4 flops per K/V element
// it reads (one multiply-add for q.k, one for p.v), far below the ~295
// flops per byte where bf16 tensor cores become the limit, so a layer's
// floor is the kv_len * KV * hd * 2 (K and V) * 2 (bytes) it must read over
// 3.35 TB/s. The Q-block kernel reuses each K/V row for every query of a
// tile, which raises the flops per byte by the tile's query count.
//
// What this first design does about it: each block stages 32 keys at a
// time (gathered through the block table, 16-byte loads, one key row per
// lane later) in shared memory and keeps m, l and acc in fp32 registers,
// so K and V are read from device memory once per block and never written.
// It does not yet overlap the loads with the math, use tensor cores, or
// split a long sequence over several blocks: the decode grid is S x KV
// blocks (32 at 4 slots on 132 SMs). Split-KV with the log-sum-exp combine
// of paged_flash_decode.py:101-115, cp.async/TMA double buffering and wgmma
// are the next steps (PERF.md).

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;             // keys staged per step: one per lane
constexpr int kMaxRowsPerWarp = 8;    // (query, head) rows a warp carries
constexpr int kMaxRows = kWarps * kMaxRowsPerWarp;
constexpr int kHeadDim = 128;         // the only head_dim compiled (Qwen3)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// What a pool element is stored as: the shared-memory key row's padding
// (in elements) makes each row's byte stride 4 x an odd number, so lane t
// reading key row t hits its own bank; kQuant pools carry scales.
template <typename T>
struct Storage;
template <>
struct Storage<__nv_bfloat16> {
  static constexpr int kPad = 2;
  static constexpr bool kQuant = false;
};
template <>
struct Storage<int8_t> {
  static constexpr int kPad = 4;
  static constexpr bool kQuant = true;
};
template <>
struct Storage<__nv_fp8_e4m3> {
  static constexpr int kPad = 4;
  static constexpr bool kQuant = true;
};

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) { return static_cast<float>(x); }

// Two consecutive elements (2-element aligned) as fp32.
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2((float)c.x, (float)c.y);
}
__device__ __forceinline__ float2 load2(const __nv_fp8_e4m3* p) {
  return static_cast<float2>(*reinterpret_cast<const __nv_fp8x2_e4m3*>(p));
}

// Shared memory: qs (rows x HD fp32) | ks (kTile x (HD + kPad) T) | vs
// (kTile x HD T) | lims (kMaxRows int) | ksc, vsc (kTile fp32 each: the
// scale of each staged key row's page; quantized pools only).
template <typename T, int HD>
size_t smem_bytes(int rows) {
  return (size_t)rows * HD * sizeof(float) +
         (size_t)kTile * (HD + Storage<T>::kPad) * sizeof(T) +
         (size_t)kTile * HD * sizeof(T) + kMaxRows * sizeof(int) +
         2 * kTile * sizeof(float);
}

template <typename T, int HD>
struct Smem {
  float* qs;
  T* ks;
  T* vs;
  int* lims;
  float* ksc;
  float* vsc;
  __device__ Smem(unsigned char* base, int rows) {
    qs = reinterpret_cast<float*>(base);
    ks = reinterpret_cast<T*>(base + (size_t)rows * HD * sizeof(float));
    vs = ks + kTile * (HD + Storage<T>::kPad);
    lims = reinterpret_cast<int*>(vs + kTile * HD);
    ksc = reinterpret_cast<float*>(lims + kMaxRows);
    vsc = ksc + kTile;
  }
};

// Online-softmax attention of `rows` query rows (fp32 in sm.qs, row R
// attends key positions <= sm.lims[R]; -1 = inactive row) over key
// positions [0, n_keys) of one slot and one KV head `g`, read through the
// slot's block-table row. On return each active row of sm.qs holds its
// normalised output (acc / max(l, 1e-30)). Every thread of the block calls
// this; warp w owns rows [w * rpw, w * rpw + rpw). A quantized pool's
// elements are dequantized with their page's (layer, page, g) scale from
// kscale / vscale (num_pages x kvh fp32) as they are read.
template <typename T, int HD>
__device__ void attend_rows(const Smem<T, HD>& sm, int rows, int n_keys,
                            const T* __restrict__ kpool, const T* __restrict__ vpool,
                            const float* __restrict__ kscale,
                            const float* __restrict__ vscale,
                            const int* __restrict__ table_row, int kvh, int g,
                            int page) {
  constexpr bool kQuant = Storage<T>::kQuant;
  constexpr int KLD = HD + Storage<T>::kPad;   // shared key row stride
  constexpr int DPL = HD / 32;        // output dims per lane
  constexpr int EPV = 16 / sizeof(T); // elements per 16-byte vector
  constexpr int VPR = HD / EPV;       // 16-byte vectors per key row
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rpw = (rows + kWarps - 1) / kWarps;
  const int row0 = warp * rpw;
  const int nrows = max(0, min(rpw, rows - row0));
  const float scale = 1.0f / sqrtf((float)HD);

  float m[kMaxRowsPerWarp], l[kMaxRowsPerWarp], p[kMaxRowsPerWarp];
  float acc[kMaxRowsPerWarp][DPL];
  int lim[kMaxRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kMaxRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
    p[r] = 0.f;
    lim[r] = r < nrows ? sm.lims[row0 + r] : -1;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[r][j] = 0.f;
  }

  for (int kbase = 0; kbase < n_keys; kbase += kTile) {
    __syncthreads();  // the previous tile is consumed by every warp
    for (int v = threadIdx.x; v < kTile * VPR; v += kThreads) {
      const int j = v / VPR, c = v % VPR;
      const int pos = kbase + j;
      uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      float ksc = 0.f, vsc = 0.f;
      if (pos < n_keys) {
        const int pid = table_row[pos / page];
        const size_t off =
            (((size_t)pid * kvh + g) * page + (pos % page)) * HD + c * EPV;
        kv4 = *reinterpret_cast<const uint4*>(kpool + off);
        vv4 = *reinterpret_cast<const uint4*>(vpool + off);
        if constexpr (kQuant) {
          if (c == 0) {
            ksc = kscale[(size_t)pid * kvh + g];
            vsc = vscale[(size_t)pid * kvh + g];
          }
        }
      }
      if constexpr (kQuant) {
        if (c == 0) {
          sm.ksc[j] = ksc;
          sm.vsc[j] = vsc;
        }
      }
      uint32_t* kd = reinterpret_cast<uint32_t*>(sm.ks + j * KLD + c * EPV);
      kd[0] = kv4.x;
      kd[1] = kv4.y;
      kd[2] = kv4.z;
      kd[3] = kv4.w;
      *reinterpret_cast<uint4*>(sm.vs + j * HD + c * EPV) = vv4;
    }
    __syncthreads();
    if (nrows == 0) continue;

    // Scores: lane t takes key kbase + t against each of the warp's rows.
    float s[kMaxRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kMaxRowsPerWarp; ++r) s[r] = 0.f;
    const T* krow = sm.ks + lane * KLD;
    const float kq = kQuant ? sm.ksc[lane] : 1.f;
#pragma unroll 4
    for (int d2 = 0; d2 < HD / 2; ++d2) {
      float2 kf = load2(krow + 2 * d2);
      if constexpr (kQuant) {
        kf.x *= kq;
        kf.y *= kq;
      }
#pragma unroll
      for (int r = 0; r < kMaxRowsPerWarp; ++r) {
        if (r < nrows) {
          const float2 qv =
              *reinterpret_cast<const float2*>(sm.qs + (row0 + r) * HD + 2 * d2);
          s[r] = fmaf(qv.x, kf.x, fmaf(qv.y, kf.y, s[r]));
        }
      }
    }

    const int key = kbase + lane;
#pragma unroll
    for (int r = 0; r < kMaxRowsPerWarp; ++r) {
      if (r < nrows) {
        const float sc = (key < n_keys && key <= lim[r]) ? s[r] * scale : -INFINITY;
        const float m_new = fmaxf(m[r], warp_max(sc));
        const float m_safe = m_new == -INFINITY ? 0.f : m_new;
        p[r] = sc == -INFINITY ? 0.f : expf(sc - m_safe);
        const float corr = m[r] == -INFINITY ? 0.f : expf(m[r] - m_safe);
        l[r] = l[r] * corr + warp_sum(p[r]);
        m[r] = m_new;
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[r][j] *= corr;
      }
    }

    // P.V: lane owns output dims [lane * DPL, lane * DPL + DPL).
    const int t_end = min(kTile, n_keys - kbase);
    for (int t = 0; t < t_end; ++t) {
      float vf[DPL];
      const T* vrow = sm.vs + t * HD + lane * DPL;
      const float vq = kQuant ? sm.vsc[t] : 1.f;
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        vf[j] = to_f32(vrow[j]);
        if constexpr (kQuant) vf[j] *= vq;
      }
#pragma unroll
      for (int r = 0; r < kMaxRowsPerWarp; ++r) {
        if (r < nrows) {
          const float pt = __shfl_sync(kFull, p[r], t);
#pragma unroll
          for (int j = 0; j < DPL; ++j) acc[r][j] = fmaf(pt, vf[j], acc[r][j]);
        }
      }
    }
  }

  // Each warp overwrites only its own rows of qs, which no other warp reads.
#pragma unroll
  for (int r = 0; r < kMaxRowsPerWarp; ++r) {
    if (r < nrows) {
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int j = 0; j < DPL; ++j)
        sm.qs[(row0 + r) * HD + lane * DPL + j] = acc[r][j] * inv;
    }
  }
}

// Grid (KV, S): block (g, b) carries the rep = H / KV query heads of KV
// head g for slot b. Slot b attends positions < max(kv_len[b], 1), capped
// at the table row's capacity (a parked slot's clamped length of 1 reads
// its all-zero row's scratch page, finite garbage the caller drops).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q, const T* __restrict__ kpool,
                    const T* __restrict__ vpool, const float* __restrict__ kscale,
                    const float* __restrict__ vscale, const int* __restrict__ table,
                    const int* __restrict__ kv_len,
                    __nv_bfloat16* __restrict__ out, int H, int kvh, int page,
                    int p_max) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = blockIdx.x, b = blockIdx.y;
  const int rep = H / kvh;
  const Smem<T, HD> sm(smem, rep);
  const int n_keys = min(max(kv_len[b], 1), p_max * page);
  const size_t qbase = ((size_t)b * H + (size_t)g * rep) * HD;
  for (int e = threadIdx.x; e < rep * HD; e += kThreads)
    sm.qs[e] = __bfloat162float(q[qbase + e]);
  for (int r = threadIdx.x; r < rep; r += kThreads) sm.lims[r] = n_keys - 1;
  __syncthreads();
  attend_rows<T, HD>(sm, rep, n_keys, kpool, vpool, kscale, vscale,
                     table + (size_t)b * p_max, kvh, g, page);
  __syncthreads();
  for (int e = threadIdx.x; e < rep * HD; e += kThreads)
    out[qbase + e] = __float2bfloat16(sm.qs[e]);
}

// Grid (ceil(C / qt), KV, B): block (tile, g, b) carries queries
// [tile * qt, tile * qt + qt) of slot b times the rep heads of KV head g.
// Query i attends positions <= clamp(positions[b, i], 0, cap - 1); the
// block walks keys up to its own largest position only, so pages past it
// are never read.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
paged_qblock_kernel(const __nv_bfloat16* __restrict__ q, const T* __restrict__ kpool,
                    const T* __restrict__ vpool, const float* __restrict__ kscale,
                    const float* __restrict__ vscale, const int* __restrict__ table,
                    const int* __restrict__ positions,
                    __nv_bfloat16* __restrict__ out, int C, int H, int kvh,
                    int page, int p_max, int qt) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int rep = H / kvh;
  const int rows = qt * rep;
  const int i0 = tile * qt;
  const int cap = p_max * page;
  const Smem<T, HD> sm(smem, rows);
  for (int R = threadIdx.x; R < rows; R += kThreads) {
    const int i = i0 + R / rep;
    sm.lims[R] = i < C ? min(max(positions[(size_t)b * C + i], 0), cap - 1) : -1;
  }
  for (int e = threadIdx.x; e < rows * HD; e += kThreads) {
    const int R = e / HD, d = e % HD;
    const int i = i0 + R / rep, h = g * rep + R % rep;
    sm.qs[e] = i < C ? __bfloat162float(q[(((size_t)b * C + i) * H + h) * HD + d])
                     : 0.f;
  }
  __syncthreads();
  int n_keys = 0;
  for (int R = 0; R < rows; ++R) n_keys = max(n_keys, sm.lims[R] + 1);
  attend_rows<T, HD>(sm, rows, n_keys, kpool, vpool, kscale, vscale,
                     table + (size_t)b * p_max, kvh, g, page);
  __syncthreads();
  for (int e = threadIdx.x; e < rows * HD; e += kThreads) {
    const int R = e / HD, d = e % HD;
    const int i = i0 + R / rep, h = g * rep + R % rep;
    if (i < C) out[(((size_t)b * C + i) * H + h) * HD + d] = __float2bfloat16(sm.qs[e]);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int HD>
cudaError_t launch_decode(const void* q, const void* kpool, const void* vpool,
                          const float* kscale, const float* vscale, const int* table,
                          const int* kv_len, void* out, int S, int H, int kvh, int page,
                          int p_max, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, HD>(H / kvh);
  cudaError_t err = allow_smem(paged_decode_kernel<T, HD>, smem);
  if (err != cudaSuccess) return err;
  paged_decode_kernel<T, HD><<<dim3(kvh, S), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(kpool),
      static_cast<const T*>(vpool), kscale, vscale, table, kv_len,
      static_cast<__nv_bfloat16*>(out), H, kvh, page, p_max);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_qblock(const void* q, const void* kpool, const void* vpool,
                          const float* kscale, const float* vscale, const int* table,
                          const int* positions, void* out, int B, int C, int H, int kvh,
                          int page, int p_max, cudaStream_t stream) {
  const int rep = H / kvh;
  const int qt = std::max(1, std::min(kMaxRows / rep, C));
  const size_t smem = smem_bytes<T, HD>(qt * rep);
  cudaError_t err = allow_smem(paged_qblock_kernel<T, HD>, smem);
  if (err != cudaSuccess) return err;
  paged_qblock_kernel<T, HD><<<dim3((C + qt - 1) / qt, kvh, B), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(kpool),
      static_cast<const T*>(vpool), kscale, vscale, table, positions,
      static_cast<__nv_bfloat16*>(out), C, H, kvh, page, p_max, qt);
  return cudaGetLastError();
}

bool shape_ok(int H, int kvh, int hd, int page, int p_max) {
  return kvh > 0 && H % kvh == 0 && H / kvh <= kMaxRows && hd == kHeadDim &&
         page > 0 && p_max > 0;
}

template <typename T>
int decode_entry(const void* q, const void* kpool, const void* vpool, const void* kscale,
                 const void* vscale, const void* table, const void* kv_len, void* out,
                 int S, int H, int kvh, int hd, int page, int p_max, int device,
                 void* stream) {
  if (!shape_ok(H, kvh, hd, page, p_max) || S <= 0) return (int)cudaErrorInvalidValue;
  if (Storage<T>::kQuant && (kscale == nullptr || vscale == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_decode<T, kHeadDim>(
      q, kpool, vpool, static_cast<const float*>(kscale), static_cast<const float*>(vscale),
      static_cast<const int*>(table), static_cast<const int*>(kv_len), out, S, H, kvh, page,
      p_max, static_cast<cudaStream_t>(stream));
}

template <typename T>
int qblock_entry(const void* q, const void* kpool, const void* vpool, const void* kscale,
                 const void* vscale, const void* table, const void* positions, void* out,
                 int B, int C, int H, int kvh, int hd, int page, int p_max, int device,
                 void* stream) {
  if (!shape_ok(H, kvh, hd, page, p_max) || B <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  if (Storage<T>::kQuant && (kscale == nullptr || vscale == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_qblock<T, kHeadDim>(
      q, kpool, vpool, static_cast<const float*>(kscale), static_cast<const float*>(vscale),
      static_cast<const int*>(table), static_cast<const int*>(positions), out, B, C, H, kvh,
      page, p_max, static_cast<cudaStream_t>(stream));
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers on `device`;
// `stream` is a cudaStream_t. The int8 / fp8 entry points take the layer's
// (num_pages, KV) fp32 scale tables of the K and V pools. Returns a
// cudaError_t code (0 = launched).
extern "C" int tdt_paged_decode_bf16(const void* q, const void* kpool,
                                     const void* vpool, const void* table,
                                     const void* kv_len, void* out, int S, int H,
                                     int kvh, int hd, int page, int p_max,
                                     int device, void* stream) {
  return decode_entry<__nv_bfloat16>(q, kpool, vpool, nullptr, nullptr, table, kv_len, out,
                                     S, H, kvh, hd, page, p_max, device, stream);
}

extern "C" int tdt_paged_decode_int8(const void* q, const void* kpool, const void* vpool,
                                     const void* kscale, const void* vscale,
                                     const void* table, const void* kv_len, void* out,
                                     int S, int H, int kvh, int hd, int page, int p_max,
                                     int device, void* stream) {
  return decode_entry<int8_t>(q, kpool, vpool, kscale, vscale, table, kv_len, out, S, H, kvh,
                              hd, page, p_max, device, stream);
}

extern "C" int tdt_paged_decode_fp8(const void* q, const void* kpool, const void* vpool,
                                    const void* kscale, const void* vscale,
                                    const void* table, const void* kv_len, void* out,
                                    int S, int H, int kvh, int hd, int page, int p_max,
                                    int device, void* stream) {
  return decode_entry<__nv_fp8_e4m3>(q, kpool, vpool, kscale, vscale, table, kv_len, out, S,
                                     H, kvh, hd, page, p_max, device, stream);
}

extern "C" int tdt_paged_qblock_bf16(const void* q, const void* kpool,
                                     const void* vpool, const void* table,
                                     const void* positions, void* out, int B, int C,
                                     int H, int kvh, int hd, int page, int p_max,
                                     int device, void* stream) {
  return qblock_entry<__nv_bfloat16>(q, kpool, vpool, nullptr, nullptr, table, positions,
                                     out, B, C, H, kvh, hd, page, p_max, device, stream);
}

extern "C" int tdt_paged_qblock_int8(const void* q, const void* kpool, const void* vpool,
                                     const void* kscale, const void* vscale,
                                     const void* table, const void* positions, void* out,
                                     int B, int C, int H, int kvh, int hd, int page,
                                     int p_max, int device, void* stream) {
  return qblock_entry<int8_t>(q, kpool, vpool, kscale, vscale, table, positions, out, B, C,
                              H, kvh, hd, page, p_max, device, stream);
}

extern "C" int tdt_paged_qblock_fp8(const void* q, const void* kpool, const void* vpool,
                                    const void* kscale, const void* vscale,
                                    const void* table, const void* positions, void* out,
                                    int B, int C, int H, int kvh, int hd, int page,
                                    int p_max, int device, void* stream) {
  return qblock_entry<__nv_fp8_e4m3>(q, kpool, vpool, kscale, vscale, table, positions, out,
                                     B, C, H, kvh, hd, page, p_max, device, stream);
}

// Dynamic shared memory a block of either kernel takes for `rows` (query,
// head) rows: decode rows = H / KV, Q-block rows = qt * (H / KV) <= 32;
// `quant` = 1 for the int8 / fp8 pools (1-byte elements).
extern "C" int tdt_paged_smem_bytes(int rows, int quant) {
  return quant ? (int)smem_bytes<int8_t, kHeadDim>(rows)
               : (int)smem_bytes<__nv_bfloat16, kHeadDim>(rows);
}

extern "C" const char* tdt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
