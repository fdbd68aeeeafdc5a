// KV-allgather attention across simulated ranks on Hopper (sm_90a): the
// long-context prefill of sequence parallelism, bf16 in and out, fp32 scores
// and softmax.
//
// sp_ag_attention_kernel replaces triton_dist_tpu/ops/sp_ag_attention.py
// _sp_ag_attn_kernel (:174, the flat form of sp_ag_attention_fused :636).
// Rank r holds its sequence slice of q (S_loc x H x hd) and of k, v (S_loc x
// KV x hd, KV heads at their true count: query head h reads KV head
// h / (H / KV)); rank r's rows are global positions r * S_loc + i. Every
// rank's output is attention over the keys it may see:
//
//   out[r][i][h] = softmax_j(q . k_j * scale) . v_j   over global keys j
//
// causal: j <= r * S_loc + i; varlen (cu_seqlens, packed sequences, causal
// only): also the same sequence as the query; non-causal: every key.
//
// The protocol is JAX's: every rank pushes its KV chunk at entry to the ranks
// that read it (causal: the ranks above; varlen: those a packed sequence
// spans to, JAX's span_need predicate :200-217; non-causal: all), one flag
// per (receiver, sender, row block); then each query tile walks the chunks
// in ring-arrival order, src = (r - k) mod n at step k (the local chunk
// first, read from the input; causal stops at k = r), with one arrival wait
// per source (its row blocks' flags, polled at once by the block's threads)
// and an online softmax over the key tiles. Varlen prunes the waits by the
// same predicate as the puts, and skips key tiles whose sequences all end
// before the query tile's first one.
//
// Work items, in the order every block walks them (each waits only on a
// lower-numbered item, see shmem_device.cuh): the puts (sender, peer offset,
// row block), then the attention items (rank, query tile, query head), the
// last rank's first (under causal masking it reads the most chunks).
//
// The tile loop is flash_attention.cu's: one block of four warps per 64-query
// tile of one head, 64-key tiles, S = Q K^T and O += P V on the tensor cores
// (nvcuda::wmma bf16, fp32 sums), a lane pair per query row holding its
// running max and sum; the unnormalised probabilities are rounded to bf16
// for P V (JAX's kernel casts p to the value dtype at :455) and the output
// is divided by the sum and rounded once.
//
// What bounds it on the H100: operations. At Qwen3-8B width (32 / 8 heads of
// 128) over S = 32768 split 4 ways, causal: 4 x 128 x 32 x 32768^2 / 2 =
// 8.8 TFLOP (8.9 ms at 989 TFLOP/s) against 1.1 GB of q, k, v and out. No
// cp.async, TMA or wgmma yet, and K/V tiles are not double-buffered
// (PERF.md).

#include <math.h>
#include <mma.h>

#include "shmem_device.cuh"

namespace {

using namespace tdt;
using namespace nvcuda;

enum Fault { kNoFault = 0, kSlotOffByOne = 1, kLostSignal = 2 };

constexpr int kBM = 64;               // query rows per item, 16 per warp
constexpr int kBN = 64;               // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxHeadDim = 256;
constexpr int kMaxCu = 512;           // packed-sequence boundaries
constexpr int kSLd = kBN + 4;         // fp32 scores, padded rows
constexpr int kPLd = kBN + 8;         // bf16 probabilities, padded rows
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int ld_bf16(int hdp) { return hdp + 8; }
__host__ __device__ inline int ld_f32(int hdp) { return hdp + 4; }

// Shared memory: O (kBM x hdp fp32) | S (kBM x kBN fp32) | Q | K | V (bf16)
// | P (kBM x kBN bf16) | key sequence ids (kBN) | the boundaries (kMaxCu,
// reserved in every launch: the occupancy asked once per kernel must hold
// for each). At hd 128 that is 114,944 bytes: two blocks an SM.
size_t smem_bytes(int hdp) {
  return (size_t)kBM * ld_f32(hdp) * sizeof(float) + (size_t)kBM * kSLd * sizeof(float) +
         (size_t)(kBM + 2 * kBN) * ld_bf16(hdp) * sizeof(bf16) +
         (size_t)kBM * kPLd * sizeof(bf16) + (size_t)(kBN + kMaxCu) * sizeof(int);
}

struct Params {
  const bf16* q;     // (n, S_loc, H, hd)
  const bf16* k;     // (n, S_loc, KV, hd)
  const bf16* v;
  bf16* out;         // (n, S_loc, H, hd)
  bf16* kws;         // (n, n, S_loc, KV, hd): [receiver][sender]
  bf16* vws;
  const int* cu;     // (n_cu,) packed boundaries, or null
  int n, S_loc, H, KV, hd, hdp, causal, n_cu, rb_rows, n_rb, n_qt, fault;
  float scale;
  Sync sync;
};

// Sequence id of global position pos: the boundaries cu[1:] at or below it.
__device__ __forceinline__ int seq_of(const int* cu, int n_cu, long long pos) {
  int id = 0;
  for (int j = 1; j < n_cu; ++j) id += cu[j] <= pos;
  return id;
}

// Whether rank dst's queries read any key of rank src's chunk (src < dst):
// a packed sequence spans from src's last row to dst's first (JAX :211).
__device__ __forceinline__ bool span_need(const Params& P, const int* cu, int src, int dst) {
  return seq_of(cu, P.n_cu, (long long)(src + 1) * P.S_loc - 1) ==
         seq_of(cu, P.n_cu, (long long)dst * P.S_loc);
}

__device__ __forceinline__ long long flag_of(const Params& P, int dst, int src, int rb) {
  return ((long long)dst * P.n + src) * P.n_rb + rb;
}

// Sender src's row block rb for rank dst = src + off (causal) or
// (src + off) mod n, if dst reads it.
__device__ void put_item(const Params& P, int src, int off, int rb) {
  const int n = P.n;
  const int dst = P.causal ? src + off : (src + off) % n;
  if (dst >= n) return;
  if (P.cu != nullptr && !span_need(P, P.cu, src, dst)) return;
  const long long row = (long long)P.KV * P.hd;
  const int r0 = rb * P.rb_rows, rows = min(P.rb_rows, P.S_loc - r0);
  const long long from = ((long long)src * P.S_loc + r0) * row;
  const long long to = (((long long)dst * n + src) * P.S_loc + r0) * row;
  if (P.fault == kSlotOffByOne && src == 0 && dst == 1) {
    // A planted fault: rank 0's key rows land one position down at rank 1
    // (its values where they belong), so every key meets the next value.
    const int k_rows = r0 + rows == P.S_loc ? rows - 1 : rows;
    remote_put(P.kws + to + row, row, P.k + from, row, k_rows, (int)row);
  } else {
    remote_put(P.kws + to, row, P.k + from, row, rows, (int)row);
  }
  remote_put(P.vws + to, row, P.v + from, row, rows, (int)row);
  if (P.fault == kLostSignal && src == 0 && dst == 1 && rb == 0) return;
  signal_block(P.sync, flag_of(P, dst, src, rb));
}

// Rows [row0, row0 + rows) of one head of a (S_loc, nh, hd) slice into
// dst[rows][ld], zero past S_loc and past hd, loads past L1 (the receive
// slots are written by other blocks of the launch).
__device__ void load_rows(bf16* dst, int ld, const bf16* __restrict__ src, int row0, int rows,
                          int S, int nh, int head, int hd, int hdp) {
  const int per = hdp / 8;
  for (int e = threadIdx.x; e < rows * per; e += kThreads) {
    const int r = e / per, c8 = e % per, s = row0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (s < S && c8 * 8 < hd)
      val = __ldcg(reinterpret_cast<const uint4*>(src + ((long long)s * nh + head) * hd + c8 * 8));
    *reinterpret_cast<uint4*>(dst + r * ld + c8 * 8) = val;
  }
}

// Rank me's query tile qt of head h over every chunk it reads.
__device__ void attn_item(const Params& P, int me, int qt, int h, unsigned char* smem) {
  const int lo = ld_f32(P.hdp), lb = ld_bf16(P.hdp), hd = P.hd, hdp = P.hdp, n = P.n;
  float* Os = reinterpret_cast<float*>(smem);
  float* Ss = Os + kBM * lo;
  bf16* Qs = reinterpret_cast<bf16*>(Ss + kBM * kSLd);
  bf16* Ks = Qs + kBM * lb;
  bf16* Vs = Ks + kBN * lb;
  bf16* Ps = Vs + kBN * lb;
  int* kseq = reinterpret_cast<int*>(Ps + kBM * kPLd);
  int* cu = kseq + kBN;
  const bool varlen = P.cu != nullptr;

  const int q0 = qt * kBM, kvh = h / (P.H / P.KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long slice = (long long)P.S_loc;
  if (varlen)
    for (int j = threadIdx.x; j < P.n_cu; j += kThreads) cu[j] = P.cu[j];
  load_rows(Qs, lb, P.q + me * slice * P.H * hd, q0, kBM, P.S_loc, P.H, h, hd, hdp);
  for (int e = threadIdx.x; e < kBM * lo; e += kThreads) Os[e] = 0.f;
  __syncthreads();

  // Lanes 2r and 2r + 1 of warp w own query row 16 w + r, 32 keys each.
  const int row = warp * 16 + lane / 2, half = lane % 2;
  const long long qpos = me * slice + q0 + row;
  const int qseq = varlen ? seq_of(cu, P.n_cu, qpos) : 0;
  const int first_qseq = varlen ? seq_of(cu, P.n_cu, me * slice + q0) : 0;
  float m = -INFINITY, l = 0.f;
  const long long chunk = slice * P.KV * hd;
  for (int kk = 0; kk < n; ++kk) {
    const int src = (me - kk + n) % n;
    if (P.causal && kk > me) break;      // the chunks above me are all future
    if (kk > 0) {
      if (varlen && !span_need(P, cu, src, me)) continue;
      wait_flags(P.sync, flag_of(P, me, src, 0), P.n_rb, me, src);
    }
    const bf16* kb = kk == 0 ? P.k + me * chunk : P.kws + ((long long)me * n + src) * chunk;
    const bf16* vb = kk == 0 ? P.v + me * chunk : P.vws + ((long long)me * n + src) * chunk;
    const int last_key = (P.causal && kk == 0) ? min(q0 + kBM, P.S_loc) - 1 : P.S_loc - 1;
    const int n_tiles = last_key / kBN + 1;
    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = t * kBN;
      const long long kpos0 = src * slice + k0;
      if (varlen &&
          seq_of(cu, P.n_cu, min(kpos0 + kBN, (src + 1) * slice) - 1) < first_qseq)
        continue;                        // every key's sequence ended before
      __syncthreads();                   // the last tile's K, V, P are consumed
      load_rows(Ks, lb, kb, k0, kBN, P.S_loc, P.KV, kvh, hd, hdp);
      load_rows(Vs, lb, vb, k0, kBN, P.S_loc, P.KV, kvh, hd, hdp);
      if (varlen && threadIdx.x < kBN) kseq[threadIdx.x] = seq_of(cu, P.n_cu, kpos0 + threadIdx.x);
      __syncthreads();

      {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kBN / 16];
#pragma unroll
        for (int j = 0; j < kBN / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
        for (int c = 0; c < hdp; c += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
          wmma::load_matrix_sync(af, Qs + warp * 16 * lb + c, lb);
#pragma unroll
          for (int j = 0; j < kBN / 16; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
            wmma::load_matrix_sync(bfr, Ks + j * 16 * lb + c, lb);
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
        bool ok = key < P.S_loc && (!P.causal || src * slice + key <= qpos);
        if (varlen) ok = ok && kseq[half * 32 + c] == qseq;
        sv[c] = ok ? srow[c] * P.scale : -INFINITY;
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
      for (int c = 0; c < kBN / 16; ++c)
        wmma::load_matrix_sync(pf[c], Ps + warp * 16 * kPLd + c * 16, kPLd);
      for (int j = 0; j < hdp / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
        float* op = Os + warp * 16 * lo + j * 16;
        wmma::load_matrix_sync(o, op, lo, wmma::mem_row_major);
#pragma unroll
        for (int c = 0; c < kBN / 16; ++c) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
          wmma::load_matrix_sync(vf, Vs + c * 16 * lb + j * 16, lb);
          wmma::mma_sync(o, pf[c], vf, o);
        }
        wmma::store_matrix_sync(op, o, lo, wmma::mem_row_major);
      }
      __syncwarp();
    }
  }

  // Each lane pair stores its row, divided by l, rounded to bf16 once (a
  // causal row always sees itself, so l > 0).
  __syncwarp();
  if (q0 + row < P.S_loc) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const float* orow = Os + row * lo;
    bf16* dst = P.out + ((me * slice + q0 + row) * P.H + h) * hd;
    for (int c = half; c < hd; c += 2) dst[c] = __float2bfloat16(orow[c] * inv);
  }
}

__global__ void __launch_bounds__(kThreads) sp_ag_attention_kernel(Params P) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n = P.n;
  const long long puts = (long long)n * (n - 1) * P.n_rb;
  const long long per_rank = (long long)P.n_qt * P.H;
  const long long items = puts + n * per_rank;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    if (item < puts) {
      const int rb = (int)(item % P.n_rb);
      const long long pair = item / P.n_rb;
      put_item(P, (int)(pair / (n - 1)), 1 + (int)(pair % (n - 1)), rb);
    } else {
      const long long rem = item - puts;
      const int me = n - 1 - (int)(rem / per_rank);
      const long long t = rem % per_rank;
      attn_item(P, me, (int)(t / P.H), (int)(t % P.H), smem);
    }
    __syncthreads();   // shared memory is free for the next item
  }
}

}  // namespace

// Plain C interface for ctypes. q, out (n, S_loc, H, hd); k, v (n, S_loc, KV,
// hd); kws, vws (n, n, S_loc, KV, hd) receive slots [receiver][sender]; cu
// (n_cu,) int32 packed boundaries (cu[0] = 0, cu[n_cu - 1] = n * S_loc) or
// null; flags: the workspace's n * n * ceil(S_loc / rb_rows) flag words then
// its abort word. hd a multiple of 8, at most 256; tensors 16-byte aligned.
// epoch: this call's (>= 1); timeout_ns bounds every wait; fault: 0, or a
// planted fault in rank 0's chunk for rank 1 (1: its key rows land one
// position down; 2: its first row block is never signalled). Returns a cudaError_t
// code (0 = launched).
extern "C" int tdt_sp_ag_attention(const void* q, const void* k, const void* v, void* out,
                                   void* kws, void* vws, const void* cu, int n_cu, int n,
                                   int S_loc, int H, int KV, int hd, float scale, int causal,
                                   int rb_rows, void* flags, void* abort_word,
                                   unsigned long long epoch, unsigned long long timeout_ns,
                                   int fault, int device, void* stream) {
  if (n < 1 || S_loc < 1 || KV < 1 || H % KV || hd < 8 || hd % 8 || hd > kMaxHeadDim ||
      rb_rows < 1 || (cu != nullptr && (n_cu < 2 || n_cu > kMaxCu || !causal)) ||
      flags == nullptr || abort_word == nullptr || epoch == 0 || timeout_ns == 0 ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(kws) |
       reinterpret_cast<uintptr_t>(vws)) % 16)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = ensure_error_record();
  if (e != cudaSuccess) return (int)e;
  Params P;
  P.q = static_cast<const bf16*>(q);
  P.k = static_cast<const bf16*>(k);
  P.v = static_cast<const bf16*>(v);
  P.out = static_cast<bf16*>(out);
  P.kws = static_cast<bf16*>(kws);
  P.vws = static_cast<bf16*>(vws);
  P.cu = static_cast<const int*>(cu);
  P.n = n;
  P.S_loc = S_loc;
  P.H = H;
  P.KV = KV;
  P.hd = hd;
  P.hdp = (hd + 15) / 16 * 16;
  P.causal = causal;
  P.n_cu = cu != nullptr ? n_cu : 0;
  P.rb_rows = rb_rows;
  P.n_rb = (S_loc + rb_rows - 1) / rb_rows;
  P.n_qt = (S_loc + kBM - 1) / kBM;
  P.fault = fault;
  P.scale = scale;
  P.sync.flags = static_cast<u64*>(flags);
  P.sync.abort = static_cast<u64*>(abort_word);
  P.sync.err = g_err_dev;
  P.sync.epoch = epoch;
  P.sync.timeout_ns = timeout_ns;
  void* args[] = {&P};
  const long long items = (long long)n * (n - 1) * P.n_rb + (long long)n * P.n_qt * H;
  return (int)cooperative_launch(reinterpret_cast<const void*>(sp_ag_attention_kernel), kThreads,
                                 (int)smem_bytes(P.hdp), items, args, device,
                                 static_cast<cudaStream_t>(stream));
}
