// The megakernel for Hopper (sm_90a): a whole Qwen3 step as ONE
// persistent launch over a bf16 arena.
//
// megakernel_kernel replaces triton_dist_tpu/megakernel/builder.py
// ModelBuilder._kernel (:1157) with its decode, batched-prefill and
// prefill-chunk task bodies from triton_dist_tpu/megakernel/kernels.py.
// The three cache pairs differ only in their row rule (row_at below):
//
//   decode  (WRITE_KV / ATTN_DECODE)           row r: slot r, at lens[r]
//   prefill (WRITE_KV_PREFILL / ATTN_PREFILL)  slot r / seq, at
//                                               lens[r] + r % seq
//   chunk   (WRITE_KV_CHUNK / ATTN_CHUNK)      slot 0 (the launch carries
//            one (p_max,) table row), at max(code >= 0 ? code : -code-2, 0),
//            writing iff code >= 0 (lens holds the sign-encoded codes)
//
// so one write body and one attention body serve all three. A Qwen3-MoE
// build adds the MoE pair (kernels.py moe_weights_body / weighted_add_body):
// MOE_WEIGHTS routes each row (softmax, top-k, combine weights) and counts
// the routed (row, expert) pairs in an int32 buffer beside the arena;
// WEIGHTED_ADD accumulates one expert's output into the FFN partial. Both
// follow the build's batch rows, so they serve every row mode. The TPU kernel walks its task
// queue as a sequential grid on one core; here every block of a
// cooperative launch (as many as fit on the card at once) loops:
//
//   thread 0 claims the next entry of the claim list with atomicAdd on a
//   counter, then spins (ld.acquire.gpu) until every predecessor's done
//   flag is set; __syncthreads; the whole block runs the task body;
//   __syncthreads; thread 0 does __threadfence and a st.release.gpu of the
//   task's own flag.
//
// The claim list is a topological order and a task waits only on tasks
// claimed before it, which blocks that are all resident hold: the oldest
// unfinished claim always has its predecessors done, so the launch cannot
// deadlock. A wait is still bounded by %globaltimer (timeout_ns): past it
// the kernel records (task, predecessor, claim) in mapped host memory and
// traps, and the host wrapper raises with the task's description.
//
// Memory: L1 is not coherent between SMs and arena regions share cache
// lines at their edges, so every read of another task's output (arena
// activations, the K/V pools) is ld.global.cg (L2); weights, norm weights
// and the embedding, which no task writes, use the read-only path.
//
// Layout (triton_dist_tpu_torch/megakernel/builder.py): the arena is
// (rows, 128) bf16; an activation is consecutive (batch, 128) tiles, a
// weight is tile-major (128, 128) blocks, block (kt, j) at rows
// w_off + (kt * n_tiles + j) * 128; the pools are (layers, num_pages,
// page, kv, 128) bf16 read through a flat (batch * p_max) block table
// (the dense cache is the same with page = max_len and table = arange).
// Math inside a task is fp32; every output is rounded to bf16 when stored.
//
// What bounds a step on the H100: at decode batch <= 8, bytes. Every weight
// element is used for <= 8 multiply-adds, far below the ~295 flops per
// byte where the tensor cores become the limit; the step's floor is its
// weights plus the K/V rows it attends plus the logits, over 3.35 TB/s.
// That LINEAR body reads each weight once with 16-byte loads, up to eight
// rows in flight per thread, and sums in fp32 on CUDA cores. A prompt
// launch (chunk or batched prefill) has 9 and more rows: 512 rows use
// each weight 512 times, so it is bound by operations, and its LINEAR runs
// on tensor cores (nvcuda::wmma, bf16 16x16x16 with fp32 sums) in passes
// of 64 rows, zero-padding rows past the batch in shared memory. The
// kernel is instantiated twice (run_task<kMma>): the decode set with the
// CUDA-core LINEAR, and every ported type with the tensor-core one, so
// the decode kernel's registers are not shared with the prompt paths. Known
// slow points, measured in PERF.md and left for the redesign: the
// tensor-core LINEAR stages without pipelining and rereads its weight
// panel once per 64-row pass (no wgmma, no TMA), and attention is one
// task per layer run by one block, a serial point 36 times a launch whose
// work grows with rows x attended keys.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kW = 128;              // arena tile width (the only one built)
constexpr int kHD = 128;             // head_dim (the only one built)
constexpr int kMaxB = 8;             // rows of the CUDA-core LINEAR
constexpr int kMaxRep = 8;           // query heads per KV head
constexpr int kKC = 1024;            // LINEAR input columns staged per pass
constexpr int kKG = kThreads / (kW / 8);   // LINEAR k-groups (16)
constexpr int kSmemBytes = 32 * 1024;
constexpr unsigned kFull = 0xffffffffu;
// Tensor-core LINEAR (more than kMaxB rows): 64-row passes, 64-deep
// k stages; shared-memory rows padded by 8 bf16 against bank conflicts.
constexpr int kTM = 64;
constexpr int kTK = 64;
constexpr int kXLd = kTK + 8;
constexpr int kWLd = kW + 8;

static_assert(kMaxB * kKC * 4 <= kSmemBytes, "LINEAR input stage");
static_assert(kWarps * kMaxB * kW * 4 <= kSmemBytes, "LINEAR reduction");
static_assert(kWarps * kMaxRep * kHD * 4 <= kSmemBytes, "ATTN queries");
static_assert((kTM * kXLd + kTK * kWLd) * 2 <= kSmemBytes, "MMA stages");
static_assert(kWarps * 16 * 16 * 4 <= kTM * kXLd * 2, "MMA epilogue");
static_assert(kWarps * 16 == kW, "one 16-column fragment per warp");

// Task type codes of triton_dist_tpu_torch/megakernel/task.py.
enum TaskType : int {
  kRmsNorm = 0, kLinear = 1, kAdd = 2, kSiluMul = 3, kAttnDecode = 4,
  kWriteKv = 5, kAllreduce = 6, kGather = 7, kNoop = 8,
  kWriteKvPrefill = 9, kAttnPrefill = 10, kMoeWeights = 11, kWeightedAdd = 12,
  kAttnChunk = 16, kWriteKvChunk = 17,
};

// How a cache task maps its rows to (slot, position, writes).
enum RowMode : int { kDecodeRows = 0, kPrefillRows = 1, kChunkRows = 2 };

struct Params {
  __nv_bfloat16* arena;
  __nv_bfloat16* kpool;
  __nv_bfloat16* vpool;
  const int* tokens;
  const int* lens;
  const int* table;
  const int* claims;
  const int* types;
  const int* args;
  const int* pred_start;
  const int* preds;
  int* counter;
  int* gate;           // 0 until a wait times out: the first one reports
  int* flags;
  int* err;            // mapped host memory: [set, task, pred, claim]
  long long* task_ns;  // optional [n_tasks][start, end] on %globaltimer
  int* counts;         // MoE: [counts_rows][128] routed (row, expert) counts
  int n_claims, batch, seq, h_loc, kv_loc, num_pages, page, p_max;
  int moe_topk, moe_norm;
  float eps, theta;
  unsigned long long timeout_ns;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ __nv_bfloat16* arow(const Params& P, long long row) {
  return P.arena + (size_t)row * kW;
}

__device__ __forceinline__ void unpack4(uint2 u, float (&f)[4]) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u.y));
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
}

__device__ __forceinline__ void unpack8(uint4 u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = h.x;
    f[2 * i + 1] = h.y;
  }
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

// 4 values of another task's output (L2), 4 of a weight (read-only path).
__device__ __forceinline__ void load4_cg(const __nv_bfloat16* p, float (&f)[4]) {
  unpack4(__ldcg(reinterpret_cast<const uint2*>(p)), f);
}
__device__ __forceinline__ void load4_ro(const __nv_bfloat16* p, float (&f)[4]) {
  unpack4(__ldg(reinterpret_cast<const uint2*>(p)), f);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&f)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack2(f[0], f[1]), pack2(f[2], f[3]));
}

// Pool row (layer, KV position `pos` of `slot`'s table row, KV head g).
__device__ __forceinline__ size_t pool_off(const Params& P, int layer, int slot, int pos,
                                           int g) {
  const int pi = min(pos / P.page, P.p_max - 1);
  const int pid = __ldg(P.table + (size_t)slot * P.p_max + pi);
  return ((((size_t)layer * P.num_pages + pid) * P.page + pos % P.page) * P.kv_loc + g) *
         kHD;
}

struct Row {
  int slot, pos;
  bool writes;
};

// Row r of a cache task under its row rule (the plain bodies' _*_rows).
__device__ __forceinline__ Row row_at(const Params& P, RowMode mode, int r) {
  const int v = P.lens[r];
  Row x;
  if (mode == kPrefillRows) {
    x.slot = r / P.seq;
    x.pos = v + r % P.seq;
    x.writes = true;
  } else if (mode == kChunkRows) {
    x.slot = 0;
    x.pos = max(v >= 0 ? v : -v - 2, 0);
    x.writes = v >= 0;
  } else {
    x.slot = r;
    x.pos = v;
    x.writes = true;
  }
  return x;
}

// x (4 dims per lane, a 128-wide head) <- RMSNorm(x) * w, then rope at
// `pos` (half rotation: dims d < 64 pair with d + 64 in lane ^ 16).
__device__ __forceinline__ void norm_rope(const Params& P, float (&x)[4],
                                          const __nv_bfloat16* w_row, int pos) {
  const int lane = threadIdx.x % 32;
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) ss += x[i] * x[i];
  ss = warp_sum(ss);
  const float inv = 1.f / sqrtf(ss / (float)kHD + P.eps);
  float w[4];
  load4_ro(w_row + lane * 4, w);
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = x[i] * inv * w[i];
  float other[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) other[i] = __shfl_xor_sync(kFull, x[i], 16);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int fi = (lane * 4 + i) % (kHD / 2);
    const float inv_freq = 1.f / powf(P.theta, (2.f * fi) / (float)kHD);
    const float ang = (float)pos * inv_freq;
    const float c = cosf(ang), s = sinf(ang);
    x[i] = lane < 16 ? x[i] * c - other[i] * s : x[i] * c + other[i] * s;
  }
}

// RMSNORM (in_off, w_off, out_off, d_tiles): warp per batch row; the mean
// divides by d_tiles * 128, the padded width, as the JAX body does.
__device__ void rmsnorm(const Params& P, const int* a) {
  const int in_off = a[0], w_off = a[1], out_off = a[2], dt = a[3];
  const int b = P.batch, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int bb = warp; bb < b; bb += kWarps) {
    float ss = 0.f;
    for (int j = 0; j < dt; ++j) {
      float x[4];
      load4_cg(arow(P, in_off + (long long)j * b + bb) + lane * 4, x);
#pragma unroll
      for (int i = 0; i < 4; ++i) ss += x[i] * x[i];
    }
    ss = warp_sum(ss);
    const float inv = 1.f / sqrtf(ss / (float)(dt * kW) + P.eps);
    for (int j = 0; j < dt; ++j) {
      float x[4], w[4];
      load4_cg(arow(P, in_off + (long long)j * b + bb) + lane * 4, x);
      load4_ro(arow(P, w_off + j) + lane * 4, w);
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = x[i] * inv * w[i];
      store4(arow(P, out_off + (long long)j * b + bb) + lane * 4, x);
    }
  }
}

// ADD / SILU_MUL (a_off, b_off, out_off, tiles): one pass over the
// tiles * batch contiguous rows, 8 values per thread per step.
__device__ void elementwise(const Params& P, const int* a, bool silu) {
  const __nv_bfloat16* pa = arow(P, a[0]);
  const __nv_bfloat16* pb = arow(P, a[1]);
  __nv_bfloat16* po = arow(P, a[2]);
  const size_t n8 = (size_t)a[3] * P.batch * kW / 8;
  for (size_t v = threadIdx.x; v < n8; v += kThreads) {
    float x[8], y[8];
    unpack8(__ldcg(reinterpret_cast<const uint4*>(pa) + v), x);
    unpack8(__ldcg(reinterpret_cast<const uint4*>(pb) + v), y);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      x[i] = silu ? x[i] / (1.f + expf(-x[i])) * y[i] : x[i] + y[i];
    reinterpret_cast<uint4*>(po)[v] = make_uint4(pack2(x[0], x[1]), pack2(x[2], x[3]),
                                                 pack2(x[4], x[5]), pack2(x[6], x[7]));
  }
}

// MOE_WEIGHTS (rl_off, wbe_off, n_experts, cnt_off): warp per row, lane l
// holding columns [4l, 4l + 4) of the router-logit row. fp32 softmax over
// the first n_experts columns (the rest -inf before it, 0 after), top-k by
// k rounds of a warp argmax whose ties go to the lower column (jnp.argmax),
// renormalised over max(sum, 1e-30) when moe_norm; stores the row of
// combine weights and adds 1 per selected column to the row's counters
// (atomics at L2: the counters are exact int32, where the JAX body adds
// to its fp32 arena's cnt_off rows). Rows are independent, so every row
// of every mode routes, as in the JAX body.
__device__ void moe_weights(const Params& P, const int* a) {
  const int rl_off = a[0], wbe_off = a[1], n_e = a[2];
  const int b = P.batch, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int bb = warp; bb < b; bb += kWarps) {
    float x[4], p[4];
    load4_cg(arow(P, rl_off + bb) + lane * 4, x);
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (lane * 4 + i >= n_e) x[i] = -INFINITY;
      m = fmaxf(m, x[i]);
    }
    m = warp_max(m);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[i] = lane * 4 + i < n_e ? expf(x[i] - m) : 0.f;
      s += p[i];
    }
    s = warp_sum(s);
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] /= s;
    bool pick[4] = {false, false, false, false};
    for (int k = 0; k < P.moe_topk; ++k) {
      float bv = pick[0] ? -INFINITY : p[0];
      int bi = lane * 4;
#pragma unroll
      for (int i = 1; i < 4; ++i) {
        const float v = pick[i] ? -INFINITY : p[i];
        if (v > bv) { bv = v; bi = lane * 4 + i; }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(kFull, bv, o);
        const int oi = __shfl_xor_sync(kFull, bi, o);
        if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) pick[i] = pick[i] || bi == lane * 4 + i;
    }
    float wv[4], ws = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      wv[i] = pick[i] ? p[i] : 0.f;
      ws += wv[i];
    }
    if (P.moe_norm) {
      ws = fmaxf(warp_sum(ws), 1e-30f);
#pragma unroll
      for (int i = 0; i < 4; ++i) wv[i] /= ws;
    }
    store4(arow(P, wbe_off + bb) + lane * 4, wv);
    int* cnt = P.counts + (size_t)bb * kW + lane * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (pick[i]) atomicAdd(cnt + i, 1);
  }
}

// WEIGHTED_ADD (acc_off, part_off, wbe_off, e, tiles, init): acc = part *
// wbe[:, e] when init, acc += part * wbe[:, e] otherwise, over tiles *
// batch contiguous rows, 8 values per thread per step, fp32 math and one
// bf16 rounding per store.
__device__ void weighted_add(const Params& P, const int* a) {
  const int e = a[3], init = a[5], b = P.batch;
  const uint4* pp = reinterpret_cast<const uint4*>(arow(P, a[1]));
  uint4* pacc = reinterpret_cast<uint4*>(arow(P, a[0]));
  const size_t n8 = (size_t)a[4] * b * kW / 8;
  for (size_t v = threadIdx.x; v < n8; v += kThreads) {
    const int bb = (int)((v / (kW / 8)) % b);
    const float wgt = __bfloat162float(__ushort_as_bfloat16(
        __ldcg(reinterpret_cast<const unsigned short*>(arow(P, a[2] + bb) + e))));
    float x[8];
    unpack8(__ldcg(pp + v), x);
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] *= wgt;
    if (!init) {
      float y[8];
      unpack8(__ldcg(pacc + v), y);
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] += y[i];
    }
    pacc[v] = make_uint4(pack2(x[0], x[1]), pack2(x[2], x[3]), pack2(x[4], x[5]),
                         pack2(x[6], x[7]));
  }
}

// GATHER (table_off, out_off, d_tiles, vocab_loc): each row's embedding,
// zeros for a token outside the table.
__device__ void gather(const Params& P, const int* a) {
  const int table_off = a[0], out_off = a[1], dt = a[2], vocab = a[3];
  const int b = P.batch, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int bb = warp; bb < b; bb += kWarps) {
    const int tok = P.tokens[bb];
    const bool owner = tok >= 0 && tok < vocab;
    for (int j = 0; j < dt; ++j) {
      uint2 v = make_uint2(0, 0);
      if (owner)
        v = __ldg(reinterpret_cast<const uint2*>(
            arow(P, table_off + (long long)tok * dt + j) + lane * 4));
      *reinterpret_cast<uint2*>(arow(P, out_off + (long long)j * b + bb) + lane * 4) = v;
    }
  }
}

// WRITE_KV* (k_off, v_off, layer, k_norm_off): warp per (row, KV head);
// k-norm and rope on K at the row's position, then both rows into the
// page its slot's table row names. A row that does not write (a chunk's
// attend-only and dead rows) touches no pool byte.
__device__ void write_kv(const Params& P, const int* a, RowMode mode) {
  const int k_off = a[0], v_off = a[1], layer = a[2], kn_off = a[3];
  const int b = P.batch, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int p = warp; p < b * P.kv_loc; p += kWarps) {
    const int bb = p / P.kv_loc, g = p % P.kv_loc;
    const Row row = row_at(P, mode, bb);
    if (!row.writes) continue;
    const int pos = row.pos;
    float k[4];
    load4_cg(arow(P, k_off + (long long)g * b + bb) + lane * 4, k);
    norm_rope(P, k, arow(P, kn_off), pos);
    const size_t off = pool_off(P, layer, row.slot, pos, g) + lane * 4;
    store4(P.kpool + off, k);
    *reinterpret_cast<uint2*>(P.vpool + off) = __ldcg(reinterpret_cast<const uint2*>(
        arow(P, v_off + (long long)g * b + bb) + lane * 4));
  }
}

// ATTN_DECODE / ATTN_PREFILL / ATTN_CHUNK (q_off, out_off, layer,
// q_norm_off): warp per (row, KV head), carrying the rep query heads of
// that KV head (q-norm, rope at the row's position, 1/sqrt(hd)) in shared
// memory. Online softmax over the row's position + 1 keys of its slot in
// 32-key steps, lane t scoring key kbase + t; for P.V lane owns output
// dims [4 * lane, 4 * lane + 4). Keeps the -inf guards and
// max(l, 1e-30) of the JAX body.
__device__ void attn_rows(const Params& P, const int* a, float* smem, RowMode mode) {
  const int q_off = a[0], out_off = a[1], layer = a[2], qn_off = a[3];
  const int b = P.batch, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rep = P.h_loc / P.kv_loc;
  float* qs = smem + warp * kMaxRep * kHD;
  const float qscale = 1.f / sqrtf((float)kHD);
  for (int p = warp; p < b * P.kv_loc; p += kWarps) {
    const int bb = p / P.kv_loc, g = p % P.kv_loc;
    const Row row = row_at(P, mode, bb);
    const int pos = row.pos, slot = row.slot;
    const int n_keys = min(pos + 1, P.p_max * P.page);
    for (int r = 0; r < rep; ++r) {
      float q[4];
      load4_cg(arow(P, q_off + (long long)(g * rep + r) * b + bb) + lane * 4, q);
      norm_rope(P, q, arow(P, qn_off), pos);
#pragma unroll
      for (int i = 0; i < 4; ++i) qs[r * kHD + lane * 4 + i] = q[i] * qscale;
    }
    __syncwarp();
    float m[kMaxRep], l[kMaxRep], pr[kMaxRep], acc[kMaxRep][4];
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[r][i] = 0.f;
    }
    for (int kbase = 0; kbase < n_keys; kbase += 32) {
      const int key = kbase + lane;
      float s[kMaxRep];
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) s[r] = 0.f;
      if (key < n_keys) {
        const uint4* kp =
            reinterpret_cast<const uint4*>(P.kpool + pool_off(P, layer, slot, key, g));
#pragma unroll 4
        for (int c = 0; c < kHD / 8; ++c) {
          float kf[8];
          unpack8(__ldcg(kp + c), kf);
#pragma unroll
          for (int r = 0; r < kMaxRep; ++r) {
            if (r < rep) {
#pragma unroll
              for (int e = 0; e < 8; ++e) s[r] = fmaf(qs[r * kHD + c * 8 + e], kf[e], s[r]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) {
        if (r < rep) {
          const float sc = key < n_keys ? s[r] : -INFINITY;
          const float m_new = fmaxf(m[r], warp_max(sc));
          const float m_safe = m_new == -INFINITY ? 0.f : m_new;
          pr[r] = sc == -INFINITY ? 0.f : expf(sc - m_safe);
          const float corr = m[r] == -INFINITY ? 0.f : expf(m[r] - m_safe);
          l[r] = l[r] * corr + warp_sum(pr[r]);
          m[r] = m_new;
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[r][i] *= corr;
        }
      }
      // V rows eight at a time, so eight loads are in flight per lane
      // (keys past n_keys load zeros and carry p = 0).
      const int t_end = min(32, n_keys - kbase);
      for (int t0 = 0; t0 < t_end; t0 += 8) {
        uint2 vv[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          vv[u] = t0 + u < t_end
                      ? __ldcg(reinterpret_cast<const uint2*>(
                            P.vpool + pool_off(P, layer, slot, kbase + t0 + u, g) + lane * 4))
                      : make_uint2(0, 0);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          float v[4];
          unpack4(vv[u], v);
#pragma unroll
          for (int r = 0; r < kMaxRep; ++r) {
            if (r < rep) {
              const float pt = __shfl_sync(kFull, pr[r], t0 + u);
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[r][i] = fmaf(pt, v[i], acc[r][i]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      if (r < rep) {
        const float inv = 1.f / fmaxf(l[r], 1e-30f);
        float o[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i] = acc[r][i] * inv;
        store4(arow(P, out_off + (long long)(g * rep + r) * b + bb) + lane * 4, o);
      }
    }
    __syncwarp();   // qs is rewritten by the warp's next pair
  }
}

// LINEAR (in_off, w_off, out_off, k_tiles, n_tiles, j): output tile j of
// B rows x 128 columns. Thread t owns 8 output columns (t % 16) and every
// 16th input row from t / 16; the input is staged in shared memory as
// fp32 kKC columns at a time, weight rows are 16-byte loads, U in flight
// per thread (8 up to batch 4, 4 above, where the B x 8 sums take the
// registers). Partial sums meet in shared memory.
template <int B>
__device__ void linear(const Params& P, const int* a, float* smem) {
  constexpr int U = B <= 4 ? 8 : 4;
  const int in_off = a[0], w_off = a[1], out_off = a[2];
  const int k_tiles = a[3], n_tiles = a[4], j = a[5];
  const int K = k_tiles * kW;
  const int tid = threadIdx.x, cv = tid % (kW / 8), kg = tid / (kW / 8);
  float acc[B][8];
#pragma unroll
  for (int bb = 0; bb < B; ++bb)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[bb][c] = 0.f;
  float* xs = smem;                                   // [B][kKC]
  for (int k0 = 0; k0 < K; k0 += kKC) {
    const int kn = min(kKC, K - k0);
    const int vpr = kn / 8;
    __syncthreads();
    for (int e = tid; e < B * vpr; e += kThreads) {
      const int bb = e / vpr, k = k0 + (e % vpr) * 8;
      float f[8];
      unpack8(__ldcg(reinterpret_cast<const uint4*>(
                  arow(P, in_off + (long long)(k / kW) * B + bb) + k % kW)),
              f);
      float4* dst = reinterpret_cast<float4*>(xs + bb * kKC + (k - k0));
      dst[0] = make_float4(f[0], f[1], f[2], f[3]);
      dst[1] = make_float4(f[4], f[5], f[6], f[7]);
    }
    __syncthreads();
    for (int kk = kg; kk < kn; kk += U * kKG) {
      uint4 wv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = k0 + kk + u * kKG;
        const long long wrow = w_off + ((long long)(k / kW) * n_tiles + j) * kW + k % kW;
        wv[u] = __ldg(reinterpret_cast<const uint4*>(arow(P, wrow)) + cv);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float wf[8];
        unpack8(wv[u], wf);
#pragma unroll
        for (int bb = 0; bb < B; ++bb) {
          const float x = xs[bb * kKC + kk + u * kKG];
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[bb][c] = fmaf(x, wf[c], acc[bb][c]);
        }
      }
    }
  }
  // Lanes l and l ^ 16 hold the same columns for k-groups 2w and 2w + 1.
#pragma unroll
  for (int bb = 0; bb < B; ++bb)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[bb][c] += __shfl_xor_sync(kFull, acc[bb][c], 16);
  __syncthreads();                                    // xs fully read
  float* red = smem;                                  // [kWarps][B][kW]
  const int warp = tid / 32, lane = tid % 32;
  if (lane < 16) {
#pragma unroll
    for (int bb = 0; bb < B; ++bb)
#pragma unroll
      for (int c = 0; c < 8; ++c) red[(warp * B + bb) * kW + cv * 8 + c] = acc[bb][c];
  }
  __syncthreads();
  for (int e = tid; e < B * kW; e += kThreads) {
    const int bb = e / kW, col = e % kW;
    float s = 0.f;
#pragma unroll
    for (int w8 = 0; w8 < kWarps; ++w8) s += red[(w8 * B + bb) * kW + col];
    arow(P, out_off + (long long)j * B + bb)[col] = __float2bfloat16(s);
  }
}

// LINEAR for more than kMaxB rows, on tensor cores: output tile j (all
// rows x 128 columns) in passes of kTM rows. Each k stage puts kTM input
// rows x kTK columns (rows past the batch zero-filled) and the weight
// block's kTK x 128 panel in shared memory; warp w owns the 16 output
// columns [16w, 16w + 16) and the pass's four 16-row fragments, fp32
// accumulators. The epilogue goes through a per-warp 16x16 fp32 scratch
// (aliasing the input stage) and stores only rows < batch, in bf16.
__device__ void linear_mma(const Params& P, const int* a, float* smem) {
  using namespace nvcuda;
  const int in_off = a[0], w_off = a[1], out_off = a[2];
  const int k_tiles = a[3], n_tiles = a[4], j = a[5];
  const int B = P.batch, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);   // [kTM][kXLd]
  __nv_bfloat16* ws = xs + kTM * kXLd;                            // [kTK][kWLd]
  for (int r0 = 0; r0 < B; r0 += kTM) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kTM / 16];
#pragma unroll
    for (int i = 0; i < kTM / 16; ++i) wmma::fill_fragment(acc[i], 0.f);
    for (int kt = 0; kt < k_tiles; ++kt) {
      for (int k0 = 0; k0 < kW; k0 += kTK) {
        __syncthreads();                                   // stage consumed
        for (int e = tid; e < kTM * (kTK / 8); e += kThreads) {
          const int r = e / (kTK / 8), c8 = e % (kTK / 8);
          uint4 v = make_uint4(0, 0, 0, 0);
          if (r0 + r < B)
            v = __ldcg(reinterpret_cast<const uint4*>(
                           arow(P, in_off + (long long)kt * B + r0 + r) + k0) +
                       c8);
          *reinterpret_cast<uint4*>(xs + r * kXLd + c8 * 8) = v;
        }
        for (int e = tid; e < kTK * (kW / 8); e += kThreads) {
          const int r = e / (kW / 8), c8 = e % (kW / 8);
          const long long wrow = w_off + ((long long)kt * n_tiles + j) * kW + k0 + r;
          *reinterpret_cast<uint4*>(ws + r * kWLd + c8 * 8) =
              __ldg(reinterpret_cast<const uint4*>(arow(P, wrow)) + c8);
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kTK; kk += 16) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
          wmma::load_matrix_sync(bf, ws + kk * kWLd + warp * 16, kWLd);
#pragma unroll
          for (int i = 0; i < kTM / 16; ++i) {
            if (r0 + i * 16 < B) {                         // warp-uniform
              wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
              wmma::load_matrix_sync(af, xs + i * 16 * kXLd + kk, kXLd);
              wmma::mma_sync(acc[i], af, bf, acc[i]);
            }
          }
        }
      }
    }
    __syncthreads();                                       // stages read
    float* cs = smem + warp * 256;
#pragma unroll
    for (int i = 0; i < kTM / 16; ++i) {
      if (r0 + i * 16 < B) {
        wmma::store_matrix_sync(cs, acc[i], 16, wmma::mem_row_major);
        __syncwarp();
        // Lane l: row l / 2 of the fragment, columns 8 (l % 2) .. + 8.
        const int row = r0 + i * 16 + lane / 2, c = (lane % 2) * 8;
        if (row < B) {
          const float* f = cs + (lane / 2) * 16 + c;
          *reinterpret_cast<uint4*>(arow(P, out_off + (long long)j * B + row) + warp * 16 + c) =
              make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                         pack2(f[6], f[7]));
        }
        __syncwarp();                                      // cs rewritten next
      }
    }
  }
}

__device__ void fail(const Params& P, int task, int pred, int claim) {
  if (atomicCAS(P.gate, 0, 1) != 0) {
    for (;;) __nanosleep(1000);   // the first failure's trap ends the launch
  }
  volatile int* err = P.err;
  err[1] = task;
  err[2] = pred;
  err[3] = claim;
  __threadfence_system();
  err[0] = 1;
  __threadfence_system();
  __trap();
}

// The task bodies of one launch. Two instantiations: kMma = false is the
// decode kernel (the decode task set, LINEAR on CUDA cores for <= kMaxB
// rows); kMma = true runs every ported type, LINEAR on tensor cores for
// any row count (the prompt modes, or decode past kMaxB rows). Keeping
// the tensor-core body and the prompt row rules out of the decode kernel
// keeps its register allocation that of the decode set alone.
template <bool kMma>
__device__ void run_task(const Params& P, int t, float* smem) {
  const int* a = P.args + (size_t)t * 8;
  const int type = P.types[t];
  switch (type) {
    case kRmsNorm: rmsnorm(P, a); return;
    case kAdd: elementwise(P, a, false); return;
    case kSiluMul: elementwise(P, a, true); return;
    case kAttnDecode: attn_rows(P, a, smem, kDecodeRows); return;
    case kWriteKv: write_kv(P, a, kDecodeRows); return;
    case kGather: gather(P, a); return;
    case kMoeWeights: moe_weights(P, a); return;
    case kWeightedAdd: weighted_add(P, a); return;
    case kAllreduce:     // one rank: nothing to reduce
    case kNoop: return;
    default: break;
  }
  if constexpr (kMma) {
    switch (type) {
      case kLinear: linear_mma(P, a, smem); return;
      case kAttnPrefill: attn_rows(P, a, smem, kPrefillRows); return;
      case kAttnChunk: attn_rows(P, a, smem, kChunkRows); return;
      case kWriteKvPrefill: write_kv(P, a, kPrefillRows); return;
      case kWriteKvChunk: write_kv(P, a, kChunkRows); return;
      default: break;
    }
  } else if (type == kLinear) {
    switch (P.batch) {
      case 1: linear<1>(P, a, smem); return;
      case 2: linear<2>(P, a, smem); return;
      case 3: linear<3>(P, a, smem); return;
      case 4: linear<4>(P, a, smem); return;
      case 5: linear<5>(P, a, smem); return;
      case 6: linear<6>(P, a, smem); return;
      case 7: linear<7>(P, a, smem); return;
      default: linear<8>(P, a, smem); return;
    }
  }
  if (threadIdx.x == 0) fail(P, t, -1, -1);
}

// Wait (thread 0 only) until every predecessor of task t is done.
__device__ void wait_preds(const Params& P, int t, int claim) {
  const unsigned long long t0 = globaltimer();
  for (int e = P.pred_start[t]; e < P.pred_start[t + 1]; ++e) {
    const int p = P.preds[e];
    while (ld_acquire(P.flags + p) == 0) {
      if (globaltimer() - t0 > P.timeout_ns) fail(P, t, p, claim);
      __nanosleep(64);
    }
  }
}

template <bool kMma>
__global__ void __launch_bounds__(kThreads, 2) megakernel_kernel(const Params P) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  __shared__ int s_task;
  for (;;) {
    if (threadIdx.x == 0) {
      const int c = atomicAdd(P.counter, 1);
      int t = -1;
      if (c < P.n_claims) {
        t = P.claims[c];
        wait_preds(P, t, c);
      }
      s_task = t;
    }
    __syncthreads();
    const int t = s_task;
    if (t < 0) return;
    if (P.task_ns != nullptr && threadIdx.x == 0) P.task_ns[2 * t] = (long long)globaltimer();
    run_task<kMma>(P, t, smem);
    __syncthreads();
    if (threadIdx.x == 0) {
      if (P.task_ns != nullptr) P.task_ns[2 * t + 1] = (long long)globaltimer();
      __threadfence();
      st_release(P.flags + t, 1);
    }
  }
}

int* g_err_host = nullptr;   // mapped, so it stays readable after a trap
int* g_err_dev = nullptr;

cudaError_t ensure_error_record() {
  if (g_err_host != nullptr) return cudaSuccess;
  cudaError_t e = cudaHostAlloc(reinterpret_cast<void**>(&g_err_host), 4 * sizeof(int),
                                cudaHostAllocMapped);
  if (e != cudaSuccess) return e;
  memset(g_err_host, 0, 4 * sizeof(int));
  return cudaHostGetDevicePointer(reinterpret_cast<void**>(&g_err_dev), g_err_host, 0);
}

const void* kernel_for(bool mma) {
  return mma ? reinterpret_cast<const void*>(megakernel_kernel<true>)
             : reinterpret_cast<const void*>(megakernel_kernel<false>);
}

cudaError_t resident_blocks(int device, bool mma, int* out) {
  int sms = 0, per_sm = 0;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_for(mma), kThreads,
                                                    kSmemBytes);
  if (e != cudaSuccess) return e;
  *out = sms * per_sm;
  return cudaSuccess;
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers on `device`
// (int32 tables; `sync` holds 2 + n_tasks ints: the claim counter, the
// failure gate, then the done flags; `task_ns`, null or 2 * n_tasks
// int64, receives each task's start and end; `counts`, null for a dense
// build, the MoE build's int32 [rows][128] expert counters, rows >=
// batch); `stream` is a cudaStream_t. `moe_topk` experts are kept per
// row, renormalised when `moe_norm`.
// `batch` counts rows, `seq` the rows per slot of a batched prefill;
// `mma` = 1 launches the tensor-core instantiation (required for the
// prompt row modes and for more than kMaxB rows). Returns a cudaError_t
// code (0 = launched). The grid is every block that can be resident at
// once.
extern "C" int tdt_megakernel_bf16(void* arena, void* kpool, void* vpool, const void* tokens,
                                   const void* lens, const void* table, const void* claims,
                                   const void* types, const void* args, const void* pred_start,
                                   const void* preds, void* sync, void* task_ns, void* counts,
                                   int n_claims, int n_tasks, int batch, int seq, int w, int hd,
                                   int h_loc, int kv_loc, int num_pages, int page, int p_max,
                                   float rms_eps, float rope_theta, long long timeout_ns,
                                   int mma, int moe_topk, int moe_norm, int device,
                                   void* stream) {
  if (w != kW || hd != kHD || batch < 1 || seq < 1 || batch % seq || kv_loc < 1 ||
      h_loc % kv_loc || (!mma && batch > kMaxB) ||
      h_loc / kv_loc > kMaxRep || page < 1 || p_max < 1 || num_pages < 1 || n_tasks < 1 ||
      n_claims < 1 || timeout_ns <= 0 || moe_topk < 0 || moe_topk > kW ||
      (moe_topk > 0 && counts == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = ensure_error_record();
  if (e != cudaSuccess) return (int)e;
  int grid = 0;
  e = resident_blocks(device, mma != 0, &grid);
  if (e != cudaSuccess) return (int)e;
  if (grid < 1) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = cudaMemsetAsync(sync, 0, (size_t)(2 + n_tasks) * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  g_err_host[0] = 0;
  Params P;
  P.arena = static_cast<__nv_bfloat16*>(arena);
  P.kpool = static_cast<__nv_bfloat16*>(kpool);
  P.vpool = static_cast<__nv_bfloat16*>(vpool);
  P.tokens = static_cast<const int*>(tokens);
  P.lens = static_cast<const int*>(lens);
  P.table = static_cast<const int*>(table);
  P.claims = static_cast<const int*>(claims);
  P.types = static_cast<const int*>(types);
  P.args = static_cast<const int*>(args);
  P.pred_start = static_cast<const int*>(pred_start);
  P.preds = static_cast<const int*>(preds);
  P.counter = static_cast<int*>(sync);
  P.gate = static_cast<int*>(sync) + 1;
  P.flags = static_cast<int*>(sync) + 2;
  P.err = g_err_dev;
  P.task_ns = static_cast<long long*>(task_ns);
  P.counts = static_cast<int*>(counts);
  P.moe_topk = moe_topk;
  P.moe_norm = moe_norm;
  P.n_claims = n_claims;
  P.batch = batch;
  P.seq = seq;
  P.h_loc = h_loc;
  P.kv_loc = kv_loc;
  P.num_pages = num_pages;
  P.page = page;
  P.p_max = p_max;
  P.eps = rms_eps;
  P.theta = rope_theta;
  P.timeout_ns = (unsigned long long)timeout_ns;
  void* kargs[] = {&P};
  e = cudaLaunchCooperativeKernel(kernel_for(mma != 0), dim3(grid), dim3(kThreads), kargs,
                                  kSmemBytes, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The record of the last timed-out wait: out = [set, task, pred, claim];
// returns `set` (0: no wait timed out). Plain host memory: readable after
// the trap has cost the process its CUDA context.
extern "C" int tdt_megakernel_error(int* out) {
  if (g_err_host == nullptr) return 0;
  const volatile int* e = g_err_host;
  for (int i = 0; i < 4; ++i) out[i] = e[i];
  return out[0];
}

// Blocks in one launch of the decode (mma = 0) or tensor-core (mma = 1)
// instantiation on `device` (resident blocks per SM x SMs), or a negative
// cudaError_t.
extern "C" int tdt_megakernel_grid(int device, int mma) {
  int grid = 0;
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = resident_blocks(device, mma != 0, &grid);
  return e == cudaSuccess ? grid : -(int)e;
}

extern "C" int tdt_megakernel_smem_bytes() { return kSmemBytes; }

extern "C" const char* tdt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
