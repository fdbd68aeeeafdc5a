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
//   qblock  (WRITE_KV_QBLOCK / ATTN_QBLOCK)    slot r / K (seq = K drafted
//            candidates a slot), at max(lens[r], 0), writing iff
//            lens[r] >= 0 (kernels.py write_kv_qblock_body :956,
//            attn_qblock_body :1044: the speculative verify block)
//
// so one write body and one attention body serve all four. A Qwen3-MoE
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
// Quantized pools (kv_quant 1 = int8, 2 = fp8 e4m3; kernels.py
// _write_kv_body_quant :338, _attn_decode_body_quant :498 and the
// kv_quant branches of _attn_rowpos_body): the pools hold one byte per
// element and (layers, num_pages, kv) fp32 scale tables ride beside them.
// The write task quantizes token by token under a running max-abs scale
// per (layer, page, kv head), as _quant_store_token :129 does: a page's
// first position resets the scale; a token that grows it first rescales
// the page's stored codes by s_old / s_new. That update is serial within a
// (page, head) pair, so warp w owns the pairs of KV head w % kv and of the
// pages whose id is w / kv modulo kWarps / kv, and walks the rows in order:
// two warps never touch one scale, and a page takes its tokens in
// ascending position. Every attention read dequantizes (code * scale) as
// it loads. Rounding follows the plain version: x / scale (a division, not
// a reciprocal), int8 by rintf (half to even) clipped to +-127, fp8 clipped
// to +-448 and cast with __nv_cvt_float_to_fp8 (satfinite, to nearest).
// The rescale rereads and rewrites the page (page x 128 bytes) each time a
// token grows its scale, so a write task's worst case is slow.
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
// kernel is instantiated per (kMma, pool storage) (run_task<kMma, kQ>):
// the decode set with the CUDA-core LINEAR, and every ported type with the
// tensor-core one, each for bf16, int8 and fp8 pools, so no kernel shares
// its registers with paths it does not run (one kernel holding every
// storage's bodies spilled, and its bf16 512-row chunk took 10 % longer,
// measured in PERF.md §6). A verify launch (K rows a slot) is a prompt-mode
// launch: it runs the tensor-core LINEAR, where decode runs the CUDA-core
// one, so its logits differ from decode's by the order of the sums. Known
// slow points, measured in PERF.md and left for the redesign: the
// tensor-core LINEAR stages without pipelining and rereads its weight
// panel once per 64-row pass (no wgmma, no TMA), and attention is one
// task per layer run by one block, a serial point 36 times a launch whose
// work grows with rows x attended keys.
//
// Tensor-parallel builds (n_ranks = n > 1; builder.py ModelBuilder with a
// mesh) run n simulated ranks in ONE cooperative launch: block b belongs to
// rank b / blocks_per_rank (occupancy x SMs / n blocks a rank, so every
// rank's blocks are resident together) and runs that rank's copy of the
// claim list on that rank's arena slice (the arena is n slices of
// arena_rows rows) with its own claim counter and done flags; its KV heads
// are heads [r * kv_loc, (r + 1) * kv_loc) of pools that hold all kv_tot =
// n * kv_loc heads. GATHER reads the rank's vocabulary shard (token - r *
// vocab_loc). The ALLREDUCE task replaces kernels.py allreduce_body (:719,
// the TPU kernel's one-shot in-kernel allreduce of an arena slab across the
// tp axis; ModelBuilder's third arg is its ordinal k among the launch's
// ALLREDUCE tasks). Rank me's task:
//
//   1. waits until every peer has finished reading its ar_ws slots of
//      ALLREDUCE k - 1 (their done flags of ordinal k - 1): 2L + 1 tasks
//      share one ar_ws, so without this a fast rank's put could overwrite
//      a slot that a slow rank still reads (the TPU kernel's opening
//      barrier_all, kernels.py:742);
//   2. stores its slab (ar_tiles (batch, 128) tiles at buf_off) with
//      16-byte stores into slot me of every peer's ar_ws, then releases one
//      arrival flag per peer;
//   3. acquire-waits for the n - 1 arrivals into its own ar_ws;
//   4. sums in fp32 its own slab first, then its peers' me+1, me+2, ...
//      mod n (the JAX body's order, different on every rank), stores the
//      sum in bf16 over its slab, and releases its done flag of ordinal k.
//
// The flags are 64-bit epoch words of a persistent workspace, never
// cleared (shmem_device.cuh: per ordinal k, n x n arrival flags
// [receiver][sender] then n done flags): each launch takes a new epoch.
// The launch stays deadlock-free: the builder pins ALLREDUCE to core 0,
// every rank claims its tasks in one topological order, and the ALLREDUCE
// tasks form a chain on every rank, so the rank whose oldest unfinished
// task is the lowest ALLREDUCE finds every peer at or past it. A wait past
// timeout_ns records (rank, task, flag slot, epoch) in host-mapped memory
// and raises the workspace's abort word: every wait of the launch (the
// ALLREDUCE waits and, at n > 1, the waits on predecessors) then gives up,
// the launch ends, and the host raises CommTimeoutError naming the task.
// What bounds it: bytes. Each rank moves (n - 1) slabs out and reads n in,
// 32 KB a slab at decode (4 rows x 4096) and 1 MB for a 128-row chunk; one
// block per rank does it all, so a chunk's ALLREDUCE runs at one SM's copy
// rate, not the card's.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <type_traits>

#include "shmem_device.cuh"

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
  kAttnQblock = 14, kWriteKvQblock = 15, kAttnChunk = 16, kWriteKvChunk = 17,
};

// How a cache task maps its rows to (slot, position, writes).
enum RowMode : int { kDecodeRows = 0, kPrefillRows = 1, kChunkRows = 2, kQblockRows = 3 };

// Pool storage: the arena's bf16, or a quantized pool with scale tables.
enum KvQuant : int { kKvBf16 = 0, kKvInt8 = 1, kKvFp8 = 2 };

struct Params {
  __nv_bfloat16* arena;
  void* kpool;         // bf16, int8 or fp8 by kv_quant
  void* vpool;
  float* kscale;       // quantized pools: [layers][num_pages][kv] fp32
  float* vscale;
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
  int kv_quant;        // KvQuant
  float qmax;          // 127 (int8) or 448 (fp8)
  float eps, theta;
  unsigned long long timeout_ns;
  // Tensor-parallel ranks: this block's rank, the blocks of one rank, one
  // rank's arena rows (the arena holds n slices), rank 0's arena, the KV
  // heads of a pool row, and the ALLREDUCE workspace (ar_tiles tiles a
  // slot at row ar_ws_off) with its flags (tdt::Sync: flags, abort word,
  // error record, this launch's epoch, the wait bound).
  int n_ranks, rank, blocks_per_rank, kv_tot, n_tasks;
  long long arena_rows;
  __nv_bfloat16* arena0;
  int ar_ws_off, ar_tiles;
  tdt::Sync ar;
  int fault, fault_rank, fault_ar;   // planted ALLREDUCE faults (builder.py)
};

// Planted faults of the ALLREDUCE task (builder.py AR_FAULTS).
enum ArFault : int { kArLostSignal = 1, kArWrongSlot = 2 };

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

// Page id of KV position `pos` of `slot`'s table row.
__device__ __forceinline__ int page_of(const Params& P, int slot, int pos) {
  const int pi = min(pos / P.page, P.p_max - 1);
  return __ldg(P.table + (size_t)slot * P.p_max + pi);
}

// Pool row (layer, page pid, in-page offset off, KV head g), in elements.
__device__ __forceinline__ size_t pool_row(const Params& P, int layer, int pid, int off,
                                           int g) {
  return ((((size_t)layer * P.num_pages + pid) * P.page + off) * P.kv_tot + g) * kHD;
}

// Pool row (layer, KV position `pos` of `slot`'s table row, KV head g).
__device__ __forceinline__ size_t pool_off(const Params& P, int layer, int slot, int pos,
                                           int g) {
  return pool_row(P, layer, page_of(P, slot, pos), pos % P.page, g);
}

// Scale-table index of (layer, page pid, KV head g).
__device__ __forceinline__ size_t scale_idx(const Params& P, int layer, int pid, int g) {
  return ((size_t)layer * P.num_pages + pid) * P.kv_tot + g;
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
  } else if (mode == kQblockRows) {
    x.slot = r / P.seq;
    x.pos = max(v, 0);
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

// GATHER (table_off, out_off, d_tiles, vocab_loc): each row's embedding
// from the rank's vocabulary shard, zeros for a token outside it.
__device__ void gather(const Params& P, const int* a) {
  const int table_off = a[0], out_off = a[1], dt = a[2], vocab = a[3];
  const int b = P.batch, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int bb = warp; bb < b; bb += kWarps) {
    const int tok = P.tokens[bb] - P.rank * vocab;
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
    store4(static_cast<__nv_bfloat16*>(P.kpool) + off, k);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(P.vpool) + off) =
        __ldcg(reinterpret_cast<const uint2*>(arow(P, v_off + (long long)g * b + bb) +
                                              lane * 4));
  }
}

// One byte of a quantized pool, as fp32 and from fp32 (the cast of
// kernels.py _quant_cast: int8 rounds half to even and clips; fp8 clips,
// then rounds to nearest).
__device__ __forceinline__ float code_f32(int8_t c) { return (float)c; }
__device__ __forceinline__ float code_f32(__nv_fp8_e4m3 c) { return static_cast<float>(c); }

template <typename T>
__device__ __forceinline__ T quant_cast(float x, float qmax);
template <>
__device__ __forceinline__ int8_t quant_cast<int8_t>(float x, float qmax) {
  return (int8_t)(int)fminf(fmaxf(rintf(x), -qmax), qmax);
}
template <>
__device__ __forceinline__ __nv_fp8_e4m3 quant_cast<__nv_fp8_e4m3>(float x, float qmax) {
  __nv_fp8_e4m3 r;
  r.__x = __nv_cvt_float_to_fp8(fminf(fmaxf(x, -qmax), qmax), __NV_SATFINITE, __NV_E4M3);
  return r;
}

// Four consecutive codes (4-byte aligned) as fp32.
template <typename T>
__device__ __forceinline__ void unpack_codes(uint32_t w, float (&f)[4]) {
  const T* c = reinterpret_cast<const T*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = code_f32(c[i]);
}

template <typename T>
__device__ __forceinline__ uint32_t pack_codes(const float (&f)[4], float qmax) {
  uint32_t w;
  T* c = reinterpret_cast<T*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] = quant_cast<T>(f[i], qmax);
  return w;
}

// One token's 128-dim row x (4 dims per lane) into quantized page pid at
// offset off, KV head g, under the running scale s (in: the page's scale
// before this token, out: after). kernels.py _quant_store_token: the
// page's first position resets the scale; a grown scale first rescales
// the page's codes by s_old / s_new. Lane l only ever reads and writes
// dims [4l, 4l + 4) of the page, so the warp needs no barrier for them.
template <typename T>
__device__ void quant_store(const Params& P, T* pool, int layer, int pid, int off, int g,
                            const float (&x)[4], float& s) {
  const int lane = threadIdx.x % 32;
  float am = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) am = fmaxf(am, fabsf(x[i]));
  am = warp_max(am);
  const float s_old = s;
  const float s_tok = am > 0.f ? am / P.qmax : 0.f;
  const float s_new = off == 0 ? (am > 0.f ? am / P.qmax : 1.f) : fmaxf(s_old, s_tok);
  if (off != 0 && s_new > s_old) {
    const float ratio = s_old / s_new;
    for (int p = 0; p < P.page; ++p) {
      uint32_t* cw = reinterpret_cast<uint32_t*>(pool + pool_row(P, layer, pid, p, g) + lane * 4);
      float c[4];
      unpack_codes<T>(__ldcg(cw), c);
#pragma unroll
      for (int i = 0; i < 4; ++i) c[i] *= ratio;
      *cw = pack_codes<T>(c, P.qmax);
    }
  }
  float y[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) y[i] = x[i] / s_new;
  *reinterpret_cast<uint32_t*>(pool + pool_row(P, layer, pid, off, g) + lane * 4) =
      pack_codes<T>(y, P.qmax);
  s = s_new;
}

// WRITE_KV* on a quantized pool: the same k-norm and rope as write_kv,
// then quant_store of K and V. Warp w walks the rows in order for its
// (KV head, page bucket) units (the header's ownership rule), keeping the
// running scale of its current page in registers; lane 0 stores it.
template <typename T>
__device__ void write_kv_quant(const Params& P, const int* a, RowMode mode) {
  const int k_off = a[0], v_off = a[1], layer = a[2], kn_off = a[3];
  const int b = P.batch, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int buckets = max(1, kWarps / P.kv_loc);
  T* kpool = static_cast<T*>(P.kpool);
  T* vpool = static_cast<T*>(P.vpool);
  for (int unit = warp; unit < P.kv_loc * buckets; unit += kWarps) {
    const int g = unit % P.kv_loc, bucket = unit / P.kv_loc;
    int cur = -1;
    float ks = 0.f, vs = 0.f;
    for (int bb = 0; bb < b; ++bb) {
      const Row row = row_at(P, mode, bb);
      if (!row.writes) continue;
      const int pid = page_of(P, row.slot, row.pos);
      if (pid % buckets != bucket) continue;
      const size_t si = scale_idx(P, layer, pid, g);
      if (pid != cur) {
        cur = pid;
        ks = __ldcg(P.kscale + si);
        vs = __ldcg(P.vscale + si);
      }
      float k[4], v[4];
      load4_cg(arow(P, k_off + (long long)g * b + bb) + lane * 4, k);
      load4_cg(arow(P, v_off + (long long)g * b + bb) + lane * 4, v);
      norm_rope(P, k, arow(P, kn_off), row.pos);
      const int off = row.pos % P.page;
      quant_store<T>(P, kpool, layer, pid, off, g, k, ks);
      quant_store<T>(P, vpool, layer, pid, off, g, v, vs);
      if (lane == 0) {
        P.kscale[si] = ks;
        P.vscale[si] = vs;
      }
    }
  }
}

// ATTN_DECODE / ATTN_PREFILL / ATTN_CHUNK (q_off, out_off, layer,
// q_norm_off): warp per (row, KV head), carrying the rep query heads of
// that KV head (q-norm, rope at the row's position, 1/sqrt(hd)) in shared
// memory. Online softmax over the row's position + 1 keys of its slot in
// 32-key steps, lane t scoring key kbase + t; for P.V lane owns output
// dims [4 * lane, 4 * lane + 4). Keeps the -inf guards and
// max(l, 1e-30) of the JAX body.
//
// T is the pool's storage: __nv_bfloat16, or int8_t / __nv_fp8_e4m3 for a
// quantized pool, whose K and V elements are dequantized (code * the
// page's scale for head g) as they are loaded.
template <typename T>
__device__ void attn_rows(const Params& P, const int* a, float* smem, RowMode mode) {
  constexpr bool kQuant = sizeof(T) == 1;
  const int q_off = a[0], out_off = a[1], layer = a[2], qn_off = a[3];
  const int b = P.batch, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rep = P.h_loc / P.kv_loc;
  const T* kpool = static_cast<const T*>(P.kpool);
  const T* vpool = static_cast<const T*>(P.vpool);
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
      float vsl = 0.f;                 // quantized: V scale of this lane's key
      if (key < n_keys) {
        const int pid = page_of(P, slot, key);
        const uint4* kp =
            reinterpret_cast<const uint4*>(kpool + pool_row(P, layer, pid, key % P.page, g));
        if constexpr (kQuant) {
          const size_t si = scale_idx(P, layer, pid, g);
          const float ksl = __ldcg(P.kscale + si);
          vsl = __ldcg(P.vscale + si);
#pragma unroll 2
          for (int c = 0; c < kHD / 16; ++c) {
            const uint4 u = __ldcg(kp + c);
            const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
            for (int h = 0; h < 4; ++h) {
              float kf[4];
              unpack_codes<T>(w[h], kf);
#pragma unroll
              for (int e = 0; e < 4; ++e) kf[e] *= ksl;
#pragma unroll
              for (int r = 0; r < kMaxRep; ++r) {
                if (r < rep) {
#pragma unroll
                  for (int e = 0; e < 4; ++e)
                    s[r] = fmaf(qs[r * kHD + c * 16 + h * 4 + e], kf[e], s[r]);
                }
              }
            }
          }
        } else {
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
        // bf16: 4 values are a uint2; quantized: 4 codes are one uint32.
        using VV = typename std::conditional<kQuant, uint32_t, uint2>::type;
        VV vv[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          vv[u] = t0 + u < t_end
                      ? __ldcg(reinterpret_cast<const VV*>(
                            vpool + pool_off(P, layer, slot, kbase + t0 + u, g) + lane * 4))
                      : VV{};
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          float v[4];
          if constexpr (kQuant) {
            unpack_codes<T>(vv[u], v);
            const float vs = __shfl_sync(kFull, vsl, t0 + u);
#pragma unroll
            for (int i = 0; i < 4; ++i) v[i] *= vs;
          } else {
            unpack4(vv[u], v);
          }
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

// Whether a wait of this launch timed out (n > 1: the ALLREDUCE
// workspace's abort word holds the epoch).
__device__ __forceinline__ bool aborted(const Params& P) {
  return P.n_ranks > 1 && tdt::ld_acquire(P.ar.abort) >= P.ar.epoch;
}

// One thread: wait for ALLREDUCE flag `slot` of this launch; false when a
// wait of the launch gave up.
__device__ __forceinline__ bool ar_wait(const Params& P, long long slot, int t) {
  return tdt::signal_wait_until(P.ar, slot, P.rank, t);
}

// ALLREDUCE (buf_off, tiles, k) at n > 1 (see the top of the file); a no-op
// at one rank. Returns false when the launch aborted.
__device__ bool allreduce(const Params& P, const int* a, int t) {
  const int n = P.n_ranks;
  if (n == 1) return true;
  const int me = P.rank, k = a[2];
  const long long rows = (long long)P.ar_tiles * P.batch;
  const long long per_k = (long long)n * n + n;
  const long long arrive = k * per_k, done = arrive + (long long)n * n;
  __shared__ int ok;
  // 1. Every peer has read its slots of ALLREDUCE k - 1.
  if (threadIdx.x == 0) {
    bool all = true;
    for (int off = 1; off < n && all && k > 0; ++off)
      all = ar_wait(P, done - per_k + (me + off) % n, t);
    ok = all;
  }
  __syncthreads();
  if (!ok) return false;
  // 2. Slot me (or, planted, slot me + 1) of every peer's ar_ws.
  const bool faulty = P.fault != 0 && me == P.fault_rank && k == P.fault_ar;
  const int slot = faulty && P.fault == kArWrongSlot ? (me + 1) % n : me;
  const __nv_bfloat16* src = arow(P, a[0]);
  const int vecs = (int)(rows * (kW / 8));
  for (int off = 1; off < n; ++off) {
    const int peer = (me + off) % n;
    __nv_bfloat16* dst = P.arena0 + ((size_t)peer * P.arena_rows + P.ar_ws_off +
                                     (size_t)slot * rows) * kW;
    for (int i = threadIdx.x; i < vecs; i += kThreads)
      reinterpret_cast<uint4*>(dst)[i] = __ldcg(reinterpret_cast<const uint4*>(src) + i);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int off = 1; off < n; ++off) {
      const int peer = (me + off) % n;
      if (faulty && P.fault == kArLostSignal && peer == (me + 1) % n) continue;
      tdt::st_release(P.ar.flags + arrive + (long long)peer * n + me, P.ar.epoch);
    }
  }
  // 3. The n - 1 arrivals into this rank's ar_ws.
  if (threadIdx.x == 0) {
    bool all = true;
    for (int off = 1; off < n && all; ++off)
      all = ar_wait(P, arrive + (long long)me * n + (me + off) % n, t);
    __threadfence();
    ok = all;
  }
  __syncthreads();
  if (!ok) return false;
  // 4. own + peers me+1, me+2, ... in fp32, stored in bf16 over the slab.
  __nv_bfloat16* buf = arow(P, a[0]);
  const __nv_bfloat16* ws = arow(P, P.ar_ws_off);
  for (int i = threadIdx.x; i < vecs; i += kThreads) {
    float acc[8], x[8];
    unpack8(__ldcg(reinterpret_cast<const uint4*>(buf) + i), acc);
    for (int off = 1; off < n; ++off) {
      const int peer = (me + off) % n;
      unpack8(__ldcg(reinterpret_cast<const uint4*>(ws + (size_t)peer * rows * kW) + i), x);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] += x[e];
    }
    reinterpret_cast<uint4*>(buf)[i] = make_uint4(pack2(acc[0], acc[1]), pack2(acc[2], acc[3]),
                                                  pack2(acc[4], acc[5]), pack2(acc[6], acc[7]));
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) tdt::st_release(P.ar.flags + done + me, P.ar.epoch);
  return true;
}

// A cache task's body for the pools' storage: each kernel instantiation
// holds the bodies of one storage type (kQ, a KvQuant), so the quantized
// bodies never share a register allocation with the bf16 ones.
template <int kQ>
__device__ void attn_task(const Params& P, const int* a, float* smem, RowMode mode) {
  if constexpr (kQ == kKvInt8) {
    attn_rows<int8_t>(P, a, smem, mode);
  } else if constexpr (kQ == kKvFp8) {
    attn_rows<__nv_fp8_e4m3>(P, a, smem, mode);
  } else {
    attn_rows<__nv_bfloat16>(P, a, smem, mode);
  }
}

template <int kQ>
__device__ void write_task(const Params& P, const int* a, RowMode mode) {
  if constexpr (kQ == kKvInt8) {
    write_kv_quant<int8_t>(P, a, mode);
  } else if constexpr (kQ == kKvFp8) {
    write_kv_quant<__nv_fp8_e4m3>(P, a, mode);
  } else {
    write_kv(P, a, mode);
  }
}

// The task bodies of one launch. Instantiated per (kMma, kQ): kMma = false
// is the decode kernel (the decode task set, LINEAR on CUDA cores for <=
// kMaxB rows); kMma = true runs every ported type, LINEAR on tensor cores
// for any row count (the prompt and Q-block modes, or decode past kMaxB
// rows). kQ is the pools' storage (batched prefill only on bf16 pools: the
// builder refuses a quantized prefill build). Keeping the tensor-core body,
// the prompt row rules and the quantized bodies out of the bf16 decode
// kernel keeps its register allocation that of the decode set alone.
template <bool kMma, int kQ>
__device__ void run_task(const Params& P, int t, float* smem) {
  const int* a = P.args + (size_t)t * 8;
  const int type = P.types[t];
  switch (type) {
    case kRmsNorm: rmsnorm(P, a); return;
    case kAdd: elementwise(P, a, false); return;
    case kSiluMul: elementwise(P, a, true); return;
    case kAttnDecode: attn_task<kQ>(P, a, smem, kDecodeRows); return;
    case kWriteKv: write_task<kQ>(P, a, kDecodeRows); return;
    case kGather: gather(P, a); return;
    case kMoeWeights: moe_weights(P, a); return;
    case kWeightedAdd: weighted_add(P, a); return;
    case kAllreduce:     // run by the kernel's loop (it may abort)
    case kNoop: return;
    default: break;
  }
  if constexpr (kMma) {
    switch (type) {
      case kLinear: linear_mma(P, a, smem); return;
      case kAttnChunk: attn_task<kQ>(P, a, smem, kChunkRows); return;
      case kWriteKvChunk: write_task<kQ>(P, a, kChunkRows); return;
      case kAttnQblock: attn_task<kQ>(P, a, smem, kQblockRows); return;
      case kWriteKvQblock: write_task<kQ>(P, a, kQblockRows); return;
      default: break;
    }
    if constexpr (kQ == kKvBf16) {
      switch (type) {
        case kAttnPrefill: attn_rows<__nv_bfloat16>(P, a, smem, kPrefillRows); return;
        case kWriteKvPrefill: write_kv(P, a, kPrefillRows); return;
        default: break;
      }
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

// Wait (thread 0 only) until every predecessor of task t is done; false
// when the launch aborted (n > 1) while it waited. Past timeout_ns (twice
// that at n > 1, where an ALLREDUCE's own bounded wait should report first)
// it traps.
__device__ bool wait_preds(const Params& P, int t, int claim) {
  const unsigned long long t0 = globaltimer();
  const unsigned long long bound = P.n_ranks > 1 ? 2 * P.timeout_ns : P.timeout_ns;
  for (int e = P.pred_start[t]; e < P.pred_start[t + 1]; ++e) {
    const int p = P.preds[e];
    while (ld_acquire(P.flags + p) == 0) {
      if (aborted(P)) return false;
      if (globaltimer() - t0 > bound) fail(P, t, p, claim);
      __nanosleep(64);
    }
  }
  return true;
}

// Block b runs rank b / blocks_per_rank: its arena slice, its KV heads, its
// claim counter and done flags (sync holds 2 + n_tasks ints a rank), its
// task times.
__device__ __forceinline__ Params rank_params(const Params& P0) {
  const int n_tasks = P0.n_tasks;
  Params P = P0;
  if (P0.n_ranks > 1) {
    const int r = blockIdx.x / P0.blocks_per_rank;
    P.rank = r;
    P.arena = P0.arena0 + (size_t)r * P0.arena_rows * kW;
    const size_t heads = (size_t)r * P0.kv_loc * kHD;
    P.kpool = static_cast<__nv_bfloat16*>(P0.kpool) + heads;
    P.vpool = static_cast<__nv_bfloat16*>(P0.vpool) + heads;
    P.counter = P0.counter + (size_t)r * (2 + n_tasks);
    P.gate = P.counter + 1;
    P.flags = P.counter + 2;
    if (P0.task_ns != nullptr) P.task_ns = P0.task_ns + (size_t)r * 2 * n_tasks;
  }
  return P;
}

template <bool kMma, int kQ>
__global__ void __launch_bounds__(kThreads, 2) megakernel_kernel(const Params P0) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  __shared__ int s_task;
  const Params P = rank_params(P0);
  for (;;) {
    if (threadIdx.x == 0) {
      const int c = atomicAdd(P.counter, 1);
      int t = -1;
      if (c < P.n_claims) {
        t = P.claims[c];
        if (!wait_preds(P, t, c)) t = -1;
      }
      s_task = t;
    }
    __syncthreads();
    const int t = s_task;
    if (t < 0) return;
    if (P.task_ns != nullptr && threadIdx.x == 0) P.task_ns[2 * t] = (long long)globaltimer();
    bool ok = true;                  // false: an ALLREDUCE wait gave up
    if (P.types[t] == kAllreduce)
      ok = allreduce(P, P.args + (size_t)t * 8, t);
    else
      run_task<kMma, kQ>(P, t, smem);
    __syncthreads();
    if (!ok) return;
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

const void* kernel_for(bool mma, int kv_quant) {
  static const void* const kernels[2][3] = {
      {reinterpret_cast<const void*>(megakernel_kernel<false, kKvBf16>),
       reinterpret_cast<const void*>(megakernel_kernel<false, kKvInt8>),
       reinterpret_cast<const void*>(megakernel_kernel<false, kKvFp8>)},
      {reinterpret_cast<const void*>(megakernel_kernel<true, kKvBf16>),
       reinterpret_cast<const void*>(megakernel_kernel<true, kKvInt8>),
       reinterpret_cast<const void*>(megakernel_kernel<true, kKvFp8>)}};
  return kernels[mma ? 1 : 0][kv_quant];
}

cudaError_t resident_blocks(int device, bool mma, int kv_quant, int* out) {
  int sms = 0, per_sm = 0;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_for(mma, kv_quant),
                                                    kThreads, kSmemBytes);
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
// row, renormalised when `moe_norm`. `kv_quant` (0 bf16, 1 int8, 2 fp8)
// is the pools' storage; a quantized pool comes with its fp32 (layers,
// num_pages, kv) `kscale` / `vscale` tables and `qmax` (127 or 448).
// `batch` counts rows, `seq` the rows per slot of a batched prefill;
// `mma` = 1 launches the tensor-core instantiation (required for the
// prompt row modes and for more than kMaxB rows). `n_ranks` > 1 runs that
// many simulated tensor-parallel ranks (arena: n slices of `arena_rows`
// rows; pools of `kv_tot` = n * kv_loc heads; `sync`: 2 + n_tasks ints a
// rank; `task_ns`: n_tasks x 2 a rank) with the ALLREDUCE workspace's
// flags `ar_flags` (n_allreduce x (n * n + n) u64), abort word `ar_abort`
// and this launch's `epoch`; `fault` (0, or ArFault) is planted into
// rank `fault_rank`'s ALLREDUCE of ordinal `fault_ar`. Returns a
// cudaError_t code (0 = launched). The grid is every block that can be
// resident at once, rounded down to a multiple of n_ranks.
extern "C" int tdt_megakernel_bf16(void* arena, void* kpool, void* vpool, const void* tokens,
                                   const void* lens, const void* table, const void* claims,
                                   const void* types, const void* args, const void* pred_start,
                                   const void* preds, void* sync, void* task_ns, void* counts,
                                   int n_claims, int n_tasks, int batch, int seq, int w, int hd,
                                   int h_loc, int kv_loc, int num_pages, int page, int p_max,
                                   float rms_eps, float rope_theta, long long timeout_ns,
                                   int mma, int moe_topk, int moe_norm, void* kscale,
                                   void* vscale, int kv_quant, float qmax, int n_ranks,
                                   int ar_ws_off, int ar_tiles, int kv_tot, int fault,
                                   long long arena_rows, void* ar_flags, void* ar_abort,
                                   unsigned long long epoch, int fault_rank, int fault_ar,
                                   int n_allreduce, int device, void* stream) {
  if (w != kW || hd != kHD || batch < 1 || seq < 1 || batch % seq || kv_loc < 1 ||
      h_loc % kv_loc || (!mma && batch > kMaxB) ||
      h_loc / kv_loc > kMaxRep || page < 1 || p_max < 1 || num_pages < 1 || n_tasks < 1 ||
      n_claims < 1 || timeout_ns <= 0 || moe_topk < 0 || moe_topk > kW ||
      (moe_topk > 0 && counts == nullptr) || kv_quant < kKvBf16 || kv_quant > kKvFp8 ||
      (kv_quant != kKvBf16 && (kscale == nullptr || vscale == nullptr || !(qmax > 0.f))) ||
      n_ranks < 1 || kv_tot != n_ranks * kv_loc ||
      (n_ranks > 1 && (kv_quant != kKvBf16 || moe_topk > 0 || ar_flags == nullptr ||
                       ar_abort == nullptr || epoch == 0 || ar_tiles < 1 || n_allreduce < 1 ||
                       fault < 0 || fault > kArWrongSlot)))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = ensure_error_record();
  if (e != cudaSuccess) return (int)e;
  if (n_ranks > 1) {
    e = tdt::ensure_error_record();
    if (e != cudaSuccess) return (int)e;
  }
  int grid = 0;
  e = resident_blocks(device, mma != 0, kv_quant, &grid);
  if (e != cudaSuccess) return (int)e;
  // Every rank gets the same share of the blocks that fit at once.
  const int per_rank = grid / n_ranks;
  if (per_rank < 1) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = cudaMemsetAsync(sync, 0, (size_t)n_ranks * (2 + n_tasks) * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  g_err_host[0] = 0;
  Params P;
  P.n_ranks = n_ranks;
  P.rank = 0;
  P.blocks_per_rank = per_rank;
  P.kv_tot = kv_tot;
  P.n_tasks = n_tasks;
  P.arena_rows = arena_rows;
  P.arena0 = static_cast<__nv_bfloat16*>(arena);
  P.ar_ws_off = ar_ws_off;
  P.ar_tiles = ar_tiles;
  P.ar.flags = static_cast<tdt::u64*>(ar_flags);
  P.ar.abort = static_cast<tdt::u64*>(ar_abort);
  P.ar.err = tdt::g_err_dev;
  P.ar.epoch = epoch;
  P.ar.timeout_ns = (unsigned long long)timeout_ns;
  P.fault = fault;
  P.fault_rank = fault_rank;
  P.fault_ar = fault_ar;
  P.arena = static_cast<__nv_bfloat16*>(arena);
  P.kpool = kpool;
  P.vpool = vpool;
  P.kscale = static_cast<float*>(kscale);
  P.vscale = static_cast<float*>(vscale);
  P.kv_quant = kv_quant;
  P.qmax = qmax;
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
  e = cudaLaunchCooperativeKernel(kernel_for(mma != 0, kv_quant), dim3(per_rank * n_ranks),
                                  dim3(kThreads), kargs, kSmemBytes, s);
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
  if (e == cudaSuccess) e = resident_blocks(device, mma != 0, kKvBf16, &grid);
  return e == cudaSuccess ? grid : -(int)e;
}

extern "C" int tdt_megakernel_smem_bytes() { return kSmemBytes; }
