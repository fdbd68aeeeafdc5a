// Fused all-gather + grouped expert GEMM across simulated tensor-parallel
// ranks on Hopper (sm_90a): bf16 in and out, fp32 sums.
//
// ag_moe_kernel replaces triton_dist_tpu/ops/ag_moe.py _ag_moe_kernel (:161,
// ag_group_gemm at n > 1). Every rank holds its top-k-replicated tokens
// sorted expert-major with each expert's segment padded to the row tile tm
// (ag_moe.prepare_grouped_tokens): chunk c = x[c] (s_loc x d), whose row tile
// i belongs to expert te[c][i]. Rank r holds the ffn shard of every expert's
// gate and up weight (rows [r * f0, (r + 1) * f0) of each (E, f, d) weight,
// strided views of the one weight) and computes
//
//   out[r][c * s_loc + row] = x[c][row] . [Wg_r[e] ; Wu_r[e]]^T,  e = te[c][row / tm]
//
// gate columns [0, f0) first, then up columns [f0, f0 + f1): the layout of
// JAX's concatenated w_gu, with no concatenated copy. The ring is AG+GEMM's
// (ag_gemm.cu, row 7): at step k rank r computes chunk c = (r - k) mod n (its
// own chunk at step 0, read from its input) and forwards the chunk it holds
// for step k to rank r + 1 (remote_put into ws[r + 1], then a signal) for
// k = 0 .. n - 2, before computing on it. A row block waits only for its own
// rows' flag. The per-tile B operand is the only change: each row block
// reads its expert from te and that expert's rows of the two shards.
//
// Padding: a row tile at or past used[c] (the tiles of chunk c that hold a
// real row; the rest are the sorted layout's tail) holds only zero rows, so
// its product is zero: it is neither forwarded nor multiplied, and its
// output rows are stored as zeros (what the product gives). At Qwen3-30B-A3B
// tp = 4 over 512 tokens a rank, about half of the 8,064 rows of a chunk
// are such a tail.
//
// Work items, in the order every block walks them (each waits only on a
// lower-numbered item, see shmem_device.cuh): for each step k, the forward
// items (r, row block) of step k, then the tile items (r, row block, column
// block) of step k.
//
// What bounds it on the H100: operations, at Qwen3-30B-A3B tp = 4 over
// 512 tokens a rank, 2 x 32,256 rows x 2048 x 384 per rank, 2.0e11 in all
// (0.205 ms at 989 TFLOP/s) against 0.80 GB of gate/up shards and 0.53 GB
// of gathered tokens (0.40 ms at 3.35 TB/s, so bytes, counting each input
// once). This first design reads each expert's shard once per ring step
// (n times) and runs the wmma tile GEMM of tile_gemm.cuh at row tiles of
// 16, 32 or 64 (the MoE tile or a piece of it): no wgmma, no TMA (PERF.md).

#include "shmem_device.cuh"
#include "tile_gemm.cuh"

namespace {

using namespace tdt;

enum Fault { kNoFault = 0, kWrongChunk = 1, kLostSignal = 2 };

// Row blocks by the MoE row tile: tm <= 16 (a short prompt's cap), tm <= 32,
// and larger tiles in pieces of 64. Four warps each.
typedef Tile<16, 64, 16, 16, 4> Moe16;
typedef Tile<32, 128, 32, 32, 3> Moe32;
typedef Tile<64, 128, 32, 64, 3> Moe64;

struct Params {
  const bf16* x;   // (n, s_loc, d): every rank's sorted tokens
  const bf16* wg;  // gate shard of rank r, expert e: wg + r * g_rank + e * g_e, rows g_row apart
  const bf16* wu;  // up shard, the same way (f1 rows)
  const int* te;   // (n, n_i): the tile -> expert map of every chunk
  const int* used; // (n,): leading tiles of each chunk that hold a real row
  bf16* out;       // (n, n * s_loc, f0 + f1)
  bf16* ws;        // (n, n * s_loc, d): the gather buffer
  long long g_rank, g_e, g_row, u_rank, u_e, u_row;
  int n, s_loc, d, E, f0, f1, tm, rb, n_i, n_rb, n_cb, fault;
  Sync sync;
};

// Flag of row block i of chunk c in rank r's gather buffer.
__device__ __forceinline__ long long flag_of(const Params& P, int r, int c, int i) {
  return ((long long)r * P.n + c) * P.n_rb + i;
}

__device__ __forceinline__ bool padding(const Params& P, int c, int i) {
  return (i * P.rb) / P.tm >= P.used[c];
}

// Row rr of the B tile at column block c0: a gate row, then up rows.
struct GateUpRows {
  const bf16* g;
  const bf16* u;
  long long g_row, u_row;
  int f0, c0;
  __device__ __forceinline__ const bf16* operator()(int rr) const {
    const int c = c0 + rr;
    return c < f0 ? g + c * g_row : u + (c - f0) * u_row;
  }
};

// Rank r's forward of row block i at step k (k < n - 1).
__device__ void forward_item(const Params& P, int k, int r, int i) {
  const int n = P.n, c = ((r - k) % n + n) % n;
  if (padding(P, c, i)) return;   // zero rows: nobody waits for them
  const long long d = P.d, chunk_rows = (long long)n * P.s_loc;
  const bf16* src = P.x + ((long long)r * P.s_loc + (long long)i * P.rb) * d;
  if (k > 0) {
    wait_arrivals(P.sync, flag_of(P, r, c, i), 0, 1, r, k);
    if (P.fault != kWrongChunk)
      src = P.ws + (r * chunk_rows + (long long)c * P.s_loc + (long long)i * P.rb) * d;
  }
  const int right = (r + 1) % n;
  remote_put(P.ws + (right * chunk_rows + (long long)c * P.s_loc + (long long)i * P.rb) * d, d,
             src, d, P.rb, P.d);
  if (P.fault == kLostSignal && r == 0 && k == 0 && i == 0) return;
  signal_block(P.sync, flag_of(P, right, c, i));
}

// Rank r's output tile (row block i of chunk c, column block j) at step k.
template <class T>
__device__ void tile_item(const Params& P, int k, int r, int i, int j, unsigned char* smem) {
  const int n = P.n, c = ((r - k) % n + n) % n, N = P.f0 + P.f1;
  const long long d = P.d, chunk_rows = (long long)n * P.s_loc;
  const long long row0 = (long long)c * P.s_loc + (long long)i * P.rb;
  const int cols = min(T::BN, N - j * T::BN);
  bf16* o = P.out + (r * chunk_rows + row0) * N + (long long)j * T::BN;
  const bool pad = padding(P, c, i);
  const int e = pad ? 0 : P.te[(long long)c * P.n_i + (i * P.rb) / P.tm];
  if (pad || e < 0 || e >= P.E) {
    // Padding rows: their product is zero. A corrupt map: NaN, visibly.
    const bf16 v = __float2bfloat16(pad ? 0.f : __int_as_float(0x7fc00000));
    for (int t = threadIdx.x; t < P.rb * cols; t += T::kThreads) o[(t / cols) * N + t % cols] = v;
    return;
  }
  const bf16* A = P.x + ((long long)r * P.s_loc + (long long)i * P.rb) * d;
  if (k > 0) {
    wait_arrivals(P.sync, flag_of(P, r, c, i), 0, 1, r, k);
    A = P.ws + (r * chunk_rows + row0) * d;
  }
  const GateUpRows rows{P.wg + r * P.g_rank + e * P.g_e, P.wu + r * P.u_rank + e * P.u_e,
                        P.g_row, P.u_row, P.f0, j * T::BN};
  const float* C = tile_mma_rows<T>(A, d, P.rb, rows, cols, P.d, smem);
  store_tile_bf16<T>(o, N, C, P.rb, cols);
  __syncthreads();   // C is read before the next item reuses shared memory
}

template <class T>
__global__ void __launch_bounds__(T::kThreads) ag_moe_kernel(Params P) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n = P.n;
  const long long fwd = (long long)n * P.n_rb, tiles = fwd * P.n_cb;
  for (long long item = blockIdx.x;; item += gridDim.x) {
    long long rem = item;
    int k = 0;
    for (; k < n; ++k) {
      const long long cnt = (k < n - 1 ? fwd : 0) + tiles;
      if (rem < cnt) break;
      rem -= cnt;
    }
    if (k == n) break;
    if (k < n - 1) {
      if (rem < fwd) {
        forward_item(P, k, (int)(rem / P.n_rb), (int)(rem % P.n_rb));
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
  P.rb = P.tm < T::BM ? P.tm : T::BM;
  P.n_rb = P.s_loc / P.rb;
  P.n_cb = (P.f0 + P.f1 + T::BN - 1) / T::BN;
  const long long per_step = (long long)P.n * P.n_rb;
  const long long items = per_step * P.n_cb * P.n + per_step * (P.n - 1);
  void* args[] = {&P};
  return cooperative_launch(reinterpret_cast<const void*>(ag_moe_kernel<T>), T::kThreads,
                            T::kSmem, items, args, device, s);
}

int tile_rows(int tm) { return tm <= 16 ? Moe16::BM : tm <= 32 ? Moe32::BM : Moe64::BM; }

}  // namespace

// The rows of one forwarded / multiplied row block at row tile tm: the host
// sizes the flags (n * n * s_loc / rows) by it.
extern "C" int tdt_ag_moe_row_block(int tm) {
  const int bm = tile_rows(tm);
  return tm < bm ? tm : bm;
}

// Plain C interface for ctypes. x (n, s_loc, d) contiguous; the gate shard
// of rank r, expert e at wg + r * g_rank + e * g_e elements with row pitch
// g_row (f0 rows of d), the up shard likewise (f1 rows; f1 = 0 and wu null
// for one weight); te (n, s_loc / tm) int32; used (n,) int32; out
// (n, n * s_loc, f0 + f1); ws (n, n * s_loc, d); flags: the workspace's
// n * n * (s_loc / tdt_ag_moe_row_block(tm)) flag words then its abort word;
// d and every stride a multiple of 8; tm at most 64 or a multiple of 64,
// dividing s_loc. epoch: this call's (>= 1); timeout_ns bounds every wait;
// fault: 0, or a planted fault (1: forward a rank's own chunk in place of
// the one it received, 2: rank 0's first forward never signalled). Returns
// a cudaError_t code (0 = launched).
extern "C" int tdt_ag_moe_bf16(const void* x, const void* wg, const void* wu, const void* te,
                               const void* used, void* out, void* ws, long long g_rank,
                               long long g_e, long long g_row, long long u_rank, long long u_e,
                               long long u_row, int n, int s_loc, int d, int E, int f0, int f1,
                               int tm, void* flags, void* abort_word, unsigned long long epoch,
                               unsigned long long timeout_ns, int fault, int device,
                               void* stream) {
  if (n < 1 || s_loc < 1 || d < 8 || d % 8 || E < 1 || f0 < 1 || f1 < 0 || tm < 1 ||
      s_loc % tm || (tm > 64 && tm % 64) || (f1 > 0 && wu == nullptr) || g_rank % 8 ||
      g_e % 8 || g_row % 8 || u_rank % 8 || u_e % 8 || u_row % 8 || epoch == 0 ||
      timeout_ns == 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = ensure_error_record();
  if (e != cudaSuccess) return (int)e;
  Params P;
  P.x = static_cast<const bf16*>(x);
  P.wg = static_cast<const bf16*>(wg);
  P.wu = f1 > 0 ? static_cast<const bf16*>(wu) : P.wg;
  P.te = static_cast<const int*>(te);
  P.used = static_cast<const int*>(used);
  P.out = static_cast<bf16*>(out);
  P.ws = static_cast<bf16*>(ws);
  P.g_rank = g_rank;
  P.g_e = g_e;
  P.g_row = g_row;
  P.u_rank = u_rank;
  P.u_e = u_e;
  P.u_row = u_row;
  P.n = n;
  P.s_loc = s_loc;
  P.d = d;
  P.E = E;
  P.f0 = f0;
  P.f1 = f1;
  P.tm = tm;
  P.n_i = s_loc / tm;
  P.fault = fault;
  P.sync.flags = static_cast<u64*>(flags);
  P.sync.abort = static_cast<u64*>(abort_word);
  P.sync.err = g_err_dev;
  P.sync.epoch = epoch;
  P.sync.timeout_ns = timeout_ns;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tm <= 16) return (int)launch<Moe16>(P, device, s);
  if (tm <= 32) return (int)launch<Moe32>(P, device, s);
  return (int)launch<Moe64>(P, device, s);
}
