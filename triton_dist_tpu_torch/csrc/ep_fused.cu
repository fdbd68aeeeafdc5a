// Tile-fused expert parallelism across simulated ranks on Hopper (sm_90a):
// the reference's Mega-EP pairing, bf16 in and out, fp32 sums.
//
// ep_dispatch_gemm_kernel replaces triton_dist_tpu/ops/ep_fused.py
// _dispatch_gemm_kernel (:137, ep_dispatch_gemm :195): the dispatch
// all-to-all fused into the experts' up projection. Every rank holds its
// tokens packed by ep_route as send[src][dst][e] (C capacity rows of d, the
// first counts[src][dst][e] of them filled, the rest zero) and computes,
// for every rank s that sent it tokens,
//
//   h[o][s][e] = recv[o][s][e] . [Wg_o[e] ; Wu_o[e]]^T,   recv[o][s] = send[s][o]
//
// gate columns [0, f0) first, then up columns [f0, f0 + f1): JAX's
// concatenated w_gu, read from the two weights through a row functor with
// no concatenated copy. Work items, in the order every block walks them
// (each waits only on a lower-numbered item, see shmem_device.cuh):
//   1. the puts (src, peer offset, e): src copies its filled rows of
//      send[src][dst][e] into dst's receive buffer at [dst][src][e] (zeros
//      past them), stores the count beside them and raises one flag per
//      (dst, src, e): JAX's per-(source, expert) DMA semaphore;
//   2. the GEMM items (owner, e, column tile j, row block, k), src =
//      (owner + k) mod n in ring order from the owner: its own tokens
//      first, read from its send buffer with no wait (JAX's k == 0); the
//      others wait for their (src, e) flag. The n items of one (owner, e,
//      j) are neighbours, so the blocks running them share the weight tile
//      through L2.
// Every put is numbered before every wait.
//
// ep_gemm_combine_kernel replaces _gemm_combine_kernel (:255,
// ep_gemm_combine :314): the experts' down projection fused into the
// combine all-to-all. Items (owner, e, d tile j, row block, k) compute
//
//   comb[s][o][e][rows, j] = act[o][s][e][rows] . Wd_o[e][j rows]^T
//
// store the block straight into source s's combine buffer and raise one
// flag per (s, o, e, j, row block); the last n items, one per source, wait
// for every block addressed to it (its n x E_loc x tiles flags, polled by
// all threads). The source's weighted gather is plain PyTorch after the
// launch (JAX: XLA after the Pallas call).
//
// Empty capacity slots (rows past the count) hold zeros in JAX and give
// zero outputs: both kernels skip them (A rows past the count read as
// zeros in tile_mma) and a block with no filled row stores zeros without a
// product.
//
// What bounds them on the H100: bytes. At Qwen3-30B-A3B over 4 ranks (512
// tokens a rank, top-8, 32 experts a rank, C 64, uniform routing) row 25
// reads 805 MB of gate/up weights and about 134 MB of filled token rows and
// writes the received tokens and h (0.3 ms at 3.35 TB/s) for about 100
// GFLOP (0.1 ms at 989 TFLOP/s); row 26 reads 403 MB of down weights. This
// first design runs the wmma tile GEMM of tile_gemm.cuh on 64-row blocks:
// no wgmma, no TMA (PERF.md).

#include "shmem_device.cuh"
#include "tile_gemm.cuh"

namespace {

using namespace tdt;

enum Fault { kNoFault = 0, kSlotShifted = 1, kLostSignal = 2, kWrongSource = 3 };

// A capacity's 64 rows by 128 output columns: four warps of 32 x 64, three
// K stages (82,944 bytes of shared memory).
typedef Tile<64, 128, 32, 64, 3> EpTile;

// Row rr of the B tile at column c0: a gate row, then up rows.
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

// Zeros into a rows x cols block of row pitch ld: what an empty block's
// product gives.
__device__ inline void store_zeros(bf16* o, long long ld, int rows, int cols) {
  for (int t = threadIdx.x; t < rows * cols; t += blockDim.x)
    o[(t / cols) * ld + t % cols] = __float2bfloat16(0.f);
}

struct DispatchParams {
  const bf16* send;   // (n, n, E_loc, C, d): [src][dst][e]
  const int* counts;  // (n, n, E_loc): filled slots of send[src][dst][e]
  const bf16* wg;     // gate of rank r, expert e: wg + r * g_rank + e * g_e, rows g_row apart
  const bf16* wu;     // up, the same way (f1 rows)
  bf16* recv;         // (n, n, E_loc, C, d): [dst][src][e]
  int* recv_counts;   // (n, n, E_loc): [dst][src][e]
  bf16* h;            // (n, n, E_loc, C, f0 + f1): [owner][src][e]
  long long g_rank, g_e, g_row, u_rank, u_e, u_row;
  int n, e_loc, C, d, f0, f1, n_rb, n_cb, fault;
  Sync sync;
};

// Flag of (receiver dst, sender src, local expert e).
__device__ __forceinline__ long long dispatch_flag(const DispatchParams& P, int dst, int src,
                                                   int e) {
  return ((long long)dst * P.n + src) * P.e_loc + e;
}

// Sender src's chunk for expert e of receiver dst: its filled rows into
// dst's receive buffer, zeros past them, the count beside them, one flag.
__device__ void put_item(const DispatchParams& P, int src, int dst, int e) {
  const long long d = P.d;
  const long long from_i = ((long long)src * P.n + dst) * P.e_loc + e;
  const long long to_i = dispatch_flag(P, dst, src, e);
  const int cnt = P.counts[from_i];
  const bf16* from = P.send + from_i * P.C * d;
  bf16* to = P.recv + to_i * P.C * d;
  const bool faulted = src == 0 && dst == 1 % P.n;
  // A planted fault lands rank 0's rows for rank 1 one slot down.
  const int shift = (P.fault == kSlotShifted && faulted) ? 1 : 0;
  const int vec = P.d / 8;
  for (long long i = threadIdx.x; i < (long long)P.C * vec; i += blockDim.x) {
    const int r = (int)(i / vec), c = (int)(i % vec) * 8, s = r - shift;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (s >= 0 && s < cnt) v = __ldcg(reinterpret_cast<const uint4*>(from + s * d + c));
    *reinterpret_cast<uint4*>(to + r * d + c) = v;
  }
  if (threadIdx.x == 0) P.recv_counts[to_i] = cnt;
  if (P.fault == kLostSignal && faulted && e == 0) return;
  signal_block(P.sync, to_i);
}

// Owner's output block (row block rb, column tile j) of the tokens src =
// (owner + k) mod n placed at its expert e.
__device__ void gemm_item(const DispatchParams& P, int owner, int e, int j, int rb, int k,
                          unsigned char* smem) {
  const int n = P.n, src = (owner + k) % n, N = P.f0 + P.f1;
  const long long d = P.d, chunk = ((long long)owner * n + src) * P.e_loc + e;
  const int rows = min(EpTile::BM, P.C - rb * EpTile::BM);
  const int cols = min(EpTile::BN, N - j * EpTile::BN);
  bf16* o = P.h + (chunk * P.C + (long long)rb * EpTile::BM) * N + (long long)j * EpTile::BN;
  const bf16* A;
  int cnt;
  if (k == 0) {
    // Own tokens: straight from the send layout, no transport.
    const long long own = ((long long)owner * n + owner) * P.e_loc + e;
    A = P.send + own * P.C * d;
    cnt = P.counts[own];
  } else {
    wait_arrivals(P.sync, dispatch_flag(P, owner, src, e), 0, 1, owner, src);
    A = P.recv + chunk * P.C * d;
    cnt = __ldcg(P.recv_counts + chunk);
  }
  const int a_rows = max(0, min(rows, cnt - rb * EpTile::BM));
  if (a_rows == 0) {
    store_zeros(o, N, rows, cols);
    return;
  }
  const GateUpRows B{P.wg + owner * P.g_rank + e * P.g_e, P.wu + owner * P.u_rank + e * P.u_e,
                     P.g_row, P.u_row, P.f0, j * EpTile::BN};
  const float* C = tile_mma_rows<EpTile>(A + (long long)rb * EpTile::BM * d, d, a_rows, B, cols,
                                         P.d, smem);
  store_tile_bf16<EpTile>(o, N, C, rows, cols);
}

__global__ void __launch_bounds__(EpTile::kThreads) ep_dispatch_gemm_kernel(DispatchParams P) {
  extern __shared__ __align__(128) unsigned char smem[];
  const long long puts = (long long)P.n * P.n * P.e_loc;
  const long long items = puts * (1 + (long long)P.n_cb * P.n_rb);
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    if (item < puts) {
      const long long pair = item / P.e_loc;
      const int src = (int)(pair / P.n), off = (int)(pair % P.n);
      put_item(P, src, (src + off) % P.n, (int)(item % P.e_loc));
    } else {
      long long rem = item - puts;
      const int k = (int)(rem % P.n);
      rem /= P.n;
      const int rb = (int)(rem % P.n_rb);
      rem /= P.n_rb;
      const int j = (int)(rem % P.n_cb);
      rem /= P.n_cb;
      gemm_item(P, (int)(rem / P.e_loc), (int)(rem % P.e_loc), j, rb, k, smem);
    }
    __syncthreads();   // shared memory and the item's flags are free again
  }
}

struct CombineParams {
  const bf16* act;         // (n, n, E_loc, C, f): [owner][src][e]
  const int* recv_counts;  // (n, n, E_loc): filled slots of act[owner][src][e]
  const bf16* wd;          // down of rank r, expert e: wd + r * w_rank + e * w_e, d rows w_row apart
  bf16* comb;              // (n, n, E_loc, C, d): [src][owner][e]
  long long w_rank, w_e, w_row;
  int n, e_loc, C, f, d, n_rb, n_cb, fault;
  Sync sync;
};

// Flag of block (row block rb, d tile j) of owner's output for src's
// tokens at its expert e, in src's combine buffer.
__device__ __forceinline__ long long combine_flag(const CombineParams& P, int src, int owner,
                                                  int e, int j, int rb) {
  return ((((long long)src * P.n + owner) * P.e_loc + e) * P.n_cb + j) * P.n_rb + rb;
}

__device__ void combine_item(const CombineParams& P, int owner, int e, int j, int rb, int k,
                             unsigned char* smem) {
  const int n = P.n, src = (owner + k) % n;
  const long long chunk = ((long long)owner * n + src) * P.e_loc + e;
  const int rows = min(EpTile::BM, P.C - rb * EpTile::BM);
  const int cols = min(EpTile::BN, P.d - j * EpTile::BN);
  const int a_rows = max(0, min(rows, P.recv_counts[chunk] - rb * EpTile::BM));
  const bool faulted = owner == 1 % n && src == 0;
  // A planted fault sends rank 1's blocks for rank 0 to rank 1 instead.
  const int home = (P.fault == kWrongSource && faulted) ? (src + 1) % n : src;
  bf16* o = P.comb + ((((long long)home * n + owner) * P.e_loc + e) * P.C +
                      (long long)rb * EpTile::BM) * P.d + (long long)j * EpTile::BN;
  if (a_rows == 0) {
    store_zeros(o, P.d, rows, cols);
  } else {
    const bf16* A = P.act + (chunk * P.C + (long long)rb * EpTile::BM) * P.f;
    const bf16* B = P.wd + owner * P.w_rank + e * P.w_e + (long long)j * EpTile::BN * P.w_row;
    const float* C = tile_mma<EpTile>(A, P.f, a_rows, B, P.w_row, cols, P.f, smem);
    store_tile_bf16<EpTile>(o, P.d, C, rows, cols);
  }
  if (P.fault == kLostSignal && faulted && e == 0 && j == 0 && rb == 0) return;
  signal_block(P.sync, combine_flag(P, src, owner, e, j, rb));
}

// Source src: wait until every block addressed to it has landed.
__device__ void home_wait_item(const CombineParams& P, int src) {
  const long long per_owner = (long long)P.e_loc * P.n_cb * P.n_rb;
  const long long base = (long long)src * P.n * per_owner;
  for (long long i = threadIdx.x; i < P.n * per_owner; i += blockDim.x)
    if (!signal_wait_until(P.sync, base + i, src, (int)(i / per_owner))) break;
  fence();
}

__global__ void __launch_bounds__(EpTile::kThreads) ep_gemm_combine_kernel(CombineParams P) {
  extern __shared__ __align__(128) unsigned char smem[];
  const long long blocks = (long long)P.n * P.n * P.e_loc * P.n_cb * P.n_rb;
  for (long long item = blockIdx.x; item < blocks + P.n; item += gridDim.x) {
    if (item < blocks) {
      long long rem = item;
      const int k = (int)(rem % P.n);
      rem /= P.n;
      const int rb = (int)(rem % P.n_rb);
      rem /= P.n_rb;
      const int j = (int)(rem % P.n_cb);
      rem /= P.n_cb;
      combine_item(P, (int)(rem / P.e_loc), (int)(rem % P.e_loc), j, rb, k, smem);
    } else {
      home_wait_item(P, (int)(item - blocks));
    }
    __syncthreads();
  }
}

bool bad_sync(void* flags, void* abort_word, unsigned long long epoch,
              unsigned long long timeout_ns) {
  return flags == nullptr || abort_word == nullptr || epoch == 0 || timeout_ns == 0;
}

Sync make_sync(void* flags, void* abort_word, unsigned long long epoch,
               unsigned long long timeout_ns) {
  Sync s;
  s.flags = static_cast<u64*>(flags);
  s.abort = static_cast<u64*>(abort_word);
  s.err = g_err_dev;
  s.epoch = epoch;
  s.timeout_ns = timeout_ns;
  return s;
}

}  // namespace

// Plain C interfaces for ctypes; each returns a cudaError_t code (0 =
// launched). d and every weight stride a multiple of 8, tensors 16-byte
// aligned. flags: the workspace's flag words (n * n * E_loc for the
// dispatch, n * n * E_loc * ceil(d / 128) * ceil(C / 64) for the combine)
// then its abort word; epoch: this call's (>= 1); timeout_ns bounds every
// wait.
//
// tdt_ep_dispatch_gemm: send (n, n, E_loc, C, d) [src][dst][e]; counts (n,
// n, E_loc) int32; the gate weight of rank r, expert e at wg + r * g_rank +
// e * g_e elements (f0 rows of d, row pitch g_row), the up weight likewise
// (f1 rows; f1 = 0 for one weight); recv (n, n, E_loc, C, d) and
// recv_counts (n, n, E_loc) [dst][src][e]; h (n, n, E_loc, C, f0 + f1)
// [owner][src][e]. fault: 0, or a planted fault in rank 0's chunks for
// rank 1 (1: every row lands one slot down; 2: expert 0's flag is never
// raised).
extern "C" int tdt_ep_dispatch_gemm(const void* send, const void* counts, const void* wg,
                                    const void* wu, void* recv, void* recv_counts, void* h,
                                    long long g_rank, long long g_e, long long g_row,
                                    long long u_rank, long long u_e, long long u_row, int n,
                                    int e_loc, int C, int d, int f0, int f1, void* flags,
                                    void* abort_word, unsigned long long epoch,
                                    unsigned long long timeout_ns, int fault, int device,
                                    void* stream) {
  if (n < 1 || e_loc < 1 || C < 1 || d < 8 || d % 8 || f0 < 1 || f1 < 0 || g_rank % 8 ||
      g_e % 8 || g_row % 8 || u_rank % 8 || u_e % 8 || u_row % 8 ||
      bad_sync(flags, abort_word, epoch, timeout_ns) ||
      (reinterpret_cast<uintptr_t>(send) | reinterpret_cast<uintptr_t>(recv) |
       reinterpret_cast<uintptr_t>(wg) | reinterpret_cast<uintptr_t>(wu)) % 16)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = ensure_error_record();
  if (e != cudaSuccess) return (int)e;
  DispatchParams P;
  P.send = static_cast<const bf16*>(send);
  P.counts = static_cast<const int*>(counts);
  P.wg = static_cast<const bf16*>(wg);
  P.wu = static_cast<const bf16*>(wu);
  P.recv = static_cast<bf16*>(recv);
  P.recv_counts = static_cast<int*>(recv_counts);
  P.h = static_cast<bf16*>(h);
  P.g_rank = g_rank;
  P.g_e = g_e;
  P.g_row = g_row;
  P.u_rank = u_rank;
  P.u_e = u_e;
  P.u_row = u_row;
  P.n = n;
  P.e_loc = e_loc;
  P.C = C;
  P.d = d;
  P.f0 = f0;
  P.f1 = f1;
  P.n_rb = (C + EpTile::BM - 1) / EpTile::BM;
  P.n_cb = (f0 + f1 + EpTile::BN - 1) / EpTile::BN;
  P.fault = fault;
  P.sync = make_sync(flags, abort_word, epoch, timeout_ns);
  void* args[] = {&P};
  const long long items = (long long)n * n * e_loc * (1 + (long long)P.n_cb * P.n_rb);
  return (int)cooperative_launch(reinterpret_cast<const void*>(ep_dispatch_gemm_kernel),
                                 EpTile::kThreads, EpTile::kSmem, items, args, device,
                                 static_cast<cudaStream_t>(stream));
}

// tdt_ep_gemm_combine: act (n, n, E_loc, C, f) [owner][src][e] with
// recv_counts (n, n, E_loc) its filled slots; the down weight of rank r,
// expert e at wd + r * w_rank + e * w_e elements (d rows of f, row pitch
// w_row); comb (n, n, E_loc, C, d) [src][owner][e]. fault: 0, or a planted
// fault in rank 1's blocks for rank 0 (2: the first block's flag is never
// raised; 3: every block lands in rank 1's buffer).
extern "C" int tdt_ep_gemm_combine(const void* act, const void* recv_counts, const void* wd,
                                   void* comb, long long w_rank, long long w_e, long long w_row,
                                   int n, int e_loc, int C, int f, int d, void* flags,
                                   void* abort_word, unsigned long long epoch,
                                   unsigned long long timeout_ns, int fault, int device,
                                   void* stream) {
  if (n < 1 || e_loc < 1 || C < 1 || f < 8 || f % 8 || d < 1 || w_rank % 8 || w_e % 8 ||
      w_row % 8 || bad_sync(flags, abort_word, epoch, timeout_ns) ||
      (reinterpret_cast<uintptr_t>(act) | reinterpret_cast<uintptr_t>(wd)) % 16)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = ensure_error_record();
  if (e != cudaSuccess) return (int)e;
  CombineParams P;
  P.act = static_cast<const bf16*>(act);
  P.recv_counts = static_cast<const int*>(recv_counts);
  P.wd = static_cast<const bf16*>(wd);
  P.comb = static_cast<bf16*>(comb);
  P.w_rank = w_rank;
  P.w_e = w_e;
  P.w_row = w_row;
  P.n = n;
  P.e_loc = e_loc;
  P.C = C;
  P.f = f;
  P.d = d;
  P.n_rb = (C + EpTile::BM - 1) / EpTile::BM;
  P.n_cb = (d + EpTile::BN - 1) / EpTile::BN;
  P.fault = fault;
  P.sync = make_sync(flags, abort_word, epoch, timeout_ns);
  void* args[] = {&P};
  const long long items = (long long)n * n * e_loc * P.n_cb * P.n_rb + n;
  return (int)cooperative_launch(reinterpret_cast<const void*>(ep_gemm_combine_kernel),
                                 EpTile::kThreads, EpTile::kSmem, items, args, device,
                                 static_cast<cudaStream_t>(stream));
}
