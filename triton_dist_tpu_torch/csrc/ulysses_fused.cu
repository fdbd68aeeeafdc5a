// Ulysses sequence parallelism across simulated ranks on Hopper (sm_90a):
// the QKV and O projections fused with the head <-> sequence all-to-alls,
// bf16 in and out, fp32 sums.
//
// ulysses_qkv_a2a_kernel replaces triton_dist_tpu/ops/ulysses_fused.py
// _qkv_kernel (:87, qkv_gemm_a2a :204). Rank s holds its sequence slice x[s]
// (S_loc x K) and every rank holds the projection weight grouped by head
// owner, w[o] (cols x K, stored (out, in)): owner o's q, k and v heads. Rank
// s projects its rows onto every owner's heads and puts each finished block
// straight into the owner's receive slot:
//
//   out[o][s] = x[s] . w[o]^T        (S_loc x cols; out[o] is pre_attn_a2a(x . w))
//
// Work items (s, o, row block): the whole (row block x cols) row of tiles,
// column tile after column tile (JAX's z_row), stored into out[o][s] and, for
// a remote owner, published by one flag per (owner, source, row block); the
// local owner's blocks need no flag. Then one item per owner waits for its
// (n - 1) x row-block flags, polled by all of its threads: the launch ends
// only once every rank has seen all its rows, as JAX's kernel ends on its
// receive semaphore.
//
// ulysses_o_a2a_kernel replaces _o_kernel (:263, o_a2a_gemm :344). Rank r
// holds the attention output of its heads over the whole sequence o[r]
// (S x rows, S = n * S_loc) and the O-projection rows of every owner's heads
// w[s] (d x rows, stored (out, in): the column slice of W_o for s's heads).
// Each rank's output is a sum of one partial product per source:
//
//   out[d] = sum_s o[s][d * S_loc : (d + 1) * S_loc] . w[s]^T     (S_loc x d)
//
// Work items: first the puts (sender s, peer offset, row block) copying
// o[s]'s rows for rank p = (s + off) mod n into p's receive slot s, one flag
// per (receiver, sender, row block): every send issued at entry, before any
// wait; then the GEMM items (rank, row block, column block), one contraction
// whose K runs through the n sources in the swizzle's order (src = (d + k)
// mod n for "a2a", the local chunk read from o with no wait; src = k for
// "identity"), each source's flag waited just before its first K stage
// (tile_gemm.cuh tile_mma_segments).
//
// What bounds them on the H100: operations. At Qwen3-8B width over 4 ranks
// (S = 32768, d 4096, 8 + 2 + 2 heads of 128 a rank) the QKV kernel does
// 1.65 TFLOP (1.67 ms at 989 TFLOP/s) and the O kernel 1.10 TFLOP (1.11 ms).
// This first design runs the wmma tiles of tile_gemm.cuh: no wgmma, no TMA
// (PERF.md).

#include "shmem_device.cuh"
#include "tile_gemm.cuh"

namespace {

using namespace tdt;

enum Fault { kNoFault = 0, kWrongChunk = 1, kLostSignal = 2 };
enum Mode { kA2A = 0, kIdentity = 1 };

typedef BigTile T;

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

bool bad_sync(void* flags, void* abort_word, unsigned long long epoch,
              unsigned long long timeout_ns) {
  return flags == nullptr || abort_word == nullptr || epoch == 0 || timeout_ns == 0;
}

// -- row 29: QKV projection scattered to the head owners ---------------------

struct QkvParams {
  const bf16* x;     // (n, S_loc, K)
  const bf16* w;     // owner o's rows at w + o * w_rank, ldw apart (cols rows of K)
  bf16* out;         // (n_owner, n_src, S_loc, cols)
  long long w_rank, ldw;
  int n, S_loc, K, cols, n_rb, n_cb, fault;
  Sync sync;
};

// Flag of row block rb of source s's rows in owner o's slot.
__device__ __forceinline__ long long qkv_flag(const QkvParams& P, int o, int s, int rb) {
  return ((long long)o * P.n + s) * P.n_rb + rb;
}

__device__ void qkv_item(const QkvParams& P, int s, int o, int rb, unsigned char* smem) {
  const int n = P.n;
  const long long K = P.K;
  const int rows = min(T::BM, P.S_loc - rb * T::BM);
  const bf16* A = P.x + ((long long)s * P.S_loc + (long long)rb * T::BM) * K;
  // A planted fault: rank 0's rows for owner 1 land in the slot of source 1.
  const int slot = (P.fault == kWrongChunk && s == 0 && o == 1 % n) ? 1 % n : s;
  bf16* dst = P.out + (((long long)o * n + slot) * P.S_loc + (long long)rb * T::BM) * P.cols;
  for (int cb = 0; cb < P.n_cb; ++cb) {
    const int cols = min(T::BN, P.cols - cb * T::BN);
    const float* C = tile_mma<T>(A, K, rows, P.w + o * P.w_rank + (long long)cb * T::BN * P.ldw,
                                 P.ldw, cols, P.K, smem);
    store_tile_bf16<T>(dst + (long long)cb * T::BN, P.cols, C, rows, cols);
    __syncthreads();   // C is read before the next tile overwrites it
  }
  if (o == s) return;                    // my own heads: nothing to signal
  if (P.fault == kLostSignal && s == 0 && o == 1 % n && rb == 0) return;
  signal_block(P.sync, qkv_flag(P, o, s, rb));
}

__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
    ulysses_qkv_a2a_kernel(QkvParams P) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n = P.n;
  const long long blocks = (long long)n * n * P.n_rb;
  for (long long item = blockIdx.x; item < blocks + n; item += gridDim.x) {
    if (item < blocks) {
      // (source, row block, owner): an x row block's n owners are neighbours,
      // so the blocks running them share it through L2.
      const int o = (int)(item % n);
      const long long rem = item / n;
      qkv_item(P, (int)(rem / P.n_rb), o, (int)(rem % P.n_rb), smem);
    } else if (n > 1) {
      // Owner o: every row block of every other source has landed.
      const int o = (int)(item - blocks);
      for (int k = 1; k < n; ++k) {
        const int s = (o + k) % n;
        if (!wait_flags(P.sync, qkv_flag(P, o, s, 0), P.n_rb, o, s)) break;
      }
    }
    __syncthreads();
  }
}

// -- row 30: A2A consumed by the O projection --------------------------------

struct OParams {
  const bf16* o;     // (n, S, rows): rank r's heads over the whole sequence
  const bf16* w;     // source s's B rows at w + s * w_src, ldw apart (d rows of `rows`)
  bf16* recv;        // (n, n, S_loc, rows): [receiver][sender]
  bf16* out;         // (n, S_loc, d)
  long long w_src, ldw;
  int n, S_loc, rows, d, n_rb, n_cb, mode, fault;
  Sync sync;
};

__device__ __forceinline__ long long o_flag(const OParams& P, int dst, int s, int rb) {
  return ((long long)dst * P.n + s) * P.n_rb + rb;
}

// Sender s's row block rb of the rows rank p = (s + off) mod n owns.
__device__ void o_put_item(const OParams& P, int s, int off, int rb) {
  const int n = P.n, p = (s + off) % n;
  const int rows = min(T::BM, P.S_loc - rb * T::BM);
  // A planted fault: rank 0 sends rank 1 the rows of rank 2.
  const int part = (P.fault == kWrongChunk && s == 0 && p == 1 % n) ? (p + 1) % n : p;
  const long long S = (long long)n * P.S_loc;
  const bf16* src = P.o + ((long long)s * S + (long long)part * P.S_loc + (long long)rb * T::BM) *
                              P.rows;
  bf16* dst = P.recv + (((long long)p * n + s) * P.S_loc + (long long)rb * T::BM) * P.rows;
  remote_put(dst, P.rows, src, P.rows, rows, P.rows);
  if (P.fault == kLostSignal && s == 0 && p == 1 % n && rb == 0) return;
  signal_block(P.sync, o_flag(P, p, s, rb));
}

// The n sources of rank d's row block rb, column block cb, in swizzle order.
struct OSegments {
  const OParams* P;
  int d, rb, cb;
  __device__ __forceinline__ int src(int k) const {
    return P->mode == kIdentity ? k : (d + k) % P->n;
  }
  __device__ __forceinline__ const bf16* a(int k) const {
    const int s = src(k);
    const long long row0 = (long long)rb * T::BM;
    if (s == d)
      return P->o + ((long long)d * P->n * P->S_loc + (long long)d * P->S_loc + row0) * P->rows;
    return P->recv + (((long long)d * P->n + s) * P->S_loc + row0) * P->rows;
  }
  __device__ __forceinline__ long long lda(int) const { return P->rows; }
  __device__ __forceinline__ const bf16* b(int k, int r) const {
    return P->w + src(k) * P->w_src + ((long long)cb * T::BN + r) * P->ldw;
  }
  __device__ __forceinline__ void ready(int k) const {
    const int s = src(k);
    if (s != d) wait_arrivals(P->sync, o_flag(*P, d, s, rb), 0, 1, d, s);
  }
};

__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks) ulysses_o_a2a_kernel(OParams P) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n = P.n;
  const long long puts = (long long)n * (n - 1) * P.n_rb;
  const long long items = puts + (long long)n * P.n_rb * P.n_cb;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    if (item < puts) {
      const int rb = (int)(item % P.n_rb);
      const long long pair = item / P.n_rb;
      o_put_item(P, (int)(pair / (n - 1)), 1 + (int)(pair % (n - 1)), rb);
    } else {
      long long rem = item - puts;
      const int cb = (int)(rem % P.n_cb);
      rem /= P.n_cb;
      const int d = (int)(rem / P.n_rb), rb = (int)(rem % P.n_rb);
      const OSegments seg{&P, d, rb, cb};
      const int rows = min(T::BM, P.S_loc - rb * T::BM);
      const int cols = min(T::BN, P.d - cb * T::BN);
      const float* C = tile_mma_segments<T>(seg, n, rows, cols, P.rows, smem);
      store_tile_bf16<T>(P.out + ((long long)d * P.S_loc + (long long)rb * T::BM) * P.d +
                             (long long)cb * T::BN,
                         P.d, C, rows, cols);
    }
    __syncthreads();
  }
}

}  // namespace

// Plain C interfaces for ctypes; each returns a cudaError_t code (0 =
// launched). K, rows and every weight stride a multiple of 8, tensors 16-byte
// aligned. flags: the workspace's flag words (n * n * ceil(S_loc / 128)) then
// its abort word; epoch: this call's (>= 1); timeout_ns bounds every wait.
//
// tdt_ulysses_qkv_a2a: x (n, S_loc, K); owner o's weight (cols rows of K, row
// pitch ldw) at w + o * w_rank elements; out (n, n, S_loc, cols)
// [owner][source]. fault: 0, or a planted fault in rank 0's rows for owner 1
// (1: they land in the slot of source 1; 2: the first row block's flag is
// never raised).
extern "C" int tdt_ulysses_qkv_a2a(const void* x, const void* w, void* out, long long w_rank,
                                   long long ldw, int n, int S_loc, int K, int cols,
                                   void* flags, void* abort_word, unsigned long long epoch,
                                   unsigned long long timeout_ns, int fault, int device,
                                   void* stream) {
  if (n < 1 || S_loc < 1 || K < 8 || K % 8 || cols < 1 || ldw % 8 || w_rank % 8 ||
      bad_sync(flags, abort_word, epoch, timeout_ns) ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = ensure_error_record();
  if (e != cudaSuccess) return (int)e;
  QkvParams P;
  P.x = static_cast<const bf16*>(x);
  P.w = static_cast<const bf16*>(w);
  P.out = static_cast<bf16*>(out);
  P.w_rank = w_rank;
  P.ldw = ldw;
  P.n = n;
  P.S_loc = S_loc;
  P.K = K;
  P.cols = cols;
  P.n_rb = (S_loc + T::BM - 1) / T::BM;
  P.n_cb = (cols + T::BN - 1) / T::BN;
  P.fault = fault;
  P.sync = make_sync(flags, abort_word, epoch, timeout_ns);
  void* args[] = {&P};
  const long long items = (long long)n * n * P.n_rb + n;
  return (int)cooperative_launch(reinterpret_cast<const void*>(ulysses_qkv_a2a_kernel),
                                 T::kThreads, T::kSmem, items, args, device,
                                 static_cast<cudaStream_t>(stream));
}

// tdt_ulysses_o_a2a: o (n, n * S_loc, rows); source s's O-projection rows (d
// rows of `rows`, row pitch ldw) at w + s * w_src elements; recv (n, n, S_loc,
// rows) [receiver][sender]; out (n, S_loc, d); mode 0 "a2a", 1 "identity".
// fault: 0, or a planted fault in rank 0's rows for rank 1 (1: rank 2's rows
// are sent in their place; 2: the first row block's flag is never raised).
extern "C" int tdt_ulysses_o_a2a(const void* o, const void* w, void* recv, void* out,
                                 long long w_src, long long ldw, int n, int S_loc, int rows,
                                 int d, int mode, void* flags, void* abort_word,
                                 unsigned long long epoch, unsigned long long timeout_ns,
                                 int fault, int device, void* stream) {
  if (n < 1 || S_loc < 1 || rows < 8 || rows % 8 || d < 1 || ldw % 8 || w_src % 8 || mode < 0 ||
      mode > 1 || bad_sync(flags, abort_word, epoch, timeout_ns) ||
      (reinterpret_cast<uintptr_t>(o) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(recv)) % 16)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = ensure_error_record();
  if (e != cudaSuccess) return (int)e;
  OParams P;
  P.o = static_cast<const bf16*>(o);
  P.w = static_cast<const bf16*>(w);
  P.recv = static_cast<bf16*>(recv);
  P.out = static_cast<bf16*>(out);
  P.w_src = w_src;
  P.ldw = ldw;
  P.n = n;
  P.S_loc = S_loc;
  P.rows = rows;
  P.d = d;
  P.n_rb = (S_loc + T::BM - 1) / T::BM;
  P.n_cb = (d + T::BN - 1) / T::BN;
  P.mode = mode;
  P.fault = fault;
  P.sync = make_sync(flags, abort_word, epoch, timeout_ns);
  void* args[] = {&P};
  const long long items = (long long)n * (n - 1) * P.n_rb + (long long)n * P.n_rb * P.n_cb;
  return (int)cooperative_launch(reinterpret_cast<const void*>(ulysses_o_a2a_kernel),
                                 T::kThreads, T::kSmem, items, args, device,
                                 static_cast<cudaStream_t>(stream));
}

// The row block of both kernels (their flag granularity).
extern "C" int tdt_ulysses_row_block() { return T::BM; }
