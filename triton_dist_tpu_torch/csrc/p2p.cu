// One-sided point-to-point puts across simulated ranks on Hopper (sm_90a).
//
//   p2p_kernel  replaces triton_dist_tpu/ops/p2p.py _p2p_kernel (:29), and
//               with an edge from the root to every position (the root's
//               own included) triton_dist_tpu/ops/broadcast.py
//               _bcast_kernel (:29)
//
// It moves bytes: a rank's operand is one chunk of c_bytes (any count, any
// alignment), over one axis of a mesh (parallel/mesh.py): R ranks in all,
// the axis of size n with neighbours st flat ranks apart, independently in
// each of the R / n groups along it.
//
// JAX's static permutation of puts is an edge table (source position,
// destination position) with every destination named at most once; a
// source may feed several edges (a multicast forward, the broadcast). The
// source's blocks copy its chunk into the destination's output and signal
// the destination's flag of that piece; the destination waits for its
// pieces. Ranks that receive nothing get zeros (lax.ppermute's contract):
// the output is a fresh allocation that may hold an earlier call's bytes,
// so their zero-fill runs as items of its own, ordered before every wait.
//
// A chunk moves in 8 KiB pieces, each with its own flag per receiving rank,
// so a piece waits only for its own data. Work items, in the order every
// block walks them (each waits only on a lower-numbered item, see
// shmem_device.cuh): the zero-fills (position, group, piece), the puts
// (edge, group, piece), then one wait a receiving rank, which polls all of
// the rank's piece flags with every thread of its block.
//
// What bounds it on the H100: bytes, each input read once and each output
// written once. This first design is a grid-stride copy of the widest unit
// the chunk's alignment allows (16 bytes a thread for the pipeline's
// chunks): no TMA bulk copies (PERF.md).

#include "shmem_device.cuh"

namespace {

using namespace tdt;

enum Fault { kNoFault = 0, kWrongSource = 1, kLostSignal = 2 };

constexpr int kThreads = 256;
constexpr int kMaxAxis = 64;   // positions along the axis

struct Params {
  const char* x;     // (R, c_bytes): every rank's input
  char* out;         // (R, c_bytes): every rank's output
  long long c_bytes, n_pc;
  int R, n, st, fault;
  int n_edges, n_zero;
  int edge_src[kMaxAxis], edge_dst[kMaxAxis];   // positions, by edge
  int zero_pos[kMaxAxis];                       // positions receiving nothing
  Sync sync;
};

// The wait of receiving rank r for its n_pc pieces (flags r * n_pc ..);
// the record's step names the source position.
__device__ __forceinline__ void wait_chunk(const Params& P, int r, int src_pos) {
  wait_flags(P.sync, (long long)r * P.n_pc, (int)P.n_pc, r, src_pos);
}

__global__ void __launch_bounds__(kThreads) p2p_kernel(Params P) {
  const long long groups = P.R / P.n;
  const long long zero_items = (long long)P.n_zero * groups * P.n_pc;
  const long long put_items = (long long)P.n_edges * groups * P.n_pc;
  const long long total = zero_items + put_items + (long long)P.n_edges * groups;
  for (long long item = blockIdx.x; item < total; item += gridDim.x) {
    if (item < zero_items) {
      const long long p = item % P.n_pc, rest = item / P.n_pc;
      const int r = group_rank(rest % groups, P.zero_pos[rest / groups], P.n, P.st);
      long long b0, nb;
      piece_bytes(P.c_bytes, p, &b0, &nb);
      zero_bytes(P.out + (long long)r * P.c_bytes + b0, nb);
    } else if (item < zero_items + put_items) {
      const long long i = item - zero_items;
      const long long p = i % P.n_pc, rest = i / P.n_pc, g = rest % groups;
      const int e = (int)(rest / groups);
      int src = P.edge_src[e];
      if (P.fault == kWrongSource && e == 0) src = (src + 1) % P.n;
      const int rs = group_rank(g, src, P.n, P.st), rd = group_rank(g, P.edge_dst[e], P.n, P.st);
      long long b0, nb;
      piece_bytes(P.c_bytes, p, &b0, &nb);
      copy_bytes(P.out + (long long)rd * P.c_bytes + b0, P.x + (long long)rs * P.c_bytes + b0, nb);
      if (P.fault == kLostSignal && e == 0 && g == 0 && p == 0) {
        __syncthreads();
        continue;
      }
      signal_block(P.sync, (long long)rd * P.n_pc + p);
    } else {
      const long long i = item - zero_items - put_items;
      const int e = (int)(i / groups);
      wait_chunk(P, group_rank(i % groups, P.edge_dst[e], P.n, P.st), P.edge_src[e]);
    }
    __syncthreads();
  }
}

}  // namespace

// Plain C interface for ctypes. x and out (R, c_bytes) with a leading rank
// dimension of R, contiguous; the axis has size n <= 64 and stride st (R a
// multiple of n * st). src_of (host, n ints): for each destination position
// the source position, or -1 where the position receives nothing; no
// position is named twice as a destination by construction, a source may
// feed several. flags: the workspace's R * n_pc flag words (n_pc =
// ceil(c_bytes / 8 KiB): rank r's piece p at r * n_pc + p), then its abort
// word. epoch: this call's (>= 1); timeout_ns bounds every wait; fault: 0,
// or a planted fault (1: the first edge's put reads the wrong rank's input,
// 2: that put's first piece in group 0 never signalled). Return a
// cudaError_t code (0 = launched).
extern "C" int tdt_p2p_put(const void* x, void* out, long long c_bytes, int R, int n, int st,
                           const int* src_of, void* flags, void* abort_word,
                           unsigned long long epoch, unsigned long long timeout_ns, int fault,
                           int device, void* stream) {
  if (R < 1 || n < 1 || n > kMaxAxis || st < 1 || R % (n * st) || c_bytes < 1 || epoch == 0 ||
      timeout_ns == 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = ensure_error_record();
  if (e != cudaSuccess) return (int)e;
  Params P;
  memset(&P, 0, sizeof(P));
  P.x = static_cast<const char*>(x);
  P.out = static_cast<char*>(out);
  P.c_bytes = c_bytes;
  P.n_pc = (c_bytes + kPieceBytes - 1) / kPieceBytes;
  P.R = R;
  P.n = n;
  P.st = st;
  P.fault = fault;
  P.sync.flags = static_cast<u64*>(flags);
  P.sync.abort = static_cast<u64*>(abort_word);
  P.sync.err = g_err_dev;
  P.sync.epoch = epoch;
  P.sync.timeout_ns = timeout_ns;
  for (int d = 0; d < n; ++d) {
    if (src_of[d] < -1 || src_of[d] >= n) return (int)cudaErrorInvalidValue;
    if (src_of[d] < 0) {
      P.zero_pos[P.n_zero++] = d;
    } else {
      P.edge_src[P.n_edges] = src_of[d];
      P.edge_dst[P.n_edges++] = d;
    }
  }
  const long long groups = R / n;
  const long long items = (long long)(P.n_zero + P.n_edges) * groups * P.n_pc +
                          (long long)P.n_edges * groups;
  void* args[] = {&P};
  return (int)cooperative_launch(reinterpret_cast<const void*>(p2p_kernel), kThreads, 0, items,
                                 args, device, static_cast<cudaStream_t>(stream));
}
