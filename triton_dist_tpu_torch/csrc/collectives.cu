// Ring all-gather, ring reduce-scatter and one-shot all-reduce across
// simulated ranks on Hopper (sm_90a).
//
//   all_gather_kernel      replaces triton_dist_tpu/ops/allgather.py
//                          _ring_kernel (:49): rows of any type, as bytes
//   reduce_scatter_kernel  replaces triton_dist_tpu/ops/reduce_scatter.py
//                          _ring_kernel (:32): bf16
//   all_reduce_kernel      replaces triton_dist_tpu/ops/allreduce.py
//                          _one_shot_kernel (:50): bf16
//   full_mesh_kernel       replaces triton_dist_tpu/ops/allgather.py
//                          _full_mesh_kernel (:77): rows of any type and
//                          any byte count
//   rhd_kernel<T>          replaces triton_dist_tpu/ops/allreduce.py
//                          _rhd_kernel (:79): bf16 and fp32
//
// Each runs over one axis of a mesh (parallel/mesh.py): R ranks in all, the
// axis of size n with neighbours st flat ranks apart, so the collective runs
// independently in each of the R / n groups of ranks that share their other
// coordinates (on make_mesh(dp=2, tp=2) an op over "dp" pairs ranks 0-2 and
// 1-3). me = axis_pos(r), right = the group's position me + 1.
//
// All-gather (JAX's ring): rank r writes its chunk into its own output slot
// me, and at step k = 0 .. n - 2 puts the chunk it holds for step k
// (chunk (me - k) mod n: its own at k = 0, else the one that arrived from
// the left at step k - 1) into the same slot of the right neighbour's
// output, then signals it. Step n - 1 only waits for the last arrival, as
// the JAX kernel's copy.wait() certifies every receive.
//
// Reduce-scatter (JAX's ring): at step k = 0 .. n - 2 rank r sends the
// running sum of chunk (me - k - 1) mod n to the right neighbour's receive
// slot k: its own chunk at k = 0, else bf16(own + received), the sum
// rounded to bf16 at every hop as JAX's x.dtype receive buffers round it.
// At step n - 1 it adds the last arrival to its own chunk me: its output.
//
// One-shot all-reduce: every rank puts its whole buffer into gather slot me
// of every peer and signals; then each rank waits for its n - 1 arrivals
// and sums the n buffers in fp32 in a fixed order, positions 0 .. n - 1
// (its own read from its input), rounded to bf16 once, so every rank of a
// group holds the same bits (JAX adds in bf16 from each rank's own buffer
// round the ring; at n = 2 the two agree).
//
// Full-mesh all-gather (JAX's one-hop form): rank r copies its chunk into
// its own output slot me and puts it into slot me of each of its n - 1
// peers, signalling each; then it waits for its n - 1 arrivals. The output
// is the ring's, bit for bit.
//
// Recursive halving-doubling all-reduce (JAX's Rabenseifner form; n a power
// of two, each rank's rows a multiple of n, so every region is whole chunks
// of rows / n rows): at halving step s = 0 .. log2 n - 1 a rank keeps one
// half of its current region and puts the other into its partner's (me xor
// n >> (s + 1)) receive region at JAX's packed offset rows - (rows >> s),
// then adds what arrives into the kept half, rounded to the element type as
// JAX's x.dtype acc_v / tmp_v round it; rank me ends holding chunk me
// summed over its group. The doubling steps (bits 0 .. log2 n - 1) put each
// held chunk into the partner's output at the same coordinates. The sums are
// a fixed tree, ((x0 + x4) + (x2 + x6)) + ((x1 + x5) + (x3 + x7)) at n = 8,
// whatever the rank, so every rank of a group ends with the same bits.
// Step s + 1 reads what step s summed, so the items follow each chunk c, not
// each step: a halving item (rank, c, piece) is where rank me's share of
// chunk c ends. Its level k is the step at which me sends c (the first bit,
// from the top, where me and c differ; log2 n for me == c, which never sends
// it). It waits for its k arrivals, sums x and them in step order, and puts
// the sum into the level-k partner's receive region (or, at me == c, writes
// its output and puts the reduced chunk to every me xor 2^b). A doubling item
// (rank, c, piece) with highest differing bit h waits for chunk c's arrival
// at bit h and forwards it at every higher bit. Items run by level, then the
// doubling items by h: each waits only on lower ones.
//
// A chunk moves in pieces of kPieceVecs 16-byte vectors (8 KiB), each with
// its own flag, so a piece waits only for its own data. Work items, in the
// order every block walks them (each waits only on a lower-numbered item,
// see shmem_device.cuh): the rings by (step, rank, piece); the one-shot
// all-reduce its puts (rank, piece), then its reduces (rank, piece); the
// full-mesh all-gather its puts (rank, destination, piece), then one wait a
// rank; the recursive all-reduce as set out above.
//
// What bounds them on the H100: bytes, each input read once and each output
// written once (plus the rings' forwarded pieces). This first design is a
// grid-stride copy of 16-byte vectors per piece: no TMA bulk copies
// (PERF.md).

#include "shmem_device.cuh"

namespace {

using namespace tdt;

enum Fault { kNoFault = 0, kWrongChunk = 1, kDropPartial = 1, kLostSignal = 2 };

constexpr int kThreads = 256;
constexpr long long kPieceVecs = kPieceBytes / 16;   // 16-byte vectors a work item moves

struct Params {
  const char* x;        // (R, x_rank) bytes: every rank's input
  char* out;            // (R, out_rank) bytes: every rank's output
  char* buf;            // receive slots (reduce-scatter, recursive) / gather slots
  long long c_vecs;     // 16-byte vectors of one chunk
  long long c_bytes;    // bytes of one chunk
  long long n_pc;       // pieces of one chunk
  int R, n, st, fault;
  int logn;             // recursive all-reduce: log2 n
  Sync sync;
};

__device__ __forceinline__ const uint4* vec_at(const char* base, long long chunk, long long c_vecs) {
  return reinterpret_cast<const uint4*>(base) + chunk * c_vecs;
}

__device__ __forceinline__ uint4* vec_at(char* base, long long chunk, long long c_vecs) {
  return reinterpret_cast<uint4*>(base) + chunk * c_vecs;
}

// Eight bf16 lanes added in fp32, rounded to bf16.
__device__ __forceinline__ uint4 add_bf16x8(uint4 a, uint4 b) {
  const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
  uint4 r;
  __nv_bfloat162* pr = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 fa = __bfloat1622float2(pa[k]), fb = __bfloat1622float2(pb[k]);
    pr[k] = __floats2bfloat162_rn(fa.x + fb.x, fa.y + fb.y);
  }
  return r;
}

// Piece p of a chunk: its first vector and its vector count.
__device__ __forceinline__ void piece(const Params& P, long long p, long long* v0, int* nv) {
  *v0 = p * kPieceVecs;
  *nv = (int)min(kPieceVecs, P.c_vecs - *v0);
}

// Flag of piece p that rank r receives at ring step k.
__device__ __forceinline__ long long ring_flag(const Params& P, int r, int k, long long p) {
  return ((long long)r * (P.n - 1) + k) * P.n_pc + p;
}

// -- all-gather --------------------------------------------------------------

// x (R, c); out (R, n * c): rank r's slot c at out[r] + c * c_vecs vectors.
__device__ void all_gather_item(const Params& P, int k, int r, long long p) {
  const int n = P.n, me = axis_pos(r, n, P.st);
  const int right = axis_peer(r, (me + 1) % n, n, P.st);
  const int c = ((me - k) % n + n) % n;
  long long v0;
  int nv;
  piece(P, p, &v0, &nv);
  const long long out_chunks = n;   // slots a rank's output holds
  const uint4* src;
  if (k == 0) {
    src = vec_at(P.x, r, P.c_vecs) + v0;
    uint4* own = vec_at(P.out, r * out_chunks + me, P.c_vecs) + v0;
    for (int e = threadIdx.x; e < nv; e += blockDim.x) own[e] = __ldcg(src + e);
    if (P.fault == kWrongChunk)   // the put reads the right neighbour's input
      src = vec_at(P.x, right, P.c_vecs) + v0;
  } else {
    wait_arrivals(P.sync, ring_flag(P, r, k - 1, p), 0, 1, r, k);
    src = vec_at(P.out, r * out_chunks + c, P.c_vecs) + v0;
  }
  if (k < n - 1) {
    uint4* dst = vec_at(P.out, right * out_chunks + c, P.c_vecs) + v0;
    for (int e = threadIdx.x; e < nv; e += blockDim.x) dst[e] = __ldcg(src + e);
    if (P.fault == kLostSignal && r == 0 && k == 0 && p == 0) {
      __syncthreads();
      return;
    }
    signal_block(P.sync, ring_flag(P, right, k, p));
  }
}

// -- reduce-scatter -----------------------------------------------------------

// x (R, n * c) bf16; out (R, c); buf (R, n - 1, c): receive slot k of rank r.
__device__ void reduce_scatter_item(const Params& P, int k, int r, long long p) {
  const int n = P.n, me = axis_pos(r, n, P.st);
  const int right = axis_peer(r, (me + 1) % n, n, P.st);
  const int c = ((me - k - 1) % n + n) % n;
  long long v0;
  int nv;
  piece(P, p, &v0, &nv);
  const uint4* own = vec_at(P.x, (long long)r * n + c, P.c_vecs) + v0;
  const uint4* in = nullptr;
  if (k > 0) {
    wait_arrivals(P.sync, ring_flag(P, r, k - 1, p), 0, 1, r, k);
    if (!(P.fault == kDropPartial && k == n - 1))
      in = vec_at(P.buf, (long long)r * (n - 1) + k - 1, P.c_vecs) + v0;
  }
  uint4* dst = k < n - 1 ? vec_at(P.buf, (long long)right * (n - 1) + k, P.c_vecs) + v0
                         : vec_at(P.out, r, P.c_vecs) + v0;
  for (int e = threadIdx.x; e < nv; e += blockDim.x) {
    const uint4 v = __ldcg(own + e);
    dst[e] = in != nullptr ? add_bf16x8(v, __ldcg(in + e)) : v;
  }
  if (k < n - 1) {
    if (P.fault == kLostSignal && r == 0 && k == 0 && p == 0) {
      __syncthreads();
      return;
    }
    signal_block(P.sync, ring_flag(P, right, k, p));
  }
}

// -- one-shot all-reduce ------------------------------------------------------

// Flag of piece p that rank r receives from group position q.
__device__ __forceinline__ long long gather_flag(const Params& P, int r, int q, long long p) {
  return ((long long)r * P.n + q) * P.n_pc + p;
}

// x (R, c) bf16; buf (R, n, c): gather slot q of rank r.
__device__ void all_reduce_put_item(const Params& P, int r, long long p) {
  const int n = P.n, me = axis_pos(r, n, P.st);
  long long v0;
  int nv;
  piece(P, p, &v0, &nv);
  const uint4* src = vec_at(P.x, r, P.c_vecs) + v0;
  for (int e = threadIdx.x; e < nv; e += blockDim.x) {
    const uint4 v = __ldcg(src + e);
    for (int q = 0; q < n; ++q)
      if (q != me) vec_at(P.buf, (long long)axis_peer(r, q, n, P.st) * n + me, P.c_vecs)[v0 + e] = v;
  }
  fence();
  __syncthreads();
  if (threadIdx.x == 0)
    for (int q = 0; q < n; ++q) {
      if (q == me || (P.fault == kLostSignal && r == 0 && p == 0 && q == (me + 1) % n)) continue;
      signal_op(P.sync, gather_flag(P, axis_peer(r, q, n, P.st), me, p));
    }
}

__device__ void all_reduce_sum_item(const Params& P, int r, long long p) {
  const int n = P.n, me = axis_pos(r, n, P.st);
  long long v0;
  int nv;
  piece(P, p, &v0, &nv);
  // Thread 0 waits for the n - 1 arrivals (a timed-out wait is recorded
  // and the sum goes on over whatever is there: the host raises).
  if (threadIdx.x == 0) {
    for (int q = 0; q < n; ++q)
      if (q != me) signal_wait_until(P.sync, gather_flag(P, r, q, p), r, q);
    fence();
  }
  __syncthreads();
  const int dropped = P.fault == kDropPartial ? (me + 1) % n : -1;
  uint4* dst = vec_at(P.out, r, P.c_vecs) + v0;
  for (int e = threadIdx.x; e < nv; e += blockDim.x) {
    float acc[8];
#pragma unroll
    for (int l = 0; l < 8; ++l) acc[l] = 0.f;
    for (int q = 0; q < n; ++q) {
      if (q == dropped) continue;
      const uint4 v = q == me ? __ldcg(vec_at(P.x, r, P.c_vecs) + v0 + e)
                              : __ldcg(vec_at(P.buf, (long long)r * n + q, P.c_vecs) + v0 + e);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const float2 f = __bfloat1622float2(h[l]);
        acc[2 * l] += f.x;
        acc[2 * l + 1] += f.y;
      }
    }
    uint4 o;
    __nv_bfloat162* ho = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int l = 0; l < 4; ++l) ho[l] = __floats2bfloat162_rn(acc[2 * l], acc[2 * l + 1]);
    dst[e] = o;
  }
}

// -- full-mesh all-gather -----------------------------------------------------

// x (R, c); out (R, n * c): rank r's slot q at out + (r * n + q) * c bytes.
// Flag of piece p that rank r receives from group position q: gather_flag.
__device__ void full_mesh_put_item(const Params& P, int r, int q, long long p) {
  const int n = P.n, me = axis_pos(r, n, P.st);
  const int dst = axis_peer(r, q, n, P.st), right = axis_peer(r, (me + 1) % n, n, P.st);
  long long b0, nb;
  piece_bytes(P.c_bytes, p, &b0, &nb);
  const int src = P.fault == kWrongChunk && q == (me + 1) % n ? right : r;
  copy_bytes(P.out + ((long long)dst * n + me) * P.c_bytes + b0,
             P.x + (long long)src * P.c_bytes + b0, nb);
  if (q == me || (P.fault == kLostSignal && r == 0 && q == (me + 1) % n && p == 0)) return;
  signal_block(P.sync, gather_flag(P, dst, me, p));
}

// Rank r's n - 1 arrivals: every piece flag of every other position.
__device__ void full_mesh_wait_item(const Params& P, int r) {
  const int me = axis_pos(r, P.n, P.st);
  wait_flags(P.sync, gather_flag(P, r, 0, 0), (int)(me * P.n_pc), r, 0);
  wait_flags(P.sync, gather_flag(P, r, me + 1, 0), (int)((P.n - 1 - me) * P.n_pc), r, 0);
}

__global__ void __launch_bounds__(kThreads) full_mesh_kernel(Params P) {
  const long long puts = (long long)P.R * P.n * P.n_pc;
  for (long long item = blockIdx.x; item < puts + P.R; item += gridDim.x) {
    if (item < puts) {
      full_mesh_put_item(P, (int)(item / (P.n * P.n_pc)), (int)(item / P.n_pc % P.n),
                         item % P.n_pc);
    } else {
      full_mesh_wait_item(P, (int)(item - puts));
    }
    __syncthreads();
  }
}

// -- recursive halving-doubling all-reduce -------------------------------------

// x, out (R, n * c) of T; buf (R, n - 1, c): rank r's packed receive
// regions, step s's at chunk n - (n >> s). Flags: one range per step, the
// halving steps s = 0 .. logn - 1, then the doubling bits b at 2 logn - 1 - b
// (JAX's send_sem.at[logn + s] with s = logn - 1 - b); in each, the flag of
// piece p of chunk c that rank r receives.
__device__ __forceinline__ long long rhd_flag(const Params& P, int step, int r, int c,
                                              long long p) {
  return (((long long)step * P.R + r) * P.n + c) * P.n_pc + p;
}

// Where chunk c lands in the receive region of halving step s.
__device__ __forceinline__ long long rhd_slot(const Params& P, int s, int c) {
  return (P.n - (P.n >> s)) + (c & ((P.n >> (s + 1)) - 1));
}

__device__ __forceinline__ char* chunk_at(char* base, const Params& P, int r, long long chunk) {
  return base + ((long long)r * P.n + chunk) * P.c_bytes;
}

__device__ __forceinline__ char* recv_at(const Params& P, int r, long long slot) {
  return P.buf + ((long long)r * (P.n - 1) + slot) * P.c_bytes;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) { return __float2bfloat16_rn(v); }

constexpr int kMaxDsts = 8;     // the owner's output and its log2 n <= 6 peers'

// Block-wide: for each element of a piece of nb bytes, acc = src, then acc
// = T(acc + part) for each of the n_parts received parts in step order,
// stored to each of the n_dsts destinations; V elements (16 bytes a thread
// where every address allows it, else one element) a thread per step.
template <typename T, typename V>
__device__ void sum_piece_as(const char* src, const char* const* parts, int n_parts,
                             char* const* dsts, int n_dsts, long long nb) {
  constexpr int kLanes = sizeof(V) / sizeof(T);
  for (long long i = threadIdx.x; i < nb / (long long)sizeof(V); i += blockDim.x) {
    V v = __ldcg(reinterpret_cast<const V*>(src) + i);
    float acc[kLanes];
#pragma unroll
    for (int l = 0; l < kLanes; ++l) acc[l] = to_float(reinterpret_cast<const T*>(&v)[l]);
    for (int k = 0; k < n_parts; ++k) {
      v = __ldcg(reinterpret_cast<const V*>(parts[k]) + i);
#pragma unroll
      for (int l = 0; l < kLanes; ++l)
        acc[l] = to_float(from_float<T>(acc[l] + to_float(reinterpret_cast<const T*>(&v)[l])));
    }
#pragma unroll
    for (int l = 0; l < kLanes; ++l) reinterpret_cast<T*>(&v)[l] = from_float<T>(acc[l]);
    for (int d = 0; d < n_dsts; ++d) reinterpret_cast<V*>(dsts[d])[i] = v;
  }
}

template <typename T>
__device__ void sum_piece(const char* src, const char* const* parts, int n_parts,
                          char* const* dsts, int n_dsts, long long nb) {
  unsigned long long a = reinterpret_cast<unsigned long long>(src) | (unsigned long long)nb;
  for (int k = 0; k < n_parts; ++k) a |= reinterpret_cast<unsigned long long>(parts[k]);
  for (int d = 0; d < n_dsts; ++d) a |= reinterpret_cast<unsigned long long>(dsts[d]);
  if (a % 16 == 0)
    sum_piece_as<T, uint4>(src, parts, n_parts, dsts, n_dsts, nb);
  else if constexpr (sizeof(T) == 4)
    sum_piece_as<T, unsigned int>(src, parts, n_parts, dsts, n_dsts, nb);
  else
    sum_piece_as<T, unsigned short>(src, parts, n_parts, dsts, n_dsts, nb);
}

// Halving item of level k for rank r (position me) and piece p of chunk c.
template <typename T>
__device__ void rhd_halving_item(const Params& P, int k, int r, int me, int c, long long p) {
  const int logn = P.logn;
  long long b0, nb;
  piece_bytes(P.c_bytes, p, &b0, &nb);
  const long long stride = (long long)P.R * P.n * P.n_pc;   // flags of one step
  if (k > 0) wait_arrivals(P.sync, rhd_flag(P, 0, r, c, p), stride, k, r, -1);
  const char* parts[kMaxDsts];
  int n_parts = 0;
  for (int s = 0; s < k; ++s)
    if (!(P.fault == kDropPartial && s == 0)) parts[n_parts++] = recv_at(P, r, rhd_slot(P, s, c)) + b0;
  char* dsts[kMaxDsts];
  int n_dsts = 0;
  int peer_of[kMaxDsts];
  if (k < logn) {
    const int partner = axis_peer(r, me ^ (1 << (logn - 1 - k)), P.n, P.st);
    peer_of[0] = partner;
    dsts[n_dsts++] = recv_at(P, partner, rhd_slot(P, k, c)) + b0;
  } else {
    dsts[n_dsts++] = chunk_at(P.out, P, r, c) + b0;
    for (int b = 0; b < logn; ++b) {
      const int peer = axis_peer(r, me ^ (1 << b), P.n, P.st);
      peer_of[n_dsts] = peer;
      dsts[n_dsts++] = chunk_at(P.out, P, peer, c) + b0;
    }
  }
  sum_piece<T>(chunk_at(const_cast<char*>(P.x), P, r, c) + b0, parts, n_parts, dsts, n_dsts, nb);
  fence();
  __syncthreads();
  if (threadIdx.x != 0) return;
  if (k < logn) {
    if (!(P.fault == kLostSignal && r == 0 && k == 0 && p == 0))
      signal_op(P.sync, rhd_flag(P, k, peer_of[0], c, p));
  } else {
    for (int b = 0; b < logn; ++b)
      signal_op(P.sync, rhd_flag(P, 2 * logn - 1 - b, peer_of[1 + b], c, p));
  }
}

// Doubling item for rank r (position me), chunk c whose highest differing
// bit with me is h, piece p: wait for the arrival at bit h, forward above it.
__device__ void rhd_doubling_item(const Params& P, int h, int r, int me, int c, long long p) {
  const int logn = P.logn;
  long long b0, nb;
  piece_bytes(P.c_bytes, p, &b0, &nb);
  wait_arrivals(P.sync, rhd_flag(P, 2 * logn - 1 - h, r, c, p), 0, 1, r, -1);
  const char* held = chunk_at(P.out, P, r, c) + b0;
  for (int b = h + 1; b < logn; ++b) {
    const int peer = axis_peer(r, me ^ (1 << b), P.n, P.st);
    copy_bytes(chunk_at(P.out, P, peer, c) + b0, held, nb);
  }
  fence();
  __syncthreads();
  if (threadIdx.x == 0)
    for (int b = h + 1; b < logn; ++b)
      signal_op(P.sync, rhd_flag(P, 2 * logn - 1 - b, axis_peer(r, me ^ (1 << b), P.n, P.st), c, p));
}

// Items: the halving levels k = 0 .. logn (2^(logn - 1 - k) ranks of a group
// per chunk at k < logn, one at logn), then the doubling ones h = 0 .. logn -
// 1 (2^h ranks a chunk), each level's items (group, c, j, piece).
template <typename T>
__global__ void __launch_bounds__(kThreads) rhd_kernel(Params P) {
  const int logn = P.logn;
  const long long groups = P.R / P.n;
  const long long per_rank = (long long)P.n * P.n_pc;   // (c, piece) pairs
  const long long total = groups * per_rank * (2 * P.n - 1);
  for (long long item = blockIdx.x; item < total; item += gridDim.x) {
    long long i = item;
    int seg = 0, cnt = 0;
    for (; seg <= 2 * logn; ++seg) {
      cnt = seg < logn ? 1 << (logn - 1 - seg) : seg == logn ? 1 : 1 << (seg - logn - 1);
      const long long size = groups * per_rank * cnt;
      if (i < size) break;
      i -= size;
    }
    const long long p = i % P.n_pc;
    long long rest = i / P.n_pc;
    const int j = (int)(rest % cnt);
    rest /= cnt;
    const int c = (int)(rest % P.n);
    const long long g = rest / P.n;
    if (seg <= logn) {
      const int me = seg < logn ? c ^ (1 << (logn - 1 - seg)) ^ j : c;
      rhd_halving_item<T>(P, seg, group_rank(g, me, P.n, P.st), me, c, p);
    } else {
      const int h = seg - logn - 1;
      const int me = c ^ (1 << h) ^ j;
      rhd_doubling_item(P, h, group_rank(g, me, P.n, P.st), me, c, p);
    }
    __syncthreads();
  }
}

// -- kernels ------------------------------------------------------------------

enum Op { kAllGather = 0, kReduceScatter = 1, kAllReduce = 2, kAllGatherFullMesh = 3,
          kAllReduceRhd = 4 };

template <int OP>
__global__ void __launch_bounds__(kThreads) collective_kernel(Params P) {
  const long long per_step = (long long)P.R * P.n_pc;
  const long long total = (OP == kAllReduce ? 2 : P.n) * per_step;
  for (long long item = blockIdx.x; item < total; item += gridDim.x) {
    const int k = (int)(item / per_step);
    const long long rem = item % per_step;
    const int r = (int)(rem / P.n_pc);
    const long long p = rem % P.n_pc;
    if (OP == kAllGather) {
      all_gather_item(P, k, r, p);
    } else if (OP == kReduceScatter) {
      reduce_scatter_item(P, k, r, p);
    } else if (k == 0) {
      all_reduce_put_item(P, r, p);
    } else {
      all_reduce_sum_item(P, r, p);
    }
    __syncthreads();
  }
}

// Validates, fills Params and launches op OP; elem_bytes is the recursive
// all-reduce's element size (2: bf16, 4: fp32).
template <int OP>
int launch(const void* x, void* out, void* buf, long long c_bytes, int R, int n, int st,
           void* flags, void* abort_word, unsigned long long epoch, unsigned long long timeout_ns,
           int fault, int device, void* stream, int elem_bytes = 0) {
  int logn = 0;
  while ((1 << logn) < n) ++logn;
  constexpr bool rings = OP == kAllGather || OP == kReduceScatter || OP == kAllReduce;
  if (R < 1 || n < 1 || st < 1 || R % (n * st) || c_bytes < 1 || epoch == 0 ||
      timeout_ns == 0 || (OP != kAllGather && n < 2) ||
      (rings && (c_bytes < 16 || c_bytes % 16)) ||
      (OP == kAllReduceRhd && ((1 << logn) != n || logn > 6 ||
                               (elem_bytes != 2 && elem_bytes != 4) || c_bytes % elem_bytes)))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = ensure_error_record();
  if (e != cudaSuccess) return (int)e;
  Params P;
  P.x = static_cast<const char*>(x);
  P.out = static_cast<char*>(out);
  P.buf = static_cast<char*>(buf);
  P.c_vecs = c_bytes / 16;
  P.c_bytes = c_bytes;
  P.n_pc = (c_bytes + kPieceBytes - 1) / kPieceBytes;
  P.R = R;
  P.n = n;
  P.st = st;
  P.fault = fault;
  P.logn = logn;
  P.sync.flags = static_cast<u64*>(flags);
  P.sync.abort = static_cast<u64*>(abort_word);
  P.sync.err = g_err_dev;
  P.sync.epoch = epoch;
  P.sync.timeout_ns = timeout_ns;
  const void* kernel;
  long long items;
  if constexpr (rings) {
    kernel = reinterpret_cast<const void*>(collective_kernel<OP>);
    items = (OP == kAllReduce ? 2 : n) * (long long)R * P.n_pc;
  } else if constexpr (OP == kAllGatherFullMesh) {
    kernel = reinterpret_cast<const void*>(full_mesh_kernel);
    items = (long long)R * n * P.n_pc + R;
  } else {
    kernel = elem_bytes == 2 ? reinterpret_cast<const void*>(rhd_kernel<bf16>)
                             : reinterpret_cast<const void*>(rhd_kernel<float>);
    items = (long long)R * P.n_pc * (2 * n - 1);
  }
  void* args[] = {&P};
  return (int)cooperative_launch(kernel, kThreads, 0, items, args, device,
                                 static_cast<cudaStream_t>(stream));
}

}  // namespace

// Plain C interfaces for ctypes. Every rank's operand and output are
// contiguous with a leading rank dimension of R; the axis has size n and
// stride st (R a multiple of n * st); c_bytes is one chunk's bytes (a
// multiple of 16, the buffers 16-byte aligned). flags: the workspace's
// R * (n - 1) * n_pc (rings) or R * n * n_pc (all-reduce) flag words, n_pc
// = ceil(c_bytes / 8 KiB), then its abort word. epoch: this call's (>= 1);
// timeout_ns bounds every wait; fault: 0, or a planted fault (1: all-gather
// puts the right neighbour's input at step 0 / the reductions drop the
// partial received last, 2: rank 0's first piece never signalled). Return a
// cudaError_t code (0 = launched).

// x (R, c) any type; out (R, n * c).
extern "C" int tdt_all_gather_ring(const void* x, void* out, long long c_bytes, int R, int n,
                                   int st, void* flags, void* abort_word,
                                   unsigned long long epoch, unsigned long long timeout_ns,
                                   int fault, int device, void* stream) {
  return launch<kAllGather>(x, out, nullptr, c_bytes, R, n, st, flags, abort_word, epoch,
                            timeout_ns, fault, device, stream);
}

// x (R, n * c) bf16; out (R, c); recv (R, n - 1, c) bf16 receive slots.
extern "C" int tdt_reduce_scatter_ring_bf16(const void* x, void* out, void* recv,
                                            long long c_bytes, int R, int n, int st, void* flags,
                                            void* abort_word, unsigned long long epoch,
                                            unsigned long long timeout_ns, int fault, int device,
                                            void* stream) {
  return launch<kReduceScatter>(x, out, recv, c_bytes, R, n, st, flags, abort_word, epoch,
                                timeout_ns, fault, device, stream);
}

// x (R, c) bf16; out (R, c); gather (R, n, c) bf16 gather slots.
extern "C" int tdt_all_reduce_one_shot_bf16(const void* x, void* out, void* gather,
                                            long long c_bytes, int R, int n, int st, void* flags,
                                            void* abort_word, unsigned long long epoch,
                                            unsigned long long timeout_ns, int fault, int device,
                                            void* stream) {
  return launch<kAllReduce>(x, out, gather, c_bytes, R, n, st, flags, abort_word, epoch,
                            timeout_ns, fault, device, stream);
}

// x (R, c) any type, any byte count; out (R, n * c). flags: R * n * n_pc
// (rank r's piece p from position q at (r * n + q) * n_pc + p).
extern "C" int tdt_all_gather_full_mesh(const void* x, void* out, long long c_bytes, int R, int n,
                                        int st, void* flags, void* abort_word,
                                        unsigned long long epoch, unsigned long long timeout_ns,
                                        int fault, int device, void* stream) {
  return launch<kAllGatherFullMesh>(x, out, nullptr, c_bytes, R, n, st, flags, abort_word, epoch,
                                    timeout_ns, fault, device, stream);
}

// x (R, n * c) of bf16 (elem_bytes 2) or fp32 (4), c_bytes one chunk's
// bytes (rows / n rows); out (R, n * c); recv (R, n - 1, c) receive regions;
// n a power of two <= 64. flags: 2 log2(n) * R * n * n_pc (see rhd_flag).
extern "C" int tdt_all_reduce_rhd(const void* x, void* out, void* recv, long long c_bytes, int R,
                                  int n, int st, void* flags, void* abort_word,
                                  unsigned long long epoch, unsigned long long timeout_ns,
                                  int fault, int elem_bytes, int device, void* stream) {
  return launch<kAllReduceRhd>(x, out, recv, c_bytes, R, n, st, flags, abort_word, epoch,
                               timeout_ns, fault, device, stream, elem_bytes);
}
