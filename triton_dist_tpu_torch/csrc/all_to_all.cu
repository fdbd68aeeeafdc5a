// Direct-put all-to-all across simulated ranks on Hopper (sm_90a): rows of
// any element type, moved as bytes.
//
// all_to_all_kernel replaces triton_dist_tpu/ops/all_to_all.py _a2a_kernel
// (:33). Sender s holds n chunks, chunk d bound for receiver d; receiver d
// ends with sender s's chunk d in its slot s:
//
//   out[d][s] = x[s][d]
//
// Dense form (the capped EP dispatch/combine, ops/ep_a2a.py :478-479 and
// :510-511): every chunk is C rows, x[s] is (n, C, row) and out[d] is
// (n, C, row). Ragged form (the drop-free hop of ops/ep_a2a.py _ragged_a2a,
// which is lax.ragged_all_to_all on the TPU): three (n, n) int32 matrices on
// the device, indexed [sender, receiver], give each chunk's first row in the
// sender's rows (in_off), its row count (sizes) and its first row in the
// receiver's rows (out_off). Only the real rows move, and nothing is read on
// the host.
//
// The protocol is the JAX kernel's: the local chunk is copied locally, the
// n - 1 remote chunks are put straight into the peer's slot (16 bytes a
// thread where the rows allow), each put is published by a signal, and each
// receiver waits for its n - 1 senders' arrivals. A chunk moves in row blocks
// of rb_rows rows; each row block of a remote chunk has its own flag
// (receiver, sender, row block), so the receiver waits for (n - 1) * n_rb
// flags, polled by all of its block's threads at once. In a ragged chunk the
// row blocks past its row count move nothing and only signal.
//
// Work items, in the order every block walks them (each waits only on a
// lower-numbered item, see shmem_device.cuh): the puts (sender, peer offset,
// row block), peer offset 0 being the local copy, then one wait per
// receiver.
//
// What bounds it on the H100: bytes. Each row is read once and written once:
// at Qwen3-30B-A3B tp = 4 (4 ranks x 4 peers x C 2048 x 2048 bf16) 134 MB
// each way, 0.080 ms at 3.35 TB/s. This first design is a plain grid-stride
// copy of 16-byte vectors per row block (about 64 KB an item): no TMA bulk
// copies (PERF.md).

#include "shmem_device.cuh"

namespace {

using namespace tdt;

enum Fault { kNoFault = 0, kSlotOffByOne = 1, kLostSignal = 2 };

constexpr int kThreads = 256;

struct Params {
  const char* src;     // sender s's rows at src + s * src_rank
  char* out;           // receiver d's rows at out + d * out_rank
  const int* in_off;   // (n, n) [sender, receiver], or null: the dense form
  const int* sizes;
  const int* out_off;
  long long src_rank, out_rank, row_bytes;  // bytes
  int n, chunk_rows, out_rows, rb_rows, n_rb, unit, fault;
  Sync sync;
};

// Chunk (s, d): its first row at the sender, its rows, its first row at the
// receiver.
__device__ __forceinline__ void chunk(const Params& P, int s, int d, long long* src_row,
                                      long long* rows, long long* dst_row) {
  if (P.sizes == nullptr) {
    *src_row = (long long)d * P.chunk_rows;
    *rows = P.chunk_rows;
    *dst_row = (long long)s * P.chunk_rows;
  } else {
    const int i = s * P.n + d;
    *src_row = __ldg(P.in_off + i);
    *rows = __ldg(P.sizes + i);
    *dst_row = __ldg(P.out_off + i);
  }
}

// Block-wide copy of len bytes, `unit` bytes (16, 4 or 1) a thread per step;
// both ends and len are multiples of unit.
__device__ __forceinline__ void copy_bytes(char* dst, const char* src, long long len, int unit) {
  if (unit == 16) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (long long i = threadIdx.x; i < len / 16; i += blockDim.x) d[i] = s[i];
  } else if (unit == 4) {
    const unsigned* s = reinterpret_cast<const unsigned*>(src);
    unsigned* d = reinterpret_cast<unsigned*>(dst);
    for (long long i = threadIdx.x; i < len / 4; i += blockDim.x) d[i] = s[i];
  } else {
    for (long long i = threadIdx.x; i < len; i += blockDim.x) dst[i] = src[i];
  }
}

__device__ __forceinline__ long long flag(const Params& P, int d, int s, int rb) {
  return ((long long)d * P.n + s) * P.n_rb + rb;
}

// Row block rb of chunk (s, d): put, then signal receiver d (a remote chunk).
__device__ void put_item(const Params& P, int s, int d, int rb) {
  long long src_row, rows, dst_row;
  chunk(P, s, d, &src_row, &rows, &dst_row);
  if (P.fault == kSlotOffByOne && s == 0 && d == 1 % P.n) {
    // A planted fault: rank 0's chunk lands in the slot of sender 1.
    long long unused_src, unused_rows;
    chunk(P, 1 % P.n, d, &unused_src, &unused_rows, &dst_row);
  }
  if (dst_row + rows > P.out_rows) rows = P.out_rows - dst_row;
  const long long r0 = (long long)rb * P.rb_rows;
  long long cnt = rows - r0;
  if (cnt > P.rb_rows) cnt = P.rb_rows;
  if (cnt > 0)
    copy_bytes(P.out + d * P.out_rank + (dst_row + r0) * P.row_bytes,
               P.src + s * P.src_rank + (src_row + r0) * P.row_bytes, cnt * P.row_bytes, P.unit);
  if (s == d) return;                  // the local chunk: no arrival to signal
  if (P.fault == kLostSignal && s == 0 && d == 1 % P.n && rb == 0) return;
  signal_block(P.sync, flag(P, d, s, rb));
}

// Receiver d: wait for every row block of its n - 1 remote chunks, each of
// the block's threads polling its share of the flags.
__device__ void wait_item(const Params& P, int d) {
  const int count = (P.n - 1) * P.n_rb;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int s = (d + 1 + i / P.n_rb) % P.n;
    signal_wait_until(P.sync, flag(P, d, s, i % P.n_rb), d, s);
  }
  fence();
}

__global__ void __launch_bounds__(kThreads) all_to_all_kernel(Params P) {
  const long long puts = (long long)P.n * P.n * P.n_rb;
  for (long long item = blockIdx.x; item < puts + P.n; item += gridDim.x) {
    if (item < puts) {
      const int rb = (int)(item % P.n_rb);
      const long long pair = item / P.n_rb;
      const int s = (int)(pair / P.n), d = (s + (int)(pair % P.n)) % P.n;
      put_item(P, s, d, rb);
    } else {
      wait_item(P, (int)(item - puts));
    }
    __syncthreads();
  }
}

}  // namespace

// Plain C interface for ctypes. src: sender s's rows at src + s * src_rank
// bytes, row_bytes each; out: receiver d's out_rows rows at out + d *
// out_rank. Dense form (in_off = sizes = out_off = null): chunk d of sender
// s is its rows [d * chunk_rows, (d + 1) * chunk_rows) and lands at the
// receiver's rows [s * chunk_rows, ...). Ragged form: the three (n, n) int32
// device matrices [sender, receiver] give each chunk's first sender row, row
// count and first receiver row; chunk_rows is the most rows a chunk can hold
// (a sender's row count). A chunk moves in row blocks of rb_rows rows; flags:
// the workspace's n * n * ceil(chunk_rows / rb_rows) words then its abort
// word. epoch: this call's (>= 1); timeout_ns bounds every wait; fault: 0,
// or a planted fault (1: rank 0's chunk for rank 1 lands in the slot of
// sender 1; 2: rank 0's first signal to rank 1 never sent). Returns a
// cudaError_t code (0 = launched).
extern "C" int tdt_all_to_all(const void* src, void* out, const void* in_off, const void* sizes,
                              const void* out_off, long long src_rank, long long out_rank,
                              long long row_bytes, int n, int chunk_rows, int out_rows,
                              int rb_rows, void* flags, void* abort_word,
                              unsigned long long epoch, unsigned long long timeout_ns, int fault,
                              int device, void* stream) {
  const bool ragged = sizes != nullptr;
  if (n < 1 || chunk_rows < 1 || out_rows < 1 || rb_rows < 1 || row_bytes < 1 ||
      epoch == 0 || timeout_ns == 0 || (ragged && (in_off == nullptr || out_off == nullptr)) ||
      (!ragged && (in_off != nullptr || out_off != nullptr || out_rows != n * chunk_rows)))
    return (int)cudaErrorInvalidValue;
  Params P;
  P.src = static_cast<const char*>(src);
  P.out = static_cast<char*>(out);
  P.in_off = static_cast<const int*>(in_off);
  P.sizes = static_cast<const int*>(sizes);
  P.out_off = static_cast<const int*>(out_off);
  P.src_rank = src_rank;
  P.out_rank = out_rank;
  P.row_bytes = row_bytes;
  P.n = n;
  P.chunk_rows = chunk_rows;
  P.out_rows = out_rows;
  P.rb_rows = rb_rows;
  P.n_rb = (chunk_rows + rb_rows - 1) / rb_rows;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(out);
  const long long strides = row_bytes | src_rank | out_rank;
  P.unit = (strides % 16 == 0 && addr % 16 == 0) ? 16 : (strides % 4 == 0 && addr % 4 == 0) ? 4 : 1;
  P.fault = fault;
  P.sync.flags = static_cast<u64*>(flags);
  P.sync.abort = static_cast<u64*>(abort_word);
  P.sync.epoch = epoch;
  P.sync.timeout_ns = timeout_ns;
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = ensure_error_record();
  if (e != cudaSuccess) return (int)e;
  P.sync.err = g_err_dev;
  void* args[] = {&P};
  const long long items = (long long)n * n * P.n_rb + n;
  return (int)cooperative_launch(reinterpret_cast<const void*>(all_to_all_kernel), kThreads, 0,
                                 items, args, device, static_cast<cudaStream_t>(stream));
}
