// Device half of the symmetric-memory protocol that the multi-rank kernels
// (the fused GEMMs ag_gemm.cu, gemm_rs.cu, gemm_ar.cu, ag_moe.cu and
// moe_reduce.cu; the all-to-alls all_to_all.cu and ll_a2a.cu; the ring and
// one-shot collectives collectives.cu; the megakernel's multi-rank
// ALLREDUCE task in megakernel.cu; the tile-fused EP pair ep_fused.cu; the
// sequence-parallel kernels a2a_gemm.cu, ulysses_fused.cu and
// sp_ag_attention.cu; the one-sided puts p2p.cu) run between
// simulated ranks on one Hopper card (sm_90a). Counterpart of the parts of
// triton_dist_tpu/lang/shmem_device.py those kernels use:
//
//   remote_put            :125  copy rows into a peer rank's slice
//   putmem_signal_block   :182  remote_put, then signal_block (a block's
//                               stores published by one flag)
//   signal_op             :540  release-store the epoch into a flag
//   signal_wait_until     :566  spin until a flag reaches the epoch
//   wait_arrivals         :583  the same over several flags
//   fence / quiet         :462 / :478  fence (a put is a plain store,
//                               complete when issued: quiet is fence)
//
// The ranks of a mesh live in one process on one device
// (triton_dist_tpu_torch/parallel/mesh.py): a symmetric buffer is one
// allocation with a leading rank dimension, and a "peer" is another rank's
// slice of it. Every rank's thread blocks run in the same cooperative launch,
// so a rank's blocks spin on flags that another rank's blocks write.
//
// Flags are 64-bit words of a persistent workspace
// (triton_dist_tpu_torch/shmem/workspace.py). Every call has a new epoch: a
// signal stores it, a wait compares flag >= epoch, and flags are never
// cleared, so a flag of call e cannot satisfy a wait of call e + 1. A kernel
// whose puts cross two hops of an (outer x inner) mesh keeps the inner hop's
// flags first and the outer hop's after them, under the one epoch, so a
// timed-out wait's slot names its hop. Memory
// order: the writer's data stores, __threadfence(), __syncthreads(), then one
// thread's st.release.gpu of the flag; the reader's one thread spins on
// ld.acquire.gpu, __threadfence(), __syncthreads(), then every thread reads
// the data with L1-bypassing loads (ld.global.cg / cp.async.cg).
//
// A wait never hangs the run: past timeout_ns (%globaltimer) it records
// (rank, step, slot, epoch) in host-mapped memory, stores the epoch into the
// workspace's abort word, and gives up; every other wait of the launch sees
// the abort word and gives up at once, so the launch ends and the host
// wrapper raises CommTimeoutError (there is no silent fallback: the record
// stays set until the host has read it).
//
// Work items of a launch are numbered so that an item waits only on items
// with lower numbers, and every block walks its items (blockIdx.x, + grid,
// ...) in increasing order. With every block resident (a cooperative launch
// no larger than occupancy x SMs) the lowest unfinished item then always has
// its inputs ready, so the protocol cannot deadlock.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace tdt {

typedef unsigned long long u64;
using bf16 = __nv_bfloat16;

__device__ __forceinline__ u64 ld_acquire(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(u64* p, u64 v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ u64 globaltimer() {
  u64 t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// What a launch needs to signal and wait: the workspace's flags and abort
// word, this call's epoch, the wait bound and the host-mapped error record
// [set, rank, step, slot, epoch low 32 bits, epoch high 32 bits].
struct Sync {
  u64* flags;
  u64* abort;
  int* err;
  u64 epoch;
  u64 timeout_ns;
};

// -- where a rank sits in its mesh (triton_dist_tpu_torch/parallel/mesh.py) --
//
// Flat rank r is row-major over the mesh's axes. On an (outer x inner) mesh
// r = o * n_in + i; an op over one axis of size n whose neighbours lie st
// flat ranks apart (the product of the sizes inside it) runs in every group
// of ranks that share their other coordinates.

struct Coord2 {
  int o, i;
};

// Rank r's (outer, inner) coordinates, and back (JAX's flat_axis_rank).
__host__ __device__ __forceinline__ Coord2 coords_of(int r, int n_in) {
  return Coord2{r / n_in, r % n_in};
}
__host__ __device__ __forceinline__ int rank_of(int o, int i, int n_in) { return o * n_in + i; }

// Rank r's position along an axis of size n and stride st, and the flat
// rank at position p of r's group (JAX's logical_device_id).
__host__ __device__ __forceinline__ int axis_pos(int r, int n, int st) { return (r / st) % n; }
__host__ __device__ __forceinline__ int axis_peer(int r, int p, int n, int st) {
  return r + (p - axis_pos(r, n, st)) * st;
}

// The flat rank at position p of group g, the groups of an axis numbered
// g = 0 .. R / n - 1 in the order of their lowest flat rank.
__host__ __device__ __forceinline__ int group_rank(long long g, int p, int n, int st) {
  return (int)((g / st) * n * st + (long long)p * st + g % st);
}

// Order this thread's earlier stores before its later ones, device wide.
__device__ __forceinline__ void fence() { __threadfence(); }

// One thread: release-store the epoch into flag `slot`.
__device__ __forceinline__ void signal_op(const Sync& S, long long slot) {
  fence();
  st_release(S.flags + slot, S.epoch);
}

// Block-wide: every thread has stored its share of the data; publish it.
__device__ __forceinline__ void signal_block(const Sync& S, long long slot) {
  fence();
  __syncthreads();
  if (threadIdx.x == 0) signal_op(S, slot);
}

// One thread: spin until flag `slot` reaches the epoch. False when the wait
// timed out here (recorded, abort raised) or another wait of the launch did.
__device__ inline bool signal_wait_until(const Sync& S, long long slot, int rank, int step) {
  const u64* f = S.flags + slot;
  if (ld_acquire(f) >= S.epoch) return true;
  const u64 t0 = globaltimer();
  unsigned ns = 32;
  for (;;) {
    if (ld_acquire(f) >= S.epoch) return true;
    if (ld_acquire(S.abort) >= S.epoch) return false;
    if (globaltimer() - t0 > S.timeout_ns) {
      // The first wait of the launch to time out raises the abort word
      // (device memory, so the gate is atomic) and writes the record,
      // unless an earlier record is still unread.
      const u64 old = ld_acquire(S.abort);
      if (old < S.epoch && atomicCAS(S.abort, old, S.epoch) == old) {
        volatile int* err = S.err;
        if (err[0] == 0) {
          err[1] = rank;
          err[2] = step;
          err[3] = (int)slot;
          err[4] = (int)(S.epoch & 0xffffffffu);
          err[5] = (int)(S.epoch >> 32);
          __threadfence_system();
          err[0] = 1;
          __threadfence_system();
        }
      }
      return false;
    }
    __nanosleep(ns);
    if (ns < 1024) ns *= 2;
  }
}

// Block-wide: wait until `count` flags (slot, slot + stride, ...) reach the
// epoch. Thread 0 polls; every thread may read the data afterwards. Returns
// false after a timeout (the caller's item then computes on whatever is
// there: the launch is failed and the host raises).
__device__ inline bool wait_arrivals(const Sync& S, long long slot, long long stride, int count,
                                     int rank, int step) {
  __shared__ int ok;
  if (threadIdx.x == 0) {
    bool all = true;
    for (int i = 0; i < count; ++i)
      all = signal_wait_until(S, slot + i * stride, rank, step) && all;
    fence();
    ok = all;
  }
  __syncthreads();
  const bool r = ok != 0;
  __syncthreads();
  return r;
}

// Block-wide: wait until the `count` consecutive flags from `slot` reach the
// epoch, every thread polling its share of them at once (a wait on many
// flags: a whole chunk's row blocks, every tile bound for one rank). False
// after a timeout, as wait_arrivals.
__device__ inline bool wait_flags(const Sync& S, long long slot, int count, int rank, int step) {
  __shared__ int bad;
  if (threadIdx.x == 0) bad = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < count; i += blockDim.x)
    if (!signal_wait_until(S, slot + i, rank, step)) {
      bad = 1;
      break;
    }
  fence();
  __syncthreads();
  const bool ok = bad == 0;
  __syncthreads();
  return ok;
}

// Block-wide copy of rows x cols bf16 (cols a multiple of 8, rows 16-byte
// aligned) from src (row pitch ld_src) to a peer's dst (row pitch ld_dst),
// 16 bytes a thread per step, loads past L1.
__device__ inline void remote_put(bf16* dst, long long ld_dst, const bf16* src, long long ld_src,
                                  int rows, int cols) {
  const int vec = cols / 8;
  for (int i = threadIdx.x; i < rows * vec; i += blockDim.x) {
    const int r = i / vec, c = (i % vec) * 8;
    const uint4 v = __ldcg(reinterpret_cast<const uint4*>(src + r * ld_src + c));
    *reinterpret_cast<uint4*>(dst + r * ld_dst + c) = v;
  }
}

// The byte-moving kernels (p2p.cu, the full-mesh all-gather and the
// recursive all-reduce of collectives.cu) move a chunk in pieces of
// kPieceBytes, each with its own flag.
constexpr long long kPieceBytes = 8192;

// Byte range of piece p of a chunk of c_bytes: its first byte, its count.
__device__ __forceinline__ void piece_bytes(long long c_bytes, long long p, long long* b0,
                                            long long* nb) {
  *b0 = p * kPieceBytes;
  *nb = min(kPieceBytes, c_bytes - *b0);
}

// Block-wide copy (or zero-fill) of nb bytes at any alignment, for the
// kernels that move rows of any type as bytes (p2p.cu, the full-mesh
// all-gather): 16 bytes a thread per step where both addresses and nb
// allow it, else the widest unit they share; loads past L1, as a peer's
// puts land in L2.
template <typename V>
__device__ __forceinline__ void copy_units(char* dst, const char* src, long long nb) {
  V* d = reinterpret_cast<V*>(dst);
  const V* s = reinterpret_cast<const V*>(src);
  const long long n = nb / (long long)sizeof(V);
  for (long long i = threadIdx.x; i < n; i += blockDim.x) d[i] = __ldcg(s + i);
}

template <typename V>
__device__ __forceinline__ void zero_units(char* dst, long long nb) {
  V* d = reinterpret_cast<V*>(dst);
  const long long n = nb / (long long)sizeof(V);
  for (long long i = threadIdx.x; i < n; i += blockDim.x) d[i] = V{};
}

__device__ __forceinline__ unsigned widest_unit(unsigned long long a) {
  return a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : a % 4 == 0 ? 4 : a % 2 == 0 ? 2 : 1;
}

__device__ inline void copy_bytes(char* dst, const char* src, long long nb) {
  switch (widest_unit(reinterpret_cast<unsigned long long>(dst) |
                      reinterpret_cast<unsigned long long>(src) | (unsigned long long)nb)) {
    case 16: copy_units<uint4>(dst, src, nb); break;
    case 8: copy_units<uint2>(dst, src, nb); break;
    case 4: copy_units<unsigned int>(dst, src, nb); break;
    case 2: copy_units<unsigned short>(dst, src, nb); break;
    default: copy_units<unsigned char>(dst, src, nb);
  }
}

__device__ inline void zero_bytes(char* dst, long long nb) {
  switch (widest_unit(reinterpret_cast<unsigned long long>(dst) | (unsigned long long)nb)) {
    case 16: zero_units<uint4>(dst, nb); break;
    case 8: zero_units<uint2>(dst, nb); break;
    case 4: zero_units<unsigned int>(dst, nb); break;
    case 2: zero_units<unsigned short>(dst, nb); break;
    default: zero_units<unsigned char>(dst, nb);
  }
}

// -- the host side: error record and cooperative launch ---------------------

static const int kErrWords = 6;    // [set, rank, step, slot, epoch lo, hi]
static int* g_err_host = nullptr;  // host-mapped
static int* g_err_dev = nullptr;

static cudaError_t ensure_error_record() {
  if (g_err_host != nullptr) return cudaSuccess;
  cudaError_t e = cudaHostAlloc(reinterpret_cast<void**>(&g_err_host), kErrWords * sizeof(int),
                                cudaHostAllocMapped);
  if (e != cudaSuccess) return e;
  memset(g_err_host, 0, kErrWords * sizeof(int));
  return cudaHostGetDevicePointer(reinterpret_cast<void**>(&g_err_dev), g_err_host, 0);
}

// Blocks of `kernel` that can be resident at once on `device` (occupancy x
// SMs), asked once per (kernel, device, threads, dynamic shared memory) and
// kept: a decode step launches these kernels 72 times, and a kernel whose
// shared memory follows its operands (sp_ag_attention.cu's head_dim) gets
// one entry per size. The kernel's dynamic shared-memory limit is only ever
// raised, to the largest size launched so far, so every kept entry stays
// launchable.
static cudaError_t resident_blocks(const void* kernel, int threads, int smem, int device,
                                   long long* out) {
  struct Entry {
    const void* kernel;
    int device, threads, smem;
    long long blocks;
  };
  struct Limit {
    const void* kernel;
    int smem;
  };
  static Entry cache[64];
  static Limit limits[32];
  static int used = 0, n_limits = 0;
  for (int i = 0; i < used; ++i)
    if (cache[i].kernel == kernel && cache[i].device == device &&
        cache[i].threads == threads && cache[i].smem == smem) {
      *out = cache[i].blocks;
      return cudaSuccess;
    }
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024) {
    int li = 0;
    while (li < n_limits && limits[li].kernel != kernel) ++li;
    if (li == n_limits || limits[li].smem < smem) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
      if (li < n_limits) limits[li].smem = smem;
      else if (n_limits < 32) limits[n_limits++] = Limit{kernel, smem};
    }
  }
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return e;
  *out = (long long)sms * per_sm;
  if (used < 64) cache[used++] = Entry{kernel, device, threads, smem, *out};
  return cudaSuccess;
}

// Launch `kernel` cooperatively with one block per work item, capped at the
// blocks that can be resident at once.
static cudaError_t cooperative_launch(const void* kernel, int threads, int smem, long long items,
                                      void** args, int device, cudaStream_t stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  long long grid = 0;
  e = resident_blocks(kernel, threads, smem, device, &grid);
  if (e != cudaSuccess) return e;
  if (grid > items) grid = items;
  if (grid < 1) return cudaErrorInvalidConfiguration;
  e = cudaLaunchCooperativeKernel(kernel, dim3((unsigned)grid), dim3(threads), args, smem,
                                  stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace tdt

// The record of the first wait that timed out since the last clear:
// out = [set, rank, step, slot, epoch lo, epoch hi] (the epoch names the
// launch); returns `set` (0: none).
extern "C" int tdt_shmem_error(int* out) {
  if (tdt::g_err_host == nullptr) return 0;
  const volatile int* e = tdt::g_err_host;
  for (int i = 0; i < tdt::kErrWords; ++i) out[i] = e[i];
  return out[0];
}

extern "C" void tdt_shmem_clear_error() {
  if (tdt::g_err_host != nullptr) memset(tdt::g_err_host, 0, tdt::kErrWords * sizeof(int));
}

extern "C" const char* tdt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
