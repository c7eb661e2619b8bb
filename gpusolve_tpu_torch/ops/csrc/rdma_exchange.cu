// The in-kernel halo exchange of the distributed per-leg engine
// (dist/spmd.py, halo="rdma"): every field's x-face slabs written straight
// into the x neighbours' receive buffers through peer-mapped pointers, and
// the slabs at the global x edges zero-filled, all fields and both
// directions in one launch, for Hopper (sm_90a).
//
// It replaces gpusolve_tpu/ops/pallas_spmd.py::_rdma_exchange_call (:1919),
// whose remote copies are the TPU's in-kernel remote DMAs.  Here the
// receive buffers of each rank are one device allocation of their own
// (mg_ipc_alloc), whose CUDA IPC handle the x neighbours open
// (mg_ipc_open, with cudaIpcMemLazyEnablePeerAccess): the same mapping
// serves processes on one card and cards of one host.  A slab u[:g] or
// u[bx-g:] of a contiguous (bx, by, bz) block is one contiguous byte range,
// so every write is a flat copy (a "job"): this rank's first g planes into
// its lower neighbour's hi buffer, its last g planes into its upper
// neighbour's lo buffer, or zeros into its own lo (hi) buffer where it has
// no lower (upper) neighbour.  The kernel copies bytes, so it serves
// float32 and float64 alike.
//
// The TPU kernel's neighbour barrier and its wait for every send and
// receive are host-ordered around this launch (ops/rdma.py: stream sync
// and a process-group barrier before and after), not in-kernel flags as
// the pod chains' (pod.cu), whose waits on one card last until the
// neighbour's context is scheduled: about a time slice each (PERF.md).
// The TPU layout (the zz lane extent, the VMEM zero slab, the DMA
// semaphore pairs) is not carried over.
//
// Bound: bytes (each slab sent is read once and written once, each edge
// slab written once; no arithmetic).  On one rank the launch is the edge
// zero fill alone (six 13.1 MB slabs at the 511^3 plan's level-0 block),
// so the design is that of a fill at the copy rate.  One flat index space
// of tiles over all jobs: each job is cut into tiles of kRdmaThreads x
// kUnroll units (16 bytes where the job's pointers and length allow, 4
// bytes else), a tile belongs to one job, and the blocks walk the tiles
// in a grid-stride loop, so no block idles on a short job; the grid is
// sized from the total tiles, at most kWaveBlocks.  A thread keeps kUnroll
// stores (and their loads) in flight, neighbouring threads on neighbouring
// units.
//
// Fences.  A zero fill writes this rank's own buffer, which its next leg
// reads after the launch ends on the same stream: no fence.  A block that
// wrote a neighbour's buffer ends with one system-scope fence, issued by
// one thread after a block barrier: the barrier orders the block's writes
// before that thread's fence, and the fence (cumulative) makes them
// visible beyond the card before the launch ends.  The host-ordered
// barrier after the launch (stream sync, then the group barrier) is what
// the neighbour waits on before it reads.
//
// The entry points return a cudaError_t as int; the launch allocates
// nothing and runs on the given stream.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kRdmaThreads = 256;
constexpr int kUnroll = 4;            // units a thread keeps in flight
constexpr int kTile = kRdmaThreads * kUnroll;  // units a tile
constexpr int kMaxJobs = 16;
constexpr int kWaveBlocks = 132 * 8;  // 132 SMs x 8 blocks of 256 threads

struct RdmaJob {
  void* dst;
  const void* src;   // null: zero-fill dst
  long long units;   // 16-byte units (vec) or 4-byte units
  long long tile0;   // the job's first tile in the flat space
  int vec;
};

struct RdmaArgs {
  RdmaJob job[kMaxJobs];
  int njobs;
  long long tiles;
};

// One tile of units (u0 its first) of a job: kUnroll units a thread, the
// loads (a copy) all issued before the stores.
template <class T>
__device__ __forceinline__ void tile_units(T* dst, const T* src, long long u0,
                                           long long n) {
  long long i[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    i[k] = u0 + k * kRdmaThreads + threadIdx.x;
  }
  if (src == nullptr) {
    const T zero{};
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (i[k] < n) dst[i[k]] = zero;
    }
    return;
  }
  T v[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    if (i[k] < n) v[k] = src[i[k]];
  }
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    if (i[k] < n) dst[i[k]] = v[k];
  }
}

__global__ void __launch_bounds__(kRdmaThreads)
rdma_kernel(const __grid_constant__ RdmaArgs a) {
  bool peer = false;  // uniform over the block: tiles are per block
  int j = 0;
  for (long long t = blockIdx.x; t < a.tiles; t += gridDim.x) {
    while (j + 1 < a.njobs && t >= a.job[j + 1].tile0) ++j;
    const RdmaJob& b = a.job[j];
    const long long u0 = (t - b.tile0) * kTile;
    if (b.vec) {
      tile_units(static_cast<int4*>(b.dst), static_cast<const int4*>(b.src),
                 u0, b.units);
    } else {
      tile_units(static_cast<int*>(b.dst), static_cast<const int*>(b.src),
                 u0, b.units);
    }
    peer |= b.src != nullptr;
  }
  if (peer) {
    __syncthreads();
    if (threadIdx.x == 0) __threadfence_system();
  }
}

}  // namespace

extern "C" {

// njobs (dst[i], src[i], bytes[i]) copies, src[i] null for a zero fill,
// in one launch.
int mg_rdma_exchange(void* const* dst, const void* const* src,
                     const long long* bytes, int njobs, cudaStream_t stream) {
  if (njobs < 1 || njobs > kMaxJobs) return (int)cudaErrorInvalidValue;
  RdmaArgs a;
  memset(&a, 0, sizeof a);
  a.njobs = njobs;
  long long tiles = 0;
  for (int i = 0; i < njobs; ++i) {
    if (dst[i] == nullptr || bytes[i] < 0 || bytes[i] % 4 != 0)
      return (int)cudaErrorInvalidValue;
    const uintptr_t align = reinterpret_cast<uintptr_t>(dst[i]) |
                            reinterpret_cast<uintptr_t>(src[i]) |
                            static_cast<uintptr_t>(bytes[i]);
    const int vec = (align & 15) == 0;
    const long long units = bytes[i] / (vec ? 16 : 4);
    a.job[i] = RdmaJob{dst[i], src[i], units, tiles, vec};
    tiles += (units + kTile - 1) / kTile;
  }
  a.tiles = tiles;
  const long long grid =
      tiles < 1 ? 1 : tiles < kWaveBlocks ? tiles : kWaveBlocks;
  rdma_kernel<<<(unsigned)grid, kRdmaThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// The receive buffers: one allocation of their own, so the IPC handle
// covers exactly them (a pointer inside a block of PyTorch's caching
// allocator would give the whole block's handle).
int mg_ipc_alloc(int device, long long bytes, void** out) {
  cudaError_t rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaMalloc(out, (size_t)bytes);
}

int mg_ipc_free(int device, void* ptr) {
  cudaError_t rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaFree(ptr);
}

int mg_ipc_handle_size() { return (int)sizeof(cudaIpcMemHandle_t); }

// handle: mg_ipc_handle_size() bytes.
int mg_ipc_handle(int device, void* ptr, void* handle) {
  cudaError_t rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return (int)rc;
  cudaIpcMemHandle_t h;
  rc = cudaIpcGetMemHandle(&h, ptr);
  if (rc == cudaSuccess) memcpy(handle, &h, sizeof h);
  return (int)rc;
}

// A neighbour's buffer in this process (a process cannot open its own).
int mg_ipc_open(int device, const void* handle, void** out) {
  cudaError_t rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return (int)rc;
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof h);
  return (int)cudaIpcOpenMemHandle(out, h, cudaIpcMemLazyEnablePeerAccess);
}

int mg_ipc_close(int device, void* ptr) {
  cudaError_t rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaIpcCloseMemHandle(ptr);
}

}  // extern "C"
