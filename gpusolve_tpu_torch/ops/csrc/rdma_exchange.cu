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
// and a process-group barrier before and after), not in-kernel flags: the
// ranks of one card are processes whose contexts the card time-slices, so
// a kernel spinning on a neighbour's flag would wait whole time slices or
// hang.  The TPU layout (the zz lane extent, the VMEM zero slab, the DMA
// semaphore pairs) is not carried over.
//
// Bound: bytes (each slab sent is read once and written once, each edge
// slab written once; no arithmetic).  Design: a grid-stride copy, 16 bytes
// a thread where the job's pointers and length allow (4 bytes else), the
// jobs on grid y so every slab is in flight together, about one wave of
// blocks in all.  Every thread ends with a system-scope fence, so the
// peer writes are performed before the launch ends.
//
// The entry points return a cudaError_t as int; the launch allocates
// nothing and runs on the given stream.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kRdmaThreads = 256;
constexpr int kMaxJobs = 16;
constexpr int kWaveBlocks = 132 * 8;  // 132 SMs x 8 blocks of 256 threads

struct RdmaJob {
  void* dst;
  const void* src;  // null: zero-fill dst
  long long bytes;  // a multiple of 4
};

struct RdmaArgs {
  RdmaJob job[kMaxJobs];
};

template <class T>
__device__ void copy_range(T* dst, const T* src, long long n) {
  const long long step = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (src != nullptr) {
    for (; i < n; i += step) dst[i] = src[i];
  } else {
    const T zero{};
    for (; i < n; i += step) dst[i] = zero;
  }
}

__global__ void __launch_bounds__(kRdmaThreads)
rdma_kernel(const __grid_constant__ RdmaArgs a) {
  const RdmaJob j = a.job[blockIdx.y];
  const uintptr_t align = reinterpret_cast<uintptr_t>(j.dst) |
                          reinterpret_cast<uintptr_t>(j.src) |
                          static_cast<uintptr_t>(j.bytes);
  if ((align & 15) == 0) {
    copy_range(static_cast<int4*>(j.dst), static_cast<const int4*>(j.src),
               j.bytes >> 4);
  } else {
    copy_range(static_cast<int*>(j.dst), static_cast<const int*>(j.src),
               j.bytes >> 2);
  }
  __threadfence_system();
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
  long long most = 0;
  for (int i = 0; i < njobs; ++i) {
    if (dst[i] == nullptr || bytes[i] < 0 || bytes[i] % 4 != 0)
      return (int)cudaErrorInvalidValue;
    a.job[i] = RdmaJob{dst[i], src[i], bytes[i]};
    if (bytes[i] > most) most = bytes[i];
  }
  const long long need = (most / 16 + kRdmaThreads - 1) / kRdmaThreads;
  long long per_job = kWaveBlocks / njobs;
  if (need < per_job) per_job = need;
  if (per_job < 1) per_job = 1;
  rdma_kernel<<<dim3((unsigned)per_job, (unsigned)njobs), kRdmaThreads, 0,
                stream>>>(a);
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
