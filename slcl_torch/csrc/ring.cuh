// Primitives of the shared-memory rings that feed the port's backward
// kernels on Hopper (sm_90): mbarriers, the 1D bulk copies (cp.async.bulk)
// into shared memory, completing on one, and out of it, in bulk groups, and
// the size of a persistent grid, which the kernels on direct loads take too.
//
// A ring kernel runs one block per resident slot. Each block walks tiles of
// G::kRows rows at a fixed stride; one elected thread fills a stage with
// bulk copies that complete on the stage's "full" barrier, and every warp
// arrives on the stage's "empty" barrier when it has read its rows, after
// which the elected thread may fill the stage again. A ring that also
// writes (the soft centroids' backward) puts its results in the stage, and
// the elected thread stores them with bulk_store once the warps have
// arrived, then waits (bulk_wait_read) until the store has read the stage
// before it fills it again. Bulk copies need sizes and both addresses in
// multiples of 16 bytes, and mbar_expect_tx must name exactly the bytes the
// copies bring.
#pragma once

#include "common.cuh"

namespace slcl {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Arrive, and expect `bytes` of copies before the phase completes.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of this parity to complete. A phase that never
// completes (a lost copy) traps after 2^26 polls instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (n == (1u << 26)) __trap();
  }
}

// Whether the phase of this parity has completed, without waiting.
__device__ __forceinline__ bool mbar_test(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// global -> shared, `bytes` (a multiple of 16) completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// shared -> global, `bytes` (a multiple of 16), in the thread's current bulk
// group. The writes to the source must be fenced for the async proxy
// (fence_proxy_async) by every thread that made them, before a barrier that
// orders them ahead of this call.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}

// Close the thread's current bulk group.
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Wait until at most N of the thread's bulk groups still read their
// sources: their shared memory may then be written again.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

// Wait until every bulk group of the thread has completed its writes.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Order this thread's writes to shared memory before later reads of it by
// the async proxy (a bulk store).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Blocks of a persistent launch of the kernel kKern over tiles of G::kRows
// rows with G::kSmemBytes of dynamic shared memory (a ring's stages, or 0):
// one per resident slot
// (SMs x blocks per SM), at most one per tile. The slot count is queried
// once per device and cached per kernel: the kernel itself is the template
// argument, so two kernels never share an entry, whatever their signatures
// and tile types. Static, so that every library keeps its own cache.
template <typename G, auto kKern>
static int ring_grid(int M, int* grid) {
  constexpr int kMaxDevices = 64;
  static int slots[kMaxDevices];
  int dev = 0;
  int e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (slots[dev] == 0) {
    int sms = 0, per = 0, smem = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = occupancy(kKern, G::kSmemBytes, &per, &smem);
    if (e != cudaSuccess) return e;
    if (per < 1) return cudaErrorInvalidConfiguration;
    slots[dev] = sms * per;
  }
  const int tiles = (M + G::kRows - 1) / G::kRows;
  *grid = tiles < 1 ? 1 : (tiles < slots[dev] ? tiles : slots[dev]);
  return cudaSuccess;
}

// The same for a kernel whose tile rows and dynamic shared memory are set at
// run time (the general centroid backward's plan): tiles of `rows` rows,
// `smem_bytes` of dynamic shared memory, which gen_prepare lets the kernel
// take (-1 if it does not fit a block of this device). The slot count is
// queried once per device and shared memory size and cached per kernel, a
// few sizes at a time.
template <auto kKern>
static int ring_grid(long long M, int rows, int smem_bytes, int* grid) {
  constexpr int kMaxDevices = 64, kWays = 4;
  static int key[kMaxDevices][kWays];   // smem_bytes + 1 of an entry; 0: none
  static int slots[kMaxDevices][kWays];
  static int next[kMaxDevices];
  int dev = 0;
  int e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int n = 0;
  for (int i = 0; i < kWays; ++i)
    if (key[dev][i] == smem_bytes + 1) n = slots[dev][i];
  if (n == 0) {
    e = gen_prepare<kKern>(smem_bytes);
    if (e != 0) return e;
    int sms = 0, per = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kKern, kThreads, smem_bytes);
    if (e != cudaSuccess) return e;
    if (per < 1) return cudaErrorInvalidConfiguration;
    n = sms * per;
    const int i = next[dev];
    next[dev] = (i + 1) % kWays;
    key[dev][i] = smem_bytes + 1;
    slots[dev][i] = n;
  }
  const long long tiles = (M + rows - 1) / rows;
  *grid = tiles < 1 ? 1 : (tiles < n ? static_cast<int>(tiles) : n);
  return cudaSuccess;
}

}  // namespace slcl
