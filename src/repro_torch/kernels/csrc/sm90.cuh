// Hopper (sm_90a) building blocks of the tensor-core flash kernels
// (flash_fwd_sm90.cu, flash_bwd_sm90.cu; flash_f32_sm90.cu takes the
// cp.async copies, the rows of lse and delta, the masks and the host
// helpers): 16-byte cp.async copies into 128-byte-swizzled bf16 tiles,
// wgmma descriptors and products, the two-term bf16 split, and the
// reference's masks and tile bounds.
//
// Tiles.  A tile is 64 rows of a head, bf16 in shared memory in the
// 128-byte swizzle: a row of 64 columns is one 128-byte line of an 8-row
// atom, its 16-byte chunks XORed with row % 8; a d = 128 row spans two
// 64-column atoms, kAtom bytes apart.  One layout serves both operand
// forms of wgmma: k-major (rows the M or N index, the head dim the
// reduction, as K in s = q k^T) and n-major (rows the reduction, as V in
// o += p V).  Tiles must start on 1 KB.
//
// Accumulators.  A warpgroup's m64nN accumulator gives thread (warp w,
// lane) element i at row 16 w + lane / 4 + 8 ((i >> 1) & 1) and column
// 8 (i >> 2) + 2 (lane % 4) + (i & 1); a pair (i, i + 1) of a 64 x 16
// slice is one register of a register A operand.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace sm90 {

constexpr int kTile = 64;             // rows of a q-tile and of a k-tile
constexpr int kThreads = 128;         // one warpgroup
constexpr int kAtom = kTile * 128;    // bytes of 64 rows of one 64-column atom
constexpr float kNegInf = -1e30f;

struct Strides {                      // element strides; d has stride 1
  long long b, h, s;
};

using bf16 = __nv_bfloat16;

// ------------------------------------------------------------ PTX helpers
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, zeros where !full
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// the thread's shared-memory writes, visible to the tensor cores' reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N committed groups of products are in flight
template <int N = 0>
__device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of an asynchronous
// product's registers (accumulators, register A operands) across its issue
// or its wait, or from reusing them before the wait
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// a shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lead,
                                               uint32_t stride) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lead >> 4) << 16) |
         (static_cast<uint64_t>(stride >> 4) << 32) | (1ull << 62);
}
// k-step kk (columns 16 kk ..) of a tile whose rows are M or N: 8-row
// groups 1 KB apart, the step 32 bytes into its 64-column atom
__device__ __forceinline__ uint64_t k_major(uint32_t tile, int kk) {
  return descriptor(tile + (kk >> 2) * kAtom + (kk & 3) * 32, 16, 1024);
}
// k-step kk (rows 16 kk ..) of a tile whose rows are the reduction: 8-row
// groups 1 KB apart, 64-column atoms kAtom apart
__device__ __forceinline__ uint64_t n_major(uint32_t tile, int kk) {
  return descriptor(tile + kk * 2048, kAtom, 1024);
}

// d (64 x 64) = a b^T (+ d where acc): a 64 x 16 and b 64 x 16, both in
// shared memory with k contiguous
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a,
                                           uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// d (64 x 64) += a b: a 64 x 16 in registers (the accumulator layout of
// a 64 x 16 slice, two bf16 a register), b 16 x 64 in shared memory with n
// contiguous (the transposed operand)
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t* a,
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128) += a b: a 64 x 16 in registers (the accumulator layout of
// a 64 x 16 slice, two bf16 a register), b 16 x 128 in shared memory with n
// contiguous (the transposed operand)
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t* a,
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// --------------------------------------------------------------- helpers
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}
// (x0, x1) as two bf16 terms: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h)));
}

// rows r0 .. r0 + 63 of one head into a (64, DP) swizzled bf16 tile by
// cp.async; rows past S and columns past D are zeros
template <int D, int DP>
__device__ __forceinline__ void load_tile(uint32_t tile, const bf16* src,
                                          long long row_stride, int r0,
                                          int S) {
  constexpr int kChunks = DP / 8;     // 16-byte chunks a row
#pragma unroll 4
  for (int e = threadIdx.x; e < kTile * kChunks; e += kThreads) {
    const int r = e / kChunks, c = e - r * kChunks;
    const bool ok = r0 + r < S && c < D / 8;
    const bf16* from =
        ok ? src + static_cast<long long>(r0 + r) * row_stride + c * 8 : src;
    cp_async16(tile + (c >> 3) * kAtom + r * 128 + (((c & 7) ^ (r & 7)) << 4),
               from, ok);
  }
}

// lse and delta of rows r0 .. r0 + 63 into two 64-float rows at dst
// (kThreads threads, one 4-byte copy each); zeros past S
__device__ __forceinline__ void load_rows(uint32_t dst, const float* lse,
                                          const float* delta, int r0, int S) {
  const int t = threadIdx.x & (kTile - 1);
  const float* src = threadIdx.x < kTile ? lse : delta;
  const bool ok = r0 + t < S;
  cp_async4(dst + (threadIdx.x < kTile ? 0 : kTile * 4) + t * 4,
            ok ? src + r0 + t : src, ok);
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int S, int causal,
                                        int window) {
  return qpos < S && kpos < S && (!causal || kpos <= qpos) &&
         (window <= 0 || kpos > qpos - window);
}

// whether any (query, key) pair of q-tile q0 and k-tile k0 is masked
__device__ __forceinline__ bool any_masked(int q0, int k0, int S, int causal,
                                           int window) {
  return q0 + kTile > S || k0 + kTile > S ||
         (causal && k0 + kTile - 1 > q0) ||
         (window > 0 && k0 <= q0 + kTile - 1 - window);
}

// first and one-past-last k-tile that q-tile q0 sees (flash_attention.py:75-83)
__device__ __forceinline__ void k_tiles(int q0, int S, int causal, int window,
                                        int* lo, int* hi) {
  const int n = (S + kTile - 1) / kTile;
  *hi = causal ? min(n, (q0 + kTile - 1) / kTile + 1) : n;
  *lo = window > 0 ? max(0, (q0 - window + 1) / kTile) : 0;
}

// ------------------------------------------------------------------ host
// cudaFuncSetAttribute applies to the current device only: each launcher
// instantiation sets it on a device's first launch
constexpr int kMaxDevices = 64;
using DeviceFlags = std::atomic<bool>[kMaxDevices];

template <typename Kernel>
inline cudaError_t allow_smem(DeviceFlags& set, Kernel kernel, size_t bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && set[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < kMaxDevices)
    set[dev].store(true, std::memory_order_release);
  return err;
}

inline Strides strides(const long long* s) { return Strides{s[0], s[1], s[2]}; }

}  // namespace sm90

// the head dims the tensor-core kernels take, as template arguments
#define SM90_HEAD_DIMS(FN, ...)                                        \
  switch (d) {                                                         \
    case 16: return static_cast<int>(FN<16>(__VA_ARGS__));            \
    case 32: return static_cast<int>(FN<32>(__VA_ARGS__));            \
    case 64: return static_cast<int>(FN<64>(__VA_ARGS__));            \
    case 128: return static_cast<int>(FN<128>(__VA_ARGS__));          \
    default: return static_cast<int>(cudaErrorInvalidValue);          \
  }
