// Shared device helpers of the wire kernels (dsc_update, quantize,
// dsc_quantize).
//
// The counter-based PRNG of src/repro/kernels/common.py:25-40: murmur3
// fmix32 keyed on (seed, element index), 24 bits of it as U[0, 1).
// Bit-exact with repro_torch/kernels/common.py, which emulates the same
// uint32 arithmetic in int64 on the host.
//
// The index of coordinate i is (index_base + i) mod 2**32.  The reference
// draws from the coordinate's place in the flattened, padded (K, n_pad)
// client block, as uint32 (common.py:39); the port hands one client at a
// time to a kernel with index_base = k * n_pad, which passes 2**32 at full
// width (4 * 1,816,565,760 > 2**32).  So the sum is taken in 64 bits and
// cut to its low 32: int32 arithmetic would overflow from client 2 on.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wire {

constexpr int kQBlock = 256;       // coords per int8 scale (quantize.QBLOCK)
constexpr int kPerLane = 8;        // coords per thread: 32 lanes x 8 = 256
constexpr int kThreads = 256;      // threads per block
// f32(1/127).  The reference's max|x| / 127 is compiled by XLA into a
// multiply by this constant, and the port's plain versions multiply too.
constexpr float kInv127 = 0x1.020408p-7f;

__device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float uniform_from_index(uint32_t idx,
                                                    uint32_t seed) {
  // (bits >> 8) < 2**24 converts exactly; the scale by 2**-24 is exact
  return static_cast<float>(hash_u32(idx ^ seed) >> 8) *
         (1.0f / 16777216.0f);
}

__device__ __forceinline__ uint32_t flat_index(unsigned long long base,
                                               long long i) {
  return static_cast<uint32_t>(base + static_cast<unsigned long long>(i));
}

// 8 consecutive values as f32, 16-byte loads where the caller says the
// run is whole and aligned, element by element (zeros past n) otherwise
__device__ __forceinline__ void load8(const float* p, long long i0,
                                      long long n, bool vec, float out[8]) {
  if (vec) {
    const float4 a = *reinterpret_cast<const float4*>(p + i0);
    const float4 b = *reinterpret_cast<const float4*>(p + i0 + 4);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) out[j] = i0 + j < n ? p[i0 + j] : 0.0f;
  }
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, long long i0,
                                      long long n, bool vec, float out[8]) {
  if (vec) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p + i0);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) out[j] = __bfloat162float(h[j]);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      out[j] = i0 + j < n ? __bfloat162float(p[i0 + j]) : 0.0f;
  }
}

__device__ __forceinline__ void store8(float* p, long long i0, long long n,
                                       bool vec, const float v[8]) {
  if (vec) {
    *reinterpret_cast<float4*>(p + i0) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + i0 + 4) =
        make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (i0 + j < n) p[i0 + j] = v[j];
  }
}

// f32 -> bf16 rounds to nearest even, as torch's and XLA's casts do
__device__ __forceinline__ void store8(__nv_bfloat16* p, long long i0,
                                       long long n, bool vec,
                                       const float v[8]) {
  if (vec) {
    uint4 raw;
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) h[j] = __float2bfloat16_rn(v[j]);
    *reinterpret_cast<uint4*>(p + i0) = raw;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (i0 + j < n) p[i0 + j] = __float2bfloat16_rn(v[j]);
  }
}

// One warp's share of a 256-coordinate quant block: the block's max |x|
// by shuffle, then each lane's 8 stochastic codes.  scale = max * f32(1/127)
// and y = x / scale as IEEE division (__fdiv_rn: no fast-math reciprocal),
// q = clip(floor(y) + (u < y - floor(y)), +-127).  A zero block gives
// scale 0 and codes 0 (safe = 1).  Returns the block's scale.
__device__ __forceinline__ float quantize_lane(const float x[8],
                                               unsigned long long base,
                                               long long i0, uint32_t seed,
                                               float qf[8]) {
  float amax = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(x[j]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = __fmul_rn(amax, kInv127);
  const float safe = scale > 0.0f ? scale : 1.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float y = __fdiv_rn(x[j], safe);
    const float low = floorf(y);
    const float u = uniform_from_index(flat_index(base, i0 + j), seed);
    const float q = __fadd_rn(low, u < __fsub_rn(y, low) ? 1.0f : 0.0f);
    qf[j] = fminf(fmaxf(q, -127.0f), 127.0f);
  }
  return scale;
}

__device__ __forceinline__ void store_codes(int8_t* q, long long i0,
                                            const float qf[8]) {
  // i0 is a multiple of 8 and q holds the padded block: one 8-byte store
  uint2 raw;
  int8_t* c = reinterpret_cast<int8_t*>(&raw);
#pragma unroll
  for (int j = 0; j < 8; ++j) c[j] = static_cast<int8_t>(__float2int_rn(qf[j]));
  *reinterpret_cast<uint2*>(q + i0) = raw;
}

}  // namespace wire
