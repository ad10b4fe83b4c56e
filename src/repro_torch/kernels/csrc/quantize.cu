// Per-block stochastic int8 quantization and its inverse, for Hopper
// (sm_90a).
//
// Replaces the TPU kernels src/repro/kernels/quantize.py::_quant_kernel
// and ::_dequant_kernel (called through quantize / dequantize, from
// core/pipeline.py::Int8Wire and, for dequantize, DSCCompress's fused
// path):
//
//   quantize:   per 256-coordinate block b of x (zero-padded to n_pad):
//               scale_b = max|x_b| * f32(1/127)
//               q_i = clip(floor(y) + (U(idx_i, seed) < y - floor(y)), +-127)
//               with y = x_i / scale_b (a zero block divides by 1)
//               idx_i = (index_base + i) mod 2**32
//   dequantize: x_i = q_i * scale_b
//
//   x (n,) f32 or bf16  ->  q int8 (n_pad,), scales f32 (n_pad / 256,)
//
// Rounding.  The scale is a multiply by f32(1/127): that is what XLA
// compiles the reference's max / 127.0 into on the CPU.  y is IEEE
// division (__fdiv_rn; the build uses no fast math), and the codes are
// exact small integers, so q and the scales are bit-identical to the
// plain versions (kernels/ref.py::quantize_ref / dequantize_ref).
//
// Design.  One warp per quant block, 8 coordinates per lane (16-byte
// loads where aligned), the block max by a shuffle reduction across the
// warp, so the block never leaves registers; 8 warps per thread block.
// The TPU kernel's (1024, 256) tiles exist for VMEM; the draws are keyed
// on the flat index, so the tiling does not change them.  The padded tail
// reads as zeros and quantizes to code 0 without moving its block's scale.
//
// Bound.  Bytes.  quantize reads x once and writes one byte a coordinate
// plus 4 bytes a block: 5.02 B a coordinate with an f32 x, 9.12 GB at
// n = 1,816,565,760, 2.72 ms at 3.35 TB/s; dequantize reads the same
// 5.02 B and writes 4: 2.72 ms too.  The hash and the division per
// coordinate stay far below the card's rates.
#include "common.cuh"

namespace {

template <typename TX>
__global__ void __launch_bounds__(wire::kThreads)
quantize_kernel(const TX* x, int8_t* q, float* scales, long long n,
                long long nb, unsigned long long base, uint32_t seed,
                int aligned) {
  const long long b =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (b >= nb) return;                  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const long long i0 = b * wire::kQBlock + lane * wire::kPerLane;
  float xv[8], qf[8];
  wire::load8(x, i0, n, aligned && i0 + 8 <= n, xv);
  const float scale = wire::quantize_lane(xv, base, i0, seed, qf);
  wire::store_codes(q, i0, qf);
  if (lane == 0) scales[b] = scale;
}

__global__ void __launch_bounds__(wire::kThreads)
dequantize_kernel(const int8_t* q, const float* scales, float* x,
                  long long nb) {
  const long long b =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (b >= nb) return;
  const int lane = threadIdx.x & 31;
  const long long i0 = b * wire::kQBlock + lane * wire::kPerLane;
  const uint2 raw = *reinterpret_cast<const uint2*>(q + i0);
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
  const float scale = scales[b];
  float out[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    out[j] = __fmul_rn(static_cast<float>(c[j]), scale);
  wire::store8(x, i0, i0 + 8, true, out);
}

unsigned blocks_for(long long nb) {
  constexpr long long kWarps = wire::kThreads / 32;
  return static_cast<unsigned>((nb + kWarps - 1) / kWarps);
}

}  // namespace

extern "C" {

// q holds n_pad = nb * 256 codes.  Returns the cudaError_t of the launch.
int quantize_launch(const void* x, void* q, void* scales, long long n,
                    long long nb, unsigned long long index_base,
                    unsigned int seed, int x_bf16, int aligned,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* qp = static_cast<int8_t*>(q);
  float* sp = static_cast<float*>(scales);
  if (x_bf16)
    quantize_kernel<__nv_bfloat16><<<blocks_for(nb), wire::kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), qp, sp, n, nb, index_base, seed,
        aligned);
  else
    quantize_kernel<float><<<blocks_for(nb), wire::kThreads, 0, st>>>(
        static_cast<const float*>(x), qp, sp, n, nb, index_base, seed,
        aligned);
  return static_cast<int>(cudaGetLastError());
}

// x holds nb * 256 floats; q and x must be 16-byte aligned.
int dequantize_launch(const void* q, const void* scales, void* x,
                      long long nb, void* stream) {
  dequantize_kernel<<<blocks_for(nb), wire::kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scales),
      static_cast<float*>(x), nb);
  return static_cast<int>(cudaGetLastError());
}

const char* quantize_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
