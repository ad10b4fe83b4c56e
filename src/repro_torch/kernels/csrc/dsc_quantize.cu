// Fused DSC -> int8 wire client step, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/dsc_quantize.py::_kernel
// (called through dsc_quantize, from core/pipeline.py::DSCCompress
// ._compress_fused), the main path's hot loop:
//
//   v      = U(idx, seed_mask) < p ? (g - s) * inv_p : 0      (RandP)
//   q, c   = per-256-block stochastic int8 of v (seed_round)   (quantize.cu)
//   s'     = s + gamma * (q * c)       the shift tracks the wire value
//
//   g (n,) f32 or bf16;  s (n,) f32  ->  q int8 (n_pad,), scales f32
//   (n_pad / 256,), s' f32 (n,);  idx = (index_base + i) mod 2**32, the
//   same index for both draws.  The zero-padded tail has g = s = 0, so
//   v = 0 there and it never moves a scale or the shift state.
//
// Rounding.  v = (g - s) * f32(1/p) and q * c round on their own
// (__fsub_rn, __fmul_rn); s + gamma * (q * c) is ONE fused multiply-add
// (__fmaf_rn), because that is what XLA compiles the reference's line into
// on the CPU (it contracts it here, though not in dsc_update).  The scale
// is max|v| * f32(1/127), y = v / scale an IEEE division.  q, the scales
// and s' are then bit-identical to the plain version
// (kernels/ref.py::dsc_quantize_ref).
//
// Design.  One warp per quant block, 8 coordinates per lane: each lane
// loads its g and s (16-byte loads where aligned), draws the mask, forms
// v, the warp reduces max|v| by shuffle, each lane rounds its 8 codes and
// forms s', and the lane stores 8 code bytes and 8 s' values; lane 0
// stores the scale.  v and the dequantized value never reach device
// memory.  s' may be s itself (in place): each coordinate is read and then
// written by the same lane.
//
// Bound.  Bytes: g and s read once; q, the scales and s' written once:
// 4 + 4 + 1 + 4 + 4/256 = 13.02 bytes a coordinate with an f32 g (11.02
// with bf16), 23.65 GB at n = 1,816,565,760, 7.06 ms at 3.35 TB/s.  The
// two hashes and the division per coordinate stay far below the card's
// rates.
#include "common.cuh"

namespace {

template <typename TG>
__global__ void __launch_bounds__(wire::kThreads)
dsc_quantize_kernel(const TG* g, const float* s, int8_t* q, float* scales,
                    float* s_out, long long n, long long nb,
                    unsigned long long base, uint32_t seed_mask,
                    uint32_t seed_round, float p, float inv_p, float gamma,
                    int aligned) {
  const long long b =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (b >= nb) return;                  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const long long i0 = b * wire::kQBlock + lane * wire::kPerLane;
  const bool vec = aligned && i0 + 8 <= n;
  float gv[8], sv[8], v[8], qf[8], so[8];
  wire::load8(g, i0, n, vec, gv);
  wire::load8(s, i0, n, vec, sv);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float u = wire::uniform_from_index(wire::flat_index(base, i0 + j),
                                             seed_mask);
    v[j] = u < p ? __fmul_rn(__fsub_rn(gv[j], sv[j]), inv_p) : 0.0f;
  }
  const float scale = wire::quantize_lane(v, base, i0, seed_round, qf);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    so[j] = __fmaf_rn(gamma, __fmul_rn(qf[j], scale), sv[j]);
  wire::store_codes(q, i0, qf);
  wire::store8(s_out, i0, n, vec, so);
  if (lane == 0) scales[b] = scale;
}

}  // namespace

extern "C" {

// q holds n_pad = nb * 256 codes.  Returns the cudaError_t of the launch.
int dsc_quantize_launch(const void* g, const void* s, void* q, void* scales,
                        void* s_out, long long n, long long nb,
                        unsigned long long index_base, unsigned int seed_mask,
                        unsigned int seed_round, float p, float inv_p,
                        float gamma, int g_bf16, int aligned, void* stream) {
  constexpr long long kWarps = wire::kThreads / 32;
  const unsigned blocks = static_cast<unsigned>((nb + kWarps - 1) / kWarps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(s);
  int8_t* qp = static_cast<int8_t*>(q);
  float* cp = static_cast<float*>(scales);
  float* op = static_cast<float*>(s_out);
  if (g_bf16)
    dsc_quantize_kernel<__nv_bfloat16><<<blocks, wire::kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(g), sp, qp, cp, op, n, nb,
        index_base, seed_mask, seed_round, p, inv_p, gamma, aligned);
  else
    dsc_quantize_kernel<float><<<blocks, wire::kThreads, 0, st>>>(
        static_cast<const float*>(g), sp, qp, cp, op, n, nb, index_base,
        seed_mask, seed_round, p, inv_p, gamma, aligned);
  return static_cast<int>(cudaGetLastError());
}

const char* dsc_quantize_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
