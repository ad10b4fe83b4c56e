// Fused DSC client update, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/dsc_update.py::_kernel (called
// through dsc_update, from core/pipeline.py::DSCCompress._compress_pallas):
//
//   u  = U(idx, seed)                  idx = (index_base + i) mod 2**32
//   v  = u < p ? (g - s) * inv_p : 0   inv_p = f32(1/p), 1/p taken in double
//   s' = s + gamma * v                 from the f32 v, before v is cast
//
//   g (n,) f32 or bf16;  s (n,) f32;  v (n,) in g's dtype;  s' (n,) f32
//
// Rounding.  Every step rounds on its own, as the reference computes this
// kernel on the CPU (XLA does not contract s + gamma * v here): the
// intrinsics __fsub_rn / __fmul_rn / __fadd_rn are never fused into an
// FMA, whatever nvcc's -fmad says.  v and s' are then bit-identical to the
// plain version (kernels/ref.py::dsc_update_ref).
//
// Design.  Elementwise: each thread takes 8 consecutive coordinates, with
// 16-byte loads and stores where the wrapper found every pointer aligned
// and the run of 8 lies inside n (the ragged tail goes element by
// element).  The TPU kernel's (rows, 1024) tiling exists for VMEM; here
// the index is simply the flat position.  s' may be s itself (in place):
// each coordinate is read and then written by the same thread.
//
// Bound.  Bytes: g and s read once, v and s' written once,
// (2 * sizeof(g) + 8) bytes a coordinate, 16 with an f32 g: 29.07 GB at
// n = 1,816,565,760, 8.68 ms at 3.35 TB/s on an H100 SXM.  A few dozen
// integer operations a coordinate (the hash) stay far below the card's
// rate, so bytes bound it; the design moves each byte once.
#include "common.cuh"

namespace {

template <typename TG>
__global__ void __launch_bounds__(wire::kThreads)
dsc_update_kernel(const TG* g, const float* s, TG* v, float* s_out,
                  long long n, unsigned long long base, uint32_t seed,
                  float p, float inv_p, float gamma, int aligned) {
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 8;
  if (i0 >= n) return;
  const bool vec = aligned && i0 + 8 <= n;
  float gv[8], sv[8], vv[8], so[8];
  wire::load8(g, i0, n, vec, gv);
  wire::load8(s, i0, n, vec, sv);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float u = wire::uniform_from_index(wire::flat_index(base, i0 + j),
                                             seed);
    vv[j] = u < p ? __fmul_rn(__fsub_rn(gv[j], sv[j]), inv_p) : 0.0f;
    so[j] = __fadd_rn(sv[j], __fmul_rn(gamma, vv[j]));
  }
  wire::store8(v, i0, n, vec, vv);
  wire::store8(s_out, i0, n, vec, so);
}

template <typename TG>
cudaError_t launch(const void* g, const float* s, void* v, float* s_out,
                   long long n, unsigned long long base, uint32_t seed,
                   float p, float inv_p, float gamma, int aligned,
                   cudaStream_t stream) {
  const long long threads = (n + 7) / 8;
  const long long blocks = (threads + wire::kThreads - 1) / wire::kThreads;
  dsc_update_kernel<TG><<<static_cast<unsigned>(blocks), wire::kThreads, 0,
                          stream>>>(
      static_cast<const TG*>(g), s, static_cast<TG*>(v), s_out, n, base,
      seed, p, inv_p, gamma, aligned);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch.  n > 0.
int dsc_update_launch(const void* g, const void* s, void* v, void* s_out,
                      long long n, unsigned long long index_base,
                      unsigned int seed, float p, float inv_p, float gamma,
                      int g_bf16, int aligned, void* stream) {
  const float* sp = static_cast<const float*>(s);
  float* so = static_cast<float*>(s_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      g_bf16 ? launch<__nv_bfloat16>(g, sp, v, so, n, index_base, seed, p,
                                     inv_p, gamma, aligned, st)
             : launch<float>(g, sp, v, so, n, index_base, seed, p, inv_p,
                             gamma, aligned, st);
  return static_cast<int>(err);
}

const char* dsc_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
