// Flash attention dq for training, f32, for Hopper (sm_90a).
//
// Replaces the TPU kernel _dq_kernel of src/repro/kernels/flash_attention.py
// (called through flash_attention, a custom VJP, from
// models/transformer.py::_attn when cfg.flash_attention trains a shape the
// 128-blocks tile) on the f32 path: p = exp(s - lse),
// ds = p (do v^T - delta), dq = scale * sum ds k.
//
// f32 only.  bf16 dq runs on the tensor cores in flash_bwd_sm90.cu; the
// forward and dk/dv run on the tensor cores in flash_fwd_sm90.cu and
// flash_bwd_sm90.cu (bf16) and flash_f32_sm90.cu (f32, 3xTF32).
//
//   q, do, dq (B, H, S, d)  f32, any strides with d contiguous
//   k, v (B, KV, S, d)      f32, H = KV * G (query head h reads kv head
//                           h / G, the reference's _kv_index)
//   lse, delta (B * H, S)   f32, contiguous
//
// Arithmetic, as the Pallas kernel: every input is loaded into shared
// memory as f32, q is multiplied by scale = f32(d**-0.5) there (q_hat),
// masked scores are -1e30 (causal: kpos <= qpos; window w: kpos > qpos -
// w), and all sums are f32.  dq is scaled once at the end.  delta =
// rowsum(do * o) is computed outside, as the reference computes it outside
// its kernels.
//
// Design.  The TPU kernel walks k-blocks on a sequential loop inside one
// grid step with the running sum in VMEM.  Here one thread block of 256
// threads owns a 64-row q-tile, per (b*h, q-tile), and loops over the
// 64-row k-tiles it must see, staging each in shared memory as f32 with
// rows padded to d + 1 floats (no bank conflicts on the column walks):
// Q_hat, dO, lse and delta stay; per k-tile S = Q_hat K^T and dP = dO V^T
// as 4x4 register tiles per thread (rows ty + 16i, columns tx + 16j), dS to
// shared memory, dq += dS K in registers.  Tile bounds follow the
// reference's lo/hi (flash_attention.py:75-83) at 64-row tiles: tiles
// above the diagonal and below the window are skipped.  S need not be a
// multiple of 64: rows and columns past S are masked and never stored.
//
// Bound.  At the f32 step's shape (8, 16, 16, 64, 128) it reads and
// writes a few MB and is bound by latency and launch; at S = 2048 the
// causal products (6 d flops a visible pair) make it compute-bound.  This
// first design runs the products as f32 FMAs from shared memory (about
// 60 TFLOP/s at best on the CUDA cores, halved by one shared load per two
// FMAs): no mma, cp.async pipeline or warp specialisation yet.
#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kTile = 64;             // rows of a q-tile and of a k-tile
constexpr int kThreads = 256;         // a 16 x 16 grid of threads
constexpr int kLP = kTile + 1;        // padded row of a score tile
constexpr float kNegInf = -1e30f;

struct Strides {                      // element strides; d has stride 1
  long long b, h, s;
};

// rows r0 .. r0 + kTile - 1 of one head into a (kTile, D + 1) tile, times
// mul; rows past S read as zeros
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long row_stride, int r0, int S,
                                          float mul) {
  constexpr int LD = D + 1;
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, c = e - r * D;
    const int row = r0 + r;
    dst[r * LD + c] =
        row < S ? src[static_cast<long long>(row) * row_stride + c] * mul
                : 0.f;
  }
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int S, int causal,
                                        int window) {
  return qpos < S && kpos < S && (!causal || kpos <= qpos) &&
         (window <= 0 || kpos > qpos - window);
}

// first and one-past-last k-tile that q-tile q0 sees (flash_attention.py:75-83)
__device__ __forceinline__ void k_tiles(int q0, int S, int causal, int window,
                                        int* lo, int* hi) {
  const int n = (S + kTile - 1) / kTile;
  *hi = causal ? min(n, (q0 + kTile - 1) / kTile + 1) : n;
  *lo = window > 0 ? max(0, (q0 - window + 1) / kTile) : 0;
}

// s[i][j] = A[ty + 16i] . B[tx + 16j] over D columns of two padded tiles
template <int D>
__device__ __forceinline__ void tile_dot(const float* a, const float* b,
                                         int ty, int tx, float s[4][4]) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int c = 0; c < D; ++c) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[(ty + 16 * i) * LD + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = b[(tx + 16 * j) * LD + c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(x[i], y[j], s[i][j]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dq, Strides sq, Strides sk, Strides sv,
                Strides sdo, Strides sdq, int H, int KV, int S, float scale,
                int causal, int window) {
  constexpr int NC = D / 16;
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  float* q_s = smem;                    // (kTile, LD) q_hat
  float* do_s = q_s + kTile * LD;
  float* k_s = do_s + kTile * LD;
  float* v_s = k_s + kTile * LD;
  float* ds_s = v_s + kTile * LD;       // (kTile, kLP)
  float* lse_s = ds_s + kTile * kLP;
  float* dl_s = lse_s + kTile;

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* kb = k + b * sk.b + kvh * sk.h;
  const float* vb = v + b * sv.b + kvh * sv.h;

  load_tile<D>(q_s, q + b * sq.b + h * sq.h, sq.s, q0, S, scale);
  load_tile<D>(do_s, dout + b * sdo.b + h * sdo.h, sdo.s, q0, S, 1.f);
  if (tid < kTile) {
    const bool ok = q0 + tid < S;
    const long long at = static_cast<long long>(bh) * S + q0 + tid;
    lse_s[tid] = ok ? lse[at] : 0.f;
    dl_s[tid] = ok ? delta[at] : 0.f;
  }
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;

  int lo, hi;
  k_tiles(q0, S, causal, window, &lo, &hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<D>(k_s, kb, sk.s, k0, S, 1.f);
    load_tile<D>(v_s, vb, sv.s, k0, S, 1.f);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<D>(q_s, k_s, ty, tx, s);
    tile_dot<D>(do_s, v_s, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float sc =
            visible(q0 + r, k0 + c, S, causal, window) ? s[i][j] : kNegInf;
        const float p = expf(sc - lse_s[r]);
        ds_s[r * kLP + c] = p * (dp[i][j] - dl_s[r]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float x[4], y[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = ds_s[(ty + 16 * i) * kLP + c];
#pragma unroll
      for (int j = 0; j < NC; ++j) y[j] = k_s[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
    }
  }
  float* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j)
      dqb[static_cast<long long>(row) * sdq.s + tx + 16 * j] =
          acc[i][j] * scale;
  }
}

// dynamic shared memory of the dq kernel for head dim D
constexpr size_t dq_smem(int D) {
  return sizeof(float) * (4 * kTile * (D + 1) + kTile * kLP + 2 * kTile);
}

// cudaFuncSetAttribute applies to the current device only, so each launcher
// instantiation keeps one flag a device (a static local) and sets the
// attribute on a device's first launch; later launches, in a CUDA graph
// capture too, make no runtime call but cudaGetDevice and the launch.  A
// failed set is not remembered: the next launch tries again.
constexpr int kMaxDevices = 64;
using DeviceFlags = std::atomic<bool>[kMaxDevices];

template <typename Kernel>
cudaError_t allow_smem(DeviceFlags& set, Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
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

Strides strides(const long long* s) { return Strides{s[0], s[1], s[2]}; }

template <int D>
cudaError_t dq(const float* q, const float* k, const float* v,
               const float* dout, const float* lse, const float* delta,
               float* dq_out, const long long* st, int B, int H, int KV, int S,
               float scale, int causal, int window, cudaStream_t stream) {
  auto kernel = flash_dq_kernel<D>;
  static DeviceFlags smem_set;
  const cudaError_t attr = allow_smem(smem_set, kernel, dq_smem(D));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((S + kTile - 1) / kTile, B * H);
  kernel<<<grid, kThreads, dq_smem(D), stream>>>(
      q, k, v, dout, lse, delta, dq_out, strides(st), strides(st + 3),
      strides(st + 6), strides(st + 9), strides(st + 12), H, KV, S, scale,
      causal, window);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// strides of q, k, v, do, dq
int flash_dq_launch(const float* q, const float* k, const float* v,
                    const float* dout, const float* lse, const float* delta,
                    float* dq_out, const long long* strides, int B, int H,
                    int KV, int S, int d, float scale, int causal, int window,
                    void* stream) {
  using Launch = decltype(&dq<16>);
  const Launch launch = d == 16    ? &dq<16>
                        : d == 32  ? &dq<32>
                        : d == 64  ? &dq<64>
                        : d == 128 ? &dq<128>
                                   : nullptr;
  if (launch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(q, k, v, dout, lse, delta, dq_out, strides,
                                 B, H, KV, S, scale, causal, window,
                                 static_cast<cudaStream_t>(stream)));
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
