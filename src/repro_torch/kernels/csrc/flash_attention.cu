// Flash attention for training, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/flash_attention.py
// (called through flash_attention, a custom VJP, from
// models/transformer.py::_attn when cfg.flash_attention trains a shape the
// 128-blocks tile):
//
//   flash_fwd_kernel  <- _fwd_kernel: blocked online softmax; emits o (q's
//                        dtype) and lse = m + log(max(l, 1e-30)) in f32
//   flash_dq_kernel   <- _dq_kernel: p = exp(s - lse), ds = p (do v^T - delta),
//                        dq = scale * sum ds k
//   flash_dkv_kernel  <- _dkv_kernel and the group sum after it:
//                        dv = sum p^T do, dk = sum ds^T q_hat over the G
//                        query heads of a kv head, in f32, cast once
//
// All three take f32 only.  bf16 runs on the tensor cores: the forward
// in flash_fwd_sm90.cu, dq and dk/dv in flash_bwd_sm90.cu.
//
//   q, do, o, dq (B, H, S, d)   f32, any strides with d contiguous
//   k, v, dk, dv (B, KV, S, d)  q's dtype, H = KV * G (query head h reads
//                               kv head h / G, the reference's _kv_index)
//   lse, delta   (B * H, S)     f32, contiguous
//
// Arithmetic, as the Pallas kernels: every input is widened to f32 as it is
// loaded into shared memory, q is multiplied by scale = f32(d**-0.5) there
// (q_hat), masked scores are -1e30 (causal: kpos <= qpos; window w:
// kpos > qpos - w), and all sums are f32.  dq is scaled once at the end;
// dk carries the scale through q_hat.  delta = rowsum(do * o) is computed
// outside, as the reference computes it outside its kernels.
//
// Design.  The TPU kernels walk k-blocks (or q-blocks) on a sequential
// loop inside one grid step with the running state in VMEM.  Here one
// thread block of 256 threads owns a 64-row tile and loops over the
// 64-row tiles it must see, staging each in shared memory as f32 with
// rows padded to d + 1 floats (no bank conflicts on the column walks):
//
//   forward  one block per (b*h, q-tile): Q_hat, then per k-tile K and V;
//            S = Q_hat K^T as a 4x4 register tile per thread (rows ty +
//            16i, columns tx + 16j), masked into shared memory; four
//            threads per row take the online-softmax step (running max m,
//            sum l, rescale alpha); then acc = alpha acc + P V, a 4 x d/16
//            register tile per thread.
//   dq       one block per (b*h, q-tile): Q_hat, dO, lse, delta; per
//            k-tile S and dP = dO V^T in registers, dS to shared memory,
//            dq += dS K in registers.
//   dk/dv    one block per (b*kv, k-tile): K and V stay; the block loops
//            over its G query heads and, for each, over the q-tiles that
//            see the k-tile; P and dS go to shared memory, and dv += P^T dO,
//            dk += dS^T Q_hat accumulate in registers over heads and tiles,
//            written once.  That is the reference's per-head kernel and its
//            group sum in one pass, the same math up to summation order.
//
// Tile bounds follow the reference's lo/hi (flash_attention.py:75-83 and
// 148-159) at 64-row tiles: tiles above the diagonal and below the window
// are skipped.  A row whose first visited tile is fully masked takes
// m = -1e30 and p = exp(0) = 1 there, which the next tile's
// alpha = exp(-1e30 - m) = 0 clears exactly, as in _fwd_kernel.  S need not
// be a multiple of 64: rows and columns past S are masked and never
// stored.
//
// Bound.  At the round's shapes (S = 64) each kernel reads and writes a few
// MB and is bound by latency and launch; at S = 2048 the causal products
// (4 S^2 d H / 2 flops forward, 6 and 8 for dq and dk/dv with the
// recompute) make it compute-bound against the tensor cores' 989 TFLOP/s.
// This first design runs the products as f32 FMAs from shared memory
// (about 60 TFLOP/s at best on the CUDA cores, halved by one shared load
// per two FMAs): no mma/wgmma, TMA, cp.async pipeline or warp
// specialisation yet.
#include <cuda_bf16.h>
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

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}

// rows r0 .. r0 + kTile - 1 of one head into a (kTile, D + 1) f32 tile,
// times mul; rows past S read as zeros
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride, int r0, int S,
                                          float mul) {
  constexpr int LD = D + 1;
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, c = e - r * D;
    const int row = r0 + r;
    dst[r * LD + c] =
        row < S ? to_f(src[static_cast<long long>(row) * row_stride + c]) * mul
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

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
                 Strides so, int H, int KV, int S, float scale, int causal,
                 int window) {
  constexpr int NC = D / 16;
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  float* q_s = smem;                    // (kTile, LD) q_hat
  float* k_s = q_s + kTile * LD;
  float* v_s = k_s + kTile * LD;
  float* p_s = v_s + kTile * LD;        // (kTile, kLP) scores, then p
  float* m_s = p_s + kTile * kLP;       // running max of each row
  float* l_s = m_s + kTile;             // running sum
  float* a_s = l_s + kTile;             // this tile's alpha

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;

  load_tile<D>(q_s, q + b * sq.b + h * sq.h, sq.s, q0, S, scale);
  if (tid < kTile) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
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
    __syncthreads();                    // the last tile's readers are done
    load_tile<D>(k_s, kb, sk.s, k0, S, 1.f);
    load_tile<D>(v_s, vb, sv.s, k0, S, 1.f);
    __syncthreads();
    float s[4][4];
    tile_dot<D>(q_s, k_s, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        p_s[r * kLP + c] =
            visible(q0 + r, k0 + c, S, causal, window) ? s[i][j] : kNegInf;
      }
    __syncthreads();
    {  // online softmax: four neighbouring lanes share a row
      const int r = tid >> 2, part = tid & 3;
      float* row = p_s + r * kLP + part * 16;
      float mx = row[0];
#pragma unroll
      for (int c = 1; c < 16; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(row[c] - m_new);
        row[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_old - m_new);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
        a_s[r] = alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float p[4], y[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = p_s[(ty + 16 * i) * kLP + c];
#pragma unroll
      for (int j = 0; j < NC; ++j) y[j] = v_s[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(p[i], y[j], acc[i][j]);
    }
  }
  __syncthreads();
  T* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, row = q0 + r;
    if (row >= S) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NC; ++j)
      ob[static_cast<long long>(row) * so.s + tx + 16 * j] =
          from_f<T>(acc[i][j] / l);
  }
  if (tid < kTile && q0 + tid < S)
    lse[static_cast<long long>(bh) * S + q0 + tid] =
        m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dq, Strides sq, Strides sk, Strides sv,
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
  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;

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
  T* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j)
      dqb[static_cast<long long>(row) * sdq.s + tx + 16 * j] =
          from_f<T>(acc[i][j] * scale);
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, Strides sq, Strides sk, Strides sv,
                 Strides sdo, Strides sdk, Strides sdv, int H, int KV, int S,
                 float scale, int causal, int window) {
  constexpr int NC = D / 16;
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  float* k_s = smem;                    // (kTile, LD)
  float* v_s = k_s + kTile * LD;
  float* q_s = v_s + kTile * LD;        // q_hat
  float* do_s = q_s + kTile * LD;
  float* p_s = do_s + kTile * LD;       // (kTile q rows, kLP)
  float* ds_s = p_s + kTile * kLP;
  float* lse_s = ds_s + kTile * kLP;
  float* dl_s = lse_s + kTile;

  const int G = H / KV;
  const int bkv = blockIdx.y, b = bkv / KV, kvh = bkv - b * KV;
  const int k0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  load_tile<D>(k_s, k + b * sk.b + kvh * sk.h, sk.s, k0, S, 1.f);
  load_tile<D>(v_s, v + b * sv.b + kvh * sv.h, sv.s, k0, S, 1.f);
  // dk and dv rows ty + 16i of this k-tile, columns tx + 16j
  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // the q-tiles that see this k-tile (flash_attention.py:148-159)
  const int n_q = (S + kTile - 1) / kTile;
  const int lo = causal ? k0 / kTile : 0;
  const int hi =
      window > 0 ? min(n_q, (k0 + kTile - 1 + window - 1) / kTile + 1) : n_q;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const long long bh = static_cast<long long>(b) * H + h;
    const T* qb = q + b * sq.b + h * sq.h;
    const T* dob = dout + b * sdo.b + h * sdo.h;
    for (int qt = lo; qt < hi; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();
      load_tile<D>(q_s, qb, sq.s, q0, S, scale);
      load_tile<D>(do_s, dob, sdo.s, q0, S, 1.f);
      if (tid < kTile) {
        const bool ok = q0 + tid < S;
        lse_s[tid] = ok ? lse[bh * S + q0 + tid] : 0.f;
        dl_s[tid] = ok ? delta[bh * S + q0 + tid] : 0.f;
      }
      __syncthreads();
      // q rows ty + 16i against k columns tx + 16j
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
          p_s[r * kLP + c] = p;
          ds_s[r * kLP + c] = p * (dp[i][j] - dl_s[r]);
        }
      }
      __syncthreads();
#pragma unroll 2
      for (int r = 0; r < kTile; ++r) {
        float p[4], ds[4], x[NC], y[NC];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = p_s[r * kLP + ty + 16 * i];
          ds[i] = ds_s[r * kLP + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          x[j] = do_s[r * LD + tx + 16 * j];
          y[j] = q_s[r * LD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NC; ++j) {
            dv_acc[i][j] = fmaf(p[i], x[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(ds[i], y[j], dk_acc[i][j]);
          }
      }
    }
  }
  T* dkb = dk + b * sdk.b + kvh * sdk.h;
  T* dvb = dv + b * sdv.b + kvh * sdv.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = tx + 16 * j;
      dkb[static_cast<long long>(row) * sdk.s + c] = from_f<T>(dk_acc[i][j]);
      dvb[static_cast<long long>(row) * sdv.s + c] = from_f<T>(dv_acc[i][j]);
    }
  }
}

// dynamic shared memory of each kernel for head dim D
constexpr size_t fwd_smem(int D) {
  return sizeof(float) * (3 * kTile * (D + 1) + kTile * kLP + 3 * kTile);
}
constexpr size_t dq_smem(int D) {
  return sizeof(float) * (4 * kTile * (D + 1) + kTile * kLP + 2 * kTile);
}
constexpr size_t dkv_smem(int D) {
  return sizeof(float) * (4 * kTile * (D + 1) + 2 * kTile * kLP + 2 * kTile);
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

template <int D, typename T>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                float* lse, const long long* st, int B, int H, int KV, int S,
                float scale, int causal, int window, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<D, T>;
  static DeviceFlags smem_set;
  const cudaError_t attr = allow_smem(smem_set, kernel, fwd_smem(D));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((S + kTile - 1) / kTile, B * H);
  kernel<<<grid, kThreads, fwd_smem(D), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, strides(st),
      strides(st + 3), strides(st + 6), strides(st + 9), H, KV, S, scale,
      causal, window);
  return cudaGetLastError();
}

template <int D, typename T>
cudaError_t dq(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq_out,
               const long long* st, int B, int H, int KV, int S, float scale,
               int causal, int window, cudaStream_t stream) {
  auto kernel = flash_dq_kernel<D, T>;
  static DeviceFlags smem_set;
  const cudaError_t attr = allow_smem(smem_set, kernel, dq_smem(D));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((S + kTile - 1) / kTile, B * H);
  kernel<<<grid, kThreads, dq_smem(D), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq_out), strides(st), strides(st + 3), strides(st + 6),
      strides(st + 9), strides(st + 12), H, KV, S, scale, causal, window);
  return cudaGetLastError();
}

template <int D, typename T>
cudaError_t dkv(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dk, void* dv,
                const long long* st, int B, int H, int KV, int S, float scale,
                int causal, int window, cudaStream_t stream) {
  auto kernel = flash_dkv_kernel<D, T>;
  static DeviceFlags smem_set;
  const cudaError_t attr = allow_smem(smem_set, kernel, dkv_smem(D));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((S + kTile - 1) / kTile, B * KV);
  kernel<<<grid, kThreads, dkv_smem(D), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), strides(st), strides(st + 3),
      strides(st + 6), strides(st + 9), strides(st + 12), strides(st + 15), H,
      KV, S, scale, causal, window);
  return cudaGetLastError();
}

// the f32 instantiations alone (bf16 runs on the tensor cores, in
// flash_fwd_sm90.cu and flash_bwd_sm90.cu)
#define FLASH_DISPATCH_F32(FN, ...)                                     \
  if (bf16) return static_cast<int>(cudaErrorInvalidValue);             \
  switch (d) {                                                          \
    case 16: return static_cast<int>(FN<16, float>(__VA_ARGS__));       \
    case 32: return static_cast<int>(FN<32, float>(__VA_ARGS__));       \
    case 64: return static_cast<int>(FN<64, float>(__VA_ARGS__));       \
    case 128: return static_cast<int>(FN<128, float>(__VA_ARGS__));     \
    default: return static_cast<int>(cudaErrorInvalidValue);            \
  }

}  // namespace

extern "C" {

// strides: (b, h, s) element strides of q, k, v, o, in that order.
// window <= 0 means none; f32 only (bf16 returns cudaErrorInvalidValue).
// Returns the cudaError_t of the launch.
int flash_fwd_launch(const void* q, const void* k, const void* v, void* o,
                     void* lse, const long long* strides, int B, int H, int KV,
                     int S, int d, float scale, int causal, int window,
                     int bf16, void* stream) {
  FLASH_DISPATCH_F32(fwd, q, k, v, o, static_cast<float*>(lse), strides, B,
                     H, KV, S, scale, causal, window,
                     static_cast<cudaStream_t>(stream))
}

// strides of q, k, v, do, dq; f32 only (bf16 returns cudaErrorInvalidValue)
int flash_dq_launch(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dq_out, const long long* strides, int B, int H,
                    int KV, int S, int d, float scale, int causal, int window,
                    int bf16, void* stream) {
  FLASH_DISPATCH_F32(dq, q, k, v, dout, static_cast<const float*>(lse),
                 static_cast<const float*>(delta), dq_out, strides, B, H, KV,
                 S, scale, causal, window, static_cast<cudaStream_t>(stream))
}

// strides of q, k, v, do, dk, dv; f32 only
int flash_dkv_launch(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dk, void* dv, const long long* strides, int B,
                     int H, int KV, int S, int d, float scale, int causal,
                     int window, int bf16, void* stream) {
  FLASH_DISPATCH_F32(dkv, q, k, v, dout, static_cast<const float*>(lse),
                 static_cast<const float*>(delta), dk, dv, strides, B, H, KV,
                 S, scale, causal, window, static_cast<cudaStream_t>(stream))
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
