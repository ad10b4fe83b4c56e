// Paged decode attention through a block table, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py::_kernel
// (called through paged_attention, from models/transformer.py::_attn_paged).
// One decode step of GQA attention for a batch of requests whose K/V live
// in fixed-size blocks of a global pool:
//
//   q        (B, H, hd)          bf16 or f32, head h*G+g is query g of kv-head h
//   k/v pool (N, KV, bs, hd)     bf16 or f32
//   tables   (B, P)   int32      pool block of each request's page p
//   ctx      (B,)     int32      valid positions, the token being decoded included
//   out      (B, H, hd)          q's dtype
//
// Design.  The TPU kernel walks the pages on a sequential grid axis and
// carries the online-softmax state in VMEM scratch between grid steps.
// Blocks on the GPU run in no order, so here one thread block owns one
// (request b, kv-head h) pair and loops over that request's positions
// itself, reading block_tables[b, pos / bs] on its own (no scalar
// prefetch).  It visits only positions in [max(ctx - window, 0), ctx):
// pages past the context and pages below the window are never read.
// Because every visited key is valid, the reference's masking (-1e30
// scores, lanes zeroed after the exp) reduces to the loop bounds.
//
// Inside the block the positions are dealt to the kWarps warps in groups
// of kGroup: warp w takes groups w, w + kWarps, ...  A warp loads the K
// and V rows of its whole group at once (lanes across hd, bf16x2/float2
// loads coalesced along each row), so 2 * kGroup rows are in flight per
// warp, then for each of the G grouped query rows: the scores by shuffle
// reduction, an online-softmax step (running max m, sum l, rescale
// alpha) and acc = acc * alpha + sum_r p_r v_r.  Each warp keeps its own
// m, l and acc (shared memory, private to the warp); at the end the
// warps' states merge: out = sum_w e^(m_w - M) acc_w / max(L, 1e-30).
// A row with an empty range (ctx == 0, an inactive engine slot) keeps
// l = 0, acc = 0 in every warp and comes out as exact zeros through the
// 1e-30 floor, not as mean(v).  The G query rows sit in shared memory,
// pre-scaled by hd**-0.5 in f32 as the reference does; all arithmetic is
// f32.  Every result depends on its own row's inputs only, with a fixed
// assignment of positions to warps and a fixed order of summation, so a
// row computed in a batch of 8 and alone is bit-identical.
//
// Bound.  The kernel must read each valid key and value once:
//   bytes = sum_b min(ctx_b, window) * KV * hd * 2 * sizeof(pool)
//         + q bytes + out bytes,
// over 3.35 TB/s on an H100 SXM.  Its operations (4 * G * hd per key) are
// far below the bf16 ridge, so it is bound by bytes.
//
// What this simple design leaves on the table: one block per (b, h) puts
// only B * KV blocks on 132 SMs (16 for qwen2-0.5b at batch 8), and
// nothing splits a long context across blocks (split-K, flash-decoding);
// loads are 4 or 8 bytes a lane, not 16, and no cp.async/TMA pipeline
// keeps the next group's rows in flight during this group's math; the
// scores are plain FMAs, not tensor-core products.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 4;            // positions a warp loads at once
constexpr int kMaxPairsPerLane = 4;  // hd <= 256: hd / 2 <= 128 pairs
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
                       const TKV* __restrict__ v_pool,
                       const int* __restrict__ tables,
                       const int* __restrict__ ctx_lens, TQ* __restrict__ out,
                       int H, int KV, int hd, int N, int bs, int P, int window,
                       float scale) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KV;
  const int hp = hd / 2;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ float2 smem[];
  float2* q_s = smem;                                  // (G, hp)
  float2* acc_s = q_s + G * hp;                        // (kWarps, G, hp)
  float* m_s = reinterpret_cast<float*>(acc_s + kWarps * G * hp);  // (kWarps, G)
  float* l_s = m_s + kWarps * G;                       // (kWarps, G)

  // Out-of-range inputs stay in bounds: the positions visited stop at
  // the table's reach and block ids are clamped to the pool (the
  // reference's gather clamps too); the window starts from the true ctx.
  const int ctx_in = max(ctx_lens[b], 0);
  const int ctx = min(ctx_in, P * bs);
  const int lo = window >= 0 ? max(ctx_in - window, 0) : 0;
  const int* tbl = tables + static_cast<long long>(b) * P;
  const long long head0 = static_cast<long long>(b) * H + static_cast<long long>(h) * G;

  const TQ* qb = q + head0 * hd;
  for (int e = tid; e < G * hp; e += kThreads) {
    const int g = e / hp, j = e - g * hp;
    const float2 x = load2(qb + static_cast<long long>(g) * hd + 2 * j);
    q_s[e] = make_float2(x.x * scale, x.y * scale);
  }
  for (int e = tid; e < kWarps * G * hp; e += kThreads)
    acc_s[e] = make_float2(0.f, 0.f);
  for (int e = tid; e < kWarps * G; e += kThreads) {
    m_s[e] = kNegInf;
    l_s[e] = 0.f;
  }
  __syncthreads();

  float2* acc_w = acc_s + warp * G * hp;
  float* m_w = m_s + warp * G;
  float* l_w = l_s + warp * G;

  for (int p0 = lo + warp * kGroup; p0 < ctx; p0 += kWarps * kGroup) {
    float2 kx[kGroup][kMaxPairsPerLane];
    float2 vx[kGroup][kMaxPairsPerLane];
    bool valid[kGroup];
#pragma unroll
    for (int r = 0; r < kGroup; ++r) {
      const int pos = p0 + r;
      valid[r] = pos < ctx;
      long long row = 0;
      if (valid[r]) {
        const int blk = min(max(tbl[pos / bs], 0), N - 1);
        row = ((static_cast<long long>(blk) * KV + h) * bs + pos % bs) * hd;
      }
#pragma unroll
      for (int i = 0; i < kMaxPairsPerLane; ++i) {
        const int j = lane + 32 * i;
        const bool ok = valid[r] && j < hp;
        kx[r][i] = ok ? load2(k_pool + row + 2 * j) : make_float2(0.f, 0.f);
        vx[r][i] = ok ? load2(v_pool + row + 2 * j) : make_float2(0.f, 0.f);
      }
    }

    for (int g = 0; g < G; ++g) {
      float2 qq[kMaxPairsPerLane];
#pragma unroll
      for (int i = 0; i < kMaxPairsPerLane; ++i) {
        const int j = lane + 32 * i;
        qq[i] = j < hp ? q_s[g * hp + j] : make_float2(0.f, 0.f);
      }
      // scores of the group's positions for query row g
      float s[kGroup];
#pragma unroll
      for (int r = 0; r < kGroup; ++r) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < kMaxPairsPerLane; ++i) {
          part = fmaf(qq[i].x, kx[r][i].x, part);
          part = fmaf(qq[i].y, kx[r][i].y, part);
        }
        s[r] = part;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int r = 0; r < kGroup; ++r)
          s[r] += __shfl_xor_sync(0xffffffffu, s[r], o);
      }
      // online softmax step; position p0 is always valid
      float mx = s[0];
#pragma unroll
      for (int r = 1; r < kGroup; ++r)
        if (valid[r]) mx = fmaxf(mx, s[r]);
      const float m_old = m_w[g];
      const float m_new = fmaxf(m_old, mx);
      const float alpha = expf(m_old - m_new);
      float p[kGroup];
      float psum = 0.f;
#pragma unroll
      for (int r = 0; r < kGroup; ++r) {
        p[r] = valid[r] ? expf(s[r] - m_new) : 0.f;
        psum += p[r];
      }
#pragma unroll
      for (int i = 0; i < kMaxPairsPerLane; ++i) {
        const int j = lane + 32 * i;
        if (j < hp) {
          float2 a = acc_w[g * hp + j];
          a.x *= alpha;
          a.y *= alpha;
#pragma unroll
          for (int r = 0; r < kGroup; ++r) {
            a.x = fmaf(p[r], vx[r][i].x, a.x);
            a.y = fmaf(p[r], vx[r][i].y, a.y);
          }
          acc_w[g * hp + j] = a;
        }
      }
      __syncwarp();
      if (lane == 0) {
        m_w[g] = m_new;
        l_w[g] = l_w[g] * alpha + psum;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // merge the warps' states
  TQ* ob = out + head0 * hd;
  for (int e = tid; e < G * hp; e += kThreads) {
    const int g = e / hp, j = e - g * hp;
    float M = kNegInf;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, m_s[w * G + g]);
    float L = 0.f;
    float2 a = make_float2(0.f, 0.f);
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(m_s[w * G + g] - M);
      L = fmaf(l_s[w * G + g], c, L);
      const float2 x = acc_s[(w * G + g) * hp + j];
      a.x = fmaf(c, x.x, a.x);
      a.y = fmaf(c, x.y, a.y);
    }
    const float inv = 1.f / fmaxf(L, 1e-30f);
    store2(ob + static_cast<long long>(g) * hd + 2 * j, a.x * inv, a.y * inv);
  }
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* tables, const int* ctx, void* out, int B, int H,
                   int KV, int hd, int N, int bs, int P, int window, float scale,
                   cudaStream_t stream) {
  const int G = H / KV;
  const size_t smem = static_cast<size_t>(G) *
                      ((1 + kWarps) * hd * sizeof(float) +
                       2 * kWarps * sizeof(float));
  auto kernel = paged_attention_kernel<TQ, TKV>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(KV, B), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), tables, ctx, static_cast<TQ*>(out), H,
      KV, hd, N, bs, P, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// window < 0 means no window.  Returns the cudaError_t of the launch.
int paged_attention_launch(const void* q, const void* k_pool,
                           const void* v_pool, const void* tables,
                           const void* ctx, void* out, int B, int H, int KV,
                           int hd, int N, int bs, int P, int window,
                           float scale, int q_bf16, int kv_bf16,
                           void* stream) {
  const int* tb = static_cast<const int*>(tables);
  const int* cl = static_cast<const int*>(ctx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_bf16 && kv_bf16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(q, k_pool, v_pool, tb, cl, out, B, H, KV, hd, N, bs, P, window, scale, s);
  else if (q_bf16)
    err = launch<__nv_bfloat16, float>(q, k_pool, v_pool, tb, cl, out, B, H, KV, hd, N, bs, P, window, scale, s);
  else if (kv_bf16)
    err = launch<float, __nv_bfloat16>(q, k_pool, v_pool, tb, cl, out, B, H, KV, hd, N, bs, P, window, scale, s);
  else
    err = launch<float, float>(q, k_pool, v_pool, tb, cl, out, B, H, KV, hd, N, bs, P, window, scale, s);
  return static_cast<int>(err);
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
