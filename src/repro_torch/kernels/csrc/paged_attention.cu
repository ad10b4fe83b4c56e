// Paged decode attention through a block table, for Hopper (sm_90a), split
// over chunks of the context.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py::_kernel
// (called through paged_attention, from models/transformer.py::_attn_paged).
// One decode step of GQA attention for a batch of requests whose K/V live
// in fixed-size blocks of a global pool:
//
//   q        (B, H, hd)          bf16 or f32, head h*G+g is query g of kv-head h
//   k/v pool (N, KV, bs, hd)     bf16 or f32, hd a multiple of 8
//   tables   (B, P)   int32      pool block of each request's page p
//   ctx      (B,)     int32      valid positions, the token being decoded included
//   out      (B, H, hd)          q's dtype
//
// Bound.  The kernel must read each valid key and value once:
//   bytes = sum_b min(ctx_b, window) * KV * hd * 2 * sizeof(pool)
//         + q bytes + out bytes,
// over 3.35 TB/s on an H100 SXM.  Its operations (4 G hd per key) are far
// below the ridge, so it is bound by bytes: what counts is enough loads in
// flight on all 132 SMs.
//
// Design (split-K, as flash-decoding).  A request's visible range
// [max(ctx - window, 0), ctx) is cut at the fixed positions C, 2 C, ... (C
// a multiple of the block size, chunk_positions() in paged_attention.py,
// 64 at bs = 16), and one thread block of 256 threads takes one (request,
// kv head, chunk): the grid is B x KV x ceil(P bs / C) from the table width
// P that the host already knows, and blocks whose chunk lies outside their
// row's range exit at once, so the host never reads ctx.  A block:
//
//   1. copies its chunk's K rows, then its V rows, into shared memory with
//      16-byte cp.async (a row's page looked up in the block table by the
//      thread that copies it), as two commit groups: V stays in flight
//      while the scores are computed;
//   2. scores: hd / 8 (bf16) or hd / 4 (f32) lanes a row, 16 bytes each,
//      so that a warp covers two rows of hd = 128 in bf16 at once, against
//      the G query rows (pre-scaled by hd**-0.5 in f32, as the reference),
//      reduced by shuffles;
//   3. the chunk's softmax: m = max s, p = e^(s - m), l = sum p, a warp a
//      query row;
//   4. acc = sum_r p_r v_r: threads over (16-byte column chunk, query row,
//      slice of the chunk's rows), the slices summed in shared memory in a
//      fixed order.
//
// A row whose range is one chunk writes out = acc / max(l, 1e-30) at once.
// Otherwise each chunk writes its partial (m, l, acc) in f32 to the
// workspace, and the last of the row's chunks to finish merges them, in
// chunk order: out = sum_c e^(m_c - M) acc_c / max(sum_c e^(m_c - M) l_c,
// 1e-30), M = max_c m_c.  The last block is found by an atomic counter a
// (request, kv head), behind a __threadfence; the merging block returns
// its counter to zero, so the counters stay zero between launches and a
// replayed CUDA graph finds them so (a second launch for the merge would
// also do, at the cost of a launch and a pass over the partials).  The
// workspace and the counters belong to the wrapper, one of each per
// device; the counters are zeroed once, when they are allocated.
//
// Properties.  All arithmetic is f32.  A row with an empty range (ctx == 0,
// an inactive engine slot) comes out as exact zeros, written by its chunk-0
// block.  Chunk boundaries and the merge order depend on the row's own ctx
// and window only, never on B or P, and every sum runs in a fixed order, so
// a row computed in a batch of 8 is bit-identical to the same row alone.
// Out-of-range inputs stay in bounds: positions stop at the table's reach
// and block ids are clamped to the pool (the reference's gather clamps
// too); the window starts from the true ctx.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// the 16 bytes at p (shared memory) as 4 or 8 floats
__device__ __forceinline__ void widen(const uint8_t* p, float (&x)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
}
__device__ __forceinline__ void widen(const uint8_t* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {       // a bf16 is the top half of its f32
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// slices of a chunk's rows that step 4 sums apart: enough to give each of
// the 256 threads work when G query rows x hd / kPer column chunks are few
__host__ __device__ inline int slices(int items) {
  return items >= kThreads ? 1 : kThreads / items;
}

// dynamic shared memory of a block: K and V of C rows, the G scaled query
// rows, step 4's slices, the scores, m and l, the last-block flag
__host__ __device__ inline size_t smem_bytes(int G, int hd, int C,
                                             int kv_size) {
  const int items = G * (hd * kv_size / 16);
  return 2 * static_cast<size_t>(C) * hd * kv_size +
         4 * (static_cast<size_t>(G) * hd * (1 + slices(items)) +
              static_cast<size_t>(G) * C + 2 * G + 1);
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
                       const TKV* __restrict__ v_pool,
                       const int* __restrict__ tables,
                       const int* __restrict__ ctx_lens, TQ* __restrict__ out,
                       float* __restrict__ ws, int* __restrict__ counters,
                       int H, int KV, int hd, int N, int bs, int P, int window,
                       float scale, int C) {
  constexpr int kPer = 16 / sizeof(TKV);  // values a 16-byte chunk
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_chunks = gridDim.x;
  const int G = H / KV;
  const int CH = hd / kPer;               // 16-byte chunks a row
  const int row_bytes = hd * static_cast<int>(sizeof(TKV));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row = static_cast<long long>(b) * KV + h;
  const long long head0 = static_cast<long long>(b) * H +
                          static_cast<long long>(h) * G;
  TQ* ob = out + head0 * hd;

  const int ctx_in = max(ctx_lens[b], 0);
  const int hi = min(ctx_in, P * bs);
  const int lo = window >= 0 ? max(ctx_in - window, 0) : 0;
  const int c_lo = lo / C, c_hi = (hi + C - 1) / C;
  const int n_c = hi > lo ? c_hi - c_lo : 0;
  if (n_c == 0) {                         // empty range: exact zeros
    if (c == 0)
      for (int e = tid; e < G * hd; e += kThreads) store(ob + e, 0.f);
    return;
  }
  if (c < c_lo || c >= c_hi) return;
  const int p_lo = max(c * C, lo);
  const int n = min(c * C + C, hi) - p_lo;

  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* k_s = smem;
  uint8_t* v_s = k_s + static_cast<size_t>(C) * row_bytes;
  float* q_s = reinterpret_cast<float*>(v_s + static_cast<size_t>(C) * row_bytes);
  float* part_s = q_s + G * hd;           // (slice, g, hd)
  const int ns = slices(G * CH);
  float* s_s = part_s + ns * G * hd;      // (g, C): scores, then p
  float* m_s = s_s + G * C;
  float* l_s = m_s + G;
  int* last = reinterpret_cast<int*>(l_s + G);

  // 1. the chunk's K rows, then its V rows
  const int* tbl = tables + static_cast<long long>(b) * P;
  for (int pass = 0; pass < 2; ++pass) {
    const TKV* pool = pass ? v_pool : k_pool;
    uint8_t* dst = pass ? v_s : k_s;
    for (int e = tid; e < n * CH; e += kThreads) {
      const int r = e / CH, j = e - r * CH;
      const int pos = p_lo + r;
      const int blk = min(max(__ldg(tbl + pos / bs), 0), N - 1);
      cp_async16(dst + r * row_bytes + j * 16,
                 pool + ((static_cast<long long>(blk) * KV + h) * bs +
                         pos % bs) * hd + j * kPer);
    }
    cp_async_commit();
  }
  for (int e = tid; e < G * hd; e += kThreads)
    q_s[e] = to_f(q[head0 * hd + e]) * scale;
  cp_async_wait<1>();
  __syncthreads();

  // 2. scores: L lanes a row (a power of two), 32 / L rows a warp at once
  int L = 1;
  while (L < CH && L < 32) L <<= 1;
  const int per_warp = 32 / L, sub = lane / L, li = lane - sub * L;
  for (int r0 = warp * per_warp; r0 < n; r0 += kWarps * per_warp) {
    const int r = r0 + sub;
    float kx[2][kPer];                    // CH <= 64: two chunks a lane
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int j = li + t * L;
      if (r < n && j < CH) {
        widen(k_s + r * row_bytes + j * 16, kx[t]);
      } else {
#pragma unroll
        for (int u = 0; u < kPer; ++u) kx[t][u] = 0.f;
      }
    }
    for (int g = 0; g < G; ++g) {
      float part = 0.f;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = li + t * L;
        if (j < CH) {
          const float* qq = q_s + g * hd + j * kPer;
#pragma unroll
          for (int u = 0; u < kPer; ++u) part = fmaf(qq[u], kx[t][u], part);
        }
      }
      for (int off = L >> 1; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (li == 0 && r < n) s_s[g * C + r] = part;
    }
  }
  __syncthreads();

  // 3. the chunk's softmax, a warp a query row
  for (int g = warp; g < G; g += kWarps) {
    float mx = kNegInf;
    for (int r = lane; r < n; r += 32) mx = fmaxf(mx, s_s[g * C + r]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int r = lane; r < n; r += 32) {
      const float p = expf(s_s[g * C + r] - mx);
      s_s[g * C + r] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      m_s[g] = mx;
      l_s[g] = sum;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // 4. acc = sum_r p_r v_r over (column chunk, query row, slice of rows)
  for (int e = tid; e < G * CH * ns; e += kThreads) {
    const int j = e % CH, t = e / CH, g = t % G, sl = t / G;
    float a[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) a[u] = 0.f;
    for (int r = sl; r < n; r += ns) {
      const float p = s_s[g * C + r];
      float vx[kPer];
      widen(v_s + r * row_bytes + j * 16, vx);
#pragma unroll
      for (int u = 0; u < kPer; ++u) a[u] = fmaf(p, vx[u], a[u]);
    }
    float* dst = part_s + (sl * G + g) * hd + j * kPer;
#pragma unroll
    for (int u = 0; u < kPer; ++u) dst[u] = a[u];
  }
  __syncthreads();

  float* ws_acc = ws + (row * n_chunks + c) * G * hd;
  const bool single = n_c == 1;
  for (int e = tid; e < G * hd; e += kThreads) {
    float a = 0.f;
    for (int sl = 0; sl < ns; ++sl) a += part_s[sl * G * hd + e];
    if (single)
      store(ob + e, a / fmaxf(l_s[e / hd], 1e-30f));
    else
      ws_acc[e] = a;
  }
  if (single) return;

  // the partial's m and l, then the count of the row's finished chunks
  const long long n_rows = static_cast<long long>(gridDim.y) * gridDim.z;
  float* ws_ml = ws + n_rows * n_chunks * G * hd;   // (row, chunk, g, 2)
  if (tid < G) {
    ws_ml[((row * n_chunks + c) * G + tid) * 2] = m_s[tid];
    ws_ml[((row * n_chunks + c) * G + tid) * 2 + 1] = l_s[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *last = atomicAdd(counters + row, 1) == n_c - 1;
  __syncthreads();
  if (!*last) return;

  // the last chunk to finish merges the row's partials, in chunk order
  __threadfence();
  for (int e = tid; e < G * hd; e += kThreads) {
    const int g = e / hd;
    float M = kNegInf;
    for (int cc = c_lo; cc < c_hi; ++cc)
      M = fmaxf(M, __ldcg(ws_ml + ((row * n_chunks + cc) * G + g) * 2));
    float l_sum = 0.f, a = 0.f;
    for (int cc = c_lo; cc < c_hi; ++cc) {
      const float* ml = ws_ml + ((row * n_chunks + cc) * G + g) * 2;
      const float w = expf(__ldcg(ml) - M);
      l_sum = fmaf(w, __ldcg(ml + 1), l_sum);
      a = fmaf(w, __ldcg(ws + ((row * n_chunks + cc) * G) * hd + e), a);
    }
    store(ob + e, a / fmaxf(l_sum, 1e-30f));
  }
  if (tid == 0) counters[row] = 0;      // zero again for the next launch
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* tables, const int* ctx, void* out, float* ws,
                   int* counters, int B, int H, int KV, int hd, int N, int bs,
                   int P, int window, float scale, int C,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(H / KV, hd, C, sizeof(TKV));
  auto kernel = paged_attention_kernel<TQ, TKV>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int spans = (P * bs + C - 1) / C;
  const int n_chunks = spans > 0 ? spans : 1;
  kernel<<<dim3(n_chunks, KV, B), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), tables, ctx, static_cast<TQ*>(out),
      ws, counters, H, KV, hd, N, bs, P, window, scale, C);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// ws: B * KV * ceil(P bs / C) * G * (hd + 2) floats; counters: B * KV
// ints, zero.  window < 0 means no window.  Returns the cudaError_t of the
// launch.
int paged_attention_launch(const void* q, const void* k_pool,
                           const void* v_pool, const void* tables,
                           const void* ctx, void* out, void* ws,
                           void* counters, int B, int H, int KV, int hd,
                           int N, int bs, int P, int window, float scale,
                           int C, int q_bf16, int kv_bf16, void* stream) {
  const int* tb = static_cast<const int*>(tables);
  const int* cl = static_cast<const int*>(ctx);
  float* w = static_cast<float*>(ws);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_bf16 && kv_bf16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(q, k_pool, v_pool, tb, cl, out, w, cnt, B, H, KV, hd, N, bs, P, window, scale, C, s);
  else if (q_bf16)
    err = launch<__nv_bfloat16, float>(q, k_pool, v_pool, tb, cl, out, w, cnt, B, H, KV, hd, N, bs, P, window, scale, C, s);
  else if (kv_bf16)
    err = launch<float, __nv_bfloat16>(q, k_pool, v_pool, tb, cl, out, w, cnt, B, H, KV, hd, N, bs, P, window, scale, C, s);
  else
    err = launch<float, float>(q, k_pool, v_pool, tb, cl, out, w, cnt, B, H, KV, hd, N, bs, P, window, scale, C, s);
  return static_cast<int>(err);
}

// bytes of dynamic shared memory a block takes (the wrapper's smem_bytes)
int paged_attention_smem(int G, int hd, int C, int kv_size) {
  return static_cast<int>(smem_bytes(G, hd, C, kv_size));
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
