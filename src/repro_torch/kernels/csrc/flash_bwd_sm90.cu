// Flash attention backward on Hopper's tensor cores (sm_90a): the dq and
// dk/dv kernels for bf16 q, k, v and do.
//
// Replaces the TPU kernels of src/repro/kernels/flash_attention.py on the
// bf16 path (the model's training dtype):
//
//   flash_dq_sm90_kernel   <- _dq_kernel: p = exp(s - lse),
//                             ds = p (do v^T - delta), dq = scale sum ds k
//   flash_dkv_sm90_kernel  <- _dkv_kernel, one block per query head as its
//                             grid, dv = sum p^T do, dk = scale sum ds^T q;
//                             the sum over each group's G query heads runs
//                             after the kernel (flash_attention.py:264-265)
//
// f32 inputs run dq and dk/dv on the tensor cores in flash_f32_sm90.cu
// (three TF32 products a product hold the host to 1e-4, which one would
// not).
// bf16 at d = 16 and 32 runs here too, zero-padded to 64 columns in
// shared memory (the padding adds zeros to q.k and do.v, and its dq, dk
// and dv columns are never stored).
//
// Layout and masks: q, do, dq (B, H, S, d) and
// k, v, dk, dv (B, KV, S, d) with any strides whose rows start on 16 bytes
// (the wrapper checks), lse and delta (B * H, S) f32; causal kpos <= qpos,
// window w kpos > qpos - w; tiles of 64 rows, skipped outside the
// reference's lo/hi; S need not be a multiple of 64 (rows and columns past
// S are zero-filled, masked and never stored).
//
// Arithmetic.  q enters the products unscaled, exactly as bf16:
// s = scale (q . k) in f32 with scale = f32(d**-0.5) (q scale is not exact
// in bf16); p = exp(s - lse); ds = p (dp - delta) with dp = do . v.  The
// second products take p and ds, which are f32, as two bf16 terms each,
// hi = bf16(x) and lo = bf16(x - hi), multiplied into one f32 accumulator:
// rounding p and ds once to bf16 (as FlashAttention-2 does) leaves errors
// up to 60x a bf16 step of the outputs, the two terms hold them to one
// step.  dq and dk are multiplied by scale once, at the end.
//
// Design.  One warpgroup (128 threads) a block; every product is a
// wgmma.mma_async m64nNk16 bf16 -> f32 with the accumulators in registers.
// Tiles are bf16 in shared memory in the 128-byte swizzle of sm90.cuh,
// whose one layout serves as the k-major operand (K in s = q k^T) and the
// n-major one (K in dq += ds K).  Tiles stream through a two-stage ring
// filled by 16-byte cp.async, the next tile's copies in flight while the
// current one is multiplied.
//
//   dq     one block per (b h, 64-row q-tile), longest causal q-tiles
//          first.  Q and dO stay; K and V stream.  S = Q K^T and
//          dP = dO V^T from shared memory; ds, split, becomes the register
//          A operand of dq += ds K (K n-major).
//   dk/dv  one block per (b h, 64-row k-tile), the reference's grid: at
//          qwen2-0.5b's round shape 56 blocks where a block per kv head
//          gives 8.  K and V stay; Q, dO, lse and delta stream.  S^T = K Q^T
//          and dP^T = V dO^T put keys on the accumulator rows, so p^T and
//          ds^T are register A operands of dv += p^T dO and dk += ds^T Q
//          (dO, Q n-major) with no trip through shared memory.  G = 1
//          writes dk, dv in k's dtype; G > 1 writes f32 partials
//          (B H, S, d) that the wrapper sums over each group and casts once.
//
// Bound.  At S = 2048 the causal products (6 d and 8 d flops a visible
// (query, key) pair, 8 d and 12 d as issued with the split) make both
// kernels compute-bound against the tensor cores' 989 TFLOP/s; at the
// round's S = 64 they read a few MB on 56-64 blocks, and latency rules.
// Shared memory: 6 tiles of 64 x max(d, 64) bf16, 97-98 KB at d = 128, so
// two blocks share an SM.
#include "sm90.cuh"

namespace {

using namespace sm90;

// ------------------------------------------------------------------- dq
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_sm90_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dq,
                     Strides sq, Strides sk, Strides sv, Strides sdo,
                     Strides sdq, int H, int KV, int S, float scale,
                     int causal, int window) {
  constexpr int DP = D < 64 ? 64 : D;   // columns of a tile in shared memory
  constexpr int kTileBytes = kTile * DP * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base, do_s = base + kTileBytes;
  const uint32_t k_s = base + 2 * kTileBytes;        // two stages
  const uint32_t v_s = base + 4 * kTileBytes;        // two stages

  const int n_q = (S + kTile - 1) / kTile;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int kvh = h / (H / KV);
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.y)) * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* kb = k + b * sk.b + kvh * sk.h;
  const bf16* vb = v + b * sv.b + kvh * sv.h;

  int lo, hi;
  k_tiles(q0, S, causal, window, &lo, &hi);
  load_tile<D, DP>(q_s, q + b * sq.b + h * sq.h, sq.s, q0, S);
  load_tile<D, DP>(do_s, dout + b * sdo.b + h * sdo.h, sdo.s, q0, S);
  load_tile<D, DP>(k_s, kb, sk.s, lo * kTile, S);
  load_tile<D, DP>(v_s, vb, sv.s, lo * kTile, S);
  cp_async_commit();

  // this thread's accumulator rows: rows[0] and rows[0] + 8 of the tile
  const int rows[2] = {warp * 16 + (lane >> 2), warp * 16 + (lane >> 2) + 8};
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool ok = q0 + rows[i] < S;
    const long long at = static_cast<long long>(bh) * S + q0 + rows[i];
    lse_r[i] = ok ? lse[at] : 0.f;
    dl_r[i] = ok ? delta[at] : 0.f;
  }
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

  for (int kt = lo; kt < hi; ++kt) {
    const int stage = (kt - lo) & 1;
    if (kt + 1 < hi) {
      const int next = (stage ^ 1) * kTileBytes;
      load_tile<D, DP>(k_s + next, kb, sk.s, (kt + 1) * kTile, S);
      load_tile<D, DP>(v_s + next, vb, sv.s, (kt + 1) * kTile, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_shared();
    __syncthreads();
    const uint32_t kc = k_s + stage * kTileBytes;
    const uint32_t vc = v_s + stage * kTileBytes;

    float s[32], dp[32];
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      mma_ss(s, k_major(q_s, kk), k_major(kc, kk), kk);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      mma_ss(dp, k_major(do_s, kk), k_major(vc, kk), kk);
    mma_commit();
    mma_wait();
    hold(s);
    hold(dp);

    // element i: row rows[(i >> 1) & 1], column 8 (i >> 2) + 2 (lane & 3) +
    // (i & 1); a pair (i, i + 1) is one register of the A operand
    const int k0 = kt * kTile;
    const bool edge = any_masked(q0, k0, S, causal, window);
    uint32_t ds_hi[16], ds_lo[16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = (i >> 1) & 1;
      const int c = 8 * (i >> 2) + 2 * (lane & 3);
      float x[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float sc = s[i + j] * scale;
        if (edge && !visible(q0 + rows[r], k0 + c + j, S, causal, window))
          sc = kNegInf;
        x[j] = expf(sc - lse_r[r]) * (dp[i + j] - dl_r[r]);
      }
      split(x[0], x[1], ds_hi[i >> 1], ds_lo[i >> 1]);
    }
    hold(acc);
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_rs(acc, ds_hi + 4 * kk, n_major(kc, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_rs(acc, ds_lo + 4 * kk, n_major(kc, kk));
    mma_commit();
    mma_wait();
    hold(acc);
    hold(ds_hi);
    hold(ds_lo);
    __syncthreads();                    // the stage may be refilled
  }
  cp_async_wait<0>();

  bf16* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int i = 0; i < DP / 2; i += 2) {
    const int row = q0 + rows[(i >> 1) & 1];
    const int c = 8 * (i >> 2) + 2 * (lane & 3);
    if (row < S && c < D)
      *reinterpret_cast<__nv_bfloat162*>(
          dqb + static_cast<long long>(row) * sdq.s + c) =
          __floats2bfloat162_rn(acc[i] * scale, acc[i + 1] * scale);
  }
}

// ----------------------------------------------------------------- dk/dv
template <int D, bool kPartial>
__global__ void __launch_bounds__(kThreads)
flash_dkv_sm90_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, void* __restrict__ dk,
                      void* __restrict__ dv, Strides sq, Strides sk,
                      Strides sv, Strides sdo, Strides sdk, Strides sdv, int H,
                      int KV, int S, float scale, int causal, int window) {
  constexpr int DP = D < 64 ? 64 : D;
  constexpr int kTileBytes = kTile * DP * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t k_s = base, v_s = base + kTileBytes;
  const uint32_t q_s = base + 2 * kTileBytes;        // two stages
  const uint32_t do_s = base + 4 * kTileBytes;       // two stages
  const uint32_t rows_s = base + 6 * kTileBytes;     // two stages of lse, delta
  // the same rows through a generic pointer, for plain loads
  const float* rows_p = reinterpret_cast<const float*>(
      smem_raw + (rows_s - smem_addr(smem_raw)));

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int kvh = h / (H / KV);
  const int k0 = blockIdx.y * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* dob = dout + b * sdo.b + h * sdo.h;
  const float* lseb = lse + static_cast<long long>(bh) * S;
  const float* dlb = delta + static_cast<long long>(bh) * S;

  // the q-tiles that see this k-tile (flash_attention.py:148-159)
  const int n_q = (S + kTile - 1) / kTile;
  const int lo = causal ? k0 / kTile : 0;
  const int hi =
      window > 0 ? min(n_q, (k0 + kTile - 1 + window - 1) / kTile + 1) : n_q;

  load_tile<D, DP>(k_s, k + b * sk.b + kvh * sk.h, sk.s, k0, S);
  load_tile<D, DP>(v_s, v + b * sv.b + kvh * sv.h, sv.s, k0, S);
  load_tile<D, DP>(q_s, qb, sq.s, lo * kTile, S);
  load_tile<D, DP>(do_s, dob, sdo.s, lo * kTile, S);
  load_rows(rows_s, lseb, dlb, lo * kTile, S);
  cp_async_commit();

  // this thread's accumulator rows (keys): rows[0] and rows[0] + 8
  const int rows[2] = {warp * 16 + (lane >> 2), warp * 16 + (lane >> 2) + 8};
  float dk_acc[DP / 2], dv_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int qt = lo; qt < hi; ++qt) {
    const int stage = (qt - lo) & 1;
    if (qt + 1 < hi) {
      const int next = (stage ^ 1) * kTileBytes;
      load_tile<D, DP>(q_s + next, qb, sq.s, (qt + 1) * kTile, S);
      load_tile<D, DP>(do_s + next, dob, sdo.s, (qt + 1) * kTile, S);
      load_rows(rows_s + (stage ^ 1) * 2 * kTile * 4, lseb, dlb,
                (qt + 1) * kTile, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_shared();
    __syncthreads();
    const uint32_t qc = q_s + stage * kTileBytes;
    const uint32_t doc = do_s + stage * kTileBytes;
    const float* lse_s = rows_p + stage * 2 * kTile;
    const float* dl_s = lse_s + kTile;

    float s[32], dp[32];                // S^T and dP^T: keys x queries
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      mma_ss(s, k_major(k_s, kk), k_major(qc, kk), kk);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      mma_ss(dp, k_major(v_s, kk), k_major(doc, kk), kk);
    mma_commit();
    mma_wait();
    hold(s);
    hold(dp);

    const int q0 = qt * kTile;
    const bool edge = any_masked(q0, k0, S, causal, window);
    uint32_t p_hi[16], p_lo[16], ds_hi[16], ds_lo[16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = rows[(i >> 1) & 1];
      const int c = 8 * (i >> 2) + 2 * (lane & 3);
      float p[2], ds[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float sc = s[i + j] * scale;
        if (edge && !visible(q0 + c + j, k0 + r, S, causal, window))
          sc = kNegInf;
        p[j] = expf(sc - lse_s[c + j]);
        ds[j] = p[j] * (dp[i + j] - dl_s[c + j]);
      }
      split(p[0], p[1], p_hi[i >> 1], p_lo[i >> 1]);
      split(ds[0], ds[1], ds_hi[i >> 1], ds_lo[i >> 1]);
    }
    hold(dk_acc);
    hold(dv_acc);
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_rs(dv_acc, p_hi + 4 * kk, n_major(doc, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_rs(dv_acc, p_lo + 4 * kk, n_major(doc, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_rs(dk_acc, ds_hi + 4 * kk, n_major(qc, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_rs(dk_acc, ds_lo + 4 * kk, n_major(qc, kk));
    mma_commit();
    mma_wait();
    hold(dk_acc);
    hold(dv_acc);
    hold(p_hi);
    hold(p_lo);
    hold(ds_hi);
    hold(ds_lo);
    __syncthreads();                    // the stage may be refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < DP / 2; i += 2) {
    const int row = k0 + rows[(i >> 1) & 1];
    const int c = 8 * (i >> 2) + 2 * (lane & 3);
    if (row >= S || c >= D) continue;
    const float2 gk = make_float2(dk_acc[i] * scale, dk_acc[i + 1] * scale);
    const float2 gv = make_float2(dv_acc[i], dv_acc[i + 1]);
    if (kPartial) {                     // (B H, S, D) f32 partials
      const long long at = (static_cast<long long>(bh) * S + row) * D + c;
      *reinterpret_cast<float2*>(static_cast<float*>(dk) + at) = gk;
      *reinterpret_cast<float2*>(static_cast<float*>(dv) + at) = gv;
    } else {                            // G = 1: kvh = h
      bf16* dkb = static_cast<bf16*>(dk) + b * sdk.b + kvh * sdk.h;
      bf16* dvb = static_cast<bf16*>(dv) + b * sdv.b + kvh * sdv.h;
      *reinterpret_cast<__nv_bfloat162*>(
          dkb + static_cast<long long>(row) * sdk.s + c) =
          __floats2bfloat162_rn(gk.x, gk.y);
      *reinterpret_cast<__nv_bfloat162*>(
          dvb + static_cast<long long>(row) * sdv.s + c) =
          __floats2bfloat162_rn(gv.x, gv.y);
    }
  }
}

// ------------------------------------------------------------------ host
// dynamic shared memory: six (64, max(d, 64)) bf16 tiles, dk/dv's two
// stages of lse and delta, and 1 KB to align the swizzle atoms
constexpr size_t dq_smem(int D) {
  return 6 * kTile * (D < 64 ? 64 : D) * 2 + 1024;
}
constexpr size_t dkv_smem(int D) { return dq_smem(D) + 4 * kTile * 4; }

template <int D>
cudaError_t dq(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq_out,
               const long long* st, int B, int H, int KV, int S, float scale,
               int causal, int window, cudaStream_t stream) {
  auto kernel = flash_dq_sm90_kernel<D>;
  static DeviceFlags smem_set;
  const cudaError_t attr = allow_smem(smem_set, kernel, dq_smem(D));
  if (attr != cudaSuccess) return attr;
  const dim3 grid(B * H, (S + kTile - 1) / kTile);
  kernel<<<grid, kThreads, dq_smem(D), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dq_out), strides(st), strides(st + 3),
      strides(st + 6), strides(st + 9), strides(st + 12), H, KV, S, scale,
      causal, window);
  return cudaGetLastError();
}

template <int D>
cudaError_t dkv(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dk, void* dv,
                const long long* st, int B, int H, int KV, int S, float scale,
                int causal, int window, int partial, cudaStream_t stream) {
  auto kernel = partial ? flash_dkv_sm90_kernel<D, true>
                        : flash_dkv_sm90_kernel<D, false>;
  static DeviceFlags smem_set[2];
  const cudaError_t attr =
      allow_smem(smem_set[partial ? 1 : 0], kernel, dkv_smem(D));
  if (attr != cudaSuccess) return attr;
  const dim3 grid(B * H, (S + kTile - 1) / kTile);
  kernel<<<grid, kThreads, dkv_smem(D), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      dk, dv, strides(st), strides(st + 3), strides(st + 6), strides(st + 9),
      strides(st + 12), strides(st + 15), H, KV, S, scale, causal, window);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// strides: (b, h, s) element strides of q, k, v, do, dq.  window <= 0
// means none.  Returns the cudaError_t of the launch.
int flash_dq_sm90_launch(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dq_out, const long long* strides, int B, int H,
                         int KV, int S, int d, float scale, int causal,
                         int window, void* stream) {
  SM90_HEAD_DIMS(dq, q, k, v, dout, static_cast<const float*>(lse),
                 static_cast<const float*>(delta), dq_out, strides, B, H, KV,
                 S, scale, causal, window, static_cast<cudaStream_t>(stream))
}

// strides of q, k, v, do, dk, dv.  partial: dk and dv are f32 (B H, S, d)
// per query head (for G > 1), else k's dtype and strides (G = 1 only).
int flash_dkv_sm90_launch(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dk, void* dv,
                          const long long* strides, int B, int H, int KV,
                          int S, int d, float scale, int causal, int window,
                          int partial, void* stream) {
  if (!partial && H != KV) return static_cast<int>(cudaErrorInvalidValue);
  SM90_HEAD_DIMS(dkv, q, k, v, dout, static_cast<const float*>(lse),
                 static_cast<const float*>(delta), dk, dv, strides, B, H, KV,
                 S, scale, causal, window, partial,
                 static_cast<cudaStream_t>(stream))
}

// bytes of dynamic shared memory a block of the dq (kind 0) or dk/dv
// (kind 1) kernel takes at head dim d
int flash_bwd_sm90_smem(int kind, int d) {
  return static_cast<int>(kind ? dkv_smem(d) : dq_smem(d));
}

const char* flash_bwd_sm90_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
