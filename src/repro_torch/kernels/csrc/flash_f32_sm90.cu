// Flash attention forward, dq and dk/dv on Hopper's tensor cores (sm_90a)
// for f32 q, k, v and do, at f32 accuracy (3xTF32).
//
// Replaces the TPU kernels of src/repro/kernels/flash_attention.py on the
// f32 path (a model whose params are f32, as adam makes a bf16 model after
// its first step):
//
//   flash_fwd_f32_kernel  <- _fwd_kernel (call site :193): blocked online
//                            softmax; o in f32 and lse = m + log(max(l,
//                            1e-30))
//   flash_dq_f32_kernel   <- _dq_kernel (call site :226): p = exp(s -
//                            lse), ds = p (do v^T - delta), dq = scale sum
//                            ds k, scaled once at the end
//   flash_dkv_f32_kernel  <- _dkv_kernel (call site :244) and the group sum
//                            after it: dv = sum p^T do, dk = sum ds^T q_hat
//                            over the G query heads of a kv head, in f32
//
// Layout and masks as the bf16 kernels: q, do, o, dq (B, H, S, d) and k,
// v, dk, dv (B, KV, S, d) f32 with any strides whose rows start on 16
// bytes (the wrapper checks), lse and delta (B * H, S) f32; query head h
// reads kv head h / G; causal kpos <= qpos, window w kpos > qpos - w; S need not be a
// multiple of the tiles (rows past S are zero-filled, masked and never
// stored); d in {16, 32, 64, 128}.
//
// Arithmetic, the reference's: q_hat = q * scale in f32 (scale =
// f32(d**-0.5)) before any product, masked scores -1e30, p = exp(s - m) in
// the forward (a row whose keys so far are all masked takes exp(0) = 1,
// which the next tile's alpha = exp(-1e30 - m) = 0 clears, as in
// _fwd_kernel) and exp(s - lse) in dq and dk/dv, ds = p (dp - delta), every
// sum in f32.  dk carries the scale through q_hat; dq is multiplied by it
// once, at the end.
//
// Products (3xTF32).  Every product runs on the tensor cores as
// mma.sync m16n8k8 tf32 -> f32.  One tf32 term keeps 10 mantissa bits and
// misses the f32 gate (1e-4; tests/test_torch_flash_f32.py), so each f32
// operand x is split in registers into big = x rounded to tf32 (to
// nearest, ties away: the bits plus 2**12, whose low 13 bits the tensor
// cores drop) and small = x - big (exact in f32, truncated to tf32 by the
// tensor cores), and a b is taken as a_small b_big + a_big b_small +
// a_big b_big into one f32 accumulator (CUTLASS's fast-accurate f32); the
// small x small term is dropped.  wgmma's tf32 form takes both operands
// k-major from shared memory (its transpose bits are for 16-bit types),
// which fits S = Q K^T but not P V or p^T dO; mma.sync reads its fragments
// from padded f32 tiles in any orientation instead.  Rows are padded to
// d + 4 floats, so the fragment reads of a warp (8 rows x 4 columns, or 4
// row pairs x 8 columns) fall in 32 distinct banks.
//
// The layout trap of the second products.  A score tile comes out of an
// mma as accumulators (thread (g, t) of a quad holds columns 2t and 2t + 1
// of each 8-column block) and must go back in as an A operand (columns t
// and t + 4).  The second product sums over those columns, so its
// reduction index is permuted instead of the registers: A's column t is
// key (query) 2t and column t + 4 is 2t + 1 of each 8-block, and the B
// fragment is read from the same rows of V (K; dO, Q_hat).  p and ds never
// leave registers and take no shuffle.
//
// Design.  Eight warps (256 threads) a block, two to each 16 rows of a
// 64-row tile, splitting the other side's 64-row tile into halves of 32;
// tiles are f32 in shared memory, filled by 16-byte cp.async with each
// thread's copies worked out once (RowCopy).
//   forward  one block per (b h, 64-row q-tile), the longest causal q-tiles
//            first.  Q stays in shared memory (scaled to q_hat once it
//            lands); K and V stream through a two-stage ring (one stage
//            when S fits one k-tile), the next k-tile's copies in flight
//            while this one is multiplied, and V's copy under S = Q K^T.
//            Each warp runs the online softmax over its half of every
//            k-tile; at the end the two warps of a row merge their
//            (m, l, acc) through shared memory (m = max, the others scaled
//            by exp(m_w - m)).
//   dq       the forward's block, grid and K, V ring, with dO beside Q_hat;
//            lse and delta of a thread's two rows in registers.  Each warp
//            takes S = Q_hat K^T and dP = dO V^T of its 16 x 32, ds = p
//            (dP - delta) in place, and dq += ds K with ds as the A
//            operand and K's rows as B; at the end the two warps of a row
//            add their dq through shared memory, scale once and store.
//   dk/dv    one block per (b kv, 64-key tile): keys on the accumulator
//            rows, so p^T and ds^T are A operands of dv and dk.  K and V
//            stay; the block walks the G query heads of its kv head and,
//            for each, the q-tiles that see the k-tile (the reference's
//            lo/hi), streaming Q, dO, lse and delta through a two-stage
//            ring.  Each warp takes its half of each q-tile's queries
//            (S^T and dP^T of 16 x 32 beside dk and dv of 16 x d in
//            registers); at the end the two warps of a key add their dk and
//            dv through shared memory, so the G heads are summed in the
//            block and written once in f32, with no per-head partials or
//            group sum.
//
// Bound.  At the f32 step's shape (8, 16, 16, 64, 128) the kernels move
// a few MB against a few GFLOP and are bound by bytes (about 5, 6.3 and
// 7.5 us at 3.35 TB/s); at S = 2048 the causal products (4 d, 6 d and 8 d
// flops a visible pair, 3x that as issued) bind them against the tensor
// cores' 495 TFLOP/s tf32, 165 TFLOP/s at f32 accuracy.  Shared memory at
// d = 128: the forward 169 KB (101 KB with one stage), dq 203 KB (135 KB),
// dk/dv 204 KB; one block, of eight warps, an SM.  Tried and measured
// slower on an H100: 32-row q-tiles in the forward (256 blocks at the f32
// step's shape, K and V read twice).
#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kBlock = 256;           // eight warps
constexpr int kHalf = kTile / 2;      // keys (queries) a warp takes of a tile

// Accumulation.  The tensor cores add each product into the accumulator
// with truncation, so a long chain of mma.sync into one accumulator drifts
// toward zero by up to an ulp a step: over dk/dv's G x S / 8 x 3 steps
// (1,344 at GQA 7, S = 512) that reached 0.9 of the 1e-4 gate on an H100.
// So the second products (P V; p^T dO and ds^T Q_hat) sum a warp's share
// of each tile (its 32 keys or queries, four 8-blocks) into a fresh
// fragment, which is added to the running f32 sum with an IEEE add; so
// does dq's ds K, whose chain (S / 16 x 3 steps a warp, 384 at S = 2048)
// does not grow with G but is as long as dk/dv's at one head a group;
// S = Q K^T, dP = dO V^T, S^T and dP^T chain d / 8 x 3 steps at most.

// ------------------------------------------------------------- 3xTF32
// x as two tf32 terms: big = x rounded to nearest, ties away (the tensor
// cores drop the low 13 bits of bits + 2**12), small = x - big, exact
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  const uint32_t r = __float_as_uint(x) + 0x1000u;
  big = r;
  small = __float_as_uint(x - __uint_as_float(r & 0xffffe000u));
}

// d (16 x 8) += a (16 x 8) b (8 x 8), one tf32 term each
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b at f32 accuracy: a split already, b (its two fragment values)
// split here; the small terms first, then big x big
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&a_big)[4],
                                     const uint32_t (&a_small)[4], float b0,
                                     float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split(b0, bb0, bs0);
  split(b1, bb1, bs1);
  mma(d, a_small, bb0, bb1);
  mma(d, a_big, bs0, bs1);
  mma(d, a_big, bb0, bb1);
}

// The A fragment of rows r0 .. r0 + 15 and columns c0 .. c0 + 7 of a
// padded tile (row stride LD floats), split: thread (g, t) takes (g, t),
// (g + 8, t), (g, t + 4), (g + 8, t + 4)
template <int LD>
__device__ __forceinline__ void load_a(const float* tile, int r0, int c0,
                                       int lane, uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
  const float* p = tile + (r0 + (lane >> 2)) * LD + c0 + (lane & 3);
  split(p[0], big[0], small[0]);
  split(p[8 * LD], big[1], small[1]);
  split(p[4], big[2], small[2]);
  split(p[8 * LD + 4], big[3], small[3]);
}

// An accumulator fragment (16 x 8: (g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1)) as the split A operand of a product whose reduction
// runs over its 8 columns, column t standing for 2t and t + 4 for 2t + 1
__device__ __forceinline__ void as_a(const float (&c)[4], uint32_t (&big)[4],
                                     uint32_t (&small)[4]) {
  split(c[0], big[0], small[0]);
  split(c[2], big[1], small[1]);
  split(c[1], big[2], small[2]);
  split(c[3], big[3], small[3]);
}

// The copies of one thread into a padded (ROWS, D + 4) f32 tile, worked out
// once: with NT threads and D / 4 16-byte chunks a row, a thread copies the
// same chunk of rows row0, row0 + kStep, ...
template <int D, int NT>
struct RowCopy {
  static constexpr int LD = D + 4;
  static constexpr int kChunks = D / 4;
  static constexpr int kStep = NT / kChunks;
  int at;                               // row0 * LD + column, in floats
  int row0;
  __device__ __forceinline__ RowCopy() {
    row0 = threadIdx.x / kChunks;
    at = row0 * LD + (threadIdx.x % kChunks) * 4;
  }
  // rows r0 .. r0 + ROWS - 1 of src into tile; rows past S zero
  template <int ROWS>
  __device__ __forceinline__ void copy(float* tile, const float* src,
                                       long long row_stride, int r0,
                                       int S) const {
    static_assert(ROWS % kStep == 0, "a tile is whole passes");
    const uint32_t dst = smem_addr(tile + at);
    const float* from = src + static_cast<long long>(r0 + row0) * row_stride +
                        (at - row0 * LD);
#pragma unroll
    for (int j = 0; j < ROWS / kStep; ++j) {
      const bool ok = r0 + row0 + j * kStep < S;
      cp_async16(dst + j * kStep * LD * 4,
                 ok ? from + j * kStep * row_stride : src, ok);
    }
  }
  // this thread's chunks of tile, once landed, times x
  template <int ROWS>
  __device__ __forceinline__ void scale(float* tile, float x) const {
#pragma unroll
    for (int j = 0; j < ROWS / kStep; ++j) {
      float4* p = reinterpret_cast<float4*>(tile + at + j * kStep * LD);
      float4 y = *p;
      y.x *= x;
      y.y *= x;
      y.z *= x;
      y.w *= x;
      *p = y;
    }
  }
};

// ------------------------------------------------------------- forward
template <int D>
__global__ void __launch_bounds__(kBlock, 1)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, Strides sq, Strides sk,
                     Strides sv, Strides so, int H, int KV, int S,
                     float scale, int causal, int window) {
  constexpr int LD = D + 4;
  constexpr int NB = D / 8;             // 8-column blocks of the head dim
  extern __shared__ __align__(16) float smem[];
  const int n_k = (S + kTile - 1) / kTile;
  const int stages = n_k > 1 ? 2 : 1;
  float* q_s = smem;                                 // (64, LD) q_hat
  float* k_s = q_s + kTile * LD;                     // stages x (64, LD)
  float* v_s = k_s + stages * kTile * LD;

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int kvh = h / (H / KV);
  const int q0 = (n_k - 1 - static_cast<int>(blockIdx.y)) * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp & 3) * 16;       // this warp's query rows
  const int c0 = (warp >> 2) * kHalf;   // and its half of each k-tile
  const float* kb = k + b * sk.b + kvh * sk.h;
  const float* vb = v + b * sv.b + kvh * sv.h;
  const RowCopy<D, kBlock> rows;

  // the k-tiles that the q-tile sees (flash_attention.py:75-83)
  int lo, hi;
  k_tiles(q0, S, causal, window, &lo, &hi);
  rows.template copy<kTile>(q_s, q + b * sq.b + h * sq.h, sq.s, q0, S);
  rows.template copy<kTile>(k_s, kb, sk.s, lo * kTile, S);
  cp_async_commit();                    // Q, K_lo
  rows.template copy<kTile>(v_s, vb, sv.s, lo * kTile, S);
  cp_async_commit();                    // V_lo

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = lo; kt < hi; ++kt) {
    const int stage = (kt - lo) & 1;
    const float* kc = k_s + stage * kTile * LD;
    const float* vc = v_s + stage * kTile * LD;
    const bool next = kt + 1 < hi;
    cp_async_wait<1>();                 // K_kt (and Q); V_kt may fly
    if (kt == lo) rows.template scale<kTile>(q_s, scale);
    __syncthreads();                    // and tile kt - 1 is done
    if (next) {                         // K, V of kt + 1 over kt - 1's
      const int other = (stage ^ 1) * kTile * LD;
      rows.template copy<kTile>(k_s + other, kb, sk.s, (kt + 1) * kTile,
                                S);
      cp_async_commit();
      rows.template copy<kTile>(v_s + other, vb, sv.s, (kt + 1) * kTile,
                                S);
      cp_async_commit();
    }

    // S = Q_hat K^T: rows r0 + g (+ 8), keys c0 + 8 j + 2 t (+ 1)
    float s[kHalf / 8][4];
#pragma unroll
    for (int j = 0; j < kHalf / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NB; ++kk) {
      uint32_t ab[4], as[4];
      load_a<LD>(q_s, r0, kk * 8, lane, ab, as);
#pragma unroll
      for (int j = 0; j < kHalf / 8; ++j) {
        const float* kp = kc + (c0 + j * 8 + g) * LD + kk * 8 + t;
        mma3(s[j], ab, as, kp[0], kp[4]);
      }
    }

    // the online-softmax step of this warp's keys; the four lanes of a
    // quad share two rows
    const int k0 = kt * kTile;
    const bool edge = any_masked(q0, k0, S, causal, window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kHalf / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        if (edge && !visible(q0 + r0 + g + 8 * r,
                             k0 + c0 + 8 * j + 2 * t + (e & 1), S, causal,
                             window))
          s[j][e] = kNegInf;
        mx[r] = fmaxf(mx[r], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
    uint32_t pb[kHalf / 8][4], ps[kHalf / 8][4];  // P split, keys permuted
#pragma unroll
    for (int j = 0; j < kHalf / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e >> 1]);
        l[e >> 1] += s[j][e];
      }
      as_a(s[j], pb[j], ps[j]);
    }

    if (next)
      cp_async_wait<2>();               // V_kt; kt + 1 in flight
    else
      cp_async_wait<0>();
    __syncthreads();
    // acc = alpha acc + P V, this tile's P V summed apart (Accumulation)
    const float* vp = vc + (c0 + 2 * t) * LD + g;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      float pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kHalf / 8; ++j)
        mma3(pv, pb[j], ps[j], vp[j * 8 * LD + n * 8],
             vp[(j * 8 + 1) * LD + n * 8]);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n][e] = fmaf(acc[n][e], alpha[e >> 1], pv[e]);
    }
  }

  // merge the two halves of each row: the upper warps' (m, l, acc) through
  // shared memory (K and V are done, and no copy is in flight)
#pragma unroll
  for (int r = 0; r < 2; ++r) {         // the row's four lanes' shares
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  float* part = k_s;                    // (64, LD) acc, then 64 m, 64 l
  float* part_m = part + kTile * LD;
  __syncthreads();
  if (c0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + g + 8 * r;
#pragma unroll
      for (int n = 0; n < NB; ++n)
        *reinterpret_cast<float2*>(part + row * LD + n * 8 + 2 * t) =
            make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
      if (t == 0) {
        part_m[row] = m[r];
        part_m[kTile + row] = l[r];
      }
    }
  }
  __syncthreads();
  if (c0) return;
  float* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (q0 + row >= S) continue;
    const float m1 = part_m[row];
    const float mr = fmaxf(m[r], m1);
    const float a0 = expf(m[r] - mr), a1 = expf(m1 - mr);
    const float lr = fmaxf(l[r] * a0 + part_m[kTile + row] * a1, 1e-30f);
    float* orow = ob + static_cast<long long>(q0 + row) * so.s + 2 * t;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const float2 x =
          *reinterpret_cast<const float2*>(part + row * LD + n * 8 + 2 * t);
      *reinterpret_cast<float2*>(orow + n * 8) =
          make_float2((acc[n][2 * r] * a0 + x.x * a1) / lr,
                      (acc[n][2 * r + 1] * a0 + x.y * a1) / lr);
    }
    if (t == 0)
      lse[static_cast<long long>(bh) * S + q0 + row] = mr + logf(lr);
  }
}

// ------------------------------------------------------------------ dq
template <int D>
__global__ void __launch_bounds__(kBlock, 1)
flash_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    Strides sq, Strides sk, Strides sv, Strides sdo,
                    Strides sdq, int H, int KV, int S, float scale,
                    int causal, int window) {
  constexpr int LD = D + 4;
  constexpr int NB = D / 8;
  constexpr int kTileF = kTile * LD;
  extern __shared__ __align__(16) float smem[];
  const int n_k = (S + kTile - 1) / kTile;
  const int stages = n_k > 1 ? 2 : 1;
  float* q_s = smem;                    // (64, LD) q_hat
  float* do_s = q_s + kTileF;           // (64, LD) dO
  float* k_s = do_s + kTileF;           // stages x (64, LD)
  float* v_s = k_s + stages * kTileF;

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int kvh = h / (H / KV);
  const int q0 = (n_k - 1 - static_cast<int>(blockIdx.y)) * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp & 3) * 16;       // this warp's query rows
  const int c0 = (warp >> 2) * kHalf;   // and its half of each k-tile
  const float* kb = k + b * sk.b + kvh * sk.h;
  const float* vb = v + b * sv.b + kvh * sv.h;
  const RowCopy<D, kBlock> rows;

  // the k-tiles that the q-tile sees (flash_attention.py:111-119)
  int lo, hi;
  k_tiles(q0, S, causal, window, &lo, &hi);
  rows.template copy<kTile>(q_s, q + b * sq.b + h * sq.h, sq.s, q0, S);
  rows.template copy<kTile>(k_s, kb, sk.s, lo * kTile, S);
  cp_async_commit();                    // Q, K_lo
  rows.template copy<kTile>(do_s, dout + b * sdo.b + h * sdo.h, sdo.s, q0,
                            S);
  rows.template copy<kTile>(v_s, vb, sv.s, lo * kTile, S);
  cp_async_commit();                    // dO, V_lo

  // lse and delta of this thread's rows r0 + g and r0 + g + 8
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + 8 * r;
    const long long at = static_cast<long long>(bh) * S + row;
    row_lse[r] = row < S ? lse[at] : 0.f;
    row_delta[r] = row < S ? delta[at] : 0.f;
  }

  float acc[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = lo; kt < hi; ++kt) {
    const int stage = (kt - lo) & 1;
    const float* kc = k_s + stage * kTileF;
    const float* vc = v_s + stage * kTileF;
    const bool next = kt + 1 < hi;
    cp_async_wait<1>();                 // K_kt (and Q); V_kt may fly
    if (kt == lo) rows.template scale<kTile>(q_s, scale);
    __syncthreads();                    // and tile kt - 1 is done
    if (next) {                         // K, V of kt + 1 over kt - 1's
      const int other = (stage ^ 1) * kTileF;
      rows.template copy<kTile>(k_s + other, kb, sk.s, (kt + 1) * kTile,
                                S);
      cp_async_commit();
      rows.template copy<kTile>(v_s + other, vb, sv.s, (kt + 1) * kTile,
                                S);
      cp_async_commit();
    }

    // S = Q_hat K^T: rows r0 + g (+ 8), keys c0 + 8 j + 2 t (+ 1)
    float s[kHalf / 8][4], dp[kHalf / 8][4];
#pragma unroll
    for (int j = 0; j < kHalf / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NB; ++kk) {
      uint32_t ab[4], as[4];
      load_a<LD>(q_s, r0, kk * 8, lane, ab, as);
#pragma unroll
      for (int j = 0; j < kHalf / 8; ++j) {
        const float* kp = kc + (c0 + j * 8 + g) * LD + kk * 8 + t;
        mma3(s[j], ab, as, kp[0], kp[4]);
      }
    }
    if (next)
      cp_async_wait<2>();               // V_kt (and dO); kt + 1 in flight
    else
      cp_async_wait<0>();
    __syncthreads();
    // dP = dO V^T, the same fragments
#pragma unroll
    for (int kk = 0; kk < NB; ++kk) {
      uint32_t ab[4], as[4];
      load_a<LD>(do_s, r0, kk * 8, lane, ab, as);
#pragma unroll
      for (int j = 0; j < kHalf / 8; ++j) {
        const float* vp = vc + (c0 + j * 8 + g) * LD + kk * 8 + t;
        mma3(dp[j], ab, as, vp[0], vp[4]);
      }
    }

    // p = exp(s - lse), ds = p (dP - delta), split with the keys of each
    // 8-block permuted (as_a)
    const int k0 = kt * kTile;
    const bool edge = any_masked(q0, k0, S, causal, window);
    uint32_t ab[kHalf / 8][4], as[kHalf / 8][4];
#pragma unroll
    for (int j = 0; j < kHalf / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float x = s[j][e];
        if (edge && !visible(q0 + r0 + g + 8 * r,
                             k0 + c0 + 8 * j + 2 * t + (e & 1), S, causal,
                             window))
          x = kNegInf;
        dp[j][e] = expf(x - row_lse[r]) * (dp[j][e] - row_delta[r]);
      }
      as_a(dp[j], ab[j], as[j]);
    }
    // dq += ds K, this tile's product summed apart (Accumulation)
    const float* kp = kc + (c0 + 2 * t) * LD + g;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kHalf / 8; ++j)
        mma3(part, ab[j], as[j], kp[j * 8 * LD + n * 8],
             kp[(j * 8 + 1) * LD + n * 8]);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += part[e];
    }
  }

  // the two halves of each row's sum: the upper warps' through shared
  // memory (K and V are done, and no copy is in flight)
  float* part = k_s;                    // (64, LD)
  __syncthreads();
  if (c0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int at = (r0 + g + 8 * r) * LD + 2 * t;
#pragma unroll
      for (int n = 0; n < NB; ++n)
        *reinterpret_cast<float2*>(part + at + n * 8) =
            make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
    }
  }
  __syncthreads();
  if (c0) return;
  float* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (q0 + row >= S) continue;
    const int at = row * LD + 2 * t;
    float* out = dqb + static_cast<long long>(q0 + row) * sdq.s + 2 * t;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const float2 x = *reinterpret_cast<const float2*>(part + at + n * 8);
      *reinterpret_cast<float2*>(out + n * 8) =
          make_float2((acc[n][2 * r] + x.x) * scale,
                      (acc[n][2 * r + 1] + x.y) * scale);
    }
  }
}

// --------------------------------------------------------------- dk/dv
template <int D>
__global__ void __launch_bounds__(kBlock, 1)
flash_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, Strides sq, Strides sk,
                     Strides sv, Strides sdo, Strides sdk, Strides sdv, int H,
                     int KV, int S, float scale, int causal, int window) {
  constexpr int LD = D + 4;
  constexpr int NB = D / 8;
  constexpr int kTileF = kTile * LD;    // floats of a padded tile
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;
  float* v_s = k_s + kTileF;
  float* q_s = v_s + kTileF;            // two stages, q_hat
  float* do_s = q_s + 2 * kTileF;       // two stages
  float* rows_s = do_s + 2 * kTileF;    // two stages of lse, delta (64 each)

  const int G = H / KV;
  const int bkv = blockIdx.x, b = bkv / KV, kvh = bkv - b * KV;
  const int k0 = blockIdx.y * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp & 3) * 16;       // this warp's keys
  const int c0 = (warp >> 2) * kHalf;   // and its half of each q-tile
  const RowCopy<D, kBlock> rows;

  // the q-tiles that see this k-tile (flash_attention.py:148-159); item i
  // is query head kvh G + i / n, q-tile lo + i % n
  const int n_q = (S + kTile - 1) / kTile;
  const int lo = causal ? k0 / kTile : 0;
  const int hi =
      window > 0 ? min(n_q, (k0 + kTile - 1 + window - 1) / kTile + 1) : n_q;
  const int n = hi - lo, items = G * n;
  // item i's Q, lse and delta as one copy group, its dO as the next
  auto issue_q = [&](int i, int stage) {
    const int h = kvh * G + i / n, q0 = (lo + i % n) * kTile;
    const long long bh = static_cast<long long>(b) * H + h;
    rows.template copy<kTile>(q_s + stage * kTileF, q + b * sq.b + h * sq.h,
                              sq.s, q0, S);
    if (threadIdx.x < 2 * kTile)
      load_rows(smem_addr(rows_s + stage * 2 * kTile), lse + bh * S,
                delta + bh * S, q0, S);
    cp_async_commit();
  };
  auto issue_do = [&](int i, int stage) {
    const int h = kvh * G + i / n;
    rows.template copy<kTile>(do_s + stage * kTileF,
                              dout + b * sdo.b + h * sdo.h, sdo.s,
                              (lo + i % n) * kTile, S);
    cp_async_commit();
  };

  rows.template copy<kTile>(k_s, k + b * sk.b + kvh * sk.h, sk.s, k0, S);
  issue_q(0, 0);                        // K, Q_0, rows_0
  rows.template copy<kTile>(v_s, v + b * sv.b + kvh * sv.h, sv.s, k0, S);
  issue_do(0, 0);                       // V, dO_0

  float dk_acc[NB][4], dv_acc[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nb][e] = dv_acc[nb][e] = 0.f;

  for (int i = 0; i < items; ++i) {
    const int stage = i & 1;
    const int q0 = (lo + i % n) * kTile;
    float* qc = q_s + stage * kTileF;
    const float* doc = do_s + stage * kTileF;
    const float* lse_s = rows_s + stage * 2 * kTile;
    const float* dl_s = lse_s + kTile;
    const bool next = i + 1 < items;
    cp_async_wait<1>();                 // Q_i (and K); dO_i (and V) may fly
    rows.template scale<kTile>(qc, scale);
    __syncthreads();                    // and item i - 1 is done
    if (next) {
      issue_q(i + 1, stage ^ 1);
      issue_do(i + 1, stage ^ 1);
    }

    // S^T = K Q_hat^T: keys r0 + g (+ 8), queries c0 + 8 j + 2 t (+ 1)
    const bool edge = any_masked(q0, k0, S, causal, window);
    float s[kHalf / 8][4], dp[kHalf / 8][4];
#pragma unroll
    for (int j = 0; j < kHalf / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NB; ++kk) {
      uint32_t ab[4], as[4];
      load_a<LD>(k_s, r0, kk * 8, lane, ab, as);
#pragma unroll
      for (int j = 0; j < kHalf / 8; ++j) {
        const float* qp = qc + (c0 + j * 8 + g) * LD + kk * 8 + t;
        mma3(s[j], ab, as, qp[0], qp[4]);
      }
    }
#pragma unroll
    for (int j = 0; j < kHalf / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + 8 * j + 2 * t + (e & 1);
        float x = s[j][e];
        if (edge && !visible(q0 + col, k0 + r0 + g + 8 * (e >> 1), S, causal,
                             window))
          x = kNegInf;
        s[j][e] = expf(x - lse_s[col]);
      }
    if (next)
      cp_async_wait<2>();               // dO_i (and V); i + 1 in flight
    else
      cp_async_wait<0>();
    __syncthreads();
    // dP^T = V dO^T, then ds^T = p^T (dP^T - delta)
#pragma unroll
    for (int kk = 0; kk < NB; ++kk) {
      uint32_t ab[4], as[4];
      load_a<LD>(v_s, r0, kk * 8, lane, ab, as);
#pragma unroll
      for (int j = 0; j < kHalf / 8; ++j) {
        const float* dop = doc + (c0 + j * 8 + g) * LD + kk * 8 + t;
        mma3(dp[j], ab, as, dop[0], dop[4]);
      }
    }
#pragma unroll
    for (int j = 0; j < kHalf / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[j][e] = s[j][e] * (dp[j][e] - dl_s[c0 + 8 * j + 2 * t + (e & 1)]);
    // dv += p^T dO, then dk += ds^T Q_hat, the queries of each 8-block
    // permuted (as_a) and this item's products summed apart (Accumulation)
    const int row = (c0 + 2 * t) * LD + g;
    uint32_t ab[kHalf / 8][4], as[kHalf / 8][4];
#pragma unroll
    for (int j = 0; j < kHalf / 8; ++j) as_a(s[j], ab[j], as[j]);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kHalf / 8; ++j)
        mma3(part, ab[j], as[j], doc[row + j * 8 * LD + nb * 8],
             doc[row + (j * 8 + 1) * LD + nb * 8]);
#pragma unroll
      for (int e = 0; e < 4; ++e) dv_acc[nb][e] += part[e];
    }
#pragma unroll
    for (int j = 0; j < kHalf / 8; ++j) as_a(dp[j], ab[j], as[j]);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kHalf / 8; ++j)
        mma3(part, ab[j], as[j], qc[row + j * 8 * LD + nb * 8],
             qc[row + (j * 8 + 1) * LD + nb * 8]);
#pragma unroll
      for (int e = 0; e < 4; ++e) dk_acc[nb][e] += part[e];
    }
  }

  // the two halves of each key's sums: the upper warps' through shared
  // memory (Q and dO are done, and no copy is in flight)
  float* part_k = q_s;                  // (64, LD) dk, then (64, LD) dv
  float* part_v = q_s + kTileF;
  __syncthreads();
  if (c0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int at = (r0 + g + 8 * r) * LD + 2 * t;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        *reinterpret_cast<float2*>(part_k + at + nb * 8) =
            make_float2(dk_acc[nb][2 * r], dk_acc[nb][2 * r + 1]);
        *reinterpret_cast<float2*>(part_v + at + nb * 8) =
            make_float2(dv_acc[nb][2 * r], dv_acc[nb][2 * r + 1]);
      }
    }
  }
  __syncthreads();
  if (c0) return;
  float* dkb = dk + b * sdk.b + kvh * sdk.h;
  float* dvb = dv + b * sdv.b + kvh * sdv.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + r0 + g + 8 * r;
    if (key >= S) continue;
    const int at = (r0 + g + 8 * r) * LD + 2 * t;
    float* krow = dkb + static_cast<long long>(key) * sdk.s + 2 * t;
    float* vrow = dvb + static_cast<long long>(key) * sdv.s + 2 * t;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const float2 xk =
          *reinterpret_cast<const float2*>(part_k + at + nb * 8);
      const float2 xv =
          *reinterpret_cast<const float2*>(part_v + at + nb * 8);
      *reinterpret_cast<float2*>(krow + nb * 8) = make_float2(
          dk_acc[nb][2 * r] + xk.x, dk_acc[nb][2 * r + 1] + xk.y);
      *reinterpret_cast<float2*>(vrow + nb * 8) = make_float2(
          dv_acc[nb][2 * r] + xv.x, dv_acc[nb][2 * r + 1] + xv.y);
    }
  }
}

// ------------------------------------------------------------------ host
// dynamic shared memory, bytes: the forward's Q tile (dq's Q and dO tiles)
// and `stages` stages of K and V; dk/dv's K, V, two stages of Q and dO, two
// of lse and delta
constexpr size_t fwd_smem(int D, int stages) {
  return 4 * static_cast<size_t>(1 + 2 * stages) * kTile * (D + 4);
}
constexpr size_t dq_smem(int D, int stages) {
  return fwd_smem(D, stages) + 4 * static_cast<size_t>(kTile) * (D + 4);
}
constexpr size_t dkv_smem(int D) {
  return 4 * (6 * static_cast<size_t>(kTile) * (D + 4) + 4 * kTile);
}

template <int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                float* lse, const long long* st, int B, int H, int KV, int S,
                float scale, int causal, int window, cudaStream_t stream) {
  auto kernel = flash_fwd_f32_kernel<D>;
  static DeviceFlags smem_set;
  const cudaError_t attr = allow_smem(smem_set, kernel, fwd_smem(D, 2));
  if (attr != cudaSuccess) return attr;
  const dim3 grid(B * H, (S + kTile - 1) / kTile);
  kernel<<<grid, kBlock, fwd_smem(D, S > kTile ? 2 : 1), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, strides(st),
      strides(st + 3), strides(st + 6), strides(st + 9), H, KV, S, scale,
      causal, window);
  return cudaGetLastError();
}

template <int D>
cudaError_t dq(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq_out,
               const long long* st, int B, int H, int KV, int S, float scale,
               int causal, int window, cudaStream_t stream) {
  auto kernel = flash_dq_f32_kernel<D>;
  static DeviceFlags smem_set;
  const cudaError_t attr = allow_smem(smem_set, kernel, dq_smem(D, 2));
  if (attr != cudaSuccess) return attr;
  const dim3 grid(B * H, (S + kTile - 1) / kTile);
  kernel<<<grid, kBlock, dq_smem(D, S > kTile ? 2 : 1), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dq_out), strides(st), strides(st + 3),
      strides(st + 6), strides(st + 9), strides(st + 12), H, KV, S, scale,
      causal, window);
  return cudaGetLastError();
}

template <int D>
cudaError_t dkv(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dk, void* dv,
                const long long* st, int B, int H, int KV, int S, float scale,
                int causal, int window, cudaStream_t stream) {
  auto kernel = flash_dkv_f32_kernel<D>;
  static DeviceFlags smem_set;
  const cudaError_t attr = allow_smem(smem_set, kernel, dkv_smem(D));
  if (attr != cudaSuccess) return attr;
  const dim3 grid(B * KV, (S + kTile - 1) / kTile);
  kernel<<<grid, kBlock, dkv_smem(D), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dk), static_cast<float*>(dv), strides(st),
      strides(st + 3), strides(st + 6), strides(st + 9), strides(st + 12),
      strides(st + 15), H, KV, S, scale, causal, window);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// strides: (b, h, s) element strides of q, k, v, o.  window <= 0 means
// none.  Returns the cudaError_t of the launch.
int flash_fwd_f32_sm90_launch(const void* q, const void* k, const void* v,
                              void* o, void* lse, const long long* strides,
                              int B, int H, int KV, int S, int d, float scale,
                              int causal, int window, void* stream) {
  SM90_HEAD_DIMS(fwd, q, k, v, o, static_cast<float*>(lse), strides, B, H,
                 KV, S, scale, causal, window,
                 static_cast<cudaStream_t>(stream))
}

// strides of q, k, v, do, dq; dq f32 in q's strides
int flash_dq_f32_sm90_launch(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dq_out,
                             const long long* strides, int B, int H, int KV,
                             int S, int d, float scale, int causal,
                             int window, void* stream) {
  SM90_HEAD_DIMS(dq, q, k, v, dout, static_cast<const float*>(lse),
                 static_cast<const float*>(delta), dq_out, strides, B, H,
                 KV, S, scale, causal, window,
                 static_cast<cudaStream_t>(stream))
}

// strides of q, k, v, do, dk, dv; dk and dv f32 in k's and v's strides
int flash_dkv_f32_sm90_launch(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dk, void* dv,
                              const long long* strides, int B, int H, int KV,
                              int S, int d, float scale, int causal,
                              int window, void* stream) {
  SM90_HEAD_DIMS(dkv, q, k, v, dout, static_cast<const float*>(lse),
                 static_cast<const float*>(delta), dk, dv, strides, B, H, KV,
                 S, scale, causal, window, static_cast<cudaStream_t>(stream))
}

// bytes of dynamic shared memory a block of the forward (kind 0, two
// stages), dk/dv (kind 1) or dq (kind 2, two stages) kernel takes at head
// dim d
int flash_f32_sm90_smem(int kind, int d) {
  return static_cast<int>(kind == 2 ? dq_smem(d, 2)
                          : kind    ? dkv_smem(d)
                                    : fwd_smem(d, 2));
}

const char* flash_f32_sm90_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
