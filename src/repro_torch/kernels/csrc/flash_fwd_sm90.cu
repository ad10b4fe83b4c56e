// Flash attention forward on Hopper's tensor cores (sm_90a), for bf16 q, k
// and v.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_fwd_kernel
// on the bf16 path (the model's training dtype): blocked online softmax
// over the k-tiles a q-tile sees, o = acc / max(l, 1e-30) in q's dtype and
// lse = m + log(max(l, 1e-30)) in f32.  f32 inputs run the forward of
// flash_f32_sm90.cu, whose three TF32 products a product hold the host to
// 1e-4, which one would not.  d = 16 and 32 run here too, zero-padded to 64
// columns in shared memory (the padding adds zeros to q.k, and its o
// columns are never stored).
//
// Layout and masks: q, o (B, H, S, d) and k, v
// (B, KV, S, d) with any strides whose rows start on 16 bytes (the wrapper
// checks), lse (B * H, S) f32; causal kpos <= qpos, window w
// kpos > qpos - w; the reference's lo/hi tile bounds; S need not be a
// multiple of 64 (rows and columns past S are zero-filled, masked and
// never stored).
//
// Arithmetic.  q enters the product unscaled, exactly as bf16:
// s = scale (q . k) in f32 with scale = f32(d**-0.5), as the backward
// computes it.  The online softmax is the reference's (running max m, sum
// l, rescale alpha = e^(m_old - m_new)), every value f32, the exponentials
// as exp2 of (s - m) log2(e).  p is f32 in [0, 1] and enters acc += P V as
// two bf16 terms, hi = bf16(p) and lo = bf16(p - hi), into one f32
// accumulator: a single bf16 rounding of p (FlashAttention-2's and -3's
// choice) adds up to 2**-9 of each term where v's signs cancel, and
// tests/test_torch_flash.py's emulation shows it breaks the one-step gate
// on o (2**-7 |o| + 1e-4) that the two terms hold.  A row whose keys so far
// are all masked keeps m = -1e30 and takes p = 0, not the reference's
// exp(0) = 1: the reference's next tile clears those with alpha = 0, so
// every stored row gets the same values.  o is cast once.
//
// Design.  One warpgroup (128 threads) a block and one block per (b h,
// 64-row q-tile), the longest causal q-tiles first.  Q stays in shared
// memory; K and V stream through two-stage rings filled by 16-byte
// cp.async, in the 128-byte swizzle of sm90.cuh, each thread's copies
// worked out once (TileCopy).  S = Q K^T is a wgmma
// m64n64k16 with both operands in shared memory; p, split, is the register
// A operand of acc += P V (V n-major, m64nDk16).  The forward has only two
// products a tile, so the exponentials are a large share of its time; the
// loop is software-pipelined inside the warpgroup to run them beside the
// tensor cores:
//
//   tile j:  issue S_j = Q K_j^T, then acc += P_{j-1} V_{j-1}; issue the
//            copies of K_{j+1} and V_j; wait for S_j alone; the softmax of
//            S_j (m, l, alpha_j, P_j) while P_{j-1} V_{j-1} runs; wait for
//            it; acc *= alpha_j.
//
// So K_{j+1}'s stage was last read by S_{j-1} and V_j's by
// P_{j-2} V_{j-2}, both waited for before the barrier that opens tile j.
//
// Bound.  4 d flops a visible (query, key) pair (6 d as issued with the
// split) make S = 2048 compute-bound against the tensor cores' 989
// TFLOP/s; at the round's S = 64 it reads a few MB on 64 blocks, and
// latency rules.  Shared memory: five tiles of 64 x max(d, 64) bf16, 81 KB
// at d = 128, so two blocks share an SM.  Tried and measured slower on an
// H100: two warpgroups on a 128-row q-tile sharing each K/V tile through a
// three-stage ring (half the K/V traffic from L2, but one 256-thread block
// an SM at 226 registers).
#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr float kLog2e = 1.4426950408889634f;

// Copies that stay where they are written.  ptxas serializes every wgmma
// of a kernel (its warning C7513) if any register that some wgmma reads is
// written while a product is in flight; left to itself the compiler gives
// the softmax's outputs the registers that the last tile's P V reads.  So
// a finished product's accumulator is copied out after its wait, and the
// new p, built in other registers, is copied into the operand registers
// only after the last wait of the tile.
template <int N>
__device__ __forceinline__ void take(const float (&from)[N], float (&to)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    asm volatile("mov.f32 %0, %1;" : "=f"(to[i]) : "f"(from[i]));
}
template <int N>
__device__ __forceinline__ void take(const uint32_t (&from)[N],
                                     uint32_t (&to)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    asm volatile("mov.b32 %0, %1;" : "=r"(to[i]) : "r"(from[i]));
}

// The online-softmax step of one 64 x 64 score tile s (raw q . k, the
// accumulator layout of sm90.cuh): masks, scales, updates the running max
// m and this thread's share of the sum l of its two rows, returns alpha of
// each row and p split into two bf16 terms as a register A operand.
template <bool kEdge>
__device__ __forceinline__ void softmax_step(
    float (&s)[32], float (&m)[2], float (&l)[2], float (&alpha)[2],
    uint32_t (&p_hi)[16], uint32_t (&p_lo)[16], const int (&rows)[2], int q0,
    int k0, int lane, int S, int causal, int window, float scale) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    float x = s[i] * scale;
    if (kEdge) {
      const int c = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      if (!visible(q0 + rows[r], k0 + c, S, causal, window)) x = kNegInf;
    }
    s[i] = x;
    mx[r] = fmaxf(mx[r], x);
  }
  float ml[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {         // the four lanes of a row agree
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = exp2f((m[r] - mx[r]) * kLog2e);
    m[r] = mx[r];
    // all masked so far: p = exp2(-1e30 log2 e) = 0 for every key
    ml[r] = mx[r] == kNegInf ? 0.f : mx[r] * kLog2e;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int r = (i >> 1) & 1;
    const float p0 = exp2f(fmaf(s[i], kLog2e, -ml[r]));
    const float p1 = exp2f(fmaf(s[i + 1], kLog2e, -ml[r]));
    l[r] += p0 + p1;
    split(p0, p1, p_hi[i >> 1], p_lo[i >> 1]);
  }
}

// acc += P V: p as two bf16 terms, V n-major (16 keys a k-step)
template <int N>
__device__ __forceinline__ void issue_pv(float (&acc)[N],
                                         const uint32_t (&p_hi)[16],
                                         const uint32_t (&p_lo)[16],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) mma_rs(acc, p_hi + 4 * kk, n_major(v_tile, kk));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) mma_rs(acc, p_lo + 4 * kk, n_major(v_tile, kk));
}

// The copies of one thread into a tile, worked out once.  With 128 threads
// and 8 or 16 chunks a row, a thread always copies the same column chunk,
// of rows row0, row0 + kStep, ..., and row0 + j kStep keeps row0's swizzle,
// so a 16-byte copy costs a compare, a select and an add (sm90.cuh's
// load_tile works out row, column and swizzle for every chunk, integer
// work that rivals the softmax of a tile).
template <int D, int DP>
struct TileCopy {
  static constexpr int kChunks = DP / 8;            // 16-byte chunks a row
  static constexpr int kStep = kThreads / kChunks;  // rows a pass covers
  static_assert(kStep % 8 == 0, "a pass must keep the swizzle");
  int row0, col;
  bool col_ok;
  uint32_t dst0;
  __device__ __forceinline__ TileCopy() {
    const int c = threadIdx.x % kChunks;
    row0 = threadIdx.x / kChunks;
    col = c * 8;
    col_ok = c < D / 8;
    dst0 = (c >> 3) * kAtom + row0 * 128 + (((c & 7) ^ (row0 & 7)) << 4);
  }
  // rows r0 .. r0 + 63 of src into tile; rows past S, columns past D zero
  __device__ __forceinline__ void operator()(uint32_t tile, const bf16* src,
                                             long long row_stride, int r0,
                                             int S) const {
    const bf16* from = src + static_cast<long long>(r0 + row0) * row_stride +
                       col;
    const long long step = kStep * row_stride;
#pragma unroll
    for (int j = 0; j < kTile / kStep; ++j) {
      const bool ok = col_ok && r0 + row0 + j * kStep < S;
      cp_async16(tile + dst0 + j * kStep * 128, ok ? from + j * step : src,
                 ok);
    }
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_sm90_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, Strides sq, Strides sk,
                      Strides sv, Strides so, int H, int KV, int S,
                      float scale, int causal, int window) {
  constexpr int DP = D < 64 ? 64 : D;   // columns of a tile in shared memory
  constexpr int kTileBytes = kTile * DP * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = base + kTileBytes;            // two stages
  const uint32_t v_s = base + 3 * kTileBytes;        // two stages

  const int n_q = (S + kTile - 1) / kTile;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int kvh = h / (H / KV);
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.y)) * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* kb = k + b * sk.b + kvh * sk.h;
  const bf16* vb = v + b * sv.b + kvh * sv.h;
  const TileCopy<D, DP> copy_tile;

  int lo, hi;
  k_tiles(q0, S, causal, window, &lo, &hi);
  copy_tile(q_s, q + b * sq.b + h * sq.h, sq.s, q0, S);
  copy_tile(k_s, kb, sk.s, lo * kTile, S);
  cp_async_commit();                    // Q, K_lo
  if (lo + 1 < hi) copy_tile(k_s + kTileBytes, kb, sk.s,
                                    (lo + 1) * kTile, S);
  copy_tile(v_s, vb, sv.s, lo * kTile, S);
  cp_async_commit();                    // K_lo+1, V_lo

  // this thread's accumulator rows: rows[0] and rows[0] + 8 of the tile
  const int rows[2] = {warp * 16 + (lane >> 2), warp * 16 + (lane >> 2) + 8};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  uint32_t p_hi[16], p_lo[16];          // P of the last tile, not yet in acc

  // tile lo: S and its softmax alone
  cp_async_wait<1>();
  fence_async_shared();
  __syncthreads();
  {
    float s[32];
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      mma_ss(s, k_major(q_s, kk), k_major(k_s, kk), kk);
    mma_commit();
    mma_wait();
    float x[32];
    take(s, x);
    const int k0 = lo * kTile;
    if (any_masked(q0, k0, S, causal, window))
      softmax_step<true>(x, m, l, alpha, p_hi, p_lo, rows, q0, k0, lane, S,
                         causal, window, scale);
    else
      softmax_step<false>(x, m, l, alpha, p_hi, p_lo, rows, q0, k0, lane, S,
                          causal, window, scale);
  }

  for (int kt = lo + 1; kt < hi; ++kt) {
    const int stage = (kt - lo) & 1;
    cp_async_wait<0>();                 // K_kt and V_kt-1
    fence_async_shared();
    __syncthreads();
    const uint32_t kc = k_s + stage * kTileBytes;
    const uint32_t vp = v_s + (stage ^ 1) * kTileBytes;

    float s[32];
    hold(acc);
    hold(p_hi);
    hold(p_lo);
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      mma_ss(s, k_major(q_s, kk), k_major(kc, kk), kk);
    mma_commit();
    issue_pv(acc, p_hi, p_lo, vp);
    mma_commit();

    // K_kt+1 over K_kt-1, V_kt over V_kt-2
    if (kt + 1 < hi)
      copy_tile(k_s + (stage ^ 1) * kTileBytes, kb, sk.s,
                       (kt + 1) * kTile, S);
    copy_tile(v_s + stage * kTileBytes, vb, sv.s, kt * kTile, S);
    cp_async_commit();

    mma_wait<1>();                      // S_kt; P V still in flight
    float x[32];
    take(s, x);
    uint32_t n_hi[16], n_lo[16];
    const int k0 = kt * kTile;
    if (any_masked(q0, k0, S, causal, window))
      softmax_step<true>(x, m, l, alpha, n_hi, n_lo, rows, q0, k0, lane, S,
                         causal, window, scale);
    else
      softmax_step<false>(x, m, l, alpha, n_hi, n_lo, rows, q0, k0, lane, S,
                          causal, window, scale);
    mma_wait<0>();
    hold(acc);
    hold(p_hi);
    hold(p_lo);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    take(n_hi, p_hi);
    take(n_lo, p_lo);
  }

  // the last tile's P V
  cp_async_wait<0>();
  fence_async_shared();
  __syncthreads();
  hold(acc);
  hold(p_hi);
  hold(p_lo);
  mma_fence();
  issue_pv(acc, p_hi, p_lo, v_s + ((hi - 1 - lo) & 1) * kTileBytes);
  mma_commit();
  mma_wait();
  hold(acc);

  float l_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {         // the row's four lanes' shares
    l_row[r] = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 2);
    l_row[r] = fmaxf(l_row[r], 1e-30f);
  }
  bf16* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < DP / 2; i += 2) {
    const int r = (i >> 1) & 1;
    const int row = q0 + rows[r];
    const int c = 8 * (i >> 2) + 2 * (lane & 3);
    if (row < S && c < D)
      *reinterpret_cast<__nv_bfloat162*>(
          ob + static_cast<long long>(row) * so.s + c) =
          __floats2bfloat162_rn(acc[i] / l_row[r], acc[i + 1] / l_row[r]);
  }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + rows[r];
      if (row < S)
        lse[static_cast<long long>(bh) * S + row] = m[r] + logf(l_row[r]);
    }
  }
}

// ------------------------------------------------------------------ host
// dynamic shared memory: five (64, max(d, 64)) bf16 tiles (Q, two stages
// each of K and V) and 1 KB to align the swizzle atoms
constexpr size_t fwd_smem(int D) {
  return 5 * kTile * (D < 64 ? 64 : D) * 2 + 1024;
}

template <int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                float* lse, const long long* st, int B, int H, int KV, int S,
                float scale, int causal, int window, cudaStream_t stream) {
  auto kernel = flash_fwd_sm90_kernel<D>;
  static DeviceFlags smem_set;
  const cudaError_t attr = allow_smem(smem_set, kernel, fwd_smem(D));
  if (attr != cudaSuccess) return attr;
  const dim3 grid(B * H, (S + kTile - 1) / kTile);
  kernel<<<grid, kThreads, fwd_smem(D), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, strides(st),
      strides(st + 3), strides(st + 6), strides(st + 9), H, KV, S, scale,
      causal, window);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// strides: (b, h, s) element strides of q, k, v, o.  window <= 0 means
// none.  Returns the cudaError_t of the launch.
int flash_fwd_sm90_launch(const void* q, const void* k, const void* v,
                          void* o, void* lse, const long long* strides, int B,
                          int H, int KV, int S, int d, float scale, int causal,
                          int window, void* stream) {
  SM90_HEAD_DIMS(fwd, q, k, v, o, static_cast<float*>(lse), strides, B, H, KV,
                 S, scale, causal, window, static_cast<cudaStream_t>(stream))
}

// bytes of dynamic shared memory a block takes at head dim d
int flash_fwd_sm90_smem(int d) { return static_cast<int>(fwd_smem(d)); }

const char* flash_fwd_sm90_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
