// Attention backward on Hopper (sm_90a): dQ, dK and dV of the causal,
// sliding-window or bidirectional GQA attention that flash_attention.cu
// computes forward, bfloat16 or float32 in and out.
//
// Port-only: the TPU reference has no backward kernel.  Its custom_vjp
// (_fa_bwd, src/repro/kernels/ops.py:51) recomputes the forward through
// ref.attention_ref and differentiates that, over a materialised (B, H, S,
// S) float32 score tensor.  This kernel computes the same gradient from the
// forward's output o and its per-row logsumexp lse (written by
// flash_attention_lse_launch), as the plain twin
// ref.flash_attention_bwd_ref spells it out:
//   P = exp(S scale - lse), delta = rowsum(dO o O), dV = sum_group P^T dO,
//   dP = dO V^T, dS = P o (dP - delta), dQ = scale dS K,
//   dK = scale sum_group dS^T Q.
//
// Bound on the H100: operations, 10*D per unmasked (q, k) pair (S, dP, dV,
// dQ and dK, a multiply and an add each): 0.348 ms for one Llama-3-8B
// training launch (B=1, H=32 over 8 kv heads, S=4096, D=128, causal) at the
// 989 TFLOP/s bf16 tensor-core peak.  The bytes (q, k, v, o, dO read once,
// dq, dk, dv written once) are far below.
//
// Design: three launches on the caller's stream, no atomics, every sum in a
// fixed order, so two calls on the same inputs give the same bits.
//   1. bwd_delta: delta = rowsum(dO o O), float32 (B, H, S), a warp a row.
//   2. dK, dV (kDQ false): a block per (64-key tile, batch and kv head).
//      k and v stay in shared memory; the block walks the q heads of its
//      group, and for each the 64-row q tiles that see some of its keys
//      (fully masked tiles are skipped, as the forward skips them), loads q,
//      dO, lse and delta, rebuilds S, P, dP and dS for the 64 x 64 tile and
//      accumulates dV += P^T dO and dK += dS^T Q in registers.
//   3. dQ (kDQ true): a block per (64-row q tile, batch and q head), the
//      longest tiles first; q, dO, lse and delta stay, the block walks the
//      kv tiles its rows see, rebuilds the same tile and accumulates
//      dQ += dS K.
// S and dP are recomputed in both (14*D operations a pair in all, 1.4x
// the bound's count) so that dQ needs no sum across blocks.
//
// bfloat16 runs on the tensor cores through mma.sync m16n8k16 (bf16 in,
// float32 accumulate): 8 warps, tiles staged in shared memory by cp.async
// with rows padded by 16 bytes so that ldmatrix reads are free of bank
// conflicts.  Warp w computes rows 16 (w % 4).. and keys 32 (w / 4).. of the
// 64 x 64 tile (S and dP, 32 float registers), writes P and dS as bf16 into
// shared memory, and owns rows 16 (w % 4).. and columns (w / 4) D/2.. of
// the accumulators (dK and dV: D/2 registers a thread, 128 at D = 256, the
// largest that fits beside the tile).  Rounding P and dS to bf16 for the
// second products is where the bf16 error comes from.  float32 stays on
// the CUDA cores (TF32 would break float32's bars): 32 x 32 tiles, a 2 x 2
// micro-tile of S and dP a thread, float4 reads of rows padded by 16
// bytes.  Rows past S are loaded as zeros and masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16 bytes global -> shared, zero-filled where src_bytes is 0
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// rows row0 .. row0 + ROWS - 1 of a (S, D) matrix into a shared tile with
// row stride ld elements; rows past S read as zeros
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src,
                                          int row0, int S) {
  constexpr int kPer = 16 / sizeof(T);
  constexpr int kChunks = D / kPer;
  for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    const int row = row0 + r;
    const T* g = src + static_cast<size_t>(row < S ? row : 0) * D + c * kPer;
    cp_async16(smem_u32(dst + r * ld + c * kPer), g, row < S ? 16 : 0);
  }
}

// lse (times lse_mul) and delta of rows row0 .. row0 + ROWS - 1; 0 past S
template <int ROWS>
__device__ __forceinline__ void load_row_stats(float* s_lse, float* s_delta,
                                               const float* lse,
                                               const float* delta, int row0,
                                               int S, float lse_mul) {
  for (int r = threadIdx.x; r < ROWS; r += kThreads) {
    const bool in = row0 + r < S;
    s_lse[r] = in ? lse[row0 + r] * lse_mul : 0.f;
    s_delta[r] = in ? delta[row0 + r] : 0.f;
  }
}

__device__ __forceinline__ bool visible(int q, int k, int S, int causal,
                                        int window) {
  return q < S && k < S && (!causal || q >= k) &&
         (window <= 0 || q - k < window);
}

// (q tile [q0, q0 + BQ)) x (key tile [k0, k0 + BK)) lies inside S and every
// pair is visible
__device__ __forceinline__ bool whole_tile(int q0, int BQ, int k0, int BK,
                                           int S, int causal, int window) {
  return q0 + BQ <= S && k0 + BK <= S && (!causal || k0 + BK - 1 <= q0) &&
         (window <= 0 || q0 + BQ - 1 - k0 < window);
}

// key tiles of size BK that rows [q0, q0 + BQ) see: [t_lo, t_hi)
__device__ __forceinline__ void key_tiles(int q0, int BQ, int BK, int S,
                                          int causal, int window, int& t_lo,
                                          int& t_hi) {
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(q0 + BQ, S) : S;
  t_lo = k_lo / BK;
  t_hi = (k_hi + BK - 1) / BK;
}

// q tiles of size BQ whose rows see some key of [k0, k0 + BK): [t_lo, t_hi)
__device__ __forceinline__ void query_tiles(int k0, int BK, int BQ, int S,
                                            int causal, int window, int& t_lo,
                                            int& t_hi) {
  const int q_lo = causal ? k0 : 0;
  const int k_last = min(k0 + BK, S) - 1;
  const int q_hi = window > 0 ? min(S, k_last + window) : S;
  t_lo = q_lo / BQ;
  t_hi = (q_hi + BQ - 1) / BQ;
}

// ---------------------------------------------------------------------------
// delta = rowsum(dO o O)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
    bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
              float* __restrict__ delta, int rows, int D) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* a = o + static_cast<size_t>(row) * D;
  const T* b = dout + static_cast<size_t>(row) * D;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc += to_f32(a[c]) * to_f32(b[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// ---------------------------------------------------------------------------
// bfloat16: mma.sync m16n8k16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kB = 64;        // rows of a q tile and of a key tile
constexpr int kLdP = kB + 8;  // padded row stride of the P and dS tiles

template <int D>
struct Bf16Layout {
  static constexpr int kLd = D + 8;  // padded row stride of the D-wide tiles
  static constexpr int kTile = kB * kLd;  // elements of one D-wide tile
  static constexpr int kPTile = kB * kLdP;
  static constexpr size_t kBytes =
      2 * (4 * static_cast<size_t>(kTile) + 2 * kPTile) + 2 * kB * 4;
};

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16 x 8 f32) += a (16 x 16 bf16, row) . b (16 x 8 bf16, col)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment addresses for ldmatrix.x4 in a row-major shared tile of row
// stride ld (elements), lane l.  A (16 x 16) at rows m0.., columns k0..:
__device__ __forceinline__ uint32_t a_addr(const __nv_bfloat16* t, int ld,
                                           int m0, int k0, int lane) {
  return smem_u32(t + (m0 + lane % 8 + 8 * ((lane / 8) % 2)) * ld + k0 +
                  8 * (lane / 16));
}
// A (16 x 16) whose transpose is stored: rows k0.. are A's columns, columns
// m0.. its rows (ldmatrix.trans)
__device__ __forceinline__ uint32_t at_addr(const __nv_bfloat16* t, int ld,
                                            int m0, int k0, int lane) {
  return smem_u32(t + (k0 + lane % 8 + 8 * (lane / 16)) * ld + m0 +
                  8 * ((lane / 8) % 2));
}
// B (16 x 16: two 8-column n tiles) stored n-major, rows n0.., columns
// k0.. (B^T row-major): registers {b0, b1} of n tile n0, then of n0 + 8
__device__ __forceinline__ uint32_t bn_addr(const __nv_bfloat16* t, int ld,
                                            int n0, int k0, int lane) {
  return smem_u32(t + (n0 + lane % 8 + 8 * (lane / 16)) * ld + k0 +
                  8 * ((lane / 8) % 2));
}
// B (16 x 16) stored k-major, rows k0.., columns n0.. (ldmatrix.trans)
__device__ __forceinline__ uint32_t bk_addr(const __nv_bfloat16* t, int ld,
                                            int n0, int k0, int lane) {
  return smem_u32(t + (k0 + lane % 8 + 8 * ((lane / 8) % 2)) * ld + n0 +
                  8 * (lane / 16));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One 64 x 64 (q, key) tile: S = Q K^T and dP = dO V^T by warp w's 16 rows
// x 32 keys, then P = exp2(S scale log2e - lse log2e) (0 where masked) and
// dS = P (dP - delta), both written to shared memory as bf16 [q][key].
template <int D>
__device__ __forceinline__ void bf16_tile(
    const __nv_bfloat16* sQ, const __nv_bfloat16* sdO,
    const __nv_bfloat16* sK, const __nv_bfloat16* sV, __nv_bfloat16* sP,
    __nv_bfloat16* sdS, const float* sLse, const float* sDelta, int q0,
    int k0, int S, int causal, int window, float scale_log2) {
  constexpr int LD = Bf16Layout<D>::kLd;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qm = 16 * (warp % 4), kn = 32 * (warp / 4);
  float s[4][4], dp[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < D; kk += 16) {
    uint32_t a[4], ad[4], b[4];
    ldsm_x4(a_addr(sQ, LD, qm, kk, lane), a);
    ldsm_x4(a_addr(sdO, LD, qm, kk, lane), ad);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      ldsm_x4(bn_addr(sK, LD, kn + 16 * p, kk, lane), b);
      mma(s[2 * p], a, b[0], b[1]);
      mma(s[2 * p + 1], a, b[2], b[3]);
      ldsm_x4(bn_addr(sV, LD, kn + 16 * p, kk, lane), b);
      mma(dp[2 * p], ad, b[0], b[1]);
      mma(dp[2 * p + 1], ad, b[2], b[3]);
    }
  }
  const bool whole = whole_tile(q0, kB, k0, kB, S, causal, window);
  const int gid = lane / 4, tig = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // rows gid and gid + 8
    const int ql = qm + gid + 8 * h;
    const float lse2 = sLse[ql], dl = sDelta[ql];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kl = kn + 8 * j + 2 * tig;
      float p[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok =
            whole || visible(q0 + ql, k0 + kl + e, S, causal, window);
        p[e] = ok ? fast_exp2(fmaf(s[j][2 * h + e], scale_log2, -lse2)) : 0.f;
        ds[e] = p[e] * (dp[j][2 * h + e] - dl);
      }
      *reinterpret_cast<uint32_t*>(sP + ql * kLdP + kl) = pack_bf16(p[0], p[1]);
      *reinterpret_cast<uint32_t*>(sdS + ql * kLdP + kl) =
          pack_bf16(ds[0], ds[1]);
    }
  }
}

// rows m0 + gid (+ 8) and columns n0 + 8 j + 2 tig (+ 1) of acc, times mul,
// into a (S, D) bf16 matrix at row0; rows past S are not written
template <int D, int NT>
__device__ __forceinline__ void store_bf16(__nv_bfloat16* out,
                                           const float (&acc)[NT][4],
                                           int row0, int n0, int S,
                                           float mul) {
  const int lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + gid + 8 * h;
    if (row >= S) continue;
    __nv_bfloat16* r = out + static_cast<size_t>(row) * D + n0 + 2 * tig;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      *reinterpret_cast<uint32_t*>(r + 8 * j) =
          pack_bf16(acc[j][2 * h] * mul, acc[j][2 * h + 1] * mul);
  }
}

template <int D, bool kDQ>
__global__ void __launch_bounds__(kThreads, D <= 128 ? 2 : 1)
    flash_bwd_bf16(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dq,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, int H, int Hkv, int S,
                   int causal, int window, float scale) {
  using L = Bf16Layout<D>;
  constexpr int LD = L::kLd;
  constexpr int NT = D / 16;  // 8-column n tiles of a warp's D/2 columns
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sdO = sQ + L::kTile;
  __nv_bfloat16* sK = sdO + L::kTile;
  __nv_bfloat16* sV = sK + L::kTile;
  __nv_bfloat16* sP = sV + L::kTile;
  __nv_bfloat16* sdS = sP + L::kPTile;
  float* sLse = reinterpret_cast<float*>(sdS + L::kPTile);
  float* sDelta = sLse + kB;

  const float scale_log2 = scale * kLog2e;
  const int G = H / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = 16 * (warp % 4), n0 = (warp / 4) * (D / 2);

  if constexpr (kDQ) {
    // a q tile of one q head; walk the key tiles it sees
    const int bh = blockIdx.y, b = bh / H;
    const int kvh = b * Hkv + (bh % H) / G;
    const int q0 = (gridDim.x - 1 - blockIdx.x) * kB;  // longest first
    const size_t qoff = static_cast<size_t>(bh) * S * D;
    const size_t koff = static_cast<size_t>(kvh) * S * D;
    load_rows<__nv_bfloat16, D, kB>(sQ, LD, q + qoff, q0, S);
    load_rows<__nv_bfloat16, D, kB>(sdO, LD, dout + qoff, q0, S);
    load_row_stats<kB>(sLse, sDelta, lse + static_cast<size_t>(bh) * S,
                       delta + static_cast<size_t>(bh) * S, q0, S, kLog2e);
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    int t_lo, t_hi;
    key_tiles(q0, kB, kB, S, causal, window, t_lo, t_hi);
    for (int t = t_lo; t < t_hi; ++t) {
      const int k0 = t * kB;
      __syncthreads();  // the last tile's readers are done with sK, sV, sdS
      load_rows<__nv_bfloat16, D, kB>(sK, LD, k + koff, k0, S);
      load_rows<__nv_bfloat16, D, kB>(sV, LD, v + koff, k0, S);
      cp_async_wait_all();
      __syncthreads();
      bf16_tile<D>(sQ, sdO, sK, sV, sP, sdS, sLse, sDelta, q0, k0, S,
                   causal, window, scale_log2);
      __syncthreads();
      // dQ += dS (64 q x 64 keys) . K (64 keys x D)
#pragma unroll
      for (int kk = 0; kk < kB; kk += 16) {
        uint32_t a[4], bb[4];
        ldsm_x4(a_addr(sdS, kLdP, m0, kk, lane), a);
#pragma unroll
        for (int p = 0; p < NT / 2; ++p) {
          ldsm_x4_t(bk_addr(sK, LD, n0 + 16 * p, kk, lane), bb);
          mma(acc[2 * p], a, bb[0], bb[1]);
          mma(acc[2 * p + 1], a, bb[2], bb[3]);
        }
      }
    }
    store_bf16<D>(dq + qoff, acc, q0 + m0, n0, S, scale);
  } else {
    // a key tile of one kv head; walk its group's q heads and the q tiles
    // that see it, in a fixed order
    const int bkv = blockIdx.y, b = bkv / Hkv;
    const int k0 = blockIdx.x * kB;  // low keys (most q tiles) first
    const size_t koff = static_cast<size_t>(bkv) * S * D;
    load_rows<__nv_bfloat16, D, kB>(sK, LD, k + koff, k0, S);
    load_rows<__nv_bfloat16, D, kB>(sV, LD, v + koff, k0, S);
    float ak[NT][4], av[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ak[j][e] = av[j][e] = 0.f;
    int t_lo, t_hi;
    query_tiles(k0, kB, kB, S, causal, window, t_lo, t_hi);
    for (int hq = 0; hq < G; ++hq) {
      const int bh = b * H + (bkv % Hkv) * G + hq;
      const size_t qoff = static_cast<size_t>(bh) * S * D;
      for (int t = t_lo; t < t_hi; ++t) {
        const int q0 = t * kB;
        __syncthreads();  // the last tile's readers are done
        load_rows<__nv_bfloat16, D, kB>(sQ, LD, q + qoff, q0, S);
        load_rows<__nv_bfloat16, D, kB>(sdO, LD, dout + qoff, q0, S);
        load_row_stats<kB>(sLse, sDelta, lse + static_cast<size_t>(bh) * S,
                           delta + static_cast<size_t>(bh) * S, q0, S,
                           kLog2e);
        cp_async_wait_all();
        __syncthreads();
        bf16_tile<D>(sQ, sdO, sK, sV, sP, sdS, sLse, sDelta, q0, k0, S,
                     causal, window, scale_log2);
        __syncthreads();
        // dV += P^T . dO and dK += dS^T . Q over the tile's 64 q rows
#pragma unroll
        for (int kk = 0; kk < kB; kk += 16) {
          uint32_t ap[4], as[4], bb[4];
          ldsm_x4_t(at_addr(sP, kLdP, m0, kk, lane), ap);
          ldsm_x4_t(at_addr(sdS, kLdP, m0, kk, lane), as);
#pragma unroll
          for (int p = 0; p < NT / 2; ++p) {
            ldsm_x4_t(bk_addr(sdO, LD, n0 + 16 * p, kk, lane), bb);
            mma(av[2 * p], ap, bb[0], bb[1]);
            mma(av[2 * p + 1], ap, bb[2], bb[3]);
            ldsm_x4_t(bk_addr(sQ, LD, n0 + 16 * p, kk, lane), bb);
            mma(ak[2 * p], as, bb[0], bb[1]);
            mma(ak[2 * p + 1], as, bb[2], bb[3]);
          }
        }
      }
    }
    store_bf16<D>(dk + koff, ak, k0 + m0, n0, S, scale);
    store_bf16<D>(dv + koff, av, k0 + m0, n0, S, 1.f);
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF = 32;        // rows of a q tile and of a key tile
constexpr int kLdPF = kF + 1;  // row stride of the P and dS tiles

template <int D>
struct F32Layout {
  static constexpr int kLd = D + 4;  // padded row stride of the D-wide tiles
  static constexpr int kTile = kF * kLd;
  static constexpr size_t kBytes =
      4 * (4 * static_cast<size_t>(kTile) + 2 * kF * kLdPF + 2 * kF);
};

// One 32 x 32 (q, key) tile: thread (ty, tx) computes rows ty + 16 i and
// keys tx + 16 j of S and dP, then P = exp(S scale - lse) and
// dS = P (dP - delta) into shared memory [q][key].
template <int D>
__device__ __forceinline__ void f32_tile(const float* sQ, const float* sdO,
                                         const float* sK, const float* sV,
                                         float* sP, float* sdS,
                                         const float* sLse,
                                         const float* sDelta, int q0, int k0,
                                         int S, int causal, int window,
                                         float scale) {
  constexpr int LD = F32Layout<D>::kLd;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[2][2] = {}, dp[2][2] = {};
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 qv[2], dov[2], kv[2], vv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      qv[i] = *reinterpret_cast<const float4*>(&sQ[(ty + 16 * i) * LD + d]);
      dov[i] = *reinterpret_cast<const float4*>(&sdO[(ty + 16 * i) * LD + d]);
      kv[i] = *reinterpret_cast<const float4*>(&sK[(tx + 16 * i) * LD + d]);
      vv[i] = *reinterpret_cast<const float4*>(&sV[(tx + 16 * i) * LD + d]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[i][j] += qv[i].x * kv[j].x + qv[i].y * kv[j].y + qv[i].z * kv[j].z +
                   qv[i].w * kv[j].w;
        dp[i][j] += dov[i].x * vv[j].x + dov[i].y * vv[j].y +
                    dov[i].z * vv[j].z + dov[i].w * vv[j].w;
      }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int ql = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int kl = tx + 16 * j;
      const bool ok = visible(q0 + ql, k0 + kl, S, causal, window);
      const float p = ok ? expf(s[i][j] * scale - sLse[ql]) : 0.f;
      sP[ql * kLdPF + kl] = p;
      sdS[ql * kLdPF + kl] = p * (dp[i][j] - sDelta[ql]);
    }
  }
}

// rows ty + 16 i, columns 64 jj + 4 tx .. + 3 of acc, times mul, into a
// (S, D) float32 matrix at row0; rows past S are not written
template <int D>
__device__ __forceinline__ void store_f32(float* out,
                                          const float (&acc)[2][D / 64][4],
                                          int row0, int S, float mul) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= S) continue;
#pragma unroll
    for (int jj = 0; jj < D / 64; ++jj)
      *reinterpret_cast<float4*>(out + static_cast<size_t>(row) * D +
                                 64 * jj + 4 * tx) =
          make_float4(acc[i][jj][0] * mul, acc[i][jj][1] * mul,
                      acc[i][jj][2] * mul, acc[i][jj][3] * mul);
  }
}

template <int D, bool kDQ>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dq,
                  float* __restrict__ dk, float* __restrict__ dv, int H,
                  int Hkv, int S, int causal, int window, float scale) {
  using L = F32Layout<D>;
  constexpr int LD = L::kLd;
  constexpr int NV = D / 64;  // float4 column groups a thread and row
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sdO = sQ + L::kTile;
  float* sK = sdO + L::kTile;
  float* sV = sK + L::kTile;
  float* sP = sV + L::kTile;
  float* sdS = sP + kF * kLdPF;
  float* sLse = sdS + kF * kLdPF;
  float* sDelta = sLse + kF;
  const int G = H / Hkv;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  if constexpr (kDQ) {
    const int bh = blockIdx.y, b = bh / H;
    const int kvh = b * Hkv + (bh % H) / G;
    const int q0 = (gridDim.x - 1 - blockIdx.x) * kF;
    const size_t qoff = static_cast<size_t>(bh) * S * D;
    const size_t koff = static_cast<size_t>(kvh) * S * D;
    load_rows<float, D, kF>(sQ, LD, q + qoff, q0, S);
    load_rows<float, D, kF>(sdO, LD, dout + qoff, q0, S);
    load_row_stats<kF>(sLse, sDelta, lse + static_cast<size_t>(bh) * S,
                       delta + static_cast<size_t>(bh) * S, q0, S, 1.f);
    float acc[2][NV][4] = {};
    int t_lo, t_hi;
    key_tiles(q0, kF, kF, S, causal, window, t_lo, t_hi);
    for (int t = t_lo; t < t_hi; ++t) {
      const int k0 = t * kF;
      __syncthreads();
      load_rows<float, D, kF>(sK, LD, k + koff, k0, S);
      load_rows<float, D, kF>(sV, LD, v + koff, k0, S);
      cp_async_wait_all();
      __syncthreads();
      f32_tile<D>(sQ, sdO, sK, sV, sP, sdS, sLse, sDelta, q0, k0, S, causal,
                  window, scale);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kF; ++kk) {
        float a[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) a[i] = sdS[(ty + 16 * i) * kLdPF + kk];
#pragma unroll
        for (int jj = 0; jj < NV; ++jj) {
          const float4 kv =
              *reinterpret_cast<const float4*>(&sK[kk * LD + 64 * jj + 4 * tx]);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            acc[i][jj][0] += a[i] * kv.x;
            acc[i][jj][1] += a[i] * kv.y;
            acc[i][jj][2] += a[i] * kv.z;
            acc[i][jj][3] += a[i] * kv.w;
          }
        }
      }
    }
    store_f32<D>(dq + qoff, acc, q0, S, scale);
  } else {
    const int bkv = blockIdx.y, b = bkv / Hkv;
    const int k0 = blockIdx.x * kF;
    const size_t koff = static_cast<size_t>(bkv) * S * D;
    load_rows<float, D, kF>(sK, LD, k + koff, k0, S);
    load_rows<float, D, kF>(sV, LD, v + koff, k0, S);
    float ak[2][NV][4] = {}, av[2][NV][4] = {};
    int t_lo, t_hi;
    query_tiles(k0, kF, kF, S, causal, window, t_lo, t_hi);
    for (int hq = 0; hq < G; ++hq) {
      const int bh = b * H + (bkv % Hkv) * G + hq;
      const size_t qoff = static_cast<size_t>(bh) * S * D;
      for (int t = t_lo; t < t_hi; ++t) {
        const int q0 = t * kF;
        __syncthreads();
        load_rows<float, D, kF>(sQ, LD, q + qoff, q0, S);
        load_rows<float, D, kF>(sdO, LD, dout + qoff, q0, S);
        load_row_stats<kF>(sLse, sDelta, lse + static_cast<size_t>(bh) * S,
                           delta + static_cast<size_t>(bh) * S, q0, S, 1.f);
        cp_async_wait_all();
        __syncthreads();
        f32_tile<D>(sQ, sdO, sK, sV, sP, sdS, sLse, sDelta, q0, k0, S,
                    causal, window, scale);
        __syncthreads();
#pragma unroll 4
        for (int qq = 0; qq < kF; ++qq) {
          float ap[2], as[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            ap[i] = sP[qq * kLdPF + ty + 16 * i];
            as[i] = sdS[qq * kLdPF + ty + 16 * i];
          }
#pragma unroll
          for (int jj = 0; jj < NV; ++jj) {
            const int c = qq * LD + 64 * jj + 4 * tx;
            const float4 o4 = *reinterpret_cast<const float4*>(&sdO[c]);
            const float4 q4 = *reinterpret_cast<const float4*>(&sQ[c]);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              av[i][jj][0] += ap[i] * o4.x;
              av[i][jj][1] += ap[i] * o4.y;
              av[i][jj][2] += ap[i] * o4.z;
              av[i][jj][3] += ap[i] * o4.w;
              ak[i][jj][0] += as[i] * q4.x;
              ak[i][jj][1] += as[i] * q4.y;
              ak[i][jj][2] += as[i] * q4.z;
              ak[i][jj][3] += as[i] * q4.w;
            }
          }
        }
      }
    }
    store_f32<D>(dk + koff, ak, k0, S, scale);
    store_f32<D>(dv + koff, av, k0, S, 1.f);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// the dK/dV kernel, then the dQ kernel, over tiles of TILE rows
template <int TILE, typename T, typename Kernel>
int launch_pair(Kernel kdq, Kernel kdkv, size_t smem, const T* q, const T* k,
                const T* v, const T* dout, const float* lse,
                const float* delta, T* dq, T* dk, T* dv, int B, int H,
                int Hkv, int S, int causal, int window, float scale,
                cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kdkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (S + TILE - 1) / TILE;
  kdkv<<<dim3(tiles, B * Hkv), kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, dk, dv, H, Hkv, S, causal, window,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kdq<<<dim3(tiles, B * H), kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, dk, dv, H, Hkv, S, causal, window,
      scale);
  return cudaGetLastError();
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, const void* o,
             const float* lse, const void* dout, float* delta, void* dq,
             void* dk, void* dv, int B, int H, int Hkv, int S, int is_bf16,
             int causal, int window, float scale, cudaStream_t stream) {
  const int rows = B * H * S;
  const dim3 dgrid((rows + kThreads / 32 - 1) / (kThreads / 32));
  if (is_bf16) {
    using T = __nv_bfloat16;
    bwd_delta<T><<<dgrid, kThreads, 0, stream>>>(
        static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows,
        D);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return launch_pair<kB>(
        flash_bwd_bf16<D, true>, flash_bwd_bf16<D, false>,
        Bf16Layout<D>::kBytes, static_cast<const T*>(q),
        static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq),
        static_cast<T*>(dk), static_cast<T*>(dv), B, H, Hkv, S, causal,
        window, scale, stream);
  }
  bwd_delta<float><<<dgrid, kThreads, 0, stream>>>(
      static_cast<const float*>(o), static_cast<const float*>(dout), delta,
      rows, D);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_pair<kF>(
      flash_bwd_f32<D, true>, flash_bwd_f32<D, false>, F32Layout<D>::kBytes,
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv), B, H, Hkv, S, causal, window, scale, stream);
}

}  // namespace

extern "C" {

// Gradients of o = attention(q, k, v) (flash_attention.cu) for upstream
// gradient dout: q, o, dout and dq (B,H,S,D), k, v, dk and dv (B,Hkv,S,D),
// all contiguous, of one type (bf16 when is_bf16, else f32) and 16-byte
// aligned; lse (B,H,S) float32 from flash_attention_lse_launch; delta
// (B,H,S) float32 scratch.  D is 64, 128 or 256 and H a multiple of Hkv;
// window <= 0 means no window.  Returns cudaGetLastError() of the last
// launch, or the error that kept one from launching.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const float* lse,
                               const void* dout, float* delta, void* dq,
                               void* dk, void* dv, int B, int H, int Hkv,
                               int S, int D, int is_bf16, int causal,
                               int window, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || S <= 0 || H % Hkv != 0 ||
      B * H > 65535)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) %
          16 != 0)
    return cudaErrorMisalignedAddress;  // 16-byte cp.async copies
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_d<64>(q, k, v, o, lse, dout, delta, dq, dk, dv, B, H,
                          Hkv, S, is_bf16, causal, window, scale, st);
    case 128:
      return launch_d<128>(q, k, v, o, lse, dout, delta, dq, dk, dv, B, H,
                           Hkv, S, is_bf16, causal, window, scale, st);
    case 256:
      return launch_d<256>(q, k, v, o, lse, dout, delta, dq, dk, dv, B, H,
                           Hkv, S, is_bf16, causal, window, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* flash_attention_bwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
