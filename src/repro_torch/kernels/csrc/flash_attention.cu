// Online-softmax attention forward on Hopper (sm_90a): causal, sliding
// window or bidirectional, GQA, bfloat16 or float32 in and out.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_flash_fwd_kernel, launched by flash_attention_fwd).  The port's griffin
// prefill calls it once per local-attention layer on the prompt's own keys.
//
// Bound on the H100: operations.  Only the unmasked (q, k) pairs need work,
// 4*D operations each (q.k and p.v); at the serving shape (B=4, H=10, Hkv=1,
// S=4064, D=256, window 2048) that is ~6.2 M pairs per head, ~0.26 ms at
// the 989 TFLOP/s bf16 tensor-core peak.  The bytes (q, k, v read once, o
// written once) are a few tens of MB, far below it.
//
// bfloat16 (the serving path): tensor cores and TMA.  One block of 256
// threads, two warpgroups, per (batch*head, 128-row q tile), the tiles with
// the most keys launched first.  Thread 0 also produces: it loads the q
// tile once and streams 64-row k and v tiles by TMA through a 2-stage ring
// in shared memory, each stage guarded by a full and an empty mbarrier,
// refilling a stage as soon as both warpgroups have released it.  Each
// warpgroup owns 64 q rows: S = Q.K^T by wgmma m64n64k16 with both operands
// in shared memory (K-major, as stored), the online softmax on the
// accumulator registers, P cast to bf16 in registers and fed as wgmma's
// register A operand for O += P.V, V read from shared memory with the
// transpose bit (its rows are the contraction).  O stays in registers
// (64 x D f32 per warpgroup, D/2 a thread).  Tiles are stored with 128-byte
// swizzle: a 64-value (128-byte) box per TMA, D/64 boxes per row, and the
// wgmma descriptors walk the same layout.  The tensor maps are 3-D (D, S,
// heads), so rows past S read as zeros and never as the next head's rows;
// they are masked all the same.  Tiles wholly in the future or outside the
// window are never loaded, tiles wholly masked for one warpgroup are
// skipped by it, and only partial tiles pay for the mask.  Shared memory at
// D=256: q 64 KB + 2 x (k 32 KB + v 32 KB) = 192 KB, one block per SM.
// Why no separate producer warp: a third warpgroup caps every thread at
// 168 registers (the register file is split over the SM's 4 sub-partitions),
// and even with setmaxnreg handing the producer's registers to the
// consumers, ptxas spilled the D=256 consumer and serialised its wgmmas,
// and that design ran slower than this one at the serving shape (PERF.md
// has the times and register counts).  The tensor-map encoder comes
// from cudaGetDriverEntryPoint, so the library links nothing but the CUDA
// runtime.
//
// float32: the first port's body on the CUDA cores (TF32 tensor cores
// cannot hold float32's 2e-5 tolerance).  One block of 256 threads per
// (batch*head, 64-row q tile), q, k and v tiles staged in shared memory,
// scores and the output slice in registers.
//
// Numerics follow the Pallas body: scores scaled after the dot product,
// masked scores -1e30, running max from -1e30, final division by
// max(l, 1e-30).  The bf16 path keeps the row sum l from float32 p before
// it casts p to bf16 for P.V (the one intended difference from an all-f32
// product; the 2e-2 bf16 tolerance and the 5e-3 normwise check cover it),
// and takes exp2 of scores prescaled by log2(e) with the hardware's
// ex2.approx: the accurate exp2f costs a quarter of the kernel's time at
// the serving shape for no change in the bf16 result.
#include <cuda.h>  // CUtensorMap and its enums: types only, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;

template <int D>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kBQ) * (D + 4) +
                          static_cast<size_t>(kBK) * (D + 4) +
                          static_cast<size_t>(kBK) * D +
                          static_cast<size_t>(kBQ) * (kBK + 4));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int H,
                  int Hkv, int S, int causal, int window, float scale) {
  constexpr int QS = D + 4;   // padded row stride of the q and k tiles
  constexpr int PS = kBK + 4;  // padded row stride of the probability tile
  constexpr int NV = D / 64;   // float4 output groups per thread and row
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * QS;
  float* sV = sK + kBK * QS;
  float* sP = sV + kBK * D;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int kvh = b * Hkv + (bh % H) / (H / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const float* qb = q + static_cast<size_t>(bh) * S * D;
  const float* kb = k + static_cast<size_t>(kvh) * S * D;
  const float* vb = v + static_cast<size_t>(kvh) * S * D;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int qp = q0 + r;
    sQ[r * QS + c] = qp < S ? qb[static_cast<size_t>(qp) * D + c] : 0.f;
  }

  float acc[4][NV][4];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NV; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][jj][e] = 0.f;
  }

  // k tiles that hold at least one key some row of this tile may see
  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? q_last + 1 : S;
  const int t_lo = k_lo / kBK;
  const int t_hi = (k_hi + kBK - 1) / kBK;

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the last tile's readers are done with sK, sV, sP
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      const int kp = k0 + r;
      const size_t g = static_cast<size_t>(kp) * D + c;
      sK[r * QS + c] = kp < S ? kb[g] : 0.f;
      sV[r * D + c] = kp < S ? vb[g] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&sQ[(ty + 16 * i) * QS + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&sK[(tx + 16 * j) * QS + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] += qv[i].x * kv[j].x + qv[i].y * kv[j].y +
                     qv[i].z * kv[j].z + qv[i].w * kv[j].w;
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool ok = kp < S && (!causal || qp >= kp) &&
                        (window <= 0 || qp - kp < window);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        psum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * corr + psum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NV; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][jj][e] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sP[(ty + 16 * i) * PS + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(ty + 16 * i) * PS + kk];
#pragma unroll
      for (int jj = 0; jj < NV; ++jj) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&sV[kk * D + 64 * jj + 4 * tx]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][jj][0] += p[i] * vv.x;
          acc[i][jj][1] += p[i] * vv.y;
          acc[i][jj][2] += p[i] * vv.z;
          acc[i][jj][3] += p[i] * vv.w;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = o + (static_cast<size_t>(bh) * S + qp) * D;
#pragma unroll
    for (int jj = 0; jj < NV; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        orow[64 * jj + 4 * tx + e] = acc[i][jj][e] / den;
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int H, int Hkv, int S, int causal, int window, float scale,
               cudaStream_t stream) {
  const size_t smem = f32_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_fwd_f32<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, Hkv, S,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma + TMA, warp-specialised
// ---------------------------------------------------------------------------

constexpr int kTileQ = 128;   // q rows per block, 64 per consumer warpgroup
constexpr int kTileK = 64;    // k/v rows per ring stage
constexpr int kStages = 2;    // ring depth
constexpr int kSlab = 64;     // bf16 values per 128-byte swizzled row
constexpr int kRow = 128;     // bytes per swizzled row
constexpr int kThreadsBf16 = 256;  // two consumer warpgroups
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Layout {
  static constexpr int kQBytes = kTileQ * D * 2;
  static constexpr int kKVBytes = kTileK * D * 2;  // one k (or v) stage
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBar = kV + kStages * kKVBytes;  // q, full[], empty[]
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages);
  static constexpr int kAlloc = kBytes + 1024;  // room to align to 1024
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// spin on a barrier phase; a wait of ~2^26 polls (seconds) can only be a
// deadlock, and traps so that the launch fails instead of hanging
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint32_t polls = 0;
  do {
    if (++polls == (1u << 26)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout B128.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accesses of wgmma's registers across the
// asynchronous instructions
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_ACC32                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define WG_OUT32(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])

// The descriptors below are a tile's base descriptor plus a step's offset
// (16-byte units, added to the start address inside the asm), so that the
// compiler cannot hoist sixteen loop-invariant q descriptors out of the k
// loop into registers beside the O accumulator.
#define WG_ADD_OFFSET(out, desc, off)      \
  "mov.b64 {wlo, whi}, " desc ";\n"        \
  "add.u32 wlo, wlo, " off ";\n"           \
  "mov.b64 " out ", {wlo, whi};\n"

// d (64 x 64 f32) (+)= A (64 x 16, shared, K-major) . B (64 x 16, shared,
// K-major)^T
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint32_t off_a, uint64_t db,
                                         uint32_t off_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .b32 wlo, whi;\n"
      ".reg .b64 wda, wdb;\n"
      "setp.ne.b32 p, %36, 0;\n"
      WG_ADD_OFFSET("wda", "%32", "%33")
      WG_ADD_OFFSET("wdb", "%34", "%35")
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_ACC32
      ", wda, wdb, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_OUT32(d)
      : "l"(da), "r"(off_a), "l"(db), "r"(off_b), "r"(accumulate));
}

// d (64 x 64 f32) += A (64 x 16 bf16, registers) . B (16 x 64, shared,
// N-major: transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db, uint32_t off_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .b32 wlo, whi;\n"
      ".reg .b64 wdb;\n"
      "setp.ne.b32 p, %38, 0;\n"
      WG_ADD_OFFSET("wdb", "%36", "%37")
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_ACC32
      ", {%32, %33, %34, %35}, wdb, p, 1, 1, 1;\n"
      "}\n"
      : WG_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(off_b),
        "r"(1));
}

// one k/v tile (keys t*kTileK ..) into ring stage s, both completing on
// the stage's full barrier
template <int D>
__device__ __forceinline__ void load_kv(const CUtensorMap* k_map,
                                        const CUtensorMap* v_map,
                                        uint32_t sK, uint32_t sV,
                                        uint32_t full, int s, int t,
                                        int kvh) {
  using L = Layout<D>;
  mbar_expect_tx(full, 2 * L::kKVBytes);
  for (int c = 0; c < D / kSlab; ++c) {
    tma_load_3d(sK + s * L::kKVBytes + c * kTileK * kRow, k_map, full,
                c * kSlab, t * kTileK, kvh);
    tma_load_3d(sV + s * L::kKVBytes + c * kTileK * kRow, v_map, full,
                c * kSlab, t * kTileK, kvh);
  }
}

// 2^x on the special-function unit (ex2.approx.ftz: about 2 ulp, results
// below the normal range flushed to 0), for scores and rescale factors
// whose probabilities go to bf16 anyway
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(kThreadsBf16, 1)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   __nv_bfloat16* __restrict__ o, int H, int Hkv, int S,
                   int causal, int window, float scale_log2) {
  constexpr int NS = D / kSlab;  // 128-byte slabs per row
  constexpr int KQ = D / 16;     // k16 steps of q.k
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kQ;
  const uint32_t sK = base + L::kK;
  const uint32_t sV = base + L::kV;
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_full = bar_q + 8;                 // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * kStages;  // + 8 * stage

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTileQ;  // longest first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int kvh = b * Hkv + (bh % H) / (H / Hkv);

  // k tiles that hold at least one key some row of this block may see
  const int q_last = min(q0 + kTileQ, S) - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? q_last + 1 : S;
  const int t_lo = k_lo / kTileK;
  const int t_hi = (k_hi + kTileK - 1) / kTileK;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // thread 0 is also the producer: it loads the q tile and the first
  // kStages k/v tiles now, and refills each stage once both warpgroups
  // have released it
  const bool producer = threadIdx.x == 0;
  if (producer) {
    mbar_expect_tx(bar_q, L::kQBytes);
    for (int c = 0; c < NS; ++c)
      tma_load_3d(sQ + c * kTileQ * kRow, &q_map, bar_q, c * kSlab, q0, bh);
    for (int t = t_lo; t < min(t_hi, t_lo + kStages); ++t)
      load_kv<D>(&k_map, &v_map, sK, sV, bar_full + 8 * (t - t_lo),
                 t - t_lo, t, kvh);
  }
  const int g = threadIdx.x / 128;  // rows 64g .. 64g+63 of the q tile
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  // accumulator layout: this thread holds rows r0 and r0 + 8, and in
  // every 8-column chunk j the columns 8j + cq and 8j + cq + 1
  const int r0 = q0 + 64 * g + 16 * (tid / 32) + lane / 4;
  const int cq = 2 * (lane % 4);
  const int g_first = q0 + 64 * g;
  const int g_last = min(g_first + 63, S - 1);
  const int gk_lo = window > 0 ? max(0, g_first - window + 1) : 0;
  const int gk_hi = causal ? g_last + 1 : S;
  // keys [key_lo, key_hi) of rows r0 and r0 + 8, less this thread's cq
  const int key_lo0 = (window > 0 ? r0 - window + 1 : -(1 << 30)) - cq;
  const int key_lo1 = (window > 0 ? r0 + 9 - window : -(1 << 30)) - cq;
  const int key_hi0 = (causal ? min(r0 + 1, S) : S) - cq;
  const int key_hi1 = (causal ? min(r0 + 9, S) : S) - cq;

  float acc[NS][32];
#pragma unroll
  for (int c = 0; c < NS; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[c][e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  mbar_wait(bar_q, 0);
  for (int t = t_lo; t < t_hi; ++t) {
    const int i = t - t_lo, s = i % kStages;
    const int k0 = t * kTileK;
    mbar_wait(bar_full + 8 * s, (i / kStages) & 1);
    if (g_first < S && k0 < gk_hi && k0 + kTileK > gk_lo) {
      // S = Q_g . K_t^T
      float sc[32];
      const uint64_t dq = sw128_desc(sQ + g * 64 * kRow, 16, 8 * kRow);
      const uint64_t dk = sw128_desc(sK + s * L::kKVBytes, 16, 8 * kRow);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
        // slab kk / 4, 32-byte k16 step kk % 4 inside it
        wgmma_ss(sc, dq, ((kk / 4) * kTileQ * kRow + (kk % 4) * 32) >> 4,
                 dk, ((kk / 4) * kTileK * kRow + (kk % 4) * 32) >> 4,
                 kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      const bool whole = k0 + kTileK <= S &&
                         (!causal || k0 + kTileK - 1 <= g_first) &&
                         (window <= 0 || g_last - k0 < window);
      float mx0 = kNegInf, mx1 = kNegInf;
      // element (j, e) is key k0 + cq + 8j + (e & 1): it is visible when
      // 8j + (e & 1) lies in [lo, hi) of its row, shifted by k0 + cq
      const int lo0 = key_lo0 - k0, hi0 = key_hi0 - k0;
      const int lo1 = key_lo1 - k0, hi1 = key_hi1 - k0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e] * scale_log2;
          if (!whole) {
            const int c = 8 * j + (e & 1);
            const bool ok = e < 2 ? (c >= lo0 && c < hi0)
                                  : (c >= lo1 && c < hi1);
            x = ok ? x : kNegInf;
          }
          sc[4 * j + e] = x;
          if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
        }
      }
      // the 4 threads of a quad hold one row's 64 columns
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float corr0 = fast_exp2(m0 - mn0), corr1 = fast_exp2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = fast_exp2(sc[4 * j + e] - (e < 2 ? mn0 : mn1));
          sc[4 * j + e] = p;
          if (e < 2) ps0 += p; else ps1 += p;
        }
      }
      l0 = l0 * corr0 + ps0;  // this thread's share; the quad sums at the end
      l1 = l1 * corr1 + ps1;
#pragma unroll
      for (int c = 0; c < NS; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[c][4 * j + 0] *= corr0;
          acc[c][4 * j + 1] *= corr0;
          acc[c][4 * j + 2] *= corr1;
          acc[c][4 * j + 3] *= corr1;
        }
      // the accumulator layout of k16 slice kk (chunks 2kk, 2kk+1) is
      // wgmma's register A layout, so P needs no shuffle
      uint32_t pa[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) pa[r] = pack_bf16(sc[2 * r], sc[2 * r + 1]);

      // O += P . V_t, one 64-wide slab of D per instruction
#pragma unroll
      for (int c = 0; c < NS; ++c) fence_regs(acc[c]);
      const uint64_t dv =
          sw128_desc(sV + s * L::kKVBytes, kTileK * kRow, 8 * kRow);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTileK / 16; ++kk)
#pragma unroll
        for (int c = 0; c < NS; ++c)  // slab c, keys 16kk .. 16kk+15
          wgmma_rs(acc[c], pa + 4 * kk, dv,
                   (c * kTileK * kRow + kk * 16 * kRow) >> 4);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < NS; ++c) fence_regs(acc[c]);
    }
    mbar_arrive(bar_empty + 8 * s);
    if (producer && t + kStages < t_hi) {
      mbar_wait(bar_empty + 8 * s, (i / kStages) & 1);
      load_kv<D>(&k_map, &v_map, sK, sV, bar_full + 8 * s, s,
                 t + kStages, kvh);
    }
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* o0 = o + (static_cast<size_t>(bh) * S + r0) * D + cq;
  __nv_bfloat16* o1 = o0 + 8 * static_cast<size_t>(D);
#pragma unroll
  for (int c = 0; c < NS; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c * kSlab + 8 * j;
      if (r0 < S)
        *reinterpret_cast<uint32_t*>(o0 + col) =
            pack_bf16(acc[c][4 * j] * inv0, acc[c][4 * j + 1] * inv0);
      if (r0 + 8 < S)
        *reinterpret_cast<uint32_t*>(o1 + col) =
            pack_bf16(acc[c][4 * j + 2] * inv1, acc[c][4 * j + 3] * inv1);
    }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled lookup_encode_tiled() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
  const cudaError_t err = cudaGetDriverEntryPoint(
      "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
  if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
    return nullptr;
  return reinterpret_cast<EncodeTiled>(fn);
}

// a (depth, S, D) bf16 tensor as 128-byte-swizzled boxes of 64 values by
// box_rows rows; rows past S read as zeros
bool encode_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int D,
                int S, int depth, int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(depth)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(S) * D * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kSlab),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int H, int Hkv, int S, int causal, int window, float scale,
                cudaStream_t stream) {
  static const EncodeTiled encode = lookup_encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return cudaErrorMisalignedAddress;  // TMA reads from 16-byte bases
  CUtensorMap qm, km, vm;
  if (!encode_map(encode, &qm, q, D, S, B * H, kTileQ) ||
      !encode_map(encode, &km, k, D, S, B * Hkv, kTileK) ||
      !encode_map(encode, &vm, v, D, S, B * Hkv, kTileK))
    return cudaErrorInvalidValue;
  const int smem = Layout<D>::kAlloc;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kTileQ - 1) / kTileQ, B * H);
  flash_fwd_bf16<D><<<grid, kThreadsBf16, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), H, Hkv, S, causal, window,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Hkv, int S, int is_bf16, int causal, int window,
           float scale, cudaStream_t stream) {
  return is_bf16 ? launch_bf16<D>(q, k, v, o, B, H, Hkv, S, causal, window,
                                  scale, stream)
                 : launch_f32<D>(q, k, v, o, B, H, Hkv, S, causal, window,
                                 scale, stream);
}

}  // namespace

extern "C" {

// q (B,H,S,D), k and v (B,Hkv,S,D) -> o (B,H,S,D), all contiguous, of one
// type (bf16 when is_bf16, else f32), on the current device; D is 64, 128
// or 256 and H a multiple of Hkv.  window <= 0 means no window.  Returns
// cudaGetLastError() of the launch, or the error that kept it from
// launching.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int H, int Hkv, int S, int D,
                           int is_bf16, int causal, int window, float scale,
                           void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || S <= 0 || H % Hkv != 0 ||
      B * H > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, o, B, H, Hkv, S, is_bf16, causal, window,
                        scale, st);
    case 128:
      return launch<128>(q, k, v, o, B, H, Hkv, S, is_bf16, causal, window,
                         scale, st);
    case 256:
      return launch<256>(q, k, v, o, B, H, Hkv, S, is_bf16, causal, window,
                         scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* flash_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
