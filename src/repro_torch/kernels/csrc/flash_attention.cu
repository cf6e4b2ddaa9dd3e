// Online-softmax attention forward on Hopper (sm_90a): causal, sliding
// window or bidirectional, GQA, bfloat16 or float32 in and out.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_flash_fwd_kernel, launched by flash_attention_fwd).  The port calls it
// once per self-attention layer of a fresh prompt: the dense and MoE
// prefill and training forward at D=128, Whisper's encoder and decoder at
// D=64, the griffin prefill's local-attention layers at D=256.
//
// Bound on the H100: operations.  Only the unmasked (q, k) pairs need work,
// 4*D operations each (q.k and p.v): a Llama-3-8B prefill launch (B=4,
// H=32, S=4064, D=128, causal) is 0.55 ms at the 989 TFLOP/s bf16
// tensor-core peak, a griffin one (B=4, H=10, S=4064, D=256, window 2048)
// 0.26 ms.  The bytes (q, k, v read once, o written once) are far below.
//
// Three designs, picked by dtype and head dim in flash_attention_launch.
// Both bfloat16 designs run on the tensor cores: q, k and v tiles come into
// shared memory by TMA with 128-byte swizzle (a 64-value, 128-byte box per
// load, D/64 boxes a row; the 3-D tensor maps (D, S, heads) read rows past
// S as zeros, never as the next head's rows), S = Q.K^T and O += P.V run
// as wgmma, the online softmax on the accumulator registers, O stays in
// registers (64 q rows x D a warpgroup, D/2 f32 a thread).  One block per
// (batch*head, 128-row q tile), the tiles with the most keys launched
// first; k tiles wholly in the future or outside the window are never
// loaded, and only tiles that cut a mask or S pay for the mask.
//
// bfloat16, D = 64 and 128 (flash_fwd_bf16_ws): 384 threads.  One thread
// of a producer warpgroup loads the q tile, then streams 128-key k and v
// tiles through a ring (2 stages at D=128, 4 at D=64) with a full and an
// empty mbarrier per k and per v stage, so a k stage is refilled once S is
// done with it.  Two consumer warpgroups, 64 q rows each, issue tile i's S
// (m64n128k16, both operands in shared memory) with tile i-1's P.V behind
// it, and run tile i's softmax while that P.V runs (wgmma.wait_group 1,
// then 0); named barriers make them take turns to issue, so one's exp2
// work runs under the other's wgmmas.  Registers bound this design: 12
// warps put 3 on each of the SM's 4 sub-partitions, and ptxas holds every
// thread to 168 registers (setmaxnreg 24 / 240 moved none to the
// consumers' code: the same 168, the same spills).  S and O take 64 each
// at D=128, so P goes through shared memory: stmatrix writes it into a
// K-major swizzled 64 x 128 tile per consumer, and P.V's wgmma reads it
// there (kept in registers beside S and O, P made ptxas spill and
// serialise the wgmmas).  At D=64 O takes 32, P stays in registers as
// wgmma's A operand, and that is faster there.  Shared memory: q 32 KB +
// 2 x (k 32 + v 32) + P 2 x 16 = 192 KB at D=128; q 16 + 4 x (16 + 16) =
// 144 KB at D=64.  ptxas keeps both within 168 registers with no spills
// (PERF.md has the counts, the times and the measurements behind each
// choice).
//
// bfloat16, D = 256 (flash_fwd_bf16, the griffin path): 256 threads, two
// warpgroups, 64-key tiles in a 2-stage ring that thread 0 refills, each
// tile's S, softmax and P.V in turn.  O takes 128 registers a thread here,
// so a third warpgroup's 168-register cap spilled it, and that design ran
// slower than this one at the serving shape.  Shared memory: q 64 KB + 2 x
// (k 32 KB + v 32 KB) = 192 KB.  The tensor-map encoder comes from
// cudaGetDriverEntryPoint, so the library links nothing but the CUDA
// runtime.
//
// float32: the first port's body on the CUDA cores (TF32 tensor cores
// cannot hold float32's 2e-5 tolerance).  One block of 256 threads per
// (batch*head, 64-row q tile), q, k and v tiles staged in shared memory,
// scores and the output slice in registers.
//
// Training launches (flash_attention_lse_launch) also write each row's
// logsumexp of the masked, scaled scores, float32 (B, H, S) in natural-log
// units, which the backward (flash_attention_bwd.cu) reads to rebuild P
// without a second softmax pass.  Each body is a template on kLse, so the
// serving launches (flash_attention_launch, no lse) run the code they ran
// before; the lse store is one value a row at the end.
//
// Numerics follow the Pallas body: scores scaled after the dot product,
// masked scores -1e30, running max from -1e30, final division by
// max(l, 1e-30).  The bf16 paths keep the row sum l from float32 p before
// they cast p to bf16 for P.V (the one intended difference from an all-f32
// product; the 2e-2 bf16 tolerance and the 5e-3 normwise check cover it),
// and take exp2 of scores prescaled by log2(e) with the hardware's
// ex2.approx: the accurate exp2f costs a quarter of the kernel's time at
// the griffin serving shape for no change in the bf16 result.
#include <cuda.h>  // CUtensorMap and its enums: types only, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

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

template <int D, bool kLse>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ lse, int H, int Hkv, int S, int causal,
                  int window, float scale) {
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
    if (kLse && tx == 0)
      lse[static_cast<size_t>(bh) * S + qp] = m[i] + logf(l[i]);
    float* orow = o + (static_cast<size_t>(bh) * S + qp) * D;
#pragma unroll
    for (int jj = 0; jj < NV; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        orow[64 * jj + 4 * tx + e] = acc[i][jj][e] / den;
  }
}

template <int D, bool kLse>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int H, int Hkv, int S, int causal,
               int window, float scale, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<D, kLse>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_fwd_f32<D, kLse><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H, Hkv, S,
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
// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accesses of wgmma's registers across the
// asynchronous instructions
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
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

#define WG_ACC64                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
#define WG_OUT64(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),       \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),       \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),       \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),       \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),       \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),       \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d (64 x 128 f32) (+)= A (64 x 16, shared, K-major) . B, B 128 x 16 in
// shared memory, K-major (TB = 0), or 16 x 128 N-major (TB = 1: its two
// 64-column slabs lie the descriptor's leading byte offset apart)
template <int TB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint32_t off_a, uint64_t db,
                                              uint32_t off_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .b32 wlo, whi;\n"
      ".reg .b64 wda, wdb;\n"
      "setp.ne.b32 p, %68, 0;\n"
      WG_ADD_OFFSET("wda", "%64", "%65")
      WG_ADD_OFFSET("wdb", "%66", "%67")
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_ACC64
      ", wda, wdb, p, 1, 1, 0, %69;\n"
      "}\n"
      : WG_OUT64(d)
      : "l"(da), "r"(off_a), "l"(db), "r"(off_b), "r"(accumulate),
        "n"(TB));
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

// rows r0 and r0 + 8's logsumexp in natural-log units, from the running
// max (log2 units: scores times scale * log2(e)) and the quad-summed row
// sums; one thread of the quad stores
__device__ __forceinline__ void store_lse(float* lse, int bh, int S, int r0,
                                          int lane, float m0, float l0,
                                          float m1, float l1) {
  if (lane % 4 != 0) return;
  float* row = lse + static_cast<size_t>(bh) * S + r0;
  if (r0 < S) row[0] = (m0 + log2f(l0)) * kLn2;
  if (r0 + 8 < S) row[8] = (m1 + log2f(l1)) * kLn2;
}

template <int D, bool kLse>
__global__ void __launch_bounds__(kThreadsBf16, 1)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                   int H, int Hkv, int S, int causal, int window,
                   float scale_log2) {
  static_assert(D == 256, "D <= 128 take flash_fwd_bf16_ws");
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
      wgmma_wait<0>();
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
      wgmma_wait<0>();
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
  if (kLse) store_lse(lse, bh, S, r0, lane, m0, l0, m1, l1);
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

// ---------------------------------------------------------------------------
// bfloat16 at D = 64 and 128: a producer warpgroup, 128-key tiles, and each
// tile's softmax run while the tensor cores work
// ---------------------------------------------------------------------------

constexpr int kWsTileK = 128;    // k/v rows per ring stage
constexpr int kWsThreads = 384;  // a producer and two consumer warpgroups
// named barriers 1 and 2 (0 is __syncthreads'): consumer g waits on 1 + g
// for its turn to issue wgmmas and hands the turn on at the other's; 3 and
// 4: consumer g's own four warps, once its P tile is written
constexpr int kTurnBar = 1;
constexpr int kPBar = 3;

template <int D>
struct WsLayout {
  // P through shared memory at D = 128, in registers at D = 64 (the
  // kernel's note says why)
  static constexpr bool kPSmem = D == 128;
  static constexpr int kStages = D == 64 ? 4 : 2;
  static constexpr int kQBytes = kTileQ * D * 2;
  static constexpr int kKVBytes = kWsTileK * D * 2;  // one k (or v) stage
  static constexpr int kPBytes = kPSmem ? 64 * kWsTileK * 2 : 0;  // a P
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kP = kV + kStages * kKVBytes;
  // q, then full k[], full v[], empty k[], empty v[]
  static constexpr int kBar = kP + 2 * kPBytes;
  static constexpr int kBytes = kBar + 8 * (1 + 4 * kStages);
  static constexpr int kAlloc = kBytes + 1024;  // room to align to 1024
};

// the two consumer warpgroups' named barriers (256 threads: 128 arrive,
// 128 wait)
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// four 8x8 bf16 blocks, in mma's fragment layout, into shared memory; lane
// l gives the address of row l % 8 of block l / 8
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0,
                                            uint32_t r1, uint32_t r2,
                                            uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::
          "r"(addr),
      "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
}

// make this thread's shared-memory writes visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// one k or v tile (keys t*kWsTileK ..) into a ring stage, completing on its
// full barrier
template <int D>
__device__ __forceinline__ void load_ws_tile(const CUtensorMap* map,
                                             uint32_t dst, uint32_t full,
                                             int t, int kvh) {
  mbar_expect_tx(full, WsLayout<D>::kKVBytes);
  for (int c = 0; c < D / kSlab; ++c)
    tma_load_3d(dst + c * kWsTileK * kRow, map, full, c * kSlab,
                t * kWsTileK, kvh);
}

// S (64 x 128 f32) = Q_g (64 x D) . K_t^T, one m64n128k16 a k16 step
template <int D>
__device__ __forceinline__ void ws_qk(float (&sc)[64], uint64_t dq,
                                      uint64_t dk) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)  // slab kk / 4, 32-byte step kk % 4
    wgmma_ss_n128<0>(sc, dq, ((kk / 4) * kTileQ * kRow + (kk % 4) * 32) >> 4,
                  dk, ((kk / 4) * kWsTileK * kRow + (kk % 4) * 32) >> 4,
                  kk > 0);
}

// O (64 x D f32) += P (64 x 128 bf16) . V_t (128 x D), one m64nDk16 a
// step of 16 keys, P read from shared memory (descriptor dp) at D = 128 and
// from registers (pa, wgmma's A fragments) at D = 64
template <int D>
__device__ __forceinline__ void ws_pv(float (&acc)[D / 2],
                                      const uint32_t (&pa)[32], uint64_t dp,
                                      uint64_t dv) {
#pragma unroll
  for (int kk = 0; kk < kWsTileK / 16; ++kk) {
    const uint32_t off_v = (kk * 16 * kRow) >> 4;
    if constexpr (WsLayout<D>::kPSmem)
      wgmma_ss_n128<1>(acc, dp, ((kk / 4) * 64 * kRow + (kk % 4) * 32) >> 4,
                       dv, off_v, 1);
    else
      wgmma_rs(acc, pa + 4 * kk, dv, off_v);
  }
}

// One tile's online softmax for this thread's rows r0 and r0 + 8: raw
// scores in, probabilities out in place, the running max and this thread's
// share of the row sums updated, and the factors by which O's rows must be
// rescaled before this tile's P.V returned in corr0, corr1.  A tile that
// cuts no mask and no S (kMask false) takes the max of the raw scores
// (scaling by a positive factor keeps the order, and rounds the max as it
// rounds each score) and one fused multiply-add a score; a masked tile
// scales first and sets masked scores to -1e30.  The element (j, e) is key
// k0 + cq + 8j + (e & 1); it is visible when 8j + (e & 1) lies in [lo, hi)
// of its row (bounds shifted by k0 + cq).  Maxima and sums run in two
// chains a row, to halve their dependent latency.
template <bool kMask>
__device__ __forceinline__ void ws_softmax(float (&sc)[64], int lo0,
                                           int hi0, int lo1, int hi1,
                                           float scale_log2, float& m0,
                                           float& m1, float& l0, float& l1,
                                           float& corr0, float& corr1) {
  float mx[4] = {kNegInf, kNegInf, kNegInf, kNegInf};  // (row, chain)
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[4 * j + e];
      if (kMask) {
        const int c = 8 * j + (e & 1);
        const bool ok =
            e < 2 ? (c >= lo0 && c < hi0) : (c >= lo1 && c < hi1);
        x = ok ? x * scale_log2 : kNegInf;
        sc[4 * j + e] = x;
      }
      float& m = mx[2 * (e >> 1) + (j & 1)];
      m = fmaxf(m, x);
    }
  float mx0 = fmaxf(mx[0], mx[1]), mx1 = fmaxf(mx[2], mx[3]);
  // the 4 threads of a quad hold one row's 128 columns
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  if (!kMask) {
    mx0 *= scale_log2;
    mx1 *= scale_log2;
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  corr0 = fast_exp2(m0 - mn0);
  corr1 = fast_exp2(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float ps[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float mn = e < 2 ? mn0 : mn1;
      const float x = sc[4 * j + e];
      const float p = fast_exp2(kMask ? x - mn : fmaf(x, scale_log2, -mn));
      sc[4 * j + e] = p;
      ps[2 * (e >> 1) + (j & 1)] += p;
    }
  l0 = l0 * corr0 + (ps[0] + ps[1]);  // the quad sums at the end
  l1 = l1 * corr1 + (ps[2] + ps[3]);
}

template <int D, bool kLse>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_fwd_bf16_ws(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      int H, int Hkv, int S, int causal, int window,
                      float scale_log2) {
  static_assert(D == 64 || D == 128, "the D <= 128 design");
  using L = WsLayout<D>;
  constexpr int ST = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kQ;
  const uint32_t sK = base + L::kK;
  const uint32_t sV = base + L::kV;
  const uint32_t sP = base + L::kP;
  const uint32_t bar_q = base + L::kBar;
  const uint32_t full_k = bar_q + 8;  // + 8 * stage, and so on
  const uint32_t full_v = full_k + 8 * ST;
  const uint32_t empty_k = full_v + 8 * ST;
  const uint32_t empty_v = empty_k + 8 * ST;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTileQ;  // longest first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int kvh = b * Hkv + (bh % H) / (H / Hkv);

  // k tiles that hold at least one key some row of this block may see;
  // both consumers walk all of them (a tile wholly masked for one of them,
  // at a window's edge, reads as -1e30 scores and is wiped by the next
  // tile's rescale: every row sees its own key)
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(q0 + kTileQ, S) : S;
  const int t_lo = k_lo / kWsTileK;
  const int n = (k_hi + kWsTileK - 1) / kWsTileK - t_lo;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, 2 * 128);
      mbar_init(empty_v + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int role = threadIdx.x / 128;  // warpgroup 0 produces
  if (role == 0) {
    // producer: one thread loads the q tile, then each k and v tile as
    // soon as both consumers have released its stage
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, L::kQBytes);
      for (int c = 0; c < D / kSlab; ++c)
        tma_load_3d(sQ + c * kTileQ * kRow, &q_map, bar_q, c * kSlab, q0,
                    bh);
      for (int i = 0; i < n; ++i) {
        const int s = i % ST;
        // parity of the stage's release of tile i - ST
        const uint32_t freed = (i / ST + 1) & 1;
        if (i >= ST) mbar_wait(empty_k + 8 * s, freed);
        load_ws_tile<D>(&k_map, sK + s * L::kKVBytes, full_k + 8 * s,
                        t_lo + i, kvh);
        if (i >= ST) mbar_wait(empty_v + 8 * s, freed);
        load_ws_tile<D>(&v_map, sV + s * L::kKVBytes, full_v + 8 * s,
                        t_lo + i, kvh);
      }
    }
  } else {
    // consumers: warpgroup g owns q rows 64g .. 64g+63 of the tile.  Tile
    // i's S = Q.K^T is issued with tile i-1's O += P.V behind it, and tile
    // i's softmax runs while P.V does; the two warpgroups take turns to
    // issue, so one's softmax runs while the other's wgmmas do
    const int g = role - 1;
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    // accumulator layout: this thread holds rows r0 and r0 + 8, and in
    // every 8-column chunk j the columns 8j + cq and 8j + cq + 1
    const int r0 = q0 + 64 * g + 16 * (tid / 32) + lane / 4;
    const int cq = 2 * (lane % 4);
    const int g_first = q0 + 64 * g;
    const int g_last = min(g_first + 63, S - 1);
    // keys [key_lo, key_hi) of rows r0 and r0 + 8, less this thread's cq
    const int key_lo0 = (window > 0 ? r0 - window + 1 : -(1 << 30)) - cq;
    const int key_lo1 = (window > 0 ? r0 + 9 - window : -(1 << 30)) - cq;
    const int key_hi0 = (causal ? min(r0 + 1, S) : S) - cq;
    const int key_hi1 = (causal ? min(r0 + 9, S) : S) - cq;
    const int my_turn = kTurnBar + g, next_turn = kTurnBar + 1 - g;
    const uint64_t dq = sw128_desc(sQ + g * 64 * kRow, 16, 8 * kRow);

    float acc[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
    float sc[64];
    uint32_t pa[32];  // P's wgmma A fragments, at D = 64
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
    float corr0 = 1.f, corr1 = 1.f;

    // tile i's softmax; only tiles that cut a mask or S pay for the mask
    auto softmax = [&](int i) {
      const int k0 = (t_lo + i) * kWsTileK;
      const bool whole = k0 + kWsTileK <= S &&
                         (!causal || k0 + kWsTileK - 1 <= g_first) &&
                         (window <= 0 || g_last - k0 < window);
      // one branch a tile: the mask's tests stay out of whole tiles
      if (whole)
        ws_softmax<false>(sc, 0, 0, 0, 0, scale_log2, m0, m1, l0, l1, corr0,
                          corr1);
      else
        ws_softmax<true>(sc, key_lo0 - k0, key_hi0 - k0, key_lo1 - k0,
                         key_hi1 - k0, scale_log2, m0, m1, l0, l1, corr0,
                         corr1);
    };
    // P in bf16 for the next P.V.  In k16 slice kk, chunks 2kk and 2kk+1
    // of S's accumulator are wgmma's register A fragment: four 8x8 blocks
    // in mma's fragment layout (rows 0-7 and 8-15 of this warp's 16, keys
    // 16kk.. and 16kk+8..).  At D = 128 stmatrix stores them into this
    // warpgroup's P tile, K-major in the 128-byte swizzle wgmma reads
    // (16-byte chunk c of row r at c ^ (r % 8); lane l addresses row l % 8
    // of block l / 8), read once all four warps have written it.
    const int blk = lane / 8;
    const uint32_t p_row = sP + g * L::kPBytes +
                           (16 * (tid / 32) + 8 * (blk & 1) + lane % 8) * kRow;
    auto store_p = [&]() {
#pragma unroll
      for (int r = 0; r < 32; ++r) pa[r] = pack_bf16(sc[2 * r], sc[2 * r + 1]);
      if constexpr (L::kPSmem) {
#pragma unroll
        for (int kk = 0; kk < kWsTileK / 16; ++kk) {
          const int c = (kk % 4) * 2 + (blk >> 1);
          stmatrix_x4(p_row + (kk / 4) * 64 * kRow + ((c ^ (lane % 8)) << 4),
                      pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                      pa[4 * kk + 3]);
        }
        fence_proxy_async();
        warpgroup_sync(kPBar + g);
      }
    };
    const uint64_t dp = sw128_desc(sP + g * L::kPBytes, 16, 8 * kRow);
    // P's registers are wgmma operands only at D = 64
    auto fence_p = [&]() {
      if constexpr (!L::kPSmem) fence_regs(pa);
    };
    // O's rows at the new max: skipped by a warp whose rows' max held
    auto rescale = [&]() {
      if (!__any_sync(0xffffffffu, corr0 != 1.f || corr1 != 1.f)) return;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j + 0] *= corr0;
        acc[4 * j + 1] *= corr0;
        acc[4 * j + 2] *= corr1;
        acc[4 * j + 3] *= corr1;
      }
    };
    auto k_desc = [&](int s) {
      return sw128_desc(sK + s * L::kKVBytes, 16, 8 * kRow);
    };
    auto v_desc = [&](int s) {
      return sw128_desc(sV + s * L::kKVBytes, kWsTileK * kRow, 8 * kRow);
    };

    if (g == 1) turn_pass(kTurnBar);  // consumer 0 issues first
    mbar_wait(bar_q, 0);

    // tile 0: S alone
    mbar_wait(full_k, 0);
    turn_wait(my_turn);
    wgmma_fence();
    ws_qk<D>(sc, dq, k_desc(0));
    wgmma_commit();
    turn_pass(next_turn);
    wgmma_wait<0>();
    fence_regs(sc);
    mbar_arrive(empty_k);
    softmax(0);
    store_p();

    for (int i = 1; i < n; ++i) {
      const int s = i % ST, sp = (i - 1) % ST;
      mbar_wait(full_k + 8 * s, (i / ST) & 1);
      turn_wait(my_turn);
      wgmma_fence();
      ws_qk<D>(sc, dq, k_desc(s));
      wgmma_commit();
      fence_regs(acc);  // rescale after the issue, under S's wgmmas
      rescale();
      mbar_wait(full_v + 8 * sp, ((i - 1) / ST) & 1);
      fence_p();
      wgmma_fence();
      ws_pv<D>(acc, pa, dp, v_desc(sp));
      wgmma_commit();
      turn_pass(next_turn);
      wgmma_wait<1>();  // S of tile i; P.V of tile i-1 runs on
      fence_regs(sc);
      mbar_arrive(empty_k + 8 * s);
      softmax(i);
      wgmma_wait<0>();  // P.V of tile i-1 is done with P
      fence_regs(acc);
      fence_p();
      mbar_arrive(empty_v + 8 * sp);
      store_p();
    }

    // the last tile's P.V
    const int sl = (n - 1) % ST;
    rescale();
    mbar_wait(full_v + 8 * sl, ((n - 1) / ST) & 1);
    turn_wait(my_turn);
    fence_p();
    wgmma_fence();
    ws_pv<D>(acc, pa, dp, v_desc(sl));
    wgmma_commit();
    turn_pass(next_turn);
    wgmma_wait<0>();
    fence_regs(acc);

#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / fmaxf(l0, 1e-30f);
    const float inv1 = 1.f / fmaxf(l1, 1e-30f);
    if (kLse) store_lse(lse, bh, S, r0, lane, m0, l0, m1, l1);
    __nv_bfloat16* o0 = o + (static_cast<size_t>(bh) * S + r0) * D + cq;
    __nv_bfloat16* o1 = o0 + 8 * static_cast<size_t>(D);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (r0 < S)
        *reinterpret_cast<uint32_t*>(o0 + 8 * j) =
            pack_bf16(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
      if (r0 + 8 < S)
        *reinterpret_cast<uint32_t*>(o1 + 8 * j) =
            pack_bf16(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
    }
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

// D = 64 and 128 take flash_fwd_bf16_ws, D = 256 flash_fwd_bf16
template <int D, bool kLse>
constexpr auto bf16_kernel() {
  if constexpr (D <= 128)
    return flash_fwd_bf16_ws<D, kLse>;
  else
    return flash_fwd_bf16<D, kLse>;
}

template <int D, bool kLse>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int H, int Hkv, int S, int causal,
                int window, float scale, cudaStream_t stream) {
  static const EncodeTiled encode = lookup_encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return cudaErrorMisalignedAddress;  // TMA reads from 16-byte bases
  constexpr bool ws = D <= 128;
  constexpr int tile_k = ws ? kWsTileK : kTileK;
  constexpr int smem = ws ? WsLayout<D>::kAlloc : Layout<D>::kAlloc;
  constexpr int threads = ws ? kWsThreads : kThreadsBf16;
  CUtensorMap qm, km, vm;
  if (!encode_map(encode, &qm, q, D, S, B * H, kTileQ) ||
      !encode_map(encode, &km, k, D, S, B * Hkv, tile_k) ||
      !encode_map(encode, &vm, v, D, S, B * Hkv, tile_k))
    return cudaErrorInvalidValue;
  const auto kernel = bf16_kernel<D, kLse>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kTileQ - 1) / kTileQ, B * H);
  kernel<<<grid, threads, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), lse, H, Hkv, S, causal,
      window, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kLse>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Hkv, int S, int is_bf16, int causal, int window,
           float scale, cudaStream_t stream) {
  return is_bf16 ? launch_bf16<D, kLse>(q, k, v, o, lse, B, H, Hkv, S,
                                        causal, window, scale, stream)
                 : launch_f32<D, kLse>(q, k, v, o, lse, B, H, Hkv, S, causal,
                                       window, scale, stream);
}

template <bool kLse>
int launch_any(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int H, int Hkv, int S, int D, int is_bf16,
               int causal, int window, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || S <= 0 || H % Hkv != 0 ||
      B * H > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64, kLse>(q, k, v, o, lse, B, H, Hkv, S, is_bf16, causal,
                              window, scale, st);
    case 128:
      return launch<128, kLse>(q, k, v, o, lse, B, H, Hkv, S, is_bf16,
                               causal, window, scale, st);
    case 256:
      return launch<256, kLse>(q, k, v, o, lse, B, H, Hkv, S, is_bf16,
                               causal, window, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
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
  return launch_any<false>(q, k, v, o, nullptr, B, H, Hkv, S, D, is_bf16,
                           causal, window, scale, stream);
}

// the same, also writing lse (B,H,S) float32: each row's logsumexp of its
// masked, scaled scores, in natural-log units (the training forward's)
int flash_attention_lse_launch(const void* q, const void* k, const void* v,
                               void* o, float* lse, int B, int H, int Hkv,
                               int S, int D, int is_bf16, int causal,
                               int window, float scale, void* stream) {
  if (lse == nullptr) return cudaErrorInvalidValue;
  return launch_any<true>(q, k, v, o, lse, B, H, Hkv, S, D, is_bf16, causal,
                          window, scale, stream);
}

const char* flash_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
