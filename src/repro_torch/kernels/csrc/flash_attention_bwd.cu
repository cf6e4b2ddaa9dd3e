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
// No atomics, and every sum in a fixed order, so two calls on the same
// inputs give the same bits (the sharded and elastic training paths compare
// runs bit for bit).  dQ sums over key tiles and dK, dV over q tiles and
// the group's q heads; each of those sums runs inside one block, or, where
// a group's q heads are split over blocks, in a fourth pass that adds the
// blocks' partials in head order.  The price is that S and dP are computed
// twice, once in the dK/dV pass and once in the dQ pass: 14*D operations a
// pair, 1.4x the bound's count.
//
// bfloat16 (the training path), four launches on the caller's stream:
//   1. bwd_rowstats_bf16: delta = rowsum(dO o O) and lse * log2(e), float32
//      (B*H, S_pad) with S padded to a multiple of 128 and zeros past S, so
//      that a 64-row tile of either is one aligned bulk copy; 16-byte loads,
//      D/8 lanes a row.
//   2. flash_bwd_bf16_dkdv: a block per (key tile, batch and kv head, part
//      of the group's q heads).  k and v stay in shared memory; q, dO and
//      the two row statistics stream through a ring of 64-row stages, one
//      stage per (q head, q tile that sees these keys), fully masked tiles
//      never loaded.  Per stage a warpgroup computes S^T = K Q^T and
//      dP^T = V dO^T (wgmma, both operands in shared memory), so that each
//      thread holds key rows and q columns: P^T = exp2(S^T scale log2e -
//      lse log2e) and dS^T = P^T o (dP^T - delta) come out of the
//      accumulators already in wgmma's register A layout and go to bf16
//      there, and dV += P^T dO and dK += dS^T Q read only dO and Q from
//      shared memory (the transpose bit: the contraction runs over their
//      rows; one m64n128 wgmma a pair of 64-column slabs).  P and dS never
//      pass through shared memory.  A software pipeline: a stage's S^T and
//      dP^T are issued while the last stage's dV and dK still run, and dV
//      is issued as soon as P^T is in registers, to run while dS^T is
//      computed.  At D <= 128 the block owns 128 keys, 64 a warpgroup, and
//      each warpgroup holds dK and dV for all of D (D float32 registers a
//      thread); at D = 128 the two warpgroups take turns to issue S^T and
//      dP^T (named barriers), so that one's exp2 work runs under the
//      other's wgmmas.  At D = 256 that would be 256 registers, so the
//      block owns 64 keys: both warpgroups compute the same S^T and dP^T
//      and each holds dK and dV for 128 columns (the S^T and dP^T products
//      run twice there).  Key tiles go longest first (low keys see the most
//      q rows).  Where the batch's kv
//      heads and key tiles give fewer blocks than the card has SMs (the
//      griffin model: 10 q heads over 1 kv head), the wrapper splits each
//      group's q heads over up to G blocks, and each block writes float32
//      partial dK and dV into scratch.
//   3. flash_bwd_bf16_dq: a block per (batch and q head, 128-row q tile),
//      64 rows a warpgroup, the longest tiles first.  q and dO stay, k and
//      v stream through the ring (64 keys a stage; 128 at D = 64, S and dP
//      then one m64n128 wgmma a k16 step; 32 at D = 256, whose q and dO
//      take 128 KB); S = Q K^T and dP = dO V^T as above, and dQ += dS K
//      with dS in registers.  The warpgroups take turns to issue S and dP;
//      at D = 256 a stage's S and dP are also issued while the last
//      stage's dQ runs.
//   4. bwd_reduce_dkv, where the heads were split: sums the partials in
//      head order, times scale for dK, into bf16.
// Rounding P and dS to bf16 for the second products is where the bf16
// error comes from.
//
// Each of these choices (the pipelines, the turns, the slab pairs, the
// stage widths) stands where it measured faster on the H100, per head dim
// (PERF.md).
//
// The bf16 kernels: 256 threads, two consumer warpgroups; loads by TMA
// (3-D tensor maps over (D, S, heads): a box never reads across a head,
// rows past S arrive as zeros and are masked) with 128-byte swizzle, the
// row statistics by bulk copy, each ring stage with a full and an empty
// mbarrier.  Thread 0 is the producer: it loads the resident tiles and the
// first ring stages, then in each of its tiles refills the stage that
// both warpgroups released a tile or two earlier, so a stage lands one
// tile (or more) before it is read.  A separate producer warp would be a
// ninth warp, three on one of the SM's four register files, which caps
// every thread at 168 registers (setmaxnreg moved none with this
// toolchain, as flash_attention.cu records); the dK/dV pass needs ~200 at
// D = 128 (dK and dV 128, S^T and dP^T 64).
// The context is bound once per thread and the shared-memory opt-in set
// once per device, because the tensor-map encode fails on a thread that
// has no context bound (autograd's device thread).
//
// float32 stays on the CUDA cores (TF32 would break float32's bars), three
// launches: bwd_delta (a warp a row), then the dK/dV and dQ passes of 32 x
// 32 tiles staged in shared memory by cp.async, a 2 x 2 micro-tile of S and
// dP a thread, float4 reads of rows padded by 16 bytes.  Rows past S are
// loaded as zeros and masked.
#include <cuda.h>  // CUtensorMap and its enums: types only, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float to_f32(float x) { return x; }

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
// bfloat16: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int kSlab = 64;  // bf16 values per 128-byte swizzled row
constexpr int kRow = 128;  // bytes per swizzled row
constexpr int kPad = 128;  // the row statistics' S is padded to this

// Tile sizes and shared-memory layouts of the two bf16 passes (bytes from
// a 1024-byte-aligned base; a D-wide tile of R rows is D/64 slabs of R
// swizzled 128-byte rows, slab c at c * R * 128)
template <int D>
struct Cfg {
  // dK/dV pass.  At D = 256 both warpgroups own the block's 64 keys and
  // warpgroup g holds dK and dV columns 128g ..; below, warpgroup g owns
  // keys 64g .. of the block's 128 and holds all of D
  static constexpr bool kSplitD = D == 256;
  static constexpr int kKeys = kSplitD ? 64 : 128;
  static constexpr int kSlabsHeld = (kSplitD ? D / 2 : D) / kSlab;
  static constexpr int kBQ = 64;  // q rows a ring stage
  static constexpr int kStA = D == 256 ? 2 : 4;
  // dV and dK over pairs of 64-column slabs, one m64n128 wgmma each
  static constexpr bool kPairsA = kSlabsHeld % 2 == 0;
  // the warpgroups take turns to issue S^T and dP^T (see turn_wait)
  static constexpr bool kTurnsA = D == 128;
  static constexpr int kTileA = kKeys * D * 2;  // k (or v), resident
  static constexpr int kStageQ = kBQ * D * 2;   // q (or dO), a stage
  static constexpr int kStatBytes = 2 * kBQ * 4;  // lse2 then delta
  static constexpr int kA_K = 0;
  static constexpr int kA_V = kA_K + kTileA;
  static constexpr int kA_Q = kA_V + kTileA;
  static constexpr int kA_dO = kA_Q + kStA * kStageQ;
  static constexpr int kA_Stat = kA_dO + kStA * kStageQ;
  // barriers: kv, full[], empty[]
  static constexpr int kA_Bar = kA_Stat + kStA * kStatBytes;
  static constexpr int kA_Alloc = kA_Bar + 8 * (1 + 2 * kStA) + 1024;
  // dQ pass: 128 q rows a block, 64 a warpgroup; kBK keys a ring stage
  // (also the k and v maps' box rows)
  static constexpr int kRows = 128;
  static constexpr int kBK = D == 256 ? 32 : D == 64 ? 128 : 64;
  static constexpr int kStB = D == 256 ? 3 : 4;
  // tile i's S and dP issued while tile i-1's dQ runs
  static constexpr bool kPipeB = D == 256;
  static constexpr int kTileB = kRows * D * 2;  // q (or dO), resident
  static constexpr int kStageK = kBK * D * 2;   // k (or v), a stage
  static constexpr int kB_Q = 0;
  static constexpr int kB_dO = kB_Q + kTileB;
  static constexpr int kB_K = kB_dO + kTileB;
  static constexpr int kB_V = kB_K + kStB * kStageK;
  static constexpr int kB_Bar = kB_V + kStB * kStageK;  // q, full[], empty[]
  static constexpr int kB_Alloc = kB_Bar + 8 * (1 + 2 * kStB) + 1024;
  static_assert(kA_Alloc <= 232448 && kB_Alloc <= 232448,
                "a block's shared memory");
};

// In tile i, once its warpgroup has released the last tile's stage, the
// producer refills the stage of tile i + ST - LAG, released by tile i -
// LAG: two tiles back where the ring has 3 or more stages, so that it
// seldom waits on the other warpgroup's last tile.
template <int ST>
constexpr int kLag = ST >= 3 ? 2 : 1;

struct BwdMaps {
  CUtensorMap q, dout, k, v;
};

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

// spin until the barrier's completion of this parity (completion n,
// 0-based, has parity n & 1); a wait of ~2^26 polls (seconds) can only be
// a deadlock, and traps so that the launch fails instead of hanging
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

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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

// bytes (a multiple of 16) from a 16-byte-aligned global address
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
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
template <int M, int N>
__device__ __forceinline__ void fence_regs(float (&d)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i) fence_regs(d[i]);
}

#define WG_ACC16                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define WG_OUT16(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
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
// compiler does not hoist every step's descriptor into registers beside
// the accumulators.
#define WG_ADD_OFFSET(out, desc, off)      \
  "mov.b64 {wlo, whi}, " desc ";\n"        \
  "add.u32 wlo, wlo, " off ";\n"           \
  "mov.b64 " out ", {wlo, whi};\n"

// d (64 x N f32) (+)= A (64 x 16, shared, K-major) . B (N x 16, shared,
// K-major)^T, N = 64, 32 or (below) 128
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
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint32_t off_a, uint64_t db,
                                         uint32_t off_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .b32 wlo, whi;\n"
      ".reg .b64 wda, wdb;\n"
      "setp.ne.b32 p, %20, 0;\n"
      WG_ADD_OFFSET("wda", "%16", "%17")
      WG_ADD_OFFSET("wdb", "%18", "%19")
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " WG_ACC16
      ", wda, wdb, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_OUT16(d)
      : "l"(da), "r"(off_a), "l"(db), "r"(off_b), "r"(accumulate));
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

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
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
      ", wda, wdb, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_OUT64(d)
      : "l"(da), "r"(off_a), "l"(db), "r"(off_b), "r"(accumulate));
}

// d (64 x 128 f32) += A (64 x 16 bf16, registers) . B (16 x 128, shared,
// N-major: its two 64-column slabs the descriptor's leading offset apart)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t db, uint32_t off_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .b32 wlo, whi;\n"
      ".reg .b64 wdb;\n"
      "setp.ne.b32 p, %70, 0;\n"
      WG_ADD_OFFSET("wdb", "%68", "%69")
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_ACC64
      ", {%64, %65, %66, %67}, wdb, p, 1, 1, 1;\n"
      "}\n"
      : WG_OUT64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(off_b),
        "r"(1));
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

// acc (NC 64-column slabs of 32 f32) += A (64 x 16, registers) . B (16 x
// 64 NC, shared, N-major, slab c at c * slab_bytes from off): one m64n128
// a pair of slabs where kPairs (the descriptor's leading offset is then
// the slab stride), else one m64n64 a slab
template <bool kPairs, int NC>
__device__ __forceinline__ void wgmma_rs_slabs(float (&acc)[NC][32],
                                               const uint32_t* a,
                                               uint64_t db, uint32_t off,
                                               uint32_t slab_bytes) {
  if constexpr (kPairs) {
#pragma unroll
    for (int c = 0; c < NC; c += 2)
      wgmma_rs(*reinterpret_cast<float(*)[64]>(&acc[c][0]), a, db,
               off + ((c * slab_bytes) >> 4));
  } else {
#pragma unroll
    for (int c = 0; c < NC; ++c)
      wgmma_rs(acc[c], a, db, off + ((c * slab_bytes) >> 4));
  }
}

// Where kOn, the two consumer warpgroups take turns to issue their score
// products (named barriers 1 and 2, 256 threads: 128 arrive, 128 wait):
// warpgroup g waits on 1 + g before its S and dP and passes the turn on at
// 2 - g after them, so that one's exp2 work runs under the other's wgmmas
template <bool kOn>
__device__ __forceinline__ void turn_wait(int g) {
  if (kOn) asm volatile("bar.sync %0, 256;\n" ::"r"(1 + g) : "memory");
}
template <bool kOn>
__device__ __forceinline__ void turn_pass(int g) {
  if (kOn) asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - g) : "memory");
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

// In wgmma's accumulator layout thread (warp w, lane l) of a warpgroup
// holds rows 16w + l/4 and 16w + l/4 + 8, and in each 8-column chunk j the
// columns 8j + 2(l%4) and 8j + 2(l%4) + 1: d[4j + e] is row + 8 (e >> 1),
// column 8j + 2(l%4) + (e & 1).  In k16 slice kk the chunks 2kk and 2kk+1
// are wgmma's register A fragment, so a[r] = bf16 pair (d[2r], d[2r+1]).
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 2],
                                       const float (&d)[N]) {
#pragma unroll
  for (int r = 0; r < N / 2; ++r) a[r] = pack_bf16(d[2 * r], d[2 * r + 1]);
}

// d (64 x N, N = 2 * NA) = A (64 x D, K-major at rows) . B (N x D, K-major)^T
// over D/16 k16 steps; A's slabs lie a_rows * 128 bytes apart, B's b_rows
template <int D, int NA>
__device__ __forceinline__ void wgmma_dot(float (&d)[NA], uint64_t da,
                                          int a_rows, uint64_t db,
                                          int b_rows) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)  // slab kk / 4, 32-byte step kk % 4
    wgmma_ss(d, da, ((kk / 4) * a_rows * kRow + (kk % 4) * 32) >> 4, db,
             ((kk / 4) * b_rows * kRow + (kk % 4) * 32) >> 4, kk > 0);
}

// one 64-row box a slab for each of rows [row0, row0 + ROWS) of a (D, S,
// heads) map, into a tile of ROWS rows
template <int D, int ROWS, int BOX>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int row0, int head) {
#pragma unroll
  for (int c = 0; c < D / kSlab; ++c)
#pragma unroll
    for (int r = 0; r < ROWS; r += BOX)
      tma_load_3d(dst + (c * ROWS + r) * kRow, map, bar, c * kSlab, row0 + r,
                  head);
}

// lse * log2(e) and delta = rowsum(dO o O) of every padded row, 0 past S:
// D/8 lanes a row, one 16-byte load of o and of dO each
template <int D>
__global__ void __launch_bounds__(kThreads)
    bwd_rowstats_bf16(const __nv_bfloat16* __restrict__ o,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse,
                      float* __restrict__ lse2, float* __restrict__ delta,
                      int S, int S_pad, int rows_pad) {
  constexpr int L = D / 8;  // lanes a row
  const int lane = threadIdx.x % 32;
  const int row = (blockIdx.x * kThreads + threadIdx.x) / L;
  const bool in = row < rows_pad;
  const int bh = row / S_pad, q = row % S_pad;
  const bool live = in && q < S;
  float acc = 0.f;
  if (live) {
    const size_t at = (static_cast<size_t>(bh) * S + q) * D + 8 * (lane % L);
    const uint4 a = *reinterpret_cast<const uint4*>(o + at);
    const uint4 b = *reinterpret_cast<const uint4*>(dout + at);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(a2[i]), y = __bfloat1622float2(b2[i]);
      acc += x.x * y.x;
      acc += x.y * y.y;
    }
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (in && lane % L == 0) {
    delta[row] = acc;
    lse2[row] = live ? lse[static_cast<size_t>(bh) * S + q] * kLog2e : 0.f;
  }
}

// dK and dV of one key tile (see the header).  Grid: x = (batch * Hkv + kv
// head) * split + part, y = key tile, key tile 0 first.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_bf16_dkdv(const __grid_constant__ BwdMaps maps,
                        const float* __restrict__ lse2,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv,
                        float* __restrict__ part, int H, int Hkv, int S,
                        int S_pad, int split, int causal, int window,
                        float scale) {
  using C = Cfg<D>;
  constexpr int ST = C::kStA, BQ = C::kBQ, NK = C::kKeys;
  constexpr int NC = C::kSlabsHeld;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const float* stat =
      reinterpret_cast<const float*>(smem_raw + (base - raw) + C::kA_Stat);
  const uint32_t sK = base + C::kA_K, sV = base + C::kA_V;
  const uint32_t sQ = base + C::kA_Q, sdO = base + C::kA_dO;
  const uint32_t sStat = base + C::kA_Stat;
  const uint32_t bar_kv = base + C::kA_Bar;
  const uint32_t full = bar_kv + 8;       // + 8 * stage
  const uint32_t empty = full + 8 * ST;  // + 8 * stage

  const int bkv = blockIdx.x / split, pj = blockIdx.x % split;
  const int b = bkv / Hkv, kvh = bkv % Hkv;
  const int G = H / Hkv;
  const int h_lo = pj * G / split, h_hi = (pj + 1) * G / split;
  const int k0 = blockIdx.y * NK;
  int t_lo, t_hi;
  query_tiles(k0, NK, BQ, S, causal, window, t_lo, t_hi);
  const int nt = t_hi - t_lo;
  const int n = nt * (h_hi - h_lo);  // tile i: head h_lo + i / nt, q tile
                                     // t_lo + i % nt

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const bool producer = threadIdx.x == 0;
  const BwdMaps* mp = &maps;
  // q and dO of tile i, with its rows' lse2 and delta, into stage i % ST
  auto load = [&](int i) {
    const int s = i % ST;
    const int bh = b * H + kvh * G + h_lo + i / nt;
    const int q0 = (t_lo + i % nt) * BQ;
    const uint32_t f = full + 8 * s;
    mbar_expect_tx(f, 2 * C::kStageQ + C::kStatBytes);
    tma_tile<D, BQ, 64>(sQ + s * C::kStageQ, &mp->q, f, q0, bh);
    tma_tile<D, BQ, 64>(sdO + s * C::kStageQ, &mp->dout, f, q0, bh);
    const size_t at = static_cast<size_t>(bh) * S_pad + q0;
    bulk_load(sStat + s * C::kStatBytes, lse2 + at, BQ * 4, f);
    bulk_load(sStat + s * C::kStatBytes + BQ * 4, delta + at, BQ * 4, f);
  };
  if (producer) {
    mbar_expect_tx(bar_kv, 2 * C::kTileA);
    tma_tile<D, NK, C::kBK>(sK, &mp->k, bar_kv, k0, bkv);
    tma_tile<D, NK, C::kBK>(sV, &mp->v, bar_kv, k0, bkv);
    for (int i = 0; i < min(n, ST); ++i) load(i);
  }

  const int g = threadIdx.x / 128;
  const int tid = threadIdx.x % 128, lane = tid % 32;
  const int kw = k0 + (C::kSplitD ? 0 : 64 * g);  // this warpgroup's keys
  const int c_lo = C::kSplitD ? g * NC : 0;       // its first slab of D
  // this thread's keys kr and kr + 8, and its q columns cq, cq + 1 of
  // every 8-column chunk.  Key k sees q in [lo, hi): causal from k, a
  // window up to k + window, nothing for a key past S; shifted by cq
  const int kr = kw + 16 * (tid / 32) + lane / 4;
  const int cq = 2 * (lane % 4);
  constexpr int kFar = 1 << 30;
  const int lo0 = (causal ? kr : -kFar) - cq;
  const int lo1 = (causal ? kr + 8 : -kFar) - cq;
  const int hi0 =
      (kr < S ? (window > 0 ? min(S, kr + window) : S) : -kFar) - cq;
  const int hi1 =
      (kr + 8 < S ? (window > 0 ? min(S, kr + 8 + window) : S) : -kFar) -
      cq;
  const float scale_log2 = scale * kLog2e;

  float ak[NC][32], av[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) ak[c][e] = av[c][e] = 0.f;
  // S^T's and dP^T's A operand: this warpgroup's 64 rows of K and of V
  const uint64_t dk_a = sw128_desc(sK + (kw - k0) * kRow, 16, 8 * kRow);
  const uint64_t dv_a = sw128_desc(sV + (kw - k0) * kRow, 16, 8 * kRow);

  // A software pipeline: tile i's S^T and dP^T are issued while tile
  // i-1's dV and dK still run, then tile i's dV is issued as soon as P^T
  // is in registers, and runs while dS^T is computed.  Groups in flight
  // at the top of tile i: dV(i-1), dK(i-1); the stage of tile i-1 is
  // released once both are done.
  float sc[32], dp[32];
  uint32_t pa[16], da[16];
  if (g == 1) turn_pass<C::kTurnsA>(0);  // warpgroup 0 issues first
  mbar_wait(bar_kv, 0);
  for (int i = 0; i < n; ++i) {
    const int s = i % ST;
    const int q0 = (t_lo + i % nt) * BQ;
    const uint32_t qs = sQ + s * C::kStageQ, os = sdO + s * C::kStageQ;
    mbar_wait(full + 8 * s, (i / ST) & 1);

    // S^T = K Q^T and dP^T = V dO^T, 64 keys x 64 q rows, a group each
    turn_wait<C::kTurnsA>(g);
    wgmma_fence();
    wgmma_dot<D>(sc, dk_a, NK, sw128_desc(qs, 16, 8 * kRow), BQ);
    wgmma_commit();
    wgmma_dot<D>(dp, dv_a, NK, sw128_desc(os, 16, 8 * kRow), BQ);
    wgmma_commit();
    turn_pass<C::kTurnsA>(g);
    if (i > 0) {
      wgmma_wait<2>();  // dV and dK of tile i-1
      fence_regs(ak);
      fence_regs(av);
      fence_regs(pa);
      fence_regs(da);
      mbar_arrive(empty + 8 * ((i - 1) % ST));
    }
    if (producer) {
      const int j = i - kLag<ST> + ST;
      if (i >= kLag<ST> && j < n) {
        mbar_wait(empty + 8 * (j % ST), (j / ST + 1) & 1);
        load(j);
      }
    }
    __syncwarp();
    wgmma_wait<1>();
    fence_regs(sc);

    // P^T = exp2(S^T scale log2e - lse2[q]), 0 where masked; only tiles
    // that cut a mask or S pay for the mask
    const float* st_lse = stat + s * 2 * BQ;
    const float* st_delta = st_lse + BQ;
    const bool whole = whole_tile(q0, BQ, kw, 64, S, causal, window);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(st_lse + 8 * j + cq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = fast_exp2(fmaf(sc[4 * j + e], scale_log2,
                                 -((e & 1) ? l2.y : l2.x)));
        if (!whole) {
          const int c = 8 * j + (e & 1) + q0;
          const bool ok = e < 2 ? (c >= lo0 && c < hi0) : (c >= lo1 && c < hi1);
          p = ok ? p : 0.f;
        }
        sc[4 * j + e] = p;
      }
    }
    pack_a<32>(pa, sc);

    // dV += P^T dO over the stage's 64 q rows: dO read N-major (its rows
    // are the contraction), one 64-column slab a wgmma
    fence_regs(av);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rs_slabs<C::kPairsA>(
          av, pa + 4 * kk, sw128_desc(os, BQ * kRow, 8 * kRow),
          (c_lo * BQ * kRow + kk * 16 * kRow) >> 4, BQ * kRow);
    wgmma_commit();
    wgmma_wait<1>();  // dP^T; dV runs on
    fence_regs(dp);

    // dS^T = P^T o (dP^T - delta[q]), then dK += dS^T Q likewise
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 d2 =
          *reinterpret_cast<const float2*>(st_delta + 8 * j + cq);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * j + e] =
            sc[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? d2.y : d2.x));
    }
    pack_a<32>(da, dp);
    fence_regs(ak);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rs_slabs<C::kPairsA>(
          ak, da + 4 * kk, sw128_desc(qs, BQ * kRow, 8 * kRow),
          (c_lo * BQ * kRow + kk * 16 * kRow) >> 4, BQ * kRow);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(ak);
  fence_regs(av);

  // rows kr and kr + 8 past S are not written; dK times scale
  const size_t bhkv_rows = static_cast<size_t>(bkv) * S;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = kr + 8 * h;
    if (key >= S) continue;
    const size_t row = (bhkv_rows + key) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const size_t at = row + (c_lo + c) * kSlab + 8 * j + cq;
        const float k0v = ak[c][4 * j + 2 * h], k1v = ak[c][4 * j + 2 * h + 1];
        const float v0v = av[c][4 * j + 2 * h], v1v = av[c][4 * j + 2 * h + 1];
        if (split == 1) {
          *reinterpret_cast<uint32_t*>(dk + at) =
              pack_bf16(k0v * scale, k1v * scale);
          *reinterpret_cast<uint32_t*>(dv + at) = pack_bf16(v0v, v1v);
        } else {
          // partials: dK of part pj at pj * n, dV at (split + pj) * n
          const size_t n_all = static_cast<size_t>(gridDim.x / split) * S * D;
          *reinterpret_cast<float2*>(part + pj * n_all + at) =
              make_float2(k0v, k1v);
          *reinterpret_cast<float2*>(part + (split + pj) * n_all + at) =
              make_float2(v0v, v1v);
        }
      }
  }
}

// dQ of one 128-row q tile (see the header).  Grid: x = batch * H + q
// head, y = q tile, the last tile (the most keys) first.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_bf16_dq(const __grid_constant__ BwdMaps maps,
                      const float* __restrict__ lse2,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dq, int H, int Hkv, int S,
                      int S_pad, int causal, int window, float scale) {
  using C = Cfg<D>;
  constexpr int ST = C::kStB, BK = C::kBK, NR = C::kRows;
  constexpr int NS = D / kSlab;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + C::kB_Q, sdO = base + C::kB_dO;
  const uint32_t sK = base + C::kB_K, sV = base + C::kB_V;
  const uint32_t bar_q = base + C::kB_Bar;
  const uint32_t full = bar_q + 8;       // + 8 * stage
  const uint32_t empty = full + 8 * ST;  // + 8 * stage

  const int bh = blockIdx.x, b = bh / H;
  const int kvh = b * Hkv + (bh % H) / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * NR;
  int t_lo, t_hi;
  key_tiles(q0, NR, BK, S, causal, window, t_lo, t_hi);
  const int n = t_hi - t_lo;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const bool producer = threadIdx.x == 0;
  const BwdMaps* mp = &maps;
  auto load = [&](int i) {  // k and v of key tile t_lo + i into its stage
    const int s = i % ST;
    const uint32_t f = full + 8 * s;
    mbar_expect_tx(f, 2 * C::kStageK);
    tma_tile<D, BK, BK>(sK + s * C::kStageK, &mp->k, f, (t_lo + i) * BK,
                        kvh);
    tma_tile<D, BK, BK>(sV + s * C::kStageK, &mp->v, f, (t_lo + i) * BK,
                        kvh);
  };
  if (producer) {
    mbar_expect_tx(bar_q, 2 * C::kTileB);
    tma_tile<D, NR, 64>(sQ, &mp->q, bar_q, q0, bh);
    tma_tile<D, NR, 64>(sdO, &mp->dout, bar_q, q0, bh);
    for (int i = 0; i < min(n, ST); ++i) load(i);
  }

  const int g = threadIdx.x / 128;
  const int tid = threadIdx.x % 128, lane = tid % 32;
  // this thread's q rows r0 and r0 + 8, its key columns cq, cq + 1 of
  // every 8-column chunk; row r sees keys [lo, hi), shifted by cq
  const int gq = q0 + 64 * g;
  const int r0 = gq + 16 * (tid / 32) + lane / 4;
  const int cq = 2 * (lane % 4);
  constexpr int kFar = 1 << 30;
  auto key_lo = [&](int r) {
    return (window > 0 ? r - window + 1 : -kFar) - cq;
  };
  auto key_hi = [&](int r) {
    return (r < S ? (causal ? min(r + 1, S) : S) : -kFar) - cq;
  };
  const int lo0 = key_lo(r0), lo1 = key_lo(r0 + 8);
  const int hi0 = key_hi(r0), hi1 = key_hi(r0 + 8);
  const size_t st = static_cast<size_t>(bh) * S_pad + r0;  // < S_pad rows
  const float l0 = lse2[st], l1 = lse2[st + 8];
  const float d0 = delta[st], d1 = delta[st + 8];
  const float scale_log2 = scale * kLog2e;

  float acc[NS][32];
#pragma unroll
  for (int c = 0; c < NS; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[c][e] = 0.f;
  const uint64_t dq_a = sw128_desc(sQ + 64 * g * kRow, 16, 8 * kRow);
  const uint64_t do_a = sw128_desc(sdO + 64 * g * kRow, 16, 8 * kRow);

  // A software pipeline: tile i's S and dP are issued while tile i-1's
  // dQ still runs; tile i-1's stage is released once that dQ is done
  constexpr bool kPipe = C::kPipeB;
  float sc[BK / 2], dp[BK / 2];
  uint32_t da[BK / 4];
  if (g == 1) turn_pass<true>(0);  // warpgroup 0 issues first
  mbar_wait(bar_q, 0);
  for (int i = 0; i < n; ++i) {
    const int s = i % ST;
    const int kt = (t_lo + i) * BK;
    const uint32_t ks = sK + s * C::kStageK, vs = sV + s * C::kStageK;
    mbar_wait(full + 8 * s, (i / ST) & 1);

    // S = Q K^T and dP = dO V^T, 64 q rows x BK keys, a group each
    turn_wait<true>(g);
    wgmma_fence();
    wgmma_dot<D>(sc, dq_a, NR, sw128_desc(ks, 16, 8 * kRow), BK);
    wgmma_commit();
    wgmma_dot<D>(dp, do_a, NR, sw128_desc(vs, 16, 8 * kRow), BK);
    wgmma_commit();
    turn_pass<true>(g);
    if (kPipe && i > 0) {
      wgmma_wait<2>();  // dQ of tile i-1
      fence_regs(acc);
      fence_regs(da);
      mbar_arrive(empty + 8 * ((i - 1) % ST));
    }
    if (producer) {
      const int j = i - kLag<ST> + ST;
      if (i >= kLag<ST> && j < n) {
        mbar_wait(empty + 8 * (j % ST), (j / ST + 1) & 1);
        load(j);
      }
    }
    __syncwarp();
    wgmma_wait<1>();
    fence_regs(sc);
    const bool whole = whole_tile(gq, 64, kt, BK, S, causal, window);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = fast_exp2(fmaf(sc[4 * j + e], scale_log2, e < 2 ? -l0 : -l1));
        if (!whole) {
          const int c = 8 * j + (e & 1) + kt;
          const bool ok = e < 2 ? (c >= lo0 && c < hi0) : (c >= lo1 && c < hi1);
          p = ok ? p : 0.f;
        }
        sc[4 * j + e] = p;
      }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - (e < 2 ? d0 : d1));
    pack_a<BK / 2>(da, dp);

    // dQ += dS K: K read N-major, one 64-column slab a wgmma
    fence_regs(acc);
    fence_regs(da);
    const uint64_t bk = sw128_desc(ks, BK * kRow, 8 * kRow);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs_slabs<false>(acc, da + 4 * kk, bk, (kk * 16 * kRow) >> 4,
                            BK * kRow);
    wgmma_commit();
    if (!kPipe) {
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(da);
      mbar_arrive(empty + 8 * s);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // rows past S are not written; dQ times scale
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= S) continue;
    __nv_bfloat16* out = dq + (static_cast<size_t>(bh) * S + r) * D + cq;
#pragma unroll
    for (int c = 0; c < NS; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(out + c * kSlab + 8 * j) =
            pack_bf16(acc[c][4 * j + 2 * h] * scale,
                      acc[c][4 * j + 2 * h + 1] * scale);
  }
}

// dK and dV from the split blocks' partials (n elements each): summed in
// part order, dK times scale, into bf16; four elements a thread
__global__ void __launch_bounds__(kThreads)
    bwd_reduce_dkv(const float* __restrict__ part, int split, size_t n4,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, float scale) {
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < 2 * n4; i += static_cast<size_t>(gridDim.x) * kThreads) {
    const bool is_v = i >= n4;
    const size_t e = is_v ? i - n4 : i;
    const float4* p =
        reinterpret_cast<const float4*>(part) + (is_v ? split : 0) * n4 + e;
    float4 a = p[0];
    for (int j = 1; j < split; ++j) {
      const float4 x = p[j * n4];
      a.x += x.x;
      a.y += x.y;
      a.z += x.z;
      a.w += x.w;
    }
    const float mul = is_v ? 1.f : scale;
    uint2 out;
    out.x = pack_bf16(a.x * mul, a.y * mul);
    out.y = pack_bf16(a.z * mul, a.w * mul);
    *reinterpret_cast<uint2*>((is_v ? dv : dk) + 4 * e) = out;
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

// float32: the dK/dV kernel, then the dQ kernel, over tiles of kF rows
template <typename Kernel>
int launch_f32_pair(Kernel kdq, Kernel kdkv, size_t smem, const float* q,
                    const float* k, const float* v, const float* dout,
                    const float* lse, const float* delta, float* dq,
                    float* dk, float* dv, int B, int H, int Hkv, int S,
                    int causal, int window, float scale,
                    cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kdkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (S + kF - 1) / kF;
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

// Per device, whether the bf16 kernels' dynamic shared memory is allowed
// (by head dim 64, 128, 256): the opt-in is set once, under the lock.  Per
// thread, whether it has bound a context: cuTensorMapEncodeTiled fails on a
// thread that has none, and autograd's device thread can reach this launch
// before any runtime call of its own that would bind one.
constexpr int kMaxDevices = 64;
std::mutex g_mu;
bool g_smem_allowed[kMaxDevices][3];
thread_local bool t_context_bound[kMaxDevices];

template <int D>
cudaError_t prepare_bf16_launch() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!t_context_bound[dev]) {
    err = cudaFree(nullptr);  // binds the device's primary context
    if (err != cudaSuccess) return err;
    t_context_bound[dev] = true;
  }
  const int d = D == 64 ? 0 : D == 128 ? 1 : 2;
  std::lock_guard<std::mutex> lock(g_mu);
  if (!g_smem_allowed[dev][d]) {
    err = cudaFuncSetAttribute(flash_bwd_bf16_dkdv<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Cfg<D>::kA_Alloc);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(flash_bwd_bf16_dq<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Cfg<D>::kB_Alloc);
    if (err != cudaSuccess) return err;
    g_smem_allowed[dev][d] = true;
  }
  return cudaSuccess;
}

int pad_rows(int S) { return (S + kPad - 1) / kPad * kPad; }

// float32 elements of scratch a launch needs: delta (B, H, S) in float32;
// in bf16 lse2 and delta (B*H, S_pad), then, where the heads are split,
// the partial dK and dV of every part (2 * split * B * Hkv * S * D)
long long scratch_floats(int B, int H, int Hkv, int S, int D, int is_bf16,
                         int head_split) {
  if (!is_bf16) return static_cast<long long>(B) * H * S;
  const long long stats = 2LL * B * H * pad_rows(S);
  const long long parts =
      head_split > 1 ? 2LL * head_split * B * Hkv * S * D : 0LL;
  return stats + parts;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* o,
                const float* lse, const void* dout, float* scratch, void* dq,
                void* dk, void* dv, int B, int H, int Hkv, int S, int causal,
                int window, float scale, int split, cudaStream_t stream) {
  using T = __nv_bfloat16;
  using C = Cfg<D>;
  if (reinterpret_cast<uintptr_t>(o) % 16 != 0)
    return cudaErrorMisalignedAddress;  // 16-byte loads of o and dO
  cudaError_t err = prepare_bf16_launch<D>();
  if (err != cudaSuccess) return err;
  static const EncodeTiled encode = lookup_encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  BwdMaps maps;
  if (!encode_map(encode, &maps.q, q, D, S, B * H, 64) ||
      !encode_map(encode, &maps.dout, dout, D, S, B * H, 64) ||
      !encode_map(encode, &maps.k, k, D, S, B * Hkv, C::kBK) ||
      !encode_map(encode, &maps.v, v, D, S, B * Hkv, C::kBK))
    return cudaErrorInvalidValue;
  const int S_pad = pad_rows(S);
  const int rows_pad = B * H * S_pad;
  float* lse2 = scratch;
  float* delta = lse2 + rows_pad;
  float* part = delta + rows_pad;
  const int stat_blocks = (rows_pad * (D / 8) + kThreads - 1) / kThreads;
  bwd_rowstats_bf16<D><<<stat_blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, lse2,
      delta, S, S_pad, rows_pad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_bf16_dkdv<D>
      <<<dim3(B * Hkv * split, (S + C::kKeys - 1) / C::kKeys), kThreads,
         C::kA_Alloc, stream>>>(maps, lse2, delta, static_cast<T*>(dk),
                                static_cast<T*>(dv), part, H, Hkv, S, S_pad,
                                split, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_bf16_dq<D>
      <<<dim3(B * H, (S + C::kRows - 1) / C::kRows), kThreads, C::kB_Alloc,
         stream>>>(maps, lse2, delta, static_cast<T*>(dq), H, Hkv, S, S_pad,
                   causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return err;
  const size_t n4 = static_cast<size_t>(B) * Hkv * S * D / 4;
  const int blocks = static_cast<int>(
      std::min<size_t>((2 * n4 + kThreads - 1) / kThreads, 4096));
  bwd_reduce_dkv<<<blocks, kThreads, 0, stream>>>(
      part, split, n4, static_cast<T*>(dk), static_cast<T*>(dv), scale);
  return cudaGetLastError();
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, const void* o,
             const float* lse, const void* dout, float* scratch, void* dq,
             void* dk, void* dv, int B, int H, int Hkv, int S, int is_bf16,
             int causal, int window, float scale, int split,
             cudaStream_t stream) {
  if (is_bf16)
    return launch_bf16<D>(q, k, v, o, lse, dout, scratch, dq, dk, dv, B, H,
                          Hkv, S, causal, window, scale, split, stream);
  const int rows = B * H * S;
  const dim3 dgrid((rows + kThreads / 32 - 1) / (kThreads / 32));
  bwd_delta<float><<<dgrid, kThreads, 0, stream>>>(
      static_cast<const float*>(o), static_cast<const float*>(dout), scratch,
      rows, D);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_f32_pair(
      flash_bwd_f32<D, true>, flash_bwd_f32<D, false>, F32Layout<D>::kBytes,
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      scratch, static_cast<float*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv), B, H, Hkv, S, causal, window, scale, stream);
}

}  // namespace

extern "C" {

// float32 elements of the scratch that flash_attention_bwd_launch needs
// for these sizes and this head split
long long flash_attention_bwd_scratch_floats(int B, int H, int Hkv, int S,
                                             int D, int is_bf16,
                                             int head_split) {
  return scratch_floats(B, H, Hkv, S, D, is_bf16, head_split);
}

// Gradients of o = attention(q, k, v) (flash_attention.cu) for upstream
// gradient dout: q, o, dout and dq (B,H,S,D), k, v, dk and dv (B,Hkv,S,D),
// all contiguous, of one type (bf16 when is_bf16, else f32) and 16-byte
// aligned; lse (B,H,S) float32 from flash_attention_lse_launch.  scratch:
// scratch_floats float32 elements, 16-byte aligned
// (flash_attention_bwd_scratch_floats gives the least).  D is 64, 128 or
// 256 and H a multiple of Hkv; window <= 0 means no window.  head_split
// (1 .. H / Hkv, bf16 only; 1 in float32) is the number of blocks over
// which each group's q heads are split in the dK/dV pass.  Returns
// cudaGetLastError() of the last launch, or the error that kept one from
// launching.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const float* lse,
                               const void* dout, float* scratch, void* dq,
                               void* dk, void* dv, int B, int H, int Hkv,
                               int S, int D, int is_bf16, int causal,
                               int window, int head_split,
                               long long scratch_floats_given, float scale,
                               void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || S <= 0 || H % Hkv != 0 ||
      B * H > 65535 || head_split < 1 || head_split > H / Hkv ||
      (!is_bf16 && head_split != 1) ||
      scratch_floats_given <
          scratch_floats(B, H, Hkv, S, D, is_bf16, head_split))
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
       reinterpret_cast<uintptr_t>(scratch)) %
          16 != 0)
    return cudaErrorMisalignedAddress;  // 16-byte cp.async and TMA copies
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_d<64>(q, k, v, o, lse, dout, scratch, dq, dk, dv, B, H,
                          Hkv, S, is_bf16, causal, window, scale, head_split,
                          st);
    case 128:
      return launch_d<128>(q, k, v, o, lse, dout, scratch, dq, dk, dv, B, H,
                           Hkv, S, is_bf16, causal, window, scale, head_split,
                           st);
    case 256:
      return launch_d<256>(q, k, v, o, lse, dout, scratch, dq, dk, dv, B, H,
                           Hkv, S, is_bf16, causal, window, scale, head_split,
                           st);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* flash_attention_bwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
