// The RG-LRU linear recurrence y_t = a_t * y_{t-1} + x_t on Hopper (sm_90a),
// float32, from a zero state.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rg_lru.py (_rg_lru_kernel,
// launched by rg_lru_pallas).  The port's griffin prefill calls it once per
// RG-LRU sublayer, on (B, S, W) gates and gated inputs, after folding the
// carried state into x[:, 0].
//
// Bound on the H100: bytes.  a and x are read once and y written once,
// 3*B*S*W*4 bytes: 500 MB at the serving shape (4, 4064, 2560), ~0.15 ms at
// 3.35 TB/s.  The operations (2 per element) are nothing beside it.
//
// Design: one thread per (b, w) column walks the whole sequence, so the
// state stays in a register and no pass across blocks is needed (the TPU
// kernel carried it in VMEM across sequential S blocks).  A block is one
// warp, 32 neighbouring columns (128 bytes a step), so the serving shape
// gives B*ceil(W/32) = 320 blocks over the 132 SMs.  Each block stages
// 64-step x 32-column tiles of a and x (16 KB a stage) through a 3-stage
// ring in shared memory with cp.async, 16-byte copies where the rows are
// whole and 16-byte aligned (4-byte copies on a ragged W edge), so two
// tiles (32 KB) are in flight while the warp walks the third.  Stores go
// straight from the walk, 128 coalesced bytes per warp and step.  Built
// with -fmad=false, each step is a separately rounded multiply and add, as
// the plain PyTorch loop computes it, so the two agree bit for bit.
//
// The backward (rg_lru_bwd_kernel) is the adjoint recurrence, run backward in
// time: with upstream gradient g, d_{S-1} = g_{S-1} and d_t = g_t +
// a_{t+1} * d_{t+1}; dx_t = d_t and da_t = d_t * y_{t-1} (y_{-1} = 0).  The
// TPU reference has no backward kernel (XLA differentiates its
// associative_scan); the port's plain route is a Python loop over S, so this
// kernel carries the training path.  Bound: bytes, g, a and y read once, dx
// and da written once, 5*B*S*W*4 bytes (210 MB, ~63 us at 3.35 TB/s for one
// training launch (1, 4096, 2560)).  Bit for bit with autograd through the
// plain loop, each column's chain stays one sequential walk (no chunked or
// associative form), so the only parallelism is the B*W columns: 2560 at
// the training shape, ~19 an SM.  The design makes that walk cheap and
// keeps the memory traffic off it:
//  - blocks of 16 columns (64-byte rows), so the training shape gives 160
//    blocks and every SM works (20 columns, 128 blocks, ran slower);
//  - two warps a block.  The memory warp's lane 0 loads 64-step x 16-column
//    boxes of g, of a shifted one step later and of y shifted one step
//    earlier by TMA into a 4-stage ring (48 KB, full mbarriers): while the
//    walker walks tile i, tiles i+1 and i+2 land and tile i-1's stores
//    drain.  Deeper rings (5, 6, 8 stages) ran slower on the H100 (PERF.md);
//    the tiles are aligned to the last step, so every box is whole and
//    TMA's zero fill gives a_S = 0 and y_{-1} = 0;
//  - the walker warp, one lane a column, only runs the chain: it reads g
//    and a a batch of 8 steps ahead into registers and writes d over g in
//    shared memory, issuing no global load or store.  Starting from d =
//    -0.0, the first step g + a_S * d = g + (-0.0) is g exactly, so no step
//    is special;
//  - the memory warp then writes da = d * y_prev over y_prev (one rounded
//    multiply), stores the d tile as dx and the da tile by TMA, and refills
//    the slot once those stores have read it.  TMA stores no box that
//    starts below step 0, so the first-in-time tile of an S that is not a
//    multiple of 64 goes out through the lanes' 4-byte stores.
// W % 4 != 0 or a base off 16 bytes (TMA needs 16-byte rows and bases) take
// the same kernel with the memory warp's lanes copying 4 bytes each by
// cp.async (zero-filled outside the tensor) and storing dx and da from
// shared memory.
#include <cuda.h>  // CUtensorMap and its enums: types only, no -lcuda
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kCols = 32;    // columns per block: one warp
constexpr int kSteps = 64;   // steps per staged tile
constexpr int kStages = 3;   // ring depth
constexpr int kChunks = kCols / 4;  // 16-byte chunks per tile row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// stage rows [row0, row0 + rows) of one array's block columns into dst
__device__ __forceinline__ void stage_rows(float (*dst)[kCols],
                                           const float* src, size_t col0,
                                           int row0, int rows, int W,
                                           bool whole, int lane,
                                           bool lane_ok) {
  if (whole) {
    for (int i = lane; i < rows * kChunks; i += kCols) {
      const int r = i / kChunks, c = 4 * (i % kChunks);
      cp_async16(&dst[r][c],
                 src + col0 + static_cast<size_t>(row0 + r) * W + c);
    }
  } else if (lane_ok) {
    for (int r = 0; r < rows; ++r)
      cp_async4(&dst[r][lane],
                src + col0 + static_cast<size_t>(row0 + r) * W + lane);
  }
}

__global__ void __launch_bounds__(kCols)
    rg_lru_kernel(const float* __restrict__ a, const float* __restrict__ x,
                  float* __restrict__ y, int S, int W, int aligned16) {
  __shared__ __align__(16) float sa[kStages][kSteps][kCols];
  __shared__ __align__(16) float sx[kStages][kSteps][kCols];
  const int lane = threadIdx.x;
  const int w0 = blockIdx.x * kCols;
  const bool lane_ok = w0 + lane < W;
  // whole 128-byte rows on 16-byte boundaries take 16-byte copies
  const bool whole = aligned16 && W % 4 == 0 && w0 + kCols <= W;
  const size_t col0 = static_cast<size_t>(blockIdx.y) * S * W + w0;
  const int n_tiles = (S + kSteps - 1) / kSteps;

  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) {
      const int rows = min(kSteps, S - i * kSteps);
      stage_rows(sa[i], a, col0, i * kSteps, rows, W, whole, lane, lane_ok);
      stage_rows(sx[i], x, col0, i * kSteps, rows, W, whole, lane, lane_ok);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  float h = 0.f;
  float* yp = y + col0 + lane;
  for (int tile = 0; tile < n_tiles; ++tile) {
    // this thread's copies of `tile` have landed; the barrier makes every
    // thread's visible and frees the slot walked last iteration
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
    __syncthreads();
    const int next = tile + kStages - 1;
    if (next < n_tiles) {
      const int t0 = next * kSteps, rows = min(kSteps, S - t0);
      stage_rows(sa[next % kStages], a, col0, t0, rows, W, whole, lane,
                 lane_ok);
      stage_rows(sx[next % kStages], x, col0, t0, rows, W, whole, lane,
                 lane_ok);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    if (!lane_ok) continue;
    const int slot = tile % kStages;
    const int t0 = tile * kSteps;
    const int rows = min(kSteps, S - t0);
    float* yt = yp + static_cast<size_t>(t0) * W;
#pragma unroll 16
    for (int r = 0; r < rows; ++r) {
      h = sa[slot][r][lane] * h + sx[slot][r][lane];
      yt[static_cast<size_t>(r) * W] = h;
    }
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

constexpr int kBwdCols = 16;     // columns per block
constexpr int kBwdSteps = 64;    // steps per tile
constexpr int kBwdStages = 4;    // ring depth
constexpr int kBwdBatch = 8;     // steps the walker reads ahead
constexpr int kBwdTile = kBwdSteps * kBwdCols;  // floats per array tile
constexpr int kBwdThreads = 64;  // the walker warp and the memory warp
// ring slot layout: [stage][g or d, a shifted +1, y shifted -1 or da][step]
// [column], then a full and a walked mbarrier per stage
constexpr size_t kBwdRing = sizeof(float) * kBwdStages * 3 * kBwdTile;
constexpr size_t kBwdSmem =
    kBwdRing + 2 * kBwdStages * sizeof(uint64_t) + 128;
static_assert(kBwdCols % 4 == 0 && kBwdCols <= 32,
              "TMA rows are whole 16-byte chunks; one walker lane a column");
static_assert(kBwdSteps % kBwdBatch == 0, "whole read-ahead batches");

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

// spin on a barrier phase; ~2^26 polls (seconds) can only be a deadlock, and
// trap so that the launch fails instead of hanging
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

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// one (columns, steps, 1) box at (column c0, step c1, batch c2)
__device__ __forceinline__ void tma_load(float* dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const float* src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// 4 bytes of src[row t, column col] of batch b, zeros outside the tensor
__device__ __forceinline__ void cp_async4_or_zero(float* dst, const float* src,
                                                  int b, int t, int col,
                                                  int S, int W) {
  const bool in = t >= 0 && t < S && col < W;
  const float* p =
      in ? src + (static_cast<size_t>(b) * S + t) * W + col : src;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(p), "r"(in ? 4 : 0)
               : "memory");
}

struct BwdMaps {
  CUtensorMap g, a, y, dx, da;
};

// walk one tile's column from its last step to its first: d = g + a * d,
// the multiply and the add rounded apart, d written over g
__device__ __forceinline__ float walk_tile(float* g, const float* a,
                                           float d) {
  float gv[kBwdBatch], av[kBwdBatch];
#pragma unroll
  for (int u = 0; u < kBwdBatch; ++u) {
    gv[u] = g[(kBwdSteps - 1 - u) * kBwdCols];
    av[u] = a[(kBwdSteps - 1 - u) * kBwdCols];
  }
#pragma unroll
  for (int r0 = kBwdSteps - 1; r0 >= 0; r0 -= kBwdBatch) {
    float gn[kBwdBatch] = {}, an[kBwdBatch] = {};
    if (r0 >= kBwdBatch) {
#pragma unroll
      for (int u = 0; u < kBwdBatch; ++u) {
        gn[u] = g[(r0 - kBwdBatch - u) * kBwdCols];
        an[u] = a[(r0 - kBwdBatch - u) * kBwdCols];
      }
    }
#pragma unroll
    for (int u = 0; u < kBwdBatch; ++u) {
      d = gv[u] + av[u] * d;
      g[(r0 - u) * kBwdCols] = d;
      gv[u] = gn[u];
      av[u] = an[u];
    }
  }
  return d;
}

// Walk step i covers the tile of steps [S - (i + 1) * kBwdSteps, S - i *
// kBwdSteps), in ring slot i % kBwdStages; the first-in-time tile reaches
// below step 0, where TMA (or the zero-filled copies) read zeros and the
// stores write nothing.
__global__ void __launch_bounds__(kBwdThreads)
    rg_lru_bwd_kernel(const __grid_constant__ BwdMaps maps,
                      const float* __restrict__ a,
                      const float* __restrict__ y,
                      const float* __restrict__ g, float* __restrict__ da,
                      float* __restrict__ dx, int S, int W, int use_tma) {
  extern __shared__ unsigned char bwd_smem[];
  // 128-byte aligned for TMA; offset from the array itself, so the compiler
  // keeps shared-memory loads and stores (LDS/STS) for the walk
  float* ring = reinterpret_cast<float*>(bwd_smem +
                                         (-smem_u32(bwd_smem) & 127u));
  const uint32_t full = smem_u32(ring + kBwdStages * 3 * kBwdTile);
  const uint32_t walked = full + 8 * kBwdStages;
  const int lane = threadIdx.x % 32;
  const int w0 = blockIdx.x * kBwdCols;
  const int b = blockIdx.y;
  const int n_tiles = (S + kBwdSteps - 1) / kBwdSteps;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kBwdStages; ++s) {
      // TMA: lane 0's expect_tx; else each lane's cp.async completion
      mbar_init(full + 8 * s, use_tma ? 1 : 32);
      mbar_init(walked + 8 * s, 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 32) {
    // the walker: the chain alone, one lane a column
    float d = -0.f;
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kBwdStages;
      float* slot = ring + s * 3 * kBwdTile;
      mbar_wait(full + 8 * s, (i / kBwdStages) & 1);
      if (lane < kBwdCols)
        d = walk_tile(slot + lane, slot + kBwdTile + lane, d);
      fence_proxy_async();  // d goes out through TMA
      mbar_arrive(walked + 8 * s);
    }
    return;
  }

  // the memory warp
  auto load = [&](int i) {
    const int s = i % kBwdStages;
    float* slot = ring + s * 3 * kBwdTile;
    const int t0 = S - (i + 1) * kBwdSteps;
    if (use_tma) {
      if (lane == 0) {
        const uint32_t bar = full + 8 * s;
        mbar_expect_tx(bar, 3 * kBwdTile * sizeof(float));
        tma_load(slot, &maps.g, bar, w0, t0, b);
        tma_load(slot + kBwdTile, &maps.a, bar, w0, t0 + 1, b);
        tma_load(slot + 2 * kBwdTile, &maps.y, bar, w0, t0 - 1, b);
      }
      return;
    }
    for (int k = lane; k < kBwdTile; k += 32) {
      const int t = t0 + k / kBwdCols, col = w0 + k % kBwdCols;
      cp_async4_or_zero(slot + k, g, b, t, col, S, W);
      cp_async4_or_zero(slot + kBwdTile + k, a, b, t + 1, col, S, W);
      cp_async4_or_zero(slot + 2 * kBwdTile + k, y, b, t - 1, col, S, W);
    }
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                     "r"(full + 8 * s)
                 : "memory");
  };

  for (int i = 0; i < kBwdStages && i < n_tiles; ++i) load(i);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kBwdStages;
    float* slot = ring + s * 3 * kBwdTile;
    const int t0 = S - (i + 1) * kBwdSteps;
    mbar_wait(walked + 8 * s, (i / kBwdStages) & 1);
    // da = d * y_prev, over y_prev
    const float4* d4 = reinterpret_cast<const float4*>(slot);
    float4* y4 = reinterpret_cast<float4*>(slot + 2 * kBwdTile);
    for (int k = lane; k < kBwdTile / 4; k += 32) {
      const float4 dv = d4[k], yv = y4[k];
      y4[k] = make_float4(dv.x * yv.x, dv.y * yv.y, dv.z * yv.z, dv.w * yv.w);
    }
    int freed;  // the tile whose slot is free to refill
    if (use_tma && t0 >= 0) {  // (a TMA store takes no row below 0)
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        tma_store(&maps.dx, slot, w0, t0, b);
        tma_store(&maps.da, slot + 2 * kBwdTile, w0, t0, b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        // the previous tile's stores have read their slot
        asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      }
      freed = i - 1;
    } else {
      __syncwarp();
      for (int k = lane; k < kBwdTile; k += 32) {
        const int t = t0 + k / kBwdCols, col = w0 + k % kBwdCols;
        if (t < 0 || col >= W) continue;
        const size_t at = (static_cast<size_t>(b) * S + t) * W + col;
        dx[at] = slot[k];
        da[at] = slot[2 * kBwdTile + k];
      }
      __syncwarp();
      freed = i;
    }
    if (freed >= 0 && freed + kBwdStages < n_tiles) load(freed + kBwdStages);
  }
  if (use_tma && lane == 0)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
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

// a (B, S, W) float32 tensor as (kBwdCols, kBwdSteps, 1) boxes; elements
// outside it read as zeros and are never written
bool encode_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B,
                int S, int W) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(W) * 4,
                                 static_cast<cuuint64_t>(S) * W * 4};
  const cuuint32_t box[3] = {kBwdCols, kBwdSteps, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Per device, whether the backward's dynamic shared memory is allowed: the
// opt-in is set once, under the lock, not on every launch.  Per thread,
// whether the thread has bound a context: cuTensorMapEncodeTiled fails on a
// thread that has none, and a thread whose first CUDA work is this launch
// (autograd's device thread, when this backward is the first node it runs)
// has made no runtime call that would have bound one.
constexpr int kMaxDevices = 64;
std::mutex g_mu;
bool g_bwd_smem_allowed[kMaxDevices];
thread_local bool t_context_bound[kMaxDevices];

cudaError_t prepare_bwd_launch() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!t_context_bound[dev]) {
    err = cudaFree(nullptr);  // binds the device's primary context
    if (err != cudaSuccess) return err;
    t_context_bound[dev] = true;
  }
  std::lock_guard<std::mutex> lock(g_mu);
  if (!g_bwd_smem_allowed[dev]) {
    err = cudaFuncSetAttribute(rg_lru_bwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kBwdSmem));
    if (err != cudaSuccess) return err;
    g_bwd_smem_allowed[dev] = true;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// a, x (B,S,W) f32 -> y (B,S,W) f32, all contiguous on the current device.
// Returns cudaGetLastError() of the launch.
int rg_lru_launch(const void* a, const void* x, void* y, int B, int S, int W,
                  void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535) return cudaErrorInvalidValue;
  const uintptr_t bases =
      reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(x);
  if (bases % 4) return cudaErrorMisalignedAddress;
  const dim3 grid((W + kCols - 1) / kCols, B);
  rg_lru_kernel<<<grid, kCols, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(x),
      static_cast<float*>(y), S, W, bases % 16 == 0);
  return static_cast<int>(cudaGetLastError());
}

// a, y, g (B,S,W) f32 -> da, dx (B,S,W) f32, all contiguous on the current
// device: the adjoint of rg_lru_launch for upstream gradient g, where y is
// its output.  Returns cudaGetLastError() of the launch.
int rg_lru_bwd_launch(const void* a, const void* y, const void* g, void* da,
                      void* dx, int B, int S, int W, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535) return cudaErrorInvalidValue;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(a) |
                          reinterpret_cast<uintptr_t>(y) |
                          reinterpret_cast<uintptr_t>(g);
  const uintptr_t outs =
      reinterpret_cast<uintptr_t>(da) | reinterpret_cast<uintptr_t>(dx);
  if (bases % 4 || outs % 4) return cudaErrorMisalignedAddress;
  cudaError_t err = prepare_bwd_launch();
  if (err != cudaSuccess) return static_cast<int>(err);
  // TMA takes 16-byte bases and rows; else the lanes' 4-byte copies
  const bool use_tma = W % 4 == 0 && (bases | outs) % 16 == 0;
  BwdMaps maps = {};
  if (use_tma) {
    static const EncodeTiled encode = lookup_encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    if (!encode_map(encode, &maps.g, g, B, S, W) ||
        !encode_map(encode, &maps.a, a, B, S, W) ||
        !encode_map(encode, &maps.y, y, B, S, W) ||
        !encode_map(encode, &maps.dx, dx, B, S, W) ||
        !encode_map(encode, &maps.da, da, B, S, W))
      return cudaErrorInvalidValue;
  }
  const dim3 grid((W + kBwdCols - 1) / kBwdCols, B);
  rg_lru_bwd_kernel<<<grid, kBwdThreads, kBwdSmem,
                      static_cast<cudaStream_t>(stream)>>>(
      maps, static_cast<const float*>(a), static_cast<const float*>(y),
      static_cast<const float*>(g), static_cast<float*>(da),
      static_cast<float*>(dx), S, W, use_tma);
  return static_cast<int>(cudaGetLastError());
}

const char* rg_lru_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
