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
// training launch (1, 4096, 2560)).  Same layout as the forward: one warp of
// 32 columns per block walks its columns from the last step to the first,
// with 64-step tiles of g, of a shifted one step later and of y shifted one
// step earlier staged through a 3-stage cp.async ring (72 KB of dynamic
// shared memory), so each step reads its three operands from one row.  It
// rounds the multiply and the add apart, as autograd through the plain loop
// does, and matches it bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

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

constexpr int kBwdArrays = 3;  // g, a shifted +1, y shifted -1
constexpr size_t kBwdSmem =
    sizeof(float) * kStages * kBwdArrays * kSteps * kCols;

// ring slot layout: [stage][array][step][column]
typedef float BwdTile[kSteps][kCols];

// stage the tile starting at step t0 (rows steps): row r of the g tile is
// g_{t0+r}, of the a tile a_{t0+r+1} (none past S - 1), of the y tile
// y_{t0+r-1} (none before 0; the walk reads y_{-1} as 0)
__device__ __forceinline__ void stage_bwd_tile(BwdTile* slot, const float* a,
                                               const float* y, const float* g,
                                               size_t col0, int t0, int rows,
                                               int S, int W, bool whole,
                                               int lane, bool lane_ok) {
  stage_rows(slot[0], g, col0, t0, rows, W, whole, lane, lane_ok);
  stage_rows(slot[1], a, col0, t0 + 1, min(rows, S - 1 - t0), W, whole, lane,
             lane_ok);
  if (t0 == 0)
    stage_rows(slot[2] + 1, y, col0, 0, rows - 1, W, whole, lane, lane_ok);
  else
    stage_rows(slot[2], y, col0, t0 - 1, rows, W, whole, lane, lane_ok);
}

__global__ void __launch_bounds__(kCols)
    rg_lru_bwd_kernel(const float* __restrict__ a,
                      const float* __restrict__ y,
                      const float* __restrict__ g, float* __restrict__ da,
                      float* __restrict__ dx, int S, int W, int aligned16) {
  extern __shared__ __align__(16) float smem[];
  BwdTile* ring = reinterpret_cast<BwdTile*>(smem);  // [kStages * 3]
  const int lane = threadIdx.x;
  const int w0 = blockIdx.x * kCols;
  const bool lane_ok = w0 + lane < W;
  const bool whole = aligned16 && W % 4 == 0 && w0 + kCols <= W;
  const size_t col0 = static_cast<size_t>(blockIdx.y) * S * W + w0;
  const int n_tiles = (S + kSteps - 1) / kSteps;

  // walk step i covers tile n_tiles - 1 - i, in ring slot i % kStages
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) {
      const int t0 = (n_tiles - 1 - i) * kSteps;
      stage_bwd_tile(ring + kBwdArrays * i, a, y, g, col0, t0,
                     min(kSteps, S - t0), S, W, whole, lane, lane_ok);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  float d = 0.f;
  for (int i = 0; i < n_tiles; ++i) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
    __syncthreads();
    const int next = i + kStages - 1;
    if (next < n_tiles) {
      const int t0 = (n_tiles - 1 - next) * kSteps;
      stage_bwd_tile(ring + kBwdArrays * (next % kStages), a, y, g, col0, t0,
                     min(kSteps, S - t0), S, W, whole, lane, lane_ok);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    if (!lane_ok) continue;
    const BwdTile* slot = ring + kBwdArrays * (i % kStages);
    const int t0 = (n_tiles - 1 - i) * kSteps;
    const int rows = min(kSteps, S - t0);
    const size_t off = col0 + lane + static_cast<size_t>(t0) * W;
    float* dxt = dx + off;
    float* dat = da + off;
#pragma unroll 16
    for (int r = rows - 1; r >= 0; --r) {
      const int t = t0 + r;
      const float gt = slot[0][r][lane];
      d = (t == S - 1) ? gt : gt + slot[1][r][lane] * d;
      const float y_prev = (t == 0) ? 0.f : slot[2][r][lane];
      dxt[static_cast<size_t>(r) * W] = d;
      dat[static_cast<size_t>(r) * W] = d * y_prev;
    }
  }
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
  // above 48 KB, dynamic shared memory needs the opt-in (per device)
  const cudaError_t err = cudaFuncSetAttribute(
      rg_lru_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kBwdSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + kCols - 1) / kCols, B);
  rg_lru_bwd_kernel<<<grid, kCols, kBwdSmem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(y),
      static_cast<const float*>(g), static_cast<float*>(da),
      static_cast<float*>(dx), S, W, bases % 16 == 0);
  return static_cast<int>(cudaGetLastError());
}

const char* rg_lru_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
