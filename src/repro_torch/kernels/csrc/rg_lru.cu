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

// stage rows [t0, t0 + rows) of this block's columns into one ring slot
__device__ __forceinline__ void stage_tile(float (*sa)[kCols],
                                           float (*sx)[kCols],
                                           const float* a, const float* x,
                                           size_t col0, int t0, int rows,
                                           int W, bool whole, int lane,
                                           bool lane_ok) {
  if (whole) {
    for (int i = lane; i < rows * kChunks; i += kCols) {
      const int r = i / kChunks, c = 4 * (i % kChunks);
      const size_t g = col0 + static_cast<size_t>(t0 + r) * W + c;
      cp_async16(&sa[r][c], a + g);
      cp_async16(&sx[r][c], x + g);
    }
  } else if (lane_ok) {
    for (int r = 0; r < rows; ++r) {
      const size_t g = col0 + static_cast<size_t>(t0 + r) * W + lane;
      cp_async4(&sa[r][lane], a + g);
      cp_async4(&sx[r][lane], x + g);
    }
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
    if (i < n_tiles)
      stage_tile(sa[i], sx[i], a, x, col0, i * kSteps,
                 min(kSteps, S - i * kSteps), W, whole, lane, lane_ok);
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
    if (next < n_tiles)
      stage_tile(sa[next % kStages], sx[next % kStages], a, x, col0,
                 next * kSteps, min(kSteps, S - next * kSteps), W, whole,
                 lane, lane_ok);
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

const char* rg_lru_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
