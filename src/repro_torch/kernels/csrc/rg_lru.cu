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
// kernel carried it in VMEM across sequential S blocks).  Neighbouring
// threads take neighbouring w, so every load and store is coalesced.  The
// loop loads 16 steps of a and x before it runs them, to keep enough
// requests in flight.  Built with -fmad=false, each step is a separately
// rounded multiply and add, as the plain PyTorch loop computes it, so the
// two agree bit for bit.
//
// Known limit: B*W threads (10,240 at the serving shape, 80 blocks) do not
// fill 132 SMs, and each keeps only 16 steps in flight, short of what the
// memory rate needs.  Splitting S into chunks (a local scan per chunk, then
// a pass that carries each chunk's state into the next) is later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 16;

__global__ void __launch_bounds__(kThreads)
    rg_lru_kernel(const float* __restrict__ a, const float* __restrict__ x,
                  float* __restrict__ y, int S, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * W + w;
  const float* ap = a + base;
  const float* xp = x + base;
  float* yp = y + base;
  const size_t step = static_cast<size_t>(W);
  float h = 0.f;
  int t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float av[kUnroll], xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = ap[(t + u) * step];
      xv[u] = xp[(t + u) * step];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = av[u] * h + xv[u];
      yp[(t + u) * step] = h;
    }
  }
  for (; t < S; ++t) {
    h = ap[t * step] * h + xp[t * step];
    yp[t * step] = h;
  }
}

}  // namespace

extern "C" {

// a, x (B,S,W) f32 -> y (B,S,W) f32, all contiguous on the current device.
// Returns cudaGetLastError() of the launch.
int rg_lru_launch(const void* a, const void* x, void* y, int B, int S, int W,
                  void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535) return cudaErrorInvalidValue;
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  rg_lru_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(x),
      static_cast<float*>(y), S, W);
  return static_cast<int>(cudaGetLastError());
}

const char* rg_lru_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
