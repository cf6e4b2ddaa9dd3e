// Batched progressive-filling max-min fair rates on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/metronome_fill.py
// (_fill_kernel, launched by metronome_fill).  One CTA solves one fill
// problem: per round, every active flow grows by the common increment
// min(own headroom, min over its links of remaining / active count), then
// flows freeze on demand met or on a path link with remaining <= FILL_EPS.
//
// Bound on the H100: neither bytes nor operations.  A 64-problem bucket of
// the trace corpus moves under 1 MB and its rounds need ~1e7 operations
// (well under a microsecond of either), while each round is a chain of
// block barriers and reductions.  The design keeps that chain short:
//   * all per-flow state (demand, rate, active flag) and per-link state
//     (remaining capacity, active count, saturated flag) lives in shared
//     memory for the whole solve;
//   * the 0/1 route matrix arrives as uint8 and is staged in shared memory
//     when it fits (2048 flows x 16 links = 32 KB); otherwise rounds read
//     it from global memory, where a bucket (a few MB) stays L2-resident;
//   * the loop exits as soon as no flow of the problem is active
//     (__syncthreads_or), where the TPU kernel ran a fixed F_pad+1 rounds
//     (drained rounds add 0, so the result is the same).
// Counts are integers and every reduction is a min, so no result depends
// on summation order; built with -fmad=false the kernel matches the plain
// PyTorch version bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kFillEps = 1e-4f;
constexpr float kFillInf = 1e30f;
constexpr int kMaxThreads = 256;

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Minimum over the block; scratch holds 33 floats.  blockDim.x is a
// multiple of 32.
__device__ float block_min(float v, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_min(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < nwarps ? scratch[lane] : kFillInf;
    w = warp_min(w);
    if (lane == 0) scratch[32] = w;
  }
  __syncthreads();
  return scratch[32];
}

__global__ void fill_kernel(const float* __restrict__ demands,
                            const uint8_t* __restrict__ routes,
                            const float* __restrict__ caps,
                            float* __restrict__ out, int F, int L,
                            int routes_in_smem) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_dem = reinterpret_cast<float*>(smem);  // F
  float* s_rate = s_dem + F;                      // F
  float* s_rem = s_rate + F;                      // L
  float* s_red = s_rem + L;                       // 33
  int* s_cnt = reinterpret_cast<int*>(s_red + 33);                // L
  uint8_t* s_act = reinterpret_cast<uint8_t*>(s_cnt + L);         // F
  uint8_t* s_sat = s_act + F;                                     // L
  uint8_t* s_routes = s_sat + L;                                  // F*L

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;
  const size_t b = blockIdx.x;
  const float* d = demands + b * F;
  const uint8_t* g_routes = routes + b * F * L;
  const float* c = caps + b * L;

  int local = 0;
  for (int f = tid; f < F; f += nt) {
    const float dem = d[f];
    const int a = dem > kFillEps;
    s_dem[f] = dem;
    s_rate[f] = 0.f;
    s_act[f] = static_cast<uint8_t>(a);
    local |= a;
  }
  for (int l = tid; l < L; l += nt) s_rem[l] = c[l];
  if (routes_in_smem) {
    for (int i = tid; i < F * L; i += nt) s_routes[i] = g_routes[i];
  }
  const uint8_t* R = routes_in_smem ? s_routes : g_routes;
  int alive = __syncthreads_or(local);

  for (int round = 0; round <= F && alive; ++round) {
    // active flows per link: one warp per link
    for (int l = warp; l < L; l += nwarps) {
      int n = 0;
      for (int f = lane; f < F; f += 32)
        n += (s_act[f] && R[static_cast<size_t>(f) * L + l]) ? 1 : 0;
      n = warp_sum(n);
      if (lane == 0) s_cnt[l] = n;
    }
    __syncthreads();

    // common increment: min over link shares and active-flow headroom
    float m = kFillInf;
    for (int l = tid; l < L; l += nt)
      if (s_cnt[l] > 0) m = fminf(m, s_rem[l] / static_cast<float>(s_cnt[l]));
    for (int f = tid; f < F; f += nt)
      if (s_act[f]) m = fminf(m, s_dem[f] - s_rate[f]);
    const float inc = fmaxf(block_min(m, s_red), 0.f);

    // grow the active flows, drain the links
    for (int f = tid; f < F; f += nt)
      if (s_act[f]) s_rate[f] = s_rate[f] + inc;
    for (int l = tid; l < L; l += nt) {
      const float r = s_rem[l] - inc * static_cast<float>(s_cnt[l]);
      s_rem[l] = r;
      s_sat[l] = r <= kFillEps;
    }
    __syncthreads();

    // freeze on demand met or a saturated link on the path
    local = 0;
    for (int f = tid; f < F; f += nt) {
      if (!s_act[f]) continue;
      bool stop = s_rate[f] >= s_dem[f] - kFillEps;
      const uint8_t* row = R + static_cast<size_t>(f) * L;
      for (int l = 0; l < L && !stop; ++l) stop = row[l] && s_sat[l];
      if (stop) {
        s_act[f] = 0;
      } else {
        local = 1;
      }
    }
    alive = __syncthreads_or(local);
  }

  float* o = out + b * F;
  for (int f = tid; f < F; f += nt) o[f] = s_rate[f];
}

size_t state_bytes(int F, int L) {
  return static_cast<size_t>(F) * (2 * sizeof(float) + 1) +
         static_cast<size_t>(L) * (sizeof(float) + sizeof(int) + 1) +
         33 * sizeof(float);
}

}  // namespace

extern "C" {

// Largest shared-memory footprint a block may ask for on the current
// device, or a negative CUDA error code.
long long metronome_fill_smem_limit() {
  int dev = 0;
  int limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
  return err == cudaSuccess ? limit : -static_cast<long long>(err);
}

// Bytes of per-problem state the kernel keeps in shared memory (without
// the staged route matrix).
long long metronome_fill_state_bytes(int F, int L) {
  return static_cast<long long>(state_bytes(F, L));
}

// demands (B,F) f32, routes (B,F,L) u8, caps (B,L) f32 -> out (B,F) f32,
// all contiguous on the current device.  Returns cudaGetLastError() of the
// launch.
int metronome_fill_launch(const void* demands, const void* routes,
                          const void* caps, void* out, int B, int F, int L,
                          void* stream) {
  const long long limit = metronome_fill_smem_limit();
  if (limit < 0) return static_cast<int>(-limit);
  const size_t base = state_bytes(F, L);
  const size_t staged = base + static_cast<size_t>(F) * L;
  const int in_smem = staged <= static_cast<size_t>(limit);
  const size_t smem = in_smem ? staged : base;
  if (smem > static_cast<size_t>(limit)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int threads = ((F + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
  fill_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(demands), static_cast<const uint8_t*>(routes),
      static_cast<const float*>(caps), static_cast<float*>(out), F, L,
      in_smem);
  return static_cast<int>(cudaGetLastError());
}

const char* metronome_fill_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
