// Joint rotation scores (Eq. 18, min over links) on Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of src/repro/kernels/metronome_score.py:
// _multilink_batch_kernel (metronome_score_multilink_batch), _multilink_kernel
// (metronome_score_multilink, here the C = 1 launch) and _score_kernel
// (metronome_score_pairwise, the C = 1, L = 1 launch).  For every candidate
// c and rotation pair (a, b):
//
//   score[c, a, b] = max(0, 100 * (1 - max_l sum_s relu(base + A + B - cap_l)
//                                               / (cap_l * S)))
//
// Bound on the H100: operations.  Each (c, a, b, l, s) term is an add, a
// max and an add on inputs that are read once, so at the planner's shapes
// (C = 64, L = 4, Ra = Rb = S = 72) the work is ~3e8 operations against
// ~12 MB of traffic.  The design:
//   * a block owns one candidate and a 24 x 24 tile of (a, b) pairs; each
//     thread owns a 3 x 3 micro-tile, so one float4 shared-memory load of
//     u = base + A or v = B - cap feeds three terms of four slots, and a
//     term is three instructions (u + v, max, +=);
//   * u and v are staged once per link by coalesced 16-byte loads (rows of
//     S = 72 floats are 288 bytes, a multiple of 16), transformed on the
//     way through registers, into rows padded to an odd number of 16-byte
//     units so that the eight rows a quarter-warp reads sit in distinct
//     banks;
//   * the links are split across up to four groups of 64 threads, whose
//     per-link maxima are combined at the end (a max is exact in any
//     order): at C = 1 that puts 9 blocks of 8 warps to work, and at every
//     C it gives an SM more warps to hide latency with;
//   * the slot loop is unrolled for S = 72 (DI_PRE); other S (or operands
//     off a 16-byte boundary) take an instance with a runtime slot count
//     and 4-byte loads.
// Each (c, a, b, l) slot sum runs in float32 in slot order and is scaled
// by 1 / (cap * S) with the true S; nothing is padded.  Every max
// propagates NaN, as the plain version's clamp_min and amax do: a
// zero-capacity link with zero excess (0 * inf) makes the score NaN.  Zero-demand, unit-capacity padding
// links add no excess and so score exactly 100.
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kTile = 24;                 // rotations of A and of B a block
constexpr int kMicro = 3;                 // a thread's 3 x 3 (a, b) pairs
constexpr int kSide = kTile / kMicro;     // 8 x 8 threads a link group
constexpr int kGroup = kSide * kSide;     // 64
constexpr int kMaxGroups = 4;
constexpr int kPlannerS = 72;             // DI_PRE, core/geometry.py

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float relu_add(float acc, float u, float v) {
  return acc + max_nan(u + v, 0.f);
}

// Row stride in floats: for S % 4 == 0 an odd number of 16-byte units
// (float4 reads of rows 3 apart hit distinct bank groups), else odd.
__host__ __device__ constexpr int row_stride(int S) {
  return S % 4 == 0 ? ((S / 4) % 2 == 0 ? S + 4 : S) : (S | 1);
}

template <int SC>
__global__ void __launch_bounds__(kGroup * kMaxGroups)
score_kernel(const float* __restrict__ base, const float* __restrict__ bank_a,
             const float* __restrict__ bank_b, const float* __restrict__ caps,
             float* __restrict__ out, int L, int Ra, int Rb, int S_rt,
             int tiles_b, int n_tiles) {
  extern __shared__ __align__(16) float smem[];
  const int S = SC ? SC : S_rt;
  const int stride = row_stride(S);
  const int G = blockDim.x / kGroup;
  const int g = threadIdx.x / kGroup;
  const int t = threadIdx.x % kGroup;
  const int ta = t / kSide, tb = t % kSide;
  const int c = blockIdx.x / n_tiles;
  const int tile = blockIdx.x % n_tiles;
  const int a0 = (tile / tiles_b) * kTile;
  const int b0 = (tile % tiles_b) * kTile;
  float* u = smem + static_cast<size_t>(g) * 2 * kTile * stride;
  float* v = u + kTile * stride;

  float worst[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) worst[i][j] = __int_as_float(0xff800000);

  for (int l0 = 0; l0 < L; l0 += G) {
    const int l = l0 + g;
    const size_t cl = static_cast<size_t>(c) * L + l;
    float cap = 0.f;
    if (l < L) {
      cap = caps[cl];
      const float* brow = base + cl * S;
      const float* arows = bank_a + (cl * Ra + a0) * S;
      const float* brows = bank_b + (cl * Rb + b0) * S;
      if constexpr (SC != 0) {
        constexpr int Q = SC / 4;
        for (int i = t; i < 2 * kTile * Q; i += kGroup) {
          const int r = i / Q, q = i % Q;
          const bool is_a = r < kTile;
          const int row = is_a ? r : r - kTile;
          float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
          if (is_a ? a0 + row < Ra : b0 + row < Rb) {
            const float4 y = __ldg(reinterpret_cast<const float4*>(
                (is_a ? arows : brows) + row * SC) + q);
            if (is_a) {
              const float4 z =
                  __ldg(reinterpret_cast<const float4*>(brow) + q);
              x = make_float4(z.x + y.x, z.y + y.y, z.z + y.z, z.w + y.w);
            } else {
              x = make_float4(y.x - cap, y.y - cap, y.z - cap, y.w - cap);
            }
          }
          *reinterpret_cast<float4*>((is_a ? u : v) + row * stride + 4 * q) =
              x;
        }
      } else {
        for (int i = t; i < 2 * kTile * S; i += kGroup) {
          const int r = i / S, s = i % S;
          const bool is_a = r < kTile;
          const int row = is_a ? r : r - kTile;
          float x = 0.f;
          if (is_a ? a0 + row < Ra : b0 + row < Rb)
            x = is_a ? brow[s] + arows[row * S + s]
                     : brows[row * S + s] - cap;
          (is_a ? u : v)[row * stride + s] = x;
        }
      }
    }
    __syncthreads();
    if (l < L) {
      float ex[kMicro][kMicro];
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j) ex[i][j] = 0.f;
      const float* ur = u + ta * kMicro * stride;
      const float* vr = v + tb * kMicro * stride;
      if constexpr (SC != 0) {
#pragma unroll
        for (int s = 0; s < SC; s += 4) {
          float4 ua[kMicro], vb[kMicro];
#pragma unroll
          for (int i = 0; i < kMicro; ++i)
            ua[i] = *reinterpret_cast<const float4*>(ur + i * stride + s);
#pragma unroll
          for (int j = 0; j < kMicro; ++j)
            vb[j] = *reinterpret_cast<const float4*>(vr + j * stride + s);
#pragma unroll
          for (int i = 0; i < kMicro; ++i)
#pragma unroll
            for (int j = 0; j < kMicro; ++j) {
              float e = ex[i][j];
              e = relu_add(e, ua[i].x, vb[j].x);
              e = relu_add(e, ua[i].y, vb[j].y);
              e = relu_add(e, ua[i].z, vb[j].z);
              ex[i][j] = relu_add(e, ua[i].w, vb[j].w);
            }
        }
      } else {
        for (int s = 0; s < S; ++s) {
          float ua[kMicro], vb[kMicro];
#pragma unroll
          for (int i = 0; i < kMicro; ++i) ua[i] = ur[i * stride + s];
#pragma unroll
          for (int j = 0; j < kMicro; ++j) vb[j] = vr[j * stride + s];
#pragma unroll
          for (int i = 0; i < kMicro; ++i)
#pragma unroll
            for (int j = 0; j < kMicro; ++j)
              ex[i][j] = relu_add(ex[i][j], ua[i], vb[j]);
        }
      }
      // one division a link: ex * (1 / (cap * S)) is within 1.5 ulp of
      // ex / (cap * S), keeps 0 / 0 = NaN and x / 0 = inf, and leaves no
      // division slow-path call (with its register saves) in the 9 terms
      const float rden = 1.f / (cap * static_cast<float>(S));
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j)
          worst[i][j] = max_nan(worst[i][j], ex[i][j] * rden);
    }
    __syncthreads();  // the tiles are consumed before the next links land
  }

  if (G > 1) {  // combine the link groups' maxima through shared memory
    float* part = smem + (static_cast<size_t>(g) * kGroup + t) *
                             (kMicro * kMicro);
#pragma unroll
    for (int i = 0; i < kMicro; ++i)
#pragma unroll
      for (int j = 0; j < kMicro; ++j) part[i * kMicro + j] = worst[i][j];
    __syncthreads();
    if (g != 0) return;
    for (int h = 1; h < G; ++h) {
      const float* p = smem + (static_cast<size_t>(h) * kGroup + t) *
                                  (kMicro * kMicro);
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j)
          worst[i][j] = max_nan(worst[i][j], p[i * kMicro + j]);
    }
  }
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int a = a0 + ta * kMicro + i;
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const int b = b0 + tb * kMicro + j;
      if (a < Ra && b < Rb)
        out[(static_cast<size_t>(c) * Ra + a) * Rb + b] =
            max_nan(0.f, 100.f * (1.f - worst[i][j]));
    }
  }
}

size_t smem_bytes(int S, int G) {
  const size_t tiles = static_cast<size_t>(G) * 2 * kTile * row_stride(S);
  const size_t parts = static_cast<size_t>(G) * kGroup * kMicro * kMicro;
  return (tiles > parts ? tiles : parts) * sizeof(float);
}

// Per device: the opt-in shared-memory limit and the dynamic shared memory
// each instance has been allowed, so a launch makes no driver call beyond
// cudaGetDevice.
constexpr int kMaxDevices = 64;
struct DeviceState {
  int limit = -1;
  size_t allowed[2] = {48 * 1024, 48 * 1024};
};
std::mutex g_mu;
DeviceState g_dev[kMaxDevices];

cudaError_t device_state(DeviceState** st) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceState& s = g_dev[dev];
  if (s.limit < 0) {
    int limit = 0;
    err = cudaDeviceGetAttribute(&limit,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    s.limit = limit;
  }
  *st = &s;
  return cudaSuccess;
}

template <int SC>
cudaError_t launch(DeviceState* st, int slot, const float* base,
                   const float* bank_a, const float* bank_b,
                   const float* caps, float* out, int C, int L, int Ra,
                   int Rb, int S, cudaStream_t stream) {
  const int tiles_a = (Ra + kTile - 1) / kTile;
  const int tiles_b = (Rb + kTile - 1) / kTile;
  const int n_tiles = tiles_a * tiles_b;
  const long long blocks = static_cast<long long>(C) * n_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  // every link a thread group of its own, up to four: more warps per SM
  // to hide latency with, at every C
  int G = L < kMaxGroups ? L : kMaxGroups;
  while (G > 1 && smem_bytes(S, G) > static_cast<size_t>(st->limit)) --G;
  const size_t smem = smem_bytes(S, G);
  if (smem > static_cast<size_t>(st->limit)) return cudaErrorInvalidValue;
  if (smem > st->allowed[slot]) {
    const cudaError_t err = cudaFuncSetAttribute(
        score_kernel<SC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    st->allowed[slot] = smem;
  }
  score_kernel<SC><<<static_cast<int>(blocks), kGroup * G, smem, stream>>>(
      base, bank_a, bank_b, caps, out, L, Ra, Rb, S, tiles_b, n_tiles);
  return cudaSuccess;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

// Largest slot count S the kernel takes on the current device (one link
// group's tiles within the opt-in shared memory), or a negative CUDA error.
long long metronome_score_max_slots() {
  std::lock_guard<std::mutex> lock(g_mu);
  DeviceState* st = nullptr;
  const cudaError_t err = device_state(&st);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  int s = 1;
  while (smem_bytes(s + 1, 1) <= static_cast<size_t>(st->limit)) ++s;
  return s;
}

// base (C,L,S), bank_a (C,L,Ra,S), bank_b (C,L,Rb,S), caps (C,L) f32 ->
// out (C,Ra,Rb) f32, all contiguous on the current device.  Returns
// cudaGetLastError() of the launch.
int metronome_score_launch(const void* base, const void* bank_a,
                           const void* bank_b, const void* caps, void* out,
                           int C, int L, int Ra, int Rb, int S, void* stream) {
  if (C < 1 || L < 1 || Ra < 1 || Rb < 1 || S < 1)
    return cudaErrorInvalidValue;
  std::lock_guard<std::mutex> lock(g_mu);
  DeviceState* st = nullptr;
  cudaError_t err = device_state(&st);
  if (err != cudaSuccess) return err;
  const auto* b = static_cast<const float*>(base);
  const auto* a = static_cast<const float*>(bank_a);
  const auto* bb = static_cast<const float*>(bank_b);
  const auto* c = static_cast<const float*>(caps);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (S == kPlannerS && aligned16(b) && aligned16(a) && aligned16(bb))
    err = launch<kPlannerS>(st, 0, b, a, bb, c, o, C, L, Ra, Rb, S, s);
  else
    err = launch<0>(st, 1, b, a, bb, c, o, C, L, Ra, Rb, S, s);
  if (err != cudaSuccess) return err;
  return static_cast<int>(cudaGetLastError());
}

const char* metronome_score_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
