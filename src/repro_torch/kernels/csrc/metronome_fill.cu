// Batched progressive-filling max-min fair rates on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/metronome_fill.py
// (_fill_kernel, launched by metronome_fill).  Per round, every active flow
// grows by the common increment min(own headroom, min over its links of
// remaining / active count), then flows freeze on demand met or on a path
// link with remaining <= FILL_EPS.
//
// Bound on the H100: neither bytes nor operations.  A 64-problem bucket of
// the trace corpus moves under 1 MB and needs ~1e7 operations, well under
// a microsecond of either; what takes the time is each round's chain of
// barriers and reductions.  The design shortens that chain:
//   * a water level, not a rate per flow.  Every active flow has held the
//     same rate since round 0 (0 + inc_1 + inc_2 + ..., added in the same
//     order), so a problem keeps one float level; a flow that freezes takes
//     the level as its rate.  Rounding is monotone, so the min over active
//     flows of fl(d - level) is the plain version's min headroom;
//   * routes as link bitmasks (ceil(L/32) 32-bit words a flow, packed once
//     in the prologue) and the saturated links as a mask, so the freeze
//     test is (route & sat) != 0 || level >= d - FILL_EPS;
//   * link counts computed once and decremented when a flow freezes
//     (warp-aggregated shared-memory atomics; integers, so the order does
//     not matter), never recounted from the F x L routes;
//   * two block barriers a round: the increment's min, then the freeze with
//     __syncthreads_or; a thread a flow (up to 1,024 threads), since each
//     round's time grows with the flows a thread walks.  Every warp keeps
//     its own copy of the links' remaining capacity (lane l holds link l),
//     so the saturated mask needs no barrier; counts are double-buffered so
//     a round's decrements never meet its reads;
//   * one warp per problem where F <= 32 and L <= 32 (the event loop's
//     shapes), four problems a CTA, with ballots and shuffles and no block
//     barrier at all: a link's count is popc(its flow column & the active
//     ballot);
//   * the loop exits as soon as the problem drains (the TPU kernel ran a
//     fixed F_pad + 1 rounds; drained rounds add 0).
// Built with -fmad=false, the kernel matches the plain PyTorch version bit
// for bit: every float operation is the plain version's, in its order.
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr float kFillEps = 1e-4f;
constexpr float kFillInf = 1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpProblems = 4;    // problems per CTA on the warp path
constexpr int kMaxThreads = 1024;
constexpr int kMaxFlowSlots = 32;   // flows a thread tracks (one bit each)

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Add sign * (number of lanes whose fm has bit l) to cnt[l] for every l,
// one atomic per link the warp touches.  All 32 lanes must call it.
__device__ __forceinline__ void add_link_counts(uint32_t fm, int* cnt,
                                                int sign, int lane) {
  uint32_t u = __reduce_or_sync(kFull, fm);
  while (u) {
    const int l = __ffs(u) - 1;
    u &= u - 1;
    const int n = __popc(__ballot_sync(kFull, (fm >> l) & 1u));
    if (lane == 0) atomicAdd(cnt + l, sign * n);
  }
}

// F <= 32, L <= 32: warp w of the CTA solves problem blockIdx.x * 4 + w.
// Lane f holds flow f (demand, route mask, rate), lane l holds link l
// (remaining capacity, the column of flows that cross it).
__global__ void __launch_bounds__(32 * kWarpProblems)
fill_warp_kernel(const float* __restrict__ demands,
                 const uint8_t* __restrict__ routes,
                 const float* __restrict__ caps, float* __restrict__ out,
                 int B, int F, int L) {
  __shared__ uint8_t s_routes[kWarpProblems][32 * 32];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarpProblems + w;
  if (b >= B) return;  // the whole warp; nothing below syncs the block
  const uint8_t* g_r = routes + static_cast<size_t>(b) * F * L;
  uint8_t* r = s_routes[w];
  for (int i = lane; i < F * L; i += 32) r[i] = g_r[i];
  __syncwarp();
  const float dem = lane < F ? demands[static_cast<size_t>(b) * F + lane]
                             : 0.f;
  uint32_t mask = 0, col = 0;
  if (lane < F)
    for (int l = 0; l < L; ++l) mask |= (r[lane * L + l] != 0 ? 1u : 0u) << l;
  if (lane < L)
    for (int f = 0; f < F; ++f) col |= (r[f * L + lane] != 0 ? 1u : 0u) << f;
  float rem = lane < L ? caps[static_cast<size_t>(b) * L + lane] : 0.f;
  bool act = lane < F && dem > kFillEps;
  float rate = 0.f, level = 0.f;
  uint32_t live = __ballot_sync(kFull, act);
  for (int round = 0; live && round <= F; ++round) {
    const int cnt = __popc(col & live);
    float v = act ? dem - level : kFillInf;
    if (lane < L && cnt > 0) v = fminf(v, rem / static_cast<float>(cnt));
    const float inc = fmaxf(warp_min(v), 0.f);
    level = level + inc;
    bool sat = false;
    if (lane < L) {
      rem = rem - inc * static_cast<float>(cnt);
      sat = rem <= kFillEps;
    }
    const uint32_t satm = __ballot_sync(kFull, sat);
    if (act && ((mask & satm) != 0 || level >= dem - kFillEps)) {
      rate = level;
      act = false;
    }
    live = __ballot_sync(kFull, act);
  }
  if (act) rate = level;  // the F + 1 round cap, as the plain version
  if (lane < F) out[static_cast<size_t>(b) * F + lane] = rate;
}

// One CTA per problem, a thread a flow up to 1,024 flows.  Thread t tracks
// flows t + k * blockDim.x (bit k of `act`).  Each warp keeps its own copy
// of the links' remaining capacity, lane l holding link l: in a register
// where L <= 32 (ONE, every launch of the main path), else links l, l + 32,
// ... in the warp's shared memory.  (A minimum of one block an SM gives
// ptxas the registers to keep the division's slow path from spilling.)
template <bool ONE>
__global__ void __launch_bounds__(kMaxThreads, 1)
fill_block_kernel(const float* __restrict__ demands,
                  const uint8_t* __restrict__ routes,
                  const float* __restrict__ caps, float* __restrict__ out,
                  int F, int L, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;
  const int nw = ONE ? 1 : W;
  float* s_dem = reinterpret_cast<float*>(smem);                    // F
  uint32_t* s_mask = reinterpret_cast<uint32_t*>(s_dem + F);        // F*W
  int* s_cnt = reinterpret_cast<int*>(s_mask + static_cast<size_t>(F) * nw);
  float* s_red = reinterpret_cast<float*>(s_cnt + 2 * 32 * nw);     // 32
  float* s_rem = s_red + 32 + static_cast<size_t>(warp) * 32 * nw;  // !ONE
  uint32_t* s_sat = reinterpret_cast<uint32_t*>(
      s_red + 32 + static_cast<size_t>(nwarps) * 32 * nw) + warp * nw;

  const size_t b = blockIdx.x;
  const float* d = demands + b * F;
  const uint8_t* g_r = routes + b * F * L;
  float* o = out + b * F;
  const int K = (F + nt - 1) / nt;  // <= kMaxFlowSlots, checked by the host

  // prologue: demands, packed route masks, initial link counts
  for (int i = tid; i < 2 * 32 * nw; i += nt) s_cnt[i] = 0;
  __syncthreads();
  uint32_t act = 0;
  for (int k = 0; k < K; ++k) {
    const int f = tid + k * nt;
    bool a = false;
    if (f < F) {
      const float dem = d[f];
      s_dem[f] = dem;
      a = dem > kFillEps;
      o[f] = 0.f;
    }
    act |= (a ? 1u : 0u) << k;
    const uint8_t* row = g_r + static_cast<size_t>(f) * L;
    for (int j = 0; j < nw; ++j) {
      uint32_t word = 0;
      if (f < F) {
        if constexpr (ONE) {  // every byte of the row in flight at once
#pragma unroll
          for (int l = 0; l < 32; ++l)
            if (l < L) word |= (__ldg(row + l) != 0 ? 1u : 0u) << l;
        } else {
          const int hi = min(L, 32 * j + 32);
#pragma unroll 4
          for (int l = 32 * j; l < hi; ++l)
            word |= (__ldg(row + l) != 0 ? 1u : 0u) << (l & 31);
        }
        s_mask[static_cast<size_t>(f) * nw + j] = word;
      }
      add_link_counts(a ? word : 0u, s_cnt + 32 * j, 1, lane);
    }
  }
  float rem = 0.f;  // ONE: link `lane`
  if constexpr (ONE) {
    if (lane < L) rem = caps[b * L + lane];
  } else {
    for (int l = lane; l < 32 * nw; l += 32)
      s_rem[l] = l < L ? caps[b * L + l] : 0.f;
  }
  float level = 0.f;
  int cur = 0;
  int alive = __syncthreads_or(act != 0);

  for (int round = 0; alive && round <= F; ++round) {
    const int* cnt_cur = s_cnt + cur * 32 * nw;
    int* cnt_nxt = s_cnt + (cur ^ 1) * 32 * nw;
    // the common increment: min over the active flows' headroom and the
    // links' shares
    float v = kFillInf;
    for (uint32_t a = act; a; a &= a - 1)
      v = fminf(v, s_dem[tid + (__ffs(a) - 1) * nt] - level);
    for (int l = lane; l < 32 * nw; l += 32) {
      const int n = l < L ? cnt_cur[l] : 0;
      if (n > 0)
        v = fminf(v, (ONE ? rem : s_rem[l]) / static_cast<float>(n));
      if (warp == 0) cnt_nxt[l] = n;
    }
    v = warp_min(v);
    if (lane == 0) s_red[warp] = v;
    __syncthreads();

    const float inc =
        fmaxf(warp_min(lane < nwarps ? s_red[lane] : kFillInf), 0.f);
    level = level + inc;
    uint32_t sat = 0;  // ONE: the saturated links
    for (int l = lane; l < 32 * nw; l += 32) {
      bool s = false;
      if (l < L) {  // cnt_cur is still this round's count
        const float r =
            (ONE ? rem : s_rem[l]) - inc * static_cast<float>(cnt_cur[l]);
        if constexpr (ONE) rem = r; else s_rem[l] = r;
        s = r <= kFillEps;
      }
      sat = __ballot_sync(kFull, s);
      if (!ONE && lane == 0) s_sat[l >> 5] = sat;
    }
    if constexpr (!ONE) __syncwarp();

    // freeze on demand met or a saturated link on the path
    for (int k = 0; k < K; ++k) {
      const int f = tid + k * nt;
      const uint32_t* m = s_mask + static_cast<size_t>(f) * nw;
      bool stop = false;
      if ((act >> k) & 1u) {
        stop = level >= s_dem[f] - kFillEps;
        if constexpr (ONE) {
          stop |= (m[0] & sat) != 0;
        } else {
          for (int j = 0; j < nw && !stop; ++j) stop = (m[j] & s_sat[j]) != 0;
        }
        if (stop) {
          o[f] = level;
          act &= ~(1u << k);
        }
      }
      if (__any_sync(kFull, stop))
        for (int j = 0; j < nw; ++j)
          add_link_counts(stop ? m[j] : 0u, cnt_nxt + 32 * j, -1, lane);
    }
    cur ^= 1;
    alive = __syncthreads_or(act != 0);
  }
  for (uint32_t a = act; a; a &= a - 1)  // the F + 1 round cap
    o[tid + (__ffs(a) - 1) * nt] = level;
}

int words(int L) { return (L + 31) / 32; }

bool warp_path(int F, int L) { return F <= 32 && L <= 32; }

int block_threads(int F) {  // a thread a flow, in whole warps
  const int t = ((F + 31) / 32) * 32;
  return t > kMaxThreads ? kMaxThreads : t;
}

size_t block_bytes(int F, int L) {
  const size_t w = words(L);
  size_t n = static_cast<size_t>(F) * (1 + w) + 2 * 32 * w + 32;
  if (w > 1) n += static_cast<size_t>(block_threads(F) / 32) * (32 * w + w);
  return n * sizeof(float);
}

// Per device: the opt-in shared-memory limit and the dynamic shared memory
// each block-kernel instance has been allowed, so that a launch makes no
// driver call beyond cudaGetDevice.
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

template <bool ONE>
cudaError_t launch_block(DeviceState* st, int slot, const float* d,
                         const uint8_t* r, const float* c, float* out, int B,
                         int F, int L, cudaStream_t stream) {
  const size_t smem = block_bytes(F, L);
  if (smem > st->allowed[slot]) {
    cudaError_t err = cudaFuncSetAttribute(
        fill_block_kernel<ONE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    st->allowed[slot] = smem;
  }
  fill_block_kernel<ONE><<<B, block_threads(F), smem, stream>>>(
      d, r, c, out, F, L, words(L));
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Largest shared-memory footprint a block may ask for on the current
// device (queried once per device), or a negative CUDA error code.
long long metronome_fill_smem_limit() {
  std::lock_guard<std::mutex> lock(g_mu);
  DeviceState* st = nullptr;
  const cudaError_t err = device_state(&st);
  return err == cudaSuccess ? st->limit : -static_cast<long long>(err);
}

// Dynamic shared memory one problem of F flows over L links needs (0 on
// the warp path).
long long metronome_fill_state_bytes(int F, int L) {
  return warp_path(F, L) ? 0 : static_cast<long long>(block_bytes(F, L));
}

// Largest F the kernel takes (L is bounded by shared memory alone).
int metronome_fill_max_flows() { return kMaxThreads * kMaxFlowSlots; }

// demands (B,F) f32, routes (B,F,L) u8, caps (B,L) f32 -> out (B,F) f32,
// all contiguous on the current device.  Returns cudaGetLastError() of the
// launch.
int metronome_fill_launch(const void* demands, const void* routes,
                          const void* caps, void* out, int B, int F, int L,
                          void* stream) {
  if (B < 1 || F < 1 || L < 1 || F > metronome_fill_max_flows())
    return cudaErrorInvalidValue;
  const auto* d = static_cast<const float*>(demands);
  const auto* r = static_cast<const uint8_t*>(routes);
  const auto* c = static_cast<const float*>(caps);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (warp_path(F, L)) {
    fill_warp_kernel<<<(B + kWarpProblems - 1) / kWarpProblems,
                       32 * kWarpProblems, 0, s>>>(d, r, c, o, B, F, L);
    return static_cast<int>(cudaGetLastError());
  }
  std::lock_guard<std::mutex> lock(g_mu);
  DeviceState* st = nullptr;
  cudaError_t err = device_state(&st);
  if (err != cudaSuccess) return err;
  if (block_bytes(F, L) > static_cast<size_t>(st->limit))
    return cudaErrorInvalidValue;
  err = L <= 32 ? launch_block<true>(st, 0, d, r, c, o, B, F, L, s)
                : launch_block<false>(st, 1, d, r, c, o, B, F, L, s);
  if (err != cudaSuccess) return err;
  return static_cast<int>(cudaGetLastError());
}

const char* metronome_fill_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
