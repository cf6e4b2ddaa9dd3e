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
// Bound on the H100: operations.  Each (c, a, b, l, s) term is four float32
// operations on inputs that are read once, so at the planner's shapes
// (C = 64, L = 4, Ra = Rb = S = 72) the work is ~4e8 operations against
// ~12 MB of traffic.  The design keeps the inner loop on registers and
// shared memory: a block owns one candidate and a tile of 8 rotations of
// job A, stages base + A for a chunk of links in shared memory (every
// thread reads the same word, a broadcast), and each thread walks one
// rotation b of job B, reading its row once from global memory and
// accumulating the 8 excess sums of the tile in registers.  The slot sum
// runs in float32 in slot order and is divided by the true S; nothing is
// padded.  Zero-demand, unit-capacity padding links add no excess and so
// score exactly 100.
#include <cuda_runtime.h>

namespace {

constexpr int kTileA = 8;
constexpr size_t kTileBytes = 48 * 1024;

__global__ void score_kernel(const float* __restrict__ base,
                             const float* __restrict__ bank_a,
                             const float* __restrict__ bank_b,
                             const float* __restrict__ caps,
                             float* __restrict__ out, int L, int Ra, int Rb,
                             int S, int n_tiles, int links_per_chunk) {
  extern __shared__ float tile[];  // links_per_chunk x kTileA x S
  const int c = blockIdx.x / n_tiles;
  const int a0 = (blockIdx.x % n_tiles) * kTileA;
  const int b = threadIdx.x;
  const int tile_len = kTileA * S;

  float worst[kTileA];
#pragma unroll
  for (int ai = 0; ai < kTileA; ++ai) worst[ai] = 0.f;

  for (int l0 = 0; l0 < L; l0 += links_per_chunk) {
    const int nl = min(links_per_chunk, L - l0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < nl * tile_len; i += blockDim.x) {
      const int li = i / tile_len;
      const int ai = (i % tile_len) / S;
      const int s = i % S;
      const int a = a0 + ai;
      const size_t cl = static_cast<size_t>(c) * L + l0 + li;
      tile[i] = a < Ra ? base[cl * S + s] + bank_a[(cl * Ra + a) * S + s]
                       : 0.f;
    }
    __syncthreads();
    if (b < Rb) {
      for (int li = 0; li < nl; ++li) {
        const size_t cl = static_cast<size_t>(c) * L + l0 + li;
        const float cap = caps[cl];
        const float* brow = bank_b + (cl * Rb + b) * S;
        const float* t = tile + li * tile_len;
        float ex[kTileA];
#pragma unroll
        for (int ai = 0; ai < kTileA; ++ai) ex[ai] = 0.f;
        for (int s = 0; s < S; ++s) {
          const float bv = __ldg(brow + s);
#pragma unroll
          for (int ai = 0; ai < kTileA; ++ai)
            ex[ai] += fmaxf(t[ai * S + s] + bv - cap, 0.f);
        }
        const float denom = cap * static_cast<float>(S);
#pragma unroll
        for (int ai = 0; ai < kTileA; ++ai)
          worst[ai] = fmaxf(worst[ai], ex[ai] / denom);
      }
    }
  }

  if (b < Rb) {
#pragma unroll
    for (int ai = 0; ai < kTileA; ++ai) {
      const int a = a0 + ai;
      if (a < Ra)
        out[(static_cast<size_t>(c) * Ra + a) * Rb + b] =
            fmaxf(0.f, 100.f * (1.f - worst[ai]));
    }
  }
}

}  // namespace

extern "C" {

// base (C,L,S), bank_a (C,L,Ra,S), bank_b (C,L,Rb,S), caps (C,L) f32 ->
// out (C,Ra,Rb) f32, all contiguous on the current device; needs
// 1 <= Rb <= 1024 and 8 * S floats within 48 KB.  Returns
// cudaGetLastError() of the launch.
int metronome_score_launch(const void* base, const void* bank_a,
                           const void* bank_b, const void* caps, void* out,
                           int C, int L, int Ra, int Rb, int S, void* stream) {
  const size_t link_bytes = static_cast<size_t>(kTileA) * S * sizeof(float);
  if (Rb < 1 || Rb > 1024 || link_bytes > kTileBytes)
    return cudaErrorInvalidValue;
  int per_chunk = static_cast<int>(kTileBytes / link_bytes);
  per_chunk = per_chunk < L ? per_chunk : L;
  const int n_tiles = (Ra + kTileA - 1) / kTileA;
  const int threads = ((Rb + 31) / 32) * 32;
  const size_t smem = per_chunk * link_bytes;
  score_kernel<<<C * n_tiles, threads, smem,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(base), static_cast<const float*>(bank_a),
      static_cast<const float*>(bank_b), static_cast<const float*>(caps),
      static_cast<float*>(out), L, Ra, Rb, S, n_tiles, per_chunk);
  return static_cast<int>(cudaGetLastError());
}

const char* metronome_score_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
