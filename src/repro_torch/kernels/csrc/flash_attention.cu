// Online-softmax attention forward on Hopper (sm_90a): causal, sliding
// window or bidirectional, GQA, float32 or bfloat16 in, float32 inside.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_flash_fwd_kernel, launched by flash_attention_fwd).  The port's griffin
// prefill calls it once per local-attention layer on the prompt's own keys.
//
// Bound on the H100: operations.  Only the unmasked (q, k) pairs need work,
// 4*D operations each (q.k and p.v); at the serving shape (B=4, H=10, Hkv=1,
// S=4064, D=256, window 2048) that is ~6.2 M pairs per head, ~0.26 ms at
// the 989 TFLOP/s bf16 tensor-core peak.  The bytes (q, k, v read once, o
// written once) are a few tens of MB, far below it.
//
// Design (right and simple first; tensor cores, wgmma and TMA are later
// work): one block of 256 threads per (batch*head, 64-row q tile).  The q
// tile and each 64-row k and v tile are staged in shared memory as float32
// (216 KB at D=256, opted in above 48 KB); rows past S are zero and masked,
// so any S works (no block-multiple requirement).  Thread (ty, tx) of a
// 16 x 16 grid owns rows ty + 16i (i < 4): scores for columns tx + 16j
// (j < 4) and the output columns 4tx + 64jj (jj < D/64), kept in registers
// with the row max and sum.  The 16 threads of a row reduce with warp
// shuffles.  Tiles wholly in the future (causal) or wholly outside the
// window are never loaded.  Float32 FMAs on the CUDA cores: what bounds this
// version is those FMAs and the shared-memory reads that feed them, so it
// sits far above the tensor-core bound.
//
// Numerics follow the Pallas body: scores scaled after the dot product,
// masked scores -1e30, running max from -1e30, final division by
// max(l, 1e-30).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kBQ) * (D + 4) +
                          static_cast<size_t>(kBK) * (D + 4) +
                          static_cast<size_t>(kBK) * D +
                          static_cast<size_t>(kBQ) * (kBK + 4));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int H,
                     int Hkv, int S, int causal, int window, float scale) {
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
  const T* qb = q + static_cast<size_t>(bh) * S * D;
  const T* kb = k + static_cast<size_t>(kvh) * S * D;
  const T* vb = v + static_cast<size_t>(kvh) * S * D;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int qp = q0 + r;
    sQ[r * QS + c] = qp < S ? to_f32(qb[static_cast<size_t>(qp) * D + c]) : 0.f;
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
      sK[r * QS + c] = kp < S ? to_f32(kb[g]) : 0.f;
      sV[r * D + c] = kp < S ? to_f32(vb[g]) : 0.f;
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
      for (int j = 0; j < 4; ++j) sP[(ty + 16 * i) * PS + tx + 16 * j] = s[i][j];
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
    T* orow = o + (static_cast<size_t>(bh) * S + qp) * D;
#pragma unroll
    for (int jj = 0; jj < NV; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store(&orow[64 * jj + 4 * tx + e], acc[i][jj][e] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Hkv, int S, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Hkv, S, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int H, int Hkv, int S, int D, int causal, int window,
             float scale, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, Hkv, S, causal, window, scale,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, Hkv, S, causal, window, scale,
                            stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, H, Hkv, S, causal, window, scale,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B,H,S,D), k and v (B,Hkv,S,D) -> o (B,H,S,D), all contiguous, of one
// type (bf16 when is_bf16, else f32), on the current device; D is 64, 128
// or 256 and H a multiple of Hkv.  window <= 0 means no window.  Returns
// cudaGetLastError() of the launch.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int H, int Hkv, int S, int D,
                           int is_bf16, int causal, int window, float scale,
                           void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || S <= 0 || H % Hkv != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_d<__nv_bfloat16>(q, k, v, o, B, H, Hkv, S, D,
                                           causal, window, scale, st)
                 : launch_d<float>(q, k, v, o, B, H, Hkv, S, D, causal,
                                   window, scale, st);
}

const char* flash_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
