// The LM head's three products on Hopper (sm_90a), each a float32 result
// of bfloat16 tensor-core passes, with the products float32 would form:
//
//   forward  logits[T, V] (f32)  = x[T, d] (bf16) . W[d, V] (bf16)
//   dX       dX[T, d] (bf16)     = dlogits[T, V] (f32) . W^T
//   dW       dW[d, V] (bf16)     = x^T . dlogits, computed as
//                                  dW^T[V, d] = dlogits^T . x
//
// T is a micro-batch's tokens, d the model width, V the vocabulary.  It
// replaces no Pallas kernel: the JAX package leaves the head to XLA's
// einsum (src/repro/models/model.py, _logits).  Without it the head is
// x.float() @ W.float() with autograd (what float32 parameters and CPU
// tensors take), three float32 GEMMs on the CUDA cores, bound by their
// 67 TFLOP/s float32 peak.
//
// Why float32's own results: x (rmsnorm's output) and W are bfloat16
// values, and every bf16 x bf16 product is exact in float32, so one bf16
// pass with float32 accumulation forms the forward's float32 products;
// only the order of the sum differs, as between any two GEMMs.  dlogits is
// a true float32 tensor: each value a is split in registers into three
// bfloat16 values, hi = bf16(a), mid = bf16(a - hi), lo = bf16(a - hi -
// mid), whose sum is a exactly for |a| above ~1e-33 (the subtractions are
// exact, and 3 x 8 significant bits hold float32's 24).  So dX and dW are
// three bf16 passes each with exact products and float32 sums, rounded
// once to bf16 on store, where the float32 path rounds its float32 result
// to the bf16 leaves.
//
// Bound on the H100: operations, 3 products of 2*T*d*V at 989 TFLOP/s
// (InternLM2-20B's micro-batch, T 4096, d 6144, V 92544: 1.40e13 in 14.1
// ms); the algorithm's own floor is 7 bf16 passes, 3.26e13 in 33 ms, the
// 3-pass backward being the cost of float32's precision (the float32 path
// takes ~270 ms).  Bytes are far below: the logits and
// dlogits (1.5 GB each there) are written or read once per product.
// Measured there: PERF.md section 6, the kernel table.
//
// Design, one template (lm_head_gemm<kMode>) for the three: a persistent
// block on each SM walks 128-row output tiles (the dimension with fewer
// tiles fastest, so that a wave shares one operand's panel in L2); two
// warpgroups of 64 rows each.  Thread 0 also keeps TMA loads of 64-deep
// k-tiles in flight through a ring of stages (full and empty mbarriers),
// refilling a stage as soon as both warpgroups have released it, and runs
// on across tile boundaries, so that a tile's epilogue overlaps the next
// one's loads.  Every thread walks the loads' schedule and waits where
// thread 0 waits; only thread 0's copies are issued (predicated in the
// asm): a branch around them split the warpgroups while their wgmmas were
// in flight, and ptxas serialised the wgmmas.  No separate producer warp:
// with a ninth warp the SM's sub-partition that holds three warps caps
// every thread at 168 registers, which spilled the backward's accumulator
// and fragments and serialised its wgmmas; with eight a thread may hold
// 255.  128-byte swizzle on every tile; out-of-range rows and k read as
// TMA's zero fill, and stores are masked, so every T, d and V is taken (d
// and the operands' row strides must be multiples of 8 bf16 / 4 float32
// values, which the wrapper arranges).
//
// - forward: x and W both by TMA, wgmma m64n192k16 with both operands in
//   shared memory (W's tile N-major, through the descriptor's transpose
//   bit); 5 stages of 40 KB; float32 stores with a streaming hint.  The
//   tensor cores' float32 accumulation over 6,144 products lost about
//   2.6x cuBLAS float32's largest error, so each warpgroup drains its
//   accumulator into a float32 sum in registers every 8 k-tiles (512
//   products), which left 0.2x: 96 + 96 registers, hence 192 columns, not
//   256 (V = 92,544 is 482 of them).
// - dX: dlogits' tile comes by TMA as float32 (two 32-column boxes) and
//   each thread reads its register-fragment elements from it, splits them
//   and issues three m64n192k16 wgmmas with the register A operand on the
//   same K-major shared tile of W rows; 4 stages of 56 KB.  A warpgroup
//   reads a k16 slice's values while its last slice's passes run, waits
//   for them, then splits: while it waits and splits, the other
//   warpgroup's passes run.  Undrained (256 columns), the tensor cores'
//   sum over V's 3 x 92,544 products rounded 3.3% of InternLM2's dX to
//   the other bf16 neighbour of the float64 product (cuBLAS float32:
//   0.08%), though the largest error matched cuBLAS's; so each warpgroup
//   drains its accumulator into the float32 sum after every k-tile (12
//   wgmmas), 0.01%, as the forward does, hence 192 columns here too (244
//   registers).  It cost dX and dW 17-18% of their time at 256 columns.
// - dW: the same with dW^T = dlogits^T . x: dlogits' tile comes as four
//   32-row boxes (V contiguous), the fragment is read down its columns,
//   and x's tile is N-major.  The epilogue writes dW^T's tile transposed,
//   straight from the sum (bf16 scalar stores).
#include <cuda.h>  // CUtensorMap and its enums: types only, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kBM = 128;  // tile rows, 64 a consumer warpgroup
constexpr int kBK = 64;   // k-tile depth
constexpr int kThreads = 256;  // two warpgroups
constexpr int kRow = 128;  // bytes of a swizzled row
// each warpgroup promotes its tensor-core partial sums into a float32 sum
// in registers every kPromote k-tiles: the forward's 8 (512 products), the
// backward's every k-tile (its three passes, 12 wgmmas)
constexpr int kPromote = 8;
constexpr int kBwdPromote = 1;

enum Mode { kFwd = 0, kDx = 1, kDw = 2 };

template <int kMode>
struct Layout {
  // tile columns: 192 leave registers for the second accumulator (V =
  // 92,544 is 482 of them)
  static constexpr int kBN = 192;
  static constexpr int kAcc = kBN / 2;  // accumulator floats a thread
  static constexpr int kPromoteTiles = kMode == kFwd ? kPromote : kBwdPromote;
  // A: x (forward, 128 x 64 bf16) or dlogits (128 x 64 float32); B: W or
  // x, 64 x kBN bf16
  static constexpr int kABytes = kMode == kFwd ? kBM * kBK * 2 : kBM * kBK * 4;
  static constexpr int kBBytes = kBK * kBN * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kStages = kMode == kFwd ? 5 : 4;
  static constexpr int kBar = kStages * kStageBytes;  // full[], empty[]
  static constexpr int kAlloc = kBar + 16 * kStages + 1024;  // + alignment
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// the producer's instructions, predicated on ``issue`` inside the asm: every
// thread runs the producer's code, so no branch splits a warpgroup while
// its wgmmas are in flight (ptxas serialises them around one), and thread
// 0 alone arrives and copies
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes,
                                               bool issue) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %2, 0;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
      "}\n" ::"r"(bar),
      "r"(bytes), "r"(static_cast<int>(issue))
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// spin on a barrier phase; a wait of ~2^26 polls (seconds) can only be a
// deadlock, and traps so that the launch fails instead of hanging
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

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            bool issue) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %5, 0;\n"
      "@p cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      "}\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(static_cast<int>(issue))
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout B128.
// K-major: 8-row groups 1024 bytes apart (the leading offset unused);
// N-major: 64-column slabs the leading offset apart.
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
__device__ __forceinline__ void fence_regs(uint32_t (&d)[3][4]) {
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) asm volatile("" : "+r"(d[p][q])::"memory");
}

// a descriptor plus a step's offset (16-byte units), added inside the asm
// so that the compiler keeps one base descriptor, not one per step
#define WG_ADD_OFFSET(out, desc, off)      \
  "mov.b64 {wlo, whi}, " desc ";\n"        \
  "add.u32 wlo, wlo, " off ";\n"           \
  "mov.b64 " out ", {wlo, whi};\n"

#define WG_ACC96 \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, " \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, " \
  "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, " \
  "%93, %94, %95" \
  "}"
#define WG_OUT96(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), \
  "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
  "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), \
  "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), \
  "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), \
  "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), \
  "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), \
  "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), \
  "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), \
  "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), \
  "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), \
  "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), \
  "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), \
  "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), \
  "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])

// d (64 x 192 f32) += A (64 x 16, shared, K-major) . B (16 x 192, shared,
// N-major: three 64-column slabs the descriptor's leading offset apart)
__device__ __forceinline__ void wgmma_ss(float (&d)[96], uint64_t da,
                                         uint32_t off_a, uint64_t db,
                                         uint32_t off_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .b32 wlo, whi;\n"
      ".reg .b64 wda, wdb;\n"
      "setp.ne.b32 p, %100, 0;\n"
      WG_ADD_OFFSET("wda", "%96", "%97")
      WG_ADD_OFFSET("wdb", "%98", "%99")
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 " WG_ACC96
      ", wda, wdb, p, 1, 1, 0, 1;\n"
      "}\n"
      : WG_OUT96(d)
      : "l"(da), "r"(off_a), "l"(db), "r"(off_b), "r"(1));
}

// d (64 x 192 f32) += A (64 x 16 bf16, registers) . B (16 x 192, shared;
// TB = 0: K-major, 192 rows of k; TB = 1: N-major, three 64-column slabs
// the descriptor's leading offset apart)
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[96], const uint32_t* a,
                                         uint64_t db, uint32_t off_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .b32 wlo, whi;\n"
      ".reg .b64 wdb;\n"
      "setp.ne.b32 p, %102, 0;\n"
      WG_ADD_OFFSET("wdb", "%100", "%101")
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 " WG_ACC96
      ", {%96, %97, %98, %99}, wdb, p, 1, 1, %103;\n"
      "}\n"
      : WG_OUT96(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(off_b),
        "r"(1), "n"(TB));
}

__device__ __forceinline__ float2 lds_f32x2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ float lds_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) as three packed bf16 pairs whose sums are x and y exactly:
// hi = bf16(a), mid = bf16(a - hi), lo = bf16(a - hi - mid), each
// subtraction exact in float32
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const float rx = x - hf.x, ry = y - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l = __floats2bfloat162_rn(rx - mf.x, ry - mf.y);
  hi = bits(h);
  mid = bits(m);
  lo = bits(l);
}

// Fragment geometry.  wgmma's accumulator and register-A layouts: warp w
// of warpgroup wg holds tile rows r = 64 wg + 16 w + lane / 4 and r + 8;
// of a k16 slice, columns c = 2 (lane % 4) and c + 1, c + 8 and c + 9.
// Fragment register 0 packs (r, c..c+1), 1 (r+8, c..), 2 (r, c+8..),
// 3 (r+8, c+8..).

// dX: dlogits' float32 tile, two 32-column boxes of 128 rows (k contiguous,
// 128-byte swizzle: a row's 16-byte chunk j sits at chunk j ^ (row % 8)).
// Slice kk's eight values of this thread, in fragment order.
__device__ __forceinline__ void frag_dx(float (&v)[8], uint32_t sa, int row,
                                        int lane, int kk) {
  const int g = lane >> 2, tq = lane & 3;  // row % 8 == g
  const uint32_t box = sa + (kk >> 1) * (kBM * kRow) + row * kRow +
                       8 * (tq & 1);
  const int ch = 4 * (kk & 1) + (tq >> 1);  // 16-byte chunk of column c
  const float2 a = lds_f32x2(box + ((ch ^ g) << 4));
  const float2 b = lds_f32x2(box + 8 * kRow + ((ch ^ g) << 4));
  const float2 c = lds_f32x2(box + (((ch + 2) ^ g) << 4));
  const float2 d = lds_f32x2(box + 8 * kRow + (((ch + 2) ^ g) << 4));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  v[4] = c.x; v[5] = c.y; v[6] = d.x; v[7] = d.y;
}

// dW: dlogits' float32 tile as A^T, four 32-column boxes of 64 rows (the
// tile's m, i.e. V, contiguous; a box row is one k).  Slice kk's eight
// values of this thread, in fragment order, read down the columns.
__device__ __forceinline__ void frag_dw(float (&v)[8], uint32_t sa, int row,
                                        int lane, int kk) {
  const int tq = lane & 3;
  const int mm = row & 31;  // m within its box
  const uint32_t box = sa + (row >> 5) * (kBK * kRow) + 4 * (mm & 3);
  const int ch = mm >> 2;
  const int k0 = 16 * kk + 2 * tq;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    // e: bit 0 the column pair's second, bit 1 row r + 8, bit 2 column + 8
    const int k = k0 + (e & 1) + 8 * (e >> 2);
    const int chunk = ch + 2 * ((e >> 1) & 1);
    v[e] = lds_f32(box + k * kRow + ((chunk ^ (k & 7)) << 4));
  }
}

template <int kMode>
__device__ __forceinline__ void tile_origin(int t, int m_tiles, int n_tiles,
                                            int m_fast, int& m0, int& n0) {
  const int mt = m_fast ? t % m_tiles : t / n_tiles;
  const int nt = m_fast ? t / m_tiles : t % n_tiles;
  m0 = mt * kBM;
  n0 = nt * Layout<kMode>::kBN;
}

// the TMA loads of one k-tile (depth k0 ..) into a stage, issued where
// ``issue``
template <int kMode>
__device__ __forceinline__ void load_stage(const CUtensorMap* a_map,
                                           const CUtensorMap* b_map,
                                           uint32_t sa, uint32_t bar, int m0,
                                           int n0, int k0, bool issue) {
  using L = Layout<kMode>;
  const uint32_t sb = sa + L::kABytes;
  mbar_expect_tx(bar, L::kStageBytes, issue);
  if (kMode == kFwd) {
    tma_load_2d(sa, a_map, bar, k0, m0, issue);  // x: 64 k x 128 rows
  } else if (kMode == kDx) {
    for (int c = 0; c < 2; ++c)  // dlogits: 32 k x 128 rows, twice
      tma_load_2d(sa + c * kBM * kRow, a_map, bar, k0 + 32 * c, m0, issue);
  } else {
    for (int c = 0; c < 4; ++c)  // dlogits: 32 m x 64 k rows, four times
      tma_load_2d(sa + c * kBK * kRow, a_map, bar, m0 + 32 * c, k0, issue);
  }
  if (kMode == kDx) {
    tma_load_2d(sb, b_map, bar, k0, n0, issue);  // W: 64 k x kBN rows
  } else {
    for (int c = 0; c < L::kBN / 64; ++c)  // W or x: 64 n x 64 k rows
      tma_load_2d(sb + c * kBK * kRow, b_map, bar, n0 + 64 * c, k0, issue);
  }
}

// the tile's accumulator to C: rows r and r + 8, columns c + 8 j and
// c + 8 j + 1 (forward: float32 C[M][ldc]; dX: bf16 C[M][ldc]; dW: the
// transpose, bf16 C[N][ldc])
template <int kMode>
__device__ __forceinline__ void store_tile(
    const float (&acc)[Layout<kMode>::kAcc], void* c, int r, int col, int M,
    int N, int ldc) {
#pragma unroll
  for (int j = 0; j < Layout<kMode>::kAcc / 4; ++j) {
    const int n = col + 8 * j;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = r + 8 * h;
      const float x = acc[4 * j + 2 * h], y = acc[4 * j + 2 * h + 1];
      if (m >= M || n >= N) continue;
      if (kMode == kFwd) {
        float* p = static_cast<float*>(c) + static_cast<size_t>(m) * ldc + n;
        if (((ldc | N) & 1) == 0) {
          __stcs(reinterpret_cast<float2*>(p), make_float2(x, y));
        } else {
          __stcs(p, x);
          if (n + 1 < N) __stcs(p + 1, y);
        }
      } else if (kMode == kDx) {  // N even
        __nv_bfloat16* p = static_cast<__nv_bfloat16*>(c) +
                           static_cast<size_t>(m) * ldc + n;
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
      } else {
        __nv_bfloat16* p = static_cast<__nv_bfloat16*>(c) +
                           static_cast<size_t>(n) * ldc + m;
        p[0] = __float2bfloat16_rn(x);
        if (n + 1 < N) p[ldc] = __float2bfloat16_rn(y);
      }
    }
  }
}

// the block's loads: its k-tiles in order (tile by tile), each into stage
// i % kStages once both warpgroups have released its last use.  Every
// thread walks them; thread 0 alone issues them
template <int kMode>
struct Producer {
  int i = 0, t, kt = 0, m0, n0;

  __device__ __forceinline__ Producer(int first, int m_tiles, int n_tiles,
                                      int m_fast)
      : t(first) {
    tile_origin<kMode>(t, m_tiles, n_tiles, m_fast, m0, n0);
  }

  // load every k-tile up to flat index ``last``
  __device__ __forceinline__ void to(int last, const CUtensorMap* a_map,
                                     const CUtensorMap* b_map, uint32_t base,
                                     uint32_t bar_full, uint32_t bar_empty,
                                     int tiles, int k_tiles, int m_tiles,
                                     int n_tiles, int m_fast) {
    using L = Layout<kMode>;
    for (; i <= last && t < tiles; ++i) {
      const int s = i % L::kStages;
      if (i >= L::kStages)
        mbar_wait(bar_empty + 8 * s, ((i / L::kStages) + 1) & 1);
      load_stage<kMode>(a_map, b_map, base + s * L::kStageBytes,
                        bar_full + 8 * s, m0, n0, kt * kBK,
                        threadIdx.x == 0);
      if (++kt == k_tiles) {
        kt = 0;
        t += gridDim.x;
        if (t < tiles) tile_origin<kMode>(t, m_tiles, n_tiles, m_fast, m0, n0);
      }
    }
  }
};

template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
    lm_head_gemm(const __grid_constant__ CUtensorMap a_map,
                 const __grid_constant__ CUtensorMap b_map,
                 void* __restrict__ c, int M, int N, int K, int ldc,
                 int m_tiles, int n_tiles, int m_fast) {
  using L = Layout<kMode>;
  constexpr int ST = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_full = base + L::kBar;  // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * ST;
  const int tiles = m_tiles * n_tiles;
  const int k_tiles = (K + kBK - 1) / kBK;
  Producer<kMode> prod(blockIdx.x, m_tiles, n_tiles, m_fast);

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // thread 0 also loads: the first stages now, and each stage again as
  // soon as both warpgroups have released it
  const auto refill = [&](int last) {
    prod.to(last, &a_map, &b_map, base, bar_full, bar_empty, tiles, k_tiles,
            m_tiles, n_tiles, m_fast);
  };
  refill(ST - 1);

  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  const int row = 64 * wg + 16 * ((threadIdx.x & 127) >> 5) + (lane >> 2);
  float acc[L::kAcc];
  float sum[L::kAcc];  // the promoted sum
  uint32_t f[3][4];  // a k16 slice's hi, mid and lo fragments
  int i = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    int m0, n0;
    tile_origin<kMode>(t, m_tiles, n_tiles, m_fast, m0, n0);
#pragma unroll
    for (int e = 0; e < L::kAcc; ++e) acc[e] = sum[e] = 0.f;
    int prev = -1;  // the stage of the last k-tile, until released
    for (int kt = 0; kt < k_tiles; ++kt, ++i) {
      const int s = i % ST;
      mbar_wait(bar_full + 8 * s, (i / ST) & 1);
      const uint32_t sa = base + s * L::kStageBytes;
      const uint32_t sb = sa + L::kABytes;
      if constexpr (kMode == kFwd) {
        const uint64_t da = sw128_desc(sa + 64 * wg * kRow, 16, 8 * kRow);
        const uint64_t db = sw128_desc(sb, kBK * kRow, 8 * kRow);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_ss(acc, da, 2 * kk, db, (kk * 16 * kRow) >> 4);
        wgmma_commit();
        if (kt % L::kPromoteTiles == L::kPromoteTiles - 1) {
          wgmma_wait<0>();
          fence_regs(acc);
#pragma unroll
          for (int e = 0; e < L::kAcc; ++e) {
            sum[e] += acc[e];
            acc[e] = 0.f;
          }
        } else {
          wgmma_wait<1>();  // the last k-tile's group is done
          fence_regs(acc);
        }
        if (prev >= 0) {
          mbar_arrive(bar_empty + 8 * prev);
          refill(i - 1 + ST);
        }
      } else {
        // dX: B is W's K-major tile (a k16 slice 32 bytes on); dW: x's
        // N-major tile (16 rows on)
        const uint64_t db = kMode == kDx
                                ? sw128_desc(sb, 16, 8 * kRow)
                                : sw128_desc(sb, kBK * kRow, 8 * kRow);
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          float v[8];
          if (kMode == kDx)
            frag_dx(v, sa, row, lane, kk);
          else
            frag_dw(v, sa, row, lane, kk);
          // this warpgroup's last slice done (the other's products keep
          // the tensor cores busy meanwhile): its fragments are free and,
          // at kk == 0, the last k-tile's stage.  Splitting the next
          // slice while a wgmma still read the last one's registers made
          // ptxas serialise every wgmma (C7513), 7% slower than this
          wgmma_wait<0>();
          if (kk == 0 && prev >= 0) {
            mbar_arrive(bar_empty + 8 * prev);
            refill(i - 1 + ST);
          }
#pragma unroll
          for (int q = 0; q < 4; ++q)
            split3(v[2 * q], v[2 * q + 1], f[0][q], f[1][q], f[2][q]);
          const uint32_t off =
              kMode == kDx ? 2 * kk : (kk * 16 * kRow) >> 4;
          // the split done before the wgmmas start (the same rule)
          fence_regs(f);
          fence_regs(acc);
          wgmma_fence();
#pragma unroll
          for (int p = 0; p < 3; ++p) {
            if (kMode == kDx)
              wgmma_rs<0>(acc, f[p], db, off);
            else
              wgmma_rs<1>(acc, f[p], db, off);
          }
          wgmma_commit();
        }
        if (kt % L::kPromoteTiles == L::kPromoteTiles - 1) {
          wgmma_wait<0>();
          fence_regs(acc);
#pragma unroll
          for (int e = 0; e < L::kAcc; ++e) {
            sum[e] += acc[e];
            acc[e] = 0.f;
          }
        }
      }
      prev = s;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (prev >= 0) {
      mbar_arrive(bar_empty + 8 * prev);
      refill(i - 1 + ST);
    }
#pragma unroll
    for (int e = 0; e < L::kAcc; ++e) sum[e] += acc[e];
    store_tile<kMode>(sum, c, m0 + row, n0 + 2 * (lane & 3), M, N, ldc);
  }
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

// a row-major (outer, inner) matrix, rows ld values apart, as
// 128-byte-swizzled boxes of box_inner x box_outer; reads past either
// edge are zeros
bool encode_2d(EncodeTiled encode, CUtensorMap* map, bool f32,
               const void* ptr, int inner, int outer, int ld, int box_inner,
               int box_outer) {
  const int elem = f32 ? 4 : 2;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map,
                f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                2, const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Per device, the SM count and whether each kernel's shared memory is
// allowed, read and set once under the lock.  Per thread, whether it has
// bound a context: cuTensorMapEncodeTiled fails on a thread that has none,
// and autograd's device thread can reach a backward launch before any
// runtime call of its own that would bind one.
constexpr int kMaxDevices = 64;
std::mutex g_mu;
int g_sms[kMaxDevices];
bool g_smem_allowed[kMaxDevices][3];
thread_local bool t_context_bound[kMaxDevices];

template <int kMode>
cudaError_t prepare(int* sms) {
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
  if (!g_smem_allowed[dev][kMode]) {
    err = cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(lm_head_gemm<kMode>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Layout<kMode>::kAlloc);
    if (err != cudaSuccess) return err;
    g_smem_allowed[dev][kMode] = true;
  }
  *sms = g_sms[dev];
  return cudaSuccess;
}

template <int kMode>
int launch(const CUtensorMap& a_map, const CUtensorMap& b_map, void* c,
           int M, int N, int K, int ldc, int sms, void* stream) {
  using L = Layout<kMode>;
  const int m_tiles = (M + kBM - 1) / kBM;
  const int n_tiles = (N + L::kBN - 1) / L::kBN;
  if (static_cast<long long>(m_tiles) * n_tiles > (1LL << 30))
    return cudaErrorInvalidValue;
  const int tiles = m_tiles * n_tiles;
  const int grid = tiles < sms ? tiles : sms;
  lm_head_gemm<kMode><<<grid, kThreads, L::kAlloc,
                        static_cast<cudaStream_t>(stream)>>>(
      a_map, b_map, c, M, N, K, ldc, m_tiles, n_tiles,
      m_tiles <= n_tiles ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// logits (T, V) float32 = x (T, d) bf16 . w (d, V) bf16, w's rows ldw
// values apart (ldw >= V, a multiple of 8); d a multiple of 8; x and w on
// 16-byte boundaries.  Returns cudaGetLastError() of the launch, or the
// error that kept it from launching.
int lm_head_fwd_launch(const void* x, const void* w, void* logits, int T,
                       int d, int V, int ldw, void* stream) {
  static const EncodeTiled encode = lookup_encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (T <= 0 || d <= 0 || V <= 0 || d % 8 || ldw < V || ldw % 8)
    return cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(w) || !aligned16(logits))
    return cudaErrorMisalignedAddress;
  int sms = 0;
  const cudaError_t err = prepare<kFwd>(&sms);
  if (err != cudaSuccess) return err;
  CUtensorMap a, b;
  if (!encode_2d(encode, &a, false, x, d, T, d, 64, kBM) ||
      !encode_2d(encode, &b, false, w, V, d, ldw, 64, kBK))
    return cudaErrorInvalidValue;
  return launch<kFwd>(a, b, logits, T, V, d, V, sms, stream);
}

// dx (T, d) bf16 = g (T, V) float32 . w (d, V)^T, g's rows ldg values
// apart (ldg >= V, a multiple of 4), w's ldw (a multiple of 8)
int lm_head_dx_launch(const void* g, const void* w, void* dx, int T, int d,
                      int V, int ldg, int ldw, void* stream) {
  static const EncodeTiled encode = lookup_encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (T <= 0 || d <= 0 || V <= 0 || d % 8 || ldg < V || ldg % 4 ||
      ldw < V || ldw % 8)
    return cudaErrorInvalidValue;
  if (!aligned16(g) || !aligned16(w) || !aligned16(dx))
    return cudaErrorMisalignedAddress;
  int sms = 0;
  const cudaError_t err = prepare<kDx>(&sms);
  if (err != cudaSuccess) return err;
  CUtensorMap a, b;
  if (!encode_2d(encode, &a, true, g, V, T, ldg, 32, kBM) ||
      !encode_2d(encode, &b, false, w, V, d, ldw, 64, Layout<kDx>::kBN))
    return cudaErrorInvalidValue;
  return launch<kDx>(a, b, dx, T, d, V, d, sms, stream);
}

// dw (d, V) bf16 = x (T, d)^T . g (T, V), g's rows ldg values apart
int lm_head_dw_launch(const void* x, const void* g, void* dw, int T, int d,
                      int V, int ldg, void* stream) {
  static const EncodeTiled encode = lookup_encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (T <= 0 || d <= 0 || V <= 0 || d % 8 || ldg < V || ldg % 4)
    return cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(g) || !aligned16(dw))
    return cudaErrorMisalignedAddress;
  int sms = 0;
  const cudaError_t err = prepare<kDw>(&sms);
  if (err != cudaSuccess) return err;
  CUtensorMap a, b;
  if (!encode_2d(encode, &a, true, g, V, T, ldg, 32, kBK) ||
      !encode_2d(encode, &b, false, x, d, T, d, 64, kBK))
    return cudaErrorInvalidValue;
  return launch<kDw>(a, b, dw, V, d, T, V, sms, stream);
}

const char* lm_head_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
