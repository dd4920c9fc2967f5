// Device helpers shared by the CUDA sources: storage conversions and warp
// reductions (every source); the model's fixed widths, the
// tensor-core product unit, the LayerNorm fill and the one-query attention
// loop (stack_kernels.cu and block_kernels.cu). ops/cuda_build.py hashes this
// header into every library's name, so an edit here rebuilds them all.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round to the storage type and back: the identity in f32.
template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

constexpr int C = 256;        // model width
constexpr int NH = 8;         // heads
constexpr int HD = 32;        // head dim
constexpr int NT = 256;       // threads per block
constexpr int NW = NT / 32;   // warps
constexpr int MT = 16;        // rows of a product unit (the mma M)
constexpr int NC = 32;        // columns of a product unit (one head)
constexpr float kScale = 0.176776695296636881f;  // HD ** -0.5 in f32
constexpr float kMaskVal = -1e30f;

// Product tiling per storage type: KC weight rows per ring stage, NS stages in
// the ring, PAD elements of row padding (16 bytes: ldmatrix rows then fall on
// distinct banks).
constexpr int NS = 4;
template <typename T> struct Tile {
  static constexpr int KC = sizeof(T) == 2 ? 256 : 128;
  static constexpr int PAD = 16 / sizeof(T);
  static constexpr int WLD = NC + PAD;          // weight stage row stride
  static constexpr int SEG = NC * sizeof(T) / 16;  // 16-byte pieces per weight row
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// product_unit's warp partials [NW][MT][NC], f32
constexpr size_t kRedBytes = (size_t)NW * MT * NC * sizeof(float);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
// D += A B for one m16n8k16 tile: bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Smem {
  char* r0;      // activation tile [MT][K + PAD] (storage type) | scores [NW][max(T, S)] f32
  char* ring;    // two weight stages [KC][WLD]
  float* red;    // [NW][MT][NC] warp partials
};

// Copy weight rows k0..k0+KC-1, columns n0..n0+NC-1 of the row-major W[.., ldw]
// into a ring stage (the caller commits).
template <typename T>
__device__ void load_stage(T* dst, const T* W, int ldw, int k0, int n0) {
  using Tl = Tile<T>;
  constexpr int E = 16 / sizeof(T);
  for (int i = threadIdx.x; i < Tl::KC * Tl::SEG; i += NT) {
    const int r = i / Tl::SEG, s = i % Tl::SEG;
    cp_async16(dst + r * Tl::WLD + s * E, W + (size_t)(k0 + r) * ldw + n0 + s * E);
  }
}

// Warp `warp`'s share of one ring stage: weight rows warp*KC/NW.. of the stage
// against the matching activation columns, into acc: bf16, the four n8 tiles'
// mma fragments; f32, a 4x4 tile (rows 4*(lane/8).., columns 4*(lane%8)..).
__device__ __forceinline__ void stage_product(const __nv_bfloat16* A, int lda, int kbase,
                                              const __nv_bfloat16* Wst, float (&acc)[4][4]) {
  using Tl = Tile<__nv_bfloat16>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int KW = Tl::KC / NW;                 // 32 rows: two k16 steps
#pragma unroll
  for (int ks = 0; ks < KW / 16; ++ks) {
    const int kr = warp * KW + ks * 16;           // row within the stage
    uint32_t a[4];
    ldsm_x4(a, A + (lane & 15) * lda + kbase + kr + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < NC / 16; ++np) {        // two n8 tiles per ldmatrix
      uint32_t b[4];
      ldsm_x4_trans(b, Wst + (kr + (lane & 15)) * Tl::WLD + np * 16 + (lane >> 4) * 8);
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}
__device__ __forceinline__ void stage_product(const float* A, int lda, int kbase, const float* Wst,
                                              float (&acc)[4][4]) {
  using Tl = Tile<float>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int KW = Tl::KC / NW;                 // 16 rows
  const int r0 = 4 * (lane >> 3), c0 = 4 * (lane & 7);
#pragma unroll 4
  for (int kk = 0; kk < KW; ++kk) {
    const int kr = warp * KW + kk;
    const float4 w = *reinterpret_cast<const float4*>(Wst + kr * Tl::WLD + c0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float av = A[(r0 + i) * lda + kbase + kr];
      acc[i][0] = fmaf(av, w.x, acc[i][0]);
      acc[i][1] = fmaf(av, w.y, acc[i][1]);
      acc[i][2] = fmaf(av, w.z, acc[i][2]);
      acc[i][3] = fmaf(av, w.w, acc[i][3]);
    }
  }
}

// Lane's accumulators into red[warp][row][col] (the layouts of the two paths).
template <typename T> __device__ __forceinline__ void store_partials(float* red, const float (&acc)[4][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* w = red + warp * MT * NC;
  if constexpr (sizeof(T) == 2) {                 // mma D fragments
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int nt = 0; nt < NC / 8; ++nt) {
      const int c = nt * 8 + 2 * t;
      w[g * NC + c] = acc[nt][0];
      w[g * NC + c + 1] = acc[nt][1];
      w[(g + 8) * NC + c] = acc[nt][2];
      w[(g + 8) * NC + c + 1] = acc[nt][3];
    }
  } else {                                        // 4x4 register tile
    const int r0 = 4 * (lane >> 3), c0 = 4 * (lane & 7);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) w[(r0 + i) * NC + c0 + j] = acc[i][j];
  }
}

// One product unit: out[r][n] = sum_k A[r][k] W[k][n0 + n] for the MT x NC tile.
// fill(A, lda) writes the activation tile (rows past the batch as zeros; its
// cp.async copies join the first stage's group) while the first weight stage
// is in flight; epi(r, n, sum) consumes each output once.
template <typename T, typename Fill, typename Epi>
__device__ void product_unit(const Smem& sm, const T* W, int ldw, int n0, int K, Fill fill, Epi epi) {
  using Tl = Tile<T>;
  T* A = reinterpret_cast<T*>(sm.r0);
  T* ring = reinterpret_cast<T*>(sm.ring);
  const int lda = K + Tl::PAD;
  const int stages = K / Tl::KC;
  // one commit group per stage (empty past the last), NS - 1 in flight
  load_stage<T>(ring, W, ldw, 0, n0);
  fill(A, lda);
  cp_async_commit();
  for (int s = 1; s < NS - 1; ++s) {
    if (s < stages) load_stage<T>(ring + s * Tl::KC * Tl::WLD, W, ldw, s * Tl::KC, n0);
    cp_async_commit();
  }
  float acc[4][4];                                // NC / 8 == 4 n8 tiles, or 4x4
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int s = 0; s < stages; ++s) {
    const int nx = s + NS - 1;
    if (nx < stages) load_stage<T>(ring + (nx % NS) * Tl::KC * Tl::WLD, W, ldw, nx * Tl::KC, n0);
    cp_async_commit();
    cp_async_wait<NS - 1>();
    __syncthreads();                              // stage s and the activation tile are in
    stage_product(A, lda, s * Tl::KC, ring + (s % NS) * Tl::KC * Tl::WLD, acc);
    __syncthreads();                              // stage s's buffer may be refilled
  }
  store_partials<T>(sm.red, acc);
  __syncthreads();
  for (int i = threadIdx.x; i < MT * NC; i += NT) {
    const int r = i / NC, n = i % NC;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) s += sm.red[w * MT * NC + i];   // warp order: fixed
    epi(r, n, s);
  }
  __syncthreads();                                // shared memory free for the next unit
}

// LayerNorm of rows row0.. of the residual into the activation tile, plus qpos
// where given, rounded to T. src(i, c) is residual element i (column c); each
// warp loads its MT / NW rows and the lane's LayerNorm columns at once.
// init_res: also store the loaded rows there.
template <typename T, typename Src>
__device__ void fill_ln(T* A, int lda, int B, int row0, Src src, float* init_res, const T* scale,
                        const T* bias, const T* qpos) {
  constexpr int RW = MT / NW, J = C / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float v[RW][J], ps[J], pb[J], pq[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = lane + 32 * j;
    ps[j] = to_f(scale[c]);
    pb[j] = to_f(bias[c]);
    pq[j] = qpos != nullptr ? to_f(qpos[c]) : 0.f;
  }
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int row = row0 + warp + NW * rr;
#pragma unroll
    for (int j = 0; j < J; ++j) v[rr][j] = src((size_t)(row < B ? row : 0) * C + lane + 32 * j, lane + 32 * j);
  }
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int r = warp + NW * rr, row = row0 + r;
    if (row >= B) {
      for (int c = lane; c < C; c += 32) A[r * lda + c] = from_f<T>(0.f);
      continue;
    }
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) s += v[rr][j];
    const float mean = warp_sum(s) / C;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const float d = v[rr][j] - mean;
      q += d * d;
    }
    const float inv = rsqrtf(warp_sum(q) / C + 1e-5f);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = lane + 32 * j;
      float o = (v[rr][j] - mean) * inv * ps[j] + pb[j];
      if (qpos != nullptr) o = o + pq[j];
      A[r * lda + c] = from_f<T>(o);
      if (init_res != nullptr) init_res[(size_t)row * C + c] = v[rr][j];
    }
  }
}

// Eight consecutive elements as loaded (16 or 32 bytes), converted later: a
// warp step issues all its loads before the first use.
template <typename T> struct Raw8;
template <> struct Raw8<__nv_bfloat16> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) { u = *reinterpret_cast<const uint4*>(p); }
  __device__ __forceinline__ void get(float* o) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};
template <> struct Raw8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = reinterpret_cast<const float4*>(p)[0];
    b = reinterpret_cast<const float4*>(p)[1];
  }
  __device__ __forceinline__ void get(float* o) const {
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  }
};

// Loaders of attend's q and current k/v: through L2 (ld.global.cg, never a
// stale L1 line), or plain (shared memory).
struct LdCg {
  __device__ __forceinline__ float operator()(const float* p) const { return __ldcg(p); }
};
struct LdShared {
  __device__ __forceinline__ float operator()(const float* p) const { return *p; }
};

__device__ __forceinline__ void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// One query (row b, head h) against n keys, by a group of wg warps (warp
// wi = warp % wg of the group takes positions [lo, hi), consecutive 8-aligned
// slices), exact softmax, the attention output into out. Key/value position t
// is read at kbase/vbase + t*HD (storage type) except t == cur, which comes
// from the f32 kn/vn; bias(t) is added to each score. Each warp's shared slab
// holds its exchange words (max, sum, 32 output partials), its scores, and as
// many of its value rows as fit, copied by cp.async so they arrive during the
// score pass. The group combines max, sum and outputs in warp order. Lane =
// (8-dim group g, position class ts): a position's 32 dims are four lanes'
// 16-byte loads, eight positions per warp step; VU steps' loads are issued
// before their sums. ld(p) loads q and the current position's k/v: LdCg for
// device scratch another block wrote, LdShared for the block's shared memory.
template <typename T, typename Bias, typename Ld>
__device__ void attend(char* slabs, size_t slab, int smax, int wg, const float* q, int n, int cur,
                       const T* kbase, const T* vbase, const float* kn, const float* vn, Bias bias,
                       float* out, Ld ld) {
  constexpr int VU = 8, XW = 64;                  // steps in flight; exchange words
  constexpr int E = 16 / sizeof(T), SEGS = HD / E;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane & 3, ts = lane >> 2;
  const int wi = warp % wg, w0 = warp - wi, bar = 1 + warp / wg;
  float* xch = reinterpret_cast<float*>(slabs + warp * slab);
  float* sc = xch + XW;
  const size_t head = align16((size_t)(XW + smax) * sizeof(float));
  T* vs = reinterpret_cast<T*>(slabs + warp * slab + head);
  const int per = ((n + wg - 1) / wg + 7) & ~7;
  const int lo = min(n, wi * per), cnt = min(n, lo + per) - lo;
  const int nv = min(cnt, (int)((slab - head) / (HD * sizeof(T))));
  for (int i = lane; i < nv * SEGS; i += 32)
    cp_async16(vs + i * E, vbase + (size_t)lo * HD + (size_t)i * E);  // rows lo.. are contiguous
  cp_async_commit();
  // the current position's f32 k/v (self-attention), the lane's 8 dims
  float kn8[8], vn8[8], qv[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    kn8[j] = cur >= 0 ? ld(kn + g * 8 + j) : 0.f;
    vn8[j] = cur >= 0 ? ld(vn + g * 8 + j) : 0.f;
    qv[j] = ld(q + g * 8 + j);
  }
  float m = -INFINITY;
  for (int t0 = 0; t0 < cnt; t0 += 8 * VU) {      // the same trip count on every lane
    Raw8<T> kr[VU];
    float bv[VU];
#pragma unroll
    for (int u = 0; u < VU; ++u) {
      const int tl = t0 + 8 * u + ts, t = lo + (tl < cnt ? tl : 0);
      kr[u].load(kbase + (size_t)t * HD + g * 8);
      bv[u] = bias(t);
    }
#pragma unroll
    for (int u = 0; u < VU; ++u) {
      const int tl = t0 + 8 * u + ts;
      float k8[8];
      kr[u].get(k8);
      if (lo + tl == cur) {
#pragma unroll
        for (int j = 0; j < 8; ++j) k8[j] = kn8[j];
      }
      float d = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) d = fmaf(qv[j], k8[j], d);
      d = d + __shfl_xor_sync(0xffffffffu, d, 1);
      d = d + __shfl_xor_sync(0xffffffffu, d, 2);   // the same sum on the four lanes
      if (tl < cnt) {
        d = d + bv[u];
        if (g == 0) sc[tl] = d;
        m = fmaxf(m, d);
      }
    }
  }
  m = warp_max(m);
  if (wg > 1) {                                   // the group's max (exact in any order)
    if (lane == 0) xch[0] = m;
    group_sync(bar, wg * 32);
    for (int k = 0; k < wg; ++k) m = fmaxf(m, reinterpret_cast<const float*>(slabs + (w0 + k) * slab)[0]);
  }
  __syncwarp();
  float sum = 0.f;
  for (int t = lane; t < cnt; t += 32) {
    const float e = expf(sc[t] - m);
    sc[t] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  if (wg > 1) {                                   // the group's sum, in warp order
    if (lane == 0) xch[1] = sum;
    group_sync(bar, wg * 32);
    sum = 0.f;
    for (int k = 0; k < wg; ++k) sum += reinterpret_cast<const float*>(slabs + (w0 + k) * slab)[1];
  }
  for (int t = lane; t < cnt; t += 32) sc[t] = sc[t] / sum;
  cp_async_wait<0>();
  __syncwarp();                                   // the scores and the staged rows are in
  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
  for (int t0 = 0; t0 < cnt; t0 += 8 * VU) {
    Raw8<T> vr[VU];
    float p[VU];
#pragma unroll
    for (int u = 0; u < VU; ++u) {
      const int tl0 = t0 + 8 * u + ts, tl = tl0 < cnt ? tl0 : 0;
      p[u] = sc[tl];
      vr[u].load(tl < nv ? vs + (size_t)tl * HD + g * 8 : vbase + (size_t)(lo + tl) * HD + g * 8);
    }
#pragma unroll
    for (int u = 0; u < VU; ++u) {
      const int tl = t0 + 8 * u + ts;
      float v8[8];
      vr[u].get(v8);
      if (lo + tl == cur) {
#pragma unroll
        for (int j = 0; j < 8; ++j) v8[j] = vn8[j];
      }
      if (tl < cnt) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] = fmaf(p[u], v8[j], acc[j]);
      }
    }
  }
#pragma unroll
  for (int o = 4; o < 32; o <<= 1)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
  if (wg > 1) {                                   // the group's output, in warp order
    if (ts == 0)
#pragma unroll
      for (int j = 0; j < 8; ++j) xch[2 + g * 8 + j] = acc[j];
    group_sync(bar, wg * 32);
    if (wi == 0 && ts == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = 0.f;
      for (int k = 0; k < wg; ++k) {
        const float* x = reinterpret_cast<const float*>(slabs + (w0 + k) * slab) + 2 + g * 8;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] += x[j];
      }
    }
  }
  if (wi == 0 && ts == 0) {
    float4* dst = reinterpret_cast<float4*>(out + g * 8);
    dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
  __syncwarp();                                   // the slab is reused by the warp's next unit
}

}  // namespace
