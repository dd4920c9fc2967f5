// The cross-attention and FF residual blocks of one decode position for Hopper
// (sm_90a), each one launch of thread-block clusters.
//
//   rt_ff_block         <- retr_tpu/ops/decoder_kernels.py ff_block (_ff_kernel)
//   rt_cross_attn_block <- retr_tpu/ops/decoder_kernels.py cross_attn_block (_cross_kernel)
//
// Bound. ff_block: bytes below ~300 rows (the two [256, F] weights, 2.1 MB in
// bf16 at F = 2048, against 4*B*C*F operations), operations above (0.0054 ms
// at 2560 rows in bf16). cross_attn_block: bytes, the memory K/V (2*B*H*S*D
// elements: 32.7 MB at 160 rows and S = 196 in bf16, 0.0098 ms at 3.35 TB/s).
//
// Design. The TPU kernels hold the whole FF width in VMEM (ff_block) or walk
// the heads as a sequential grid axis, accumulating the out-projection into
// the output in head order (cross_attn_block). Here a cluster of blocks takes
// that axis: its blocks run at once on neighbouring SMs, one slice each, and
// after cluster.sync() each block finishes a slice of the output columns from
// all the blocks' f32 partials, read through distributed shared memory.
//   ff_kernel: one cluster per tile of R rows, G blocks (ff_cluster: the
//     largest divisor of F/256 up to 8). Block g owns hidden columns
//     [g F/G, (g+1) F/G): LayerNorm of the R rows (recomputed per block),
//     FF1 + b1 + ReLU into shared memory rounded to the storage type (the
//     [B, F] hidden never reaches device memory), FF2's partial [R, 256] in
//     f32. Rank r then adds the G partials in chunk order for its 256/G output
//     columns, adds b2 and rounds, adds x and rounds (x + (h W2 + b2) in x's
//     type, as ff_block_plain). W1 and W2 stream as one sequence of
//     [KC, 256] stages through a cp.async ring, so FF2's first stages are in
//     flight during FF1's epilogue.
//   cross_kernel: one cluster of 8 blocks, one per head, per tile of R rows.
//     Block h: LayerNorm + qpos (rounded), q_h = . Wq[:, 32h:32h+32]
//     + bq times 32**-0.5 in f32 (product_unit), one-query attention over the
//     S memory positions, a warp per row (attend: K in 16-byte loads, eight
//     steps in flight, V rows staged by cp.async during the score pass, exact
//     softmax in f32, key bias clamped at -1e30), attn_h rounded, part_h =
//     attn_h Wo[32h:32h+32, :] in f32 from a Wo slice prefetched at the
//     start. Rank r then finishes columns [32r, 32r+32):
//     rnd(rnd(x + bo) + part_0), then rnd(acc + rnd(part_h)) for h = 1..7,
//     the TPU split kernels' rounding in head order.
// Products: bf16 on tensor cores (mma.sync.m16n8k16, ldmatrix / ldmatrix.trans
// from shared memory), f32 on CUDA cores (TF32 would break the f32 parity).
// Every warp of a row product owns 32 output columns over the whole K, so no
// partials cross warps. The row tile R is the smallest whose clusters all fit
// on the card at once (launch): 16-64 rows (ff), 4-32 (cross). No grid
// barrier, no float atomics, no device scratch: every sum runs in an order
// fixed by F and S, so repeated launches give the same bits, and so does any
// row tile R. A second cluster.sync() keeps each block's partial alive until
// its peers have read it.
//
// Fixed widths: C = 256, 8 heads of 32; F a multiple of 256. The wrappers in
// ops/decoder_kernels.py check every shape.

#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

// Launch arguments, mirrored field for field by _BlockArgs in ops/decoder_kernels.py.
struct BlockArgs {
  int B, S, F;
  int rows;              // 0, or the row tile R to use instead of launch's choice
  const void* x;
  void* y;
  const void* qpos;                                                 // cross
  const void* lns; const void* lnb;                                 // the block's LayerNorm
  const void* wq; const void* bq; const void* wo; const void* bo;   // cross
  const void* w1; const void* b1; const void* w2; const void* b2;   // ff
  const void* ck; const void* cv;                                   // cross: memory K/V [B, H, S, D]
  const float* key_bias;                                            // cross: [B, S]
};

namespace {

// Row products out[R][256] = A[R][K] . W[K][n0 .. n0 + 255]: warp w owns output
// columns 32w .. 32w + 31 over the whole K. Weight stages of KC rows x 256
// columns (~16.5 KB in either type), rows padded by 16 bytes (ldmatrix rows on
// distinct banks).
template <typename T> struct Wide {
  static constexpr int KC = sizeof(T) == 2 ? 32 : 16;
  static constexpr int PAD = 16 / sizeof(T);
  static constexpr int WLD = C + PAD;
  static constexpr int STAGE = KC * WLD;     // elements
};

// A warp's accumulators of an R-row product, [N][4] floats: bf16, the mma D
// fragments of ceil(R/16) row tiles x 4 n8 tiles; f32, an (R/4) x 4 tile
// (rows lane/8 + 4i, columns 4 (lane % 8) ..).
template <typename T, int R> struct Acc {
  static constexpr int N = sizeof(T) == 2 ? (R + 15) / 16 * 4 : R / 4;
};

template <int N> __device__ __forceinline__ void zero_acc(float (&acc)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// Weight rows k0 .. k0 + KC - 1, columns n0 .. n0 + 255 of the row-major W[.., ldw]
// into a stage (the caller commits).
template <typename T>
__device__ __forceinline__ void load_wide(T* dst, const T* W, int ldw, int k0, int n0) {
  constexpr int E = 16 / sizeof(T), SEG = C / E;
  for (int i = threadIdx.x; i < Wide<T>::KC * SEG; i += NT) {
    const int r = i / SEG, s = i % SEG;
    cp_async16(dst + r * Wide<T>::WLD + s * E, W + (size_t)(k0 + r) * ldw + n0 + s * E);
  }
}

// acc += A[:, kbase .. kbase + KC) . Wst (one stage) for the warp's 32 columns.
template <int R>
__device__ __forceinline__ void wide_stage(const __nv_bfloat16* A, int lda, int kbase, const __nv_bfloat16* Wst,
                                           float (&acc)[Acc<__nv_bfloat16, R>::N][4]) {
  using W = Wide<__nv_bfloat16>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int ks = 0; ks < W::KC / 16; ++ks) {
    uint32_t b[2][4];                              // the four n8 tiles' B fragments
#pragma unroll
    for (int np = 0; np < 2; ++np)
      ldsm_x4_trans(b[np], Wst + (ks * 16 + (lane & 15)) * W::WLD + warp * 32 + np * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int mt = 0; mt < (R + 15) / 16; ++mt) {
      uint32_t a[4];
      ldsm_x4(a, A + (mt * 16 + (lane & 15)) * lda + kbase + ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        mma_bf16(acc[mt * 4 + 2 * np], a, b[np][0], b[np][1]);
        mma_bf16(acc[mt * 4 + 2 * np + 1], a, b[np][2], b[np][3]);
      }
    }
  }
}
template <int R>
__device__ __forceinline__ void wide_stage(const float* A, int lda, int kbase, const float* Wst,
                                           float (&acc)[Acc<float, R>::N][4]) {
  using W = Wide<float>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = lane >> 3, c0 = warp * 32 + 4 * (lane & 7);
#pragma unroll 4
  for (int kk = 0; kk < W::KC; ++kk) {
    const float4 w = *reinterpret_cast<const float4*>(Wst + kk * W::WLD + c0);
#pragma unroll
    for (int i = 0; i < R / 4; ++i) {
      const float av = A[(rg + 4 * i) * lda + kbase + kk];
      acc[i][0] = fmaf(av, w.x, acc[i][0]);
      acc[i][1] = fmaf(av, w.y, acc[i][1]);
      acc[i][2] = fmaf(av, w.z, acc[i][2]);
      acc[i][3] = fmaf(av, w.w, acc[i][3]);
    }
  }
}

// fn(row, column, value) for each of the lane's accumulators (rows of the
// bf16 tile past R included; the caller skips them).
template <typename T, int R, typename Fn>
__device__ __forceinline__ void for_each_acc(const float (&acc)[Acc<T, R>::N][4], Fn fn) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if constexpr (sizeof(T) == 2) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mt = 0; mt < (R + 15) / 16; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int r = mt * 16 + g, c = warp * 32 + nt * 8 + 2 * t;
        const float* d = acc[mt * 4 + nt];
        fn(r, c, d[0]);
        fn(r, c + 1, d[1]);
        fn(r + 8, c, d[2]);
        fn(r + 8, c + 1, d[3]);
      }
  } else {
    const int rg = lane >> 3, c0 = warp * 32 + 4 * (lane & 7);
#pragma unroll
    for (int i = 0; i < R / 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) fn(rg + 4 * i, c0 + j, acc[i][j]);
  }
}

// ---------------------------------------------------------------------------------
// ff_block
// ---------------------------------------------------------------------------------

// Blocks of a cluster, one per hidden chunk: the largest divisor of F / 256 up
// to 8 (the portable cluster size), so every chunk is whole 256-column passes.
__host__ __device__ inline int ff_cluster(int F) {
  int g = 8;
  while ((F / 256) % g) --g;
  return g;
}
// Ring stages: deeper for small tiles, whose blocks are few and wait on latency.
template <int R> __host__ __device__ constexpr int ff_stages() { return R <= 16 ? 8 : R <= 32 ? 6 : 4; }

// Shared memory: LN(x) [R][C + PAD], the hidden chunk [R][F/G + PAD] (storage
// type), then the weight ring, which holds FF2's f32 partial [R][C] once drained.
template <typename T, int R> size_t ff_smem(int F) {
  using Wd = Wide<T>;
  const size_t ring = (size_t)ff_stages<R>() * Wd::STAGE * sizeof(T), part = (size_t)R * C * sizeof(float);
  return align16((size_t)R * (C + Wd::PAD) * sizeof(T)) +
         align16((size_t)R * (F / ff_cluster(F) + Wd::PAD) * sizeof(T)) + (ring > part ? ring : part);
}

template <typename T, int R>
__global__ void __launch_bounds__(NT, 1) ff_kernel(const BlockArgs a) {
  using Wd = Wide<T>;
  constexpr int NSt = ff_stages<R>();
  constexpr int kc1 = C / Wd::KC;                 // stages of one FF1 pass (K = C)
  extern __shared__ float4 smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int G = ff_cluster(a.F), g = (int)cluster.block_rank();
  const int FC = a.F / G, row0 = (int)(blockIdx.x / G) * R;
  const int lda = C + Wd::PAD, ldh = FC + Wd::PAD;
  char* base = reinterpret_cast<char*>(smem_raw);
  T* A = reinterpret_cast<T*>(base);
  T* Hs = reinterpret_cast<T*>(base + align16((size_t)R * lda * sizeof(T)));
  T* ring = reinterpret_cast<T*>(reinterpret_cast<char*>(Hs) + align16((size_t)R * ldh * sizeof(T)));
  float* part = reinterpret_cast<float*>(ring);
  const T* x = static_cast<const T*>(a.x);
  const T* w1 = static_cast<const T*>(a.w1);
  const T* w2 = static_cast<const T*>(a.w2) + (size_t)g * FC * C;
  const T* b1 = static_cast<const T*>(a.b1) + (size_t)g * FC;
  // stage i: FF1 pass i / kc1 (hidden columns g FC + 256 (i / kc1) ..), weight
  // rows KC (i % kc1) ..; then FF2, rows g FC + KC (i - n1) .. of W2
  const int n1 = FC / C * kc1, nst = n1 + FC / Wd::KC;
  auto load = [&](int i) {
    T* dst = ring + (i % NSt) * Wd::STAGE;
    if (i < n1) load_wide<T>(dst, w1, a.F, (i % kc1) * Wd::KC, g * FC + (i / kc1) * C);
    else load_wide<T>(dst, w2, C, (i - n1) * Wd::KC, 0);
  };
  for (int i = 0; i < NSt - 1; ++i) {             // one commit group per stage, NSt - 1 in flight
    if (i < nst) load(i);
    cp_async_commit();
  }
  // LayerNorm of the tile's rows, rounded (zeros past B), while they arrive
  for (int m = 0; m < R; m += MT)
    fill_ln<T>(A + m * lda, lda, a.B, row0 + m, [&](size_t i, int) { return to_f(x[i]); }, nullptr,
               static_cast<const T*>(a.lns), static_cast<const T*>(a.lnb), static_cast<const T*>(nullptr));
  float acc[Acc<T, R>::N][4];
  zero_acc(acc);
  for (int i = 0; i < nst; ++i) {
    if (i + NSt - 1 < nst) load(i + NSt - 1);
    cp_async_commit();
    cp_async_wait<NSt - 1>();
    __syncthreads();                              // stage i (and the LN tile) are in
    const bool ff1 = i < n1;
    wide_stage<R>(ff1 ? A : Hs, ff1 ? lda : ldh, (ff1 ? i % kc1 : i - n1) * Wd::KC,
                  ring + (i % NSt) * Wd::STAGE, acc);
    if (ff1 && i % kc1 == kc1 - 1) {              // an FF1 pass done: + b1, ReLU, rounded
      const int n0 = (i / kc1) * C;
      for_each_acc<T, R>(acc, [&](int r, int c, float v) {
        Hs[r * ldh + n0 + c] = from_f<T>(fmaxf(v + to_f(b1[n0 + c]), 0.f));
      });
      zero_acc(acc);
    }
    __syncthreads();                              // stage i's buffer may be refilled
  }
  cp_async_wait<0>();
  for_each_acc<T, R>(acc, [&](int r, int c, float v) { part[r * C + c] = v; });
  cluster.sync();                                 // every block's partial is written

  const int c0 = g * C / G, nc = (g + 1) * C / G - c0;
  const float* parts[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) parts[k] = cluster.map_shared_rank(part, k < G ? k : 0);
  const T* b2 = static_cast<const T*>(a.b2);
  T* y = static_cast<T*>(a.y);
  for (int i = threadIdx.x; i < R * nc; i += NT) {
    const int r = i / nc, c = c0 + i % nc;
    if (row0 + r >= a.B) continue;
    float p[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) p[k] = k < G ? parts[k][r * C + c] : 0.f;
    float s = p[0];
#pragma unroll
    for (int k = 1; k < 8; ++k)
      if (k < G) s = s + p[k];                    // chunk order
    const size_t o = (size_t)(row0 + r) * C + c;
    y[o] = from_f<T>(to_f(x[o]) + rnd<T>(s + to_f(b2[c])));
  }
  cluster.sync();                                 // the peers have read this block's partial
}

// ---------------------------------------------------------------------------------
// cross_attn_block
// ---------------------------------------------------------------------------------

constexpr size_t kSlab = 10240;      // attend's shared bytes per warp: scores, staged value rows

// Shared memory, byte offsets: the head's Wo rows [HD][C + PAD] at 0, q [R][HD]
// and the attention output [R][HD] in f32, the out-projection operand
// [max(R, MT)][HD + PAD], then one region used in turn by the q product
// (activation tile, the ring stages it fills, warp partials), attend's
// per-warp slabs and the f32 partial [R][C] that the peers read.
template <typename T> struct CrossLayout {
  size_t q, att, at, u, ring, slab, total;
  __host__ __device__ CrossLayout(int R, int S) {
    using Tl = Tile<T>;
    q = align16((size_t)HD * Wide<T>::WLD * sizeof(T));
    att = q + (size_t)R * HD * sizeof(float);
    at = att + (size_t)R * HD * sizeof(float);
    u = at + align16((size_t)(R > MT ? R : MT) * (HD + Tl::PAD) * sizeof(T));
    ring = (size_t)(C / Tl::KC < NS ? C / Tl::KC : NS) * Tl::KC * Tl::WLD * sizeof(T);
    const size_t head = align16((size_t)(64 + S) * sizeof(float));   // attend's exchange words and scores
    slab = head + (size_t)S * HD * sizeof(T);
    if (slab > kSlab) slab = head > kSlab ? head : kSlab;
    size_t r = align16((size_t)MT * (C + Tl::PAD) * sizeof(T)) + ring + kRedBytes;
    if (NW * slab > r) r = NW * slab;
    if ((size_t)R * C * sizeof(float) > r) r = (size_t)R * C * sizeof(float);
    total = u + r;
  }
};

template <typename T, int R>
__global__ void __launch_bounds__(NT, sizeof(T) == 2 ? 2 : 1) cross_kernel(const BlockArgs a) {
  using Wd = Wide<T>;
  using Tl = Tile<T>;
  extern __shared__ float4 smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int h = (int)cluster.block_rank(), row0 = (int)(blockIdx.x / NH) * R;
  const int nrows = min(R, a.B - row0);
  const CrossLayout<T> lay(R, a.S);
  char* base = reinterpret_cast<char*>(smem_raw);
  T* wo = reinterpret_cast<T*>(base);
  float* qs = reinterpret_cast<float*>(base + lay.q);
  float* att = reinterpret_cast<float*>(base + lay.att);
  T* at = reinterpret_cast<T*>(base + lay.at);
  char* u = base + lay.u;
  float* part = reinterpret_cast<float*>(u);
  const T* x = static_cast<const T*>(a.x);

  // the head's Wo rows [32h, 32h + 32), in flight through the q product and the attention
  for (int k0 = 0; k0 < HD; k0 += Wd::KC)
    load_wide<T>(wo + k0 * Wd::WLD, static_cast<const T*>(a.wo) + (size_t)h * HD * C, C, k0, 0);
  cp_async_commit();

  // q_h = (LN(x) + qpos) Wq[:, 32h:32h+32] + bq, times HD**-0.5, 16 rows a product unit
  const size_t a_bytes = align16((size_t)MT * (C + Tl::PAD) * sizeof(T));
  const Smem sm{u, u + a_bytes, reinterpret_cast<float*>(u + a_bytes + lay.ring)};
  const T* bq = static_cast<const T*>(a.bq) + h * HD;
  for (int m = 0; m < R; m += MT)
    product_unit<T>(
        sm, static_cast<const T*>(a.wq), C, h * HD, C,
        [&](T* A, int lda) {
          fill_ln<T>(A, lda, row0 + nrows, row0 + m, [&](size_t i, int) { return to_f(x[i]); }, nullptr,
                     static_cast<const T*>(a.lns), static_cast<const T*>(a.lnb), static_cast<const T*>(a.qpos));
        },
        [&](int r, int n, float s) {
          if (m + r < R) qs[(m + r) * HD + n] = (s + to_f(bq[n])) * kScale;
        });

  // one-query attention over the S memory positions, a warp per row
  const T* ck = static_cast<const T*>(a.ck);
  const T* cv = static_cast<const T*>(a.cv);
  for (int r = threadIdx.x >> 5; r < nrows; r += NW) {
    const size_t off = ((size_t)(row0 + r) * NH + h) * a.S * HD;
    const float* kb = a.key_bias + (size_t)(row0 + r) * a.S;
    attend<T>(u, lay.slab, a.S, 1, qs + r * HD, a.S, -1, ck + off, cv + off, nullptr, nullptr,
              [kb](int t) { return fmaxf(__ldg(kb + t), kMaskVal); }, att + r * HD, LdShared{});
  }
  __syncthreads();

  // part_h = rnd(attn_h) Wo[32h:32h+32, :], f32 (rows past the tile zero)
  constexpr int ldt = HD + Tl::PAD;
  for (int i = threadIdx.x; i < (R > MT ? R : MT) * HD; i += NT) {
    const int r = i / HD, d = i % HD;
    at[r * ldt + d] = from_f<T>(r < nrows ? att[r * HD + d] : 0.f);
  }
  cp_async_wait<0>();
  __syncthreads();
  float acc[Acc<T, R>::N][4];
  zero_acc(acc);
#pragma unroll
  for (int k0 = 0; k0 < HD; k0 += Wd::KC) wide_stage<R>(at, ldt, k0, wo + k0 * Wd::WLD, acc);
  for_each_acc<T, R>(acc, [&](int r, int c, float v) {
    if (r < R) part[r * C + c] = v;
  });
  cluster.sync();                                 // every head's partial is written

  const float* parts[NH];
#pragma unroll
  for (int k = 0; k < NH; ++k) parts[k] = cluster.map_shared_rank(part, k);
  const T* bo = static_cast<const T*>(a.bo);
  T* y = static_cast<T*>(a.y);
  for (int i = threadIdx.x; i < nrows * HD; i += NT) {
    const int r = i / HD, c = h * HD + i % HD;
    float p[NH];
#pragma unroll
    for (int k = 0; k < NH; ++k) p[k] = parts[k][r * C + c];
    const size_t o = (size_t)(row0 + r) * C + c;
    float v = rnd<T>(rnd<T>(to_f(x[o]) + to_f(bo[c])) + p[0]);
#pragma unroll
    for (int k = 1; k < NH; ++k) v = rnd<T>(v + rnd<T>(p[k]));   // head order
    y[o] = from_f<T>(v);
  }
  cluster.sync();                                 // the peers have read this block's partial
}

// ---------------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------------

// A kernel's cached set-up: the dynamic shared memory allowed so far, and the
// co-resident clusters of the last (device, bytes, cluster size) asked. A decode
// loop asks the same every step, and the queries cost microseconds.
struct Plan {
  size_t granted = 0, bytes = 0;
  int dev = -1, cluster = 0, fit = 0;
};

// One launch of `clusters` clusters of `cluster` blocks, or with `out` set
// only the plan: out[3] = co-resident clusters, out[4] = shared bytes per block.
// A shape where no cluster fits on the card is refused.
int launch_clusters(const void* kern, Plan& p, const BlockArgs& a, int cluster, int clusters, size_t bytes,
                    cudaStream_t st, int* out) {
  if (bytes > p.granted) {
    const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    p.granted = bytes;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * clusters);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && (dev != p.dev || bytes != p.bytes || cluster != p.cluster)) {
    e = cudaOccupancyMaxActiveClusters(&p.fit, kern, &cfg);
    p.dev = e == cudaSuccess ? dev : -1;
    p.bytes = bytes;
    p.cluster = cluster;
  }
  if (e != cudaSuccess) return (int)e;
  if (out != nullptr) {
    out[3] = p.fit;
    out[4] = (int)bytes;
    return 0;
  }
  if (p.fit < 1) return (int)cudaErrorLaunchOutOfResources;
  void* args[] = {const_cast<BlockArgs*>(&a)};
  e = cudaLaunchKernelExC(&cfg, kern, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// out (plan only, else null): {R, blocks per cluster, clusters, ...launch_clusters}
template <typename T, int R>
int ff_launch(const BlockArgs& a, cudaStream_t st, int* out) {
  static Plan plan;
  const int G = ff_cluster(a.F), tiles = (a.B + R - 1) / R;
  if (out != nullptr) {
    out[0] = R;
    out[1] = G;
    out[2] = tiles;
  }
  return launch_clusters((const void*)ff_kernel<T, R>, plan, a, G, tiles, ff_smem<T, R>(a.F), st, out);
}

template <typename T, int R>
int cross_launch(const BlockArgs& a, cudaStream_t st, int* out) {
  static Plan plan;
  const int tiles = (a.B + R - 1) / R;
  if (out != nullptr) {
    out[0] = R;
    out[1] = NH;
    out[2] = tiles;
  }
  return launch_clusters((const void*)cross_kernel<T, R>, plan, a, NH, tiles, CrossLayout<T>(R, a.S).total, st,
                         out);
}

template <typename T>
int launch_rows(const BlockArgs& a, bool cross, int R, cudaStream_t st, int* out) {
  if (cross) {
    if (R == 4) return cross_launch<T, 4>(a, st, out);
    if (R == 8) return cross_launch<T, 8>(a, st, out);
    if (R == 16) return cross_launch<T, 16>(a, st, out);
    if (R == 32) return cross_launch<T, 32>(a, st, out);
  } else {
    if (R == 16) return ff_launch<T, 16>(a, st, out);
    if (R == 32) return ff_launch<T, 32>(a, st, out);
    if (R == 64) return ff_launch<T, 64>(a, st, out);
  }
  return (int)cudaErrorInvalidValue;              // a row tile the kernel is not built for
}

// The row tile: a.rows where set, else the smallest tile whose clusters all
// fit on the card at once (one wave), else the largest. Small tiles spread a
// small batch over more SMs; past one wave, larger tiles re-read the weights
// (ff) or the q / Wo slices (cross) fewer times and leave a shorter tail. A
// row's result does not depend on the tile.
template <typename T>
int launch(const BlockArgs& a, bool cross, cudaStream_t st, int* out) {
  if (a.B < 1 || (cross ? a.S < 1 : (a.F < 256 || a.F % 256 != 0))) return (int)cudaErrorInvalidValue;
  int R = a.rows;
  if (R <= 0) {
    const int last = cross ? 32 : 64;
    for (R = cross ? 4 : 16; R < last; R *= 2) {
      int plan[5];
      const int rc = launch_rows<T>(a, cross, R, st, plan);
      if (rc != 0) return rc;
      if ((a.B + R - 1) / R <= plan[3]) break;
    }
  }
  return launch_rows<T>(a, cross, R, st, out);
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched).
int rt_ff_block(const BlockArgs* a, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(*a, false, st, nullptr) : launch<float>(*a, false, st, nullptr);
}
int rt_cross_attn_block(const BlockArgs* a, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(*a, true, st, nullptr) : launch<float>(*a, true, st, nullptr);
}

// The launch rt_cross_attn_block (cross != 0) or rt_ff_block would make: out =
// {rows per tile, blocks per cluster, clusters, co-resident clusters, shared
// bytes per block}.
int rt_block_plan(const BlockArgs* a, int cross, int bf16, int* out) {
  return bf16 ? launch<__nv_bfloat16>(*a, cross != 0, nullptr, out) : launch<float>(*a, cross != 0, nullptr, out);
}

const char* rt_block_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
