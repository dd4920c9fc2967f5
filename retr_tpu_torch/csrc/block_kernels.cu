// The cross-attention, FF and self-attention residual blocks of one decode
// position for Hopper (sm_90a), each one launch of thread-block clusters.
//
//   rt_ff_block         <- retr_tpu/ops/decoder_kernels.py ff_block (_ff_kernel)
//   rt_cross_attn_block <- retr_tpu/ops/decoder_kernels.py cross_attn_block (_cross_kernel)
//   rt_self_attn_block  <- retr_tpu/ops/decoder_kernels.py self_attn_block (_self_kernel)
//   rt_self_attn_block_beam <- retr_tpu/ops/decoder_kernels.py self_attn_block_beam
//                          (_make_self_beam_kernel)
//
// Bound. ff_block: bytes below ~300 rows (the two [256, F] weights, 2.1 MB in
// bf16 at F = 2048, against 4*B*C*F operations), operations above (0.0054 ms
// at 2560 rows in bf16). cross_attn_block: bytes, the memory K/V (2*B*H*S*D
// elements: 32.7 MB at 160 rows and S = 196 in bf16, 0.0098 ms at 3.35 TB/s).
// self_attn_block(_beam): bytes, the four [256, 256] weights below ~100 rows,
// the cache rows above (2*B*H*step*D elements: 33.5 MB at 512 rows, step 63,
// bf16, 0.0103 ms; gathered by ancestry, 168 MB at 2560 rows, 0.050 ms).
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
//   self_beam_kernel<T, Anc>: one cluster of 8 blocks, one per head, per tile
//     of R rows, R a whole number of beam groups (up to 32 rows). Block h:
//     LayerNorm + qpos (rounded) into q_h (times 32**-0.5) and k_h, LayerNorm
//     alone into v_h, from the 32-column slices of Wq, Wk, Wv, in f32 (bf16:
//     the three slices in flight at once, then one pass on tensor cores with
//     no partials across warps; f32: product_unit); slot `step` of head h of
//     the rows' caches written (rounded); then a warp per row attends over
//     positions 0..step, reading position t from row anc[i, t] of the row's
//     group (kept in shared memory as local rows; the ancestry gather: one
//     64-byte cache row per position and head in bf16, 8 positions per warp
//     step and 8 steps' 16-byte loads in flight per lane), position `step`
//     from the group's fresh f32 k/v in shared memory (the TPU kernel updated
//     the whole group's cache before reading it), exact softmax in f32;
//     part_h (Wo's rows loaded during the attention) and the reduction as
//     cross_kernel. The row tile is up to 32 rows: the products' and the
//     reduction's fixed costs are the block's, the attention the rows'.
//     self_attn_block is the same kernel without the ancestry (Anc false:
//     beam groups of one row, the Pallas _self_kernel): each row reads
//     positions 0..step-1 from its own cache row, a contiguous 64 bytes a
//     position and head in bf16, and no ancestry table is read or kept.
// Products: bf16 on tensor cores (mma.sync.m16n8k16, ldmatrix / ldmatrix.trans
// from shared memory), f32 on CUDA cores (TF32 would break the f32 parity).
// Every warp of a row product owns 32 output columns over the whole K, so no
// partials cross warps. The row tile R is the smallest whose clusters all fit
// on the card at once (launch, launch_beam): 16-64 rows (ff), 4-32 (cross),
// whole beam groups up to 32 (self beam); for self_attn_block the smallest
// whose clusters fit at one block an SM (4 rows at batch 32). No grid
// barrier, no float atomics, no device scratch: every sum runs in an order
// fixed by F and S, so repeated launches give the same bits, and so does any
// row tile R. A second cluster.sync() keeps each block's partial alive until
// its peers have read it. Only slot `step` of each self cache is written.
//
// Partial mode (a.partial, tensor parallelism): the block's parameters are one
// rank's mp slice (q/k/v and W1 by column, Wo and W2 by row), so an attention
// launch has a.H = 8 / mp heads (clusters of 4 at mp = 2, of 2 at mp = 4) and
// its q/k/v width is a.H * 32, and ff_kernel takes F / mp hidden units. The
// cluster's reduction then writes the f32 sum of its partials (heads or
// hidden chunks, in order) to y [B, C] and adds neither the bias nor the
// residual: the caller all-reduces that sum over the mp group and finishes
// the block (ops/decoder_kernels.attn_block_epilogue / ff_block_epilogue).
// Block h of a cluster of H finishes output columns [h C/H, (h+1) C/H).
//
// Fixed widths: C = 256, heads of 32 (8, or an mp slice's 1, 2 or 4); F a
// multiple of 256; beam groups of 1..8 rows; T up to the self kernels'
// shared-memory limit (BeamLayout: scores [8][T] f32 and, with the ancestry,
// src [32][T] bytes). The wrappers in ops/decoder_kernels.py check every
// shape; a launch past the limit is refused.

#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

// Launch arguments, mirrored field for field by _BlockArgs in ops/decoder_kernels.py.
struct BlockArgs {
  int B, S, F;
  int rows;              // 0, or the row tile R to use instead of launch's choice
  int T, K;              // self beam: cache length, rows of a beam group
  int H;                 // attention: heads of the launch, its cluster size (8, or an mp slice's)
  int partial;           // 1: y is the f32 sum of the partials [B, C], no bias, no residual
  const void* x;
  void* y;
  const void* qpos;                                                 // cross
  const void* lns; const void* lnb;                                 // the block's LayerNorm
  const void* wq; const void* bq; const void* wo; const void* bo;   // cross
  const void* w1; const void* b1; const void* w2; const void* b2;   // ff
  const void* ck; const void* cv;                                   // cross: memory K/V [B, H, S, D]
  const float* key_bias;                                            // cross: [B, S]
  const void* wk; const void* bk; const void* wv; const void* bv;   // self beam (and lns, lnb, qpos, wq, bq, wo, bo)
  void* kc; void* vc;                                               // self beam: caches [B, H, T, D]
  const int* step;                                                  // self beam: the position written
  const int* anc;                                                   // self beam: [B, T] row within the group
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
    if (a.partial) static_cast<float*>(a.y)[o] = s;
    else y[o] = from_f<T>(to_f(x[o]) + rnd<T>(s + to_f(b2[c])));
  }
  cluster.sync();                                 // the peers have read this block's partial
}

// The attention kernels' reduction, after cluster.sync(): block h of the nh
// finishes output columns [h C/nh, (h+1) C/nh) of its rows from every head's
// f32 out-projection part [R][C] (read through distributed shared memory):
// rnd(rnd(x + bo) + part_0), then rnd(acc + rnd(part_k)) for k = 1.., the TPU
// split kernels' rounding in head order; partial: the f32 sum of the parts in
// head order, into the f32 y.
template <typename T>
__device__ void reduce_heads(cg::cluster_group& cluster, const BlockArgs& a, float* part, int h, int nh, int row0,
                             int nrows) {
  const float* parts[NH];
#pragma unroll
  for (int k = 0; k < NH; ++k) parts[k] = cluster.map_shared_rank(part, k < nh ? k : 0);
  const T* x = static_cast<const T*>(a.x);
  const T* bo = static_cast<const T*>(a.bo);
  const int nc = C / nh, c0 = h * nc;
  for (int i = threadIdx.x; i < nrows * nc; i += NT) {
    const int r = i / nc, c = c0 + i % nc;
    float p[NH];
#pragma unroll
    for (int k = 0; k < NH; ++k) p[k] = k < nh ? parts[k][r * C + c] : 0.f;
    const size_t o = (size_t)(row0 + r) * C + c;
    if (a.partial) {
      float s = p[0];
#pragma unroll
      for (int k = 1; k < NH; ++k)
        if (k < nh) s = s + p[k];                 // head order
      static_cast<float*>(a.y)[o] = s;
    } else {
      float v = rnd<T>(rnd<T>(to_f(x[o]) + to_f(bo[c])) + p[0]);
#pragma unroll
      for (int k = 1; k < NH; ++k)
        if (k < nh) v = rnd<T>(v + rnd<T>(p[k]));   // head order
      static_cast<T*>(a.y)[o] = from_f<T>(v);
    }
  }
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
  const int h = (int)cluster.block_rank(), nh = a.H, row0 = (int)(blockIdx.x / nh) * R;
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
        sm, static_cast<const T*>(a.wq), nh * HD, h * HD, C,   // Wq [C, nh HD]
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
    const size_t off = ((size_t)(row0 + r) * nh + h) * a.S * HD;
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

  reduce_heads<T>(cluster, a, part, h, nh, row0, nrows);
  cluster.sync();                                 // the peers have read this block's partial
}


// ---------------------------------------------------------------------------------
// self_attn_block_beam
// ---------------------------------------------------------------------------------

constexpr int BR = 32;   // the most rows of a beam tile

// bf16's fused q/k/v product: the activation tile [BR][C + 8] and the three
// 32-column weight slices [3][C][HD + 8].
constexpr int kQkvLda = C + 8, kQkvLdw = HD + 8;
constexpr size_t kQkvBytes = (size_t)BR * kQkvLda * 2 + (size_t)3 * C * kQkvLdw * 2;

// Shared memory, byte offsets: q, the new k and v and the attention output
// [BR][HD] in f32 at 0, the out-projection operand [BR][HD + PAD], with the
// ancestry the rows' local source rows [BR][T] (bytes), then one region used
// in turn by the products (bf16: qkv's tiles; f32: product_unit's activation tile, ring and
// warp partials), by the warps' scores [NW][T] beside the head's Wo rows
// [HD][C + PAD] (loaded after the products), and by the f32 partial [BR][C]
// that the peers read.
template <typename T> struct BeamLayout {
  size_t kn, vn, att, at, src, u, ring, scores, wo, total;
  __host__ __device__ BeamLayout(int tmax, bool anc) {
    using Tl = Tile<T>;
    kn = (size_t)BR * HD * sizeof(float);
    vn = 2 * kn;
    att = 3 * kn;
    at = 4 * kn;
    src = at + align16((size_t)BR * (HD + Tl::PAD) * sizeof(T));
    u = src + (anc ? align16((size_t)BR * tmax) : 0);
    ring = (size_t)(C / Tl::KC < NS ? C / Tl::KC : NS) * Tl::KC * Tl::WLD * sizeof(T);
    scores = align16((size_t)tmax * sizeof(float));
    wo = NW * scores;
    size_t r = sizeof(T) == 2 ? kQkvBytes : align16((size_t)MT * (C + Tl::PAD) * sizeof(T)) + ring + kRedBytes;
    const size_t w = wo + (size_t)HD * Wide<T>::WLD * sizeof(T);
    if (w > r) r = w;
    if ((size_t)BR * C * sizeof(float) > r) r = (size_t)BR * C * sizeof(float);
    total = u + r;
  }
};

// The bf16 q/k/v product in two calls. qkv_issue: the three 32-column slices
// of Wq, Wk and Wv [C, ldw] of head h into shared memory (one cp.async group).
__device__ void qkv_issue(char* u, const __nv_bfloat16* wq, const __nv_bfloat16* wk, const __nv_bfloat16* wv, int h,
                          int ldw) {
  using T = __nv_bfloat16;
  constexpr int SEG = HD / 8;
  T* W = reinterpret_cast<T*>(u) + BR * kQkvLda;
  for (int i = threadIdx.x; i < 3 * C * SEG; i += NT) {
    const int p = i / (C * SEG), r = i / SEG % C, sg = i % SEG;
    cp_async16(W + (p * C + r) * kQkvLdw + sg * 8, (p == 0 ? wq : p == 1 ? wk : wv) + (size_t)r * ldw + h * HD + sg * 8);
  }
  cp_async_commit();
}

// qkv_compute: fill(A, lda, with_qpos) writes the LayerNorm tile (+ qpos for
// q and k); each warp takes one 16-row half and 16 of one product's 32
// columns over the whole K (mma.sync), so no partials cross warps: q and k
// with the + qpos tile (8 warps), then v with the tile refilled without it
// (4 warps). epi(p, r, c, sum): product p (0 q, 1 k, 2 v), row r, column c.
template <typename Fill, typename Epi>
__device__ void qkv_compute(char* u, Fill fill, Epi epi) {
  using T = __nv_bfloat16;
  T* A = reinterpret_cast<T*>(u);
  const T* W = A + BR * kQkvLda;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  auto product = [&](int p, int mt, int n0) {
    float acc[2][4] = {};
#pragma unroll 4
    for (int ks = 0; ks < C / 16; ++ks) {
      uint32_t af[4], bf[4];
      ldsm_x4(af, A + (mt * 16 + (lane & 15)) * kQkvLda + ks * 16 + (lane >> 4) * 8);
      ldsm_x4_trans(bf, W + (p * C + ks * 16 + (lane & 15)) * kQkvLdw + n0 + (lane >> 4) * 8);
      mma_bf16(acc[0], af, bf[0], bf[1]);
      mma_bf16(acc[1], af, bf[2], bf[3]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) epi(p, mt * 16 + g + (e >= 2 ? 8 : 0), n0 + j * 8 + 2 * t + (e & 1), acc[j][e]);
  };
  fill(A, kQkvLda, true);
  cp_async_wait<0>();
  __syncthreads();                                // the weights and the tile are in
  product(warp >> 2, (warp >> 1) & 1, (warp & 1) * 16);
  __syncthreads();
  fill(A, kQkvLda, false);
  __syncthreads();
  if (warp < 4) product(2, warp >> 1, (warp & 1) * 16);
  __syncthreads();                                // the outputs are in; the region is free
}

// Local row r's attention for head h over positions 0..step. With Anc (the
// beam block) position t comes from the cache row row0 + src[t] (src: the
// tile's local source rows, clamped into the row's group) and position `step`
// from the f32 kn / vn rows [src[step]] of the block's shared memory; without
// it (self_attn_block) every position from the row's own cache row row0 + r
// and position `step` from kn / vn row r. Lane = (8-dim group g, position
// class ts), eight positions per warp step, VU steps' loads issued before
// their sums (as attend): 128 bytes a lane in flight in either type.
template <typename T, bool Anc>
__device__ void beam_attend(float* sc, const float* q, int step, const T* kc, const T* vc, int tmax, int nh, int h,
                            const int8_t* src, int r, int row0, const float* kn, const float* vn, float* out) {
  constexpr int VU = sizeof(T) == 2 ? 8 : 4;
  const int lane = threadIdx.x & 31, g = lane & 3, ts = lane >> 2, n = step + 1;
  auto row_of = [&](int t) -> int {
    if constexpr (Anc) return src[t];
    else return r;
  };
  auto at_pos = [&](int t) { return (((size_t)(row0 + row_of(t)) * nh + h) * tmax + t) * HD + g * 8; };
  const int cur = row_of(step);                   // the fresh k/v row in shared memory
  float qv[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) qv[j] = q[g * 8 + j];
  float m = -INFINITY;
  for (int t0 = 0; t0 < n; t0 += 8 * VU) {        // the same trip count on every lane
    Raw8<T> kr[VU];
#pragma unroll
    for (int u = 0; u < VU; ++u) {
      const int t = t0 + 8 * u + ts;
      if (t < n && t != step) kr[u].load(kc + at_pos(t));
    }
#pragma unroll
    for (int u = 0; u < VU; ++u) {
      const int t = t0 + 8 * u + ts;
      float k8[8];
      if (t < n && t != step) {
        kr[u].get(k8);
      } else {                                    // the fresh slot (past n: unused)
#pragma unroll
        for (int j = 0; j < 8; ++j) k8[j] = kn[cur * HD + g * 8 + j];
      }
      float d = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) d = fmaf(qv[j], k8[j], d);
      d = d + __shfl_xor_sync(0xffffffffu, d, 1);
      d = d + __shfl_xor_sync(0xffffffffu, d, 2);   // the same sum on the four lanes
      if (t < n) {
        if (g == 0) sc[t] = d;
        m = fmaxf(m, d);
      }
    }
  }
  m = warp_max(m);
  __syncwarp();
  float sum = 0.f;
  for (int t = lane; t < n; t += 32) {
    const float e = expf(sc[t] - m);
    sc[t] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  for (int t = lane; t < n; t += 32) sc[t] = sc[t] / sum;
  __syncwarp();
  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
  for (int t0 = 0; t0 < n; t0 += 8 * VU) {
    Raw8<T> vr[VU];
#pragma unroll
    for (int u = 0; u < VU; ++u) {
      const int t = t0 + 8 * u + ts;
      if (t < n && t != step) vr[u].load(vc + at_pos(t));
    }
#pragma unroll
    for (int u = 0; u < VU; ++u) {
      const int t = t0 + 8 * u + ts;
      if (t < n) {
        float v8[8];
        if (t != step) {
          vr[u].get(v8);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) v8[j] = vn[cur * HD + g * 8 + j];
        }
        const float p = sc[t];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] = fmaf(p, v8[j], acc[j]);
      }
    }
  }
#pragma unroll
  for (int o = 4; o < 32; o <<= 1)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
  if (ts == 0)
#pragma unroll
    for (int j = 0; j < 8; ++j) out[g * 8 + j] = acc[j];
  __syncwarp();                                   // the scores are reused by the warp's next row
}

// a.rows: the rows of a tile (whole beam groups, at most BR); two blocks an SM.
// Anc: the beam block (a.anc read); else self_attn_block (groups of one row).
template <typename T, bool Anc>
__global__ void __launch_bounds__(NT, 2) self_beam_kernel(const BlockArgs a) {
  using Wd = Wide<T>;
  using Tl = Tile<T>;
  extern __shared__ float4 smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int h = (int)cluster.block_rank(), nh = a.H, R = a.rows, row0 = (int)(blockIdx.x / nh) * R;
  const int nrows = min(R, a.B - row0), step = *a.step;
  const BeamLayout<T> lay(a.T, Anc);
  char* base = reinterpret_cast<char*>(smem_raw);
  float* qs = reinterpret_cast<float*>(base);
  float* kn = reinterpret_cast<float*>(base + lay.kn);
  float* vn = reinterpret_cast<float*>(base + lay.vn);
  float* att = reinterpret_cast<float*>(base + lay.att);
  T* at = reinterpret_cast<T*>(base + lay.at);
  int8_t* src = reinterpret_cast<int8_t*>(base + lay.src);
  char* u = base + lay.u;
  T* wo = reinterpret_cast<T*>(u + lay.wo);
  float* part = reinterpret_cast<float*>(u);
  const T* x = static_cast<const T*>(a.x);
  T* kc = static_cast<T*>(a.kc);
  T* vc = static_cast<T*>(a.vc);
  const T* wq = static_cast<const T*>(a.wq);
  const T* wk = static_cast<const T*>(a.wk);
  const T* wv = static_cast<const T*>(a.wv);
  if constexpr (sizeof(T) == 2) qkv_issue(u, wq, wk, wv, h, nh * HD);   // in flight while the ancestry is read

  // the local source row of each (row, position <= step): the row's group base
  // + its ancestor, clamped into the group so no value of anc reaches outside it
  if constexpr (Anc) {
    const int n = step + 1;
    for (int i = threadIdx.x; i < nrows * n; i += NT) {
      const int r = i / n, t = i % n;
      src[r * a.T + t] = (int8_t)(r / a.K * a.K + min(max(__ldg(a.anc + (size_t)(row0 + r) * a.T + t), 0), a.K - 1));
    }
    __syncthreads();
  }

  // q_h = ((LN(x) + qpos) Wq + bq) * HD**-0.5, k_h = (LN(x) + qpos) Wk + bk,
  // v_h = LN(x) Wv + bv: the 32 columns of head h (bf16: qkv_compute on tensor
  // cores; f32: product units on CUDA cores, 16 rows each)
  const T* lns = static_cast<const T*>(a.lns);
  const T* lnb = static_cast<const T*>(a.lnb);
  const T* qpos = static_cast<const T*>(a.qpos);
  const T* bq = static_cast<const T*>(a.bq) + h * HD;
  const T* bk = static_cast<const T*>(a.bk) + h * HD;
  const T* bv = static_cast<const T*>(a.bv) + h * HD;
  auto fill16 = [&](T* A, int lda, int m, bool with_qpos) {   // rows m .. m + 15 of the tile
    fill_ln<T>(A, lda, row0 + nrows, row0 + m, [&](size_t i, int) { return to_f(x[i]); }, nullptr, lns, lnb,
               with_qpos ? qpos : static_cast<const T*>(nullptr));
  };
  auto epi = [&](int p, int r, int c, float v) {
    if (p == 0) qs[r * HD + c] = (v + to_f(bq[c])) * kScale;
    else if (p == 1) kn[r * HD + c] = v + to_f(bk[c]);
    else vn[r * HD + c] = v + to_f(bv[c]);
  };
  if constexpr (sizeof(T) == 2) {
    qkv_compute(u, [&](T* A, int lda, bool with_qpos) {
      for (int m = 0; m < BR; m += MT) fill16(A + m * lda, lda, m, with_qpos);
    }, epi);
  } else {
    const size_t a_bytes = align16((size_t)MT * (C + Tl::PAD) * sizeof(T));
    const Smem sm{u, u + a_bytes, reinterpret_cast<float*>(u + a_bytes + lay.ring)};
    for (int m = 0; m < R; m += MT)
#pragma unroll
      for (int p = 0; p < 3; ++p)
        product_unit<T>(sm, p == 0 ? wq : p == 1 ? wk : wv, nh * HD, h * HD, C,
                        [&](T* A, int lda) { fill16(A, lda, m, p < 2); },
                        [&](int r, int c, float v) { epi(p, m + r, c, v); });
  }

  // the head's Wo rows [32h, 32h + 32), in flight through the attention
  for (int k0 = 0; k0 < HD; k0 += Wd::KC)
    load_wide<T>(wo + k0 * Wd::WLD, static_cast<const T*>(a.wo) + (size_t)h * HD * C, C, k0, 0);
  cp_async_commit();

  // slot `step` of head h in the rows' caches, rounded to the cache type
  for (int i = threadIdx.x; i < nrows * HD; i += NT) {
    const int r = i / HD, d = i % HD;
    const size_t off = (((size_t)(row0 + r) * nh + h) * a.T + step) * HD + d;
    kc[off] = from_f<T>(kn[i]);
    vc[off] = from_f<T>(vn[i]);
  }

  // a warp per row: the attention (gathered by ancestry with Anc)
  float* sc = reinterpret_cast<float*>(u + (threadIdx.x >> 5) * lay.scores);
  for (int r = threadIdx.x >> 5; r < nrows; r += NW)
    beam_attend<T, Anc>(sc, qs + r * HD, step, kc, vc, a.T, nh, h, src + r * a.T, r, row0, kn, vn, att + r * HD);
  __syncthreads();

  // part_h = rnd(attn_h) Wo[32h:32h+32, :], f32 (rows past the tile zero)
  constexpr int ldt = HD + Tl::PAD;
  for (int i = threadIdx.x; i < BR * HD; i += NT) {
    const int r = i / HD, d = i % HD;
    at[r * ldt + d] = from_f<T>(r < nrows ? att[r * HD + d] : 0.f);
  }
  cp_async_wait<0>();
  __syncthreads();
  float acc[Acc<T, BR>::N][4];
  zero_acc(acc);
#pragma unroll
  for (int k0 = 0; k0 < HD; k0 += Wd::KC) wide_stage<BR>(at, ldt, k0, wo + k0 * Wd::WLD, acc);
  __syncthreads();                                // Wo is read; the partial overwrites it
  for_each_acc<T, BR>(acc, [&](int r, int c, float v) { part[r * C + c] = v; });
  cluster.sync();                                 // every head's partial is written

  reduce_heads<T>(cluster, a, part, h, nh, row0, nrows);
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

// A refused call's code, with the runtime's last error cleared, so that the
// next launch's cudaGetLastError() reports that launch alone.
int refused(cudaError_t e) {
  cudaGetLastError();
  return (int)e;
}

// One launch of `clusters` clusters of `cluster` blocks, or with `out` set
// only the plan: out[3] = co-resident clusters, out[4] = shared bytes per block.
// A shape where no cluster fits on the card (more shared bytes than a block
// may have) is refused.
int launch_clusters(const void* kern, Plan& p, const BlockArgs& a, int cluster, int clusters, size_t bytes,
                    cudaStream_t st, int* out) {
  if (bytes > p.granted) {
    const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return refused(e);
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
  if (e != cudaSuccess) return refused(e);
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
    out[1] = a.H;
    out[2] = tiles;
  }
  return launch_clusters((const void*)cross_kernel<T, R>, plan, a, a.H, tiles, CrossLayout<T>(R, a.S).total, st,
                         out);
}

// a.rows: the rows of a tile, whole beam groups
template <typename T, bool Anc>
int beam_launch(const BlockArgs& a, cudaStream_t st, int* out) {
  static Plan plan;
  const int tiles = (a.B + a.rows - 1) / a.rows;
  if (out != nullptr) {
    out[0] = a.rows;
    out[1] = a.H;
    out[2] = tiles;
  }
  return launch_clusters((const void*)self_beam_kernel<T, Anc>, plan, a, a.H, tiles, BeamLayout<T>(a.T, Anc).total,
                         st, out);
}

// The row tile: a.rows where set (a whole number of groups, at most BR rows),
// else as launch: the smallest of K, 2K, 4K, ... whose clusters all fit on the
// card at once, else the most whole groups that fit BR rows. Without the
// ancestry (self_attn_block, groups of one row) the smallest of 1, 2, 4, ...
// whose clusters take at most half the co-resident ones, as if one block an
// SM: on the H100 at 32 rows 2-row tiles (16 of 30 clusters) took 0.0148 ms
// in bf16, 4-row tiles 0.0120 and 8-row ones 0.0122; at 512 rows the 32-row
// tile was the fastest of all (chip_smoke.py --block-rows).
// An attention launch's heads: 8, or with a.partial an mp slice's 1, 2, 4 or 8.
inline bool heads_ok(const BlockArgs& a) {
  return a.partial ? a.H >= 1 && a.H <= NH && NH % a.H == 0 : a.H == NH;
}

template <typename T, bool Anc>
int launch_beam(const BlockArgs& a, cudaStream_t st, int* out) {
  if (a.B < 1 || a.T < 1 || a.K < 1 || a.K > 8 || a.B % a.K != 0 || (!Anc && a.K != 1) || !heads_ok(a))
    return (int)cudaErrorInvalidValue;
  BlockArgs b = a;
  if (b.rows <= 0) {
    const int rmax = BR / a.K * a.K;
    for (b.rows = a.K; b.rows < rmax; b.rows = min(2 * b.rows, rmax)) {
      int plan[5];
      const int rc = beam_launch<T, Anc>(b, st, plan);
      if (rc != 0) return rc;
      if ((a.B + b.rows - 1) / b.rows <= (Anc ? plan[3] : plan[3] / 2)) break;
    }
  } else if (b.rows % a.K != 0 || b.rows > BR) {
    return (int)cudaErrorInvalidValue;
  }
  return beam_launch<T, Anc>(b, st, out);
}

template <bool Anc>
int launch_self(const BlockArgs& a, int bf16, cudaStream_t st, int* out) {
  return bf16 ? launch_beam<__nv_bfloat16, Anc>(a, st, out) : launch_beam<float, Anc>(a, st, out);
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
  if (a.B < 1 || (cross ? a.S < 1 || !heads_ok(a) : (a.F < 256 || a.F % 256 != 0))) return (int)cudaErrorInvalidValue;
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
int rt_self_attn_block_beam(const BlockArgs* a, int bf16, void* stream) {
  if (a->anc == nullptr) return (int)cudaErrorInvalidValue;
  return launch_self<true>(*a, bf16, static_cast<cudaStream_t>(stream), nullptr);
}
// a->K = 1; a->anc is not read
int rt_self_attn_block(const BlockArgs* a, int bf16, void* stream) {
  return launch_self<false>(*a, bf16, static_cast<cudaStream_t>(stream), nullptr);
}

// The launch rt_ff_block (kind 0), rt_cross_attn_block (1),
// rt_self_attn_block_beam (2) or rt_self_attn_block (3) would make: out =
// {rows per tile, blocks per cluster, clusters, co-resident clusters, shared
// bytes per block}.
int rt_block_plan(const BlockArgs* a, int kind, int bf16, int* out) {
  if (kind == 2) return launch_self<true>(*a, bf16, nullptr, out);
  if (kind == 3) return launch_self<false>(*a, bf16, nullptr, out);
  return bf16 ? launch<__nv_bfloat16>(*a, kind == 1, nullptr, out) : launch<float>(*a, kind == 1, nullptr, out);
}

const char* rt_block_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
