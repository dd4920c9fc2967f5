// The stacked decode step for Hopper (sm_90a): one KV-cached greedy position
// through all L pre-norm decoder layers (self-attention -> cross-attention -> FF
// each), in one cooperative launch.
//
//   rt_stack_step <- retr_tpu/ops/decoder_kernels.py fused_stack_step (_stack_kernel)
//                 <- retr_tpu/ops/decoder_kernels.py fused_layer_step (_layer_kernel; L = 1)
//
// Bound. Bytes: every layer's weights (2.9 MB a layer in bf16), the cross K/V
// and the self caches up to `step`. At batch 32, bf16, step 63, six layers:
// 68.7 MB, 0.0205 ms at 3.35 TB/s; at batch 512: 836 MB, 0.2496 ms, most of it
// the cross K/V (chip_smoke.py kernel_work). The operations (~2 per weight
// element per row) never bound it.
//
// Design. A position's work is a chain of skinny products ([B, 256] x [256, N],
// and [B, F] x [F, 256]) and one-query attention per (row, head). One block per
// row tile (the previous design) left 124 of 132 SMs idle at batch 32 and waited
// on one block's chain of dependent loads. Here every phase of a layer is split
// over the whole grid, and the grid is as many blocks as are co-resident (capped
// by the largest phase's work), separated by grid barriers
// (cooperative_groups::this_grid().sync(); 8 or 9 phases per layer, a barrier
// between every two):
//   P1 LN1, Q/K/V       unit = (16-row tile, 32 output columns = one head of q, k or v);
//                       writes q (scaled), k, v in f32 and the cache slot at `step`
//   P2 self-attention   unit = (row, head), 1-8 warps (attn_group: more at small
//                       batches); positions <= step, the current one from P1's f32 k/v
//   P3 out-projection   unit = (16-row tile, 32 columns); adds into the f32 residual
//   P4 LN2, cross Q     as P1 for q alone
//   P5 cross-attention  unit = (row, head) over the S memory positions, as P2
//   P6 out-projection   as P3
//   P7 LN3, FF1, ReLU   unit = (16-row tile, 32 hidden columns)
//   P8 FF2              unit = (16-row tile, 32 columns[, hidden chunk]); adds into
//                       the next layer's residual (the last layer: the output)
//   P9 (small batches)  FF2 split into up to 8 hidden chunks (ff2_split) so that
//                       its units still cover the card; P9 adds their f32
//                       products in chunk order
// Data between phases lives in f32 scratch that the wrapper allocates (residual
// [2, B, C], one half per layer parity, so FF2 can read this layer's while it
// writes the next one's; q/k/v [B, 3C]; attention output [B, C]; FF2 chunk
// products [ks, B, C]) and the FF hidden [B, F] in the storage type; it
// stays in the 50 MB L2. Reads of scratch that another block wrote use
// ld.global.cg / cp.async.cg (L2, never a stale L1 line).
//
// Products. A unit stages its activation tile [16, K] in shared memory in the
// storage type (LayerNorm recomputed per unit for its 16 rows: cheap) and streams
// its [K, 32] weight tile through a four-stage cp.async ring. bf16 runs on tensor
// cores: mma.sync.m16n8k16 (bf16 in, f32 accumulate), fragments by ldmatrix
// (.trans for the row-major [K, N] weights). f32 runs on CUDA cores with 4x4
// register tiles (TF32 would break the f32 parity). The eight warps split K and
// their partials are added in warp order, so every output element is summed in
// one fixed order whatever the grid size: two launches give the same bits.
// No float atomics anywhere.
//
// Numerics (the TPU kernels'): every product casts the activation to the weight
// type and accumulates in f32; LayerNorm (eps 1e-5, biased variance) and softmax
// (exact, divided by the sum) in f32; q = (LN(x) + qpos) Wq + bq, times 32**-0.5;
// k takes qpos, v does not; the cache stores k/v rounded, the current position
// attends with them unrounded; positions after `step` are masked, the key bias is
// clamped at -1e30; the residual stays f32 across all layers and is rounded once
// at the output. `step` is a device int32 read by the kernel.
//
// Fixed widths: C = 256, 8 heads of 32; F a multiple of 256. The wrapper in
// ops/decoder_kernels.py checks every shape. The product unit, the LayerNorm
// fill and the attention loop are in common.cuh (block_kernels.cu uses them too).

#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

// Launch arguments, mirrored field for field by _StackArgs in ops/decoder_kernels.py.
struct StackArgs {
  int B, T, S, F, L;
  int max_blocks;        // 0, or a cap on the grid (tests of grid-size independence)
  const void* x;
  void* y;
  const void* qpos;
  const void* ln1s; const void* ln1b;
  const void* swq; const void* sbq; const void* swk; const void* sbk;
  const void* swv; const void* sbv; const void* swo; const void* sbo;
  const void* ln2s; const void* ln2b;
  const void* cwq; const void* cbq; const void* cwo; const void* cbo;
  const void* ln3s; const void* ln3b;
  const void* w1; const void* b1; const void* w2; const void* b2;
  void* kc; void* vc;
  const void* ck; const void* cv;
  const float* key_bias;
  const int* step;
  float* xres;           // [2, B, C] residual, one half per layer parity (f32 scratch)
  float* qkv;            // [B, 3C] q | k | v (f32 scratch; the cross q reuses q)
  float* att;            // [B, C] attention output (f32 scratch)
  void* hid;             // [B, F] FF hidden after ReLU (storage type)
  float* part;           // [ff2_split, B, C] FF2 products per hidden chunk (f32 scratch)
  unsigned long long* trace;  // null, or [grid barriers + 2]: block 0's %globaltimer (ns)
                              // at the start, after each grid barrier and at the end
};

namespace {

constexpr int kPhases = 8;    // grid-wide phases per layer

// Hidden chunks FF2 is split into: doubled while the FF2 units of a batch of B
// rows number under 128 (about one per SM), so a small batch still spreads its
// largest product over the card. A function of B and F alone, never of the
// grid, so the sums' order is the same on any grid.
constexpr int kMaxChunks = 8;
__host__ __device__ inline int ff2_split(int B, int F) {
  const int tiles = (B + MT - 1) / MT, chunks = F / 256;
  int ks = 1;
  while (2 * ks <= kMaxChunks && chunks % (2 * ks) == 0 && tiles * NH * ks < 128) ks *= 2;
  return ks;
}

// Shared memory: [activation tile | attention scores] [weight ring] [warp partials].
template <typename T> __host__ __device__ size_t region0_bytes(int F, int T_, int S) {
  const size_t a = (size_t)MT * (F + Tile<T>::PAD) * sizeof(T);
  const size_t sc = (size_t)NW * (64 + (T_ > S ? T_ : S)) * sizeof(float);
  return align16(a > sc ? a : sc);
}
template <typename T> __host__ __device__ size_t ring_bytes() {
  return (size_t)NS * Tile<T>::KC * Tile<T>::WLD * sizeof(T);
}

template <typename T> __host__ __device__ size_t smem_bytes(const StackArgs& a) {
  return region0_bytes<T>(a.F, a.T, a.S) + ring_bytes<T>() + kRedBytes;
}

// Rows row0.. of an f32 scratch [B, C] into the activation tile, rounded to T:
// every thread's four 16-byte loads in flight at once.
template <typename T>
__device__ void fill_rows_f32(T* A, int lda, const float* src, int B, int row0) {
  constexpr int PER = MT * C / 4 / NT;
  float4 v[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = (threadIdx.x + u * NT) * 4, row = row0 + i / C;
    v[u] = row < B ? __ldcg(reinterpret_cast<const float4*>(src + (size_t)row * C + i % C))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = (threadIdx.x + u * NT) * 4;
    T* d = A + (i / C) * lda + i % C;
    d[0] = from_f<T>(v[u].x); d[1] = from_f<T>(v[u].y); d[2] = from_f<T>(v[u].z); d[3] = from_f<T>(v[u].w);
  }
}

// Columns 0..K-1 of rows row0.. of the hidden (row stride ld, already T) into
// the activation tile by cp.async (zeros past the batch); the caller commits.
template <typename T>
__device__ void fill_hidden(T* A, int lda, const T* hid, int ld, int K, int B, int row0) {
  constexpr int E = 16 / sizeof(T);
  for (int i = threadIdx.x; i < MT * K / E; i += NT) {
    const int r = i / (K / E), k = (i % (K / E)) * E, row = row0 + r;
    const T* src = hid + (size_t)(row < B ? row : 0) * ld + k;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(A + r * lda + k)),
                 "l"(src), "r"(row < B ? 16 : 0) : "memory");
  }
}

// Warps per attention unit for a batch of B rows: as many as keep the B * NH
// units near 1024 warps (128 blocks of NW), at most NW. A function of B alone,
// so the sums' order is the same on any grid.
__host__ __device__ inline int attn_group(int B) {
  int wg = NW;
  while (wg > 1 && B * NH * wg > 1024) wg /= 2;
  return wg;
}

template <typename T>
__global__ void __launch_bounds__(NT, 1) stack_kernel(const StackArgs a) {
  extern __shared__ float4 smem_raw[];
  cg::grid_group grid = cg::this_grid();
  char* base = reinterpret_cast<char*>(smem_raw);
  const Smem sm{base, base + region0_bytes<T>(a.F, a.T, a.S),
                reinterpret_cast<float*>(base + region0_bytes<T>(a.F, a.T, a.S) + ring_bytes<T>())};
  const int warp = threadIdx.x >> 5;
  const int step = *a.step;
  const int tiles = (a.B + MT - 1) / MT;
  const int ks = ff2_split(a.B, a.F), kch = a.F / ks;
  const size_t BC = (size_t)a.B * C;
  const int G = gridDim.x;
  const T* qpos = static_cast<const T*>(a.qpos);
  const T* hid = static_cast<const T*>(a.hid);
  // attention phases: the whole shared memory as one slab per warp; units of
  // wg warps each, NW / wg units per block at a time
  const int smax = a.T > a.S ? a.T : a.S;
  const size_t slab = (smem_bytes<T>(a) / NW) & ~size_t(15);
  const int wg = attn_group(a.B), ngroups = NW / wg, grp = warp / wg;
  int mark = 0;
  auto stamp = [&]() {                            // block 0's clock into the trace
    if (a.trace != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
      unsigned long long ns;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
      a.trace[mark] = ns;
    }
    ++mark;
  };
  auto barrier = [&]() {
    grid.sync();
    stamp();
  };
  stamp();

  for (int l = 0; l < a.L; ++l) {
    const size_t lc = (size_t)l * C, lcc = (size_t)l * C * C, lf = (size_t)l * a.F;
    const size_t lcf = (size_t)l * C * a.F;
    const size_t lcache = (size_t)l * a.B * NH * a.T * HD;
    const size_t lmem = (size_t)l * a.B * NH * a.S * HD;
    T* kc = static_cast<T*>(a.kc) + lcache;
    T* vc = static_cast<T*>(a.vc) + lcache;
    float* R = a.xres + (l & 1) * BC;             // this layer's residual; the next layer's
    float* Rn = a.xres + ((l + 1) & 1) * BC;      // is the other half
    const bool last = l + 1 == a.L;

    // P1: LN1 of the residual (layer 0: the input, which one unit per row tile
    // stores into R), the q/k/v products, the new k/v into the cache slot at
    // `step`.
    for (int u = blockIdx.x; u < tiles * 3 * NH; u += G) {
      const int row0 = (u / (3 * NH)) * MT, which = (u % (3 * NH)) / NH, h = u % NH;
      const T* W = static_cast<const T*>(which == 0 ? a.swq : which == 1 ? a.swk : a.swv) + lcc;
      const T* bias = static_cast<const T*>(which == 0 ? a.sbq : which == 1 ? a.sbk : a.sbv) + lc;
      product_unit<T>(
          sm, W, C, h * HD, C,
          [&](T* A, int lda) {
            fill_ln<T>(A, lda, a.B, row0,
                       [&](size_t i, int) {
                         return l == 0 ? to_f(static_cast<const T*>(a.x)[i]) : __ldcg(R + i);
                       },
                       l == 0 && which == 0 && h == 0 ? R : nullptr, static_cast<const T*>(a.ln1s) + lc,
                       static_cast<const T*>(a.ln1b) + lc, which == 2 ? nullptr : qpos);
          },
          [&](int r, int n, float s) {
            const int b = row0 + r;
            if (b >= a.B) return;
            const int c = h * HD + n;
            const float v = which == 0 ? (s + to_f(bias[c])) * kScale : s + to_f(bias[c]);
            a.qkv[(size_t)b * 3 * C + which * C + c] = v;
            if (which > 0) {
              T* cache = which == 1 ? kc : vc;
              cache[(((size_t)b * NH + h) * a.T + step) * HD + n] = from_f<T>(v);
            }
          });
    }
    barrier();

    // P2: self-attention over positions 0..step, a group of warps per (row, head).
    for (int u = blockIdx.x + G * grp; u < a.B * NH; u += G * ngroups) {
      const int b = u / NH, h = u % NH;
      const float* row = a.qkv + (size_t)b * 3 * C + h * HD;
      const size_t off = ((size_t)b * NH + h) * a.T * HD;
      attend<T>(base, slab, smax, wg, row, step + 1, step, kc + off, vc + off, row + C, row + 2 * C,
                [](int) { return 0.f; }, a.att + (size_t)b * C + h * HD, LdCg{});
    }
    barrier();

    // P3 / P6: out-projection of the attention output, added into the residual.
    auto out_proj = [&](const void* wo, const void* bo) {
      for (int u = blockIdx.x; u < tiles * NH; u += G) {
        const int row0 = (u / NH) * MT, n0 = (u % NH) * NC;
        const T* bias = static_cast<const T*>(bo) + lc;
        product_unit<T>(
            sm, static_cast<const T*>(wo) + lcc, C, n0, C,
            [&](T* A, int lda) { fill_rows_f32<T>(A, lda, a.att, a.B, row0); },
            [&](int r, int n, float s) {
              const int b = row0 + r;
              if (b >= a.B) return;
              const size_t i = (size_t)b * C + n0 + n;
              R[i] = __ldcg(R + i) + (s + to_f(bias[n0 + n]));
            });
      }
    };
    out_proj(a.swo, a.sbo);
    barrier();

    auto resid = [&](size_t i, int) { return __ldcg(R + i); };
    // P4: LN2 and the cross q product.
    for (int u = blockIdx.x; u < tiles * NH; u += G) {
      const int row0 = (u / NH) * MT, h = u % NH;
      const T* bias = static_cast<const T*>(a.cbq) + lc;
      product_unit<T>(
          sm, static_cast<const T*>(a.cwq) + lcc, C, h * HD, C,
          [&](T* A, int lda) {
            fill_ln<T>(A, lda, a.B, row0, resid, nullptr, static_cast<const T*>(a.ln2s) + lc,
                       static_cast<const T*>(a.ln2b) + lc, qpos);
          },
          [&](int r, int n, float s) {
            const int b = row0 + r;
            if (b < a.B) a.qkv[(size_t)b * 3 * C + h * HD + n] = (s + to_f(bias[h * HD + n])) * kScale;
          });
    }
    barrier();

    // P5: cross-attention over the S memory positions, a group of warps per (row, head).
    for (int u = blockIdx.x + G * grp; u < a.B * NH; u += G * ngroups) {
      const int b = u / NH, h = u % NH;
      const size_t off = lmem + ((size_t)b * NH + h) * a.S * HD;
      const float* kb = a.key_bias + (size_t)b * a.S;
      attend<T>(base, slab, smax, wg, a.qkv + (size_t)b * 3 * C + h * HD, a.S, -1,
                static_cast<const T*>(a.ck) + off,
                static_cast<const T*>(a.cv) + off, nullptr, nullptr,
                [kb](int t) { return fmaxf(__ldg(kb + t), kMaskVal); }, a.att + (size_t)b * C + h * HD,
                LdCg{});
    }
    barrier();

    out_proj(a.cwo, a.cbo);                       // P6
    barrier();

    // P7: LN3, FF1 and ReLU into the hidden (rounded to T).
    for (int u = blockIdx.x; u < tiles * (a.F / NC); u += G) {
      const int row0 = (u / (a.F / NC)) * MT, n0 = (u % (a.F / NC)) * NC;
      const T* bias = static_cast<const T*>(a.b1) + lf;
      product_unit<T>(
          sm, static_cast<const T*>(a.w1) + lcf, a.F, n0, C,
          [&](T* A, int lda) {
            fill_ln<T>(A, lda, a.B, row0, resid, nullptr, static_cast<const T*>(a.ln3s) + lc,
                       static_cast<const T*>(a.ln3b) + lc, nullptr);
          },
          [&](int r, int n, float s) {
            const int b = row0 + r;
            if (b < a.B)
              static_cast<T*>(a.hid)[(size_t)b * a.F + n0 + n] = from_f<T>(fmaxf(s + to_f(bias[n0 + n]), 0.f));
          });
    }
    barrier();

    // P8: FF2 added to the residual into the next layer's half (the last
    // layer: the output, rounded once). With ks > 1 (ff2_split) each unit
    // takes one chunk of the hidden and stores its f32 product, and P9 adds
    // the chunks in order.
    const T* b2 = static_cast<const T*>(a.b2) + lc;
    auto ff_out = [&](size_t i, float ff) {       // R + (FF2 product + b2)
      const float v = __ldcg(R + i) + (ff + to_f(b2[i % C]));
      if (last) static_cast<T*>(a.y)[i] = from_f<T>(v);
      else Rn[i] = v;
    };
    for (int u = blockIdx.x; u < tiles * NH * ks; u += G) {
      const int row0 = (u / (NH * ks)) * MT, k = (u / NH) % ks, n0 = (u % NH) * NC;
      product_unit<T>(
          sm, static_cast<const T*>(a.w2) + lcf + (size_t)k * kch * C, C, n0, kch,
          [&](T* A, int lda) { fill_hidden<T>(A, lda, hid + (size_t)k * kch, a.F, kch, a.B, row0); },
          [&](int r, int n, float s) {
            const int b = row0 + r;
            if (b >= a.B) return;
            const size_t i = (size_t)b * C + n0 + n;
            if (ks == 1) ff_out(i, s);
            else a.part[k * BC + i] = s;
          });
    }
    if (ks > 1) {
      barrier();
      // P9: the chunks' products in chunk order, each element's loads at once
      for (size_t i = (size_t)blockIdx.x * NT + threadIdx.x; i < BC; i += (size_t)G * NT) {
        float p[kMaxChunks];
#pragma unroll
        for (int k = 0; k < kMaxChunks; ++k) p[k] = k < ks ? __ldcg(a.part + k * BC + i) : 0.f;
        float ff = p[0];
#pragma unroll
        for (int k = 1; k < kMaxChunks; ++k)
          if (k < ks) ff = ff + p[k];
        ff_out(i, ff);
      }
    }
    if (!last) barrier();
  }
  stamp();
}

// Grid of a launch: blocks, co-resident blocks per SM, dynamic shared memory.
template <typename T>
int plan(const StackArgs& a, int* blocks, int* per_sm, size_t* bytes) {
  *bytes = smem_bytes<T>(a);
  auto kern = stack_kernel<T>;
  static size_t granted = 0;  // dynamic shared memory already allowed for this kernel
  if (*bytes > granted) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
    if (e != cudaSuccess) return (int)e;
    granted = *bytes;
  }
  // the SM count and occupancy of the last (device, shared memory) asked: a
  // decode loop asks the same every step, and the queries cost microseconds
  static int last_dev = -1, sms = 0, fit = 0;
  static size_t last_bytes = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && (dev != last_dev || *bytes != last_bytes)) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kern, NT, *bytes);
    last_dev = e == cudaSuccess ? dev : -1;
    last_bytes = *bytes;
  }
  if (e != cudaSuccess) return (int)e;
  *per_sm = fit;
  if (*per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // the largest phase: q/k/v or FF1 product units, or attention units / NW
  const int tiles = (a.B + MT - 1) / MT;
  int work = tiles * 3 * NH;
  if (tiles * (a.F / NC) > work) work = tiles * (a.F / NC);
  const int attn = (a.B * NH * attn_group(a.B) + NW - 1) / NW;   // attention warps / NW
  if (attn > work) work = attn;
  if (tiles * NH * ff2_split(a.B, a.F) > work) work = tiles * NH * ff2_split(a.B, a.F);
  int g = *per_sm * sms;
  if (work < g) g = work;
  if (a.max_blocks > 0 && a.max_blocks < g) g = a.max_blocks;
  *blocks = g;
  return 0;
}

template <typename T>
int launch(const StackArgs& a, cudaStream_t st) {
  int blocks = 0, per_sm = 0;
  size_t bytes = 0;
  const int rc = plan<T>(a, &blocks, &per_sm, &bytes);
  if (rc != 0) return rc;
  // a cooperative launch (the grid barriers need every block resident) given
  // as a launch attribute, which a CUDA graph's kernel node carries too, so
  // the launch can be captured (ops/graphs.py)
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* params[] = {const_cast<StackArgs*>(&a)};
  const cudaError_t e = cudaLaunchKernelExC(&cfg, (const void*)stack_kernel<T>, params);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int rt_stack_step(const StackArgs* a, int bf16, void* stream) {
  if (a->F % 256 || a->F < 256 || a->L < 1 || a->B < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(*a, st) : launch<float>(*a, st);
}

// The grid rt_stack_step would launch: out = {blocks, blocks per SM, grid
// barriers, FF2 hidden chunks}.
int rt_stack_grid(const StackArgs* a, int bf16, int* out) {
  size_t bytes = 0;
  const int rc = bf16 ? plan<__nv_bfloat16>(*a, &out[0], &out[1], &bytes) : plan<float>(*a, &out[0], &out[1], &bytes);
  out[2] = (kPhases + (ff2_split(a->B, a->F) > 1)) * a->L - 1;
  out[3] = ff2_split(a->B, a->F);
  return rc;
}

const char* rt_stack_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
