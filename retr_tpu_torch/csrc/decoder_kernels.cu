// Self-attention kernel for Hopper (sm_90a): one KV-cached decode position
// through the self-attention block of a pre-norm decoder layer.
//
// The entry point is the counterpart of a Pallas kernel of
// retr_tpu/ops/decoder_kernels.py:
//   rt_self_attn_block   <- self_attn_block   (LN -> +qpos -> Q/K/V -> write one cache slot
//                                              -> attention over positions <= step -> out-proj -> +x)
// The stacked step (fused_stack_step, fused_layer_step) is stack_kernels.cu; the
// cross-attention, FF and beam self-attention blocks (cross_attn_block,
// ff_block, self_attn_block_beam) are block_kernels.cu.
//
// Design. The work of one decode position is a chain of skinny products
// ([rows, 256] x [256, N]) plus one-query attention over per-row caches. On the
// H100 it is bound by bytes (weights, self caches), not by operations.
// One thread block owns a tile of R rows for the whole chain and keeps their
// residual in shared memory in f32, so nothing but the inputs, the one new cache
// slot and the output touches device memory. Weights stream from global memory
// in 16-byte loads with eight loads in flight per thread; row tiles after the
// first read them from L2. Only the slot at `step` of each self cache is
// written (the TPU kernel wrote whole cache blocks back).
//
// Numerics follow the TPU kernels: every product casts the activation to the
// weight type and accumulates in f32; LayerNorm and softmax run in f32; the
// current position's attention uses the unrounded f32 k/v while the cache stores
// them rounded; the kernels round the residual to the storage type after each
// head's out-projection part (head order), as the TPU split kernels do.
//
// Fixed widths: C = 256, 8 heads of 32 (the served model). The wrappers in
// ops/decoder_kernels.py check every shape.

#include <stdint.h>

#include "common.cuh"

// Launch arguments, mirrored field for field by _Args in ops/decoder_kernels.py.
struct Args {
  int B, T;
  const void* x;
  void* y;
  const void* qpos;
  const void* ln1s; const void* ln1b;
  const void* swq; const void* sbq; const void* swk; const void* sbk;
  const void* swv; const void* sbv; const void* swo; const void* sbo;
  void* kc; void* vc;
  const int* step;
};

namespace {

// C, NH, HD, NT and NW (warps = K slices of a product, one head each for K = C)
// come from common.cuh.
constexpr int KS = C / NW;    // rows of the weight each warp reads
constexpr int U = 8;          // weight rows in flight per thread
// Rows per block. On the H100 (700 W) 4 was the fastest or tied of 2/4/8 for every
// kernel at batch 32 and 512: smaller tiles re-read the weights from more blocks,
// larger ones leave SMs idle and hold more shared memory.
constexpr int kRows = 4;

// Floats of the shared reduction area: product partials or attention scores.
template <int R>
__host__ __device__ size_t red_floats(int smax) {
  const size_t prod = (size_t)NW * R * 256, sc = (size_t)R * NH * smax;
  return prod > sc ? prod : sc;
}

// Shared-memory working set of one row tile (all f32).
template <int R>
struct RowSmem {
  float* x;    // [R][C] residual
  float* t;    // [R][C] LayerNorm output / q
  float* a;    // [R][C] rounded product input
  float* b;    // [R][C] rounded product input (v path) / FF accumulator
  float* kn;   // [R][C] new key (f32)
  float* vn;   // [R][C] new value (f32)
  float* att;  // [R][C] attention output (f32)
  float* red;  // union: [NW][R][256] product partials | [R][NH][smax] scores
  __device__ RowSmem(float* base) {
    x = base;
    t = x + R * C;
    a = t + R * C;
    b = a + R * C;
    kn = b + R * C;
    vn = kn + R * C;
    att = vn + R * C;
    red = att + R * C;
  }
};

// LayerNorm (eps 1e-5, biased variance) of the R rows of x into out, in f32.
template <int R, typename T>
__device__ void layer_norm_rows(const float* x, const T* scale, const T* bias, float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < R; r += NW) {
    float v[C / 32];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < C / 32; ++j) {
      v[j] = x[r * C + lane + 32 * j];
      s += v[j];
    }
    const float mean = warp_sum(s) / C;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < C / 32; ++j) {
      const float d = v[j] - mean;
      q += d * d;
    }
    const float inv = rsqrtf(warp_sum(q) / C + 1e-5f);
#pragma unroll
    for (int j = 0; j < C / 32; ++j) {
      const int c = lane + 32 * j;
      out[r * C + c] = (v[j] - mean) * inv * to_f(scale[c]) + to_f(bias[c]);
    }
  }
}

// Partial products of xs[R][C] (shared, f32) with columns n0..n0+255 of the
// row-major weight W[C][ldw]. Warp w sums weight rows w*KS..w*KS+KS-1 and writes
// red[w][r][0..255]; callers add the NW partials in warp order.
template <int R, typename T>
__device__ void mv_partials(const float* xs, const T* W, int ldw, int n0, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = warp * KS;
  const T* wp = W + (size_t)k0 * ldw + n0 + lane * 8;
  float acc[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;
#pragma unroll 1
  for (int kk = 0; kk < KS; kk += U) {
    float w[U][8];
#pragma unroll
    for (int u = 0; u < U; ++u) load8(wp + (size_t)(kk + u) * ldw, w[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float xv = xs[r * C + k0 + kk + u];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(xv, w[u][j], acc[r][j]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float4* dst = reinterpret_cast<float4*>(red + (warp * R + r) * 256 + lane * 8);
    dst[0] = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    dst[1] = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
  }
}

// out[r][n] = (sum_w red[w][r][n] + bias[n0 + n]) * scale for the 256-column tile.
template <int R, typename T>
__device__ void mv_finish(const float* red, const T* bias, int n0, float scale, float* out, int ldo) {
  for (int i = threadIdx.x; i < R * 256; i += NT) {
    const int r = i >> 8, n = i & 255;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) s += red[(w * R + r) * 256 + n];
    out[r * ldo + n0 + n] = (s + to_f(bias[n0 + n])) * scale;
  }
}

// x <- x + bo + sum_h part_h with part_h the head-h slice of the out-projection
// (warp h's partial), rounded to the storage type after each part as the TPU
// split kernels round.
template <int R, typename T>
__device__ void add_heads(float* x, const float* red, const T* bo) {
  for (int i = threadIdx.x; i < R * C; i += NT) {
    const int r = i >> 8, n = i & 255;
    float acc = x[i] + to_f(bo[n]);
    acc = rnd<T>(acc);
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      float p = red[(h * R + r) * 256 + n];
      if (h > 0) p = rnd<T>(p);
      acc = rnd<T>(acc + p);
    }
    x[i] = acc;
  }
}

// Softmax over the first n entries of each of the R*NH score rows, in place.
template <int R>
__device__ void softmax_rows(float* sc, int smax, int n) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int rh = warp; rh < R * NH; rh += NW) {
    float* row = sc + rh * smax;
    float m = -INFINITY;
    for (int t = lane; t < n; t += 32) m = fmaxf(m, row[t]);
    m = warp_max(m);
    float s = 0.f;
    for (int t = lane; t < n; t += 32) {
      const float e = expf(row[t] - m);
      row[t] = e;
      s += e;
    }
    s = warp_sum(s);
    for (int t = lane; t < n; t += 32) row[t] = row[t] / s;
  }
}

// att[r][h*HD + d] = sum_{t<n} p[r,h,t] * V[b,h,t,d]; position `cur` (if >= 0) reads
// the f32 value vn instead of the cache.
template <int R, typename T>
__device__ void attend_values(const float* p, int smax, int n, int cur, const T* V, int tstride,
                              const float* vn, float* att, int nrows, int row0) {
  for (int i = threadIdx.x; i < R * NH * (HD / 8); i += NT) {
    const int g = i & (HD / 8 - 1), rh = i / (HD / 8);
    const int r = rh / NH, h = rh % NH;
    const float* pr = p + rh * smax;
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;
    if (r < nrows) {
      const T* vp = V + ((size_t)(row0 + r) * NH + h) * (size_t)tstride * HD + g * 8;
#pragma unroll 4
      for (int t = 0; t < n; ++t) {
        if (t == cur) continue;
        float v8[8];
        load8(vp + (size_t)t * HD, v8);
        const float pt = pr[t];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] = fmaf(pt, v8[j], acc[j]);
      }
    }
    if (cur >= 0 && r < nrows) {
      const float pt = pr[cur];
      const float* v8 = vn + r * C + h * HD + g * 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = fmaf(pt, v8[j], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) att[r * C + h * HD + g * 8 + j] = acc[j];
  }
}

// Self-attention residual block of layer `l` for the block's rows.
template <int R, typename T>
__device__ void self_phase(RowSmem<R>& s, const Args& a, int l, int row0, int nrows, int step, int smax) {
  const size_t lc = (size_t)l * C, lcc = (size_t)l * C * C;
  const T* qpos = static_cast<const T*>(a.qpos);
  const int n = step + 1;
  layer_norm_rows<R, T>(s.x, static_cast<const T*>(a.ln1s) + lc, static_cast<const T*>(a.ln1b) + lc, s.t);
  __syncthreads();
  for (int i = threadIdx.x; i < R * C; i += NT) {
    const float nx = s.t[i];
    s.a[i] = rnd<T>(nx + to_f(qpos[i & (C - 1)]));  // q/k input: LN + query pos
    s.b[i] = rnd<T>(nx);                             // v input: LN only
  }
  __syncthreads();
  mv_partials<R, T>(s.a, static_cast<const T*>(a.swq) + lcc, C, 0, s.red);
  __syncthreads();
  mv_finish<R, T>(s.red, static_cast<const T*>(a.sbq) + lc, 0, kScale, s.t, C);
  __syncthreads();
  mv_partials<R, T>(s.a, static_cast<const T*>(a.swk) + lcc, C, 0, s.red);
  __syncthreads();
  mv_finish<R, T>(s.red, static_cast<const T*>(a.sbk) + lc, 0, 1.f, s.kn, C);
  __syncthreads();
  mv_partials<R, T>(s.b, static_cast<const T*>(a.swv) + lcc, C, 0, s.red);
  __syncthreads();
  mv_finish<R, T>(s.red, static_cast<const T*>(a.sbv) + lc, 0, 1.f, s.vn, C);
  __syncthreads();

  // Write the one new slot of each cache (rounded to the cache type).
  const size_t lcache = (size_t)l * a.B * NH * a.T * HD;
  T* kc = static_cast<T*>(a.kc) + lcache;
  T* vc = static_cast<T*>(a.vc) + lcache;
  for (int i = threadIdx.x; i < R * C; i += NT) {
    const int r = i >> 8, c = i & 255, b = row0 + r;
    if (r < nrows) {
      const size_t off = (((size_t)b * NH + c / HD) * a.T + step) * HD + (c % HD);
      kc[off] = from_f<T>(s.kn[i]);
      vc[off] = from_f<T>(s.vn[i]);
    }
  }

  // Scores over positions 0..step; the current one uses the f32 key.
  float* sc = s.red;
  for (int i = threadIdx.x; i < R * NH * n; i += NT) {
    const int t = i % n, rh = i / n;
    const int r = rh / NH, h = rh % NH;
    const float* qv = s.t + r * C + h * HD;
    float acc = 0.f;
    if (r >= nrows) {
    } else if (t == step) {
      const float* kv = s.kn + r * C + h * HD;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc = fmaf(qv[d], kv[d], acc);
    } else {
      const T* kp = kc + (((size_t)(row0 + r) * NH + h) * a.T + t) * HD;
#pragma unroll
      for (int g = 0; g < HD / 8; ++g) {
        float k8[8];
        load8(kp + g * 8, k8);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc = fmaf(qv[g * 8 + j], k8[j], acc);
      }
    }
    sc[rh * smax + t] = acc;
  }
  __syncthreads();
  softmax_rows<R>(sc, smax, n);
  __syncthreads();
  attend_values<R, T>(sc, smax, n, step, vc, a.T, s.vn, s.att, nrows, row0);
  __syncthreads();
  for (int i = threadIdx.x; i < R * C; i += NT) s.a[i] = rnd<T>(s.att[i]);
  __syncthreads();
  mv_partials<R, T>(s.a, static_cast<const T*>(a.swo) + lcc, C, 0, s.red);
  __syncthreads();
  add_heads<R, T>(s.x, s.red, static_cast<const T*>(a.sbo) + lc);
  __syncthreads();
}

template <int R, typename T>
__device__ void load_rows(RowSmem<R>& s, const Args& a, int row0, int nrows) {
  const T* x = static_cast<const T*>(a.x);
  for (int i = threadIdx.x; i < R * C; i += NT)
    s.x[i] = (i >> 8) < nrows ? to_f(x[(size_t)row0 * C + i]) : 0.f;
  __syncthreads();
}

template <int R, typename T>
__device__ void store_rows(RowSmem<R>& s, const Args& a, int row0, int nrows) {
  T* y = static_cast<T*>(a.y);
  for (int i = threadIdx.x; i < R * C; i += NT)
    if ((i >> 8) < nrows) y[(size_t)row0 * C + i] = from_f<T>(s.x[i]);
}

template <int R, typename T>
__global__ void __launch_bounds__(NT) decode_kernel(const Args a) {
  extern __shared__ float4 smem_raw[];
  RowSmem<R> s(reinterpret_cast<float*>(smem_raw));
  const int row0 = blockIdx.x * R;
  const int nrows = min(R, a.B - row0);
  load_rows<R, T>(s, a, row0, nrows);
  self_phase<R, T>(s, a, 0, row0, nrows, *a.step, a.T);
  store_rows<R, T>(s, a, row0, nrows);
}

template <int R>
size_t smem_bytes(const Args& a) {
  return (7 * (size_t)R * C + red_floats<R>(a.T)) * sizeof(float);
}

template <int R, typename T>
int launch_t(const Args& a, cudaStream_t stream) {
  const size_t bytes = smem_bytes<R>(a);
  auto kern = decode_kernel<R, T>;
  static size_t granted = 0;  // dynamic shared memory already allowed for this kernel
  if (bytes > granted) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    granted = bytes;
  }
  const int grid = (a.B + R - 1) / R;
  kern<<<grid, NT, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int rt_self_attn_block(const Args* a, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_t<kRows, __nv_bfloat16>(*a, st) : launch_t<kRows, float>(*a, st);
}
const char* rt_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
