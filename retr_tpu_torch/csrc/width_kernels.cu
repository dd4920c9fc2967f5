// The decoder-layer kernels at any model width, for Hopper (sm_90a): the
// widths, head count, FF width, cache length and memory length are run-time
// values. The wrappers of ops/decoder_kernels.py launch these where the tuned
// kernels (stack_kernels.cu, block_kernels.cu: C = 256, 8
// heads of 32, F a multiple of 256) do not take the model, as the Pallas
// kernels of retr_tpu/ops/decoder_kernels.py take any width.
//
//   rt_width_self   <- self_attn_block (K = 0) and self_attn_block_beam (K = beam group)
//   rt_width_cross  <- cross_attn_block
//   rt_width_ff     <- ff_block
//   rt_width_stack  <- fused_stack_step and fused_layer_step: per layer the three
//                      kernels above, 3 L launches, the residual kept in f32 scratch
//
// Design: right first. One block of NT threads per tile of R rows (beam: whole
// beam groups, so the fresh f32 k/v at `step` of any ancestor are in the
// block's shared memory), which keeps every intermediate of its rows in shared
// memory in f32: residual, LayerNorm output, q/k/v, scores [R][H][n], attention
// output, FF hidden [R][F]. Products run on CUDA cores: thread n owns output
// column n (n, n + NT, ...) for all R rows and walks K in order, so the weight
// rows are read coalesced and once per tile; the out-projection sums each
// head's K slice apart and folds the heads in order. Scores: a thread per
// (row, head, position); softmax: a warp per (row, head); values: a thread per
// (row, column). R is the largest tile up to 4 rows (a group of K rows, or as
// many groups as fit in 4) whose shared memory fits a block.
//
// Numerics are the plain versions' (the TPU kernels'): each product casts its
// input to the weight type and accumulates in f32; LayerNorm (eps 1e-5) and an
// exact softmax in f32; q = (LN(x) + qpos) Wq + bq times D**-0.5, k takes qpos,
// v does not; the cache stores the new k/v rounded, the current position
// attends with them unrounded; the key bias is clamped at -1e30. `exact` = 0
// (the split blocks): the residual is rounded to the storage type as x's type
// rounds it, after each head's out-projection part, after FF's output;
// `exact` = 1 (the stacked step): the residual stays f32 across all layers
// and is rounded once, at the output. No atomics: the same inputs give the
// same bits.
//
// Partial mode (`partial` = 1, tensor parallelism; rt_width_self, _cross and
// _ff): the parameters are one rank's mp slice, H its heads over the q/k/v
// width I (= H x the head width, below C), F its hidden units; y, f32, gets
// the sum of the heads' out-projection parts in head order (FF: the FF2
// product) with neither the bias nor the residual, which the caller adds
// after the all-reduce over the mp group.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

// Launch arguments, mirrored field for field by _WidthArgs in ops/decoder_kernels.py.
struct WidthArgs {
  int B, C, H, F, T, S, K, L;   // K: rows of a beam group (0: no ancestry)
  int xf32, yf32;               // x / y stored in f32 (else the storage type)
  int exact;                    // 1: no rounding of the residual (stacked step)
  int I;                        // q/k/v width (0: C; an mp slice's is narrower)
  int partial;                  // 1: y (f32) = the f32 sum of the partials, no bias, no residual
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
  void* kc; void* vc;           // self caches [B, H, T, D] (stack: [L, ...])
  const void* ck; const void* cv;   // memory K/V [B, H, S, D] (stack: [L, ...])
  const float* key_bias;        // [B, S]
  const int* step;
  const int* anc;               // [B, T] row within the beam group (K > 0)
  float* res;                   // [B, C] f32 residual scratch (rt_width_stack)
};

namespace {

constexpr int RMAX = 16;        // most rows of a tile (a beam group of up to 16)
constexpr int kTileRows = 4;
constexpr size_t kSmemMax = 232448;   // a block's shared-memory limit on Hopper

enum Kind { kSelfK = 0, kCrossK = 1, kFfK = 2 };

// The q/k/v width.
__host__ __device__ inline int inner_of(const WidthArgs& a) { return a.I > 0 ? a.I : a.C; }

// Shared floats of one tile of R rows (ints of the ancestry counted as floats):
// the [R][C] arrays also hold the [R][I] ones (I <= C).
__host__ __device__ inline size_t tile_floats(int kind, const WidthArgs& a, int R) {
  const size_t rc = (size_t)R * a.C;
  if (kind == kSelfK) return 7 * rc + (size_t)R * a.H * a.T + (a.K > 0 ? (size_t)R * a.T : 0);
  if (kind == kCrossK) return 4 * rc + (size_t)R * a.H * a.S;
  return 2 * rc + (size_t)R * a.F;
}

// Rows a block owns, 0 where not even one tile (one beam group) fits.
inline int tile_rows(int kind, const WidthArgs& a) {
  const int unit = kind == kSelfK && a.K > 0 ? a.K : 1;
  int R = unit * (kTileRows / unit > 1 ? kTileRows / unit : 1);
  while (R >= unit && tile_floats(kind, a, R) * sizeof(float) > kSmemMax) R -= unit;
  return R >= unit && R <= RMAX ? R : 0;
}

template <typename T> __device__ __forceinline__ float ld(const T* p, size_t i) { return to_f(p[i]); }

// Residual rows row0.. into xs [R][C] (zeros past the batch).
template <typename T>
__device__ void load_x(float* xs, const WidthArgs& a, int row0, int nrows, int R) {
  for (int i = threadIdx.x; i < R * a.C; i += NT) {
    const int r = i / a.C;
    const size_t g = (size_t)row0 * a.C + i;
    xs[i] = r >= nrows ? 0.f : a.xf32 ? static_cast<const float*>(a.x)[g] : ld(static_cast<const T*>(a.x), g);
  }
  __syncthreads();
}

template <typename T>
__device__ void store_y(const float* xs, const WidthArgs& a, int row0, int nrows) {
  for (int i = threadIdx.x; i < nrows * a.C; i += NT) {
    const size_t g = (size_t)row0 * a.C + i;
    if (a.yf32) static_cast<float*>(a.y)[g] = xs[i];
    else static_cast<T*>(a.y)[g] = from_f<T>(xs[i]);
  }
}

// LayerNorm (eps 1e-5, biased variance) of the R rows of xs into out, f32; a
// warp per row.
template <typename T>
__device__ void layer_norm(const float* xs, int R, int width, const T* scale, const T* bias, float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < R; r += NW) {
    const float* x = xs + (size_t)r * width;
    float s = 0.f;
    for (int c = lane; c < width; c += 32) s += x[c];
    const float mean = warp_sum(s) / width;
    float q = 0.f;
    for (int c = lane; c < width; c += 32) {
      const float d = x[c] - mean;
      q += d * d;
    }
    const float inv = rsqrtf(warp_sum(q) / width + 1e-5f);
    for (int c = lane; c < width; c += 32) out[(size_t)r * width + c] = (x[c] - mean) * inv * to_f(scale[c]) + to_f(bias[c]);
  }
}

// For every output column n < N: sum_k in[r][k0 + k] W[k0 + k][n] over k < kn,
// for the R rows (in: f32 values already rounded to T, row stride ldi), handed
// to epi(n, acc) with acc[r] for r < R.
template <typename T, typename Epi>
__device__ void rows_product(const float* in, int ldi, int R, const T* W, int k0, int kn, int N, Epi epi) {
  for (int n = threadIdx.x; n < N; n += NT) {
    float acc[RMAX];
#pragma unroll
    for (int r = 0; r < RMAX; ++r) acc[r] = 0.f;
    const T* w = W + (size_t)k0 * N + n;
#pragma unroll 4
    for (int k = 0; k < kn; ++k) {
      const float wv = to_f(w[(size_t)k * N]);
#pragma unroll
      for (int r = 0; r < RMAX; ++r)
        if (r < R) acc[r] = fmaf(in[r * ldi + k0 + k], wv, acc[r]);
    }
    epi(n, acc);
  }
}

// xs <- xs + bo + sum_h (att_h Wo[hD:(h+1)D]) with the heads folded in order;
// not exact: rounded to T after the bias, after each head's part, and each
// part h > 0 rounded first (the split blocks' _add_heads); partial: xs <-
// sum_h (att_h Wo[hD:(h+1)D]) in f32, head order. att: [R][I].
template <typename T>
__device__ void out_proj(float* xs, const float* att, int R, const WidthArgs& a, const T* W, const T* bo) {
  const int width = a.C, inner = inner_of(a), hd = inner / a.H;
  for (int n = threadIdx.x; n < width; n += NT) {
    float y[RMAX];
    const float b = a.partial ? 0.f : to_f(bo[n]);
#pragma unroll
    for (int r = 0; r < RMAX; ++r)
      y[r] = r >= R || a.partial ? 0.f : a.exact ? xs[r * width + n] + b : rnd<T>(xs[r * width + n] + b);
    for (int h = 0; h < a.H; ++h) {
      float acc[RMAX];
#pragma unroll
      for (int r = 0; r < RMAX; ++r) acc[r] = 0.f;
      const T* w = W + (size_t)h * hd * width + n;
#pragma unroll 4
      for (int k = 0; k < hd; ++k) {
        const float wv = to_f(w[(size_t)k * width]);
#pragma unroll
        for (int r = 0; r < RMAX; ++r)
          if (r < R) acc[r] = fmaf(att[r * inner + h * hd + k], wv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < RMAX; ++r) {
        if (a.exact || a.partial) y[r] = y[r] + acc[r];
        else y[r] = rnd<T>(y[r] + (h > 0 ? rnd<T>(acc[r]) : acc[r]));
      }
    }
#pragma unroll
    for (int r = 0; r < RMAX; ++r)
      if (r < R) xs[r * width + n] = y[r];
  }
}

// Exact softmax over the first n entries of each of the rows of sc (stride ld), a warp per row.
__device__ void softmax_rows(float* sc, int rows, int ld, int n) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < rows; i += NW) {
    float* row = sc + (size_t)i * ld;
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

// Self-attention block (K > 0: ancestry-addressed reads, whole groups per block).
template <typename T>
__global__ void __launch_bounds__(NT) self_kernel(const WidthArgs a, int R, float scale) {
  extern __shared__ float4 smem_raw[];
  const int width = a.C, inner = inner_of(a), hd = inner / a.H, rc = R * width, ri = R * inner;
  const int step = *a.step, n = step + 1;
  float* xs = reinterpret_cast<float*>(smem_raw);
  float* q = xs + rc;       // LayerNorm output, then q [R][I]
  float* in = q + rc;       // rounded (LN + qpos), then the rounded attention output
  float* vin = in + rc;     // rounded LN
  float* kn = vin + rc;
  float* vn = kn + rc;
  float* att = vn + rc;
  float* sc = att + rc;     // [R][H][T]
  int* src = reinterpret_cast<int*>(sc + (size_t)R * a.H * a.T);   // [R][T] local source row
  const int row0 = blockIdx.x * R, nrows = min(R, a.B - row0);
  const T* qpos = static_cast<const T*>(a.qpos);
  load_x<T>(xs, a, row0, nrows, R);
  if (a.K > 0) {
    for (int i = threadIdx.x; i < R * n; i += NT) {
      const int r = i / n, t = i % n;
      const int j = r < nrows ? a.anc[(size_t)(row0 + r) * a.T + t] : 0;
      src[r * a.T + t] = (r / a.K) * a.K + min(max(j, 0), a.K - 1);
    }
  }
  layer_norm<T>(xs, R, width, static_cast<const T*>(a.ln1s), static_cast<const T*>(a.ln1b), q);
  __syncthreads();
  for (int i = threadIdx.x; i < rc; i += NT) {
    in[i] = rnd<T>(q[i] + to_f(qpos[i % width]));
    vin[i] = rnd<T>(q[i]);
  }
  __syncthreads();
  const T* sbq = static_cast<const T*>(a.sbq);
  const T* sbk = static_cast<const T*>(a.sbk);
  const T* sbv = static_cast<const T*>(a.sbv);
  rows_product<T>(in, width, R, static_cast<const T*>(a.swq), 0, width, inner, [&](int c, const float* acc) {
    for (int r = 0; r < R; ++r) q[r * inner + c] = (acc[r] + to_f(sbq[c])) * scale;
  });
  rows_product<T>(in, width, R, static_cast<const T*>(a.swk), 0, width, inner, [&](int c, const float* acc) {
    for (int r = 0; r < R; ++r) kn[r * inner + c] = acc[r] + to_f(sbk[c]);
  });
  rows_product<T>(vin, width, R, static_cast<const T*>(a.swv), 0, width, inner, [&](int c, const float* acc) {
    for (int r = 0; r < R; ++r) vn[r * inner + c] = acc[r] + to_f(sbv[c]);
  });
  __syncthreads();
  T* kc = static_cast<T*>(a.kc);
  T* vc = static_cast<T*>(a.vc);
  for (int i = threadIdx.x; i < nrows * inner; i += NT) {   // the one new slot of each cache
    const int r = i / inner, c = i % inner;
    const size_t off = (((size_t)(row0 + r) * a.H + c / hd) * a.T + step) * hd + c % hd;
    kc[off] = from_f<T>(kn[i]);
    vc[off] = from_f<T>(vn[i]);
  }
  // scores over positions 0..step: the current one from the (source row's) f32 key
  for (int i = threadIdx.x; i < R * a.H * n; i += NT) {
    const int t = i % n, rh = i / n, r = rh / a.H, h = rh % a.H;
    const int s = a.K > 0 ? src[r * a.T + t] : r;
    const float* qv = q + r * inner + h * hd;
    float acc = 0.f;
    if (r < nrows) {
      if (t == step) {
        const float* kv = kn + s * inner + h * hd;
        for (int d = 0; d < hd; ++d) acc = fmaf(qv[d], kv[d], acc);
      } else {
        const T* kp = kc + (((size_t)(row0 + s) * a.H + h) * a.T + t) * hd;
        for (int d = 0; d < hd; ++d) acc = fmaf(qv[d], to_f(kp[d]), acc);
      }
    }
    sc[(size_t)rh * a.T + t] = acc;
  }
  __syncthreads();
  softmax_rows(sc, R * a.H, a.T, n);
  __syncthreads();
  for (int i = threadIdx.x; i < ri; i += NT) {
    const int r = i / inner, c = i % inner, h = c / hd, d = c % hd;
    const float* p = sc + ((size_t)r * a.H + h) * a.T;
    float acc = 0.f;
    if (r < nrows) {
      for (int t = 0; t < n; ++t) {
        const int s = a.K > 0 ? src[r * a.T + t] : r;
        const float v = t == step ? vn[s * inner + c] : to_f(vc[(((size_t)(row0 + s) * a.H + h) * a.T + t) * hd + d]);
        acc = fmaf(p[t], v, acc);
      }
    }
    att[i] = acc;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ri; i += NT) in[i] = rnd<T>(att[i]);
  __syncthreads();
  out_proj<T>(xs, in, R, a, static_cast<const T*>(a.swo), static_cast<const T*>(a.sbo));
  __syncthreads();
  store_y<T>(xs, a, row0, nrows);
}

// Cross-attention block.
template <typename T>
__global__ void __launch_bounds__(NT) cross_kernel(const WidthArgs a, int R, float scale) {
  extern __shared__ float4 smem_raw[];
  const int width = a.C, inner = inner_of(a), hd = inner / a.H, rc = R * width, ri = R * inner;
  float* xs = reinterpret_cast<float*>(smem_raw);
  float* q = xs + rc;       // LayerNorm output, then q [R][I]
  float* in = q + rc;
  float* att = in + rc;
  float* sc = att + rc;     // [R][H][S]
  const int row0 = blockIdx.x * R, nrows = min(R, a.B - row0);
  const T* qpos = static_cast<const T*>(a.qpos);
  load_x<T>(xs, a, row0, nrows, R);
  layer_norm<T>(xs, R, width, static_cast<const T*>(a.ln2s), static_cast<const T*>(a.ln2b), q);
  __syncthreads();
  for (int i = threadIdx.x; i < rc; i += NT) in[i] = rnd<T>(q[i] + to_f(qpos[i % width]));
  __syncthreads();
  const T* cbq = static_cast<const T*>(a.cbq);
  rows_product<T>(in, width, R, static_cast<const T*>(a.cwq), 0, width, inner, [&](int c, const float* acc) {
    for (int r = 0; r < R; ++r) q[r * inner + c] = (acc[r] + to_f(cbq[c])) * scale;
  });
  __syncthreads();
  const T* ck = static_cast<const T*>(a.ck);
  const T* cv = static_cast<const T*>(a.cv);
  for (int i = threadIdx.x; i < R * a.H * a.S; i += NT) {
    const int s = i % a.S, rh = i / a.S, r = rh / a.H, h = rh % a.H;
    float acc = 0.f;
    if (r < nrows) {
      const float* qv = q + r * inner + h * hd;
      const T* kp = ck + (((size_t)(row0 + r) * a.H + h) * a.S + s) * hd;
      for (int d = 0; d < hd; ++d) acc = fmaf(qv[d], to_f(kp[d]), acc);
      acc = acc + fmaxf(a.key_bias[(size_t)(row0 + r) * a.S + s], kMaskVal);
    }
    sc[i] = acc;
  }
  __syncthreads();
  softmax_rows(sc, R * a.H, a.S, a.S);
  __syncthreads();
  for (int i = threadIdx.x; i < ri; i += NT) {
    const int r = i / inner, c = i % inner, h = c / hd, d = c % hd;
    const float* p = sc + ((size_t)r * a.H + h) * a.S;
    float acc = 0.f;
    if (r < nrows) {
      const T* vp = cv + ((size_t)(row0 + r) * a.H + h) * a.S * hd + d;
      for (int s = 0; s < a.S; ++s) acc = fmaf(p[s], to_f(vp[(size_t)s * hd]), acc);
    }
    att[i] = acc;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ri; i += NT) in[i] = rnd<T>(att[i]);
  __syncthreads();
  out_proj<T>(xs, in, R, a, static_cast<const T*>(a.cwo), static_cast<const T*>(a.cbo));
  __syncthreads();
  store_y<T>(xs, a, row0, nrows);
}

// FF block: x + (ReLU(LN(x) W1 + b1) W2 + b2), the hidden rounded to T;
// partial: the FF2 product alone.
template <typename T>
__global__ void __launch_bounds__(NT) ff_kernel(const WidthArgs a, int R) {
  extern __shared__ float4 smem_raw[];
  const int width = a.C, rc = R * width;
  float* xs = reinterpret_cast<float*>(smem_raw);
  float* in = xs + rc;
  float* hid = in + rc;     // [R][F]
  const int row0 = blockIdx.x * R, nrows = min(R, a.B - row0);
  load_x<T>(xs, a, row0, nrows, R);
  layer_norm<T>(xs, R, width, static_cast<const T*>(a.ln3s), static_cast<const T*>(a.ln3b), in);
  __syncthreads();
  for (int i = threadIdx.x; i < rc; i += NT) in[i] = rnd<T>(in[i]);
  __syncthreads();
  const T* b1 = static_cast<const T*>(a.b1);
  const T* b2 = static_cast<const T*>(a.b2);
  rows_product<T>(in, width, R, static_cast<const T*>(a.w1), 0, width, a.F, [&](int j, const float* acc) {
    for (int r = 0; r < R; ++r) hid[r * a.F + j] = rnd<T>(fmaxf(acc[r] + to_f(b1[j]), 0.f));
  });
  __syncthreads();
  rows_product<T>(hid, a.F, R, static_cast<const T*>(a.w2), 0, a.F, width, [&](int c, const float* acc) {
    for (int r = 0; r < R; ++r) {
      float& x = xs[r * width + c];
      if (a.partial) {
        x = acc[r];
        continue;
      }
      const float ff = acc[r] + to_f(b2[c]);
      x = a.exact ? x + ff : rnd<T>(x + rnd<T>(ff));
    }
  });
  __syncthreads();
  store_y<T>(xs, a, row0, nrows);
}

template <typename Kern>
int grant(Kern kern, size_t bytes, size_t& granted) {
  if (bytes > 48 * 1024 && bytes > granted) {
    const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    granted = bytes;
  }
  return 0;
}

float head_scale(const WidthArgs& a) { return (float)(1.0 / sqrt((double)(inner_of(a) / a.H))); }

bool valid(const WidthArgs& a) {
  const int inner = inner_of(a);
  return a.B >= 1 && a.C >= 1 && a.H >= 1 && inner <= a.C && inner % a.H == 0 && (a.partial || inner == a.C) &&
         a.F >= 1 && a.K >= 0 && (a.K == 0 || a.B % a.K == 0);
}

template <typename T>
int launch(int kind, const WidthArgs& a, cudaStream_t st) {
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  const int R = tile_rows(kind, a);
  if (R == 0) return (int)cudaErrorInvalidValue;   // one tile's shared memory does not fit a block
  const size_t bytes = tile_floats(kind, a, R) * sizeof(float);
  const dim3 grid((a.B + R - 1) / R);
  if (kind == kSelfK) {
    static size_t granted = 0;
    if (const int e = grant(self_kernel<T>, bytes, granted)) return e;
    self_kernel<T><<<grid, NT, bytes, st>>>(a, R, head_scale(a));
  } else if (kind == kCrossK) {
    static size_t granted = 0;
    if (const int e = grant(cross_kernel<T>, bytes, granted)) return e;
    cross_kernel<T><<<grid, NT, bytes, st>>>(a, R, head_scale(a));
  } else {
    static size_t granted = 0;
    if (const int e = grant(ff_kernel<T>, bytes, granted)) return e;
    ff_kernel<T><<<grid, NT, bytes, st>>>(a, R);
  }
  return (int)cudaGetLastError();
}

template <typename T> const T* at(const void* p, size_t n) { return static_cast<const T*>(p) + n; }

// All L layers: layer l's parameters, caches and memory K/V at offset l of
// their leading axis; x (T) -> self -> cross -> ff -> ... -> y (T), the
// residual f32 in a.res between the launches.
template <typename T>
int launch_stack(const WidthArgs& a0, cudaStream_t st) {
  const size_t c = a0.C, f = a0.F, cc = c * c, hd = a0.C / a0.H;
  const size_t cache = (size_t)a0.B * a0.H * a0.T * hd, mem = (size_t)a0.B * a0.H * a0.S * hd;
  for (int l = 0; l < a0.L; ++l) {
    WidthArgs a = a0;
    a.exact = 1;
    a.ln1s = at<T>(a0.ln1s, l * c); a.ln1b = at<T>(a0.ln1b, l * c);
    a.swq = at<T>(a0.swq, l * cc); a.sbq = at<T>(a0.sbq, l * c);
    a.swk = at<T>(a0.swk, l * cc); a.sbk = at<T>(a0.sbk, l * c);
    a.swv = at<T>(a0.swv, l * cc); a.sbv = at<T>(a0.sbv, l * c);
    a.swo = at<T>(a0.swo, l * cc); a.sbo = at<T>(a0.sbo, l * c);
    a.ln2s = at<T>(a0.ln2s, l * c); a.ln2b = at<T>(a0.ln2b, l * c);
    a.cwq = at<T>(a0.cwq, l * cc); a.cbq = at<T>(a0.cbq, l * c);
    a.cwo = at<T>(a0.cwo, l * cc); a.cbo = at<T>(a0.cbo, l * c);
    a.ln3s = at<T>(a0.ln3s, l * c); a.ln3b = at<T>(a0.ln3b, l * c);
    a.w1 = at<T>(a0.w1, l * c * f); a.b1 = at<T>(a0.b1, l * f);
    a.w2 = at<T>(a0.w2, l * f * c); a.b2 = at<T>(a0.b2, l * c);
    a.kc = static_cast<T*>(a0.kc) + l * cache;
    a.vc = static_cast<T*>(a0.vc) + l * cache;
    a.ck = at<T>(a0.ck, l * mem);
    a.cv = at<T>(a0.cv, l * mem);
    // self: x (layer 0, T) or the residual -> residual; cross and FF in place
    a.x = l == 0 ? a0.x : a0.res;
    a.xf32 = l == 0 ? a0.xf32 : 1;
    a.y = a0.res;
    a.yf32 = 1;
    if (const int e = launch<T>(kSelfK, a, st)) return e;
    a.x = a0.res;
    a.xf32 = 1;
    if (const int e = launch<T>(kCrossK, a, st)) return e;
    if (l + 1 == a0.L) {
      a.y = a0.y;
      a.yf32 = a0.yf32;
    }
    if (const int e = launch<T>(kFfK, a, st)) return e;
  }
  return 0;
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched).
int rt_width_self(const WidthArgs* a, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(kSelfK, *a, st) : launch<float>(kSelfK, *a, st);
}
int rt_width_cross(const WidthArgs* a, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(kCrossK, *a, st) : launch<float>(kCrossK, *a, st);
}
int rt_width_ff(const WidthArgs* a, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(kFfK, *a, st) : launch<float>(kFfK, *a, st);
}
int rt_width_stack(const WidthArgs* a, int bf16, void* stream) {
  if (a->L < 1 || a->res == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_stack<__nv_bfloat16>(*a, st) : launch_stack<float>(*a, st);
}

const char* rt_width_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
