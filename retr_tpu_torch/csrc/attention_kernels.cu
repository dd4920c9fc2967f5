// Full-sequence fused attention for Hopper (sm_90a): the counterpart of the
// Pallas kernel retr_tpu/ops/attention.py fused_attention (_attn_kernel).
//
//   rt_fused_attention: out[b,h] = softmax(q[b,h] * D**-0.5 . k[b,h]^T + key_bias[b]
//                                          (+ causal mask)) . v[b,h]
//
// q [B,H,Sq,D], k/v [B,H,Sk,D] and out [B,H,Sq,D] are contiguous, in f32 or bf16;
// key_bias [B,Sk] is f32 (or null: no bias). Any D and Sk whose one-query
// score row fits a block's shared memory (~58000 keys).
//
// Numerics are the TPU kernel's: q is upcast to f32 and scaled, the scores
// are f32 products, the bias is clamped at -1e30 and added, the causal mask
// (key > query -> -1e30) is applied after it, the softmax is exact (max, exp,
// sum, then e / sum), and the probabilities are rounded to v's type before the
// PV product, which accumulates in f32; the output is cast to q's type.
//
// Design. One block per (b, h, tile of QT = 32 query rows). The block keeps its
// whole [QT, Sk] score row block in shared memory (128 KB at Sk = 1024), so the
// normalisation is exact and done once: pass 1 streams K through shared memory
// in KT = 64-key tiles and writes the scores, a warp per row then takes max,
// exp, sum and the rounded probabilities in place, and pass 2 streams V in the
// same tiles for the PV product. No online-softmax rescale (it would move the
// point where the probabilities are rounded). The TPU kernel held the whole
// padded K/V of one (b, h) in VMEM; here only one tile of K or V is resident,
// as f32 with a padded row (D + 1) so neighbouring keys fall in distinct banks.
//
// Bound on the card: at the model's shapes (Sk <= 397, D = 32) the function
// moves 4 * B*H*S*D elements and does 4 * B*H*Sq*Sk*D operations; in f32 the
// operations on CUDA cores (67 TFLOP/s) and the bytes take about the same time.
// This first kernel multiplies on CUDA cores with fmaf and makes no use of the
// tensor cores: it is right first, fast in a later change.
//
// Other shapes (any_kernel): a head dim other than 16, 32 or 64, or a score
// block of 32 rows too large for shared memory. Same two passes and the same
// numerics, with D and the query rows per block (QT halved until the scores
// fit, down to 1) known at run time: pass 1 gives a thread a (row, key) pair,
// which reads its key row from global memory; pass 2 a (row, column) pair,
// which walks V's column in key order. Right first: no tiles are staged.
//
// An all-masked row (every key at -1e30) gets uniform probabilities over the
// real Sk keys: the mean of V (the TPU kernel averaged over its 128-padded
// length). The model never produces such a row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Launch arguments, mirrored field for field by _AttnArgs in ops/decoder_kernels.py.
struct AttnArgs {
  int B, H, Sq, Sk, D, causal;
  float scale;             // D**-0.5 in f32, computed by the caller
  const void* q;
  const void* k;
  const void* v;
  const float* key_bias;   // [B, Sk] additive bias, or null
  void* out;
};

namespace {

constexpr int QT = 32;     // query rows per block
constexpr int KT = 64;     // keys per shared-memory tile
constexpr int NT = 256;    // threads per block
constexpr float kNegInf = -1e30f;
constexpr size_t kMaxSmem = 232448;  // a block's shared-memory limit on Hopper

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as a cast to bf16 does
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
size_t smem_bytes(int sk) {
  return ((size_t)(QT + KT) * (D + 1) + (size_t)QT * sk) * sizeof(float);
}

// Copy rows [k0, k0 + nk) of one (b, h) slice of k or v into the f32 tile.
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* tile, const T* src, int k0, int nk) {
  constexpr int DP = D + 1;
  const T* p = src + (size_t)k0 * D;
  for (int i = threadIdx.x; i < nk * D; i += NT) tile[(i / D) * DP + i % D] = to_f(p[i]);
}

template <int D, typename T>
__global__ void __launch_bounds__(NT) attn_kernel(const AttnArgs a) {
  constexpr int DP = D + 1;
  extern __shared__ float4 smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [QT][DP] scaled f32 queries
  float* tile = qs + QT * DP;                      // [KT][DP] a K tile, then a V tile
  float* sc = tile + KT * DP;                      // [QT][Sk] scores, then probabilities

  const int sk = a.Sk;
  const int bh = blockIdx.x;                       // b * H + h
  const int b = bh / a.H;
  const int q0 = blockIdx.y * QT;
  const int nq = min(QT, a.Sq - q0);
  const T* q = static_cast<const T*>(a.q) + ((size_t)bh * a.Sq + q0) * D;
  const T* k = static_cast<const T*>(a.k) + (size_t)bh * sk * D;
  const T* v = static_cast<const T*>(a.v) + (size_t)bh * sk * D;
  const float* bias = a.key_bias ? a.key_bias + (size_t)b * sk : nullptr;
  const int t = threadIdx.x;

  for (int i = t; i < QT * D; i += NT) {
    const int r = i / D;
    qs[r * DP + i % D] = r < nq ? to_f(q[i]) * a.scale : 0.f;
  }

  // Pass 1: scores. Thread t takes key kk of the tile for QPT query rows.
  constexpr int QPT = QT * KT / NT;  // 8
  const int kk = t % KT;
  const int r0 = (t / KT) * QPT;
  for (int k0 = 0; k0 < sk; k0 += KT) {
    const int nk = min(KT, sk - k0);
    __syncthreads();  // the previous tile is consumed
    load_tile<D, T>(tile, k, k0, nk);
    __syncthreads();
    if (kk < nk) {
      float acc[QPT];
#pragma unroll
      for (int j = 0; j < QPT; ++j) acc[j] = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        const float kc = tile[kk * DP + c];
#pragma unroll
        for (int j = 0; j < QPT; ++j) acc[j] = fmaf(qs[(r0 + j) * DP + c], kc, acc[j]);
      }
      const int col = k0 + kk;
      const float bc = bias ? fmaxf(bias[col], kNegInf) : 0.f;
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
        float s = acc[j] + bc;
        if (a.causal && col > q0 + r0 + j) s = kNegInf;
        sc[(r0 + j) * sk + col] = s;
      }
    }
  }
  __syncthreads();

  // Exact softmax, one warp per row; probabilities rounded to v's type.
  const int lane = t & 31;
  for (int r = t >> 5; r < nq; r += NT / 32) {
    float* row = sc + (size_t)r * sk;
    float m = -INFINITY;
    for (int c = lane; c < sk; c += 32) m = fmaxf(m, row[c]);
    m = warp_max(m);
    float s = 0.f;
    for (int c = lane; c < sk; c += 32) {
      const float e = expf(row[c] - m);
      row[c] = e;
      s += e;
    }
    s = warp_sum(s);
    for (int c = lane; c < sk; c += 32) row[c] = to_f(from_f<T>(row[c] / s));
  }

  // Pass 2: out = probs . V. Thread t takes column c for RPT rows RS apart.
  constexpr int RS = NT / D;
  constexpr int RPT = QT / RS;
  const int c = t % D;
  const int rr = t / D;
  float o[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) o[i] = 0.f;
  for (int k0 = 0; k0 < sk; k0 += KT) {
    const int nk = min(KT, sk - k0);
    __syncthreads();  // probabilities written, or the previous V tile consumed
    load_tile<D, T>(tile, v, k0, nk);
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      const float vj = tile[j * DP + c];
#pragma unroll
      for (int i = 0; i < RPT; ++i) o[i] = fmaf(sc[(rr + i * RS) * sk + k0 + j], vj, o[i]);
    }
  }
  T* out = static_cast<T*>(a.out) + ((size_t)bh * a.Sq + q0) * D;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rr + i * RS;
    if (r < nq) out[r * D + c] = from_f<T>(o[i]);
  }
}

template <int D, typename T>
int launch_t(const AttnArgs& a, cudaStream_t stream) {
  const size_t bytes = smem_bytes<D>(a.Sk);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kern = attn_kernel<D, T>;
  static size_t granted = 0;  // dynamic shared memory already allowed for this kernel
  if (bytes > 48 * 1024 && bytes > granted) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    granted = bytes;
  }
  const dim3 grid(a.B * a.H, (a.Sq + QT - 1) / QT);
  kern<<<grid, NT, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(const AttnArgs& a, int bf16, cudaStream_t st) {
  return bf16 ? launch_t<D, __nv_bfloat16>(a, st) : launch_t<D, float>(a, st);
}

size_t any_smem_bytes(int qt, int d, int sk) { return (size_t)qt * (d + sk) * sizeof(float); }

// Any D, qt query rows per block: qs [qt][D] scaled f32 queries, sc [qt][Sk].
template <typename T>
__global__ void __launch_bounds__(NT) any_kernel(const AttnArgs a, int qt) {
  extern __shared__ float4 smem_raw[];
  const int d = a.D, sk = a.Sk;
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* sc = qs + (size_t)qt * d;
  const int bh = blockIdx.x, b = bh / a.H, q0 = blockIdx.y * qt, nq = min(qt, a.Sq - q0);
  const T* q = static_cast<const T*>(a.q) + ((size_t)bh * a.Sq + q0) * d;
  const T* k = static_cast<const T*>(a.k) + (size_t)bh * sk * d;
  const T* v = static_cast<const T*>(a.v) + (size_t)bh * sk * d;
  const float* bias = a.key_bias ? a.key_bias + (size_t)b * sk : nullptr;
  for (int i = threadIdx.x; i < nq * d; i += NT) qs[i] = to_f(q[i]) * a.scale;
  __syncthreads();
  for (int i = threadIdx.x; i < nq * sk; i += NT) {
    const int r = i / sk, j = i % sk;
    const float* qr = qs + (size_t)r * d;
    const T* kr = k + (size_t)j * d;
    float acc = 0.f;
    for (int c = 0; c < d; ++c) acc = fmaf(qr[c], to_f(kr[c]), acc);
    float s = acc + (bias ? fmaxf(bias[j], kNegInf) : 0.f);
    if (a.causal && j > q0 + r) s = kNegInf;
    sc[i] = s;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < nq; r += NT / 32) {
    float* row = sc + (size_t)r * sk;
    float m = -INFINITY;
    for (int c = lane; c < sk; c += 32) m = fmaxf(m, row[c]);
    m = warp_max(m);
    float s = 0.f;
    for (int c = lane; c < sk; c += 32) {
      const float e = expf(row[c] - m);
      row[c] = e;
      s += e;
    }
    s = warp_sum(s);
    for (int c = lane; c < sk; c += 32) row[c] = to_f(from_f<T>(row[c] / s));
  }
  __syncthreads();
  T* out = static_cast<T*>(a.out) + ((size_t)bh * a.Sq + q0) * d;
  for (int i = threadIdx.x; i < nq * d; i += NT) {
    const int r = i / d, c = i % d;
    const float* p = sc + (size_t)r * sk;
    float o = 0.f;
    for (int j = 0; j < sk; ++j) o = fmaf(p[j], to_f(v[(size_t)j * d + c]), o);
    out[i] = from_f<T>(o);
  }
}

template <typename T>
int launch_any(const AttnArgs& a, cudaStream_t stream) {
  int qt = QT;
  while (qt > 1 && any_smem_bytes(qt, a.D, a.Sk) > kMaxSmem) qt /= 2;
  const size_t bytes = any_smem_bytes(qt, a.D, a.Sk);
  if (bytes > kMaxSmem || a.Sq > 65535 * qt) return (int)cudaErrorInvalidValue;
  static size_t granted = 0;
  if (bytes > 48 * 1024 && bytes > granted) {
    const cudaError_t e = cudaFuncSetAttribute(any_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    granted = bytes;
  }
  any_kernel<T><<<dim3(a.B * a.H, (a.Sq + qt - 1) / qt), NT, bytes, stream>>>(a, qt);
  return (int)cudaGetLastError();
}

template <int D>
bool tiled_fits(const AttnArgs& a) { return a.D == D && smem_bytes<D>(a.Sk) <= kMaxSmem; }

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int rt_fused_attention(const AttnArgs* a, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->B < 1 || a->H < 1 || a->Sq < 1 || a->Sk < 1 || a->D < 1) return (int)cudaErrorInvalidValue;
  if (a->Sq <= 65535 * QT) {
    if (tiled_fits<16>(*a)) return launch_d<16>(*a, bf16, st);
    if (tiled_fits<32>(*a)) return launch_d<32>(*a, bf16, st);
    if (tiled_fits<64>(*a)) return launch_d<64>(*a, bf16, st);
  }
  return bf16 ? launch_any<__nv_bfloat16>(*a, st) : launch_any<float>(*a, st);
}

const char* rt_attn_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
