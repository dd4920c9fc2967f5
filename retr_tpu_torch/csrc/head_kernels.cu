// Vocab-blocked MLP-head kernels for Hopper (sm_90a): the decode tail of the
// caption model (C -> Hd -> Hd -> V with ReLU between) without writing the
// [rows, V] logits to device memory.
//
// Two entry points, the counterparts of two Pallas kernels of
// retr_tpu/ops/decoder_kernels.py:
//   rt_head_trunk   <- the trunk of mlp_head_argmax (_head_kernel: x -> ReLU(x W1 + b1)
//                      -> ReLU(. W2 + b2)), written to h2 in the storage type
//   rt_head_blocks  <- the vocab-block body of mlp_head_argmax and mlp_head_topk
//                      (_head_kernel, _head_topk_kernel): the logits h2 W3 + b3 of one
//                      256-wide vocab slab for a tile of rows, then per row the slab's
//                      top-k (value, first index), its max and sum(exp(logit - max))
// The pick across slabs (argmax, or top-k plus the online logsumexp) runs in
// PyTorch on the [rows, slabs, k] outputs, as the TPU left it to XLA.
//
// Bound: bytes at the served shapes. W3 is Hd x V (31 MB in bf16 at 512 x 30522)
// against 2 operations per weight element per row, so below ~300 rows it moves
// more than it computes. Design: a block owns a tile of 8 rows and one 256-wide
// vocab slab; blockIdx.x walks the row tiles, so the blocks of one slab run side
// by side and re-read the slab from L2. Products run on the CUDA cores in f32
// (no tensor cores yet). The TPU padded the vocab to a multiple of 2048 with a
// -1e30 bias; here the last slab is bounds-checked instead, and W3's rows (odd
// byte strides at V = 30522) are read one element per thread, neighbouring
// threads on neighbouring columns.
//
// Numerics follow the TPU kernels: each product casts its input to the weight
// type and accumulates in f32; h1 and h2 are rounded to the storage type where
// the next product reads them; logits, max and sum of exponentials are f32.
// Within a slab ties go to the lowest vocab index.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Launch arguments, mirrored field for field by _HeadArgs in ops/decoder_kernels.py.
struct HeadArgs {
  int B, C, Hd, V, k;   // rows, trunk input width, hidden width, vocab, top-k per slab
  const void* x;        // [B, C]
  const void* w1; const void* b1; const void* w2; const void* b2;
  void* h2;             // [B, Hd]: written by the trunk, read by the slabs
  const void* w3; const void* b3;
  float* vals;          // [B, G, k] slab top-k logits, G = ceil(V / 256)
  int* idx;             // [B, G, k] their vocab ids
  float* mx;            // [B, G] slab max
  float* se;            // [B, G] slab sum(exp(logit - max))
};

namespace {

constexpr int NT = 256;      // threads per block
constexpr int NW = NT / 32;  // warps = K slices of a product
constexpr int TW = 256;      // columns of a product tile (lane + 32 * j, j < 8)
constexpr int U = 4;         // weight rows in flight per thread
constexpr int kRows = 8;     // rows per block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

// Partial products of xs[R][kd] (shared, f32) with columns n0 + lane + 32*j of the
// row-major W[kd][ldw], columns >= nv read as 0. Warp w sums rows w*kd/NW..;
// red[w][r][0..TW) gets its partials, which callers add in warp order.
template <int R, typename T>
__device__ void tile_partials(const float* xs, int kd, const T* W, int ldw, int n0, int nv, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ks = kd / NW, k0 = warp * ks;
  const T* wp = W + (size_t)k0 * ldw + n0 + lane;
  bool ok[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) ok[j] = n0 + lane + 32 * j < nv;
  float acc[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;
#pragma unroll 1
  for (int kk = 0; kk < ks; kk += U) {
    float w[U][8];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < 8; ++j) w[u][j] = ok[j] ? to_f(wp[(size_t)(kk + u) * ldw + 32 * j]) : 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float xv = xs[r * kd + k0 + kk + u];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(xv, w[u][j], acc[r][j]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) red[(warp * R + r) * TW + lane + 32 * j] = acc[r][j];
}

__device__ __forceinline__ float red_sum(const float* red, int R, int r, int n) {
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < NW; ++w) s += red[(w * R + r) * TW + n];
  return s;
}

template <int R, typename T>
__device__ void load_rows(const T* src, int width, int row0, int nrows, float* xs) {
  for (int i = threadIdx.x; i < R * width; i += NT)
    xs[i] = i / width < nrows ? to_f(src[(size_t)row0 * width + i]) : 0.f;
}

// h2 = ReLU(ReLU(x W1 + b1) W2 + b2) for a tile of R rows.
template <int R, typename T>
__global__ void __launch_bounds__(NT) trunk_kernel(const HeadArgs a) {
  extern __shared__ float4 smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);  // [R][C]
  float* h1 = xs + R * a.C;                         // [R][Hd]
  float* red = h1 + R * a.Hd;                       // [NW][R][TW]
  const int row0 = blockIdx.x * R, nrows = min(R, a.B - row0);
  const T* b1 = static_cast<const T*>(a.b1);
  const T* b2 = static_cast<const T*>(a.b2);
  T* h2 = static_cast<T*>(a.h2);
  load_rows<R, T>(static_cast<const T*>(a.x), a.C, row0, nrows, xs);
  __syncthreads();
  for (int n0 = 0; n0 < a.Hd; n0 += TW) {
    tile_partials<R, T>(xs, a.C, static_cast<const T*>(a.w1), a.Hd, n0, a.Hd, red);
    __syncthreads();
    for (int i = threadIdx.x; i < R * TW; i += NT) {
      const int r = i / TW, n = i % TW;
      if (n0 + n < a.Hd) h1[r * a.Hd + n0 + n] = rnd<T>(fmaxf(red_sum(red, R, r, n) + to_f(b1[n0 + n]), 0.f));
    }
    __syncthreads();
  }
  for (int n0 = 0; n0 < a.Hd; n0 += TW) {
    tile_partials<R, T>(h1, a.Hd, static_cast<const T*>(a.w2), a.Hd, n0, a.Hd, red);
    __syncthreads();
    for (int i = threadIdx.x; i < R * TW; i += NT) {
      const int r = i / TW, n = i % TW;
      if (r < nrows && n0 + n < a.Hd)
        h2[(size_t)(row0 + r) * a.Hd + n0 + n] = from_f<T>(fmaxf(red_sum(red, R, r, n) + to_f(b2[n0 + n]), 0.f));
    }
    __syncthreads();
  }
}

// Logits of vocab slab blockIdx.y for a tile of R rows, then each row's slab
// statistics (one warp per row).
template <int R, typename T>
__global__ void __launch_bounds__(NT) blocks_kernel(const HeadArgs a) {
  extern __shared__ float4 smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);  // [R][Hd]
  float* red = xs + R * a.Hd;                       // [NW][R][TW]
  float* lg = red + NW * R * TW;                    // [R][TW] logits
  const int row0 = blockIdx.x * R, nrows = min(R, a.B - row0);
  const int g = blockIdx.y, ng = gridDim.y, n0 = g * TW;
  const T* b3 = static_cast<const T*>(a.b3);
  load_rows<R, T>(static_cast<const T*>(a.h2), a.Hd, row0, nrows, xs);
  __syncthreads();
  tile_partials<R, T>(xs, a.Hd, static_cast<const T*>(a.w3), a.V, n0, a.V, red);
  __syncthreads();
  for (int i = threadIdx.x; i < R * TW; i += NT) {
    const int r = i / TW, n = i % TW;
    lg[i] = n0 + n < a.V ? red_sum(red, R, r, n) + to_f(b3[n0 + n]) : -INFINITY;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < nrows; r += NW) {
    float v[8];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = lg[r * TW + lane + 32 * j];
      m = fmaxf(m, v[j]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float se = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) se += expf(v[j] - m);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) se += __shfl_xor_sync(0xffffffffu, se, o);
    const size_t o_row = (size_t)(row0 + r) * ng + g;
    if (lane == 0) {
      a.mx[o_row] = m;
      a.se[o_row] = se;
    }
    // k rounds of (max, lowest column) over the columns not taken yet
    unsigned taken = 0;
    for (int i = 0; i < a.k; ++i) {
      float bv = -INFINITY;
      int bc = 0x7fffffff;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = lane + 32 * j;
        if (!((taken >> j) & 1u) && (v[j] > bv || (v[j] == bv && c < bc))) {
          bv = v[j];
          bc = c;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oc = __shfl_xor_sync(0xffffffffu, bc, o);
        if (ov > bv || (ov == bv && oc < bc)) {
          bv = ov;
          bc = oc;
        }
      }
      if (bc < TW && (bc & 31) == lane) taken |= 1u << (bc >> 5);
      if (lane == 0) {
        a.vals[o_row * a.k + i] = bv;
        a.idx[o_row * a.k + i] = n0 + bc;
      }
    }
  }
}

template <typename Kern>
int set_smem(Kern kern, size_t bytes, size_t& granted) {
  if (bytes > granted) {
    const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    granted = bytes;
  }
  return 0;
}

template <typename T>
int launch_trunk(const HeadArgs& a, cudaStream_t st) {
  static size_t granted = 0;
  const size_t bytes = ((size_t)kRows * (a.C + a.Hd) + (size_t)NW * kRows * TW) * sizeof(float);
  if (const int e = set_smem(trunk_kernel<kRows, T>, bytes, granted)) return e;
  trunk_kernel<kRows, T><<<(a.B + kRows - 1) / kRows, NT, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_blocks(const HeadArgs& a, cudaStream_t st) {
  static size_t granted = 0;
  const size_t bytes = ((size_t)kRows * a.Hd + (size_t)(NW + 1) * kRows * TW) * sizeof(float);
  if (const int e = set_smem(blocks_kernel<kRows, T>, bytes, granted)) return e;
  const dim3 grid((a.B + kRows - 1) / kRows, (a.V + TW - 1) / TW);
  blocks_kernel<kRows, T><<<grid, NT, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched).
int rt_head_trunk(const HeadArgs* a, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_trunk<__nv_bfloat16>(*a, st) : launch_trunk<float>(*a, st);
}
int rt_head_blocks(const HeadArgs* a, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_blocks<__nv_bfloat16>(*a, st) : launch_blocks<float>(*a, st);
}
const char* rt_head_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
