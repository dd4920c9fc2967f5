// Vocab-blocked MLP-head kernels for Hopper (sm_90a): the decode tail of the
// caption model (C -> Hd -> Hd -> V with ReLU between) without writing the
// [rows, V] logits to device memory.
//
// Two entry points, the counterparts of two Pallas kernels of
// retr_tpu/ops/decoder_kernels.py:
//   rt_head_trunk   <- the trunk of mlp_head_argmax (_head_kernel): h1 = ReLU(x W1 + b1),
//                      then h2 = ReLU(h1 W2 + b2), each stored in the storage type
//                      (two launches of one kernel)
//   rt_head_blocks  <- the vocab-block body of mlp_head_argmax and mlp_head_topk
//                      (_head_kernel, _head_topk_kernel): the logits h2 W3 + b3 of one
//                      128-wide vocab slab for a tile of rows, then per row the slab's
//                      top-k (value, first index), its max and sum(exp(logit - max))
// The pick across slabs (argmax, or top-k plus the online logsumexp) runs in
// PyTorch on the [rows, slabs, k] outputs, as the TPU left it to XLA.
//
// Bound: W3 is Hd x V (31 MB in bf16 at 512 x 30522) against 2 operations per
// element per row: bytes below ~300 rows, operations above. Design: the vocab
// product is a tiled product h2 [N, Hd] x W3 [Hd, V] with the slab statistics in
// its epilogue. A block owns a tile of R rows (32, 64 or 128: every row up to 128
// rows, 128-row tiles above) and one slab; blockIdx.x walks the row tiles, so the
// blocks of one slab run side by side and W3 comes from device memory about once
// per call, the other row tiles' reads from L2. K streams through a 6-stage
// cp.async ring (an h2 tile and a W3 tile per stage, one barrier per stage;
// rows past the batch are zero-filled, not re-read: 96 copies of one row per
// block made an L2 hot spot at 160 rows). bf16 multiplies on tensor
// cores (ldmatrix, mma.sync.m16n8k16, f32 accumulators; the primitives of
// common.cuh), f32 on the CUDA cores with the same tiles. After the last stage
// the ring's memory holds the tile's logits + b3 (f32), and NT / R threads per
// row take that row's statistics over interleaved columns, merged by warp
// shuffles in a fixed order: the max with its lowest column, the sum of
// exponentials, then each further top-k entry as the best column after the
// previous one in (value desc, column asc) order, so no list is kept, and k
// may be anything up to 256 (rounds past a slab's 128 columns give -inf).
//
// W3's rows are 2V bytes apart in bf16, not 16-byte aligned at V = 30522, and
// cp.async and ldmatrix need 16 bytes. So the kernel takes W3 packed: its vocab
// padded to a multiple of 8 columns with zero weights and a -inf bias
// (pack_head in ops/decoder_kernels.py, once per decode call, as the TPU padded
// to 2048 with -1e30 on every call), and copies it in 16-byte pieces, zero past
// V; columns at or past V read as -inf. (4-byte copies of the unpadded W3 ran at
// about one copy per cycle per SM: 2.3 us per ring stage on the H100.)
//
// The trunk (latency-bound: 0.75 MB of weights): one block per 16-row x 8-column
// tile of a layer's output (128 blocks at 32 rows and Hd = 512), whose 8 warps
// take the K dimension's 32-row chunks in turn and add their partials in warp
// order. Hd is a multiple of 32 (pack_head pads it with zero units); the input
// width C may be anything: the tiles are zero-filled up to a multiple of 32,
// and an input whose rows are not 16-byte aligned is copied element by element.
//
// Numerics follow the TPU kernels: each product casts its input to the weight
// type and accumulates in f32; h1 and h2 are rounded to the storage type where
// the next product reads them; logits, max and sum of exponentials are f32.
// Within a slab ties go to the lowest vocab index. No atomics: the same inputs
// give the same bits.

#include "common.cuh"

// Launch arguments, mirrored field for field by _HeadArgs in ops/decoder_kernels.py.
struct HeadArgs {
  int B, C, Hd, V, k;   // rows, trunk input width, hidden width, vocab, top-k per slab
  const void* x;        // [B, C]
  const void* w1; const void* b1; const void* w2; const void* b2;
  void* h1;             // [B, Hd]: the trunk's first layer
  void* h2;             // [B, Hd]: written by the trunk, read by the slabs
  const void* w3; const void* b3;
  float* vals;          // [B, G, k] slab top-k logits, G = ceil(V / 128)
  int* idx;             // [B, G, k] their vocab ids
  float* mx;            // [B, G] slab max
  float* se;            // [B, G] slab sum(exp(logit - max))
};

namespace {

constexpr int SLAB = 128;    // vocab columns per block
constexpr int KMAX = 256;    // most top-k entries a row returns (HEAD_KMAX in ops/decoder_kernels.py)
constexpr int NSTAGE = 6;    // cp.async ring depth of the vocab product (2 blocks per SM)
constexpr int TR = 16;       // trunk tile rows (the mma M)
constexpr int TN = 8;        // trunk tile columns (one mma N)

// Vocab-product tiling per storage type: KS weight rows per ring stage, rows of
// the h2 tile (ALD) and W3 tile (BLD) padded by 16 bytes so ldmatrix rows fall
// on distinct banks.
template <typename T> struct VT {
  static constexpr int KS = sizeof(T) == 2 ? 32 : 16;
  static constexpr int ALD = KS + 16 / sizeof(T);
  static constexpr int BLD = SLAB + 16 / sizeof(T);
};

// 16 bytes, or zeros where bytes == 0 (src is then not read).
__device__ __forceinline__ void cp_async16z(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes)
               : "memory");
}

// ---------------------------------------------------------------------------------
// Trunk
// ---------------------------------------------------------------------------------

// Warp's share of a trunk tile: its 32-row K chunks (warp, warp + NW, ...) of
// A [TR][lda] against Ws [K][TN]; bf16: one mma D fragment, f32: rows lane/2,
// columns 4 * (lane % 2)...
__device__ __forceinline__ void trunk_chunks(const __nv_bfloat16* A, int lda, const __nv_bfloat16* Ws, int K,
                                             float (&acc)[4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int k0 = warp * 32; k0 < K; k0 += NW * 32) {
    uint32_t b[4];                                // k 0-7, 8-15, 16-23, 24-31 of the chunk
    ldsm_x4_trans(b, Ws + (k0 + lane) * TN);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t af[4];
      ldsm_x4(af, A + (lane & 15) * lda + k0 + ks * 16 + (lane >> 4) * 8);
      mma_bf16(acc, af, b[2 * ks], b[2 * ks + 1]);
    }
  }
}
__device__ __forceinline__ void trunk_chunks(const float* A, int lda, const float* Ws, int K, float (&acc)[4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 1, c0 = 4 * (lane & 1);
  for (int k0 = warp * 32; k0 < K; k0 += NW * 32) {
#pragma unroll 8
    for (int kk = 0; kk < 32; ++kk) {
      const float av = A[r * lda + k0 + kk];
      const float4 w = *reinterpret_cast<const float4*>(Ws + (k0 + kk) * TN + c0);
      acc[0] = fmaf(av, w.x, acc[0]);
      acc[1] = fmaf(av, w.y, acc[1]);
      acc[2] = fmaf(av, w.z, acc[2]);
      acc[3] = fmaf(av, w.w, acc[3]);
    }
  }
}

// red[warp][r][n] of the lane's accumulators (the layouts of trunk_chunks).
template <typename T> __device__ __forceinline__ void trunk_partials(float* red, const float (&acc)[4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* w = red + warp * TR * TN;
  if constexpr (sizeof(T) == 2) {
    const int g = lane >> 2, t = lane & 3;
    w[g * TN + 2 * t] = acc[0];
    w[g * TN + 2 * t + 1] = acc[1];
    w[(g + 8) * TN + 2 * t] = acc[2];
    w[(g + 8) * TN + 2 * t + 1] = acc[3];
  } else {
    const int r = lane >> 1, c0 = 4 * (lane & 1);
#pragma unroll
    for (int j = 0; j < 4; ++j) w[r * TN + c0 + j] = acc[j];
  }
}

// K rounded up to the trunk's 32-row chunks.
__host__ __device__ inline int trunk_k(int K) { return (K + 31) & ~31; }

// out = ReLU(in W + bias) for rows blockIdx.x * TR.., columns blockIdx.y * TN..:
// in [B, K], W [K, N], out [B, N], all row-major in T; N a multiple of 8. The
// tiles hold K rounded up to 32 (trunk_k), zeros past K; `vec`: in's rows are
// 16-byte aligned (K a multiple of 16 bytes), so they are copied by cp.async.
template <typename T>
__global__ void __launch_bounds__(NT) trunk_kernel(const T* in, const T* W, const T* bias, T* out, int B, int K,
                                                   int N, int vec) {
  constexpr int E = 16 / sizeof(T);               // elements per 16-byte piece
  extern __shared__ float4 smem_raw[];
  const int KP = trunk_k(K), lda = KP + E;
  T* A = reinterpret_cast<T*>(smem_raw);          // [TR][lda]
  T* Ws = A + TR * lda;                           // [KP][TN]
  float* red = reinterpret_cast<float*>(Ws + KP * TN);   // [NW][TR][TN]
  const int row0 = blockIdx.x * TR, n0 = blockIdx.y * TN;
  if (vec) {
    for (int i = threadIdx.x; i < TR * KP / E; i += NT) {
      const int r = i / (KP / E), s = i % (KP / E);
      const bool in_b = row0 + r < B && s * E < K;   // rows past B, columns past K: zeros
      cp_async16z(A + r * lda + s * E, in + (in_b ? (size_t)(row0 + r) * K + s * E : 0), in_b ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < TR * KP; i += NT) {
      const int r = i / KP, k = i % KP;
      A[r * lda + k] = row0 + r < B && k < K ? in[(size_t)(row0 + r) * K + k] : from_f<T>(0.f);
    }
  }
  for (int i = threadIdx.x; i < KP * TN / E; i += NT) {
    const int r = i / (TN / E), s = i % (TN / E);
    cp_async16z(Ws + r * TN + s * E, W + (r < K ? (size_t)r * N + n0 + s * E : 0), r < K ? 16 : 0);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  trunk_chunks(A, lda, Ws, KP, acc);
  trunk_partials<T>(red, acc);
  __syncthreads();
  if (threadIdx.x < TR * TN) {
    const int r = threadIdx.x / TN, n = threadIdx.x % TN;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) s += red[w * TR * TN + threadIdx.x];   // warp order: fixed
    if (row0 + r < B) out[(size_t)(row0 + r) * N + n0 + n] = from_f<T>(fmaxf(s + to_f(bias[n0 + n]), 0.f));
  }
}

// ---------------------------------------------------------------------------------
// Vocab product and slab statistics
// ---------------------------------------------------------------------------------

// One ring stage: h2 rows row0.. (zero past the batch), columns k0..k0+KS-1,
// and W3 rows k0..k0+KS-1, columns n0..n0+SLAB-1 (zero past V), as 16-byte
// pieces. The caller commits.
template <typename T, int R>
__device__ __forceinline__ void load_vocab_stage(T* As, const HeadArgs& a, int row0, int n0, int k0) {
  using Tl = VT<T>;
  T* Bs = As + R * Tl::ALD;
  const T* h2 = static_cast<const T*>(a.h2);
  const T* w3 = static_cast<const T*>(a.w3);
  constexpr int E = 16 / sizeof(T), PR = Tl::KS / E;   // pieces per h2 tile row
  for (int i = threadIdx.x; i < R * PR; i += NT) {
    const int r = i / PR, s = i % PR;
    const bool in = row0 + r < a.B;
    cp_async16z(As + r * Tl::ALD + s * E, h2 + (in ? (size_t)(row0 + r) * a.Hd + k0 + s * E : 0), in ? 16 : 0);
  }
  constexpr int PW = SLAB / E;                        // pieces per W3 tile row
  for (int i = threadIdx.x; i < Tl::KS * PW; i += NT) {
    const int r = i / PW, s = i % PW, col = n0 + s * E;
    const bool in = col < a.V;                        // V % 8 == 0: a piece is all in or all out
    cp_async16z(Bs + r * Tl::BLD + s * E, w3 + (size_t)(k0 + r) * a.V + (in ? col : 0), in ? 16 : 0);
  }
}

// The block's R x SLAB logits: bf16 on tensor cores (warp grid WM x WN, each
// warp MI m16 tiles x NI n8 tiles), f32 on the CUDA cores (thread rows
// tr + 16 i, columns 4 tc.. and 64 + 4 tc..).
template <typename T, int R> struct VocabAcc;

template <int R> struct VocabAcc<__nv_bfloat16, R> {
  using Tl = VT<__nv_bfloat16>;
  static constexpr int WM = R == 128 ? 4 : 2, WN = NW / WM;
  static constexpr int MI = R / (16 * WM), NI = SLAB / (8 * WN);
  float acc[MI][NI][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }
  __device__ __forceinline__ void stage(const __nv_bfloat16* As) {
    const __nv_bfloat16* Bs = As + R * Tl::ALD;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int rb = (warp / WN) * MI * 16, cb = (warp % WN) * NI * 8;
#pragma unroll
    for (int ks = 0; ks < Tl::KS / 16; ++ks) {
      uint32_t af[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        ldsm_x4(af[mi], As + (rb + mi * 16 + (lane & 15)) * Tl::ALD + ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NI / 2; ++np) {       // two n8 tiles per ldmatrix
        uint32_t b[4];
        ldsm_x4_trans(b, Bs + (ks * 16 + (lane & 15)) * Tl::BLD + cb + np * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          mma_bf16(acc[mi][2 * np], af[mi], b[0], b[1]);
          mma_bf16(acc[mi][2 * np + 1], af[mi], b[2], b[3]);
        }
      }
    }
  }
  // lg[r][c] = logit + bias(c) for the lane's fragments
  template <typename Bias> __device__ __forceinline__ void store(float* lg, int ldl, Bias bias) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int rb = (warp / WN) * MI * 16, cb = (warp % WN) * NI * 8;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int r = rb + mi * 16 + g, c = cb + ni * 8 + 2 * t;
        const float b0 = bias(c), b1 = bias(c + 1);
        lg[r * ldl + c] = acc[mi][ni][0] + b0;
        lg[r * ldl + c + 1] = acc[mi][ni][1] + b1;
        lg[(r + 8) * ldl + c] = acc[mi][ni][2] + b0;
        lg[(r + 8) * ldl + c + 1] = acc[mi][ni][3] + b1;
      }
  }
};

template <int R> struct VocabAcc<float, R> {
  using Tl = VT<float>;
  static constexpr int MI = R / 16;
  float acc[MI][8];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  __device__ __forceinline__ void stage(const float* As) {
    const float* Bs = As + R * Tl::ALD;
    const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
#pragma unroll 4
    for (int kk = 0; kk < Tl::KS; ++kk) {
      const float4 w0 = *reinterpret_cast<const float4*>(Bs + kk * Tl::BLD + 4 * tc);
      const float4 w1 = *reinterpret_cast<const float4*>(Bs + kk * Tl::BLD + SLAB / 2 + 4 * tc);
      const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const float av = As[(tr + 16 * i) * Tl::ALD + kk];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, w[j], acc[i][j]);
      }
    }
  }
  template <typename Bias> __device__ __forceinline__ void store(float* lg, int ldl, Bias bias) const {
    const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = (j < 4 ? 0 : SLAB / 2) + 4 * tc + (j & 3);
      const float b = bias(c);
#pragma unroll
      for (int i = 0; i < MI; ++i) lg[(tr + 16 * i) * ldl + c] = acc[i][j] + b;
    }
  }
};

// (value, column) order of the top-k: value descending, ties to the lower
// column. NaN is never better than anything.
__device__ __forceinline__ bool better(float x, int xc, float y, int yc) { return x > y || (x == y && xc < yc); }

// The best (value, column) over the TPR consecutive lanes of a row, on all of
// them (the order is total, so every lane ends with the same pair).
template <int TPR> __device__ __forceinline__ void best_of_row(float& v, int& c) {
#pragma unroll
  for (int lvl = 0; (1 << lvl) < TPR; ++lvl) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, 1 << lvl);
    const int oc = __shfl_xor_sync(0xffffffffu, c, 1 << lvl);
    if (better(ov, oc, v, c)) {
      v = ov;
      c = oc;
    }
  }
}

// Each row's statistics over the tile's logits lg [R][ldl]: TPR = NT / R
// consecutive threads per row, thread h taking columns h, h + TPR, ... A first
// pass takes the row's best (value, column), which is its max and top-1; a
// second its sum of exponentials; top-k round i then takes the best column
// after round i-1's in the order, so no list is kept. Merges across the row's
// threads use xor shuffles in a fixed order (same bits every launch).
template <int R>
__device__ __forceinline__ void slab_stats(const float* lg, const HeadArgs& a, int row0, int n0) {
  constexpr int TPR = NT / R, PER = SLAB / TPR, LDL = SLAB + TPR;
  const int r = threadIdx.x / TPR, h = threadIdx.x % TPR;
  const float* row = lg + r * LDL;
  const bool out = h == 0 && row0 + r < a.B;
  const size_t o = (size_t)(row0 + r) * gridDim.y + blockIdx.y;
  float bv = -INFINITY;
  int bc = SLAB;                                  // sentinel: any column beats it
#pragma unroll 8
  for (int j = 0; j < PER; ++j) {
    const float x = row[j * TPR + h];
    if (better(x, j * TPR + h, bv, bc)) {
      bv = x;
      bc = j * TPR + h;
    }
  }
  best_of_row<TPR>(bv, bc);
  const float m = bv;
  float se = 0.f;
#pragma unroll 8
  for (int j = 0; j < PER; ++j) se += expf(row[j * TPR + h] - m);
#pragma unroll
  for (int lvl = 0; (1 << lvl) < TPR; ++lvl) se += __shfl_xor_sync(0xffffffffu, se, 1 << lvl);
  if (out) {
    a.mx[o] = m;
    a.se[o] = se;
    a.vals[o * a.k] = bv;
    a.idx[o * a.k] = n0 + bc;
  }
  for (int i = 1; i < a.k; ++i) {
    const float pv = bv;
    const int pc = bc;
    bv = -INFINITY;
    bc = SLAB;
#pragma unroll 8
    for (int j = 0; j < PER; ++j) {
      const float x = row[j * TPR + h];
      const int c = j * TPR + h;
      if (better(pv, pc, x, c) && better(x, c, bv, bc)) {
        bv = x;
        bc = c;
      }
    }
    best_of_row<TPR>(bv, bc);
    if (out) {
      a.vals[o * a.k + i] = bv;
      a.idx[o * a.k + i] = n0 + bc;
    }
  }
}

// Logits of vocab slab blockIdx.y for row tile blockIdx.x, then each row's slab
// statistics.
template <typename T, int R>
__global__ void __launch_bounds__(NT, 2) vocab_kernel(const HeadArgs a) {
  using Tl = VT<T>;
  constexpr int STAGE = R * Tl::ALD + Tl::KS * Tl::BLD;   // elements of one ring stage
  extern __shared__ float4 smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  const int row0 = blockIdx.x * R, n0 = blockIdx.y * SLAB;
  const int stages = a.Hd / Tl::KS;
  // one commit group per stage (empty past the last), NSTAGE - 1 in flight
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < stages) load_vocab_stage<T, R>(ring + s * STAGE, a, row0, n0, s * Tl::KS);
    cp_async_commit();
  }
  VocabAcc<T, R> acc;
  acc.zero();
  for (int s = 0; s < stages; ++s) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();                              // stage s is in; every warp is done with stage s - 1
    const int nx = s + NSTAGE - 1;                // refills stage s - 1's buffer
    if (nx < stages) load_vocab_stage<T, R>(ring + (nx % NSTAGE) * STAGE, a, row0, n0, nx * Tl::KS);
    cp_async_commit();
    acc.stage(ring + (s % NSTAGE) * STAGE);
  }
  cp_async_wait<0>();
  __syncthreads();                                // every warp is done with the ring
  constexpr int LDL = SLAB + NT / R;
  float* lg = reinterpret_cast<float*>(smem_raw);   // the ring's memory, free now
  const T* b3 = static_cast<const T*>(a.b3);
  acc.store(lg, LDL, [&](int c) { return n0 + c < a.V ? to_f(b3[n0 + c]) : -INFINITY; });
  __syncthreads();
  slab_stats<R>(lg, a, row0, n0);
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
int launch_trunk_layer(const T* in, const T* W, const T* bias, T* out, int B, int K, int N, cudaStream_t st) {
  static size_t granted = 0;
  const int KP = trunk_k(K);
  const size_t bytes = ((size_t)TR * (KP + 16 / sizeof(T)) + (size_t)KP * TN) * sizeof(T) + NW * TR * TN * sizeof(float);
  if (const int e = set_smem(trunk_kernel<T>, bytes, granted)) return e;
  const int vec = (K * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0;
  trunk_kernel<T><<<dim3((B + TR - 1) / TR, N / TN), NT, bytes, st>>>(in, W, bias, out, B, K, N, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_trunk(const HeadArgs& a, cudaStream_t st) {
  if (a.B < 1 || a.C < 1 || a.Hd % 32) return (int)cudaErrorInvalidValue;
  T* h1 = static_cast<T*>(a.h1);
  if (const int e = launch_trunk_layer<T>(static_cast<const T*>(a.x), static_cast<const T*>(a.w1),
                                          static_cast<const T*>(a.b1), h1, a.B, a.C, a.Hd, st))
    return e;
  return launch_trunk_layer<T>(h1, static_cast<const T*>(a.w2), static_cast<const T*>(a.b2), static_cast<T*>(a.h2),
                               a.B, a.Hd, a.Hd, st);
}

template <typename T, int R>
int launch_vocab(const HeadArgs& a, cudaStream_t st) {
  using Tl = VT<T>;
  static size_t granted = 0;
  const size_t ring = (size_t)NSTAGE * (R * Tl::ALD + Tl::KS * Tl::BLD) * sizeof(T);
  const size_t logits = (size_t)R * (SLAB + NT / R) * sizeof(float);
  const size_t bytes = ring > logits ? ring : logits;
  if (const int e = set_smem(vocab_kernel<T, R>, bytes, granted)) return e;
  vocab_kernel<T, R><<<dim3((a.B + R - 1) / R, (a.V + SLAB - 1) / SLAB), NT, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_blocks(const HeadArgs& a, cudaStream_t st) {
  if (a.B < 1 || a.Hd % 32 || a.k < 1 || a.k > KMAX || a.k > a.V || a.V % 8)
    return (int)cudaErrorInvalidValue;
  if (a.B <= 32) return launch_vocab<T, 32>(a, st);
  if (a.B <= 64) return launch_vocab<T, 64>(a, st);
  return launch_vocab<T, 128>(a, st);
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
