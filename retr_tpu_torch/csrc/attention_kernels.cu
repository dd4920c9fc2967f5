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
// Numerics are the TPU kernel's: the scores are f32 products of q and k,
// scaled by D**-0.5, the bias is clamped at -1e30 and added, the causal mask
// (key > query -> -1e30) is applied after it, the softmax is exact (max, exp,
// sum, then e / sum), and the probabilities are rounded to v's type before the
// PV product, which accumulates in f32; the output is cast to q's type.
//
// Bound on the card: at the model's shapes (Sk <= 397, D = 32) the function
// moves 4 * B*H*S*D elements and does 4 * B*H*Sq*Sk*D operations; on tensor
// cores the bytes bound it in bf16, the operations in f32 (3 products per
// product, below).
//
// Design (mma_kernel, head dims 16, 32 and 64). One block of 8 warps (4 at
// D = 16) per (b, h, tile of QT = 32 query rows; 64-row tiles of 8 or 16
// warps were no faster at the model's shapes and fit fewer blocks per SM).
// The block keeps its whole [QT, Sk] f32 score block in shared memory, so the
// softmax is exact and done once between two passes: pass 1 takes S = Q K^T a 64-key tile
// at a time and the row maxima from its accumulators, a warp per row then
// turns each score into exp(s - max), sums the row and writes e / sum in v's
// type, and pass 2 takes O = P V. K and then V tiles stream as one
// sequence of stages through a 3-stage cp.async ring in their own type (rows
// padded by 16 bytes, so ldmatrix and the f32 fragment loads are free of bank
// conflicts; keys past Sk zero-filled), and the first V tiles are in flight
// during the softmax. No online-softmax rescale: it would move the point
// where the probabilities are rounded.
//   bf16: mma.sync.m16n8k16 with f32 accumulators; Q's fragments stay in
//     registers, K comes through ldmatrix, V through ldmatrix.trans, P
//     through ldmatrix from the score block's rows, where the softmax packed
//     it as bf16. The
//     scale multiplies the f32 score after the product (q * scale is not a
//     bf16 value), a few f32 ulps from the TPU kernel's order.
//   f32: 3xTF32 on mma.sync.m16n8k8: each operand splits into a TF32 high
//     part and the TF32 rounding of the rest, and hi.hi + hi.lo + lo.hi
//     keeps about 22 bits of each product, against 11 for one TF32 product
//     (which would miss the f32 tolerance 1e-4). q is scaled in f32 first, as
//     the TPU kernel scales it.
//   The warps of a 16-row strip split each key tile in both passes; their
//   partial outputs are added in warp order at the end.
//   Causal: key tiles wholly above the tile's last query row are skipped in
//   both passes. A row that sees only masked keys gets the mean of V over
//   all Sk keys, as below: the block then runs pass 2 over every key tile,
//   the skipped ones as -1e30 scores.
//
// Other shapes (any_kernel): a head dim other than 16, 32 or 64, or a score
// block of 32 rows too large for shared memory. The same numerics untiled,
// with D and the query rows per block (32 halved until the scores fit, down to
// 1, chosen by attention_plan) known at run time: pass 1 gives a thread a
// (row, key) pair, which reads its key row from global memory; pass 2 a
// (row, column) pair, which walks V's column in key order. Right first: no
// tiles are staged.
//
// An all-masked row (every key at -1e30) gets uniform probabilities over the
// real Sk keys: the mean of V (the TPU kernel averaged over its 128-padded
// length). The model never produces such a row.

#include "common.cuh"

// Launch arguments, mirrored field for field by _AttnArgs in ops/decoder_kernels.py.
struct AttnArgs {
  int B, H, Sq, Sk, D, causal;
  int tile;                // query rows per block (ops/attention.attention_plan)
  int mma;                 // 1: mma_kernel (D 16, 32 or 64; tile 32), 0: any_kernel
  float scale;             // D**-0.5 in f32, computed by the caller
  const void* q;
  const void* k;
  const void* v;
  const float* key_bias;   // [B, Sk] additive bias, or null: no bias
  void* out;
};

namespace {

constexpr int KT = 64;     // keys per ring stage
constexpr int NSTG = 3;    // ring stages
constexpr float kNegInf = -1e30f;
constexpr size_t kMaxSmem = 232448;  // a block's shared-memory limit on Hopper

constexpr int QT = 32;     // query rows per block of mma_kernel: two 16-row strips
// Warps per strip: each takes 1/WN of each key tile in pass 1 and of the
// output columns in pass 2 (at least one n8 tile): 4, or 2 at D = 16.
__host__ __device__ constexpr int strip_warps(int d) { return d >= 32 ? 4 : 2; }

// mma_kernel's shared memory: the score block [QT][score_ld] f32 and the ring
// of NSTG stages of KT rows x (D + 8) elements (at the end, the strip warps'
// partial outputs [WN][QT][D] f32), the maxima of the strip warps' key
// shares [WN][QT], row maxima [QT] and a flag. The score row stride is 4
// words past a multiple of 32, so ldmatrix's 8 row addresses and the f32
// fragment loads fall on distinct banks. ops/attention.py mirrors it.
__host__ __device__ inline int score_ld(int sk) { return (sk + 31) / 32 * 32 + 4; }
__host__ __device__ inline size_t mma_smem(int d, int sk, bool bf16) {
  const size_t passes = (size_t)QT * score_ld(sk) * 4 + (size_t)NSTG * KT * (d + 8) * (bf16 ? 2 : 4);
  const size_t parts = (size_t)strip_warps(d) * QT * d * 4;
  return (passes > parts ? passes : parts) + (size_t)QT * 4 * (strip_warps(d) + 1) + 16;
}
size_t any_smem(int qt, int d, int sk) { return (size_t)qt * (d + sk) * sizeof(float); }

// 16 bytes from global memory, or zeros where bytes == 0 (rows past Sk).
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes)
               : "memory");
}
// D += A B for one m16n8k8 tile: TF32 inputs, f32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// x = hi + lo + (what TF32 drops of the rest): hi, lo TF32 values.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}
// Small terms first: lo.hi + hi.lo, then hi.hi.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

template <int D, typename T>
__global__ void __launch_bounds__(QT / 16 * strip_warps(D) * 32) mma_kernel(const AttnArgs a) {
  constexpr bool BF = sizeof(T) == 2;
  constexpr int WN = strip_warps(D);
  constexpr int NTH = QT / 16 * WN * 32;
  constexpr int NWP = NTH / 32;
  constexpr int KLD = BF ? D + 8 : D + 4;         // K tile row stride (elements)
  constexpr int VLD = D + 8;                      // V tile row stride
  constexpr int STG = KT * (D + 8);               // stage size (elements)
  constexpr int NK8 = KT / WN / 8;                // pass 1: a warp's n8 key tiles
  constexpr int KS = BF ? 16 : 8;                 // mma depth
  extern __shared__ float4 smem_raw[];
  const int sk = a.Sk, sld = score_ld(sk);
  float* sc = reinterpret_cast<float*>(smem_raw);
  T* ring = reinterpret_cast<T*>(sc + QT * sld);
  constexpr size_t kParts = (size_t)WN * QT * D * 4;
  const size_t passes = (size_t)QT * sld * 4 + (size_t)NSTG * STG * sizeof(T);
  float* pmax = reinterpret_cast<float*>(reinterpret_cast<char*>(smem_raw) + (passes > kParts ? passes : kParts));
  float* rowmax = pmax + WN * QT;                 // [QT]
  int* flag = reinterpret_cast<int*>(rowmax + QT);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int bh = blockIdx.x, b = bh / a.H, q0 = blockIdx.y * QT, nq = min(QT, a.Sq - q0);
  const T* qg = static_cast<const T*>(a.q) + (size_t)bh * a.Sq * D;
  const T* kg = static_cast<const T*>(a.k) + (size_t)bh * sk * D;
  const T* vg = static_cast<const T*>(a.v) + (size_t)bh * sk * D;
  const float* bias = a.key_bias ? a.key_bias + (size_t)b * sk : nullptr;
  const int nkt = (sk + KT - 1) / KT;
  const int kend = a.causal ? min(sk, q0 + nq) : sk;   // keys any row of the tile may see
  const int nk1 = (kend + KT - 1) / KT;

  // stage i: K tile i for i < nk1, then V tile i - nk1 (loaded past pass 2's
  // last tile at most NSTG - 1 times, never past the last key tile)
  auto load = [&](int i) {
    const bool isk = i < nk1;
    const int j = isk ? i : i - nk1;
    if (j >= nkt) return;
    constexpr int E = 16 / sizeof(T), SEG = D / E;
    const int ld = isk ? KLD : VLD, nrow = min(KT, sk - j * KT);
    const T* src = (isk ? kg : vg) + (size_t)j * KT * D;
    T* dst = ring + (i % NSTG) * STG;
    for (int idx = tid; idx < KT * SEG; idx += NTH) {
      const int r = idx / SEG, s = idx % SEG;
      cp_async16_zfill(dst + r * ld + s * E, src + (size_t)(r < nrow ? r : 0) * D + s * E, r < nrow ? 16 : 0);
    }
  };
  for (int i = 0; i < NSTG - 1; ++i) {            // one commit group per stage, NSTG - 1 in flight
    load(i);
    cp_async_commit();
  }
  if (tid == 0) *flag = 0;

  // Q's fragments of the warp's 16 rows (zeros past Sq), in registers
  const int ra = wm * 16 + g;                     // the lane's first row in the tile (and ra + 8)
  const bool in0 = ra < nq, in1 = ra + 8 < nq;
  uint32_t qh[D / KS][4], ql[BF ? 1 : D / KS][4];
#pragma unroll
  for (int kd = 0; kd < D / KS; ++kd) {
    if constexpr (BF) {
      const T* p0 = qg + (size_t)(q0 + ra) * D + kd * 16 + 2 * t4;
      const T* p1 = p0 + 8 * D;
      qh[kd][0] = in0 ? *reinterpret_cast<const uint32_t*>(p0) : 0u;
      qh[kd][1] = in1 ? *reinterpret_cast<const uint32_t*>(p1) : 0u;
      qh[kd][2] = in0 ? *reinterpret_cast<const uint32_t*>(p0 + 8) : 0u;
      qh[kd][3] = in1 ? *reinterpret_cast<const uint32_t*>(p1 + 8) : 0u;
    } else {
      const T* p0 = qg + (size_t)(q0 + ra) * D + kd * 8 + t4;
      const T* p1 = p0 + 8 * D;
      const float v[4] = {in0 ? to_f(p0[0]) * a.scale : 0.f, in1 ? to_f(p1[0]) * a.scale : 0.f,
                          in0 ? to_f(p0[4]) * a.scale : 0.f, in1 ? to_f(p1[4]) * a.scale : 0.f};
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(v[e], qh[kd][e], ql[kd][e]);
    }
  }

  // Pass 1: scores of the key tiles the tile's rows may see, and the lane's
  // running maxima of its two rows.
  float mx[2] = {-INFINITY, -INFINITY};
  for (int i = 0; i < nk1; ++i) {
    load(i + NSTG - 1);
    cp_async_commit();
    cp_async_wait<NSTG - 1>();
    __syncthreads();                              // stage i is in
    const T* kt = ring + (i % NSTG) * STG;
    const int n0 = wn * (KT / WN);                // the warp's first key in the tile
    float acc[NK8][4];
#pragma unroll
    for (int n = 0; n < NK8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D / KS; ++kd) {
#pragma unroll
      for (int n = 0; n < NK8; n += (BF ? 2 : 1)) {
        if constexpr (BF) {
          uint32_t r[4];                          // (keys n, d lo), (n, d hi), (n + 8, lo), (n + 8, hi)
          ldsm_x4(r, kt + (n0 + n * 8 + (lane & 7) + ((lane >> 4) << 3)) * KLD + kd * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(acc[n], qh[kd], r[0], r[1]);
          mma_bf16(acc[n + 1], qh[kd], r[2], r[3]);
        } else {
          const T* kp = kt + (n0 + n * 8 + g) * KLD + kd * 8 + t4;
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(to_f(kp[0]), bh0, bl0);
          split_tf32(to_f(kp[4]), bh1, bl1);
          mma_3xtf32(acc[n], qh[kd], ql[kd], bh0, bh1, bl0, bl1);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NK8; ++n) {
      const int c0 = i * KT + n0 + n * 8 + 2 * t4;
      float bc[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) bc[e] = bias && c0 + e < sk ? fmaxf(__ldg(bias + c0 + e), kNegInf) : 0.f;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {            // rows ra, ra + 8
        const int r = ra + 8 * hf;
        float s2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float s = (BF ? acc[n][2 * hf + e] * a.scale : acc[n][2 * hf + e]) + bc[e];
          if (a.causal && c0 + e > q0 + r) s = kNegInf;
          s2[e] = s;
          if (c0 + e < sk) mx[hf] = fmaxf(mx[hf], s);
        }
        float* dst = sc + r * sld + c0;
        if (c0 + 1 < sk) {
          *reinterpret_cast<float2*>(dst) = make_float2(s2[0], s2[1]);
        } else if (c0 < sk) {
          dst[0] = s2[0];
        }
      }
    }
    __syncthreads();                              // stage i's buffer may be refilled
  }

  // Row maxima: the four lanes of a row, then the WN warps of its strip.
  // Keys past kend were skipped (causal): their scores are -1e30. A row whose
  // maximum is -1e30 sees no unmasked key and takes uniform probabilities
  // over all Sk keys; the flag then runs pass 2 over every key tile.
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
    if (t4 == 0) pmax[wn * QT + ra + 8 * hf] = mx[hf];
  }
  __syncthreads();
  if (tid < nq) {
    float m = pmax[tid];
#pragma unroll
    for (int w = 1; w < WN; ++w) m = fmaxf(m, pmax[w * QT + tid]);
    if (kend < sk) m = fmaxf(m, kNegInf);
    rowmax[tid] = m;
    if (m <= kNegInf && kend < sk) *flag = 1;
  }
  __syncthreads();
  const int kw = *flag ? sk : kend;               // keys of pass 2
  const int kwp = (kw + KS - 1) / KS * KS;        // ... padded to the mma depth with zeros

  // Exact softmax, a warp per row: e = exp(s - max) in place with the row's
  // sum, then p = e / sum in v's type (zeros up to kwp): f32 in place; bf16
  // packed into the row's first half, 512 columns a round, each round's
  // values read before any is written (a round writes below the columns it
  // and the earlier rounds read), so pass 2 reads P with ldmatrix.
  for (int r = warp; r < nq; r += NWP) {
    float* row = sc + r * sld;
    const float m = rowmax[r];
    float s = 0.f;
    for (int c0 = 0; c0 < kw; c0 += 128) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + 32 * j + lane;
        if (c < kw) {
          const float e = expf((c < kend ? row[c] : kNegInf) - m);
          row[c] = e;
          s += e;
        }
      }
    }
    s = warp_sum(s);
    T* prow = reinterpret_cast<T*>(row);
    for (int c0 = 0; c0 < kwp; c0 += 512) {
      float e[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = c0 + 32 * j + lane;
        e[j] = c < kw ? row[c] / s : 0.f;
      }
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = c0 + 32 * j + lane;
        if (c < kwp) prow[c] = from_f<T>(e[j]);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // Pass 2: out = P . V over the key tiles of pass 2; the warps of a strip
  // take a quarter (half at D = 16) of each tile's keys for all D columns.
  constexpr int KQ = KT / WN;                     // keys of a tile per warp
  const int nk2 = (kw + KT - 1) / KT;
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  for (int j = 0; j < nk2; ++j) {
    const int i = nk1 + j;
    load(i + NSTG - 1);
    cp_async_commit();
    cp_async_wait<NSTG - 1>();
    __syncthreads();                              // stage i is in
    const T* vt = ring + (i % NSTG) * STG;
    const int k0 = j * KT, steps = max(0, min(KQ, min(KT, kwp - k0) - wn * KQ)) / KS;
    for (int ks = 0; ks < steps; ++ks) {
      const int kk = wn * KQ + ks * KS;           // the step's first key in the tile
      if constexpr (BF) {
        uint32_t pa[4];                           // P's fragment: rows of the strip, keys kk .. kk + 15
        ldsm_x4(pa, reinterpret_cast<const T*>(sc + (wm * 16 + (lane & 15)) * sld) + k0 + kk + (lane >> 4) * 8);
#pragma unroll
        for (int n = 0; n < D / 8; n += 2) {
          uint32_t r[4];                          // (k lo, cols n), (k hi, n), (k lo, n + 8), (k hi, n + 8)
          ldsm_x4_trans(r, vt + (kk + (lane & 15)) * VLD + n * 8 + (lane >> 4) * 8);
          mma_bf16(o[n], pa, r[0], r[1]);
          mma_bf16(o[n + 1], pa, r[2], r[3]);
        }
      } else {
        const float* p0 = sc + ra * sld + k0 + kk;
        const float* p1 = p0 + 8 * sld;
        uint32_t ah[4], al[4];
        split_tf32(p0[t4], ah[0], al[0]);
        split_tf32(p1[t4], ah[1], al[1]);
        split_tf32(p0[t4 + 4], ah[2], al[2]);
        split_tf32(p1[t4 + 4], ah[3], al[3]);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          const T* vp = vt + (kk + t4) * VLD + n * 8 + g;
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(to_f(vp[0]), bh0, bl0);
          split_tf32(to_f(vp[4 * VLD]), bh1, bl1);
          mma_3xtf32(o[n], ah, al, bh0, bh1, bl0, bl1);
        }
      }
    }
    __syncthreads();                              // stage i's buffer may be refilled
  }
  cp_async_wait<0>();
  __syncthreads();                                // the score block and the ring are free

  // The strip warps' partial outputs [WN][QT][D] over the score block and
  // ring, then summed in warp order.
  float* part = sc;
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      part[(wn * QT + ra + (e >= 2 ? 8 : 0)) * D + n * 8 + 2 * t4 + (e & 1)] = o[n][e];
  __syncthreads();
  T* out = static_cast<T*>(a.out) + ((size_t)bh * a.Sq + q0) * D;
  for (int idx = tid; idx < nq * D; idx += NTH) {
    float v = part[idx];
#pragma unroll
    for (int w = 1; w < WN; ++w) v += part[w * QT * D + idx];
    out[idx] = from_f<T>(v);
  }
}

template <int D, typename T>
int launch_mma(const AttnArgs& a, cudaStream_t stream) {
  const size_t bytes = mma_smem(D, a.Sk, sizeof(T) == 2);
  if (a.tile != QT || bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kern = mma_kernel<D, T>;
  static size_t granted = 0;  // dynamic shared memory already allowed for this kernel
  if (bytes > granted) {      // and the largest shared-memory carveout, for blocks side by side
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    granted = bytes;
  }
  kern<<<dim3(a.B * a.H, (a.Sq + QT - 1) / QT), QT / 16 * strip_warps(D) * 32, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const AttnArgs& a, cudaStream_t st) {
  if (a.D == 16) return launch_mma<16, T>(a, st);
  if (a.D == 32) return launch_mma<32, T>(a, st);
  if (a.D == 64) return launch_mma<64, T>(a, st);
  return (int)cudaErrorInvalidValue;
}

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
    for (int c = lane; c < sk; c += 32) row[c] = rnd<T>(row[c] / s);
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
  const int qt = a.tile;
  const size_t bytes = any_smem(qt, a.D, a.Sk);
  if (qt < 1 || bytes > kMaxSmem || a.Sq > 65535 * qt) return (int)cudaErrorInvalidValue;
  static size_t granted = 0;
  if (bytes > 48 * 1024 && bytes > granted) {
    const cudaError_t e = cudaFuncSetAttribute(any_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    granted = bytes;
  }
  any_kernel<T><<<dim3(a.B * a.H, (a.Sq + qt - 1) / qt), NT, bytes, stream>>>(a, qt);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int rt_fused_attention(const AttnArgs* a, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->B < 1 || a->H < 1 || a->Sq < 1 || a->Sk < 1 || a->D < 1) return (int)cudaErrorInvalidValue;
  if (a->mma) {
    if (a->Sq > 65535 * a->tile) return (int)cudaErrorInvalidValue;
    return bf16 ? launch_d<__nv_bfloat16>(*a, st) : launch_d<float>(*a, st);
  }
  return bf16 ? launch_any<__nv_bfloat16>(*a, st) : launch_any<float>(*a, st);
}

const char* rt_attn_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
