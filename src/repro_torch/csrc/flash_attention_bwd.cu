// Flash attention backward for Hopper (sm_90a), GQA, causal / sliding
// window / q_offset / key padding; fully masked rows get zero gradient.
//
// The reference trains through the Pallas TPU kernel
// repro/kernels/attention.py::flash_attention (_fa_kernel) under
// jax.value_and_grad; this is the gradient of that function, from the row
// log-sum-exp the forward writes (flash_attention.cu, `lse`). It is
// FlashAttention-2's algebra, recomputing P instead of storing it:
//
//   delta_i = sum_d dO_id O_id                   (per query row)
//   P_ij    = exp(scale * q_i.k_j - lse_i)       (0 where masked)
//   dV_j   += sum_i P_ij dO_i
//   dS_ij   = P_ij (dO_i.v_j - delta_i)
//   dQ_i    = scale * sum_j dS_ij k_j
//   dK_j   += scale * sum_i dS_ij q_i
//
// Two launches a call on one stream, dq first (dk/dv reads its delta).
// Two designs, chosen by dtype, as the forward chooses:
//
// * bf16, on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
//   accumulate), tiles kept bf16 in shared memory, rows padded by 16
//   bytes so that ldmatrix hits distinct banks, 16-byte cp.async copies
//   in two stages (tile j+1 loads while tile j computes):
//   - fa_bwd_dq_mma<D>: grid (B*H, S/32), 64 threads. Each of the two
//     warps owns 16 query rows: it computes their delta from dO (shared)
//     and O (global), writes it to the fp32 (B, H, S) scratch, and keeps
//     its Q and dO fragments in registers (D <= 80; at D = 128 they are
//     read again from shared memory, which the register budget of the dQ
//     accumulator needs). 64-key K and V tiles stream over the keys its
//     rows can see: S = Q K^T and dP = dO V^T on mma.sync; P and dS in
//     fp32 on the accumulator fragments; dS, packed to bf16, is the A
//     operand of dQ += dS K as it stands (K through ldmatrix.trans).
//     32 rows a block, not 64: the training shape then launches 144
//     blocks on 132 SMs instead of 72.
//   - fa_bwd_dkdv_mma<D>: grid (B*H, T/64), 128 threads: one block per
//     (b, query head, 64-key tile), each warp owning 16 keys, whose K and
//     V fragments stay in registers (D <= 80). 64-row Q and dO tiles,
//     with their lse and delta, stream over the visible query tiles.
//     S^T = K Q^T and dP^T = V dO^T put the keys on the M rows, so P^T
//     and dS^T land in accumulator layout and are the A operands of
//     dV += P^T dO and dK += dS^T Q (dO and Q through ldmatrix.trans).
//     At D = 128 the scores run 32 queries at a time.
//   - The GQA sum: each block writes its head's fp32 dK and dV partial
//     (unscaled) to a (B, T, H, D) scratch; the last block of its (b, KV
//     head, key tile) to arrive (an int counter that fa_bwd_dq_mma
//     resets, __threadfence on both sides, as pa_pv does) sums the
//     group's partials in head order, scales dK and writes bf16. No
//     float atomics: two calls give the same bits. With H == KV a block
//     writes its result directly.
//   Rounding points: S and dP accumulate in fp32 from bf16 operands; P =
//   exp(scale S - lse) and dS = P (dP - delta) are fp32, and are rounded
//   to bf16 once each where they enter a product (P for dV, dS for dQ
//   and dK); dQ, dK and dV accumulate in fp32 and are rounded once.
//   Takes rows that start on 16 bytes (the wrapper copies others).
// * fp32, fa_bwd_dq<T, D> then fa_bwd_dkdv<T, D>: the first design,
//   scalar fp32 FMAs from fp32 tiles in shared memory (bf16 inputs are
//   widened as they load; the wrapper runs it for bf16 only on request,
//   as the yardstick of the tensor-core kernels). fa_bwd_dq: grid
//   (B*H, S/32); fa_bwd_dkdv: grid (B*KV, T/32), each block looping over
//   its KV head's whole query group, so the GQA sum needs no atomics.
//
// Bound on the card (bytes: q, k, v, o, dO and lse read once, dq, dk, dv
// written once; operations: the five products over the visible pairs,
// 10 D flops a pair): at smollm-135m's training shape (B=2, S=T=256,
// H=9, KV=3, D=64, bf16, causal) 3.16 MB, ~0.95 us at 3.35 TB/s, against
// 0.38 GFLOP, ~0.38 us at the bf16 peak; at its serving shape (B=8,
// S=T=512) 25.3 MB, ~7.6 us, against 6.05 GFLOP, ~6.1 us. Both memory
// bound. At the training shape the first design launched 144 dq blocks
// and 48 dk/dv blocks (each looping over 3 heads); this one 144 dq
// blocks of 2 warps and 72 dk/dv blocks of 4 warps. PERF.md has the
// times.
//
// Later work: wgmma with TMA-fed tiles (FlashAttention-3), dQ in the
// dk/dv kernel (one launch, dQ summed across blocks), persistent blocks
// ordered by their causal work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention_bwd.so flash_attention_bwd.cu
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

#include "sm90_common.cuh"

namespace {

constexpr int NT = 128;  // threads per block
constexpr int BO = 32;   // rows a block owns: queries (dq), keys (dk/dv)
constexpr int BI = 64;   // rows streamed per tile: keys (dq), queries (dk/dv)
constexpr int RPT = BO * BI / NT;   // score entries per thread per tile: 16

// element strides over (B, row, head) of the eight tensors, in this order
enum { SQ = 0, SK = 3, SV = 6, SO = 9, SDO = 12, SDQ = 15, SDK = 18,
       SDV = 21, NSTRIDES = 24 };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;    // (B, H, S), from the forward
  float* delta;        // (B, H, S) scratch: written by dq, read by dk/dv
  float* dk_part;      // (B, T, H, D) scratch: per-head dK partials (mma)
  float* dv_part;      // (B, T, H, D) scratch: per-head dV partials (mma)
  int* arrivals;       // (B, KV, T/64) counters (mma): reset by dq
  void* dq;
  void* dk;
  void* dv;
  long long st[NSTRIDES];
  int B, S, T, H, KV;
  int causal, window, q_offset;
  float scale;
  int n_arrivals;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// rows [row0, row0 + ROWS) of one (batch, head) slice into an fp32 tile of
// pitch D + 1; rows at or past `limit` are 0
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long row_stride, int row0,
                                          int limit) {
  for (int i = threadIdx.x; i < ROWS * D; i += NT) {
    const int r = i / D, d = i - (i / D) * D;
    const int row = row0 + r;
    dst[r * (D + 1) + d] = row < limit ? to_f(src[row * row_stride + d]) : 0.f;
  }
}

// whether query row i sees key j: the forward's mask
__device__ __forceinline__ bool visible(const Params& p, int i, int j) {
  if (i >= p.S || j >= p.T) return false;
  const int qpos = i + p.q_offset;
  if (p.causal && j > qpos) return false;
  if (p.window > 0 && j <= qpos - p.window) return false;
  return true;
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) *
         (2 * BO * (D + 1) + 2 * BI * (D + 1) + BO * (BI + 1) + 2 * BO);
}

template <int D>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(float) *
         (2 * BO * (D + 1) + 2 * BI * (D + 1) + 2 * BI * (BO + 1) + 2 * BI);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) fa_bwd_dq(const Params p) {
  constexpr int DP = D + 1;
  constexpr int SP = BI + 1;
  constexpr int CPT = D / 4;     // dQ columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;              // BO x DP
  float* dOs = Qs + BO * DP;     // BO x DP
  float* Ks = dOs + BO * DP;     // BI x DP; holds the O tile first
  float* Vs = Ks + BI * DP;      // BI x DP
  float* dSs = Vs + BI * DP;     // BO x SP
  float* lse_s = dSs + BO * SP;  // BO
  float* dl_s = lse_s + BO;      // BO

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int kvh = h / (p.H / p.KV);
  const int q0 = blockIdx.y * BO;
  const long long* st = p.st;
  const T* qg = static_cast<const T*>(p.q) + b * st[SQ] + h * st[SQ + 2];
  const T* kg = static_cast<const T*>(p.k) + b * st[SK] + kvh * st[SK + 2];
  const T* vg = static_cast<const T*>(p.v) + b * st[SV] + kvh * st[SV + 2];
  const T* og = static_cast<const T*>(p.o) + b * st[SO] + h * st[SO + 2];
  const T* dog =
      static_cast<const T*>(p.dout) + b * st[SDO] + h * st[SDO + 2];
  T* dqg = static_cast<T*>(p.dq) + b * st[SDQ] + h * st[SDQ + 2];

  load_rows<T, D, BO>(Qs, qg, st[SQ + 1], q0, p.S);
  load_rows<T, D, BO>(dOs, dog, st[SDO + 1], q0, p.S);
  load_rows<T, D, BO>(Ks, og, st[SO + 1], q0, p.S);
  __syncthreads();
  {  // delta of the block's rows: 4 lanes a row, then two shuffles
    const int r = tid >> 2, part = tid & 3;
    float acc = 0.f;
    for (int d = part; d < D; d += 4)
      acc = fmaf(dOs[r * DP + d], Ks[r * DP + d], acc);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      const int row = q0 + r;
      dl_s[r] = acc;
      lse_s[r] = row < p.S ? p.lse[(long long)bh * p.S + row] : 0.f;
      if (row < p.S) p.delta[(long long)bh * p.S + row] = acc;
    }
  }

  // the key tiles some row of this block can see (the forward's bounds)
  const int first_pos = q0 + p.q_offset;
  const int last_pos = min(q0 + BO, p.S) - 1 + p.q_offset;
  int k_end = p.T;
  if (p.causal) k_end = min(k_end, last_pos + 1);
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, first_pos - p.window + 1);
  k_begin = (k_begin / BI) * BI;

  float acc[CPT];
#pragma unroll
  for (int cc = 0; cc < CPT; ++cc) acc[cc] = 0.f;
  const int jA = tid & (BI - 1), rA = tid / BI;   // score entries
  const int rB = tid & (BO - 1), dB = tid / BO;   // dQ rows and columns

  for (int k0 = k_begin; k0 < k_end; k0 += BI) {
    __syncthreads();   // the O tile / previous K, V and dS consumed
    load_rows<T, D, BI>(Ks, kg, st[SK + 1], k0, p.T);
    load_rows<T, D, BI>(Vs, vg, st[SV + 1], k0, p.T);
    __syncthreads();
    // scores and dO.v of key jA with rows rA, rA + 2, ...
    float s[RPT], dp[RPT];
#pragma unroll
    for (int e = 0; e < RPT; ++e) s[e] = dp[e] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      const float kv = Ks[jA * DP + d], vv = Vs[jA * DP + d];
#pragma unroll
      for (int e = 0; e < RPT; ++e) {
        const int r = rA + 2 * e;
        s[e] = fmaf(Qs[r * DP + d], kv, s[e]);
        dp[e] = fmaf(dOs[r * DP + d], vv, dp[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < RPT; ++e) {
      const int r = rA + 2 * e;
      float ds = 0.f;
      if (visible(p, q0 + r, k0 + jA)) {
        const float pr = expf(s[e] * p.scale - lse_s[r]);
        ds = pr * (dp[e] - dl_s[r]);
      }
      dSs[r * SP + jA] = ds;
    }
    __syncthreads();
    // dQ += dS K
    for (int j = 0; j < BI; ++j) {
      const float ds = dSs[rB * SP + j];
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc)
        acc[cc] = fmaf(ds, Ks[j * DP + dB + 4 * cc], acc[cc]);
    }
  }

  const int row = q0 + rB;
  if (row < p.S) {
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc)
      dqg[row * st[SDQ + 1] + dB + 4 * cc] = from_f<T>(acc[cc] * p.scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) fa_bwd_dkdv(const Params p) {
  constexpr int DP = D + 1;
  constexpr int SP = BO + 1;
  constexpr int CPT = D / 4;     // dK and dV columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;              // BO x DP
  float* Vs = Ks + BO * DP;      // BO x DP
  float* Qs = Vs + BO * DP;      // BI x DP
  float* dOs = Qs + BI * DP;     // BI x DP
  float* Ps = dOs + BI * DP;     // BI x SP
  float* dSs = Ps + BI * SP;     // BI x SP
  float* lse_s = dSs + BI * SP;  // BI
  float* dl_s = lse_s + BI;      // BI

  const int tid = threadIdx.x;
  const int b = blockIdx.x / p.KV;
  const int kvh = blockIdx.x - b * p.KV;
  const int k0 = blockIdx.y * BO;
  const int group = p.H / p.KV;
  const long long* st = p.st;
  const T* kg = static_cast<const T*>(p.k) + b * st[SK] + kvh * st[SK + 2];
  const T* vg = static_cast<const T*>(p.v) + b * st[SV] + kvh * st[SV + 2];
  T* dkg = static_cast<T*>(p.dk) + b * st[SDK] + kvh * st[SDK + 2];
  T* dvg = static_cast<T*>(p.dv) + b * st[SDV] + kvh * st[SDV + 2];

  load_rows<T, D, BO>(Ks, kg, st[SK + 1], k0, p.T);
  load_rows<T, D, BO>(Vs, vg, st[SV + 1], k0, p.T);

  // the query rows that can see a key of this tile: causal -> positions at
  // or after the first key; window -> before the last key + window
  const int k_last = min(k0 + BO, p.T) - 1;
  int i_begin = 0, i_end = p.S;
  if (p.causal) i_begin = max(0, k0 - p.q_offset);
  if (p.window > 0) i_end = min(i_end, k_last + p.window - p.q_offset);
  i_begin = (i_begin / BI) * BI;

  float dk[CPT], dv[CPT];
#pragma unroll
  for (int cc = 0; cc < CPT; ++cc) dk[cc] = dv[cc] = 0.f;
  const int jA = tid & (BO - 1), rA = tid / BO;   // score entries
  const int jB = tid & (BO - 1), dB = tid / BO;   // dK/dV rows and columns

  for (int hh = 0; hh < group; ++hh) {
    const int h = kvh * group + hh;
    const T* qg = static_cast<const T*>(p.q) + b * st[SQ] + h * st[SQ + 2];
    const T* dog =
        static_cast<const T*>(p.dout) + b * st[SDO] + h * st[SDO + 2];
    const long long row_base = ((long long)b * p.H + h) * p.S;
    for (int i0 = i_begin; i0 < i_end; i0 += BI) {
      __syncthreads();   // the previous tile's Q, dO, P and dS consumed
      load_rows<T, D, BI>(Qs, qg, st[SQ + 1], i0, p.S);
      load_rows<T, D, BI>(dOs, dog, st[SDO + 1], i0, p.S);
      for (int r = tid; r < BI; r += NT) {
        const bool in = i0 + r < p.S;
        lse_s[r] = in ? p.lse[row_base + i0 + r] : 0.f;
        dl_s[r] = in ? p.delta[row_base + i0 + r] : 0.f;
      }
      __syncthreads();
      // scores and dO.v of key jA with rows rA, rA + 4, ...
      float s[RPT], dp[RPT];
#pragma unroll
      for (int e = 0; e < RPT; ++e) s[e] = dp[e] = 0.f;
#pragma unroll 2
      for (int d = 0; d < D; ++d) {
        const float kv = Ks[jA * DP + d], vv = Vs[jA * DP + d];
#pragma unroll
        for (int e = 0; e < RPT; ++e) {
          const int r = rA + 4 * e;
          s[e] = fmaf(Qs[r * DP + d], kv, s[e]);
          dp[e] = fmaf(dOs[r * DP + d], vv, dp[e]);
        }
      }
#pragma unroll
      for (int e = 0; e < RPT; ++e) {
        const int r = rA + 4 * e;
        float pr = 0.f, ds = 0.f;
        if (visible(p, i0 + r, k0 + jA)) {
          pr = expf(s[e] * p.scale - lse_s[r]);
          ds = pr * (dp[e] - dl_s[r]);
        }
        Ps[r * SP + jA] = pr;
        dSs[r * SP + jA] = ds;
      }
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q
      for (int r = 0; r < BI; ++r) {
        const float pr = Ps[r * SP + jB], ds = dSs[r * SP + jB];
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) {
          dv[cc] = fmaf(pr, dOs[r * DP + dB + 4 * cc], dv[cc]);
          dk[cc] = fmaf(ds, Qs[r * DP + dB + 4 * cc], dk[cc]);
        }
      }
    }
  }

  const int row = k0 + jB;
  if (row < p.T) {
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      dkg[row * st[SDK + 1] + dB + 4 * cc] = from_f<T>(dk[cc] * p.scale);
      dvg[row * st[SDV + 1] + dB + 4 * cc] = from_f<T>(dv[cc]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
typedef __nv_bfloat16 bf16;
constexpr int PAD = 8;        // bf16 elements (16 bytes) of padding per row
constexpr int MT = 64;        // rows of a streamed tile; keys of a dk/dv block
constexpr int DQ_ROWS = 32;   // query rows of a dq block: two warps
constexpr int DQ_NT = 64;
constexpr int KV_NT = 128;    // dk/dv: four warps of 16 keys

template <int D>
constexpr size_t dq_mma_smem_bytes() {   // Q, dO + 2 x (K, V) + delta
  return sizeof(bf16) * (2 * DQ_ROWS + 4 * MT) * (D + PAD) +
         sizeof(float) * DQ_ROWS;
}
template <int D>
constexpr size_t dkdv_mma_smem_bytes() {   // K, V + 2 x (Q, dO, lse, delta)
  return sizeof(bf16) * 6 * MT * (D + PAD) + sizeof(float) * 4 * MT;
}

// rows [row0, row0 + ROWS) of one (batch, head) slice into a bf16 tile of
// pitch D + PAD by 16-byte cp.async copies; rows at or past limit are 0
template <int D, int ROWS, int NTH>
__device__ __forceinline__ void cp_rows(bf16* dst, const bf16* src,
                                        long long stride, int row0,
                                        int limit) {
  constexpr int CH = D / 8;
  static_assert((ROWS * CH) % NTH == 0, "whole copies per thread");
#pragma unroll
  for (int it = 0; it < ROWS * CH / NTH; ++it) {
    const int i = threadIdx.x + it * NTH;
    const int r = i / CH, c = i - (i / CH) * CH;
    const bool in = row0 + r < limit;
    const bf16* from = in ? src + (row0 + r) * stride + c * 8 : src;
    cp_async16(smem_u32(dst + r * (D + PAD) + c * 8), from, in);
  }
}

// ldmatrix addresses (lane = 8 m + i gives row i of matrix m), pitch P:
// the A fragment of rows row0..+15 at k-step kk of a row-major tile
template <int P>
__device__ __forceinline__ uint32_t a_addr(const bf16* tile, int row0,
                                           int kk, int lane) {
  const int mi = lane >> 3;
  return smem_u32(tile + (row0 + (lane & 7) + (mi & 1) * 8) * P + kk * 16 +
                  (mi >> 1) * 8);
}
// B fragments of two n-tiles (rows n0..n0+15 of the tile, k-step kk): the
// tile's rows are the n dim (K for Q K^T)
template <int P>
__device__ __forceinline__ uint32_t b_addr(const bf16* tile, int n0, int kk,
                                           int lane) {
  const int mi = lane >> 3;
  return smem_u32(tile + (n0 + (lane & 7) + (mi >> 1) * 8) * P + kk * 16 +
                  (mi & 1) * 8);
}
// B fragments (with ldmatrix.trans) of two n-tiles (columns 16 np..+15)
// over k rows k0..k0+15: the tile's rows are the k dim (K for dS K)
template <int P>
__device__ __forceinline__ uint32_t bt_addr(const bf16* tile, int k0, int np,
                                            int lane) {
  const int mi = lane >> 3;
  return smem_u32(tile + (k0 + (lane & 7) + (mi & 1) * 8) * P + np * 16 +
                  (mi >> 1) * 8);
}

// the A fragment of accumulator tiles n, n + 1 (16 columns), rounded
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// whether the query at position qpos sees the key at kpos: the mask alone,
// on positions (cheaper in registers than `visible`, whose bounds checks
// the tensor-core kernels do elsewhere)
__device__ __forceinline__ bool sees(const Params& p, int qpos, int kpos) {
  if (p.causal && kpos > qpos) return false;
  if (p.window > 0 && kpos <= qpos - p.window) return false;
  return true;
}

// lse as the products use it: a row with no visible key (lse = -inf) or
// past S reads +inf, so exp(s - lse) = 0 there whatever the mask says
__device__ __forceinline__ float lse_or_inf(const Params& p, long long base,
                                            int row) {
  const float v = row < p.S ? p.lse[base + row] : INFINITY;
  return v == -INFINITY ? INFINITY : v;
}

// this warp's 16 rows of an fp32 accumulator (times `mul`) as bf16 into
// its own rows of a shared tile, then 16-byte rows to global (rows < limit)
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4],
                                           float mul, bf16* stage, int wrow,
                                           bf16* dst, long long stride,
                                           int row0, int limit, int lane) {
  constexpr int P = D + PAD, CH = D / 8;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    bf16* r0 = stage + (wrow + g) * P + n * 8 + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(r0) =
        __floats2bfloat162_rn(acc[n][0] * mul, acc[n][1] * mul);
    *reinterpret_cast<__nv_bfloat162*>(r0 + 8 * P) =
        __floats2bfloat162_rn(acc[n][2] * mul, acc[n][3] * mul);
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < CH / 2; ++it) {
    const int i = lane + it * 32;
    const int r = i / CH, c = i - (i / CH) * CH;
    const int row = row0 + wrow + r;
    if (row < limit)
      *reinterpret_cast<uint4*>(dst + row * stride + c * 8) =
          *reinterpret_cast<const uint4*>(stage + (wrow + r) * P + c * 8);
  }
}

template <int D>
__global__ void __launch_bounds__(DQ_NT) fa_bwd_dq_mma(const Params p) {
  constexpr int P = D + PAD;
  constexpr int KSTEPS = D / 16;
  constexpr int NTO = D / 8;          // 8-column tiles of dQ
  constexpr bool PIN = D <= 80;       // Q and dO fragments in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // DQ_ROWS x P
  bf16* dOs = Qs + DQ_ROWS * P;                   // DQ_ROWS x P
  bf16* Ks = dOs + DQ_ROWS * P;                   // 2 stages of MT x P
  bf16* Vs = Ks + 2 * MT * P;                     // 2 stages of MT x P
  float* dl_s = reinterpret_cast<float*>(Vs + 2 * MT * P);   // DQ_ROWS

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  {  // the dk/dv kernel's arrival counters, for this call
    const int nth = gridDim.x * gridDim.y * DQ_NT;
    for (int i = (blockIdx.y * gridDim.x + blockIdx.x) * DQ_NT + tid;
         i < p.n_arrivals; i += nth)
      p.arrivals[i] = 0;
  }
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int kvh = h / (p.H / p.KV);
  // the last query tiles (the most key tiles under a causal mask) first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * DQ_ROWS;
  const long long* st = p.st;
  const bf16* qg = static_cast<const bf16*>(p.q) + b * st[SQ] + h * st[SQ + 2];
  const bf16* kg =
      static_cast<const bf16*>(p.k) + b * st[SK] + kvh * st[SK + 2];
  const bf16* vg =
      static_cast<const bf16*>(p.v) + b * st[SV] + kvh * st[SV + 2];
  const bf16* og = static_cast<const bf16*>(p.o) + b * st[SO] + h * st[SO + 2];
  const bf16* dog =
      static_cast<const bf16*>(p.dout) + b * st[SDO] + h * st[SDO + 2];
  bf16* dqg = static_cast<bf16*>(p.dq) + b * st[SDQ] + h * st[SDQ + 2];

  // the key tiles some row of this block can see (the forward's bounds)
  const int first_pos = q0 + p.q_offset;
  const int last_pos = min(q0 + DQ_ROWS, p.S) - 1 + p.q_offset;
  int k_end = p.T;
  if (p.causal) k_end = min(k_end, last_pos + 1);
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, first_pos - p.window + 1);
  k_begin = (k_begin / MT) * MT;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + MT - 1) / MT : 0;

  cp_rows<D, DQ_ROWS, DQ_NT>(Qs, qg, st[SQ + 1], q0, p.S);
  cp_rows<D, DQ_ROWS, DQ_NT>(dOs, dog, st[SDO + 1], q0, p.S);
  cp_async_commit();
  if (n_tiles > 0) {
    cp_rows<D, MT, DQ_NT>(Ks, kg, st[SK + 1], k_begin, p.T);
    cp_rows<D, MT, DQ_NT>(Vs, vg, st[SV + 1], k_begin, p.T);
  }
  cp_async_commit();
  cp_async_wait<1>();          // Q and dO have landed
  __syncthreads();

  const int wrow = warp * 16;
  const long long row_base = (long long)bh * p.S;
  {  // delta of the warp's 16 rows: two lanes a row, dO from shared
     // memory, O from global, 16 bytes at a time
    const int r = lane >> 1, half = lane & 1;
    const int row = q0 + wrow + r;
    float acc = 0.f;
    if (row < p.S) {
      const bf16* orow = og + row * st[SO + 1] + half * (D / 2);
      const bf16* drow = dOs + (wrow + r) * P + half * (D / 2);
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c * 8);
        const uint4 dv = *reinterpret_cast<const uint4*>(drow + c * 8);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(o2[e]);
          const float2 df = __bfloat1622float2(d2[e]);
          acc = fmaf(df.x, of.x, acc);
          acc = fmaf(df.y, of.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      dl_s[wrow + r] = acc;
      if (row < p.S) p.delta[row_base + row] = acc;
    }
  }
  __syncwarp();
  const float dl0 = dl_s[wrow + g], dl1 = dl_s[wrow + g + 8];
  const float ls0 = lse_or_inf(p, row_base, q0 + wrow + g);
  const float ls1 = lse_or_inf(p, row_base, q0 + wrow + g + 8);

  uint32_t qf[PIN ? KSTEPS : 1][4], dof[PIN ? KSTEPS : 1][4];
  if constexpr (PIN) {
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      ldsm_x4(qf[kk], a_addr<P>(Qs, wrow, kk, lane));
      ldsm_x4(dof[kk], a_addr<P>(dOs, wrow, kk, lane));
    }
  }

  const int w_first = q0 + wrow + p.q_offset;   // positions of the warp's
  const int w_last = w_first + 15;              // first and last rows
  const bool warp_live = q0 + wrow < p.S;
  float acc[NTO][4];
#pragma unroll
  for (int n = 0; n < NTO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = k_begin + j * MT;
    const int s_ = j & 1;
    if (j + 1 < n_tiles) {
      cp_rows<D, MT, DQ_NT>(Ks + (s_ ^ 1) * MT * P, kg, st[SK + 1], k0 + MT,
                            p.T);
      cp_rows<D, MT, DQ_NT>(Vs + (s_ ^ 1) * MT * P, vg, st[SV + 1], k0 + MT,
                            p.T);
    }
    cp_async_commit();
    cp_async_wait<1>();        // tile j has landed
    __syncthreads();
    // a tile that none of this warp's rows can see changes nothing
    const bool skip = !warp_live || (p.causal && k0 > w_last) ||
                      (p.window > 0 && k0 + MT - 1 <= w_first - p.window);
    if (!skip) {
      const bf16* Kt = Ks + s_ * MT * P;
      const bf16* Vt = Vs + s_ * MT * P;
      float s[8][4], dp[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t aq[4], ado[4];
        if constexpr (PIN) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            aq[e] = qf[PIN ? kk : 0][e];
            ado[e] = dof[PIN ? kk : 0][e];
          }
        } else {
          ldsm_x4(aq, a_addr<P>(Qs, wrow, kk, lane));
          ldsm_x4(ado, a_addr<P>(dOs, wrow, kk, lane));
        }
#pragma unroll
        for (int np = 0; np < 4; ++np) {   // 16 keys: two n-tiles
          uint32_t bk[4], bv[4];
          ldsm_x4(bk, b_addr<P>(Kt, np * 16, kk, lane));
          mma_bf16(s[2 * np], aq, bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], aq, bk[2], bk[3]);
          ldsm_x4(bv, b_addr<P>(Vt, np * 16, kk, lane));
          mma_bf16(dp[2 * np], ado, bv[0], bv[1]);
          mma_bf16(dp[2 * np + 1], ado, bv[2], bv[3]);
        }
      }
      // P and dS in fp32; the mask only where the tile crosses T, the
      // diagonal or the window edge for some row of this warp
      const bool need_mask = k0 + MT > p.T ||
                             (p.causal && k0 + MT - 1 > w_first) ||
                             (p.window > 0 && k0 <= w_last - p.window);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pr = expf(s[n][e] * p.scale - (e < 2 ? ls0 : ls1));
          if (need_mask) {
            const int kpos = k0 + n * 8 + 2 * t + (e & 1);
            const int qpos = w_first + g + (e < 2 ? 0 : 8);
            if (kpos >= p.T || !sees(p, qpos, kpos)) pr = 0.f;
          }
          s[n][e] = pr * (dp[n][e] - (e < 2 ? dl0 : dl1));   // dS
        }
      // dQ += dS K: keys 16 kk..+15 are the accumulator tiles 2 kk, 2 kk+1
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t da[4];
        pack_a(da, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int np = 0; np < NTO / 2; ++np) {   // 16 columns of dQ
          uint32_t bk[4];
          ldsm_x4_trans(bk, bt_addr<P>(Kt, kk * 16, np, lane));
          mma_bf16(acc[2 * np], da, bk[0], bk[1]);
          mma_bf16(acc[2 * np + 1], da, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();           // stage s_ is refilled in iteration j + 1
  }
  cp_async_wait<0>();
  // the warp's own rows of the Q tile stage dQ (no other warp reads them)
  store_rows<D>(acc, p.scale, Qs, wrow, dqg, st[SDQ + 1], q0, p.S, lane);
}

template <int D>
__global__ void __launch_bounds__(KV_NT) fa_bwd_dkdv_mma(const Params p) {
  constexpr int P = D + PAD;
  constexpr int KSTEPS = D / 16;
  constexpr int NTO = D / 8;           // 8-column tiles of dK and dV
  constexpr bool PIN = D <= 80;        // K and V fragments in registers
  constexpr int QC = D > 80 ? 32 : 64; // queries per S^T / dP^T chunk
  constexpr int NQ = QC / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int is_last;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);   // MT x P
  bf16* Vs = Ks + MT * P;                         // MT x P
  bf16* Qs = Vs + MT * P;                         // 2 stages of MT x P
  bf16* dOs = Qs + 2 * MT * P;                    // 2 stages of MT x P
  // 2 stages of (lse of MT rows, then their delta)
  float* stat_s = reinterpret_cast<float*>(dOs + 2 * MT * P);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int group = p.H / p.KV;
  const int kvh = h / group;
  const int k0 = blockIdx.y * MT;
  const long long* st = p.st;
  const bf16* qg = static_cast<const bf16*>(p.q) + b * st[SQ] + h * st[SQ + 2];
  const bf16* dog =
      static_cast<const bf16*>(p.dout) + b * st[SDO] + h * st[SDO + 2];
  const bf16* kg =
      static_cast<const bf16*>(p.k) + b * st[SK] + kvh * st[SK + 2];
  const bf16* vg =
      static_cast<const bf16*>(p.v) + b * st[SV] + kvh * st[SV + 2];
  const long long row_base = (long long)bh * p.S;

  // the query rows that can see a key of this tile: causal -> positions at
  // or after the first key; window -> before the last key + window
  const int k_last = min(k0 + MT, p.T) - 1;
  int i_begin = 0, i_end = p.S;
  if (p.causal) i_begin = max(0, k0 - p.q_offset);
  if (p.window > 0) i_end = min(i_end, k_last + p.window - p.q_offset);
  i_begin = (i_begin / MT) * MT;
  const int n_tiles = i_end > i_begin ? (i_end - i_begin + MT - 1) / MT : 0;

  // thread tid < MT loads the lse of row i0 + tid, the others the delta
  // of row i0 + tid - MT: stage entry tid
  auto stat_at = [&](int i0) -> float {
    const int i = i0 + (tid & (MT - 1));
    if (tid < MT) return lse_or_inf(p, row_base, i);
    return i < p.S ? p.delta[row_base + i] : 0.f;
  };

  cp_rows<D, MT, KV_NT>(Ks, kg, st[SK + 1], k0, p.T);
  cp_rows<D, MT, KV_NT>(Vs, vg, st[SV + 1], k0, p.T);
  if (n_tiles > 0) {
    cp_rows<D, MT, KV_NT>(Qs, qg, st[SQ + 1], i_begin, p.S);
    cp_rows<D, MT, KV_NT>(dOs, dog, st[SDO + 1], i_begin, p.S);
    stat_s[tid] = stat_at(i_begin);
  }
  cp_async_commit();

  const int wrow = warp * 16;
  const int wk0 = k0 + wrow;           // the warp's keys wk0 .. wk0 + 15
  uint32_t kf[PIN ? KSTEPS : 1][4], vf[PIN ? KSTEPS : 1][4];
  float dk[NTO][4], dv[NTO][4];
#pragma unroll
  for (int n = 0; n < NTO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int i0 = i_begin + j * MT;
    const int s_ = j & 1;
    float next = 0.f;
    if (j + 1 < n_tiles) {
      cp_rows<D, MT, KV_NT>(Qs + (s_ ^ 1) * MT * P, qg, st[SQ + 1], i0 + MT,
                            p.S);
      cp_rows<D, MT, KV_NT>(dOs + (s_ ^ 1) * MT * P, dog, st[SDO + 1],
                            i0 + MT, p.S);
      next = stat_at(i0 + MT);         // stored after this tile's work
    }
    cp_async_commit();
    cp_async_wait<1>();                // tile j (and K, V) have landed
    __syncthreads();
    if constexpr (PIN) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          ldsm_x4(kf[kk], a_addr<P>(Ks, wrow, kk, lane));
          ldsm_x4(vf[kk], a_addr<P>(Vs, wrow, kk, lane));
        }
      }
    }
    // a tile in which no query sees any of this warp's keys changes nothing
    const bool skip =
        wk0 >= p.T || (p.causal && i0 + MT - 1 + p.q_offset < wk0) ||
        (p.window > 0 && i0 + p.q_offset >= wk0 + 15 + p.window);
    if (!skip) {
      const bf16* Qt = Qs + s_ * MT * P;
      const bf16* dOt = dOs + s_ * MT * P;
      const float* ls = stat_s + s_ * 2 * MT;
      const float* dls = ls + MT;
      // rows past S read lse +inf (P = 0); keys past T are never written
      const bool need_mask =
          (p.causal && wk0 + 15 > i0 + p.q_offset) ||
          (p.window > 0 && wk0 <= i0 + MT - 1 + p.q_offset - p.window);
#pragma unroll
      for (int c0 = 0; c0 < MT; c0 += QC) {
        float s[NQ][4], dp[NQ][4];
#pragma unroll
        for (int n = 0; n < NQ; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          uint32_t ak[4], av[4];
          if constexpr (PIN) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              ak[e] = kf[PIN ? kk : 0][e];
              av[e] = vf[PIN ? kk : 0][e];
            }
          } else {
            ldsm_x4(ak, a_addr<P>(Ks, wrow, kk, lane));
            ldsm_x4(av, a_addr<P>(Vs, wrow, kk, lane));
          }
#pragma unroll
          for (int np = 0; np < NQ / 2; ++np) {   // 16 queries
            uint32_t bq[4], bo[4];
            ldsm_x4(bq, b_addr<P>(Qt, c0 + np * 16, kk, lane));
            mma_bf16(s[2 * np], ak, bq[0], bq[1]);
            mma_bf16(s[2 * np + 1], ak, bq[2], bq[3]);
            ldsm_x4(bo, b_addr<P>(dOt, c0 + np * 16, kk, lane));
            mma_bf16(dp[2 * np], av, bo[0], bo[1]);
            mma_bf16(dp[2 * np + 1], av, bo[2], bo[3]);
          }
        }
        // P^T and dS^T: element e of tile n is key wk0 + g (+8 for e >= 2)
        // and query c0 + 8 n + 2 t (+1 for odd e) of the stage
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          const int qi = c0 + n * 8 + 2 * t;
          const float2 l2 = *reinterpret_cast<const float2*>(ls + qi);
          const float2 d2 = *reinterpret_cast<const float2*>(dls + qi);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float pr = expf(s[n][e] * p.scale - ((e & 1) ? l2.y : l2.x));
            if (need_mask) {
              const int kpos = wk0 + g + (e < 2 ? 0 : 8);
              const int qpos = i0 + qi + (e & 1) + p.q_offset;
              if (!sees(p, qpos, kpos)) pr = 0.f;
            }
            dp[n][e] = pr * (dp[n][e] - ((e & 1) ? d2.y : d2.x));   // dS^T
            s[n][e] = pr;                                           // P^T
          }
        }
        // dV += P^T dO, dK += dS^T Q over the chunk's queries
#pragma unroll
        for (int kk = 0; kk < QC / 16; ++kk) {
          uint32_t pa[4], da[4];
          pack_a(pa, s[2 * kk], s[2 * kk + 1]);
          pack_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
          for (int np = 0; np < NTO / 2; ++np) {   // 16 columns
            uint32_t bo[4], bq[4];
            ldsm_x4_trans(bo, bt_addr<P>(dOt, c0 + kk * 16, np, lane));
            mma_bf16(dv[2 * np], pa, bo[0], bo[1]);
            mma_bf16(dv[2 * np + 1], pa, bo[2], bo[3]);
            ldsm_x4_trans(bq, bt_addr<P>(Qt, c0 + kk * 16, np, lane));
            mma_bf16(dk[2 * np], da, bq[0], bq[1]);
            mma_bf16(dk[2 * np + 1], da, bq[2], bq[3]);
          }
        }
      }
    }
    if (j + 1 < n_tiles) stat_s[(s_ ^ 1) * 2 * MT + tid] = next;
    __syncthreads();                   // stage s_ is refilled in j + 1
  }
  cp_async_wait<0>();
  __syncthreads();   // with no tile, other threads' K/V copies land here

  bf16* dkg = static_cast<bf16*>(p.dk) + b * st[SDK] + kvh * st[SDK + 2];
  bf16* dvg = static_cast<bf16*>(p.dv) + b * st[SDV] + kvh * st[SDV + 2];
  if (group == 1) {
    // the warp's own rows of the K and V tiles stage the result
    store_rows<D>(dk, p.scale, Ks, wrow, dkg, st[SDK + 1], k0, p.T, lane);
    store_rows<D>(dv, 1.f, Vs, wrow, dvg, st[SDV + 1], k0, p.T, lane);
    return;
  }
  // this head's partials, unscaled fp32, rows (b, key, h) of the scratch
  const long long hd = (long long)p.H * D;
  const long long part0 = ((long long)b * p.T * p.H + h) * D;
#pragma unroll
  for (int n = 0; n < NTO; ++n) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = wk0 + g + 8 * half;
      if (key < p.T) {
        const long long at = part0 + key * hd + n * 8 + 2 * t;
        *reinterpret_cast<float2*>(p.dk_part + at) =
            make_float2(dk[n][2 * half], dk[n][2 * half + 1]);
        *reinterpret_cast<float2*>(p.dv_part + at) =
            make_float2(dv[n][2 * half], dv[n][2 * half + 1]);
      }
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0)
    is_last = atomicAdd(p.arrivals + ((long long)b * p.KV + kvh) * gridDim.y +
                            blockIdx.y, 1) == group - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // the last block of (b, KV head, key tile): the group's sum, head order
  const long long first = ((long long)b * p.T * p.H + kvh * group) * D;
  for (int i = tid; i < MT * (D / 4); i += KV_NT) {
    const int r = i / (D / 4), c = (i - r * (D / 4)) * 4;
    const int key = k0 + r;
    if (key >= p.T) continue;
    const long long at = first + key * hd + c;
    float4 sk = __ldcg(reinterpret_cast<const float4*>(p.dk_part + at));
    float4 sv = __ldcg(reinterpret_cast<const float4*>(p.dv_part + at));
    for (int hh = 1; hh < group; ++hh) {
      const float4 ak =
          __ldcg(reinterpret_cast<const float4*>(p.dk_part + at + hh * D));
      const float4 av =
          __ldcg(reinterpret_cast<const float4*>(p.dv_part + at + hh * D));
      sk.x += ak.x; sk.y += ak.y; sk.z += ak.z; sk.w += ak.w;
      sv.x += av.x; sv.y += av.y; sv.z += av.z; sv.w += av.w;
    }
    __nv_bfloat162 ok[2] = {
        __floats2bfloat162_rn(sk.x * p.scale, sk.y * p.scale),
        __floats2bfloat162_rn(sk.z * p.scale, sk.w * p.scale)};
    __nv_bfloat162 ov[2] = {__floats2bfloat162_rn(sv.x, sv.y),
                            __floats2bfloat162_rn(sv.z, sv.w)};
    *reinterpret_cast<uint2*>(dkg + key * st[SDK + 1] + c) =
        *reinterpret_cast<const uint2*>(ok);
    *reinterpret_cast<uint2*>(dvg + key * st[SDV + 1] + c) =
        *reinterpret_cast<const uint2*>(ov);
  }
}

// the kernels the last call ran (chip_smoke.py prints it)
const char* g_last_kernel = "none";

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream, const char* name) {
  static std::atomic<unsigned long long> done_dq{0}, done_dkdv{0};
  const size_t smem_dq = dq_smem_bytes<D>();
  const size_t smem_dkdv = dkdv_smem_bytes<D>();
  cudaError_t err = allow_smem(fa_bwd_dq<T, D>, smem_dq, done_dq);
  if (err != cudaSuccess) return err;
  err = allow_smem(fa_bwd_dkdv<T, D>, smem_dkdv, done_dkdv);
  if (err != cudaSuccess) return err;
  fa_bwd_dq<T, D><<<dim3(p.B * p.H, (p.S + BO - 1) / BO), NT, smem_dq,
                    stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fa_bwd_dkdv<T, D><<<dim3(p.B * p.KV, (p.T + BO - 1) / BO), NT, smem_dkdv,
                      stream>>>(p);
  err = cudaGetLastError();
  if (err == cudaSuccess) g_last_kernel = name;
  return err;
}

template <int D>
cudaError_t launch_mma(const Params& p, cudaStream_t stream,
                       const char* name) {
  static std::atomic<unsigned long long> done_dq{0}, done_dkdv{0};
  const size_t smem_dq = dq_mma_smem_bytes<D>();
  const size_t smem_dkdv = dkdv_mma_smem_bytes<D>();
  cudaError_t err = allow_smem(fa_bwd_dq_mma<D>, smem_dq, done_dq);
  if (err != cudaSuccess) return err;
  err = allow_smem(fa_bwd_dkdv_mma<D>, smem_dkdv, done_dkdv);
  if (err != cudaSuccess) return err;
  fa_bwd_dq_mma<D><<<dim3(p.B * p.H, (p.S + DQ_ROWS - 1) / DQ_ROWS), DQ_NT,
                     smem_dq, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fa_bwd_dkdv_mma<D><<<dim3(p.B * p.H, (p.T + MT - 1) / MT), KV_NT,
                       smem_dkdv, stream>>>(p);
  err = cudaGetLastError();
  if (err == cudaSuccess) g_last_kernel = name;
  return err;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for q, k, v, o, dout, dq, dk, dv alike.
// `strides` holds NSTRIDES element strides, (B, row, head) of each tensor
// in the order q, k, v, o, dout, dq, dk, dv (last dims contiguous; for
// bf16 on the tensor cores every row starts on 16 bytes). lse and delta
// are contiguous fp32 (B, H, S). bf16 with simt == 0 runs fa_bwd_dq_mma
// then fa_bwd_dkdv_mma and, when H > KV, takes dk_part and dv_part (fp32
// (B, T, H, D) each, 16-byte aligned) and arrivals (B * KV * ceil(T / 64)
// ints, any contents); every other call runs fa_bwd_dq then fa_bwd_dkdv
// and reads none of the three. Launches on `stream`; returns the
// cudaError_t of the launches (0 = success).
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, float* dk_part,
    float* dv_part, int* arrivals, void* dq, void* dk, void* dv,
    const long long* strides, int B, int S, int T, int H, int KV, int D,
    int dtype, int causal, int window, int q_offset, float scale, int simt,
    void* stream) {
  Params p{q, k, v, o, dout, lse, delta, dk_part, dv_part, arrivals, dq, dk,
           dv, {}, B, S, T, H, KV, causal, window, q_offset, scale, 0};
  for (int i = 0; i < NSTRIDES; ++i) p.st[i] = strides[i];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (D) {
      case 64: return (int)launch<float, 64>(p, st, "fa_bwd<f32,64>");
      case 80: return (int)launch<float, 80>(p, st, "fa_bwd<f32,80>");
      case 128: return (int)launch<float, 128>(p, st, "fa_bwd<f32,128>");
    }
  } else if (dtype == 1 && simt) {
    switch (D) {
      case 64:
        return (int)launch<__nv_bfloat16, 64>(p, st, "fa_bwd<bf16,64>");
      case 80:
        return (int)launch<__nv_bfloat16, 80>(p, st, "fa_bwd<bf16,80>");
      case 128:
        return (int)launch<__nv_bfloat16, 128>(p, st, "fa_bwd<bf16,128>");
    }
  } else if (dtype == 1) {
    if (H > KV) {
      if (dk_part == nullptr || dv_part == nullptr || arrivals == nullptr)
        return (int)cudaErrorInvalidValue;
      p.n_arrivals = B * KV * ((T + MT - 1) / MT);
    }
    switch (D) {
      case 64: return (int)launch_mma<64>(p, st, "fa_bwd_mma<bf16,64>");
      case 80: return (int)launch_mma<80>(p, st, "fa_bwd_mma<bf16,80>");
      case 128: return (int)launch_mma<128>(p, st, "fa_bwd_mma<bf16,128>");
    }
  }
  return (int)cudaErrorInvalidValue;
}

// The name of the kernels the last successful call ran.
extern "C" const char* repro_flash_attention_bwd_last_kernel() {
  return g_last_kernel;
}
