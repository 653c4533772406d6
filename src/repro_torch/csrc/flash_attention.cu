// Flash attention forward for Hopper (sm_90a), GQA, causal / sliding
// window / q_offset / key padding, fully masked rows -> 0.
//
// Replaces the Pallas TPU kernel repro/kernels/attention.py::flash_attention
// (_fa_kernel). Computes what it computes, not a block-by-block copy: the
// TPU's sequential innermost grid axis over k blocks (with m, l and the
// accumulator carried in VMEM scratch) becomes a loop over k-tiles inside
// one thread block, which keeps the running max, sum and accumulator in
// registers.
//
// Layout: q (B, S, H, D), k/v (B, T, KV, D), o (B, S, H, D), read in place
// through their strides (last dim contiguous); no transposed copies.
// Grid: x = b*H + h, y = 64-row query tile; 128 threads (4 warps) a block.
// Two kernels, chosen by dtype:
//
// * fa_fwd_mma<D>, bf16, on the tensor cores. Each warp owns 16 query
//   rows; Q's fragments are loaded once with ldmatrix and stay in
//   registers. K/V tiles of 64 keys stay bf16 in shared memory, brought in
//   by 16-byte cp.async copies in two stages (tile j+1 loads while tile j
//   computes), rows padded by 16 bytes so that ldmatrix hits distinct
//   banks. QK^T and PV are mma.sync m16n8k16 (bf16 in, fp32 accumulate);
//   the online softmax runs on the accumulator fragments in registers
//   (row reductions are shuffles among the 4 lanes that share a row), and
//   P, rounded to bf16, is the A operand of the PV product as it stands:
//   the m16n8k16 accumulator layout is its A layout, so P never touches
//   shared memory. V is read with ldmatrix.trans. The output is staged
//   through the warp's own rows of the Q tile and written in 16-byte rows.
//   Takes 16-byte-aligned rows only (the wrapper checks).
// * fa_fwd<D>, fp32, scalar FMAs from shared memory (the first
//   port's kernel, unchanged): thread t owns query rows 4*(t/8)..+3, score
//   columns (t%8) + 8j of each 64-key tile and output columns (t%8) + 8c.
//   The port holds fp32 attention at 2e-5, which TF32 would not meet.
//
// Bound on the card: at the serving shape (B=8, S=512, H=9, KV=3, D=64,
// bf16, causal) the kernel must move ~12.6 MB (q, k, v read once, o
// written once) and do ~2.4 GFLOP, i.e. ~3.8 us at 3.35 TB/s: memory
// bound. Each K/V tile is read from device memory once per 64 query rows
// and reused from shared memory, tiles entirely in the future (causal) or
// before the window are skipped (and, inside a block, a warp skips a tile
// that its 16 rows cannot see), mask arithmetic runs only on tiles that
// cross the diagonal, the window edge or T, and scores and probabilities
// never leave the SM. wgmma/TMA (warp-specialised) is later work.
//
// With a non-null `lse` (training), each kernel also writes the row
// log-sum-exp m + log(l) of the scaled scores, fp32 (B, H, S), for the
// backward (flash_attention_bwd.cu); a fully masked row writes -inf. A null
// `lse` (serving) writes nothing more.
//
// Numerics follow the reference: masked scores are -1e30 (the bf16 kernel
// writes -inf, which gives the same running max and p), p = 0 where
// masked, fp32 running max / sum / accumulator, expf (no fast math),
// output cast with round-to-nearest. The fp32 kernel scales q before the
// product; the bf16 kernel multiplies the fp32 scores by the scale after
// it (q stays bf16 for the tensor cores) and rounds p to bf16 for PV
// (l sums the fp32 p).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

#include "sm90_common.cuh"

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per k-tile
constexpr int NT = 128;      // threads per block
constexpr float NEG = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;             // (B, H, S) row log-sum-exp, or null
  long long qb, qs, qh;   // element strides of q over (B, S, H)
  long long kb, kt, kh;   // k over (B, T, KV)
  long long vb, vt, vh;   // v over (B, T, KV)
  long long ob, os, oh;   // o over (B, S, H)
  int B, S, T, H, KV;
  int causal, window, q_offset;
  float scale;
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <int D>
__global__ void __launch_bounds__(NT) fa_fwd(const Params p) {
  constexpr int DP = D + 1;   // padded row stride: the 8 key rows a warp reads hit 8 banks
  constexpr int PP = BK + 1;
  constexpr int CPT = D / 8;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;            // BQ x DP, pre-scaled fp32 q tile
  float* Ks = Qs + BQ * DP;    // BK x DP
  float* Vs = Ks + BK * DP;    // BK x D
  float* Ps = Vs + BK * D;     // BQ x PP, probabilities of the current tile

  const int tid = threadIdx.x;
  const int r = tid >> 3;      // row group: tile rows 4r .. 4r+3
  const int c = tid & 7;       // column group
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int kvh = h / (p.H / p.KV);
  const int q0 = blockIdx.y * BQ;          // first query row of the tile

  const float* qg = static_cast<const float*>(p.q) + b * p.qb + h * p.qh;
  const float* kg = static_cast<const float*>(p.k) + b * p.kb + kvh * p.kh;
  const float* vg = static_cast<const float*>(p.v) + b * p.vb + kvh * p.vh;
  float* og = static_cast<float*>(p.o) + b * p.ob + h * p.oh;

  for (int i = tid; i < BQ * D; i += NT) {
    const int row = i / D, d = i - (i / D) * D;
    const int s = q0 + row;
    Qs[row * DP + d] = s < p.S ? qg[s * p.qs + d] * p.scale : 0.f;
  }

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) acc[i][cc] = 0.f;
  }

  // k-tiles that can hold a visible key for some row of this tile:
  // causal -> keys <= the last row's position; window -> keys after the
  // first row's position - window. Whole tiles outside are skipped.
  const int first_pos = q0 + p.q_offset;
  const int last_pos = min(q0 + BQ, p.S) - 1 + p.q_offset;
  int k_end = p.T;
  if (p.causal) k_end = min(k_end, last_pos + 1);
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, first_pos - p.window + 1);
  k_begin = (k_begin / BK) * BK;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // previous tile's K/V fully consumed (and Qs written)
    for (int i = tid; i < BK * D; i += NT) {
      const int row = i / D, d = i - (i / D) * D;
      const int t = k0 + row;
      const bool in = t < p.T;
      Ks[row * DP + d] = in ? kg[t * p.kt + d] : 0.f;
      Vs[row * D + d] = in ? vg[t * p.vt + d] : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(4 * r + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = Ks[(c + 8 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * r + i + p.q_offset;
      unsigned valid = 0;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + c + 8 * j;
        bool ok = kpos < p.T;
        if (p.causal) ok = ok && kpos <= qpos;
        if (p.window > 0) ok = ok && kpos > qpos - p.window;
        if (ok) valid |= 1u << j;
        s[i][j] = ok ? s[i][j] : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float pj = (valid >> j) & 1u ? expf(s[i][j] - m_new) : 0.f;
        Ps[(4 * r + i) * PP + c + 8 * j] = pj;
        rs += pj;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) acc[i][cc] *= alpha;
    }
    // a row's probabilities were written by the 8 lanes of its row group,
    // all in this warp
    __syncwarp();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(4 * r + i) * PP + j];
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const float vv = Vs[j * D + c + 8 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(pv[i], vv, acc[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * r + i;
    if (row >= p.S) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];   // fully masked rows -> 0
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc)
      og[row * p.os + c + 8 * cc] = acc[i][cc] / li;
    // m and l are the same in the 8 lanes of the row group
    if (p.lse != nullptr && c == 0)
      p.lse[(long long)bh * p.S + row] =
          l[i] == 0.f ? -INFINITY : m[i] + logf(l[i]);
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
constexpr int PAD = 8;   // bf16 elements (16 bytes) of padding per shared row

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * 5 * BQ * (D + PAD);   // Q + 2 x (K, V)
}

// Fragment layouts and the mma/ldmatrix/cp.async helpers: sm90_common.cuh.
template <int D>
__global__ void __launch_bounds__(NT) fa_fwd_mma(const Params p) {
  constexpr int P = D + PAD;   // shared row pitch, elements
  constexpr int CH = D / 8;    // 16-byte chunks per row
  constexpr int KSTEPS = D / 16;
  constexpr int NTO = D / 8;   // 8-column tiles of the output
  static_assert(D % 16 == 0 && (BQ * CH) % NT == 0, "whole ldmatrix tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * P;          // 2 stages of BK x P
  __nv_bfloat16* Vs = Ks + 2 * BK * P;      // 2 stages of BK x P

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3;                 // ldmatrix: matrix of this lane
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int kvh = h / (p.H / p.KV);
  // the last query tiles (the most k-tiles under a causal mask) first, so
  // the short ones fill the tail of the grid
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;

  const __nv_bfloat16* qg =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.qb + h * p.qh;
  const __nv_bfloat16* kg =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.kb + kvh * p.kh;
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.vb + kvh * p.vh;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.ob + h * p.oh;

  // rows [row0, row0 + 64) of src into dst; rows at or past limit are 0
  auto load_tile = [&](__nv_bfloat16* dst, const __nv_bfloat16* src,
                       long long stride, int row0, int limit) {
#pragma unroll
    for (int it = 0; it < BQ * CH / NT; ++it) {
      const int i = tid + it * NT;
      const int r = i / CH, c = i - (i / CH) * CH;
      const bool in = row0 + r < limit;
      const __nv_bfloat16* from = in ? src + (row0 + r) * stride + c * 8 : src;
      cp_async16(smem_u32(dst + r * P + c * 8), from, in);
    }
  };

  const int first_pos = q0 + p.q_offset;
  const int last_pos = min(q0 + BQ, p.S) - 1 + p.q_offset;
  int k_end = p.T;
  if (p.causal) k_end = min(k_end, last_pos + 1);
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, first_pos - p.window + 1);
  k_begin = (k_begin / BK) * BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  load_tile(Qs, qg, p.qs, q0, p.S);
  if (n_tiles > 0) {
    load_tile(Ks, kg, p.kt, k_begin, p.T);
    load_tile(Vs, vg, p.vt, k_begin, p.T);
  }
  cp_async_commit();

  // this warp's rows: tile rows 16*warp .. +15; this thread's two rows
  const int wrow = warp * 16;
  const int w_first = q0 + wrow + p.q_offset;    // positions of the warp's
  const int w_last = w_first + 15;               // first and last rows
  const int qpos0 = w_first + g, qpos1 = qpos0 + 8;
  const bool warp_live = q0 + wrow < p.S;

  uint32_t qf[KSTEPS][4];
  float o[NTO][4];
#pragma unroll
  for (int n = 0; n < NTO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = k_begin + j * BK;
    const int st = j & 1;
    if (j + 1 < n_tiles) {
      load_tile(Ks + (st ^ 1) * BK * P, kg, p.kt, k0 + BK, p.T);
      load_tile(Vs + (st ^ 1) * BK * P, vg, p.vt, k0 + BK, p.T);
    }
    cp_async_commit();
    cp_async_wait<1>();        // tile j (and Q) have landed
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        ldsm_x4(qf[kk], smem_u32(Qs + (wrow + (lane & 7) + (mi & 1) * 8) * P
                                 + kk * 16 + (mi >> 1) * 8));
    }
    // a tile that none of this warp's rows can see changes nothing
    const bool skip = !warp_live || (p.causal && k0 > w_last) ||
                      (p.window > 0 && k0 + BK - 1 <= w_first - p.window);
    if (!skip) {
      const __nv_bfloat16* Kt = Ks + st * BK * P;
      const __nv_bfloat16* Vt = Vs + st * BK * P;
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
        for (int np = 0; np < 4; ++np) {       // 16 keys: two n-tiles
          uint32_t bk[4];
          ldsm_x4(bk, smem_u32(Kt + (np * 16 + (lane & 7) + (mi >> 1) * 8) * P
                               + kk * 16 + (mi & 1) * 8));
          mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
        }
      }
      // scale, then mask only where the tile crosses T, the diagonal or
      // the window edge for some row of this warp. A masked score is -inf
      // here: the tile's max starts at -1e30 as the running max does, so
      // m is the reference's (which masks with -1e30), and expf(-inf - m)
      // is the reference's p = 0 exactly, with no per-element test
      const bool need_mask = k0 + BK > p.T ||
                             (p.causal && k0 + BK - 1 > w_first) ||
                             (p.window > 0 && k0 <= w_last - p.window);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= p.scale;
      if (need_mask) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + n * 8 + 2 * t + (e & 1);
            const int qpos = e < 2 ? qpos0 : qpos1;
            bool ok = kpos < p.T;
            if (p.causal) ok = ok && kpos <= qpos;
            if (p.window > 0) ok = ok && kpos > qpos - p.window;
            if (!ok) s[n][e] = -INFINITY;
          }
      }
      float mx0 = NEG, mx1 = NEG;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
      }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = expf(s[n][e] - (e < 2 ? mn0 : mn1));
          s[n][e] = pe;
          if (e < 2) rs0 += pe; else rs1 += pe;
        }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        rs0 += __shfl_xor_sync(0xffffffffu, rs0, x);
        rs1 += __shfl_xor_sync(0xffffffffu, rs1, x);
      }
      l0 = l0 * a0 + rs0;
      l1 = l1 * a1 + rs1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int n = 0; n < NTO; ++n) {
        o[n][0] *= a0; o[n][1] *= a0;
        o[n][2] *= a1; o[n][3] *= a1;
      }
      // O += P V: keys 16kk..16kk+15 are the accumulator tiles 2kk, 2kk+1
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t pa[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int np = 0; np < NTO / 2; ++np) {  // 16 output columns
          uint32_t bv[4];
          ldsm_x4_trans(bv, smem_u32(Vt + (kk * 16 + (lane & 7) + (mi & 1) * 8)
                                     * P + np * 16 + (mi >> 1) * 8));
          mma_bf16(o[2 * np], pa, bv[0], bv[1]);
          mma_bf16(o[2 * np + 1], pa, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();           // stage st is refilled in iteration j + 1
  }

  // epilogue: O / l (fully masked rows -> 0) through this warp's rows of
  // the Q tile, then 16-byte rows to global
  cp_async_wait<0>();
  __syncthreads();
  const float li0 = l0 == 0.f ? 1.f : l0, li1 = l1 == 0.f ? 1.f : l1;
  // m and l are the same in the 4 lanes that share a row
  if (p.lse != nullptr && t == 0) {
    const int row0 = q0 + wrow + g;
    float* lrow = p.lse + (long long)bh * p.S;
    if (row0 < p.S) lrow[row0] = l0 == 0.f ? -INFINITY : m0 + logf(l0);
    if (row0 + 8 < p.S)
      lrow[row0 + 8] = l1 == 0.f ? -INFINITY : m1 + logf(l1);
  }
#pragma unroll
  for (int n = 0; n < NTO; ++n) {
    __nv_bfloat16* r0 = Qs + (wrow + g) * P + n * 8 + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(r0) =
        __floats2bfloat162_rn(o[n][0] / li0, o[n][1] / li0);
    *reinterpret_cast<__nv_bfloat162*>(r0 + 8 * P) =
        __floats2bfloat162_rn(o[n][2] / li1, o[n][3] / li1);
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < CH / 2; ++it) {
    const int i = lane + it * 32;
    const int r = i / CH, c = i - (i / CH) * CH;
    const int row = q0 + wrow + r;
    if (row < p.S)
      *reinterpret_cast<uint4*>(og + row * p.os + c * 8) =
          *reinterpret_cast<const uint4*>(Qs + (wrow + r) * P + c * 8);
  }
}

// the kernel a launch ran last (chip_smoke.py prints it)
const char* g_last_kernel = "none";

template <int D>
cudaError_t launch_mma(const Params& p, cudaStream_t stream) {
  static std::atomic<unsigned long long> done{0};
  const size_t smem = mma_smem_bytes<D>();
  cudaError_t err = allow_smem(fa_fwd_mma<D>, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.H, (p.S + BQ - 1) / BQ);
  fa_fwd_mma<D><<<grid, NT, smem, stream>>>(p);
  const char* name = D == 64   ? "fa_fwd_mma<bf16,64>"
                     : D == 80 ? "fa_fwd_mma<bf16,80>"
                               : "fa_fwd_mma<bf16,128>";
  err = cudaGetLastError();
  if (err == cudaSuccess) g_last_kernel = name;
  return err;
}

template <int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  static std::atomic<unsigned long long> done{0};
  const size_t smem = smem_bytes<D>();
  cudaError_t err = allow_smem(fa_fwd<D>, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.H, (p.S + BQ - 1) / BQ);
  fa_fwd<D><<<grid, NT, smem, stream>>>(p);
  const char* name = D == 64   ? "fa_fwd<f32,64>"
                     : D == 80 ? "fa_fwd<f32,80>"
                               : "fa_fwd<f32,128>";
  err = cudaGetLastError();
  if (err == cudaSuccess) g_last_kernel = name;
  return err;
}

}  // namespace

// dtype: 0 = float32 (fa_fwd, SIMT), 1 = bfloat16 (fa_fwd_mma, tensor
// cores; 16-byte-aligned rows). Strides are in elements. `lse` is null or
// a contiguous fp32 (B, H, S) buffer. Returns the cudaError_t of the
// launch (0 = success).
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse,
    long long qb, long long qs, long long qh,
    long long kb, long long kt, long long kh,
    long long vb, long long vt, long long vh,
    long long ob, long long os, long long oh,
    int B, int S, int T, int H, int KV, int D, int dtype,
    int causal, int window, int q_offset, float scale, void* stream) {
  Params p{q, k, v, o, lse, qb, qs, qh, kb, kt, kh, vb, vt, vh, ob, os, oh,
           B, S, T, H, KV, causal, window, q_offset, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (D) {
      case 64: return (int)launch<64>(p, st);
      case 80: return (int)launch<80>(p, st);
      case 128: return (int)launch<128>(p, st);
    }
  } else if (dtype == 1) {
    switch (D) {
      case 64: return (int)launch_mma<64>(p, st);
      case 80: return (int)launch_mma<80>(p, st);
      case 128: return (int)launch_mma<128>(p, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// The name of the kernel the last successful launch ran.
extern "C" const char* repro_flash_attention_last_kernel() {
  return g_last_kernel;
}
