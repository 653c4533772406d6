// Mamba2 SSD within-chunk pass for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py::ssd_chunked_pallas
// (_ssd_chunk_kernel) and computes its three outputs, per (batch, head,
// chunk) of Q <= 128 steps:
//   cum[t]      = sum_{r<=t} dt_r A                        (B, H, nc, Q)
//   y_intra[t]  = sum_{s<=t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s
//                                                          (B, H, nc, Q, P)
//   state       = sum_s exp(cum_{Q-1} - cum_s) dt_s B_s x_s^T
//                                                          (B, H, nc, N, P)
// all fp32. The inter-chunk recurrence, y_inter and the D*x skip stay
// outside, in plain PyTorch, as the reference keeps them outside.
//
// Layout: x (B, S, H, P), dt (B, S, H) fp32, B/C (B, S, N), read in place
// through their strides (last dim of x, B and C contiguous): the model's
// x, B and C are column slices of one conv output, so the reference's
// moveaxis/reshape copies never happen. Q need not be a power of two
// (a 100-token prompt gives Q = 100); rows past Q are zero-filled.
//
// Two kernels, chosen by dtype, one block per (b, h, chunk), grid B*H*nc:
//
// * ssd_chunk_mma<P>, bf16 x, B and C, on the tensor cores (mma.sync
//   m16n8k16, bf16 in, fp32 accumulate), 256 threads. The x, B and C
//   tiles come in by 16-byte cp.async copies (rows past Q and state dims
//   past N zero-filled, each padded to a multiple of 16). Warp w owns
//   chunk rows 16w..16w+15: it forms G = C B^T for the columns s <= its
//   rows (C by ldmatrix as the A operand, B rows as the B operand, as Q
//   and K in fa_fwd_mma) while one thread of warp 0 runs the sequential
//   cumsum; then the masked, decayed scores
//   G * exp(cum_t - cum_s) * dt_s (s <= t < Q) in fp32 on the
//   accumulator fragments, rounded to bf16, become the A operand of
//   scores x (x by ldmatrix.trans, as V in fa_fwd_mma) without leaving
//   registers. The state product takes w_s B_s, rounded to bf16 and
//   written over the C tile, as A through ldmatrix.trans (warp w owns
//   state rows 16w..16w+15), against the same x fragments. y_intra and
//   the state are staged per warp through shared memory and written in
//   16-byte rows. Takes 16-byte-aligned rows and N <= 128 (the wrapper
//   checks).
// * ssd_chunk<P>, fp32, scalar FMAs from shared memory (the first port's
//   kernel): 256 threads; the fp32 x tile (128 x P), the Q x Q score
//   tile, and B and C staged in slices of 32 state dims (~131 KB at
//   P = 64). For each slice the block accumulates C B^T into per-thread
//   8x8 register tiles and writes that slice's 32 rows of the chunk
//   state; then it applies mask, decay and dt to the scores and
//   multiplies by x. It keeps the fp32 engine at 5e-5 of the plain
//   version, which TF32 or bf16 products would not.
//
// Bound on the card: at the serving shape (B=8, S=512, H=24, P=64, N=128,
// Q=128, bf16) the call must move ~65.8 MB, of which the two fp32 outputs
// are 25.2 MB each, and needs ~2.5 GFLOP (lower triangles only, C B^T once
// per batch and chunk): ~20 us at 3.35 TB/s, memory bound. What the
// design does about the bound: every input element is read from device
// memory once per block (B and C are shared by the heads of a batch and
// chunk, and come again from L2), the score tile never leaves the SM,
// each output is written once in whole 16-byte pieces, and on bf16 the
// three products run on the tensor cores, so the SM's time goes to
// loads and stores. C B^T is recomputed by every head's block (~4
// MFLOP a chunk on the tensor cores) rather than shared, so that a
// single request's call (B=1, 24-96 blocks) still spreads over the SMs.
//
// Numerics follow the reference: fp32 accumulation, masked scores are 0
// (exp of -1e30), expf (no fast math). The within-chunk cumsum is
// sequential (one thread, ~Q dependent adds), in the order of the plain
// versions' cumsum: with the model's step sizes cum reaches -1e3 within a
// chunk, so exp(cum_t - cum_s) amplifies any difference in its rounding.
// The bf16 kernel rounds the scores and w_s B_s to bf16 for the tensor
// cores (~2^-9 relative per element; the plain version keeps them fp32).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libssd_chunk.so ssd_chunk.cu
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

#include "sm90_common.cuh"

namespace {

constexpr int QT = 128;      // chunk rows a block covers (Q <= QT)
constexpr int NS = 32;       // fp32 kernel: state dims per staged slice of B and C
constexpr int NT = 256;      // threads per block
constexpr int QP = QT + 1;   // fp32 kernel: padded row stride of the score tile
constexpr int NSP = NS + 1;  // fp32 kernel: padded row stride of the B/C slices
constexpr int NMAX = 128;    // bf16 kernel: state dims it takes
constexpr int PAD = 8;       // bf16 kernel: elements (16 bytes) of row padding

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  float* y;
  float* st;
  float* cum;
  long long xb, xs, xh;   // element strides of x over (B, S, H)
  long long db, ds, dh;   // dt over (B, S, H)
  long long bb, bs;       // B over (B, S)
  long long cb, cs;       // C over (B, S)
  int H, N, Q, nc;
};

// cum = inclusive cumsum of dt*A, sequential in fp32 with the product
// rounded first (no FMA contraction): the order of a sequential
// torch.cumsum, so cum_t - cum_s, whose cancellation dominates the error
// when cum is large, matches the plain versions bit for bit.
__device__ __forceinline__ void chunk_cumsum(const float* dts, float A, int Q,
                                             float* cums) {
  float run = 0.f;
#pragma unroll 8
  for (int i = 0; i < Q; ++i) {
    run = __fadd_rn(run, __fmul_rn(dts[i], A));
    cums[i] = run;
  }
}

// ---------------------------------------------------------------------------
// fp32: scalar FMAs
// ---------------------------------------------------------------------------
template <int P>
constexpr size_t smem_bytes() {
  return sizeof(float) * (QT * P + QT * QP + 2 * QT * NSP + 3 * QT);
}

template <int P>
__global__ void __launch_bounds__(NT) ssd_chunk(const Params p) {
  constexpr int PC = P / 32;   // state columns per thread: lane + 32 * pc
  constexpr int NK = NS / 8;   // state rows per thread and slice: wq + 8 * k
  constexpr int PJ = P / 16;   // y columns per thread: tx + 16 * j
  extern __shared__ float smem[];
  float* Xs = smem;              // QT x P, fp32 x tile
  float* Ss = Xs + QT * P;       // QT x QP, masked/decayed scores
  float* Cs = Ss + QT * QP;      // QT x NSP, C slice
  float* Bs = Cs + QT * NSP;     // QT x NSP, B slice
  float* dts = Bs + QT * NSP;    // QT
  float* cums = dts + QT;        // QT
  float* ws = cums + QT;         // QT, exp(total - cum_s) dt_s

  const int tid = threadIdx.x;
  const int c = blockIdx.x % p.nc;
  const int bh = blockIdx.x / p.nc;
  const int h = bh % p.H;
  const int b = bh / p.H;
  const int Q = p.Q;
  const long long s0 = (long long)c * Q;      // first step of the chunk

  const float* xg = static_cast<const float*>(p.x) + b * p.xb + s0 * p.xs + h * p.xh;
  const float* dg = p.dt + b * p.db + s0 * p.ds + h * p.dh;
  const float* bg = static_cast<const float*>(p.Bm) + b * p.bb + s0 * p.bs;
  const float* cg = static_cast<const float*>(p.Cm) + b * p.cb + s0 * p.cs;
  const long long row = (long long)bh * p.nc + c;   // index over (B, H, nc)
  float* yg = p.y + row * Q * P;
  float* sg = p.st + row * p.N * P;
  float* cumg = p.cum + row * Q;

  const float A = p.A[h];
  for (int i = tid; i < QT; i += NT) dts[i] = i < Q ? dg[i * p.ds] : 0.f;
  for (int i = tid; i < QT * P; i += NT) {
    const int t = i / P, col = i - (i / P) * P;
    Xs[i] = t < Q ? xg[t * p.xs + col] : 0.f;
  }
  __syncthreads();
  if (tid == 0) chunk_cumsum(dts, A, Q, cums);
  __syncthreads();
  const float total = cums[Q - 1];
  for (int i = tid; i < QT; i += NT) {
    ws[i] = i < Q ? expf(total - cums[i]) * dts[i] : 0.f;
    if (i < Q) cumg[i] = cums[i];
  }

  // scores: thread (ty, tx) owns rows t = ty + 16 i, columns s = tx + 16 j
  const int tx = tid & 15, ty = tid >> 4;
  // chunk state: warp wq owns rows n0 + wq + 8 k, lane owns columns
  const int lane = tid & 31, wq = tid >> 5;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int n0 = 0; n0 < p.N; n0 += NS) {
    __syncthreads();   // previous slice consumed; ws visible
    for (int i = tid; i < QT * NS; i += NT) {
      const int t = i / NS, col = i - (i / NS) * NS;
      const int n = n0 + col;
      const bool in = t < Q && n < p.N;
      Cs[t * NSP + col] = in ? cg[t * p.cs + n] : 0.f;
      Bs[t * NSP + col] = in ? bg[t * p.bs + n] : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int k = 0; k < NS; ++k) {
      float cv[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) cv[i] = Cs[(ty + 16 * i) * NSP + k];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = Bs[(tx + 16 * j) * NSP + k];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
    }

    float sacc[NK][PC];
#pragma unroll
    for (int k = 0; k < NK; ++k)
#pragma unroll
      for (int pc = 0; pc < PC; ++pc) sacc[k][pc] = 0.f;
    for (int s = 0; s < Q; ++s) {
      const float w = ws[s];
      float xv[PC];
#pragma unroll
      for (int pc = 0; pc < PC; ++pc) xv[pc] = Xs[s * P + lane + 32 * pc];
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        const float bw = Bs[s * NSP + wq + 8 * k] * w;
#pragma unroll
        for (int pc = 0; pc < PC; ++pc) sacc[k][pc] = fmaf(bw, xv[pc], sacc[k][pc]);
      }
    }
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      const int n = n0 + wq + 8 * k;
      if (n < p.N) {
#pragma unroll
        for (int pc = 0; pc < PC; ++pc) sg[n * P + lane + 32 * pc] = sacc[k][pc];
      }
    }
  }

  // scores[t, s] = (C_t . B_s) * exp(cum_t - cum_s) * dt_s for s <= t < Q
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int s = tx + 16 * j;
      float v = 0.f;
      if (s <= t && t < Q) v = acc[i][j] * expf(cums[t] - cums[s]) * dts[s];
      Ss[t * QP + s] = v;
    }
  }
  __syncthreads();

  // y_intra = scores @ x: thread (ty, tx) owns rows ty + 16 i, columns tx + 16 j
  float yacc[8][PJ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < PJ; ++j) yacc[i][j] = 0.f;
  for (int s = 0; s < Q; ++s) {
    float sv[8], xv[PJ];
#pragma unroll
    for (int i = 0; i < 8; ++i) sv[i] = Ss[(ty + 16 * i) * QP + s];
#pragma unroll
    for (int j = 0; j < PJ; ++j) xv[j] = Xs[s * P + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < PJ; ++j) yacc[i][j] = fmaf(sv[i], xv[j], yacc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = ty + 16 * i;
    if (t >= Q) continue;
#pragma unroll
    for (int j = 0; j < PJ; ++j) yg[t * P + tx + 16 * j] = yacc[i][j];
  }
}


// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

// Shared memory: the x tile (QP16 x (P+8)), the C tile (later w*B) and
// the B tile (QP16 x (NP16+8) each), all bf16, or, once the products are
// done, the per-warp fp32 output staging (16 x (P+8) a warp) over them;
// then dt, cum and w (QP16 fp32 each).
__host__ __device__ constexpr size_t mma_tile_bytes(int P, int qp, int np) {
  return sizeof(__nv_bfloat16) * ((size_t)qp * (P + PAD) + 2 * (size_t)qp * (np + PAD));
}
__host__ __device__ constexpr size_t mma_stage_bytes(int P, int qp, int np) {
  return sizeof(float) * (size_t)(qp > np ? qp : np) * (P + PAD);
}
__host__ __device__ constexpr size_t mma_smem_bytes(int P, int qp, int np) {
  return (mma_tile_bytes(P, qp, np) > mma_stage_bytes(P, qp, np)
              ? mma_tile_bytes(P, qp, np) : mma_stage_bytes(P, qp, np)) +
         3 * sizeof(float) * (size_t)qp;
}

// 16 rows x P fp32 of a warp's accumulator fragments, staged through its
// shared rows, to `dst` (row stride P) in 16-byte pieces; rows at or past
// `limit` are not written
template <int P>
__device__ __forceinline__ void store_rows(const float (&acc)[P / 8][4],
                                           float* stage, float* dst, int limit,
                                           int lane) {
  constexpr int FP = P + PAD;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < P / 8; ++n) {
    *reinterpret_cast<float2*>(stage + g * FP + n * 8 + 2 * t) =
        make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(stage + (g + 8) * FP + n * 8 + 2 * t) =
        make_float2(acc[n][2], acc[n][3]);
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < P / 8; ++it) {     // 16 rows x P/4 pieces, 32 lanes
    const int i = lane + 32 * it;
    const int r = i / (P / 4), c = i - r * (P / 4);
    if (r < limit)
      *reinterpret_cast<float4*>(dst + r * P + c * 4) =
          *reinterpret_cast<const float4*>(stage + r * FP + c * 4);
  }
  __syncwarp();
}

template <int P>
__global__ void __launch_bounds__(NT) ssd_chunk_mma(const Params p) {
  constexpr int XP = P + PAD;     // x tile row pitch, elements
  constexpr int XCH = P / 8;      // 16-byte pieces of an x row
  constexpr int NTP = P / 8;      // 8-column tiles of y and of the state
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Q = p.Q, N = p.N;
  const int qp = round16(Q), np16 = round16(N);
  const int CP = np16 + PAD;      // C / B tile row pitch, elements
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Cs = Xs + qp * XP;       // C, then w*B
  __nv_bfloat16* Bs = Cs + qp * CP;
  float* dts = reinterpret_cast<float*>(smem_raw + mma_smem_bytes(P, qp, np16)) - 3 * qp;
  float* cums = dts + qp;
  float* ws = cums + qp;
  float* stage_all = reinterpret_cast<float*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3, mi = lane >> 3;
  const int c = blockIdx.x % p.nc;
  const int bh = blockIdx.x / p.nc;
  const int h = bh % p.H;
  const int b = bh / p.H;
  const long long s0 = (long long)c * Q;

  const __nv_bfloat16* xg =
      static_cast<const __nv_bfloat16*>(p.x) + b * p.xb + s0 * p.xs + h * p.xh;
  const float* dg = p.dt + b * p.db + s0 * p.ds + h * p.dh;
  const __nv_bfloat16* bg = static_cast<const __nv_bfloat16*>(p.Bm) + b * p.bb + s0 * p.bs;
  const __nv_bfloat16* cg = static_cast<const __nv_bfloat16*>(p.Cm) + b * p.cb + s0 * p.cs;
  const long long row = (long long)bh * p.nc + c;   // index over (B, H, nc)

  // x, C and B tiles; rows past Q and state dims past N are zero
  for (int i = tid; i < qp * XCH; i += NT) {
    const int t = i / XCH, ch = i - t * XCH;
    const bool in = t < Q;
    cp_async16(smem_u32(Xs + t * XP + ch * 8), in ? xg + t * p.xs + ch * 8 : xg, in);
  }
  const int nch = np16 / 8;
  for (int i = tid; i < qp * nch; i += NT) {
    const int t = i / nch, ch = i - t * nch;
    const bool in = t < Q && ch * 8 < N;
    cp_async16(smem_u32(Cs + t * CP + ch * 8), in ? cg + t * p.cs + ch * 8 : cg, in);
    cp_async16(smem_u32(Bs + t * CP + ch * 8), in ? bg + t * p.bs + ch * 8 : bg, in);
  }
  cp_async_commit();
  for (int i = tid; i < qp; i += NT) dts[i] = i < Q ? dg[i * p.ds] : 0.f;
  cp_async_wait<0>();
  __syncthreads();

  // G = C B^T on this warp's rows t0..t0+15, columns s < t0 + 16, while
  // one thread runs the cumsum
  const int t0 = warp * 16;
  const bool rows_live = t0 < Q;
  if (tid == 0) chunk_cumsum(dts, p.A[h], Q, cums);
  __syncwarp();
  float gacc[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) gacc[n][e] = 0.f;
  if (rows_live) {
    for (int kk = 0; kk < np16 / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, smem_u32(Cs + (t0 + (lane & 7) + (mi & 1) * 8) * CP + kk * 16 +
                          (mi >> 1) * 8));
#pragma unroll
      for (int sb = 0; sb < 8; ++sb) {
        if (sb > warp) break;
        uint32_t bk[4];
        ldsm_x4(bk, smem_u32(Bs + (sb * 16 + (lane & 7) + (mi >> 1) * 8) * CP +
                             kk * 16 + (mi & 1) * 8));
        mma_bf16(gacc[2 * sb], a, bk[0], bk[1]);
        mma_bf16(gacc[2 * sb + 1], a, bk[2], bk[3]);
      }
    }
  }
  __syncthreads();   // cum ready; C consumed

  const float total = cums[Q - 1];
  float* cumg = p.cum + row * Q;
  for (int i = tid; i < qp; i += NT) {
    ws[i] = i < Q ? expf(total - cums[i]) * dts[i] : 0.f;
    if (i < Q) cumg[i] = cums[i];
  }
  // scores[t, s] = G * exp(cum_t - cum_s) * dt_s for s <= t < Q, else 0,
  // rounded to bf16 in the A layout of the scores x product
  uint32_t sa[8][4];
#pragma unroll
  for (int sb = 0; sb < 8; ++sb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sa[sb][e] = 0u;
    if (!rows_live || sb > warp) continue;
    float v[2][4];
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = t0 + g + (e >> 1) * 8;
        const int s = sb * 16 + half * 8 + 2 * t4 + (e & 1);
        v[half][e] = (s <= t && t < Q)
                         ? gacc[2 * sb + half][e] * expf(cums[t] - cums[s]) * dts[s]
                         : 0.f;
      }
    sa[sb][0] = pack_bf16(v[0][0], v[0][1]);
    sa[sb][1] = pack_bf16(v[0][2], v[0][3]);
    sa[sb][2] = pack_bf16(v[1][0], v[1][1]);
    sa[sb][3] = pack_bf16(v[1][2], v[1][3]);
  }
  __syncthreads();   // ws ready

  // w_s B_s, rounded to bf16, over the C tile
  for (int i = tid; i < qp * nch; i += NT) {
    const int t = i / nch, ch = i - t * nch;
    const uint4 raw = *reinterpret_cast<const uint4*>(Bs + t * CP + ch * 8);
    const uint32_t in[4] = {raw.x, raw.y, raw.z, raw.w};
    uint32_t out[4];
    const float w = ws[t];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&in[k]));
      out[k] = pack_bf16(f.x * w, f.y * w);
    }
    *reinterpret_cast<uint4*>(Cs + t * CP + ch * 8) = make_uint4(out[0], out[1], out[2], out[3]);
  }
  __syncthreads();

  // y = scores x (this warp's rows, s-steps up to its diagonal) and
  // state = (w B)^T x (this warp's state rows n0..n0+15), sharing each x
  // fragment
  const int n0 = warp * 16;
  const bool state_live = n0 < np16;
  float yacc[NTP][4], sacc[NTP][4];
#pragma unroll
  for (int n = 0; n < NTP; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) yacc[n][e] = sacc[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    if (kk * 16 >= qp) break;
    const bool y_step = rows_live && kk <= warp;
    if (!y_step && !state_live) continue;
    uint32_t aw[4];
    if (state_live)
      ldsm_x4_trans(aw, smem_u32(Cs + (kk * 16 + (lane & 7) + (mi >> 1) * 8) * CP +
                                 n0 + (mi & 1) * 8));
#pragma unroll
    for (int pn = 0; pn < P / 16; ++pn) {
      uint32_t bv[4];
      ldsm_x4_trans(bv, smem_u32(Xs + (kk * 16 + (lane & 7) + (mi & 1) * 8) * XP +
                                 pn * 16 + (mi >> 1) * 8));
      if (y_step) {
        mma_bf16(yacc[2 * pn], sa[kk], bv[0], bv[1]);
        mma_bf16(yacc[2 * pn + 1], sa[kk], bv[2], bv[3]);
      }
      if (state_live) {
        mma_bf16(sacc[2 * pn], aw, bv[0], bv[1]);
        mma_bf16(sacc[2 * pn + 1], aw, bv[2], bv[3]);
      }
    }
  }
  __syncthreads();   // tiles consumed: the staging goes over them

  float* stage = stage_all + warp * 16 * (P + PAD);
  if (rows_live)
    store_rows<P>(yacc, stage, p.y + (row * Q + t0) * P, Q - t0, lane);
  if (state_live)
    store_rows<P>(sacc, stage, p.st + (row * N + n0) * P, N - n0, lane);
}

// the kernel a launch ran last (chip_smoke.py and the tests read it)
const char* g_last_kernel = "none";

template <int P>
cudaError_t launch(const Params& p, int grid, cudaStream_t stream) {
  static std::atomic<unsigned long long> done{0};
  constexpr size_t smem = smem_bytes<P>();
  cudaError_t err = allow_smem(ssd_chunk<P>, smem, done);
  if (err != cudaSuccess) return err;
  ssd_chunk<P><<<grid, NT, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err == cudaSuccess) g_last_kernel = P == 32 ? "ssd_chunk<f32,32>" : "ssd_chunk<f32,64>";
  return err;
}

template <int P>
cudaError_t launch_mma(const Params& p, int grid, cudaStream_t stream) {
  static std::atomic<unsigned long long> done{0};
  const size_t smem = mma_smem_bytes(P, round16(p.Q), round16(p.N));
  // the most any (Q, N) it takes can need
  cudaError_t err = allow_smem(ssd_chunk_mma<P>, mma_smem_bytes(P, QT, NMAX), done);
  if (err != cudaSuccess) return err;
  ssd_chunk_mma<P><<<grid, NT, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    g_last_kernel = P == 32 ? "ssd_chunk_mma<bf16,32>" : "ssd_chunk_mma<bf16,64>";
  return err;
}

}  // namespace

// dtype (of x, B and C): 0 = float32 (ssd_chunk, SIMT), 1 = bfloat16
// (ssd_chunk_mma, tensor cores; 16-byte-aligned rows, N <= 128); dt and A
// are float32. Strides are in elements. Outputs y (B,H,nc,Q,P), states
// (B,H,nc,N,P) and cum (B,H,nc,Q) are contiguous fp32. Returns the
// cudaError_t of the launch (0 = success).
extern "C" int repro_ssd_chunk_fwd(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, void* y, void* states, void* cum,
    long long xb, long long xs, long long xh,
    long long db, long long ds, long long dh,
    long long bb, long long bs, long long cb, long long cs,
    int Bsz, int S, int H, int P, int N, int Q, int dtype, void* stream) {
  if (Q < 1 || Q > QT || S % Q != 0 || N < 1) return (int)cudaErrorInvalidValue;
  const int nc = S / Q;
  const long long grid = (long long)Bsz * H * nc;
  if (grid < 1 || grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Params p{x, static_cast<const float*>(dt), static_cast<const float*>(A),
           Bm, Cm, static_cast<float*>(y), static_cast<float*>(states),
           static_cast<float*>(cum), xb, xs, xh, db, ds, dh, bb, bs, cb, cs,
           H, N, Q, nc};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (P) {
      case 32: return (int)launch<32>(p, (int)grid, st);
      case 64: return (int)launch<64>(p, (int)grid, st);
    }
  } else if (dtype == 1 && N <= NMAX && N % 8 == 0) {
    switch (P) {
      case 32: return (int)launch_mma<32>(p, (int)grid, st);
      case 64: return (int)launch_mma<64>(p, (int)grid, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// The name of the kernel the last successful launch ran.
extern "C" const char* repro_ssd_chunk_last_kernel() { return g_last_kernel; }
