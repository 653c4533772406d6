// Mamba2 SSD within-chunk pass, backward, for Hopper (sm_90a).
//
// The gradient of the function of the Pallas TPU kernel
// repro/kernels/ssd_scan.py::ssd_chunked_pallas (_ssd_chunk_kernel, called
// at ssd_scan.py:81), which the reference takes through XLA under
// jax.value_and_grad; ssd_chunk.cu is that kernel's forward here. Per
// (batch b, head h, chunk c) of Q <= 128 steps the forward computes
//   cum[t]     = sum_{r<=t} dt_r A
//   L[t,s]     = exp(cum_t - cum_s) for s <= t, else 0 (masked before exp)
//   y[t]       = sum_s (C_t . B_s) L[t,s] dt_s x_s
//   state      = sum_s w_s B_s x_s^T,   w_s = exp(cum_{Q-1} - cum_s) dt_s
// and this computes, from the cotangents dy (Q x P), dS (N x P) and dcum
// (Q) of its three outputs (fp32, like the outputs), G = C B^T and
// dscores = dy x^T:
//   dG     = dscores L dt_s          F = dscores G L
//   dx     = (G L dt_s)^T dy + w (B dS)
//   dC     = sum_h dG B              dB = sum_h (dG^T C + w (x dS^T))
//   dw     = rowsum(B (x dS^T))
//   dcum'  = dcum + rowsum(F dt_s) - dt colsum(F) - dw w
//            (+ sum_s dw_s w_s on row Q-1, through cum_{Q-1} in w)
//   da     = reverse cumsum of dcum'
//   ddt    = colsum(F) + dw exp(cum_{Q-1} - cum) + A da
//   dA     = sum_{b, c, t} dt da
// (ssd_scan_bwd.ssd_chunk_bwd_plain is this algebra in plain PyTorch).
// No float atomics anywhere: two calls give the same bits.
//
// * ssd_chunk_bwd_mma<P, NC> (bf16 x, B and C; every bf16 call), one
//   launch. One block of 8 warps per (b, h, c); the blocks of one (b, c)
//   and G heads (the largest of 8, 4, 2, 1 dividing H) form a thread
//   block cluster. Tiles in shared memory as bf16, 128 rows (zero past Q)
//   and NC = 64 or 128 state dims (zero past N), rows padded by 16 bytes
//   so ldmatrix is free of bank conflicts: x, B and C by cp.async, dy and
//   dS rounded from fp32 (dy is a bf16 output widened on the training
//   path, so exact there; dS's rounding keeps every leaf within a sixth
//   of the bf16 tolerance on the sweep, chip_smoke.py [2f]). Warp w owns
//   rows s of one 16-row tile (0..3 for warps 0..3, 7..4 for warps 4..7)
//   and takes the t-tiles t >= s in halves, 0..3 (if its tile is one of
//   them) and 4..7, with no branch inside a half, so that its ldmatrix
//   loads and products overlap (the tiles above the diagonal come out
//   masked); the two warps of an SM sub-partition (w, w + 4) then share
//   12 tile pairs. On mma.sync m16n8k16 (bf16 in, fp32 accumulators):
//     G^T = B_s C_t^T and dscores^T = x_s dy_t^T;
//     F's sums in fp32 from the accumulators (colsum on its rows, rowsum
//     per s-tile into shared memory, summed in tile order); the scores^T
//     and dG^T rounded to bf16 straight from the accumulators into A
//     fragments over t (no branch: a masked entry takes exp(0) and is
//     selected away), dG^T also into a 128 x 128 tile;
//     dx = scores^T dy + w (B dS) (dy and dS by ldmatrix.trans), written
//     in x's dtype; this head's dB = dG^T C + w (x dS^T) and dw.
//   After a block barrier every warp forms this head's dC = dG B on rows t
//   of its tile (dG from the tile by ldmatrix.trans; s-tiles in halves as
//   above), and warp 0, which has the fewest, then runs the length-Q scans
//   (dcum', its reverse cumsum, dA's and dw w's sums) as shuffles in a
//   fixed order, four steps a lane, and writes ddt (fp32). The fp32 dB and
//   dC of the block go over its tiles; the cluster sums them over its G
//   heads through distributed shared memory, each rank its own Q/G rows,
//   the blocks in rank order. With one cluster per (b, c) (H == G) the sum
//   is written in bf16; else each cluster writes an fp32 partial and the
//   last to arrive (integer counters, reset by their last reader) sums the
//   H/G partials in cluster order and writes bf16. dA likewise: one fp32
//   partial per (b, h, c), summed in (b, c) order by the last block of the
//   head to arrive. 167 KB of shared memory at P = 64, NC = 128 (125 KB
//   at NC = 64), 249 registers: one block an SM.
// * ssd_chunk_bwd<T, P> + ssd_chunk_bwd_reduce (fp32 x, B and C, and
//   bf16 with simt=True: the first design, kept as the fp32 engine, which
//   bf16 products would not keep at 5e-5, and as the yardstick), two
//   launches. One block of 256 threads per (b, h, c), fp32 SIMT FMAs from
//   fp32 tiles in shared memory: the x and dy tiles (Q x P), one Q x Q
//   tile that holds G*L, then the scores, then dG, and B, C and dS staged
//   in slices of 32 state dims (186,496 bytes at P = 64). Thread (ty, tx)
//   owns rows ty + 16i and columns tx + 16j of every tile it computes. G
//   is accumulated over the state slices in registers, masked and decayed
//   into the tile; dscores in registers, which turn into dG after F's row
//   and column sums are taken (rows by a shuffle over the 16 lanes of a
//   row group, columns through shared memory in ty order). dx = scores^T
//   dy, then per state slice dC, dB, x dS^T, dw and B dS. One thread runs
//   the two length-Q scans. It writes dx (B, S, H, P) and ddt (B, S, H)
//   once, fp32, and fp32 partials: dB and dC per head (B, H, S, N) and dA
//   per (b, h, c); ssd_chunk_bwd_reduce sums them, one thread per (b, s,
//   n) in head order, H more threads over b and c.
//
// The masked entries (s > t, and rows and columns at or past Q) are never
// passed through exp: cum_t - cum_s > 0 there, and an overflow times 0
// would give NaN. x, B and C are read in place through their strides (the
// model's are column slices of one conv output); in the tensor-core
// kernel so are cum and the cotangents (the training path's dy is a
// transposed view).
//
// Bound on the card at mamba2-130m's training shape per rank (B=2, S=256,
// H=24, P=64, N=128, Q=128, bf16 x/B/C): 10.16 MB to read and write once,
// dx, dB and dC in bf16 (3.03 us at 3.35 TB/s), 1.02 GFLOP (the
// lower-triangle products over P and N per head, x dS^T and B dS per
// head, C B^T once per (b, c)): 1.03 us at the bf16 tensor-core rate, so
// bound by bytes. What the tensor-core design does about it: each input
// is read once per block (B and C again by each head's block, from L2)
// and each output written once in its final dtype; the per-head dB/dC
// partials of the first design (2 x B x H x S x N fp32, 12.6 MB here,
// written and read again by a second launch) shrink to what crosses
// clusters (2 x B x (H/G) x S x N fp32, 1.6 MB here); the products run
// on the tensor cores. C B^T is recomputed by every head's block. What
// it does not do yet: overlap the loads, the products and the cluster's
// sums (one block an SM runs them in turn; tools/ssd_bwd_phases.py times
// each from a build with -DSSD_BWD_PHASES), or use wgmma (PERF.md).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libssd_chunk_bwd.so ssd_chunk_bwd.cu
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include <atomic>

#include "sm90_common.cuh"

namespace {

constexpr int QT = 128;      // chunk rows a block covers (Q <= QT)
constexpr int NS = 32;       // state dims per staged slice of B, C and dS
constexpr int NT = 256;      // threads per block
constexpr int QP = QT + 1;   // padded row pitch of the Q x Q tile
constexpr int NSP = NS + 1;  // padded row pitch of the B and C slices

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* cum;    // (B, H, nc, Q)
  const float* dy;     // (B, H, nc, Q, P)
  const float* dst;    // (B, H, nc, N, P)
  const float* dcum;   // (B, H, nc, Q)
  float* dx;           // (B, S, H, P)
  float* ddt;          // (B, S, H)
  float* dBp;          // (B, H, S, N) per-head partials
  float* dCp;          // (B, H, S, N) per-head partials
  float* dAp;          // (B, H, nc) partials
  long long xb, xs, xh;   // element strides of x over (B, S, H)
  long long db, ds, dh;   // dt over (B, S, H)
  long long bb, bs;       // B over (B, S)
  long long cb, cs;       // C over (B, S)
  int S, H, N, Q, nc;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// sum over the 16 lanes of a row group (tid = 16 ty + tx: lanes with one
// ty are 16 consecutive lanes of a warp), in a fixed order
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int P>
constexpr size_t smem_floats() {
  return (size_t)QT * (P + 1)      // x tile, padded
         + (size_t)QT * P          // dy tile
         + (size_t)QT * QP         // G*L, scores, then dG
         + 2 * (size_t)QT * NSP    // C and B slices
         + (size_t)NS * (P + 1)    // dS slice, padded
         + 16 * (size_t)QT         // column partials, one row per ty
         + 8 * (size_t)QT;         // dt, cum, w, e, row E, col F, dw, dcum'
}

template <typename T, int P>
__global__ void __launch_bounds__(NT) ssd_chunk_bwd(const Params p) {
  constexpr int XP = P + 1;    // x tile row pitch
  constexpr int DP = P + 1;    // dS slice row pitch
  constexpr int PJ = P / 16;   // dx columns per thread: tx + 16 j
  extern __shared__ float smem[];
  float* Xs = smem;                 // QT x XP
  float* Ys = Xs + QT * XP;         // QT x P
  float* Ss = Ys + QT * P;          // QT x QP
  float* Cs = Ss + QT * QP;         // QT x NSP
  float* Bs = Cs + QT * NSP;        // QT x NSP
  float* Ds = Bs + QT * NSP;        // NS x DP
  float* colp = Ds + NS * DP;       // 16 x QT
  float* dts = colp + 16 * QT;
  float* cums = dts + QT;
  float* ws = cums + QT;
  float* es = ws + QT;
  float* rowE = es + QT;
  float* colF = rowE + QT;
  float* dws = colF + QT;
  float* dcs = dws + QT;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int c = blockIdx.x % p.nc;
  const int bh = blockIdx.x / p.nc;
  const int h = bh % p.H;
  const int b = bh / p.H;
  const int Q = p.Q, N = p.N;
  const long long s0 = (long long)c * Q;     // first step of the chunk
  const long long row = (long long)bh * p.nc + c;   // index over (B, H, nc)

  const T* xg = static_cast<const T*>(p.x) + b * p.xb + s0 * p.xs + h * p.xh;
  const float* dg = p.dt + b * p.db + s0 * p.ds + h * p.dh;
  const T* bg = static_cast<const T*>(p.Bm) + b * p.bb + s0 * p.bs;
  const T* cg = static_cast<const T*>(p.Cm) + b * p.cb + s0 * p.cs;
  const float* cumg = p.cum + row * Q;
  const float* dyg = p.dy + row * Q * P;
  const float* dsg = p.dst + row * N * P;
  const float* dcg = p.dcum + row * Q;

  for (int i = tid; i < QT; i += NT) {
    dts[i] = i < Q ? dg[i * p.ds] : 0.f;
    cums[i] = i < Q ? cumg[i] : 0.f;
    dws[i] = 0.f;
  }
  for (int i = tid; i < QT * P; i += NT) {
    const int t = i / P, col = i - (i / P) * P;
    Xs[t * XP + col] = t < Q ? ld(xg + t * p.xs + col) : 0.f;
    Ys[i] = t < Q ? dyg[i] : 0.f;
  }
  __syncthreads();
  const float total = cums[Q - 1];
  for (int i = tid; i < QT; i += NT) {
    const float e = i < Q ? expf(total - cums[i]) : 0.f;
    es[i] = e;
    ws[i] = e * dts[i];
  }

  // ---- G = C B^T over the state slices, then G*L into the tile --------
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int n0 = 0; n0 < N; n0 += NS) {
    __syncthreads();
    for (int i = tid; i < QT * NS; i += NT) {
      const int t = i / NS, col = i - (i / NS) * NS;
      const int n = n0 + col;
      const bool in = t < Q && n < N;
      Cs[t * NSP + col] = in ? ld(cg + t * p.cs + n) : 0.f;
      Bs[t * NSP + col] = in ? ld(bg + t * p.bs + n) : 0.f;
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
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int s = tx + 16 * j;
      Ss[t * QP + s] =
          (s <= t && t < Q) ? acc[i][j] * expf(cums[t] - cums[s]) : 0.f;
    }
  }

  // ---- dscores = dy x^T; then F's sums, the scores and dG -------------
  float dac[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) dac[i][j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < P; ++k) {
    float yv[8], xv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) yv[i] = Ys[(ty + 16 * i) * P + k];
#pragma unroll
    for (int j = 0; j < 8; ++j) xv[j] = Xs[(tx + 16 * j) * XP + k];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) dac[i][j] = fmaf(yv[i], xv[j], dac[i][j]);
  }
  float colf[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) colf[j] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = ty + 16 * i;
    float rowe = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int s = tx + 16 * j;
      if (s <= t && t < Q) {
        const float gl = Ss[t * QP + s];     // this thread's own entry
        const float f = dac[i][j] * gl;
        rowe = fmaf(f, dts[s], rowe);
        colf[j] += f;
        Ss[t * QP + s] = gl * dts[s];        // the scores
        dac[i][j] = dac[i][j] * expf(cums[t] - cums[s]) * dts[s];   // dG
      } else {
        dac[i][j] = 0.f;
      }
    }
    rowe = sum16(rowe);
    if (tx == 0) rowE[t] = rowe;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) colp[ty * QT + tx + 16 * j] = colf[j];
  __syncthreads();   // scores and column partials complete
  if (tid < QT) {
    float v = 0.f;
#pragma unroll
    for (int r = 0; r < 16; ++r) v += colp[r * QT + tid];
    colF[tid] = v;
  }

  // ---- dx, first term: scores^T dy (rows s = ty + 16 i) ---------------
  float dxa[8][PJ], bds[8][PJ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < PJ; ++j) dxa[i][j] = bds[i][j] = 0.f;
  for (int t = 0; t < Q; ++t) {
    float sv[8], yv[PJ];
#pragma unroll
    for (int i = 0; i < 8; ++i) sv[i] = Ss[t * QP + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < PJ; ++j) yv[j] = Ys[t * P + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < PJ; ++j) dxa[i][j] = fmaf(sv[i], yv[j], dxa[i][j]);
  }
  __syncthreads();   // scores consumed: dG goes over them
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) Ss[(ty + 16 * i) * QP + tx + 16 * j] = dac[i][j];

  // ---- per state slice: dC, dB, x dS^T, dw and B dS --------------------
  float* dBg = p.dBp + ((long long)bh * p.S + s0) * N;
  float* dCg = p.dCp + ((long long)bh * p.S + s0) * N;
  for (int n0 = 0; n0 < N; n0 += NS) {
    __syncthreads();   // dG written; the previous slice consumed
    for (int i = tid; i < QT * NS; i += NT) {
      const int t = i / NS, col = i - (i / NS) * NS;
      const int n = n0 + col;
      const bool in = t < Q && n < N;
      Cs[t * NSP + col] = in ? ld(cg + t * p.cs + n) : 0.f;
      Bs[t * NSP + col] = in ? ld(bg + t * p.bs + n) : 0.f;
    }
    for (int i = tid; i < NS * P; i += NT) {
      const int nn = i / P, col = i - (i / P) * P;
      Ds[nn * DP + col] = n0 + nn < N ? dsg[(n0 + nn) * P + col] : 0.f;
    }
    __syncthreads();

    // slice outputs: rows r = ty + 16 i, state columns tx + 16 j (j < 2)
    float dc[8][2], db[8][2], xd[8][2];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) dc[i][j] = db[i][j] = xd[i][j] = 0.f;
    for (int s = 0; s < Q; ++s) {
      float gr[8], gc[8], bv[2], cv[2];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        gr[i] = Ss[(ty + 16 * i) * QP + s];     // dG[r, s]
        gc[i] = Ss[s * QP + ty + 16 * i];       // dG[s, r]
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        bv[j] = Bs[s * NSP + tx + 16 * j];
        cv[j] = Cs[s * NSP + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          dc[i][j] = fmaf(gr[i], bv[j], dc[i][j]);
          db[i][j] = fmaf(gc[i], cv[j], db[i][j]);
        }
    }
#pragma unroll 4
    for (int k = 0; k < P; ++k) {
      float xv[8], dv[2];
#pragma unroll
      for (int i = 0; i < 8; ++i) xv[i] = Xs[(ty + 16 * i) * XP + k];
#pragma unroll
      for (int j = 0; j < 2; ++j) dv[j] = Ds[(tx + 16 * j) * DP + k];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) xd[i][j] = fmaf(xv[i], dv[j], xd[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty + 16 * i;
      float dwp = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = n0 + tx + 16 * j;
        if (r < Q && n < N) {
          dwp = fmaf(Bs[r * NSP + tx + 16 * j], xd[i][j], dwp);
          dCg[(long long)r * N + n] = dc[i][j];
          dBg[(long long)r * N + n] = db[i][j] + ws[r] * xd[i][j];
        }
      }
      dwp = sum16(dwp);
      if (tx == 0 && r < Q) dws[r] += dwp;   // one writer a row, slices in order
    }
#pragma unroll 4
    for (int nn = 0; nn < NS; ++nn) {
      float bv[8], dv[PJ];
#pragma unroll
      for (int i = 0; i < 8; ++i) bv[i] = Bs[(ty + 16 * i) * NSP + nn];
#pragma unroll
      for (int j = 0; j < PJ; ++j) dv[j] = Ds[nn * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) bds[i][j] = fmaf(bv[i], dv[j], bds[i][j]);
    }
  }

  // ---- dx = scores^T dy + w (B dS) -------------------------------------
  float* dxg = p.dx + ((long long)b * p.S + s0) * p.H * P + (long long)h * P;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int s = ty + 16 * i;
    if (s >= Q) continue;
#pragma unroll
    for (int j = 0; j < PJ; ++j)
      dxg[(long long)s * p.H * P + tx + 16 * j] = dxa[i][j] + ws[s] * bds[i][j];
  }
  __syncthreads();   // dw, row E and column F complete

  // ---- dcum', its reverse cumsum, ddt and dA's partial -----------------
  if (tid < Q)
    dcs[tid] = dcg[tid] + rowE[tid] - dts[tid] * colF[tid] - dws[tid] * ws[tid];
  __syncthreads();
  if (tid == 0) {
    float sum = 0.f;
    for (int s = 0; s < Q; ++s) sum = fmaf(dws[s], ws[s], sum);
    dcs[Q - 1] += sum;
    float run = 0.f, dA = 0.f;
    for (int t = Q - 1; t >= 0; --t) {
      run += dcs[t];
      dcs[t] = run;
      dA = fmaf(dts[t], run, dA);
    }
    p.dAp[row] = dA;
  }
  __syncthreads();
  const float A = p.A[h];
  if (tid < Q)
    p.ddt[((long long)b * p.S + s0 + tid) * p.H + h] =
        colF[tid] + dws[tid] * es[tid] + A * dcs[tid];
}

// dB and dC: the per-head partials summed in head order; dA: its
// per-(b, h, c) partials summed over b, then c
__global__ void ssd_chunk_bwd_reduce(const float* __restrict__ dBp,
                                     const float* __restrict__ dCp,
                                     const float* __restrict__ dAp,
                                     float* __restrict__ dB,
                                     float* __restrict__ dC,
                                     float* __restrict__ dA, int Bsz, int S,
                                     int H, int N, int nc) {
  const long long sn = (long long)S * N;
  const long long total = (long long)Bsz * sn;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < total) {
    const long long b = i / sn, rem = i - b * sn;
    const float* pb = dBp + b * H * sn + rem;
    const float* pc = dCp + b * H * sn + rem;
    float vb = 0.f, vc = 0.f;
    for (int h = 0; h < H; ++h) {
      vb += pb[h * sn];
      vc += pc[h * sn];
    }
    dB[i] = vb;
    dC[i] = vc;
  } else if (i < total + H) {
    const int h = (int)(i - total);
    float v = 0.f;
    for (int b = 0; b < Bsz; ++b)
      for (int c = 0; c < nc; ++c) v += dAp[((long long)b * H + h) * nc + c];
    dA[h] = v;
  }
}

// the chunk pass a launch ran last (chip_smoke.py and the tests read it)
const char* g_last_kernel = "none";

template <typename T, int P>
cudaError_t launch(const Params& p, int grid, cudaStream_t stream) {
  static std::atomic<unsigned long long> done{0};
  constexpr size_t smem = sizeof(float) * smem_floats<P>();
  cudaError_t err = allow_smem(ssd_chunk_bwd<T, P>, smem, done);
  if (err != cudaSuccess) return err;
  ssd_chunk_bwd<T, P><<<grid, NT, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    const bool bf = sizeof(T) == 2;
    g_last_kernel = P == 32 ? (bf ? "ssd_chunk_bwd<bf16,32>" : "ssd_chunk_bwd<f32,32>")
                            : (bf ? "ssd_chunk_bwd<bf16,64>" : "ssd_chunk_bwd<f32,64>");
  }
  return err;
}

template <typename T>
cudaError_t launch_p(const Params& p, int P, int grid, cudaStream_t st) {
  switch (P) {
    case 32: return launch<T, 32>(p, grid, st);
    case 64: return launch<T, 64>(p, grid, st);
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: ssd_chunk_bwd_mma<P>
// ---------------------------------------------------------------------------
constexpr int PAD = 8;       // bf16 row padding (16 bytes): ldmatrix rows hit distinct banks
constexpr int NMAX = 128;    // state dims the tensor-core kernel takes

// Phase stamps of ssd_chunk_bwd_mma, for tools/ssd_bwd_phases.py: built
// with -DSSD_BWD_PHASES, threads 0 and 128 (warps 0 and 4) write the
// device's global timer (ns) at phase boundary k to
// g_stamps[block * 32 + 16 * (thread / 128) + k]; otherwise empty.
#ifdef SSD_BWD_PHASES
__device__ unsigned long long* g_stamps;
__device__ __forceinline__ void stamp(int k) {
  if (threadIdx.x == 0 || threadIdx.x == 128) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_stamps[blockIdx.x * 32 + (threadIdx.x >> 3) + k] = t;
  }
}
#define SSD_BWD_STAMP(k) stamp(k)
#else
#define SSD_BWD_STAMP(k) ((void)0)
#endif

struct MmaParams {
  const __nv_bfloat16* x;
  const float* dt;
  const float* A;
  const __nv_bfloat16* Bm;
  const __nv_bfloat16* Cm;
  const float* cum;     // (B, H, nc, Q)
  const float* dy;      // (B, H, nc, Q, P)
  const float* dst;     // (B, H, nc, N, P)
  const float* dcum;    // (B, H, nc, Q)
  __nv_bfloat16* dx;    // (B, S, H, P)
  float* ddt;           // (B, S, H)
  float* dA;            // (H)
  __nv_bfloat16* dB;    // (B, S, N)
  __nv_bfloat16* dC;    // (B, S, N)
  float* part;          // (2, B, H/G, S, N) cluster partials of dB, dC (H > G)
  float* dAp;           // (H, B*nc) partials of dA (B*nc > 1)
  int* cnt;             // B*nc*G + H arrival counters, zero between calls
  long long xb, xs, xh, db, ds, dh, bb, bs, cb, cs;   // element strides
  long long ub, uh, uc, ut;           // cum over (B, H, nc, Q)
  long long yb, yh, yc, yt, yp;       // dy over (B, H, nc, Q, P)
  long long sb, sh, sc, sn, sp;       // dS over (B, H, nc, N, P)
  long long qb, qh, qc, qt;           // dcum over (B, H, nc, Q)
  int Bsz, S, H, N, Q, nc, G;
  int vec;              // dy and dS rows contiguous and on 16 bytes: float4 loads
};

// Shared memory, bf16 tiles of QT rows (rows at or past Q and state dims
// at or past N zero; rows padded by PAD): x and dy (QT x (P+PAD)), dS
// (NC x (P+PAD)), B and C (QT x (NC+PAD)), dG^T (QT x (QT+PAD)); over
// them, once the products are done, the block's fp32 dB and dC (QT x
// (NC+PAD) each) that the cluster sums; then the fp32 vectors.
constexpr int VEC_FLOATS = 15 * QT;   // dt, cum, w, e, dcum, colF, dw; rowE by s-tile
__host__ __device__ constexpr size_t mma_tile_bytes(int P, int NC) {
  return 2 * ((size_t)(2 * QT + NC) * (P + PAD) + 2 * (size_t)QT * (NC + PAD) +
              (size_t)QT * (QT + PAD));
}
__host__ __device__ constexpr size_t mma_vec_offset(int P, int NC) {
  return mma_tile_bytes(P, NC) > 8 * (size_t)QT * (NC + PAD) ? mma_tile_bytes(P, NC)
                                                              : 8 * (size_t)QT * (NC + PAD);
}
__host__ __device__ constexpr size_t mma_smem_bytes(int P, int NC) {
  return mma_vec_offset(P, NC) + sizeof(float) * VEC_FLOATS;
}

// v summed over the lanes that differ from this one in the bits from..to-1
// of the lane index (a butterfly: every lane gets the same sum, in a
// fixed order)
__device__ __forceinline__ float xor_sum(float v, int from, int to) {
#pragma unroll
  for (int off = from; off < to; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// A warp's 16 rows x NC fp32 accumulators to a padded fp32 tile
template <int NC>
__device__ __forceinline__ void put_rows(const float (&acc)[NC / 8][4], float* dst,
                                         int lane) {
  constexpr int FP = NC + PAD;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
    *reinterpret_cast<float2*>(dst + g * FP + j * 8 + 2 * t4) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(dst + (g + 8) * FP + j * 8 + 2 * t4) =
        make_float2(acc[j][2], acc[j][3]);
  }
}

__device__ __forceinline__ void store_bf16x4(__nv_bfloat16* dst, float4 v) {
  *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}

__device__ __forceinline__ void add4(float4& a, const float4 b) {
  a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
}

// The kernel of one (b, h, c). NC: the state dims the tiles hold (64 or
// 128; N <= NC, zero past N).
template <int P, int NC>
__global__ void __launch_bounds__(NT, 1) ssd_chunk_bwd_mma(const MmaParams p) {
  namespace cg = cooperative_groups;
  constexpr int XP = P + PAD;   // x, dy and dS row pitch, elements
  constexpr int CP = NC + PAD;  // B and C row pitch
  constexpr int MP = QT + PAD;  // dG^T row pitch
  constexpr int FP = NC + PAD;  // fp32 dB and dC row pitch
  constexpr int PN = P / 8;     // 8-column tiles of dx
  constexpr int JN = NC / 8;    // 8-column tiles of dB and dC
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Q = p.Q, N = p.N, H = p.H;
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ys = Xs + QT * XP;
  __nv_bfloat16* Ds = Ys + QT * XP;
  __nv_bfloat16* Bs = Ds + NC * XP;
  __nv_bfloat16* Cs = Bs + QT * CP;
  __nv_bfloat16* Ms = Cs + QT * CP;     // dG^T: row s, column t
  float* DBs = reinterpret_cast<float*>(smem_raw);   // after the products
  float* DCs = DBs + QT * FP;
  float* dts = reinterpret_cast<float*>(smem_raw + mma_vec_offset(P, NC));
  float* cums = dts + QT;
  float* ws = cums + QT;
  float* es = ws + QT;
  float* dcs = es + QT;
  float* colF = dcs + QT;
  float* dws = colF + QT;
  float* rowEp = dws + QT;              // 8 x QT: rowsum(F dt) by s-tile
  __shared__ int is_last;

  SSD_BWD_STAMP(0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3, mi = lane >> 3;
  const int h = blockIdx.x % H;
  const int bc = blockIdx.x / H;        // b * nc + c
  const int c = bc % p.nc, b = bc / p.nc;
  const long long s0 = (long long)c * Q;

  const __nv_bfloat16* xg = p.x + b * p.xb + s0 * p.xs + h * p.xh;
  const __nv_bfloat16* bg = p.Bm + b * p.bb + s0 * p.bs;
  const __nv_bfloat16* cmg = p.Cm + b * p.cb + s0 * p.cs;
  const float* dtg = p.dt + b * p.db + s0 * p.ds + h * p.dh;
  const float* cumg = p.cum + b * p.ub + h * p.uh + c * p.uc;
  const float* dyg = p.dy + b * p.yb + h * p.yh + c * p.yc;
  const float* dsg = p.dst + b * p.sb + h * p.sh + c * p.sc;
  const float* dcg = p.dcum + b * p.qb + h * p.qh + c * p.qc;

  // ---- x, B and C by cp.async; dy and dS rounded to bf16; vectors -------
  for (int i = tid; i < QT * (P / 8); i += NT) {
    const int t = i / (P / 8), ch = i - t * (P / 8);
    const bool in = t < Q;
    cp_async16(smem_u32(Xs + t * XP + ch * 8), in ? xg + t * p.xs + ch * 8 : xg, in);
  }
#pragma unroll 4
  for (int i = tid; i < QT * (NC / 8); i += NT) {
    const int t = i / (NC / 8), ch = i - t * (NC / 8);
    const bool in = t < Q && ch * 8 < N;
    cp_async16(smem_u32(Bs + t * CP + ch * 8), in ? bg + t * p.bs + ch * 8 : bg, in);
    cp_async16(smem_u32(Cs + t * CP + ch * 8), in ? cmg + t * p.cs + ch * 8 : cmg, in);
  }
  cp_async_commit();
  if (p.vec) {
    // every 16-byte piece of dy and dS this thread stages, loaded before
    // any is stored, so the loads' latencies overlap
    constexpr int IT = QT * (P / 4) / NT;
    float4 vy[IT], vs[IT];
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int i = tid + it * NT;
      const int r = i / (P / 4), col = 4 * (i - r * (P / 4));
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      vy[it] = r < Q ? __ldg(reinterpret_cast<const float4*>(dyg + r * p.yt + col)) : zero;
      vs[it] = r < N ? __ldg(reinterpret_cast<const float4*>(dsg + r * p.sn + col)) : zero;
    }
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int i = tid + it * NT;
      const int r = i / (P / 4), col = 4 * (i - r * (P / 4));
      *reinterpret_cast<uint2*>(Ys + r * XP + col) =
          make_uint2(pack_bf16(vy[it].x, vy[it].y), pack_bf16(vy[it].z, vy[it].w));
      if (r < NC)
        *reinterpret_cast<uint2*>(Ds + r * XP + col) =
            make_uint2(pack_bf16(vs[it].x, vs[it].y), pack_bf16(vs[it].z, vs[it].w));
    }
  } else {
    for (int i = tid; i < QT * (P / 2); i += NT) {
      const int t = i / (P / 2), col = 2 * (i - t * (P / 2));
      float v0 = 0.f, v1 = 0.f;
      if (t < Q) {
        v0 = dyg[t * p.yt + col * p.yp];
        v1 = dyg[t * p.yt + (col + 1) * p.yp];
      }
      *reinterpret_cast<uint32_t*>(Ys + t * XP + col) = pack_bf16(v0, v1);
    }
    for (int i = tid; i < NC * (P / 2); i += NT) {
      const int n = i / (P / 2), col = 2 * (i - n * (P / 2));
      float v0 = 0.f, v1 = 0.f;
      if (n < N) {
        v0 = dsg[n * p.sn + col * p.sp];
        v1 = dsg[n * p.sn + (col + 1) * p.sp];
      }
      *reinterpret_cast<uint32_t*>(Ds + n * XP + col) = pack_bf16(v0, v1);
    }
  }
  const float total = cumg[(Q - 1) * p.ut];
  for (int i = tid; i < QT; i += NT) {
    const bool in = i < Q;
    const float cm = in ? cumg[i * p.ut] : 0.f, d = in ? dtg[i * p.ds] : 0.f;
    const float e = in ? expf(total - cm) : 0.f;
    dts[i] = d;
    cums[i] = cm;
    es[i] = e;
    ws[i] = e * d;
    dcs[i] = in ? dcg[i * p.qt] : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();

  SSD_BWD_STAMP(1);
  // ---- warp w owns rows s of the 16-row tile st: 0..3 for warps 0..3,
  // 7..4 for warps 4..7. It takes the t-tiles t >= s in halves, 0..3 (if
  // st < 4) and 4..7, each without a branch inside, so its loads and
  // products overlap (tiles above the diagonal come out masked to 0); the
  // two warps of an SM sub-partition (w, w + 4) share 12 of the 64 tile
  // pairs ---------------------------------------------------------------
  const int st = warp < 4 ? warp : 11 - warp;
  const int sr = st * 16;
  const int h0 = st < 4 ? 0 : 1;       // the first half of t-tiles taken
  // G^T = B_s C_t^T (over N) and dscores^T = x_s dy_t^T (over P)
  float gacc[8][2][4], dacc[8][2][4];
#pragma unroll
  for (int tt = 0; tt < 8; ++tt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int e = 0; e < 4; ++e) gacc[tt][hf][e] = dacc[tt][hf][e] = 0.f;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (hh < h0) continue;
#pragma unroll
    for (int kk = 0; kk < NC / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, smem_u32(Bs + (sr + (lane & 7) + (mi & 1) * 8) * CP + kk * 16 + (mi >> 1) * 8));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int tt = 4 * hh + j;
        uint32_t bk[4];
        ldsm_x4(bk, smem_u32(Cs + (tt * 16 + (lane & 7) + (mi >> 1) * 8) * CP + kk * 16 +
                             (mi & 1) * 8));
        mma_bf16(gacc[tt][0], a, bk[0], bk[1]);
        mma_bf16(gacc[tt][1], a, bk[2], bk[3]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < P / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, smem_u32(Xs + (sr + (lane & 7) + (mi & 1) * 8) * XP + kk * 16 + (mi >> 1) * 8));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int tt = 4 * hh + j;
        uint32_t bk[4];
        ldsm_x4(bk, smem_u32(Ys + (tt * 16 + (lane & 7) + (mi >> 1) * 8) * XP + kk * 16 +
                             (mi & 1) * 8));
        mma_bf16(dacc[tt][0], a, bk[0], bk[1]);
        mma_bf16(dacc[tt][1], a, bk[2], bk[3]);
      }
    }
  }

  SSD_BWD_STAMP(2);
  // F = dscores G L, its sums in fp32; the scores^T = (G L dt_s)^T and
  // dG^T = (dscores L dt_s)^T rounded to bf16 as A operands over t; dG^T
  // also into its tile for dC
  // (without a branch: a masked entry (s > t or t >= Q) takes exp(0) and
  // is then selected away, so no entry waits on another's loads)
  uint32_t sa[8][4], ga[8][4];
  float cf[2] = {0.f, 0.f};         // colsum(F) on rows s = sr + g, sr + g + 8
  const float cum_s[2] = {cums[sr + g], cums[sr + g + 8]};
  const float dt_s[2] = {dts[sr + g], dts[sr + g + 8]};
#pragma unroll
  for (int tt = 0; tt < 8; ++tt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sa[tt][e] = ga[tt][e] = 0u;
    if (tt < 4 * h0) continue;
    float sv[2][4], gv[2][4], re[2][4];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int t0 = tt * 16 + hf * 8 + 2 * t4;
      const float2 cum_t = *reinterpret_cast<const float2*>(cums + t0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = sr + g + 8 * (e >> 1), t = t0 + (e & 1);
        const bool live = s <= t && t < Q;
        const float L =
            __expf(live ? ((e & 1) ? cum_t.y : cum_t.x) - cum_s[e >> 1] : 0.f);
        const float gl = gacc[tt][hf][e] * L;
        const float d = dacc[tt][hf][e];
        const float f = live ? d * gl : 0.f;
        cf[e >> 1] += f;
        re[hf][e] = f * dt_s[e >> 1];
        sv[hf][e] = live ? gl * dt_s[e >> 1] : 0.f;
        gv[hf][e] = live ? d * L * dt_s[e >> 1] : 0.f;
      }
    }
    // rowsum(F dt_s) over this tile's 16 rows s, per column t
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float v = xor_sum(re[hf][q] + re[hf][q + 2], 4, 32);
        if (g == 0) rowEp[st * QT + tt * 16 + hf * 8 + 2 * t4 + q] = v;
      }
    sa[tt][0] = pack_bf16(sv[0][0], sv[0][1]);
    sa[tt][1] = pack_bf16(sv[0][2], sv[0][3]);
    sa[tt][2] = pack_bf16(sv[1][0], sv[1][1]);
    sa[tt][3] = pack_bf16(sv[1][2], sv[1][3]);
    ga[tt][0] = pack_bf16(gv[0][0], gv[0][1]);
    ga[tt][1] = pack_bf16(gv[0][2], gv[0][3]);
    ga[tt][2] = pack_bf16(gv[1][0], gv[1][1]);
    ga[tt][3] = pack_bf16(gv[1][2], gv[1][3]);
    __nv_bfloat16* mrow = Ms + (sr + g) * MP + tt * 16 + 2 * t4;
    *reinterpret_cast<uint32_t*>(mrow) = ga[tt][0];
    *reinterpret_cast<uint32_t*>(mrow + 8 * MP) = ga[tt][1];
    *reinterpret_cast<uint32_t*>(mrow + 8) = ga[tt][2];
    *reinterpret_cast<uint32_t*>(mrow + 8 * MP + 8) = ga[tt][3];
  }
  cf[0] = xor_sum(cf[0], 1, 4);   // the 4 lanes of a row differ in bits 0-1
  cf[1] = xor_sum(cf[1], 1, 4);
  if (t4 == 0) {
    colF[sr + g] = cf[0];
    colF[sr + g + 8] = cf[1];
  }

  SSD_BWD_STAMP(3);
  // dx = scores^T dy + w (B dS), on rows s
  float dxa[PN][4], bda[PN][4];
#pragma unroll
  for (int n = 0; n < PN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dxa[n][e] = bda[n][e] = 0.f;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (hh < h0) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int tt = 4 * hh + j;
#pragma unroll
      for (int pn = 0; pn < P / 16; ++pn) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, smem_u32(Ys + (tt * 16 + (lane & 7) + (mi & 1) * 8) * XP + pn * 16 +
                                   (mi >> 1) * 8));
        mma_bf16(dxa[2 * pn], sa[tt], bv[0], bv[1]);
        mma_bf16(dxa[2 * pn + 1], sa[tt], bv[2], bv[3]);
      }
    }
  }
#pragma unroll
  for (int kk = 0; kk < NC / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, smem_u32(Bs + (sr + (lane & 7) + (mi & 1) * 8) * CP + kk * 16 + (mi >> 1) * 8));
#pragma unroll
    for (int pn = 0; pn < P / 16; ++pn) {
      uint32_t bv[4];
      ldsm_x4_trans(bv, smem_u32(Ds + (kk * 16 + (lane & 7) + (mi & 1) * 8) * XP + pn * 16 +
                                 (mi >> 1) * 8));
      mma_bf16(bda[2 * pn], a, bv[0], bv[1]);
      mma_bf16(bda[2 * pn + 1], a, bv[2], bv[3]);
    }
  }
  __nv_bfloat16* dxg = p.dx + ((b * (long long)p.S + s0 + sr) * H + h) * P;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = g + 8 * hf;
    if (sr + r >= Q) continue;
    const float w = ws[sr + r];
#pragma unroll
    for (int n = 0; n < PN; ++n)
      *reinterpret_cast<uint32_t*>(dxg + (long long)r * H * P + n * 8 + 2 * t4) =
          pack_bf16(dxa[n][2 * hf] + w * bda[n][2 * hf],
                    dxa[n][2 * hf + 1] + w * bda[n][2 * hf + 1]);
  }

  SSD_BWD_STAMP(4);
  // this head's dB = dG^T C + w (x dS^T) on rows s; dw = rowsum(B (x dS^T))
  float dbh[JN][4], xd[JN][4];
#pragma unroll
  for (int j = 0; j < JN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dbh[j][e] = xd[j][e] = 0.f;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (hh < h0) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int tt = 4 * hh + j;
#pragma unroll
      for (int nn = 0; nn < NC / 16; ++nn) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, smem_u32(Cs + (tt * 16 + (lane & 7) + (mi & 1) * 8) * CP + nn * 16 +
                                   (mi >> 1) * 8));
        mma_bf16(dbh[2 * nn], ga[tt], bv[0], bv[1]);
        mma_bf16(dbh[2 * nn + 1], ga[tt], bv[2], bv[3]);
      }
    }
  }
#pragma unroll
  for (int kk = 0; kk < P / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, smem_u32(Xs + (sr + (lane & 7) + (mi & 1) * 8) * XP + kk * 16 + (mi >> 1) * 8));
#pragma unroll
    for (int nn = 0; nn < NC / 16; ++nn) {
      uint32_t bk[4];
      ldsm_x4(bk, smem_u32(Ds + (nn * 16 + (lane & 7) + (mi >> 1) * 8) * XP + kk * 16 +
                           (mi & 1) * 8));
      mma_bf16(xd[2 * nn], a, bk[0], bk[1]);
      mma_bf16(xd[2 * nn + 1], a, bk[2], bk[3]);
    }
  }
  SSD_BWD_STAMP(5);
  float dw[2] = {0.f, 0.f};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int s = sr + g + 8 * hf;
    const float w = ws[s];
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      const float2 bv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(Bs + s * CP + j * 8 + 2 * t4));
      dw[hf] += bv.x * xd[j][2 * hf] + bv.y * xd[j][2 * hf + 1];
      dbh[j][2 * hf] += w * xd[j][2 * hf];
      dbh[j][2 * hf + 1] += w * xd[j][2 * hf + 1];
    }
  }
  dw[0] = xor_sum(dw[0], 1, 4);
  dw[1] = xor_sum(dw[1], 1, 4);
  if (t4 == 0) {
    dws[sr + g] = dw[0];
    dws[sr + g + 8] = dw[1];
  }
  SSD_BWD_STAMP(6);
  __syncthreads();   // dG^T, colF, rowsum(F dt) and dw complete

  SSD_BWD_STAMP(7);
  // ---- this head's dC = dG B on rows t of tile st: s-tiles 0..3, and
  // 4..7 for t-tiles 4..7 (dG^T is 0 above the diagonal) ---------------
  float dca[JN][4];
#pragma unroll
  for (int j = 0; j < JN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dca[j][e] = 0.f;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (hh > h0) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ks = 4 * hh + j;
      uint32_t a[4];
      ldsm_x4_trans(a, smem_u32(Ms + (ks * 16 + (lane & 7) + (mi >> 1) * 8) * MP + sr +
                                (mi & 1) * 8));
#pragma unroll
      for (int nn = 0; nn < NC / 16; ++nn) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, smem_u32(Bs + (ks * 16 + (lane & 7) + (mi & 1) * 8) * CP + nn * 16 +
                                   (mi >> 1) * 8));
        mma_bf16(dca[2 * nn], a, bv[0], bv[1]);
        mma_bf16(dca[2 * nn + 1], a, bv[2], bv[3]);
      }
    }
  }
  SSD_BWD_STAMP(8);
  // ---- dcum', its reverse cumsum, ddt and dA on one warp (the one with
  // the fewest dC products), four steps a lane, in a fixed order --------
  if (warp == 0) {
    float v[4], dwl = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = 4 * lane + j;
      v[j] = 0.f;
      if (t < Q) {
        float rowE = rowEp[t];
        for (int k = 1; k <= t / 16; ++k) rowE += rowEp[k * QT + t];
        v[j] = dcs[t] + rowE - dts[t] * colF[t] - dws[t] * ws[t];
        dwl += dws[t] * ws[t];
      }
    }
    const float dwsum = xor_sum(dwl, 1, 32);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (4 * lane + j == Q - 1) v[j] += dwsum;   // through cum_{Q-1} in w
    float r[4];
    r[3] = v[3];
    r[2] = v[2] + r[3];
    r[1] = v[1] + r[2];
    r[0] = v[0] + r[1];
    float inc = r[0];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_down_sync(0xffffffffu, inc, off);
      if (lane + off < 32) inc += y;
    }
    float after = __shfl_down_sync(0xffffffffu, inc, 1);
    if (lane == 31) after = 0.f;
    const float A = p.A[h];
    float dal = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = 4 * lane + j;
      if (t < Q) {
        const float da = r[j] + after;
        p.ddt[(b * (long long)p.S + s0 + t) * H + h] = colF[t] + dws[t] * es[t] + A * da;
        dal += dts[t] * da;
      }
    }
    const float dAb = xor_sum(dal, 1, 32);
    if (lane == 0) {   // dA itself, or its partial (summed at the end)
      const int nbc = p.Bsz * p.nc;
      if (nbc == 1) p.dA[h] = dAb;
      else p.dAp[(long long)h * nbc + bc] = dAb;
    }
  }

  __syncthreads();   // the tiles consumed: the fp32 dB and dC go over them
  SSD_BWD_STAMP(9);
  put_rows<NC>(dbh, DBs + sr * FP, lane);
  put_rows<NC>(dca, DCs + sr * FP, lane);

  // ---- dB and dC summed over the cluster's heads: rank r sums its rows
  // over the blocks in rank order ---------------------------------------
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  SSD_BWD_STAMP(10);
  const int G = p.G, rank = (int)cluster.block_rank();
  const int ncl = H / G, ci = h / G;
  const int r0 = rank * Q / G, r1 = (rank + 1) * Q / G;
  const int n4 = N / 4;
  const int items = (r1 - r0) * n4;
  const long long rows_all = (long long)p.Bsz * ncl * p.S;   // one partial plane
#pragma unroll 2
  for (int i = tid; i < 2 * items; i += NT) {
    const int which = i >= items;
    const int j = i - which * items;
    const int row = r0 + j / n4, col = 4 * (j - (j / n4) * n4);
    const float* src = (which ? DCs : DBs) + row * FP + col;
    float4 v[8];   // every rank's piece first, then the sum in rank order
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (k < G) v[k] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(src, k));
    float4 sum = v[0];
#pragma unroll
    for (int k = 1; k < 8; ++k)
      if (k < G) add4(sum, v[k]);
    const long long at = (b * (long long)p.S + s0 + row) * N + col;
    if (ncl == 1) {
      store_bf16x4((which ? p.dC : p.dB) + at, sum);
    } else {
      *reinterpret_cast<float4*>(
          p.part + ((which * rows_all + (b * (long long)ncl + ci) * p.S + s0 + row) * N + col)) =
          sum;
    }
  }
  cluster.sync();    // no block leaves while another reads its shared memory
  SSD_BWD_STAMP(11);
  const int nbc = p.Bsz * p.nc;
  if (ncl == 1 && nbc == 1) return;

  // ---- the last block of a head to arrive sums dA's partials over (b, c)
  // in order; the last cluster of (b, c) sums the clusters' dB and dC
  // partials in cluster order, rank by rank -------------------------------
  __threadfence();
  __syncthreads();
  int* arrive = p.cnt + (long long)bc * G + rank;
  if (tid == 0 && ncl > 1) is_last = atomicAdd(arrive, 1) == ncl - 1;
  if (tid == 32 && nbc > 1) {
    int* arrive_h = p.cnt + (long long)nbc * G + h;
    if (atomicAdd(arrive_h, 1) == nbc - 1) {
      __threadfence();
      float sum = 0.f;
      for (int i = 0; i < nbc; ++i) sum += __ldcg(p.dAp + (long long)h * nbc + i);
      p.dA[h] = sum;
      *arrive_h = 0;
    }
  }
  __syncthreads();
  if (ncl == 1 || !is_last) return;
  __threadfence();
  for (int i = tid; i < 2 * items; i += NT) {
    const int which = i >= items;
    const int j = i - which * items;
    const int row = r0 + j / n4, col = 4 * (j - (j / n4) * n4);
    const float* src = p.part + (which * rows_all + b * (long long)ncl * p.S + s0 + row) * N + col;
    float4 sum = __ldcg(reinterpret_cast<const float4*>(src));
    for (int k = 1; k < ncl; ++k)
      add4(sum, __ldcg(reinterpret_cast<const float4*>(src + (long long)k * p.S * N)));
    store_bf16x4((which ? p.dC : p.dB) + (b * (long long)p.S + s0 + row) * N + col, sum);
  }
  SSD_BWD_STAMP(12);
  if (tid == 0) *arrive = 0;
}

template <int P, int NC>
cudaError_t launch_mma(const MmaParams& p, int grid, cudaStream_t stream) {
  static std::atomic<unsigned long long> done{0};
  constexpr size_t smem = mma_smem_bytes(P, NC);
  cudaError_t err = allow_smem(ssd_chunk_bwd_mma<P, NC>, smem, done);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ssd_chunk_bwd_mma<P, NC>, p);
  if (err == cudaSuccess)
    g_last_kernel = P == 32 ? "ssd_chunk_bwd_mma<bf16,32>" : "ssd_chunk_bwd_mma<bf16,64>";
  return err;
}

// what the tensor-core kernel takes on the card with clusters of G
// blocks: out[0] dynamic shared memory (bytes), out[1] resident blocks per
// SM, out[2] clusters resident at once, out[3] registers a thread, out[4]
// local memory a thread (bytes; spills)
template <int P, int NC>
cudaError_t mma_info(int G, int* out) {
  static std::atomic<unsigned long long> done{0};
  constexpr size_t smem = mma_smem_bytes(P, NC);
  cudaError_t err = allow_smem(ssd_chunk_bwd_mma<P, NC>, smem, done);
  if (err != cudaSuccess) return err;
  out[0] = (int)smem;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], ssd_chunk_bwd_mma<P, NC>, NT,
                                                      smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(&out[2], ssd_chunk_bwd_mma<P, NC>, &cfg);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, ssd_chunk_bwd_mma<P, NC>);
  out[3] = fa.numRegs;
  out[4] = (int)fa.localSizeBytes;
  return err;
}

}  // namespace

// dtype (of x, B and C): 0 = float32, 1 = bfloat16; dt, A, cum, dy,
// dstates and dcum are float32 (cum, dy, dstates, dcum contiguous).
// Strides are in elements. Outputs dx (B,S,H,P), ddt (B,S,H), dA (H), dB
// and dC (B,S,N) are contiguous fp32; scratch holds 2*B*H*S*N + B*H*nc
// floats. Two launches on `stream` (the SIMT kernel, then the reduce).
// Returns the cudaError_t of the first failure (0 = success).
extern "C" int repro_ssd_chunk_bwd(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* cum, const void* dy, const void* dstates,
    const void* dcum, void* dx, void* ddt, void* dA, void* dB, void* dC,
    void* scratch,
    long long xb, long long xs, long long xh,
    long long db, long long ds, long long dh,
    long long bb, long long bs, long long cb, long long cs,
    int Bsz, int S, int H, int P, int N, int Q, int dtype, void* stream) {
  if (Q < 1 || Q > QT || S % Q != 0 || N < 1 || H < 1 || Bsz < 1)
    return (int)cudaErrorInvalidValue;
  const int nc = S / Q;
  const long long grid = (long long)Bsz * H * nc;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  float* sc = static_cast<float*>(scratch);
  const long long part = (long long)Bsz * H * S * N;
  Params p{x, static_cast<const float*>(dt), static_cast<const float*>(A),
           Bm, Cm, static_cast<const float*>(cum), static_cast<const float*>(dy),
           static_cast<const float*>(dstates), static_cast<const float*>(dcum),
           static_cast<float*>(dx), static_cast<float*>(ddt), sc, sc + part,
           sc + 2 * part, xb, xs, xh, db, ds, dh, bb, bs, cb, cs,
           S, H, N, Q, nc};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0   ? launch_p<float>(p, P, (int)grid, st)
                    : dtype == 1 ? launch_p<__nv_bfloat16>(p, P, (int)grid, st)
                                 : cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  const long long threads = (long long)Bsz * S * N + H;
  const long long rgrid = (threads + 255) / 256;
  if (rgrid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ssd_chunk_bwd_reduce<<<(int)rgrid, 256, 0, st>>>(
      p.dBp, p.dCp, p.dAp, static_cast<float*>(dB), static_cast<float*>(dC),
      static_cast<float*>(dA), Bsz, S, H, N, nc);
  return (int)cudaGetLastError();
}

// bf16 x, B and C on the tensor cores (ssd_chunk_bwd_mma; rows on 16
// bytes, N a multiple of 8 up to 128), one launch in clusters of G heads
// (G divides H, at most 8). dt, A, cum and the cotangents dy, dstates and
// dcum are float32, read through `strides` (elements): x (3), dt (3), B
// (2), C (2), cum (4), dy (5), dstates (5), dcum (4). Outputs, contiguous:
// dx (B,S,H,P) and dB, dC (B,S,N) bf16, ddt (B,S,H) and dA (H) fp32.
// `part` holds 2*B*(H/G)*S*N floats when H > G, `dAp` H*B*(S/Q) when
// B*(S/Q) > 1 (else either may be null); `cnt` B*(S/Q)*G + H ints, zero
// on entry and left zero. Returns the cudaError_t of the launch.
extern "C" int repro_ssd_chunk_bwd_mma(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* cum, const void* dy, const void* dstates,
    const void* dcum, void* dx, void* ddt, void* dA, void* dB, void* dC,
    void* part, void* dAp, void* cnt, const long long* strides,
    int Bsz, int S, int H, int P, int N, int Q, int G, void* stream) {
  if (Q < 1 || Q > QT || S % Q != 0 || N < 8 || N > NMAX || N % 8 || H < 1 || Bsz < 1 ||
      G < 1 || G > 8 || H % G)
    return (int)cudaErrorInvalidValue;
  const int nc = S / Q;
  const long long grid = (long long)Bsz * H * nc;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if ((H > G && part == nullptr) || (Bsz * nc > 1 && dAp == nullptr) || cnt == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long* s = strides;
  MmaParams p{static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
              static_cast<const float*>(A), static_cast<const __nv_bfloat16*>(Bm),
              static_cast<const __nv_bfloat16*>(Cm), static_cast<const float*>(cum),
              static_cast<const float*>(dy), static_cast<const float*>(dstates),
              static_cast<const float*>(dcum), static_cast<__nv_bfloat16*>(dx),
              static_cast<float*>(ddt), static_cast<float*>(dA),
              static_cast<__nv_bfloat16*>(dB), static_cast<__nv_bfloat16*>(dC),
              static_cast<float*>(part), static_cast<float*>(dAp), static_cast<int*>(cnt),
              s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9],
              s[10], s[11], s[12], s[13],
              s[14], s[15], s[16], s[17], s[18],
              s[19], s[20], s[21], s[22], s[23],
              s[24], s[25], s[26], s[27],
              Bsz, S, H, N, Q, nc, G, 0};
  // float4 loads of dy and dS: unit column stride, every other stride a
  // multiple of 4 elements, the base on 16 bytes
  const bool dy4 = s[18] == 1 && (s[14] | s[15] | s[16] | s[17]) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  const bool ds4 = s[23] == 1 && (s[19] | s[20] | s[21] | s[22]) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(dstates) % 16 == 0;
  p.vec = dy4 && ds4;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool narrow = N <= 64;   // the tiles hold 64 or 128 state dims
  switch (P) {
    case 32: return (int)(narrow ? launch_mma<32, 64>(p, (int)grid, st)
                                 : launch_mma<32, 128>(p, (int)grid, st));
    case 64: return (int)(narrow ? launch_mma<64, 64>(p, (int)grid, st)
                                 : launch_mma<64, 128>(p, (int)grid, st));
  }
  return (int)cudaErrorInvalidValue;
}

// The tensor-core kernel's resources at (P, N) in clusters of G:
// out[0..4] = dynamic shared memory bytes, resident blocks per SM,
// clusters resident at once, registers a thread, local (spill) bytes a
// thread. Returns the cudaError_t of the queries.
extern "C" int repro_ssd_chunk_bwd_mma_info(int P, int N, int G, int* out) {
  if (N < 8 || N > NMAX || G < 1 || G > 8) return (int)cudaErrorInvalidValue;
  const bool narrow = N <= 64;
  switch (P) {
    case 32: return (int)(narrow ? mma_info<32, 64>(G, out) : mma_info<32, 128>(G, out));
    case 64: return (int)(narrow ? mma_info<64, 64>(G, out) : mma_info<64, 128>(G, out));
  }
  return (int)cudaErrorInvalidValue;
}

// The name of the kernel the last successful launch ran.
extern "C" const char* repro_ssd_chunk_bwd_last_kernel() { return g_last_kernel; }

#ifdef SSD_BWD_PHASES
// Where the stamped build writes its phase stamps (see SSD_BWD_STAMP).
extern "C" int repro_ssd_chunk_bwd_set_stamps(void* buf) {
  return (int)cudaMemcpyToSymbol(g_stamps, &buf, sizeof(buf));
}
#endif
