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
// One block of 256 threads per (b, h, chunk), grid B*H*nc. Shared memory:
// the fp32 x tile (128 x P), the Q x Q score tile, and B and C staged in
// slices of 32 state dims, which keeps the block at ~131 KB (P = 64)
// instead of the ~224 KB that whole fp32 B and C tiles would take. For
// each slice the block accumulates C B^T into per-thread 8x8 register
// tiles and writes that slice's 32 rows of the chunk state; then it
// applies mask, decay and dt to the scores and multiplies by x.
//
// Bound on the card: at the serving shape (B=8, S=512, H=24, P=64, N=128,
// Q=128, bf16) the call must move ~65.8 MB, of which the two fp32 outputs
// are 25.2 MB each, and needs ~2.5 GFLOP (lower triangles only, C B^T once
// per batch and chunk): ~20 us at 3.35 TB/s, memory bound. This first
// version does scalar fp32 FMAs from shared memory (no tensor cores), so
// it is bound by shared-memory loads and FMA issue, far from that bound.
// What the design does about the bound: every input element is read from
// device memory once, the score tile never leaves the SM, and each output
// is written once.
//
// Numerics follow the reference: fp32 throughout, masked scores are 0
// (exp of -1e30), expf (no fast math). The within-chunk cumsum is
// sequential (one thread, ~Q dependent adds), in the order of the plain
// versions' cumsum: with the model's step sizes cum reaches -1e3 within a
// chunk, so exp(cum_t - cum_s) amplifies any difference in its rounding.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libssd_chunk.so ssd_chunk.cu
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int QT = 128;      // chunk rows a block covers (Q <= QT)
constexpr int NS = 32;       // state dims per staged slice of B and C
constexpr int NT = 256;      // threads per block
constexpr int QP = QT + 1;   // padded row stride of the score tile
constexpr int NSP = NS + 1;  // padded row stride of the B/C slices

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

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

template <int P>
constexpr size_t smem_bytes() {
  return sizeof(float) * (QT * P + QT * QP + 2 * QT * NSP + 3 * QT);
}

template <typename T, int P>
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

  const T* xg = static_cast<const T*>(p.x) + b * p.xb + s0 * p.xs + h * p.xh;
  const float* dg = p.dt + b * p.db + s0 * p.ds + h * p.dh;
  const T* bg = static_cast<const T*>(p.Bm) + b * p.bb + s0 * p.bs;
  const T* cg = static_cast<const T*>(p.Cm) + b * p.cb + s0 * p.cs;
  const long long row = (long long)bh * p.nc + c;   // index over (B, H, nc)
  float* yg = p.y + row * Q * P;
  float* sg = p.st + row * p.N * P;
  float* cumg = p.cum + row * Q;

  const float A = p.A[h];
  for (int i = tid; i < QT; i += NT) dts[i] = i < Q ? dg[i * p.ds] : 0.f;
  for (int i = tid; i < QT * P; i += NT) {
    const int t = i / P, col = i - (i / P) * P;
    Xs[i] = t < Q ? to_f(xg[t * p.xs + col]) : 0.f;
  }
  __syncthreads();

  // cum = inclusive cumsum of dt*A, sequential in fp32 with the product
  // rounded first (no FMA contraction): the order of a sequential
  // torch.cumsum, so cum_t - cum_s, whose cancellation dominates the
  // error when cum is large, matches the plain versions bit for bit.
  if (tid == 0) {
    float run = 0.f;
#pragma unroll 8
    for (int i = 0; i < Q; ++i) {
      run = __fadd_rn(run, __fmul_rn(dts[i], A));
      cums[i] = run;
    }
  }
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
      Cs[t * NSP + col] = in ? to_f(cg[t * p.cs + n]) : 0.f;
      Bs[t * NSP + col] = in ? to_f(bg[t * p.bs + n]) : 0.f;
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

template <typename T, int P>
cudaError_t launch(const Params& p, int grid, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<P>();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ssd_chunk<T, P><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_p(const Params& p, int P, int grid, cudaStream_t stream) {
  switch (P) {
    case 32: return launch<T, 32>(p, grid, stream);
    case 64: return launch<T, 64>(p, grid, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (of x, B and C): 0 = float32, 1 = bfloat16; dt and A are float32.
// Strides are in elements. Outputs y (B,H,nc,Q,P), states (B,H,nc,N,P) and
// cum (B,H,nc,Q) are contiguous fp32. Returns the cudaError_t of the launch
// (0 = success).
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
  if (dtype == 0) return (int)dispatch_p<float>(p, P, (int)grid, st);
  if (dtype == 1) return (int)dispatch_p<__nv_bfloat16>(p, P, (int)grid, st);
  return (int)cudaErrorInvalidValue;
}
