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
// Two kernels, launched back to back on one stream, each a thread block
// of 128 threads that owns 32 rows of its output in registers and streams
// 64-row tiles of the other side through shared memory:
//
// * fa_bwd_dq<T, D>: grid (B*H, S/32). Computes delta for its 32 query
//   rows from the O and dO tiles, writes it to the fp32 (B, H, S) scratch
//   that the second kernel reads, then loops over the 64-key tiles its rows
//   can see (the forward's causal / window tile bounds) for dQ.
// * fa_bwd_dkdv<T, D>: grid (B*KV, T/32). Loops over the H/KV query heads
//   of its KV head and, for each, over the 64-row query tiles that can see
//   one of its 32 keys, accumulating dK and dV for the whole group in
//   registers: the GQA sum needs no atomics.
//
// Every output element is written once by one thread after a fixed-order
// sum, so two calls give the same bits. Tiles are fp32 in shared memory
// (bf16 inputs are widened as they are loaded), rows padded by one float so
// the 32 lanes that read 32 rows of one column hit 32 banks; scores,
// probabilities and dS never leave the SM. Products are scalar fp32 FMAs:
// a simple SIMT kernel, right first (mma.sync, wgmma and TMA are later
// work). Outputs are in the input dtype, rounded once from fp32.
//
// Bound on the card: at smollm-135m's training shape (B=2, S=T=256, H=9,
// KV=3, D=64, bf16, causal) the call must read q, k, v, o, dO and lse and
// write dq, dk, dv, ~3.2 MB (~0.95 us at 3.35 TB/s), and do five products
// over the visible pairs, 10 B H S T D / 2 = 0.38 GFLOP (~0.4 us at the
// bf16 tensor-core peak): memory bound.
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
  void* dq;
  void* dk;
  void* dv;
  long long st[NSTRIDES];
  int B, S, T, H, KV;
  int causal, window, q_offset;
  float scale;
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for q, k, v, o, dout, dq, dk, dv alike.
// `strides` holds NSTRIDES element strides, (B, row, head) of each tensor
// in the order q, k, v, o, dout, dq, dk, dv (last dims contiguous). lse and
// delta are contiguous fp32 (B, H, S). Launches fa_bwd_dq then fa_bwd_dkdv
// on `stream`; returns the cudaError_t of the launches (0 = success).
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, const long long* strides, int B, int S, int T, int H, int KV,
    int D, int dtype, int causal, int window, int q_offset, float scale,
    void* stream) {
  Params p{q, k, v, o, dout, lse, delta, dq, dk, dv, {}, B, S, T, H, KV,
           causal, window, q_offset, scale};
  for (int i = 0; i < NSTRIDES; ++i) p.st[i] = strides[i];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (D) {
      case 64: return (int)launch<float, 64>(p, st, "fa_bwd<f32,64>");
      case 80: return (int)launch<float, 80>(p, st, "fa_bwd<f32,80>");
      case 128: return (int)launch<float, 128>(p, st, "fa_bwd<f32,128>");
    }
  } else if (dtype == 1) {
    switch (D) {
      case 64:
        return (int)launch<__nv_bfloat16, 64>(p, st, "fa_bwd<bf16,64>");
      case 80:
        return (int)launch<__nv_bfloat16, 80>(p, st, "fa_bwd<bf16,80>");
      case 128:
        return (int)launch<__nv_bfloat16, 128>(p, st, "fa_bwd<bf16,128>");
    }
  }
  return (int)cudaErrorInvalidValue;
}

// The name of the kernels the last successful call ran.
extern "C" const char* repro_flash_attention_bwd_last_kernel() {
  return g_last_kernel;
}
