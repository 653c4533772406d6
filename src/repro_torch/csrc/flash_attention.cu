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
// Grid: x = b*H + h, y = 64-row query tile. 128 threads per block; thread
// t owns query rows 4*(t/8)..+3 of the tile, score columns (t%8) + 8j of
// each 64-key tile, and output columns (t%8) + 8c. Row reductions are
// shuffles inside the 8 lanes that share a row group.
//
// Bound on the card: at the serving shape (B=8, S=512, H=9, KV=3, D=64,
// bf16, causal) the kernel must move ~12.6 MB (q, k, v read once, o
// written once) and do ~2.4 GFLOP, i.e. ~3.8 us at 3.35 TB/s: memory
// bound. This first version is far from that: it stages K/V tiles as
// fp32 in shared memory and does scalar fp32 FMAs (no tensor cores), so
// it is bound by shared-memory loads in the two inner products. What the
// design does about the bound: each K/V tile is read from device memory
// once per 64 query rows and reused from shared memory, tiles entirely in
// the future (causal) or before the window are skipped, and scores and
// probabilities never leave the SM. wgmma/TMA is later work.
//
// Numerics follow the reference: q is scaled in fp32 before the product,
// masked scores are -1e30, p = 0 where masked, fp32 running max / sum /
// accumulator, expf (no fast math), output cast with round-to-nearest.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per k-tile
constexpr int NT = 128;      // threads per block
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
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

template <typename T, int D>
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

  const T* qg = static_cast<const T*>(p.q) + b * p.qb + h * p.qh;
  const T* kg = static_cast<const T*>(p.k) + b * p.kb + kvh * p.kh;
  const T* vg = static_cast<const T*>(p.v) + b * p.vb + kvh * p.vh;
  T* og = static_cast<T*>(p.o) + b * p.ob + h * p.oh;

  for (int i = tid; i < BQ * D; i += NT) {
    const int row = i / D, d = i - (i / D) * D;
    const int s = q0 + row;
    Qs[row * DP + d] = s < p.S ? to_f(qg[s * p.qs + d]) * p.scale : 0.f;
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
      Ks[row * DP + d] = in ? to_f(kg[t * p.kt + d]) : 0.f;
      Vs[row * D + d] = in ? to_f(vg[t * p.vt + d]) : 0.f;
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
      og[row * p.os + c + 8 * cc] = from_f<T>(acc[i][cc] / li);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.H, (p.S + BQ - 1) / BQ);
  fa_fwd<T, D><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Params& p, int D, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64>(p, stream);
    case 80: return launch<T, 80>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. Returns the
// cudaError_t of the launch (0 = success).
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    long long qb, long long qs, long long qh,
    long long kb, long long kt, long long kh,
    long long vb, long long vt, long long vh,
    long long ob, long long os, long long oh,
    int B, int S, int T, int H, int KV, int D, int dtype,
    int causal, int window, int q_offset, float scale, void* stream) {
  Params p{q, k, v, o, qb, qs, qh, kb, kt, kh, vb, vt, vh, ob, os, oh,
           B, S, T, H, KV, causal, window, q_offset, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_d<float>(p, D, st);
  if (dtype == 1) return (int)dispatch_d<__nv_bfloat16>(p, D, st);
  return (int)cudaErrorInvalidValue;
}
