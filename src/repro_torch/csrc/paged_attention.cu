// Paged (block-table) decode attention for Hopper (sm_90a): one new token
// per request against a shared KV block pool, GQA, ring-buffer views,
// sliding window, fully masked rows -> 0.
//
// Replaces the Pallas TPU kernel
// repro/kernels/paged_attention.py::_paged_attention_pallas (_pa_kernel).
// Computes what it computes, not a block-by-block copy: the TPU kernel
// scalar-prefetches the block table, walks a sequential grid axis over a
// request's table (one pool block DMA'd into VMEM per step) and carries m,
// l and the accumulator in VMEM scratch across that axis. Here one thread
// block takes one (request, KV head), loads its own table entries and
// loops over them; the running max, sum and accumulator of the head's
// `group` query heads stay in shared memory for the whole loop.
//
// Layout: q (R, 1, H, D) read through its strides over (R, H), last dim
// contiguous; pools (NB, bs, KV, D) contiguous; block tables (R, nb) and
// lengths (R,) int32 contiguous; o (R, 1, H, D) contiguous. Slot
// i = j*bs + t of request r lives at pool[tables[r, j], t]. After `length`
// writes (the current token included) slot i holds position
// pos = i + T*((length-1-i) // T), T = nb*bs; it is valid iff i < length
// and, with a window, pos > length-1-window (_pa_kernel's ring rule). A
// pool block none of whose slots is valid is not read at all: the TPU
// kernel reads it and masks every slot, which gives the same result.
//
// Per pool block: 128 threads stage its K and V rows of this KV head as
// fp32 in shared memory (row stride D+1 for K, so the slot-per-thread
// score loop hits distinct banks); one thread per (query head, slot)
// computes a score with scalar fp32 FMAs; one warp per query head updates
// the online softmax; one thread per (query head, column) rescales and
// accumulates P V.
//
// Bound on the card: the call must read each request's K and V view once
// (R * nb*bs * KV * D * 2 * itemsize bytes) plus q and o; 4 * D operations
// per (query head, slot) are far below the fp32 rate, so it is memory
// bound (smollm's serving shape, R=8, view 576, KV=3, D=64, bf16: 3.54 MB
// of K and V, ~1.06 us at 3.35 TB/s). This first version is far from
// that: a grid of R*KV blocks (24 for smollm) leaves most of the 132 SMs
// idle, the loads are 2-byte scalar loads, and a block's loads, scores
// and accumulation run one after the other. Split-K over the table
// (flash-decoding) and 16-byte loads are the later redesign; PERF.md has
// the measured times.
//
// Numerics follow the TPU kernel: q is upcast and scaled by D**-0.5 in
// fp32, K and V are upcast to fp32, masked scores are -1e30 and their
// probabilities exactly 0, fp32 running max / sum / accumulator, expf (no
// fast math), l == 0 -> 1 so a row with no valid slot gives 0, output cast
// with round-to-nearest. q and the pools may differ in dtype (fp32 compute
// over a bf16 pool).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libpaged_attention.so paged_attention.cu
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;      // threads per block
constexpr int MAX_BS = 64;   // slots per pool block (<= NT)
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

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
  const int* tables;      // (R, nb)
  const int* lengths;     // (R,)
  long long qr, qh;       // element strides of q over (R, H)
  int R, H, KV, bs, nb, window;
  float scale;
};

// Slot i of a T-slot ring after `length` writes: written, and inside the
// window of the query at position length-1.
__device__ __forceinline__ bool slot_valid(int i, int length, int T, int window) {
  if (i >= length) return false;
  if (window <= 0) return true;
  const int pos = i + T * ((length - 1 - i) / T);   // length-1-i >= 0 here
  return pos > length - 1 - window;
}

__host__ __device__ constexpr size_t smem_floats(int D, int group, int bs) {
  // Qs, Acc: group x D; Ks: bs x (D+1); Vs: bs x D; Ss: group x bs;
  // m, l, alpha: group each
  return (size_t)2 * group * D + (size_t)bs * (D + 1) + (size_t)bs * D +
         (size_t)group * bs + (size_t)3 * group;
}

template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(NT) pa_decode(const Params p) {
  constexpr int DP = D + 1;
  extern __shared__ float smem[];
  const int group = p.H / p.KV;
  const int bs = p.bs;
  float* Qs = smem;                 // group x D, scaled fp32 queries
  float* Acc = Qs + group * D;      // group x D, unnormalised output
  float* Ks = Acc + group * D;      // bs x DP
  float* Vs = Ks + bs * DP;         // bs x D
  float* Ss = Vs + bs * D;          // group x bs: scores, then probabilities
  float* Ms = Ss + group * bs;      // group: running max
  float* Ls = Ms + group;           // group: running sum
  float* As = Ls + group;           // group: this block's rescale

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int r = blockIdx.x / p.KV;
  const int kvh = blockIdx.x - r * p.KV;
  const int length = p.lengths[r];
  const int T = p.nb * bs;
  const long long slot_stride = (long long)p.KV * D;   // pool elements per slot

  const QT* qg = static_cast<const QT*>(p.q) + r * p.qr + (long long)kvh * group * p.qh;
  for (int i = tid; i < group * D; i += NT) {
    const int g = i / D, d = i - g * D;
    Qs[i] = to_f(qg[g * p.qh + d]) * p.scale;
    Acc[i] = 0.f;
  }
  for (int g = tid; g < group; g += NT) {
    Ms[g] = NEG;
    Ls[g] = 0.f;
  }

  const KT* kpool = static_cast<const KT*>(p.k);
  const KT* vpool = static_cast<const KT*>(p.v);
  const int* bt = p.tables + (long long)r * p.nb;
  for (int j = 0; j < p.nb; ++j) {
    // also the barrier that orders the previous block's reads of Ks, Vs
    // and Ss before this block's writes (and the set-up before block 0)
    const int live = __syncthreads_or(tid < bs && slot_valid(j * bs + tid, length, T, p.window));
    if (!live) continue;
    const long long base = (long long)bt[j] * bs * slot_stride + (long long)kvh * D;
    for (int i = tid; i < bs * D; i += NT) {
      const int t = i / D, d = i - t * D;
      const long long off = base + t * slot_stride + d;
      Ks[t * DP + d] = to_f(kpool[off]);
      Vs[t * D + d] = to_f(vpool[off]);
    }
    __syncthreads();

    for (int i = tid; i < group * bs; i += NT) {
      const int g = i / bs, t = i - g * bs;
      const float* qrow = Qs + g * D;
      const float* krow = Ks + t * DP;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(qrow[d], krow[d], s);
      Ss[i] = slot_valid(j * bs + t, length, T, p.window) ? s : NEG;
    }
    __syncthreads();

    for (int g = warp; g < group; g += NT / 32) {
      float* srow = Ss + g * bs;
      float mx = NEG;
      for (int t = lane; t < bs; t += 32) mx = fmaxf(mx, srow[t]);
#pragma unroll
      for (int o = 16; o; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      const float m_old = Ms[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < bs; t += 32) {
        const float pt = slot_valid(j * bs + t, length, T, p.window)
                             ? expf(srow[t] - m_new) : 0.f;
        srow[t] = pt;
        sum += pt;
      }
#pragma unroll
      for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        As[g] = alpha;
        Ls[g] = Ls[g] * alpha + sum;
        Ms[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < group * D; i += NT) {
      const int g = i / D, d = i - g * D;
      const float* prow = Ss + g * bs;
      float a = Acc[i] * As[g];
#pragma unroll 4
      for (int t = 0; t < bs; ++t) a = fmaf(prow[t], Vs[t * D + d], a);
      Acc[i] = a;
    }
  }
  __syncthreads();   // Ls written by another warp when the last block was live

  QT* og = static_cast<QT*>(p.o) + (long long)r * p.H * D + (long long)kvh * group * D;
  for (int i = tid; i < group * D; i += NT) {
    const float l = Ls[i / D];
    og[i] = from_f<QT>(Acc[i] / (l == 0.f ? 1.f : l));
  }
}

template <typename QT, typename KT, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(D, p.H / p.KV, p.bs);
  cudaError_t err = cudaFuncSetAttribute(
      pa_decode<QT, KT, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  pa_decode<QT, KT, D><<<p.R * p.KV, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename QT, typename KT>
cudaError_t dispatch_d(const Params& p, int D, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<QT, KT, 64>(p, stream);
    case 80: return launch<QT, KT, 80>(p, stream);
    case 128: return launch<QT, KT, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Shared memory one block needs, in bytes (the wrapper refuses a call
// above the card's 227 KB).
extern "C" long long repro_paged_attention_smem(int D, int group, int bs) {
  return (long long)(sizeof(float) * smem_floats(D, group, bs));
}

// dtypes: 0 = float32, 1 = bfloat16 (q and o share one; the pools the
// other). Strides are in elements. Returns the cudaError_t of the launch
// (0 = success).
extern "C" int repro_paged_attention(
    const void* q, const void* k, const void* v, void* o,
    const int* tables, const int* lengths, long long qr, long long qh,
    int R, int H, int KV, int D, int bs, int nb, int window, float scale,
    int q_dtype, int kv_dtype, void* stream) {
  if (bs < 1 || bs > MAX_BS || KV < 1 || H % KV) return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, tables, lengths, qr, qh, R, H, KV, bs, nb, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0) return (int)dispatch_d<float, float>(p, D, st);
  if (q_dtype == 0 && kv_dtype == 1) return (int)dispatch_d<float, __nv_bfloat16>(p, D, st);
  if (q_dtype == 1 && kv_dtype == 0) return (int)dispatch_d<__nv_bfloat16, float>(p, D, st);
  if (q_dtype == 1 && kv_dtype == 1)
    return (int)dispatch_d<__nv_bfloat16, __nv_bfloat16>(p, D, st);
  return (int)cudaErrorInvalidValue;
}
