// Paged (block-table) decode attention for Hopper (sm_90a), split over the
// table (flash-decoding): one new token per request against a shared KV
// block pool, GQA, ring-buffer views, sliding window, rows with no valid
// slot -> 0.
//
// Replaces the Pallas TPU kernel
// repro/kernels/paged_attention.py::_paged_attention_pallas (_pa_kernel).
// Computes the function of the gather path that the reference's engine
// runs (models/layers.py::cache_attention), not a block-by-block copy: the
// TPU kernel walks a sequential grid axis over a request's table and
// carries m, l and the accumulator in VMEM across it. Here each request's
// table is cut into splits of `bps` pool blocks, and a (request, KV head,
// split) is one thread block, so R * KV * splits blocks fill the card
// (the wrapper picks bps so that there are at least four per SM).
//
// Layout: q (R, 1, H, D) read through its strides over (R, H), last dim
// contiguous; pools (NB, bs, KV, D) contiguous, 16-byte aligned; block
// tables (R, nb) int32 and lengths (R,) int32 or int64 (the engine's),
// contiguous; o (R, 1, H, D) contiguous. Slot i = j*bs + t of request r lives at
// pool[tables[r, j], t]. After `length` writes (the current token
// included) the valid slots are those of positions
// [length - n, length - 1], n = min(length, window or T), T = nb*bs (the
// ring rule of _pa_kernel: slot i holds i + T*((length-1-i) // T)). A
// pool block with no valid slot is not read at all.
//
// Two launches on the stream, one call:
//   pa_scores: per block, the split's K rows of the KV head come in by
//     16-byte cp.async copies as stored (bf16 or fp32), in two stages
//     (the next live pool block loads while this one is scored); 4 lanes
//     per (query head, slot) dot the rounded q against a K row; the
//     scores go to a scratch row (R, H, T) and the split's max and sum
//     (online over its pool blocks) to (R, H, splits). The `group` query
//     heads of the KV head share every K load.
//   pa_pv: per block, merges all splits' (m, l) of its heads in split
//     order, forms p = round_pool(exp(s - m) / l) from the scores, and
//     accumulates p V over its split's V rows (cp.async, two stages) in
//     fp32 into a partial (R, H, splits, D). The last block of each
//     (request, KV head) to arrive (an atomic counter, reset by
//     pa_scores) sums the partials in split order and writes o. No float
//     atomics: the result does not depend on block timing.
//
// Bound on the card: the call must read each request's K and V view once
// (R * nb*bs * KV * D * 2 * itemsize bytes) plus q and o; 4 * D operations
// per (query head, slot) are far below any peak rate, so it is memory
// bound (smollm's serving shape, R=8, view 576, KV=3, D=64, bf16: 3.54 MB
// of K and V, ~1.06 us at 3.35 TB/s). What the design does about it: K
// and V are read once each, 16 bytes a thread, with the copy of the next
// pool block in flight; enough blocks to keep every SM loading; the
// scores (R*H*T fp32) and partials are small beside K and V and stay in
// L2 between the two launches. Two launches cost two launch latencies,
// which at these sizes is most of the time; PERF.md has the times.
//
// Numerics are the gather path's (ref.paged_attention_ref), which departs
// from _pa_kernel: the scaled q is rounded to q's dtype and then to the
// pool dtype; logits are fp32 dot products of the rounded values; masked
// logits are -1e30 and their probabilities exactly 0; the probabilities
// are exp(s - m) / l in fp32 over the row's global max m and sum l,
// rounded to the pool dtype before PV; PV accumulates in fp32 and the
// output is rounded to q's dtype. This is where the reference's dense
// decode rounds, which its engine is held to (tests/test_serving.py);
// _pa_kernel keeps q and p in fp32. With fp32 q and pools the two
// coincide. A row with no valid slot gives 0 (_pa_kernel's l == 0 -> 1;
// the gather path would give the mean of V; the engine never asks).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libpaged_attention.so paged_attention.cu
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

#include "sm90_common.cuh"

namespace {

constexpr int NT = 128;          // threads per block
constexpr int MAX_BS = 64;       // slots per pool block
constexpr int LPP = 4;           // lanes per (query head, slot) score
constexpr int SMEM_MAX = 232448; // bytes a block may use on an H100
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// the 16 bytes at `src` (shared memory) as floats
__device__ __forceinline__ void load_chunk(const float* src, float (&out)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* src, float (&out)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {     // a bf16 is the top half of its float
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* tables;      // (R, nb)
  const void* lengths;    // (R,), int64 if lengths64 else int32
  float2* ml;             // (R, H, splits): each split's max and sum
  float* part;            // (R, H, splits, D): each split's P V
  float* scores;          // (R, H, T): logits of the live pool blocks
  int* arrivals;          // (R, KV): pa_pv blocks done
  long long qr, qh;       // element strides of q over (R, H)
  int R, H, KV, bs, nb, window, bps, splits, lengths64;
  float scale;
};

__device__ __forceinline__ int length_of(const Params& p, int r) {
  return p.lengths64 ? (int)static_cast<const long long*>(p.lengths)[r]
                     : static_cast<const int*>(p.lengths)[r];
}

// The valid slots of a T-slot ring after `length` writes: those of the
// positions [length - n, length - 1], i.e. slots lo..hi, wrapping past
// T - 1 when lo > hi.
struct Ring {
  int T, n, lo, hi;
  __device__ Ring(int length, int T_, int window) : T(T_) {
    n = min(length, window > 0 ? min(window, T) : T);
    lo = n > 0 ? (length - n) % T : 0;
    hi = n > 0 ? (length - 1) % T : 0;
  }
  __device__ bool valid(int i) const {
    if (n <= 0) return false;
    if (n >= T) return true;
    return lo <= hi ? (i >= lo && i <= hi) : (i >= lo || i <= hi);
  }
  // some slot of [a, b] is valid
  __device__ bool any(int a, int b) const {
    if (n <= 0) return false;
    if (n >= T) return true;
    return lo <= hi ? (b >= lo && a <= hi) : (b >= lo || a <= hi);
  }
};

// Shared memory: per query head of the block D + bs + 2 floats (q or the
// accumulator, scores or probabilities, m, l) and a flag, then two
// stages of bs rows padded by 16 bytes (so the rows a warp reads at one
// column fall on different banks).
__host__ __device__ constexpr size_t head_floats(int D, int group, int bs) {
  return ((size_t)group * (D + bs + 2) + 4 + 3) / 4 * 4;
}
__host__ __device__ constexpr size_t row_bytes(int D, int itemsize) {
  return (size_t)D * itemsize + 16;
}
__host__ __device__ constexpr size_t smem_bytes(int D, int group, int bs,
                                                int itemsize) {
  return sizeof(float) * head_floats(D, group, bs) +
         2 * (size_t)bs * row_bytes(D, itemsize);
}

// One block's place: request r, KV head kvh, pool blocks [j0, j1).
struct Place {
  int r, kvh, split, rk, j0, j1;
  __device__ explicit Place(const Params& p) {
    split = blockIdx.x % p.splits;
    rk = blockIdx.x / p.splits;
    r = rk / p.KV;
    kvh = rk - r * p.KV;
    j0 = split * p.bps;
    j1 = min(p.nb, j0 + p.bps);
  }
};

// the first pool block at or after j (before j1) holding a valid slot
__device__ __forceinline__ int next_live(const Ring& ring, int j, int j1, int bs) {
  while (j < j1 && !ring.any(j * bs, j * bs + bs - 1)) ++j;
  return j;
}

// pool block `block`'s bs rows of KV head kvh into a stage, 16 bytes a copy
template <typename KT, int D>
__device__ __forceinline__ void load_rows(unsigned char* stage, const KT* pool,
                                          int block, int kvh, const Params& p) {
  constexpr int CH = D * (int)sizeof(KT) / 16;
  constexpr int RB = (int)row_bytes(D, sizeof(KT));
  const KT* src = pool + ((long long)block * p.bs * p.KV + kvh) * D;
  for (int i = threadIdx.x; i < p.bs * CH; i += NT) {
    const int t = i / CH, c = i - t * CH;
    cp_async16(smem_u32(stage + t * RB + c * 16),
               src + (long long)t * p.KV * D + c * (16 / (int)sizeof(KT)), true);
  }
}

template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(NT) pa_scores(const Params p) {
  constexpr int E = 16 / (int)sizeof(KT);   // elements per 16-byte chunk
  constexpr int CH = D / E;
  constexpr int RB = (int)row_bytes(D, sizeof(KT));
  extern __shared__ __align__(16) unsigned char smem[];
  const int group = p.H / p.KV, bs = p.bs;
  float* Qs = reinterpret_cast<float*>(smem);   // group x D, rounded q
  float* Ss = Qs + group * D;                   // group x bs
  float* Ms = Ss + group * bs;                  // group: running max
  float* Ls = Ms + group;                       // group: running sum
  unsigned char* Ks = smem + sizeof(float) * head_floats(D, group, bs);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Place pl(p);
  const int T = p.nb * bs, h0 = pl.kvh * group;
  const Ring ring(length_of(p, pl.r), T, p.window);
  const int* bt = p.tables + (long long)pl.r * p.nb;
  const KT* kpool = static_cast<const KT*>(p.k);

  int j = next_live(ring, pl.j0, pl.j1, bs);
  if (j < pl.j1) load_rows<KT, D>(Ks, kpool, bt[j], pl.kvh, p);
  cp_async_commit();

  if (pl.split == 0 && tid == 0) p.arrivals[pl.rk] = 0;
  const QT* qg = static_cast<const QT*>(p.q) + pl.r * p.qr + (long long)h0 * p.qh;
  for (int i = tid; i < group * D; i += NT) {
    const int g = i / D, d = i - g * D;
    const QT qs = from_f<QT>(to_f(qg[g * p.qh + d]) * p.scale);
    Qs[i] = to_f(from_f<KT>(to_f(qs)));
  }
  for (int g = tid; g < group; g += NT) {
    Ms[g] = NEG;
    Ls[g] = 0.f;
  }

  float* sg = p.scores + ((long long)pl.r * p.H + h0) * T;
  const int pairs = group * bs;
  for (int st = 0; j < pl.j1; st ^= 1) {
    const int jn = next_live(ring, j + 1, pl.j1, bs);
    if (jn < pl.j1) load_rows<KT, D>(Ks + (st ^ 1) * bs * RB, kpool, bt[jn], pl.kvh, p);
    cp_async_commit();
    cp_async_wait<1>();
    // stage st landed; Qs, Ms, Ls set; the previous block's Ss consumed
    __syncthreads();

    const unsigned char* Kt = Ks + st * bs * RB;
    for (int base = 0; base < pairs; base += NT / LPP) {
      const int pr = base + tid / LPP, sub = tid % LPP;
      float s = 0.f;
      if (pr < pairs) {
        const int g = pr / bs, t = pr - g * bs;
        const float* qrow = Qs + g * D;
        const KT* krow = reinterpret_cast<const KT*>(Kt + t * RB);
        for (int c = sub; c < CH; c += LPP) {
          float kv[E];
          load_chunk(krow + c * E, kv);
#pragma unroll
          for (int e = 0; e < E; ++e) s = fmaf(qrow[c * E + e], kv[e], s);
        }
      }
      s += __shfl_xor_sync(FULL, s, 1);
      s += __shfl_xor_sync(FULL, s, 2);
      if (pr < pairs && sub == 0) {
        const int g = pr / bs, t = pr - g * bs, slot = j * bs + t;
        s = ring.valid(slot) ? s : NEG;
        Ss[g * bs + t] = s;
        sg[(long long)g * T + slot] = s;
      }
    }
    __syncthreads();

    // the split's running max and sum, one warp per query head
    for (int g = warp; g < group; g += NT / 32) {
      const float* srow = Ss + g * bs;
      float mx = NEG;
      for (int t = lane; t < bs; t += 32) mx = fmaxf(mx, srow[t]);
#pragma unroll
      for (int o = 16; o; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      const float m_old = Ms[g], m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < bs; t += 32)
        if (ring.valid(j * bs + t)) sum += expf(srow[t] - m_new);
#pragma unroll
      for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
      if (lane == 0) {
        Ls[g] = Ls[g] * expf(m_old - m_new) + sum;
        Ms[g] = m_new;
      }
    }
    j = jn;
  }
  __syncthreads();   // Ms, Ls written by lane 0 of each head's warp
  for (int g = tid; g < group; g += NT)
    p.ml[((long long)pl.r * p.H + h0 + g) * p.splits + pl.split] =
        make_float2(Ms[g], Ls[g]);
}

template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(NT) pa_pv(const Params p) {
  constexpr int E = 16 / (int)sizeof(KT);
  constexpr int CH = D / E;
  constexpr int RB = (int)row_bytes(D, sizeof(KT));
  extern __shared__ __align__(16) unsigned char smem[];
  const int group = p.H / p.KV, bs = p.bs;
  float* Acc = reinterpret_cast<float*>(smem);  // group x D
  float* Ps = Acc + group * D;                  // group x bs, rounded p
  float* Mg = Ps + group * bs;                  // group: the row's max
  float* Lg = Mg + group;                       // group: the row's sum
  int* last = reinterpret_cast<int*>(Lg + group);
  unsigned char* Vs = smem + sizeof(float) * head_floats(D, group, bs);

  const int tid = threadIdx.x;
  const Place pl(p);
  const int T = p.nb * bs, h0 = pl.kvh * group;
  const Ring ring(length_of(p, pl.r), T, p.window);
  const int* bt = p.tables + (long long)pl.r * p.nb;
  const KT* vpool = static_cast<const KT*>(p.v);

  int j = next_live(ring, pl.j0, pl.j1, bs);
  if (j < pl.j1) load_rows<KT, D>(Vs, vpool, bt[j], pl.kvh, p);
  cp_async_commit();

  // the row's max and sum from every split's, in split order
  for (int g = tid; g < group; g += NT) {
    const float2* ml = p.ml + ((long long)pl.r * p.H + h0 + g) * p.splits;
    float m = NEG;
    for (int s = 0; s < p.splits; ++s) m = fmaxf(m, ml[s].x);
    float l = 0.f;
    for (int s = 0; s < p.splits; ++s) l += ml[s].y * expf(ml[s].x - m);
    Mg[g] = m;
    Lg[g] = l;
  }
  for (int i = tid; i < group * D; i += NT) Acc[i] = 0.f;

  const float* sg = p.scores + ((long long)pl.r * p.H + h0) * T;
  for (int st = 0; j < pl.j1; st ^= 1) {
    // the previous block's P V done: its stage and Ps are free
    __syncthreads();
    const int jn = next_live(ring, j + 1, pl.j1, bs);
    if (jn < pl.j1) load_rows<KT, D>(Vs + (st ^ 1) * bs * RB, vpool, bt[jn], pl.kvh, p);
    cp_async_commit();
    // normalised probabilities, rounded to the pool dtype
    for (int i = tid; i < group * bs; i += NT) {
      const int g = i / bs, t = i - g * bs, slot = j * bs + t;
      Ps[i] = ring.valid(slot)
                  ? to_f(from_f<KT>(expf(sg[(long long)g * T + slot] - Mg[g]) / Lg[g]))
                  : 0.f;
    }
    cp_async_wait<1>();
    __syncthreads();

    // Acc += P V: thread owns (query head, 16-byte column chunk) items
    const unsigned char* Vt = Vs + st * bs * RB;
    for (int i = tid; i < group * CH; i += NT) {
      const int g = i / CH, c = i - g * CH;
      float a[E];
#pragma unroll
      for (int e = 0; e < E; ++e) a[e] = Acc[g * D + c * E + e];
      const float* prow = Ps + g * bs;
      for (int t = 0; t < bs; ++t) {
        float vv[E];
        load_chunk(reinterpret_cast<const KT*>(Vt + t * RB) + c * E, vv);
        const float pt = prow[t];
#pragma unroll
        for (int e = 0; e < E; ++e) a[e] = fmaf(pt, vv[e], a[e]);
      }
#pragma unroll
      for (int e = 0; e < E; ++e) Acc[g * D + c * E + e] = a[e];
    }
    j = jn;
  }
  __syncthreads();

  QT* og = static_cast<QT*>(p.o) + ((long long)pl.r * p.H + h0) * D;
  if (p.splits == 1) {
    for (int i = tid; i < group * D; i += NT) og[i] = from_f<QT>(Acc[i]);
    return;
  }
  // this split's partial; the last block of (request, KV head) to arrive
  // sums all partials in split order
  float* pg = p.part + ((long long)pl.r * p.H + h0) * p.splits * D;
  for (int i = tid; i < group * D; i += NT) {
    const int g = i / D, d = i - g * D;
    pg[((long long)g * p.splits + pl.split) * D + d] = Acc[i];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *last = atomicAdd(p.arrivals + pl.rk, 1) == p.splits - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  for (int i = tid; i < group * D; i += NT) {
    const int g = i / D, d = i - g * D;
    const float* src = pg + (long long)g * p.splits * D + d;
    float sum = 0.f;
    for (int s = 0; s < p.splits; ++s) sum += __ldcg(src + (long long)s * D);
    og[i] = from_f<QT>(sum);
  }
}

template <typename QT, typename KT, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  static std::atomic<unsigned long long> done_scores{0}, done_pv{0};
  const size_t smem = smem_bytes(D, p.H / p.KV, p.bs, sizeof(KT));
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = allow_smem(pa_scores<QT, KT, D>, SMEM_MAX, done_scores);
    if (err == cudaSuccess) err = allow_smem(pa_pv<QT, KT, D>, SMEM_MAX, done_pv);
    if (err != cudaSuccess) return err;
  }
  const int grid = p.R * p.KV * p.splits;
  pa_scores<QT, KT, D><<<grid, NT, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  pa_pv<QT, KT, D><<<grid, NT, smem, stream>>>(p);
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
// above the card's 227 KB). kv_itemsize: 4 (float32) or 2 (bfloat16).
extern "C" long long repro_paged_attention_smem(int D, int group, int bs,
                                                int kv_itemsize) {
  return (long long)smem_bytes(D, group, bs, kv_itemsize);
}

// dtypes: 0 = float32, 1 = bfloat16 (q and o share one; the pools the
// other); lengths64: 1 if lengths are int64, 0 if int32. Strides are in
// elements. `scratch` holds, in order, ml
// (R*H*splits float2), part (R*H*splits*D floats), scores (R*H*nb*bs
// floats) and arrivals (R*KV ints); splits = ceil(nb / bps). Returns the
// cudaError_t of the launches (0 = success).
extern "C" int repro_paged_attention(
    const void* q, const void* k, const void* v, void* o,
    const int* tables, const void* lengths, int lengths64, void* scratch,
    long long qr, long long qh, int R, int H, int KV, int D, int bs,
    int nb, int window, int bps, int splits, float scale,
    int q_dtype, int kv_dtype, void* stream) {
  if (bs < 1 || bs > MAX_BS || KV < 1 || H % KV || nb < 1 || bps < 1 ||
      splits != (nb + bps - 1) / bps)
    return (int)cudaErrorInvalidValue;
  char* s = static_cast<char*>(scratch);
  float2* ml = reinterpret_cast<float2*>(s);
  s += sizeof(float2) * (size_t)R * H * splits;
  float* part = reinterpret_cast<float*>(s);
  s += sizeof(float) * (size_t)R * H * splits * D;
  float* scores = reinterpret_cast<float*>(s);
  s += sizeof(float) * (size_t)R * H * nb * bs;
  int* arrivals = reinterpret_cast<int*>(s);
  Params p{q, k, v, o, tables, lengths, ml, part, scores, arrivals,
           qr, qh, R, H, KV, bs, nb, window, bps, splits, lengths64, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0) return (int)dispatch_d<float, float>(p, D, st);
  if (q_dtype == 0 && kv_dtype == 1) return (int)dispatch_d<float, __nv_bfloat16>(p, D, st);
  if (q_dtype == 1 && kv_dtype == 0) return (int)dispatch_d<__nv_bfloat16, float>(p, D, st);
  if (q_dtype == 1 && kv_dtype == 1)
    return (int)dispatch_d<__nv_bfloat16, __nv_bfloat16>(p, D, st);
  return (int)cudaErrorInvalidValue;
}
