// Segment combine for Hopper (sm_90a): the reduce step of every tuned
// reduction (ring, Rabenseifner, recursive doubling and halving, the
// binomial reduce, every synthesized step program).
//
// Replaces the Pallas TPU kernel
// repro/kernels/segment_reduce.py::segment_combine_pallas (_combine_kernel):
//   out[i] = cast(op(float(acc[i]), float(part[i])))   op in {add, max, min}
// for fp32 and bf16, one fp32 operation and one round-to-nearest-even cast
// per element, as the reference computes it.
//
// The TPU kernel pads the flattened buffer to (rows, 128) tiles of
// block_rows = 256 and walks them in grid order. Here there is no padding:
// one pass over the n elements of three contiguous buffers. Where acc,
// part and out all start on a 16-byte boundary, each thread moves one
// 16-byte vector (4 fp32 or 8 bf16) per operand, on a grid sized to the
// work, and a scalar tail ends it (the first port's grid-stride loop over
// at most 1,056 blocks was slower on the H100, and 2 or 4 vectors per
// thread gained nothing: PERF.md). Where one does not (a ring segment's
// row slice starts at seg * itemsize bytes), the whole call takes the
// scalar loop, which is still coalesced: neighbouring threads touch
// neighbouring elements.
//
// out may be acc itself (the in-place form the ring and the step programs
// use): each element of out depends only on the same element of acc and
// part, and a thread loads both before it stores, so acc and out carry no
// __restrict__. out must not overlap part (the wrapper checks).
//
// Bound on the card: each element of acc and part is read once and out is
// written once, so the call moves 3 * n * itemsize bytes and does n
// operations: ~0.060 ms for 16M fp32 elements at 3.35 TB/s, memory bound
// by a factor of ~500 over the fp32 rate. The design reads and writes each
// byte once and keeps no intermediate in device memory; in place, it also
// spares the caller the copy back into its buffer (2 * n * itemsize more).
//
// Max and min propagate a NaN in either input, as jnp.maximum and
// torch.maximum do (fmaxf would drop it).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

template <int OP>
__device__ __forceinline__ float apply(float a, float b) {
  if (OP == 0) return __fadd_rn(a, b);
  if (OP == 1) return (a > b || a != a) ? a : b;   // max, NaN propagates
  return (a < b || a != a) ? a : b;                // min, NaN propagates
}

template <typename T, int OP>
__device__ __forceinline__ T combine1(T a, T b) {
  return from_f<T>(apply<OP>(to_f(a), to_f(b)));
}

// [0, nvec * V) in 16-byte vectors, one per operand per thread, the rest
// scalar. nvec == 0 makes the whole call scalar.
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const T* acc, const T* __restrict__ part, T* out, long long n,
               long long nvec) {
  constexpr int V = 16 / sizeof(T);
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  if (tid < nvec) {
    const uint4 ua = reinterpret_cast<const uint4*>(acc)[tid];
    const uint4 up = reinterpret_cast<const uint4*>(part)[tid];
    uint4 uo;
    const T* ea = reinterpret_cast<const T*>(&ua);
    const T* ep = reinterpret_cast<const T*>(&up);
    T* eo = reinterpret_cast<T*>(&uo);
#pragma unroll
    for (int j = 0; j < V; ++j) eo[j] = combine1<T, OP>(ea[j], ep[j]);
    reinterpret_cast<uint4*>(out)[tid] = uo;
  }
  for (long long j = nvec * V + tid; j < n; j += stride) {
    out[j] = combine1<T, OP>(acc[j], part[j]);
  }
}

template <typename T, int OP>
cudaError_t launch(const void* acc, const void* part, void* out, long long n,
                   cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const uintptr_t aligned = reinterpret_cast<uintptr_t>(acc) |
                            reinterpret_cast<uintptr_t>(part) |
                            reinterpret_cast<uintptr_t>(out);
  const long long nvec = aligned % 16 == 0 ? n / V : 0;
  const long long blocks = ((nvec > 0 ? nvec : n) + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  combine_kernel<T, OP><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(acc), static_cast<const T*>(part),
      static_cast<T*>(out), n, nvec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_op(const void* acc, const void* part, void* out,
                        long long n, int op, cudaStream_t stream) {
  if (op == 0) return launch<T, 0>(acc, part, out, n, stream);
  if (op == 1) return launch<T, 1>(acc, part, out, n, stream);
  if (op == 2) return launch<T, 2>(acc, part, out, n, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 fp32, 1 bf16; op: 0 add, 1 max, 2 min. out may be acc.
// Returns the launch's cudaError_t (0 on success); the kernel runs on
// `stream`, unsynchronised.
extern "C" int repro_segment_combine(const void* acc, const void* part,
                                     void* out, long long n, int dtype,
                                     int op, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_op<float>(acc, part, out, n, op, st);
  if (dtype == 1)
    return (int)dispatch_op<__nv_bfloat16>(acc, part, out, n, op, st);
  return (int)cudaErrorInvalidValue;
}
