// Kernel B: fused threshold call + per-(position, strand, counter) count.
//
// Replaces the Pallas kernel modkit_tpu/ops/pallas_counts.py
// modcall_counts_pallas (_count_call / _count_kernel), the XLA
// modcall_count_kernel of modkit_tpu/ops/pileup_counts.py, and the host
// sort/grouping (prepare_events) that fed it.
//
// The TPU has no scatter, so the Pallas kernel sorted events by position
// and counted them as int8 one-hot matmuls. Hopper has integer atomics in
// L2, so this kernel is a plain scatter histogram: one thread per event
// computes the call state over its f32 row (the same call.cuh function as
// kernel A) and adds one to counts[(rpos*2 + strand)*Km + counter] with an
// atomicAdd. Integer atomics make the result exact in any order.
//
// Bound: bytes. An event reads 12 + 4M bytes and the count tensor is
// written once (the wrapper zeroes it); the atomics land in L2, which holds
// a 100 kb tile's tensor (10.4 MB at M = 2). Hot positions contend on the
// same counters; privatising a position window in shared memory is later
// work.
//
// M in {1, 2, 4, 8} is unrolled; any other M up to kMaxClasses runs
// counts_kernel_any, a loop over m classes. Both take the thresholds by
// value. The unrolled kernels stay because they are faster where both
// apply (the loop took 1.03-1.04x their time on the H100;
// tools/call_bench.py, readings in PERF.md).
//
// Counter layout per (position, strand), Km = 1 + 4(M+1):
//   0 filtered, 1 + b(M+1) canonical for base b, 1 + b(M+1) + 1 + j mod j.
// An event whose index falls outside [0, P*2*Km) is dropped, never written.

#include "call.cuh"

namespace {

constexpr int kThreads = 256;

template <int M>
__global__ void counts_kernel(const int32_t* __restrict__ rpos,
                              const int32_t* __restrict__ strand,
                              const int32_t* __restrict__ base,
                              const float* __restrict__ probs, int64_t n,
                              int64_t total, Thresholds thr,
                              int32_t* __restrict__ counts) {
  constexpr int kKm = 1 + 4 * (M + 1);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float p[M];
    uint32_t present = 0;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      p[j] = probs[i * M + j];
      present |= (p[j] >= 0.0f ? 1u : 0u) << j;  // -1 marks an absent class
    }
    const int b = base[i];
    const int state = call_state<M>(p, present, b, thr);
    const int counter = state == 0 ? 0 : 1 + b * (M + 1) + (state - 1);
    const int64_t flat =
        ((int64_t)rpos[i] * 2 + strand[i]) * kKm + counter;
    if (flat >= 0 && flat < total) atomicAdd(&counts[flat], 1);
  }
}

__global__ void counts_kernel_any(const int32_t* __restrict__ rpos,
                                  const int32_t* __restrict__ strand,
                                  const int32_t* __restrict__ base,
                                  const float* __restrict__ probs, int64_t n,
                                  int m, int64_t total, ThresholdsAny thr,
                                  int32_t* __restrict__ counts) {
  const int km = 1 + 4 * (m + 1);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int b = base[i];
    const int state = call_state_row(probs + i * m, m, b, thr);
    const int counter = state == 0 ? 0 : 1 + b * (m + 1) + (state - 1);
    const int64_t flat = ((int64_t)rpos[i] * 2 + strand[i]) * km + counter;
    if (flat >= 0 && flat < total) atomicAdd(&counts[flat], 1);
  }
}

template <int M>
void launch(const int32_t* rpos, const int32_t* strand, const int32_t* base,
            const float* probs, int64_t n, int64_t total,
            const Thresholds& thr, int32_t* counts, cudaStream_t stream) {
  counts_kernel<M><<<grid_for(n, kThreads), kThreads, 0, stream>>>(
      rpos, strand, base, probs, n, total, thr, counts);
}

}  // namespace

// counts must hold num_positions * 2 * (1 + 4(m+1)) zeroed int32; any m in
// [1, kMaxClasses].
extern "C" int mk_modcall_counts(const void* rpos, const void* strand,
                                 const void* base, const void* probs,
                                 int64_t n, int32_t m, int64_t num_positions,
                                 const void* thr_mod, const void* thr_can,
                                 void* counts, void* stream) {
  if (n <= 0 || num_positions <= 0 || m < 1 || m > kMaxClasses)
    return (int)cudaErrorInvalidValue;
  const auto* tm = static_cast<const float*>(thr_mod);
  const auto* tc = static_cast<const float*>(thr_can);
  const int64_t total = num_positions * 2 * (1 + 4 * (m + 1));
  const auto* r = static_cast<const int32_t*>(rpos);
  const auto* s = static_cast<const int32_t*>(strand);
  const auto* b = static_cast<const int32_t*>(base);
  const auto* p = static_cast<const float*>(probs);
  auto* c = static_cast<int32_t*>(counts);
  auto st = static_cast<cudaStream_t>(stream);
  if (m == 1 || m == 2 || m == 4 || m == 8) {
    const auto thr = make_thresholds<8>(tm, m, tc);
    switch (m) {
      case 1: launch<1>(r, s, b, p, n, total, thr, c, st); break;
      case 2: launch<2>(r, s, b, p, n, total, thr, c, st); break;
      case 4: launch<4>(r, s, b, p, n, total, thr, c, st); break;
      case 8: launch<8>(r, s, b, p, n, total, thr, c, st); break;
    }
  } else {
    counts_kernel_any<<<grid_for(n, kThreads), kThreads, 0, st>>>(
        r, s, b, p, n, m, total, make_thresholds<kMaxClasses>(tm, m, tc), c);
  }
  return (int)cudaGetLastError();
}
