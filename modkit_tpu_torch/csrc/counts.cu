// Kernel B: fused threshold call + per-(position, strand, counter) count.
//
// Replaces the Pallas kernel modkit_tpu/ops/pallas_counts.py
// modcall_counts_pallas (_count_call / _count_kernel), the XLA
// modcall_count_kernel of modkit_tpu/ops/pileup_counts.py, and the host
// sort/grouping (prepare_events) that fed it.
//
// Counter layout per (position, strand), Km = 1 + 4(M+1):
//   0 filtered, 1 + b(M+1) canonical for base b, 1 + b(M+1) + 1 + j mod j.
// The flat index of an event is flat = (rpos * 2 + strand) * Km + counter;
// an event whose flat index falls outside [0, P*2*Km) is dropped.
//
// Bound: bytes. An event reads 12 + 4M bytes and the [P, 2, Km] int32
// output is written once. The TPU has no scatter, so the Pallas kernel
// sorted events by position on the host and counted them as int8 one-hot
// matmuls into one group's block per grid step. Hopper has integer atomics
// in L2, and the events reach this kernel read by read, in query order
// (pileup/events.py): the events of one (position, strand) lie about a
// read's length of events apart and never meet inside a warp. So the count
// is a scatter histogram, one global atomic per event, which integer
// atomics make exact in any order; the output (10.4 MB at M = 2 over a
// 100 kb tile) stays in L2 while they land.
//
// The C entry writes every cell, in two launches on the caller's stream:
//
//   1. zero_kernel, one block per SM, stores the output's zeros with
//      16-byte stores. It lets the count pass launch at once (a
//      programmatic dependent launch, sm_90).
//   2. scatter_kernel, one event per thread: it loads the event and
//      computes its call (the call.cuh function of kernel A, unrolled for
//      M in {1, 2, 4, 8}, a loop over the classes for any other M up to
//      kMaxClasses) while the zeros are being stored, waits for the zero
//      pass to finish, then adds one to the event's counter.
//
// So the blocks resident beside the zero pass load and call while it
// stores, where a zeroed output from the caller would put all of that
// after it. Reading the inputs before the wait is safe: the zero pass is
// launched in stream order, after all earlier work on the stream, and
// this pass cannot start before it. One event per thread and one zero
// block per SM came out of a sweep on the H100 over 1, 2, 4 and 8 events
// per thread and 1 to 32 zero blocks per SM.
//
// An output window owned by one block (a device-side sort by window, each
// block counting its window in shared memory and storing every cell) was
// built and measured slower on these events at every M: a second pass and
// its dependent L2 reads cost more than the atomics (PERF.md).

#include "call.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kZeroThreads = 256;

// ---- the call ----

// The unrolled call: class count M known at compile time.
// load() brings event i's row, state() calls it.
template <int M>
struct UnrolledCall {
  const float* __restrict__ probs;
  Thresholds thr;
  struct Row {
    float p[M];
  };
  __device__ Row load(int64_t i) const {
    Row r;
#pragma unroll
    for (int j = 0; j < M; ++j) r.p[j] = __ldg(probs + i * M + j);
    return r;
  }
  __device__ int state(const Row& r, int b) const {
    uint32_t present = 0;
#pragma unroll
    for (int j = 0; j < M; ++j)
      present |= (r.p[j] >= 0.0f ? 1u : 0u) << j;  // -1: an absent class
    return call_state<M>(r.p, present, b, thr);
  }
  __device__ int m() const { return M; }
};

// The runtime-M call: a loop over the classes.
struct AnyCall {
  const float* __restrict__ probs;
  int classes;
  ThresholdsAny thr;
  struct Row {
    int64_t i;
  };
  __device__ Row load(int64_t i) const { return Row{i}; }
  __device__ int state(const Row& r, int b) const {
    return call_state_row(probs + r.i * classes, classes, b, thr);
  }
  __device__ int m() const { return classes; }
};

// ---- programmatic dependent launch (sm_90) ----

__device__ __forceinline__ void launch_dependents() {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  asm volatile("griddepcontrol.launch_dependents;");
#endif
}

__device__ __forceinline__ void wait_for_prerequisite() {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  asm volatile("griddepcontrol.wait;" ::: "memory");
#endif
}

// ---- 1. zero ----

// counts is 16-byte aligned; total cells of it are zeroed.
__global__ void __launch_bounds__(kZeroThreads)
    zero_kernel(int32_t* __restrict__ counts, int64_t total) {
  launch_dependents();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int4* c4 = reinterpret_cast<int4*>(counts);
  const int64_t n4 = total / 4;
  for (int64_t q = t; q < n4; q += stride) c4[q] = make_int4(0, 0, 0, 0);
  for (int64_t c = n4 * 4 + t; c < total; c += stride) counts[c] = 0;
}

// ---- 2. scatter ----

template <class Call>
__global__ void __launch_bounds__(kThreads)
    scatter_kernel(Call call, const int32_t* __restrict__ rpos,
                   const int32_t* __restrict__ strand,
                   const int32_t* __restrict__ base, int64_t n, int64_t total,
                   int32_t* __restrict__ counts) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  int64_t flat = -1;
  if (i < n) {
    const int m = call.m();
    const int b = __ldg(base + i);
    const int st = call.state(call.load(i), b);
    const int counter = st == 0 ? 0 : 1 + b * (m + 1) + (st - 1);
    flat = ((int64_t)__ldg(rpos + i) * 2 + __ldg(strand + i)) *
               (1 + 4 * (m + 1)) +
           counter;
  }
  wait_for_prerequisite();
  if (flat >= 0 && flat < total) atomicAdd(&counts[flat], 1);
}

// ---- launch ----

template <class Call>
int launch(const Call& call, const int32_t* rpos, const int32_t* strand,
           const int32_t* base, int64_t n, int64_t total, int32_t* counts,
           cudaStream_t st) {
  int dev = 0, sms = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc == 0)
    rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
  if (rc != 0) return rc;
  // a block per SM at most, a block per 4 * kZeroThreads cells
  const int64_t zero_blocks =
      (total + 4 * kZeroThreads - 1) / (4 * kZeroThreads);
  zero_kernel<<<(unsigned int)(zero_blocks < sms ? zero_blocks : sms),
                kZeroThreads, 0, st>>>(counts, total);
  rc = (int)cudaGetLastError();
  if (rc != 0 || n == 0) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned int)((n + kThreads - 1) / kThreads));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = (int)cudaLaunchKernelEx(&cfg, scatter_kernel<Call>, call, rpos,
                               strand, base, n, total, counts);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

}  // namespace

// Writes every cell of counts (num_positions * 2 * (1 + 4(m+1)) int32, 16-
// byte aligned): nothing needs to zero it first. n >= 0 events; any m in
// [1, kMaxClasses].
extern "C" int mk_modcall_counts(const void* rpos, const void* strand,
                                 const void* base, const void* probs,
                                 int64_t n, int32_t m, int64_t num_positions,
                                 const void* thr_mod, const void* thr_can,
                                 void* counts, void* stream) {
  if (n < 0 || num_positions <= 0 || m < 1 || m > kMaxClasses ||
      reinterpret_cast<uintptr_t>(counts) % 16)
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
      case 1:
        return launch(UnrolledCall<1>{p, thr}, r, s, b, n, total, c, st);
      case 2:
        return launch(UnrolledCall<2>{p, thr}, r, s, b, n, total, c, st);
      case 4:
        return launch(UnrolledCall<4>{p, thr}, r, s, b, n, total, c, st);
      default:
        return launch(UnrolledCall<8>{p, thr}, r, s, b, n, total, c, st);
    }
  }
  return launch(AnyCall{p, m, make_thresholds<kMaxClasses>(tm, m, tc)}, r, s,
                b, n, total, c, st);
}
