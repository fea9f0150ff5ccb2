// Kernel A: per-event threshold-call state, one u8 per event.
//
// Replaces the Pallas kernel modkit_tpu/ops/pallas_state.py
// threshold_state_pallas (_state_kernel) and its XLA f32 fallback
// modkit_tpu/ops/pileup_counts.py threshold_state_f32.
//
// Bound: bytes. Each event reads M quality bytes + 3 bitmask/base bytes
// (or 4M f32 bytes + 1 base byte) and writes one byte, with a dozen flops
// per class: far below the card's operation rate. The design streams each
// input once: one thread per event, class-major u8 planes (quals_t[j*n+i])
// so a warp's loads of one class are 32 consecutive bytes, the class loop
// unrolled in registers (M is a template argument), and the thresholds in
// the kernel's parameter bank. No shared memory, no synchronisation.
//
// The quals entry takes M in {1, 2, 4, 8} (its present/zero masks are one
// byte). The f32 entry unrolls those counts too; any other M up to
// kMaxClasses runs state_f32_kernel_any, a loop over m classes with the
// thresholds in a larger by-value table. The unrolled kernels stay beside
// it because they are faster where both apply (with M known at compile
// time the compiler can drop the loop and widen a row's loads): on the
// H100 the loop took up to 1.16x their time, at M = 4
// (tools/call_bench.py; the readings are in PERF.md).
//
// C interface: pointers are device pointers except thr_mod/thr_can (host),
// which are copied into the by-value argument. Returns cudaGetLastError().

#include "call.cuh"

namespace {

constexpr int kThreads = 256;

template <int M>
__global__ void state_quals_kernel(const uint8_t* __restrict__ quals_t,
                                   const uint8_t* __restrict__ present,
                                   const uint8_t* __restrict__ zero,
                                   const uint8_t* __restrict__ base,
                                   int64_t n, Thresholds thr,
                                   uint8_t* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint32_t zero_bits = zero[i];
    float p[M];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const float q = (float)quals_t[(int64_t)j * n + i];
      p[j] = ((zero_bits >> j) & 1u) ? 0.0f : (q + 0.5f) * 0.00390625f;
    }
    out[i] = call_state<M>(p, present[i], base[i], thr);
  }
}

template <int M>
__global__ void state_f32_kernel(const float* __restrict__ probs,
                                 const uint8_t* __restrict__ base, int64_t n,
                                 Thresholds thr, uint8_t* __restrict__ out) {
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
    out[i] = call_state<M>(p, present, base[i], thr);
  }
}

__global__ void state_f32_kernel_any(const float* __restrict__ probs,
                                     const uint8_t* __restrict__ base,
                                     int64_t n, int m, ThresholdsAny thr,
                                     uint8_t* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = call_state_row(probs + i * m, m, base[i], thr);
}

template <int M>
void launch_quals(const uint8_t* quals_t, const uint8_t* present,
                  const uint8_t* zero, const uint8_t* base, int64_t n,
                  const Thresholds& thr, uint8_t* out, cudaStream_t stream) {
  state_quals_kernel<M><<<grid_for(n, kThreads), kThreads, 0, stream>>>(
      quals_t, present, zero, base, n, thr, out);
}

template <int M>
void launch_f32(const float* probs, const uint8_t* base, int64_t n,
                const Thresholds& thr, uint8_t* out, cudaStream_t stream) {
  state_f32_kernel<M><<<grid_for(n, kThreads), kThreads, 0, stream>>>(
      probs, base, n, thr, out);
}

}  // namespace

extern "C" int mk_state_quals_t(const void* quals_t, const void* present,
                                const void* zero, const void* base, int64_t n,
                                int32_t m, const void* thr_mod,
                                const void* thr_can, void* out,
                                void* stream) {
  if (n <= 0 || !(m == 1 || m == 2 || m == 4 || m == 8))
    return (int)cudaErrorInvalidValue;
  const auto thr = make_thresholds<8>(static_cast<const float*>(thr_mod), m,
                                      static_cast<const float*>(thr_can));
  const auto* q = static_cast<const uint8_t*>(quals_t);
  const auto* pr = static_cast<const uint8_t*>(present);
  const auto* z = static_cast<const uint8_t*>(zero);
  const auto* b = static_cast<const uint8_t*>(base);
  auto* o = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 1: launch_quals<1>(q, pr, z, b, n, thr, o, s); break;
    case 2: launch_quals<2>(q, pr, z, b, n, thr, o, s); break;
    case 4: launch_quals<4>(q, pr, z, b, n, thr, o, s); break;
    case 8: launch_quals<8>(q, pr, z, b, n, thr, o, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Any m in [1, kMaxClasses].
extern "C" int mk_state_f32(const void* probs, const void* base, int64_t n,
                            int32_t m, const void* thr_mod,
                            const void* thr_can, void* out, void* stream) {
  if (n <= 0 || m < 1 || m > kMaxClasses) return (int)cudaErrorInvalidValue;
  const auto* tm = static_cast<const float*>(thr_mod);
  const auto* tc = static_cast<const float*>(thr_can);
  const auto* p = static_cast<const float*>(probs);
  const auto* b = static_cast<const uint8_t*>(base);
  auto* o = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (m == 1 || m == 2 || m == 4 || m == 8) {
    const auto thr = make_thresholds<8>(tm, m, tc);
    switch (m) {
      case 1: launch_f32<1>(p, b, n, thr, o, s); break;
      case 2: launch_f32<2>(p, b, n, thr, o, s); break;
      case 4: launch_f32<4>(p, b, n, thr, o, s); break;
      case 8: launch_f32<8>(p, b, n, thr, o, s); break;
    }
  } else {
    state_f32_kernel_any<<<grid_for(n, kThreads), kThreads, 0, s>>>(
        p, b, n, m, make_thresholds<kMaxClasses>(tm, m, tc), o);
  }
  return (int)cudaGetLastError();
}
