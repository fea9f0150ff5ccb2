// Kernel A: per-event threshold-call state, one u8 per event.
//
// Replaces the Pallas kernel modkit_tpu/ops/pallas_state.py
// threshold_state_pallas (_state_kernel) and its XLA f32 fallback
// modkit_tpu/ops/pileup_counts.py threshold_state_f32.
//
// Bound: bytes. Each event reads M quality bytes + 3 bitmask/base bytes
// (or 4M f32 bytes + 1 base byte) and writes one byte, with a dozen flops
// per class: far below the card's operation rate. At the bench tile (615 136
// events, M = 2) the quals entry moves 3.7 MB, about 1.1 us of HBM time; a
// launch and the loads' latency are most of its time.
//
// The quals entry (the pileup's main path) takes M in {1, 2, 4, 8} (its
// present/zero masks are one byte), class-major u8 planes quals_t[j*n+i],
// the class loop unrolled in registers (call_state<M>) and the thresholds
// in the kernel's parameter bank:
//   - M <= 4: state_quals_grouped_kernel. Each thread takes kGroup = 4
//     consecutive events: one 4-byte load each of present, zero, base and
//     each plane (128 consecutive bytes per warp), one 4-byte store, over
//     one wave of blocks (the blocks per SM that registers allow x the SM
//     count). Plane j begins at quals_t + j*n, so where n % 4 != 0 planes
//     1.. are not 4-byte aligned; the offset is the same for every group of
//     a plane, so such a plane takes two aligned loads and a funnel shift,
//     with no per-event branch. The last n % 4 events run one per thread.
//     The wrapper refuses a base pointer that is not 4-byte aligned.
//   - M = 8: state_quals_kernel, one thread per event with byte loads.
// On the H100 (tools/call_bench.py, PERF.md) groups of 16 and 8 events lost
// to groups of 4 at every M, and the grouped kernel took 0.80, 0.76, 0.98
// and 1.06x the time of one thread per event at M = 1, 2, 4, 8: at M = 8
// the class loop's arithmetic, not the loads, sets the time, and more
// threads hide its latency better.
//
// The f32 entry keeps one thread per event. It unrolls those counts too;
// any other M up to kMaxClasses runs state_f32_kernel_any, a loop over m
// classes with the thresholds in a larger by-value table. The unrolled
// kernels stay beside it because they are faster where both apply (with M
// known at compile time the compiler can drop the loop and widen a row's
// loads): on the H100 the loop took up to 1.16x their time, at M = 4
// (tools/call_bench.py; the readings are in PERF.md).
//
// C interface: pointers are device pointers except thr_mod/thr_can (host),
// which are copied into the by-value argument. Returns cudaGetLastError().

#include "call.cuh"

namespace {

constexpr int kThreads = 256;       // the one-event-per-thread kernels
constexpr int kQualsThreads = 128;  // the grouped quals kernel's blocks
constexpr int kGroup = 4;           // events of a grouped quals thread

__device__ __forceinline__ uint32_t load4(const uint8_t* p) {
  return __ldg(reinterpret_cast<const uint32_t*>(p));
}

// The 4 bytes at a + mis (a 4-byte aligned, 0 <= mis < 4, the same for
// every group of a plane): one aligned load, or two and a funnel shift.
// The second load stays inside the aligned 4 bytes that hold the last
// byte wanted, so it never leaves the allocation.
__device__ __forceinline__ uint32_t load4_at(const uint8_t* a, int mis) {
  const uint32_t lo = load4(a);
  return mis == 0 ? lo : __funnelshift_r(lo, load4(a + 4), 8 * mis);
}

__device__ __forceinline__ uint32_t byte_of(uint32_t w, int s) {
  return (w >> (8 * s)) & 0xffu;
}

// The state of one event from its M quality bytes and masks.
template <int M>
__device__ __forceinline__ uint8_t quals_state(const uint32_t (&q)[M],
                                               uint32_t present,
                                               uint32_t zero, int base,
                                               const Thresholds& thr) {
  float p[M];
#pragma unroll
  for (int j = 0; j < M; ++j)
    p[j] = ((zero >> j) & 1u) ? 0.0f : ((float)q[j] + 0.5f) * 0.00390625f;
  return call_state<M>(p, present, base, thr);
}

// M <= 4: kGroup consecutive events per thread, one 4-byte load of each
// input and one 4-byte store, over one wave; the last n % kGroup events
// one per thread.
template <int M>
__global__ void __launch_bounds__(kQualsThreads)
    state_quals_grouped_kernel(const uint8_t* __restrict__ quals_t,
                               const uint8_t* __restrict__ present,
                               const uint8_t* __restrict__ zero,
                               const uint8_t* __restrict__ base, int64_t n,
                               Thresholds thr, uint8_t* __restrict__ out) {
  const int64_t groups = n / kGroup;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int64_t gi = tid; gi < groups; gi += stride) {
    const int64_t i0 = gi * kGroup;
    const uint32_t pr = load4(present + i0), zr = load4(zero + i0),
                   br = load4(base + i0);
    uint32_t qv[M];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const int64_t off = (int64_t)j * n + i0;
      qv[j] = load4_at(quals_t + (off & ~(int64_t)3), (int)(off & 3));
    }
    uint32_t res = 0;
#pragma unroll
    for (int s = 0; s < kGroup; ++s) {
      uint32_t q[M];
#pragma unroll
      for (int j = 0; j < M; ++j) q[j] = byte_of(qv[j], s);
      res |= (uint32_t)quals_state<M>(q, byte_of(pr, s), byte_of(zr, s),
                                      (int)byte_of(br, s), thr)
             << (8 * s);
    }
    *reinterpret_cast<uint32_t*>(out + i0) = res;
  }
  const int64_t i = groups * kGroup + tid;
  if (i < n) {
    uint32_t q[M];
#pragma unroll
    for (int j = 0; j < M; ++j) q[j] = quals_t[(int64_t)j * n + i];
    out[i] = quals_state<M>(q, present[i], zero[i], base[i], thr);
  }
}

// M = 8: one thread per event (the grouped kernel was slower there).
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

// The current device's SM count.
int sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)e;
}

// The grouped kernel over one wave: the blocks per SM that its registers
// allow x the SM count, or fewer where the groups need fewer.
template <int M>
int launch_quals(const uint8_t* quals_t, const uint8_t* present,
                 const uint8_t* zero, const uint8_t* base, int64_t n,
                 const Thresholds& thr, uint8_t* out, cudaStream_t stream) {
  if constexpr (M > 4) {
    state_quals_kernel<M><<<grid_for(n, kThreads), kThreads, 0, stream>>>(
        quals_t, present, zero, base, n, thr, out);
    return (int)cudaGetLastError();
  }
  static const int per_sm = [] {
    int b = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &b, state_quals_grouped_kernel<M>, kQualsThreads, 0);
    return b > 0 ? b : 1;
  }();
  int sms = 0;
  const int rc = sm_count(&sms);
  if (rc != 0) return rc;
  const int64_t need = (n / kGroup + kQualsThreads - 1) / kQualsThreads;
  const int64_t wave = (int64_t)per_sm * sms;
  const int64_t blocks = need < 1 ? 1 : (need < wave ? need : wave);
  state_quals_grouped_kernel<M>
      <<<(unsigned int)blocks, kQualsThreads, 0, stream>>>(
          quals_t, present, zero, base, n, thr, out);
  return (int)cudaGetLastError();
}

template <int M>
void launch_f32(const float* probs, const uint8_t* base, int64_t n,
                const Thresholds& thr, uint8_t* out, cudaStream_t stream) {
  state_f32_kernel<M><<<grid_for(n, kThreads), kThreads, 0, stream>>>(
      probs, base, n, thr, out);
}

}  // namespace

// quals_t, present, zero and base are 4-byte aligned.
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
    case 1: return launch_quals<1>(q, pr, z, b, n, thr, o, s);
    case 2: return launch_quals<2>(q, pr, z, b, n, thr, o, s);
    case 4: return launch_quals<4>(q, pr, z, b, n, thr, o, s);
    case 8: return launch_quals<8>(q, pr, z, b, n, thr, o, s);
    default: return (int)cudaErrorInvalidValue;
  }
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
