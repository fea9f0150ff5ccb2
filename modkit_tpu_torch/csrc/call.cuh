// Per-event threshold call shared by the state and count kernels.
//
// Bit-exact port of the Pallas body modkit_tpu/ops/pallas_state.py
// _state_kernel (:61-86), i.e. MultipleThresholdModCaller::call:
//   - p = (q + 0.5) * 2^-8, exact in f32 (equal to the reference's /256);
//     a set zero bit forces p = 0 (inferred canonical);
//   - the canonical probability is 1 - sum(present p), summed one class at
//     a time in class order (no tree reduction, so f32 rounding matches);
//   - a mod class passes when present and p >= thr_mod[j][base]; the best
//     passing class is taken on >=, so the later class wins a tie;
//   - canonical passes when 1 - sum >= thr_can[base] and wins over a tied
//     best mod class;
//   - state 0 = filtered, 1 = canonical, 2 + j = mod class j.
// Build with -fmad=false and without --use_fast_math so no contraction or
// approximate arithmetic changes a rounding.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

// Thresholds for up to MaxM classes x 4 bases + 4 canonical ones, passed
// by value as a kernel argument (the constant bank): no device copy and no
// upload before a launch.
template <int MaxM>
struct ThresholdTable {
  float mod[MaxM][4];
  float can[4];
};

// The state 2 + j of class j must fit a byte.
constexpr int kMaxClasses = 253;

// The unrolled kernels' table (M <= 8), and the runtime-m kernels' table:
// 4064 bytes, within the 32 764-byte kernel parameter space of CUDA 12.1
// and later on sm_70 and newer.
using Thresholds = ThresholdTable<8>;
using ThresholdsAny = ThresholdTable<kMaxClasses>;

// Threshold row of a base index: 1..3 select their own column, any other
// value the first (the select chain of pallas_state.py thr_for).
__device__ __forceinline__ int threshold_column(int base) {
  return (base == 1 || base == 2 || base == 3) ? base : 0;
}

// The running state of the call, one class at a time in class order.
struct CallAcc {
  float prob_sum = 0.0f;
  float best_p = -INFINITY;
  int best_j = 0;
  bool any_mod = false;
};

// Class j with probability pj, present or not, against its threshold.
__device__ __forceinline__ void call_step(CallAcc& a, int j, float pj,
                                          bool present_j, float thr_j) {
  a.prob_sum = a.prob_sum + (present_j ? pj : 0.0f);
  const bool pass_j = present_j && (pj >= thr_j);
  const float mp = pass_j ? pj : -INFINITY;
  if (mp >= a.best_p) {
    a.best_p = mp;
    a.best_j = j;
  }
  a.any_mod = a.any_mod || pass_j;
}

// The u8 state once every class has been stepped.
__device__ __forceinline__ uint8_t call_finish(const CallAcc& a,
                                               float thr_can) {
  const float canon_p = 1.0f - a.prob_sum;
  const bool choose_can =
      (canon_p >= thr_can) && (!a.any_mod || canon_p >= a.best_p);
  return choose_can ? 1 : (a.any_mod ? (uint8_t)(2 + a.best_j) : 0);
}

// p[j] is class j's probability, present bit j says whether class j was
// called at this event. Returns the u8 state.
template <int M>
__device__ __forceinline__ uint8_t call_state(const float (&p)[M],
                                              uint32_t present, int base,
                                              const Thresholds& thr) {
  const int b = threshold_column(base);
  CallAcc a;
#pragma unroll
  for (int j = 0; j < M; ++j)
    call_step(a, j, p[j], (present >> j) & 1u, thr.mod[j][b]);
  return call_finish(a, thr.can[b]);
}

// The same call for a class count m known only at run time, over one f32
// row (-1 marks an absent class). Padding classes (absent everywhere) never
// pass and never change the state.
__device__ __forceinline__ uint8_t call_state_row(const float* __restrict__ p,
                                                  int m, int base,
                                                  const ThresholdsAny& thr) {
  const int b = threshold_column(base);
  CallAcc a;
  for (int j = 0; j < m; ++j) {
    const float pj = p[j];
    call_step(a, j, pj, pj >= 0.0f, thr.mod[j][b]);
  }
  return call_finish(a, thr.can[b]);
}

// Thresholds from host arrays thr_mod [m, 4] (row-major) and thr_can [4];
// rows past m stay zero. m <= MaxM.
template <int MaxM>
inline ThresholdTable<MaxM> make_thresholds(const float* thr_mod, int m,
                                            const float* thr_can) {
  ThresholdTable<MaxM> t = {};
  for (int j = 0; j < m; ++j)
    for (int b = 0; b < 4; ++b) t.mod[j][b] = thr_mod[j * 4 + b];
  for (int b = 0; b < 4; ++b) t.can[b] = thr_can[b];
  return t;
}

// Grid for a one-thread-per-event, grid-stride launch over n events.
inline unsigned int grid_for(int64_t n, int threads) {
  const int64_t blocks = (n + threads - 1) / threads;
  // a few waves of 132 SMs x 8 resident 256-thread blocks; past that the
  // grid-stride loop covers the rest
  const int64_t cap = 132 * 8 * 4;
  return (unsigned int)(blocks < cap ? blocks : cap);
}

// Message of a cudaError_t returned by one of the library's entry points.
extern "C" const char* mk_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
