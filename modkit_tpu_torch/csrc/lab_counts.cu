// The count-kernel lab: the grouped 128 x 128 histograms of
// tools/kernel_lab.py and of modkit_tpu/ops/pallas_counts.py _count_call.
//
// Replaces the Pallas kernels run_variant (:81), run_diag (:160), run_bigk
// (:211), run_group (:296), run_bigk_host (:344) and run_rep8 (:412) of
// tools/kernel_lab.py, and _count_call (pallas_counts.py:113). Each counts
// events into out[g, p2, col] (int32 [n_groups, 128, 128]), where chunk c
// of `chunk` event slots belongs to group c2g[c]. The TPU formulations
// (one-hot int8/bf16 matmuls on the MXU, because the TPU has no scatter)
// are exact in every variant, so their one-hot dtype, accumulator dtype
// and accumulator count change no count and select nothing here.
//
// Bound: bytes on paper. An event slot reads 2 to 16 bytes, the output is
// 12.85 MB at the lab's shape, and a histogram does a handful of integer
// operations per slot. Hopper has integer atomics in L2 (which holds the
// output), so each kernel is a scatter: one thread per slot reads the
// slot's values and atomicAdds into the cell; the wrapper zeroes `out`. On
// the H100 the L2 atomic transactions (one per slot, to a random cell of
// the group's block) bound it, whatever bytes a slot brings; privatising a
// group's histogram in shared memory or counting with tensor-core one-hot
// products is later work.
//
// A value outside [0, 128) (col 255 = invalid, u8 values above 127, a
// negative int32) matches no output row or lane in the TPU kernels; here it
// is dropped, never used as an index. Chunks of a group index outside
// [0, n_groups), and run_group chunk ranges past the chunks, count nowhere
// too, as in the plain versions. Atomics count in any order, so c2g need
// not be sorted here (the TPU kernels needed it).
//
// Bodies:
//   (a) hist_kernel, templated over the slot layout: PlanesReader (p2 u8,
//       col i32, valid i32: run_variant, run_bigk), RowsReader (p2 u8, col
//       u8 with 255 = invalid: run_bigk_host), Rep8Reader (8 rows per chunk:
//       run_rep8, _count_call);
//   (b) group_kernel: one block per group over its chunk range (run_group);
//   (c) diag_kernel: run_diag's four modes and run_rep8's two ablations.

#include "call.cuh"  // grid_for, mk_cuda_error_string

namespace {

constexpr int kP2 = 128;
constexpr int kLanes = 128;
constexpr int kCells = kP2 * kLanes;  // one group's block
constexpr int kCR = 16;               // rows of a 2048-slot chunk
constexpr int kRep = 8;               // rows of a rep8 chunk
constexpr int kThreads = 256;

__device__ __forceinline__ void add_cell(int32_t* __restrict__ out_g, int i,
                                         int j, int v = 1) {
  if ((unsigned)i < (unsigned)kP2 && (unsigned)j < (unsigned)kLanes)
    atomicAdd(&out_g[i * kLanes + j], v);
}

// Slot k of chunk c; slot-major planes (e = c * chunk + k).
struct PlanesReader {
  const uint8_t* __restrict__ p2;
  const int32_t* __restrict__ col;
  const int32_t* __restrict__ valid;
  __device__ void operator()(int64_t c, int k, int chunk,
                             int32_t* __restrict__ out_g) const {
    const int64_t e = c * chunk + k;
    if (valid[e] != 0) add_cell(out_g, p2[e], col[e]);
  }
};

struct RowsReader {
  const uint8_t* __restrict__ p2;
  const uint8_t* __restrict__ col;
  __device__ void operator()(int64_t c, int k, int chunk,
                             int32_t* __restrict__ out_g) const {
    const int64_t e = c * chunk + k;
    add_cell(out_g, p2[e], col[e]);
  }
};

// Output row i reads replica row i % 8, column j replica row j % 8: a value
// v of row a counts as row v only when v % 8 == a. With identical rows
// exactly one (a, b) pair matches and this is the histogram.
struct Rep8Reader {
  const uint8_t* __restrict__ p2r;
  const uint8_t* __restrict__ colr;
  __device__ void operator()(int64_t c, int k, int chunk,
                             int32_t* __restrict__ out_g) const {
    const int64_t row0 = c * kRep;
#pragma unroll
    for (int a = 0; a < kRep; ++a) {
      const int vi = p2r[(row0 + a) * chunk + k];
      if (vi >= kP2 || (vi & (kRep - 1)) != a) continue;
#pragma unroll
      for (int b = 0; b < kRep; ++b) {
        const int vj = colr[(row0 + b) * chunk + k];
        if (vj < kLanes && (vj & (kRep - 1)) == b) add_cell(out_g, vi, vj);
      }
    }
  }
};

template <class Reader>
__global__ void hist_kernel(Reader rd, const int32_t* __restrict__ c2g,
                            int64_t n_chunks, int chunk, int n_groups,
                            int32_t* __restrict__ out) {
  for (int64_t c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int g = c2g[c];
    if (g < 0 || g >= n_groups) continue;
    int32_t* out_g = out + (int64_t)g * kCells;
    for (int k = threadIdx.x; k < chunk; k += blockDim.x) rd(c, k, chunk, out_g);
  }
}

// gmeta: counts [n_groups], then starts [n_groups]; packed: per chunk kCR
// rows of p2, then kCR rows of col (255 = invalid), kLanes wide.
__global__ void group_kernel(const int32_t* __restrict__ gmeta,
                             const uint8_t* __restrict__ packed,
                             int n_groups, int64_t n_chunks,
                             int32_t* __restrict__ out) {
  constexpr int kSlots = kCR * kLanes;
  for (int g = blockIdx.x; g < n_groups; g += gridDim.x) {
    const int cnt = gmeta[g];
    const int start = gmeta[n_groups + g];
    int32_t* out_g = out + (int64_t)g * kCells;
    for (int ci = 0; ci < cnt; ++ci) {
      const int64_t c = (int64_t)start + ci;
      if (c < 0 || c >= n_chunks) continue;
      const uint8_t* blk = packed + c * 2 * kSlots;
      for (int s = threadIdx.x; s < kSlots; s += blockDim.x)
        add_cell(out_g, blk[s], blk[kSlots + s]);
    }
  }
}

enum DiagMode {
  kEmpty = 0,        // adds nothing
  kOnehotOnly = 1,   // sum_r (A_r + B_r), indexed [i, lane]
  kMatmulOnly = 2,   // 16 * A_0 B_0^T
  kAOnly = 3,        // sum_r A_r B_0^T
  kRep8NoDot = 4,    // [p2r[i%8, l] == i] + [colr[i%8, l] == i], l < 128
  kRep8NoConstruct = 5,  // out[0, 0] += chunk * p2r[row 0, slot 0]
};

// One block per chunk, one thread per lane. Modes 1-3 read the planes of
// PlanesReader (a = p2, b = col, v = valid, chunk = kCR * kLanes); modes
// 4-5 the rep8 rows (a = p2r, b = colr).
template <int Mode>
__global__ void diag_kernel(const int32_t* __restrict__ c2g,
                            const void* __restrict__ a_,
                            const void* __restrict__ b_,
                            const int32_t* __restrict__ valid,
                            int64_t n_chunks, int chunk, int n_groups,
                            int32_t* __restrict__ out) {
  const int l = threadIdx.x;
  for (int64_t c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int g = c2g[c];
    if (Mode == kEmpty || g < 0 || g >= n_groups) continue;
    int32_t* out_g = out + (int64_t)g * kCells;
    if (Mode <= kAOnly) {
      const auto* p2 = static_cast<const uint8_t*>(a_) + c * chunk;
      const auto* col = static_cast<const int32_t*>(b_) + c * chunk;
      const int32_t* v = valid + c * chunk;
      if (Mode == kOnehotOnly) {
        for (int r = 0; r < kCR; ++r) {
          const int e = r * kLanes + l;
          add_cell(out_g, p2[e], l);
          if (v[e] != 0) add_cell(out_g, col[e], l);
        }
      } else if (Mode == kMatmulOnly) {
        if (v[l] != 0) add_cell(out_g, p2[l], col[l], kCR);
      } else if (v[l] != 0 && (unsigned)col[l] < (unsigned)kLanes) {
        for (int r = 0; r < kCR; ++r) add_cell(out_g, p2[r * kLanes + l], col[l]);
      }
    } else {
      const auto* p2r = static_cast<const uint8_t*>(a_) + c * kRep * chunk;
      const auto* colr = static_cast<const uint8_t*>(b_) + c * kRep * chunk;
      if (Mode == kRep8NoDot) {
        for (int a = 0; a < kRep; ++a) {
          const int vi = p2r[a * chunk + l];
          if ((vi & (kRep - 1)) == a) add_cell(out_g, vi, l);
          const int vj = colr[a * chunk + l];
          if ((vj & (kRep - 1)) == a) add_cell(out_g, vj, l);
        }
      } else if (l == 0) {
        add_cell(out_g, 0, 0, chunk * (int)p2r[0]);
      }
    }
  }
}

unsigned int chunk_grid(int64_t n_chunks) {
  const int64_t cap = 132 * 8 * 4;
  return (unsigned int)(n_chunks < cap ? n_chunks : cap);
}

}  // namespace

// layout 0: a = p2 u8, b = col i32, v = valid i32; 1: a = p2 u8, b = col u8;
// 2: a = p2r u8, b = colr u8 (n_chunks * 8 rows of `chunk`). `out` holds
// n_groups * 128 * 128 zeroed int32.
extern "C" int mk_lab_hist(int32_t layout, const void* c2g, const void* a,
                           const void* b, const void* v, int64_t n_chunks,
                           int32_t chunk, int32_t n_groups, void* out,
                           void* stream) {
  if (n_chunks <= 0 || chunk <= 0 || n_groups <= 0)
    return (int)cudaErrorInvalidValue;
  const auto* g = static_cast<const int32_t*>(c2g);
  auto* o = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* a8 = static_cast<const uint8_t*>(a);
  const unsigned int grid = chunk_grid(n_chunks);
  switch (layout) {
    case 0:
      hist_kernel<<<grid, kThreads, 0, st>>>(
          PlanesReader{a8, static_cast<const int32_t*>(b),
                       static_cast<const int32_t*>(v)},
          g, n_chunks, chunk, n_groups, o);
      break;
    case 1:
      hist_kernel<<<grid, kThreads, 0, st>>>(
          RowsReader{a8, static_cast<const uint8_t*>(b)}, g, n_chunks, chunk,
          n_groups, o);
      break;
    case 2:
      hist_kernel<<<grid, kThreads, 0, st>>>(
          Rep8Reader{a8, static_cast<const uint8_t*>(b)}, g, n_chunks, chunk,
          n_groups, o);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int mk_lab_group(const void* gmeta, const void* packed,
                            int32_t n_groups, int64_t n_chunks, void* out,
                            void* stream) {
  if (n_groups <= 0 || n_chunks <= 0) return (int)cudaErrorInvalidValue;
  const unsigned int grid = (unsigned int)(n_groups < 65535 ? n_groups : 65535);
  group_kernel<<<grid, 1024, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(gmeta), static_cast<const uint8_t*>(packed),
      n_groups, n_chunks, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}

// mode: DiagMode. Modes 0-3 take chunk == 2048 (the plane layout), modes
// 4-5 any chunk >= 128 that is a multiple of 128.
extern "C" int mk_lab_diag(int32_t mode, const void* c2g, const void* a,
                           const void* b, const void* v, int64_t n_chunks,
                           int32_t chunk, int32_t n_groups, void* out,
                           void* stream) {
  if (n_chunks <= 0 || n_groups <= 0 || chunk < kLanes || chunk % kLanes)
    return (int)cudaErrorInvalidValue;
  if (mode <= kAOnly && chunk != kCR * kLanes)
    return (int)cudaErrorInvalidValue;
  const auto* g = static_cast<const int32_t*>(c2g);
  const auto* vv = static_cast<const int32_t*>(v);
  auto* o = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const unsigned int grid = chunk_grid(n_chunks);
#define MK_DIAG(M)                                                        \
  case M:                                                                 \
    diag_kernel<M><<<grid, kLanes, 0, st>>>(g, a, b, vv, n_chunks, chunk, \
                                            n_groups, o);                 \
    break;
  switch (mode) {
    MK_DIAG(kEmpty)
    MK_DIAG(kOnehotOnly)
    MK_DIAG(kMatmulOnly)
    MK_DIAG(kAOnly)
    MK_DIAG(kRep8NoDot)
    MK_DIAG(kRep8NoConstruct)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MK_DIAG
  return (int)cudaGetLastError();
}
