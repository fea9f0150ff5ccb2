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
// operations per slot. The lab's events are sorted by position, so the
// slots of one (position, strand) -- about 21 at the lab's shape -- lie
// side by side and land on one cell: one global atomic per slot (the first
// design) serialised on a few addresses per warp, ran at 62-71 Gslots/s
// whatever the bytes, and took 3 ms where every event sits at one position.
// The histogram bodies here:
//   - privatise: a block counts a contiguous span of chunks into one
//     group's block in shared memory, as 16-bit counts two to a 32-bit word
//     (32 KB). Where c2g changes inside the span, after every kPieceSlots
//     slots (so no count carries into its neighbour) and at the span's end,
//     the block flushes: it atomicAdds only the nonzero cells to the zeroed
//     output and zeroes its block again. Exact for any order of c2g; a
//     sorted plan flushes once per (group, block).
//   - fill the card in one wave: the grid is kBlocksPerSm blocks per SM
//     (what registers and shared memory allow), the chunks shared out
//     evenly (spans of 4-5, 3-4 and 5-6 chunks for the planes, rows and
//     rep8 readers at the lab's 2 149 chunks on 132 SMs).
//   - aggregate: a lane's 16 consecutive slots add each run of equal cells
//     once (one or two runs at the lab's data). Warp-wide aggregation
//     (__match_any_sync over the lanes, or a ballot over runs of lanes) was
//     slower on the H100 at the lab's shape.
//   - 16-byte loads: a lane takes 16 consecutive slots, one uint4 of each
//     u8 row (rep8: each of the 16 rows); for the int32 planes each load of
//     a warp reads 512 consecutive bytes (lane l takes slots 4 l .. 4 l + 3
//     of each 128). Chunks are multiples of 128 slots (512 for the planes)
//     and the wrappers refuse a base pointer that is not 16-byte aligned,
//     so every load is aligned.
//
// A value outside [0, 128) (col 255 = invalid, u8 values above 127, a
// negative int32) matches no output row or lane in the TPU kernels; here it
// is dropped, never used as an index. Chunks of a group index outside
// [0, n_groups), and run_group chunk ranges past the chunks, count nowhere
// too, as in the plain versions.
//
// Bodies:
//   (a) hist_kernel, templated over the slot layout: PlanesReader (p2 u8,
//       col i32, valid i32: run_variant, run_bigk), RowsReader (p2 u8, col
//       u8 with 255 = invalid: run_bigk_host), Rep8Reader (8 rows per chunk:
//       run_rep8, _count_call);
//   (b) group_kernel: blocks over (group, a sub-range of its gmeta chunk
//       range), RowsReader over the packed chunks (run_group);
//   (c) the diag bodies (see "diag" below): diag_kernel (onehot-only,
//       a-only) over the same shared 16-bit group block, matmul_kernel,
//       no_dot_kernel, no_construct_kernel and empty_kernel.

#include "call.cuh"  // mk_cuda_error_string

namespace {

constexpr int kP2 = 128;
constexpr int kLanes = 128;
constexpr int kCells = kP2 * kLanes;  // one group's block
constexpr int kCR = 16;               // rows of a 2048-slot chunk
constexpr int kRep = 8;               // rows of a rep8 chunk
constexpr int kThreads = 256;
constexpr int kVec = 16;              // slots a thread loads at once
// The shared block holds a group's cells as 16-bit counts, two to a word
// (32 KB). A cell gains at most one per slot, so a block flushes at least
// every kPieceSlots slots and no count carries into its neighbour.
constexpr int kSmemBytes = kCells * 2;
constexpr int kPieceSlots = 32768;
// a group_kernel block takes sub-ranges of kGroupSpan chunks
constexpr int kGroupSpan = 2;

// Adds n to cell `cell` of the 16-bit shared block.
__device__ __forceinline__ void add16(uint32_t* __restrict__ h, int cell,
                                      int n) {
  atomicAdd(&h[cell >> 1], (uint32_t)n << (16 * (cell & 1)));
}

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(static_cast<const uint4*>(p));
}

__device__ __forceinline__ uint32_t word(const uint4& v, int w) {
  return w == 0 ? v.x : w == 1 ? v.y : w == 2 ? v.z : v.w;
}

// Byte s of 16 loaded bytes.
__device__ __forceinline__ int byte_of(const uint4& v, int s) {
  return (word(v, s >> 2) >> (8 * (s & 3))) & 0xff;
}

__device__ __forceinline__ void zero_block(uint32_t* __restrict__ h) {
  uint4* h4 = reinterpret_cast<uint4*>(h);
  for (int q = threadIdx.x; q < kCells / 8; q += blockDim.x)
    h4[q] = make_uint4(0, 0, 0, 0);
  __syncthreads();
}

// Adds the nonzero cells of the shared block to out_g; zeroes the block
// again where more counting follows.
__device__ __forceinline__ void flush(uint32_t* __restrict__ h,
                                      int32_t* __restrict__ out_g,
                                      bool rezero) {
  __syncthreads();
  uint4* h4 = reinterpret_cast<uint4*>(h);
  for (int q = threadIdx.x; q < kCells / 8; q += blockDim.x) {
    const uint4 v = h4[q];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const uint32_t x = word(v, w);
      if (x & 0xffffu) atomicAdd(&out_g[8 * q + 2 * w], (int)(x & 0xffffu));
      if (x >> 16) atomicAdd(&out_g[8 * q + 2 * w + 1], (int)(x >> 16));
    }
    if (rezero) h4[q] = make_uint4(0, 0, 0, 0);
  }
  if (rezero) __syncthreads();
}

// Adds the 16 cells (-1 = none) of a lane's item to the shared block, each
// run of equal cells once: sorted events put the ~21 slots of a (position,
// strand) side by side, so a lane's 16 slots hold one or two runs.
__device__ __forceinline__ void add_runs(uint32_t* __restrict__ h,
                                         const int (&cell)[kVec]) {
  int cur = cell[0], n = 1;
#pragma unroll
  for (int s = 1; s < kVec; ++s) {
    if (cell[s] == cur) {
      ++n;
    } else {
      if (cur >= 0) add16(h, cur, n);
      cur = cell[s];
      n = 1;
    }
  }
  if (cur >= 0) add16(h, cur, n);
}

// Readers: load() brings the bytes of one item (kVec slots of a lane) in
// 16-byte loads; cells() gives each slot's cell, -1 where it counts nowhere
// (has = false: every slot). kBlocksPerSm of a reader's blocks fit an SM
// (registers and shared memory), and its grid is one wave of them.

// Slot-major planes (e = c * chunk + k). A warp's 32 items are 512
// consecutive slots; lane l takes slots 128 q + 4 l .. 128 q + 4 l + 3 of
// them for q < 4, so that each load of the warp reads 512 consecutive
// bytes of an int32 plane (chunk is a multiple of 512).
struct PlanesReader {
  const uint8_t* __restrict__ p2;
  const int32_t* __restrict__ col;
  const int32_t* __restrict__ valid;
  static constexpr int kBlocksPerSm = 4;
  struct Data {
    uint32_t p[4];
    uint4 cv[4], vv[4];
  };
  __device__ Data load(int64_t c, int k, int chunk) const {
    Data d;
    const int lane = threadIdx.x & 31;
    const int64_t e = c * chunk + k - kVec * lane + 4 * lane;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      d.p[q] = __ldg(reinterpret_cast<const uint32_t*>(p2 + e + 128 * q));
      d.cv[q] = load16(col + e + 128 * q);
      d.vv[q] = load16(valid + e + 128 * q);
    }
    return d;
  }
  __device__ void cells(const Data& d, bool has, int64_t, int, int,
                        uint32_t* __restrict__, int (&cell)[kVec]) const {
#pragma unroll
    for (int s = 0; s < kVec; ++s) {
      const int i = (d.p[s >> 2] >> (8 * (s & 3))) & 0xff;
      const int j = (int)word(d.cv[s >> 2], s & 3);
      const bool ok = has && word(d.vv[s >> 2], s & 3) != 0 && i < kP2 &&
                      (unsigned)j < (unsigned)kLanes;
      cell[s] = ok ? i * kLanes + j : -1;
    }
  }
};

// u8 p2 and col (255 = invalid) of slot k of chunk c at c * stride + k:
// run_bigk_host's rows (col = its own plane, stride = chunk) and
// run_group's packed chunks (col = p2 + 2048, stride = 4096).
struct RowsReader {
  const uint8_t* __restrict__ p2;
  const uint8_t* __restrict__ col;
  int64_t stride;
  static constexpr int kBlocksPerSm = 5;
  struct Data {
    uint4 p, q;
  };
  __device__ Data load(int64_t c, int k, int) const {
    return Data{load16(p2 + c * stride + k), load16(col + c * stride + k)};
  }
  __device__ void cells(const Data& d, bool has, int64_t, int, int,
                        uint32_t* __restrict__, int (&cell)[kVec]) const {
#pragma unroll
    for (int s = 0; s < kVec; ++s) {
      const int i = byte_of(d.p, s), j = byte_of(d.q, s);
      cell[s] = has && i < kP2 && j < kLanes ? i * kLanes + j : -1;
    }
  }
};

// Output row i reads replica row i % 8, column j replica row j % 8: a value
// v of row a counts as row v only when v % 8 == a (and v < 128, i.e.
// (v & 0x87) == a). Every matching (a, b) pair of a slot adds at (v_a, v_b)
// (distinct cells, since v_a % 8 == a); with identical rows exactly one pair
// matches and this is the histogram. A slot with more than one pair (rows
// that differ) adds its pairs to the shared block itself and hands the
// adder no cell.
struct Rep8Reader {
  const uint8_t* __restrict__ p2r;
  const uint8_t* __restrict__ colr;
  static constexpr int kBlocksPerSm = 3;
  struct Data {
    uint4 x[kRep], y[kRep];
  };

  __device__ Data load(int64_t c, int k, int chunk) const {
    Data d;
#pragma unroll
    for (int a = 0; a < kRep; ++a) {
      d.x[a] = load16(p2r + (c * kRep + a) * chunk + k);
      d.y[a] = load16(colr + (c * kRep + a) * chunk + k);
    }
    return d;
  }

  // Adds every matching pair of the slot at `base` (row 0, the slot).
  __device__ static void add_pairs(const uint8_t* __restrict__ r,
                                   const uint8_t* __restrict__ s,
                                   int64_t base, int chunk,
                                   uint32_t* __restrict__ h) {
    for (int a = 0; a < kRep; ++a) {
      const int x = r[base + (int64_t)a * chunk];
      if ((x & 0x87) != a) continue;
      for (int b = 0; b < kRep; ++b) {
        const int y = s[base + (int64_t)b * chunk];
        if ((y & 0x87) == b) add16(h, x * kLanes + y, 1);
      }
    }
  }

  __device__ void cells(const Data& d, bool has, int64_t c, int k, int chunk,
                        uint32_t* __restrict__ h, int (&cell)[kVec]) const {
    // per byte: the number of matching rows (n) and, where it is one, the
    // matching value (v: the OR of the matching bytes)
    uint32_t ni[4] = {}, vi[4] = {}, nj[4] = {}, vj[4] = {};
#pragma unroll
    for (int a = 0; a < kRep; ++a) {
      const uint32_t pat = 0x01010101u * a;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const uint32_t mx = __vcmpeq4(word(d.x[a], w) & 0x87878787u, pat);
        const uint32_t my = __vcmpeq4(word(d.y[a], w) & 0x87878787u, pat);
        ni[w] += mx & 0x01010101u;
        vi[w] |= word(d.x[a], w) & mx;
        nj[w] += my & 0x01010101u;
        vj[w] |= word(d.y[a], w) & my;
      }
    }
#pragma unroll
    for (int s = 0; s < kVec; ++s) {
      const int w = s >> 2, sh = 8 * (s & 3);
      const int np =
          has ? (int)(((ni[w] >> sh) & 0xff) * ((nj[w] >> sh) & 0xff)) : 0;
      cell[s] = np == 1 ? (int)(((vi[w] >> sh) & 0xff) * kLanes +
                                ((vj[w] >> sh) & 0xff))
                        : -1;
      if (np > 1) add_pairs(p2r, colr, c * kRep * chunk + k + s, chunk, h);
    }
  }
};

// Counts the items [i_begin, i_end) of kVec slots, warp by warp (every lane
// of a warp runs the same iterations); at(i, c, k) gives item i's chunk and
// first slot and whether it counts.
template <class Reader, class At>
__device__ __forceinline__ void count_items(const Reader& rd, int i_begin,
                                            int i_end, int chunk,
                                            uint32_t* __restrict__ h, At at) {
  const int lane = threadIdx.x & 31;
  for (int i0 = i_begin + threadIdx.x - lane; i0 < i_end; i0 += blockDim.x) {
    const int i = i0 + lane;
    int64_t c = 0;
    int k = 0;
    const bool has = i < i_end && at(i, c, k);
    const typename Reader::Data d =
        has ? rd.load(c, k, chunk) : typename Reader::Data{};
    int cell[kVec];
    rd.cells(d, has, c, k, chunk, h, cell);
    add_runs(h, cell);
  }
}

// Block b of B counts chunks [b n_chunks / B, (b + 1) n_chunks / B) (at
// most kThreads): each run of equal c2g in pieces of at most kPieceSlots
// slots, flushing after each piece.
template <class Reader>
__global__ void __launch_bounds__(kThreads, Reader::kBlocksPerSm)
    hist_kernel(Reader rd, const int32_t* __restrict__ c2g, int64_t n_chunks,
                int chunk, int n_groups, int32_t* __restrict__ out) {
  extern __shared__ uint4 smem[];
  __shared__ int span_g[kThreads];  // c2g of the block's span
  uint32_t* h = reinterpret_cast<uint32_t*>(smem);
  const int64_t c_begin = blockIdx.x * n_chunks / gridDim.x;
  const int n = (int)((blockIdx.x + 1) * n_chunks / gridDim.x - c_begin);
  const int per_chunk = chunk / kVec;
  const int per_piece = kPieceSlots / kVec;
  for (int t = threadIdx.x; t < n; t += blockDim.x)
    span_g[t] = c2g[c_begin + t];
  zero_block(h);
  for (int t = 0; t < n;) {
    const int g = span_g[t];
    int e = t + 1;
    while (e < n && span_g[e] == g) ++e;
    if ((unsigned)g < (unsigned)n_groups) {
      const int64_t c0 = c_begin + t;
      const int items = (e - t) * per_chunk;
      for (int i = 0; i < items; i += per_piece) {
        const int i_end = items - i < per_piece ? items : i + per_piece;
        count_items(rd, i, i_end, chunk, h, [&](int j, int64_t& c, int& k) {
          c = c0 + j / per_chunk;
          k = (j % per_chunk) * kVec;
          return true;
        });
        flush(h, out + (int64_t)g * kCells, e < n || i_end < items);
      }
    }
    t = e;
  }
}

// gmeta: counts [n_groups], then starts [n_groups]; packed: per chunk kCR
// rows of p2, then kCR rows of col (255 = invalid), kLanes wide. Block
// (g, x) of gridDim.y counts sub-ranges x, x + gridDim.y, ... of kGroupSpan
// chunks of group g's range, flushing after each kPieceSlots slots and at
// the end.
__global__ void __launch_bounds__(kThreads, RowsReader::kBlocksPerSm)
    group_kernel(const int32_t* __restrict__ gmeta,
                 const uint8_t* __restrict__ packed, int n_groups,
                 int64_t n_chunks, int32_t* __restrict__ out) {
  constexpr int kSlots = kCR * kLanes;
  constexpr int kPerChunk = kSlots / kVec;
  constexpr int kSubsPerPiece = kPieceSlots / (kGroupSpan * kSlots);
  extern __shared__ uint4 smem[];
  uint32_t* h = reinterpret_cast<uint32_t*>(smem);
  const int g = blockIdx.x;
  const int64_t cnt = gmeta[g];
  const int64_t start = gmeta[n_groups + g];
  if ((int64_t)blockIdx.y * kGroupSpan >= cnt) return;  // no sub-range here
  int32_t* out_g = out + (int64_t)g * kCells;
  zero_block(h);
  const RowsReader rd{packed, packed + kSlots, 2 * kSlots};
  int subs = 0;
  for (int64_t sub = blockIdx.y; sub * kGroupSpan < cnt; sub += gridDim.y) {
    if (subs++ == kSubsPerPiece) {
      flush(h, out_g, true);
      subs = 1;
    }
    const int64_t c0 = start + sub * kGroupSpan;
    const int64_t left = cnt - sub * kGroupSpan;
    const int n = left < kGroupSpan ? (int)left : kGroupSpan;
    count_items(rd, 0, n * kPerChunk, kSlots, h,
                [&](int i, int64_t& c, int& k) {
                  c = c0 + i / kPerChunk;
                  k = (i % kPerChunk) * kVec;
                  return c >= 0 && c < n_chunks;
                });
  }
  flush(h, out_g, false);
}

// The current device's SM count.
int sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)e;
}

// One wave of Reader::kBlocksPerSm blocks on each SM over the chunks,
// shared out evenly; more blocks where a span would pass kThreads chunks.
template <class Reader>
int launch_hist(const Reader& rd, const int32_t* c2g, int64_t n_chunks,
                int chunk, int n_groups, int32_t* out, cudaStream_t st) {
  int sms = 0;
  const int rc = sm_count(&sms);
  if (rc != 0) return rc;
  const int64_t wave = (int64_t)Reader::kBlocksPerSm * sms;
  const int64_t least = (n_chunks + kThreads - 1) / kThreads;
  int64_t blocks = wave > least ? wave : least;
  if (blocks > n_chunks) blocks = n_chunks;
  hist_kernel<Reader><<<(unsigned int)blocks, kThreads, kSmemBytes, st>>>(
      rd, c2g, n_chunks, chunk, n_groups, out);
  return (int)cudaGetLastError();
}

// ---- diag: run_diag's four modes and run_rep8's two ablations ----
//
// Modes 1-3 read the planes of PlanesReader (a = p2 u8, b = col i32, v =
// valid i32, chunk = kCR * kLanes = 2048 slots: row r, lane l is slot
// r * kLanes + l); modes 4-5 the rep8 rows (a = p2r, b = colr, kRep rows
// of `chunk` per chunk). What each adds per chunk of group g:
enum DiagMode {
  kEmpty = 0,        // nothing (the output's zeros, written here)
  kOnehotOnly = 1,   // +1 at (p2[r, l], l); +1 at (col[r, l], l) if valid
  kMatmulOnly = 2,   // +kCR at (p2[0, l], col[0, l]) if valid[0, l]
  kAOnly = 3,        // +1 at (p2[r, l], col[0, l]) if valid[0, l], r < kCR
  kRep8NoDot = 4,    // +1 at (v, l) for v = p2r or colr of row v % 8, l < 128
  kRep8NoConstruct = 5,  // out[g, 0, 0] += chunk * p2r[row 0, slot 0]
};
//
// The first design ran one block per chunk with one global atomic per
// counted slot: 8.8 M of them for onehot-only, and in a-only the lanes
// whose (p2, col[0]) agree -- most of a warp on sorted events -- hit one
// address, which the hardware serialises (3.07 ms where every event sits
// at one position). Each mode now has the body that measured fastest on
// the H100 (tools/call_bench.py --lab; PERF.md):
//   onehot-only, a-only: diag_kernel, a group's block privatised in shared
//     memory as 16-bit counts, as the histograms do;
//   matmul-only: matmul_kernel, one thread per 16 lanes of row 0 adding
//     its runs of equal cells straight to the output (a chunk adds 128
//     cells at most: a shared block's fixed costs outweigh its atomics);
//   no-dot: no_dot_kernel, one block per chunk, one global atomic per
//     matching slot (the first design: neither shared-block nor 16-byte
//     direct bodies beat it);
//   no-construct: one thread per chunk, one global atomic each, its least;
//   empty: empty_kernel, which writes every cell of the output as zeros
//     with 16-byte stores, as the TPU body zeroes each group's block, and
//     loads what the TPU body touches (c2g, and row 0 of p2 and col of each
//     chunk) behind the stores, in one launch: its wrapper zeroes nothing.
//
// diag_kernel. Items: kItems per chunk, each a lane's 16 slots, loaded 16
// bytes at a time (the wrapper refuses a base pointer that is not 16-byte
// aligned):
//   onehot-only  128: 4 slots of each of 4 rows, lane t of a warp taking
//                lanes 4t .. 4t + 3 (PlanesReader's pattern), so a warp's
//                atomics fall on one row's distinct cells;
//   a-only       128: 16 lanes of row r, with row 0's col and valid (L1),
//                each run of equal cells added once (add_runs).
// 16-bit counts stay exact: a block flushes at least every kDiagPiece
// chunks, and in one chunk a cell gains at most
//   onehot-only  32: a slot adds at most 2, and only to cells of its own
//                lane, which holds kCR slots of the chunk;
//   a-only       2048: one for each of the chunk's 2048 slots;
// so at most 16 x 2048 = 32768 < 65536 per flush.
//
// Spans that follow the groups (onehot-only): its block of a group is
// dense (about 14 000 of 16 384 cells nonzero at the lab's shape), so a
// group split over several blocks would cost each of them a dense flush of
// global atomics (measured slower on the H100). Block b starts at the
// nominal b * n_chunks / B moved on to the start of the next run of equal
// c2g, unless the run it falls in is longer than kAlign chunks (then it
// splits there); so a run of at most kAlign chunks is counted by one
// block. When c2g is non-decreasing (each such block checks all of it) and
// a run is its group's whole run, that block is the group's only writer,
// and it stores its nonzero cells into the zeroed output instead of adding
// them (on the H100 flushing these blocks with atomics took 1.71x the
// time: tools/call_bench.py --lab, PERF.md). Anywhere else (c2g in another
// order, a long run, a group at a span's edge) it adds them with atomics,
// which is exact for any plan. The check reads all of c2g in every block,
// blocks x n_chunks loads from L2 (264 x 2 149 at the lab's shape).
// a-only's block is sparse (about 1 200 nonzero cells per group): its
// blocks take the nominal spans (kAlign = 0), which keeps every block busy,
// and always flush with atomics.
constexpr int kDiagPiece = 16;  // chunks between flushes at most
// a diag_kernel body's threads per block (kThreads); 1024 / kThreads of its
// blocks fit an SM (registers: up to 64 per thread)
constexpr int kDiagSmThreads = 1024;

struct DiagArgs {
  const uint8_t* __restrict__ a;
  const void* __restrict__ b;
  const int32_t* __restrict__ v;
};

template <int Mode>
struct DiagBody;

template <>
struct DiagBody<kOnehotOnly> {
  static constexpr int kThreads = 512;
  static constexpr int kAlign = kDiagPiece;
  static constexpr int kItems = kCR * kLanes / kVec;
  __device__ static void add(const DiagArgs& d, int64_t c, int i,
                             uint32_t* __restrict__ h) {
    const auto* col = static_cast<const int32_t*>(d.b);
    const int t = i & 31;
    const int64_t e0 = c * (kCR * kLanes) + (i >> 5) * 4 * kLanes + 4 * t;
    uint32_t p[4];
    uint4 cv[4], vv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int64_t e = e0 + q * kLanes;
      p[q] = __ldg(reinterpret_cast<const uint32_t*>(d.a + e));
      cv[q] = load16(col + e);
      vv[q] = load16(d.v + e);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int l = 4 * t + s;
        const int x = (p[q] >> (8 * s)) & 0xff;
        const int y = (int)word(cv[q], s);
        const bool ox = x < kP2;
        const bool oy = word(vv[q], s) != 0 && (unsigned)y < (unsigned)kP2;
        if (ox && oy && x == y) {
          add16(h, x * kLanes + l, 2);
        } else {
          if (ox) add16(h, x * kLanes + l, 1);
          if (oy) add16(h, y * kLanes + l, 1);
        }
      }
    }
  }
};

// The cells (p2[r, l], col[0, l]) of lanes 16 k .. 16 k + 15 of chunk c,
// where valid[0, l] and col[0, l] is in range; -1 elsewhere.
__device__ __forceinline__ void row0_cells(const DiagArgs& d, int64_t c,
                                           int r, int k,
                                           int (&cell)[kVec]) {
  const auto* col = static_cast<const int32_t*>(d.b);
  const int64_t e0 = c * (kCR * kLanes) + kVec * k;
  const uint4 p = load16(d.a + e0 + r * kLanes);
  uint4 cv[4], vv[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    cv[q] = load16(col + e0 + 4 * q);
    vv[q] = load16(d.v + e0 + 4 * q);
  }
#pragma unroll
  for (int s = 0; s < kVec; ++s) {
    const int x = byte_of(p, s);
    const int y = (int)word(cv[s >> 2], s & 3);
    const bool ok = word(vv[s >> 2], s & 3) != 0 && x < kP2 &&
                    (unsigned)y < (unsigned)kLanes;
    cell[s] = ok ? x * kLanes + y : -1;
  }
}

template <>
struct DiagBody<kAOnly> {
  static constexpr int kThreads = 256;
  static constexpr int kAlign = 0;
  static constexpr int kItems = kCR * kLanes / kVec;
  __device__ static void add(const DiagArgs& d, int64_t c, int i,
                             uint32_t* __restrict__ h) {
    int cell[kVec];
    row0_cells(d, c, i >> 3, i & 7, cell);
    add_runs(h, cell);
  }
};

// Where the block whose nominal span starts at chunk a starts (see "Spans
// that follow the groups"): a itself if a run of equal c2g starts there or
// the run holding a is longer than kAlign chunks, else that run's end. It
// depends on a alone, so neighbouring blocks agree and the spans tile the
// chunks. at(c) is c2g[c]; it reads chunks a - kAlign - 1 .. a + kAlign.
template <int kAlign, class At>
__device__ int64_t diag_start(At at, int64_t n, int64_t a) {
  if (a <= 0) return 0;
  if (a >= n) return n;
  const int g = at(a);
  int64_t s = a;
  while (s > 0 && a - s <= kAlign && at(s - 1) == g) --s;
  if (s == a) return a;
  int64_t e = a + 1;
  while (e < n && e - s <= kAlign && at(e) == g) ++e;
  return e - s <= kAlign ? e : a;
}

// Stores the nonzero cells of the shared block into out_g, which the block
// alone writes (its zeros are the wrapper's); zeroes the block again where
// more counting follows.
__device__ __forceinline__ void store_block(uint32_t* __restrict__ h,
                                            int32_t* __restrict__ out_g,
                                            bool rezero) {
  __syncthreads();
  uint4* h4 = reinterpret_cast<uint4*>(h);
  int4* o4 = reinterpret_cast<int4*>(out_g);
  for (int q = threadIdx.x; q < kCells / 8; q += blockDim.x) {
    const uint4 v = h4[q];
    if (v.x | v.y | v.z | v.w) {
      o4[2 * q] = make_int4(v.x & 0xffff, v.x >> 16, v.y & 0xffff, v.y >> 16);
      o4[2 * q + 1] =
          make_int4(v.z & 0xffff, v.z >> 16, v.w & 0xffff, v.w >> 16);
      if (rezero) h4[q] = make_uint4(0, 0, 0, 0);
    }
  }
  if (rezero) __syncthreads();
}

// A block reads c2g around its nominal span into shared memory at once,
// one entry per thread: the span, kDiagPiece chunks and one more on each
// side (what diag_start and the run bounds look at). So a nominal span
// holds at most nominal<Body>() chunks, and more blocks than one wave run
// where n_chunks needs them.
template <class Body>
constexpr int nominal() {
  return Body::kThreads - 2 * kDiagPiece - 2;
}

template <int Mode>
__global__ void __launch_bounds__(DiagBody<Mode>::kThreads,
                                  kDiagSmThreads / DiagBody<Mode>::kThreads)
    diag_kernel(DiagArgs d, const int32_t* __restrict__ c2g,
                int64_t n_chunks, int n_groups, int32_t* __restrict__ out) {
  using Body = DiagBody<Mode>;
  constexpr int kAlign = Body::kAlign;
  static_assert(kAlign <= kDiagPiece, "a whole run is one piece");
  extern __shared__ uint4 smem[];
  __shared__ int win[Body::kThreads];  // c2g[w0 ..], -1 outside the chunks
  __shared__ int64_t span[2];
  uint32_t* h = reinterpret_cast<uint32_t*>(smem);
  const int64_t a0 = blockIdx.x * n_chunks / gridDim.x;
  const int64_t w0 = a0 - kDiagPiece - 1;
  {
    const int64_t c = w0 + threadIdx.x;
    win[threadIdx.x] = c >= 0 && c < n_chunks ? c2g[c] : -1;
  }
  // c2g non-decreasing? (with the window's loads in flight; only a block
  // that may store needs to know)
  bool unsorted = kAlign == 0;
  if (kAlign > 0) {
#pragma unroll 4
    for (int64_t c = threadIdx.x; c + 1 < n_chunks; c += blockDim.x)
      unsorted |= c2g[c] > c2g[c + 1];
  }
  const bool sorted = !__syncthreads_or(unsorted);
  const auto at = [&](int64_t c) { return win[c - w0]; };
  if (threadIdx.x < 2)
    span[threadIdx.x] = diag_start<kAlign>(
        at, n_chunks, (blockIdx.x + threadIdx.x) * n_chunks / gridDim.x);
  __syncthreads();
  const int64_t c_begin = span[0], c_end = span[1];
  if (c_begin >= c_end) return;
  zero_block(h);
  for (int64_t t = c_begin; t < c_end;) {
    const int g = at(t);
    int64_t e = t + 1;
    while (e < c_end && at(e) == g) ++e;
    if ((unsigned)g < (unsigned)n_groups) {
      int32_t* out_g = out + (int64_t)g * kCells;
      const bool alone = sorted && e - t <= kDiagPiece &&
                         (t == 0 || at(t - 1) != g) &&
                         (e == n_chunks || at(e) != g);
      for (int64_t c0 = t; c0 < e; c0 += kDiagPiece) {
        const int n = (int)(e - c0 < kDiagPiece ? e - c0 : kDiagPiece);
        for (int i = threadIdx.x; i < n * Body::kItems; i += blockDim.x)
          Body::add(d, c0 + i / Body::kItems, i % Body::kItems, h);
        const bool more = c0 + n < e || e < c_end;
        if (alone)
          store_block(h, out_g, more);
        else
          flush(h, out_g, more);
      }
    }
    t = e;
  }
}

template <int Mode>
int launch_diag(const DiagArgs& d, const int32_t* c2g, int64_t n_chunks,
                int n_groups, int32_t* out, cudaStream_t st) {
  int sms = 0;
  const int rc = sm_count(&sms);
  if (rc != 0) return rc;
  using Body = DiagBody<Mode>;
  const int64_t wave = (int64_t)(kDiagSmThreads / Body::kThreads) * sms;
  const int64_t least = (n_chunks + nominal<Body>() - 1) / nominal<Body>();
  int64_t blocks = wave > least ? wave : least;
  if (blocks > n_chunks) blocks = n_chunks;
  diag_kernel<Mode><<<(unsigned int)blocks, Body::kThreads, kSmemBytes,
                      st>>>(d, c2g, n_chunks, n_groups, out);
  return (int)cudaGetLastError();
}

// matmul-only: thread i takes lanes 16 (i % 8) .. + 15 of row 0 of chunk
// i / 8 and adds kCR x each run of equal cells once.
__global__ void __launch_bounds__(kThreads)
    matmul_kernel(DiagArgs d, const int32_t* __restrict__ c2g,
                  int64_t n_chunks, int n_groups, int32_t* __restrict__ out) {
  constexpr int kItems = kLanes / kVec;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_chunks * kItems; i += stride) {
    const int64_t c = i / kItems;
    const int g = c2g[c];
    if ((unsigned)g >= (unsigned)n_groups) continue;
    int32_t* out_g = out + (int64_t)g * kCells;
    int cell[kVec];
    row0_cells(d, c, 0, (int)(i % kItems), cell);
    int cur = cell[0], n = 1;
#pragma unroll
    for (int s = 1; s < kVec; ++s) {
      if (cell[s] == cur) {
        ++n;
      } else {
        if (cur >= 0) atomicAdd(&out_g[cur], n * kCR);
        cur = cell[s];
        n = 1;
      }
    }
    if (cur >= 0) atomicAdd(&out_g[cur], n * kCR);
  }
}

// no-dot: one block of kLanes threads per chunk, one thread per lane.
__global__ void no_dot_kernel(const int32_t* __restrict__ c2g,
                              const uint8_t* __restrict__ p2r,
                              const uint8_t* __restrict__ colr,
                              int64_t n_chunks, int chunk, int n_groups,
                              int32_t* __restrict__ out) {
  const int l = threadIdx.x;
  for (int64_t c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int g = c2g[c];
    if ((unsigned)g >= (unsigned)n_groups) continue;
    int32_t* out_g = out + (int64_t)g * kCells;
    const uint8_t* r = p2r + c * kRep * chunk;
    const uint8_t* s = colr + c * kRep * chunk;
    for (int a = 0; a < kRep; ++a) {
      const int vi = r[a * chunk + l];
      if ((vi & 0x87) == a) atomicAdd(&out_g[vi * kLanes + l], 1);
      const int vj = s[a * chunk + l];
      if ((vj & 0x87) == a) atomicAdd(&out_g[vj * kLanes + l], 1);
    }
  }
}

// no-construct: one thread per chunk.
__global__ void no_construct_kernel(const int32_t* __restrict__ c2g,
                                    const uint8_t* __restrict__ p2r,
                                    int64_t n_chunks, int chunk, int n_groups,
                                    int32_t* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       c < n_chunks; c += stride) {
    const int g = c2g[c];
    if ((unsigned)g < (unsigned)n_groups)
      atomicAdd(&out[(int64_t)g * kCells], chunk * (int)p2r[c * kRep * chunk]);
  }
}

// Keeps x computed: an empty asm statement that reads it.
__device__ __forceinline__ void keep(uint32_t x) { asm volatile("" ::"r"(x)); }

// empty: writes every cell of the output as zeros and loads what the TPU
// body touches, c2g and row 0 of p2 and col of each chunk, kept live. One
// wave, grid-stride: item i stores 16 zero bytes of the output, and where
// i < n_chunks * kItems also loads 16 bytes of chunk i / kItems's row 0
// (items 0-7 p2's 128 bytes, 8-39 col's 512, the first item c2g), so the
// loads are in flight behind the stores.
__global__ void __launch_bounds__(kThreads)
    empty_kernel(DiagArgs d, const int32_t* __restrict__ c2g,
                 int64_t n_chunks, int64_t n_quads,
                 int4* __restrict__ out) {
  constexpr int kP2Items = kLanes / kVec;
  constexpr int kItems = kP2Items + kLanes * 4 / kVec;
  const auto* col = static_cast<const int32_t*>(d.b);
  const int64_t n_loads = n_chunks * kItems;
  const int64_t n = n_quads > n_loads ? n_quads : n_loads;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  uint32_t acc = 0;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (i < n_loads) {
      const int64_t c = i / kItems;
      const int k = (int)(i % kItems);
      const int64_t e0 = c * (kCR * kLanes);
      const uint4 x = k < kP2Items ? load16(d.a + e0 + kVec * k)
                                   : load16(col + e0 + 4 * (k - kP2Items));
      acc ^= x.x ^ x.y ^ x.z ^ x.w;
      if (k == 0) acc ^= (uint32_t)__ldg(c2g + c);
    }
    if (i < n_quads) out[i] = make_int4(0, 0, 0, 0);
  }
  keep(acc);
}

}  // namespace

// layout 0: a = p2 u8, b = col i32, v = valid i32; 1: a = p2 u8, b = col u8;
// 2: a = p2r u8, b = colr u8 (n_chunks * 8 rows of `chunk`). `out` holds
// n_groups * 128 * 128 zeroed int32. chunk is a multiple of 128 and a, b,
// v are 16-byte aligned.
extern "C" int mk_lab_hist(int32_t layout, const void* c2g, const void* a,
                           const void* b, const void* v, int64_t n_chunks,
                           int32_t chunk, int32_t n_groups, void* out,
                           void* stream) {
  if (n_chunks <= 0 || n_groups <= 0 || chunk < kLanes || chunk % kLanes ||
      (layout == 0 && chunk % (32 * kVec)))
    return (int)cudaErrorInvalidValue;
  const auto* g = static_cast<const int32_t*>(c2g);
  auto* o = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* a8 = static_cast<const uint8_t*>(a);
  const auto* b8 = static_cast<const uint8_t*>(b);
  switch (layout) {
    case 0:
      return launch_hist(
          PlanesReader{a8, static_cast<const int32_t*>(b),
                       static_cast<const int32_t*>(v)},
          g, n_chunks, chunk, n_groups, o, st);
    case 1:
      return launch_hist(RowsReader{a8, b8, chunk}, g, n_chunks, chunk,
                         n_groups, o, st);
    case 2:
      return launch_hist(Rep8Reader{a8, b8}, g, n_chunks, chunk, n_groups, o,
                         st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// packed is 16-byte aligned. Each group gets gridDim.y blocks: twice the
// mean group's sub-ranges, so an even plan fills the card and a large
// group still spreads (nothing reads gmeta back to the host).
extern "C" int mk_lab_group(const void* gmeta, const void* packed,
                            int32_t n_groups, int64_t n_chunks, void* out,
                            void* stream) {
  if (n_groups <= 0 || n_chunks <= 0) return (int)cudaErrorInvalidValue;
  const int64_t per_group =
      (2 * n_chunks + (int64_t)n_groups * kGroupSpan - 1) /
      ((int64_t)n_groups * kGroupSpan);
  const dim3 grid((unsigned int)n_groups,
                  (unsigned int)(per_group < 65535 ? per_group : 65535));
  group_kernel<<<grid, kThreads, kSmemBytes,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(gmeta), static_cast<const uint8_t*>(packed),
      n_groups, n_chunks, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}

// mode: DiagMode. Modes 0-3 take chunk == 2048 (the plane layout), modes
// 4-5 any chunk >= 128 that is a multiple of 128. Modes 0-3 read a, b, v
// 16 bytes at a time: they are 16-byte aligned. Mode 0 writes every cell of
// `out` (16-byte aligned), so it need not be zeroed; modes 1-5 add into
// `out`, which holds n_groups * 128 * 128 zeroed int32.
extern "C" int mk_lab_diag(int32_t mode, const void* c2g, const void* a,
                           const void* b, const void* v, int64_t n_chunks,
                           int32_t chunk, int32_t n_groups, void* out,
                           void* stream) {
  if (n_chunks <= 0 || n_groups <= 0 || chunk < kLanes || chunk % kLanes)
    return (int)cudaErrorInvalidValue;
  if (mode <= kAOnly && chunk != kCR * kLanes)
    return (int)cudaErrorInvalidValue;
  const auto* g = static_cast<const int32_t*>(c2g);
  auto* o = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const DiagArgs d{static_cast<const uint8_t*>(a), b,
                   static_cast<const int32_t*>(v)};
  const int64_t per_chunk = n_chunks < 132 * 8 * 4 ? n_chunks : 132 * 8 * 4;
  switch (mode) {
    case kEmpty: {
      if (reinterpret_cast<uintptr_t>(out) % 16)
        return (int)cudaErrorInvalidValue;
      int sms = 0;
      const int rc = sm_count(&sms);
      if (rc != 0) return rc;
      const int64_t quads = (int64_t)n_groups * kCells / 4;
      const int64_t loads = n_chunks * (kLanes * 5 / kVec);
      const int64_t items = quads > loads ? quads : loads;
      const int64_t wave = (int64_t)sms * (2048 / kThreads);
      const int64_t need = (items + kThreads - 1) / kThreads;
      empty_kernel<<<(unsigned int)(need < wave ? need : wave), kThreads, 0,
                     st>>>(d, g, n_chunks, quads, reinterpret_cast<int4*>(o));
      return (int)cudaGetLastError();
    }
    case kOnehotOnly:
      return launch_diag<kOnehotOnly>(d, g, n_chunks, n_groups, o, st);
    case kMatmulOnly:
      matmul_kernel<<<grid_for(n_chunks * (kLanes / kVec), kThreads),
                      kThreads, 0, st>>>(d, g, n_chunks, n_groups, o);
      return (int)cudaGetLastError();
    case kAOnly:
      return launch_diag<kAOnly>(d, g, n_chunks, n_groups, o, st);
    case kRep8NoDot:
      no_dot_kernel<<<(unsigned int)per_chunk, kLanes, 0, st>>>(
          g, d.a, static_cast<const uint8_t*>(b), n_chunks, chunk, n_groups,
          o);
      return (int)cudaGetLastError();
    case kRep8NoConstruct:
      no_construct_kernel<<<grid_for(n_chunks, kThreads), kThreads, 0, st>>>(
          g, d.a, n_chunks, chunk, n_groups, o);
      return (int)cudaGetLastError();
    default:
      return (int)cudaErrorInvalidValue;
  }
}
