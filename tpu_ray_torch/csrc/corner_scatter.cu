// A ray block's mesh corners, gathered by triangle, and the gather's
// backward: the vertex gradient's scatter of the (R, 9) corner cotangent
// into the (T, 10) triangle table, summed by triangle.
//
// The JAX package has no Pallas kernel here. It gathers a block's corners
// with `mesh_rows[idx][:, :9]` (tpu_ray/render/render.py:615), and XLA
// writes the gather's transpose, a scatter-add by triangle; these two
// kernels are the counterpart of that gather and of XLA's transpose. The
// port ran torch's autograd of the same indexing, whose backward is a
// sorted `index_put_(accumulate=True)` in which one warp walks a triangle's
// rows one duplicate after another: a `mixed` block's rays hit few
// triangles (the ground quad's two, and the misses clamped to triangle 0,
// in runs of thousands), so its longest run set its time, 6.1 ms a block.
// Plain PyTorch versions: `corner_gather_torch` and `corner_scatter_torch`
// in tpu_ray_torch/kernels/cuda_scatter.py (the indexing and its autograd).
//
// What bounds them on an H100: bytes. The gather reads R ids and R rows of
// 40 B and writes R x 36 B; the scatter reads R ids and R x 36 B of
// cotangent and writes the (T, 10) gradient, zero where no ray landed: at
// R = 32,768 and T = 69,938, ~4.3 MB, ~0.0013 ms.
//
// The scatter's design (`tr_corner_scatter`): deterministic, parallel
// within a triangle's run of rows, no float atomic.
//   * Tiles of kTile rays, a block each (`corner_tile_kernel`). The tile's
//     (triangle, lane) keys are sorted in shared memory (bitonic; the keys
//     are unique, so a triangle's rows stay in ray order), then a segmented
//     inclusive scan over the sorted rows (Hillis-Steele: log2(kTile)
//     levels, a fixed tree) leaves each triangle's tile partial at its run's
//     last row. The tile's sorted ids, partials and row counts go to
//     scratch; each triangle ORs its tile's bit into its mask of tiles (an
//     integer atomic, whose result does not depend on the order).
//   * The combine (`corner_combine_kernel`, a thread a tile row). The run's
//     end in a triangle's first tile (the mask's lowest bit) owns the
//     triangle. Alone in the mask, it writes its partial. Otherwise 32 lanes
//     take the later tiles of the mask, lane l every 32nd from the owner's
//     tile + 1 + l, each found by a binary search in that tile's sorted ids
//     and summed in tile order; a fixed tree over the lanes, then the
//     owner's partial, gives the gradient's row.
//   * The zero fill of the gradient and of the masks: cudaMemsetAsync, in
//     the same entry point.
// A triangle's sum is the same tree over the same rows on every run, so
// the gradient is bit-identical from run to run; only the order of a
// float32 sum differs from a serial one. Rows with ids outside [0, T), which
// the wrapper refuses, are skipped (the gather writes zeros for them).
//
// Counters (cuda_scatter.COUNTERS; always on): launches, rows in, rows with
// a nonzero cotangent, segments (distinct triangles) and the longest
// segment's rows, each added (or maxed) by one global integer atomic a
// block after a block-level sum.
//
// Everything above the __CUDACC__ guard also builds as host C++: a block's
// threads run each stretch between barriers in turn (TRCS_LANES), so the CPU
// tests run the kernels' own arithmetic and order
// (tests/test_torch_corner_scatter.py).
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#else  // a host build, for the CPU tests
#define __host__
#define __device__
#define __forceinline__ inline
#endif

namespace trcs {

constexpr int kTile = 1024;                   // rays a tile (a corner_tile_kernel block)
constexpr int kTileThreads = kTile / 2;       // two sorted rows a thread
constexpr int kCombineRows = 32;              // tile rows a corner_combine_kernel block
constexpr int kLanes = 32;                    // lanes that combine one triangle's tiles
constexpr int kCombineThreads = 256;          // kGroups triangles at a time
constexpr int kGroups = kCombineThreads / kLanes;
constexpr unsigned kNone = 0xffffffffu;       // the sorted id of a row past n

// the counter buffer's entries (cuda_scatter.COUNTERS)
enum Counter { kLaunches, kRows, kRowsNonzero, kSegments, kLongest };

struct TileShared {
  unsigned long long key[kTile];  // (id << 32) | row in tile; ~0 for a row past n
  float val[kTile * 9];           // the tile's cotangent rows, then the scan's exchange
  unsigned long long tally[2];    // rows in, rows with a nonzero cotangent
};

// A tile thread's two sorted rows, kept from one stretch to the next.
struct TileLane {
  int tid;
  unsigned id[2];
  int head[2];  // the first sorted row of the row's run
  float v[2][9];
};

struct CombineShared {
  int owners[kCombineRows];                  // owned runs whose triangle spans tiles
  int n_owners;
  float part[kCombineThreads * 9];
  int count[kCombineThreads];
  unsigned long long tally[2];               // segments, the longest segment's rows
};

struct CombineLane {
  int tid;
};

// The scatter's scratch, carved from one buffer: the triangles' tile masks,
// then the tiles' partials, sorted ids and run counts.
struct Scratch {
  unsigned long long* mask;
  float* val;
  unsigned* id;
  int* count;
  int n_tiles, n_words;
};

inline int tiles_of(int n) { return (n + kTile - 1) / kTile; }

inline long long scratch_bytes(int n, int n_tris) {
  const long long rows = static_cast<long long>(tiles_of(n)) * kTile;
  const long long words = (tiles_of(n) + 63) / 64;
  return 8 * words * n_tris + rows * (9 * 4 + 4 + 4);
}

inline Scratch carve(void* base, int n, int n_tris) {
  Scratch s;
  s.n_tiles = tiles_of(n);
  s.n_words = (s.n_tiles + 63) / 64;
  const long long rows = static_cast<long long>(s.n_tiles) * kTile;
  s.mask = static_cast<unsigned long long*>(base);
  s.val = reinterpret_cast<float*>(s.mask + static_cast<long long>(s.n_words) * n_tris);
  s.id = reinterpret_cast<unsigned*>(s.val + 9 * rows);
  s.count = reinterpret_cast<int*>(s.id + rows);
  return s;
}

// Row r of the gather: the nine corners of triangle idx[r] (zeros for an id
// outside [0, n_tris)).
__host__ __device__ __forceinline__ float gather_one(const float* rows, int n_tris,
                                                      const int* idx, long long e) {
  const long long r = e / 9;
  const int id = idx[r];
  return id >= 0 && id < n_tris ? rows[10 * static_cast<long long>(id) + (e - 9 * r)] : 0.0f;
}

// The sorted row of tile `ids` (kTile sorted ids) that ends id's run.
__host__ __device__ __forceinline__ int run_end(const unsigned* ids, unsigned id) {
  int lo = 0, hi = kTile;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ids[mid] <= id)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo - 1;
}

#ifdef __CUDACC__
#define TRCS_LANES(...) { auto& L = *lanes; (void)L; __VA_ARGS__ }
#define TRCS_SYNC() __syncthreads()

__device__ __forceinline__ int shared_add(int* w, int v) { return atomicAdd(w, v); }
__device__ __forceinline__ void shared_add64(unsigned long long* w, unsigned long long v) {
  atomicAdd(w, v);
}
__device__ __forceinline__ void shared_max64(unsigned long long* w, unsigned long long v) {
  atomicMax(w, v);
}
__device__ __forceinline__ void mask_or(unsigned long long* w, unsigned long long v) {
  atomicOr(w, v);
}
__device__ __forceinline__ void counter_add(unsigned long long* c, unsigned long long v) {
  atomicAdd(c, v);
}
__device__ __forceinline__ void counter_max(unsigned long long* c, unsigned long long v) {
  atomicMax(c, v);
}
// A warp's sum of v, and whether this thread adds it for the warp.
__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
__device__ __forceinline__ bool warp_lead(int tid) { return (tid & 31) == 0; }
__device__ __forceinline__ int lowest_bit(unsigned long long m) { return __ffsll(m) - 1; }
__device__ __forceinline__ int bit_count(unsigned long long m) { return __popcll(m); }
#else
#define TRCS_LANES(...) \
  for (int lane_ = 0; lane_ < n_lanes; ++lane_) { auto& L = lanes[lane_]; (void)L; __VA_ARGS__ }
#define TRCS_SYNC() ((void)0)

inline int shared_add(int* w, int v) { const int old = *w; *w += v; return old; }
inline void shared_add64(unsigned long long* w, unsigned long long v) { *w += v; }
inline void shared_max64(unsigned long long* w, unsigned long long v) { if (v > *w) *w = v; }
inline void mask_or(unsigned long long* w, unsigned long long v) { *w |= v; }
inline void counter_add(unsigned long long* c, unsigned long long v) { *c += v; }
inline void counter_max(unsigned long long* c, unsigned long long v) { if (v > *c) *c = v; }
inline unsigned long long warp_sum(unsigned long long v) { return v; }  // a lane at a time
inline bool warp_lead(int) { return true; }
inline int lowest_bit(unsigned long long m) { return __builtin_ctzll(m); }
inline int bit_count(unsigned long long m) { return __builtin_popcountll(m); }
#endif

// Tile `tile` of the scatter (see the note at the top): its sorted ids, its
// triangles' partials and run counts at their runs' last rows, its bit in
// each of its triangles' masks. `lanes`: this thread's on the card, the
// block's kTileThreads (tid set) in the host build.
__device__ __forceinline__ void tile_block(int tile, const float* __restrict__ ct,
                                           const int* __restrict__ idx, int n, int n_tris,
                                           Scratch s, unsigned long long* counters,
                                           TileShared& sh, TileLane* lanes) {
#ifndef __CUDACC__
  const int n_lanes = kTileThreads;
#endif
  TRCS_LANES(if (L.tid == 0) sh.tally[0] = sh.tally[1] = 0;)
  TRCS_SYNC();
  TRCS_LANES(
    unsigned long long rows = 0, nonzero = 0;
    for (int k = 0; k < 2; ++k) {
      const int j = L.tid + k * kTileThreads;
      const long long r = static_cast<long long>(tile) * kTile + j;
      unsigned long long key = ~0ull;
      float* row = sh.val + 9 * j;
      bool nz = false;
      for (int c = 0; c < 9; ++c) {
        row[c] = r < n ? ct[9 * r + c] : 0.0f;
        nz |= row[c] != 0.0f;
      }
      if (r < n) {
        const int id = idx[r];
        ++rows;
        nonzero += nz;
        if (id >= 0 && id < n_tris)
          key = (static_cast<unsigned long long>(id) << 32) | static_cast<unsigned>(j);
      }
      sh.key[j] = key;
    }
    rows = warp_sum(rows);
    nonzero = warp_sum(nonzero);
    if (warp_lead(L.tid)) {
      shared_add64(&sh.tally[0], rows);
      shared_add64(&sh.tally[1], nonzero);
    }
  )
  TRCS_SYNC();
  for (int k = 2; k <= kTile; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      TRCS_LANES(
        const int i = 2 * L.tid - (L.tid & (j - 1));
        const unsigned long long a = sh.key[i], b = sh.key[i + j];
        if ((a > b) == ((i & k) == 0)) {
          sh.key[i] = b;
          sh.key[i + j] = a;
        }
      )
      TRCS_SYNC();
    }
  }
  TRCS_LANES(
    for (int k = 0; k < 2; ++k) {
      const int i = L.tid + k * kTileThreads;
      const unsigned long long key = sh.key[i];
      const unsigned id = static_cast<unsigned>(key >> 32);
      int lo = 0, hi = i;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (static_cast<unsigned>(sh.key[mid] >> 32) < id)
          lo = mid + 1;
        else
          hi = mid;
      }
      L.id[k] = id;
      L.head[k] = lo;
      const int j = id == kNone ? 0 : static_cast<int>(key & 0xffffffffu);
      for (int c = 0; c < 9; ++c) L.v[k][c] = id == kNone ? 0.0f : sh.val[9 * j + c];
    }
  )
  TRCS_SYNC();
  for (int d = 1; d < kTile; d <<= 1) {
    TRCS_LANES(
      for (int k = 0; k < 2; ++k)
        for (int c = 0; c < 9; ++c) sh.val[9 * (L.tid + k * kTileThreads) + c] = L.v[k][c];
    )
    TRCS_SYNC();
    TRCS_LANES(
      for (int k = 0; k < 2; ++k) {
        const int i = L.tid + k * kTileThreads;
        if (i - d >= L.head[k])
          for (int c = 0; c < 9; ++c) L.v[k][c] += sh.val[9 * (i - d) + c];
      }
    )
    TRCS_SYNC();
  }
  TRCS_LANES(
    for (int k = 0; k < 2; ++k) {
      const int i = L.tid + k * kTileThreads;
      const long long g = static_cast<long long>(tile) * kTile + i;
      const unsigned id = L.id[k];
      s.id[g] = id;
      if (id != kNone && (i == kTile - 1 || static_cast<unsigned>(sh.key[i + 1] >> 32) != id)) {
        for (int c = 0; c < 9; ++c) s.val[9 * g + c] = L.v[k][c];
        s.count[g] = i - L.head[k] + 1;
        mask_or(s.mask + static_cast<long long>(id) * s.n_words + tile / 64,
                1ull << (tile % 64));
      }
    }
    if (L.tid == 0) {
      counter_add(counters + kRows, sh.tally[0]);
      counter_add(counters + kRowsNonzero, sh.tally[1]);
    }
  )
}

// Block `block` of the combine: kCombineRows tile rows; each owned run
// writes its triangle's row of the gradient (see the note at the top).
__device__ __forceinline__ void combine_block(int block, Scratch s, float* __restrict__ grad,
                                              unsigned long long* counters, CombineShared& sh,
                                              CombineLane* lanes) {
#ifndef __CUDACC__
  const int n_lanes = kCombineThreads;
#endif
  const long long n_rows = static_cast<long long>(s.n_tiles) * kTile;
  TRCS_LANES(if (L.tid == 0) {
    sh.n_owners = 0;
    sh.tally[0] = sh.tally[1] = 0;
  })
  TRCS_SYNC();
  TRCS_LANES(
    const long long g = static_cast<long long>(block) * kCombineRows + L.tid;
    const int i = static_cast<int>(g % kTile), t = static_cast<int>(g / kTile);
    const unsigned id = L.tid < kCombineRows && g < n_rows ? s.id[g] : kNone;
    if (id != kNone && (i == kTile - 1 || s.id[g + 1] != id)) {
      const unsigned long long* m = s.mask + static_cast<long long>(id) * s.n_words;
      int first = -1, tiles = 0;
      for (int w = 0; w < s.n_words; ++w) {
        if (first < 0 && m[w]) first = 64 * w + lowest_bit(m[w]);
        tiles += bit_count(m[w]);
      }
      if (first == t) {
        shared_add64(&sh.tally[0], 1);
        if (tiles == 1) {
          float* out = grad + 10 * static_cast<long long>(id);
          for (int c = 0; c < 9; ++c) out[c] = s.val[9 * g + c];
          shared_max64(&sh.tally[1], static_cast<unsigned long long>(s.count[g]));
        } else {
          sh.owners[shared_add(&sh.n_owners, 1)] = static_cast<int>(g);
        }
      }
    }
  )
  TRCS_SYNC();
  for (int q0 = 0; q0 < sh.n_owners; q0 += kGroups) {
    TRCS_LANES(
      const int q = q0 + L.tid / kLanes, lane = L.tid % kLanes;
      float acc[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      int count = 0;
      if (q < sh.n_owners) {
        const int g = sh.owners[q];
        const unsigned id = s.id[g];
        const unsigned long long* m = s.mask + static_cast<long long>(id) * s.n_words;
        for (int u = g / kTile + 1 + lane; u < s.n_tiles; u += kLanes) {
          if ((m[u >> 6] >> (u & 63)) & 1ull) {
            const long long base = static_cast<long long>(u) * kTile;
            const long long at = base + run_end(s.id + base, id);
            for (int c = 0; c < 9; ++c) acc[c] += s.val[9 * at + c];
            count += s.count[at];
          }
        }
      }
      for (int c = 0; c < 9; ++c) sh.part[9 * L.tid + c] = acc[c];
      sh.count[L.tid] = count;
    )
    TRCS_SYNC();
    for (int off = kLanes / 2; off > 0; off >>= 1) {
      TRCS_LANES(if (L.tid % kLanes < off) {
        for (int c = 0; c < 9; ++c) sh.part[9 * L.tid + c] += sh.part[9 * (L.tid + off) + c];
        sh.count[L.tid] += sh.count[L.tid + off];
      })
      TRCS_SYNC();
    }
    TRCS_LANES(
      const int q = q0 + L.tid / kLanes;
      if (L.tid % kLanes == 0 && q < sh.n_owners) {
        const int g = sh.owners[q];
        float* out = grad + 10 * static_cast<long long>(s.id[g]);
        for (int c = 0; c < 9; ++c)
          out[c] = s.val[9 * static_cast<long long>(g) + c] + sh.part[9 * L.tid + c];
        shared_max64(&sh.tally[1],
                     static_cast<unsigned long long>(s.count[g] + sh.count[L.tid]));
      }
    )
    TRCS_SYNC();
  }
  TRCS_LANES(if (L.tid == 0) {
    counter_add(counters + kSegments, sh.tally[0]);
    counter_max(counters + kLongest, sh.tally[1]);
    if (block == 0) counter_add(counters + kLaunches, 1);
  })
}

}  // namespace trcs

#ifdef __CUDACC__

namespace {

constexpr int kGatherThreads = 256;

__global__ void __launch_bounds__(kGatherThreads) corner_gather_kernel(
    const float* __restrict__ rows, int n_tris, const int* __restrict__ idx, long long n9,
    float* __restrict__ out) {
  const long long e = static_cast<long long>(blockIdx.x) * kGatherThreads + threadIdx.x;
  if (e < n9) out[e] = trcs::gather_one(rows, n_tris, idx, e);
}

__global__ void __launch_bounds__(trcs::kTileThreads) corner_tile_kernel(
    const float* __restrict__ ct, const int* __restrict__ idx, int n, int n_tris,
    trcs::Scratch s, unsigned long long* counters) {
  __shared__ trcs::TileShared sh;
  trcs::TileLane lane;
  lane.tid = threadIdx.x;
  trcs::tile_block(blockIdx.x, ct, idx, n, n_tris, s, counters, sh, &lane);
}

__global__ void __launch_bounds__(trcs::kCombineThreads) corner_combine_kernel(
    trcs::Scratch s, float* __restrict__ grad, unsigned long long* counters) {
  __shared__ trcs::CombineShared sh;
  trcs::CombineLane lane;
  lane.tid = threadIdx.x;
  trcs::combine_block(blockIdx.x, s, grad, counters, sh, &lane);
}

}  // namespace

// out (n, 9) = rows (n_tris, 10)[idx][:, :9].
extern "C" int tr_corner_gather(const float* rows, int n_tris, const int* idx, int n,
                                float* out, void* stream) {
  const long long n9 = 9LL * n;
  if (n9 > 0)
    corner_gather_kernel<<<static_cast<unsigned>((n9 + kGatherThreads - 1) / kGatherThreads),
                           kGatherThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        rows, n_tris, idx, n9, out);
  return static_cast<int>(cudaGetLastError());
}

// The bytes of scratch tr_corner_scatter needs for n rows and n_tris triangles.
extern "C" long long tr_corner_scatter_scratch(int n, int n_tris) {
  return trcs::scratch_bytes(n, n_tris);
}

// grad (n_tris, 10) = the sum by triangle idx[r] of ct (n, 9)'s rows, column
// 9 zero; scratch: tr_corner_scatter_scratch(n, n_tris) bytes, 8-byte
// aligned; counters: cuda_scatter.COUNTERS, added to.
extern "C" int tr_corner_scatter(const float* ct, const int* idx, int n, int n_tris,
                                 float* grad, void* scratch, unsigned long long* counters,
                                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const trcs::Scratch s = trcs::carve(scratch, n, n_tris);
  cudaError_t e = cudaMemsetAsync(grad, 0, sizeof(float) * 10 * static_cast<size_t>(n_tris), st);
  if (e == cudaSuccess && n > 0)
    e = cudaMemsetAsync(s.mask, 0, 8 * static_cast<size_t>(s.n_words) * n_tris, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n > 0) {
    corner_tile_kernel<<<s.n_tiles, trcs::kTileThreads, 0, st>>>(ct, idx, n, n_tris, s,
                                                                 counters);
    const long long rows = static_cast<long long>(s.n_tiles) * trcs::kTile;
    corner_combine_kernel<<<static_cast<unsigned>(
                                (rows + trcs::kCombineRows - 1) / trcs::kCombineRows),
                            trcs::kCombineThreads, 0, st>>>(s, grad, counters);
  }
  return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__
