// Closest-hit and any-hit Möller–Trumbore over the packet accel: two kernels
// over one block-cooperative walk.
//
// `packet_kernel` replaces the Pallas kernel `intersect_packet_streamed`
// (tpu_ray/kernels/pallas_mt.py:347); `packet_resident_kernel` replaces
// `intersect_packet` (pallas_mt.py:102, with `any_hit_packet` :589), which
// visits the supers in a given order: by distance from a point (primary
// rays from one camera), by projection on a direction (shadow rays toward
// one light), or in slot order. Both share the chunk update `_mt_chunk_update`
// (:60-99) and the slot-to-id mapping `_finalize_hits` (:249-262). Plain
// PyTorch versions: intersect_packet_streamed_torch and
// intersect_packet_torch in tpu_ray_torch/kernels/cuda_mt.py. Layout of the
// accel: tpu_ray_torch/accel/packet.py.
//
// What bounds them on an H100: latency, of the loads of the corner rows and
// of the walk's dependent tests. A surviving chunk costs 9 loads a triangle
// before ~40 flops of MT; a 70k-triangle accel (4.9 MB) or one 12 MiB part
// sits in the 50 MB L2 cache, knot1m's 68 MiB whole-mesh accel does not.
// The least work a ray needs is one MT test, which puts the bound far below
// any walk that culls by boxes: the walk, not the arithmetic, is the cost.
//
// The design: a block owns kRays = 32 neighbouring rays (the renderer's
// blocks are in Morton order, so they walk much the same chunks) and splits
// each chunk's 128 triangles into kSlices = 4 slices of 32, one warp each;
// thread (ray r, slice k) is lane r of warp k. A 32,768-ray launch is 1,024
// blocks of 4 warps, four times the warps of one thread per ray.
//   * Supers, in slot order (#3) or in the wrapper's sorted order (#4). Per
//     super every thread slab-tests the super's box for its ray against the
//     ray's best t, then the chunk boxes of its slice (c = k, k + 4, ...);
//     the block ORs the passing chunks into a 16-bit mask in shared memory
//     and counts the rays still undecided. The block leaves when none is
//     (a 0-seed, an any-hit ray with a hit, a lane past n). Such a step
//     costs a barrier, and #4 takes one for every super. #3 reaches its
//     supers through a 16-ary tree over them (accel/packet.py
//     `super_tree`), depth first in slot order: a node's visit is the same
//     step over its children's boxes, and a subtree that no ray reaches is
//     never entered (`tree_walk`: knot8m's 4,097 supers are 4 levels of
//     257, 17, 2 and 1 nodes).
//   * Chunks of the mask, in order: each one's 9 corner rows (4.6 KB) are
//     copied into shared memory with cp.async, double buffered: the next
//     chunk's copy is issued before the current one is tested. A thread
//     tests its ray's box against the chunk again with the refreshed best t
//     (the culls are then those of one thread walking the ray), and runs MT
//     on its slice of 32 triangles from shared memory: every lane of a warp
//     reads the same triangle, a broadcast.
//   * Each ray's best t lives in shared memory as the min over its slices'
//     private bests, refreshed after every chunk, so that culls tighten.
//   * The tie rule stays exact. A thread records a hit only when strictly
//     below the ray's best t at the chunk's start, and keeps (t, visit rank),
//     rank = k * 2048 + c * 128 + j for visit position k; the slices' bests
//     are reduced lexicographically at the end. That is the first minimum in
//     visit order, what one thread's strict-min walk keeps.
// Nothing bounds the number of supers. It keeps the TPU kernels' rules:
// best t starts at min(t_init, t_far); a triangle is valid only with t in
// (T_MIN, t_far) for the static t_far; in any-hit mode a ray is decided at
// its first hit (its best t becomes 0).
//
// An optional counter buffer receives, per launch, the chunks staged, the MT
// tests run, the (ray, staged chunk) pairs whose box test passed and all such
// pairs, the supers visited, the blocks, the rays and the tree's nodes
// visited: what says whether the time goes to staging, to divergence, to
// culling or to the steps above the chunks.
//
// The walk is written once for the card and for a host emulation of the
// block: TRMT_LANES runs a stretch between barriers for this thread on the
// card and for every lane of the block in turn on the host, where
// TRMT_SYNC is nothing and cp.async a copy. Shared state is written and
// read in different stretches, so the emulation is the block's own result:
// the CPU tests build it with g++ and hold it against the plain versions.
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#else  // a host build of the walk, for the CPU tests
#include <math.h>
#define __host__
#define __device__
#define __forceinline__ inline
#endif

namespace trmt {

constexpr int kChunk = 128;
constexpr int kRowsPerChunk = 16;
constexpr int kSuper = 16;
constexpr float kDetEps = 1e-10f;
constexpr float kTMin = 1e-5f;
constexpr float kBig = 1e10f;

constexpr int kRays = 32;                    // rays a block (a warp's lanes)
constexpr int kSlices = 4;                   // slices of a chunk (warps)
constexpr int kThreads = kRays * kSlices;
constexpr int kSliceTris = kChunk / kSlices;
constexpr int kStageFloats = 9 * kChunk;     // a chunk's v0, e1, e2 rows
constexpr int kSuperRank = kSuper * kChunk;  // visit ranks a super
constexpr int kMaxLevels = 6;                // of #3's tree: 16^6 supers, past the int ranks

// the optional counter buffer's entries (cuda_mt.COUNTERS)
enum Counter {
  kChunksStaged, kMtTests, kBoxPasses, kBoxSlots, kSupersVisited, kBlocks, kRayCount,
  kNodesVisited
};

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__host__ __device__ __forceinline__ float inv_dir(float v) {
  return (v >= 0.0f ? 1.0f : -1.0f) / fmaxf(fabsf(v), 1e-12f);
}

__host__ __device__ __forceinline__ Ray load_ray(const float* o, const float* d,
                                                 int i) {
  Ray r;
  r.ox = o[3 * i]; r.oy = o[3 * i + 1]; r.oz = o[3 * i + 2];
  r.dx = d[3 * i]; r.dy = d[3 * i + 1]; r.dz = d[3 * i + 2];
  r.ix = inv_dir(r.dx); r.iy = inv_dir(r.dy); r.iz = inv_dir(r.dz);
  return r;
}

// Slab test of one AABB row (lanes 0..5 = lo.xyz, hi.xyz) against the ray,
// in the reference's op order: (tf >= max(tn, 0)) & (max(tn, 0) < best).
__host__ __device__ __forceinline__ bool slab(const float* ab, const Ray& r,
                                              float best) {
  const float t0x = (ab[0] - r.ox) * r.ix, t1x = (ab[3] - r.ox) * r.ix;
  const float t0y = (ab[1] - r.oy) * r.iy, t1y = (ab[4] - r.oy) * r.iy;
  const float t0z = (ab[2] - r.oz) * r.iz, t1z = (ab[5] - r.oz) * r.iz;
  float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  tn = fmaxf(tn, 0.0f);
  return (tf >= tn) && (tn < best);
}

// The block's shared state. rows first: cp.async writes 16-byte pieces.
struct Shared {
  alignas(16) float rows[2][kStageFloats];  // the staged chunk, double buffered
  float best[kSlices][kRays];   // each slice's best t of each ray
  int rank[kSlices][kRays];     // their visit ranks (the final reduction)
  uint32_t mask[3];             // the block's chunk mask of a super, rotating
  int undecided[3];             // its undecided rays, rotating
  unsigned long long tally[2];  // the block's MT tests and box passes (counters)
};

// One thread's state: its ray and slice, and its slice's best hit.
struct Lane {
  int tid, r, k, i;
  bool valid;          // i < n
  Ray ray;
  float bt;            // best t (0 once an any-hit ray is decided)
  int brank;           // its visit rank, -1 without a hit
  unsigned mt_tests, passes;
};

// The ray's best t: the min over its slices'.
__host__ __device__ __forceinline__ float block_best(const Shared& sh, int r) {
  float b = sh.best[0][r];
  for (int k = 1; k < kSlices; ++k) b = fminf(b, sh.best[k][r]);
  return b;
}

// MT of the thread's slice of the staged chunk `rows` against its ray; a
// valid hit strictly below thr replaces the lane's best (t, rank).
__host__ __device__ __forceinline__ void slice_mt(const float* rows, Lane& L,
                                                  float thr, float t_far,
                                                  int rank0, int any_hit) {
  const Ray& r = L.ray;
  const int j0 = L.k * kSliceTris;
  int tested = kSliceTris;
#ifdef __CUDACC__
#pragma unroll 4
#endif
  for (int jj = 0; jj < kSliceTris; ++jj) {
    const int j = j0 + jj;
    const float v0x = rows[0 * kChunk + j], v0y = rows[1 * kChunk + j],
                v0z = rows[2 * kChunk + j];
    const float e1x = rows[3 * kChunk + j], e1y = rows[4 * kChunk + j],
                e1z = rows[5 * kChunk + j];
    const float e2x = rows[6 * kChunk + j], e2y = rows[7 * kChunk + j],
                e2z = rows[8 * kChunk + j];
    const float px = r.dy * e2z - r.dz * e2y;
    const float py = r.dz * e2x - r.dx * e2z;
    const float pz = r.dx * e2y - r.dy * e2x;
    const float det = e1x * px + e1y * py + e1z * pz;
    const bool ok = fabsf(det) > kDetEps;
    const float inv_det = 1.0f / (ok ? det : 1.0f);
    const float tx = r.ox - v0x, ty = r.oy - v0y, tz = r.oz - v0z;
    const float u = (tx * px + ty * py + tz * pz) * inv_det;
    const float qx = ty * e1z - tz * e1y;
    const float qy = tz * e1x - tx * e1z;
    const float qz = tx * e1y - ty * e1x;
    const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
    const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
    const bool valid = ok && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) &&
                       (t > kTMin) && (t < t_far);
    if (valid && t < thr) {
      thr = t;
      L.bt = t;
      L.brank = rank0 + j;
      if (any_hit) {  // decided: best t 0 for every later cull
        L.bt = 0.0f;
        tested = jj + 1;
        break;
      }
    }
  }
  L.mt_tests += tested;
}

#ifdef __CUDACC__
#define TRMT_LANES(...) { Lane& L = *lanes; (void)L; __VA_ARGS__ }
#define TRMT_SYNC() __syncthreads()

__device__ __forceinline__ void shared_or(uint32_t* w, uint32_t v) { atomicOr(w, v); }
__device__ __forceinline__ void shared_add(int* w, int v) { atomicAdd(w, v); }
__device__ __forceinline__ void shared_add64(unsigned long long* w, unsigned long long v) {
  atomicAdd(w, v);
}
__device__ __forceinline__ void counter_add(unsigned long long* c, unsigned long long v) {
  atomicAdd(c, v);
}
// The sum of v over the thread's warp, and whether the thread adds it for
// the warp: the counters' atomics, one a warp in shared memory and one a
// block in global memory (one global atomic a thread took a third of a
// 32,768-ray walk's time).
__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
__device__ __forceinline__ bool warp_lead(int tid) { return (tid & 31) == 0; }
__device__ __forceinline__ int lowest_bit(uint32_t m) { return __ffs(m) - 1; }

// This thread's 16-byte pieces of a chunk's 9 rows into dst, one cp.async
// group.
__device__ __forceinline__ void stage_part(float* dst, const float* src, int tid) {
  for (int q = tid; q < kStageFloats / 4; q += kThreads) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst + 4 * q));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src + 4 * q));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait for this thread's copies of the chunk before the newest group (all of
// them when `newer` is false).
__device__ __forceinline__ void stage_wait(bool newer) {
  if (newer)
    asm volatile("cp.async.wait_group 1;\n" ::);
  else
    asm volatile("cp.async.wait_group 0;\n" ::);
}
#else
#define TRMT_LANES(...) \
  for (int lane_ = 0; lane_ < kThreads; ++lane_) { Lane& L = lanes[lane_]; (void)L; __VA_ARGS__ }
#define TRMT_SYNC() ((void)0)

inline void shared_or(uint32_t* w, uint32_t v) { *w |= v; }
inline void shared_add(int* w, int v) { *w += v; }
inline void shared_add64(unsigned long long* w, unsigned long long v) { *w += v; }
inline void counter_add(unsigned long long* c, unsigned long long v) { *c += v; }
inline unsigned long long warp_sum(unsigned long long v) { return v; }  // a lane at a time
inline bool warp_lead(int) { return true; }
inline int lowest_bit(uint32_t m) { return __builtin_ctz(m); }
inline void stage_part(float* dst, const float* src, int tid) {
  for (int q = tid; q < kStageFloats / 4; q += kThreads)
    memcpy(dst + 4 * q, src + 4 * q, 16);
}
inline void stage_wait(bool) {}
#endif

// The block's start: each lane's ray and slice, its best t from t_init
// (0, decided, past n), the shared bests and the rotating slots cleared.
__device__ __forceinline__ void begin_block(int block, const float* __restrict__ o,
                                            const float* __restrict__ d,
                                            const float* __restrict__ t_init, int n,
                                            float t_far, Shared& sh, Lane* lanes) {
  TRMT_LANES(
    L.r = L.tid % kRays;
    L.k = L.tid / kRays;
    L.i = block * kRays + L.r;
    L.valid = L.i < n;
    float best0 = 0.0f;  // a lane past n is decided
    if (L.valid) {
      L.ray = load_ray(o, d, L.i);
      best0 = t_init ? fminf(t_init[L.i], t_far) : t_far;
    }
    L.bt = best0;
    L.brank = -1;
    L.mt_tests = 0;
    L.passes = 0;
    sh.best[L.k][L.r] = best0;
    if (L.tid < 3) {
      sh.mask[L.tid] = 0;
      sh.undecided[L.tid] = 0;
    }
    if (L.tid < 2) sh.tally[L.tid] = 0;
  )
  TRMT_SYNC();
}

// One mask step, a super's or a tree node's: each lane ORs bits_of(lane,
// its ray's best t) into the rotating slot step % 3 (nothing once its ray
// is decided), and the block counts its undecided rays -> the block's mask;
// `done` when no ray is undecided. A slot is written after one barrier,
// read after the next, and cleared after the step that follows, so a step
// needs one barrier.
template <typename Bits>
__device__ __forceinline__ uint32_t mask_step(Shared& sh, Lane* lanes, unsigned step,
                                              const Bits& bits_of, bool& done) {
  const unsigned slot = step % 3;
  TRMT_LANES(
    const float cur = block_best(sh, L.r);
    const uint32_t bits = cur > 0.0f ? bits_of(L, cur) : 0u;
    if (bits) shared_or(&sh.mask[slot], bits);
    if (cur > 0.0f && L.k == 0) shared_add(&sh.undecided[slot], 1);
  )
  TRMT_SYNC();
  const uint32_t mask = sh.mask[slot];
  done = sh.undecided[slot] == 0;
  // the slot read before the last barrier is free again
  TRMT_LANES(if (L.tid == 0) {
    sh.mask[(step + 2) % 3] = 0;
    sh.undecided[(step + 2) % 3] = 0;
  })
  return mask;
}

// The step of super s at visit position kpos: its box and its chunk boxes
// against each ray's best t, then the chunks of the mask staged and tested
// in order -> whether the block is done (no ray undecided).
__device__ __forceinline__ bool super_step(
    int s, int kpos, unsigned step, float t_far, const float* __restrict__ corners,
    const float* __restrict__ chunk_aabb, const float* __restrict__ super_aabb,
    int any_hit, unsigned& staged, Shared& sh, Lane* lanes) {
  bool done;
  uint32_t mask = mask_step(sh, lanes, step, [&](const Lane& L, float cur) {
    uint32_t bits = 0;
    if (slab(super_aabb + (size_t)s * 128, L.ray, cur)) {
      for (int c = L.k; c < kSuper; c += kSlices)
        if (slab(chunk_aabb + ((size_t)s * kSuper + c) * 128, L.ray, cur)) bits |= 1u << c;
    }
    return bits;
  }, done);
  if (done) return true;
  if (mask == 0) return false;
  int c = lowest_bit(mask);
  const float* base = corners + (size_t)s * kSuper * kRowsPerChunk * kChunk;
  TRMT_LANES(stage_part(sh.rows[0], base + (size_t)c * kRowsPerChunk * kChunk, L.tid);)
  for (int b = 0;; b ^= 1) {
    mask &= mask - 1;
    const int nxt = mask ? lowest_bit(mask) : -1;
    if (nxt >= 0)
      TRMT_LANES(stage_part(sh.rows[b ^ 1], base + (size_t)nxt * kRowsPerChunk * kChunk,
                            L.tid);)
    TRMT_LANES(stage_wait(nxt >= 0);)
    TRMT_SYNC();
    ++staged;
    const float* box = chunk_aabb + ((size_t)s * kSuper + c) * 128;
    const int rank0 = kpos * kSuperRank + c * kChunk;
    TRMT_LANES(
      const float cur = block_best(sh, L.r);
      if (cur > 0.0f && slab(box, L.ray, cur)) {
        if (L.k == 0) ++L.passes;
        slice_mt(sh.rows[b], L, cur, t_far, rank0, any_hit);
      }
    )
    TRMT_SYNC();  // every slice has read rows[b] and the bests
    TRMT_LANES(sh.best[L.k][L.r] = L.bt;)
    if (nxt < 0) break;
    c = nxt;
  }
  TRMT_SYNC();
  return false;
}

// Nodes at level L >= 0 of the tree over n >= 1 supers (accel/packet.py
// `super_tree`; level 0 are the supers): ceil(n / 16^L).
__host__ __device__ __forceinline__ int level_nodes(int n, int level) {
  return ((n - 1) >> (4 * level)) + 1;
}

// #3's walk: the tree depth first, children in slot order. A node's visit
// is a mask step over its (at most 16) children's boxes, which are supers
// at level 1; a set bit of level L > 1 is visited next, one of level 1
// steps its super. A subtree that no ray reaches at its visit is skipped:
// its boxes lie inside the node's and a ray's best t only falls, so no ray
// would pass one of its supers' boxes at that super's turn (the slab test
// is monotone in the box under float32 rounding). The supers stepped, and
// each ray's best t at their step, are those of the walk of every super in
// slot order: the same hits, staging and counts, fewer steps. The walk's
// state is block-uniform: the level, the node's index in it (its parent's
// is index / 16) and a mask a level of the children still to take.
__device__ __forceinline__ void tree_walk(
    int n_supers, float t_far, const float* __restrict__ corners,
    const float* __restrict__ chunk_aabb, const float* __restrict__ super_aabb,
    const float* __restrict__ tree, int any_hit, unsigned& staged, unsigned& supers,
    unsigned& nodes, Shared& sh, Lane* lanes) {
  int top = 1;
  while (level_nodes(n_supers, top) > 1) ++top;
  uint32_t left[kMaxLevels + 1];
  unsigned step = 0;
  bool done = false;
  // the visit of node idx of `level`: its children's boxes, the supers' or
  // the rows of level - 1 (levels 1, 2, ... one after another in `tree`)
  auto visit = [&](int level, int idx) {
    const int first = idx * kSuper;
    const int below = level_nodes(n_supers, level - 1) - first;
    const int kids = below < kSuper ? below : kSuper;
    int row = first;
    for (int l = 1; l < level - 1; ++l) row += level_nodes(n_supers, l);
    const float* boxes = level == 1 ? super_aabb + (size_t)first * 128 : tree + (size_t)row * 8;
    const int stride = level == 1 ? 128 : 8;
    ++nodes;
    left[level] = mask_step(sh, lanes, step++, [&](const Lane& L, float cur) {
      uint32_t bits = 0;
      for (int c = L.k; c < kids; c += kSlices)
        if (slab(boxes + (size_t)c * stride, L.ray, cur)) bits |= 1u << c;
      return bits;
    }, done);
  };
  int level = top, idx = 0;
  visit(top, 0);
  while (!done) {
    if (left[level] == 0) {  // the node's subtree is done: back up
      if (level == top) return;
      ++level;
      idx /= kSuper;
      continue;
    }
    const int child = idx * kSuper + lowest_bit(left[level]);
    left[level] &= left[level] - 1;
    if (level == 1) {
      ++supers;
      done = super_step(child, child, step++, t_far, corners, chunk_aabb, super_aabb, any_hit,
                        staged, sh, lanes);
    } else {
      idx = child;
      visit(--level, idx);
    }
  }
}

// #4's walk: every super in `order`, one super step each.
__device__ __forceinline__ void flat_walk(
    const int* __restrict__ order, int n_supers, float t_far,
    const float* __restrict__ corners, const float* __restrict__ chunk_aabb,
    const float* __restrict__ super_aabb, int any_hit, unsigned& staged, unsigned& supers,
    Shared& sh, Lane* lanes) {
  for (int kpos = 0; kpos < n_supers; ++kpos) {
    ++supers;
    if (super_step(order[kpos], kpos, kpos, t_far, corners, chunk_aabb, super_aabb, any_hit,
                   staged, sh, lanes))
      return;
  }
}

// The block walk of block `block` (see the note at the top): #3's tree walk
// (kTree, `order` unread), #4's walk of the supers in `order` (`tree`
// unread), then each ray's outputs: t and the original triangle id on a
// closest hit; t BIG and tri 0 on an any-hit ray that hit; BIG and -1 on a
// miss. `lanes`: this thread's lane on the card, the block's kThreads lanes
// (tid set) in the host emulation.
template <bool kTree>
__device__ __forceinline__ void walk_block(
    int block, const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ t_init, int n, float t_far,
    const float* __restrict__ corners, const float* __restrict__ chunk_aabb,
    const float* __restrict__ super_aabb, const float* __restrict__ tree,
    const int* __restrict__ order, int n_supers, const int* __restrict__ perm, int perm_len,
    int any_hit, float* __restrict__ t_out, int* __restrict__ tri_out,
    uint8_t* __restrict__ hit_out, unsigned long long* counters, Shared& sh,
    Lane* lanes) {
  begin_block(block, o, d, t_init, n, t_far, sh, lanes);
  unsigned staged = 0, supers = 0, nodes = 0;
  if constexpr (kTree)
    tree_walk(n_supers, t_far, corners, chunk_aabb, super_aabb, tree, any_hit, staged,
              supers, nodes, sh, lanes);
  else
    flat_walk(order, n_supers, t_far, corners, chunk_aabb, super_aabb, any_hit, staged,
              supers, sh, lanes);
  TRMT_LANES(sh.rank[L.k][L.r] = L.brank;)
  TRMT_SYNC();
  TRMT_LANES(
    if (L.k == 0 && L.valid) {
      // the first minimum in visit order: the least (t, rank) over slices
      float bt = kBig;
      int rank = -1;
      for (int k = 0; k < kSlices; ++k) {
        const int rk = sh.rank[k][L.r];
        if (rk < 0) continue;
        const float tk = sh.best[k][L.r];
        if (rank < 0 || tk < bt || (tk == bt && rk < rank)) {
          bt = tk;
          rank = rk;
        }
      }
      const bool hit = rank >= 0;
      hit_out[L.i] = hit ? 1 : 0;
      if (any_hit) {
        t_out[L.i] = kBig;
        tri_out[L.i] = hit ? 0 : -1;
      } else {
        const int kp = hit ? rank / kSuperRank : 0;
        const int sup = kTree ? kp : order[kp];
        const int slot = sup * kSuperRank + (hit ? rank % kSuperRank : 0);
        const int clipped = slot < perm_len ? slot : perm_len - 1;
        t_out[L.i] = hit ? bt : kBig;
        tri_out[L.i] = hit ? perm[clipped] : -1;
      }
    }
    if (counters) {  // the lanes' counts summed a warp, then in shared memory
      const unsigned long long tests = warp_sum(L.mt_tests), passes = warp_sum(L.passes);
      if (warp_lead(L.tid)) {
        shared_add64(&sh.tally[0], tests);
        shared_add64(&sh.tally[1], passes);
      }
    }
  )
  if (counters) {  // the block's counts, one global atomic each
    TRMT_SYNC();
    TRMT_LANES(if (L.tid == 0) {
      const int rays = n - block * kRays < kRays ? n - block * kRays : kRays;
      counter_add(counters + kMtTests, sh.tally[0]);
      counter_add(counters + kBoxPasses, sh.tally[1]);
      counter_add(counters + kChunksStaged, staged);
      counter_add(counters + kBoxSlots, (unsigned long long)staged * rays);
      counter_add(counters + kSupersVisited, supers);
      counter_add(counters + kBlocks, 1);
      counter_add(counters + kRayCount, rays);
      counter_add(counters + kNodesVisited, nodes);
    })
  }
}

}  // namespace trmt

#ifdef __CUDACC__

namespace {

// TPU kernel #3: the supers in slot order, through the tree over them.
__global__ void __launch_bounds__(trmt::kThreads) packet_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ t_init, int n, float t_far,
    const float* __restrict__ corners, const float* __restrict__ chunk_aabb,
    const float* __restrict__ super_aabb, const float* __restrict__ tree, int n_supers,
    const int* __restrict__ perm, int perm_len, int any_hit,
    float* __restrict__ t_out, int* __restrict__ tri_out,
    uint8_t* __restrict__ hit_out, unsigned long long* counters) {
  __shared__ trmt::Shared sh;
  trmt::Lane lane;
  lane.tid = threadIdx.x;
  trmt::walk_block<true>(blockIdx.x, o, d, t_init, n, t_far, corners, chunk_aabb,
                         super_aabb, tree, nullptr, n_supers, perm, perm_len, any_hit,
                         t_out, tri_out, hit_out, counters, sh, &lane);
}

// TPU kernel #4: every super in `super_order` (the wrapper's sort).
__global__ void __launch_bounds__(trmt::kThreads) packet_resident_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ t_init, int n, float t_far,
    const float* __restrict__ corners, const float* __restrict__ chunk_aabb,
    const float* __restrict__ super_aabb, const int* __restrict__ super_order,
    int n_supers, const int* __restrict__ perm, int perm_len, int any_hit,
    float* __restrict__ t_out, int* __restrict__ tri_out,
    uint8_t* __restrict__ hit_out, unsigned long long* counters) {
  __shared__ trmt::Shared sh;
  trmt::Lane lane;
  lane.tid = threadIdx.x;
  trmt::walk_block<false>(blockIdx.x, o, d, t_init, n, t_far, corners, chunk_aabb,
                          super_aabb, nullptr, super_order, n_supers, perm, perm_len, any_hit,
                          t_out, tri_out, hit_out, counters, sh, &lane);
}

}  // namespace

// The corners must be 16-byte aligned (cp.async); chunk rows then are too.
extern "C" int tr_intersect_packet_streamed(
    const float* o, const float* d, const float* t_init, int n, float t_far,
    const float* corners, const float* chunk_aabb, const float* super_aabb,
    const float* tree, int n_supers, const int* perm, int perm_len, int any_hit, float* t,
    int* tri, uint8_t* hit, unsigned long long* counters, void* stream) {
  if (n <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(corners) % 16) return static_cast<int>(cudaErrorInvalidValue);
  packet_kernel<<<(n + trmt::kRays - 1) / trmt::kRays, trmt::kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      o, d, t_init, n, t_far, corners, chunk_aabb, super_aabb, tree, n_supers, perm,
      perm_len, any_hit, t, tri, hit, counters);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tr_intersect_packet_resident(
    const float* o, const float* d, const float* t_init, int n, float t_far,
    const float* corners, const float* chunk_aabb, const float* super_aabb,
    const int* super_order, int n_supers, const int* perm, int perm_len,
    int any_hit, float* t, int* tri, uint8_t* hit, unsigned long long* counters,
    void* stream) {
  if (n <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(corners) % 16) return static_cast<int>(cudaErrorInvalidValue);
  packet_resident_kernel<<<(n + trmt::kRays - 1) / trmt::kRays, trmt::kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      o, d, t_init, n, t_far, corners, chunk_aabb, super_aabb, super_order,
      n_supers, perm, perm_len, any_hit, t, tri, hit, counters);
  return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__
