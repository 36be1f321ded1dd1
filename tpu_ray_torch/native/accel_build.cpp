// Native packet-accel builder: the host-side hot path of
// tpu_ray_torch/accel/packet.py's build (a copy of the reference's
// tpu_ray/native/accel_build.cpp; the port never loads the reference's).
//
// Contract: BIT-IDENTICAL output to the numpy build in
// accel/packet._numpy_build (tests/test_torch_native_accel.py asserts it).
// That pins down every operation order:
//   * centroid = ((v0 + v1) + v2) / 3.0 in double (numpy mean over axis 1);
//   * quantization q = trunc((c - lo) / extent * 1023) clipped to [0, 1023],
//     extent = max(hi - lo, 1e-12) per axis, all double;
//   * 10-bit Morton interleave (x << 2 | y << 1 | z) via the same
//     spread-bits magic constants;
//   * stable sort of triangle indices by Morton key (np.argsort kind=stable);
//   * corners / AABBs computed in double, cast to float exactly where the
//     numpy path casts (corner stores, chunk AABB stores); SUPER AABBs are
//     min/max over the FLOAT chunk values (numpy unions float32 lo_p/hi_p).
//
// Exposed via a plain C ABI for ctypes. The caller (native/__init__.py's
// build_accel) allocates every output zero-filled and passes raw pointers;
// layout constants (CHUNK=128, ROWS_PER_CHUNK=16, SUPER=16) are compiled in
// and cross-checked through tpu_ray_accel_abi() when the library loads.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr int64_t CHUNK = 128;
constexpr int64_t ROWS_PER_CHUNK = 16;
constexpr int64_t SUPER = 16;
constexpr double BIG = 1e10;

inline uint64_t spread_bits(uint64_t v) {
  v = (v | (v << 32)) & 0x1F00000000FFFFull;
  v = (v | (v << 16)) & 0x1F0000FF0000FFull;
  v = (v | (v << 8)) & 0x100F00F00F00F00Full;
  v = (v | (v << 4)) & 0x10C30C30C30C30C3ull;
  v = (v | (v << 2)) & 0x1249249249249249ull;
  return v;
}

}  // namespace

extern "C" {

// Sanity handshake: the Python side refuses the library if layout constants
// or this version tag drift from the numpy implementation.
int64_t tpu_ray_accel_abi(void) {
  return 1000000 * 1 + CHUNK * 1000 + ROWS_PER_CHUNK * 10 + SUPER / 10;
}

// Build one packet accel. Outputs must be pre-allocated AND zero-filled:
//   corners    float32[C_pad * ROWS_PER_CHUNK * CHUNK]
//   chunk_aabb float32[C_pad * 128]
//   super_aabb float32[S * 128]
//   perm       int32  [Tpad]
// where Tpad = ceil(T/CHUNK)*CHUNK, C = Tpad/CHUNK, S = ceil(C/SUPER),
// C_pad = S*SUPER (the caller computes the same values; n_* args are
// redundancy checks). tri_ids may be null (identity). Returns 0 on success.
int tpu_ray_accel_build(const double* verts, int64_t n_verts,
                        const int64_t* tris, int64_t n_tris,
                        const int64_t* tri_ids,
                        float* corners, int64_t n_corner_rows,
                        float* chunk_aabb, int64_t n_chunks_pad,
                        float* super_aabb, int64_t n_supers,
                        int32_t* perm, int64_t n_perm) {
  const int64_t T = n_tris;
  if (T <= 0) return 1;
  const int64_t Tpad = ((T + CHUNK - 1) / CHUNK) * CHUNK;
  const int64_t C = Tpad / CHUNK;
  const int64_t S = (C + SUPER - 1) / SUPER;
  const int64_t C_pad = S * SUPER;
  if (n_perm != Tpad || n_chunks_pad != C_pad || n_supers != S ||
      n_corner_rows != C_pad * ROWS_PER_CHUNK)
    return 2;

  // ---- Morton keys over quantized centroids (all double, numpy order) ----
  std::vector<double> cx(T), cy(T), cz(T);
  double lo[3] = {1e300, 1e300, 1e300}, hi[3] = {-1e300, -1e300, -1e300};
#pragma omp parallel
  {
    double tlo[3] = {1e300, 1e300, 1e300}, thi[3] = {-1e300, -1e300, -1e300};
#pragma omp for schedule(static)
    for (int64_t t = 0; t < T; ++t) {
      const int64_t* tr = tris + 3 * t;
      double c[3];
      for (int a = 0; a < 3; ++a) {
        const double v0 = verts[3 * tr[0] + a];
        const double v1 = verts[3 * tr[1] + a];
        const double v2 = verts[3 * tr[2] + a];
        c[a] = ((v0 + v1) + v2) / 3.0;  // numpy mean(axis=1) add order
        tlo[a] = std::min(tlo[a], c[a]);
        thi[a] = std::max(thi[a], c[a]);
      }
      cx[t] = c[0]; cy[t] = c[1]; cz[t] = c[2];
    }
#pragma omp critical
    for (int a = 0; a < 3; ++a) {
      lo[a] = std::min(lo[a], tlo[a]);
      hi[a] = std::max(hi[a], thi[a]);
    }
  }
  double extent[3];
  for (int a = 0; a < 3; ++a) extent[a] = std::max(hi[a] - lo[a], 1e-12);

  std::vector<uint64_t> key(T);
#pragma omp parallel for schedule(static)
  for (int64_t t = 0; t < T; ++t) {
    const double c[3] = {cx[t], cy[t], cz[t]};
    uint64_t q[3];
    for (int a = 0; a < 3; ++a) {
      // numpy: ((c - lo) / extent * 1023).astype(int64) then clip(0, 1023)
      const int64_t qi = static_cast<int64_t>((c[a] - lo[a]) / extent[a] * 1023.0);
      q[a] = static_cast<uint64_t>(std::min<int64_t>(std::max<int64_t>(qi, 0), 1023));
    }
    key[t] = (spread_bits(q[0]) << 2) | (spread_bits(q[1]) << 1) | spread_bits(q[2]);
  }

  std::vector<int64_t> order(T);
  for (int64_t t = 0; t < T; ++t) order[t] = t;
  std::stable_sort(order.begin(), order.end(),
                   [&key](int64_t a, int64_t b) { return key[a] < key[b]; });

  // ---- one fused pass: corners + chunk AABBs + perm -----------------------
  // Chunk AABB float values are kept for the super union below (numpy unions
  // the FLOAT32 lo_p/hi_p, not the doubles).
  std::vector<float> clo(C_pad * 3), chi(C_pad * 3);
#pragma omp parallel for schedule(static)
  for (int64_t ci = 0; ci < C; ++ci) {
    double blo[3] = {BIG, BIG, BIG}, bhi[3] = {-BIG, -BIG, -BIG};
    float* crow = corners + ci * ROWS_PER_CHUNK * CHUNK;
    const int64_t base = ci * CHUNK;
    const int64_t live = std::min(CHUNK, T - base);
    for (int64_t j = 0; j < live; ++j) {
      const int64_t t = order[base + j];
      const int64_t* tr = tris + 3 * t;
      for (int a = 0; a < 3; ++a) {
        const double v0 = verts[3 * tr[0] + a];
        const double v1 = verts[3 * tr[1] + a];
        const double v2 = verts[3 * tr[2] + a];
        crow[(a + 0) * CHUNK + j] = static_cast<float>(v0);
        crow[(a + 3) * CHUNK + j] = static_cast<float>(v1 - v0);
        crow[(a + 6) * CHUNK + j] = static_cast<float>(v2 - v0);
        const double tmin = std::min(v0, std::min(v1, v2));
        const double tmax = std::max(v0, std::max(v1, v2));
        blo[a] = std::min(blo[a], tmin);
        bhi[a] = std::max(bhi[a], tmax);
      }
      perm[base + j] = static_cast<int32_t>(tri_ids ? tri_ids[t] : t);
    }
    for (int64_t j = live; j < CHUNK; ++j) perm[base + j] = -1;
    // degenerate all-zero pad triangles never inflate the box (numpy masks
    // them; with live>=1 the mask only matters for pure-pad chunks, which
    // cannot occur since C = ceil(T/CHUNK))
    float* ab = chunk_aabb + ci * 128;
    for (int a = 0; a < 3; ++a) {
      ab[a] = clo[ci * 3 + a] = static_cast<float>(blo[a]);
      ab[3 + a] = chi[ci * 3 + a] = static_cast<float>(bhi[a]);
    }
  }
  for (int64_t ci = C; ci < C_pad; ++ci) {  // never-hit pad chunks
    float* ab = chunk_aabb + ci * 128;
    for (int a = 0; a < 3; ++a) {
      ab[a] = clo[ci * 3 + a] = static_cast<float>(BIG);
      ab[3 + a] = chi[ci * 3 + a] = static_cast<float>(-BIG);
    }
  }

  // ---- super AABBs: float unions over SUPER consecutive chunks ------------
  for (int64_t si = 0; si < S; ++si) {
    float slo[3] = {static_cast<float>(BIG), static_cast<float>(BIG),
                    static_cast<float>(BIG)};
    float shi[3] = {static_cast<float>(-BIG), static_cast<float>(-BIG),
                    static_cast<float>(-BIG)};
    for (int64_t ci = si * SUPER; ci < (si + 1) * SUPER; ++ci)
      for (int a = 0; a < 3; ++a) {
        slo[a] = std::min(slo[a], clo[ci * 3 + a]);
        shi[a] = std::max(shi[a], chi[ci * 3 + a]);
      }
    float* sb = super_aabb + si * 128;
    for (int a = 0; a < 3; ++a) { sb[a] = slo[a]; sb[3 + a] = shi[a]; }
  }
  return 0;
}

}  // extern "C"
