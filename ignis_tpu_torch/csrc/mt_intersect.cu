// Moeller-Trumbore closest-hit / any-hit over a whole triangle soup, with no
// acceleration structure.
//
// Replaces the Pallas TPU kernels of ignis_tpu/ops/pallas_intersect.py
// (`_closest_kernel` / `_any_kernel` -> `_mt_loop`, entries
// `pallas_intersect_closest` / `pallas_intersect_any`).
//
// What it computes: every ray is tested against every triangle (v0, e1, e2
// and an optional per-triangle visibility flag) in ascending triangle order;
// the closest accepted hit wins, and among equal t the highest triangle index
// (the accept test is t <= best).
//
// What bounds it on this card: operations.  A ray moves 32 bytes in and 16
// out and a triangle 37 bytes, but every pair of them costs about 54 float32
// operations, so from a few dozen triangles on the arithmetic outweighs the
// bytes by orders of magnitude.
//
// What the design does about it: one ray per thread with the ray and its best
// hit in registers; the block stages a tile of triangles through shared
// memory once and every thread reads them as broadcasts, so device memory is
// read once per block and the inner loop is arithmetic only.  Any-hit rays
// stop testing at their first hit and a block leaves the loop when all its
// rays have one.
//
// Arithmetic follows `_mt_loop` term by term; build with -fmad=false so
// nothing is contracted and the result equals the plain PyTorch version bit
// for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 256;   // triangles staged per shared-memory tile

template <bool ANY>
__global__ void __launch_bounds__(kThreads)
mt_kernel(const float* __restrict__ v0, const float* __restrict__ e1,
          const float* __restrict__ e2, const unsigned char* __restrict__ tri_mask,
          int ntris, const float* __restrict__ org, const float* __restrict__ dir,
          const float* __restrict__ tmin_p, const float* __restrict__ tmax_p, int n,
          float* __restrict__ out_t, float* __restrict__ out_u,
          float* __restrict__ out_v, int* __restrict__ out_prim) {
    __shared__ float s_v0[kTile * 3];
    __shared__ float s_e1[kTile * 3];
    __shared__ float s_e2[kTile * 3];
    __shared__ unsigned char s_m[kTile];

    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const bool live = i < n;
    float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 1.f;
    float tmn = 0.f, bt = -1.f;
    if (live) {
        ox = org[3 * i + 0]; oy = org[3 * i + 1]; oz = org[3 * i + 2];
        dx = dir[3 * i + 0]; dy = dir[3 * i + 1]; dz = dir[3 * i + 2];
        tmn = tmin_p[i];
        bt = tmax_p[i];
    }
    const float tol = -1.1920928955078125e-07f;
    float bu = 0.f, bv = 0.f;
    int bi = -1;
    bool done = !live;

    for (int tile0 = 0; tile0 < ntris; tile0 += kTile) {
        const int nt = min(kTile, ntris - tile0);
        // all rays of the block have their hit: nothing left to test
        if (__syncthreads_and(done)) break;
        for (int j = threadIdx.x; j < nt * 3; j += blockDim.x) {
            s_v0[j] = v0[(size_t)tile0 * 3 + j];
            s_e1[j] = e1[(size_t)tile0 * 3 + j];
            s_e2[j] = e2[(size_t)tile0 * 3 + j];
        }
        for (int j = threadIdx.x; j < nt; j += blockDim.x)
            s_m[j] = tri_mask ? tri_mask[tile0 + j] : (unsigned char)1;
        __syncthreads();
        if (done) continue;

#pragma unroll 4
        for (int k = 0; k < nt; ++k) {
            const float av0x = s_v0[3 * k], av0y = s_v0[3 * k + 1], av0z = s_v0[3 * k + 2];
            const float ae1x = s_e1[3 * k], ae1y = s_e1[3 * k + 1], ae1z = s_e1[3 * k + 2];
            const float ae2x = s_e2[3 * k], ae2y = s_e2[3 * k + 1], ae2z = s_e2[3 * k + 2];
            const float nx = ae1y * ae2z - ae1z * ae2y;
            const float ny = ae1z * ae2x - ae1x * ae2z;
            const float nz = ae1x * ae2y - ae1y * ae2x;
            const float cx = av0x - ox, cy = av0y - oy, cz = av0z - oz;
            const float rx = dy * cz - dz * cy;
            const float ry = dz * cx - dx * cz;
            const float rz = dx * cy - dy * cx;
            const float det = nx * dx + ny * dy + nz * dz;
            const float inv_det = (det == 0.f) ? 0.f : 1.0f / det;
            const float u = -(rx * ae2x + ry * ae2y + rz * ae2z) * inv_det;
            const float v = (rx * ae1x + ry * ae1y + rz * ae1z) * inv_det;
            const float w = 1.0f - u - v;
            const float tt = (cx * nx + cy * ny + cz * nz) * inv_det;
            const bool ok = (det != 0.f) && (u >= tol) && (v >= tol) && (w >= tol) &&
                            (tt >= tmn) && (tt <= bt) && (s_m[k] != 0);
            if (ok) {
                bt = tt;
                bu = fmaxf(u, 0.f);
                bv = fmaxf(v, 0.f);
                bi = tile0 + k;
                if (ANY) { done = true; break; }
            }
        }
    }
    if (live) {
        out_t[i] = bt;
        out_u[i] = bu;
        out_v[i] = bv;
        out_prim[i] = bi;
    }
}

}  // namespace

// `tri_mask` is one byte per triangle (0 = invisible) or null for none.
// Launches on `stream`, allocates nothing, does not synchronise.
// Returns cudaGetLastError() as an int (0 = launched).
extern "C" int ignis_mt_intersect(const void* v0, const void* e1, const void* e2,
                                  const void* tri_mask, int ntris, const void* org,
                                  const void* dir, const void* tmin, const void* tmax, int n,
                                  int any_hit, void* out_t, void* out_u, void* out_v,
                                  void* out_prim, void* stream) {
    if (n <= 0) return 0;
    const int blocks = (n + kThreads - 1) / kThreads;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto f = [](const void* p) { return static_cast<const float*>(p); };
    const unsigned char* m = static_cast<const unsigned char*>(tri_mask);
    if (any_hit) {
        mt_kernel<true><<<blocks, kThreads, 0, s>>>(
            f(v0), f(e1), f(e2), m, ntris, f(org), f(dir), f(tmin), f(tmax), n,
            static_cast<float*>(out_t), static_cast<float*>(out_u),
            static_cast<float*>(out_v), static_cast<int*>(out_prim));
    } else {
        mt_kernel<false><<<blocks, kThreads, 0, s>>>(
            f(v0), f(e1), f(e2), m, ntris, f(org), f(dir), f(tmin), f(tmax), n,
            static_cast<float*>(out_t), static_cast<float*>(out_u),
            static_cast<float*>(out_v), static_cast<int*>(out_prim));
    }
    return static_cast<int>(cudaGetLastError());
}
