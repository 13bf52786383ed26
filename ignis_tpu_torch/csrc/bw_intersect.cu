// Baldwin-Weber brute-force closest-hit / any-hit over a clustered soup.
//
// Replaces the Pallas TPU kernel of ignis_tpu/ops/bw_intersect.py
// (`_kernel` -> `_bw_loop` -> `_tri_test`, entries `bw_closest` / `bw_any`).
//
// What it computes: every ray is tested against every triangle of a soup that
// the host precomputed into Baldwin-Weber form (a plane and two barycentric
// functionals per triangle, 16 floats a row) and grouped into SAH-ordered
// clusters of 8 triangles, each with an AABB.  A ray tests a cluster's
// triangles only when its own [tmin, best] window crosses the cluster box.
//
// What bounds it on this card: operations for all but the smallest soups.
// The tables of the scenes that take this path are a few KB to 256 KB (under
// 4096 triangles) and stay in L1/L2; a ray moves 32 bytes in and 16 out and
// does about 25 float32 operations per cluster box and 48 per triangle it
// tests.  At the H100's ratio of float32 rate to memory rate (20 operations a
// byte) the box tests alone outweigh the ray's 48 bytes from about 40 clusters
// (320 triangles) on; below that, as in the 13-cluster demo scene, the bound
// is the rays' bytes, and the kernel's time is launch and latency.
//
// What the design does about it: one ray per thread, ray and best hit in
// registers.  The block stages a tile of clusters and their triangles through
// shared memory once, so every thread reads them as broadcasts.  The cluster
// skip is decided per ray (so a ray's result does not depend on its
// neighbours) and a warp vote skips the eight tests when no ray of the warp
// needs them.  Any-hit rays stop testing after their first hit.
//
// The slab and triangle tests are those of bw_tri_test.cuh, shared with
// tlas.cu; they follow `_tri_test` term by term.  Build with -fmad=false so
// the products are not contracted and the result equals the plain PyTorch
// version bit for bit.

#include <cuda_runtime.h>

#include "bw_tri_test.cuh"

namespace {

using ignis::bw_inv;
using ignis::bw_slab;
using ignis::bw_tri_test;

constexpr int kTriTile = 8;      // triangles per cluster
constexpr int kRowFloats = 16;   // floats per triangle row
constexpr int kClusterTile = 16; // clusters staged per shared-memory tile
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
bw_kernel(const float* __restrict__ tris, const float* __restrict__ clusters,
          int nclusters, const float* __restrict__ org,
          const float* __restrict__ dir, const float* __restrict__ tmin_p,
          const float* __restrict__ tmax_p, int n, int mask_bit, int any_hit,
          float* __restrict__ out_t, float* __restrict__ out_u,
          float* __restrict__ out_v, int* __restrict__ out_prim) {
    __shared__ float s_cl[kClusterTile * 8];
    __shared__ __align__(16) float s_tr[kClusterTile * kTriTile * kRowFloats];

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
    const float ix = bw_inv(dx), iy = bw_inv(dy), iz = bw_inv(dz);
    float bu = 0.f, bv = 0.f;
    int bi = -1;

    for (int tile0 = 0; tile0 < nclusters; tile0 += kClusterTile) {
        const int ncl = min(kClusterTile, nclusters - tile0);
        __syncthreads();
        for (int j = threadIdx.x; j < ncl * 8; j += blockDim.x)
            s_cl[j] = clusters[(size_t)tile0 * 8 + j];
        const float4* src =
            reinterpret_cast<const float4*>(tris + (size_t)tile0 * kTriTile * kRowFloats);
        float4* dst = reinterpret_cast<float4*>(s_tr);
        for (int j = threadIdx.x; j < ncl * kTriTile * kRowFloats / 4; j += blockDim.x)
            dst[j] = src[j];
        __syncthreads();

        for (int c = 0; c < ncl; ++c) {
            const float* cb = s_cl + c * 8;
            bool pass = live && bw_slab(cb, ox, oy, oz, ix, iy, iz, tmn, bt) &&
                        (cb[6] > 0.f);
            if (any_hit && bi >= 0) pass = false;
            // uniform per warp: skip the eight tests when no ray needs them
            if (!__any_sync(0xffffffffu, pass)) continue;

            const float* row = s_tr + c * kTriTile * kRowFloats;
#pragma unroll
            for (int k = 0; k < kTriTile; ++k, row += kRowFloats) {
                float tt, u, v;
                const bool ok = pass && bw_tri_test(row, mask_bit, ox, oy, oz, dx, dy, dz,
                                                    tmn, bt, tt, u, v);
                if (ok) {
                    bt = tt;
                    if (!any_hit) {
                        bu = fmaxf(u, 0.f);
                        bv = fmaxf(v, 0.f);
                    }
                    bi = static_cast<int>(row[13]);
                }
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

// Launches on `stream`, allocates nothing, does not synchronise.
// Returns cudaGetLastError() as an int (0 = launched).
extern "C" int ignis_bw_intersect(const void* tris, const void* clusters, int nclusters,
                                  const void* org, const void* dir, const void* tmin,
                                  const void* tmax, int n, int mask_bit, int any_hit,
                                  void* out_t, void* out_u, void* out_v, void* out_prim,
                                  void* stream) {
    if (n <= 0) return 0;
    const int blocks = (n + kThreads - 1) / kThreads;
    bw_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(tris), static_cast<const float*>(clusters), nclusters,
        static_cast<const float*>(org), static_cast<const float*>(dir),
        static_cast<const float*>(tmin), static_cast<const float*>(tmax), n, mask_bit,
        any_hit, static_cast<float*>(out_t), static_cast<float*>(out_u),
        static_cast<float*>(out_v), static_cast<int*>(out_prim));
    return static_cast<int>(cudaGetLastError());
}
