// 8-wide BVH traversal, closest-hit / any-hit, Moeller-Trumbore leaves.
//
// Replaces the Pallas TPU kernel of ignis_tpu/ops/pallas_bvh.py
// (`_traverse_kernel` -> `_traverse_packet` -> `_leaf_test`, entries
// `packet_bvh_closest` / `packet_bvh_any`).
//
// What it computes: each ray walks the unified (R, 128) float32 row table that
// `build_packet_bvh` lays out.  An inner row holds 8 child boxes at lanes
// [6c, 6c+6) and the child row ids at lanes 64+c (-1e9 = no child); a leaf row
// holds 8 triangle records of 16 lanes (v0, e1, e2, visibility bits, original
// id); lane 126 is the row type.  The result is the closest hit (t, u, v,
// original triangle id) or whether anything blocks the segment.
//
// What bounds it on this card: bytes, and their latency.  A visit reads one
// 512-byte row at an address that depends on the previous visit, and
// neighbouring threads diverge to different rows after a few levels, so the
// loads are scattered 32-byte sectors served from L2 (the table of a
// half-million-triangle scene is about 60 MB, near the size of L2) with few
// operations (about 25 per box, 50 per triangle) to hide them behind.
//
// What the design does about it: one ray per thread with its own short stack
// in local memory, so no thread waits on a neighbour's path; rows are read
// with 16-byte read-only loads; a box whose slab interval misses the ray's
// [tmin, best] window is never pushed; any-hit rays return at their first
// hit.  The TPU kernel shares one stack among 1024 rays and walks the union
// of their paths; that trade is not carried over.  Children are pushed in
// build order and popped last-first, the same order as the plain PyTorch
// version, so hits at exactly equal t resolve identically.
//
// Arithmetic follows `_leaf_test` and the slab test of `_traverse_packet`
// term by term; build with -fmad=false so nothing is contracted.

#include <cuda_runtime.h>

namespace {

constexpr int kRow = 128;
constexpr int kWidth = 8;
constexpr int kTypeLane = 126;
constexpr int kStack = 128;   // entries; the wrapper checks 7*depth+1 <= kStack
constexpr int kThreads = 128;
constexpr float kMissingHalf = -0.5e9f;

template <bool ANY>
__global__ void __launch_bounds__(kThreads)
pbvh_kernel(const float* __restrict__ rows, const float* __restrict__ org,
            const float* __restrict__ dir, const float* __restrict__ tmin_p,
            const float* __restrict__ tmax_p, int n, int mask_bit,
            float* __restrict__ out_t, float* __restrict__ out_u,
            float* __restrict__ out_v, int* __restrict__ out_prim) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float ox = org[3 * i + 0], oy = org[3 * i + 1], oz = org[3 * i + 2];
    const float dx = dir[3 * i + 0], dy = dir[3 * i + 1], dz = dir[3 * i + 2];
    const float tmn = tmin_p[i];
    float bt = tmax_p[i];
    const float big = 1e30f;
    const float ix = (dx == 0.f) ? big : 1.0f / dx;
    const float iy = (dy == 0.f) ? big : 1.0f / dy;
    const float iz = (dz == 0.f) ? big : 1.0f / dz;
    const float tol = -1.1920928955078125e-07f;
    float bu = 0.f, bv = 0.f;
    int bi = -1;

    int stack[kStack];
    int sp = 0;
    stack[sp++] = 0;

    while (sp > 0) {
        const int rid = stack[--sp];
        const float4* r4 = reinterpret_cast<const float4*>(rows + (size_t)rid * kRow);
        const float type = __ldg(rows + (size_t)rid * kRow + kTypeLane);
        if (type > 0.5f) {
#pragma unroll 2
            for (int k = 0; k < kWidth; ++k) {
                const float4 a = __ldg(r4 + 4 * k + 0);   // v0.xyz e1.x
                const float4 b = __ldg(r4 + 4 * k + 1);   // e1.yz e2.xy
                const float4 c = __ldg(r4 + 4 * k + 2);   // e2.z mask id pad
                const float v0x = a.x, v0y = a.y, v0z = a.z;
                const float e1x = a.w, e1y = b.x, e1z = b.y;
                const float e2x = b.z, e2y = b.w, e2z = c.x;
                const bool vis = (static_cast<int>(c.y) & mask_bit) != 0;
                const float nx = e1y * e2z - e1z * e2y;
                const float ny = e1z * e2x - e1x * e2z;
                const float nz = e1x * e2y - e1y * e2x;
                const float cx = v0x - ox, cy = v0y - oy, cz = v0z - oz;
                const float rx = dy * cz - dz * cy;
                const float ry = dz * cx - dx * cz;
                const float rz = dx * cy - dy * cx;
                const float det = nx * dx + ny * dy + nz * dz;
                const float inv_det = (det == 0.f) ? 0.f : 1.0f / det;
                const float u = -(rx * e2x + ry * e2y + rz * e2z) * inv_det;
                const float v = (rx * e1x + ry * e1y + rz * e1z) * inv_det;
                const float w = 1.0f - u - v;
                const float tt = (cx * nx + cy * ny + cz * nz) * inv_det;
                const bool ok = vis && (det != 0.f) && (u >= tol) && (v >= tol) &&
                                (w >= tol) && (tt >= tmn) && (tt <= bt);
                if (ok) {
                    bt = tt;
                    bu = fmaxf(u, 0.f);
                    bv = fmaxf(v, 0.f);
                    bi = static_cast<int>(c.z);
                    if (ANY) { sp = 0; break; }
                }
            }
        } else {
            const float4 ch0 = __ldg(r4 + 16);
            const float4 ch1 = __ldg(r4 + 17);
            const float child[kWidth] = {ch0.x, ch0.y, ch0.z, ch0.w,
                                         ch1.x, ch1.y, ch1.z, ch1.w};
            // 8 boxes of 6 floats = 48 floats = 12 float4
            float bx[48];
#pragma unroll
            for (int q = 0; q < 12; ++q) {
                const float4 f = __ldg(r4 + q);
                bx[4 * q + 0] = f.x; bx[4 * q + 1] = f.y;
                bx[4 * q + 2] = f.z; bx[4 * q + 3] = f.w;
            }
#pragma unroll
            for (int c = 0; c < kWidth; ++c) {
                const float* b = bx + 6 * c;
                const float t0x = (b[0] - ox) * ix;
                const float t1x = (b[3] - ox) * ix;
                const float t0y = (b[1] - oy) * iy;
                const float t1y = (b[4] - oy) * iy;
                const float t0z = (b[2] - oz) * iz;
                const float t1z = (b[5] - oz) * iz;
                const float near_ = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                                          fmaxf(fminf(t0z, t1z), tmn));
                const float far_ = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                                         fminf(fmaxf(t0z, t1z), bt));
                if ((near_ <= far_) && (child[c] > kMissingHalf) && sp < kStack)
                    stack[sp++] = static_cast<int>(child[c]);
            }
        }
    }
    out_t[i] = bt;
    out_u[i] = bu;
    out_v[i] = bv;
    out_prim[i] = bi;
}

}  // namespace

// The largest per-ray stack the kernel was compiled with.
extern "C" int ignis_packet_bvh_stack_entries() { return kStack; }

// Launches on `stream`, allocates nothing, does not synchronise.
// Returns cudaGetLastError() as an int (0 = launched).
extern "C" int ignis_packet_bvh(const void* rows, const void* org, const void* dir,
                                const void* tmin, const void* tmax, int n, int mask_bit,
                                int any_hit, void* out_t, void* out_u, void* out_v,
                                void* out_prim, void* stream) {
    if (n <= 0) return 0;
    const int blocks = (n + kThreads - 1) / kThreads;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (any_hit) {
        pbvh_kernel<true><<<blocks, kThreads, 0, s>>>(
            static_cast<const float*>(rows), static_cast<const float*>(org),
            static_cast<const float*>(dir), static_cast<const float*>(tmin),
            static_cast<const float*>(tmax), n, mask_bit, static_cast<float*>(out_t),
            static_cast<float*>(out_u), static_cast<float*>(out_v),
            static_cast<int*>(out_prim));
    } else {
        pbvh_kernel<false><<<blocks, kThreads, 0, s>>>(
            static_cast<const float*>(rows), static_cast<const float*>(org),
            static_cast<const float*>(dir), static_cast<const float*>(tmin),
            static_cast<const float*>(tmax), n, mask_bit, static_cast<float*>(out_t),
            static_cast<float*>(out_u), static_cast<float*>(out_v),
            static_cast<int*>(out_prim));
    }
    return static_cast<int>(cudaGetLastError());
}
