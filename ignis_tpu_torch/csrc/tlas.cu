// Two-level instanced traversal: 8-wide BVH over instance world boxes, then
// the instance's shared local Baldwin-Weber clusters.  Closest hit / any hit.
//
// Replaces the Pallas TPU kernel of ignis_tpu/ops/bw_tlas.py (`_kernel`,
// entry `tlas_traverse`).
//
// What it computes: each ray walks the (R, 128) float32 `tl_top` rows (inner
// row: 8 child boxes at lanes [6c, 6c+6), child row ids at lanes 64+c, -1e9 =
// none; leaf row: 8 instance ids at lanes 0..7, -1 = empty; lane 126 = row
// type).  For every instance whose world box the ray's [tmin, best] window
// crosses and whose visibility bits hold the ray's class bit, the ray is
// taken to the shape's local space by the instance's 3x4 (direction not
// normalised, so local t = world t) and sweeps the shape's clusters in
// order: box test, then eight precomputed-triangle tests.  The result is the
// closest hit (t, u, v, pool row, instance) or, for any-hit, the first hit.
//
// What bounds it on this card: operations, and the latency of dependent
// loads.  All four tables of a scene with a thousand instances of one mesh
// are under 1 MB and stay in L1/L2; a ray moves 32 bytes in and 20 out, and
// does about 25 float32 operations per box and 48 per triangle over every
// cluster of every instance it enters.
//
// What the design does about it: one ray per thread, ray, best hit and local
// ray in registers, a short per-thread stack in local memory, tables read
// through the read-only path.  Entering an instance, entering a cluster and
// pushing a child are decided per ray, so a ray's result does not depend on
// its neighbours (the TPU kernel decides them for a block of 1024 rays and
// shares one stack among them; that trade is not carried over).  Any-hit rays
// return at their first hit.  Children are pushed 0..7 and popped last
// first, leaf slots, clusters and triangles are visited ascending, and the
// accept test is t <= best: the order of the plain PyTorch version, so hits
// at exactly equal t resolve identically.
//
// The slab and triangle tests are those of bw_tri_test.cuh; the local ray is
// (m0*ox + m1*oy) + (m2*oz + m3) and m0*dx + m1*dy + m2*dz, as in the
// reference.  Build with -fmad=false so nothing is contracted.

#include <cuda_runtime.h>

#include "bw_tri_test.cuh"

namespace {

using ignis::bw_inv;
using ignis::bw_slab;
using ignis::bw_tri_test;

constexpr int kRow = 128;        // floats per tl_top row
constexpr int kWidth = 8;        // children / instance slots per row
constexpr int kTypeLane = 126;
constexpr int kInstFloats = 32;
constexpr int kTriTile = 8;
constexpr int kStack = 64;       // entries; the wrapper raises when the need is larger
constexpr int kThreads = 128;
constexpr float kMissingHalf = -0.5e9f;

template <bool ANY>
__global__ void __launch_bounds__(kThreads)
tlas_kernel(const float* __restrict__ top, const float* __restrict__ tris,
            const float* __restrict__ clust, const float* __restrict__ inst,
            const float* __restrict__ org, const float* __restrict__ dir,
            const float* __restrict__ tmin_p, const float* __restrict__ tmax_p, int n,
            int mask_bit, float* __restrict__ out_t, float* __restrict__ out_u,
            float* __restrict__ out_v, int* __restrict__ out_row,
            int* __restrict__ out_inst) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float ox = org[3 * i + 0], oy = org[3 * i + 1], oz = org[3 * i + 2];
    const float dx = dir[3 * i + 0], dy = dir[3 * i + 1], dz = dir[3 * i + 2];
    const float tmn = tmin_p[i];
    float bt = tmax_p[i];
    const float ix = bw_inv(dx), iy = bw_inv(dy), iz = bw_inv(dz);
    float bu = 0.f, bv = 0.f;
    int bi = -1, be = -1;

    int stack[kStack];
    int sp = 0;
    stack[sp++] = 0;
    bool done = false;

    while (sp > 0 && !done) {
        const float* row = top + (size_t)stack[--sp] * kRow;
        if (__ldg(row + kTypeLane) > 0.5f) {
            // ---- leaf row: the instances of slots 0..7
            for (int s = 0; s < kWidth && !done; ++s) {
                const int iid = static_cast<int>(__ldg(row + s));
                if (iid < 0) continue;
                const float* ir = inst + (size_t)iid * kInstFloats;
                if (!(__ldg(ir + 6) > 0.f)) continue;
                if ((static_cast<int>(__ldg(ir + 23)) & mask_bit) == 0) continue;
                float wb[6];
#pragma unroll
                for (int q = 0; q < 6; ++q) wb[q] = __ldg(ir + q);
                if (!bw_slab(wb, ox, oy, oz, ix, iy, iz, tmn, bt)) continue;

                // local ray; t is preserved
                float m[12];
#pragma unroll
                for (int q = 0; q < 12; ++q) m[q] = __ldg(ir + 10 + q);
                const float lox = (m[0] * ox + m[1] * oy) + (m[2] * oz + m[3]);
                const float loy = (m[4] * ox + m[5] * oy) + (m[6] * oz + m[7]);
                const float loz = (m[8] * ox + m[9] * oy) + (m[10] * oz + m[11]);
                const float ldx = m[0] * dx + m[1] * dy + m[2] * dz;
                const float ldy = m[4] * dx + m[5] * dy + m[6] * dz;
                const float ldz = m[8] * dx + m[9] * dy + m[10] * dz;
                const float lix = bw_inv(ldx), liy = bw_inv(ldy), liz = bw_inv(ldz);
                const int cl0 = static_cast<int>(__ldg(ir + 7));
                const int ccnt = static_cast<int>(__ldg(ir + 8));
                const int toff = static_cast<int>(__ldg(ir + 9));

                for (int c = 0; c < ccnt && !done; ++c) {
                    const float4* cb4 =
                        reinterpret_cast<const float4*>(clust + (size_t)(cl0 + c) * 8);
                    const float4 c0 = __ldg(cb4), c1 = __ldg(cb4 + 1);
                    const float cb[6] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y};
                    if (!(c1.z > 0.f)) continue;
                    if (!bw_slab(cb, lox, loy, loz, lix, liy, liz, tmn, bt)) continue;
                    const int r0 = toff + c * kTriTile;
                    const float4* t4 = reinterpret_cast<const float4*>(tris + (size_t)r0 * 16);
#pragma unroll 2
                    for (int kk = 0; kk < kTriTile; ++kk) {
                        const float4 a = __ldg(t4 + 4 * kk + 0);
                        const float4 b = __ldg(t4 + 4 * kk + 1);
                        const float4 g = __ldg(t4 + 4 * kk + 2);
                        const float4 h = __ldg(t4 + 4 * kk + 3);
                        const float tr[16] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
                                              g.x, g.y, g.z, g.w, h.x, h.y, h.z, h.w};
                        float tt, u, v;
                        if (bw_tri_test(tr, mask_bit, lox, loy, loz, ldx, ldy, ldz, tmn, bt,
                                        tt, u, v)) {
                            bt = tt;
                            bi = r0 + kk;
                            be = iid;
                            if (ANY) { done = true; break; }
                            bu = fmaxf(u, 0.f);
                            bv = fmaxf(v, 0.f);
                        }
                    }
                }
            }
        } else {
            // ---- inner row: push the children whose box the window crosses
            const float4* r4 = reinterpret_cast<const float4*>(row);
            const float4 ch0 = __ldg(r4 + 16);
            const float4 ch1 = __ldg(r4 + 17);
            const float child[kWidth] = {ch0.x, ch0.y, ch0.z, ch0.w,
                                         ch1.x, ch1.y, ch1.z, ch1.w};
            float bx[48];
#pragma unroll
            for (int q = 0; q < 12; ++q) {
                const float4 f = __ldg(r4 + q);
                bx[4 * q + 0] = f.x; bx[4 * q + 1] = f.y;
                bx[4 * q + 2] = f.z; bx[4 * q + 3] = f.w;
            }
#pragma unroll
            for (int c = 0; c < kWidth; ++c) {
                if (bw_slab(bx + 6 * c, ox, oy, oz, ix, iy, iz, tmn, bt) &&
                    (child[c] > kMissingHalf)) {
                    // the wrapper sized the walk to fit: a push is never
                    // dropped, a stack that overflows all the same is a fault
                    if (sp >= kStack) __trap();
                    stack[sp++] = static_cast<int>(child[c]);
                }
            }
        }
    }
    out_t[i] = bt;
    out_u[i] = bu;
    out_v[i] = bv;
    out_row[i] = bi;
    out_inst[i] = be;
}

}  // namespace

// The largest per-ray stack the kernel was compiled with.
extern "C" int ignis_tlas_stack_entries() { return kStack; }

// Launches on `stream`, allocates nothing, does not synchronise.
// Returns cudaGetLastError() as an int (0 = launched).
extern "C" int ignis_tlas(const void* top, const void* tris, const void* clust,
                          const void* inst, const void* org, const void* dir,
                          const void* tmin, const void* tmax, int n, int mask_bit,
                          int any_hit, void* out_t, void* out_u, void* out_v, void* out_row,
                          void* out_inst, void* stream) {
    if (n <= 0) return 0;
    const int blocks = (n + kThreads - 1) / kThreads;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto f = [](const void* p) { return static_cast<const float*>(p); };
    if (any_hit) {
        tlas_kernel<true><<<blocks, kThreads, 0, s>>>(
            f(top), f(tris), f(clust), f(inst), f(org), f(dir), f(tmin), f(tmax), n, mask_bit,
            static_cast<float*>(out_t), static_cast<float*>(out_u),
            static_cast<float*>(out_v), static_cast<int*>(out_row),
            static_cast<int*>(out_inst));
    } else {
        tlas_kernel<false><<<blocks, kThreads, 0, s>>>(
            f(top), f(tris), f(clust), f(inst), f(org), f(dir), f(tmin), f(tmax), n, mask_bit,
            static_cast<float*>(out_t), static_cast<float*>(out_u),
            static_cast<float*>(out_v), static_cast<int*>(out_row),
            static_cast<int*>(out_inst));
    }
    return static_cast<int>(cudaGetLastError());
}
