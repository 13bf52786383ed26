// Device functions shared by the Baldwin-Weber kernels (bw_intersect.cu,
// tlas.cu): the ray / box slab test and the ray / precomputed-triangle test.
//
// Arithmetic follows `_tri_test` and the slab test of
// ignis_tpu/ops/bw_intersect.py term by term, including the association
// (nx*ox + ny*oy) + (nz*oz + d0); build with -fmad=false so the products are
// not contracted and the results equal the plain PyTorch versions bit for bit.
// Zero tests and slab minima follow the reference's float rules
// (ref_float.cuh): a subnormal k counts as 0, a NaN in the chain rejects.

#pragma once

#include <cuda_runtime.h>

#include "ref_float.cuh"

namespace ignis {

constexpr float kBwTol = 1.1920928955078125e-07f;

// Does the ray's [tmn, bt] window cross the box lo = b[0..2], hi = b[3..5]?
// (ix, iy, iz = safe_inv of the direction; false when the chain holds a NaN)
__device__ __forceinline__ bool bw_slab(const float* __restrict__ b, float ox, float oy,
                                        float oz, float ix, float iy, float iz,
                                        float tmn, float bt) {
    const float t0x = (b[0] - ox) * ix;
    const float t1x = (b[3] - ox) * ix;
    const float t0y = (b[1] - oy) * iy;
    const float t1y = (b[4] - oy) * iy;
    const float t0z = (b[2] - oz) * iz;
    const float t1z = (b[5] - oz) * iz;
    const float near_ = nan_max(nan_max(nan_min(t0x, t1x), nan_min(t0y, t1y)),
                                nan_max(nan_min(t0z, t1z), tmn));
    const float far_ = nan_min(nan_min(nan_max(t0x, t1x), nan_max(t0y, t1y)),
                               nan_min(nan_max(t0z, t1z), bt));
    return near_ <= far_;
}

// One 16-float Baldwin-Weber row (n, d0, B1, b1, B2, b2, mask bits, id)
// against one ray.  Returns whether the hit is accepted (inside, visible to
// `mask_bit`, tmn <= t <= bt) and writes t and the unclamped u, v.
__device__ __forceinline__ bool bw_tri_test(const float* __restrict__ row, int mask_bit,
                                            float ox, float oy, float oz, float dx,
                                            float dy, float dz, float tmn, float bt,
                                            float& tt, float& u, float& v) {
    const float nx = row[0], ny = row[1], nz = row[2], d0 = row[3];
    const float b1x = row[4], b1y = row[5], b1z = row[6], b1c = row[7];
    const float b2x = row[8], b2y = row[9], b2z = row[10], b2c = row[11];
    const bool vis = (static_cast<int>(row[12]) & mask_bit) != 0;
    const float m = (nx * ox + ny * oy) + (nz * oz + d0);
    const float kk = nx * dx + ny * dy + nz * dz;
    const bool kz = is_zero(kk);
    const float inv_k = kz ? 0.f : 1.0f / kk;
    tt = -m * inv_k;
    const float s1 = (b1x * ox + b1y * oy) + (b1z * oz + b1c);
    const float r1 = b1x * dx + b1y * dy + b1z * dz;
    u = s1 + tt * r1;
    const float s2 = (b2x * ox + b2y * oy) + (b2z * oz + b2c);
    const float r2 = b2x * dx + b2y * dy + b2z * dz;
    v = s2 + tt * r2;
    return vis && !kz && (u >= -kBwTol) && (v >= -kBwTol) &&
           (u + v <= 1.0f + kBwTol) && (tt >= tmn) && (tt <= bt);
}

}  // namespace ignis
