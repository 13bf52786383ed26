// The walk over a cluster tree, shared by the Baldwin-Weber kernels
// (bw_intersect.cu: one range, the whole soup; tlas.cu: the range of each
// entered instance).  `ops/bw_intersect.py` (`_walk_clusters`) is the same
// walk in PyTorch, for the tests.
//
// The tree (`cluster_levels` in ops/bw_intersect.py) is an implicit 8-ary
// tree over a range of clusters [0, ccnt): a level-l node covers 8^l
// consecutive clusters, its box is the float32 min / max of its valid
// children's boxes (min(lo, hi) and max(lo, hi) of each), it is valid iff a
// child is; level l + 1 exists while level l has more than 8 nodes, so level L
// is one group of at most 8.  A header row gives [L, first row of level
// 1..7].  The walk is stackless.  At cluster c it works at a level l (after a
// pass: one below; after a skip or a finished node: the largest level <= L
// aligned at c): the group of 8 siblings holding node c >> 3l is decided in
// order from that node, each against the running best; the first that passes
// is descended into (at level 0 it is entered: its eight triangles), the ones
// before it are skipped, and when none passes the walk moves past the whole
// group.  Clusters are still decided one by one, in ascending order, each by
// `bw_slab` against the running best, as in the dense sweep.
//
// Why that is exact.  The decisions equal the dense sweep's when a node that
// fails proves that every cluster below it fails.  A node is tested on the
// best it sees, never smaller than the best any later cluster below it sees,
// and a box test is monotone in the best (far = min(.., bt)).  So it is
// enough that "a child passes => its parent passes" on one best.  A child
// passes `bw_slab` only when no value of its chain is NaN (nan_min / nan_max,
// the reference's rule, ref_float.cuh); per axis it contributes a = min(t0,
// t1) to near and b = max(t0, t1) to far, t = (box - o) * inv.  A node takes
// an axis with fminf / fmaxf but leaves it unconstrained (a = -inf, b = +inf)
// when t0 or t1 is NaN (`node_span`), and drops a NaN tmn or best.  inv =
// safe_inv(d) is finite (|inv| <= 2^126, or the 1e30 of a component that
// counts as 0), +-0 (an infinite component) or NaN.  Cases:
//  - inv finite, non-zero: box - o and the product are monotone under
//    round-to-nearest, overflow to inf included; the node's lo <= min(child
//    lo, hi) and hi >= max(...), so the node's a <= the child's a and b >= b.
//    A node's end is NaN only where o is infinite and so is a coordinate of a
//    sibling's box: unconstrained.
//  - inv = +-0: t is +-0, or NaN where box - o is infinite.  A child that
//    passes has a finite box - o on that axis; a node's ends are +-0 too
//    (compared equal to the child's) or NaN (a sibling's infinite
//    coordinate): unconstrained.
//  - o or inv NaN: every t of the axis is NaN and no child passes.  A NaN box
//    coordinate: that child never passes; the builder's min / max keep it
//    in every node above, whose axis is then unconstrained.
//  So near(node) <= near(child) and far(node) >= far(child) whenever the
//  child passes, and child passes => node passes.  The clusters entered are
//  the dense sweep's, in its order, with the same running best: the same
//  bits.  tests/test_torch_tlas.py holds the node test to it on rays with
//  NaN / inf / +-0 / zero / subnormal direction components, and shows that
//  `bw_slab` on a node is not enough.
//
// Eight lanes a ray.  Lane k computes member k's interval without the best (a
// level-0 group is kept until the walk leaves it).  Members are decided in
// order on the running best, which changes only when a cluster is entered,
// so all of them up to the next entry are decided at once by one ballot of
// near <= nan_min(far_nobt, bt): that is `bw_slab`'s decision bit for bit
// (a NaN anywhere makes it false).  An entered cluster: lane k tests
// triangle k against the best at entry; the sequential `t <= best` sweep
// leaves the smallest accepted t at the HIGHEST index that reaches it, so the
// closest entry takes min t, ties to the larger k; the any-hit entry takes
// the lowest accepted k.  Every decision stays per ray, and a warp runs the
// union of 4 walks, not 32.

#pragma once

#include <cuda_runtime.h>

#include "bw_tri_test.cuh"

namespace ignis {

constexpr int kWalkWidth = 8;     // members a group, lanes a ray
constexpr int kNodeFloats = 8;    // tree row: lo(3), hi(3), valid, 0
constexpr int kClusterTris = 8;   // triangles a cluster

// The eight lanes of one ray in a warp.  A segment's lanes take the same
// branches, so every ballot and shuffle is reached by all eight.
struct Segment {
    unsigned mask;   // the segment's lanes in the warp
    int lo;          // its first lane
    int sub;         // this lane's index in it

    __device__ static Segment of_thread() {
        const int lo_ = threadIdx.x & 31 & ~(kWalkWidth - 1);
        return {0xFFu << lo_, lo_, static_cast<int>(threadIdx.x & (kWalkWidth - 1))};
    }
    __device__ unsigned bits(bool p) const { return (__ballot_sync(mask, p) >> lo) & 0xFFu; }
    __device__ float from(float x, int src) const {
        return __shfl_sync(mask, x, src, kWalkWidth);
    }
};

// What a diagnostic build counts (the kernels' -D*_COUNT builds pass their
// own); this one counts nothing and compiles away.
struct NoCount {
    __device__ void walk_step() {}
    __device__ void tri_step() {}
    __device__ void nodes(unsigned) {}
    __device__ void clusters(unsigned) {}
    __device__ void tris(unsigned) {}
};

// A node's contribution on one axis: [a, b], or unconstrained when either
// end is NaN (see above).
__device__ __forceinline__ void node_span(float lo, float hi, float o, float inv, float& a,
                                          float& b) {
    const float t0 = (lo - o) * inv;
    const float t1 = (hi - o) * inv;
    const bool nan = (t0 != t0) || (t1 != t1);
    a = nan ? -__int_as_float(0x7f800000) : fminf(t0, t1);
    b = nan ? __int_as_float(0x7f800000) : fmaxf(t0, t1);
}

// `bw_slab` without the best-t clip: near <= nan_min(far_nobt, bt) is
// bw_slab(..., bt).
__device__ __forceinline__ void slab_nobt(const float* __restrict__ b, float ox, float oy,
                                          float oz, float ix, float iy, float iz, float tmn,
                                          float& near_, float& far_) {
    const float t0x = (b[0] - ox) * ix;
    const float t1x = (b[3] - ox) * ix;
    const float t0y = (b[1] - oy) * iy;
    const float t1y = (b[4] - oy) * iy;
    const float t0z = (b[2] - oz) * iz;
    const float t1z = (b[5] - oz) * iz;
    near_ = nan_max(nan_max(nan_min(t0x, t1x), nan_min(t0y, t1y)),
                    nan_max(nan_min(t0z, t1z), tmn));
    far_ = nan_min(nan_min(nan_max(t0x, t1x), nan_max(t0y, t1y)), nan_max(t0z, t1z));
}

// The node test without the best-t clip.
__device__ __forceinline__ void node_nobt(const float* __restrict__ b, float ox, float oy,
                                          float oz, float ix, float iy, float iz, float tmn,
                                          float& near_, float& far_) {
    float ax, bx, ay, by, az, bz;
    node_span(b[0], b[3], ox, ix, ax, bx);
    node_span(b[1], b[4], oy, iy, ay, by);
    node_span(b[2], b[5], oz, iz, az, bz);
    near_ = fmaxf(fmaxf(ax, ay), fmaxf(az, tmn));
    far_ = fminf(fminf(bx, by), bz);
}

// Largest level <= top whose nodes are aligned at cluster c (> 0).
__device__ __forceinline__ int aligned_level(int c, int top) {
    return min(top, (__ffs(c) - 1) / 3);
}

// One ray's walk over clusters [0, ccnt) of `clust` (8-float rows, lane 6 =
// valid), whose triangles are the 16-float rows of `tris` from row `toff`,
// under the tree of `ctree` whose header row holds `hdr` at this lane's
// index (lane k: float k of [levels, first row of level 1..7]).  The ray (o,
// d, inv = safe_inv(d), tmn) and its best (bt, bu, bv, bi) at entry; bi
// becomes the accepted triangle's row in `tris`.  Returns whether a triangle
// was accepted (for ANY: the ray is done).
template <bool ANY, class Count>
__device__ __forceinline__ bool walk_clusters(
    const float* __restrict__ clust, const float* __restrict__ tris, int toff, int ccnt,
    const float* __restrict__ ctree, float hdr, const Segment& sg, float ox, float oy,
    float oz, float dx, float dy, float dz, float ix, float iy, float iz, float tmn,
    int mask_bit, float& bt, float& bu, float& bv, int& bi, Count& cnt) {
    const int sub = sg.sub;
    const int levels = static_cast<int>(sg.from(hdr, 0));
    bool hit = false;
    int c = 0, l = levels;
    int cached = -1;              // the level-0 group in gnear / gfar
    float gnear = 0.f, gfar = 0.f;
    unsigned gvalid = 0;
    while (c < ccnt && !(ANY && hit)) {
        cnt.walk_step();
        const int sh = 3 * l;
        const int j = c >> sh;                   // the node holding cluster c
        const int gb = j & ~(kWalkWidth - 1);    // its group of 8 siblings
        if (l > 0 || gb != cached) {
            const int nl = (ccnt + (1 << sh) - 1) >> sh;
            const int mm = gb + sub;
            const float base = sg.from(hdr, l);  // level l's first row (l > 0)
            bool valid = false;
            if (mm < nl) {
                const float* src = l == 0 ? clust + (size_t)mm * kNodeFloats
                                          : ctree + ((size_t)base + mm) * kNodeFloats;
                const float4 c0 = __ldg(reinterpret_cast<const float4*>(src));
                const float4 c1 = __ldg(reinterpret_cast<const float4*>(src) + 1);
                const float bx[6] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y};
                valid = c1.z > 0.f;
                if (l == 0) {
                    slab_nobt(bx, ox, oy, oz, ix, iy, iz, tmn, gnear, gfar);
                } else {
                    node_nobt(bx, ox, oy, oz, ix, iy, iz, tmn, gnear, gfar);
                }
            }
            gvalid = sg.bits(valid);
            cached = l == 0 ? gb : -1;
        }
        // decide the members from node j on, in order, on the running best
        // (fixed until a cluster is entered): the first that passes, the
        // ones before it skipped
        const unsigned todo = gvalid & (0xFFu << (j - gb));
        // (a cluster by `bw_slab`'s rule, a node conservatively)
        const unsigned pm =
            sg.bits(gnear <= (l == 0 ? nan_min(gfar, bt) : fminf(gfar, bt))) & todo;
        const int pass = pm ? gb + __ffs(pm) - 1 : -1;
        const unsigned decided = __popc(pm ? todo & ((2u << (__ffs(pm) - 1)) - 1) : todo);
        if (l == 0) {
            cnt.clusters(decided);
        } else {
            cnt.nodes(decided);
        }
        if (pass < 0) {                          // past the whole group
            c = (gb + kWalkWidth) << sh;
            l = aligned_level(c, levels);
            continue;
        }
        if (l > 0) {                             // descend
            c = pass << sh;
            l -= 1;
            continue;
        }
        // ---- cluster `pass` entered: lane `sub` tests its triangle `sub`
        cnt.tri_step();
        cnt.tris(kClusterTris);
        const int r0 = toff + pass * kClusterTris;
        const float4* t4 = reinterpret_cast<const float4*>(tris + (size_t)(r0 + sub) * 16);
        const float4 a = __ldg(t4 + 0), b = __ldg(t4 + 1);
        const float4 g = __ldg(t4 + 2), h = __ldg(t4 + 3);
        const float tr[16] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
                              g.x, g.y, g.z, g.w, h.x, h.y, h.z, h.w};
        float tt, u, v;
        const bool ok = bw_tri_test(tr, mask_bit, ox, oy, oz, dx, dy, dz, tmn, bt, tt, u, v);
        const unsigned acc = sg.bits(ok);
        if (acc) {
            int win;
            if (ANY || (acc & (acc - 1)) == 0) {
                win = __ffs(acc) - 1;            // the first the sweep accepts
            } else {
                // the last index that reaches the smallest t
                int wok = ok;
                float wt = tt;
                int wk = sub;
#pragma unroll
                for (int off = kWalkWidth / 2; off > 0; off >>= 1) {
                    const int ook = __shfl_xor_sync(sg.mask, wok, off, kWalkWidth);
                    const float ot = __shfl_xor_sync(sg.mask, wt, off, kWalkWidth);
                    const int ok2 = __shfl_xor_sync(sg.mask, wk, off, kWalkWidth);
                    if (ook && (!wok || ot < wt || (ot == wt && ok2 > wk))) {
                        wok = ook;
                        wt = ot;
                        wk = ok2;
                    }
                }
                win = wk;
            }
            bt = sg.from(tt, win);
            bi = r0 + win;
            hit = true;
            if (!ANY) {
                bu = fmaxf(sg.from(u, win), 0.f);
                bv = fmaxf(sg.from(v, win), 0.f);
            }
        }
        c = pass + 1;
        l = aligned_level(c, levels);
    }
    return hit;
}

}  // namespace ignis
