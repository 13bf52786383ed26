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
// `tlas_traverse_plain` (ops/tlas.py) is the specification, bit for bit.
//
// What bounds it on this card: the latency of dependent, divergent steps.
// The tables of a scene with a thousand instances of one mesh are under 1 MB
// and stay in L1/L2; a ray moves 32 bytes in and 20 out.  One ray per thread
// swept all 160 clusters of an entered instance, one box a step, and a warp
// ran the union of 32 such walks (10 % of its lanes busy in the cluster loop,
// 4 % in the triangle loop: `scripts/torch_tlas_check.py` on the dense walk).
//
// What the design does about it:
//
// (A) A cluster tree.  `tl_ctree` (ops/tlas.py, `build_cluster_tree`) holds,
// for each instance, a header row [levels L, first row of level 1..7] and,
// for each distinct cluster range [cl0, cl0 + ccnt) of `tl_clust`, an
// implicit 8-ary tree: a level-l node covers 8^l consecutive clusters, its
// box is the float32 min / max of its valid children's boxes (min(lo, hi) and
// max(lo, hi) of each), it is valid iff a child is; level l + 1 exists while
// level l has more than 8 nodes, so level L is one group of at most 8.  The
// walk is stackless.  At cluster c it works at a level l (after a pass: one
// below; after a skip or a finished node: the largest level <= L aligned at
// c): the group of 8 siblings holding node c >> 3l is decided in order from
// that node, each against the running best; the first that passes is
// descended into (at level 0 it is entered: its eight triangles), the ones
// before it are skipped, and when none passes the walk moves past the whole
// group.  Clusters are still decided one by one, in ascending order, each by
// `bw_slab` against the running best, as in the plain version.
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
//  bits.  (Before the reference's rule for subnormals, 1 / d of a subnormal
//  component was infinite; that case no longer arises.)  tests/test_torch_tlas.py
//  holds the node test to it on rays with NaN / inf / +-0 / zero / subnormal
//  direction components, and shows that `bw_slab` on a node is not enough.
//
// (B) Eight lanes a ray (4 rays a warp, 16 a block).  An inner row: lane k
// tests child k, and the passing children are pushed 0..7 from a ballot onto
// the ray's stack in shared memory (popped last first, as before).  A leaf
// row: lane k computes slot k's world-box interval without the best.  A
// group of the walk: lane k computes member k's interval (a level-0 group is
// kept until the walk leaves it).  Slots and members are decided in order on
// the running best, which changes only when a cluster is entered, so all of
// them up to the next entry are decided at once by one ballot of near <=
// nan_min(far_nobt, bt): that is `bw_slab`'s decision bit for bit and the
// plain version's `near <= far & near <= bt` (a NaN anywhere makes each
// false).  An entered cluster: lane k tests triangle k
// against the best at entry; the sequential `t <= best` sweep leaves the
// smallest accepted t at the HIGHEST index that reaches it, so the closest
// entry takes min t, ties to the larger k; the any-hit entry takes the lowest
// accepted k.  Every decision stays per ray, and a warp runs the union of 4
// walks, not 32.
//
// The slab and triangle tests are those of bw_tri_test.cuh; the local ray is
// (m0*ox + m1*oy) + (m2*oz + m3) and m0*dx + m1*dy + m2*dz, as in the
// reference.  Build with -fmad=false so nothing is contracted.

#include <cuda_runtime.h>

#include "bw_tri_test.cuh"

namespace {

using ignis::nan_max;
using ignis::nan_min;
using ignis::safe_inv;
using ignis::bw_slab;
using ignis::bw_tri_test;

constexpr int kRow = 128;        // floats per tl_top row
constexpr int kWidth = 8;        // children / slots per row, members per group, lanes per ray
constexpr int kTypeLane = 126;
constexpr int kInstFloats = 32;
constexpr int kNodeFloats = 8;   // tl_ctree row: lo(3), hi(3), valid, 0
constexpr int kTriTile = 8;
constexpr int kStack = 64;       // entries; the wrapper raises when the need is larger
constexpr int kThreads = 128;    // 16 rays a block
constexpr float kMissingHalf = -0.5e9f;

#ifdef TLAS_COUNT
// Diagnostic build only (`scripts/torch_tlas_check.py` compiles a copy with
// -DTLAS_COUNT).  Per ray: [0] rays, [1] top rows visited, [2] instances
// entered, [3] cluster-tree nodes decided, [4] cluster boxes decided, [5]
// triangles tested.  Per warp and loop (top rows, leaf slots, cluster walk,
// triangles): [6 + 2k] warp iterations, [7 + 2k] active lanes summed over
// them; SIMT efficiency = lanes / (32 x iterations).  [14] the most loop
// iterations (steps) any one ray took.
__device__ unsigned long long tlas_counts[15];
#define TLAS_LOOP(k)                                                   \
    do {                                                               \
        steps += 1;                                                    \
        const unsigned am_ = __activemask();                           \
        if ((threadIdx.x & 31) == __ffs(am_) - 1) {                    \
            cnt[6 + 2 * (k)] += 1;                                     \
            cnt[7 + 2 * (k)] += __popc(am_);                           \
        }                                                              \
    } while (0)
#define TLAS_BUMP(k, v) (cnt[k] += (sub == 0) ? (v) : 0)
#else
#define TLAS_LOOP(k) ((void)0)
#define TLAS_BUMP(k, v) ((void)0)
#endif

// A node's contribution on one axis: [a, b], or unconstrained when either
// end is NaN (see the header).
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

template <bool ANY>
__global__ void __launch_bounds__(kThreads)
tlas_kernel(const float* __restrict__ top, const float* __restrict__ tris,
            const float* __restrict__ clust, const float* __restrict__ inst,
            const float* __restrict__ ctree, const float* __restrict__ org,
            const float* __restrict__ dir, const float* __restrict__ tmin_p,
            const float* __restrict__ tmax_p, int n, int mask_bit, float* __restrict__ out_t,
            float* __restrict__ out_u, float* __restrict__ out_v, int* __restrict__ out_row,
            int* __restrict__ out_inst) {
    const int i = (blockIdx.x * blockDim.x + threadIdx.x) / kWidth;
    if (i >= n) return;                           // whole segments leave together
    const int sub = threadIdx.x & (kWidth - 1);   // lane within the ray's segment
    const int seg_lo = threadIdx.x & 31 & ~(kWidth - 1);
    const unsigned seg = 0xFFu << seg_lo;
    auto bits = [&](bool p) { return (__ballot_sync(seg, p) >> seg_lo) & 0xFFu; };
    auto from = [&](float x, int src) { return __shfl_sync(seg, x, src, kWidth); };
    // (a segment's lanes take the same branches: every ballot and shuffle
    // below is reached by all eight)

    const float ox = org[3 * i + 0], oy = org[3 * i + 1], oz = org[3 * i + 2];
    const float dx = dir[3 * i + 0], dy = dir[3 * i + 1], dz = dir[3 * i + 2];
    const float tmn = tmin_p[i];
    float bt = tmax_p[i];
    const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
    float bu = 0.f, bv = 0.f;
    int bi = -1, be = -1;

#ifdef TLAS_COUNT
    unsigned long long cnt[14] = {sub == 0 ? 1ull : 0ull, 0, 0, 0, 0, 0, 0,
                                  0, 0, 0, 0, 0, 0, 0};
    unsigned long long steps = 0;
#endif
    // the ray's stack, shared by its lanes
    __shared__ int stacks[kThreads / kWidth][kStack];
    int* stack = stacks[threadIdx.x / kWidth];
    if (sub == 0) stack[0] = 0;
    __syncwarp(seg);
    int sp = 1;
    bool done = false;

    while (sp > 0 && !done) {
        TLAS_LOOP(0);
        TLAS_BUMP(1, 1);
        const float* row = top + (size_t)stack[--sp] * kRow;
        __syncwarp(seg);                          // read before a push overwrites it
        if (__ldg(row + kTypeLane) > 0.5f) {
            // ---- leaf row: lane `sub` looks at slot `sub`
            const int iid_k = static_cast<int>(__ldg(row + sub));
            float snear = 0.f, sfar = 0.f;
            bool cand = false;
            if (iid_k >= 0) {
                const float* ir = inst + (size_t)iid_k * kInstFloats;
                if (__ldg(ir + 6) > 0.f && (static_cast<int>(__ldg(ir + 23)) & mask_bit)) {
                    float wb[6];
#pragma unroll
                    for (int q = 0; q < 6; ++q) wb[q] = __ldg(ir + q);
                    slab_nobt(wb, ox, oy, oz, ix, iy, iz, tmn, snear, sfar);
                    cand = true;
                }
            }
            // the slots are decided in order on the running best; it changes
            // only in an entered instance, so the ones up to the next entry
            // are decided at once
            unsigned slots = bits(cand);
            while (slots && !done) {
                TLAS_LOOP(1);
                const unsigned go = bits(snear <= nan_min(sfar, bt)) & slots;
                if (!go) break;
                const int s = __ffs(go) - 1;
                slots &= ~0u << (s + 1);
                const int iid = __shfl_sync(seg, iid_k, s, kWidth);
                TLAS_BUMP(2, 1);

                // local ray; t is preserved
                const float* ir = inst + (size_t)iid * kInstFloats;
                float m[12];
#pragma unroll
                for (int q = 0; q < 12; ++q) m[q] = __ldg(ir + 10 + q);
                const float lox = (m[0] * ox + m[1] * oy) + (m[2] * oz + m[3]);
                const float loy = (m[4] * ox + m[5] * oy) + (m[6] * oz + m[7]);
                const float loz = (m[8] * ox + m[9] * oy) + (m[10] * oz + m[11]);
                const float ldx = m[0] * dx + m[1] * dy + m[2] * dz;
                const float ldy = m[4] * dx + m[5] * dy + m[6] * dz;
                const float ldz = m[8] * dx + m[9] * dy + m[10] * dz;
                const float lix = safe_inv(ldx), liy = safe_inv(ldy), liz = safe_inv(ldz);
                const int cl0 = static_cast<int>(__ldg(ir + 7));
                const int ccnt = static_cast<int>(__ldg(ir + 8));
                const int toff = static_cast<int>(__ldg(ir + 9));
                const float4* h4 =
                    reinterpret_cast<const float4*>(ctree + (size_t)iid * kNodeFloats);
                const float4 h0 = __ldg(h4), h1 = __ldg(h4 + 1);
                const int levels = static_cast<int>(h0.x);

                // ---- the walk over the cluster tree (0 levels: the dense sweep)
                int c = 0, l = levels;
                int cached = -1;              // the level-0 group in gnear / gfar
                float gnear = 0.f, gfar = 0.f;
                unsigned gvalid = 0;
                while (c < ccnt && !done) {
                    TLAS_LOOP(2);
                    const int sh = 3 * l;
                    const int j = c >> sh;               // the node holding cluster c
                    const int gb = j & ~(kWidth - 1);    // its group of 8 siblings
                    if (l > 0 || gb != cached) {
                        const int nl = (ccnt + (1 << sh) - 1) >> sh;
                        const int mm = gb + sub;
                        bool valid = false;
                        if (mm < nl) {
                            const float* src;
                            if (l == 0) {
                                src = clust + (size_t)(cl0 + mm) * 8;
                            } else {
                                const float base = l == 1 ? h0.y : l == 2 ? h0.z
                                                 : l == 3 ? h0.w : l == 4 ? h1.x
                                                 : l == 5 ? h1.y : l == 6 ? h1.z : h1.w;
                                src = ctree + ((size_t)base + mm) * kNodeFloats;
                            }
                            const float4 c0 = __ldg(reinterpret_cast<const float4*>(src));
                            const float4 c1 = __ldg(reinterpret_cast<const float4*>(src) + 1);
                            const float bx[6] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y};
                            valid = c1.z > 0.f;
                            if (l == 0) {
                                slab_nobt(bx, lox, loy, loz, lix, liy, liz, tmn, gnear, gfar);
                            } else {
                                node_nobt(bx, lox, loy, loz, lix, liy, liz, tmn, gnear, gfar);
                            }
                        }
                        gvalid = bits(valid);
                        cached = l == 0 ? gb : -1;
                    }
                    // decide the members from node j on, in order, on the
                    // running best (fixed until a cluster is entered): the
                    // first that passes, the ones before it skipped
                    const unsigned todo = gvalid & (0xFFu << (j - gb));
                    // (a cluster by `bw_slab`'s rule, a node conservatively)
                    const unsigned pm =
                        bits(gnear <= (l == 0 ? nan_min(gfar, bt) : fminf(gfar, bt))) & todo;
                    const int pass = pm ? gb + __ffs(pm) - 1 : -1;
                    TLAS_BUMP(l == 0 ? 4 : 3,
                              __popc(pm ? todo & ((2u << (__ffs(pm) - 1)) - 1) : todo));
                    if (pass < 0) {                      // past the whole group
                        c = (gb + kWidth) << sh;
                        l = aligned_level(c, levels);
                        continue;
                    }
                    if (l > 0) {                         // descend
                        c = pass << sh;
                        l -= 1;
                        continue;
                    }
                    // ---- cluster `pass` entered: lane `sub` tests its triangle `sub`
                    TLAS_LOOP(3);
                    TLAS_BUMP(5, kTriTile);
                    const int r0 = toff + pass * kTriTile;
                    const float4* t4 =
                        reinterpret_cast<const float4*>(tris + (size_t)(r0 + sub) * 16);
                    const float4 a = __ldg(t4 + 0), b = __ldg(t4 + 1);
                    const float4 g = __ldg(t4 + 2), h = __ldg(t4 + 3);
                    const float tr[16] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
                                          g.x, g.y, g.z, g.w, h.x, h.y, h.z, h.w};
                    float tt, u, v;
                    const bool ok = bw_tri_test(tr, mask_bit, lox, loy, loz, ldx, ldy, ldz,
                                                tmn, bt, tt, u, v);
                    const unsigned acc = bits(ok);
                    if (acc) {
                        int win;
                        if (ANY || (acc & (acc - 1)) == 0) {
                            win = __ffs(acc) - 1;        // the first the sweep accepts
                        } else {
                            // the last index that reaches the smallest t
                            int wok = ok;
                            float wt = tt;
                            int wk = sub;
#pragma unroll
                            for (int off = kWidth / 2; off > 0; off >>= 1) {
                                const int ook = __shfl_xor_sync(seg, wok, off, kWidth);
                                const float ot = __shfl_xor_sync(seg, wt, off, kWidth);
                                const int ok2 = __shfl_xor_sync(seg, wk, off, kWidth);
                                if (ook && (!wok || ot < wt || (ot == wt && ok2 > wk))) {
                                    wok = ook;
                                    wt = ot;
                                    wk = ok2;
                                }
                            }
                            win = wk;
                        }
                        bt = from(tt, win);
                        bi = r0 + win;
                        be = iid;
                        if (ANY) {
                            done = true;
                        } else {
                            bu = fmaxf(from(u, win), 0.f);
                            bv = fmaxf(from(v, win), 0.f);
                        }
                    }
                    c = pass + 1;
                    l = aligned_level(c, levels);
                }
            }
        } else {
            // ---- inner row: lane `sub` tests child `sub`; the passing
            // children are pushed 0..7 in order (popped last first)
            const float child = __ldg(row + 64 + sub);
            const float2* b2 = reinterpret_cast<const float2*>(row + 6 * sub);
            const float2 p0 = __ldg(b2), p1 = __ldg(b2 + 1), p2 = __ldg(b2 + 2);
            const float bx[6] = {p0.x, p0.y, p1.x, p1.y, p2.x, p2.y};
            const unsigned push =
                bits(bw_slab(bx, ox, oy, oz, ix, iy, iz, tmn, bt) && child > kMissingHalf);
            // the wrapper sized the walk to fit: a push is never dropped, a
            // stack that overflows all the same is a fault
            if (sp + __popc(push) > kStack) __trap();
            if ((push >> sub) & 1u)
                stack[sp + __popc(push & ((1u << sub) - 1))] = static_cast<int>(child);
            sp += __popc(push);
            __syncwarp(seg);
        }
    }
#ifdef TLAS_COUNT
    for (int k = 0; k < 14; ++k)
        if (cnt[k]) atomicAdd(tlas_counts + k, cnt[k]);
    atomicMax(tlas_counts + 14, steps);
#endif
    if (sub == 0) {
        out_t[i] = bt;
        out_u[i] = bu;
        out_v[i] = bv;
        out_row[i] = bi;
        out_inst[i] = be;
    }
}

}  // namespace

// The largest per-ray stack the kernel was compiled with.
extern "C" int ignis_tlas_stack_entries() { return kStack; }

#ifdef TLAS_COUNT
// Copies the counts to `out` on the host and sets them to 0.
extern "C" int ignis_tlas_counts(unsigned long long* out) {
    cudaError_t err = cudaMemcpyFromSymbol(out, tlas_counts, sizeof(tlas_counts));
    if (err != cudaSuccess) return (int)err;
    const unsigned long long zero[15] = {};
    return (int)cudaMemcpyToSymbol(tlas_counts, zero, sizeof(zero));
}
#endif

// Launches on `stream`, allocates nothing, does not synchronise.
// Returns cudaGetLastError() as an int (0 = launched).
extern "C" int ignis_tlas(const void* top, const void* tris, const void* clust,
                          const void* inst, const void* ctree, const void* org,
                          const void* dir, const void* tmin, const void* tmax, int n,
                          int mask_bit, int any_hit, void* out_t, void* out_u, void* out_v,
                          void* out_row, void* out_inst, void* stream) {
    if (n <= 0) return 0;
    const long long threads = (long long)n * kWidth;
    const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto f = [](const void* p) { return static_cast<const float*>(p); };
    if (any_hit) {
        tlas_kernel<true><<<blocks, kThreads, 0, s>>>(
            f(top), f(tris), f(clust), f(inst), f(ctree), f(org), f(dir), f(tmin), f(tmax), n,
            mask_bit, static_cast<float*>(out_t), static_cast<float*>(out_u),
            static_cast<float*>(out_v), static_cast<int*>(out_row),
            static_cast<int*>(out_inst));
    } else {
        tlas_kernel<false><<<blocks, kThreads, 0, s>>>(
            f(top), f(tris), f(clust), f(inst), f(ctree), f(org), f(dir), f(tmin), f(tmax), n,
            mask_bit, static_cast<float*>(out_t), static_cast<float*>(out_u),
            static_cast<float*>(out_v), static_cast<int*>(out_row),
            static_cast<int*>(out_inst));
    }
    return static_cast<int>(cudaGetLastError());
}
