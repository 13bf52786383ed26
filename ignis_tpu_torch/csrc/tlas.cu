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
// implicit 8-ary tree of boxes over it.  An entered instance walks its
// range through that tree (`walk_clusters`, cluster_walk.cuh, shared with
// bw_intersect.cu), which skips a subtree whose box the ray's window misses
// and changes no decision: the clusters entered are the dense sweep's, in its
// order, with the same running best (the argument is in cluster_walk.cuh).
//
// (B) Eight lanes a ray (4 rays a warp, 16 a block).  An inner row: lane k
// tests child k, and the passing children are pushed 0..7 from a ballot onto
// the ray's stack in shared memory (popped last first, as before).  A leaf
// row: lane k computes slot k's world-box interval without the best.  Slots
// are decided in order on the running best, which changes only when a
// cluster is entered, so all of them up to the next entry are decided at
// once by one ballot of near <= nan_min(far_nobt, bt): that is `bw_slab`'s
// decision bit for bit and the plain version's `near <= far & near <= bt` (a
// NaN anywhere makes each false).  The cluster walk works the same way on its
// groups of 8, and an entered cluster's eight triangles take a lane each.
// Every decision stays per ray, and a warp runs the union of 4 walks, not 32.
//
// The slab and triangle tests are those of bw_tri_test.cuh; the local ray is
// (m0*ox + m1*oy) + (m2*oz + m3) and m0*dx + m1*dy + m2*dz, as in the
// reference.  Build with -fmad=false so nothing is contracted.

#include <cuda_runtime.h>

#include "cluster_walk.cuh"

namespace {

using ignis::nan_min;
using ignis::safe_inv;
using ignis::bw_slab;
using ignis::slab_nobt;
using ignis::walk_clusters;

constexpr int kRow = 128;        // floats per tl_top row
constexpr int kWidth = ignis::kWalkWidth;   // children / slots per row, lanes per ray
constexpr int kTypeLane = 126;
constexpr int kInstFloats = 32;
constexpr int kNodeFloats = ignis::kNodeFloats;   // tl_ctree row
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

struct Count {
    unsigned long long c[14] = {};
    unsigned long long steps = 0;
    bool lead;   // the ray's lane 0 counts per-ray values

    __device__ void loop(int k) {
        steps += 1;
        const unsigned am = __activemask();
        if ((threadIdx.x & 31) == __ffs(am) - 1) {
            c[6 + 2 * k] += 1;
            c[7 + 2 * k] += __popc(am);
        }
    }
    __device__ void bump(int k, unsigned long long v) { c[k] += lead ? v : 0; }
    __device__ void walk_step() { loop(2); }
    __device__ void tri_step() { loop(3); }
    __device__ void nodes(unsigned v) { bump(3, v); }
    __device__ void clusters(unsigned v) { bump(4, v); }
    __device__ void tris(unsigned v) { bump(5, v); }
};
#else
struct Count : ignis::NoCount {
    bool lead;
    __device__ void loop(int) {}
    __device__ void bump(int, unsigned long long) {}
};
#endif

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
    const ignis::Segment sg = ignis::Segment::of_thread();
    const int sub = sg.sub;                       // lane within the ray's segment
    const unsigned seg = sg.mask;
    auto bits = [&](bool p) { return sg.bits(p); };

    const float ox = org[3 * i + 0], oy = org[3 * i + 1], oz = org[3 * i + 2];
    const float dx = dir[3 * i + 0], dy = dir[3 * i + 1], dz = dir[3 * i + 2];
    const float tmn = tmin_p[i];
    float bt = tmax_p[i];
    const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
    float bu = 0.f, bv = 0.f;
    int bi = -1, be = -1;

    Count cnt;
    cnt.lead = sub == 0;
    cnt.bump(0, 1);
    // the ray's stack, shared by its lanes
    __shared__ int stacks[kThreads / kWidth][kStack];
    int* stack = stacks[threadIdx.x / kWidth];
    if (sub == 0) stack[0] = 0;
    __syncwarp(seg);
    int sp = 1;
    bool done = false;

    while (sp > 0 && !done) {
        cnt.loop(0);
        cnt.bump(1, 1);
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
                cnt.loop(1);
                const unsigned go = bits(snear <= nan_min(sfar, bt)) & slots;
                if (!go) break;
                const int s = __ffs(go) - 1;
                slots &= ~0u << (s + 1);
                const int iid = __shfl_sync(seg, iid_k, s, kWidth);
                cnt.bump(2, 1);

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
                const float hdr = __ldg(ctree + (size_t)iid * kNodeFloats + sub);
                if (walk_clusters<ANY>(clust + (size_t)cl0 * kNodeFloats, tris, toff, ccnt,
                                       ctree, hdr, sg, lox, loy, loz, ldx, ldy, ldz, lix, liy,
                                       liz, tmn, mask_bit, bt, bu, bv, bi, cnt)) {
                    be = iid;
                    if (ANY) done = true;
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
        if (cnt.c[k]) atomicAdd(tlas_counts + k, cnt.c[k]);
    atomicMax(tlas_counts + 14, cnt.steps);
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
