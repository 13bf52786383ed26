// Baldwin-Weber closest-hit / any-hit over a clustered soup.
//
// Replaces the Pallas TPU kernel of ignis_tpu/ops/bw_intersect.py
// (`_kernel` -> `_bw_loop` -> `_tri_test`, entries `bw_closest` / `bw_any`).
//
// What it computes: every ray against a soup that the host precomputed into
// Baldwin-Weber form (a plane and two barycentric functionals per triangle,
// 16 floats a row) and grouped into SAH-ordered clusters of 8 triangles, each
// with an AABB.  A ray tests a cluster's triangles only when its own [tmin,
// best] window crosses the cluster box; clusters are decided in order and a
// hit is accepted at t <= best, so among equal t the last triangle wins.
// `bw_closest_plain` / `bw_any_plain` (ops/bw_intersect.py, the dense
// cluster-by-cluster sweep) are the specification, bit for bit.
//
// What bounds it on this card: issued instructions at a full wave of 65536
// rays (more resident warps change nothing), the latency of a ray's dependent
// steps at a tail wave; never memory: the tables of the soups that take this
// path (under 4096 triangles) are a few KB to 256 KB and stay in L1/L2, and a
// ray moves 32 bytes in and 16 out.
// The first kernel ran one ray a thread over every cluster box (481 box
// tests a ray on a 3,842-triangle soup, of which 0.3 are entered) and a warp
// vote ran a cluster's eight triangle tests for all 32 lanes when one ray
// needed them (7 % of the lanes busy in the triangle loop on bounce rays, on
// an H100: `scripts/torch_bw_check.py`).  On a soup of a few clusters, where
// nearly every ray crosses every box, that sweep stays the cheaper one: eight
// lanes a ray repeat the ray's setup and each step's logic.
//
// What the design does about it (the design of tlas.cu's cluster walk,
// applied to the soup as one cluster range with no transform):
//
// (A) `bw_ctree` (ops/bw_intersect.py, `build_bw_ctree`, derived from
// `bw_clusters` alone): a header row [levels L, first row of level 1..7],
// then an implicit 8-ary tree of boxes over the clusters.  The walk
// (`walk_clusters`, cluster_walk.cuh) skips a subtree whose box the ray's
// window misses and changes no decision: the clusters entered are the dense
// sweep's, in its order, with the same running best (the argument is in
// cluster_walk.cuh).  A soup of at most 8 clusters has L = 0: its clusters
// are decided directly, as one group.
//
// (B) Eight lanes a ray (4 rays a warp, 16 a block of 128).  Lane k decides
// member k of a group of 8 siblings, one ballot decides them all up to the
// next entry, and lane k tests triangle k of an entered cluster; the winner
// is taken by shuffles (least t, ties to the larger k; any-hit: the lowest
// accepted k).  A warp runs the union of 4 walks, not 32.
//
// The slab and triangle tests are those of bw_tri_test.cuh; they follow
// `_tri_test` term by term.  Build with -fmad=false so the products are not
// contracted and the result equals the plain PyTorch version bit for bit.

#include <cuda_runtime.h>

#include "cluster_walk.cuh"

namespace {

using ignis::safe_inv;

constexpr int kWidth = ignis::kWalkWidth;   // lanes a ray
constexpr int kRowFloats = 16;              // floats a triangle row
constexpr int kIdLane = 13;                 // a row's original triangle id
constexpr int kThreads = 128;               // 16 rays a block

#ifdef BW_COUNT
// Diagnostic build only (`scripts/torch_bw_check.py` compiles a copy with
// -DBW_COUNT).  [0] rays, [1] node boxes decided, [2] cluster boxes decided,
// [3] clusters entered, [4] triangles tested (per ray, summed); per warp and
// loop (tree walk, triangle step): [5 + 2k] warp iterations, [6 + 2k] active
// lanes, summed; [9] the most steps one ray took.
__device__ unsigned long long bw_counts[10];

struct Count {
    unsigned long long c[9] = {};
    unsigned long long steps = 0;
    bool lead;   // the ray's lane 0 counts per-ray values

    __device__ void loop(int k) {
        steps += 1;
        const unsigned am = __activemask();
        if ((threadIdx.x & 31) == __ffs(am) - 1) {
            c[5 + 2 * k] += 1;
            c[6 + 2 * k] += __popc(am);
        }
    }
    __device__ void bump(int k, unsigned long long v) { c[k] += lead ? v : 0; }
    __device__ void walk_step() { loop(0); }
    __device__ void tri_step() {
        loop(1);
        bump(3, 1);
    }
    __device__ void nodes(unsigned v) { bump(1, v); }
    __device__ void clusters(unsigned v) { bump(2, v); }
    __device__ void tris(unsigned v) { bump(4, v); }
};
#else
using Count = ignis::NoCount;
#endif

template <bool ANY>
__global__ void __launch_bounds__(kThreads)
bw_kernel(const float* __restrict__ tris, const float* __restrict__ clusters, int nclusters,
          const float* __restrict__ ctree, const float* __restrict__ org,
          const float* __restrict__ dir, const float* __restrict__ tmin_p,
          const float* __restrict__ tmax_p, int n, int mask_bit, float* __restrict__ out_t,
          float* __restrict__ out_u, float* __restrict__ out_v, int* __restrict__ out_prim) {
    const int i = (blockIdx.x * blockDim.x + threadIdx.x) / kWidth;
    if (i >= n) return;                           // whole segments leave together
    const ignis::Segment sg = ignis::Segment::of_thread();

    const float ox = org[3 * i + 0], oy = org[3 * i + 1], oz = org[3 * i + 2];
    const float dx = dir[3 * i + 0], dy = dir[3 * i + 1], dz = dir[3 * i + 2];
    const float tmn = tmin_p[i];
    float bt = tmax_p[i];
    // lanes 0, 1, 2 take the reciprocals of x, y, z; the others share them
    const float ik = safe_inv(sg.sub == 0 ? dx : sg.sub == 1 ? dy : dz);
    const float ix = sg.from(ik, 0), iy = sg.from(ik, 1), iz = sg.from(ik, 2);
    float bu = 0.f, bv = 0.f;
    int bi = -1;

    Count cnt;
#ifdef BW_COUNT
    cnt.lead = sg.sub == 0;
    cnt.bump(0, 1);
#endif
    ignis::walk_clusters<ANY>(clusters, tris, 0, nclusters, ctree, __ldg(ctree + sg.sub), sg,
                              ox, oy, oz, dx, dy, dz, ix, iy, iz, tmn, mask_bit, bt, bu, bv,
                              bi, cnt);
#ifdef BW_COUNT
    for (int k = 0; k < 9; ++k)
        if (cnt.c[k]) atomicAdd(bw_counts + k, cnt.c[k]);
    atomicMax(bw_counts + 9, cnt.steps);
#endif
    if (sg.sub == 0) {
        out_t[i] = bt;
        out_u[i] = bu;
        out_v[i] = bv;
        out_prim[i] =
            bi >= 0 ? static_cast<int>(__ldg(tris + (size_t)bi * kRowFloats + kIdLane)) : -1;
    }
}

}  // namespace

#ifdef BW_COUNT
// Copies the counts to `out` on the host and sets them to 0.
extern "C" int ignis_bw_counts(unsigned long long* out) {
    cudaError_t err = cudaMemcpyFromSymbol(out, bw_counts, sizeof(bw_counts));
    if (err != cudaSuccess) return (int)err;
    const unsigned long long zero[10] = {};
    return (int)cudaMemcpyToSymbol(bw_counts, zero, sizeof(zero));
}
#endif

// Launches on `stream`, allocates nothing, does not synchronise.
// Returns cudaGetLastError() as an int (0 = launched).
extern "C" int ignis_bw_intersect(const void* tris, const void* clusters, int nclusters,
                                  const void* ctree, const void* org, const void* dir,
                                  const void* tmin, const void* tmax, int n, int mask_bit,
                                  int any_hit, void* out_t, void* out_u, void* out_v,
                                  void* out_prim, void* stream) {
    if (n <= 0) return 0;
    const long long threads = (long long)n * kWidth;
    const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto f = [](const void* p) { return static_cast<const float*>(p); };
    float* t = static_cast<float*>(out_t);
    float* u = static_cast<float*>(out_u);
    float* v = static_cast<float*>(out_v);
    int* prim = static_cast<int*>(out_prim);
    if (any_hit) {
        bw_kernel<true><<<blocks, kThreads, 0, s>>>(f(tris), f(clusters), nclusters, f(ctree),
                                                    f(org), f(dir), f(tmin), f(tmax), n,
                                                    mask_bit, t, u, v, prim);
    } else {
        bw_kernel<false><<<blocks, kThreads, 0, s>>>(f(tris), f(clusters), nclusters, f(ctree),
                                                     f(org), f(dir), f(tmin), f(tmax), n,
                                                     mask_bit, t, u, v, prim);
    }
    return static_cast<int>(cudaGetLastError());
}
