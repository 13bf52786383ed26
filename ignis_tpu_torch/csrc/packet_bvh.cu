// 8-wide BVH traversal, closest-hit / any-hit, Moeller-Trumbore leaves.
//
// Replaces the Pallas TPU kernel of ignis_tpu/ops/pallas_bvh.py
// (`_traverse_kernel` -> `_traverse_packet` -> `_leaf_test`, entries
// `packet_bvh_closest` / `packet_bvh_any`).
//
// What it computes: each ray walks the 8-wide BVH that `build_packet_bvh`
// lays out as (R, 128) float32 rows (an inner row: 8 child boxes and child
// row ids; a leaf row: 8 triangle records v0, e1, e2, mask bits, original id)
// and returns the closest hit (t, u, v, original triangle id) or whether
// anything blocks the segment.  `_traverse_plain` (ops/packet_bvh.py) is the
// specification, bit for bit, visiting order included.
//
// What bounds it on this card: the latency of a ray's chain of dependent
// row reads.  A visit reads a row at an address the previous visit decided;
// neighbouring rays part after a few levels, so the reads are scattered over a
// table of some 40-60 MB that does not sit in the 50 MB L2 whole, and a
// visit's 25 operations a box or 54 a triangle are too few to hide them.  A
// launch of 65536 rays at one ray a thread was one resident wave, so it lasted
// as long as its slowest ray's chain.
//
// What the design does about it:
//
// (A) One dependent load a visit, and fewer bytes.  The kernel reads
// `pb_nodes` (`build_pb_nodes`), derived from `pb_rows` alone, every float
// bit-equal: an inner record is 8 entries of 32 bytes, [lo.xyz, hi.x] and
// [hi.yz, code, 0] in two runs of 8 float4, where the code of a child says
// whether it is an inner record (its offset) or a leaf (its offset and record
// count), so a popped code is enough to issue the visit's one load; a leaf
// record holds only the triangle records with non-zero mask bits (the others
// are never hit), 48 bytes each, as three runs of float4.  The old kernel read
// the row-type lane first and the boxes or triangles after it: two round
// trips a visit, 512-byte rows of which it used 224 or 352.
//
// (B) Nearest child first for closest-hit rays.  The passing children are
// pushed far to near, keyed by (near, slot), so the nearest is popped first
// and the best t shrinks early and prunes more.  Any-hit rays push in build
// order (popped last first), as before.  The plain version ranks the same
// keys, so the two visit the same rows in the same order.
//
// (C) Eight lanes a ray (4 rays a warp, 16 a block), as kernel 3.  An inner
// record: lane c tests child c from one coalesced read; the passing children
// are placed on the ray's stack in shared memory by a ballot and a rank
// (closest: the number of passing children popped after it, from the other
// lanes' near values by shuffles; any: the passing children of lower slot).
// A leaf: lane k tests record k against the best t at entry; the sequential
// `t <= best` sweep leaves the smallest accepted t at the HIGHEST record that
// reaches it, so the closest entry takes min t, ties to the larger k (three
// shuffle rounds); the any-hit entry takes the lowest accepted k and stops.
// A warp runs the union of 4 walks, not 32, and a launch is 8 threads a ray,
// so blocks of other rays fill an SM while a slow ray's block finishes.
//
// Arithmetic follows `_leaf_test` and the slab test of `_traverse_packet`
// term by term; zero tests and slab minima follow the reference's float rules
// (ref_float.cuh).  Build with -fmad=false so nothing is contracted.

#include <cuda_runtime.h>

#include "ref_float.cuh"

namespace {

using ignis::is_zero;
using ignis::nan_max;
using ignis::nan_min;
using ignis::safe_inv;

constexpr int kWidth = 8;          // children a record, records a leaf, lanes a ray
constexpr int kStack = 128;        // entries a ray; the wrapper checks 7*depth+1 <= kStack
constexpr int kThreads = 128;      // 16 rays a block
constexpr int kMissing = 0x7FFFFFFF;
constexpr int kPtrMask = 0x0FFFFFFF;

#ifdef PB_COUNT
// Diagnostic build only (`scripts/torch_pb_check.py` compiles a copy with
// -DPB_COUNT).  Summed over rays: [0] rays, [1] inner rows visited, [2] leaf
// rows visited, [3] boxes pushed, [4] triangles tested.  [5] the deepest
// stack and [6] the most rows one ray visited.  Per warp and loop (row
// visits, inner rows, leaf rows): [7 + 2k] warp iterations, [8 + 2k] active
// lanes summed over them; SIMT efficiency = lanes / (32 x iterations).
__device__ unsigned long long pb_counts[13];
#define PB_LOOP(k)                                                     \
    do {                                                               \
        const unsigned am_ = __activemask();                           \
        if ((threadIdx.x & 31) == __ffs(am_) - 1) {                    \
            cnt[7 + 2 * (k)] += 1;                                     \
            cnt[8 + 2 * (k)] += __popc(am_);                           \
        }                                                              \
    } while (0)
#define PB_BUMP(k, v) (cnt[k] += (sub == 0) ? (v) : 0)
#else
#define PB_LOOP(k) ((void)0)
#define PB_BUMP(k, v) ((void)0)
#endif

template <bool ANY>
__global__ void __launch_bounds__(kThreads)
pbvh_kernel(const float4* __restrict__ nodes, const float* __restrict__ org,
            const float* __restrict__ dir, const float* __restrict__ tmin_p,
            const float* __restrict__ tmax_p, int n, int mask_bit,
            float* __restrict__ out_t, float* __restrict__ out_u,
            float* __restrict__ out_v, int* __restrict__ out_prim) {
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
    const float tol = -1.1920928955078125e-07f;
    float bu = 0.f, bv = 0.f;
    int bi = -1;

#ifdef PB_COUNT
    unsigned long long cnt[13] = {sub == 0 ? 1ull : 0ull, 0, 0, 0, 0, 1,
                                  0, 0, 0, 0, 0, 0, 0};
#endif
    // the ray's stack of entry codes, shared by its lanes; the root is the
    // inner record at 0
    __shared__ int stacks[kThreads / kWidth][kStack];
    int* stack = stacks[threadIdx.x / kWidth];
    if (sub == 0) stack[0] = 0;
    __syncwarp(seg);
    int sp = 1;
    bool done = false;

    while (sp > 0 && !done) {
        PB_LOOP(0);
        const int code = stack[--sp];
        __syncwarp(seg);                          // read before a push overwrites it
        if (code >= 0) {
            // ---- inner record: lane `sub` tests child `sub`
            PB_LOOP(1);
            PB_BUMP(1, 1);
            const float4 a = __ldg(nodes + code + sub);           // lo.xyz hi.x
            const float4 b = __ldg(nodes + code + kWidth + sub);  // hi.yz code 0
            const int child = __float_as_int(b.z);
            const float t0x = (a.x - ox) * ix;
            const float t1x = (a.w - ox) * ix;
            const float t0y = (a.y - oy) * iy;
            const float t1y = (b.x - oy) * iy;
            const float t0z = (a.z - oz) * iz;
            const float t1z = (b.y - oz) * iz;
            const float near_ = nan_max(nan_max(nan_min(t0x, t1x), nan_min(t0y, t1y)),
                                        nan_max(nan_min(t0z, t1z), tmn));
            const float far_ = nan_min(nan_min(nan_max(t0x, t1x), nan_max(t0y, t1y)),
                                       nan_min(nan_max(t0z, t1z), bt));
            const bool pass = (near_ <= far_) && (child != kMissing);
            const unsigned push = bits(pass);
            if (push) {
                int rank;
                if (ANY) {
                    rank = __popc(push & ((1u << sub) - 1));   // build order
                } else {
                    // the passing children popped after this one: farther,
                    // or as near at a later slot (a passing near is no NaN)
                    rank = 0;
#pragma unroll
                    for (int j = 0; j < kWidth; ++j) {
                        const float nj = from(near_, j);
                        rank += ((push >> j) & 1u) &&
                                (nj > near_ || (nj == near_ && j > sub));
                    }
                }
                // the wrapper sized the walk to fit: a push is never
                // dropped, a stack that overflows all the same is a fault
                if (sp + __popc(push) > kStack) __trap();
                if (pass) stack[sp + rank] = child;
                sp += __popc(push);
                PB_BUMP(3, __popc(push));
                __syncwarp(seg);
            }
#ifdef PB_COUNT
            cnt[5] = max(cnt[5], (unsigned long long)sp);
#endif
        } else {
            // ---- leaf: lane `sub` tests record `sub` against the best t
            // at entry
            PB_LOOP(2);
            PB_BUMP(2, 1);
            const int cnt_k = ((code >> 28) & 7) + 1;
            PB_BUMP(4, cnt_k);
            const float4* rec = nodes + (code & kPtrMask);
            bool ok = false;
            float tt = 0.f, u = 0.f, v = 0.f, id = 0.f;
            if (sub < cnt_k) {
                const float4 a = __ldg(rec + sub);               // v0.xyz e1.x
                const float4 b = __ldg(rec + cnt_k + sub);       // e1.yz e2.xy
                const float4 c = __ldg(rec + 2 * cnt_k + sub);   // e2.z mask id 0
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
                const bool dzr = is_zero(det);
                const float inv_det = dzr ? 0.f : 1.0f / det;
                u = -(rx * e2x + ry * e2y + rz * e2z) * inv_det;
                v = (rx * e1x + ry * e1y + rz * e1z) * inv_det;
                const float w = 1.0f - u - v;
                tt = (cx * nx + cy * ny + cz * nz) * inv_det;
                id = c.z;
                ok = vis && !dzr && (u >= tol) && (v >= tol) && (w >= tol) &&
                     (tt >= tmn) && (tt <= bt);
            }
            const unsigned acc = bits(ok);
            if (acc) {
                int win;
                if (ANY || (acc & (acc - 1)) == 0) {
                    win = __ffs(acc) - 1;        // the first the sweep accepts
                } else {
                    // the last record that reaches the smallest t
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
                bi = static_cast<int>(from(id, win));
                bu = fmaxf(from(u, win), 0.f);
                bv = fmaxf(from(v, win), 0.f);
                done = ANY;
            }
        }
    }
#ifdef PB_COUNT
    if (sub == 0) {
        for (int k = 0; k < 5; ++k) atomicAdd(pb_counts + k, cnt[k]);
        atomicMax(pb_counts + 5, cnt[5]);
        atomicMax(pb_counts + 6, cnt[1] + cnt[2]);
    }
    for (int k = 7; k < 13; ++k)
        if (cnt[k]) atomicAdd(pb_counts + k, cnt[k]);
#endif
    if (sub == 0) {
        out_t[i] = bt;
        out_u[i] = bu;
        out_v[i] = bv;
        out_prim[i] = bi;
    }
}

}  // namespace

#ifdef PB_COUNT
// Copies the counts to `out` on the host and sets them to 0.
extern "C" int ignis_packet_bvh_counts(unsigned long long* out) {
    cudaError_t err = cudaMemcpyFromSymbol(out, pb_counts, sizeof(pb_counts));
    if (err != cudaSuccess) return (int)err;
    const unsigned long long zero[13] = {};
    return (int)cudaMemcpyToSymbol(pb_counts, zero, sizeof(zero));
}
#endif

// The largest per-ray stack the kernel was compiled with.
extern "C" int ignis_packet_bvh_stack_entries() { return kStack; }

// `nodes` is `pb_nodes` (float4 units, 16-byte aligned).
// Launches on `stream`, allocates nothing, does not synchronise.
// Returns cudaGetLastError() as an int (0 = launched).
extern "C" int ignis_packet_bvh(const void* nodes, const void* org, const void* dir,
                                const void* tmin, const void* tmax, int n, int mask_bit,
                                int any_hit, void* out_t, void* out_u, void* out_v,
                                void* out_prim, void* stream) {
    if (n <= 0) return 0;
    const long long threads = (long long)n * kWidth;
    const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto f = [](const void* p) { return static_cast<const float*>(p); };
    const float4* nd = static_cast<const float4*>(nodes);
    if (any_hit) {
        pbvh_kernel<true><<<blocks, kThreads, 0, s>>>(
            nd, f(org), f(dir), f(tmin), f(tmax), n, mask_bit, static_cast<float*>(out_t),
            static_cast<float*>(out_u), static_cast<float*>(out_v),
            static_cast<int*>(out_prim));
    } else {
        pbvh_kernel<false><<<blocks, kThreads, 0, s>>>(
            nd, f(org), f(dir), f(tmin), f(tmax), n, mask_bit, static_cast<float*>(out_t),
            static_cast<float*>(out_u), static_cast<float*>(out_v),
            static_cast<int*>(out_prim));
    }
    return static_cast<int>(cudaGetLastError());
}
