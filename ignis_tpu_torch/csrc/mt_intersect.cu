// Moeller-Trumbore closest-hit / any-hit over a whole triangle soup, with no
// acceleration structure.
//
// Replaces the Pallas TPU kernels of ignis_tpu/ops/pallas_intersect.py
// (`_closest_kernel` / `_any_kernel` -> `_mt_loop`, entries
// `pallas_intersect_closest` / `pallas_intersect_any`).
//
// What it computes: every ray is tested against every triangle (v0, e1, e2
// and an optional per-triangle visibility flag) in ascending triangle order
// with
//
//   n = e1 x e2, c = v0 - o, r = d x c, det = n.d, inv = 1/det
//   u = U' inv, v = V' inv, w = 1 - u - v, t = (c.n) inv,
//   U' = -(r.e2), V' = r.e1
//
// and a hit is accepted when det != 0, u, v, w >= -2^-23, tmin <= t <= best
// and the flag is set.  The closest accepted hit wins, and among equal t the
// highest triangle index (the accept test is t <= best).
//
// What bounds it on this card: operations.  A ray moves 32 bytes in and 16
// out and a triangle 37 bytes, but every pair of them needs 27 float32
// operations (c, r, det, U', V') before it can be ruled out, and the whole
// test as written above is 54, so from a few dozen triangles on the
// arithmetic outweighs the bytes by orders of magnitude.  Tensor cores are no help: the products are
// three-term float32 dot products whose un-fused rounding defines the
// result, and `wgmma` takes tf32 / bf16 / fp16 inputs only.  Built with
// -fmad=false (nothing is contracted, so the result equals the plain
// PyTorch version bit for bit), the card starts one float32 operation per
// lane and clock, half of what its data sheet counts.  The only way down is
// fewer instructions a pair.
//
// What the design does about it:
//
// 1. Exact early rejection before the division.  Under 0.1 % of the pairs
//    are hits, so the common path stops after c, r, det, U', V' (27
//    operations) and a test that proves the pair would fail u, v, w >= tol
//    (see "The rejection" below).  Only when some lane of the warp holds a
//    pair that is not rejected (`__any_sync`) does the warp run the full
//    sequence, for those lanes, unchanged.  The division, t, u, v, w and the
//    seven compares leave the common path.
// 2. Per-triangle work once.  While a 128-triangle tile is staged, each
//    thread computes n = e1 x e2 for one triangle (same expression, same
//    bits) and writes four float4 rows (v0 | flag, e1, e2, n); a test reads
//    them as four 16-byte shared-memory broadcasts.  The next tile's
//    triangles are fetched into registers before the current tile's
//    arithmetic and written to the other buffer after it: one barrier a
//    tile, and the loads fly under the arithmetic.  (A `cp.async` copy
//    cannot lay out rows that hold a computed n; a packing pre-pass would be
//    one more launch and a scratch table for the same overlap.)
// 3. Four rays a thread, so a shared-memory row serves four tests and four
//    independent chains hide the latency.
// 4. The soup is split into ranges of whole tiles along `grid.y`, chosen at
//    the launch from the ray count so that there are kBlocksPerSm blocks for
//    each SM, also at a few thousand rays.  Each block sweeps its range
//    from best = tmax and keeps (t, index) only.  Ranges combine through a
//    64-bit atomicMin on a per-ray key
//        (order-preserving bits of t) << 32 | (0xFFFFFFFF - index),
//    which is exactly "smallest t, highest index among equal t", what the
//    sequential sweep leaves.  -0.0 takes +0.0's key (they are equal to
//    `t <= best`); an accepted t is never NaN, so the all-ones key that the
//    launch writes first means "miss".  A finalize kernel decodes the
//    winner and recomputes its t, u, v with the same operations.
// 5. Any-hit runs the same loop; a hit is seen only on the rare full path
//    and sets a per-ray byte in device memory, which is the result.  At tile
//    boundaries a block drops rays whose byte is set (by itself or by
//    another range) and leaves when none is left.
//
// The rejection.  With s = sign bit of det, a = |det|, Us = U' xor s,
// Vs = V' xor s (so u and Us have one sign, as inv has det's), a pair is
// rejected when
//
//     Us < -(2^-20 a)  or  Vs < -(2^-20 a)  or  Us + Vs > (1 + 2^-16) a,
//
// every operation in float32, round to nearest, denormals kept (nvcc's
// default and PyTorch's).  Every compare is false on a NaN operand, so NaN
// is never rejected.  Proof that a rejected pair fails the accept test:
//  * det = 0: not accepted whatever u, v, w.  det = +-inf: a is inf and no
//    compare holds.  |det| < 2^-128: inv is inf, u and v are +-inf or NaN
//    and u, v, w >= tol fails.  So let inv be finite and non-zero: then
//    inv = (1/det)(1 + e), |e| <= 2^-22 (2^-24 unless inv is denormal).
//  * Us < -fl(2^-20 a): U' is non-zero and opposes det in sign, and
//    |U'| / a > 0.75 * 2^-20 (the scaling by 2^-20 is exact unless the
//    product is denormal, where it errs by at most a quarter for
//    a >= 2^-128).  u = fl(U' inv) is negative with |u| > 2^-21 (or -inf),
//    below tol = -2^-23.  Likewise v.
//  * Neither of those, and fl(Us + Vs) > fl((1 + 2^-16) a): then
//    u, v >= -2^-19 and the real (Us + Vs) / a > 1 + 2^-17; with the
//    relative errors of inv and of the two products (2^-21 together)
//    u + v > 1 + 2^-18 in real numbers.  x = fl(1 - u) errs by at most
//    2^-24 (1 + |u|) and |u| <= u + v + 2^-19, so x - v < -2^-19 and
//    w = fl(x - v) < -2^-20 < tol.  u = +inf gives w = -inf.
// Magnitudes and signs are compared, never a product U' det, so huge and
// tiny coordinates neither overflow into a wrong rejection nor underflow
// out of a right one.
//
// Build with -fmad=false.  No operation is reassociated or contracted, and
// 1.0f / det is the correctly rounded IEEE quotient, so t, u, v of the
// accepted hit are the plain version's bits wherever they are computed.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 128;    // triangles per shared-memory tile, one a thread
constexpr int kRays = 4;      // rays per thread
constexpr int kBlocksPerSm = 16;  // blocks a launch should have for each SM

constexpr float kTol = -1.1920928955078125e-07f;   // -2^-23
constexpr float kRejUV = 9.5367431640625e-07f;     // 2^-20
constexpr float kRejW = 1.0000152587890625f;       // 1 + 2^-16

struct Tuv {
    float t, u, v, w, det;
};

__device__ __forceinline__ float3 mt_normal(float e1x, float e1y, float e1z,
                                            float e2x, float e2y, float e2z) {
    return make_float3(e1y * e2z - e1z * e2y, e1z * e2x - e1x * e2z,
                       e1x * e2y - e1y * e2x);
}

// true: the pair provably fails u, v, w >= tol (see the header)
__device__ __forceinline__ bool mt_reject(float det, float up, float vp) {
    const unsigned s = __float_as_uint(det) & 0x80000000u;
    const float us = __uint_as_float(__float_as_uint(up) ^ s);
    const float vs = __uint_as_float(__float_as_uint(vp) ^ s);
    const float a = fabsf(det);
    const float m = -(a * kRejUV);
    return (us < m) | (vs < m) | (us + vs > a * kRejW);
}

// the whole test of one pair, term by term as `_mt_loop` has it
__device__ __forceinline__ Tuv mt_full(float v0x, float v0y, float v0z, float e1x,
                                       float e1y, float e1z, float e2x, float e2y,
                                       float e2z, float nx, float ny, float nz,
                                       float ox, float oy, float oz, float dx,
                                       float dy, float dz) {
    const float cx = v0x - ox, cy = v0y - oy, cz = v0z - oz;
    const float rx = dy * cz - dz * cy;
    const float ry = dz * cx - dx * cz;
    const float rz = dx * cy - dy * cx;
    Tuv h;
    h.det = nx * dx + ny * dy + nz * dz;
    const float inv_det = (h.det == 0.f) ? 0.f : 1.0f / h.det;
    h.u = -(rx * e2x + ry * e2y + rz * e2z) * inv_det;
    h.v = (rx * e1x + ry * e1y + rz * e1z) * inv_det;
    h.w = 1.0f - h.u - h.v;
    h.t = (cx * nx + cy * ny + cz * nz) * inv_det;
    return h;
}

// one triangle as it lies in device memory, and its flag as a float
__device__ __forceinline__ void mt_fetch(const float* __restrict__ v0,
                                         const float* __restrict__ e1,
                                         const float* __restrict__ e2,
                                         const unsigned char* __restrict__ tri_mask,
                                         int j, int tri_hi, float (&p)[9], float& flag) {
    if (j >= tri_hi) return;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
        p[q] = v0[(size_t)j * 3 + q];
        p[3 + q] = e1[(size_t)j * 3 + q];
        p[6 + q] = e2[(size_t)j * 3 + q];
    }
    flag = (tri_mask && tri_mask[j] == 0) ? 0.f : 1.f;
}

// smaller key = smaller t, and among equal t the higher index
__device__ __forceinline__ unsigned long long mt_key(float t, int idx) {
    unsigned b = (t == 0.f) ? 0u : __float_as_uint(t);
    b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
    return ((unsigned long long)b << 32) | (0xFFFFFFFFu - (unsigned)idx);
}

#ifdef MT_COUNT
// Diagnostic build only (`scripts/torch_mt_check.py` compiles a copy with
// -DMT_COUNT): pairs not rejected, warp entries into the full path,
// warp-triangle iterations.
__device__ unsigned long long mt_counts[3];
#endif

// ANY: `hit` gets a 1 per occluded ray; else `keys` the atomicMin of the
// block's best (t, index) per ray.
template <bool ANY>
__global__ void __launch_bounds__(kThreads)
mt_sweep(const float* __restrict__ v0, const float* __restrict__ e1,
         const float* __restrict__ e2, const unsigned char* __restrict__ tri_mask,
         int ntris, int tiles_per_range, const float* __restrict__ org,
         const float* __restrict__ dir, const float* __restrict__ tmin_p,
         const float* __restrict__ tmax_p, int n, unsigned long long* keys,
         unsigned char* hit) {
    __shared__ float4 s_tri[2][kTile][4];

    const int ray0 = blockIdx.x * (kThreads * kRays) + threadIdx.x;
    float ox[kRays], oy[kRays], oz[kRays], dx[kRays], dy[kRays], dz[kRays];
    float tmn[kRays], bt[kRays];
    int bi[kRays];
    unsigned active = 0;     // bit r: ray r can still be hit
#pragma unroll
    for (int r = 0; r < kRays; ++r) {
        const int i = ray0 + r * kThreads;
        ox[r] = oy[r] = oz[r] = dx[r] = dy[r] = 0.f;
        dz[r] = 1.f;
        tmn[r] = 0.f;
        bt[r] = -1.f;
        bi[r] = -1;
        if (i < n) {
            ox[r] = org[3 * i + 0]; oy[r] = org[3 * i + 1]; oz[r] = org[3 * i + 2];
            dx[r] = dir[3 * i + 0]; dy[r] = dir[3 * i + 1]; dz[r] = dir[3 * i + 2];
            tmn[r] = tmin_p[i];
            bt[r] = tmax_p[i];
            // an empty or NaN interval accepts nothing
            if (tmn[r] <= bt[r]) active |= 1u << r;
        }
    }

    const int tri_lo = blockIdx.y * tiles_per_range * kTile;
    const int tri_hi = min(ntris, tri_lo + tiles_per_range * kTile);
#ifdef MT_COUNT
    unsigned long long c_pairs = 0, c_entries = 0, c_iters = 0;
#endif

    // this thread's triangle of the next tile, raw
    float p[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float flag = 1.f;
    auto fetch = [&](int j) { mt_fetch(v0, e1, e2, tri_mask, j, tri_hi, p, flag); };
    fetch(tri_lo + threadIdx.x);

    int buf = 0;
    for (int t0 = tri_lo; t0 < tri_hi; t0 += kTile, buf ^= 1) {
        {
            const float3 nn = mt_normal(p[3], p[4], p[5], p[6], p[7], p[8]);
            float4* row = s_tri[buf][threadIdx.x];
            row[0] = make_float4(p[0], p[1], p[2], flag);
            row[1] = make_float4(p[3], p[4], p[5], 0.f);
            row[2] = make_float4(p[6], p[7], p[8], 0.f);
            row[3] = make_float4(nn.x, nn.y, nn.z, 0.f);
        }
        if (ANY) {
            // hits other ranges found for my rays
#pragma unroll
            for (int r = 0; r < kRays; ++r)
                if ((active >> r & 1u) &&
                    *(volatile unsigned char*)(hit + ray0 + r * kThreads))
                    active &= ~(1u << r);
        }
        // the one barrier of the tile; no ray of the block left: done
        if (__syncthreads_and(active == 0)) break;
        fetch(t0 + kTile + threadIdx.x);
        const int nt = min(kTile, tri_hi - t0);

#pragma unroll 2
        for (int k = 0; k < nt; ++k) {
            const float4 A = s_tri[buf][k][0], B = s_tri[buf][k][1];
            const float4 C = s_tri[buf][k][2], N = s_tri[buf][k][3];
            unsigned need = 0;
#pragma unroll
            for (int r = 0; r < kRays; ++r) {
                const float cx = A.x - ox[r], cy = A.y - oy[r], cz = A.z - oz[r];
                const float rx = dy[r] * cz - dz[r] * cy;
                const float ry = dz[r] * cx - dx[r] * cz;
                const float rz = dx[r] * cy - dy[r] * cx;
                const float det = N.x * dx[r] + N.y * dy[r] + N.z * dz[r];
                const float up = -(rx * C.x + ry * C.y + rz * C.z);
                const float vp = rx * B.x + ry * B.y + rz * B.z;
                if (!mt_reject(det, up, vp)) need |= 1u << r;
            }
            need &= active;
            const bool enter = __any_sync(0xffffffffu, need != 0);
#ifdef MT_COUNT
            c_pairs += __popc(need);
            c_entries += enter ? 1 : 0;
            c_iters += 1;
#endif
            if (enter) {
#pragma unroll
                for (int r = 0; r < kRays; ++r) {
                    if (need >> r & 1u) {
                        const Tuv h = mt_full(A.x, A.y, A.z, B.x, B.y, B.z, C.x, C.y,
                                              C.z, N.x, N.y, N.z, ox[r], oy[r], oz[r],
                                              dx[r], dy[r], dz[r]);
                        const bool ok = (h.det != 0.f) && (h.u >= kTol) &&
                                        (h.v >= kTol) && (h.w >= kTol) &&
                                        (h.t >= tmn[r]) && (h.t <= bt[r]) &&
                                        (A.w != 0.f);
                        if (ok) {
                            if (ANY) {
                                hit[ray0 + r * kThreads] = 1;
                                active &= ~(1u << r);
                            } else {
                                bt[r] = h.t;
                                bi[r] = t0 + k;
                            }
                        }
                    }
                }
            }
        }
    }
    if (!ANY) {
#pragma unroll
        for (int r = 0; r < kRays; ++r)
            if (bi[r] >= 0)
                atomicMin(keys + ray0 + r * kThreads, mt_key(bt[r], bi[r]));
    }
#ifdef MT_COUNT
    atomicAdd(mt_counts + 0, c_pairs);
    if ((threadIdx.x & 31) == 0) {
        atomicAdd(mt_counts + 1, c_entries);
        atomicAdd(mt_counts + 2, c_iters);
    }
#endif
}

// decode each ray's winning key and recompute its hit
__global__ void __launch_bounds__(256)
mt_finalize(const float* __restrict__ v0, const float* __restrict__ e1,
            const float* __restrict__ e2, const float* __restrict__ org,
            const float* __restrict__ dir, const float* __restrict__ tmax_p, int n,
            const unsigned long long* __restrict__ keys, float* __restrict__ out_t,
            float* __restrict__ out_u, float* __restrict__ out_v,
            int* __restrict__ out_prim) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const unsigned long long key = keys[i];
    if (key == ~0ull) {
        out_t[i] = tmax_p[i];
        out_u[i] = 0.f;
        out_v[i] = 0.f;
        out_prim[i] = -1;
        return;
    }
    const size_t j = 0xFFFFFFFFu - (unsigned)(key & 0xFFFFFFFFull);
    const float e1x = e1[j * 3], e1y = e1[j * 3 + 1], e1z = e1[j * 3 + 2];
    const float e2x = e2[j * 3], e2y = e2[j * 3 + 1], e2z = e2[j * 3 + 2];
    const float3 nn = mt_normal(e1x, e1y, e1z, e2x, e2y, e2z);
    const Tuv h = mt_full(v0[j * 3], v0[j * 3 + 1], v0[j * 3 + 2], e1x, e1y, e1z, e2x,
                          e2y, e2z, nn.x, nn.y, nn.z, org[3 * i], org[3 * i + 1],
                          org[3 * i + 2], dir[3 * i], dir[3 * i + 1], dir[3 * i + 2]);
    out_t[i] = h.t;
    out_u[i] = fmaxf(h.u, 0.f);
    out_v[i] = fmaxf(h.v, 0.f);
    out_prim[i] = (int)j;
}

}  // namespace

#ifdef MT_COUNT
// Copies the three counts to `out` on the host and sets them to 0.
extern "C" int ignis_mt_counts(unsigned long long* out) {
    cudaError_t err = cudaMemcpyFromSymbol(out, mt_counts, sizeof(mt_counts));
    if (err != cudaSuccess) return (int)err;
    const unsigned long long zero[3] = {0, 0, 0};
    return (int)cudaMemcpyToSymbol(mt_counts, zero, sizeof(zero));
}
#endif

// `tri_mask` is one byte per triangle (0 = invisible) or null for none.
// `work` is scratch of the caller's: n 64-bit keys for the closest hit; for
// any-hit n bytes, which are the result (1 = occluded) and the out_* are not
// touched.  Needs n > 0 and ntris > 0.  Each block along grid.y takes a range
// of whole tiles: as few ranges as give the launch kBlocksPerSm blocks for
// each SM of the current device.
// Launches on `stream`, allocates nothing, does not synchronise.
// Returns the first CUDA error as an int (0 = launched).
extern "C" int ignis_mt_intersect(const void* v0, const void* e1, const void* e2,
                                  const void* tri_mask, int ntris, const void* org,
                                  const void* dir, const void* tmin, const void* tmax, int n,
                                  int any_hit, void* work, void* out_t, void* out_u,
                                  void* out_v, void* out_prim, void* stream) {
    if (n <= 0 || ntris <= 0) return (int)cudaErrorInvalidValue;
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    const int rays = kThreads * kRays;
    const int ray_blocks = (n + rays - 1) / rays;
    const int tiles = (ntris + kTile - 1) / kTile;
    const int ranges =
        min(tiles, max(1, (kBlocksPerSm * sms + ray_blocks - 1) / ray_blocks));
    const int tiles_per_range = (tiles + ranges - 1) / ranges;
    const dim3 grid(ray_blocks, (tiles + tiles_per_range - 1) / tiles_per_range);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto f = [](const void* p) { return static_cast<const float*>(p); };
    const unsigned char* m = static_cast<const unsigned char*>(tri_mask);
    if (any_hit) {
        unsigned char* hit = static_cast<unsigned char*>(work);
        err = cudaMemsetAsync(hit, 0, (size_t)n, s);
        if (err != cudaSuccess) return (int)err;
        mt_sweep<true><<<grid, kThreads, 0, s>>>(
            f(v0), f(e1), f(e2), m, ntris, tiles_per_range, f(org), f(dir), f(tmin),
            f(tmax), n, nullptr, hit);
        return (int)cudaGetLastError();
    }
    unsigned long long* keys = static_cast<unsigned long long*>(work);
    err = cudaMemsetAsync(keys, 0xFF, (size_t)n * sizeof(unsigned long long), s);
    if (err != cudaSuccess) return (int)err;
    mt_sweep<false><<<grid, kThreads, 0, s>>>(
        f(v0), f(e1), f(e2), m, ntris, tiles_per_range, f(org), f(dir), f(tmin),
        f(tmax), n, keys, nullptr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    mt_finalize<<<(n + 255) / 256, 256, 0, s>>>(
        f(v0), f(e1), f(e2), f(org), f(dir), f(tmax), n, keys,
        static_cast<float*>(out_t), static_cast<float*>(out_u),
        static_cast<float*>(out_v), static_cast<int*>(out_prim));
    return (int)cudaGetLastError();
}
