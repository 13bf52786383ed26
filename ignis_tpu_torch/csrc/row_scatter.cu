// Row sums of a gathered table's gradient: the backward of
// `gather_rows(table, idx)` = table[idx] (ignis_tpu_torch/core/dgather.py)
// for a table that requires grad.
//
// Replaces no Pallas kernel.  Its counterpart in the JAX package is the custom
// VJP of ignis_tpu/core/dgather.py (`_bwd`, a one-hot matrix product), which
// exists there because XLA serialises colliding scatters on a TPU.
//
// What it computes: dtable[m, c] = the sum, over the lanes n with idx[n] == m
// (a negative idx taken + M, as the forward's indexing does; an index outside
// the table adds nothing), of g[n, c], in float32, where g is the (N, K)
// gradient of the gathered rows (K = the product of the table's trailing
// dimensions).  `gather_rows_backward_plain` (`index_add_`) is its plain
// version.
//
// Why it was added: PyTorch's backward of advanced indexing is
// `index_put_(accumulate=True)`.  On CUDA it sorts the indices, then for
// each run of equal indices one thread a column walks every duplicate in
// turn, twice (to count, then to sum).  A differentiable render gathers a
// handful of table rows for every lane, so a call took time in proportion to
// the largest row's lane count: on an H100, 1.37 s of a 1.49 s inverse
// rendering step (262,144 lanes x 6 bounces into 1 to 4 rows), 97 % of the
// device's time.
//
// What bounds it on this card: bytes.  Every lane's gradient row and its
// index are read once, N (4K + 8) bytes with int64 indices; M K floats are
// written and there is one add a gradient value.  At 262,144 lanes that is
// 14.7 MB for K = 12 (4.4 us at 3.35 TB/s) and 35.7 MB for K = 32.
//
// What the design does about it:
//
// 1. Lanes over the whole card, no walk over duplicates.  Along grid.x a
//    block takes a contiguous chunk of lanes (the wrapper sizes the chunks so
//    that the launch has several blocks for every SM).  Its threads form
//    `groups` = kThreads / K lane groups of K columns: thread (p, c) reads
//    column c of lanes chunk + p, + p + groups, ..., so each sweep reads
//    `groups` consecutive gradient rows, coalesced.  A thread loads kBatch
//    lanes' indices and values before it adds them, so the loads of a batch
//    are in flight together.
// 2. A fixed owner for every sum, no atomics.  The block's accumulator in
//    shared memory is acc[row][p * K + c]: thread (p, c) alone adds into
//    its column of each row, in lane order.  Threads of a warp that add into
//    one row touch consecutive words, so the adds meet no bank conflict
//    however the lanes' rows collide.  The lane groups are then summed in
//    group order into the block's partial row sums.
// 3. A second pass sums the blocks' partials in block order: 32 cells a
//    block of kReduceGroups x 32 threads, group q summing blocks q, q + 32,
//    ..., then the groups in order.  So two calls on the same inputs give
//    the same bits.  With one lane block the first pass writes dtable itself
//    and the second is not launched.
// 4. Tables larger than an accumulator.  The accumulator holds at most
//    kAccBytes; a taller table is cut into slabs of rows along grid.y, each
//    block of a slab reading every lane's index and the gradient of only
//    the lanes whose row lies in its slab, so the gradient is still read
//    once.  The cut follows the table's shape alone.  A row is at most
//    kThreads values (the parameter tables' rows are at most 32).

#include <cuda_runtime.h>

namespace {

// kThreads and kAccBytes are core/dgather.py's _THREADS and _ACC_BYTES
constexpr int kThreads = 256;         // threads of a first-pass block
constexpr int kAccBytes = 48 * 1024;  // its accumulator's most bytes
constexpr int kBatch = 8;             // lanes a thread loads before adding
constexpr int kReduceCells = 32;      // cells of a second-pass block
constexpr int kReduceGroups = 32;     // its groups of blocks summed apart

template <typename Index>
__global__ void __launch_bounds__(kThreads)
    row_partials(const float* __restrict__ g, const Index* __restrict__ idx, int n, int m,
                 int k, int lanes_per_block, int groups, int rows,
                 float* __restrict__ part) {
    extern __shared__ float acc[];  // [rows][groups * k]
    const int width = groups * k;
    const int j = threadIdx.x;
    const int p = j / k;
    const int c = j - p * k;
    const int r0 = blockIdx.y * rows;
    const int nrows = min(rows, m - r0);
    for (int i = j; i < nrows * width; i += blockDim.x) acc[i] = 0.0f;
    __syncthreads();
    const long long lo = (long long)blockIdx.x * lanes_per_block;
    const long long hi = min((long long)n, lo + lanes_per_block);
    if (p < groups) {
        float* mine = acc + j;
        const long long stride = (long long)groups * kBatch;
        for (long long base = lo + p; base < hi; base += stride) {
            int row[kBatch];
            float val[kBatch];
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
                const long long lane = base + (long long)u * groups;
                row[u] = -1;
                val[u] = 0.0f;
                if (lane < hi) {
                    long long r = (long long)idx[lane];
                    if (r < 0) r += m;
                    r -= r0;
                    if (r >= 0 && r < nrows) {
                        row[u] = (int)r;
                        val[u] = g[lane * k + c];
                    }
                }
            }
#pragma unroll
            for (int u = 0; u < kBatch; ++u)
                if (row[u] >= 0) mine[row[u] * width] += val[u];
        }
    }
    __syncthreads();
    float* out = part + (size_t)blockIdx.x * m * k;
    for (int q = j; q < nrows * k; q += blockDim.x) {
        const int r = q / k;
        const int cc = q - r * k;
        const float* src = acc + r * width + cc;
        float s = 0.0f;
        for (int pp = 0; pp < groups; ++pp) s += src[pp * k];
        out[(size_t)(r0 + r) * k + cc] = s;
    }
}

__global__ void __launch_bounds__(kReduceCells* kReduceGroups)
    row_reduce(const float* __restrict__ part, int blocks, long long cells,
               float* __restrict__ out) {
    __shared__ float sums[kReduceGroups][kReduceCells];
    const int c = threadIdx.x % kReduceCells;
    const int q = threadIdx.x / kReduceCells;
    const long long cell = (long long)blockIdx.x * kReduceCells + c;
    float s = 0.0f;
    if (cell < cells) {
#pragma unroll 4
        for (int b = q; b < blocks; b += kReduceGroups) s += part[(size_t)b * cells + cell];
    }
    sums[q][c] = s;
    __syncthreads();
    if (q == 0 && cell < cells) {
        float t = sums[0][c];
        for (int i = 1; i < kReduceGroups; ++i) t += sums[i][c];
        out[cell] = t;
    }
}

}  // namespace

// g: (n, k) float32, row-major; idx: n int32 (idx64 = 0) or int64 indices;
// out: (m, k) float32.  The plan (core/dgather.py `_plan`): `blocks` lane
// blocks of `lanes_per_block` lanes, `slabs` slabs of `rows` rows, `groups`
// lane groups of k threads a block.  `part` is scratch of the caller's,
// blocks * m * k floats, unused when blocks == 1.
// Launches on `stream`, allocates nothing, does not synchronise.
// Returns the first CUDA error as an int (0 = launched).
extern "C" int ignis_row_scatter(const void* g, const void* idx, int idx64, int n, int m,
                                 int k, int blocks, int lanes_per_block, int groups,
                                 int rows, int slabs, void* part, void* out,
                                 void* stream) {
    if (n <= 0 || m <= 0 || k <= 0 || blocks <= 0 || groups <= 0 || rows <= 0 ||
        groups * k > kThreads || (long long)rows * groups * k * sizeof(float) > kAccBytes ||
        (long long)slabs * rows < m || (long long)blocks * lanes_per_block < n ||
        slabs > 65535 || (blocks > 1 && part == nullptr))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* dst = static_cast<float*>(blocks == 1 ? out : part);
    const dim3 grid(blocks, slabs);
    const size_t smem = (size_t)rows * groups * k * sizeof(float);
    const float* gf = static_cast<const float*>(g);
    if (idx64)
        row_partials<long long><<<grid, kThreads, smem, s>>>(
            gf, static_cast<const long long*>(idx), n, m, k, lanes_per_block, groups, rows,
            dst);
    else
        row_partials<int><<<grid, kThreads, smem, s>>>(gf, static_cast<const int*>(idx), n,
                                                       m, k, lanes_per_block, groups, rows,
                                                       dst);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || blocks == 1) return (int)err;
    const long long cells = (long long)m * k;
    row_reduce<<<(unsigned)((cells + kReduceCells - 1) / kReduceCells),
                 kReduceCells * kReduceGroups, 0, s>>>(static_cast<const float*>(part),
                                                       blocks, cells,
                                                       static_cast<float*>(out));
    return (int)cudaGetLastError();
}
