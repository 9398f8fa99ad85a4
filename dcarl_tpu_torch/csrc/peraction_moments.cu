// Per-action box-query moments: the gated deployment driver's store query.
//
// Replaces dcarl_tpu/ops/pallas_store.py::_peraction_kernel.
//
// What it computes.  B observation queries q (20-D) against a prepared,
// deduplicated store (ops/store_kernels.py::prepare_peraction_store).
// Row r carries its 20 obs keys k_r, its action a_r (-1 when the row can
// add to no action: invalid, collapsed duplicate, off-lattice or out of
// range) and its aggregated moments (count, sum v, sum v^2).  For every
// query and every action a:
//     out[q, a, :] = sum over rows r with a_r == a and |q_d - k_rd| <= w_d
//                    for all d of (count_r, sum_r, sumsq_r)
// in full FP32, with the exact per-dimension test of the JAX kernel.
//
// What bounds it on the card.  The prepared store is read from device
// memory once per query tile that survives the prune, and its bytes
// (24 floats a row) are few next to the containment tests: about two
// FP32 operations (subtract, compare with |.|) for each of the 20
// dimensions of each (query, row) pair that the prune keeps.  So it is
// bound by FP32 operations on the CUDA cores, at the pair count the
// prune leaves.
//
// What the design does about that.
//  * Pruning first.  Queries are sorted (by the wrapper) into the same
//    band-cell / second-dim order as the rows, and every 128-query tile
//    carries the extrema of both dims (qext).  A block skips a 2048-row
//    tile whose band extrema (kbt) cannot overlap its own, and then a
//    256-row sub-slice whose band and second-dim rectangle (kb, kb2)
//    cannot; the pairs it skips are provably matchless.
//  * One query per thread, its 20 coordinates and half-widths in
//    registers.  The block stages each surviving sub-slice's keys,
//    actions and moments in shared memory with coalesced loads; every
//    thread then reads the same row at the same time (a broadcast, no
//    bank conflicts), so the per-pair work is register arithmetic.
//  * No atomics and no cross-block reduction: the Pallas grid's
//    sequential N axis (a VMEM accumulator) becomes a loop inside the
//    block, and each query's 3A accumulators live in shared memory laid
//    out [3A][128] (thread-contiguous, conflict-free).  A query's sums
//    are taken in row order, so results are deterministic run to run.
//  * The TPU kernel's bf16 distance prefilter is left out: it changes
//    no result, and it existed to skip a slow VPU chain on the TPU.
//    It is still to be ported (ROADMAP.md), as is any tensor-core use.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int OBS = 20;          // observation dims of a key
constexpr int QT = 128;          // queries per block, one per thread
constexpr int SUB_N = 256;       // rows per staged sub-slice
constexpr int MAX_ACTIONS = 16;  // keeps shared memory within 48 KB

__global__ void __launch_bounds__(QT) peraction_kernel(
    const float* __restrict__ queries,   // [B, OBS] (caller order)
    const int64_t* __restrict__ qorder,  // [B] sorted position -> query row
    const float* __restrict__ qext,      // [4, n_qt] band lo/hi, dim2 lo/hi
    const float* __restrict__ keys,      // [OBS, n_pad]
    const int* __restrict__ row_act,     // [n_pad]
    const float* __restrict__ row_mom,   // [3, n_pad]
    const float* __restrict__ kb,        // [2, n_pad / SUB_N]
    const float* __restrict__ kb2,       // [2, n_pad / SUB_N]
    const float* __restrict__ kbt,       // [2, n_pad / n_tile]
    const float* __restrict__ w,         // [OBS]
    const float* __restrict__ w0p,       // [1] band half-width
    const float* __restrict__ w2p,       // [1] second-dim half-width
    int B, int n_pad, int n_tile, int num_actions,
    float* __restrict__ out)             // [B, 3 * num_actions]
{
    extern __shared__ float smem[];
    float* ks = smem;                      // [OBS][SUB_N] staged keys
    float* ms = ks + OBS * SUB_N;          // [3][SUB_N] staged moments
    int* as = reinterpret_cast<int*>(ms + 3 * SUB_N);  // [SUB_N] actions
    float* acc = reinterpret_cast<float*>(as + SUB_N);  // [3A][QT]

    const int tid = threadIdx.x;
    const int tile = blockIdx.x;
    const int n_qt = gridDim.x;
    const int pos = tile * QT + tid;
    const bool live = pos < B;
    const int64_t qrow = live ? qorder[pos] : 0;

    // A dead thread's query is NaN: |NaN - k| <= w is false for every row.
    float q[OBS], wr[OBS];
#pragma unroll
    for (int d = 0; d < OBS; ++d) {
        q[d] = live ? queries[qrow * OBS + d] : __int_as_float(0x7fc00000);
        wr[d] = w[d];
    }
    const int n_feat = 3 * num_actions;
    for (int f = 0; f < n_feat; ++f) acc[f * QT + tid] = 0.f;

    const float w0 = *w0p, w2 = *w2p;
    const float q_lo = qext[tile], q_hi = qext[n_qt + tile];
    const float q2_lo = qext[2 * n_qt + tile], q2_hi = qext[3 * n_qt + tile];
    const int n_sub = n_pad / SUB_N;
    const int n_tiles = n_pad / n_tile;
    const int per_tile = n_tile / SUB_N;

    for (int t = 0; t < n_tiles; ++t) {
        // tile early-out on band extrema (uniform across the block)
        if (!(kbt[t] - w0 <= q_hi && kbt[n_tiles + t] + w0 >= q_lo)) continue;
        for (int s = t * per_tile; s < (t + 1) * per_tile; ++s) {
            // sub-slice rectangle prune on band and second dim
            if (!(kb[s] - w0 <= q_hi && kb[n_sub + s] + w0 >= q_lo
                  && kb2[s] - w2 <= q2_hi && kb2[n_sub + s] + w2 >= q2_lo)) {
                continue;
            }
            const int base = s * SUB_N;
            __syncthreads();  // every thread is done with the last slice
            for (int i = tid; i < OBS * SUB_N; i += QT) {
                const int d = i / SUB_N, r = i - d * SUB_N;
                ks[i] = keys[(size_t)d * n_pad + base + r];
            }
            for (int i = tid; i < 3 * SUB_N; i += QT) {
                const int m = i / SUB_N, r = i - m * SUB_N;
                ms[i] = row_mom[(size_t)m * n_pad + base + r];
            }
            for (int r = tid; r < SUB_N; r += QT) as[r] = row_act[base + r];
            __syncthreads();

            for (int r = 0; r < SUB_N; ++r) {
                const int a = as[r];
                if (a < 0) continue;  // same row on every thread: uniform
                bool ok = true;
#pragma unroll
                for (int d = 0; d < OBS; ++d) {
                    ok &= fabsf(q[d] - ks[d * SUB_N + r]) <= wr[d];
                }
                if (ok) {
                    float* c = acc + 3 * a * QT + tid;
                    c[0] += ms[r];
                    c[QT] += ms[SUB_N + r];
                    c[2 * QT] += ms[2 * SUB_N + r];
                }
            }
        }
    }
    if (live) {
        float* o = out + qrow * n_feat;
        for (int f = 0; f < n_feat; ++f) o[f] = acc[f * QT + tid];
    }
}

}  // namespace

// C entry point.  Launches on ``stream`` without synchronising and
// returns cudaGetLastError() (0 = launched).  The caller checks shapes,
// types, contiguity and the device; n_pad must be a multiple of n_tile
// and n_tile a multiple of 256.
extern "C" int peraction_moments(
    const void* queries, const void* qorder, const void* qext,
    const void* keys, const void* row_act, const void* row_mom,
    const void* kb, const void* kb2, const void* kbt, const void* w,
    const void* w0, const void* w2,
    int B, int n_pad, int n_tile, int num_actions,
    void* out, void* stream)
{
    if (B <= 0 || num_actions < 1 || num_actions > MAX_ACTIONS
        || n_tile % SUB_N != 0 || n_pad % n_tile != 0) {
        return (int)cudaErrorInvalidValue;
    }
    const size_t smem = sizeof(float)
        * ((size_t)OBS * SUB_N + 3 * SUB_N + SUB_N
           + (size_t)3 * num_actions * QT);
    cudaError_t err = cudaFuncSetAttribute(
        peraction_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int n_qt = (B + QT - 1) / QT;
    peraction_kernel<<<n_qt, QT, smem, (cudaStream_t)stream>>>(
        (const float*)queries, (const int64_t*)qorder, (const float*)qext,
        (const float*)keys, (const int*)row_act, (const float*)row_mom,
        (const float*)kb, (const float*)kb2, (const float*)kbt,
        (const float*)w, (const float*)w0, (const float*)w2,
        B, n_pad, n_tile, num_actions, (float*)out);
    return (int)cudaGetLastError();
}
