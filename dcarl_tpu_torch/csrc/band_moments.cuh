// Shared body of sorted_moments.cu and box_moments.cu: [Q, 3] box-query
// moments, one query per thread, rows staged in shared memory.
//
// For every query q:
//     out[q, :] = sum over rows r with valid_r != 0 and |q_d - k_rd| <= w_d
//                 for all d of (1, v_r, v_r^2)
// with the exact f32 per-dimension test of the JAX kernels.
//
// Layout.  A block owns QT queries, one per thread, its D coordinates and
// half-widths in registers.  It walks the rows in SUB_N-row sub-slices:
// the block stages a sub-slice's keys, values and valid flags in shared
// memory with coalesced loads, then every thread reads the same row at
// the same time (a broadcast), so the per-pair work is register
// arithmetic.  With kPrune, a sub-slice whose band extrema
// [kb_lo - w0, kb_hi + w0] cannot meet the block's query band
// [q_lo, q_hi] is skipped: the same f32 test as
// ops/store_kernels.py::sorted_prune_keep.
//
// Sums.  No atomics and no cross-block reduction: (count, sum, sum of
// squares) live in registers and are summed in row order, so the output
// is deterministic.  The count is f32 (exact to 2^24); the two sums are
// f64: on a lockstep trainer's store one query matches tens of thousands
// of near-identical rows, where a sequential f32 sum misses the oracle's
// rtol 1e-4 (measured on the H100).

#pragma once

#include <cuda_runtime.h>

namespace band_moments {

constexpr int QT = 128;     // queries per block, one per thread
constexpr int SUB_N = 256;  // rows per staged sub-slice
constexpr int MAX_D = 32;   // widest key

// Dynamic shared memory of one block: D x SUB_N keys, values, flags
// (at most (32 + 2) * 256 floats = 34 KB, within the static 48 KB).
inline size_t smem_bytes(int D) {
    return sizeof(float) * ((size_t)D * SUB_N + 2 * SUB_N);
}

template <bool kPrune>
__device__ __forceinline__ void moments_block(
    const float* __restrict__ q_t,    // [D, Q]
    const float* __restrict__ keys,   // [D, n_pad]
    const float* __restrict__ vals,   // [n_pad]
    const float* __restrict__ valid,  // [n_pad] 1 / 0
    const float* __restrict__ kb,     // [2, n_pad / SUB_N] (kPrune only)
    const float* __restrict__ qb,     // [2, gridDim.x] (kPrune only)
    const float* __restrict__ w,      // [D]
    const float* __restrict__ w0p,    // [1] (kPrune only)
    int Q, int n_pad, int D,
    float* __restrict__ out)          // [Q, 3]
{
    extern __shared__ float smem[];
    float* ks = smem;               // [D][SUB_N] staged keys
    float* vs = ks + D * SUB_N;     // [SUB_N] staged values
    float* ms = vs + SUB_N;         // [SUB_N] staged valid flags

    const int tid = threadIdx.x;
    const int tile = blockIdx.x;
    const int pos = tile * QT + tid;
    const bool live = pos < Q;

    // A dead thread's query is NaN: |NaN - k| <= w is false for every row.
    float q[MAX_D], wr[MAX_D];
#pragma unroll
    for (int d = 0; d < MAX_D; ++d) {
        q[d] = (live && d < D) ? q_t[(size_t)d * Q + pos]
                               : __int_as_float(0x7fc00000);
        wr[d] = d < D ? w[d] : 0.f;
    }

    const int n_sub = n_pad / SUB_N;
    float w0 = 0.f, q_lo = 0.f, q_hi = 0.f;
    if (kPrune) {
        w0 = *w0p;
        q_lo = qb[tile];
        q_hi = qb[gridDim.x + tile];
    }
    float cnt = 0.f;
    double sum = 0.0, sumsq = 0.0;

    for (int s = 0; s < n_sub; ++s) {
        // band-overlap prune (uniform across the block)
        if (kPrune && !(kb[s] - w0 <= q_hi && kb[n_sub + s] + w0 >= q_lo)) {
            continue;
        }
        const int base = s * SUB_N;
        __syncthreads();  // every thread is done with the last slice
        for (int i = tid; i < D * SUB_N; i += QT) {
            const int d = i / SUB_N, r = i - d * SUB_N;
            ks[i] = keys[(size_t)d * n_pad + base + r];
        }
        for (int r = tid; r < SUB_N; r += QT) {
            vs[r] = vals[base + r];
            ms[r] = valid[base + r];
        }
        __syncthreads();

        for (int r = 0; r < SUB_N; ++r) {
            if (ms[r] == 0.f) continue;  // same row on every thread: uniform
            bool ok = true;
#pragma unroll
            for (int d = 0; d < MAX_D; ++d) {
                if (d < D) ok &= fabsf(q[d] - ks[d * SUB_N + r]) <= wr[d];
            }
            if (ok) {
                const float v = vs[r];
                cnt += 1.f;
                sum += v;
                sumsq += (double)v * v;
            }
        }
    }
    if (live) {
        out[(size_t)pos * 3] = cnt;
        out[(size_t)pos * 3 + 1] = (float)sum;
        out[(size_t)pos * 3 + 2] = (float)sumsq;
    }
}

}  // namespace band_moments
