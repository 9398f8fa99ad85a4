// Brute-force box-query moments: the unpruned baseline of the store query.
//
// Replaces dcarl_tpu/ops/pallas_store.py::_kernel (launched by
// box_query_moments_pallas).
//
// What it computes.  Q D-dim queries (D <= 32, padded by the wrapper to
// a multiple of 128 with +inf, which matches nothing) against every one
// of N rows (padded to a multiple of 256 with valid = 0).  For every
// query q:
//     out[q, :] = sum over rows r with valid_r != 0 and |q_d - k_rd| <= w_d
//                 for all d of (1, v_r, v_r^2)
// with the exact f32 per-dimension test of the JAX kernel (sums kept in
// f64, returned as f32).
//
// What bounds it on the card.  Every (query, row) pair is tested: about
// two FP32 operations for each of the D dimensions, against (D + 2)
// floats a row read once per 128-query block.  So it is bound by FP32
// operations on the CUDA cores, at Q x N pairs: the baseline the pruned
// kernels (sorted_moments.cu, peraction_moments.cu) are measured
// against.
//
// What the design does about that.  The body of sorted_moments.cu
// (band_moments.cuh) without its prune: one query per thread with its
// coordinates in registers, each 256-row sub-slice staged in shared
// memory with coalesced loads and read as a broadcast, the count (f32)
// and the two sums (f64) in registers in row order (no atomics,
// deterministic).  The Pallas grid's sequential N axis becomes the loop
// inside the block.

#include "band_moments.cuh"

namespace {

using namespace band_moments;

__global__ void __launch_bounds__(QT) box_kernel(
    const float* __restrict__ q_t,    // [D, q_pad]
    const float* __restrict__ keys,   // [D, n_pad]
    const float* __restrict__ vals,   // [n_pad]
    const float* __restrict__ valid,  // [n_pad] 1 / 0
    const float* __restrict__ w,      // [D]
    int q_pad, int n_pad, int D,
    float* __restrict__ out)          // [q_pad, 3]
{
    moments_block<false>(q_t, keys, vals, valid, nullptr, nullptr, w,
                         nullptr, q_pad, n_pad, D, out);
}

}  // namespace

// C entry point.  Launches on ``stream`` without synchronising and
// returns cudaGetLastError() (0 = launched).  The caller checks shapes,
// types, contiguity and the device; q_pad must be a multiple of 128 and
// n_pad of 256.
extern "C" int box_moments(
    const void* q_t, const void* keys, const void* vals, const void* valid,
    const void* w, int q_pad, int n_pad, int D, void* out, void* stream)
{
    if (q_pad <= 0 || q_pad % QT != 0 || n_pad <= 0 || n_pad % SUB_N != 0
        || D < 1 || D > MAX_D) {
        return (int)cudaErrorInvalidValue;
    }
    box_kernel<<<q_pad / QT, QT, smem_bytes(D), (cudaStream_t)stream>>>(
        (const float*)q_t, (const float*)keys, (const float*)vals,
        (const float*)valid, (const float*)w, q_pad, n_pad, D, (float*)out);
    return (int)cudaGetLastError();
}
