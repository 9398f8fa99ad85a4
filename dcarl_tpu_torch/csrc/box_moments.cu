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
// two FP32 operations for each of the D dimensions, against one record
// of round_up(D + 2, 4) floats a row.  So it is bound by FP32 operations
// on the CUDA cores, at Q x N pairs: the baseline the pruned kernels
// (sorted_moments.cu, peraction_moments.cu) are measured against.
//
// What the design does about that.  The body of sorted_moments.cu
// (band_moments.cuh) with every tile's window the whole row range (the
// wrapper's plan, store_kernels.brute_plan): chunks split over a
// persistent grid, sub-slices through the bulk-copy ring, f64 partials
// added in chunk order by a second pass (no atomics, deterministic).

#include "band_moments.cuh"

using namespace band_moments;

// C entry point: both passes on ``stream``, without synchronising;
// returns cudaGetLastError() (0 = launched) and writes the main pass's
// block count to the host int ``grid``.  The caller checks shapes, types,
// contiguity and the device; q_pad is a multiple of 128 and ``partial``
// holds ``off[n_qt]`` chunks of 3 x 128 doubles; ``counters`` is null
// (count nothing) or 2 int64 device totals (walked, matched).
extern "C" int box_moments(
    const void* q_t, const void* rows, const void* perm, const void* w,
    const void* s_lo, const void* s_hi, const void* off,
    int q_pad, int D, int n_qt, int C, void* partial, void* out,
    void* counters, void* stream, int* grid)
{
    if (q_pad <= 0 || q_pad % QT != 0 || n_qt != q_pad / QT || D < 1
        || D > MAX_D || C < 1) {
        return (int)cudaErrorInvalidValue;
    }
    return (int)run((const float*)q_t, (const float*)rows, (const int*)perm,
                    (const float*)w, (const int*)s_lo, (const int*)s_hi,
                    (const int*)off, q_pad, D, n_qt, C, (double*)partial,
                    out, false, (unsigned long long*)counters,
                    (cudaStream_t)stream, grid);
}
