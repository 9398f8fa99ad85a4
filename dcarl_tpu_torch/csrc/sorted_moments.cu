// Sorted-band box-query moments: the trainer's rule-column store query.
//
// Replaces dcarl_tpu/ops/pallas_store.py::_sorted_kernel (launched by
// _launch_sorted, behind box_query_moments_sorted and
// box_query_moments_grouped).
//
// What it computes.  Q D-dim queries (D <= 32) against N rows sorted by
// a band key (ops/store_kernels.py::sorted_query_operands and
// grouped_query_operands build the order, the padding, the row records
// and the extrema).  For every query q:
//     out[q, :] = sum over rows r with valid_r != 0 and |q_d - k_rd| <= w_d
//                 for all d of (1, v_r, v_r^2)
// with the exact f32 per-dimension test of the JAX kernel (sums kept in
// f64, returned as f32).
//
// What bounds it on the card.  The rows are few bytes (one record of
// round_up(D + 2, 4) floats each) next to the tests: about two FP32
// operations (subtract, compare with |.|) for each dimension of each
// (query, row) pair that the band prune keeps, plus three adds per
// match.  So it is bound by FP32 operations on the CUDA cores, at the
// pair count the prune leaves.
//
// What the design does about that (band_moments.cuh has the body).
//  * Pruning first, as a plan.  Rows and queries arrive in band order;
//    because the rows are sorted, the sub-slices a 128-query tile keeps
//    form one window, which the wrapper finds with two searchsorted calls
//    on the device (store_kernels.sorted_plan): the same f32 test as
//    sorted_prune_keep, so the skipped pairs are provably matchless and
//    no skipped sub-slice is even visited.
//  * The window is split over the whole card.  Chunks of C sub-slices
//    are walked by a persistent grid sized from the occupancy API, so a
//    tile whose window spans tens of thousands of rows no longer runs on
//    one block while the others idle; a second pass adds each query's
//    chunk partials in chunk order (deterministic, no atomics).
//  * Sub-slices arrive by cp.async.bulk into a two-buffer ring, keys are
//    read as float4 broadcasts, D is a template parameter, the dims are
//    tested most selective first and a warp leaves a row after four dims
//    when none of its queries can still match.
//  * The TPU kernel's bf16 distance prefilter is left out: it changes no
//    result, and whether it pays on this card is still open (ROADMAP.md).

#include "band_moments.cuh"

using namespace band_moments;

// C entry point: both passes on ``stream``, without synchronising;
// returns cudaGetLastError() (0 = launched) and writes the main pass's
// block count to the host int ``grid``.  The caller checks shapes, types,
// contiguity and the device, and sizes ``partial`` for every chunk of the
// plan (``off[n_qt]`` chunks of 3 x 128 doubles); ``counters`` is null
// (count nothing) or 2 int64 device totals (walked, matched).  ``out`` is
// [Q, 3] float64 where ``out_f64`` is nonzero, else float32.
extern "C" int sorted_moments(
    const void* q_t, const void* rows, const void* perm, const void* w,
    const void* s_lo, const void* s_hi, const void* off,
    int Q, int D, int n_qt, int C, int out_f64, void* partial, void* out,
    void* counters, void* stream, int* grid)
{
    if (Q <= 0 || D < 1 || D > MAX_D || C < 1 || n_qt != (Q + QT - 1) / QT) {
        return (int)cudaErrorInvalidValue;
    }
    return (int)run((const float*)q_t, (const float*)rows, (const int*)perm,
                    (const float*)w, (const int*)s_lo, (const int*)s_hi,
                    (const int*)off, Q, D, n_qt, C, (double*)partial,
                    out, out_f64 != 0, (unsigned long long*)counters,
                    (cudaStream_t)stream, grid);
}
