// Sorted-band box-query moments: the trainer's rule-column store query.
//
// Replaces dcarl_tpu/ops/pallas_store.py::_sorted_kernel (launched by
// _launch_sorted, behind box_query_moments_sorted and
// box_query_moments_grouped).
//
// What it computes.  Q D-dim queries (D <= 32) against N rows sorted by
// a band key (ops/store_kernels.py::sorted_query_operands and
// grouped_query_operands build the order, the padding and the extrema).
// For every query q:
//     out[q, :] = sum over rows r with valid_r != 0 and |q_d - k_rd| <= w_d
//                 for all d of (1, v_r, v_r^2)
// with the exact f32 per-dimension test of the JAX kernel (sums kept in
// f64, returned as f32).
//
// What bounds it on the card.  The rows are few bytes ((D + 2) floats
// each, read once per query tile that keeps them) next to the tests:
// about two FP32 operations (subtract, compare with |.|) for each
// dimension of each (query, row) pair that the band prune keeps, plus
// three adds per match.  So it is bound by FP32 operations on the CUDA
// cores, at the pair count the prune leaves.
//
// What the design does about that.
//  * Pruning first.  Rows and queries arrive in band order, and every
//    128-query tile carries its band extrema (qb), every 256-row
//    sub-slice its own (kb).  A block skips each sub-slice whose
//    [kb_lo - w0, kb_hi + w0] cannot meet [q_lo, q_hi]: the same f32
//    test as store_kernels.sorted_prune_keep, so the skipped pairs are
//    provably matchless.  Because the rows are sorted, the kept
//    sub-slices form one band window per tile.
//  * One query per thread, sub-slices staged in shared memory and read
//    as a broadcast, sums in registers in row order (f64 sums, f32
//    count): the layout of band_moments.cuh, shared with box_moments.cu.
//    The Pallas grid's sequential N axis (a VMEM accumulator) becomes the
//    loop inside the block; the two f64 adds per match are few next to
//    the ~2 D f32 operations per pair.
//  * The TPU kernel's bf16 distance prefilter is left out: it changes no
//    result, and it existed to skip a slow VPU chain on the TPU.  It is
//    still to be ported (ROADMAP.md), as is any tensor-core use.
//  * Low occupancy is known: the trainer's 32,768 queries make 256
//    blocks of 128 threads on 132 SMs.

#include "band_moments.cuh"

namespace {

using namespace band_moments;

__global__ void __launch_bounds__(QT) sorted_kernel(
    const float* __restrict__ q_t,    // [D, Q] queries, band order
    const float* __restrict__ keys,   // [D, n_pad] rows, band order
    const float* __restrict__ vals,   // [n_pad]
    const float* __restrict__ valid,  // [n_pad] 1 / 0
    const float* __restrict__ kb,     // [2, n_pad / SUB_N] lo / hi
    const float* __restrict__ qb,     // [2, n_qt] lo / hi
    const float* __restrict__ w,      // [D]
    const float* __restrict__ w0p,    // [1] band half-width of the prune
    int Q, int n_pad, int D,
    float* __restrict__ out)          // [Q, 3], band order
{
    moments_block<true>(q_t, keys, vals, valid, kb, qb, w, w0p, Q, n_pad, D,
                        out);
}

}  // namespace

// C entry point.  Launches on ``stream`` without synchronising and
// returns cudaGetLastError() (0 = launched).  The caller checks shapes,
// types, contiguity and the device; n_pad must be a multiple of 256.
extern "C" int sorted_moments(
    const void* q_t, const void* keys, const void* vals, const void* valid,
    const void* kb, const void* qb, const void* w, const void* w0,
    int Q, int n_pad, int D, void* out, void* stream)
{
    if (Q <= 0 || D < 1 || D > MAX_D || n_pad <= 0 || n_pad % SUB_N != 0) {
        return (int)cudaErrorInvalidValue;
    }
    const int n_qt = (Q + QT - 1) / QT;
    sorted_kernel<<<n_qt, QT, smem_bytes(D), (cudaStream_t)stream>>>(
        (const float*)q_t, (const float*)keys, (const float*)vals,
        (const float*)valid, (const float*)kb, (const float*)qb,
        (const float*)w, (const float*)w0, Q, n_pad, D, (float*)out);
    return (int)cudaGetLastError();
}
