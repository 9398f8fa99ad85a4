// Shared body of sorted_moments.cu and box_moments.cu: [Q, 3] box-query
// moments over a per-tile window of row sub-slices, split over the card.
//
// For every query q:
//     out[q, :] = sum over rows r with valid_r != 0 and |q_d - k_rd| <= w_d
//                 for all d of (1, v_r, v_r^2)
// with the exact f32 per-dimension test of the JAX kernels.
//
// Layout.  Rows arrive as one record of R = round_up(D + 2, 4) floats
// each: the D keys in the order `perm` gives (most selective first), then
// v, then the valid flag.  The wrapper's plan gives each QT-query tile a
// window [s_lo, s_hi) of SUB_N-row sub-slices, cut into chunks of C
// (chunk_ring.cuh); the sorted kernel's window is exactly the sub-slices
// its band prune keeps, the brute kernel's is every sub-slice.  A fixed
// grid of persistent blocks walks the chunks.  For each, a block loads its
// tile's queries (QPT per thread, coordinates and half-widths in
// registers, in record order), streams the chunk's rows through the
// bulk-copy ring in PIECE_N-row pieces, and tests each row against its
// queries: keys read as float4 broadcasts from shared memory, in two
// independent chains of four-dim groups.  After the first four dims a
// warp skips the row when no lane still contains it (__any_sync).  Two
// queries per thread and 128-row pieces were the fastest of the four
// combinations (one or two queries, 128- or 256-row pieces) measured on
// the trainer fill.
//
// Key width.  D4 = round_up(D, 4) is a template parameter (4..32), so the
// dims unroll into registers with no per-dim bounds test except in the
// last group of four, where slots past D (which hold v and the flag, not
// keys) are not tested.
//
// Sums.  Each chunk writes (count, sum v, sum v^2) of each query to its
// own slot of `partial` in f64 (an f32 sum over tens of thousands of
// near-identical matched rows misses the oracle's rtol 1e-4, measured on
// the H100); moments_sum then adds a query's chunks in chunk order and
// rounds the f64 sums once, to float32 or (for a caller that adds several
// sums before it rounds: the flat route's two copies of a query) to
// float64.  No atomics: the output is the same bits on every run.
//
// Counters (utils/profiling.py, when tracing is on).  moments_main is a
// template on COUNT too.  With a non-null ``counters`` it adds up the
// (query, row) pairs walked (a live query slot, a valid row of its
// window) and matched, so that the matched total is the count the launch
// returned.  Nothing is added in the row loop: a warp counts a piece's
// valid rows together, and a chunk's matches are its queries' counts.
// Each thread counts in registers, then one warp reduction and one
// atomicAdd a warp and counter.  The brute kernel's query slots are its
// padded ones (padding is +inf and matches nothing).  COUNT = false is
// the kernel without counters.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "chunk_ring.cuh"

namespace band_moments {

using namespace chunk_ring;

constexpr int MAX_D = 32;  // widest key
constexpr int QPT = 2;  // queries per thread
constexpr int NT = QT / QPT;  // threads per block
constexpr int PIECE_N = 128;  // rows per ring buffer

// Floats in a row record: D keys, v, valid, padded to a float4.
__host__ __device__ inline int record_floats(int D) {
    return (D + 2 + 3) / 4 * 4;
}

template <int D4, bool COUNT>
__global__ void __launch_bounds__(NT) moments_main(
    const float* __restrict__ q_t,   // [D, Q] queries, tile order
    const float* __restrict__ rows,  // [n_pad, R] records
    const int* __restrict__ perm,    // [D] key dim of record slot d
    const float* __restrict__ w,     // [D] half-widths
    const int* __restrict__ s_lo,    // [n_qt] window start (sub-slices)
    const int* __restrict__ s_hi,    // [n_qt] window end
    const int* __restrict__ off,     // [n_qt + 1] chunk offsets
    int Q, int D, int n_qt, int C,
    double* __restrict__ partial,    // [chunks, 3, QT]
    unsigned long long* __restrict__ counters)  // [2] walked, matched
{
    extern __shared__ __align__(128) unsigned char smem[];
    Ring<PIECE_N> ring;
    ring.init(smem, record_floats(D));
    const int R = ring.R;
    const int tid = threadIdx.x;
    const int lane = tid & 31;

    float wr[D4];
    bool pad[D4];  // slot d >= D: not a key, never tested
#pragma unroll
    for (int d = 0; d < D4; ++d) {
        pad[d] = d >= D;
        wr[d] = pad[d] ? CUDART_INF_F : __ldg(w + __ldg(perm + d));
    }
    unsigned long long n_walked = 0, n_matched = 0;

    const int n_chunks = __ldg(off + n_qt);
    for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
        const int t = chunk_tile(off, n_qt, c);
        const int s0 = __ldg(s_lo + t) + (c - __ldg(off + t)) * C;
        const int n = min(C, __ldg(s_hi + t) - s0);

        // A dead query is NaN: |NaN - k| <= w is false for every row.
        float q[QPT][D4];
        int n_live = 0;  // live query slots of this thread
#pragma unroll
        for (int i = 0; i < QPT; ++i) {
            const int pos = t * QT + tid + i * NT;
            n_live += pos < Q;
#pragma unroll
            for (int d = 0; d < D4; ++d) {
                q[i][d] = pad[d] ? 0.f
                    : pos < Q ? __ldg(q_t + (size_t)__ldg(perm + d) * Q + pos)
                              : CUDART_NAN_F;
            }
        }
        float cnt[QPT];
        double sum[QPT], sumsq[QPT];
#pragma unroll
        for (int i = 0; i < QPT; ++i) {
            cnt[i] = 0.f;
            sum[i] = 0.0;
            sumsq[i] = 0.0;
        }

        constexpr int PIECES = SUB_N / PIECE_N;
        ring.walk(rows, n * PIECES,
                  [&](int j) { return s0 * SUB_N + j * PIECE_N; },
                  [&](const float* buf, int) {
            if (COUNT) {  // the piece's valid rows, counted by the warp
                unsigned valid = 0;
                for (int r = lane; r < PIECE_N; r += 32) {
                    valid += buf[r * R + D + 1] != 0.f;
                }
                n_walked += (unsigned long long)n_live
                    * __reduce_add_sync(0xffffffffu, valid);
            }
            // query i lies in the row's box along dims 4g..4g+3
            auto in_group = [&](int i, int g, const float4& k) {
                const float kk[4] = {k.x, k.y, k.z, k.w};
                bool o[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int d = 4 * g + e;
                    const bool in = fabsf(q[i][d] - kk[e]) <= wr[d];
                    o[e] = d < D4 - 4 ? in : (in | pad[d]);
                }
                return (o[0] & o[1]) & (o[2] & o[3]);
            };
            for (int r = 0; r < PIECE_N; ++r) {
                const float* row = buf + r * R;
                if (row[D + 1] == 0.f) continue;  // invalid row: uniform
                const float4* k4 = reinterpret_cast<const float4*>(row);
                float4 k[D4 / 4];  // every load issued before the vote
#pragma unroll
                for (int g = 0; g < D4 / 4; ++g) k[g] = k4[g];
                bool ok[QPT];
                bool any = false;
#pragma unroll
                for (int i = 0; i < QPT; ++i) {
                    ok[i] = in_group(i, 0, k[0]);
                    any = any | ok[i];
                }
                if (!__any_sync(0xffffffffu, any)) continue;  // warp-uniform
#pragma unroll
                for (int i = 0; i < QPT; ++i) {
                    // two independent chains of dim groups
                    bool a = ok[i], b = true;
#pragma unroll
                    for (int g = 1; g < D4 / 4; ++g) {
                        if (g & 1) b = b & in_group(i, g, k[g]);
                        else a = a & in_group(i, g, k[g]);
                    }
                    ok[i] = a & b;
                }
                const float v = row[D];
#pragma unroll
                for (int i = 0; i < QPT; ++i) {
                    if (ok[i]) {
                        cnt[i] += 1.f;
                        sum[i] += v;
                        sumsq[i] += (double)v * v;
                    }
                }
            }
        });

#pragma unroll
        for (int i = 0; i < QPT; ++i) {
            if (COUNT) n_matched += (unsigned long long)cnt[i];
            double* p = partial + (size_t)c * 3 * QT + tid + i * NT;
            p[0] = cnt[i];
            p[QT] = sum[i];
            p[2 * QT] = sumsq[i];
        }
    }
    if (COUNT) {
        warp_total(counters, n_walked);
        warp_total(counters + 1, n_matched);
    }
}

// Second pass: out[q] = sum of q's chunk partials, in chunk order.
template <typename Out>
__global__ void __launch_bounds__(QT) moments_sum(
    const double* __restrict__ partial, const int* __restrict__ off,
    int Q, Out* __restrict__ out)  // [Q, 3]
{
    const int t = blockIdx.x, tid = threadIdx.x;
    const int pos = t * QT + tid;
    double a0 = 0.0, a1 = 0.0, a2 = 0.0;
    const int c1 = off[t + 1];
    for (int c = off[t]; c < c1; ++c) {
        const double* p = partial + (size_t)c * 3 * QT + tid;
        a0 += p[0];
        a1 += p[QT];
        a2 += p[2 * QT];
    }
    if (pos < Q) {
        out[(size_t)pos * 3] = (Out)a0;
        out[(size_t)pos * 3 + 1] = (Out)a1;
        out[(size_t)pos * 3 + 2] = (Out)a2;
    }
}

template <int D4>
cudaError_t run_d(const float* q_t, const float* rows, const int* perm,
                  const float* w, const int* s_lo, const int* s_hi,
                  const int* off, int Q, int D, int n_qt, int C,
                  double* partial, void* out, bool out_f64,
                  unsigned long long* counters, cudaStream_t stream,
                  int* grid) {
    const size_t smem = ring_bytes<PIECE_N>(record_floats(D));
    const auto main_pass = counters ? &moments_main<D4, true>
                                    : &moments_main<D4, false>;
    cudaError_t err = persistent_grid(main_pass, NT, smem, grid);
    if (err != cudaSuccess) return err;
    main_pass<<<*grid, NT, smem, stream>>>(
        q_t, rows, perm, w, s_lo, s_hi, off, Q, D, n_qt, C, partial,
        counters);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (out_f64) {
        moments_sum<<<n_qt, QT, 0, stream>>>(partial, off, Q, (double*)out);
    } else {
        moments_sum<<<n_qt, QT, 0, stream>>>(partial, off, Q, (float*)out);
    }
    return cudaGetLastError();
}

// Both passes on `stream` (no synchronisation); `out` is [Q, 3] float64
// where `out_f64`, else float32; *grid receives the main pass's block
// count; `counters` is null or the 2 int64 device totals the main pass
// adds to.  D in 1..MAX_D; C >= 1.
inline cudaError_t run(const float* q_t, const float* rows, const int* perm,
                       const float* w, const int* s_lo, const int* s_hi,
                       const int* off, int Q, int D, int n_qt, int C,
                       double* partial, void* out, bool out_f64,
                       unsigned long long* counters, cudaStream_t stream,
                       int* grid) {
#define BAND_CASE(G)                                                         \
    case G:                                                                  \
        return run_d<4 * G>(q_t, rows, perm, w, s_lo, s_hi, off, Q, D, n_qt, \
                            C, partial, out, out_f64, counters, stream,      \
                            grid);
    switch ((D + 3) / 4) {
        BAND_CASE(1) BAND_CASE(2) BAND_CASE(3) BAND_CASE(4)
        BAND_CASE(5) BAND_CASE(6) BAND_CASE(7) BAND_CASE(8)
        default: return cudaErrorInvalidValue;
    }
#undef BAND_CASE
}

}  // namespace band_moments
