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
// with the exact per-dimension test of the JAX kernel.  Every sum adds
// in f64 and is rounded to f32 once, at the end, so the result does not
// depend on how the prepare cut the rows into pieces or the plan cut a
// window into chunks: the f32 terms of a query's sums add exactly in f64
// at these magnitudes, and the full store and any masked copy of it then
// give the same bits.  (Counts in f32 beside f64 sums were measured
// slower on a store whose pieces are held whole: PERF.md, C1.)
//
// What bounds it on the card.  The prepared store is read once per query
// tile that keeps a piece, and its bytes (one 24-float record a row)
// are few next to the containment tests: about two FP32 operations
// (subtract, compare with |.|) for each of the 20 dimensions of each
// (query, row) pair that the prune keeps.  So it is bound by FP32
// operations on the CUDA cores, at the pair count the prune leaves.
//
// What the design does about that.
//  * Pruning first.  Queries are sorted (by the wrapper) into the same
//    band-cell / second-dim order as the rows, and every 128-query tile
//    carries the extrema of both dims (qext).  The wrapper's plan
//    (store_kernels.peraction_plan) bounds each tile's kept sub-slices by
//    one window, from the running max / suffix min of the sub-slice band
//    extrema; inside it the kernel keeps the exact tests of the earlier
//    design (tile band early-out on kbt, then the sub-slice band and
//    second-dim rectangle on kb, kb2), so the pairs it examines are the
//    same, and only the kept sub-slices are copied.
//  * The window is split over the whole card: chunks of C sub-slices
//    walked by a persistent grid sized from the occupancy API; each chunk
//    writes its [3A][128] partial sums, and a second pass adds a query's
//    chunks in chunk order (deterministic, no atomics on data).  A block
//    takes its next chunk from a device ticket (one atomicAdd a chunk,
//    the ticket zeroed by the entry point): chunk costs differ many times
//    over, and a fixed stride left blocks idle for 38-51 % of the pass
//    on the fleet's stores (PERF.md).  The order chunks run in changes
//    no bit.
//  * Whole pieces before rows.  For every 128-row piece the prepare step
//    stores its live rows' bounding box and per-action moment sums.
//    fl(q - k) is monotone in k, so a query whose box holds both ends of
//    the piece's box along every dim matches every live row of it
//    exactly: it adds the piece's sums and skips its rows; a query past
//    an end along some dim matches none.  Rows are walked only in the
//    pieces where some query of the block is undecided, and a warp whose
//    queries are all decided skips them.  On a store written by a fleet
//    in lockstep most (query, piece) pairs are held whole.
//  * Each row is one 24-float record (20 keys in the most-selective-first
//    order `perm`, the action's int bits, 3 moments), so a piece is one
//    contiguous 12 KB block, copied by cp.async.bulk into a two-buffer
//    ring (chunk_ring.cuh) while the previous one is tested.  Keys are
//    read as float4 broadcasts; after four dims a warp leaves a row that
//    none of its queries can still contain; two rows are tested a step,
//    their first four dims before one vote.
//  * One query per thread (two were measured slower), its 20
//    coordinates in registers (the half-widths are the same on every
//    thread, and the compiler keeps them in uniform registers).  Its 3A
//    f64 sums live in registers for the whole chunk: A is a template
//    parameter (the entry point instantiates 1..MAX_ACTIONS and picks
//    the launch's), so every index into them is known at compile time.
//    A held piece adds its 3A summary terms straight into them (f64, no
//    conversion).
//  * A row is the same on every thread, so its action is too.  Before a
//    piece is walked, the block groups its live rows by action (one row
//    a thread: a warp match, counts in shared memory, a scatter), keeping
//    record order within an action; the rows of action k are then walked
//    in a loop unrolled over k, so a matched row adds its 3 terms to
//    registers the compiler names, and each sum still adds its rows in
//    record order.  Measured on the fleet's stores (PERF.md): a switch
//    on each matched row's action (a uniform jump) ran no faster than the
//    shared-memory sums it replaced, the jump's latency in place of the
//    round trip's; adds predicated over all A actions (3A f64 adds a
//    match) ran 1.5x slower.  The sums take 166 registers at A = 11, no
//    spill: 3 blocks an SM, as the 33.8 KB of shared sums allowed before;
//    a block's shared memory is now the ring, the kept lists and the
//    grouping (about 26 KB).  A dead query slot (past B in the last
//    tile) is +inf, out of reach of every piece, so it never makes its
//    block walk rows.
//  * The TPU kernel's bf16 distance prefilter is left out: it changes
//    no result, and whether it pays on this card is still open
//    (ROADMAP.md).
//
// Counters (utils/profiling.py, when tracing is on).  The main pass is a
// template on COUNT.  With a non-null ``counters`` it adds up (query,
// record) pairs walked (a live query undecided on the piece, a live
// row), rows matched by walking and live rows settled whole from piece
// sums, the last two by the count moment (a record the prepare collapsed
// from duplicates counts its weight), so that their sum is the count the
// launch returned, and the (warp, live row) iterations the walk runs (a
// warp with an open query on the piece counts its live rows once), so
// that walked / (32 warp_rows) is the walk's lane occupancy.  Nothing is
// added in the row loop (an add a row cost the kernel 12 % on the H100):
// a warp counts a walked piece's live rows together (the grouping's
// total), and a chunk's held and matched counts are its sums' count
// moments before and after the walk.  Each thread counts in registers;
// one warp reduction and one atomicAdd a warp and counter at the end.
// COUNT = false is the kernel without counters.

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#include "chunk_ring.cuh"

namespace {

using namespace chunk_ring;

constexpr int WARPS = QT / 32;   // one thread per query
constexpr int PIECE_N = 128;    // rows per ring buffer and per summary
constexpr int PIECES = SUB_N / PIECE_N;
constexpr int OBS = 20;          // observation dims of a key
constexpr int REC = 24;          // floats in a row record
constexpr int MAX_ACTIONS = 16;

static_assert(PIECE_N == QT, "a walked piece has one row a thread");

size_t smem_bytes() {
    return ring_bytes<PIECE_N>(REC)  // a multiple of 8: the ints follow
        + sizeof(int) * (2 * QT + WARPS                    // kept lists
                         + WARPS * MAX_ACTIONS + PIECE_N   // a piece's rows
                         + MAX_ACTIONS + 1                 // by action
                         + 1);                             // next chunk
}

// How a query relates to a piece's live rows, from their bounding box
// box = [lo[OBS], hi[OBS]] (record order): 1 = every live row matches,
// 2 = none does, 0 = undecided.  fl(q - k) is monotone in k, so the exact
// test |fl(q - k)| <= w holds for every k in [lo, hi] iff it holds at
// both ends, and fails for every k when fl(q - hi) > w or fl(q - lo) < -w.
__device__ __forceinline__ int settle(const float (&q)[OBS],
                                      const float (&wr)[OBS],
                                      const float* __restrict__ box) {
    const float4* b = reinterpret_cast<const float4*>(box);
    bool in = true, out = false;
#pragma unroll
    for (int g = 0; g < OBS / 4; ++g) {
        const float4 lo = __ldg(b + g), hi = __ldg(b + OBS / 4 + g);
        const float l[4] = {lo.x, lo.y, lo.z, lo.w};
        const float h[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int d = 4 * g + e;
            const float a = q[d] - l[e], c = q[d] - h[e];
            in = in & (fabsf(a) <= wr[d]) & (fabsf(c) <= wr[d]);
            out = out | (c > wr[d]) | (a < -wr[d]);
        }
    }
    return in ? 1 : (out ? 2 : 0);
}

template <bool COUNT, int A>
__global__ void __launch_bounds__(QT) peraction_main(
    const float* __restrict__ queries,   // [B, OBS] (caller order)
    const int64_t* __restrict__ qorder,  // [B] sorted position -> query row
    const float* __restrict__ qext,      // [4, n_qt] band lo/hi, dim2 lo/hi
    const float* __restrict__ rows,      // [n_pad, REC] records
    const int* __restrict__ perm,        // [OBS] obs dim of record slot d
    const float* __restrict__ piece_box,  // [n_pad / PIECE_N, 2 OBS] box
    const double* __restrict__ piece_mom,  // [n_pad / PIECE_N, 3A] sums
    const float* __restrict__ kb,        // [2, n_sub]
    const float* __restrict__ kb2,       // [2, n_sub]
    const float* __restrict__ kbt,       // [2, n_pad / n_tile]
    const float* __restrict__ w,         // [OBS]
    const float* __restrict__ w0p,       // [1] band half-width
    const float* __restrict__ w2p,       // [1] second-dim half-width
    const int* __restrict__ s_lo,        // [n_qt] window start (sub-slices)
    const int* __restrict__ s_hi,        // [n_qt] window end
    const int* __restrict__ off,         // [n_qt + 1] chunk offsets
    int B, int n_pad, int n_tile, int C,
    double* __restrict__ partial,        // [chunks, 3A, QT]
    int* __restrict__ ticket,            // [1] chunks handed out, from 0
    unsigned long long* __restrict__ counters)  // [4] walked, matched,
                                                // held, warp_rows
{
    extern __shared__ __align__(128) unsigned char smem[];
    Ring<PIECE_N> ring;
    ring.init(smem, REC);
    int* klist = reinterpret_cast<int*>(smem + ring_bytes<PIECE_N>(REC));
    int* kwalk = klist + QT;                                         // [QT]
    int* wcnt = kwalk + QT;                                          // [WARPS]
    int* acnt = wcnt + WARPS;              // [WARPS][A] rows an action
    int* order = acnt + WARPS * MAX_ACTIONS;  // [PIECE_N] rows by action
    int* abeg = order + PIECE_N;           // [A + 1] first of each action
    int* next = abeg + MAX_ACTIONS + 1;    // [1] the block's next chunk

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int n_qt = (B + QT - 1) / QT;
    const int n_sub = n_pad / SUB_N;
    const int n_tiles = n_pad / n_tile;
    const int per_tile = n_tile / SUB_N;
    const float w0 = *w0p, w2 = *w2p;

    float wr[OBS];
#pragma unroll
    for (int d = 0; d < OBS; ++d) wr[d] = __ldg(w + __ldg(perm + d));
    unsigned long long n_walked = 0, n_matched = 0, n_held = 0;
    unsigned long long n_warp_rows = 0;
    double acc[3 * A];  // this query's sums: (count, sum v, sum v^2) an action

    // Each block takes its next chunk from the ticket, so one that drew
    // light chunks takes more; the order chunks run in changes no bit.
    const int n_chunks = __ldg(off + n_qt);
    for (;;) {
        if (tid == 0) *next = atomicAdd(ticket, 1);
        __syncthreads();
        const int c = *next;  // read before the kept-list barrier below
        if (c >= n_chunks) break;
        const int t = chunk_tile(off, n_qt, c);
        const int s0 = __ldg(s_lo + t) + (c - __ldg(off + t)) * C;
        const int n = min(C, __ldg(s_hi + t) - s0);
        const float q_lo = qext[t], q_hi = qext[n_qt + t];
        const float q2_lo = qext[2 * n_qt + t], q2_hi = qext[3 * n_qt + t];

        // The chunk's kept sub-slices, in order: the tile band early-out,
        // then the sub-slice band and second-dim rectangle.
        bool kp = false;
        if (tid < n) {
            const int s = s0 + tid, tt = s / per_tile;
            kp = kbt[tt] - w0 <= q_hi && kbt[n_tiles + tt] + w0 >= q_lo
                && kb[s] - w0 <= q_hi && kb[n_sub + s] + w0 >= q_lo
                && kb2[s] - w2 <= q2_hi && kb2[n_sub + s] + w2 >= q2_lo;
        }
        const unsigned bal = __ballot_sync(0xffffffffu, kp);
        if (lane == 0) wcnt[warp] = __popc(bal);
        __syncthreads();
        int base = 0, n_kept = 0;
#pragma unroll
        for (int i = 0; i < WARPS; ++i) {
            const int x = wcnt[i];
            base += i < warp ? x : 0;
            n_kept += x;
        }
        if (kp) klist[base + __popc(bal & ((1u << lane) - 1u))] = s0 + tid;

        // This thread's query.  A dead slot (past B) is +inf: it lies in
        // no row's box and out of reach of every piece, so it settles
        // every piece and never makes its block walk rows.
        const int pos = t * QT + tid;
        const bool live = pos < B;
        const int64_t qrow = live ? qorder[pos] : 0;
        float q[OBS];
#pragma unroll
        for (int d = 0; d < OBS; ++d) {
            q[d] = live ? queries[qrow * OBS + __ldg(perm + d)]
                        : __int_as_float(0x7f800000);
        }
#pragma unroll
        for (int f = 0; f < 3 * A; ++f) acc[f] = 0.0;
        __syncthreads();

        // Whole pieces first: a query that holds a piece's box takes its
        // per-action sums at once, one outside its reach takes nothing;
        // rows are walked only in the pieces where some query is undecided.
        int n_walk = 0;
        for (int j = 0; j < n_kept * PIECES; ++j) {
            const int pc = klist[j / PIECES] * PIECES + j % PIECES;
            const int how = settle(q, wr, piece_box + (size_t)pc * 2 * OBS);
            if (how == 1) {
                const double* m = piece_mom + (size_t)pc * 3 * A;
#pragma unroll
                for (int f = 0; f < 3 * A; ++f) acc[f] += __ldg(m + f);
            }
            if (!__syncthreads_and(how != 0)) {
                if (tid == 0) kwalk[n_walk] = pc;
                ++n_walk;
            }
        }
        __syncthreads();  // kwalk is complete
        double held = 0.0;  // the count moments held whole so far
        if (COUNT) {
#pragma unroll
            for (int a = 0; a < A; ++a) held += acc[3 * a];
        }

        ring.walk(rows, n_walk, [&](int j) { return kwalk[j] * PIECE_N; },
                  [&](const float* buf, int j) {
            // The piece's live rows grouped by action, in record order
            // within each (every thread, before any warp leaves): thread t
            // places row t.  Walking an action's rows with the action a
            // constant, each sum still adds its rows in record order.
            {
                const int a_t = __float_as_int(buf[tid * REC + OBS]);
                const unsigned peers = __match_any_sync(0xffffffffu, a_t);
                const int rank = __popc(peers & ((1u << lane) - 1u));
                if (lane < A) acnt[warp * A + lane] = 0;
                __syncwarp();
                if (a_t >= 0 && rank == 0) {
                    acnt[warp * A + a_t] = __popc(peers);
                }
                __syncthreads();
                if (a_t >= 0) {  // rows of smaller actions, then earlier warps
                    int at = rank;
                    for (int k = 0; k < A; ++k) {
#pragma unroll
                        for (int i = 0; i < WARPS; ++i) {
                            at += (k < a_t || (k == a_t && i < warp))
                                ? acnt[i * A + k] : 0;
                        }
                    }
                    order[at] = tid;
                }
                if (tid <= A) {
                    int at = 0;
                    for (int k = 0; k < tid; ++k) {
#pragma unroll
                        for (int i = 0; i < WARPS; ++i) at += acnt[i * A + k];
                    }
                    abeg[tid] = at;
                }
                __syncthreads();
            }
            // the query is undecided on this piece
            const bool open =
                settle(q, wr, piece_box + (size_t)kwalk[j] * 2 * OBS) == 0;
            if (!__any_sync(0xffffffffu, open)) return;  // warp-uniform
            if (COUNT) {  // the piece's live rows, counted by the warp
                const unsigned live = abeg[A];
                if (open) n_walked += live;
                if (lane == 0) n_warp_rows += live;
            }
            // the query lies in the row's box along dims 4g..4g+3
            auto in_group = [&](int g, const float4& k) {
                return ((fabsf(q[4 * g] - k.x) <= wr[4 * g])
                        & (fabsf(q[4 * g + 1] - k.y) <= wr[4 * g + 1]))
                    & ((fabsf(q[4 * g + 2] - k.z) <= wr[4 * g + 2])
                       & (fabsf(q[4 * g + 3] - k.w) <= wr[4 * g + 3]));
            };
            auto record = [&](int i) {
                return reinterpret_cast<const float4*>(buf + order[i] * REC);
            };
            // a matched row adds its moments (count, sum v, sum v^2: the
            // record's last three floats) to action k's sums
            auto add = [&](int k, const float4* r) {
                const float4 t = r[OBS / 4];
                acc[3 * k] += (double)t.y;
                acc[3 * k + 1] += (double)t.z;
                acc[3 * k + 2] += (double)t.w;
            };
            // Action k's rows add to its three sums, whose registers the
            // unrolled loop names; two rows a step, both first tests before
            // one vote.
#pragma unroll
            for (int k = 0; k < A; ++k) {
                const int end = abeg[k + 1];
                for (int i = abeg[k]; i < end; i += 2) {
                    const bool two = i + 1 < end;
                    const float4* ra = record(i);
                    const float4* rb = record(two ? i + 1 : i);
                    bool ok_a = open & in_group(0, ra[0]);
                    bool ok_b = two & open & in_group(0, rb[0]);
                    if (!__any_sync(0xffffffffu, ok_a | ok_b)) continue;
#pragma unroll
                    for (int g = 1; g < OBS / 4; ++g) {
                        ok_a = ok_a & in_group(g, ra[g]);
                        ok_b = ok_b & in_group(g, rb[g]);
                    }
                    if (ok_a) add(k, ra);
                    if (ok_b) add(k, rb);
                }
            }
        });

        if (COUNT) {
            double total = 0.0;
#pragma unroll
            for (int a = 0; a < A; ++a) total += acc[3 * a];
            n_held += __double2ull_rn(held);
            n_matched += __double2ull_rn(total - held);
        }
        double* ps = partial + (size_t)c * 3 * A * QT + tid;
#pragma unroll
        for (int f = 0; f < 3 * A; ++f) ps[(size_t)f * QT] = acc[f];
    }
    if (COUNT) {
        warp_total(counters, n_walked);
        warp_total(counters + 1, n_matched);
        warp_total(counters + 2, n_held);
        warp_total(counters + 3, n_warp_rows);
    }
}

// The main pass of a launch: the instantiation for its number of actions,
// counting or not.
using MainPass = decltype(&peraction_main<false, 1>);

template <int... I>
MainPass main_pass_for(int num_actions, bool count,
                       std::integer_sequence<int, I...>) {
    static const MainPass off[] = {&peraction_main<false, I + 1>...};
    static const MainPass on[] = {&peraction_main<true, I + 1>...};
    return (count ? on : off)[num_actions - 1];
}

// Second pass: out[query] = sum of its chunk partials, in chunk order,
// in f64, each sum rounded to OutT once (f32; f64 for a caller that adds
// other ranks' sums before it rounds).
template <typename OutT>
__global__ void __launch_bounds__(QT) peraction_sum(
    const double* __restrict__ partial, const int* __restrict__ off,
    const int64_t* __restrict__ qorder, int B, int A,
    OutT* __restrict__ out)              // [B, A, 3] (caller order)
{
    const int t = blockIdx.x, tid = threadIdx.x;
    const int pos = t * QT + tid;
    if (pos >= B) return;
    OutT* o = out + qorder[pos] * 3 * A;
    const int c0 = off[t], c1 = off[t + 1];
    for (int a = 0; a < A; ++a) {
        double n = 0.0, s = 0.0, ss = 0.0;
        for (int c = c0; c < c1; ++c) {
            n += partial[((size_t)c * 3 * A + 3 * a) * QT + tid];
            s += partial[((size_t)c * 3 * A + 3 * a + 1) * QT + tid];
            ss += partial[((size_t)c * 3 * A + 3 * a + 2) * QT + tid];
        }
        o[3 * a] = (OutT)n;
        o[3 * a + 1] = (OutT)s;
        o[3 * a + 2] = (OutT)ss;
    }
}

}  // namespace

// C entry point: both passes on ``stream``, without synchronising;
// returns cudaGetLastError() (0 = launched) and writes the main pass's
// block count to the host int ``grid``.  The caller checks shapes, types,
// contiguity and the device; n_pad is a multiple of n_tile, n_tile of
// 256, 1 <= C <= 64, 1 <= num_actions <= 16 (the main pass's
// instantiation), and ``partial`` holds ``off[n_qt]`` chunks of
// 3 * num_actions x 128 doubles; ``ticket`` is one device int the launch
// zeroes and hands its chunks out with; ``out`` is float, or double when
// ``out_f64``; ``counters`` is null (count nothing) or 4 int64 device
// totals the launch adds to (walked, matched, held, warp_rows).
extern "C" int peraction_moments(
    const void* queries, const void* qorder, const void* qext,
    const void* rows, const void* perm, const void* piece_box,
    const void* piece_mom, const void* kb, const void* kb2, const void* kbt,
    const void* w, const void* w0, const void* w2,
    const void* s_lo, const void* s_hi, const void* off,
    int B, int n_pad, int n_tile, int num_actions, int C, int out_f64,
    void* partial, void* ticket, void* out, void* counters, void* stream,
    int* grid)
{
    if (B <= 0 || num_actions < 1 || num_actions > MAX_ACTIONS
        || n_tile % SUB_N != 0 || n_pad % n_tile != 0 || C < 1
        || C * PIECES > QT) {  // the kept lists hold QT entries
        return (int)cudaErrorInvalidValue;
    }
    const size_t smem = smem_bytes();
    const MainPass main_pass = main_pass_for(
        num_actions, counters != nullptr,
        std::make_integer_sequence<int, MAX_ACTIONS>{});
    cudaError_t err = persistent_grid(main_pass, QT, smem, grid);
    if (err != cudaSuccess) return (int)err;
    const cudaStream_t st = (cudaStream_t)stream;
    err = cudaMemsetAsync(ticket, 0, sizeof(int), st);
    if (err != cudaSuccess) return (int)err;
    main_pass<<<*grid, QT, smem, st>>>(
        (const float*)queries, (const int64_t*)qorder, (const float*)qext,
        (const float*)rows, (const int*)perm, (const float*)piece_box,
        (const double*)piece_mom, (const float*)kb, (const float*)kb2,
        (const float*)kbt, (const float*)w, (const float*)w0,
        (const float*)w2, (const int*)s_lo, (const int*)s_hi,
        (const int*)off, B, n_pad, n_tile, C,
        (double*)partial, (int*)ticket, (unsigned long long*)counters);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int n_qt = (B + QT - 1) / QT;
    if (out_f64) {
        peraction_sum<double><<<n_qt, QT, 0, st>>>(
            (const double*)partial, (const int*)off, (const int64_t*)qorder,
            B, num_actions, (double*)out);
    } else {
        peraction_sum<float><<<n_qt, QT, 0, st>>>(
            (const double*)partial, (const int*)off, (const int64_t*)qorder,
            B, num_actions, (float*)out);
    }
    return (int)cudaGetLastError();
}
