// Shared machinery of the store-query kernels (band_moments.cuh,
// peraction_moments.cu): a chunked work list walked by persistent blocks,
// a ring of sub-slice buffers in shared memory filled by bulk copies, and
// the warp total the kernels' counters add with.
//
// Work list.  Query tile t (QT consecutive queries in the wrapper's sort
// order) examines the row sub-slices [s_lo[t], s_hi[t]) (its window, from
// the wrapper's plan).  The window is cut into chunks of C sub-slices;
// tile t owns chunks [off[t], off[t + 1]) of the list, off[n_qt] chunks
// in all.  A fixed grid of blocks walks the list with a stride of
// gridDim.x; each chunk writes its own partial moments, and a second pass
// sums a query's partials in chunk order (no atomics, deterministic).
//
// Ring.  Each row is one fixed-width record of R floats (R a multiple of
// 4), so a sub-slice is one contiguous block of SUB_N * R floats, copied
// in pieces of PIECE_N rows (a smaller ring leaves room for more blocks
// on an SM).  One thread copies a piece into a ring buffer with
// cp.async.bulk, completing on that buffer's mbarrier; every thread waits
// on the barrier, tests the buffer's rows, and after a __syncthreads() the
// same thread refills the buffer with the piece STAGES ahead, so the next
// copies land while the current rows are tested.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace chunk_ring {

constexpr int QT = 128;     // queries per tile
constexpr int SUB_N = 256;  // rows per sub-slice (the prune's granularity)
constexpr int STAGES = 2;   // ring buffers per block

// Dynamic shared memory of a ring of PIECE_N-row buffers: the buffers,
// then one 8-byte mbarrier per buffer.
template <int PIECE_N>
__host__ __device__ inline size_t ring_bytes(int R) {
    return sizeof(float) * (size_t)STAGES * PIECE_N * R
        + sizeof(uint64_t) * STAGES;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Tile of chunk c: the last t with off[t] <= c (off is non-decreasing,
// off[0] = 0 <= c < off[n_qt]).
__device__ __forceinline__ int chunk_tile(const int* __restrict__ off,
                                          int n_qt, int c) {
    int lo = 0, hi = n_qt;  // off[lo] <= c < off[hi]
    while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(off + mid) <= c) lo = mid; else hi = mid;
    }
    return lo;
}

// The kernels' counters (utils/profiling.py): adds v over the warp into
// *dst (lane 0, one atomicAdd); every lane of the warp calls it.
__device__ __forceinline__ void warp_total(unsigned long long* dst,
                                           unsigned long long v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if ((threadIdx.x & 31) == 0 && v != 0) atomicAdd(dst, v);
}

// Blocks of the persistent grid of `kernel` (`threads` a block, `smem`
// bytes of dynamic shared memory): as many as fit on every SM at once.
template <typename K>
cudaError_t persistent_grid(K kernel, int threads, size_t smem, int* grid) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    int per_sm = 0, dev = 0, sms = 0;
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                            threads, smem);
    }
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    }
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    *grid = per_sm * sms;
    return cudaSuccess;
}

template <int PIECE_N>
struct Ring {
    static_assert(SUB_N % PIECE_N == 0, "a sub-slice is whole pieces");

    float* buf;      // [STAGES][PIECE_N * R]
    uint64_t* bar;   // [STAGES]
    int R;           // floats per row record
    uint32_t used;   // buffers consumed so far by this block

    // Carve the ring from dynamic shared memory and initialise the
    // barriers (one expected arrival each: the copying thread's).
    // Every thread of the block calls it.
    __device__ __forceinline__ void init(unsigned char* smem, int r) {
        R = r;
        buf = reinterpret_cast<float*>(smem);
        bar = reinterpret_cast<uint64_t*>(buf + (size_t)STAGES * PIECE_N * R);
        used = 0;
        if (threadIdx.x == 0) {
            for (int i = 0; i < STAGES; ++i) {
                asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                             :: "r"(smem_addr(bar + i)), "r"(1) : "memory");
            }
            asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        }
        __syncthreads();
    }

    __device__ __forceinline__ uint32_t bytes() const {
        return (uint32_t)(sizeof(float) * PIECE_N * R);
    }

    // Thread 0 only: copy rows [r0, r0 + PIECE_N) of rows [n_pad, R] into
    // the buffer of ring position `pos` (counted from this block's start).
    __device__ __forceinline__ void issue(const float* __restrict__ rows,
                                          int r0, uint32_t pos) const {
        const int stage = pos % STAGES;
        const uint32_t b = smem_addr(bar + stage);
        const uint32_t dst = smem_addr(buf + (size_t)stage * PIECE_N * R);
        const float* src = rows + (size_t)r0 * R;
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                     :: "r"(b), "r"(bytes()) : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];\n"
            :: "r"(dst), "l"(src), "r"(bytes()), "r"(b) : "memory");
    }

    // Wait until the copy into ring position `pos` has landed; returns
    // the buffer.
    __device__ __forceinline__ const float* wait(uint32_t pos) const {
        const int stage = pos % STAGES;
        const uint32_t b = smem_addr(bar + stage);
        const uint32_t parity = (pos / STAGES) & 1u;
        asm volatile(
            "{\n"
            ".reg .pred P1;\n"
            "LAB_WAIT:\n"
            "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
            "@P1 bra DONE;\n"
            "bra LAB_WAIT;\n"
            "DONE:\n"
            "}\n" :: "r"(b), "r"(parity) : "memory");
        return buf + (size_t)stage * PIECE_N * R;
    }

    // Walk m pieces through the ring, piece j being the PIECE_N records
    // from row first_row(j), calling body(buffer, j) for each in order.
    // Uniform across the block.
    template <typename FirstRow, typename Body>
    __device__ __forceinline__ void walk(const float* __restrict__ rows,
                                         int m, FirstRow first_row,
                                         Body body) {
        if (threadIdx.x == 0) {
            for (int j = 0; j < m && j < STAGES; ++j) {
                issue(rows, first_row(j), used + j);
            }
        }
        for (int j = 0; j < m; ++j) {
            body(wait(used + j), j);
            __syncthreads();  // every thread is done with this buffer
            if (threadIdx.x == 0 && j + STAGES < m) {
                issue(rows, first_row(j + STAGES), used + j + STAGES);
            }
        }
        used += m;
    }
};

}  // namespace chunk_ring
