// K7 map2_inplace: x <- f(x, y) in place, elementwise, with f = add.
//
// Replaces the Pallas kernels tpu_bench/kernels/axpy.py:_tiled_map2
// (add_inplace, add_inplace_wide, map2_inplace: b02 Pallas and
// Pallas(functor), the output aliased to x) and
// tpu_bench/kernels/stream.py:_stream as add_inplace_manual (b02
// Pallas(vl): x += y through a depth-3 ring of 16 MB VMEM slots with manual
// DMA), and their f64 shadows in tpu_bench/kernels/df2stream.py (add_pair,
// add_pair_wide, map2_pair on (hi, lo) f32 pairs): built in double, this
// kernel computes those columns natively.
//
// What bounds it on an H100: bytes.  One add per element against two reads
// and one write, 12 B (f32) or 24 B (f64); the least time is those bytes at
// 3.35 TB/s.  The design:
//   - the scalar form (add_inplace, map2_inplace) loads one element per
//     thread and item, UNROLL items a block apart, all loads issued before
//     the stores, on a grid that covers the array once;
//   - the 16-byte form (add_inplace_wide, add_inplace_manual) streams
//     through the cp.async.bulk ring of csrc/ring.cuh, the TPU ring's
//     analog (a ring of slots per operand in shared memory, filled and
//     drained by the copy engine, the add done in place in x's slot, on a
//     one-wave grid), with the wrapper's chunk and depth (kernels/ring.py
//     RING).  It needs x and y placed alike against 16-byte boundaries:
//     the elements before the first boundary and after the last whole
//     vector go to plain accesses of block 0.  Where x and y are placed
//     differently, the launcher runs the scalar form.

#include <cuda_runtime.h>

#include <climits>

#include "common.cuh"
#include "ring.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;

struct Add {
    template <typename T>
    __device__ __forceinline__ T operator()(T a, T b) const {
        return a + b;
    }
};

template <typename T, typename F>
__global__ void __launch_bounds__(THREADS)
    map2_scalar(T* __restrict__ x, const T* __restrict__ y, long long n,
                F f) {
    const long long base =
        static_cast<long long>(blockIdx.x) * (THREADS * UNROLL) + threadIdx.x;
    T a[UNROLL], b[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
        const long long i = base + u * THREADS;
        if (i < n) {
            a[u] = x[i];
            b[u] = y[i];
        }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
        const long long i = base + u * THREADS;
        if (i < n) x[i] = f(a[u], b[u]);
    }
}

template <typename T>
int launch_map2_inplace(T* x, const T* y, long long n, int vector,
                        int chunk, int depth, cudaStream_t stream) {
    if (n < 0) return cudaErrorInvalidValue;
    if (n == 0) return cudaSuccess;
    constexpr long long per_block = static_cast<long long>(THREADS) * UNROLL;
    const bool alike = ((reinterpret_cast<uintptr_t>(x) ^
                         reinterpret_cast<uintptr_t>(y)) & 15u) == 0;
    if (vector && alike)
        return tbt::ring::launch(x, x, y, static_cast<const T*>(nullptr), n,
                                 chunk, depth, tbt::ring::Add{}, stream);
    const long long blocks = (n + per_block - 1) / per_block;
    if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
    map2_scalar<T, Add><<<static_cast<unsigned>(blocks), THREADS, 0,
                          stream>>>(x, y, n, Add{});
    return cudaGetLastError();
}

}  // namespace

extern "C" int tbt_map2_inplace_f32(void* x, const void* y, long long n,
                                    int vector, int chunk, int depth,
                                    void* stream) {
    return launch_map2_inplace(static_cast<float*>(x),
                               static_cast<const float*>(y), n, vector,
                               chunk, depth,
                               static_cast<cudaStream_t>(stream));
}

extern "C" int tbt_map2_inplace_f64(void* x, const void* y, long long n,
                                    int vector, int chunk, int depth,
                                    void* stream) {
    return launch_map2_inplace(static_cast<double*>(x),
                               static_cast<const double*>(y), n, vector,
                               chunk, depth,
                               static_cast<cudaStream_t>(stream));
}

// Blocks of K7's ring the card holds at once, by element size.
extern "C" long long tbt_map2_inplace_wave(int itemsize, int chunk,
                                           int depth) {
    return itemsize == 4 ? tbt::ring::wave<float, tbt::ring::Add>(chunk, depth)
                         : tbt::ring::wave<double, tbt::ring::Add>(chunk,
                                                                   depth);
}
