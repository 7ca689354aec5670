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
//     thread and item, the vector form (add_inplace_wide,
//     add_inplace_manual) one 16-byte float4 / double2; each thread handles
//     UNROLL items a block apart, all loads issued before the stores, and
//     the grid covers the array once;
//   - the vector form needs x and y equally placed against 16-byte
//     boundaries: the elements before the first boundary and after the
//     last whole vector go to scalar loads in block 0.  Where x and y are
//     placed differently, the launcher runs the scalar form;
//   - the TPU ring's purpose, keeping DMA in flight while the VPU adds, is
//     served by the card's many resident warps.  Its real analog, a
//     cp.async.bulk / TMA ring through shared memory, is later work.

#include <cuda_runtime.h>

#include <climits>

#include "common.cuh"

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

template <typename T, typename F>
__global__ void __launch_bounds__(THREADS)
    map2_vector(T* __restrict__ x, const T* __restrict__ y, long long n,
                F f) {
    using V = typename tbt::Vec16<T>::type;
    constexpr int W = tbt::Vec16<T>::width;
    const long long head = tbt::head_elems(x, n);
    const long long nvec = (n - head) / W;
    V* __restrict__ xv = reinterpret_cast<V*>(x + head);
    const V* __restrict__ yv = reinterpret_cast<const V*>(y + head);
    const long long base =
        static_cast<long long>(blockIdx.x) * (THREADS * UNROLL) + threadIdx.x;
    V a[UNROLL], b[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
        const long long i = base + u * THREADS;
        if (i < nvec) {
            a[u] = xv[i];
            b[u] = yv[i];
        }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
        const long long i = base + u * THREADS;
        if (i < nvec) xv[i] = tbt::map_lanes(f, a[u], b[u]);
    }
    if (blockIdx.x == 0) {
        const long long t = threadIdx.x;
        const long long tail0 = head + nvec * W;
        if (t < head) x[t] = f(x[t], y[t]);
        if (t < n - tail0) x[tail0 + t] = f(x[tail0 + t], y[tail0 + t]);
    }
}

template <typename T>
int launch_map2_inplace(T* x, const T* y, long long n, int vector,
                        cudaStream_t stream) {
    if (n < 0) return cudaErrorInvalidValue;
    if (n == 0) return cudaSuccess;
    constexpr long long per_block = static_cast<long long>(THREADS) * UNROLL;
    const bool alike = ((reinterpret_cast<uintptr_t>(x) ^
                         reinterpret_cast<uintptr_t>(y)) & 15u) == 0;
    if (vector && alike) {
        const long long nvec =
            (n - tbt::head_elems(x, n)) / tbt::Vec16<T>::width;
        long long blocks = (nvec + per_block - 1) / per_block;
        if (blocks < 1) blocks = 1;  // block 0 does the head and the tail
        if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
        map2_vector<T, Add><<<static_cast<unsigned>(blocks), THREADS, 0,
                              stream>>>(x, y, n, Add{});
    } else {
        const long long blocks = (n + per_block - 1) / per_block;
        if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
        map2_scalar<T, Add><<<static_cast<unsigned>(blocks), THREADS, 0,
                              stream>>>(x, y, n, Add{});
    }
    return cudaGetLastError();
}

}  // namespace

extern "C" int tbt_map2_inplace_f32(void* x, const void* y, long long n,
                                    int vector, void* stream) {
    return launch_map2_inplace(static_cast<float*>(x),
                               static_cast<const float*>(y), n, vector,
                               static_cast<cudaStream_t>(stream));
}

extern "C" int tbt_map2_inplace_f64(void* x, const void* y, long long n,
                                    int vector, void* stream) {
    return launch_map2_inplace(static_cast<double*>(x),
                               static_cast<const double*>(y), n, vector,
                               static_cast<cudaStream_t>(stream));
}
