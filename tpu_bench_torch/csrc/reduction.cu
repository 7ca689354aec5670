// K6 sumsq: the sum of (x + eps)^2 over a vector, in f32 for f32 (the JAX
// package's common.acc_dtype) and in f64 for f64.
//
// Replaces the Pallas kernels of tpu_bench/kernels/reduction.py:
//   transform_reduce_two_pass (sumsq_two_pass, b01 Pallas): per-program
//     partials, then _sum_kernel over them;
//   transform_reduce_one_pass (sumsq_wide and sumsq_functor, b01 Pallas(vl)
//     and Pallas(functor)): one accumulator revisited by a sequential grid;
// and their f64 shadows in tpu_bench/kernels/df2stream.py
// (sumsq_pair_two_pass, sumsq_pair_one_pass, sumsq_pair_wide), which add
// (hi, lo) f32 pairs because the TPU has no f64 units: built in double,
// this kernel computes those columns natively.
//
// What bounds it on an H100: bytes.  Three FLOP per element against 4 (f32)
// or 8 (f64) bytes read, far below the card's FLOP-to-bandwidth ratio; one
// read of x at 3.35 TB/s is the least time.  The design keeps enough loads
// in flight and does no work after the read that scales with n:
//   - at most max_blocks blocks of 256 threads (the wrapper passes 8 per SM)
//     walk x grid-stride, each thread with UNROLL independent loads in
//     flight and UNROLL partial sums in registers;
//   - each block sums its threads by warp shuffles and one shared-memory
//     step;
//   - two-pass: each block writes its partial, and a second launch of one
//     block sums the partials.  The order is fixed, so the result is the
//     same from run to run;
//   - one-pass: 16-byte loads (float4 / double2); each block atomicAdds its
//     sum into one accumulator that the wrapper zeroed.  The atomics land
//     in another order on every run, so an f32 sum varies in its last
//     bits.  The functor form is this kernel's template instantiated with
//     SquareEps;
//   - the elements before the first 16-byte boundary and after the last
//     whole vector are summed with scalar loads by the first threads, so
//     any length and any element-aligned pointer works.
// Whatever the TPU grid carried from step to step, here a block's loop
// carries; the cross-block sum is the second pass or the atomics.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;

struct SquareEps {
    template <typename T>
    __device__ __forceinline__ T operator()(T v, T eps) const {
        const T w = v + eps;
        return w * w;
    }
};

struct Identity {
    template <typename T>
    __device__ __forceinline__ T operator()(T v, T) const {
        return v;
    }
};

// Sum of v over the block, valid in thread 0.
template <typename T>
__device__ __forceinline__ T block_sum(T v) {
    __shared__ T warp_sums[THREADS / 32];
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    v = tbt::warp_sum(v);
    if (lane == 0) warp_sums[warp] = v;
    __syncthreads();
    if (warp == 0) {
        v = lane < THREADS / 32 ? warp_sums[lane] : T(0);
        v = tbt::warp_sum(v);
    }
    return v;
}

// This thread's sum of f(x[i], eps) over i = tid, tid + stride, ... < n.
template <typename T, typename F>
__device__ __forceinline__ T scalar_sum(const T* __restrict__ x, long long n,
                                        T eps, F f, long long tid,
                                        long long stride) {
    T acc[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) acc[u] = T(0);
    long long i = tid;
    for (; i + (UNROLL - 1) * stride < n; i += UNROLL * stride) {
        T v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) v[u] = x[i + u * stride];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) acc[u] += f(v[u], eps);
    }
    for (; i < n; i += stride) acc[0] += f(x[i], eps);
    return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// The same sum over x[0:n] in 16-byte vectors, the unaligned head and the
// ragged tail by scalar loads of the first threads.
template <typename T, typename F>
__device__ __forceinline__ T vector_sum(const T* __restrict__ x, long long n,
                                        T eps, F f, long long tid,
                                        long long stride) {
    using V = typename tbt::Vec16<T>::type;
    constexpr int W = tbt::Vec16<T>::width;
    const long long head = tbt::head_elems(x, n);
    const long long nvec = (n - head) / W;
    const V* __restrict__ xv = reinterpret_cast<const V*>(x + head);
    T acc[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) acc[u] = T(0);
    long long i = tid;
    for (; i + (UNROLL - 1) * stride < nvec; i += UNROLL * stride) {
        V v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) v[u] = xv[i + u * stride];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) acc[u] += tbt::fold_lanes(f, v[u], eps);
    }
    for (; i < nvec; i += stride) acc[0] += tbt::fold_lanes(f, xv[i], eps);
    const long long tail0 = head + nvec * W;
    if (tid < head) acc[0] += f(x[tid], eps);
    if (tid < n - tail0) acc[0] += f(x[tail0 + tid], eps);
    return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// Block sums of f(x, eps) over x[0:n]: into out[blockIdx.x], or atomically
// added into out[0].
template <typename T, typename F, bool VECTOR, bool ATOMIC>
__global__ void __launch_bounds__(THREADS)
    transform_reduce(const T* __restrict__ x, long long n, T eps, F f,
                     T* __restrict__ out) {
    const long long tid = static_cast<long long>(blockIdx.x) * THREADS +
                          threadIdx.x;
    const long long stride = static_cast<long long>(gridDim.x) * THREADS;
    T s;
    if constexpr (VECTOR)
        s = vector_sum(x, n, eps, f, tid, stride);
    else
        s = scalar_sum(x, n, eps, f, tid, stride);
    s = block_sum(s);
    if (threadIdx.x == 0) {
        if constexpr (ATOMIC)
            atomicAdd(out, s);
        else
            out[blockIdx.x] = s;
    }
}

// one_pass = 0: two-pass, scalar loads, partials[0:blocks] then out[0];
// one_pass = 1: 16-byte loads, atomics into out[0], zeroed here first (a
// memset on the stream costs the host less than a zeros tensor).
template <typename T>
int launch_sumsq(const T* x, long long n, double eps, T* out, T* partials,
                 int max_blocks, int one_pass, cudaStream_t stream) {
    if (n < 0 || max_blocks <= 0) return cudaErrorInvalidValue;
    const long long per_block =
        static_cast<long long>(THREADS) * UNROLL *
        (one_pass ? tbt::Vec16<T>::width : 1);
    long long blocks = (n + per_block - 1) / per_block;
    if (blocks > max_blocks) blocks = max_blocks;
    if (blocks < 1) blocks = 1;
    const T e = static_cast<T>(eps);
    if (one_pass) {
        const cudaError_t err = cudaMemsetAsync(out, 0, sizeof(T), stream);
        if (err != cudaSuccess) return err;
        transform_reduce<T, SquareEps, true, true>
            <<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
                x, n, e, SquareEps{}, out);
        return cudaGetLastError();
    }
    transform_reduce<T, SquareEps, false, false>
        <<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
            x, n, e, SquareEps{}, partials);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    transform_reduce<T, Identity, false, false>
        <<<1, THREADS, 0, stream>>>(partials, blocks, e, Identity{}, out);
    return cudaGetLastError();
}

}  // namespace

extern "C" int tbt_sumsq_f32(const void* x, long long n, double eps,
                             void* out, void* partials, int max_blocks,
                             int one_pass, void* stream) {
    return launch_sumsq(static_cast<const float*>(x), n, eps,
                        static_cast<float*>(out),
                        static_cast<float*>(partials), max_blocks, one_pass,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int tbt_sumsq_f64(const void* x, long long n, double eps,
                             void* out, void* partials, int max_blocks,
                             int one_pass, void* stream) {
    return launch_sumsq(static_cast<const double*>(x), n, eps,
                        static_cast<double*>(out),
                        static_cast<double*>(partials), max_blocks, one_pass,
                        static_cast<cudaStream_t>(stream));
}
