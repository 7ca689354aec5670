// The cp.async.bulk ring: out = f(x, y, c) elementwise over a flat array,
// streamed through shared memory by the copy engine.  K12 (stream_map:
// copy, scale, triad; csrc/stream_probes.cu) and K7's 16-byte form
// (map2_inplace: add; csrc/stream.cu) instantiate it.
//
// It is the analog of the TPU's _ring_kernel (tpu_bench/kernels/stream.py:
// 53-111): per chunk j, wait for the reads into slot j % depth, compute in
// the first operand's slot, write back from that slot, and refill the slot
// only after the write has read it.  Here:
//   - the aligned middle of the array (16-byte vectors; x, y and out placed
//     alike against 16 bytes) is cut into chunks of `chunk` bytes of every
//     operand, the last one partial (chunk_count), on a grid of one wave
//     (ring_grid; kernels/ring.py ring_plan is the same rule in Python);
//   - each block keeps a ring of `depth` slots per operand in shared
//     memory.  Whenever a slot is free, one thread takes the next chunk
//     from a counter in device memory (one atomicAdd), issues a
//     cp.async.bulk load of each operand's chunk into the slot and arms
//     the slot's mbarrier with the bytes of all of them; every thread
//     waits on the slot's phase.  Taking chunks as slots free up, rather
//     than dealing them round-robin, lets the SMs that stream faster take
//     more: with a fixed deal every run waited on the slowest SM, 1.5-3%
//     behind the first design (PERF.md section 6);
//   - the threads compute in place in x's slot with 16-byte accesses,
//     fence their writes to the async proxy and meet at a barrier; one
//     thread stores the slot to out by cp.async.bulk (one bulk group a
//     chunk).  Copy computes nothing: its one thread waits and stores;
//   - the slot of chunk j - 1 is refilled once cp.async.bulk.wait_group.read
//     1 shows that chunk j - 1's store has read it, so depth - 1 chunks of
//     loads stay in flight beside the stores; a block ends when it takes a
//     chunk past the last, with cp.async.bulk.wait_group 0;
//   - the counter (next chunk, blocks done) belongs to the stream, so
//     launches on one stream, which run in order, share it; the last block
//     to finish sets it back to zero for the next launch;
//   - the elements before the first 16-byte boundary and after the last
//     whole vector go to plain accesses of block 0.  In-place forms (out ==
//     x) are safe: one block owns each chunk.
// What bounds it on an H100: bytes (at most two FLOP an element).  Bytes
// in flight are set by the rings, not by registers.

#pragma once

#include <cuda_runtime.h>

#include <mutex>
#include <vector>

#include "common.cuh"

namespace tbt {
namespace ring {

// Fewest and most slots a ring holds.  With one slot the refill of chunk j
// would wait on chunk j.  In front of the slots: MAX_DEPTH mbarriers and
// the chunk each slot holds.
constexpr int MIN_DEPTH = 2, MAX_DEPTH = 8;
constexpr int BARRIER_BYTES = 128;

// The functors: out = f(x, y, c).  uses_y: a second operand streams
// through the ring; computes: the threads touch the slot (not for copy).
struct Copy {
    static constexpr bool uses_y = false, uses_c = false, computes = false;
    template <typename T>
    __device__ __forceinline__ T operator()(T a, T, T) const {
        return a;
    }
};

struct Scale {
    static constexpr bool uses_y = false, uses_c = true, computes = true;
    template <typename T>
    __device__ __forceinline__ T operator()(T a, T, T c) const {
        return a * c;
    }
};

struct Triad {
    static constexpr bool uses_y = true, uses_c = true, computes = true;
    template <typename T>
    __device__ __forceinline__ T operator()(T a, T b, T c) const {
        return a + c * b;
    }
};

struct Add {
    static constexpr bool uses_y = true, uses_c = false, computes = true;
    template <typename T>
    __device__ __forceinline__ T operator()(T a, T b, T) const {
        return a + b;
    }
};

// Threads a block: one warp for copy, whose one thread drives the ring;
// the operands that stream through it.
template <typename F>
constexpr int kThreads = F::computes ? 256 : 32;
template <typename F>
constexpr int kOperands = F::uses_y ? 2 : 1;

// Dynamic shared memory of a block: the barriers, then depth slots of
// `chunk` bytes for each operand.
template <typename F>
inline size_t smem_bytes(int chunk, int depth) {
    return BARRIER_BYTES +
           static_cast<size_t>(kOperands<F>) * depth * chunk;
}

// Chunks of `chunk` bytes (the last one partial) in `bytes`.
__host__ __device__ __forceinline__ long long chunk_count(long long bytes,
                                                         int chunk) {
    return (bytes + chunk - 1) / chunk;
}

// The grid: one wave of `wave` blocks, no more than the chunks, at least
// one (block 0 also does the head and the tail).
__host__ __device__ __forceinline__ long long ring_grid(long long chunks,
                                                       long long wave) {
    const long long g = chunks < wave ? chunks : wave;
    return g < 1 ? 1 : g;
}

template <typename T, typename F>
__global__ void __launch_bounds__(kThreads<F>)
    ring_kernel(T* out, const T* x, const T* __restrict__ y,
                const T* __restrict__ c, long long n, int chunk, int depth,
                unsigned long long* __restrict__ counter, F f) {
    using V = typename Vec16<T>::type;
    constexpr int W = Vec16<T>::width;
    constexpr int THREADS = kThreads<F>;
    extern __shared__ __align__(128) unsigned char smem[];
    unsigned long long* full = reinterpret_cast<unsigned long long*>(smem);
    long long* taken = reinterpret_cast<long long*>(smem + MAX_DEPTH * 8);
    unsigned char* slots = smem + BARRIER_BYTES;

    const T k = F::uses_c ? *c : T(0);
    const long long head = head_elems(x, n);
    const long long bytes = (n - head) / W * 16;
    const long long tail0 = head + bytes / sizeof(T);
    const int t = threadIdx.x;
    if (blockIdx.x == 0) {
        if (t < head) out[t] = f(x[t], F::uses_y ? y[t] : x[t], k);
        if (t < n - tail0) {
            const long long e = tail0 + t;
            out[e] = f(x[e], F::uses_y ? y[e] : x[e], k);
        }
    }
    const long long chunks = chunk_count(bytes, chunk);
    if (chunks == 0) return;
    const unsigned char* xb = reinterpret_cast<const unsigned char*>(x + head);
    const unsigned char* yb = F::uses_y
        ? reinterpret_cast<const unsigned char*>(y + head) : nullptr;
    unsigned char* ob = reinterpret_cast<unsigned char*>(out + head);
    // slot s of operand o, and the size of chunk q
    auto slot = [&](int o, int s) {
        return slots + (static_cast<size_t>(o) * depth + s) * chunk;
    };
    auto size = [&](long long q) {
        const long long rest = bytes - q * chunk;
        return static_cast<unsigned>(rest < chunk ? rest : chunk);
    };
    // thread 0: take the next chunk into slot s, or mark the slot as the
    // end (taken -1, an arrival with no bytes)
    auto take = [&](int s) {
        const long long q =
            static_cast<long long>(atomicAdd(&counter[0], 1ULL));
        taken[s] = q < chunks ? q : -1;
        if (q >= chunks) {
            mbar_expect_tx(&full[s], 0);
            return;
        }
        const unsigned b = size(q);
        mbar_expect_tx(&full[s], b * kOperands<F>);
        bulk_load(slot(0, s), xb + q * chunk, b, &full[s]);
        if constexpr (F::uses_y)
            bulk_load(slot(1, s), yb + q * chunk, b, &full[s]);
    };

    if (t == 0) {
        for (int s = 0; s < depth; ++s) mbar_init(&full[s], 1);
        mbar_init_fence();
        for (int s = 0; s < depth; ++s) take(s);
    }
    __syncthreads();
    if (F::computes || t == 0) {
        for (long long j = 0;; ++j) {
            const int s = static_cast<int>(j % depth);
            mbar_wait(&full[s], static_cast<unsigned>((j / depth) & 1));
            const long long q = taken[s];
            if (q < 0) break;
            const unsigned b = size(q);
            if constexpr (F::computes) {
                V* xs = reinterpret_cast<V*>(slot(0, s));
                const V* ys = reinterpret_cast<const V*>(
                    slot(F::uses_y ? 1 : 0, s));
                for (int v = t; v < static_cast<int>(b / 16); v += THREADS)
                    xs[v] = map_lanes(f, xs[v], ys[v], k);
                fence_async_shared();
                __syncthreads();
            }
            if (t == 0) {
                bulk_store(ob + q * chunk, slot(0, s), b);
                bulk_commit();
                if (j >= 1) {
                    bulk_wait_read<1>();  // chunk j - 1's store has read
                    take(static_cast<int>((j - 1) % depth));
                }
            }
        }
    }
    if (t == 0) {
        bulk_wait<0>();
        // every block has taken its last chunk once all are done: the last
        // one sets the counter back to zero for the stream's next launch
        __threadfence();
        if (atomicAdd(&counter[1], 1ULL) == gridDim.x - 1) {
            counter[0] = 0;
            counter[1] = 0;
        }
    }
}

// The counter of the ring's launches on `stream` of the current device,
// {next chunk, blocks done}, zero between launches: allocated and zeroed
// on the stream at its first launch there, and kept for the process.  It
// assumes that the launches which share it run one after another, as the
// launches on one stream do.  cudaStreamPerThread and cudaStreamLegacy
// are refused: each names a different stream in each host thread (or one
// that other streams wait on), so one handle would not mean one order.
struct StreamCounter {
    int device;
    cudaStream_t stream;
    unsigned long long* counter;
};

inline cudaError_t stream_counter(cudaStream_t stream,
                                  unsigned long long** counter) {
    static std::mutex mutex;
    static std::vector<StreamCounter> table;
    if (stream == cudaStreamPerThread || stream == cudaStreamLegacy)
        return cudaErrorInvalidResourceHandle;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    std::lock_guard<std::mutex> lock(mutex);
    for (const StreamCounter& e : table)
        if (e.device == dev && e.stream == stream) {
            *counter = e.counter;
            return cudaSuccess;
        }
    void* p = nullptr;
    err = cudaMalloc(&p, 2 * sizeof(unsigned long long));
    if (err != cudaSuccess) return err;
    err = cudaMemsetAsync(p, 0, 2 * sizeof(unsigned long long), stream);
    if (err != cudaSuccess) {
        cudaFree(p);
        return err;
    }
    *counter = static_cast<unsigned long long*>(p);
    table.push_back({dev, stream, *counter});
    return cudaSuccess;
}

// out = f(x, y, c) over n elements through the ring; x, y (when F uses
// it) and out must sit alike against 16 bytes (the caller checks).
// `chunk` (a multiple of 16) and `depth` (MIN_DEPTH..MAX_DEPTH) shape the
// ring.  The shared-memory opt-in and the wave are asked of the runtime
// once per device and size.
template <typename T, typename F>
int launch(T* out, const T* x, const T* y, const T* c, long long n,
           int chunk, int depth, F f, cudaStream_t stream) {
    static DeviceCache<> optin, waves;
    if (n < 0 || chunk < 16 || chunk % 16 || depth < MIN_DEPTH ||
        depth > MAX_DEPTH)
        return cudaErrorInvalidValue;
    if (n == 0) return cudaSuccess;
    auto kernel = ring_kernel<T, F>;
    cudaError_t err = optin_smem(optin, kernel);
    if (err != cudaSuccess) return err;
    unsigned long long* counter = nullptr;
    err = stream_counter(stream, &counter);
    if (err != cudaSuccess) return err;
    const size_t smem = smem_bytes<F>(chunk, depth);
    const long long wave = wave_blocks(waves, kernel, kThreads<F>, smem);
    if (wave < 0) return static_cast<int>(-wave);
    if (wave == 0) return cudaErrorInvalidConfiguration;
    const long long bytes =
        (n - head_elems(x, n)) / Vec16<T>::width * 16;
    const long long grid = ring_grid(chunk_count(bytes, chunk), wave);
    ring_kernel<T, F><<<static_cast<unsigned>(grid), kThreads<F>, smem,
                        stream>>>(out, x, y, c, n, chunk, depth, counter, f);
    return cudaGetLastError();
}

// Blocks of F's ring for T the card holds at once (its wave), or minus a
// CUDA error code.
template <typename T, typename F>
long long wave(int chunk, int depth) {
    static DeviceCache<> optin, waves;
    if (chunk < 16 || chunk % 16 || depth < MIN_DEPTH || depth > MAX_DEPTH)
        return -static_cast<long long>(cudaErrorInvalidValue);
    auto kernel = ring_kernel<T, F>;
    const cudaError_t err = optin_smem(optin, kernel);
    if (err != cudaSuccess) return -static_cast<long long>(err);
    return wave_blocks(waves, kernel, kThreads<F>, smem_bytes<F>(chunk,
                                                                 depth));
}

}  // namespace ring
}  // namespace tbt
