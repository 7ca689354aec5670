// K10-K13: the bandwidth-ceiling probes of benchmarks/ceilings.py.
//
// Replace the Pallas probes of tpu_bench/kernels/stream.py:
//   K10 stream_read    read_manual (_read_manual_kernel): read all of x and
//                      return an (8, 128) token, rows of x + bias;
//   K11 stream_fill    fill (_fill_kernel, scalar stores here) and
//                      fill_manual (_fill_manual_kernel, 16-byte stores):
//                      write seed into every element;
//   K12 stream_map     copy_manual, scale_manual and triad_manual (_stream
//                      over _ring_kernel): out = x; x *= c; x += c*y;
//   K13 stream_expand  expand_manual (_expand_manual_kernel): m copies of
//                      each chunk of x (+ bias), output chunk j*m + t being
//                      input chunk j.
// c, seed and bias are read from device memory, as the TPU kernels read
// them from SMEM, so a timed call holds no host sync.
//
// What bounds them on an H100: bytes.  At most two FLOP per element against
// 8-24 bytes (f32) moved; the least time is the bytes at 3.35 TB/s.  A probe
// is a bound only if it moves every byte it is credited with, so:
//   - K10's loads feed nothing the caller needs but the token.  Each thread
//     folds the bit pattern of every value it loads into one XOR, each
//     block XORs its threads' and atomically XORs that into one 8-byte
//     word the wrapper passes, so no load is dead code.  The token rows
//     are stored from the registers of the threads that loaded them, in
//     the one or two blocks whose items hold them (one test per block, so
//     the other blocks' loop carries no per-item test);
//   - copy goes out of place: a self-copy stores what it just loaded, which
//     a compiler that sees the alias may drop;
//   - K12 streams operands that sit alike against 16-byte boundaries
//     through the cp.async.bulk ring of csrc/ring.cuh, the analog of the
//     TPU's _ring_kernel: a one-wave grid, a ring of slots per operand in
//     shared memory filled and drained by the copy engine, the compute in
//     place in the slot.  Its chunk and depth come from the wrapper
//     (kernels/ring.py RING).  Operands placed differently take a scalar
//     form;
//   - K10, K11 and K13 load and store 16 bytes a thread (float4 / double2)
//     where the operands sit alike against 16-byte boundaries, UNROLL
//     items a thread in flight, all loads before the stores, and the grid
//     covers the array once.  The elements before the first boundary and
//     after the last whole vector go to scalar accesses of block 0.
//     Operands placed differently take the scalar form; fill's scalar form
//     is fill's own.  K10 keeps READ_UNROLL = 8 loads a thread in flight,
//     the others UNROLL = 4: on an H100 the read sustained more at 8 than
//     as a grid-stride loop at 4 (K10's first form), and the others
//     sustained no more at 8.

#include <cuda_runtime.h>

#include <climits>
#include <type_traits>

#include "common.cuh"
#include "ring.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;
constexpr int READ_UNROLL = 8;
constexpr long long TOKEN = 8 * 128;  // elements of read_manual's token

// The 16-byte vector of T when VEC, else T itself, and its width.
template <typename T, bool VEC>
struct Item {
    using type = std::conditional_t<VEC, typename tbt::Vec16<T>::type, T>;
    static constexpr int width = VEC ? tbt::Vec16<T>::width : 1;
};

__device__ __forceinline__ float4 splat(float s) {
    return make_float4(s, s, s, s);
}
__device__ __forceinline__ double2 splat(double s) {
    return make_double2(s, s);
}

// f(a, b, c) lane by lane; c is one scalar.
template <typename F, typename T>
__device__ __forceinline__ T apply(F f, T a, T b, T c) {
    return f(a, b, c);
}
template <typename F>
__device__ __forceinline__ float4 apply(F f, float4 a, float4 b, float c) {
    return make_float4(f(a.x, b.x, c), f(a.y, b.y, c), f(a.z, b.z, c),
                       f(a.w, b.w, c));
}
template <typename F>
__device__ __forceinline__ double2 apply(F f, double2 a, double2 b,
                                         double c) {
    return make_double2(f(a.x, b.x, c), f(a.y, b.y, c));
}

// ---------------------------------------------------------------------------
// K10 stream_read
// ---------------------------------------------------------------------------

// XOR of the bit patterns of the lanes.
__device__ __forceinline__ unsigned long long bits(float v) {
    return __float_as_uint(v);
}
__device__ __forceinline__ unsigned long long bits(double v) {
    return static_cast<unsigned long long>(__double_as_longlong(v));
}
__device__ __forceinline__ unsigned long long bits(float4 v) {
    return bits(v.x) ^ bits(v.y) ^ bits(v.z) ^ bits(v.w);
}
__device__ __forceinline__ unsigned long long bits(double2 v) {
    return bits(v.x) ^ bits(v.y);
}

// tok[k] = v + b for the lanes of v whose place k (k counted from the
// token's first element) lies in the token.
template <typename T>
__device__ __forceinline__ void token_put(T v, long long k, T b, T* tok) {
    if (k >= 0 && k < TOKEN) tok[k] = v + b;
}
__device__ __forceinline__ void token_put(float4 v, long long k, float b,
                                          float* tok) {
    if (k + 4 <= 0 || k >= TOKEN) return;
    token_put(v.x, k, b, tok);
    token_put(v.y, k + 1, b, tok);
    token_put(v.z, k + 2, b, tok);
    token_put(v.w, k + 3, b, tok);
}
__device__ __forceinline__ void token_put(double2 v, long long k, double b,
                                          double* tok) {
    if (k + 2 <= 0 || k >= TOKEN) return;
    token_put(v.x, k, b, tok);
    token_put(v.y, k + 1, b, tok);
}

// XOR of v over the block, valid in thread 0.
__device__ __forceinline__ unsigned long long block_xor(unsigned long long v) {
    __shared__ unsigned long long warp_x[THREADS / 32];
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1)
        v ^= __shfl_xor_sync(0xffffffffu, v, offset);
    if (threadIdx.x % 32 == 0) warp_x[threadIdx.x / 32] = v;
    __syncthreads();
    v = 0;
    if (threadIdx.x == 0) {
#pragma unroll
        for (int w = 0; w < THREADS / 32; ++w) v ^= warp_x[w];
    }
    return v;
}

// Reads x[0:n]; tok[0:TOKEN] = x[tok0:tok0 + TOKEN] + bias[0]; XORs the
// bits of everything read into *sink.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    stream_read(const T* __restrict__ x, long long n,
                const T* __restrict__ bias, T* __restrict__ tok,
                long long tok0, unsigned long long* __restrict__ sink) {
    using V = typename tbt::Vec16<T>::type;
    constexpr int W = tbt::Vec16<T>::width;
    const long long head = tbt::head_elems(x, n);
    const long long nvec = (n - head) / W;
    const V* __restrict__ xv = reinterpret_cast<const V*>(x + head);
    const long long first =
        static_cast<long long>(blockIdx.x) * (THREADS * READ_UNROLL);
    const long long base = first + threadIdx.x;
    V v[READ_UNROLL];
#pragma unroll
    for (int u = 0; u < READ_UNROLL; ++u) {
        const long long i = base + u * THREADS;
        v[u] = i < nvec ? xv[i] : V{};
    }
    unsigned long long acc = 0;
#pragma unroll
    for (int u = 0; u < READ_UNROLL; ++u) acc ^= bits(v[u]);
    // this block's elements: head + [first, first + THREADS*READ_UNROLL) * W
    if (head + first * W < tok0 + TOKEN &&
        head + (first + THREADS * READ_UNROLL) * W > tok0) {
        const T b = *bias;
#pragma unroll
        for (int u = 0; u < READ_UNROLL; ++u) {
            const long long i = base + u * THREADS;
            if (i < nvec) token_put(v[u], head + i * W - tok0, b, tok);
        }
    }
    if (blockIdx.x == 0) {
        const T b = *bias;
        const long long t = threadIdx.x;
        const long long tail0 = head + nvec * W;
        if (t < head) {
            acc ^= bits(x[t]);
            token_put(x[t], t - tok0, b, tok);
        }
        if (t < n - tail0) {
            acc ^= bits(x[tail0 + t]);
            token_put(x[tail0 + t], tail0 + t - tok0, b, tok);
        }
    }
    acc = block_xor(acc);
    if (threadIdx.x == 0) atomicXor(sink, acc);
}

template <typename T>
int launch_read(const T* x, long long n, const T* bias, T* tok,
                long long tok0, unsigned long long* sink,
                cudaStream_t stream) {
    if (n < 0 || tok0 < 0 || tok0 + TOKEN > n) return cudaErrorInvalidValue;
    const long long nvec = (n - tbt::head_elems(x, n)) / tbt::Vec16<T>::width;
    constexpr long long per_block = THREADS * READ_UNROLL;
    long long blocks = (nvec + per_block - 1) / per_block;
    if (blocks < 1) blocks = 1;  // block 0 does the head and the tail
    if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
    stream_read<T><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
        x, n, bias, tok, tok0, sink);
    return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K11 stream_fill
// ---------------------------------------------------------------------------

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
    stream_fill(T* __restrict__ out, long long n,
                const T* __restrict__ seed) {
    using V = typename Item<T, VEC>::type;
    constexpr int W = Item<T, VEC>::width;
    const T s = *seed;
    const long long head = VEC ? tbt::head_elems(out, n) : 0;
    const long long items = (n - head) / W;
    V* __restrict__ ov = reinterpret_cast<V*>(out + head);
    V sv;
    if constexpr (VEC)
        sv = splat(s);
    else
        sv = s;
    const long long base =
        static_cast<long long>(blockIdx.x) * (THREADS * UNROLL) + threadIdx.x;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
        const long long i = base + u * THREADS;
        if (i < items) ov[i] = sv;
    }
    if (VEC && blockIdx.x == 0) {
        const long long t = threadIdx.x;
        const long long tail0 = head + items * W;
        if (t < head) out[t] = s;
        if (t < n - tail0) out[tail0 + t] = s;
    }
}

template <typename T>
int launch_fill(T* out, long long n, const T* seed, int vector,
                cudaStream_t stream) {
    if (n < 0) return cudaErrorInvalidValue;
    if (n == 0) return cudaSuccess;
    const long long items = vector ? n / tbt::Vec16<T>::width : n;
    long long blocks = (items + THREADS * UNROLL - 1) / (THREADS * UNROLL);
    if (blocks < 1) blocks = 1;  // block 0 does the head and the tail
    if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
    const unsigned grid = static_cast<unsigned>(blocks);
    if (vector)
        stream_fill<T, true><<<grid, THREADS, 0, stream>>>(out, n, seed);
    else
        stream_fill<T, false><<<grid, THREADS, 0, stream>>>(out, n, seed);
    return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K12 stream_map: out = f(x, y, c), out == x for the in-place forms
// ---------------------------------------------------------------------------

// Operands placed differently against 16 bytes: one element an item,
// UNROLL items a thread, all loads before the stores, a grid that covers
// the array once.  out and x may be one array (scale, triad), so neither
// is __restrict__.
template <typename T, typename F>
__global__ void __launch_bounds__(THREADS)
    stream_map_scalar(T* out, const T* x, const T* __restrict__ y,
                      const T* __restrict__ c, long long n, F f) {
    const T k = F::uses_c ? *c : T(0);
    const long long base =
        static_cast<long long>(blockIdx.x) * (THREADS * UNROLL) + threadIdx.x;
    T a[UNROLL], b[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
        const long long i = base + u * THREADS;
        if (i < n) {
            a[u] = x[i];
            b[u] = F::uses_y ? y[i] : a[u];
        }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
        const long long i = base + u * THREADS;
        if (i < n) out[i] = f(a[u], b[u], k);
    }
}

// Operands alike against 16 bytes take the ring (tbt::ring, csrc/ring.cuh)
// of `chunk` bytes and `depth` slots; operands placed differently take
// the scalar form.
template <typename T, typename F>
int launch_map(T* out, const T* x, const T* y, const T* c, long long n,
               int chunk, int depth, F f, cudaStream_t stream) {
    uintptr_t apart = reinterpret_cast<uintptr_t>(out) ^
                      reinterpret_cast<uintptr_t>(x);
    if (F::uses_y)
        apart |= reinterpret_cast<uintptr_t>(x) ^
                 reinterpret_cast<uintptr_t>(y);
    if ((apart & 15u) == 0)
        return tbt::ring::launch(out, x, y, c, n, chunk, depth, f, stream);
    const long long blocks = (n + THREADS * UNROLL - 1) / (THREADS * UNROLL);
    if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
    stream_map_scalar<T><<<static_cast<unsigned>(blocks), THREADS, 0,
                           stream>>>(out, x, y, c, n, f);
    return cudaGetLastError();
}

// op 0: out = x; 1: out = x * c[0]; 2: out = x + c[0] * y.
template <typename T>
int launch_stream_map(T* out, const T* x, const T* y, const T* c,
                      long long n, int op, int chunk, int depth,
                      cudaStream_t stream) {
    if (n < 0) return cudaErrorInvalidValue;
    if (n == 0) return cudaSuccess;
    switch (op) {
        case 0:
            return launch_map(out, x, y, c, n, chunk, depth,
                              tbt::ring::Copy{}, stream);
        case 1:
            return launch_map(out, x, y, c, n, chunk, depth,
                              tbt::ring::Scale{}, stream);
        case 2:
            return launch_map(out, x, y, c, n, chunk, depth,
                              tbt::ring::Triad{}, stream);
        default:
            return cudaErrorInvalidValue;
    }
}

// The wave of op's ring for T (blocks the card holds at once), or minus a
// CUDA error code.
template <typename T>
long long stream_map_wave(int op, int chunk, int depth) {
    switch (op) {
        case 0:
            return tbt::ring::wave<T, tbt::ring::Copy>(chunk, depth);
        case 1:
            return tbt::ring::wave<T, tbt::ring::Scale>(chunk, depth);
        case 2:
            return tbt::ring::wave<T, tbt::ring::Triad>(chunk, depth);
        default:
            return -static_cast<long long>(cudaErrorInvalidValue);
    }
}

// ---------------------------------------------------------------------------
// K13 stream_expand
// ---------------------------------------------------------------------------

struct Offset {
    template <typename T>
    __device__ __forceinline__ T operator()(T a, T, T c) const {
        return a + c;
    }
};

// x[0:n] in chunks of 2^shift elements; out chunk j*m + t = x chunk j +
// bias[0], t < m.  Item i of chunk j lands at i + j*(m-1)*chunk + t*chunk
// (in items), so a warp's stores stay contiguous for each t.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
    stream_expand(const T* __restrict__ x, long long n,
                  const T* __restrict__ bias, T* __restrict__ out, int m,
                  int shift) {
    using V = typename Item<T, VEC>::type;
    constexpr int W = Item<T, VEC>::width;
    constexpr int LOG_W = W == 4 ? 2 : W == 2 ? 1 : 0;
    const long long items = n / W;
    const int chunk_shift = shift - LOG_W;  // items per chunk: 2^chunk_shift
    const long long chunk = 1LL << chunk_shift;
    const V* __restrict__ xv = reinterpret_cast<const V*>(x);
    V* __restrict__ ov = reinterpret_cast<V*>(out);
    const T b = *bias;
    const long long base =
        static_cast<long long>(blockIdx.x) * (THREADS * UNROLL) + threadIdx.x;
    V v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
        const long long i = base + u * THREADS;
        if (i < items) v[u] = xv[i];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
        const long long i = base + u * THREADS;
        if (i < items) {
            const V w = apply(Offset{}, v[u], v[u], b);
            V* dst = ov + i + (i >> chunk_shift) * (m - 1) * chunk;
            for (int t = 0; t < m; ++t) dst[t * chunk] = w;
        }
    }
}

template <typename T>
int launch_expand(const T* x, long long n, const T* bias, T* out, int m,
                  int shift, cudaStream_t stream) {
    // chunks of whole 128-element rows that tile x
    if (n < 0 || m < 1 || shift < 7 || shift > 40 ||
        (n & ((1LL << shift) - 1)) != 0)
        return cudaErrorInvalidValue;
    if (n == 0) return cudaSuccess;
    const bool vector = tbt::aligned16(x) && tbt::aligned16(out);
    const long long items = vector ? n / tbt::Vec16<T>::width : n;
    const long long blocks =
        (items + THREADS * UNROLL - 1) / (THREADS * UNROLL);
    if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
    const unsigned grid = static_cast<unsigned>(blocks);
    if (vector)
        stream_expand<T, true><<<grid, THREADS, 0, stream>>>(x, n, bias, out,
                                                             m, shift);
    else
        stream_expand<T, false><<<grid, THREADS, 0, stream>>>(x, n, bias,
                                                              out, m, shift);
    return cudaGetLastError();
}

}  // namespace

extern "C" int tbt_stream_read_f32(const void* x, long long n,
                                   const void* bias, void* tok,
                                   long long tok0, void* sink, void* stream) {
    return launch_read(static_cast<const float*>(x), n,
                       static_cast<const float*>(bias),
                       static_cast<float*>(tok), tok0,
                       static_cast<unsigned long long*>(sink),
                       static_cast<cudaStream_t>(stream));
}

extern "C" int tbt_stream_read_f64(const void* x, long long n,
                                   const void* bias, void* tok,
                                   long long tok0, void* sink, void* stream) {
    return launch_read(static_cast<const double*>(x), n,
                       static_cast<const double*>(bias),
                       static_cast<double*>(tok), tok0,
                       static_cast<unsigned long long*>(sink),
                       static_cast<cudaStream_t>(stream));
}

extern "C" int tbt_stream_fill_f32(void* out, long long n, const void* seed,
                                   int vector, void* stream) {
    return launch_fill(static_cast<float*>(out), n,
                       static_cast<const float*>(seed), vector,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int tbt_stream_fill_f64(void* out, long long n, const void* seed,
                                   int vector, void* stream) {
    return launch_fill(static_cast<double*>(out), n,
                       static_cast<const double*>(seed), vector,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int tbt_stream_map_f32(void* out, const void* x, const void* y,
                                  const void* c, long long n, int op,
                                  int chunk, int depth, void* stream) {
    return launch_stream_map(static_cast<float*>(out),
                             static_cast<const float*>(x),
                             static_cast<const float*>(y),
                             static_cast<const float*>(c), n, op, chunk,
                             depth, static_cast<cudaStream_t>(stream));
}

extern "C" int tbt_stream_map_f64(void* out, const void* x, const void* y,
                                  const void* c, long long n, int op,
                                  int chunk, int depth, void* stream) {
    return launch_stream_map(static_cast<double*>(out),
                             static_cast<const double*>(x),
                             static_cast<const double*>(y),
                             static_cast<const double*>(c), n, op, chunk,
                             depth, static_cast<cudaStream_t>(stream));
}

// Blocks of K12's ring for op the card holds at once, by element size.
extern "C" long long tbt_stream_map_wave(int itemsize, int op, int chunk,
                                         int depth) {
    return itemsize == 4 ? stream_map_wave<float>(op, chunk, depth)
                         : stream_map_wave<double>(op, chunk, depth);
}

extern "C" int tbt_stream_expand_f32(const void* x, long long n,
                                     const void* bias, void* out, int m,
                                     int shift, void* stream) {
    return launch_expand(static_cast<const float*>(x), n,
                         static_cast<const float*>(bias),
                         static_cast<float*>(out), m, shift,
                         static_cast<cudaStream_t>(stream));
}

extern "C" int tbt_stream_expand_f64(const void* x, long long n,
                                     const void* bias, void* out, int m,
                                     int shift, void* stream) {
    return launch_expand(static_cast<const double*>(x), n,
                         static_cast<const double*>(bias),
                         static_cast<double*>(out), m, shift,
                         static_cast<cudaStream_t>(stream));
}
