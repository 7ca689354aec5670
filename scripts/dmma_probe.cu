// The FP64 tensor-core (DMMA) rate of each f64 mma.sync shape on one card,
// and a one-instruction check of each shape's fragment layouts.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o dmma_probe scripts/dmma_probe.cu && ./dmma_probe
//
// Shapes: m8n8k4 (sm_80, 256 FMAs an instruction) and m16n8k4, m16n8k8,
// m16n8k16 (added for sm_90 in PTX ISA 7.8: 512, 1024 and 2048 FMAs).
//
// Layouts (lane = 4 g + t): m8n8k4 a (g, t), b (k t, n g), c[i] (g, 2t +
// i); the sm_90 shapes a[i] (g + 8 (i % 2), t + 4 (i / 2)), b[i] (k t + 4i,
// n g), c[i] (g + 8 (i / 2), 2t + i % 2), as CUTLASS's
// cute/atom/mma_traits_sm90.hpp gives them.  Each shape runs once on
// integer-valued operands, whose products and sums are exact, and every
// output is compared with the host's product: "layout ok" or the first
// mismatch.
//
// Rates: one block of W warps on every SM (W = 4, 8, 16), each warp
// issuing the shape back to back from registers on CHAINS independent
// accumulators (2, 4, 8, so one chain's latency does not set the pace);
// TFLOP/s = 2 x FMAs / the CUDA-event time of one launch, after a warm-up.
// Prints one line a (shape, warps, chains) and the best of each shape.

#include <cstdio>
#include <cstdlib>
#include <cuda_runtime.h>

#define CHECK(x)                                                          \
    do {                                                                  \
        cudaError_t e_ = (x);                                             \
        if (e_ != cudaSuccess) {                                          \
            std::printf("CUDA error %s at %s:%d\n", cudaGetErrorString(e_), \
                        __FILE__, __LINE__);                              \
            std::exit(1);                                                 \
        }                                                                 \
    } while (0)

// Shape S: 0 m8n8k4, 1 m16n8k4, 2 m16n8k8, 3 m16n8k16.
template <int S>
struct Shape;
template <>
struct Shape<0> {
    static constexpr int M = 8, K = 4, NA = 1, NB = 1, NC = 2;
    static constexpr const char* name = "m8n8k4";
    __device__ static void mma(double (&d)[NC], const double (&a)[NA],
                               const double (&b)[NB]) {
        asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, "
            "{%2}, {%3}, {%0, %1};\n"
            : "+d"(d[0]), "+d"(d[1])
            : "d"(a[0]), "d"(b[0]));
    }
};
template <>
struct Shape<1> {
    static constexpr int M = 16, K = 4, NA = 2, NB = 1, NC = 4;
    static constexpr const char* name = "m16n8k4";
    __device__ static void mma(double (&d)[NC], const double (&a)[NA],
                               const double (&b)[NB]) {
        asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
            "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
            : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
            : "d"(a[0]), "d"(a[1]), "d"(b[0]));
    }
};
template <>
struct Shape<2> {
    static constexpr int M = 16, K = 8, NA = 4, NB = 2, NC = 4;
    static constexpr const char* name = "m16n8k8";
    __device__ static void mma(double (&d)[NC], const double (&a)[NA],
                               const double (&b)[NB]) {
        asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
            : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]),
              "d"(b[1]));
    }
};
template <>
struct Shape<3> {
    static constexpr int M = 16, K = 16, NA = 8, NB = 4, NC = 4;
    static constexpr const char* name = "m16n8k16";
    __device__ static void mma(double (&d)[NC], const double (&a)[NA],
                               const double (&b)[NB]) {
        asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
            "{%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
            : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
            : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]),
              "d"(a[5]), "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]),
              "d"(b[2]), "d"(b[3]));
    }
};

// Fragment coordinates of lane (g, t): A's value i at (row, k), B's at
// (k, n), C's at (row, n).
template <int S>
__host__ __device__ void a_at(int g, int t, int i, int& r, int& k) {
    if (S == 0) {
        r = g, k = t;
    } else {
        r = g + 8 * (i % 2), k = t + 4 * (i / 2);
    }
}
template <int S>
__host__ __device__ void b_at(int g, int t, int i, int& k, int& n) {
    k = t + 4 * i, n = g;
}
template <int S>
__host__ __device__ void c_at(int g, int t, int i, int& r, int& n) {
    if (S == 0) {
        r = g, n = 2 * t + i;
    } else {
        r = g + 8 * (i / 2), n = 2 * t + i % 2;
    }
}

// One warp: d (M x 8) = a (M x K, row-major) @ b (K x 8, row-major).
template <int S>
__global__ void layout_kernel(const double* a, const double* b, double* d) {
    using P = Shape<S>;
    const int g = threadIdx.x / 4, t = threadIdx.x % 4;
    double af[P::NA], bf[P::NB], cf[P::NC];
    for (int i = 0; i < P::NA; ++i) {
        int r, k;
        a_at<S>(g, t, i, r, k);
        af[i] = a[r * P::K + k];
    }
    for (int i = 0; i < P::NB; ++i) {
        int k, n;
        b_at<S>(g, t, i, k, n);
        bf[i] = b[k * 8 + n];
    }
    for (int i = 0; i < P::NC; ++i) cf[i] = 0.0;
    P::mma(cf, af, bf);
    for (int i = 0; i < P::NC; ++i) {
        int r, n;
        c_at<S>(g, t, i, r, n);
        d[r * 8 + n] = cf[i];
    }
}

template <int S>
bool check_layout() {
    using P = Shape<S>;
    double ha[16 * 16], hb[16 * 8], hd[16 * 8], ref[16 * 8];
    for (int r = 0; r < P::M; ++r)
        for (int k = 0; k < P::K; ++k) ha[r * P::K + k] = (r * 7 + k * 3) % 11 - 5;
    for (int k = 0; k < P::K; ++k)
        for (int n = 0; n < 8; ++n) hb[k * 8 + n] = (k * 5 + n * 13) % 9 - 4;
    for (int r = 0; r < P::M; ++r)
        for (int n = 0; n < 8; ++n) {
            double s = 0;
            for (int k = 0; k < P::K; ++k) s += ha[r * P::K + k] * hb[k * 8 + n];
            ref[r * 8 + n] = s;
        }
    double *da, *db, *dd;
    CHECK(cudaMalloc(&da, sizeof ha));
    CHECK(cudaMalloc(&db, sizeof hb));
    CHECK(cudaMalloc(&dd, sizeof hd));
    CHECK(cudaMemcpy(da, ha, sizeof ha, cudaMemcpyHostToDevice));
    CHECK(cudaMemcpy(db, hb, sizeof hb, cudaMemcpyHostToDevice));
    CHECK(cudaMemset(dd, 0xff, sizeof hd));
    layout_kernel<S><<<1, 32>>>(da, db, dd);
    CHECK(cudaGetLastError());
    CHECK(cudaMemcpy(hd, dd, sizeof hd, cudaMemcpyDeviceToHost));
    CHECK(cudaFree(da));
    CHECK(cudaFree(db));
    CHECK(cudaFree(dd));
    for (int r = 0; r < P::M; ++r)
        for (int n = 0; n < 8; ++n)
            if (hd[r * 8 + n] != ref[r * 8 + n]) {
                std::printf("layout %s: MISMATCH at (%d, %d): %g, expected %g\n",
                            P::name, r, n, hd[r * 8 + n], ref[r * 8 + n]);
                return false;
            }
    std::printf("layout %s: ok\n", P::name);
    return true;
}

template <int S, int CHAINS>
__global__ void __launch_bounds__(512) rate_kernel(double* out, int iters) {
    using P = Shape<S>;
    double a[P::NA], b[P::NB], acc[CHAINS][P::NC];
    for (int i = 0; i < P::NA; ++i) a[i] = 1e-9 * (threadIdx.x + i);
    for (int i = 0; i < P::NB; ++i) b[i] = 1e-9 * (threadIdx.x - i);
    for (int c = 0; c < CHAINS; ++c)
        for (int i = 0; i < P::NC; ++i) acc[c][i] = 0.0;
    for (int it = 0; it < iters; ++it)
#pragma unroll
        for (int c = 0; c < CHAINS; ++c) P::mma(acc[c], a, b);
    double s = 0;
    for (int c = 0; c < CHAINS; ++c)
        for (int i = 0; i < P::NC; ++i) s += acc[c][i];
    out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int S, int CHAINS>
double rate(int sms, int warps, double* out) {
    using P = Shape<S>;
    // about 2e12 FMAs a launch at any shape
    const long long per_warp = 2000000000000LL / (sms * warps);
    const int iters = static_cast<int>(per_warp / (P::M * 8 * P::K * CHAINS));
    cudaEvent_t e0, e1;
    CHECK(cudaEventCreate(&e0));
    CHECK(cudaEventCreate(&e1));
    rate_kernel<S, CHAINS><<<sms, 32 * warps>>>(out, iters / 10);
    CHECK(cudaGetLastError());
    CHECK(cudaEventRecord(e0));
    rate_kernel<S, CHAINS><<<sms, 32 * warps>>>(out, iters);
    CHECK(cudaEventRecord(e1));
    CHECK(cudaEventSynchronize(e1));
    float ms = 0;
    CHECK(cudaEventElapsedTime(&ms, e0, e1));
    CHECK(cudaEventDestroy(e0));
    CHECK(cudaEventDestroy(e1));
    const double fmas =
        static_cast<double>(iters) * CHAINS * P::M * 8 * P::K * sms * warps;
    return 2.0 * fmas / (ms * 1e-3) * 1e-12;
}

template <int S>
void rates(int sms, double* out) {
    const int warps_list[] = {4, 8, 16};
    double best = 0;
    int best_w = 0, best_c = 0;
    for (int warps : warps_list) {
        const double r[3] = {rate<S, 2>(sms, warps, out),
                             rate<S, 4>(sms, warps, out),
                             rate<S, 8>(sms, warps, out)};
        const int chains[3] = {2, 4, 8};
        for (int i = 0; i < 3; ++i) {
            std::printf("rate %s warps %d chains %d: %.2f TFLOP/s\n",
                        Shape<S>::name, warps, chains[i], r[i]);
            if (r[i] > best) best = r[i], best_w = warps, best_c = chains[i];
        }
    }
    std::printf("best %s: %.2f TFLOP/s (warps %d, chains %d)\n",
                Shape<S>::name, best, best_w, best_c);
}

int main() {
    cudaDeviceProp p;
    CHECK(cudaGetDeviceProperties(&p, 0));
    std::printf("device %s: %d SMs, clock %d kHz\n", p.name,
                p.multiProcessorCount, p.clockRate);
    bool ok = check_layout<0>() & check_layout<1>() & check_layout<2>() &
              check_layout<3>();
    double* out;
    CHECK(cudaMalloc(&out, sizeof(double) * p.multiProcessorCount * 512));
    rates<0>(p.multiProcessorCount, out);
    rates<1>(p.multiProcessorCount, out);
    rates<2>(p.multiProcessorCount, out);
    rates<3>(p.multiProcessorCount, out);
    CHECK(cudaFree(out));
    return ok ? 0 : 1;
}
