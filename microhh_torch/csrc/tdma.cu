// K3: the vertical Thomas solve of the spectral Poisson equation, one
// tridiagonal system per horizontal mode (pres_2.cxx:198-263).
//
// Replaces the TPU kernel Pres2._tdma_pl / _tdma_dz2_kernel
// (microhh_tpu/ops/pres_2.py:426, pallas_call :448, body :101-128): the
// forward-elimination pivots 1/w are precomputed once per case (winv,
// which also encodes the mean-mode top BC p = 0), the rhs scale dz^2 is
// folded in, and the table holds [-a, -c, dz^2] per level.  The spectrum is
// in natural rfft2 mode order (K5, csrc/dft.cu), solved in place.
//
// Bound: device-memory bytes (6 flops per complex value per pass; one read
// + one write of the spectrum in each of the two sweeps, one read of the
// pivots in each).  Design: one thread per (j, mode) marching k, with the
// running value in registers; neighbouring threads own neighbouring modes,
// so every k-step of a warp reads one contiguous run of interleaved
// (re, im) pairs as 8- or 16-byte vectors.
//
// K21 tdma_ri: the same march on a spectrum that is split into its real and
// imaginary parts and ALREADY multiplied by dz^2, with the table's columns
// [af, cf] = [-a, -c] as the TPU kernel Pres2._tdma_ri builds them
// (microhh_tpu/ops/pres_2.py:875, pallas_call :898, body _tdma_body :64;
// columns :886-891), writing the solution into two new arrays.  Every mode
// goes through the one launch, the Nyquist column too: the TPU's lane gate
// and its scan for that column fit its vector unit, they are not math.
// Used by Pres2.exec, the projection of the substep without the RK fold.
#include <cuda_runtime.h>

namespace mhh {

template <typename T> struct Vec2;
template <> struct Vec2<float> { using type = float2; };
template <> struct Vec2<double> { using type = double2; };

template <typename T>
__global__ void tdma_kernel(typename Vec2<T>::type* __restrict__ x,
                            const T* __restrict__ winv,
                            const T* __restrict__ tab, int kmax,
                            long long nmodes) {
    using V = typename Vec2<T>::type;
    const long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (m >= nmodes) return;
    T yr = T(0), yi = T(0);
    for (int k = 0; k < kmax; ++k) {
        const long long o = (long long)k * nmodes + m;
        const T wv = __ldg(winv + o);
        const T af = tab[3 * k] * wv;
        const T dz2 = tab[3 * k + 2];
        const V d = x[o];
        yr = af * yr + (d.x * dz2) * wv;
        yi = af * yi + (d.y * dz2) * wv;
        V y;
        y.x = yr;
        y.y = yi;
        x[o] = y;
    }
    T xr = T(0), xi = T(0);
    for (int k = kmax - 1; k >= 0; --k) {
        const long long o = (long long)k * nmodes + m;
        const T cf = tab[3 * k + 1] * __ldg(winv + o);
        const V y = x[o];
        xr = y.x + cf * xr;
        xi = y.y + cf * xi;
        V out;
        out.x = xr;
        out.y = xi;
        x[o] = out;
    }
}

template <typename T>
int launch_tdma(void* x, const T* winv, const T* tab, int kmax,
                long long nmodes, cudaStream_t stream) {
    const int threads = 256;
    const long long blocks = (nmodes + threads - 1) / threads;
    tdma_kernel<T><<<(unsigned int)blocks, threads, 0, stream>>>(
        (typename Vec2<T>::type*)x, winv, tab, kmax, nmodes);
    return (int)cudaGetLastError();
}

template <typename T>
__global__ void tdma_ri_kernel(const T* __restrict__ dr,
                               const T* __restrict__ di,
                               const T* __restrict__ winv,
                               const T* __restrict__ afcf, T* __restrict__ xr,
                               T* __restrict__ xi, int kmax,
                               long long nmodes) {
    const long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (m >= nmodes) return;
    T yr = T(0), yi = T(0);
    for (int k = 0; k < kmax; ++k) {
        const long long o = (long long)k * nmodes + m;
        const T wv = __ldg(winv + o);
        const T af = afcf[2 * k] * wv;
        yr = af * yr + __ldg(dr + o) * wv;
        yi = af * yi + __ldg(di + o) * wv;
        xr[o] = yr;
        xi[o] = yi;
    }
    T r = T(0), s = T(0);
    for (int k = kmax - 1; k >= 0; --k) {
        const long long o = (long long)k * nmodes + m;
        const T cf = afcf[2 * k + 1] * __ldg(winv + o);
        r = xr[o] + cf * r;
        s = xi[o] + cf * s;
        xr[o] = r;
        xi[o] = s;
    }
}

template <typename T>
int launch_tdma_ri(const T* dr, const T* di, const T* winv, const T* afcf,
                   T* xr, T* xi, int kmax, long long nmodes,
                   cudaStream_t stream) {
    const int threads = 256;
    const long long blocks = (nmodes + threads - 1) / threads;
    tdma_ri_kernel<T><<<(unsigned int)blocks, threads, 0, stream>>>(
        dr, di, winv, afcf, xr, xi, kmax, nmodes);
    return (int)cudaGetLastError();
}

}  // namespace mhh

#define MHH_TDMA(SUF, T)                                                      \
    extern "C" int mhh_tdma_##SUF(void* x, const void* winv, const void* tab, \
                                  int kmax, long long nmodes, void* stream) { \
        return mhh::launch_tdma<T>(x, (const T*)winv, (const T*)tab, kmax,    \
                                   nmodes, (cudaStream_t)stream);             \
    }                                                                         \
    extern "C" int mhh_tdma_ri_##SUF(                                         \
        const void* dr, const void* di, const void* winv, const void* afcf,   \
        void* xr, void* xi, int kmax, long long nmodes, void* stream) {       \
        return mhh::launch_tdma_ri<T>(                                        \
            (const T*)dr, (const T*)di, (const T*)winv, (const T*)afcf,       \
            (T*)xr, (T*)xi, kmax, nmodes, (cudaStream_t)stream);              \
    }

MHH_TDMA(f32, float)
MHH_TDMA(f64, double)
