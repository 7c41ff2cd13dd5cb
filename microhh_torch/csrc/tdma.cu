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
// Bound: device-memory bytes.  The least the solve can move is one read of
// the spectrum, one read of the pivots and one write of the spectrum: 20 B
// per (mode, level) in float32, 40 in float64.  The two sweeps are
// first-order affine recurrences in k,
//   forward   y_k = alpha_k y_{k-1} + beta_k,  alpha_k = tab[k][0] winv_k,
//                                              beta_k = x_k tab[k][2] winv_k
//   backward  x_k = y_k + gamma_k x_{k+1},     gamma_k = tab[k][1] winv_k,
// so the scan form (tdma_scan_kernel) solves a mode as a chunked scan and
// keeps its whole column on chip between the two: a block is TD_MT modes
// (threadIdx.x, neighbouring threads on neighbouring modes, so that the
// TD_MT threads of a chunk read one contiguous run of a level: 128 B of
// interleaved (re, im) in float32) by ceil(kmax / L) chunks (threadIdx.y) of
// L levels each.  A thread loads its L levels of the spectrum and the
// pivots into registers, all loads issued before the first use (their
// only reads), and then
//   1. forms its chunk's forward composite: A = prod alpha (real) and B, the
//      chunk's y at its top level from a zero carry;
//   2. after a barrier, folds the composites of the chunks below its own,
//      bottom up, from y = 0 into its carry-in and re-sweeps its levels
//      from it, y_k replacing beta_k in the registers;
//   3. forms its backward composite on those y: G = prod gamma and H, the
//      chunk's x at its bottom level from a zero carry above;
//   4. after another barrier, folds the composites of the chunks above its
//      own, top down, from x = 0 into its carry-in, re-sweeps its levels
//      from it and writes each x_k once (the only device-memory writes).
// Within a chunk the sweeps stay sequential; the chunks of a mode run side
// by side.  |alpha| and |gamma| are at most about 1 for this matrix (the
// weakly dominant mean mode too), so no composite can overflow; one that
// underflows to 0 is an exact decay of the carry.  Levels at or above kmax
// of a partial last chunk and modes at or past nmodes of a partial tile
// are skipped (their loads and stores guarded), never read.  L is one
// length a type, TD_L_F32 = 32 and TD_L_F64 = 16 levels: a column takes
// 3 L values a thread in registers, 96 words in both types, of the 128 that
// TD_MT x TD_NCMAX threads a block allow.  So in float32 two blocks of 16
// chunks fit an SM at kmax = 512, one block's loads overlapping another's
// scan; in float64 that column is one block of 32 chunks, the SM's whole
// register file (two blocks would need 64 registers a thread, and shorter
// chunks more than TD_NCMAX of them).
// The table rows of the block's levels are copied to shared memory by
// cp.async ahead of the column's loads (read from there four times, with
// no register to spare for them), and the composites of a block go
// through shared memory, 6 TD_NCMAX TD_MT values.
//
// The sweep form (tdma_kernel) is for columns that no block of TD_NCMAX
// chunks holds (kmax > TD_NCMAX L; ops/pres_2.py tdma_form chooses it from
// kmax and the dtype before any launch): one thread per mode marching k
// with the running value in registers, the forward sweep writing the
// spectrum and the backward sweep reading it back (40 B per (mode, level)
// in float32).
//
// K21 tdma_ri: the same march on a spectrum that is split into its real and
// imaginary parts and ALREADY multiplied by dz^2, with the table's columns
// [af, cf] = [-a, -c] as the TPU kernel Pres2._tdma_ri builds them
// (microhh_tpu/ops/pres_2.py:875, pallas_call :898, body _tdma_body :64;
// columns :886-891), writing the solution into two new arrays.  Every mode
// goes through the one launch, the Nyquist column too: the TPU's lane gate
// and its scan for that column fit its vector unit, they are not math.
// Used by Pres2.exec, the projection of the substep without the RK fold.
#include "kmarch.cuh"

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

constexpr int TD_MT = 16;          // modes a block of the scan form
constexpr int TD_NCMAX = 32;       // chunks a mode at most
constexpr int TD_L_F32 = 32;       // levels a chunk of the scan form
constexpr int TD_L_F64 = 16;
constexpr int TD_SWEEP_NT = 256;   // threads a block of the sweep form

template <typename T>
constexpr int td_l() {
    return sizeof(T) == 4 ? TD_L_F32 : TD_L_F64;
}

// the scan form: a block of TD_MT modes by blockDim.y = ceil(kmax / L)
// chunks of L levels
template <typename T, int L>
__global__ void __launch_bounds__(TD_MT * TD_NCMAX)
tdma_scan_kernel(typename Vec2<T>::type* __restrict__ x,
                 const T* __restrict__ winv, const T* __restrict__ tab,
                 int kmax, long long nmodes) {
    using V = typename Vec2<T>::type;
    // each chunk's forward (fa, fr, fi) and backward (ba, br, bi) composite
    __shared__ T fa[TD_NCMAX][TD_MT], fr[TD_NCMAX][TD_MT], fi[TD_NCMAX][TD_MT];
    __shared__ T ba[TD_NCMAX][TD_MT], br[TD_NCMAX][TD_MT], bi[TD_NCMAX][TD_MT];
    const int tx = threadIdx.x, c = threadIdx.y, nc = blockDim.y;
    const long long m = (long long)blockIdx.x * TD_MT + tx;
    const bool live = m < nmodes;
    const int k0 = c * L;
    // the table rows of the chunk's levels, copied ahead of the column
    __shared__ T tb[3 * TD_NCMAX * L];
    for (int q = tx; q < 3 * min(L, kmax - k0); q += TD_MT)
        km::cp_async<sizeof(T)>(tb + 3 * k0 + q, tab + 3 * k0 + q);
    km::commit();
    T yr[L], yi[L], w[L];
#pragma unroll
    for (int j = 0; j < L; ++j) {
        yr[j] = yi[j] = w[j] = T(0);
        if (live && k0 + j < kmax) {
            const long long o = (long long)(k0 + j) * nmodes + m;
            const V d = x[o];
            yr[j] = d.x;
            yi[j] = d.y;
            w[j] = __ldg(winv + o);
        }
    }

    km::wait_all();
    __syncthreads();

    // 1. the forward composite; beta_k in place of x_k
    T a = T(1), r = T(0), i = T(0);
#pragma unroll
    for (int j = 0; j < L; ++j) {
        const int k = k0 + j;
        if (k < kmax) {
            const T al = tb[3 * k] * w[j];
            const T dz2 = tb[3 * k + 2];
            yr[j] = (yr[j] * dz2) * w[j];
            yi[j] = (yi[j] * dz2) * w[j];
            r = al * r + yr[j];
            i = al * i + yi[j];
            a = a * al;
        }
    }
    fa[c][tx] = a;
    fr[c][tx] = r;
    fi[c][tx] = i;
    __syncthreads();

    // 2. the carry-in from the chunks below, bottom up; y_k in place
    r = T(0);
    i = T(0);
    for (int b = 0; b < c; ++b) {
        r = fa[b][tx] * r + fr[b][tx];
        i = fa[b][tx] * i + fi[b][tx];
    }
#pragma unroll
    for (int j = 0; j < L; ++j) {
        const int k = k0 + j;
        if (k < kmax) {
            const T al = tb[3 * k] * w[j];
            r = al * r + yr[j];
            i = al * i + yi[j];
            yr[j] = r;
            yi[j] = i;
        }
    }

    // 3. the backward composite
    a = T(1);
    r = T(0);
    i = T(0);
#pragma unroll
    for (int j = L - 1; j >= 0; --j) {
        const int k = k0 + j;
        if (k < kmax) {
            const T ga = tb[3 * k + 1] * w[j];
            r = yr[j] + ga * r;
            i = yi[j] + ga * i;
            a = a * ga;
        }
    }
    ba[c][tx] = a;
    br[c][tx] = r;
    bi[c][tx] = i;
    __syncthreads();

    // 4. the carry-in from the chunks above, top down; x_k written once
    r = T(0);
    i = T(0);
    for (int b = nc - 1; b > c; --b) {
        r = ba[b][tx] * r + br[b][tx];
        i = ba[b][tx] * i + bi[b][tx];
    }
#pragma unroll
    for (int j = L - 1; j >= 0; --j) {
        const int k = k0 + j;
        if (k < kmax) {
            const T ga = tb[3 * k + 1] * w[j];
            r = yr[j] + ga * r;
            i = yi[j] + ga * i;
            if (live) {
                V out;
                out.x = r;
                out.y = i;
                x[(long long)k * nmodes + m] = out;
            }
        }
    }
}

// sweep != 0: the sweep form; else the scan form, which must hold kmax
template <typename T>
int launch_tdma(void* x, const T* winv, const T* tab, int kmax,
                long long nmodes, int sweep, cudaStream_t stream) {
    if (kmax < 1 || nmodes < 1) return (int)cudaErrorInvalidValue;
    if (sweep) {
        const long long blocks = (nmodes + TD_SWEEP_NT - 1) / TD_SWEEP_NT;
        tdma_kernel<T><<<(unsigned int)blocks, TD_SWEEP_NT, 0, stream>>>(
            (typename Vec2<T>::type*)x, winv, tab, kmax, nmodes);
        return (int)cudaGetLastError();
    }
    const int chunks = (kmax + td_l<T>() - 1) / td_l<T>();
    if (chunks > TD_NCMAX) return (int)cudaErrorInvalidValue;
    const long long blocks = (nmodes + TD_MT - 1) / TD_MT;
    tdma_scan_kernel<T, td_l<T>()>
        <<<(unsigned int)blocks, dim3(TD_MT, chunks), 0, stream>>>(
            (typename Vec2<T>::type*)x, winv, tab, kmax, nmodes);
    return (int)cudaGetLastError();
}

// registers, local bytes, shared memory, blocks an SM and SMs of the sweep
// form (sweep != 0) or of the scan form at its chunks a mode (kmarch.cuh
// kernel_info)
template <typename T>
int tdma_info(int sweep, int chunks, int* out) {
    if (sweep) return km::kernel_info(tdma_kernel<T>, TD_SWEEP_NT, 0, out);
    if (chunks < 1 || chunks > TD_NCMAX) return (int)cudaErrorInvalidValue;
    return km::kernel_info(tdma_scan_kernel<T, td_l<T>()>, TD_MT * chunks, 0,
                           out);
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
                                  int kmax, long long nmodes, int sweep,      \
                                  void* stream) {                             \
        return mhh::launch_tdma<T>(x, (const T*)winv, (const T*)tab, kmax,    \
                                   nmodes, sweep, (cudaStream_t)stream);      \
    }                                                                         \
    extern "C" int mhh_tdma_info_##SUF(int sweep, int chunks, int* out) {     \
        return mhh::tdma_info<T>(sweep, chunks, out);                         \
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
