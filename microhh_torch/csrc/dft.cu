// K5/K6: the horizontal 2-D real DFT pair of the spectral Poisson solve
// (pres_2.cxx:198-263), in the natural mode order of torch.fft.rfft2:
//
//   forward  x (kt, jtot, itot) real  -> y (kt, jtot, itot/2+1) complex
//   inverse  y (kt, jtot, itot/2+1)   -> x (kt, jtot, itot) real, 1/(itot jtot)
//
// Replaces the TPU kernels dft2_fwd / _fwd_body and dft2_inv / _inv_body
// (microhh_tpu/ops/pallas_dft.py:308 and :330, pallas_call :322 and :344).
// Those factor each axis once into r = 3 or 4 residue blocks and do the
// block DFTs as (B x B) matmuls on the MXU, with permuted mode order.  A
// Hopper SM has no matmul unit that pays off at fp32/fp64 for this, so here
// each line is a mixed-radix Stockham FFT in shared memory (radix 8 and 4,
// then 2, 3, 5 and any other prime factor as a direct small DFT), which needs no
// reordering and keeps the modes in natural order; any itot and jtot work.
//
// Bound: device-memory bytes in principle (a 512-point line is ~5 flops
// per point and stage against 16 B of traffic per point and pass), but the
// stages' shared-memory traffic comes close.  Design: a block loads G whole
// lines into shared memory, runs every stage there (radix 8 first, so 512
// points take three stages; the twiddles in a shared table computed in
// double), and writes the lines back once.  Shared-memory indices get one
// pad entry per 128 B, so the stride-R stores of the first stages and the
// stride-line accesses of the j pass spread over the banks.  The i pass
// reads rows, which are contiguous; the j pass reads G adjacent modes of
// every row at once, so its loads and stores are G-element contiguous runs.
// The i passes of an even itot transform the row as itot/2 packed complex
// points (x[2m] + i x[2m+1]) and unpack the modes 0..itot/2 from them,
// which halves their stages and shared memory; an odd itot is transformed
// as complex points.  The inverse drops the imaginary parts of the mean and
// Nyquist modes, as a c2r transform does.
#include <cuda_runtime.h>

#include <initializer_list>

namespace mhh {

constexpr int DFT_THREADS = 256;
constexpr int DFT_MAX_STAGES = 32;
// shared-memory budget per block that sets the lines per block
constexpr size_t DFT_SMEM_BUDGET = 64 * 1024;
constexpr int DFT_MAX_LINES = 16;

struct DftPlan {
    int n;  // line length
    int nstages;
    int radix[DFT_MAX_STAGES];
};

template <typename T>
struct alignas(2 * sizeof(T)) cpx {
    T re, im;
};

template <typename T>
__device__ __forceinline__ cpx<T> cadd(cpx<T> a, cpx<T> b) {
    return {a.re + b.re, a.im + b.im};
}

template <typename T>
__device__ __forceinline__ cpx<T> csub(cpx<T> a, cpx<T> b) {
    return {a.re - b.re, a.im - b.im};
}

template <typename T>
__device__ __forceinline__ cpx<T> cmul(cpx<T> a, cpx<T> b) {
    return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}

// Shared-memory index of logical entry m: one pad entry per 128 B.
template <typename T>
__device__ __forceinline__ int pidx(int m) {
    return m + (m >> (sizeof(T) == 4 ? 4 : 3));
}

// line stride in shared memory for lines of n entries
template <typename T>
__host__ __device__ __forceinline__ int line_stride(int n) {
    return n + (n >> (sizeof(T) == 4 ? 4 : 3)) + 1;
}

// f(g, e) for every g < G and e < m, spread over the block's threads
// without a division per pair
template <typename F>
__device__ __forceinline__ void for_each(int G, int m, F f) {
    const int sg = blockDim.x / m, se = blockDim.x - sg * m;
    int g = threadIdx.x / m, e = threadIdx.x - g * m;
    while (g < G) {
        f(g, e);
        g += sg;
        e += se;
        if (e >= m) {
            e -= m;
            ++g;
        }
    }
}

// W[pidx(m)] = exp(sgn 2 pi i m / n), m < n
template <typename T>
__device__ void twiddles(cpx<T>* W, int n, int sgn) {
    for (int m = threadIdx.x; m < n; m += blockDim.x) {
        double s, c;
        sincospi(2.0 * m / n, &s, &c);
        W[pidx<T>(m)] = {T(c), T(sgn * s)};
    }
    __syncthreads();
}

// in-place 4-point DFT of v[0], v[k], v[2k], v[3k]
template <typename T>
__device__ __forceinline__ void dft4(cpx<T>* v, int k, int sgn) {
    const cpx<T> s02 = cadd(v[0], v[2 * k]), d02 = csub(v[0], v[2 * k]);
    const cpx<T> s13 = cadd(v[k], v[3 * k]), d13 = csub(v[k], v[3 * k]);
    const cpx<T> rot = {-sgn * d13.im, sgn * d13.re};  // sgn*i*d13
    v[0] = cadd(s02, s13);
    v[k] = cadd(d02, rot);
    v[2 * k] = csub(s02, s13);
    v[3 * k] = csub(d02, rot);
}

// Stockham FFT of G lines (line g at a + g*ld) with sign sgn; b is scratch
// of the same layout.  W holds the twiddles of a transform ws times as long
// (W[ws*m] = exp(sgn 2 pi i m / P.n)).  Returns the buffer that holds the
// result.
template <typename T>
__device__ cpx<T>* fft_lines(cpx<T>* a, cpx<T>* b, const cpx<T>* W, int ws,
                             int G, int ld, const DftPlan& P, int sgn) {
    const int n = P.n;
    int Ns = 1;
    for (int st = 0; st < P.nstages; ++st) {
        const int R = P.radix[st];
        const int nR = n / R;
        const int tmul = ws * (n / (Ns * R));
        const bool pow2 = (Ns & (Ns - 1)) == 0;
        for_each(G, nR, [&](int g, int j) {
            const cpx<T>* src = a + g * ld;
            cpx<T>* dst = b + g * ld;
            const int jm = pow2 ? (j & (Ns - 1)) : j % Ns;
            const int tw = jm * tmul;
            const int d = (j - jm) * R + jm;
            auto in = [&](int q) {
                const cpx<T> x = src[pidx<T>(j + q * nR)];
                return q == 0 ? x : cmul(x, W[pidx<T>(q * tw)]);
            };
            auto out = [&](int r, cpx<T> y) { dst[pidx<T>(d + r * Ns)] = y; };
            if (R == 8) {
                cpx<T> v[8];
                for (int q = 0; q < 8; ++q) v[q] = in(q);
                // even and odd halves, then the radix-2 combine with W8^r
                dft4(v, 2, sgn);
                dft4(v + 1, 2, sgn);
                const T c = T(0.70710678118654752440);
                const cpx<T> o1 = cmul(v[3], cpx<T>{c, sgn * c});
                const cpx<T> o2 = {-sgn * v[5].im, sgn * v[5].re};
                const cpx<T> o3 = cmul(v[7], cpx<T>{-c, sgn * c});
                out(0, cadd(v[0], v[1]));
                out(4, csub(v[0], v[1]));
                out(1, cadd(v[2], o1));
                out(5, csub(v[2], o1));
                out(2, cadd(v[4], o2));
                out(6, csub(v[4], o2));
                out(3, cadd(v[6], o3));
                out(7, csub(v[6], o3));
            } else if (R == 4) {
                cpx<T> v[4];
                for (int q = 0; q < 4; ++q) v[q] = in(q);
                dft4(v, 1, sgn);
                for (int r = 0; r < 4; ++r) out(r, v[r]);
            } else if (R == 2) {
                const cpx<T> v0 = in(0), v1 = in(1);
                out(0, cadd(v0, v1));
                out(1, csub(v0, v1));
            } else {
                // direct R-point DFT of the twiddled inputs
                for (int r = 0; r < R; ++r) {
                    cpx<T> acc = {T(0), T(0)};
                    for (int q = 0; q < R; ++q)
                        acc = cadd(acc, cmul(in(q),
                                             W[pidx<T>(ws * ((q * r) % R) * nR)]));
                    out(r, acc);
                }
            }
        });
        __syncthreads();
        cpx<T>* t = a;
        a = b;
        b = t;
        Ns *= R;
    }
    return a;
}

extern __shared__ __align__(16) unsigned char dft_smem[];

// the two line buffers (G lines of m entries) and the twiddle table (n
// entries) of a block
template <typename T>
struct Smem {
    cpx<T>*a, *b, *W;
    int ld;
    __device__ Smem(int m, int G) {
        ld = line_stride<T>(m);
        a = reinterpret_cast<cpx<T>*>(dft_smem);
        b = a + G * ld;
        W = b + G * ld;
    }
};

// forward i pass: rows of x (rows, n) -> modes 0..nf-1 of y (rows, nf).
// Even n: the row is packed into h = n/2 complex points z = x[2m] +
// i x[2m+1], transformed (P is the plan of h), and unpacked with
// X[k] = E + W^k O, E = (Z[k] + conj Z[h-k])/2, O = (Z[k] - conj Z[h-k])/2i.
// Odd n: the row is transformed as complex points with zero imaginary part.
template <typename T>
__global__ void __launch_bounds__(DFT_THREADS)
dft_r2c_x(const T* __restrict__ x, cpx<T>* __restrict__ y, long long rows,
          int n, int nf, DftPlan P, int G) {
    const int m = P.n;
    const bool packed = m != n;
    Smem<T> sm(m, G);
    twiddles(sm.W, n, -1);
    for (long long row0 = (long long)blockIdx.x * G; row0 < rows;
         row0 += (long long)gridDim.x * G) {
        const int gn = (int)(rows - row0 < G ? rows - row0 : G);
        for_each(G, m, [&](int g, int i) {
            cpx<T> v = {T(0), T(0)};
            if (g < gn && packed)
                v = reinterpret_cast<const cpx<T>*>(x + (row0 + g) * n)[i];
            else if (g < gn)
                v.re = x[(row0 + g) * n + i];
            sm.a[g * sm.ld + pidx<T>(i)] = v;
        });
        __syncthreads();
        const cpx<T>* r =
            fft_lines(sm.a, sm.b, sm.W, packed ? 2 : 1, G, sm.ld, P, -1);
        for_each(gn, nf, [&](int g, int f) {
            const cpx<T>* z = r + g * sm.ld;
            cpx<T> out = z[pidx<T>(f % m)];
            if (packed) {
                const cpx<T> zk = out, zc = z[pidx<T>((m - f) % m)];
                const cpx<T> e = {T(0.5) * (zk.re + zc.re),
                                  T(0.5) * (zk.im - zc.im)};
                // (zk - conj zc) / 2i
                const cpx<T> o = {T(0.5) * (zk.im + zc.im),
                                  T(-0.5) * (zk.re - zc.re)};
                out = cadd(e, cmul(sm.W[pidx<T>(f)], o));
            }
            y[(row0 + g) * nf + f] = out;
        });
        __syncthreads();
    }
}

// j pass, in place: for each level k and G adjacent modes, the lines along
// j of y (kt, n, nf) with stride nf
template <typename T>
__global__ void __launch_bounds__(DFT_THREADS)
dft_c2c_y(cpx<T>* __restrict__ y, int kt, int nf, DftPlan P, int G,
          int sgn) {
    const int n = P.n;
    Smem<T> sm(n, G);
    twiddles(sm.W, n, sgn);
    const int groups = (nf + G - 1) / G;
    for (long long blk = blockIdx.x; blk < (long long)kt * groups;
         blk += gridDim.x) {
        const long long k = blk / groups;
        const int f0 = (int)(blk - k * groups) * G;
        const int gn = nf - f0 < G ? nf - f0 : G;
        cpx<T>* base = y + k * n * nf + f0;
        for_each(n, G, [&](int jj, int g) {
            sm.a[g * sm.ld + pidx<T>(jj)] =
                g < gn ? base[(long long)jj * nf + g] : cpx<T>{T(0), T(0)};
        });
        __syncthreads();
        const cpx<T>* r = fft_lines(sm.a, sm.b, sm.W, 1, G, sm.ld, P, sgn);
        for_each(n, gn, [&](int jj, int g) {
            base[(long long)jj * nf + g] = r[g * sm.ld + pidx<T>(jj)];
        });
        __syncthreads();
    }
}

// inverse i pass: modes 0..nf-1 of y (rows, nf) -> real rows of x (rows, n).
// The imaginary parts of the mean and Nyquist modes are dropped.  Even n:
// Z[k] = E + i O with E = (X[k] + conj X[h-k])/2, O = (X[k] - conj X[h-k])/2
// W^-k, whose h-point inverse gives x[2m] + i x[2m+1].  Odd n: the other
// half of the spectrum is filled by Hermitian symmetry and transformed.
template <typename T>
__global__ void __launch_bounds__(DFT_THREADS)
dft_c2r_x(const cpx<T>* __restrict__ y, T* __restrict__ x, long long rows,
          int n, int nf, DftPlan P, int G, T scale) {
    const int m = P.n;
    const bool packed = m != n;
    Smem<T> sm(m, G);
    twiddles(sm.W, n, 1);
    for (long long row0 = (long long)blockIdx.x * G; row0 < rows;
         row0 += (long long)gridDim.x * G) {
        const int gn = (int)(rows - row0 < G ? rows - row0 : G);
        for_each(G, m, [&](int g, int f) {
            cpx<T> v = {T(0), T(0)};
            if (g < gn) {
                const cpx<T>* row = y + (row0 + g) * nf;
                if (packed) {
                    cpx<T> xk = row[f], xc = row[m - f];
                    if (f == 0) xk.im = xc.im = T(0);
                    xc.im = -xc.im;
                    const cpx<T> e = {T(0.5) * (xk.re + xc.re),
                                      T(0.5) * (xk.im + xc.im)};
                    const cpx<T> d = {T(0.5) * (xk.re - xc.re),
                                      T(0.5) * (xk.im - xc.im)};
                    const cpx<T> o = cmul(d, sm.W[pidx<T>(f)]);
                    v = {e.re - o.im, e.im + o.re};
                } else {
                    if (f < nf) {
                        v = row[f];
                    } else {
                        v = row[n - f];
                        v.im = -v.im;
                    }
                    if (f == 0) v.im = T(0);
                }
            }
            sm.a[g * sm.ld + pidx<T>(f)] = v;
        });
        __syncthreads();
        const cpx<T>* r =
            fft_lines(sm.a, sm.b, sm.W, packed ? 2 : 1, G, sm.ld, P, 1);
        for_each(gn, m, [&](int g, int i) {
            const cpx<T> z = r[g * sm.ld + pidx<T>(i)];
            if (packed)
                reinterpret_cast<cpx<T>*>(x + (row0 + g) * n)[i] =
                    {z.re * scale, z.im * scale};
            else
                x[(row0 + g) * n + i] = z.re * scale;
        });
        __syncthreads();
    }
}

// ---------------------------------------------------------------------------
//  host side
// ---------------------------------------------------------------------------

static bool make_plan(int n, DftPlan* P) {
    P->n = n;
    P->nstages = 0;
    if (n < 1) return false;
    int m = n;
    for (int r : {8, 4}) {
        while (m % r == 0) {
            if (P->nstages == DFT_MAX_STAGES) return false;
            P->radix[P->nstages++] = r;
            m /= r;
        }
    }
    for (int p = 2; m > 1; ++p) {
        while (m % p == 0) {
            if (P->nstages == DFT_MAX_STAGES) return false;
            P->radix[P->nstages++] = p;
            m /= p;
        }
    }
    return true;
}

// Lines per block G and the dynamic shared memory for it: two buffers of G
// padded lines of m entries and a padded twiddle table of n entries.
template <typename T>
static size_t lines_per_block(int m, int n, int* G) {
    const size_t cs = sizeof(cpx<T>);
    const long long ld = line_stride<T>(m), wn = line_stride<T>(n);
    long long g = ((long long)(DFT_SMEM_BUDGET / cs) - wn) / (2 * ld);
    if (g > DFT_MAX_LINES) g = DFT_MAX_LINES;
    if (g < 1) g = 1;
    *G = (int)g;
    return (size_t)(2 * g * ld + wn) * cs;
}

// Opt in to more than 48 KiB of shared memory when needed, and return the
// grid: one block per group of lines, at most as many as fit on the card
// at once (the kernels loop over the rest, so each block computes its
// twiddle table once).
template <typename K>
static int prepare(K kernel, size_t smem, long long groups, unsigned* grid) {
    int rc = 0;
    if (smem > 48 * 1024)
        rc = (int)cudaFuncSetAttribute(
            (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
    int dev = 0, sms = 0, per_sm = 0;
    if (!rc) rc = (int)cudaGetDevice(&dev);
    if (!rc) rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (!rc)
        rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, DFT_THREADS, smem);
    if (!rc && per_sm < 1) rc = (int)cudaErrorInvalidConfiguration;
    const long long cap = (long long)sms * per_sm;
    *grid = (unsigned)(groups < cap ? groups : cap);
    return rc;
}

// the plan of an i pass: h = n/2 packed points for even n, else n
static bool plan_x(int n, DftPlan* P) {
    return make_plan(n % 2 == 0 ? n / 2 : n, P);
}

template <typename T>
static int launch_c2c_y(cpx<T>* y, int kt, int jtot, int nf, int sgn,
                        cudaStream_t stream) {
    DftPlan P;
    if (!make_plan(jtot, &P)) return (int)cudaErrorInvalidValue;
    int G;
    const size_t smem = lines_per_block<T>(jtot, jtot, &G);
    unsigned grid;
    if (int rc = prepare(dft_c2c_y<T>, smem, (long long)kt * ((nf + G - 1) / G),
                         &grid))
        return rc;
    dft_c2c_y<T><<<grid, DFT_THREADS, smem, stream>>>(y, kt, nf, P, G, sgn);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_dft_fwd(const T* x, cpx<T>* y, int kt, int jtot, int itot,
                   cudaStream_t stream) {
    DftPlan P;
    if (!plan_x(itot, &P)) return (int)cudaErrorInvalidValue;
    int G;
    const size_t smem = lines_per_block<T>(P.n, itot, &G);
    const int nf = itot / 2 + 1;
    const long long rows = (long long)kt * jtot;
    unsigned grid;
    if (int rc = prepare(dft_r2c_x<T>, smem, (rows + G - 1) / G, &grid))
        return rc;
    dft_r2c_x<T><<<grid, DFT_THREADS, smem, stream>>>(x, y, rows, itot, nf, P,
                                                      G);
    if (int rc = (int)cudaGetLastError()) return rc;
    return launch_c2c_y<T>(y, kt, jtot, nf, -1, stream);
}

template <typename T>
int launch_dft_inv(cpx<T>* y, T* x, int kt, int jtot, int itot,
                   cudaStream_t stream) {
    const int nf = itot / 2 + 1;
    if (int rc = launch_c2c_y<T>(y, kt, jtot, nf, 1, stream)) return rc;
    DftPlan P;
    if (!plan_x(itot, &P)) return (int)cudaErrorInvalidValue;
    int G;
    const size_t smem = lines_per_block<T>(P.n, itot, &G);
    const long long rows = (long long)kt * jtot;
    unsigned grid;
    if (int rc = prepare(dft_c2r_x<T>, smem, (rows + G - 1) / G, &grid))
        return rc;
    // the unnormalised transforms of the two axes, over P.n and jtot points
    dft_c2r_x<T><<<grid, DFT_THREADS, smem, stream>>>(
        y, x, rows, itot, nf, P, G, T(1.0 / ((double)P.n * jtot)));
    return (int)cudaGetLastError();
}

}  // namespace mhh

// x real (kt, jtot, itot) -> y complex (kt, jtot, itot/2+1)
// y complex (kt, jtot, itot/2+1), overwritten -> x real (kt, jtot, itot)
#define MHH_DFT(SUF, T)                                                       \
    extern "C" int mhh_dft_fwd_##SUF(const void* x, void* y, int kt,         \
                                     int jtot, int itot, void* stream) {      \
        return mhh::launch_dft_fwd<T>((const T*)x, (mhh::cpx<T>*)y, kt, jtot, \
                                      itot, (cudaStream_t)stream);            \
    }                                                                         \
    extern "C" int mhh_dft_inv_##SUF(void* y, void* x, int kt, int jtot,     \
                                     int itot, void* stream) {                \
        return mhh::launch_dft_inv<T>((mhh::cpx<T>*)y, (T*)x, kt, jtot, itot, \
                                      (cudaStream_t)stream);                  \
    }

MHH_DFT(f32, float)
MHH_DFT(f64, double)
