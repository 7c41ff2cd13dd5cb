// K11: the Seifert-Beheng two-moment warm-rain scheme (reference
// microphys_2mom_warm.cxx:89-238): autoconversion, accretion, evaporation,
// selfcollection and breakup, and the Stevens-Seifert (2008) slope-limited
// sedimentation of qr and nr with its top-down positivity limiter.  Adds
// the tendencies of qr, nr, qt and thl to the carry in place and writes
// the surface rain rate rr_bot.
//
// Replaces the TPU kernel Micro2Fused._call / _micro2_body
// (microhh_tpu/ops/microphys_pallas.py:371, pallas_call :412).  Its plain
// version is the op path in ops/microphys.py (micro2_plain).
//
// Bound: 13 passes over a field (qr, nr, qt, thl, ql read; four tendencies
// read and written), 2.94 GB at rico 384^3 in f32, 0.88 ms at 3.35 TB/s.
// The work is transcendental (pow, exp, log and ~20 divisions a point,
// without fast math), so instruction issue bounds it above that: the
// bodies of its phases (a), (b), (b)'s gather at nsed = 4 and (d) hold
// about 1.8k SASS instructions a point in f32 and 2.4k in f64
// (ring_timing.micro2_issue), some 3.1 and 4.1 ms of issue at rico 384^3
// on an H100 if each issued once; their inline slow paths (IEEE division,
// special cases of pow, exp and log) rarely run, so that is an upper
// estimate of the issue work.
// Only the limiter is a recurrence down the column (running mass S and
// running minimum M, the closed form ft = S + min(0, cummin(ftot - S)));
// everything else at row k is a function of rows k-1 .. k+nsed-1.
//
// Design: a block owns M2_C = 32 adjacent columns of one j-row (one warp
// wide, so every row access is one coalesced segment) and the whole
// column height, so no block waits on another; 256 threads.  It marches the
// column top-down in windows of M2_W levels; in each window
//   (a) each warp takes every eighth level of the window: rain properties,
//       fall speeds and process rates; qt's and thl's tendencies added in
//       place; qr, nr, the fall speeds and the process parts of qr's and
//       nr's tendencies to shared memory; and the rain properties of the
//       row below the window (clamped to row 0 at the bottom), so no row
//       waits on the next window;
//   (b) slopes and CFL numbers of the window's levels, then the nsed-deep
//       flux gather ftot of both species from shared memory, the rows above
//       the window's top coming from a history of NSED_MAX-1 rows kept from
//       the previous windows;
//   (c) two warps (a column and species a thread) run S and M over the
//       window, carried in registers from window to window, and leave the
//       flux in shared memory; meanwhile the other warps copy the history
//       rows and stage the next window's table rows;
//   (d) each warp its levels again: the flux divergence plus the process
//       parts into qr's and nr's tendencies; the thread at k = 0 writes
//       rr_bot.
// A level's point physics is one long dependent chain, so the kernel is
// built for warps in flight rather than for ILP: the level loops are not
// unrolled (a level at a time, its state in shared memory), the window is
// 16 levels so that a block's shared memory lets 6 blocks (48 warps) sit
// on an SM in f32 and 3 in f64, the launch bounds hold the registers to
// that, and the window's first phase prefetches the next window's lines
// into L2.  PERF.md section 6 has the variants measured against each
// other.  The per-level table rows of a window are staged in shared memory
// once.  The k-1 and k+1 inputs are clamped to the interior like the TPU
// kernel's `rev` index maps (microphys_pallas.py:378-388): qr and nr above
// the top are the top row's, the fall speed there is 0; rows above the top
// enter the gather as zeros.  The nr sweep advances its CFL with dzi at the output row
// (microphys_2mom_warm.cxx:508).  cbrt(x) stands for pow(x, 1/3) of the
// plain version (within its tolerances in both types).  Built without fast
// math: the single-precision error against the plain version is set by
// pow, exp and log and by the limiter's running sums.
#include <cuda_runtime.h>
#include <math.h>

#include "kmarch.cuh"

namespace mhh {

enum { M_RHO, M_RHODZ, M_DZ, M_DZI, M_P, M_EXN, M_LVCPE, M_SQR, M_RHON,
       M_RRHO, NM };
constexpr int NSED_MAX = 8;

constexpr int M2_W = 16;                  // levels a window
constexpr int M2_C = 32;                  // columns a block (one warp wide)
constexpr int M2_NT = 256;                // threads a block
constexpr int M2_WARPS = M2_NT / M2_C;    // warps a block
constexpr int M2_HIST = NSED_MAX - 1;     // rows above a window a gather reaches
constexpr int M2_H = M2_HIST + M2_W + 1;  // rows above, the window, the row below
static_assert(M2_W % M2_WARPS == 0 && M2_W >= M2_HIST, "window");

// shared memory of a block; a buffer row br holds level ktop + M2_HIST - br
// of a window whose top level is ktop (the window's row r at br = M2_HIST + r)
template <typename T>
struct M2Smem {
    T a[2][M2_H][M2_C];        // qr, nr
    T w[2][M2_W + 2][M2_C];    // fall speeds: the row above, window, row below
    T sl[2][M2_H - 1][M2_C];   // slopes: rows above and window
    T c[2][M2_H - 1][M2_C];    // CFL numbers: rows above and window
    T f[2][M2_W][M2_C];        // ftot, then the limited flux
    T p[2][M2_W][M2_C];        // process parts of the qr and nr tendencies
    T fa[2][M2_C];             // flux of the row above the window
    T tb[2][NM][M2_H];         // table rows, two windows
};

// SB06 / SS08 constants (ops/microphys.py)
constexpr double RHO_0 = 1.225, QL_MIN = 1.e-6, QR_MIN = 1.e-15;
constexpr double X_STAR = 2.6e-10, MR_MIN = 2.6e-10, MR_MAX = 3e-6;
constexpr double PIRHOW = 3.141592653589793 * 1.e3 / 6.;
constexpr double D_V = 3.e-5, K_T = 2.5e-2;
constexpr double W_MAX = 9.65, A_R = 9.65, C_R = 600.;
constexpr double Lv = 2.501e6, cp = 1005., Rd = 287.04, Rv = 461.5;
constexpr double ep = Rd / Rv, T0 = 273.15, dsmall = 1.e-9;

template <typename T>
__device__ __forceinline__ T sq(T x) { return x * x; }

template <typename T>
__device__ __forceinline__ T esat_liq(T temp) {
    const T c[11] = {T(6.1121000000E+02), T(4.4393067270E+01),
                     T(1.4279398448E+00), T(2.6415206946E-02),
                     T(3.0291749160E-04), T(2.1159987257E-06),
                     T(7.5015702516E-09), T(-1.5604873363E-12),
                     T(-9.9726710231E-14), T(-4.8165754883E-17),
                     T(1.3839187032E-18)};
    const T x = fmax(T(-75.), temp - T(T0));
    T acc = c[10];
#pragma unroll
    for (int n = 9; n >= 0; --n) acc = c[n] + x * acc;
    return acc;
}

template <typename T>
__device__ __forceinline__ T qsat_liq(T p, T temp) {
    const T es = esat_liq(temp);
    return T(ep) * es / (p - (T(1) - T(ep)) * es);
}

template <typename T>
__device__ __forceinline__ T minmod(T x, T y) {
    const T s = T((x > T(0)) - (x < T(0)));
    return s * fmax(T(0), fmin(fabs(x), s * y));
}

// rain properties and fall speeds of one point (microphys.calc_rain_props,
// _sedi_pow_pair and the fall-speed clip)
template <typename T>
struct Rain {
    T mr, dr, lamr, wq, wn;
};

template <typename T>
__device__ __forceinline__ Rain<T> rain(T qr, T nr, T rho, T rho_n, T B_R) {
    Rain<T> r;
    T mr = rho * qr / fmax(nr, T(1));
    mr = fmin(fmax(mr, T(MR_MIN)), T(MR_MAX));
    const T dr = cbrt(mr / T(PIRHOW));
    const T x = T(1200) * (dr - T(0.0015));
    const T mur = T(10) * (T(1) + x * (T(27) + x * x) / (T(27) + T(9) * x * x));
    const T lamr = cbrt((mur + T(3)) * (mur + T(2)) * (mur + T(1))) / dr;
    const T b = T(1) + T(C_R) / lamr;
    const T p4 = exp(-(mur + T(4)) * log(b));
    const T p1 = p4 * (b * b * b);
    const bool has_qr = qr > T(QR_MIN);
    r.mr = mr;
    r.dr = dr;
    r.lamr = lamr;
    r.wq = has_qr ? fmin(fmax(rho_n * T(A_R) - B_R * p4, T(0.1)), T(W_MAX)) : T(0);
    r.wn = has_qr ? fmin(fmax(rho_n * T(A_R) - B_R * p1, T(0.1)), T(W_MAX)) : T(0);
    return r;
}

template <typename T>
__global__ void __launch_bounds__(M2_NT, sizeof(T) == 4 ? 6 : 3)
micro2_kernel(const T* __restrict__ qr_f, const T* __restrict__ nr_f,
              const T* __restrict__ qt_f, const T* __restrict__ thl_f,
              T* __restrict__ tqr, T* __restrict__ tnr, T* __restrict__ tqt,
              T* __restrict__ tthl, const T* __restrict__ ql_f,
              T* __restrict__ rr_bot, const T* __restrict__ cc, int itot,
              int jtot, int kt, int ks, int nsed, T Nc0, T dt) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    M2Smem<T>& s = *reinterpret_cast<M2Smem<T>*>(smem_raw);
    const int tid = threadIdx.x;
    const int lane = tid % M2_C, warp = tid / M2_C;
    const int i = blockIdx.x * M2_C + lane;
    const bool live = i < itot;
    const long long plane = (long long)itot * jtot;
    const long long col = (long long)blockIdx.y * itot + i;
    auto at = [&](int k) { return (long long)(ks + k) * plane + col; };

    const T B_R = T(A_R * exp(C_R * 25.0e-6));
    const T nu_c = T(1), k_cc = T(9.44e9);
    const T kccxs = k_cc / (T(20) * T(X_STAR)) * (nu_c + T(2)) * (nu_c + T(4))
                    / sq(nu_c + T(1));
    const T k_rr = T(7.12), kappa_rr = T(60.7), D_eq = T(0.9e-3);
    const T pirhow_13 = T(pow(PIRHOW, 1. / 3.));

    // table rows of the window whose top level is ktop into buffer b
    auto stage = [&](int b, int ktop, int t0, int nt) {
        for (int idx = t0; idx < NM * M2_H; idx += nt) {
            const int m = idx / M2_H, br = idx - m * M2_H;
            const int k = min(max(ktop + M2_HIST - br, 0), kt - 1);
            s.tb[b][m][br] = cc[k * NM + m];
        }
    };
    for (int idx = tid; idx < M2_HIST * M2_C; idx += M2_NT) {
        const int br = idx / M2_C, c = idx - br * M2_C;
        for (int sp = 0; sp < 2; ++sp)
            s.a[sp][br][c] = s.sl[sp][br][c] = s.c[sp][br][c] = T(0);
    }
    stage(0, kt - 1, tid, M2_NT);
    __syncthreads();

    // L2 prefetch of the window whose top level is ktop: the block's lines
    // of the nine fields it reads and writes, a (field, level) a thread
    auto prefetch = [&](int ktop) {
        const int nrows = min(M2_W, ktop + 1);
        const long long c0 = (long long)blockIdx.y * itot + blockIdx.x * M2_C;
        const int last = min(M2_C, itot - (int)blockIdx.x * M2_C) - 1;
        for (int idx = tid; idx < 9 * nrows; idx += M2_NT) {
            const int fi = idx / nrows, k = ktop - (idx - fi * nrows);
            const T* f = fi == 0 ? qr_f : fi == 1 ? nr_f : fi == 2 ? qt_f
                : fi == 3 ? thl_f : fi == 4 ? tqr : fi == 5 ? tnr
                : fi == 6 ? tqt : fi == 7 ? tthl : ql_f;
            const T* p = f + (long long)(fi == 8 ? k : ks + k) * plane + c0;
            asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
            asm volatile("prefetch.global.L2 [%0];" ::"l"(p + last));
        }
    };

    // the limiter state of the scan threads (tid < 2 M2_C: species tid / M2_C)
    T S_run = T(0), M_run = T(INFINITY), flux_above = T(0);
    const int nwin = (kt + M2_W - 1) / M2_W;
    for (int win = 0; win < nwin; ++win) {
        const int ktop = kt - 1 - win * M2_W;
        const int nrows = min(M2_W, ktop + 1);
        const T (*tb)[M2_H] = s.tb[win & 1];
        if (win + 1 < nwin) prefetch(ktop - M2_W);

        // ---- (a) rain properties and process rates of the window's
        // levels and the rain properties of the row below the window
        // (level ktop - nrows, clamped to row 0), one level a warp at a time
#pragma unroll 1
        for (int r = warp; r <= nrows && live; r += M2_WARPS) {
            const bool below = r == nrows;
            const int k = below ? max(ktop - nrows, 0) : ktop - r;
            const int br = M2_HIST + r;
            const T qr = qr_f[at(k)], nr = nr_f[at(k)];
            const T rho = tb[M_RHO][br];
            const Rain<T> rc = rain(qr, nr, rho, tb[M_RHON][br], B_R);
            s.a[0][br][lane] = qr;
            s.a[1][br][lane] = nr;
            s.w[0][r + 1][lane] = rc.wq;
            s.w[1][r + 1][lane] = rc.wn;
            if (below) continue;
            const T qt = qt_f[at(k)], thl = thl_f[at(k)];
            const T ql = ql_f[(long long)k * plane + col];
            const T p = tb[M_P][br], exn = tb[M_EXN][br];
            const T lv_cpe = tb[M_LVCPE][br], sq_rho = tb[M_SQR][br];
            T qrt = T(0), nrt = T(0), qtt = T(0), thlt = T(0);
            // autoconversion (SB06 eq 4)
            const bool has_ql = ql > T(QL_MIN);
            const T xc = rho * ql / Nc0;
            const T tau = T(1) - ql / (ql + qr + T(dsmall));
            const T t68 = pow(tau, T(0.68));
            const T phi_au = T(600) * t68 * (sq(T(1) - t68) * (T(1) - t68));
            T au = T(RHO_0) * kccxs * sq(ql) * sq(xc) * (T(1) + phi_au / sq(T(1) - tau));
            au = has_ql ? au : T(0);
            qrt += au;
            nrt += au * rho / T(X_STAR);
            qtt -= au;
            thlt += lv_cpe * au;

            // accretion (SB06 eq 7)
            const bool has_both = has_ql && qr > T(QR_MIN);
            const T tau_ac = T(1) - ql / fmax(ql + qr, T(dsmall));
            const T phi_ac = sq(sq(tau_ac / (tau_ac + T(5e-5))));
            T ac = T(5.25) * ql * qr * phi_ac * sq_rho;
            ac = has_both ? ac : T(0);
            qrt += ac;
            qtt -= ac;
            thlt += lv_cpe * ac;

            // evaporation
            const bool has_qr = qr > T(QR_MIN);
            const T temp = thl * exn + T(Lv) * ql / (T(cp) * exn);
            const T Glv = T(1) / (T(Rv) * temp / (esat_liq(temp) * T(D_V))
                                  + (T(Lv) / (T(K_T) * temp)) * (T(Lv) / (T(Rv) * temp) - T(1)));
            const T Ssat = (qt - ql) / qsat_liq(p, temp) - T(1);
            T ev = T(2. * 3.141592653589793) * rc.dr * Glv * Ssat * nr / rho;
            ev = has_qr ? ev : T(0);
            qrt += ev;
            nrt += ev * rho / rc.mr;
            qtt -= ev;
            thlt += lv_cpe * ev;

            // selfcollection and breakup (SB06 p49-50)
            const T sc_b = T(1) + kappa_rr / rc.lamr * pirhow_13;
            const T sc_b2 = sq(sc_b), sc_b4 = sq(sc_b2);
            T sc = -k_rr * nr * qr * rho / (sq(sc_b4) * sc_b) * sq_rho;
            sc = has_qr ? sc : T(0);
            const T dDr = rc.dr - D_eq;
            const T phi_br = rc.dr <= D_eq ? T(1.0e3) * dDr : T(2) * exp(T(2.3e3) * dDr) - T(1);
            const T br_ = (has_qr && rc.dr > T(0.35e-3)) ? -(phi_br + T(1)) * sc : T(0);
            nrt += sc + br_;

            s.p[0][r][lane] = qrt;
            s.p[1][r][lane] = nrt;
            tqt[at(k)] += qtt;
            tthl[at(k)] += thlt;
        }
        __syncthreads();

        // ---- (b) slopes and CFL numbers of the window's levels ----
#pragma unroll 1
        for (int r = warp; r < nrows && live; r += M2_WARPS) {
            const int k = ktop - r, br = M2_HIST + r;
            const bool top = k == kt - 1;   // above: qr, nr clamped, w = 0
            const T dzi = tb[M_DZI][br];
#pragma unroll
            for (int sp = 0; sp < 2; ++sp) {
                const T a = s.a[sp][br][lane], a_m = s.a[sp][br + 1][lane];
                const T a_p = top ? a : s.a[sp][br - 1][lane];
                s.sl[sp][br][lane] = minmod(a - a_m, a_p - a);
                const T w_p = top ? T(0) : s.w[sp][r][lane];
                s.c[sp][br][lane] = T(0.25) * (s.w[sp][r + 2][lane]
                                               + T(2) * s.w[sp][r + 1][lane] + w_p) * dzi * dt;
            }
        }
        __syncthreads();

        // ---- (b) the nsed-deep flux gather of rows k .. k+nsed-1 ----
#pragma unroll 1
        for (int r = warp; r < nrows && live; r += M2_WARPS) {
            const int k = ktop - r, br = M2_HIST + r;
            const T dzi = tb[M_DZI][br];
#pragma unroll
            for (int sp = 0; sp < 2; ++sp) {
                const bool dzi_at_out = sp == 1;
                T ccm = fmin(T(1), s.c[sp][br][lane]);
                T dzz = T(0), ftot = T(0);
#pragma unroll
                for (int m = 0; m < NSED_MAX; ++m) {
                    if (m < nsed) {
                        const bool valid = k + m <= kt - 1;   // row k+m exists
                        const int bm = br - m;
                        const T a_m = valid ? s.a[sp][bm][lane] : T(0);
                        const T sl_m = valid ? s.sl[sp][bm][lane] : T(0);
                        const T rhodz_m = valid ? tb[M_RHODZ][bm] : T(0);
                        const T dz_m = valid ? tb[M_DZ][bm] : T(0);
                        const bool active = ccm > T(0);
                        if (active) {
                            ftot = ftot + rhodz_m * (a_m + T(0.5) * sl_m * (T(1) - ccm)) * ccm;
                            dzz = dzz + dz_m;
                        }
                        if (m + 1 < nsed) {
                            const T dzi_nxt = dzi_at_out ? dzi
                                : (k + m + 1 <= kt - 1 ? tb[M_DZI][bm - 1] : T(0));
                            const T c_m = valid ? s.c[sp][bm][lane] : T(0);
                            ccm = active ? fmin(T(1), c_m - dzz * dzi_nxt) : T(0);
                        }
                    }
                }
                s.f[sp][r][lane] = ftot;
            }
        }
        __syncthreads();

        // ---- (c) the limiter's running sums; history and next table ----
        if (tid < 2 * M2_C) {
            const int sp = warp;
            if (live) {
                s.fa[sp][lane] = flux_above;
                for (int r = 0; r < nrows; ++r) {
                    const int br = M2_HIST + r;
                    const T mass = tb[M_RHODZ][br] * s.a[sp][br][lane];
                    S_run = S_run + mass;
                    M_run = fmin(M_run, s.f[sp][r][lane] - S_run);
                    const T ft = S_run + fmin(T(0), M_run);
                    flux_above = -ft / dt;
                    s.f[sp][r][lane] = flux_above;
                }
            }
        } else if (win + 1 < nwin) {
            // the window's last M2_HIST rows become the rows above the next
            const int t0 = tid - 2 * M2_C, nt = M2_NT - 2 * M2_C;
            for (int idx = t0; idx < M2_HIST * M2_C; idx += nt) {
                const int br = idx / M2_C, c = idx - br * M2_C;
                for (int sp = 0; sp < 2; ++sp) {
                    s.a[sp][br][c] = s.a[sp][M2_W + br][c];
                    s.sl[sp][br][c] = s.sl[sp][M2_W + br][c];
                    s.c[sp][br][c] = s.c[sp][M2_W + br][c];
                }
            }
            for (int idx = t0; idx < 2 * M2_C; idx += nt) {
                const int sp = idx / M2_C, c = idx - sp * M2_C;
                s.w[sp][0][c] = s.w[sp][M2_W][c];
            }
            stage((win + 1) & 1, ktop - M2_W, t0, nt);
        }
        __syncthreads();

        // ---- (d) the flux divergence into the qr and nr tendencies ----
#pragma unroll 1
        for (int r = warp; r < nrows && live; r += M2_WARPS) {
            const int k = ktop - r, br = M2_HIST + r;
            const T rrho = tb[M_RRHO][br], dzi = tb[M_DZI][br];
            const T fq = s.f[0][r][lane], fn = s.f[1][r][lane];
            const T fq_above = r == 0 ? s.fa[0][lane] : s.f[0][r - 1][lane];
            const T fn_above = r == 0 ? s.fa[1][lane] : s.f[1][r - 1][lane];
            tqr[at(k)] += s.p[0][r][lane] + -(fq_above - fq) * rrho * dzi;
            tnr[at(k)] += s.p[1][r][lane] + -(fn_above - fn) * rrho * dzi;
            if (k == 0) rr_bot[col] = -fq;
        }
        // no barrier: the next window's (a) writes no row that (d) reads
        // but its own thread's process parts, and reads the table rows
        // staged in (c)
    }
}

template <typename T>
int launch_micro2(const T* qr, const T* nr, const T* qt, const T* thl,
                  T* tqr, T* tnr, T* tqt, T* tthl, const T* ql, T* rr,
                  const T* cc, int itot, int jtot, int kt, int ks, int nsed,
                  double Nc0, double dt, cudaStream_t stream) {
    if (nsed < 1 || nsed > NSED_MAX) return (int)cudaErrorInvalidValue;
    const size_t smem = sizeof(M2Smem<T>);
    int rc = (int)cudaFuncSetAttribute(
        micro2_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc) return rc;
    const dim3 grid((itot + M2_C - 1) / M2_C, jtot);
    micro2_kernel<T><<<grid, M2_NT, smem, stream>>>(
        qr, nr, qt, thl, tqr, tnr, tqt, tthl, ql, rr, cc, itot, jtot, kt, ks,
        nsed, T(Nc0), T(dt));
    return (int)cudaGetLastError();
}

}  // namespace mhh

#define MHH_MICRO2(SUF, T)                                                    \
    extern "C" int mhh_micro2_##SUF(                                          \
        const void* qr, const void* nr, const void* qt, const void* thl,      \
        void* tqr, void* tnr, void* tqt, void* tthl, const void* ql,          \
        void* rr, const void* cc, int itot, int jtot, int kt, int ks,         \
        int nsed, double Nc0, double dt, void* stream) {                      \
        return mhh::launch_micro2<T>(                                         \
            (const T*)qr, (const T*)nr, (const T*)qt, (const T*)thl,          \
            (T*)tqr, (T*)tnr, (T*)tqt, (T*)tthl, (const T*)ql, (T*)rr,        \
            (const T*)cc, itot, jtot, kt, ks, nsed, Nc0, dt,                  \
            (cudaStream_t)stream);                                            \
    }                                                                         \
    extern "C" int mhh_micro2_info_##SUF(int scheme, int S, int* out) {       \
        return mhh::km::kernel_info(mhh::micro2_kernel<T>, mhh::M2_NT,        \
                                    sizeof(mhh::M2Smem<T>), out);             \
    }

MHH_MICRO2(f32, float)
MHH_MICRO2(f64, double)
