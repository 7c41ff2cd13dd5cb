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
// One thread owns one (j, i) column and walks k from the top down, as the
// TPU kernel's grid does: the flux at row k gathers the <= nsed rows above
// it, and the limiter is a top-down recurrence (running mass S and running
// minimum M, the closed form ft = S + min(0, cummin(ftot - S))).  The rows
// above live in shift registers (a, slope, cfl of both species, NSED_MAX
// deep, indices fixed at compile time); fall speeds at k-1 are computed one
// row early so the half-weight CFL interpolation never waits on a row
// below, and the rain properties of row k ride from the previous row.  The
// k-1 and k+1 inputs are clamped to the interior like the TPU kernel's
// `rev` index maps (microphys_pallas.py:378-388).  The nr sweep advances
// its CFL with dzi at the output row (microphys_2mom_warm.cxx:508).
//
// Bound: per point ~10 transcendentals (pow, exp, log, sqrt) and ~300
// flops on 8 reads and 4 read-modify-writes of 4 B in f32 (~48 B, ~2.7 GB
// at 384^3): near the balance of the card, so the math matters as much as
// the bytes.  Design: one pass; every field is read once (the k+-1 rows are
// kept in registers) and coalesced across the warp's columns.  Built
// without fast math: the single-precision error against the plain version
// is set by pow, exp and log and by the limiter's running sums.
#include <cuda_runtime.h>
#include <math.h>

namespace mhh {

enum { M_RHO, M_RHODZ, M_DZ, M_DZI, M_P, M_EXN, M_LVCPE, M_SQR, M_RHON,
       M_RRHO, NM };
constexpr int NSED_MAX = 8;

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
    const T dr = pow(mr / T(PIRHOW), T(1. / 3.));
    const T x = T(1200) * (dr - T(0.0015));
    const T mur = T(10) * (T(1) + x * (T(27) + x * x) / (T(27) + T(9) * x * x));
    const T lamr = pow((mur + T(3)) * (mur + T(2)) * (mur + T(1)), T(1. / 3.)) / dr;
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

// one species' rows k .. k+NSED_MAX-1 (a, slope, CFL) and limiter state
template <typename T>
struct Sed {
    T a[NSED_MAX], sl[NSED_MAX], c[NSED_MAX];
    T S, M, flux_above;
};

template <typename T>
__device__ __forceinline__ void push(Sed<T>& q, T a, T sl, T c) {
#pragma unroll
    for (int m = NSED_MAX - 1; m > 0; --m) {
        q.a[m] = q.a[m - 1];
        q.sl[m] = q.sl[m - 1];
        q.c[m] = q.c[m - 1];
    }
    q.a[0] = a;
    q.sl[0] = sl;
    q.c[0] = c;
}

// limited flux divergence at row k (g = kt-1-k rows lie above it); returns
// the tendency and sets flux_k
template <typename T>
__device__ __forceinline__ T sed_tend(Sed<T>& q, const T* __restrict__ cc,
                                      int k, int g, int kt, int nsed,
                                      bool dzi_at_out, T dt, T& flux_k) {
    const T dzi = cc[k * NM + M_DZI];
    T ccm = fmin(T(1), q.c[0]);
    T dzz = T(0), ftot = T(0);
#pragma unroll
    for (int m = 0; m < NSED_MAX; ++m) {
        if (m < nsed) {
            const bool valid = m <= g;     // row k+m exists
            const int row_m = min(k + m, kt - 1);
            const T a_m = valid ? q.a[m] : T(0);
            const T sl_m = valid ? q.sl[m] : T(0);
            const T rhodz_m = valid ? cc[row_m * NM + M_RHODZ] : T(0);
            const T dz_m = valid ? cc[row_m * NM + M_DZ] : T(0);
            const bool active = ccm > T(0);
            if (active) {
                ftot = ftot + rhodz_m * (a_m + T(0.5) * sl_m * (T(1) - ccm)) * ccm;
                dzz = dzz + dz_m;
            }
            const T dzi_nxt = dzi_at_out ? dzi
                : (m + 1 <= g ? cc[min(k + m + 1, kt - 1) * NM + M_DZI] : T(0));
            const T c_m = valid ? q.c[m] : T(0);
            ccm = active ? fmin(T(1), c_m - dzz * dzi_nxt) : T(0);
        }
    }
    const T mass = cc[k * NM + M_RHODZ] * q.a[0];
    const T S_run = q.S + mass;
    const T M_run = fmin(q.M, ftot - S_run);
    const T ft = S_run + fmin(T(0), M_run);
    flux_k = -ft / dt;
    const T tend = -(q.flux_above - flux_k) * cc[k * NM + M_RRHO] * dzi;
    q.S = S_run;
    q.M = M_run;
    q.flux_above = flux_k;
    return tend;
}

template <typename T>
__global__ void __launch_bounds__(128)
micro2_kernel(const T* __restrict__ qr_f, const T* __restrict__ nr_f,
              const T* __restrict__ qt_f, const T* __restrict__ thl_f,
              T* tqr, T* tnr, T* tqt, T* tthl, const T* __restrict__ ql_f,
              T* __restrict__ rr_bot, const T* __restrict__ cc, int itot,
              int jtot, int kt, int ks, int nsed, T Nc0, T dt) {
    const long long plane = (long long)itot * jtot;
    const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (col >= plane) return;
    auto at = [&](int k) { return (long long)(ks + k) * plane + col; };

    // rows k+1 (clamped) and k of qr, nr; the top row bootstraps the rings
    const int ktop = kt - 1;
    T qr_p = qr_f[at(ktop)], nr_p = nr_f[at(ktop)];
    T qr_c = qr_p, nr_c = nr_p;
    const T B_R = T(A_R * exp(C_R * 25.0e-6));
    Rain<T> rc = rain(qr_c, nr_c, cc[ktop * NM + M_RHO], cc[ktop * NM + M_RHON], B_R);
    T wq_c = rc.wq, wn_c = rc.wn, wq_p = T(0), wn_p = T(0);   // w(kt) = 0
    Sed<T> sq_, sn_;
#pragma unroll
    for (int m = 0; m < NSED_MAX; ++m) {
        sq_.a[m] = sq_.sl[m] = sq_.c[m] = T(0);
        sn_.a[m] = sn_.sl[m] = sn_.c[m] = T(0);
    }
    sq_.S = sn_.S = T(0);
    sq_.M = sn_.M = T(INFINITY);
    sq_.flux_above = sn_.flux_above = T(0);

    const T nu_c = T(1), k_cc = T(9.44e9);
    const T kccxs = k_cc / (T(20) * T(X_STAR)) * (nu_c + T(2)) * (nu_c + T(4))
                    / sq(nu_c + T(1));
    const T k_rr = T(7.12), kappa_rr = T(60.7), D_eq = T(0.9e-3);
    const T pirhow_13 = T(pow(PIRHOW, 1. / 3.));

    for (int g = 0; g < kt; ++g) {
        const int k = ktop - g;
        const int km = k > 0 ? k - 1 : 0;
        const T* ck = cc + k * NM;
        const T rho = ck[M_RHO], dzi = ck[M_DZI], p = ck[M_P], exn = ck[M_EXN];
        const T lv_cpe = ck[M_LVCPE], sq_rho = ck[M_SQR];

        // ---- fall speeds at k-1, one row early ----
        const T qr_m = qr_f[at(km)], nr_m = nr_f[at(km)];
        const Rain<T> rm = rain(qr_m, nr_m, cc[km * NM + M_RHO], cc[km * NM + M_RHON], B_R);
        const T cq = T(0.25) * (rm.wq + T(2) * wq_c + wq_p) * dzi * dt;
        const T cn = T(0.25) * (rm.wn + T(2) * wn_c + wn_p) * dzi * dt;

        const T qr = qr_c, nr = nr_c;
        const T qt = qt_f[at(k)], thl = thl_f[at(k)];
        const T ql = ql_f[(long long)k * plane + col];
        T qrt = T(0), nrt = T(0), qtt = T(0), thlt = T(0);

        // ---- autoconversion (SB06 eq 4) ----
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

        // ---- accretion (SB06 eq 7) ----
        const bool has_both = has_ql && qr > T(QR_MIN);
        const T tau_ac = T(1) - ql / fmax(ql + qr, T(dsmall));
        const T phi_ac = sq(sq(tau_ac / (tau_ac + T(5e-5))));
        T ac = T(5.25) * ql * qr * phi_ac * sq_rho;
        ac = has_both ? ac : T(0);
        qrt += ac;
        qtt -= ac;
        thlt += lv_cpe * ac;

        // ---- evaporation ----
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

        // ---- selfcollection and breakup (SB06 p49-50) ----
        const T sc_b = T(1) + kappa_rr / rc.lamr * pirhow_13;
        const T sc_b2 = sq(sc_b), sc_b4 = sq(sc_b2);
        T sc = -k_rr * nr * qr * rho / (sq(sc_b4) * sc_b) * sq_rho;
        sc = has_qr ? sc : T(0);
        const T dDr = rc.dr - D_eq;
        const T phi_br = rc.dr <= D_eq ? T(1.0e3) * dDr : T(2) * exp(T(2.3e3) * dDr) - T(1);
        const T br = (has_qr && rc.dr > T(0.35e-3)) ? -(phi_br + T(1)) * sc : T(0);
        nrt += sc + br;

        // ---- SS08 sedimentation ----
        push(sq_, qr, minmod(qr - qr_m, qr_p - qr), cq);
        push(sn_, nr, minmod(nr - nr_m, nr_p - nr), cn);
        T flux_q, flux_n;
        qrt += sed_tend(sq_, cc, k, g, kt, nsed, false, dt, flux_q);
        nrt += sed_tend(sn_, cc, k, g, kt, nsed, true, dt, flux_n);

        tqr[at(k)] += qrt;
        tnr[at(k)] += nrt;
        tqt[at(k)] += qtt;
        tthl[at(k)] += thlt;
        if (k == 0) rr_bot[col] = -flux_q;

        // ---- move down one row ----
        wq_p = wq_c;
        wn_p = wn_c;
        wq_c = rm.wq;
        wn_c = rm.wn;
        rc = rm;
        qr_p = qr_c;
        nr_p = nr_c;
        qr_c = qr_m;
        nr_c = nr_m;
    }
}

template <typename T>
int launch_micro2(const T* qr, const T* nr, const T* qt, const T* thl,
                  T* tqr, T* tnr, T* tqt, T* tthl, const T* ql, T* rr,
                  const T* cc, int itot, int jtot, int kt, int ks, int nsed,
                  double Nc0, double dt, cudaStream_t stream) {
    if (nsed < 1 || nsed > NSED_MAX) return (int)cudaErrorInvalidValue;
    const long long cols = (long long)itot * jtot;
    const int block = 128;
    const unsigned grid = (unsigned)((cols + block - 1) / block);
    micro2_kernel<T><<<grid, block, 0, stream>>>(
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
    }

MHH_MICRO2(f32, float)
MHH_MICRO2(f64, double)
