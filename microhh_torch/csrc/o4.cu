// K16 and K17: the 4th-order DNS stack's advection (advec_4 or advec_4m)
// plus diffusion (diff_4) added into the RK carry in one pass per field
// group (reference src/advec_4.cxx, src/advec_4m.cxx, src/diff_4.cxx).
//
// K16 o4_mom: tu, tv, tw += advection of (u, v, w with conservation-type
// ghosts) + visc * diffusion of (u, v, w with plain ghosts).  Replaces the
// momentum call of O4FusedPallas._core (microhh_tpu/ops/o4_pallas.py:391,
// pallas_call :408; body _o4_mom_body :252).
// K17 o4_scalars: each of S scalars' carry += its advection + svisc * its
// diffusion, with u, v and four w planes read once for all of them.
// Replaces the scalar call (:435; body _o4_scalar_body :319).
//
// Horizontal: 4-tap interpolations (ci) and flux divergences (cg) chained
// to a reach of i +- 3 and j +- 3, and the 7-point second derivative (cdg),
// all periodic.  Vertical: the fields are ghost-filled to three levels, so
// planes k-3..k+3 are read as they are; row r of the table cc
// (ops/o4_fused.py build_o4_tables) holds six tap weights of the
// interpolation and of the gradient (metric folded in) at one half level
// (cell family) or centre (w family), with the bi/ti/bg/tg wall rows, so a
// tap that a wall row does not use has weight zero.  The 4m scheme (M)
// replaces the interpolated fluxes by velocity times two-point means, with
// mirrored fluxes at the walls.
//
// Bound: K16 reads u, v, both w and reads and writes three carries, 10 x
// 4 B a point in f32, and does about 840 operations a point (640 in 4m):
// bytes and operations bind about equally on an H100.  K17 reads 3 + 2S
// fields and writes S, about 215 operations a scalar and point (130 in 4m).
// Design (K12/K13's): a block of OI x OJ threads owns an (OJ, OI) tile and
// marches in k; each field keeps a ring of seven (OJ+6) x (OI+6) planes
// (tile + 3-cell periodic halo) in dynamic shared memory: 94 KB for K16's
// four rings in f32, 187 KB in f64.  The thread's own vertical column of
// seven values is copied to registers once per field and level.  K17 keeps
// one ring per scalar and reads u, v (i-1..i+2, j-1..j+2) and w (k-1..k+2)
// straight from global memory; the wrapper splits the scalars over
// launches when their rings exceed a block's shared memory.  The carries
// are updated in place.
#include "common.cuh"

namespace mhh {
namespace o4 {

// table columns (ops/o4_fused.py)
enum { TXA = 0, TG = 6, TWC = 12, TGW = 18, DZI4 = 24, DZHI4 = 25, WMASK = 26,
       NC = 27 };

constexpr int OI = 32;
constexpr int OJ = 16;
constexpr int OH = 3;
constexpr int WI = OI + 2 * OH;
constexpr int WJ = OJ + 2 * OH;
constexpr int NR = 7;
constexpr int MAXS = 8;

extern __shared__ __align__(16) unsigned char o4_smem[];

__device__ __forceinline__ int slot7(int p) { return (p + NR) % NR; }

template <typename T>
__device__ __forceinline__ void load_tile7(T (*sh)[WI], const T* __restrict__ a,
                                           long long level, int j0, int i0,
                                           int jtot, int itot) {
    const long long base = level * (long long)jtot * itot;
    for (int idx = threadIdx.y * OI + threadIdx.x; idx < WJ * WI;
         idx += OI * OJ) {
        const int r = idx / WI;
        const int c = idx - r * WI;
        const int jg = wrap(j0 + r - OH, jtot);
        const int ig = wrap(i0 + c - OH, itot);
        sh[r][c] = __ldg(a + base + (long long)jg * itot + ig);
    }
}

// one field's seven-plane ring seen from the thread's point
template <typename T>
struct View7 {
    const T (*ring)[WJ][WI];
    int r, c;
    __device__ __forceinline__ T operator()(int s, int dj, int di) const {
        return ring[s][r + dj][c + di];
    }
};

template <typename T>
__device__ __forceinline__ View7<T> view7(const T (*ring)[WJ][WI]) {
    return View7<T>{ring, (int)threadIdx.y + OH, (int)threadIdx.x + OH};
}

// ci interpolation and cg gradient of four consecutive values
template <typename T>
__device__ __forceinline__ T interp4(T a, T b, T c, T d) {
    return T(-1. / 16.) * a + T(9. / 16.) * b + T(9. / 16.) * c
           + T(-1. / 16.) * d;
}

template <typename T>
__device__ __forceinline__ T grad4(T a, T b, T c, T d) {
    return T(1. / 24.) * a + T(-27. / 24.) * b + T(27. / 24.) * c
           + T(-1. / 24.) * d;
}

// plane s of Q interpolated to i-1/2 (ixh) or j-1/2 (jyh) at offset (dj, di)
template <typename T>
__device__ __forceinline__ T ixh(const View7<T>& Q, int s, int dj, int di) {
    return interp4(Q(s, dj, di - 2), Q(s, dj, di - 1), Q(s, dj, di),
                   Q(s, dj, di + 1));
}

template <typename T>
__device__ __forceinline__ T jyh(const View7<T>& Q, int s, int dj, int di) {
    return interp4(Q(s, dj - 2, di), Q(s, dj - 1, di), Q(s, dj, di),
                   Q(s, dj + 1, di));
}

// flux divergence along one axis: f(d) is the flux at offset d - 1/2
template <typename T, typename F>
__device__ __forceinline__ T div4(F f) {
    return grad4<T>(f(-1), f(0), f(1), f(2));
}

// the 4m form along one axis: vel(d) the advecting velocity at offset
// d - 1/2, q(d) the transported quantity at offset d
template <typename T, typename FV, typename FQ>
__device__ __forceinline__ T flux4(FV vel, FQ q) {
    const T h = T(0.5), q0 = q(0);
    const T a = vel(-1) * h * (q(-3) + q0);
    const T b = vel(0) * h * (q(-1) + q0);
    const T c = vel(1) * h * (q0 + q(1));
    const T d = vel(2) * h * (q0 + q(3));
    return T(1. / 24.) * (d - a) + T(-27. / 24.) * (c - b);
}

// 7-point horizontal second derivative of plane s at the point
template <typename T>
__device__ __forceinline__ T lap_h(const View7<T>& Q, int s, T dxidxi,
                                   T dyidyi) {
    const T c0 = T(-1460. / 576.), c1 = T(783. / 576.), c2 = T(-54. / 576.),
            c3 = T(1. / 576.);
    const T q0 = Q(s, 0, 0);
    return (c3 * (Q(s, 0, -3) + Q(s, 0, 3)) + c2 * (Q(s, 0, -2) + Q(s, 0, 2))
            + c1 * (Q(s, 0, -1) + Q(s, 0, 1)) + c0 * q0) * dxidxi
           + (c3 * (Q(s, -3, 0) + Q(s, 3, 0)) + c2 * (Q(s, -2, 0) + Q(s, 2, 0))
              + c1 * (Q(s, -1, 0) + Q(s, 1, 0)) + c0 * q0) * dyidyi;
}

// Cell family: sum_e cg_e * V_e * X_e with X_e the six-tap row at half level
// k-1+e (table row k+e) applied to the column q[0..6] = planes k-3..k+3;
// vel = nullptr gives the gradient (diffusion) form.  Taps outside the
// window have zero weight by construction and are skipped.
template <typename T>
__device__ __forceinline__ T vd_cell(const T* __restrict__ cc, int k, int base,
                                     const T* q, const T* vel) {
    T x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        const T* row = cc + (long long)(k + e) * NC + base;
        T acc = T(0);
#pragma unroll
        for (int d = -3; d < 3; ++d) {
            const int off = e - 1 + d;
            if (off < -3 || off > 3) continue;
            acc = acc + row[d + 3] * q[off + 3];
        }
        x[e] = vel ? vel[e] * acc : acc;
    }
    return grad4(x[0], x[1], x[2], x[3]);
}

// w family: sum_e cg_e * Y_e with Y_e the six-tap row at centre k-2+e (table
// row k-1+e, clamped at the wall where the output is masked); SQ squares the
// interpolant (w's self-advection flux).
template <bool SQ, typename T>
__device__ __forceinline__ T vd_w(const T* __restrict__ cc, int k, int base,
                                  const T* w) {
    T x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        const int r = k - 1 + e;
        const T* row = cc + (long long)(r < 0 ? 0 : r) * NC + base;
        T acc = T(0);
#pragma unroll
        for (int d = -2; d < 4; ++d) {
            const int off = e - 2 + d;
            if (off < -3 || off > 3) continue;
            acc = acc + row[d + 2] * w[off + 3];
        }
        x[e] = SQ ? acc * acc : acc;
    }
    return grad4(x[0], x[1], x[2], x[3]);
}

// 4m, cell target at level k: -grad4 of the half-position fluxes, with the
// mirrored negative outer flux at the walls; wv[e] at half level k-1+e
template <typename T>
__device__ __forceinline__ T vert4m_cell(int k, int kt, const T* q,
                                         const T* wv) {
    const T h = T(0.5), q0 = q[3];
    T a = wv[0] * h * (q[0] + q0);
    const T b = wv[1] * h * (q[2] + q0);
    const T c = wv[2] * h * (q0 + q[4]);
    T d = wv[3] * h * (q0 + q[6]);
    if (k == 0) a = -wv[2] * h * (q[2] + q[5]);
    if (k == kt - 1) d = -wv[1] * h * (q[1] + q[4]);
    return T(1. / 24.) * (d - a) + T(-27. / 24.) * (c - b);
}

// 4m, w target at half level k: centre-located fluxes
template <typename T>
__device__ __forceinline__ T vert4m_w(const T* w) {
    const T h = T(0.5), w0 = w[3];
    const T a = interp4(w[0], w[1], w[2], w[3]) * h * (w[0] + w0);
    const T b = interp4(w[1], w[2], w[3], w[4]) * h * (w[2] + w0);
    const T c = interp4(w[2], w[3], w[4], w[5]) * h * (w0 + w[4]);
    const T d = interp4(w[3], w[4], w[5], w[6]) * h * (w0 + w[6]);
    return T(1. / 24.) * (d - a) + T(-27. / 24.) * (c - b);
}

template <typename T, bool M>
__global__ void __launch_bounds__(OI * OJ)
o4_mom_kernel(const T* __restrict__ u, const T* __restrict__ v,
              const T* __restrict__ wc, const T* __restrict__ wd, T* tu, T* tv,
              T* tw, const T* __restrict__ cc, int itot, int jtot, int ktot,
              int ks, T dxi, T dyi, T visc) {
    // rings: u, v, w with conservation ghosts, w with plain ghosts
    T (*sh)[NR][WJ][WI] = reinterpret_cast<T (*)[NR][WJ][WI]>(o4_smem);
    const int i0 = blockIdx.x * OI, j0 = blockIdx.y * OJ;
    const int i = i0 + threadIdx.x, j = j0 + threadIdx.y;
    const bool inside = i < itot && j < jtot;
    const long long plane = (long long)itot * jtot;
    const View7<T> U = view7<T>(sh[0]), V = view7<T>(sh[1]),
                   WC = view7<T>(sh[2]), WD = view7<T>(sh[3]);
    const T dxidxi = dxi * dxi, dyidyi = dyi * dyi;

    auto load = [&](int p) {
        const int s = slot7(p);
        load_tile7(sh[0][s], u, ks + p, j0, i0, jtot, itot);
        load_tile7(sh[1][s], v, ks + p, j0, i0, jtot, itot);
        load_tile7(sh[2][s], wc, ks + p, j0, i0, jtot, itot);
        load_tile7(sh[3][s], wd, ks + p, j0, i0, jtot, itot);
    };

    for (int p = -3; p < 3; ++p) load(p);
    for (int k = 0; k < ktot; ++k) {
        load(k + 3);
        __syncthreads();
        if (inside) {
            int sl[NR];
#pragma unroll
            for (int n = 0; n < NR; ++n) sl[n] = slot7(k - 3 + n);
            const int s0 = sl[3];
            const T* row = cc + (long long)k * NC;
            const T dzi4 = row[DZI4], dzhi4 = row[DZHI4];
            const long long o = (long long)(ks + k) * plane + (long long)j * itot + i;

            // ---- u ----
            {
                T q[NR], vel[4];
#pragma unroll
                for (int n = 0; n < NR; ++n) q[n] = U(sl[n], 0, 0);
                // w at the half levels k-1..k+2, interpolated to the u point
#pragma unroll
                for (int e = 0; e < 4; ++e) vel[e] = ixh(WC, sl[2 + e], 0, 0);
                T t;
                if (!M) {
                    t = -div4<T>([&](int d) {
                            const T g = ixh(U, s0, 0, d);
                            return g * g;
                        }) * dxi;
                    t = t - div4<T>([&](int d) {
                                return ixh(V, s0, d, 0) * jyh(U, s0, d, 0);
                            }) * dyi;
                    t = t - vd_cell(cc, k, TXA, q, vel) * dzi4;
                } else {
                    t = flux4<T>([&](int d) { return ixh(U, s0, 0, d); },
                                 [&](int d) { return U(s0, 0, d); }) * dxi;
                    t = t + flux4<T>([&](int d) { return ixh(V, s0, d, 0); },
                                     [&](int d) { return U(s0, d, 0); }) * dyi;
                    t = t + vert4m_cell(k, ktot, q, vel) * dzi4;
                }
                t = t + visc * (lap_h(U, s0, dxidxi, dyidyi)
                                + vd_cell<T>(cc, k, TG, q, nullptr) * dzi4);
                tu[o] = tu[o] + t;
            }
            // ---- v ----
            {
                T q[NR], vel[4];
#pragma unroll
                for (int n = 0; n < NR; ++n) q[n] = V(sl[n], 0, 0);
#pragma unroll
                for (int e = 0; e < 4; ++e) vel[e] = jyh(WC, sl[2 + e], 0, 0);
                T t;
                if (!M) {
                    t = -div4<T>([&](int d) {
                            return jyh(U, s0, 0, d) * ixh(V, s0, 0, d);
                        }) * dxi;
                    t = t - div4<T>([&](int d) {
                                const T g = jyh(V, s0, d, 0);
                                return g * g;
                            }) * dyi;
                    t = t - vd_cell(cc, k, TXA, q, vel) * dzi4;
                } else {
                    t = flux4<T>([&](int d) { return jyh(U, s0, 0, d); },
                                 [&](int d) { return V(s0, 0, d); }) * dxi;
                    t = t + flux4<T>([&](int d) { return jyh(V, s0, d, 0); },
                                     [&](int d) { return V(s0, d, 0); }) * dyi;
                    t = t + vert4m_cell(k, ktot, q, vel) * dzi4;
                }
                t = t + visc * (lap_h(V, s0, dxidxi, dyidyi)
                                + vd_cell<T>(cc, k, TG, q, nullptr) * dzi4);
                tv[o] = tv[o] + t;
            }
            // ---- w at half level k; k = 0 is the wall ----
            if (k > 0) {
                T q[NR];
#pragma unroll
                for (int n = 0; n < NR; ++n) q[n] = WC(sl[n], 0, 0);
                // u and v interpolated to the half level k
                auto uzh = [&](int dj, int di) {
                    return interp4(U(sl[1], dj, di), U(sl[2], dj, di),
                                   U(sl[3], dj, di), U(sl[4], dj, di));
                };
                auto vzh = [&](int dj, int di) {
                    return interp4(V(sl[1], dj, di), V(sl[2], dj, di),
                                   V(sl[3], dj, di), V(sl[4], dj, di));
                };
                T t;
                if (!M) {
                    t = -div4<T>([&](int d) {
                            return uzh(0, d) * ixh(WC, s0, 0, d);
                        }) * dxi;
                    t = t - div4<T>([&](int d) {
                                return vzh(d, 0) * jyh(WC, s0, d, 0);
                            }) * dyi;
                    t = t - vd_w<true>(cc, k, TWC, q) * dzhi4;
                } else {
                    t = flux4<T>([&](int d) { return uzh(0, d); },
                                 [&](int d) { return WC(s0, 0, d); }) * dxi;
                    t = t + flux4<T>([&](int d) { return vzh(d, 0); },
                                     [&](int d) { return WC(s0, d, 0); }) * dyi;
                    t = t + vert4m_w(q) * dzhi4;
                }
#pragma unroll
                for (int n = 0; n < NR; ++n) q[n] = WD(sl[n], 0, 0);
                t = t + visc * (lap_h(WD, s0, dxidxi, dyidyi)
                                + vd_w<false>(cc, k, TGW, q) * dzhi4);
                tw[o] = tw[o] + t;
            }
        }
        __syncthreads();
    }
}

// the scalars', their carries' pointers and their viscosities, by value
template <typename T>
struct Scalars {
    const T* a[MAXS];
    T* ta[MAXS];
    T svisc[MAXS];
};

template <typename T, bool M>
__global__ void __launch_bounds__(OI * OJ)
o4_scalars_kernel(const T* __restrict__ u, const T* __restrict__ v,
                  const T* __restrict__ wc, const Scalars<T> sc, int S,
                  const T* __restrict__ cc, int itot, int jtot, int ktot,
                  int ks, T dxi, T dyi) {
    // one ring per scalar
    T (*sh)[NR][WJ][WI] = reinterpret_cast<T (*)[NR][WJ][WI]>(o4_smem);
    const int i0 = blockIdx.x * OI, j0 = blockIdx.y * OJ;
    const int i = i0 + threadIdx.x, j = j0 + threadIdx.y;
    const bool inside = i < itot && j < jtot;
    const long long plane = (long long)itot * jtot;
    const T dxidxi = dxi * dxi, dyidyi = dyi * dyi;
    const long long o2 = (long long)j * itot + i;
    // offsets -1..2 of the point along i and j, periodic
    long long oi[4], oj[4];
#pragma unroll
    for (int d = 0; d < 4; ++d) {
        oi[d] = (long long)j * itot + wrap(i + d - 1, itot);
        oj[d] = (long long)wrap(j + d - 1, jtot) * itot + i;
    }

    auto load = [&](int p) {
        const int s = slot7(p);
        for (int n = 0; n < S; ++n)
            load_tile7(sh[n][s], sc.a[n], ks + p, j0, i0, jtot, itot);
    };

    for (int p = -3; p < 3; ++p) load(p);
    for (int k = 0; k < ktot; ++k) {
        load(k + 3);
        __syncthreads();
        if (inside) {
            int sl[NR];
#pragma unroll
            for (int n = 0; n < NR; ++n) sl[n] = slot7(k - 3 + n);
            const int s0 = sl[3];
            const T* row = cc + (long long)k * NC;
            const T dzi4 = row[DZI4];
            const long long lev = (long long)(ks + k) * plane;
            // u at i-1..i+2, v at j-1..j+2, w at the half levels k-1..k+2
            T ux[4], vy[4], wv[4];
#pragma unroll
            for (int d = 0; d < 4; ++d) {
                ux[d] = __ldg(u + lev + oi[d]);
                vy[d] = __ldg(v + lev + oj[d]);
                wv[d] = __ldg(wc + lev + (long long)(d - 1) * plane + o2);
            }
            for (int n = 0; n < S; ++n) {
                const View7<T> A = view7<T>(sh[n]);
                T q[NR];
#pragma unroll
                for (int m = 0; m < NR; ++m) q[m] = A(sl[m], 0, 0);
                T t;
                if (!M) {
                    t = -div4<T>([&](int d) {
                            return ux[d + 1] * ixh(A, s0, 0, d);
                        }) * dxi;
                    t = t - div4<T>([&](int d) {
                                return vy[d + 1] * jyh(A, s0, d, 0);
                            }) * dyi;
                    t = t - vd_cell(cc, k, TXA, q, wv) * dzi4;
                } else {
                    t = flux4<T>([&](int d) { return ux[d + 1]; },
                                 [&](int d) { return A(s0, 0, d); }) * dxi;
                    t = t + flux4<T>([&](int d) { return vy[d + 1]; },
                                     [&](int d) { return A(s0, d, 0); }) * dyi;
                    t = t + vert4m_cell(k, ktot, q, wv) * dzi4;
                }
                t = t + sc.svisc[n] * (lap_h(A, s0, dxidxi, dyidyi)
                                       + vd_cell<T>(cc, k, TG, q, nullptr) * dzi4);
                sc.ta[n][lev + o2] = sc.ta[n][lev + o2] + t;
            }
        }
        __syncthreads();
    }
}

template <typename K>
static int raise_smem(K kernel, size_t smem) {
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, bool M>
int launch_mom(const T* u, const T* v, const T* wc, const T* wd, T* tu, T* tv,
               T* tw, const T* cc, int itot, int jtot, int ktot, int ks,
               double dxi, double dyi, double visc, cudaStream_t stream) {
    const size_t smem = (size_t)4 * NR * WJ * WI * sizeof(T);
    if (int rc = raise_smem(o4_mom_kernel<T, M>, smem)) return rc;
    const dim3 block(OI, OJ);
    const dim3 grid((itot + OI - 1) / OI, (jtot + OJ - 1) / OJ);
    o4_mom_kernel<T, M><<<grid, block, smem, stream>>>(
        u, v, wc, wd, tu, tv, tw, cc, itot, jtot, ktot, ks, T(dxi), T(dyi),
        T(visc));
    return (int)cudaGetLastError();
}

template <typename T, bool M>
int launch_scalars(const T* u, const T* v, const T* wc, const Scalars<T>& sc,
                   int S, const T* cc, int itot, int jtot, int ktot, int ks,
                   double dxi, double dyi, cudaStream_t stream) {
    const size_t smem = (size_t)S * NR * WJ * WI * sizeof(T);
    if (int rc = raise_smem(o4_scalars_kernel<T, M>, smem)) return rc;
    const dim3 block(OI, OJ);
    const dim3 grid((itot + OI - 1) / OI, (jtot + OJ - 1) / OJ);
    o4_scalars_kernel<T, M><<<grid, block, smem, stream>>>(
        u, v, wc, sc, S, cc, itot, jtot, ktot, ks, T(dxi), T(dyi));
    return (int)cudaGetLastError();
}

// scheme: 0 = advec 4, 1 = advec 4m (ops/o4_fused.py SCHEME_ID).  The
// fields need three ghost levels (ks >= 3).
template <typename T>
int mom(const T* u, const T* v, const T* wc, const T* wd, T* tu, T* tv, T* tw,
        const T* cc, int itot, int jtot, int ktot, int ks, int scheme,
        double dxi, double dyi, double visc, cudaStream_t stream) {
    if (ks < OH || scheme < 0 || scheme > 1) return (int)cudaErrorInvalidValue;
    if (scheme == 0)
        return launch_mom<T, false>(u, v, wc, wd, tu, tv, tw, cc, itot, jtot,
                                    ktot, ks, dxi, dyi, visc, stream);
    return launch_mom<T, true>(u, v, wc, wd, tu, tv, tw, cc, itot, jtot, ktot,
                               ks, dxi, dyi, visc, stream);
}

template <typename T>
int scalars(const T* u, const T* v, const T* wc, const void* const* a,
            void* const* ta, const double* sviscs, int S, const T* cc,
            int itot, int jtot, int ktot, int ks, int scheme, double dxi,
            double dyi, cudaStream_t stream) {
    if (S < 1 || S > MAXS || ks < OH || scheme < 0 || scheme > 1)
        return (int)cudaErrorInvalidValue;
    Scalars<T> sc;
    for (int n = 0; n < MAXS; ++n) {
        sc.a[n] = n < S ? (const T*)a[n] : nullptr;
        sc.ta[n] = n < S ? (T*)ta[n] : nullptr;
        sc.svisc[n] = n < S ? T(sviscs[n]) : T(0);
    }
    if (scheme == 0)
        return launch_scalars<T, false>(u, v, wc, sc, S, cc, itot, jtot, ktot,
                                        ks, dxi, dyi, stream);
    return launch_scalars<T, true>(u, v, wc, sc, S, cc, itot, jtot, ktot, ks,
                                   dxi, dyi, stream);
}

}  // namespace o4
}  // namespace mhh

#define MHH_O4(SUF, T)                                                        \
    extern "C" int mhh_o4_mom_##SUF(                                          \
        const void* u, const void* v, const void* wc, const void* wd,         \
        void* tu, void* tv, void* tw, const void* cc, int itot, int jtot,     \
        int ktot, int ks, int scheme, double dxi, double dyi, double visc,    \
        void* stream) {                                                       \
        return mhh::o4::mom<T>((const T*)u, (const T*)v, (const T*)wc,        \
                               (const T*)wd, (T*)tu, (T*)tv, (T*)tw,          \
                               (const T*)cc, itot, jtot, ktot, ks, scheme,    \
                               dxi, dyi, visc, (cudaStream_t)stream);         \
    }                                                                         \
    extern "C" int mhh_o4_scalars_##SUF(                                      \
        const void* u, const void* v, const void* wc, const void* const* a,   \
        void* const* ta, const double* sviscs, int S, const void* cc,         \
        int itot, int jtot, int ktot, int ks, int scheme, double dxi,         \
        double dyi, void* stream) {                                           \
        return mhh::o4::scalars<T>((const T*)u, (const T*)v, (const T*)wc, a, \
                                   ta, sviscs, S, (const T*)cc, itot, jtot,   \
                                   ktot, ks, scheme, dxi, dyi,                \
                                   (cudaStream_t)stream);                     \
    }

MHH_O4(f32, float)
MHH_O4(f64, double)
