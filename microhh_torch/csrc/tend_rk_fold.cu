// K22: the folded form of the dry RK sweep.  One k-march computes what K1,
// K2 and K4 rhs compute in three: the Smagorinsky eddy viscosity, advec_2 +
// Smagorinsky diffusion + dry buoyancy + static sponge + geostrophic
// Coriolis term of u, v, w, th with the low-storage RK update folded in
// (s* = s + cB*dt*t_total, carry = cA_next*t_total), and the Poisson
// right-hand side dti * div(rho s*).  The eddy viscosity e(k) is written out
// as well: the MOST wall patches read it and the step keeps it in aux.
// cB*dt and dti are read from device scalars (the step's, taken on the
// card), so that a launch captured in a CUDA graph reads each step's value.
//
// Replaces the TPU kernel FusedLES2.tendencies_rk in its tiled fold_ghosts
// form (microhh_tpu/ops/pallas_fused.py:1875, call :2073, body
// _all_tiled_rk_ev_body :910) and, with e_in given (the eddy viscosity read
// instead of computed), the same sweep without the evisc fold (call :2108,
// bodies _all_tiled_rk_ring_body :824 and _all_tiled_rk_body :1137 under
// want_rhs).  Fields are read raw with clamped k neighbours (u, v, th to
// [ks, ke-1], w to [ks, ke]); a null th gives the has_thermo=False form.
//
// Bound: device-memory bytes (4 fields and 4 carries in, 4 s*, 4 carries, e
// and rhs out: 72 B a point in f32, 2.88 ms at 512^3 on an H100) against
// ~900 operations a point; but a ring kernel of this length is held by
// instruction issue first: the PR-6 form issued ~1500 SASS instructions a
// point and level (8.3 ms), much of it ring-slot and address arithmetic,
// the table read from device memory by every thread and a fifth tendency
// on two of its eight warps.  The design cuts the issue:
//
// Design (the k-march of kmarch.cuh).  A block of K22_TJ warps owns a
// (K22_TJ, 32) tile and marches one chunk [k0, k1) of the levels
// (chunk_bounds; ops/kmarch.py picks the count so that the grid fills the
// card in whole waves).
// * The rhs of a cell needs u* at i+1 and v* at j+1, which belong to the
//   neighbouring tiles, so the block computes u* one column and v* one row
//   beyond its tile itself; the eddy viscosity is therefore needed on the
//   tile plus one cell and the fields on the tile plus two.  That halo work
//   is spread so that no warp takes two passes of one kind: the 84 points of
//   e's ring a thread each of warps 0-2, v* beyond by warp K22_VW, u*
//   beyond by eight threads of warp K22_UW.  (A ninth warp for the halo
//   work left 72 registers in f32 and 96 in f64, with spills, and ran 4%
//   slower in f32 and 26% in f64 on an H100.)
// * Shared memory holds the fields' planes k-1 .. k+4 clamped (six slots of
//   the four fields, 16-byte cp.async where the tile lies inside the plane,
//   at PlaneLoader's offsets, shared by the four fields), their staged
//   table rows, e's planes k-1 .. k+2 and u*, v* of the last two levels.
//   At level k the block issues plane k+4, computes e(k+2) (from planes
//   k+1 .. k+3) into the slot nobody reads, the tendencies of level k from
//   e(k-1 .. k+1) and the rhs of level k-1 from u*, v* of that level: one
//   commit group and one barrier a level.  A plane's slot advances by one a
//   level (a uniform register), a field's offset in it is an immediate.
// * A thread keeps its own column of u, v, w, th and e at k-1, k, k+1 in
//   registers (KV), the next level's values and the four carries loaded a
//   level ahead; only the neighbours in the plane come from shared memory.
// * The staged row carries the quotients the point functions would divide
//   at every point (dzi/rho, dzhi/rhoh, g/threfh, g/thref: les_math.cuh
//   QRow), divided once a level by four threads; th is a template flag.
// * The chunk warms up e(k0-1 .. k0+1) from planes k0-2 .. k0+3 (e(0) is the
//   MOST surface row when one is given, e(-1) repeats e(0), e(ktot) repeats
//   e(ktot-1); with e_in the eddy viscosity is read as it is).  rhs(k1-1)
//   needs w*(k1), which belongs to the chunk above: the chunk computes w's
//   tendency at k1 itself (no store but the rhs; w*(ke) = 0), so w's carry
//   is read from tw_in and written to tw_out, different buffers whenever
//   both happen (the chunk above overwrites tw(k1)), as u's and v's are
//   (read one cell inside the neighbouring tiles).  th's carry is updated in
//   place.
// * Everything is periodic, so a partial tile computes its virtual points
//   (i >= itot or j >= jtot wrap around) like any other and only guards its
//   writes.
// Shared memory is dynamic: 55.4 KB in f32 (three blocks an SM), 110.8 KB
// in f64 (two).
#include "kmarch.cuh"
#include "les_math.cuh"

namespace mhh {

constexpr int K22_TJ = 8;                  // tile rows, a warp each
constexpr int K22_NT = km::TI * K22_TJ;
constexpr int K22_HALO = 2;                // halo of the field planes
constexpr int K22_R = 6;                   // field slots: planes k-1 .. k+4
constexpr int K22_ER = 4;                  // e slots: k-1 .. k+2
constexpr int K22_EW = km::TI + 2;         // row of an e slot
constexpr int K22_ESZ = (K22_TJ + 2) * K22_EW;
constexpr int K22_NTC = 32;                // staged table row: ct, then ce
constexpr int K22_CE = 24;                 // at this column
constexpr int K22_NE = 2 * (K22_TJ + K22_EW);   // e points around the tile
constexpr int K22_VW = 3;                  // the warp that takes v* beyond
constexpr int K22_UW = 4;                  // the warp that takes u* beyond
static_assert(NTQ <= K22_CE && K22_CE + NEQ <= K22_NTC,
              "the staged row holds ct, its quotients, ce and its quotient");

template <typename T>
struct FoldArgs {
    const T *u, *v, *w, *th;        // th null: no thermo
    const T *e_in;                  // interior evisc to read, or null
    const T *se;                    // (jtot, itot) surface row of e, or null
    T *us, *vs, *ws, *ths;
    const T *tu_in, *tv_in, *tw_in; // null when first
    T *tu_out, *tv_out, *tw_out;    // null unless carry
    T *tth;                         // in place
    T *e_out;                       // (ktot, jtot, itot), null with e_in
    T *rhs;                         // (ktot, jtot, itot)
    const T *ct, *ce;               // (ktot, NTG) and (ktot, NE) tables
    // cB*dt and 1/(cB*dt): device scalars, so that a captured launch
    // reads each step's dt
    const T *cbdt, *dti;
    int itot, jtot, ktot, ks;
    T dxi, dyi, visc, svisc, tPr, can, fc, utrans, vtrans;
    int first, carry, coriolis, chunks, vec_ok;
};

using FoldSlot = km::Slot<K22_TJ, K22_HALO>;

// dynamic shared memory of a launch (ops/kmarch.py repeats it): the field
// rings, e's ring, u* and v* of two levels, the staged table rows
template <typename T>
constexpr size_t fold_smem() {
    return ((size_t)K22_R * 4 * FoldSlot::SIZE + K22_ER * K22_ESZ
            + 2 * K22_TJ * (km::TI + 1) + 2 * (K22_TJ + 1) * km::TI
            + K22_R * K22_NTC) * sizeof(T);
}

// les_math.cuh's KV with the column read from shared memory too
template <typename T, int W>
struct PV {
    const T *P0, *P1, *P2;
    __device__ __forceinline__ T operator()(int s, int dj, int di) const {
        return (s == 0 ? P0 : (s == 1 ? P1 : P2))[dj * W + di];
    }
};

extern __shared__ __align__(16) unsigned char fold_smem_buf[];

template <typename T, bool THERMO>
__global__ void __launch_bounds__(K22_NT, sizeof(T) == 4 ? 3 : 2)
tend_rk_fold_kernel(const FoldArgs<T> a) {
    using km::C0;
    using km::RS;
    using km::TI;
    constexpr int H = K22_HALO, SZ = FoldSlot::SIZE, PL = 4 * SZ;
    T* const f = reinterpret_cast<T*>(fold_smem_buf);     // [R][4][SZ]
    T* const es = f + K22_R * PL;                           // [ER][ESZ]
    T* const su = es + K22_ER * K22_ESZ;                    // [2][TJ][TI+1]
    T* const sv = su + 2 * K22_TJ * (TI + 1);               // [2][TJ+1][TI]
    T* const rows = sv + 2 * (K22_TJ + 1) * TI;             // [R][NTC]

    const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
    const int i0 = blockIdx.x * TI, j0 = blockIdx.y * K22_TJ;
    const int itot = a.itot, jtot = a.jtot, kt = a.ktot;
    const long long plane = (long long)itot * jtot;
    constexpr bool thermo = THERMO;
    const T grav = T(9.81);
    const T dxi = a.dxi, dyi = a.dyi, visc = a.visc;
    const T cbdt = __ldg(a.cbdt), dti = __ldg(a.dti);
    const Slots q{0, 1, 2};
    int k0, k1;
    km::chunk_bounds(blockIdx.z, a.chunks, kt, k0, k1);
    // the slot of plane p >= -2, and d slots on from slot s (0 <= d < R)
    auto ring = [](int p) { return (p + K22_R) % K22_R; };
    auto adv = [](int s, int d) { s += d; return s >= K22_R ? s - K22_R : s; };
    auto eslot = [](int p) { return (p + K22_ER) & (K22_ER - 1); };
    auto level = [&](int k) { return (long long)(a.ks + k) * plane; };

    const km::PlaneLoader<T, K22_TJ, K22_NT, H> ld(
        tid, i0, j0, itot, jtot, a.vec_ok && i0 + TI <= itot);
    // the copies of plane p (the four fields clamped, w to [0, ktot], the
    // others to [0, ktot-1]) and of the table rows of level clamp(p) into
    // slot s; the fields share the loader's offsets
    auto issue = [&](int p, int s) {
        T* sl = f + s * PL;
        const int pc = clampi(p, 0, kt - 1);
        const long long lc = level(pc), lw = level(clampi(p, 0, kt));
#pragma unroll
        for (int n = 0; n < ld.NOP; ++n) {
            if (ld.src[n] < 0) continue;
            T* d = sl + (ld.dst[n] & (km::VEC - 1));
            const long long g = lc + ld.src[n], gw = lw + ld.src[n];
            if (ld.dst[n] & km::VEC) {
                km::cp_async<16>(d, a.u + g);
                km::cp_async<16>(d + SZ, a.v + g);
                km::cp_async<16>(d + 2 * SZ, a.w + gw);
                if (thermo) km::cp_async<16>(d + 3 * SZ, a.th + g);
            } else {
                km::cp_async<sizeof(T)>(d, a.u + g);
                km::cp_async<sizeof(T)>(d + SZ, a.v + g);
                km::cp_async<sizeof(T)>(d + 2 * SZ, a.w + gw);
                if (thermo) km::cp_async<sizeof(T)>(d + 3 * SZ, a.th + g);
            }
        }
        T* r = rows + s * K22_NTC;
        if (tid < NTG)
            km::cp_async<sizeof(T)>(r + tid, a.ct + (long long)pc * NTG + tid);
        else if (tid >= K22_CE && tid < K22_CE + NE)
            km::cp_async<sizeof(T)>(r + tid,
                                    a.ce + (long long)pc * NE + tid - K22_CE);
        km::commit();
    };

    // e(lev) at the point (r, c) of the tile plus one (r in [-1, TJ], c in
    // [-1, TI]; cell: the point's offset in a plane) into its slot, from the
    // planes of level clamp(lev) -1, 0, +1 in slots sm, sc, sp
    auto e_point = [&](int lev, int sm, int sc, int sp, int r, int c,
                       int cell) {
        const int qc = clampi(lev, 0, kt - 1);
        T ev;
        if (a.e_in) {
            ev = __ldg(a.e_in + qc * plane + cell);
        } else if (qc == 0 && a.se) {
            ev = __ldg(a.se + cell);
        } else {
            const int off = (r + H) * RS + C0 + c;
            const T* p0 = f + sm * PL + off;
            const T* p1 = f + sc * PL + off;
            const T* p2 = f + sp * PL + off;
            const PV<T, RS> U{p0, p1, p2}, V{p0 + SZ, p1 + SZ, p2 + SZ};
            const PV<T, RS> W{p0 + 2 * SZ, p1 + 2 * SZ, p2 + 2 * SZ};
            const PV<T, RS> A{p0 + 3 * SZ, p1 + 3 * SZ, p2 + 3 * SZ};
            ev = evisc_math<QRow<T>>(U, V, W, A, q,
                                     QRow<T>{rows + sc * K22_NTC + K22_CE},
                                     dxi, dyi, a.tPr, thermo ? 1 : 0, T(0));
        }
        es[eslot(lev) * K22_ESZ + (r + 1) * K22_EW + c + 1] = ev;
        return ev;
    };
    auto e_at = [&](int lev, int r, int c, int cell) {
        const int qc = clampi(lev, 0, kt - 1);
        return e_point(lev, ring(qc - 1), ring(qc), ring(qc + 1), r, c, cell);
    };

    // the points of e's ring around the tile, n < K22_NE
    auto halo_point = [&](int n, int& r, int& c) {
        if (n < K22_EW) { r = -1; c = n - 1; }
        else if (n < 2 * K22_EW) { r = K22_TJ; c = n - K22_EW - 1; }
        else if (n < 2 * K22_EW + K22_TJ) { r = n - 2 * K22_EW; c = -1; }
        else { r = n - 2 * K22_EW - K22_TJ; c = TI; }
    };
    auto cell_of = [&](int r, int c) {
        return wrap(j0 + r, jtot) * itot + wrap(i0 + c, itot);
    };

    // u's and v's total tendencies through the views; tu, tv the carries
    // (unread when first)
    auto u_total = [&](const auto& U, const auto& V, const auto& W,
                       const auto& E, const QRow<T>& cc, T tu) {
        T ut = u_tend<QRow<T>>(U, V, W, E, q, cc, dxi, dyi, visc)
               + u_folds(U, V, 1, cc.p, a.fc, a.vtrans, a.coriolis);
        return a.first ? ut : tu + ut;
    };
    auto v_total = [&](const auto& U, const auto& V, const auto& W,
                       const auto& E, const QRow<T>& cc, T tv) {
        T vt = v_tend<QRow<T>>(U, V, W, E, q, cc, dxi, dyi, visc)
               + v_folds(U, V, 1, cc.p, a.fc, a.utrans, a.coriolis);
        return a.first ? vt : tv + vt;
    };
    // w's total tendency at half level k (> 0) without the carry
    auto w_part = [&](const auto& U, const auto& V, const auto& W,
                      const auto& A, const auto& E, const QRow<T>& cc) {
        const T w_ = W(1, 0, 0);
        T wt = w_tend<QRow<T>>(U, V, W, E, q, cc, dxi, dyi, visc)
               - cc[T_FACZH] * w_;
        if (thermo) {
            const T threfh = cc[T_THREFH];
            wt = wt + quot(cc, grav, threfh, TQ_GTHREFH)
                          * (i2(A(0, 0, 0), A(1, 0, 0)) - threfh);
        }
        return wt;
    };
    // the quotients of the staged row in slot s (QRow's columns), four
    // threads, each divided as the point functions would divide it
    auto derive = [&](int s, int t) {
        T* r = rows + s * K22_NTC;
        if (t == 0) r[TQ_RDZI] = r[T_DZI] / r[T_RHO];
        else if (t == 1) r[TQ_RDZHI] = r[T_DZHI] / r[T_RHOH];
        else if (t == 2 && thermo) r[TQ_GTHREFH] = grav / r[T_THREFH];
        else if (t == 3 && thermo)
            r[K22_CE + EQ_GTHREF] = grav / r[K22_CE + E_THREF];
    };

    // ---- warm-up: planes k0-2 .. k0+3, e(k0-1 .. k0+1) ----
    for (int p = k0 - 2; p <= k0 + 3; ++p) issue(p, ring(p));
    km::wait_all();
    __syncthreads();
    if (tid < 6 * 4) derive(ring(k0 - 2 + (tid >> 2)), tid & 3);
    __syncthreads();
    const int me = (ty + H) * RS + C0 + tx;
    const int em = (ty + 1) * K22_EW + tx + 1;
    const int o2 = cell_of(ty, tx);
    T e0 = e_at(k0 - 1, ty, tx, o2);
    T e1 = e_at(k0, ty, tx, o2);
    T e2 = e_at(k0 + 1, ty, tx, o2);
    for (int n = tid; n < 3 * K22_NE; n += K22_NT) {
        const int m = n / K22_NE;
        int r, c;
        halo_point(n - m * K22_NE, r, c);
        e_at(k0 - 1 + m, r, c, cell_of(r, c));
    }
    // the halo work of a level, spread so that no warp takes two passes of
    // one kind: e's ring by the first three warps (a point a thread), v*
    // one row beyond the tile by warp K22_VW, u* one column beyond by eight
    // threads of warp K22_UW
    int hr = 0, hc = 0;
    if (tid < K22_NE) halo_point(tid, hr, hc);
    const int hcell = tid < K22_NE ? cell_of(hr, hc)
                      : ty == K22_VW ? cell_of(K22_TJ, tx) : cell_of(tx, TI);

    // the thread's column at k0-1, k0, k0+1 and its carries at k0
    auto at = [&](int s, int fld) { return f[s * PL + fld * SZ + me]; };
    int sk = ring(k0);            // slot of plane k
    T u0 = at(ring(k0 - 1), 0), u1 = at(sk, 0), u2 = at(adv(sk, 1), 0);
    T v0 = at(ring(k0 - 1), 1), v1 = at(sk, 1), v2 = at(adv(sk, 1), 1);
    T w0 = at(ring(k0 - 1), 2), w1 = at(sk, 2), w2 = at(adv(sk, 1), 2);
    T a0 = T(0), a1 = T(0), a2 = T(0);
    if (thermo) {
        a0 = at(ring(k0 - 1), 3);
        a1 = at(sk, 3);
        a2 = at(adv(sk, 1), 3);
    }
    T cu = T(0), cv = T(0), cw = T(0), ca = T(0);
    if (!a.first) {
        const long long l = level(k0) + o2;
        cu = __ldg(a.tu_in + l);
        cv = __ldg(a.tv_in + l);
        cw = __ldg(a.tw_in + l);
        if (thermo) ca = a.tth[l];
    }
    const bool inside = i0 + tx < itot && j0 + ty < jtot;
    const T tPri = T(1) / a.tPr;
    T wsp = T(0);     // rhoh(k-1) w*(k-1): the thread's part of rhs(k-1)
    for (int k = k0; k < k1; ++k) {
        // plane k+3 has landed; every thread is past level k-1
        km::wait_all();
        __syncthreads();
        // plane k+4 goes where plane k-2 lay, which nothing reads any more
        if (k + 4 <= k1 + 1) issue(k + 4, adv(sk, 4));
        // the quotients of row k+3, which landed with its plane
        if (k > k0 && k + 3 <= k1 + 1 && tid < 4) derive(adv(sk, 3), tid);
        const int sm1 = adv(sk, K22_R - 1), s1 = adv(sk, 1), s2 = adv(sk, 2);
        const int b = k & 1;
        const QRow<T> cc{rows + sk * K22_NTC};
        const T* pl0 = f + sm1 * PL + me;
        const T* pl1 = f + sk * PL + me;
        const T* pl2 = f + s1 * PL + me;
        const T* el0 = es + eslot(k - 1) * K22_ESZ + em;
        const T* el1 = es + eslot(k) * K22_ESZ + em;
        const T* el2 = es + eslot(k + 1) * K22_ESZ + em;
        // what the next level needs, on its way during this one's work
        const T un = at(s2, 0), vn = at(s2, 1), wn = at(s2, 2);
        const T an = thermo ? at(s2, 3) : T(0);
        T cun = T(0), cvn = T(0), cwn = T(0), can_ = T(0);
        if (!a.first) {
            const long long l = level(k + 1) + o2;
            cun = __ldg(a.tu_in + l);
            cvn = __ldg(a.tv_in + l);
            cwn = __ldg(a.tw_in + l);
            if (thermo) can_ = a.tth[l];
        }
        // e(k+2), from planes k+1 .. k+3 (k .. k+2 at the top, where
        // e(ktot) repeats e(ktot-1)), into the slot nobody reads
        T en = T(0);
        if (k + 2 <= k1) {
            const int d = k + 2 <= kt - 1 ? 1 : 0;
            const int ea = adv(sk, d), eb = adv(sk, d + 1), ec = adv(sk, d + 2);
            en = e_point(k + 2, ea, eb, ec, ty, tx, o2);
            if (tid < K22_NE) e_point(k + 2, ea, eb, ec, hr, hc, hcell);
        }

        const KV<T, RS> U{pl0, pl1, pl2, u0, u1, u2};
        const KV<T, RS> V{pl0 + SZ, pl1 + SZ, pl2 + SZ, v0, v1, v2};
        const KV<T, RS> W{pl0 + 2 * SZ, pl1 + 2 * SZ, pl2 + 2 * SZ, w0, w1, w2};
        const KV<T, RS> A{pl0 + 3 * SZ, pl1 + 3 * SZ, pl2 + 3 * SZ,
                          a0, a1, a2};
        const KV<T, K22_EW> E{el0, el1, el2, e0, e1, e2};
        const long long o = level(k) + o2;
        const T ut = u_total(U, V, W, E, cc, cu);
        const T vt = v_total(U, V, W, E, cc, cv);
        const T us_ = u1 + cbdt * ut, vs_ = v1 + cbdt * vt;
        su[(b * K22_TJ + ty) * (TI + 1) + tx] = us_;
        sv[(b * (K22_TJ + 1) + ty) * TI + tx] = vs_;
        T wt = k == 0 ? T(0) : w_part(U, V, W, A, E, cc);
        if (!a.first) wt = cw + wt;
        const T ws_ = w1 + cbdt * wt;
        T tht = T(0);
        if (thermo) {
            tht = s_tend<QRow<T>>(U, V, W, A, E, q, cc, dxi, dyi, a.svisc,
                                  tPri)
                  - cc[T_FACZ] * (a1 - cc[T_SREF]);
            if (!a.first) tht = ca + tht;
        }
        if (inside) {
            a.us[o] = us_;
            a.vs[o] = vs_;
            a.ws[o] = ws_;
            if (thermo) a.ths[o] = a1 + cbdt * tht;
            if (a.carry) {
                a.tu_out[o] = a.can * ut;
                a.tv_out[o] = a.can * vt;
                a.tw_out[o] = a.can * wt;
                if (thermo) a.tth[o] = a.can * tht;
            }
            if (a.e_out) a.e_out[o - level(0)] = e1;
        }
        // v* one row and u* one column beyond the tile
        if (ty == K22_VW || (ty == K22_UW && tx < K22_TJ)) {
            const bool vrow = ty == K22_VW;
            const int r = vrow ? K22_TJ : tx, c = vrow ? tx : TI;
            const int off = (r + H) * RS + C0 + c - me;
            const int eo = (r + 1) * K22_EW + c + 1 - em;
            const PV<T, RS> Ub{pl0 + off, pl1 + off, pl2 + off};
            const PV<T, RS> Vb{pl0 + SZ + off, pl1 + SZ + off,
                               pl2 + SZ + off};
            const PV<T, RS> Wb{pl0 + 2 * SZ + off, pl1 + 2 * SZ + off,
                               pl2 + 2 * SZ + off};
            const PV<T, K22_EW> Eb{el0 + eo, el1 + eo, el2 + eo};
            const long long l = level(k) + hcell;
            if (vrow) {
                const T tv = a.first ? T(0) : __ldg(a.tv_in + l);
                sv[(b * (K22_TJ + 1) + K22_TJ) * TI + tx] =
                    Vb(1, 0, 0) + cbdt * v_total(Ub, Vb, Wb, Eb, cc, tv);
            } else {
                const T tu = a.first ? T(0) : __ldg(a.tu_in + l);
                su[(b * K22_TJ + tx) * (TI + 1) + TI] =
                    Ub(1, 0, 0) + cbdt * u_total(Ub, Vb, Wb, Eb, cc, tu);
            }
        }
        // rhs of level k-1: u*, v* of that level from shared memory
        const T wfl = cc[T_RHOH] * ws_;
        if (k > k0 && inside) {
            const int bp = b ^ 1;
            const T* s0 = su + (bp * K22_TJ + ty) * (TI + 1) + tx;
            const T* s1p = sv + (bp * (K22_TJ + 1) + ty) * TI + tx;
            const T divh = (s0[1] - s0[0]) * dxi + (s1p[TI] - s1p[0]) * dyi;
            a.rhs[o - level(0) - plane] =
                dti * (cc[T_RHO_M1] * divh + (wfl - wsp) * cc[T_DZI_M1]);
        }
        wsp = wfl;
        u0 = u1; u1 = u2; u2 = un;
        v0 = v1; v1 = v2; v2 = vn;
        w0 = w1; w1 = w2; w2 = wn;
        a0 = a1; a1 = a2; a2 = an;
        e0 = e1; e1 = e2; e2 = en;
        cu = cun; cv = cvn; cw = cwn; ca = can_;
        sk = s1;
    }
    // w*(k1) for rhs(k1-1) when the level above the chunk is inside: the
    // columns now hold k1-1 .. k1+1, the carry tw_in(k1), and the planes
    // and e(k1-1), e(k1) are still in their slots
    T wtop = T(0);
    if (k1 < kt) {
        const T* pl0 = f + adv(sk, K22_R - 1) * PL + me;
        const T* pl1 = f + sk * PL + me;
        const T* pl2 = f + adv(sk, 1) * PL + me;
        const T* el0 = es + eslot(k1 - 1) * K22_ESZ + em;
        const T* el1 = es + eslot(k1) * K22_ESZ + em;
        const KV<T, RS> U{pl0, pl1, pl2, u0, u1, u2};
        const KV<T, RS> V{pl0 + SZ, pl1 + SZ, pl2 + SZ, v0, v1, v2};
        const KV<T, RS> W{pl0 + 2 * SZ, pl1 + 2 * SZ, pl2 + 2 * SZ, w0, w1, w2};
        const KV<T, RS> A{pl0 + 3 * SZ, pl1 + 3 * SZ, pl2 + 3 * SZ,
                          a0, a1, a2};
        const KV<T, K22_EW> E{el0, el1, el1, e0, e1, e1};
        T wt = w_part(U, V, W, A, E, QRow<T>{rows + sk * K22_NTC});
        if (!a.first) wt = cw + wt;
        wtop = w1 + cbdt * wt;
    }
    __syncthreads();
    // rhs(k1-1): u*, v* of the chunk's last level, w*(k1)
    if (inside) {
        const int k = k1 - 1, bp = k & 1;
        const T* cc = rows + adv(sk, K22_R - 1) * K22_NTC;
        const T* s0 = su + (bp * K22_TJ + ty) * (TI + 1) + tx;
        const T* s1p = sv + (bp * (K22_TJ + 1) + ty) * TI + tx;
        const T divh = (s0[1] - s0[0]) * dxi + (s1p[TI] - s1p[0]) * dyi;
        a.rhs[(long long)k * plane + o2] =
            dti * (cc[T_RHO] * divh
                     + (cc[T_RHOH1] * wtop - wsp) * cc[T_DZI]);
    }
}

template <typename T, bool THERMO>
int launch_tend_rk_fold(const FoldArgs<T>& args, cudaStream_t stream) {
    if (args.chunks < 1 || args.chunks > args.ktot)
        return (int)cudaErrorInvalidValue;
    const size_t bytes = fold_smem<T>();
    cudaError_t rc = cudaFuncSetAttribute(
        tend_rk_fold_kernel<T, THERMO>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (rc != cudaSuccess) return (int)rc;
    const dim3 grid((args.itot + km::TI - 1) / km::TI,
                    (args.jtot + K22_TJ - 1) / K22_TJ, args.chunks);
    tend_rk_fold_kernel<T, THERMO><<<grid, K22_NT, bytes, stream>>>(args);
    return (int)cudaGetLastError();
}

}  // namespace mhh

#define MHH_TEND_RK_FOLD(SUF, T)                                              \
    extern "C" int mhh_tend_rk_fold_##SUF(                                    \
        const void* u, const void* v, const void* w, const void* th,          \
        const void* e_in, const void* se, void* us, void* vs, void* ws,       \
        void* ths, const void* tu_in, const void* tv_in, const void* tw_in,   \
        void* tu_out, void* tv_out, void* tw_out, void* tth, void* e_out,     \
        void* rhs, const void* ct, const void* ce, int itot, int jtot,        \
        int ktot, int ks, double dxi, double dyi, double visc, double svisc,  \
        double tPr, const void* cbdt, double can, const void* dti, double fc, \
        double utrans, double vtrans, int first, int carry, int coriolis,     \
        int chunks, void* stream) {                                           \
        mhh::FoldArgs<T> a;                                                   \
        a.u = (const T*)u; a.v = (const T*)v; a.w = (const T*)w;              \
        a.th = (const T*)th; a.e_in = (const T*)e_in; a.se = (const T*)se;    \
        a.us = (T*)us; a.vs = (T*)vs; a.ws = (T*)ws; a.ths = (T*)ths;         \
        a.tu_in = (const T*)tu_in; a.tv_in = (const T*)tv_in;                 \
        a.tw_in = (const T*)tw_in;                                            \
        a.tu_out = (T*)tu_out; a.tv_out = (T*)tv_out; a.tw_out = (T*)tw_out;  \
        a.tth = (T*)tth; a.e_out = (T*)e_out;                                 \
        a.rhs = (T*)rhs; a.ct = (const T*)ct; a.ce = (const T*)ce;            \
        a.itot = itot; a.jtot = jtot; a.ktot = ktot; a.ks = ks;               \
        a.dxi = T(dxi); a.dyi = T(dyi); a.visc = T(visc);                     \
        a.svisc = T(svisc); a.tPr = T(tPr);                                   \
        a.cbdt = (const T*)cbdt; a.dti = (const T*)dti;                       \
        a.can = T(can); a.fc = T(fc);                                         \
        a.utrans = T(utrans); a.vtrans = T(vtrans);                           \
        a.first = first; a.carry = carry; a.coriolis = coriolis;              \
        a.chunks = chunks;                                                    \
        a.vec_ok = itot % (16 / (int)sizeof(T)) == 0                          \
                   && mhh::km::aligned16(u) && mhh::km::aligned16(v)          \
                   && mhh::km::aligned16(w)                                   \
                   && (!th || mhh::km::aligned16(th));                        \
        return th ? mhh::launch_tend_rk_fold<T, true>(a, (cudaStream_t)stream) \
                  : mhh::launch_tend_rk_fold<T, false>(a,                     \
                                                      (cudaStream_t)stream);  \
    }                                                                         \
    extern "C" int mhh_tend_rk_fold_info_##SUF(int thermo, int S, int* out) { \
        return thermo ? mhh::km::kernel_info(                                 \
                            mhh::tend_rk_fold_kernel<T, true>, mhh::K22_NT,   \
                            mhh::fold_smem<T>(), out)                         \
                      : mhh::km::kernel_info(                                 \
                            mhh::tend_rk_fold_kernel<T, false>, mhh::K22_NT,  \
                            mhh::fold_smem<T>(), out);                        \
    }

MHH_TEND_RK_FOLD(f32, float)
MHH_TEND_RK_FOLD(f64, double)
