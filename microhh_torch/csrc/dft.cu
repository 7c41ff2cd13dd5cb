// K5/K6: the horizontal 2-D real DFT pair of the spectral Poisson solve
// (pres_2.cxx:198-263), in the natural mode order of torch.fft.rfft2:
//
//   forward  x (kt, jtot, itot) real  -> y (kt, jtot, itot/2+1) complex
//   inverse  y (kt, jtot, itot/2+1)   -> x (kt, jtot, itot) real, 1/(itot jtot)
//
// Replaces the TPU kernels dft2_fwd / _fwd_body and dft2_inv / _inv_body
// (microhh_tpu/ops/pallas_dft.py:308 and :330, pallas_call :322 and :344).
// Those factor each axis once into r = 3 or 4 residue blocks and do the
// block DFTs as (B x B) matmuls on the MXU, with permuted mode order.  Here
// each line is a mixed-radix Stockham FFT in shared memory (radix 8, 4, 3
// and 2 as butterflies in registers, 5 and any other prime factor as a
// direct small DFT), which keeps the modes in natural order; any itot and
// jtot work.  Neither kernel writes its input.
//
// Bound: device-memory bytes.  A transform must read its input once and
// write its output once (1.08 GB at 512^3 f32, 0.32 ms at 3.35 TB/s); its
// 2.5 N log2 N operations (6 GFLOP) take 0.09 ms at the f32 rate outside
// the tensor cores.  TF32 tensor cores would not help the bound and would
// break the 1e-5 agreement, so the MXU formulation is not carried over.
//
// Cluster form (dft_fwd_cluster / dft_inv_cluster, the main path): one
// k-plane per thread-block cluster of C CTAs (C = 1, 2, 4 or 8, the
// smallest whose CTAs hold the plane in shared memory; Pres2.dft_form
// chooses C and the column chunk F with the formula of cluster_smem below),
// looping persistently over planes so each CTA builds its twiddle tables
// once.  Forward: CTA r loads its ~jtot/C rows with cp.async (every copy of
// the slice in flight at once), transforms them as itot/2 packed complex
// points (x[2m] + i x[2m+1]) and unpacks the modes, folding the real
// Nyquist mode into the imaginary part of the real mode 0, so a row keeps
// itot/2 complex values; cluster barrier; each CTA then gathers chunks of F
// columns from all C CTAs' shared memory (DSMEM), transforms them along j
// and writes each chunk once as jtot runs of F modes, unpacking column 0
// into the mean and Nyquist columns (Y0 = (Z[k] + conj Z[-k])/2, Yn =
// (Z[k] - conj Z[-k])/2i) as it writes.  Inverse: the same backwards;
// columns come in by cp.async (8-B pieces: the spectrum's row pitch is not
// 16-B aligned), mean and Nyquist packed into one column through their
// Hermitian parts, transformed along j, scattered through DSMEM into the
// owning CTAs' rows; cluster barrier; rows unpacked, transformed and
// written as contiguous real rows.  So each transform reads its input once
// and writes its output once, in one launch (the split form's two HBM round
// trips, item 1 of the design notes), with all of a CTA's loads in flight
// (item 2), column runs of F modes (item 3), and radix 3 as a butterfly
// (item 4).  An odd itot is transformed as complex rows of itot points with
// no Nyquist fold.  Shared-memory indices get one pad entry per 128 B, so
// the stride-R stores of the first stages and the column gathers spread
// over the banks.  The Stockham stages ping-pong between the row block and
// the column-chunk scratch, one __syncthreads per stage.
//
// Split form (dft_r2c_x, dft_c2c_y, dft_c2r_x; entries mhh_dft_*_split):
// the two-pass form for planes no portable cluster holds in shared memory
// (f64 above about 1.6 MB a plane): G whole lines per block, a j pass that
// reads the spectrum from one array and writes it to another.
//
// Registers (nvcc -Xptxas -v, sm_90a; no spills): dft_fwd_cluster 76 in
// f32 and 96 in f64, dft_inv_cluster 80 and 100; dft_r2c_x 40 and 56,
// dft_c2c_y 47 and 60, dft_c2r_x 40 and 52.  Dynamic shared memory of a
// cluster-form CTA at the f32 main-path planes (cluster_smem): 512^2 C = 8
// F = 8 217736 B, 384^2 C = 4 F = 8 215944 B, 768x384 C = 8 F = 8 218632
// B, 1024x256 C = 8 F = 16 219656 B, 256^2 C = 2 F = 16 214280 B: one CTA
// of 512 threads an SM.  The split form's blocks take at most 64 KB.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <initializer_list>

namespace cg = cooperative_groups;

namespace mhh {

constexpr int DFT_THREADS = 256;
constexpr int DFT_CLUSTER_THREADS = 512;
constexpr int DFT_MAX_STAGES = 32;
// shared-memory budget per block of the split form, which sets its lines
// per block
constexpr size_t DFT_SMEM_BUDGET = 64 * 1024;
constexpr int DFT_MAX_LINES = 16;
// the most dynamic shared memory a block can have on sm_90
constexpr size_t DFT_SMEM_MAX = 232448;

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

// exp(sgn 2 pi i num / den), computed in double
template <typename T>
__device__ __forceinline__ cpx<T> root(long long num, long long den, int sgn) {
    double s, c;
    sincospi(2.0 * (double)num / (double)den, &s, &c);
    return {T(c), T(sgn * s)};
}

// The twiddles of every Stockham stage of plan P, stage after stage: the
// stage of radix R after Ns points holds W[jm (R-1) + q - 1] = exp(sgn 2 pi
// i q jm / (Ns R)) for jm < Ns, 0 < q < R, so a butterfly reads its R - 1
// twiddles from consecutive entries.  P.n - 1 entries; no barrier.
template <typename T>
__device__ void stage_twiddles(cpx<T>* W, const DftPlan& P, int sgn) {
    int Ns = 1;
    for (int st = 0; st < P.nstages; ++st) {
        const int R = P.radix[st];
        for (int e = threadIdx.x; e < Ns * (R - 1); e += blockDim.x) {
            const int jm = e / (R - 1), q = e - jm * (R - 1) + 1;
            W[e] = root<T>((long long)q * jm, (long long)Ns * R, sgn);
        }
        W += Ns * (R - 1);
        Ns *= R;
    }
}

// W[f] = exp(sgn 2 pi i f / n) for f <= n/2 (the packed rows' unpack); no
// barrier
template <typename T>
__device__ void unpack_twiddles(cpx<T>* W, int n, int sgn) {
    for (int f = threadIdx.x; f <= n / 2; f += blockDim.x)
        W[f] = root<T>(f, n, sgn);
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
// of the same layout.  W holds the stage twiddles of P (stage_twiddles).
// The caller has synchronised after filling a; every stage ends with a
// barrier.  Returns the buffer that holds the result.
template <typename T>
__device__ cpx<T>* fft_lines(cpx<T>* a, cpx<T>* b, const cpx<T>* W, int G,
                             int ld, const DftPlan& P, int sgn) {
    const int n = P.n;
    int Ns = 1;
    for (int st = 0; st < P.nstages; ++st) {
        const int R = P.radix[st];
        const int nR = n / R;
        const bool pow2 = (Ns & (Ns - 1)) == 0;
        for_each(G, nR, [&](int g, int j) {
            const cpx<T>* src = a + g * ld;
            cpx<T>* dst = b + g * ld;
            const int jm = pow2 ? (j & (Ns - 1)) : j % Ns;
            const cpx<T>* tw = W + jm * (R - 1) - 1;
            const int d = (j - jm) * R + jm;
            auto in = [&](int q) {
                const cpx<T> x = src[pidx<T>(j + q * nR)];
                return q == 0 ? x : cmul(x, tw[q]);
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
            } else if (R == 3) {
                // y0 = v0 + s, y1,2 = v0 - s/2 +- i sgn (sqrt 3)/2 (v1 - v2)
                const cpx<T> v0 = in(0), v1 = in(1), v2 = in(2);
                const cpx<T> sum = cadd(v1, v2), dif = csub(v1, v2);
                const T h = T(sgn * 0.86602540378443864676);
                const cpx<T> mid = {v0.re - T(0.5) * sum.re,
                                    v0.im - T(0.5) * sum.im};
                const cpx<T> rot = {-h * dif.im, h * dif.re};
                out(0, cadd(v0, sum));
                out(1, cadd(mid, rot));
                out(2, csub(mid, rot));
            } else if (R == 2) {
                const cpx<T> v0 = in(0), v1 = in(1);
                out(0, cadd(v0, v1));
                out(1, csub(v0, v1));
            } else {
                // direct R-point DFT of the twiddled inputs
                for (int r = 0; r < R; ++r) {
                    cpx<T> acc = {T(0), T(0)};
                    for (int q = 0; q < R; ++q)
                        acc = cadd(acc, cmul(in(q), root<T>((q * r) % R, R, sgn)));
                    out(r, acc);
                }
            }
        });
        __syncthreads();
        cpx<T>* t = a;
        a = b;
        b = t;
        W += Ns * (R - 1);
        Ns *= R;
    }
    return a;
}

extern __shared__ __align__(16) unsigned char dft_smem[];

// ---------------------------------------------------------------------------
//  cluster form
// ---------------------------------------------------------------------------

// asynchronous copy of N bytes from device memory to shared memory
template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(gmem), "n"(N)
                 : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The shape of one launch of the cluster form (the host fills it).
struct ClusterGeom {
    int kt, jtot, itot, nf;
    int m;         // row FFT length: itot/2 (even itot, packed) or itot
    int ncol;      // complex columns a row keeps: itot/2 (folded) or nf
    int C, F;      // CTAs a cluster, modes a column chunk
    int rows_max;  // rows per CTA (the last ones may hold fewer)
    int ld_row, ld_col;
    int gsub;      // rows per Stockham batch in the scratch
    int scratch;   // entries of the scratch (two column chunks)
};

// Shared-memory layout of one CTA (in complex entries): rows_max rows of
// ld_row, the scratch (column chunks A and B of F lines of ld_col; a batch
// of rows during the row phase), the stage twiddles of the rows (m) and of
// the columns (jtot), and the unpack twiddles of packed rows (m + 1).
template <typename T>
struct ClusterSmem {
    cpx<T>*rows, *A, *B, *Wr, *Wc, *Wu;
    __device__ ClusterSmem(const ClusterGeom& g) {
        rows = reinterpret_cast<cpx<T>*>(dft_smem);
        A = rows + (size_t)g.rows_max * g.ld_row;
        B = A + (size_t)g.F * g.ld_col;
        Wr = A + g.scratch;
        Wc = Wr + g.m;
        Wu = Wc + g.jtot;
    }
};

template <typename T>
__host__ __device__ inline size_t cluster_smem(const ClusterGeom& g) {
    const bool packed = g.m != g.itot;
    return (size_t)((long long)g.rows_max * g.ld_row + g.scratch + g.m +
                    g.jtot + (packed ? g.m + 1 : 0)) *
           sizeof(cpx<T>);
}

// the twiddle tables of a cluster-form CTA, then a barrier
template <typename T>
__device__ void cluster_twiddles(const ClusterSmem<T>& sm, const ClusterGeom& g,
                                 const DftPlan& Pm, const DftPlan& Pj,
                                 int sgn) {
    stage_twiddles(sm.Wr, Pm, sgn);
    stage_twiddles(sm.Wc, Pj, sgn);
    if (g.m != g.itot) unpack_twiddles(sm.Wu, g.itot, sgn);
    __syncthreads();
}

// how many rows CTA r holds (rows r*rows_max on)
__device__ __forceinline__ int cta_rows(const ClusterGeom& g, int r) {
    const int n = g.jtot - r * g.rows_max;
    return n < 0 ? 0 : (n < g.rows_max ? n : g.rows_max);
}

// Chunk A (gn lines of jtot) from columns c0.. of every CTA's rows, through
// DSMEM: each thread has GATHER_DEPTH remote loads in flight before it
// stores any of them.
constexpr int GATHER_DEPTH = 8;

template <typename T>
__device__ __forceinline__ void gather_columns(cg::cluster_group cluster,
                                               const ClusterSmem<T>& sm,
                                               const ClusterGeom& g, int c0,
                                               int gn) {
    const int total = g.jtot * gn;
    for (int base = threadIdx.x; base < total;
         base += GATHER_DEPTH * (int)blockDim.x) {
        cpx<T> v[GATHER_DEPTH];
        int at[GATHER_DEPTH];
#pragma unroll
        for (int u = 0; u < GATHER_DEPTH; ++u) {
            const int e = base + u * (int)blockDim.x;
            at[u] = -1;
            if (e < total) {
                const int jj = e / gn, c = e - jj * gn;
                const int owner = jj / g.rows_max;
                const cpx<T>* src = cluster.map_shared_rank(sm.rows, owner);
                v[u] = src[(jj - owner * g.rows_max) * g.ld_row +
                           pidx<T>(c0 + c)];
                at[u] = c * g.ld_col + pidx<T>(jj);
            }
        }
#pragma unroll
        for (int u = 0; u < GATHER_DEPTH; ++u)
            if (at[u] >= 0) sm.A[at[u]] = v[u];
    }
}

// forward: rows of x -> y, one k-plane per cluster
template <typename T>
__global__ void __launch_bounds__(DFT_CLUSTER_THREADS, 1)
dft_fwd_cluster(const T* __restrict__ x, cpx<T>* __restrict__ y,
                ClusterGeom g, DftPlan Pm, DftPlan Pj) {
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int cid = blockIdx.x / g.C, ncl = gridDim.x / g.C;
    ClusterSmem<T> sm(g);
    const bool packed = g.m != g.itot;
    const int nrows = cta_rows(g, rank);
    const int r0 = rank * g.rows_max;
    cluster_twiddles(sm, g, Pm, Pj, -1);
    for (int k = cid; k < g.kt; k += ncl) {
        // rows in: every copy of the slice in flight at once
        const T* xk = x + ((long long)k * g.jtot + r0) * g.itot;
        if (packed) {
            for_each(nrows, g.m, [&](int r, int i) {
                cp_async<sizeof(cpx<T>)>(&sm.rows[r * g.ld_row + pidx<T>(i)],
                                         xk + (long long)r * g.itot + 2 * i);
            });
        } else {
            for_each(nrows, g.m, [&](int r, int i) {
                cpx<T>* d = &sm.rows[r * g.ld_row + pidx<T>(i)];
                cp_async<sizeof(T)>(&d->re, xk + (long long)r * g.itot + i);
                d->im = T(0);
            });
        }
        cp_async_wait_all();
        __syncthreads();
        // the row transforms, in batches that ping-pong with the scratch
        for (int b0 = 0; b0 < nrows; b0 += g.gsub) {
            const int gb = nrows - b0 < g.gsub ? nrows - b0 : g.gsub;
            cpx<T>* a = sm.rows + b0 * g.ld_row;
            const cpx<T>* z =
                fft_lines(a, sm.A, sm.Wr, gb, g.ld_row, Pm, -1);
            const int h = g.m;
            if (packed) {
                // X[f] = E + W^f O, E = (Z[f] + conj Z[h-f])/2, O = (Z[f] -
                // conj Z[h-f])/2i, in pairs (f, h-f); X[0] + i X[h] at 0
                for_each(gb, h / 2 + 1, [&](int r, int f) {
                    const cpx<T>* zr = z + r * g.ld_row;
                    cpx<T>* xr = a + r * g.ld_row;
                    if (f == 0) {
                        const cpx<T> z0 = zr[0];
                        xr[0] = {z0.re + z0.im, z0.re - z0.im};
                        return;
                    }
                    const int f2 = h - f;
                    const cpx<T> zk = zr[pidx<T>(f)], zc = zr[pidx<T>(f2)];
                    const cpx<T> e = {T(0.5) * (zk.re + zc.re),
                                      T(0.5) * (zk.im - zc.im)};
                    const cpx<T> o = {T(0.5) * (zk.im + zc.im),
                                      T(-0.5) * (zk.re - zc.re)};
                    xr[pidx<T>(f)] = cadd(e, cmul(sm.Wu[f], o));
                    if (f2 != f) {
                        // the partner: zk and zc swap, so e -> conj e and
                        // o -> conj o
                        const cpx<T> e2 = {e.re, -e.im}, o2 = {o.re, -o.im};
                        xr[pidx<T>(f2)] = cadd(e2, cmul(sm.Wu[f2], o2));
                    }
                });
            } else if (z != a) {
                for_each(gb, g.ncol, [&](int r, int f) {
                    a[r * g.ld_row + pidx<T>(f)] = z[r * g.ld_row + pidx<T>(f)];
                });
            }
            __syncthreads();
        }
        cluster.sync();
        // columns: gather F at a time from every CTA's rows, transform, write
        cpx<T>* yk = y + (long long)k * g.jtot * g.nf;
        const int nchunks = (g.ncol + g.F - 1) / g.F;
        for (int q = rank; q < nchunks; q += g.C) {
            const int c0 = q * g.F;
            const int gn = g.ncol - c0 < g.F ? g.ncol - c0 : g.F;
            gather_columns(cluster, sm, g, c0, gn);
            __syncthreads();
            const cpx<T>* z =
                fft_lines(sm.A, sm.B, sm.Wc, gn, g.ld_col, Pj, -1);
            const bool fold = packed && c0 == 0;
            for_each(g.jtot, gn, [&](int jj, int c) {
                const cpx<T> zk = z[c * g.ld_col + pidx<T>(jj)];
                cpx<T>* row = yk + (long long)jj * g.nf;
                if (fold && c == 0) {
                    const int j2 = jj == 0 ? 0 : g.jtot - jj;
                    const cpx<T> zc = z[pidx<T>(j2)];
                    row[0] = {T(0.5) * (zk.re + zc.re), T(0.5) * (zk.im - zc.im)};
                    row[g.m] = {T(0.5) * (zk.im + zc.im),
                                T(-0.5) * (zk.re - zc.re)};
                } else {
                    row[c0 + c] = zk;
                }
            });
            __syncthreads();
        }
        // no CTA reloads its rows before every CTA has gathered from them
        cluster.sync();
    }
}

// inverse: y -> rows of x, one k-plane per cluster; y is only read
template <typename T>
__global__ void __launch_bounds__(DFT_CLUSTER_THREADS, 1)
dft_inv_cluster(const cpx<T>* __restrict__ y, T* __restrict__ x,
                ClusterGeom g, DftPlan Pm, DftPlan Pj, T scale) {
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int cid = blockIdx.x / g.C, ncl = gridDim.x / g.C;
    ClusterSmem<T> sm(g);
    const bool packed = g.m != g.itot;
    const int nrows = cta_rows(g, rank);
    const int r0 = rank * g.rows_max;
    cluster_twiddles(sm, g, Pm, Pj, 1);
    for (int k = cid; k < g.kt; k += ncl) {
        // columns: read F at a time, transform, scatter to the owners' rows
        const cpx<T>* yk = y + (long long)k * g.jtot * g.nf;
        const int nchunks = (g.ncol + g.F - 1) / g.F;
        for (int q = rank; q < nchunks; q += g.C) {
            const int c0 = q * g.F;
            const int gn = g.ncol - c0 < g.F ? g.ncol - c0 : g.F;
            const bool fold = packed && c0 == 0;
            for_each(g.jtot, gn, [&](int jj, int c) {
                const cpx<T>* row = yk + (long long)jj * g.nf;
                cp_async<sizeof(cpx<T>)>(&sm.A[c * g.ld_col + pidx<T>(jj)],
                                         row + c0 + c);
                if (fold && c == 0)  // the Nyquist column, beside in B
                    cp_async<sizeof(cpx<T>)>(&sm.B[pidx<T>(jj)], row + g.m);
            });
            cp_async_wait_all();
            __syncthreads();
            if (fold) {
                // Z = H(Y0) + i H(Yn), H(Y)[k] = (Y[k] + conj Y[-k])/2: the
                // two columns' real inverses in one complex line
                for_each(1, g.jtot / 2 + 1, [&](int, int jj) {
                    const int j2 = jj == 0 ? 0 : g.jtot - jj;
                    const cpx<T> a = sm.A[pidx<T>(jj)], ac = sm.A[pidx<T>(j2)];
                    const cpx<T> b = sm.B[pidx<T>(jj)], bc = sm.B[pidx<T>(j2)];
                    const cpx<T> h0 = {T(0.5) * (a.re + ac.re),
                                       T(0.5) * (a.im - ac.im)};
                    const cpx<T> hn = {T(0.5) * (b.re + bc.re),
                                       T(0.5) * (b.im - bc.im)};
                    sm.A[pidx<T>(jj)] = {h0.re - hn.im, h0.im + hn.re};
                    if (j2 != jj)
                        sm.A[pidx<T>(j2)] = {h0.re + hn.im, hn.re - h0.im};
                });
                __syncthreads();
            }
            const cpx<T>* z =
                fft_lines(sm.A, sm.B, sm.Wc, gn, g.ld_col, Pj, 1);
            for_each(g.jtot, gn, [&](int jj, int c) {
                const int owner = jj / g.rows_max;
                cpx<T>* dst = cluster.map_shared_rank(sm.rows, owner);
                dst[(jj - owner * g.rows_max) * g.ld_row + pidx<T>(c0 + c)] =
                    z[c * g.ld_col + pidx<T>(jj)];
            });
            __syncthreads();
        }
        // every column has landed in its owner's rows
        cluster.sync();
        T* xk = x + ((long long)k * g.jtot + r0) * g.itot;
        for (int b0 = 0; b0 < nrows; b0 += g.gsub) {
            const int gb = nrows - b0 < g.gsub ? nrows - b0 : g.gsub;
            cpx<T>* a = sm.rows + b0 * g.ld_row;
            const int h = g.m;
            if (packed) {
                // Z[f] = E + i O, E = (X[f] + conj X[h-f])/2, O = (X[f] -
                // conj X[h-f])/2 W^f, as dft_c2r_x, in pairs (f, h-f); entry
                // 0 holds X[0] + i X[h]
                for_each(gb, h / 2 + 1, [&](int r, int f) {
                    cpx<T>* xr = a + r * g.ld_row;
                    if (f == 0) {
                        const cpx<T> c = xr[0];
                        xr[0] = {T(0.5) * (c.re + c.im), T(0.5) * (c.re - c.im)};
                        return;
                    }
                    const int f2 = h - f;
                    const cpx<T> xk = xr[pidx<T>(f)], xc = xr[pidx<T>(f2)];
                    auto z = [&](cpx<T> p, cpx<T> qc, int ff) {
                        // e = (p + conj qc)/2, o = (p - conj qc)/2 W^ff
                        const cpx<T> e = {T(0.5) * (p.re + qc.re),
                                          T(0.5) * (p.im - qc.im)};
                        const cpx<T> d = {T(0.5) * (p.re - qc.re),
                                          T(0.5) * (p.im + qc.im)};
                        const cpx<T> o = cmul(d, sm.Wu[ff]);
                        return cpx<T>{e.re - o.im, e.im + o.re};
                    };
                    const cpx<T> v = z(xk, xc, f);
                    if (f2 != f) xr[pidx<T>(f2)] = z(xc, xk, f2);
                    xr[pidx<T>(f)] = v;
                });
            } else {
                // the other half by Hermitian symmetry; mode 0 real
                for_each(gb, g.itot - g.ncol + 1, [&](int r, int e) {
                    cpx<T>* xr = a + r * g.ld_row;
                    if (e == 0) {
                        xr[0].im = T(0);
                        return;
                    }
                    const int f = g.ncol - 1 + e;
                    const cpx<T> c = xr[pidx<T>(g.itot - f)];
                    xr[pidx<T>(f)] = {c.re, -c.im};
                });
            }
            __syncthreads();
            const cpx<T>* z =
                fft_lines(a, sm.A, sm.Wr, gb, g.ld_row, Pm, 1);
            for_each(gb, h, [&](int r, int i) {
                const cpx<T> v = z[r * g.ld_row + pidx<T>(i)];
                T* xr = xk + (long long)(b0 + r) * g.itot;
                if (packed)
                    reinterpret_cast<cpx<T>*>(xr)[i] = {v.re * scale,
                                                        v.im * scale};
                else
                    xr[i] = v.re * scale;
            });
            __syncthreads();
        }
        // no CTA scatters the next plane into rows still being transformed
        cluster.sync();
    }
}

// ---------------------------------------------------------------------------
//  split form: G lines per block, two passes a transform
// ---------------------------------------------------------------------------

// the two line buffers (G lines of m entries), the stage twiddles (m
// entries) and the unpack twiddles (m + 1 entries, packed rows) of a block
template <typename T>
struct Smem {
    cpx<T>*a, *b, *W, *Wu;
    int ld;
    __device__ Smem(int m, int G) {
        ld = line_stride<T>(m);
        a = reinterpret_cast<cpx<T>*>(dft_smem);
        b = a + G * ld;
        W = b + G * ld;
        Wu = W + m;
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
    stage_twiddles(sm.W, P, -1);
    if (packed) unpack_twiddles(sm.Wu, n, -1);
    __syncthreads();
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
            fft_lines(sm.a, sm.b, sm.W, G, sm.ld, P, -1);
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
                out = cadd(e, cmul(sm.Wu[f], o));
            }
            y[(row0 + g) * nf + f] = out;
        });
        __syncthreads();
    }
}

// j pass: for each level k and G adjacent modes, the lines along j of src
// (kt, n, nf) with stride nf, transformed into dst (which may be src)
template <typename T>
__global__ void __launch_bounds__(DFT_THREADS)
dft_c2c_y(const cpx<T>* src, cpx<T>* dst, int kt, int nf, DftPlan P, int G,
          int sgn) {
    const int n = P.n;
    Smem<T> sm(n, G);
    stage_twiddles(sm.W, P, sgn);
    __syncthreads();
    const int groups = (nf + G - 1) / G;
    for (long long blk = blockIdx.x; blk < (long long)kt * groups;
         blk += gridDim.x) {
        const long long k = blk / groups;
        const int f0 = (int)(blk - k * groups) * G;
        const int gn = nf - f0 < G ? nf - f0 : G;
        const long long base = k * n * nf + f0;
        for_each(n, G, [&](int jj, int g) {
            sm.a[g * sm.ld + pidx<T>(jj)] =
                g < gn ? src[base + (long long)jj * nf + g]
                       : cpx<T>{T(0), T(0)};
        });
        __syncthreads();
        const cpx<T>* r = fft_lines(sm.a, sm.b, sm.W, G, sm.ld, P, sgn);
        for_each(n, gn, [&](int jj, int g) {
            dst[base + (long long)jj * nf + g] = r[g * sm.ld + pidx<T>(jj)];
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
    stage_twiddles(sm.W, P, 1);
    if (packed) unpack_twiddles(sm.Wu, n, 1);
    __syncthreads();
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
                    const cpx<T> o = cmul(d, sm.Wu[f]);
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
            fft_lines(sm.a, sm.b, sm.W, G, sm.ld, P, 1);
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

// the plan of a row transform: h = n/2 packed points for even n, else n
static bool plan_x(int n, DftPlan* P) {
    return make_plan(n % 2 == 0 ? n / 2 : n, P);
}

// The cluster form's geometry for C CTAs and chunks of F modes (the formula
// Pres2.dft_form repeats in Python); false if it does not fit.
template <typename T>
static bool cluster_geom(int kt, int jtot, int itot, int C, int F,
                         ClusterGeom* g, size_t* smem) {
    if (kt < 1 || jtot < 1 || itot < 1 || F < 1 ||
        !(C == 1 || C == 2 || C == 4 || C == 8))
        return false;
    g->kt = kt;
    g->jtot = jtot;
    g->itot = itot;
    g->nf = itot / 2 + 1;
    g->m = itot % 2 == 0 ? itot / 2 : itot;
    g->ncol = itot % 2 == 0 ? itot / 2 : g->nf;
    g->C = C;
    g->F = F;
    g->rows_max = (jtot + C - 1) / C;
    g->ld_row = line_stride<T>(g->m);
    g->ld_col = line_stride<T>(jtot);
    const int chunks = 2 * F * g->ld_col;
    g->scratch = chunks > g->ld_row ? chunks : g->ld_row;
    // the fewest batches the scratch allows, of even size
    const int most = g->scratch / g->ld_row;
    const int batches = (g->rows_max + most - 1) / most;
    g->gsub = (g->rows_max + batches - 1) / batches;
    *smem = cluster_smem<T>(*g);
    return *smem <= DFT_SMEM_MAX;
}

// Opt in to the shared memory, and launch C-CTA clusters, as many as fit on
// the card at once (at most one a plane; each loops over the planes).
template <typename K, typename... Args>
static int launch_cluster(K kernel, const ClusterGeom& g, size_t smem,
                          cudaStream_t stream, Args... args) {
    int rc = (int)cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc) return rc;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = g.C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(g.C * (unsigned)g.kt);
    cfg.blockDim = dim3(DFT_CLUSTER_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    rc = (int)cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (rc) return rc;
    if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
    const int n = g.kt < clusters ? g.kt : clusters;
    cfg.gridDim = dim3((unsigned)(g.C * n));
    rc = (int)cudaLaunchKernelEx(&cfg, kernel, args...);
    if (rc) return rc;
    return (int)cudaGetLastError();
}

template <typename T>
int launch_dft_fwd_cluster(const T* x, cpx<T>* y, int kt, int jtot, int itot,
                           int C, int F, cudaStream_t stream) {
    ClusterGeom g;
    size_t smem;
    DftPlan Pm, Pj;
    if (!cluster_geom<T>(kt, jtot, itot, C, F, &g, &smem) ||
        !plan_x(itot, &Pm) || !make_plan(jtot, &Pj))
        return (int)cudaErrorInvalidValue;
    return launch_cluster(dft_fwd_cluster<T>, g, smem, stream, x, y, g, Pm,
                          Pj);
}

template <typename T>
int launch_dft_inv_cluster(const cpx<T>* y, T* x, int kt, int jtot, int itot,
                           int C, int F, cudaStream_t stream) {
    ClusterGeom g;
    size_t smem;
    DftPlan Pm, Pj;
    if (!cluster_geom<T>(kt, jtot, itot, C, F, &g, &smem) ||
        !plan_x(itot, &Pm) || !make_plan(jtot, &Pj))
        return (int)cudaErrorInvalidValue;
    // the unnormalised transforms of the two axes, over Pm.n and jtot points
    const T scale = T(1.0 / ((double)Pm.n * jtot));
    return launch_cluster(dft_inv_cluster<T>, g, smem, stream, y, x, g, Pm,
                          Pj, scale);
}

// Lines per block G and the dynamic shared memory for it: two buffers of G
// padded lines of m entries, the stage twiddles (m entries) and, for rows
// of n = 2m packed points, the unpack twiddles (m + 1).
template <typename T>
static size_t lines_per_block(int m, int n, int* G) {
    const size_t cs = sizeof(cpx<T>);
    const long long ld = line_stride<T>(m), wn = m + (m != n ? m + 1 : 0);
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

template <typename T>
static int launch_c2c_y(const cpx<T>* src, cpx<T>* dst, int kt, int jtot,
                        int nf, int sgn, cudaStream_t stream) {
    DftPlan P;
    if (!make_plan(jtot, &P)) return (int)cudaErrorInvalidValue;
    int G;
    const size_t smem = lines_per_block<T>(jtot, jtot, &G);
    unsigned grid;
    if (int rc = prepare(dft_c2c_y<T>, smem, (long long)kt * ((nf + G - 1) / G),
                         &grid))
        return rc;
    dft_c2c_y<T><<<grid, DFT_THREADS, smem, stream>>>(src, dst, kt, nf, P, G,
                                                      sgn);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_dft_fwd_split(const T* x, cpx<T>* y, int kt, int jtot, int itot,
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
    return launch_c2c_y<T>(y, y, kt, jtot, nf, -1, stream);
}

// y is read, the j pass writes into the scratch spectrum w
template <typename T>
int launch_dft_inv_split(const cpx<T>* y, cpx<T>* w, T* x, int kt, int jtot,
                         int itot, cudaStream_t stream) {
    const int nf = itot / 2 + 1;
    if (int rc = launch_c2c_y<T>(y, w, kt, jtot, nf, 1, stream)) return rc;
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
        w, x, rows, itot, nf, P, G, T(1.0 / ((double)P.n * jtot)));
    return (int)cudaGetLastError();
}

}  // namespace mhh

// x real (kt, jtot, itot) -> y complex (kt, jtot, itot/2+1)
// y complex (kt, jtot, itot/2+1), read only -> x real (kt, jtot, itot)
// cluster form: C CTAs a cluster, column chunks of F modes
// split form: the inverse's j pass writes the scratch spectrum w
#define MHH_DFT(SUF, T)                                                        \
    extern "C" int mhh_dft_fwd_##SUF(const void* x, void* y, int kt, int jtot, \
                                     int itot, int C, int F, void* stream) {   \
        return mhh::launch_dft_fwd_cluster<T>((const T*)x, (mhh::cpx<T>*)y,    \
                                              kt, jtot, itot, C, F,            \
                                              (cudaStream_t)stream);           \
    }                                                                          \
    extern "C" int mhh_dft_inv_##SUF(const void* y, void* x, int kt, int jtot, \
                                     int itot, int C, int F, void* stream) {   \
        return mhh::launch_dft_inv_cluster<T>((const mhh::cpx<T>*)y, (T*)x,    \
                                              kt, jtot, itot, C, F,            \
                                              (cudaStream_t)stream);           \
    }                                                                          \
    extern "C" int mhh_dft_fwd_split_##SUF(const void* x, void* y, int kt,     \
                                           int jtot, int itot, void* stream) { \
        return mhh::launch_dft_fwd_split<T>((const T*)x, (mhh::cpx<T>*)y, kt,  \
                                            jtot, itot, (cudaStream_t)stream); \
    }                                                                          \
    extern "C" int mhh_dft_inv_split_##SUF(const void* y, void* w, void* x,    \
                                           int kt, int jtot, int itot,         \
                                           void* stream) {                     \
        return mhh::launch_dft_inv_split<T>((const mhh::cpx<T>*)y,             \
                                            (mhh::cpx<T>*)w, (T*)x, kt, jtot,  \
                                            itot, (cudaStream_t)stream);       \
    }

MHH_DFT(f32, float)
MHH_DFT(f64, double)
