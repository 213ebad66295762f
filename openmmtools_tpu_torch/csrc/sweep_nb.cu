// Bounded-sweep direct-space nonbonded kernels for Hopper (sm_90a).
//
// Replaces: openmmtools_tpu/ops/sweep_nb.py:SweepNonbonded (the Pallas TPU
// kernel of the explicit-solvent path), both its standard and its
// alchemical variant. The physics is the same: atoms wrapped into the box
// and sorted by x; slot i interacts with the ring partners i +- s of the
// sorted order for s up to bound * shell_block; Lorentz-Berthelot LJ;
// Coulomb as Ewald/PME direct space qq erfc(a r)/r or reaction field;
// OpenMM's quintic switch on LJ or on LJ + Coulomb; exception pairs masked
// through the per-shell bitfield (bit s-1 of lane i marks the pair (i, i+s));
// a distance-only pass that re-measures the block bound on rebuild. The TPU
// layout is not carried over: no staircases of rolled planes, no poisoned
// pad lanes (pad slots are masked by index), no split loop over the
// exclusion coverage.
//
// Three C entry points, each a main kernel and a one-block finish:
//
//  * sweep_bound_f32: sweep_bound_kernel reads the rebuild flag from device
//    memory and returns at once when it is clear; on rebuild each
//    thread scans its slot's shells 1..n_pad/2 through shared-memory tiles of
//    the sorted window and keeps the last block of shell_block shells with a
//    pair of real slots within (rc + skin)^2. bound_finish_kernel reduces the
//    per-block maxima and writes the bound (1 + the last block) or, without a
//    rebuild, the bound it was given. Nothing reads the flag on the
//    host, so a step never waits on the device. Both variants share it.
//  * sweep_forces_f32: sweep_forces_kernel<false> gives one thread to each
//    sorted slot i and sums its FULL ring neighbourhood i +- s, s <= S =
//    min(bound * shell_block, n_pad/2), without Newton's third law: no
//    atomics, a deterministic result. The partner range -S..S is cut into
//    SLICES contiguous pieces on grid.y so that enough blocks fill the card
//    whatever S the device-side bound gives; each (block, slice) stages its
//    window of the sorted positions and parameters in shared memory and
//    writes partial forces and a partial energy. sweep_reduce_kernel adds
//    the SLICES partial forces in a fixed order and, in its last block, the
//    partial energies (U = 0.5 * the sum: each pair is met from both ends).
//    The shell s = n_pad/2 reaches the same partner from both sides and
//    counts half from each, and an exclusion bit is read only for
//    s <= 32 * mask_rows, both as in the TPU kernel.
//  * sweep_forces_alch_f32: sweep_forces_kernel<true>, the alchemical
//    variant (replaces the TPU kernel's alchemical branches,
//    sweep_nb.py:201-207, :295-326, :333-349, :367-378). par carries a 4th
//    row, the region code g = region_id + 1 (0 = environment, exact small
//    integers in float); lam holds 3 C class scalars [lam_s x C, asc x C,
//    lam_e x C] over the region-pair classes (a, b), 0 <= a <= b <= R, in
//    order, env-env excluded (C = (R+1)(R+2)/2 - 1). lam is a device array,
//    read by every block into shared memory, so a lambda that changes at
//    every step never passes through the host. A pair's class is computed
//    from (a, b) = (min, max)(g_i, g_j) as a * (R+1) - a(a-1)/2 + (b-a) - 1
//    (the TPU kernel compares float (g_i + g_j, g_i g_j) against each
//    class); env-env pairs keep lam_s = lam_e = 1, asc = 0. LJ is the
//    softcore (beta = 0, c = 6) x = s6/(asc s6 + 1), s6 clamped to 1e18 so
//    that no inf * 0 appears at deep overlap, U = 4 eps lam_s x (x - 1): at
//    lam_s = 1 it is the standard LJ. Coulomb is scaled by lam_e; the
//    'coulomb' PME treatment (coulomb_plain) uses the unswitched plain 1/r
//    for pairs with an alchemical member. The standard instantiation
//    compiles none of this.
//
// What bounds it on the H100: the sweep evaluates every slot pair of the
// x-sorted window from both of its ends, about 2 S pairs a slot where the
// function needs each pair once (S a slot, with Newton's third law): the
// price of a sum without atomics. Only the pairs inside the
// cutoff sphere (about 5 % of them for water at rc = 1.0 nm, skin 0.1 nm)
// need the LJ/erfc arithmetic. It is bound by FP32 issue and by warp
// divergence (a warp runs the pair arithmetic when any of its lanes has a
// pair inside the cutoff), not by device memory: the inputs (positions,
// parameters, the 6.2 MB bitfield at 24,064 slots) are read once per block
// window from L2. The design answers correctness first: shared-memory tiles
// keep the inner loop free of global loads except the exclusion word of a
// pair inside the cutoff, and grid.y slices keep 1,504 blocks in flight at
// 24,064 slots. A cell list in place of the 1D window would cut the pair
// count about tenfold; that is later work. The alchemical variant adds
// about 20 operations a pair inside the cutoff (the class index, the
// softcore and the lam_e scaling) and one more shared-memory row.
//
// erfcf stands in for the Abramowitz-Stegun 7.1.26 rational of the TPU
// kernel (|error| < 1.5e-7): both are within float32 rounding of the
// tolerance the port holds the kernel to (2e-4 of the force scale).
//
// Every C entry point returns cudaGetLastError() after its launches; the
// Python wrapper (openmmtools_tpu_torch/ops/sweep_nb.py) raises if it is not
// 0.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 128;    // sorted slots a block (ops/sweep_nb.py _BLOCK)
constexpr int SLICES = 8;     // pieces of the partner range (_SLICES)
constexpr int FINISH_BLOCK = 256;
// class scalars of the alchemical variant: at most 16 regions
// (ops/sweep_nb.py _MAX_LAM)
constexpr int MAX_LAM = 3 * (17 * 18 / 2 - 1);

__device__ __forceinline__ float ring_delta(float d, float L, float hL) {
    // one conditional shift: exact for coordinates wrapped into [0, L)
    d += (d < -hL) ? L : 0.0f;
    d -= (d > hL) ? L : 0.0f;
    return d;
}

// r^2 = (dx dx + dy dy) + dz dz with every product and sum rounded on its
// own (no fused multiply-add): bit for bit the plain version's value, so the
// kernel and its plain version agree on which pairs lie inside the cutoff
// (the unswitched Coulomb force jumps there)
__device__ __forceinline__ float dist2_rn(float dx, float dy, float dz) {
    return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                     __fmul_rn(dz, dz));
}

__device__ __forceinline__ int ring_slot(int p, int n_pad) {
    const int m = p % n_pad;
    return m < 0 ? m + n_pad : m;
}

__global__ void __launch_bounds__(BLOCK)
sweep_bound_kernel(const float* __restrict__ x, int n, int n_pad,
                   const float* __restrict__ L, float w2, int bs,
                   const unsigned char* __restrict__ rebuild,
                   int* __restrict__ partial) {
    __shared__ float sx[BLOCK];
    __shared__ float sy[BLOCK];
    __shared__ float sz[BLOCK];
    __shared__ int sv[BLOCK];
    __shared__ int red[BLOCK];
    if (rebuild[0] == 0) return;  // the finish kernel passes the bound on

    const int half = n_pad / 2;
    const int tid = threadIdx.x;
    const int i0 = blockIdx.x * BLOCK;
    const int i = i0 + tid;
    const bool active = i < n;
    const float Lx = L[0], Ly = L[1], Lz = L[2];
    const float hx = 0.5f * Lx, hy = 0.5f * Ly, hz = 0.5f * Lz;
    // this block's shells: slice blockIdx.y of 1..half
    const int per = (half + gridDim.y - 1) / gridDim.y;
    const int s_lo = 1 + blockIdx.y * per;
    const int s_hi = min(half, s_lo + per - 1);

    float xi = 0.0f, yi = 0.0f, zi = 0.0f;
    if (active) {
        xi = x[i];
        yi = x[n_pad + i];
        zi = x[2 * n_pad + i];
    }
    int last = -1;
    for (int p0 = i0 + s_lo; p0 <= i0 + BLOCK - 1 + s_hi; p0 += BLOCK) {
        const int jm = ring_slot(p0 + tid, n_pad);
        sv[tid] = jm < n;
        sx[tid] = x[jm];
        sy[tid] = x[n_pad + jm];
        sz[tid] = x[2 * n_pad + jm];
        __syncthreads();
        if (active) {
            for (int k = 0; k < BLOCK; ++k) {
                const int s = p0 + k - i;
                if (s < s_lo || s > s_hi || !sv[k]) continue;
                const float dx = ring_delta(xi - sx[k], Lx, hx);
                const float dy = ring_delta(yi - sy[k], Ly, hy);
                const float dz = ring_delta(zi - sz[k], Lz, hz);
                const float r2 = dist2_rn(dx, dy, dz);
                if (r2 <= w2 && r2 > 1e-12f) last = max(last, (s - 1) / bs);
            }
        }
        __syncthreads();
    }
    red[tid] = last;
    __syncthreads();
    for (int stride = BLOCK / 2; stride > 0; stride >>= 1) {
        if (tid < stride) red[tid] = max(red[tid], red[tid + stride]);
        __syncthreads();
    }
    if (tid == 0) partial[blockIdx.y * gridDim.x + blockIdx.x] = red[0];
}

__global__ void __launch_bounds__(FINISH_BLOCK)
bound_finish_kernel(const unsigned char* __restrict__ rebuild,
                    const int* __restrict__ bound,
                    const int* __restrict__ partial, int m,
                    int* __restrict__ nblk) {
    __shared__ int red[FINISH_BLOCK];
    const int tid = threadIdx.x;
    if (rebuild[0] == 0) {
        if (tid == 0) nblk[0] = bound[0];
        return;
    }
    int acc = -1;
    for (int k = tid; k < m; k += FINISH_BLOCK) acc = max(acc, partial[k]);
    red[tid] = acc;
    __syncthreads();
    for (int stride = FINISH_BLOCK / 2; stride > 0; stride >>= 1) {
        if (tid < stride) red[tid] = max(red[tid], red[tid + stride]);
        __syncthreads();
    }
    if (tid == 0) nblk[0] = red[0] + 1;
}

struct Physics {
    float rc2;
    int coulomb_rf;       // 0: Ewald/PME erfc direct space, 1: reaction field
    float alpha;
    float k_rf, c_rf;
    int use_switch, switch_coulomb;
    float r_switch, inv_span;
    float ke;
};

// the alchemical variant's inputs (unused by the standard instantiation)
struct Alch {
    const float* lam;     // (3 n_cls,) [lam_s | asc | lam_e] per class
    int n_regions;
    int coulomb_plain;    // 'coulomb' PME treatment: 1/r for involved pairs
};

template <bool ALCH>
__global__ void __launch_bounds__(BLOCK)
sweep_forces_kernel(const float* __restrict__ x, const float* __restrict__ par,
                    const int* __restrict__ excl, int n, int n_pad,
                    int mask_rows, int bs, const float* __restrict__ L,
                    const int* __restrict__ nblk, Physics ph, Alch al,
                    float* __restrict__ f_part, float* __restrict__ e_part) {
    __shared__ float sx[BLOCK];
    __shared__ float sy[BLOCK];
    __shared__ float sz[BLOCK];
    __shared__ float ssig[BLOCK];
    __shared__ float sse[BLOCK];
    __shared__ float sq[BLOCK];
    __shared__ int sj[BLOCK];
    __shared__ float red[BLOCK];
    __shared__ int sg[ALCH ? BLOCK : 1];          // partners' region codes
    __shared__ float slam[ALCH ? MAX_LAM : 1];    // class scalars

    const int half = n_pad / 2;
    const int S = min(max(nblk[0], 0) * bs, half);
    const int tid = threadIdx.x;
    const int i0 = blockIdx.x * BLOCK;
    const int i = i0 + tid;
    const bool active = i < n;
    const float Lx = L[0], Ly = L[1], Lz = L[2];
    const float hx = 0.5f * Lx, hy = 0.5f * Ly, hz = 0.5f * Lz;
    // this block's partner offsets: slice blockIdx.y of -S..S
    const int per = (2 * S + 1 + gridDim.y - 1) / gridDim.y;
    const int o_lo = -S + blockIdx.y * per;
    const int o_hi = min(S, o_lo + per - 1);
    const int cover = 32 * mask_rows;
    const float two_over_sqrt_pi = 1.1283791670955126f;

    float xi = 0.0f, yi = 0.0f, zi = 0.0f, sig_i = 0.0f, se_i = 0.0f, kq_i = 0.0f;
    int g_i = 0;
    if (active) {
        xi = x[i];
        yi = x[n_pad + i];
        zi = x[2 * n_pad + i];
        sig_i = par[i];
        se_i = par[n_pad + i];
        kq_i = ph.ke * par[2 * n_pad + i];
        if (ALCH) g_i = __float2int_rn(par[3 * n_pad + i]);
    }
    const int R1 = al.n_regions + 1;
    const int n_cls = R1 * (R1 + 1) / 2 - 1;
    if (ALCH) {
        for (int k = tid; k < 3 * n_cls; k += BLOCK) slam[k] = al.lam[k];
        // (the first tile's barrier below orders these stores)
    }
    float fx = 0.0f, fy = 0.0f, fz = 0.0f, e_acc = 0.0f;

    if (S > 0) {
        for (int p0 = i0 + o_lo; p0 <= i0 + BLOCK - 1 + o_hi; p0 += BLOCK) {
            const int jm = ring_slot(p0 + tid, n_pad);
            sj[tid] = jm < n ? jm : -1;
            sx[tid] = x[jm];
            sy[tid] = x[n_pad + jm];
            sz[tid] = x[2 * n_pad + jm];
            ssig[tid] = par[jm];
            sse[tid] = par[n_pad + jm];
            sq[tid] = par[2 * n_pad + jm];
            if (ALCH) sg[tid] = __float2int_rn(par[3 * n_pad + jm]);
            __syncthreads();
            if (active) {
                for (int k = 0; k < BLOCK; ++k) {
                    const int o = p0 + k - i;
                    const int j = sj[k];
                    if (o < o_lo || o > o_hi || o == 0 || j < 0) continue;
                    const float dx = ring_delta(xi - sx[k], Lx, hx);
                    const float dy = ring_delta(yi - sy[k], Ly, hy);
                    const float dz = ring_delta(zi - sz[k], Lz, hz);
                    const float r2 = dist2_rn(dx, dy, dz);
                    if (!(r2 < ph.rc2 && r2 > 1e-12f)) continue;
                    const int ao = o > 0 ? o : -o;
                    if (ao <= cover) {
                        // bit ao-1 of lane i for i + ao, of lane j for i - ao
                        const int lane = o > 0 ? i : j;
                        const unsigned word = static_cast<unsigned>(
                            excl[((ao - 1) >> 5) * n_pad + lane]);
                        if ((word >> ((ao - 1) & 31)) & 1u) continue;
                    }
                    const float wt = (ao == half) ? 0.5f : 1.0f;
                    const float inv_r = rsqrtf(r2);
                    const float inv_r2 = inv_r * inv_r;
                    const float r = r2 * inv_r;
                    const float sig = 0.5f * (sig_i + ssig[k]);
                    const float eps = se_i * sse[k];
                    const float s2 = sig * sig * inv_r2;
                    float s6 = s2 * s2 * s2;
                    float e_lj, w_lj;
                    float lam_e = 1.0f;
                    int g_j = 0;
                    if (ALCH) {
                        // the pair's region-pair class; env-env keeps the
                        // identity scalars
                        g_j = sg[k];
                        const int a = min(g_i, g_j), b = max(g_i, g_j);
                        float lam_s = 1.0f, asc = 0.0f;
                        if (b > 0) {
                            const int ci = a * R1 - a * (a - 1) / 2 + (b - a) - 1;
                            lam_s = slam[ci];
                            asc = slam[n_cls + ci];
                            lam_e = slam[2 * n_cls + ci];
                        }
                        // softcore (beta = 0, c = 6); the clamp keeps
                        // asc s6 + 1 finite at deep overlap
                        s6 = fminf(s6, 1e18f);
                        const float inv_den = 1.0f / (asc * s6 + 1.0f);
                        const float xsc = s6 * inv_den;
                        const float el4 = (4.0f * eps) * lam_s;
                        e_lj = el4 * (xsc * xsc - xsc);
                        w_lj = (6.0f * el4) * (2.0f * xsc - 1.0f) * xsc *
                               inv_den * inv_r2;
                    } else {
                        const float s12 = s6 * s6;
                        e_lj = 4.0f * eps * (s12 - s6);
                        w_lj = eps * (48.0f * s12 - 24.0f * s6) * inv_r2;
                    }
                    const float qq = kq_i * sq[k];
                    float e_c, w_c;
                    if (ph.coulomb_rf) {
                        e_c = qq * (inv_r + ph.k_rf * r2 - ph.c_rf);
                        w_c = qq * (inv_r2 * inv_r - 2.0f * ph.k_rf);
                    } else if (ALCH && al.coulomb_plain && (g_i > 0 || g_j > 0)) {
                        // 'coulomb' PME treatment: plain 1/r for a pair
                        // with an alchemical member
                        e_c = qq * inv_r;
                        w_c = qq * inv_r2 * inv_r;
                    } else {
                        const float z = ph.alpha * r;
                        const float erfc_z = erfcf(z);
                        e_c = qq * erfc_z * inv_r;
                        w_c = qq * inv_r2 * (erfc_z * inv_r +
                                             two_over_sqrt_pi * ph.alpha *
                                                 expf(-z * z));
                    }
                    if (ALCH) {
                        e_c *= lam_e;
                        w_c *= lam_e;
                    }
                    float e, w;
                    if (ph.use_switch) {
                        const float t = fminf(
                            fmaxf((r - ph.r_switch) * ph.inv_span, 0.0f), 1.0f);
                        const float Sw =
                            1.0f + t * t * t * (-10.0f + t * (15.0f - 6.0f * t));
                        const float omt = 1.0f - t;
                        const float dS = (-30.0f * ph.inv_span) * (t * t) * (omt * omt);
                        if (ph.switch_coulomb) {
                            w = (w_lj + w_c) * Sw - (e_lj + e_c) * dS * inv_r;
                            e = (e_lj + e_c) * Sw;
                        } else {
                            w = w_lj * Sw - e_lj * dS * inv_r + w_c;
                            e = e_lj * Sw + e_c;
                        }
                    } else {
                        e = e_lj + e_c;
                        w = w_lj + w_c;
                    }
                    w *= wt;
                    fx += w * dx;
                    fy += w * dy;
                    fz += w * dz;
                    e_acc += e * wt;
                }
            }
            __syncthreads();
        }
    }

    const size_t base = static_cast<size_t>(blockIdx.y) * 3 * n_pad;
    f_part[base + i] = fx;
    f_part[base + n_pad + i] = fy;
    f_part[base + 2 * n_pad + i] = fz;
    red[tid] = e_acc;
    __syncthreads();
    for (int stride = BLOCK / 2; stride > 0; stride >>= 1) {
        if (tid < stride) red[tid] += red[tid + stride];
        __syncthreads();
    }
    if (tid == 0) e_part[blockIdx.y * gridDim.x + blockIdx.x] = red[0];
}

// Real is the energy total's type: float for the standard variant, double
// for the alchemical one (whose work sums differences of totals)
template <typename Real>
__global__ void __launch_bounds__(FINISH_BLOCK)
sweep_reduce_kernel(const float* __restrict__ f_part,
                    const float* __restrict__ e_part, int slices, int n_pad,
                    int m, float* __restrict__ F, Real* __restrict__ U) {
    __shared__ Real red[FINISH_BLOCK];
    const int tid = threadIdx.x;
    if (blockIdx.x == gridDim.x - 1) {
        // the last block sums the energy partials
        Real acc = 0;
        for (int k = tid; k < m; k += FINISH_BLOCK) acc += e_part[k];
        red[tid] = acc;
        __syncthreads();
        for (int stride = FINISH_BLOCK / 2; stride > 0; stride >>= 1) {
            if (tid < stride) red[tid] += red[tid + stride];
            __syncthreads();
        }
        // every pair was met from both of its ends
        if (tid == 0) U[0] = Real(0.5) * red[0];
        return;
    }
    const int idx = blockIdx.x * FINISH_BLOCK + tid;
    if (idx >= 3 * n_pad) return;
    float acc = 0.0f;
    for (int p = 0; p < slices; ++p) acc += f_part[static_cast<size_t>(p) * 3 * n_pad + idx];
    F[idx] = acc;
}

}  // namespace

extern "C" {

// The block bound nblk (1,) int: on rebuild (the bool rebuild[0] set) 1 +
// the last block of bs shells with a pair of real slots within sqrt(w2),
// else bound[0]. x (3, n_pad) sorted positions; partial holds
// (n_pad / 128) * 8 ints of scratch.
int sweep_bound_f32(const float* x, int n, int n_pad, const float* L, float w2,
                    int bs, const unsigned char* rebuild, const int* bound,
                    int* partial, int* nblk, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 grid(n_pad / BLOCK, SLICES);
    sweep_bound_kernel<<<grid, BLOCK, 0, s>>>(x, n, n_pad, L, w2, bs, rebuild,
                                              partial);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    bound_finish_kernel<<<1, FINISH_BLOCK, 0, s>>>(rebuild, bound, partial,
                                                  grid.x * grid.y, nblk);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

namespace {

template <bool ALCH, typename Real>
int launch_forces(const float* x, const float* par, const int* excl, int n,
                  int n_pad, int mask_rows, int bs, const float* L,
                  const int* nblk, const Physics& ph, const Alch& al,
                  float* f_part, float* e_part, float* F, Real* U,
                  void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 grid(n_pad / BLOCK, SLICES);
    sweep_forces_kernel<ALCH><<<grid, BLOCK, 0, s>>>(
        x, par, excl, n, n_pad, mask_rows, bs, L, nblk, ph, al, f_part,
        e_part);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int reduce_blocks = (3 * n_pad + FINISH_BLOCK - 1) / FINISH_BLOCK + 1;
    sweep_reduce_kernel<Real><<<reduce_blocks, FINISH_BLOCK, 0, s>>>(
        f_part, e_part, SLICES, n_pad, grid.x * grid.y, F, U);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Forces F (3, n_pad) and energy U (1,) of the bounded sweep at the bound
// nblk (1,) int read on the device. x, par (3, n_pad) sorted positions and
// [sigma, sqrt(eps), charge]; excl (mask_rows, n_pad) the exception
// bitfield; f_part (8, 3, n_pad) and e_part ((n_pad / 128) * 8) scratch.
int sweep_forces_f32(const float* x, const float* par, const int* excl, int n,
                     int n_pad, int mask_rows, int bs, const float* L,
                     const int* nblk, float rc2, int coulomb_rf, float alpha,
                     float k_rf, float c_rf, int use_switch, int switch_coulomb,
                     float r_switch, float inv_span, float ke, float* f_part,
                     float* e_part, float* F, float* U, void* stream) {
    const Physics ph{rc2, coulomb_rf, alpha, k_rf, c_rf, use_switch,
                     switch_coulomb, r_switch, inv_span, ke};
    const Alch al{nullptr, 0, 0};
    return launch_forces<false>(x, par, excl, n, n_pad, mask_rows, bs, L,
                                nblk, ph, al, f_part, e_part, F, U, stream);
}

// The alchemical variant: as sweep_forces_f32, with par (4, n_pad) [sigma,
// sqrt(eps), charge, region code], lam (3 C,) the class scalars on the
// device (C = (R+1)(R+2)/2 - 1 <= 152), n_regions R and coulomb_plain (the
// 'coulomb' PME treatment), and the energy U (1,) a double: the float32
// partials summed in double, so that the difference of two evaluations
// (the nonequilibrium work) is not rounded to a float32 total's ulp
// (0.03 kJ/mol at -3.2e5 kJ/mol).
int sweep_forces_alch_f32(const float* x, const float* par, const int* excl,
                          int n, int n_pad, int mask_rows, int bs,
                          const float* L, const int* nblk, float rc2,
                          int coulomb_rf, float alpha, float k_rf, float c_rf,
                          int use_switch, int switch_coulomb, float r_switch,
                          float inv_span, float ke, const float* lam,
                          int n_regions, int coulomb_plain, float* f_part,
                          float* e_part, float* F, double* U, void* stream) {
    const int n_cls = (n_regions + 1) * (n_regions + 2) / 2 - 1;
    if (n_regions < 1 || 3 * n_cls > MAX_LAM)
        return static_cast<int>(cudaErrorInvalidValue);
    const Physics ph{rc2, coulomb_rf, alpha, k_rf, c_rf, use_switch,
                     switch_coulomb, r_switch, inv_span, ke};
    const Alch al{lam, n_regions, coulomb_plain};
    return launch_forces<true>(x, par, excl, n, n_pad, mask_rows, bs, L,
                               nblk, ph, al, f_part, e_part, F, U, stream);
}

}  // extern "C"
