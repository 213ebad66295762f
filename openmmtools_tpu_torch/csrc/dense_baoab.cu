// Dense BAOAB + LJ fluid chunk for Hopper (sm_90a): a whole chunk in one
// cooperative launch.
//
// Replaces: openmmtools_tpu/ops/pallas_baoab.py:FusedDenseBAOAB (K3, the
// Pallas TPU kernel that integrates n_steps of BAOAB, "V R O R V", for a
// monodisperse, uncharged, periodic LJ fluid in one kernel, its positions,
// velocities and forces never leaving the core between steps). The physics
// is the same: x wrapped into [0, L) at the start and after every drift
// pair, LJ with cutoff and OpenMM's quintic switch under minimum-image
// orthorhombic PBC over ALL pairs (no sort, no bound), in-kernel Box-Muller
// noise, F and U of the final positions out. The TPU layout is not carried
// over: the staircase tiles, lane rolls, the s = N/2 half weight and the
// poisoned pad lanes existed because the TPU has no gathers.
//
// Design: one thread per particle keeps its x, v and F in registers for the
// whole chunk. A force evaluation is K1's all-pairs sweep (lj_common.cuh
// all_pairs: partner tiles in shared memory, the full neighbour sum without
// Newton's third law, so no atomics and a fixed summation order). Between
// the update and the force phase of a step the grid meets at
// cooperative_groups::this_grid().sync(): each thread publishes its drifted
// position into one of two position buffers, alternating by step, so that a
// buffer is never written while another block may still read it (one grid
// barrier a step suffices). The energy of the last evaluation is reduced per
// block, then after a final grid barrier by block 0 in a fixed order. The
// O step draws K1's Philox4x32-10 stream with counter (particle, step, 0, 0)
// and the 64-bit seed as key, so K1's plain chunk for "V R O R V"
// (ops/fused_langevin.py:fused_langevin_reference) is this kernel's plain
// version, noise included.
//
// The grid is ceil(N / 64) blocks of 64 (32 at N = 2048), which must all be
// co-resident: dense_baoab_max_blocks gives the limit (occupancy x SM
// count), and the wrapper raises past it.
//
// What bounds it on the H100: the force phase, N^2 pair evaluations a step
// (4.2M at N = 2048, ~35 FP32 operations each), FP32 throughput bound; at
// N = 2048 its 32 blocks occupy 32 of 132 SMs, and each thread walks all N
// partners serially, so the step runs at one thread's latency, as K1's
// sweep does. Memory traffic is negligible (24 KB of positions in L2). What
// the design removes against K1 is the host: no launch, no host loop and no
// grid-wide reduction kernel per step, one launch per chunk.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lj_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BLOCK = 64;

struct DenseArgs {
    float* x;          // (3, n) in: start positions; out: final, wrapped
    float* v;          // (3, n) in/out
    float* xb;         // (3, n) scratch: the second position buffer
    float* F;          // (3, n) out: forces of the final positions
    float* u_partial;  // (gridDim.x) scratch
    float* U;          // (1,) out: energy of the final positions
    const float* L;    // (3,) box diagonal
    const float* kT;   // (1,)
    int n, n_steps;
    lj::Params p;
    float h_R, hv_inv_m, ou_a, ou_b, inv_m;
    uint32_t k0, k1;
};

__device__ __forceinline__ float wrap(float x, float L) {
    return x - L * floorf(x * (1.0f / L));
}

__global__ void __launch_bounds__(BLOCK) dense_baoab_kernel(DenseArgs a) {
    cg::grid_group grid = cg::this_grid();
    __shared__ float sx[BLOCK];
    __shared__ float sy[BLOCK];
    __shared__ float sz[BLOCK];
    __shared__ float se[BLOCK];

    const int tid = threadIdx.x;
    const int n = a.n;
    const int i = blockIdx.x * BLOCK + tid;
    const bool active = i < n;
    const float Lx = a.L[0], Ly = a.L[1], Lz = a.L[2];
    const float sig = a.ou_b * sqrtf(a.kT[0] * a.inv_m);

    float px = 0.0f, py = 0.0f, pz = 0.0f, vx = 0.0f, vy = 0.0f, vz = 0.0f;
    if (active) {
        px = wrap(a.x[i], Lx);
        py = wrap(a.x[n + i], Ly);
        pz = wrap(a.x[2 * n + i], Lz);
        vx = a.v[i];
        vy = a.v[n + i];
        vz = a.v[2 * n + i];
    }
    float fx = 0.0f, fy = 0.0f, fz = 0.0f, e = 0.0f;
    // step -1 publishes the wrapped start and evaluates its forces; every
    // later step integrates, publishes and evaluates (one call site of the
    // pair loop)
    for (int step = -1; step < a.n_steps; ++step) {
        if (step >= 0) {
            vx += a.hv_inv_m * fx;             // V
            vy += a.hv_inv_m * fy;
            vz += a.hv_inv_m * fz;
            px += a.h_R * vx;                  // R
            py += a.h_R * vy;
            pz += a.h_R * vz;
            if (a.ou_b != 0.0f) {              // O
                float z0, z1, z2;
                lj::normal3(static_cast<uint32_t>(i),
                            static_cast<uint32_t>(step), 0u, a.k0, a.k1, z0,
                            z1, z2);
                vx = a.ou_a * vx + sig * z0;
                vy = a.ou_a * vy + sig * z1;
                vz = a.ou_a * vz + sig * z2;
            } else if (a.ou_a != 1.0f) {
                vx *= a.ou_a;
                vy *= a.ou_a;
                vz *= a.ou_a;
            }
            px += a.h_R * vx;                  // R
            py += a.h_R * vy;
            pz += a.h_R * vz;
            px = wrap(px, Lx);
            py = wrap(py, Ly);
            pz = wrap(pz, Lz);
        }
        float* out = (step & 1) ? a.x : a.xb;  // step -1 and odd: x
        if (active) {
            out[i] = px;
            out[n + i] = py;
            out[2 * n + i] = pz;
        }
        grid.sync();
        lj::all_pairs<BLOCK>(out, n, active, px, py, pz, Lx, Ly, Lz, a.p, sx,
                             sy, sz, fx, fy, fz, e);
        if (step >= 0) {
            vx += a.hv_inv_m * fx;             // V
            vy += a.hv_inv_m * fy;
            vz += a.hv_inv_m * fz;
        }
    }

    se[tid] = e;
    __syncthreads();
    for (int s = BLOCK / 2; s > 0; s >>= 1) {
        if (tid < s) se[tid] += se[tid + s];
        __syncthreads();
    }
    if (tid == 0) a.u_partial[blockIdx.x] = se[0];
    grid.sync();   // every block is past its last read of the buffers

    if (active) {
        a.x[i] = px;
        a.x[n + i] = py;
        a.x[2 * n + i] = pz;
        a.v[i] = vx;
        a.v[n + i] = vy;
        a.v[2 * n + i] = vz;
        a.F[i] = fx;
        a.F[n + i] = fy;
        a.F[2 * n + i] = fz;
    }
    if (blockIdx.x == 0) {
        float acc = 0.0f;
        for (int k = tid; k < static_cast<int>(gridDim.x); k += BLOCK)
            acc += a.u_partial[k];
        se[tid] = acc;
        __syncthreads();
        for (int s = BLOCK / 2; s > 0; s >>= 1) {
            if (tid < s) se[tid] += se[tid + s];
            __syncthreads();
        }
        // every unordered pair was counted from both ends
        if (tid == 0) a.U[0] = 0.5f * se[0];
    }
}

}  // namespace

extern "C" {

// The most blocks of 64 that can be co-resident for dense_baoab_kernel on
// the current device (0 without cooperative launch), in *out.
int dense_baoab_max_blocks(int* out) {
    return static_cast<int>(
        lj::max_coresident_blocks(dense_baoab_kernel, BLOCK, out));
}

// n_steps of BAOAB on x, v (3, n) in place: x wrapped, F (3, n) and U (1,)
// of the final positions; xb (3, n) and u_partial (ceil(n / 64)) are
// scratch. One cooperative launch of ceil(n / 64) blocks (the runtime
// refuses a grid that cannot be co-resident).
int dense_baoab_chunk_f32(float* x, float* v, float* xb, float* F,
                          float* u_partial, float* U, const float* L,
                          const float* kT, int n, int n_steps, float rc2,
                          float sig2, float eps4, float eps24, float r_switch,
                          float inv_span, int use_switch, float h_R,
                          float hv_inv_m, float ou_a, float ou_b, float inv_m,
                          uint64_t seed, void* stream) {
    const int blocks = (n + BLOCK - 1) / BLOCK;
    DenseArgs a{x, v, xb, F, u_partial, U, L, kT, n, n_steps,
                lj::Params{rc2, sig2, eps4, eps24, r_switch, inv_span,
                           use_switch, 1e-12f},
                h_R, hv_inv_m, ou_a, ou_b, inv_m,
                static_cast<uint32_t>(seed & 0xFFFFFFFFull),
                static_cast<uint32_t>(seed >> 32)};
    void* args[] = {&a};
    cudaError_t err = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(dense_baoab_kernel), dim3(blocks),
        dim3(BLOCK), args, 0, static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
