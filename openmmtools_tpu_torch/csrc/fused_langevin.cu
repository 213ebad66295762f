// Fused Langevin splitting + LJ fluid kernels for Hopper (sm_90a).
//
// Replaces: openmmtools_tpu/ops/pallas_baoab.py:FusedSortedLangevin (the
// Pallas TPU kernel that integrates a whole chunk of any R/V/O splitting
// for a monodisperse, uncharged, periodic LJ fluid with a quintic switch).
// The physics is the same: minimum-image orthorhombic PBC, LJ with cutoff
// and OpenMM's quintic switch, one force sweep per step, Box-Muller noise
// drawn in the kernel, positions wrapped into [0, L). The TPU layout is not
// carried over: the lane rolls, staircase tiles, poisoned pad lanes, the
// s = N/2 half weight and the x-sort existed because the TPU has no gathers.
//
// Two kernels plus a one-block reduction, driven step by step from the host
// (openmmtools_tpu_torch/ops/fused_langevin.py):
//
//  * lj_forces_kernel: one thread per particle i loops over ALL j in tiles
//    of positions staged in shared memory, and accumulates F_i and its
//    energy in registers -- a full neighbour sum without Newton's third
//    law, so there are no atomics and the result is deterministic. The
//    ragged edge (N not a multiple of the block) is masked, not padded.
//    Per-block energy partials are summed by sum_energy_kernel (U = 0.5 *
//    the sum over i), so U is computed here and not by a library reduction.
//  * langevin_substep_kernel: elementwise; applies one run of R/V/O tokens
//    between force evaluations and wraps x after R tokens. The O-step
//    noise is a Philox4x32-10 stream keyed by a 64-bit seed (drawn by the
//    wrapper from the caller's torch.Generator), with the counter
//    (particle, step, O-token index, 0).
//
// What bounds it on the H100: the all-pairs sweep is N^2 pair evaluations
// (4.2M at N = 2048, ~35 FP32 operations each), so it is bound by FP32
// issue in the pair loop, and at N = 2048 by occupancy: N/64 = 32 blocks
// leave most of the 132 SMs idle. Device memory traffic is negligible
// (positions are 24 KB and stay in L2). The substep kernel moves 36 bytes
// a particle and is bound by launch latency, as is the host loop of ~4
// launches a step. The design answers correctness first: small blocks
// spread the sweep over more SMs, and shared-memory tiles keep the inner
// loop free of global loads. Making it fast (a cell list in place of the
// all-pairs loop, a skin-bounded rebuild, many steps per launch or a CUDA
// graph) is later work.
//
// The pair term, the tile loop and the noise draw live in lj_common.cuh,
// shared with K3 (dense_baoab.cu) and K4 (cell_md.cu).
//
// Every C entry point returns cudaGetLastError() after its launches; the
// Python wrapper raises if it is not 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lj_common.cuh"

namespace {

constexpr int FORCE_BLOCK = 64;
constexpr int REDUCE_BLOCK = 256;
constexpr int SUBSTEP_BLOCK = 256;

__global__ void __launch_bounds__(FORCE_BLOCK)
lj_forces_kernel(const float* __restrict__ x, int n,
                 const float* __restrict__ L, lj::Params p,
                 float* __restrict__ F, float* __restrict__ u_partial) {
    __shared__ float sx[FORCE_BLOCK];
    __shared__ float sy[FORCE_BLOCK];
    __shared__ float sz[FORCE_BLOCK];
    __shared__ float se[FORCE_BLOCK];

    const int tid = threadIdx.x;
    const int i = blockIdx.x * FORCE_BLOCK + tid;
    const bool active = i < n;

    float xi = 0.0f, yi = 0.0f, zi = 0.0f;
    if (active) {
        xi = x[i];
        yi = x[n + i];
        zi = x[2 * n + i];
    }
    float fx, fy, fz, e_acc;
    lj::all_pairs<FORCE_BLOCK>(x, n, active, xi, yi, zi, L[0], L[1], L[2], p,
                               sx, sy, sz, fx, fy, fz, e_acc);

    if (active) {
        F[i] = fx;
        F[n + i] = fy;
        F[2 * n + i] = fz;
    }
    se[tid] = e_acc;
    __syncthreads();
    for (int s = FORCE_BLOCK / 2; s > 0; s >>= 1) {
        if (tid < s) se[tid] += se[tid + s];
        __syncthreads();
    }
    if (tid == 0) u_partial[blockIdx.x] = se[0];
}

__global__ void __launch_bounds__(REDUCE_BLOCK)
sum_energy_kernel(const float* __restrict__ u_partial, int m,
                  float* __restrict__ U) {
    __shared__ float s[REDUCE_BLOCK];
    const int tid = threadIdx.x;
    float acc = 0.0f;
    for (int k = tid; k < m; k += REDUCE_BLOCK) acc += u_partial[k];
    s[tid] = acc;
    __syncthreads();
    for (int stride = REDUCE_BLOCK / 2; stride > 0; stride >>= 1) {
        if (tid < stride) s[tid] += s[tid + stride];
        __syncthreads();
    }
    // every unordered pair was counted from both ends
    if (tid == 0) U[0] = 0.5f * s[0];
}

__global__ void __launch_bounds__(SUBSTEP_BLOCK)
langevin_substep_kernel(float* __restrict__ x, float* __restrict__ v,
                        const float* __restrict__ F, int n,
                        const float* __restrict__ L,
                        const float* __restrict__ kT,
                        int n_tok, uint32_t tok_code,
                        float h_R, float hv_inv_m, float ou_a, float ou_b,
                        float inv_m, uint32_t k0, uint32_t k1, uint32_t step,
                        uint32_t o_base, int wrap) {
    const int i = blockIdx.x * SUBSTEP_BLOCK + threadIdx.x;
    if (i >= n) return;
    float px = x[i], py = x[n + i], pz = x[2 * n + i];
    float vx = v[i], vy = v[n + i], vz = v[2 * n + i];
    const float sig = ou_b * sqrtf(kT[0] * inv_m);
    uint32_t o_idx = o_base;
    for (int k = 0; k < n_tok; ++k) {
        const uint32_t tok = (tok_code >> (2 * k)) & 3u;
        if (tok == 0u) {            // R: drift
            px += h_R * vx;
            py += h_R * vy;
            pz += h_R * vz;
        } else if (tok == 1u) {     // V: kick with the last sweep's forces
            vx += hv_inv_m * F[i];
            vy += hv_inv_m * F[n + i];
            vz += hv_inv_m * F[2 * n + i];
        } else {                    // O: Ornstein-Uhlenbeck
            if (ou_b != 0.0f) {
                float z0, z1, z2;
                lj::normal3(static_cast<uint32_t>(i), step, o_idx, k0, k1,
                            z0, z1, z2);
                vx = ou_a * vx + sig * z0;
                vy = ou_a * vy + sig * z1;
                vz = ou_a * vz + sig * z2;
            } else if (ou_a != 1.0f) {
                vx *= ou_a;
                vy *= ou_a;
                vz *= ou_a;
            }
            ++o_idx;
        }
    }
    if (wrap) {
        const float Lx = L[0], Ly = L[1], Lz = L[2];
        px = px - Lx * floorf(px * (1.0f / Lx));
        py = py - Ly * floorf(py * (1.0f / Ly));
        pz = pz - Lz * floorf(pz * (1.0f / Lz));
    }
    x[i] = px;
    x[n + i] = py;
    x[2 * n + i] = pz;
    v[i] = vx;
    v[n + i] = vy;
    v[2 * n + i] = vz;
}

}  // namespace

extern "C" {

// Forces F (3, n) and energy U (1,) of positions x (3, n); u_partial holds
// at least ceil(n / 64) floats of scratch. L (3,) is the box diagonal.
int lj_forces_f32(const float* x, int n, const float* L, float rc2, float sig2,
                  float eps4, float eps24, float r_switch, float inv_span,
                  int use_switch, float* F, float* u_partial, float* U,
                  void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int blocks = (n + FORCE_BLOCK - 1) / FORCE_BLOCK;
    const lj::Params p{rc2, sig2, eps4, eps24, r_switch, inv_span, use_switch,
                       1e-12f};
    lj_forces_kernel<<<blocks, FORCE_BLOCK, 0, s>>>(x, n, L, p, F, u_partial);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    sum_energy_kernel<<<1, REDUCE_BLOCK, 0, s>>>(u_partial, blocks, U);
    return static_cast<int>(cudaGetLastError());
}

// One run of n_tok <= 16 R/V/O tokens (2 bits each in tok_code: 0 = R,
// 1 = V, 2 = O) on x, v (3, n) in place; wrap != 0 wraps x into [0, L).
int langevin_substep_f32(float* x, float* v, const float* F, int n,
                         const float* L, const float* kT, int n_tok,
                         uint32_t tok_code, float h_R, float hv_inv_m,
                         float ou_a, float ou_b, float inv_m, uint64_t seed,
                         uint32_t step, uint32_t o_base, int wrap,
                         void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int blocks = (n + SUBSTEP_BLOCK - 1) / SUBSTEP_BLOCK;
    langevin_substep_kernel<<<blocks, SUBSTEP_BLOCK, 0, s>>>(
        x, v, F, n, L, kT, n_tok, tok_code, h_R, hv_inv_m, ou_a, ou_b, inv_m,
        static_cast<uint32_t>(seed & 0xFFFFFFFFull),
        static_cast<uint32_t>(seed >> 32), step, o_base, wrap);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
