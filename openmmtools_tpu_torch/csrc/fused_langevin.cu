// LJ fluid force evaluation for Hopper (sm_90a): K1's standalone sweep.
//
// Replaces: openmmtools_tpu/ops/pallas_baoab.py:FusedSortedLangevin (the
// Pallas TPU kernel that integrates a whole chunk of any R/V/O splitting
// for a monodisperse, uncharged, periodic LJ fluid with a quintic switch).
// The chunk itself is dense_baoab.cu's lj_chunk_kernel, one cooperative
// launch a chunk for any splitting; this file holds the force evaluation
// alone, behind FusedSortedLangevin.forces() (the F and U of an integrator
// state, and the kernel's checks). The physics is the same as the TPU
// kernel's: minimum-image orthorhombic PBC, LJ with cutoff and OpenMM's
// quintic switch. The TPU layout is not carried over: the lane rolls,
// staircase tiles, poisoned pad lanes, the s = N/2 half weight and the
// x-sort existed because the TPU has no gathers.
//
// lj_forces_kernel: one warp a particle i sums ALL j (lj_common.cuh
// block_pairs: the block stages partner tiles in shared memory, lanes
// stride over them, a fixed shuffle tree sums the lanes), a full neighbour
// sum without Newton's third law, so there are no atomics and the result
// is deterministic; 16 warps a block. Its energy is
// reduced in the same launch: each block writes its warps' sum, and the
// last block to finish (an integer ticket) sums the partials in block
// order into U = 0.5 * the sum over i.
//
// What bounds it on the H100: the N^2 minimum-image distance tests (4.2M at
// N = 2048, about 25 instructions each, the ~6,500 pairs inside the cutoff
// a few more), FP32 instruction throughput; device memory traffic is
// negligible (positions are 24 KB and stay in L2, one tile a block). At
// N = 2048 the grid is 128 blocks of 16 warps, one block an SM.
//
// Every C entry point returns cudaGetLastError() after its launches; the
// Python wrapper raises if it is not 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lj_common.cuh"

namespace {

constexpr int FORCE_WARPS = 16;
constexpr int FORCE_BLOCK = FORCE_WARPS * 32;

__global__ void __launch_bounds__(FORCE_BLOCK)
lj_forces_kernel(const float* __restrict__ x, int n,
                 const float* __restrict__ L, lj::Params p,
                 float* __restrict__ F, float* __restrict__ u_partial,
                 unsigned int* __restrict__ ticket, float* __restrict__ U) {
    const int i = blockIdx.x * FORCE_WARPS + (threadIdx.x >> 5);
    float fx, fy, fz, e;
    lj::block_pairs<FORCE_WARPS>(x, n, i, L[0], L[1], L[2], p, fx, fy, fz,
                                 e);
    if (i < n && (threadIdx.x & 31) == 0) {
        F[i] = fx;
        F[n + i] = fy;
        F[2 * n + i] = fz;
    }
    __shared__ bool last;
    const float part = lj::block_sum<FORCE_WARPS>(e);
    if (threadIdx.x == 0) {
        u_partial[blockIdx.x] = part;
        __threadfence();   // the partial lands before the ticket is drawn
        last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    lj::sum_partials<FORCE_WARPS>(u_partial, gridDim.x, U);
    if (threadIdx.x == 0) *ticket = 0u;   // armed for the next launch
}

}  // namespace

extern "C" {

// Forces F (3, n) and energy U (1,) of positions x (3, n), in one launch;
// u_partial holds at least ceil(n / 16) floats of scratch, and ticket is an
// unsigned int that is 0 on entry and is 0 again on exit. L (3,) is the box
// diagonal.
int lj_forces_f32(const float* x, int n, const float* L, float rc2, float sig2,
                  float eps4, float eps24, float r_switch, float inv_span,
                  int use_switch, float* F, float* u_partial,
                  unsigned int* ticket, float* U, void* stream) {
    const int blocks = (n + FORCE_WARPS - 1) / FORCE_WARPS;
    const lj::Params p{rc2, sig2, eps4, eps24, r_switch, inv_span, use_switch,
                       1e-12f};
    lj_forces_kernel<<<blocks, FORCE_BLOCK, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        x, n, L, p, F, u_partial, ticket, U);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
