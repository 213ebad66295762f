// The LJ fluid chunk for Hopper (sm_90a): n_steps of any R/V/O splitting in
// one persistent cooperative launch.
//
// Replaces: openmmtools_tpu/ops/pallas_baoab.py:FusedDenseBAOAB (K3, the
// Pallas TPU kernel that integrates n_steps of BAOAB, "V R O R V", over all
// pairs in one kernel) and the chunk of FusedSortedLangevin (K1, any R/V/O
// splitting in one kernel). Both wrappers launch this one kernel
// (ops/fused_langevin.py): FusedSortedLangevin with its splitting's step
// program, FusedDenseBAOAB with "V R O R V". The physics is the TPU
// kernels': x wrapped into [0, L) at the start and after every run of
// drifts, LJ with cutoff and OpenMM's quintic switch under minimum-image
// orthorhombic PBC over ALL pairs (no sort, no bound), in-kernel
// Box-Muller noise, F and U of the final positions out. The TPU layout is
// not carried over: the staircase tiles, lane rolls, the s = N/2 half
// weight and the poisoned pad lanes existed because the TPU has no gathers.
//
// Design:
//  * The step program. ops/fused_langevin.py:_step_program cuts a step's
//    tokens at its force sweeps by K1's lazy rule (one sweep before the
//    first V after an R, and one at step end if positions moved); the
//    wrapper passes it as a table of at most MAX_ITEMS items in the launch
//    arguments, each a segment (up to 16 tokens, 2 bits each, the index of
//    its first O token, whether it wraps x) or a sweep. The kernel walks the
//    table once a step, so a splitting with two sweeps a step works too.
//  * A persistent grid: as many blocks of 16 warps as can be co-resident
//    (at most one warp a particle), and each warp owns the particles i =
//    w, w + W, ... (W warps in all). A warp applies its particles' segments
//    (every lane does the same arithmetic, lane 0 stores; v and F stay in
//    device memory, read and written only by their warp) and sums their
//    forces over all partners (lj_common.cuh block_pairs: the block stages
//    partner tiles in shared memory, lanes stride over them, a fixed
//    shuffle tree sums the lanes; no Newton's third law, no atomics).
//  * One grid barrier before each sweep (cooperative_groups this_grid()
//    .sync()): a segment that drifts x writes it into the other of two
//    position buffers, so a buffer is never written while a block may still
//    read it. Positions are read with plain loads, never through the
//    non-coherent read-only path: other blocks wrote them in this launch.
//  * Noise: the O token k of a segment draws Philox4x32-10 with counter
//    (particle, step, o_base + k, 0) under the 64-bit seed, so the host loop
//    over the plain versions (ops/fused_langevin.py:fused_langevin_reference)
//    is this kernel's plain version, noise included.
//  * Energy only where it is returned: the last sweep of the chunk, summed
//    per block in warp order, then by block 0 in block order after a final
//    grid barrier.
//
// What bounds it on the H100: the sweeps, N^2 minimum-image distance tests
// a sweep (4.2M at N = 2048, about 25 instructions each), FP32 instruction
// throughput, and at N = 2048 (one warp a particle, 128 blocks) the grid
// barrier and the sweep's latency a step. Memory traffic is negligible
// (24 KB of positions in L1/L2).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lj_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 16;
constexpr int BLOCK = WARPS * 32;
constexpr int MAX_ITEMS = 16;   // items of the step-program table
constexpr int ITEM_WORDS = 5;   // kind, n_tok, tok_code, o_base, wrap
constexpr uint32_t SWEEP = 1u;  // kind of a sweep; 0 is a segment

struct ChunkArgs {
    float* x;          // (3, n) in: start positions; out: final, wrapped
    float* v;          // (3, n) in/out
    float* xb;         // (3, n) scratch: the second position buffer
    float* F;          // (3, n) out: forces of the final positions
    float* u_partial;  // (gridDim.x) scratch
    float* U;          // (1,) out: energy of the final positions
    const float* L;    // (3,) box diagonal
    const float* kT;   // (1,)
    int n, n_steps, n_items;
    lj::Params p;
    float h_R, hv_inv_m, ou_a, ou_b, inv_m;
    uint32_t k0, k1;
    uint32_t table[MAX_ITEMS * ITEM_WORDS];
};

__device__ __forceinline__ float wrap(float x, float L) {
    return x - L * floorf(x * (1.0f / L));
}

// The segment `item` of the table on the warp's particles: the R/V/O tokens
// of langevin_substep_reference, then x wrapped into xout if the item
// wraps (else x is not touched).
__device__ __forceinline__ void segment(const ChunkArgs& a,
                                        const uint32_t* item, const float* xin,
                                        float* xout, int warp, int n_warps,
                                        uint32_t step, float sig) {
    const int n = a.n;
    const int n_tok = static_cast<int>(item[1]);
    const uint32_t code = item[2];
    const bool wraps = item[4] != 0u;
    const bool lead = (threadIdx.x & 31) == 0;
    for (int i = warp; i < n; i += n_warps) {
        float px = xin[i], py = xin[n + i], pz = xin[2 * n + i];
        float vx = a.v[i], vy = a.v[n + i], vz = a.v[2 * n + i];
        const float fx = a.F[i], fy = a.F[n + i], fz = a.F[2 * n + i];
        uint32_t o_idx = item[3];
        for (int k = 0; k < n_tok; ++k) {
            const uint32_t tok = (code >> (2 * k)) & 3u;
            if (tok == 0u) {            // R: drift
                px += a.h_R * vx;
                py += a.h_R * vy;
                pz += a.h_R * vz;
            } else if (tok == 1u) {     // V: kick with the last sweep's forces
                vx += a.hv_inv_m * fx;
                vy += a.hv_inv_m * fy;
                vz += a.hv_inv_m * fz;
            } else {                    // O: Ornstein-Uhlenbeck
                if (a.ou_b != 0.0f) {
                    float z0, z1, z2;
                    lj::normal3(static_cast<uint32_t>(i), step, o_idx, a.k0,
                                a.k1, z0, z1, z2);
                    vx = a.ou_a * vx + sig * z0;
                    vy = a.ou_a * vy + sig * z1;
                    vz = a.ou_a * vz + sig * z2;
                } else if (a.ou_a != 1.0f) {
                    vx *= a.ou_a;
                    vy *= a.ou_a;
                    vz *= a.ou_a;
                }
                ++o_idx;
            }
        }
        if (lead) {
            if (wraps) {
                const float Lx = a.L[0], Ly = a.L[1], Lz = a.L[2];
                xout[i] = wrap(px, Lx);
                xout[n + i] = wrap(py, Ly);
                xout[2 * n + i] = wrap(pz, Lz);
            }
            a.v[i] = vx;
            a.v[n + i] = vy;
            a.v[2 * n + i] = vz;
        }
    }
    __syncwarp();   // lane 0's stores reach the warp's other lanes
}

// Forces of the positions xs on the warp's particles into F; their energies
// added to e_warp when `last`. The loop runs equally often in every warp of
// the block (block_pairs stages tiles for the whole block); a warp whose
// particle lies past n helps stage them.
__device__ __forceinline__ void sweep(const ChunkArgs& a, const float* xs,
                                      int warp, int n_warps, bool last,
                                      float& e_warp) {
    const int n = a.n;
    const float Lx = a.L[0], Ly = a.L[1], Lz = a.L[2];
    for (int i0 = blockIdx.x * WARPS; i0 < n; i0 += n_warps) {
        const int i = i0 + warp - blockIdx.x * WARPS;
        float fx, fy, fz, e;
        lj::block_pairs<WARPS>(xs, n, i, Lx, Ly, Lz, a.p, fx, fy, fz, e);
        if (i < n) {
            if ((threadIdx.x & 31) == 0) {
                a.F[i] = fx;
                a.F[n + i] = fy;
                a.F[2 * n + i] = fz;
            }
            if (last) e_warp += e;
        }
    }
    __syncwarp();
}

__global__ void __launch_bounds__(BLOCK, 2)
lj_chunk_kernel(const __grid_constant__ ChunkArgs a) {
    cg::grid_group grid = cg::this_grid();
    const int n = a.n;
    const int warp = blockIdx.x * WARPS + (threadIdx.x >> 5);
    const int n_warps = gridDim.x * WARPS;
    const float sig = a.ou_b * sqrtf(a.kT[0] * a.inv_m);
    int last_item = -1;   // the step's last sweep
    for (int k = 0; k < a.n_items; ++k)
        if (a.table[k * ITEM_WORDS] == SWEEP) last_item = k;

    // chunk start: the wrapped start into buffer 1, and its sweep
    if ((threadIdx.x & 31) == 0) {
        const float Lx = a.L[0], Ly = a.L[1], Lz = a.L[2];
        for (int i = warp; i < n; i += n_warps) {
            a.xb[i] = wrap(a.x[i], Lx);
            a.xb[n + i] = wrap(a.x[n + i], Ly);
            a.xb[2 * n + i] = wrap(a.x[2 * n + i], Lz);
        }
    }
    float e_warp = 0.0f;
    int cur = 1;   // the buffer of the current positions: 0 is x, 1 is xb
    grid.sync();
    sweep(a, a.xb, warp, n_warps, a.n_steps == 0 || last_item < 0,
          e_warp);
    for (int step = 0; step < a.n_steps; ++step) {
        for (int k = 0; k < a.n_items; ++k) {
            const uint32_t* item = a.table + k * ITEM_WORDS;
            if (item[0] == SWEEP) {
                grid.sync();   // every drifted position is published
                cur ^= 1;
                sweep(a, cur ? a.xb : a.x, warp, n_warps,
                      step == a.n_steps - 1 && k == last_item, e_warp);
            } else {
                segment(a, item, cur ? a.xb : a.x, cur ? a.x : a.xb, warp,
                        n_warps,
                        static_cast<uint32_t>(step), sig);
            }
        }
    }

    // the final positions into x: x, when it is not the current buffer, was
    // last read by the sweep before the last grid barrier
    if (cur == 1 && (threadIdx.x & 31) == 0) {
        for (int i = warp; i < n; i += n_warps) {
            a.x[i] = a.xb[i];
            a.x[n + i] = a.xb[n + i];
            a.x[2 * n + i] = a.xb[2 * n + i];
        }
    }
    const float part = lj::block_sum<WARPS>(e_warp);
    if (threadIdx.x == 0) a.u_partial[blockIdx.x] = part;
    grid.sync();
    if (blockIdx.x == 0) lj::sum_partials<WARPS>(a.u_partial, gridDim.x, a.U);
}

}  // namespace

extern "C" {

// n_steps of the step program `table` (n_items items of ITEM_WORDS words)
// on x, v (3, n) in place: x wrapped, F (3, n) and U (1,) of the final
// positions; xb (3, n) and u_partial (at least ceil(n / 16) floats) are
// scratch. table is host memory, copied into the launch arguments. One
// cooperative launch of at most the co-resident blocks.
int lj_chunk_f32(float* x, float* v, float* xb, float* F, float* u_partial,
                 float* U, const float* L, const float* kT, int n, int n_steps,
                 const uint32_t* table, int n_items, float rc2, float sig2,
                 float eps4, float eps24, float r_switch, float inv_span,
                 int use_switch, float h_R, float hv_inv_m, float ou_a,
                 float ou_b, float inv_m, uint64_t seed, void* stream) {
    if (n_items < 0 || n_items > MAX_ITEMS)
        return static_cast<int>(cudaErrorInvalidValue);
    int max_blocks = 0;
    cudaError_t err = lj::max_coresident_blocks(lj_chunk_kernel, BLOCK,
                                                &max_blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (max_blocks == 0)
        return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    const int wanted = (n + WARPS - 1) / WARPS;
    const int blocks = wanted < max_blocks ? wanted : max_blocks;
    ChunkArgs a{x, v, xb, F, u_partial, U, L, kT, n, n_steps, n_items,
                lj::Params{rc2, sig2, eps4, eps24, r_switch, inv_span,
                           use_switch, 1e-12f},
                h_R, hv_inv_m, ou_a, ou_b, inv_m,
                static_cast<uint32_t>(seed & 0xFFFFFFFFull),
                static_cast<uint32_t>(seed >> 32), {}};
    for (int w = 0; w < n_items * ITEM_WORDS; ++w) a.table[w] = table[w];
    void* args[] = {&a};
    err = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(lj_chunk_kernel), dim3(blocks),
        dim3(BLOCK), args, 0, static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
