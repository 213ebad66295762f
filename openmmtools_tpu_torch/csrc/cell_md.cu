// Cell-grid LJ forces and BAOAB chunk for Hopper (sm_90a).
//
// Replaces: openmmtools_tpu/ops/pallas_md.py:503, the pl.pallas_call of
// FusedLJBAOAB._kernel_call (K4, the Pallas TPU kernel of _make_kernel:
// BAOAB, "V R O R V", over one rebuild interval for a monodisperse,
// uncharged LJ fluid binned into a cell grid, and its forces_only variant).
// The physics and the layout at the boundary are the same: particles sit in
// slots (3, M, G) of the padded grid, G = (n_side + 2)^3 cells of edge >= the
// cutoff, M slots a cell, filled rank-contiguously by
// ops/fused_md.py:bin_particles (slot m of a cell holds a particle exactly
// when m < the cell's occupancy); the pair term is pair_scale's (r^2 in
// (1e-6, rc^2), the quintic switch, through lj_common.cuh); plain coordinate
// differences, no minimum image; no wrap inside the chunk (the rebin wraps);
// empty slots are never written; no energy. The TPU design is not carried
// over: the cell on the lane axis, neighbour cells as lane rolls, the ghost
// layers filled by masked rolls, the Newton reaction folded back through
// the ghosts, the k < max_occ level gating and the dual 8-slot kernel all
// existed because the TPU has no gathers and its cost is linear in a static
// capacity.
//
// What bounds it on the H100: latency, neither bytes (the slot arrays, 288
// KB each at LJ-2048's capacity 24, sit in L2) nor the card's FP32 rate
// (about 6,600 pairs inside the cutoff a step at the fullest bin). A step
// lasts as long as its fullest cell takes, behind one grid barrier: as the
// fluid condenses a droplet cell holds 24 particles with 27 x 24 partners
// each, while most cells hold few or none. One thread a slot walked those
// 648 partners as one serial chain of dependent global loads (0.042 ms a
// step on an NVIDIA H100 80GB HBM3 at 700 W). So the design spreads the
// fullest cell's pairs over a block's lanes, which leaves a step to the grid
// barrier, one L2 round trip to stage the neighbourhood, and the fullest
// cell's few rounds of pairs on its SM:
//
//  * one block of WARPS warps a cell. It stages the occupied slots of the
//    cell and its 26 neighbours (dz, dy, dx from -1 to 1, then slot k < the
//    occupancy) into dynamic shared memory, 27 x rows x 12 bytes (rows: the
//    slot rows used, >= the bin's largest occupancy; past it a cell's slots
//    are cut at rows, as the plain version cuts them), each shifted by its
//    periodic image: s = x + shift, which is the plain version's xj + shift,
//    so xi - s rounds the same way. A neighbour across the boundary is found
//    by wrapping the cell index and shifting by -+L, what the TPU kernel's
//    ghost fill computes without the copies. A cell with no particle costs
//    one occupancy read;
//  * the cell's particles i go to the warps in turn (i = warp + WARPS r);
//    for each, lane l of the warp takes the staged partners l, l + 32, ...,
//    four at a time from shared memory, and a xor butterfly of shuffles sums
//    the 32 lanes; lane r keeps particle r's total. Every particle sums all
//    of its partners (no Newton reaction): no atomics, and the summation
//    order is fixed, so two launches give the same bits. The fullest cell's
//    warps wait on latency more than on issue slots: compacting the pairs
//    inside the cutoff into a queue (K2's pattern), or 16 or 32 warps a
//    block, measured slower on the condensed LJ-2048 fluid;
//  * cell_forces_f32: the forces (forces_only), one block a cell;
//  * cell_chunk_f32: n_steps of "V R O R [forces] V" in one cooperative
//    launch of persistent blocks, at most the co-resident count (sized with
//    the dynamic shared memory), each taking cells c = block, block + grid,
//    ... A prologue runs step 0's "V R O R" from the caller's forces (F, from
//    cell_forces_f32 after the bin); then each step is one force phase and
//    one grid barrier: a block stages its cell from the positions of the
//    step, and the lane that keeps a particle's force kicks it (V) and runs
//    the next step's "V R O R" for it at once, writing the other of the two
//    position arrays. Nobody reads that array in this step, and each slot's
//    velocity is written only by its cell's block, so one barrier a step
//    suffices. The occupancy is fixed within the chunk, so a block that
//    holds one cell (every block at LJ-2048, whose 512 cells fit the
//    co-resident blocks) builds the cell's neighbour table once and stages
//    positions alone.
//    O draws Philox4x32-10 (lj_common.cuh normal3) with counter (m G + g,
//    step, 0, 0) and the chunk's 64-bit seed as key. F holds the forces of
//    the final x on exit; the final positions are copied into x in the last
//    step when n_steps is odd.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lj_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 8;              // warps a block; one block a cell
constexpr int BLOCK = WARPS * 32;
constexpr int NB = 27;                // a cell and its 26 neighbours
constexpr int SMEM_DEFAULT = 48 * 1024;   // dynamic shared memory unasked

struct Grid {
    int ns;     // interior cells a side
    int M;      // slots a cell
    int rows;   // slot rows used (>= the largest occupancy)
    float L;    // cubic box edge
};

// The block's staged neighbourhood of one cell.
struct Hood {
    int n_home;   // the cell's particles
    int home;     // staged index of its slot 0
    int n;        // partners staged
};

// Padded id of interior cell c (x fastest).
__device__ __forceinline__ int padded_cell(int c, int ns) {
    const int gs = ns + 2;
    return (c % ns + 1) + gs * ((c / ns) % ns + 1 + gs * (c / (ns * ns) + 1));
}

__host__ __device__ __forceinline__ int staged_floats(int rows) {
    return 3 * NB * rows;
}

// The neighbour table of padded cell g, by the first warp: for neighbour k
// (dz, dy, dx from -1 to 1, dx fastest) its padded id, the shift of its
// periodic image, and the offset of its slots among the staged partners
// (an exclusive scan of the occupancies, each cut at rows).
__device__ __forceinline__ void build_table(const int* occ, const Grid& gr,
                                            int g, int* nb_g, int* nb_off,
                                            float (*nb_sh)[NB]) {
    if (threadIdx.x >= 32) return;
    const int ns = gr.ns, gs = ns + 2;
    const int k = threadIdx.x;
    int on = 0;
    if (k < NB) {
        int c[3] = {g % gs + k % 3 - 1, (g / gs) % gs + (k / 3) % 3 - 1,
                    g / (gs * gs) + k / 9 - 1};
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            float sh = 0.0f;
            if (c[a] == 0) { c[a] = ns; sh = -gr.L; }
            else if (c[a] == ns + 1) { c[a] = 1; sh = gr.L; }
            nb_sh[a][k] = sh;
        }
        const int gn = c[0] + gs * (c[1] + gs * c[2]);
        nb_g[k] = gn;
        on = min(occ[gn], gr.rows);
    }
    int incl = on;   // inclusive scan of the occupancies over the lanes
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(lj::FULL_MASK, incl, d);
        if (k >= d) incl += t;
    }
    if (k < NB) nb_off[k + 1] = incl;
    if (k == 0) nb_off[0] = 0;
}

// Stages the occupied slots m < rows of padded cell g and its neighbours
// from x (3, M, G) into s: s[j], s[cap + j], s[2 cap + j] for partner j,
// cap = 27 rows. The neighbour table (ids, offsets, shifts) depends on g and
// the occupancy alone; `held` says the block built it for g last time and
// keeps it. Every thread of the block calls it.
__device__ Hood stage(const float* x, const int* occ, const Grid& gr, int g,
                      bool held, float* s) {
    __shared__ int nb_g[NB], nb_off[NB + 1];
    __shared__ float nb_sh[3][NB];
    const int ns = gr.ns, gs = ns + 2, G = gs * gs * gs, MG = gr.M * G;
    const int cap = NB * gr.rows;
    __syncthreads();   // every warp is done with the previous cell
    if (!held) {
        build_table(occ, gr, g, nb_g, nb_off, nb_sh);
        __syncthreads();
    }
    const int n = nb_off[NB];
    for (int j = threadIdx.x; j < n; j += BLOCK) {
        int k = 0;   // the last neighbour whose partners start at or before j
#pragma unroll
        for (int step = 16; step > 0; step >>= 1)
            if (k + step < NB && nb_off[k + step] <= j) k += step;
        const int slot = (j - nb_off[k]) * G + nb_g[k];
        s[j] = x[slot] + nb_sh[0][k];
        s[cap + j] = x[MG + slot] + nb_sh[1][k];
        s[2 * cap + j] = x[2 * MG + slot] + nb_sh[2][k];
    }
    __syncthreads();
    return Hood{nb_off[NB / 2 + 1] - nb_off[NB / 2], nb_off[NB / 2], n};
}

// Forces on the cell's particles i = base + warp + WARPS r, r = 0..31, from
// the staged neighbourhood: lane r of each warp returns particle r's force
// (zero where i is past the cell's particles).
__device__ __forceinline__ void home_forces(const float* s, int cap,
                                            const Hood& h, const lj::Params& p,
                                            int base, float& kx, float& ky,
                                            float& kz) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    kx = ky = kz = 0.0f;
    for (int r = 0; r < 32; ++r) {
        const int i = base + warp + WARPS * r;
        if (i >= h.n_home) break;   // the same for every lane of the warp
        const float xi = s[h.home + i];
        const float yi = s[cap + h.home + i];
        const float zi = s[2 * cap + h.home + i];
        float fx = 0.0f, fy = 0.0f, fz = 0.0f, e_unused = 0.0f;
        int j = lane;
        // four partners a lane at a time, their distances first: the
        // shared-memory loads of the four overlap
        for (; j + 96 < h.n; j += 128) {
            float dx[4], dy[4], dz[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                dx[u] = xi - s[j + 32 * u];
                dy[u] = yi - s[cap + j + 32 * u];
                dz[u] = zi - s[2 * cap + j + 32 * u];
            }
#pragma unroll
            for (int u = 0; u < 4; ++u)
                lj::add_pair(dx[u], dy[u], dz[u], p, fx, fy, fz, e_unused);
        }
        for (; j < h.n; j += 32)
            lj::add_pair(xi - s[j], yi - s[cap + j], zi - s[2 * cap + j], p,
                         fx, fy, fz, e_unused);
#pragma unroll
        for (int offset = 16; offset > 0; offset >>= 1) {
            fx += __shfl_xor_sync(lj::FULL_MASK, fx, offset);
            fy += __shfl_xor_sync(lj::FULL_MASK, fy, offset);
            fz += __shfl_xor_sync(lj::FULL_MASK, fz, offset);
        }
        if (lane == r) {
            kx = fx;
            ky = fy;
            kz = fz;
        }
    }
}

__global__ void __launch_bounds__(BLOCK)
cell_forces_kernel(const float* __restrict__ x, const int* __restrict__ occ,
                   Grid gr, lj::Params p, float* __restrict__ F) {
    extern __shared__ float s[];
    const int ns = gr.ns, gs = ns + 2, G = gs * gs * gs, MG = gr.M * G;
    const int g = padded_cell(blockIdx.x, ns);
    if (occ[g] == 0) return;   // the whole block
    const Hood h = stage(x, occ, gr, g, false, s);
    const int i0 = (threadIdx.x >> 5) + WARPS * (threadIdx.x & 31);
    for (int base = 0; base < h.n_home; base += 32 * WARPS) {
        float fx, fy, fz;
        home_forces(s, NB * gr.rows, h, p, base, fx, fy, fz);
        if (base + i0 < h.n_home) {
            const int slot = (base + i0) * G + g;
            F[slot] = fx;
            F[MG + slot] = fy;
            F[2 * MG + slot] = fz;
        }
    }
}

struct ChunkArgs {
    float* x;          // (3, M, G) in/out, positions
    float* xb;         // (3, M, G) scratch: the second position array
    float* v;          // (3, M, G) in/out, velocities
    float* F;          // (3, M, G) in: forces of x; out: of the final x
    const int* occ;    // (G,) occupancy
    const float* kT;   // (1,)
    Grid gr;
    lj::Params p;
    int n_steps;
    float half_dt, kick, ou_a, ou_b, inv_m;   // kick = half_dt / mass
    uint32_t k0, k1;
};

// "R O R" of step `step` for the slot at s with its kicked velocity
// (vx, vy, vz): the drifted position from cur into nxt, the velocity into v.
__device__ __forceinline__ void drift(const ChunkArgs& a, int MG, int s,
                                      int step, float sig, const float* cur,
                                      float* nxt, float vx, float vy,
                                      float vz) {
    const float px = cur[s] + a.half_dt * vx;
    const float py = cur[MG + s] + a.half_dt * vy;
    const float pz = cur[2 * MG + s] + a.half_dt * vz;
    if (a.ou_b != 0.0f) {
        float z0, z1, z2;
        lj::normal3(static_cast<uint32_t>(s), static_cast<uint32_t>(step), 0u,
                    a.k0, a.k1, z0, z1, z2);
        vx = a.ou_a * vx + sig * z0;
        vy = a.ou_a * vy + sig * z1;
        vz = a.ou_a * vz + sig * z2;
    } else if (a.ou_a != 1.0f) {
        vx *= a.ou_a;
        vy *= a.ou_a;
        vz *= a.ou_a;
    }
    nxt[s] = px + a.half_dt * vx;
    nxt[MG + s] = py + a.half_dt * vy;
    nxt[2 * MG + s] = pz + a.half_dt * vz;
    a.v[s] = vx;
    a.v[MG + s] = vy;
    a.v[2 * MG + s] = vz;
}

__global__ void __launch_bounds__(BLOCK) cell_chunk_kernel(ChunkArgs a) {
    extern __shared__ float s[];
    cg::grid_group grid = cg::this_grid();
    const Grid gr = a.gr;
    const int ns = gr.ns, gs = ns + 2, G = gs * gs * gs, MG = gr.M * G;
    const int n_cells = ns * ns * ns, cap = NB * gr.rows;
    const float sig = a.ou_b * sqrtf(a.kT[0] * a.inv_m);

    // step 0's V R O R from the caller's x and F into xb
    for (int c = blockIdx.x; c < n_cells; c += gridDim.x) {
        const int g = padded_cell(c, ns);
        const int n_home = min(a.occ[g], gr.rows);
        for (int m = threadIdx.x; m < n_home; m += BLOCK) {
            const int slot = m * G + g;
            drift(a, MG, slot, 0, sig, a.x, a.xb,
                  a.v[slot] + a.kick * a.F[slot],
                  a.v[MG + slot] + a.kick * a.F[MG + slot],
                  a.v[2 * MG + slot] + a.kick * a.F[2 * MG + slot]);
        }
    }
    grid.sync();

    const int i0 = (threadIdx.x >> 5) + WARPS * (threadIdx.x & 31);
    int held = -1;   // the cell whose neighbour table the block holds
    for (int step = 0; step < a.n_steps; ++step) {
        float* cur = (step & 1) ? a.x : a.xb;   // positions after the drift
        float* nxt = (step & 1) ? a.xb : a.x;   // ... and after the next one
        const bool last = step + 1 == a.n_steps;
        for (int c = blockIdx.x; c < n_cells; c += gridDim.x) {
            const int g = padded_cell(c, ns);
            // the whole block; a held cell is occupied (the occupancy is
            // fixed within the chunk), and a block of one cell holds it
            if (g != held && a.occ[g] == 0) continue;
            const Hood h = stage(cur, a.occ, gr, g, g == held, s);
            held = g;
            for (int base = 0; base < h.n_home; base += 32 * WARPS) {
                float fx, fy, fz;
                home_forces(s, cap, h, a.p, base, fx, fy, fz);
                if (base + i0 >= h.n_home) continue;
                const int slot = (base + i0) * G + g;
                const float vx = a.v[slot] + a.kick * fx;          // V
                const float vy = a.v[MG + slot] + a.kick * fy;
                const float vz = a.v[2 * MG + slot] + a.kick * fz;
                if (!last) {                                      // V R O R
                    drift(a, MG, slot, step + 1, sig, cur, nxt,
                          vx + a.kick * fx, vy + a.kick * fy,
                          vz + a.kick * fz);
                    continue;
                }
                a.v[slot] = vx;
                a.v[MG + slot] = vy;
                a.v[2 * MG + slot] = vz;
                a.F[slot] = fx;
                a.F[MG + slot] = fy;
                a.F[2 * MG + slot] = fz;
                if (a.n_steps & 1) {   // the final positions are in xb
                    a.x[slot] = cur[slot];
                    a.x[MG + slot] = cur[MG + slot];
                    a.x[2 * MG + slot] = cur[2 * MG + slot];
                }
            }
        }
        if (!last) grid.sync();
    }
}

lj::Params cell_params(float rc2, float sig2, float eps4, float eps24,
                       float r_switch, float inv_span, int use_switch) {
    return lj::Params{rc2, sig2, eps4, eps24, r_switch, inv_span, use_switch,
                      1e-6f};
}

// Lets `kernel` take `bytes` of dynamic shared memory (past the 48 KB a
// block gets without asking; refused past the card's limit).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
    if (bytes <= SMEM_DEFAULT) return cudaSuccess;
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(bytes));
}

}  // namespace

extern "C" {

// Forces F (3, M, G) of the occupied slots of x (3, M, G) with occupancy
// occ (G,), slot rows m < rows; F's other slots are left as they are.
int cell_forces_f32(const float* x, const int* occ, int ns, int M, int rows,
                    float L, float rc2, float sig2, float eps4, float eps24,
                    float r_switch, float inv_span, int use_switch, float* F,
                    void* stream) {
    if (rows <= 0 || ns <= 0) return static_cast<int>(cudaGetLastError());
    const size_t smem = sizeof(float) * staged_floats(rows);
    const cudaError_t err = allow_smem(cell_forces_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cell_forces_kernel<<<ns * ns * ns, BLOCK, smem,
                         static_cast<cudaStream_t>(stream)>>>(
        x, occ, Grid{ns, M, rows, L},
        cell_params(rc2, sig2, eps4, eps24, r_switch, inv_span, use_switch), F);
    return static_cast<int>(cudaGetLastError());
}

// n_steps of BAOAB on the occupied slots of x, v (3, M, G) in place, F
// (3, M, G) holding the forces of x on entry and of the final x on exit;
// xb (3, M, G) is scratch. One cooperative launch of at most the
// co-resident blocks, one block a cell at a time.
int cell_chunk_f32(float* x, float* xb, float* v, float* F, const int* occ,
                   const float* kT, int ns, int M, int rows, float L,
                   int n_steps, float rc2, float sig2, float eps4, float eps24,
                   float r_switch, float inv_span, int use_switch,
                   float half_dt, float kick, float ou_a, float ou_b,
                   float inv_m, uint64_t seed, void* stream) {
    if (rows <= 0 || ns <= 0 || n_steps == 0)
        return static_cast<int>(cudaGetLastError());
    const size_t smem = sizeof(float) * staged_floats(rows);
    cudaError_t err = allow_smem(cell_chunk_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    int max_blocks = 0;
    err = lj::max_coresident_blocks(cell_chunk_kernel, BLOCK, &max_blocks,
                                    smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (max_blocks == 0)
        return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    const int n_cells = ns * ns * ns;
    const int blocks = n_cells < max_blocks ? n_cells : max_blocks;
    ChunkArgs a{x, xb, v, F, occ, kT, Grid{ns, M, rows, L},
                cell_params(rc2, sig2, eps4, eps24, r_switch, inv_span,
                            use_switch),
                n_steps, half_dt, kick, ou_a, ou_b, inv_m,
                static_cast<uint32_t>(seed & 0xFFFFFFFFull),
                static_cast<uint32_t>(seed >> 32)};
    void* args[] = {&a};
    err = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(cell_chunk_kernel), dim3(blocks),
        dim3(BLOCK), args, smem, static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
