// Cell-grid LJ forces and BAOAB chunk for Hopper (sm_90a).
//
// Replaces: openmmtools_tpu/ops/pallas_md.py:FusedLJBAOAB._kernel_call (K4,
// the Pallas TPU kernel of _make_kernel: BAOAB, "V R O R V", over one
// rebuild interval for a monodisperse, uncharged LJ fluid binned into a cell
// grid, and its forces_only variant). The physics and the layout at the
// boundary are the same: particles sit in slots (3, M, G) of the padded
// grid, G = (n_side + 2)^3 cells of edge >= the cutoff, M slots a cell,
// filled rank-contiguously by ops/fused_md.py:bin_particles (slot m of a
// cell holds a particle exactly when m < the cell's occupancy); the pair
// term is pair_scale's (r^2 in (1e-6, rc^2), the quintic switch, through
// lj_common.cuh); plain coordinate differences, no minimum image; no wrap
// inside the chunk (the rebin wraps); invalid slots keep their sentinel
// positions and zero velocity; no energy. The TPU design is not carried
// over: the cell on the lane axis, neighbour cells as lane rolls, the ghost
// layers filled by masked rolls, the Newton reaction folded back through
// the ghosts, the k < max_occ level gating and the dual 8-slot kernel all
// existed because the TPU has no gathers and its cost is linear in a static
// capacity.
//
// Design: one thread per slot (m, interior cell), slot rows m < rows (the
// wrapper passes the maximum occupancy of the bin, one host read a chunk).
// A thread whose slot is empty does nothing. An occupied slot sums over its
// own cell and the 26 neighbours in a fixed order (dz, dy, dx from -1 to 1),
// visiting in each only the occupied slots k < occ[cell]: a neighbour across
// the boundary is found by wrapping the cell index periodically and
// shifting its coordinates by -+L, which is what the TPU kernel's ghost
// fill computes without the copies. Every slot sums all of its partners
// (no Newton reaction), so there are no atomics and the summation order is
// fixed.
//
//  * cell_forces_f32: the forces of the slots (forces_only), one launch.
//  * cell_chunk_f32: n_steps of "V R O R [forces] V" in one cooperative
//    launch. Per step an update phase (V with the forces of the last
//    evaluation, R, O, R) writes each slot's drifted position into one of
//    two position arrays, alternating by step; the grid meets at
//    cooperative_groups::this_grid().sync(); the force phase reads the
//    neighbours from that array and kicks (V). One barrier a step suffices:
//    an array is written again only two steps after it was read. Positions,
//    velocities and forces stay in device memory (in L2 at LJ-2048:
//    3 x 16 x 1000 floats an array); the grid is at most the co-resident
//    blocks, and each thread strides over the slots. The caller's forces
//    (cell_forces_f32 after the bin) start the chunk. O draws Philox4x32-10
//    (lj_common.cuh normal3) with counter (m G + g, step, 0, 0) and the
//    chunk's 64-bit seed as key.
//
// What bounds it on the H100: the force phase's pair tests, each occupied
// slot against the occupied slots of 27 cells (about 27 x 4 at the LJ-2048
// start, growing with the occupancy as the fluid condenses); FP32 throughput and
// the latency of the neighbour loads, since the update phase moves 40 bytes
// a slot. Against the all-pairs sweep of K1/K3 (2,047 partners a particle)
// the design cuts the pair tests about twentyfold at the start state.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lj_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BLOCK = 128;

struct Grid {
    int ns;     // interior cells a side
    int M;      // slots a cell
    int rows;   // slot rows visited (>= the largest occupancy)
    float L;    // cubic box edge
};

// Slot t of the (rows, ns^3) interior enumeration: row m and padded cell g.
__device__ __forceinline__ void slot_of(int t, const Grid& gr, int& m, int& g) {
    const int ns = gr.ns, gs = ns + 2, ns3 = ns * ns * ns;
    m = t / ns3;
    const int ci = t - m * ns3;
    const int cx = ci % ns + 1;
    const int cy = (ci / ns) % ns + 1;
    const int cz = ci / (ns * ns) + 1;
    g = cx + gs * (cy + gs * cz);
}

// Force on the slot at (xi, yi, zi) in padded cell g from the occupied
// slots of g and its 26 neighbours, positions from x (3, M, G).
__device__ __forceinline__ void cell_force(const float* x, const int* occ,
                                           const Grid& gr, const lj::Params& p,
                                           int g, float xi, float yi, float zi,
                                           float& fx, float& fy, float& fz) {
    const int ns = gr.ns, gs = ns + 2, G = gs * gs * gs, MG = gr.M * G;
    const int cx = g % gs, cy = (g / gs) % gs, cz = g / (gs * gs);
    fx = fy = fz = 0.0f;
    for (int dz = -1; dz <= 1; ++dz) {
        int nz = cz + dz;
        float shz = 0.0f;
        if (nz == 0) { nz = ns; shz = -gr.L; }
        else if (nz == ns + 1) { nz = 1; shz = gr.L; }
        for (int dy = -1; dy <= 1; ++dy) {
            int ny = cy + dy;
            float shy = 0.0f;
            if (ny == 0) { ny = ns; shy = -gr.L; }
            else if (ny == ns + 1) { ny = 1; shy = gr.L; }
            for (int dx = -1; dx <= 1; ++dx) {
                int nx = cx + dx;
                float shx = 0.0f;
                if (nx == 0) { nx = ns; shx = -gr.L; }
                else if (nx == ns + 1) { nx = 1; shx = gr.L; }
                const int gn = nx + gs * (ny + gs * nz);
                const int on = occ[gn];
                for (int k = 0; k < on; ++k) {
                    const int s = k * G + gn;
                    const float ddx = xi - (x[s] + shx);
                    const float ddy = yi - (x[MG + s] + shy);
                    const float ddz = zi - (x[2 * MG + s] + shz);
                    float w, e;
                    if (lj::pair(ddx * ddx + ddy * ddy + ddz * ddz, p, w, e)) {
                        fx += w * ddx;
                        fy += w * ddy;
                        fz += w * ddz;
                    }
                }
            }
        }
    }
}

__global__ void __launch_bounds__(BLOCK)
cell_forces_kernel(const float* __restrict__ x, const int* __restrict__ occ,
                   Grid gr, lj::Params p, float* __restrict__ F) {
    const int ns = gr.ns, gs = ns + 2, G = gs * gs * gs, MG = gr.M * G;
    const int t = blockIdx.x * BLOCK + threadIdx.x;
    if (t >= gr.rows * ns * ns * ns) return;
    int m, g;
    slot_of(t, gr, m, g);
    if (m >= occ[g]) return;
    const int s = m * G + g;
    float fx, fy, fz;
    cell_force(x, occ, gr, p, g, x[s], x[MG + s], x[2 * MG + s], fx, fy, fz);
    F[s] = fx;
    F[MG + s] = fy;
    F[2 * MG + s] = fz;
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

__global__ void __launch_bounds__(BLOCK) cell_chunk_kernel(ChunkArgs a) {
    cg::grid_group grid = cg::this_grid();
    const Grid gr = a.gr;
    const int ns = gr.ns, gs = ns + 2, G = gs * gs * gs, MG = gr.M * G;
    const int total = gr.rows * ns * ns * ns;
    const int stride = gridDim.x * BLOCK;
    const int t0 = blockIdx.x * BLOCK + threadIdx.x;
    const float sig = a.ou_b * sqrtf(a.kT[0] * a.inv_m);

    for (int step = 0; step < a.n_steps; ++step) {
        const float* cur = (step & 1) ? a.xb : a.x;
        float* nxt = (step & 1) ? a.x : a.xb;
        for (int t = t0; t < total; t += stride) {        // V R O R
            int m, g;
            slot_of(t, gr, m, g);
            if (m >= a.occ[g]) continue;
            const int s = m * G + g;
            float vx = a.v[s] + a.kick * a.F[s];
            float vy = a.v[MG + s] + a.kick * a.F[MG + s];
            float vz = a.v[2 * MG + s] + a.kick * a.F[2 * MG + s];
            float px = cur[s] + a.half_dt * vx;
            float py = cur[MG + s] + a.half_dt * vy;
            float pz = cur[2 * MG + s] + a.half_dt * vz;
            if (a.ou_b != 0.0f) {
                float z0, z1, z2;
                lj::normal3(static_cast<uint32_t>(s),
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
            nxt[s] = px + a.half_dt * vx;
            nxt[MG + s] = py + a.half_dt * vy;
            nxt[2 * MG + s] = pz + a.half_dt * vz;
            a.v[s] = vx;
            a.v[MG + s] = vy;
            a.v[2 * MG + s] = vz;
        }
        grid.sync();
        for (int t = t0; t < total; t += stride) {        // forces, V
            int m, g;
            slot_of(t, gr, m, g);
            if (m >= a.occ[g]) continue;
            const int s = m * G + g;
            float fx, fy, fz;
            cell_force(nxt, a.occ, gr, a.p, g, nxt[s], nxt[MG + s],
                       nxt[2 * MG + s], fx, fy, fz);
            a.F[s] = fx;
            a.F[MG + s] = fy;
            a.F[2 * MG + s] = fz;
            a.v[s] += a.kick * fx;
            a.v[MG + s] += a.kick * fy;
            a.v[2 * MG + s] += a.kick * fz;
        }
    }
    if (a.n_steps & 1) {   // the final positions are in xb
        for (int t = t0; t < total; t += stride) {
            int m, g;
            slot_of(t, gr, m, g);
            if (m >= a.occ[g]) continue;
            const int s = m * G + g;
            a.x[s] = a.xb[s];
            a.x[MG + s] = a.xb[MG + s];
            a.x[2 * MG + s] = a.xb[2 * MG + s];
        }
    }
}

lj::Params cell_params(float rc2, float sig2, float eps4, float eps24,
                       float r_switch, float inv_span, int use_switch) {
    return lj::Params{rc2, sig2, eps4, eps24, r_switch, inv_span, use_switch,
                      1e-6f};
}

}  // namespace

extern "C" {

// Forces F (3, M, G) of the occupied slots of x (3, M, G) with occupancy
// occ (G,), slot rows m < rows; F's other slots are left as they are.
int cell_forces_f32(const float* x, const int* occ, int ns, int M, int rows,
                    float L, float rc2, float sig2, float eps4, float eps24,
                    float r_switch, float inv_span, int use_switch, float* F,
                    void* stream) {
    const Grid gr{ns, M, rows, L};
    const int total = rows * ns * ns * ns;
    if (total == 0) return static_cast<int>(cudaGetLastError());
    cell_forces_kernel<<<(total + BLOCK - 1) / BLOCK, BLOCK, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        x, occ, gr,
        cell_params(rc2, sig2, eps4, eps24, r_switch, inv_span, use_switch), F);
    return static_cast<int>(cudaGetLastError());
}

// n_steps of BAOAB on the occupied slots of x, v (3, M, G) in place, F
// (3, M, G) holding the forces of x on entry and of the final x on exit;
// xb (3, M, G) is scratch. One cooperative launch of at most the
// co-resident blocks.
int cell_chunk_f32(float* x, float* xb, float* v, float* F, const int* occ,
                   const float* kT, int ns, int M, int rows, float L,
                   int n_steps, float rc2, float sig2, float eps4, float eps24,
                   float r_switch, float inv_span, int use_switch,
                   float half_dt, float kick, float ou_a, float ou_b,
                   float inv_m, uint64_t seed, void* stream) {
    const int total = rows * ns * ns * ns;
    if (total == 0 || n_steps == 0) return static_cast<int>(cudaGetLastError());
    int max_blocks = 0;
    cudaError_t err = lj::max_coresident_blocks(cell_chunk_kernel, BLOCK,
                                                &max_blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (max_blocks == 0)
        return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    const int wanted = (total + BLOCK - 1) / BLOCK;
    const int blocks = wanted < max_blocks ? wanted : max_blocks;
    ChunkArgs a{x, xb, v, F, occ, kT, Grid{ns, M, rows, L},
                cell_params(rc2, sig2, eps4, eps24, r_switch, inv_span,
                            use_switch),
                n_steps, half_dt, kick, ou_a, ou_b, inv_m,
                static_cast<uint32_t>(seed & 0xFFFFFFFFull),
                static_cast<uint32_t>(seed >> 32)};
    void* args[] = {&a};
    err = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(cell_chunk_kernel), dim3(blocks),
        dim3(BLOCK), args, 0, static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
