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
// Every entry point takes a batch: R sort sets (a replica's sorted
// positions, exclusion bitfield, box, rebuild flag and bound, each set's
// arrays back to back) and B evaluations, evaluation b reading the sort set
// rep[b] with its own parameters (and class scalars). Propagation passes
// B = R and rep the identity; the multistate energy matrix one evaluation a
// (replica, state) pair, rep[b] the replica. Each evaluation computes what
// the TPU kernel computes, on its own; a batch of one is the single call.
//
// Three C entry points. Each takes a device counter, launches, to which the
// launch's first thread adds 1: the caller counts the launches that run,
// those a replayed CUDA graph makes included.
//
//  * sweep_bound_f32: sweep_bound_kernel, one cooperative launch a call for
//    all R sets. It reads the rebuild flags from device memory; where no set
//    rebuilds, the blocks of the first block pass each bound on and every
//    block returns. Otherwise it writes, for each set that rebuilds, 1 + the
//    last block of shell_block shells that holds a pair of real slots within
//    w = rc + skin (0 without one), and the bound it was given for each set
//    that does not. Nothing reads a flag on the host, so a step never waits
//    on the device. Both variants share it; its design is set out below the
//    force kernel's.
//  * sweep_forces_f32: sweep_forces_kernel<false> sums each sorted slot i's
//    FULL ring neighbourhood i +- s, s <= S = min(bound * shell_block,
//    n_pad/2), without Newton's third law: no atomics, a deterministic
//    result, F and U in one launch. The shell s = n_pad/2 reaches the same
//    partner from both sides and counts half from each, and an exclusion
//    bit is read only for s <= 32 * mask_rows, both as in the TPU kernel.
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
// The force kernel's design, and what bounds it on the H100. The sweep tests
// every slot pair of the x-sorted window from both of its ends, about 2 S
// tests a slot, and only the pairs inside the cutoff sphere need the
// LJ/erfc arithmetic: about 5 % of the tests on water at rc = 1.0 nm, skin
// 0.1 nm. With one thread a slot the warp's lanes would walk their partners
// in lockstep, and the warp would run the whole pair body whenever any of
// its 32 lanes had a pair inside the cutoff (about 79 % of its iterations
// at 5 %, with 1-2 lanes live): divergence would waste most of its cycles.
// Here:
//
//  * One warp a sorted slot, WARPS slots a block. The block's slots share
//    almost one partner window, 2 S + WARPS slots of the ring (S ~ 4,800
//    on water), which the block stages in shared memory in tiles of 2,048
//    partners, double-buffered with cp.async: tile t + 1 is in flight while
//    the warps test tile t. A partner is one 16-byte row (x, y, z, unused),
//    one 128-bit shared load a test; a pad slot is staged as NaN, so its
//    distance test fails (masked by index, not by its coordinates). Where the
//    ring wraps, each partner's slot is taken modulo n_pad.
//  * Test, compact, then compute. Lane l tests the partners l, l + 32, ... of
//    the slot's window, UNROLL at a time; __ballot_sync marks the lanes
//    whose partner lies inside the cutoff, and each appends the partner's
//    ring offset o (j = i + o) to the warp's queue in shared memory at the
//    position __popc of the lower lanes gives (a lane without a pair writes
//    to a spare slot: no branch). An entry is the offset alone, not a tile
//    index, so the queue outlives the tile it was filled from. Whenever it
//    holds 32 pairs the warp drains them with every lane live: each lane
//    reads the partner's position and parameters again (L1/L2; the
//    displacement computed as the test computed it, to the bit), the
//    pair's exclusion word where s <= 32 mask_rows, and runs the full pair
//    body. One partial drain ends each slot. So the distance tests run at
//    full warp width and the pair arithmetic at full width too: about
//    inside / 32 drains a slot.
//  * Fixed-order sums, no float atomics. Each lane sums F and U over the
//    pairs it drained, a fixed xor-shuffle tree sums the lanes, lane 0
//    writes the slot's F; the queue order follows the ballot order, so two
//    launches give the same bits. U: the block sums its warps in warp order
//    into a partial, and the last block to draw an integer ticket sums the
//    partials (float for the standard variant, double for the alchemical
//    one) and re-arms the ticket to 0.
//
// What bounds it now: the instruction rate of the distance tests, 2 S a slot.
// A test is a shared load, three minimum images, r^2 rounded as the plain
// version rounds it and the compare, then a ballot and a queue write, all at
// full warp width; the drains come after them (PERF.md has the measured
// split). Device memory is not the limit: positions are read once per
// block window, parameters and the 6.2 MB bitfield only for pairs inside
// the cutoff, all from L2. Newton's third law would halve the tests but
// needs a deterministic scatter; a 2D slab or cell structure would cut them
// about tenfold; both are later work.
//
// The bound kernel's design, and what bounds it. The bound is a maximum, of
// (s - 1) / shell_block over the pairs (i, i + s), 1 <= s <= n_pad/2, of
// real slots within w = rc + skin. One thread a slot over all n_pad/2
// shells (the first design) tests every pair of the ring, although on
// water only the partners within w in x, about a third of the ring, can
// hold a hit, and only the farthest hit counts. The ring is sorted by x
// only at a re-sort (every sweep_sort_interval steps); in between, the path
// gathers the current positions through the old order, so the ring it
// rebuilds on is only roughly sorted, and an atom that crossed the box's x
// face since the sort sits at the wrong end of it, with x near the other
// face. So nothing may assume that x grows along the ring: a binary search
// for a slot's x window, or a stop at the first shell past w in x, would
// skip pairs within w without any error. Here sortedness only makes the
// work small; whatever is skipped is proven out of range:
//
//  * Tiles and their x-arcs (phase 1). The ring is cut into tiles of GROUP
//    = 32 consecutive slots. A warp takes a tile and writes its periodic
//    x-arc (start, width): the offsets of its real slots from one of them
//    by the minimum image, their min and max over the warp. Measured from a
//    member, an atom that crossed the x face lands beside its neighbours
//    and does not widen the arc to the box. Pad slots stay out of it, as do
//    slots of non-finite x (they can hold no hit); a tile without a member
//    gets width -1. One grid barrier, then each block copies the arcs (8
//    bytes a tile) into its shared memory where they fit in the 48 KB a
//    block gets without asking (STAGE_MAX: up to about 188,000 slots, all
//    sets of a batch together);
//    past that every read of an arc goes to L2 (__ldcg), so no ring size is
//    refused.
//  * Groups scan far to near (phase 2). A warp takes a group, the tile g of
//    slots, one slot a lane, and walks its partner tiles g + k from k =
//    n_pad/64 down to 0, 32 at a time: lane l decides for k = k0 - l whether
//    the tile can raise the maximum (its largest shell, 32 k + 31, lies in
//    a block above the best found so far, by this warp or by any, read from
//    a device-wide int) and whether the two arcs come within W = w (1 +
//    1e-5) + 1e-5 L of each other on the periodic x-circle; a ballot
//    gathers the tiles to test. W's margin is hundreds of ulps of L, more
//    than the rounding of the arcs and of r^2, so a tile is skipped only
//    where every pair's r^2, rounded as the plain version rounds it, lies
//    above w^2. A tile to test is staged in shared memory (a float4 a
//    partner, NaN for a pad slot), each lane tests its slot against the 32
//    partners and keeps its last hit, and __reduce_max_sync gives the
//    tile's block; the next tile's partners and the device-wide best are
//    loaded while it is tested. The first tile with a hit ends the scan as
//    soon as no nearer tile's largest shell lies above it. Each new best
//    goes to the device-wide int by atomicMax, so the other warps skip what
//    cannot beat it. A maximum does not depend on the order in which it is
//    found, so every launch gives the same int.
//  * One launch for the batch. The blocks walk (set, tile) pairs grid-stride
//    in both phases, skipping the sets that do not rebuild; each set has its
//    arcs and its best block. No block may leave before the grid barrier
//    unless no set rebuilds, which every block reads alike. The last block
//    to draw an integer ticket writes each set's nblk = 1 + its best block
//    (or its bound, where it does not rebuild), re-arming the bests to -1
//    (atomicExch) and the ticket to 0; the arcs need no re-arming. The
//    wrapper keeps these R + 1 words and the arcs on its object across
//    calls. The grid is the co-resident block count whatever R is.
//
// What bounds it: on a fresh water ring a group's arc lies within W of
// about a third of its partner tiles, and its scan stops within a few
// tiles of the far edge of that window, so the pair tests are few; the
// launch, the grid barrier and the chain of the cull's rounds (a shared
// load and a dozen operations a lane, n_pad/2048 rounds a group) are most
// of the time: latency, not operations. On a stale ring the arcs widen by
// how far the atoms moved since the sort, and a group tests a few more
// tiles before its first hit.
//
// erfcf stands in for the Abramowitz-Stegun 7.1.26 rational of the TPU
// kernel (|error| < 1.5e-7): both are within float32 rounding of the
// tolerance the port holds the kernel to (2e-4 of the force scale).
//
// Every C entry point returns cudaGetLastError() after its launches; the
// Python wrapper (openmmtools_tpu_torch/ops/sweep_nb.py) raises if it is not
// 0.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "lj_common.cuh"

namespace cg = cooperative_groups;

namespace {

// n_pad is a multiple of PAD (ops/sweep_nb.py pads the ring so)
constexpr int PAD = 128;
// the bound kernel: tiles of GROUP ring slots, one warp a tile, BOUND_WARPS
// warps a block (ops/sweep_nb.py _GROUP)
constexpr int GROUP = 32;
constexpr int BOUND_WARPS = 4;
constexpr int BOUND_BLOCK = BOUND_WARPS * 32;
// the most bytes of arcs a block stages in shared memory: the 48 KB a block
// gets without asking, less the kernel's static shared memory
constexpr size_t STAGE_MAX = 48 * 1024 - sizeof(float4) * BOUND_WARPS * GROUP
                             - 16;
// the force kernel: one warp a sorted slot, WARPS slots a block
// (ops/sweep_nb.py _WARPS), two blocks an SM (64 registers a thread)
constexpr int WARPS = 16;
constexpr int FORCE_BLOCK = WARPS * 32;
constexpr int MIN_BLOCKS = 2;
constexpr int TILE = 2048;    // partners a staged tile, 4 a thread
constexpr int UNROLL = 4;     // partners a lane tests before their ballots
// a staged tile's rows, padded so that a lane past the window reads inside it
constexpr int TILE_ROWS = TILE + UNROLL * 32;
constexpr int QUEUE = 256;    // a warp's ring of queued offsets (< 32 + 32
                              // UNROLL live), and one slot for the misses
static_assert(QUEUE >= 32 * (UNROLL + 1), "the queue must hold a group");
// dynamic shared memory a block: two tiles, then the warps' queues
constexpr int FORCE_SMEM = 2 * TILE_ROWS * 16 + WARPS * (QUEUE + 1) * 4;
constexpr unsigned FULL_MASK = 0xFFFFFFFFu;
// class scalars of the alchemical variant: at most 16 regions
// (ops/sweep_nb.py _MAX_LAM)
constexpr int MAX_LAM = 3 * (17 * 18 / 2 - 1);

__device__ __forceinline__ float ring_delta(float d, float L, float hL) {
    // one conditional shift: exact for coordinates wrapped into [0, L), so
    // |d| < L; d + L where d < -hL, d - L where d > hL (copysign(L, -d)),
    // else d + 0, which is the plain version's d + L, d - L and d + 0 - 0
    // to the bit
    const float shift = __uint_as_float(
        __float_as_uint(L) | (~__float_as_uint(d) & 0x80000000u));
    return d + (fabsf(d) > hL ? shift : 0.0f);
}

// r^2 = (dx dx + dy dy) + dz dz with every product and sum rounded on its
// own (no fused multiply-add): bit for bit the plain version's value, so the
// kernel and its plain version agree on which pairs lie inside the cutoff
// (the unswitched Coulomb force jumps there)
__device__ __forceinline__ float dist2_rn(float dx, float dy, float dz) {
    return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                     __fmul_rn(dz, dz));
}

// p modulo n_pad for -n_pad <= p < 2 n_pad (the force kernel's window:
// i +- S, S <= n_pad/2), without a division
__device__ __forceinline__ int ring_near(int p, int n_pad) {
    p += (p < 0) ? n_pad : 0;
    return p - ((p >= n_pad) ? n_pad : 0);
}

// The periodic x-arc of the ring's tile t, the same in every lane: (start,
// width) with the tile's members in [start, start + width] modulo Lx; a
// member is a real slot of finite x, and a tile without one gets width -1.
__device__ __forceinline__ float2 tile_arc(const float* __restrict__ x,
                                           int t, int n, float Lx, float hx) {
    const int j = t * GROUP + (threadIdx.x & 31);
    const float xj = j < n ? x[j] : 0.0f;
    const bool member = j < n && isfinite(xj);
    const unsigned m = __ballot_sync(FULL_MASK, member);
    if (m == 0u) return make_float2(0.0f, -1.0f);
    const float ref = __shfl_sync(FULL_MASK, xj, __ffs(m) - 1);
    const float d = ring_delta(xj - ref, Lx, hx);
    float lo = member ? d : FLT_MAX;
    float hi = member ? d : -FLT_MAX;
    for (int offset = 16; offset > 0; offset >>= 1) {
        lo = fminf(lo, __shfl_xor_sync(FULL_MASK, lo, offset));
        hi = fmaxf(hi, __shfl_xor_sync(FULL_MASK, hi, offset));
    }
    return make_float2(ref + lo, hi - lo);
}

// True when no point of arc t lies within W of arc a on the periodic
// x-circle of length Lx (an empty t included): with a's start at 0, t must
// start past a's end by more than W and end more than W before Lx. Rounding
// that puts t's start at -0 or at Lx keeps the pair (it never culls more).
__device__ __forceinline__ bool far_apart(float2 a, float2 t, float Lx,
                                          float inv_Lx, float W) {
    if (t.y < 0.0f) return true;
    float u = t.x - a.x;
    u -= Lx * floorf(u * inv_Lx);
    return u > a.y + W && u + t.y < Lx - W;
}

// The largest block of shell_block shells that a partner tile g + k can
// hold for the slots of group g: its shells are 32 k - 31 .. 32 k + 31,
// at most n_pad/2
__device__ __forceinline__ int tile_top(int k, int half, int bs) {
    return (min(GROUP * k + GROUP - 1, half) - 1) / bs;
}

// Tile t modulo n_tiles for 0 <= t < 2 n_tiles
__device__ __forceinline__ int ring_tile(int t, int n_tiles) {
    return t - ((t >= n_tiles) ? n_tiles : 0);
}

// The position of ring slot j as a staged partner: NaN for a pad slot, so
// that its every distance test fails
__device__ __forceinline__ float4 partner(const float* __restrict__ x, int j,
                                          int n, int n_pad) {
    const float nan = __int_as_float(0x7fc00000);
    return j < n ? make_float4(x[j], x[n_pad + j], x[2 * n_pad + j], 0.0f)
                 : make_float4(nan, nan, nan, 0.0f);
}

// R sort sets, set r's positions at x + 3 r n_pad, its box at L + 3 r.
// words[r]: set r's best block found so far (-1 between launches);
// words[R]: the blocks' ticket (0 between launches). arcs: R n_pad / GROUP
// float2 of scratch. Launched cooperatively; STAGED: with R n_pad / GROUP
// float2 of dynamic shared memory a block, into which every block copies
// the arcs (else each arc is read from L2 where it is needed).
template <bool STAGED>
__global__ void __launch_bounds__(BOUND_BLOCK)
sweep_bound_kernel(const float* __restrict__ x_all, int n, int n_pad, int R,
                   const float* __restrict__ L_all, float w2, int bs,
                   const unsigned char* __restrict__ rebuild,
                   const int* __restrict__ bound, float2* arcs_all,
                   int* words, int* __restrict__ nblk,
                   unsigned long long* launches) {
    extern __shared__ float2 s_arcs[];            // every tile's arc
    __shared__ float4 staged[BOUND_WARPS][GROUP]; // a warp's partner tile
    __shared__ bool last;
    if (launches && blockIdx.x == 0 && threadIdx.x == 0)
        atomicAdd(launches, 1ull);
    // every block reads every flag alike: all return before the barrier,
    // or none does
    int any = 0;
    for (int r = threadIdx.x; r < R; r += BOUND_BLOCK)
        any |= rebuild[r] != 0;
    if (!__syncthreads_or(any)) {
        if (blockIdx.x == 0)
            for (int r = threadIdx.x; r < R; r += BOUND_BLOCK)
                nblk[r] = bound[r];
        return;
    }
    const int lane = threadIdx.x & 31;
    const int n_tiles = n_pad / GROUP;
    const int half = n_pad / 2;
    const int reach = half / GROUP;   // partner tiles g + 0 .. g + reach
    const int warp0 = blockIdx.x * BOUND_WARPS + (threadIdx.x >> 5);
    const int n_warps = gridDim.x * BOUND_WARPS;
    const int n_work = R * n_tiles;   // (set, tile) pairs

    // phase 1: the tiles' arcs of every set that rebuilds, then one grid
    // barrier
    for (int job = warp0; job < n_work; job += n_warps) {
        const int r = job / n_tiles;
        if (rebuild[r] == 0) continue;
        const float2 arc = tile_arc(x_all + static_cast<size_t>(r) * 3 * n_pad,
                                    job - r * n_tiles, n, L_all[3 * r],
                                    0.5f * L_all[3 * r]);
        if (lane == 0) arcs_all[job] = arc;
    }
    cg::this_grid().sync();
    if (STAGED) {
        for (int t = threadIdx.x; t < n_work; t += BOUND_BLOCK)
            s_arcs[t] = __ldcg(arcs_all + t);
        __syncthreads();
    }

    const float nan = __int_as_float(0x7fc00000);
    float4* const tile = staged[threadIdx.x >> 5];
    int top = -1;     // the best block this warp found in set top_r
    int top_r = -1;
    // phase 2: each group scans its partner tiles far to near
    for (int job = warp0; job < n_work; job += n_warps) {
        const int r = job / n_tiles;
        if (rebuild[r] == 0) continue;
        if (r != top_r) {
            top = -1;
            top_r = r;
        }
        const int g = job - r * n_tiles;
        const float* const x = x_all + static_cast<size_t>(r) * 3 * n_pad;
        const float Lx = L_all[3 * r], Ly = L_all[3 * r + 1],
                    Lz = L_all[3 * r + 2];
        const float hx = 0.5f * Lx, hy = 0.5f * Ly, hz = 0.5f * Lz;
        const float W = sqrtf(w2) * (1.0f + 1e-5f) + 1e-5f * Lx;
        const float inv_Lx = 1.0f / Lx;
        // written in this launch by other blocks: read from L2
        const int base = r * n_tiles;
        auto arc_of = [&](int t) {
            return STAGED ? s_arcs[base + t] : __ldcg(arcs_all + base + t);
        };
        volatile int* const best = words + r;
        const float2 ga = arc_of(g);
        if (ga.y < 0.0f) continue;   // no member: no hit
        // this lane's slot (a pad slot, NaN, tests nothing)
        const float4 me = partner(x, g * GROUP + lane, n, n_pad);
        const float xi = me.x, yi = me.y, zi = me.z;
        bool done = false;
        for (int k0 = reach; k0 >= 0 && !done; k0 -= GROUP) {
            // the best so far, the same in every lane (another warp may
            // raise it between two lanes' reads)
            int seen = 0;
            if (lane == 0) seen = *best;
            int floor_blk = max(top, __shfl_sync(FULL_MASK, seen, 0));
            if (tile_top(k0, half, bs) <= floor_blk) break;
            const int k = k0 - lane;
            const bool test = k >= 0 && tile_top(k, half, bs) > floor_blk &&
                              !far_apart(ga, arc_of(k >= 0 ? ring_tile(
                                             g + k, n_tiles) : g),
                                         Lx, inv_Lx, W);
            unsigned todo = __ballot_sync(FULL_MASK, test);
            // this lane's partner in the farthest tile to test, loaded one
            // tile ahead of its test
            float4 next = make_float4(nan, nan, nan, 0.0f);
            if (todo != 0u)
                next = partner(x, ring_tile(g + k0 - (__ffs(todo) - 1),
                                            n_tiles) * GROUP + lane,
                               n, n_pad);
            while (todo != 0u) {
                // the farthest tile left (the lowest lane)
                const int kq = k0 - (__ffs(todo) - 1);
                todo &= todo - 1u;
                floor_blk = max(floor_blk,
                                max(top, __shfl_sync(FULL_MASK, seen, 0)));
                if (tile_top(kq, half, bs) <= floor_blk) {
                    done = true;   // no nearer tile can raise the best
                    break;
                }
                __syncwarp();   // the previous tile's reads are done
                tile[lane] = next;
                __syncwarp();
                // the next tile's partners and the best so far, in flight
                // while this tile is tested
                if (todo != 0u)
                    next = partner(x, ring_tile(g + k0 - (__ffs(todo) - 1),
                                                n_tiles) * GROUP + lane,
                                   n, n_pad);
                if (lane == 0) seen = *best;
                // the shell of partner q is s0 + q; the last hit is the
                // farthest
                const int s0 = GROUP * kq - lane;
                int s_hit = 0;
#pragma unroll 8
                for (int q = 0; q < GROUP; ++q) {
                    const float4 p = tile[q];
                    const float r2 = dist2_rn(ring_delta(xi - p.x, Lx, hx),
                                              ring_delta(yi - p.y, Ly, hy),
                                              ring_delta(zi - p.z, Lz, hz));
                    const int s = s0 + q;
                    const bool hit = s >= 1 && s <= half && r2 <= w2 &&
                                     r2 > 1e-12f;
                    s_hit = hit ? s : s_hit;
                }
                const int blk = __reduce_max_sync(
                    FULL_MASK, s_hit > 0 ? (s_hit - 1) / bs : -1);
                if (blk > top) {
                    top = blk;
                    if (lane == 0) atomicMax(words + r, top);
                }
            }
        }
    }

    // the last block to finish writes the bounds and re-arms the words
    __threadfence();   // this warp's atomicMax lands before the ticket
    __syncthreads();
    if (threadIdx.x == 0)
        last = atomicAdd(words + R, 1) == static_cast<int>(gridDim.x) - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    for (int r = threadIdx.x; r < R; r += BOUND_BLOCK)
        nblk[r] = rebuild[r] != 0 ? atomicExch(words + r, -1) + 1 : bound[r];
    if (threadIdx.x == 0) atomicExch(words + R, 0);
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

// What one slot brings to its pairs: its index, its parameters and what the
// pair body needs of the launch.
struct Slot {
    int i, n_pad, half, cover;
    float x, y, z;        // position
    float Lx, Ly, Lz, hx, hy, hz;   // box and half box
    float sig, se, kq;
    int g;                // region code (alchemical variant)
    int R1, n_cls;        // region count + 1, class count (alchemical)
};

// cp.async of one 4-byte word from device memory to shared memory
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's cp.async groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage the ring positions p = t0 .. t0 + m - 1 of the sorted order into one
// tile, thread k the partners k, k + FORCE_BLOCK, ...: x, y, z of slot
// p mod n_pad by cp.async, a pad slot as NaN (its every distance test then
// fails). One commit group a call in every thread.
__device__ __forceinline__ void stage_tile(float4* tile, const float* x,
                                           int t0, int m, int n, int n_pad) {
    for (int k = threadIdx.x; k < m; k += FORCE_BLOCK) {
        const int jm = ring_near(t0 + k, n_pad);
        float* dst = reinterpret_cast<float*>(tile + k);
        if (jm < n) {
            cp_async4(dst, x + jm);
            cp_async4(dst + 1, x + n_pad + jm);
            cp_async4(dst + 2, x + 2 * n_pad + jm);
        } else {
            dst[0] = dst[1] = dst[2] = __int_as_float(0x7fc00000);
        }
    }
    cp_async_commit();
}

// The pair (i, j = i + o) of slot a, queued inside the cutoff: nothing for
// an exception pair, else its force and energy, weighted half on the shell
// s = n_pad/2, added to the lane's sums. The partner's position is read
// again from device memory and its displacement computed as the distance
// test computed it, to the same bits.
template <bool ALCH>
__device__ __forceinline__ void add_pair(
        int o, const Slot& a, const float* __restrict__ x,
        const int* __restrict__ excl, const float* __restrict__ par,
        const Physics& ph, const Alch& al, const float* slam, float& fx,
        float& fy, float& fz, float& e_acc) {
    const float two_over_sqrt_pi = 1.1283791670955126f;
    const int j = ring_near(a.i + o, a.n_pad);
    const int ao = o > 0 ? o : -o;
    if (ao <= a.cover) {
        // bit ao-1 of lane i for i + ao, of lane j for i - ao
        const int lane = o > 0 ? a.i : j;
        const unsigned word = static_cast<unsigned>(
            __ldg(excl + ((ao - 1) >> 5) * a.n_pad + lane));
        if ((word >> ((ao - 1) & 31)) & 1u) return;
    }
    const float dx = ring_delta(a.x - __ldg(x + j), a.Lx, a.hx);
    const float dy = ring_delta(a.y - __ldg(x + a.n_pad + j), a.Ly, a.hy);
    const float dz = ring_delta(a.z - __ldg(x + 2 * a.n_pad + j), a.Lz, a.hz);
    const float r2 = dist2_rn(dx, dy, dz);
    const float wt = (ao == a.half) ? 0.5f : 1.0f;
    const float inv_r = rsqrtf(r2);
    const float inv_r2 = inv_r * inv_r;
    const float r = r2 * inv_r;
    const float sig = 0.5f * (a.sig + __ldg(par + j));
    const float eps = a.se * __ldg(par + a.n_pad + j);
    const float s2 = sig * sig * inv_r2;
    float s6 = s2 * s2 * s2;
    float e_lj, w_lj;
    float lam_e = 1.0f;
    int g_j = 0;
    if (ALCH) {
        // the pair's region-pair class; env-env keeps the identity scalars
        g_j = __float2int_rn(__ldg(par + 3 * a.n_pad + j));
        const int lo = min(a.g, g_j), hi = max(a.g, g_j);
        float lam_s = 1.0f, asc = 0.0f;
        if (hi > 0) {
            const int ci = lo * a.R1 - lo * (lo - 1) / 2 + (hi - lo) - 1;
            lam_s = slam[ci];
            asc = slam[a.n_cls + ci];
            lam_e = slam[2 * a.n_cls + ci];
        }
        // softcore (beta = 0, c = 6); the clamp keeps asc s6 + 1 finite at
        // deep overlap
        s6 = fminf(s6, 1e18f);
        const float inv_den = 1.0f / (asc * s6 + 1.0f);
        const float xsc = s6 * inv_den;
        const float el4 = (4.0f * eps) * lam_s;
        e_lj = el4 * (xsc * xsc - xsc);
        w_lj = (6.0f * el4) * (2.0f * xsc - 1.0f) * xsc * inv_den * inv_r2;
    } else {
        const float s12 = s6 * s6;
        e_lj = 4.0f * eps * (s12 - s6);
        w_lj = eps * (48.0f * s12 - 24.0f * s6) * inv_r2;
    }
    const float qq = a.kq * __ldg(par + 2 * a.n_pad + j);
    float e_c, w_c;
    if (ph.coulomb_rf) {
        e_c = qq * (inv_r + ph.k_rf * r2 - ph.c_rf);
        w_c = qq * (inv_r2 * inv_r - 2.0f * ph.k_rf);
    } else if (ALCH && al.coulomb_plain && (a.g > 0 || g_j > 0)) {
        // 'coulomb' PME treatment: plain 1/r for a pair with an alchemical
        // member
        e_c = qq * inv_r;
        w_c = qq * inv_r2 * inv_r;
    } else {
        const float z = ph.alpha * r;
        const float erfc_z = erfcf(z);
        e_c = qq * erfc_z * inv_r;
        w_c = qq * inv_r2 *
              (erfc_z * inv_r + two_over_sqrt_pi * ph.alpha * expf(-z * z));
    }
    if (ALCH) {
        e_c *= lam_e;
        w_c *= lam_e;
    }
    float e, w;
    if (ph.use_switch) {
        const float t =
            fminf(fmaxf((r - ph.r_switch) * ph.inv_span, 0.0f), 1.0f);
        const float Sw = 1.0f + t * t * t * (-10.0f + t * (15.0f - 6.0f * t));
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

// Real is the energy total's type: float for the standard variant, double
// for the alchemical one). Evaluation b = blockIdx.y reads the sort set
// rep[b] (positions, bitfield, box, bound) and its own parameters and class
// scalars, and writes its own F, partials, ticket and U.
template <bool ALCH, typename Real>
__global__ void __launch_bounds__(FORCE_BLOCK, MIN_BLOCKS)
sweep_forces_kernel(const float* __restrict__ x, const float* __restrict__ par,
                    const int* __restrict__ excl, int n, int n_pad,
                    int mask_rows, int bs, const float* __restrict__ L,
                    const int* __restrict__ nblk,
                    const int* __restrict__ rep, Physics ph, Alch al,
                    float* __restrict__ F, float* e_part,
                    unsigned int* __restrict__ ticket, Real* __restrict__ U,
                    unsigned long long* launches) {
    // two tiles of TILE_ROWS partners, then a queue of QUEUE + 1 ints a
    // warp (launched with FORCE_SMEM bytes)
    extern __shared__ __align__(16) float4 smem[];
    __shared__ float slam[ALCH ? MAX_LAM : 1];    // class scalars
    __shared__ float warp_e[WARPS];
    __shared__ Real red[WARPS];
    __shared__ bool last;
    if (launches && blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0)
        atomicAdd(launches, 1ull);

    // this evaluation's arrays
    {
        const size_t b = blockIdx.y;
        const int r = rep[b];
        x += static_cast<size_t>(r) * 3 * n_pad;
        excl += static_cast<size_t>(r) * mask_rows * n_pad;
        L += 3 * r;
        nblk += r;
        par += b * (ALCH ? 4 : 3) * n_pad;
        F += b * 3 * n_pad;
        e_part += b * gridDim.x;
        ticket += b;
        U += b;
        if (ALCH) {
            const int R1 = al.n_regions + 1;
            al.lam += b * 3 * (R1 * (R1 + 1) / 2 - 1);
        }
    }
    const int half = n_pad / 2;
    const int S = min(max(nblk[0], 0) * bs, half);
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const unsigned lower = (1u << lane) - 1u;
    const int i0 = blockIdx.x * WARPS;
    const int i = i0 + warp;
    const bool real = i < n;
    const float Lx = L[0], Ly = L[1], Lz = L[2];
    const float hx = 0.5f * Lx, hy = 0.5f * Ly, hz = 0.5f * Lz;

    Slot a;
    a.i = i;
    a.Lx = Lx;
    a.Ly = Ly;
    a.Lz = Lz;
    a.hx = hx;
    a.hy = hy;
    a.hz = hz;
    a.n_pad = n_pad;
    a.half = half;
    a.cover = 32 * mask_rows;
    a.R1 = al.n_regions + 1;
    a.n_cls = a.R1 * (a.R1 + 1) / 2 - 1;
    a.sig = a.se = a.kq = 0.0f;
    a.g = 0;
    float xi = 0.0f, yi = 0.0f, zi = 0.0f;
    if (real) {
        xi = x[i];
        yi = x[n_pad + i];
        zi = x[2 * n_pad + i];
        a.sig = par[i];
        a.se = par[n_pad + i];
        a.kq = ph.ke * par[2 * n_pad + i];
        if (ALCH) a.g = __float2int_rn(par[3 * n_pad + i]);
    }
    a.x = xi;
    a.y = yi;
    a.z = zi;
    if (ALCH) {
        for (int k = threadIdx.x; k < 3 * a.n_cls; k += FORCE_BLOCK)
            slam[k] = al.lam[k];
        // (the first tile's barrier below orders these stores)
    }

    // the block's partner window, ring positions p_lo .. p_lo + count - 1;
    // slot i's own window is w_lo .. w_hi - 1 (i - S .. i + S)
    const int p_lo = i0 - S;
    const int count = 2 * S + WARPS;
    const int n_tiles = (count + TILE - 1) / TILE;
    const int w_lo = i - S, w_hi = i + S + 1;
    int* const queue = reinterpret_cast<int*>(smem + 2 * TILE_ROWS) +
                       warp * (QUEUE + 1);
    unsigned head = 0, tail = 0;   // pairs drained and queued so far
    float fx = 0.0f, fy = 0.0f, fz = 0.0f, e_acc = 0.0f;

    // the pairs head .. head + cnt - 1 of the queue, one a lane
    auto drain = [&](unsigned cnt) {
        if (static_cast<unsigned>(lane) < cnt) {
            add_pair<ALCH>(queue[(head + lane) & (QUEUE - 1)], a, x, excl,
                           par, ph, al, slam, fx, fy, fz, e_acc);
        }
        head += cnt;
    };

    // tile t lives at smem + (t & 1) * TILE_ROWS
    stage_tile(smem, x, p_lo, min(TILE, count), n, n_pad);
    for (int t = 0; t < n_tiles; ++t) {
        const int t0 = p_lo + t * TILE;
        if (t + 1 < n_tiles) {
            stage_tile(smem + ((t + 1) & 1) * TILE_ROWS, x, t0 + TILE,
                       min(TILE, count - (t + 1) * TILE), n, n_pad);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();   // tile t has landed in every thread's copies
        if (real) {
            const float4* tile = smem + (t & 1) * TILE_ROWS;
            const int k_lo = max(w_lo - t0, 0);
            const int k_hi = min(w_hi - t0, min(TILE, count - t * TILE));
            for (int k0 = k_lo; k0 < k_hi; k0 += UNROLL * 32) {
                // the distances of UNROLL partners first, so that their
                // shared loads overlap
                bool hit[UNROLL];
#pragma unroll
                for (int u = 0; u < UNROLL; ++u) {
                    const int k = k0 + 32 * u + lane;
                    const float4 p = tile[k];
                    const float r2 = dist2_rn(ring_delta(xi - p.x, Lx, hx),
                                              ring_delta(yi - p.y, Ly, hy),
                                              ring_delta(zi - p.z, Lz, hz));
                    hit[u] = k < k_hi && r2 < ph.rc2 && r2 > 1e-12f;
                }
                // each hit to the queue at tail + the hits of the lower
                // lanes; a miss writes to the spare slot QUEUE (no branch)
                const int o = t0 + k0 + lane - i;
#pragma unroll
                for (int u = 0; u < UNROLL; ++u) {
                    const unsigned m = __ballot_sync(FULL_MASK, hit[u]);
                    const unsigned slot =
                        (tail + __popc(m & lower)) & (QUEUE - 1);
                    queue[hit[u] ? slot : QUEUE] = o + 32 * u;
                    tail += __popc(m);
                }
                if (tail - head >= 32u) {
                    __syncwarp();   // the queued pairs are visible
                    do {
                        drain(32u);
                    } while (tail - head >= 32u);
                    __syncwarp();   // read before they are overwritten
                }
            }
        }
        __syncthreads();   // every warp is done with tile t's buffer
    }
    __syncwarp();
    drain(tail - head);    // the slot's last, partial drain

    // the lanes' sums, by a fixed xor tree: every lane ends with the totals
    for (int offset = 16; offset > 0; offset >>= 1) {
        fx += __shfl_xor_sync(FULL_MASK, fx, offset);
        fy += __shfl_xor_sync(FULL_MASK, fy, offset);
        fz += __shfl_xor_sync(FULL_MASK, fz, offset);
        e_acc += __shfl_xor_sync(FULL_MASK, e_acc, offset);
    }
    if (lane == 0) {
        // a pad slot writes 0
        F[i] = fx;
        F[n_pad + i] = fy;
        F[2 * n_pad + i] = fz;
        warp_e[warp] = e_acc;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        float part = 0.0f;
        for (int w = 0; w < WARPS; ++w) part += warp_e[w];
        e_part[blockIdx.x] = part;
        __threadfence();   // the partial lands before the ticket is drawn
        last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    // the last block: U = 0.5 * the sum of the block partials (each pair
    // was met from both of its ends), in a fixed order; the partials are
    // read from L2, where the other blocks' writes meet
    Real acc = 0;
    for (int b = threadIdx.x; b < gridDim.x; b += FORCE_BLOCK)
        acc += static_cast<Real>(__ldcg(e_part + b));
    for (int offset = 16; offset > 0; offset >>= 1)
        acc += __shfl_xor_sync(FULL_MASK, acc, offset);
    if (lane == 0) red[warp] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
        Real total = 0;
        for (int w = 0; w < WARPS; ++w) total += red[w];
        U[0] = Real(0.5) * total;
        *ticket = 0u;   // armed for the next launch
    }
}

template <bool ALCH, typename Real>
int launch_forces(const float* x, const float* par, const int* excl, int n,
                  int n_pad, int mask_rows, int bs, const float* L,
                  const int* nblk, int B, const int* rep, const Physics& ph,
                  const Alch& al, float* e_part, unsigned int* ticket,
                  float* F, Real* U, unsigned long long* launches,
                  void* stream) {
    if (n_pad <= 0 || n_pad % PAD != 0 || n > n_pad || B < 1 || B > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    // past the 48 KB a block gets without asking
    const cudaError_t err = cudaFuncSetAttribute(
        sweep_forces_kernel<ALCH, Real>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, FORCE_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    sweep_forces_kernel<ALCH, Real>
        <<<dim3(n_pad / WARPS, B), FORCE_BLOCK, FORCE_SMEM,
           static_cast<cudaStream_t>(stream)>>>(x, par, excl, n, n_pad,
                                                mask_rows, bs, L, nblk, rep,
                                                ph, al, F, e_part, ticket, U,
                                                launches);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The block bounds nblk (R,) int of R sort sets: for set r, on rebuild (the
// bool rebuild[r] set) 1 + the last block of bs shells with a pair of real
// slots within sqrt(w2), else bound[r]; one cooperative launch either way.
// x (R, 3, n_pad) sorted positions wrapped into the box, L (R, 3); arcs
// holds R n_pad / 32 float2 of scratch, words R + 1 ints that are (-1, ...,
// -1, 0) on entry and again on exit. Any n_pad and R: the arcs are staged in
// shared memory up to STAGE_MAX bytes, else read from L2. launches (one
// unsigned 64-bit int on the device, or null) gains 1.
int sweep_bound_f32(const float* x, int n, int n_pad, int R, const float* L,
                    float w2, int bs, const unsigned char* rebuild,
                    const int* bound, float2* arcs, int* words, int* nblk,
                    unsigned long long* launches, void* stream) {
    if (n_pad <= 0 || n_pad % PAD != 0 || n > n_pad || bs <= 0 || R < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const int n_tiles = n_pad / GROUP;
    const size_t arc_bytes = sizeof(float2) * n_tiles * static_cast<size_t>(R);
    const bool staged = arc_bytes <= STAGE_MAX;
    const size_t smem = staged ? arc_bytes : 0;
    const void* kernel =
        staged ? reinterpret_cast<const void*>(sweep_bound_kernel<true>)
               : reinterpret_cast<const void*>(sweep_bound_kernel<false>);
    int max_blocks = 0;
    cudaError_t err =
        staged ? lj::max_coresident_blocks(sweep_bound_kernel<true>,
                                           BOUND_BLOCK, &max_blocks, smem)
               : lj::max_coresident_blocks(sweep_bound_kernel<false>,
                                           BOUND_BLOCK, &max_blocks, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (max_blocks == 0)
        return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    const int wanted = (n_tiles + BOUND_WARPS - 1) / BOUND_WARPS;
    const int blocks = wanted < max_blocks ? wanted : max_blocks;
    void* args[] = {&x, &n, &n_pad, &R, &L, &w2, &bs, &rebuild, &bound,
                    &arcs, &words, &nblk, &launches};
    err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(BOUND_BLOCK),
                                      args, smem,
                                      static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

// Forces F (B, 3, n_pad) and energies U (B,) of B evaluations of the
// bounded sweep, in one launch. The sort sets: x (R, 3, n_pad) sorted
// positions, excl (R, mask_rows, n_pad) the exception bitfields, L (R, 3)
// and the bounds nblk (R,) int read on the device; evaluation b reads the
// set rep[b] (int, on the device) and its own par[b] (3, n_pad) [sigma,
// sqrt(eps), charge]. e_part holds B n_pad / 16 floats of scratch, and
// ticket B unsigned ints that are 0 on entry and are 0 again on exit;
// launches (one unsigned 64-bit int on the device, or null) gains 1.
int sweep_forces_f32(const float* x, const float* par, const int* excl, int n,
                     int n_pad, int mask_rows, int bs, const float* L,
                     const int* nblk, int B, const int* rep, float rc2,
                     int coulomb_rf, float alpha, float k_rf, float c_rf,
                     int use_switch, int switch_coulomb, float r_switch,
                     float inv_span, float ke, float* e_part,
                     unsigned int* ticket, float* F, float* U,
                     unsigned long long* launches, void* stream) {
    const Physics ph{rc2, coulomb_rf, alpha, k_rf, c_rf, use_switch,
                     switch_coulomb, r_switch, inv_span, ke};
    const Alch al{nullptr, 0, 0};
    return launch_forces<false>(x, par, excl, n, n_pad, mask_rows, bs, L,
                                nblk, B, rep, ph, al, e_part, ticket, F, U,
                                launches, stream);
}

// The alchemical variant: as sweep_forces_f32, with par (B, 4, n_pad)
// [sigma, sqrt(eps), charge, region code], lam (B, 3 C) each evaluation's
// class scalars on the device (C = (R+1)(R+2)/2 - 1 <= 152 for n_regions
// R), coulomb_plain (the 'coulomb' PME treatment), and the energies U (B,)
// doubles: the float32 partials summed in double, so that the difference
// of two evaluations (the nonequilibrium work) is not rounded to a float32
// total's ulp (0.03 kJ/mol at -3.2e5 kJ/mol).
int sweep_forces_alch_f32(const float* x, const float* par, const int* excl,
                          int n, int n_pad, int mask_rows, int bs,
                          const float* L, const int* nblk, int B,
                          const int* rep, float rc2,
                          int coulomb_rf, float alpha, float k_rf, float c_rf,
                          int use_switch, int switch_coulomb, float r_switch,
                          float inv_span, float ke, const float* lam,
                          int n_regions, int coulomb_plain, float* e_part,
                          unsigned int* ticket, float* F, double* U,
                          unsigned long long* launches, void* stream) {
    const int n_cls = (n_regions + 1) * (n_regions + 2) / 2 - 1;
    if (n_regions < 1 || 3 * n_cls > MAX_LAM)
        return static_cast<int>(cudaErrorInvalidValue);
    const Physics ph{rc2, coulomb_rf, alpha, k_rf, c_rf, use_switch,
                     switch_coulomb, r_switch, inv_span, ke};
    const Alch al{lam, n_regions, coulomb_plain};
    return launch_forces<true>(x, par, excl, n, n_pad, mask_rows, bs, L,
                               nblk, B, rep, ph, al, e_part, ticket, F, U,
                               launches, stream);
}

}  // extern "C"
