// Device code shared by the LJ-fluid kernels: fused_langevin.cu (K1's
// forces), dense_baoab.cu (the chunk kernel of K1 and K3) and cell_md.cu
// (K4). With one pair term, one all-pairs sweep and one noise draw, the
// kernels compute a pair and draw their Ornstein-Uhlenbeck noise alike, and
// their plain PyTorch versions (ops/fused_langevin.py, ops/fused_md.py)
// repeat this arithmetic.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lj {

// LJ with a cutoff and OpenMM's quintic switch over [r_switch, rc]; a pair
// counts when r2_min < r^2 < rc^2 (the lower bound drops the self pair).
struct Params {
    float rc2, sig2, eps4, eps24, r_switch, inv_span;
    int use_switch;
    float r2_min;
};

__device__ __forceinline__ float min_image(float d, float L, float inv_L) {
    return d - L * rintf(d * inv_L);
}

// One pair at squared distance r2: false outside (r2_min, rc^2); else w,
// with the force on i w * (x_i - x_j), and the pair energy e.
__device__ __forceinline__ bool pair(float r2, const Params& p, float& w,
                                     float& e) {
    if (!(r2 < p.rc2 && r2 > p.r2_min)) return false;
    const float inv_r = rsqrtf(r2);
    const float inv_r2 = inv_r * inv_r;
    const float s2 = p.sig2 * inv_r2;
    const float s6 = s2 * s2 * s2;
    const float s12 = s6 * s6;
    e = p.eps4 * (s12 - s6);
    w = p.eps24 * (2.0f * s12 - s6) * inv_r2;
    if (p.use_switch) {
        const float r = r2 * inv_r;
        // r < rc, so t <= 1: only the lower clamp
        const float t = fmaxf((r - p.r_switch) * p.inv_span, 0.0f);
        const float S = 1.0f + t * t * t * (-10.0f + t * (15.0f - 6.0f * t));
        const float omt = 1.0f - t;
        const float dS = (-30.0f * p.inv_span) * (t * t) * (omt * omt);
        w = w * S - e * dS * inv_r;
        e = e * S;
    }
    return true;
}

constexpr unsigned FULL_MASK = 0xFFFFFFFFu;
constexpr int TILE = 2048;   // partners a block stages in shared memory

// One partner at minimum-image offset (dx, dy, dz) from the particle: its
// pair force and energy added to the accumulators.
__device__ __forceinline__ void add_pair(float dx, float dy, float dz,
                                         const Params& p, float& fx,
                                         float& fy, float& fz, float& e_acc) {
    float w, e;
    if (pair(dx * dx + dy * dy + dz * dz, p, w, e)) {
        fx += w * dx;
        fy += w * dy;
        fz += w * dz;
        e_acc += e;
    }
}

// Force on particle i and its pair-energy sum against all n particles of x
// (3, n), minimum image in an orthorhombic box, one warp a particle and
// WARPS particles a block: the block stages tiles of TILE partners in
// shared memory, and lane l of a warp takes the partners j = l, l + 32, ...
// of each tile; a xor butterfly of shuffles then sums the 32 lanes, so
// every lane ends with the same totals, summed in the same order on every
// launch (no atomics). Every thread of the block calls it, equally often; a
// warp without a particle passes i >= n and gets zeros. x is read with plain
// loads: in a cooperative kernel the positions were written by other
// blocks earlier in the same launch.
//
// Why this layout: one thread a particle would run the sweep at one
// thread's serial latency, N iterations, on N/64 blocks of 64 (32 of the
// H100's 132 SMs at N = 2048). A warp a particle gives N warps of N/32
// iterations, enough to fill every SM. Read straight from global memory,
// each iteration of a lane would wait on an L1/L2 load; from a staged tile
// the loads take a shared-memory round trip, four partners at a time.
// Tensor cores do not serve: the work is a minimum-image distance test
// with a branch per pair, not a matrix product, and TF32's 10-bit mantissa
// would round r^2 well past the kernels' 2e-4 tolerance.
template <int WARPS>
__device__ __forceinline__ void block_pairs(
        const float* x, int n, int i, float Lx, float Ly, float Lz,
        const Params& p, float& fx, float& fy, float& fz, float& e_acc) {
    __shared__ float sx[TILE], sy[TILE], sz[TILE];
    const int lane = threadIdx.x & 31;
    const float iLx = 1.0f / Lx, iLy = 1.0f / Ly, iLz = 1.0f / Lz;
    const bool mine = i < n;
    const float xi = mine ? x[i] : 0.0f;
    const float yi = mine ? x[n + i] : 0.0f;
    const float zi = mine ? x[2 * n + i] : 0.0f;
    fx = fy = fz = e_acc = 0.0f;
    for (int t0 = 0; t0 < n; t0 += TILE) {
        const int m = min(TILE, n - t0);
        __syncthreads();   // every warp is done with the previous tile
        for (int k = threadIdx.x; k < m; k += WARPS * 32) {
            sx[k] = x[t0 + k];
            sy[k] = x[n + t0 + k];
            sz[k] = x[2 * n + t0 + k];
        }
        __syncthreads();
        if (!mine) continue;
        int k = lane;
        // four partners a lane at a time, their distances first: the
        // shared-memory loads and the distance tests of the four overlap
        for (; k + 96 < m; k += 128) {
            float dx[4], dy[4], dz[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                dx[u] = min_image(xi - sx[k + 32 * u], Lx, iLx);
                dy[u] = min_image(yi - sy[k + 32 * u], Ly, iLy);
                dz[u] = min_image(zi - sz[k + 32 * u], Lz, iLz);
            }
#pragma unroll
            for (int u = 0; u < 4; ++u)
                add_pair(dx[u], dy[u], dz[u], p, fx, fy, fz, e_acc);
        }
        for (; k < m; k += 32)
            add_pair(min_image(xi - sx[k], Lx, iLx),
                     min_image(yi - sy[k], Ly, iLy),
                     min_image(zi - sz[k], Lz, iLz), p, fx, fy, fz, e_acc);
    }
    for (int offset = 16; offset > 0; offset >>= 1) {
        fx += __shfl_xor_sync(FULL_MASK, fx, offset);
        fy += __shfl_xor_sync(FULL_MASK, fy, offset);
        fz += __shfl_xor_sync(FULL_MASK, fz, offset);
        e_acc += __shfl_xor_sync(FULL_MASK, e_acc, offset);
    }
}

// The sum over a block of WARPS warps of one value a warp (every lane of
// warp w holding v_w), in warp order; valid in thread 0. Every thread of
// the block calls it.
template <int WARPS>
__device__ __forceinline__ float block_sum(float v) {
    __shared__ float s[WARPS];
    if ((threadIdx.x & 31) == 0) s[threadIdx.x >> 5] = v;
    __syncthreads();
    float acc = 0.0f;
    if (threadIdx.x == 0)
        for (int w = 0; w < WARPS; ++w) acc += s[w];
    __syncthreads();   // s may be written again by a later call
    return acc;
}

// U = 0.5 * the sum of the m block partials (each unordered pair was counted
// from both ends), by one block of WARPS warps in a fixed order: thread t
// sums partials t, t + blockDim, ..., then the block sums the threads. The
// partials were written by other blocks of the launch, so they are read
// from L2 (__ldcg), the point where those writes meet.
template <int WARPS>
__device__ __forceinline__ void sum_partials(const float* u_partial, int m,
                                             float* U) {
    float acc = 0.0f;
    for (int b = threadIdx.x; b < m; b += WARPS * 32)
        acc += __ldcg(u_partial + b);
    for (int offset = 16; offset > 0; offset >>= 1)
        acc += __shfl_xor_sync(FULL_MASK, acc, offset);
    const float total = block_sum<WARPS>(acc);
    if (threadIdx.x == 0) U[0] = 0.5f * total;
}

// Philox4x32-10 (Salmon et al., SC'11), the Random123 round function.
__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0,
                                              uint32_t k1) {
    for (int r = 0; r < 10; ++r) {
        if (r > 0) {
            k0 += 0x9E3779B9u;
            k1 += 0xBB67AE85u;
        }
        const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]);
        const uint32_t lo0 = 0xD2511F53u * c[0];
        const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]);
        const uint32_t lo1 = 0xCD9E8D57u * c[2];
        const uint32_t n0 = hi1 ^ c[1] ^ k0;
        const uint32_t n2 = hi0 ^ c[3] ^ k1;
        c[0] = n0;
        c[1] = lo1;
        c[2] = n2;
        c[3] = lo0;
    }
}

// 23 random bits -> uniform in (0, 1), never 0 (so log() stays finite);
// the same map as the TPU kernel's draw_noise
__device__ __forceinline__ float bits_to_uniform(uint32_t r) {
    return static_cast<float>(r >> 9) * (1.0f / 8388608.0f) + (0.5f / 8388608.0f);
}

// Three standard normals by Box-Muller over one Philox draw with counter
// (c0, c1, c2, 0) and key (k0, k1): (r0, r1) give z0 and z1, (r2, r3) z2.
__device__ __forceinline__ void normal3(uint32_t c0, uint32_t c1, uint32_t c2,
                                        uint32_t k0, uint32_t k1, float& z0,
                                        float& z1, float& z2) {
    uint32_t c[4] = {c0, c1, c2, 0u};
    philox4x32_10(c, k0, k1);
    const float u0 = bits_to_uniform(c[0]);
    const float u1 = bits_to_uniform(c[1]);
    const float u2 = bits_to_uniform(c[2]);
    const float u3 = bits_to_uniform(c[3]);
    const float two_pi = 6.2831853071795865f;
    const float rad01 = sqrtf(-2.0f * logf(u0));
    const float rad23 = sqrtf(-2.0f * logf(u2));
    z0 = rad01 * cosf(two_pi * u1);
    z1 = rad01 * sinf(two_pi * u1);
    z2 = rad23 * cosf(two_pi * u3);
}

// Co-resident blocks of a cooperative kernel of `block` threads and `smem`
// bytes of dynamic shared memory a block on the current device (0 when the
// device cannot launch cooperative kernels).
template <typename Kernel>
inline cudaError_t max_coresident_blocks(Kernel kernel, int block, int* out,
                                         size_t smem = 0) {
    int dev = 0, coop = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, block, smem);
    *out = (err == cudaSuccess && coop) ? per_sm * sms : 0;
    return err;
}

}  // namespace lj
