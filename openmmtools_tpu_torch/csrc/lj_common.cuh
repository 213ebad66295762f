// Device code shared by the LJ-fluid kernels: fused_langevin.cu (K1),
// dense_baoab.cu (K3) and cell_md.cu (K4). With one pair term, one
// all-pairs tile loop and one noise draw, the three kernels compute a pair
// and draw their Ornstein-Uhlenbeck noise alike, and their plain PyTorch
// versions (ops/fused_langevin.py, ops/fused_md.py) repeat this arithmetic.
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

// Force on particle (xi, yi, zi) and its pair-energy sum against all n
// particles of x (3, n), minimum image in an orthorhombic box: partner
// tiles of BLOCK are staged in shared memory by the whole block, so every
// thread of the block calls it, those without a particle with
// active = false. x is read with plain loads: in a cooperative kernel the
// positions were written by other blocks earlier in the same launch.
template <int BLOCK>
__device__ __forceinline__ void all_pairs(
        const float* x, int n, bool active, float xi, float yi, float zi,
        float Lx, float Ly, float Lz, const Params& p, float* sx, float* sy,
        float* sz, float& fx, float& fy, float& fz, float& e_acc) {
    const int tid = threadIdx.x;
    const float iLx = 1.0f / Lx, iLy = 1.0f / Ly, iLz = 1.0f / Lz;
    fx = fy = fz = e_acc = 0.0f;
    for (int j0 = 0; j0 < n; j0 += BLOCK) {
        const int j = j0 + tid;
        if (j < n) {
            sx[tid] = x[j];
            sy[tid] = x[n + j];
            sz[tid] = x[2 * n + j];
        }
        __syncthreads();
        const int jn = min(BLOCK, n - j0);
        if (active) {
            for (int k = 0; k < jn; ++k) {
                const float dx = min_image(xi - sx[k], Lx, iLx);
                const float dy = min_image(yi - sy[k], Ly, iLy);
                const float dz = min_image(zi - sz[k], Lz, iLz);
                float w, e;
                if (pair(dx * dx + dy * dy + dz * dz, p, w, e)) {
                    fx += w * dx;
                    fy += w * dy;
                    fz += w * dz;
                    e_acc += e;
                }
            }
        }
        __syncthreads();
    }
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

// Co-resident blocks of a cooperative kernel on the current device (0 when
// the device cannot launch cooperative kernels).
template <typename Kernel>
inline cudaError_t max_coresident_blocks(Kernel kernel, int block, int* out) {
    int dev = 0, coop = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, block, 0);
    *out = (err == cudaSuccess && coop) ? per_sm * sms : 0;
    return err;
}

}  // namespace lj
