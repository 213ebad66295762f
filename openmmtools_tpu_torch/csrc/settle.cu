// SETTLE for Hopper (sm_90a): the analytic constraint projections of rigid
// isosceles three-site molecules (rigid water), one thread a molecule.
//
// Replaces no pl.pallas_call: the JAX package's SETTLE
// (openmmtools_tpu/ops/constraints.py settle_positions, settle_velocities)
// is XLA tensor code, and so is the port's plain version in
// openmmtools_tpu_torch/ops/constraints.py, which stays the CPU path and
// these kernels' oracle. On the card that tensor code issued 120-170 short
// kernels a projection (and a whole-array torch.cat), which set the pace of
// an explicit-solvent MD step; here each projection is one launch.
//
// settle_positions_kernel: Miyamoto & Kollman's closed form (J. Comput.
// Chem. 13:952, 1992) of the plain version, operation for operation, in
// registers: the centre of mass of the unconstrained triangle, a frame from
// the old triangle's plane normal, the canonical triangle (apex at (0, ra),
// satellites at (+-rc, -rb)) rotated by phi, psi and theta, and the result
// back in the box frame about the centre of mass. It works in absolute box
// coordinates, as the plain version does, not relative to the old apex:
// the bond lengths come out of the frame's unit vectors either way, so the
// constraint residual is the final rounding of each coordinate in both
// designs, and keeping the plain version's operations keeps the kernel
// within float32 rounding of it at any box size. The centre of mass is
// summed with explicit round-to-nearest products and sums, so that no
// contraction into a fused multiply-add moves it by a rounding: the
// orientation follows the apex's offset from it, 0.0066 nm for TIP3P, and
// one rounding of a 6 nm coordinate there tilts the hydrogens by ~4e-6 nm.
//
// settle_velocities_kernel: the 3x3 Cramer solve of the plain version for
// the three bond multipliers, and the three corrections added.
//
// Layout: x, x_ref, v are (B, n, 3) contiguous (B = 1 for one
// configuration); molecule w of configuration b is thread b * W + w; its
// atoms are a[w], b[w], c[w] (int64), the same for every b, so one path
// serves the contiguous and the scattered layout. tab (5, W) holds each
// molecule's apex mass, satellite mass, ra, rb, rc in the kernel's type.
// The wrapper hands in an output that already holds x (v) where no triangle
// reaches, or one that every triangle covers. No thread reads another's
// result and nothing is summed across threads (no atomics): a molecule's
// result is the same to the bit alone, in any batch and in a graph replay.
// What bounds it: one launch's latency at B = 1 (8,000 waters read ~1 MB
// and write ~0.3 MB: 0.3 us at 3.35 TB/s), its bytes at B = 9.
//
// Each launch's first thread adds 1 to a device counter, launches, so that
// the launches a CUDA graph replays count as they run. Every C entry point
// returns cudaGetLastError() after its launch; the Python wrapper raises if
// it is not 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 128;

__device__ __forceinline__ float mul_rn(float a, float b) {
    return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
    return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
    return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
    return __dadd_rn(a, b);
}

template <typename T>
struct V3 {
    T x, y, z;
};

template <typename T>
__device__ __forceinline__ V3<T> load(const T* p, long long atom) {
    return {p[3 * atom], p[3 * atom + 1], p[3 * atom + 2]};
}

template <typename T>
__device__ __forceinline__ void store(T* p, long long atom, V3<T> v) {
    p[3 * atom] = v.x;
    p[3 * atom + 1] = v.y;
    p[3 * atom + 2] = v.z;
}

template <typename T>
__device__ __forceinline__ V3<T> sub(V3<T> a, V3<T> b) {
    return {a.x - b.x, a.y - b.y, a.z - b.z};
}

template <typename T>
__device__ __forceinline__ V3<T> add(V3<T> a, V3<T> b) {
    return {a.x + b.x, a.y + b.y, a.z + b.z};
}

template <typename T>
__device__ __forceinline__ V3<T> scale(V3<T> a, T s) {
    return {a.x * s, a.y * s, a.z * s};
}

template <typename T>
__device__ __forceinline__ T dot(V3<T> a, V3<T> b) {
    return a.x * b.x + a.y * b.y + a.z * b.z;
}

template <typename T>
__device__ __forceinline__ V3<T> cross(V3<T> a, V3<T> b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x};
}

template <typename T>
__device__ __forceinline__ T clamp1(T s) {
    return s < T(-1) ? T(-1) : (s > T(1) ? T(1) : s);
}

// the centre of mass (ma a + mh (b + c)) / M, each operation rounded
template <typename T>
__device__ __forceinline__ T com1(T ma, T mh, T M, T a, T b, T c) {
    return add_rn(mul_rn(ma, a), mul_rn(mh, add_rn(b, c))) / M;
}

template <typename T>
__global__ void __launch_bounds__(BLOCK)
settle_positions_kernel(const T* __restrict__ x, const T* __restrict__ xref,
                        T* __restrict__ out,
                        const long long* __restrict__ ia,
                        const long long* __restrict__ ib,
                        const long long* __restrict__ ic,
                        const T* __restrict__ tab, int n, int W, int B,
                        unsigned long long* launches) {
    const long long t = static_cast<long long>(blockIdx.x) * BLOCK +
                        threadIdx.x;
    if (launches && t == 0) atomicAdd(launches, 1ull);
    if (t >= static_cast<long long>(W) * B) return;
    const int w = static_cast<int>(t % W);
    const long long base = (t / W) * n;
    const long long A = base + ia[w], Bt = base + ib[w], C = base + ic[w];
    const T ma = tab[w], mh = tab[W + w];
    const T ra = tab[2 * W + w], rb = tab[3 * W + w], rc = tab[4 * W + w];
    const T M = ma + T(2) * mh;

    const V3<T> a0 = load(xref, A), b0 = load(xref, Bt), c0 = load(xref, C);
    const V3<T> a1 = load(x, A), b1 = load(x, Bt), c1 = load(x, C);
    const V3<T> com = {com1(ma, mh, M, a1.x, b1.x, c1.x),
                       com1(ma, mh, M, a1.y, b1.y, c1.y),
                       com1(ma, mh, M, a1.z, b1.z, c1.z)};
    const V3<T> a1p = sub(a1, com), b1p = sub(b1, com), c1p = sub(c1, com);

    // orthonormal frame: z along the old plane's normal, a1' in the y-z
    // plane
    const V3<T> ab0 = sub(b0, a0), ac0 = sub(c0, a0);
    V3<T> zax = cross(ab0, ac0);
    zax = scale(zax, T(1) / sqrt(dot(zax, zax)));
    V3<T> xax = cross(a1p, zax);
    xax = scale(xax, T(1) / fmax(sqrt(dot(xax, xax)), T(1e-12)));
    const V3<T> yax = cross(zax, xax);

    // the old triangle relative to the old apex, the new about the centre
    // of mass, in the frame (Miyamoto & Kollman eq. A5-A9)
    const T b0x = dot(xax, ab0), b0y = dot(yax, ab0);
    const T c0x = dot(xax, ac0), c0y = dot(yax, ac0);
    const T a1z = dot(zax, a1p);
    const T b1x = dot(xax, b1p), b1y = dot(yax, b1p), b1z = dot(zax, b1p);
    const T c1x = dot(xax, c1p), c1y = dot(yax, c1p), c1z = dot(zax, c1p);

    const T sinphi = clamp1(a1z / ra);
    const T cosphi = sqrt(T(1) - sinphi * sinphi);
    const T sinpsi = clamp1((b1z - c1z) / (T(2) * rc * cosphi));
    const T cospsi = sqrt(T(1) - sinpsi * sinpsi);

    const T ya2 = ra * cosphi;
    const T xb2 = -rc * cospsi;
    const T yb2 = -rb * cosphi - rc * sinpsi * sinphi;
    const T yc2 = -rb * cosphi + rc * sinpsi * sinphi;

    const T alpha = xb2 * (b0x - c0x) + b0y * yb2 + c0y * yc2;
    const T beta = xb2 * (c0y - b0y) + b0x * yb2 + c0x * yc2;
    const T gamma = b0x * b1y - b1x * b0y + c0x * c1y - c1x * c0y;
    const T a2b2 = alpha * alpha + beta * beta;
    const T sintheta = clamp1(
        (alpha * gamma - beta * sqrt(fmax(a2b2 - gamma * gamma, T(0)))) /
        a2b2);
    const T costheta = sqrt(T(1) - sintheta * sintheta);

    const T za2 = ra * sinphi;
    const T zb2 = -rb * sinphi + rc * sinpsi * cosphi;
    const T zc2 = -rb * sinphi - rc * sinpsi * cosphi;
    const V3<T> a3 = {-ya2 * sintheta, ya2 * costheta, za2};
    const V3<T> b3 = {xb2 * costheta - yb2 * sintheta,
                      xb2 * sintheta + yb2 * costheta, zb2};
    const V3<T> c3 = {-xb2 * costheta - yc2 * sintheta,
                      -xb2 * sintheta + yc2 * costheta, zc2};

    // back to the box frame (R^T p) about the centre of mass
    auto unrot = [&](V3<T> p) {
        return add(add(scale(xax, p.x), scale(yax, p.y)), scale(zax, p.z));
    };
    store(out, A, add(com, unrot(a3)));
    store(out, Bt, add(com, unrot(b3)));
    store(out, C, add(com, unrot(c3)));
}

template <typename T>
__device__ __forceinline__ V3<T> unit(V3<T> p, V3<T> q) {
    const V3<T> r = sub(p, q);
    return scale(r, T(1) / sqrt(dot(r, r)));
}

template <typename T>
__global__ void __launch_bounds__(BLOCK)
settle_velocities_kernel(const T* __restrict__ x, const T* __restrict__ v,
                         T* __restrict__ out,
                         const long long* __restrict__ ia,
                         const long long* __restrict__ ib,
                         const long long* __restrict__ ic,
                         const T* __restrict__ tab, int n, int W, int B,
                        unsigned long long* launches) {
    const long long t = static_cast<long long>(blockIdx.x) * BLOCK +
                        threadIdx.x;
    if (launches && t == 0) atomicAdd(launches, 1ull);
    if (t >= static_cast<long long>(W) * B) return;
    const int w = static_cast<int>(t % W);
    const long long base = (t / W) * n;
    const long long A = base + ia[w], Bt = base + ib[w], C = base + ic[w];
    const T inv_ma = T(1) / tab[w], inv_mh = T(1) / tab[W + w];

    const V3<T> xa = load(x, A), xb = load(x, Bt), xc = load(x, C);
    const V3<T> va = load(v, A), vb = load(v, Bt), vc = load(v, C);
    // bonds: 0 = (a, b), 1 = (a, c), 2 = (b, c); unit directions
    const V3<T> e0 = unit(xa, xb), e1 = unit(xa, xc), e2 = unit(xb, xc);
    const T r1 = dot(sub(va, vb), e0), r2 = dot(sub(va, vc), e1),
            r3 = dot(sub(vb, vc), e2);
    const T d01 = dot(e0, e1), d02 = dot(e0, e2), d12 = dot(e1, e2);

    const T mab = inv_ma + inv_mh, mbb = T(2) * inv_mh;
    const T a11 = mab, a12 = inv_ma * d01, a13 = -inv_mh * d02;
    const T a21 = inv_ma * d01, a22 = mab, a23 = inv_mh * d12;
    const T a31 = -inv_mh * d02, a32 = inv_mh * d12, a33 = mbb;
    const T det = a11 * (a22 * a33 - a23 * a32) -
                  a12 * (a21 * a33 - a23 * a31) +
                  a13 * (a21 * a32 - a22 * a31);
    const T g0 = (r1 * (a22 * a33 - a23 * a32) - a12 * (r2 * a33 - a23 * r3) +
                  a13 * (r2 * a32 - a22 * r3)) / det;
    const T g1 = (a11 * (r2 * a33 - a23 * r3) - r1 * (a21 * a33 - a23 * a31) +
                  a13 * (a21 * r3 - r2 * a31)) / det;
    const T g2 = (a11 * (a22 * r3 - r2 * a32) - a12 * (a21 * r3 - r2 * a31) +
                  r1 * (a21 * a32 - a22 * a31)) / det;

    const V3<T> da = scale(add(scale(e0, g0), scale(e1, g1)), -inv_ma);
    const V3<T> db = scale(sub(scale(e0, g0), scale(e2, g2)), inv_mh);
    const V3<T> dc = scale(add(scale(e1, g1), scale(e2, g2)), inv_mh);
    store(out, A, add(va, da));
    store(out, Bt, add(vb, db));
    store(out, C, add(vc, dc));
}

template <typename T>
int launch_positions(const T* x, const T* xref, T* out, const long long* a,
                     const long long* b, const long long* c, const T* tab,
                     int n, int W, int B, unsigned long long* launches,
                     void* stream) {
    const long long threads = static_cast<long long>(W) * B;
    const unsigned blocks = static_cast<unsigned>((threads + BLOCK - 1) /
                                                  BLOCK);
    settle_positions_kernel<T><<<blocks, BLOCK, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        x, xref, out, a, b, c, tab, n, W, B, launches);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_velocities(const T* x, const T* v, T* out, const long long* a,
                      const long long* b, const long long* c, const T* tab,
                      int n, int W, int B, unsigned long long* launches,
                      void* stream) {
    const long long threads = static_cast<long long>(W) * B;
    const unsigned blocks = static_cast<unsigned>((threads + BLOCK - 1) /
                                                  BLOCK);
    settle_velocities_kernel<T><<<blocks, BLOCK, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        x, v, out, a, b, c, tab, n, W, B, launches);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out (B, n, 3): x (B, n, 3) with each of the W triangles projected onto
// its constraints from x_ref (B, n, 3); a, b, c (W,) int64 atom indices,
// tab (5, W) apex mass, satellite mass, ra, rb, rc; launches (one unsigned
// 64-bit int on the device, or null) gains 1.
int settle_positions_f32(const float* x, const float* xref, float* out,
                         const long long* a, const long long* b,
                         const long long* c, const float* tab, int n, int W,
                         int B, unsigned long long* launches, void* stream) {
    return launch_positions(x, xref, out, a, b, c, tab, n, W, B, launches,
                            stream);
}

int settle_positions_f64(const double* x, const double* xref, double* out,
                         const long long* a, const long long* b,
                         const long long* c, const double* tab, int n, int W,
                         int B, unsigned long long* launches, void* stream) {
    return launch_positions(x, xref, out, a, b, c, tab, n, W, B, launches,
                            stream);
}

// out (B, n, 3): v (B, n, 3) with each triangle's relative velocities
// along its bonds at x (B, n, 3) removed; the other arguments as above.
int settle_velocities_f32(const float* x, const float* v, float* out,
                          const long long* a, const long long* b,
                          const long long* c, const float* tab, int n, int W,
                          int B, unsigned long long* launches, void* stream) {
    return launch_velocities(x, v, out, a, b, c, tab, n, W, B, launches,
                             stream);
}

int settle_velocities_f64(const double* x, const double* v, double* out,
                          const long long* a, const long long* b,
                          const long long* c, const double* tab, int n,
                          int W, int B, unsigned long long* launches,
                          void* stream) {
    return launch_velocities(x, v, out, a, b, c, tab, n, W, B, launches,
                             stream);
}

}  // extern "C"
