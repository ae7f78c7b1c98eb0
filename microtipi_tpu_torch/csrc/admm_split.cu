// The ADMM object engine's split update and right-hand side, float32, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: in microtipi_tpu/jobs/admm.py the iteration is one
// lax.scan under jit, and XLA fuses these two pieces of `step_core` on the TPU.
// PyTorch runs eagerly, where the same lines are over a hundred elementwise
// launches and volume passes an iteration, so each piece is one kernel here:
//   admm_split_update  everything after the x-update for the splits z1 = Dx and
//                      z2 = x (admm.py:353-368): circular forward differences,
//                      over-relaxation, the masked gradient magnitude, 8 Newton
//                      steps of the hyperbolic prox (`_hyperbolic_prox`, :170-182),
//                      the rescale, the positivity clamp and the four dual updates;
//   admm_rhs           the x-update's right-hand side (admm.py:330-331):
//                      rho1 * D^T(z1 - u1) + rho2 * (z2 - u2).
//
// Layout: x, z2, u2 and the rhs are (B, nz, ny, nx); z1 and u1 are (B, 3, nz, ny, nx),
// the component index a in (z, y, x) second. Every lane b has its own lam = mu/rho1,
// rho1 and rho2, read from device arrays of B floats.
//
// Math of admm_split_update per voxel p of lane b, per axis a with scale s_a (e_a
// wraps around the volume: the splitting is circular so that D^T D stays circulant):
//   d_a   = (x(p + e_a) - x(p)) / s_a
//   dr_a  = alpha d_a + (1 - alpha) z1_a            (alpha != 1 only, else d_a)
//   v_a   = dr_a + u1_a
//   vmag  = sqrt(sum_a m_a v_a^2 + tiny),  m_a = 0 on axis a's trailing face, else 1
//   s     = Newton(vmag, lam, eps): s <- max(s - g/g', 0) 8 times from max(vmag - lam, 0),
//           g = s + lam s/r - vmag, g' = 1 + lam eps^2 / r^3, r = sqrt(s^2 + eps^2)
//   z1_a  = (s / vmag) v_a where m_a = 1, v_a on the trailing face (unpenalized there:
//           the penalty is the replicate-boundary TV)
//   xr    = alpha x + (1 - alpha) z2                (alpha != 1 only, else x)
//   z2    = max(xr + u2, 0)                         (or xr + u2 without positivity)
//   u1_a += dr_a - z1_a,   u2 += xr - z2
// in place on z1, u1, z2, u2. Only x is read at neighbouring voxels, and x is not
// written, so the in-place update is safe. admm_rhs reads z1 - u1 at p - e_a and
// therefore runs as its own launch:
//   rhs = rho1 * sum_a ((z1_a - u1_a)(p - e_a) - (z1_a - u1_a)(p)) / s_a + rho2 (z2 - u2).
//
// What bounds them: bytes. admm_split_update reads x, u1 x 3 and u2 and writes
// z1 x 3, u1 x 3, z2 and u2, 13 volumes (17 with alpha != 1, which also reads z1 x 3
// and z2): 52 N bytes a lane, 0.26 ms at 256^3 and 3.35 TB/s. The Newton loop is
// about 100 float32 operations a voxel, a few percent of that time at 67 TFLOP/s.
// admm_rhs reads 8 volumes and writes 1 (0.18 ms at 256^3). The design is the plain
// one: a thread a voxel, consecutive threads along x so every access of the own
// voxel coalesces, the neighbours of x (and of z1 - u1) left to the caches; a block
// covers 256 voxels of one (lane, z) plane and strides over planes, so the index
// arithmetic is 32-bit. Staging in shared memory and fusing the two launches into
// one sweep are later work.
//
// Rounding: every operation is an explicit round-to-nearest intrinsic in the order
// of the plain PyTorch version (ops/kernels/admm_split.py), so nvcc contracts no
// multiply-add and the two agree bit for bit where PyTorch's own operators round
// once (they do, but for a division by a Python scalar on the card, which PyTorch
// turns into a multiplication by its reciprocal: exact for unit scales and powers
// of two).
//
// A plain C interface, loaded with ctypes. Each launch goes on the caller's stream
// and the function returns cudaGetLastError().

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#define ADMM_THREADS 256
#define ADMM_NEWTON 8
#define ADMM_GRID_Y 65535

namespace {

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// prox of lam * (sqrt(t^2 + eps^2) - eps) on the magnitude v >= 0: the root of
// g(s) = s + lam s / sqrt(s^2 + eps^2) - v by Newton from max(v - lam, 0) <= s*.
__device__ __forceinline__ float hyperbolic_prox(float v, float lam, float eps, float eps2) {
    const float le2 = mul(mul(lam, eps), eps);
    float s = fmaxf(sub(v, lam), 0.0f);
#pragma unroll
    for (int k = 0; k < ADMM_NEWTON; ++k) {
        const float r = __fsqrt_rn(add(mul(s, s), eps2));
        const float g = sub(add(s, dvd(mul(lam, s), r)), v);
        const float gp = add(1.0f, dvd(le2, mul(mul(r, r), r)));
        s = fmaxf(sub(s, dvd(g, gp)), 0.0f);
    }
    return s;
}

template <bool kRelax, bool kPositivity>
__global__ void __launch_bounds__(ADMM_THREADS)
admm_split_update_kernel(const float* __restrict__ x, float* __restrict__ z1, float* __restrict__ u1,
                         float* __restrict__ z2, float* __restrict__ u2, const float* __restrict__ lam,
                         int nb, int nz, int ny, int nx, float eps, float eps2, float alpha,
                         float one_minus_alpha, float sz, float sy, float sx) {
    const int plane = ny * nx;
    const int q = blockIdx.x * ADMM_THREADS + threadIdx.x;  // voxel within the (lane, z) plane
    if (q >= plane) return;
    const int iy = q / nx, ix = q - iy * nx;
    const int64_t n = (int64_t)nz * plane;
    const float scales[3] = {sz, sy, sx};

    for (int p = blockIdx.y; p < nb * nz; p += gridDim.y) {
        const int lane = p / nz, iz = p - lane * nz;
        const int64_t i = (int64_t)p * plane + q;  // into x, z2, u2
        const int64_t j = i + 2 * lane * n;        // into z1, u1, component 0
        const float xc = x[i];
        const float xn[3] = {
            x[iz == nz - 1 ? i - (int64_t)(nz - 1) * plane : i + plane],
            x[iy == ny - 1 ? i - (int64_t)(ny - 1) * nx : i + nx],
            x[ix == nx - 1 ? i - (nx - 1) : i + 1],
        };
        const bool face[3] = {iz == nz - 1, iy == ny - 1, ix == nx - 1};
        const float lam_b = lam[lane];

        float dr[3], v[3], uo[3];
        float sum = 0.0f;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            float d = dvd(sub(xn[a], xc), scales[a]);
            if (kRelax) d = add(mul(alpha, d), mul(one_minus_alpha, z1[j + a * n]));
            dr[a] = d;
            uo[a] = u1[j + a * n];
            v[a] = add(d, uo[a]);
            const float sq = face[a] ? 0.0f : mul(v[a], v[a]);
            sum = a == 0 ? sq : add(sum, sq);
        }
        const float vmag = __fsqrt_rn(add(sum, FLT_MIN));
        const float scale = dvd(hyperbolic_prox(vmag, lam_b, eps, eps2), vmag);
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            const float z = face[a] ? v[a] : mul(scale, v[a]);
            z1[j + a * n] = z;
            u1[j + a * n] = sub(add(uo[a], dr[a]), z);
        }
        const float xr = kRelax ? add(mul(alpha, xc), mul(one_minus_alpha, z2[i])) : xc;
        const float uo2 = u2[i];
        float z = add(xr, uo2);
        if (kPositivity) z = fmaxf(z, 0.0f);
        z2[i] = z;
        u2[i] = sub(add(uo2, xr), z);
    }
}

__global__ void __launch_bounds__(ADMM_THREADS)
admm_rhs_kernel(const float* __restrict__ z1, const float* __restrict__ u1, const float* __restrict__ z2,
                const float* __restrict__ u2, const float* __restrict__ rho1, const float* __restrict__ rho2,
                float* __restrict__ out, int nb, int nz, int ny, int nx, float sz, float sy, float sx) {
    const int plane = ny * nx;
    const int q = blockIdx.x * ADMM_THREADS + threadIdx.x;
    if (q >= plane) return;
    const int iy = q / nx, ix = q - iy * nx;
    const int64_t n = (int64_t)nz * plane;
    const float scales[3] = {sz, sy, sx};

    for (int p = blockIdx.y; p < nb * nz; p += gridDim.y) {
        const int lane = p / nz, iz = p - lane * nz;
        const int64_t i = (int64_t)p * plane + q;
        const int64_t j = i + 2 * lane * n;
        // The voxel before this one along each axis, around the volume.
        const int64_t back[3] = {
            iz == 0 ? (int64_t)(nz - 1) * plane : -(int64_t)plane,
            iy == 0 ? (int64_t)(ny - 1) * nx : -(int64_t)nx,
            ix == 0 ? (int64_t)(nx - 1) : -1,
        };
        float adj = 0.0f;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            const int64_t c = j + a * n;
            const float g = sub(z1[c], u1[c]);
            const float gb = sub(z1[c + back[a]], u1[c + back[a]]);
            const float t = dvd(sub(gb, g), scales[a]);
            adj = a == 0 ? t : add(adj, t);
        }
        out[i] = add(mul(rho1[lane], adj), mul(rho2[lane], sub(z2[i], u2[i])));
    }
}

// The grid of both kernels: x over a plane's voxels, y over the B * nz planes
// (strided above CUDA's limit on grid y).
bool plane_grid(int nb, int nz, int ny, int nx, dim3* grid) {
    if (nb < 1 || nz < 1 || ny < 1 || nx < 1) return false;
    if ((int64_t)ny * nx > INT32_MAX - ADMM_THREADS || (int64_t)nb * nz > INT32_MAX) return false;
    const int planes = nb * nz;
    *grid = dim3((ny * nx + ADMM_THREADS - 1) / ADMM_THREADS, planes < ADMM_GRID_Y ? planes : ADMM_GRID_Y, 1);
    return true;
}

}  // namespace

extern "C" {

// One split update over nb contiguous float32 lanes, in place on z1, u1 (nb, 3, nz,
// ny, nx) and z2, u2 (nb, nz, ny, nx); x is (nb, nz, ny, nx), lam nb floats on the
// device. eps2 is eps^2 and one_minus_alpha is 1 - alpha, both rounded from double
// by the caller as PyTorch rounds its scalars. relax = 0 requires alpha == 1 and
// skips the reads of z1 and z2. Sizes that do not fit the grid are refused with
// cudaErrorInvalidConfiguration before launching.
int admm_split_update_f32(const void* x, void* z1, void* u1, void* z2, void* u2, const void* lam, int nb,
                          int nz, int ny, int nx, float eps, float eps2, float alpha, float one_minus_alpha,
                          int relax, int positivity, float sz, float sy, float sx, void* stream) {
    dim3 grid;
    if (!plane_grid(nb, nz, ny, nx, &grid)) return (int)cudaErrorInvalidConfiguration;
    if (!relax && alpha != 1.0f) return (int)cudaErrorInvalidValue;
#define ADMM_LAUNCH(R, P)                                                                                   \
    admm_split_update_kernel<R, P><<<grid, ADMM_THREADS, 0, (cudaStream_t)stream>>>(                        \
        (const float*)x, (float*)z1, (float*)u1, (float*)z2, (float*)u2, (const float*)lam, nb, nz, ny, nx, \
        eps, eps2, alpha, one_minus_alpha, sz, sy, sx)
    if (relax) {
        if (positivity) ADMM_LAUNCH(true, true); else ADMM_LAUNCH(true, false);
    } else {
        if (positivity) ADMM_LAUNCH(false, true); else ADMM_LAUNCH(false, false);
    }
#undef ADMM_LAUNCH
    return (int)cudaGetLastError();
}

// out (nb, nz, ny, nx) = rho1 * D^T(z1 - u1) + rho2 * (z2 - u2) with the circular
// adjoint; rho1 and rho2 are nb floats on the device. out must not alias an input.
int admm_rhs_f32(const void* z1, const void* u1, const void* z2, const void* u2, const void* rho1,
                 const void* rho2, void* out, int nb, int nz, int ny, int nx, float sz, float sy, float sx,
                 void* stream) {
    dim3 grid;
    if (!plane_grid(nb, nz, ny, nx, &grid)) return (int)cudaErrorInvalidConfiguration;
    admm_rhs_kernel<<<grid, ADMM_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)z1, (const float*)u1, (const float*)z2, (const float*)u2, (const float*)rho1,
        (const float*)rho2, (float*)out, nb, nz, ny, nx, sz, sy, sx);
    return (int)cudaGetLastError();
}

}  // extern "C"
