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
// rho1 and rho2, read from device arrays of B floats. Each scale s_a arrives as its
// reciprocal r_a = (float)(1.0 / s_a), rounded on the host: PyTorch's CUDA division
// of a float32 tensor by a Python scalar is a multiplication by that number.
//
// Math of admm_split_update per voxel p of lane b, per axis a (e_a wraps around the
// volume: the splitting is circular so that D^T D stays circulant):
//   d_a   = (x(p + e_a) - x(p)) * r_a
//   dr_a  = alpha d_a + (1 - alpha) z1_a            (alpha != 1 only, else d_a)
//   v_a   = dr_a + u1_a
//   vmag  = sqrt(sum_a m_a v_a^2 + tiny),  m_a = 0 on axis a's trailing face, else 1
//   s     = 8 Newton steps s <- max(s - g/g', 0) from max(vmag - lam, 0), with
//           r = sqrt(s^2 + eps^2), q = 1/r, g = s + lam s q - vmag, g' = 1 + lam eps^2 q^3
//   z1_a  = (s / vmag) v_a where m_a = 1, v_a on the trailing face (unpenalized there:
//           the penalty is the replicate-boundary TV)
//   xr    = alpha x + (1 - alpha) z2                (alpha != 1 only, else x)
//   z2    = max(xr + u2, 0)                         (or xr + u2 without positivity)
//   u1_a += dr_a - z1_a  (= v_a - z1_a),   u2 += xr - z2
// in place on z1, u1, z2, u2. Only x is read at neighbouring voxels, and x is not
// written, so the in-place update is safe. admm_rhs reads z1 - u1 at p - e_a and
// therefore runs as its own launch:
//   rhs = rho1 * sum_a ((z1_a - u1_a)(p - e_a) - (z1_a - u1_a)(p)) * r_a + rho2 (z2 - u2).
//
// What bounds them. By bytes, admm_split_update reads x, u1 x 3 and u2 and writes
// z1 x 3, u1 x 3, z2 and u2, 13 volumes (17 with alpha != 1, which also reads z1 x 3
// and z2): 0.26 / 0.34 ms at 256^3 and 3.35 TB/s. The first design (one thread a
// voxel, 8 fixed Newton steps of three correctly rounded divisions and a square root
// each, the scales divided) ran 0.61 / 0.63 ms at both byte counts: held by its
// instructions, not by memory. A correctly rounded division or square root is a
// MUFU approximation, a few FMAs, a range check (FCHK) and a call to a slow path
// for operands near the ends of the range. This design cuts the instructions:
//   - Newton stops when it has settled. The step is a fixed function of s for a
//     voxel, so once an iterate repeats the one before it (a fixed point) or the one
//     two before (an orbit of period 2, which a quarter of the voxels of a solve
//     end in, alternating at the last ulp), every later iterate is known: the 8th
//     is the current one if 8 - k is even after k steps, else the one before. So
//     the kernel stops there and returns the 8th step's value bit for bit (the
//     iterates are compared as bit patterns, so -0 and +0 stay apart). On the
//     256^3 solve's states every 128-voxel warp settles in 4 or 5 steps.
//   - A Newton step takes one reciprocal q = 1/r (__frcp_rn) and one division,
//     not three divisions; the scales are multiplications by their reciprocals.
//   - Four voxels a thread, their Newton chains interleaved step by step so that
//     four independent dependency chains hide each other's latency. Where nx % 4 == 0
//     and every base is 16-byte aligned (kVec), the four are consecutive along x and
//     every access of x, z1, u1, z2 and u2 is one 16-byte load or store (z1, u1, z2,
//     u2 with the streaming hint, so x's neighbouring planes stay in L2); the x
//     neighbour at +1 is the next voxel of the same float4, or one 4-byte load for
//     the fourth. Otherwise the four are 256 voxels apart (each access coalesced
//     across the warp) with 4-byte accesses.
// x's neighbours along y and z come from L1 / L2 (a block covers 1024 voxels of one
// (lane, z) plane and the blocks of plane z + 1 run alongside), so x is staged
// nowhere. Offsets inside a lane are 32-bit (a lane holds fewer than 2^31 voxels),
// the lane's base pointer 64-bit. admm_rhs keeps one thread a voxel: without
// divisions it runs at about 90% of its bound (0.18 ms at 256^3, 9 volumes).
//
// Slabs. On a volume sharded in z over devices (microtipi_tpu_torch/parallel) each
// z-slab takes the same kernels with its neighbours' planes: the split update reads
// x's next plane (the next slab's first plane; after the last slab, the first slab's
// first plane, around the ring), and its z trailing-face mask is the volume's last
// plane (the slab's global z offset and the global nz); the rhs reads z1_z - u1_z at
// the previous plane (the previous slab's last plane; before the first slab, the last
// slab's last plane). The rhs's whole-volume entry is the slab that is its own
// neighbour (pointers into its own tensors); the split update keeps its whole-volume
// code path as a separate instantiation (kSlab = false), since the slab mode's
// pointer select cost the over-relaxed instantiation time at 256^3. Either way the
// slabs' outputs put together are the whole volume's, bit for bit.
// GSPMD inserts these exchanges on a TPU mesh (microtipi_tpu/parallel/admm.py).
//
// Rounding: every operation is an explicit round-to-nearest intrinsic in the order
// of the plain PyTorch version (ops/kernels/admm_split.py), so nvcc contracts no
// multiply-add, flushes nothing to zero, and the two agree bit for bit on the card
// at every scale.
//
// A plain C interface, loaded with ctypes. Each launch goes on the caller's stream
// and the function returns cudaGetLastError().

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#define ADMM_THREADS 256
#define ADMM_VOXELS 4  // voxels a thread of admm_split_update
#define ADMM_NEWTON 8
#define ADMM_GRID_Y 65535

namespace {

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ bool same(float a, float b) { return __float_as_uint(a) == __float_as_uint(b); }

// One Newton step for the root of g(s) = s + lam s / sqrt(s^2 + eps^2) - v
// (le2 = lam eps^2, eps2 = eps^2).
__device__ __forceinline__ float newton_step(float s, float v, float lam, float le2, float eps2) {
    const float r = __fsqrt_rn(add(mul(s, s), eps2));
    const float q = __frcp_rn(r);
    const float g = sub(add(s, mul(mul(lam, s), q)), v);
    const float gp = add(1.0f, mul(mul(mul(le2, q), q), q));
    return fmaxf(sub(s, dvd(g, gp)), 0.0f);
}

// The prox of lam * (sqrt(t^2 + eps^2) - eps) on the magnitudes v[i] >= 0, for
// ADMM_VOXELS voxels side by side: what ADMM_NEWTON Newton steps from
// max(v - lam, 0) leave, bit for bit, stopping once every voxel has settled.
__device__ __forceinline__ void hyperbolic_prox(float (&s)[ADMM_VOXELS], const float (&v)[ADMM_VOXELS], float lam,
                                                float eps, float eps2) {
    const float le2 = mul(mul(lam, eps), eps);
    float last[ADMM_VOXELS];  // the iterate before s; at the start s itself
#pragma unroll
    for (int i = 0; i < ADMM_VOXELS; ++i) last[i] = s[i] = fmaxf(sub(v[i], lam), 0.0f);
    int k = 0;
    bool settled = false;
    while (!settled && k < ADMM_NEWTON) {
        ++k;
        settled = true;
#pragma unroll
        for (int i = 0; i < ADMM_VOXELS; ++i) {
            const float t = newton_step(s[i], v[i], lam, le2, eps2);
            settled &= same(t, s[i]) | same(t, last[i]);
            last[i] = s[i];
            s[i] = t;
        }
    }
    // s is step k, last step k - 1; from here on they alternate (or are equal).
    if ((ADMM_NEWTON - k) & 1) {
#pragma unroll
        for (int i = 0; i < ADMM_VOXELS; ++i) s[i] = last[i];
    }
}

// The four voxels' values at offset `at` (+ each voxel's own offset) of a lane.
template <bool kVec, bool kStream>
__device__ __forceinline__ void load4(const float* p, int at, const int (&off)[ADMM_VOXELS],
                                      float (&out)[ADMM_VOXELS]) {
    if (kVec) {
        const float4* src = reinterpret_cast<const float4*>(p + at + off[0]);
        const float4 t = kStream ? __ldcs(src) : *src;
        out[0] = t.x, out[1] = t.y, out[2] = t.z, out[3] = t.w;
    } else {
#pragma unroll
        for (int i = 0; i < ADMM_VOXELS; ++i) out[i] = kStream ? __ldcs(p + at + off[i]) : p[at + off[i]];
    }
}

template <bool kVec>
__device__ __forceinline__ void store4(float* p, int at, const int (&off)[ADMM_VOXELS], const float (&v)[ADMM_VOXELS],
                                       const bool (&valid)[ADMM_VOXELS]) {
    if (kVec) {
        __stcs(reinterpret_cast<float4*>(p + at + off[0]), make_float4(v[0], v[1], v[2], v[3]));
    } else {
#pragma unroll
        for (int i = 0; i < ADMM_VOXELS; ++i)
            if (valid[i]) __stcs(p + at + off[i], v[i]);
    }
}

// kSlab: x's next plane past the slab's last comes from xnext, and the z face
// is the volume's (z_off, nz_glob); otherwise the lane wraps around itself,
// the whole-volume code path of the kernel before slabs existed.
template <bool kVec, bool kRelax, bool kPositivity, bool kSlab>
__global__ void __launch_bounds__(ADMM_THREADS)
admm_split_update_kernel(const float* __restrict__ x, const float* __restrict__ xnext, int64_t next_stride,
                         float* __restrict__ z1, float* __restrict__ u1, float* __restrict__ z2,
                         float* __restrict__ u2, const float* __restrict__ lam, int nb, int nz, int ny, int nx,
                         int z_off, int nz_glob, float eps, float eps2, float alpha, float one_minus_alpha, float rz,
                         float ry, float rx) {
    const int plane = ny * nx, n = nz * plane;
    // Voxel i of this thread within its (lane, z) plane: consecutive along x (kVec,
    // nx % 4 == 0) or ADMM_THREADS apart. A voxel past the plane's end computes on
    // voxel 0's data and stores nothing.
    const int q0 = kVec ? (blockIdx.x * ADMM_THREADS + threadIdx.x) * ADMM_VOXELS
                        : blockIdx.x * ADMM_THREADS * ADMM_VOXELS + threadIdx.x;
    if (q0 >= plane) return;
    int off[ADMM_VOXELS], step_y[ADMM_VOXELS], step_x[ADMM_VOXELS];
    bool valid[ADMM_VOXELS], face_y[ADMM_VOXELS], face_x[ADMM_VOXELS];
#pragma unroll
    for (int i = 0; i < ADMM_VOXELS; ++i) {
        const int q = kVec ? q0 + i : q0 + i * ADMM_THREADS;
        valid[i] = q < plane;
        off[i] = valid[i] ? q : q0;
        const int iy = off[i] / nx, ix = off[i] - iy * nx;
        face_y[i] = iy == ny - 1;
        face_x[i] = ix == nx - 1;
        step_y[i] = face_y[i] ? -(ny - 1) * nx : nx;
        step_x[i] = face_x[i] ? -(nx - 1) : 1;
    }
    const float rs[3] = {rz, ry, rx};

    for (int p = blockIdx.y; p < nb * nz; p += gridDim.y) {
        const int lane = p / nz, iz = p - lane * nz;
        const int at = iz * plane;  // the plane's offset in its lane
        const bool face_z = kSlab ? z_off + iz == nz_glob - 1 : iz == nz - 1;
        const int64_t base = (int64_t)lane * n;
        const float* xl = x + base;

        float xc[ADMM_VOXELS], xn[3][ADMM_VOXELS];
        load4<kVec, false>(xl, at, off, xc);
        if (kSlab) {  // x's next plane: the slab's own, or past its last plane the next slab's first
            load4<kVec, false>(iz == nz - 1 ? xnext + lane * next_stride : xl + at + plane, 0, off, xn[0]);
        } else {
            load4<kVec, false>(xl, at + (face_z ? -(nz - 1) * plane : plane), off, xn[0]);
        }
        if (kVec) {
            load4<true, false>(xl, at + step_y[0], off, xn[1]);
#pragma unroll
            for (int i = 0; i < ADMM_VOXELS - 1; ++i) xn[2][i] = xc[i + 1];
            xn[2][ADMM_VOXELS - 1] = xl[at + off[ADMM_VOXELS - 1] + step_x[ADMM_VOXELS - 1]];
        } else {
#pragma unroll
            for (int i = 0; i < ADMM_VOXELS; ++i) {
                xn[1][i] = xl[at + off[i] + step_y[i]];
                xn[2][i] = xl[at + off[i] + step_x[i]];
            }
        }

        // z2 and u2 first: they need nothing else.
        {
            float zo[ADMM_VOXELS], uo[ADMM_VOXELS], z[ADMM_VOXELS], u[ADMM_VOXELS];
            if (kRelax) load4<kVec, true>(z2 + base, at, off, zo);
            load4<kVec, true>(u2 + base, at, off, uo);
#pragma unroll
            for (int i = 0; i < ADMM_VOXELS; ++i) {
                const float xr = kRelax ? add(mul(alpha, xc[i]), mul(one_minus_alpha, zo[i])) : xc[i];
                z[i] = add(xr, uo[i]);
                if (kPositivity) z[i] = fmaxf(z[i], 0.0f);
                u[i] = sub(add(uo[i], xr), z[i]);
            }
            store4<kVec>(z2 + base, at, off, z, valid);
            store4<kVec>(u2 + base, at, off, u, valid);
        }

        float v[3][ADMM_VOXELS], vmag[ADMM_VOXELS];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            const int64_t comp = base * 3 + (int64_t)a * n;
            float zo[ADMM_VOXELS], uo[ADMM_VOXELS];
            if (kRelax) load4<kVec, true>(z1 + comp, at, off, zo);
            load4<kVec, true>(u1 + comp, at, off, uo);
#pragma unroll
            for (int i = 0; i < ADMM_VOXELS; ++i) {
                float d = mul(sub(xn[a][i], xc[i]), rs[a]);
                if (kRelax) d = add(mul(alpha, d), mul(one_minus_alpha, zo[i]));
                v[a][i] = add(d, uo[i]);
                const bool face = a == 0 ? face_z : a == 1 ? face_y[i] : face_x[i];
                const float sq = face ? 0.0f : mul(v[a][i], v[a][i]);
                vmag[i] = a == 0 ? sq : add(vmag[i], sq);
            }
        }
#pragma unroll
        for (int i = 0; i < ADMM_VOXELS; ++i) vmag[i] = __fsqrt_rn(add(vmag[i], FLT_MIN));

        float scale[ADMM_VOXELS];
        hyperbolic_prox(scale, vmag, lam[lane], eps, eps2);
#pragma unroll
        for (int i = 0; i < ADMM_VOXELS; ++i) scale[i] = dvd(scale[i], vmag[i]);
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            const int64_t comp = base * 3 + (int64_t)a * n;
            float z[ADMM_VOXELS], u[ADMM_VOXELS];
#pragma unroll
            for (int i = 0; i < ADMM_VOXELS; ++i) {
                const bool face = a == 0 ? face_z : a == 1 ? face_y[i] : face_x[i];
                z[i] = face ? v[a][i] : mul(scale[i], v[a][i]);
                u[i] = sub(v[a][i], z[i]);  // (u1 + dr) - z1, as u1 + dr is v bit for bit
            }
            store4<kVec>(z1 + comp, at, off, z, valid);
            store4<kVec>(u1 + comp, at, off, u, valid);
        }
    }
}

__global__ void __launch_bounds__(ADMM_THREADS)
admm_rhs_kernel(const float* __restrict__ z1, const float* __restrict__ u1, const float* __restrict__ z2,
                const float* __restrict__ u2, const float* __restrict__ z1p, const float* __restrict__ u1p,
                int64_t prev_stride, const float* __restrict__ rho1, const float* __restrict__ rho2,
                float* __restrict__ out, int nb, int nz, int ny, int nx, float rz, float ry, float rx) {
    const int plane = ny * nx;
    const int q = blockIdx.x * ADMM_THREADS + threadIdx.x;
    if (q >= plane) return;
    const int iy = q / nx, ix = q - iy * nx;
    const int64_t n = (int64_t)nz * plane;
    const float rs[3] = {rz, ry, rx};

    for (int p = blockIdx.y; p < nb * nz; p += gridDim.y) {
        const int lane = p / nz, iz = p - lane * nz;
        const int64_t i = (int64_t)p * plane + q;
        const int64_t j = i + 2 * lane * n;
        // The voxel before this one along each axis, around the volume; before
        // the slab's first plane, the previous slab's last (z1p, u1p).
        const int64_t back[3] = {
            -(int64_t)plane,
            iy == 0 ? (int64_t)(ny - 1) * nx : -(int64_t)nx,
            ix == 0 ? (int64_t)(nx - 1) : -1,
        };
        float adj = 0.0f;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            const int64_t c = j + a * n;
            const float g = sub(z1[c], u1[c]);
            const int64_t h = lane * prev_stride + q;
            const float gb = a == 0 && iz == 0 ? sub(z1p[h], u1p[h]) : sub(z1[c + back[a]], u1[c + back[a]]);
            const float t = mul(sub(gb, g), rs[a]);
            adj = a == 0 ? t : add(adj, t);
        }
        out[i] = add(mul(rho1[lane], adj), mul(rho2[lane], sub(z2[i], u2[i])));
    }
}

// The grid: x over a plane's voxels, `per_thread` a thread, y over the B * nz
// planes (strided above CUDA's limit on grid y). A lane must hold fewer than 2^31
// voxels (admm_split_update's offsets inside a lane are 32-bit).
bool plane_grid(int nb, int nz, int ny, int nx, int per_thread, dim3* grid) {
    if (nb < 1 || nz < 1 || ny < 1 || nx < 1) return false;
    const int64_t plane = (int64_t)ny * nx;
    if (plane * nz > INT32_MAX - (int64_t)ADMM_THREADS * per_thread || (int64_t)nb * nz > INT32_MAX) return false;
    const int planes = nb * nz, tile = ADMM_THREADS * per_thread;
    *grid = dim3((unsigned)((plane + tile - 1) / tile), planes < ADMM_GRID_Y ? planes : ADMM_GRID_Y, 1);
    return true;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

int split_update(const void* x, const void* xnext, int64_t next_stride, void* z1, void* u1, void* z2, void* u2,
                 const void* lam, int nb, int nz, int ny, int nx, int z_off, int nz_glob, float eps, float eps2,
                 float alpha, float one_minus_alpha, int relax, int positivity, int vec, float rz, float ry, float rx,
                 bool slab, void* stream) {
    dim3 grid;
    if (!plane_grid(nb, nz, ny, nx, ADMM_VOXELS, &grid) || z_off < 0 || z_off + nz > nz_glob)
        return (int)cudaErrorInvalidConfiguration;
    if (!relax && alpha != 1.0f) return (int)cudaErrorInvalidValue;
    if (vec && (nx % 4 != 0 || !aligned16(x) || !aligned16(xnext) || !aligned16(z1) || !aligned16(u1) ||
                !aligned16(z2) || !aligned16(u2)))
        return (int)cudaErrorMisalignedAddress;
#define ADMM_LAUNCH(V, R, P, S)                                                                                  \
    admm_split_update_kernel<V, R, P, S><<<grid, ADMM_THREADS, 0, (cudaStream_t)stream>>>(                       \
        (const float*)x, (const float*)xnext, next_stride, (float*)z1, (float*)u1, (float*)z2, (float*)u2,       \
        (const float*)lam, nb, nz, ny, nx, z_off, nz_glob, eps, eps2, alpha, one_minus_alpha, rz, ry, rx)
#define ADMM_LAUNCH_SLAB(V, R, P) \
    if (slab) ADMM_LAUNCH(V, R, P, true); else ADMM_LAUNCH(V, R, P, false)
#define ADMM_LAUNCH_VEC(R, P) \
    if (vec) { ADMM_LAUNCH_SLAB(true, R, P); } else { ADMM_LAUNCH_SLAB(false, R, P); }
    if (relax) {
        if (positivity) { ADMM_LAUNCH_VEC(true, true); } else { ADMM_LAUNCH_VEC(true, false); }
    } else {
        if (positivity) { ADMM_LAUNCH_VEC(false, true); } else { ADMM_LAUNCH_VEC(false, false); }
    }
#undef ADMM_LAUNCH_VEC
#undef ADMM_LAUNCH_SLAB
#undef ADMM_LAUNCH
    return (int)cudaGetLastError();
}

int rhs(const void* z1, const void* u1, const void* z2, const void* u2, const void* z1p, const void* u1p,
        int64_t prev_stride, const void* rho1, const void* rho2, void* out, int nb, int nz, int ny, int nx, float rz,
        float ry, float rx, void* stream) {
    dim3 grid;
    if (!plane_grid(nb, nz, ny, nx, 1, &grid)) return (int)cudaErrorInvalidConfiguration;
    admm_rhs_kernel<<<grid, ADMM_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)z1, (const float*)u1, (const float*)z2, (const float*)u2, (const float*)z1p,
        (const float*)u1p, prev_stride, (const float*)rho1, (const float*)rho2, (float*)out, nb, nz, ny, nx, rz, ry,
        rx);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One split update over nb contiguous float32 lanes, in place on z1, u1 (nb, 3, nz,
// ny, nx) and z2, u2 (nb, nz, ny, nx); x is (nb, nz, ny, nx), lam nb floats on the
// device. eps2 is eps^2 and one_minus_alpha is 1 - alpha, both rounded from double
// by the caller as PyTorch rounds its scalars; rz, ry, rx are the scales'
// reciprocals. relax = 0 requires alpha == 1 and skips the reads of z1 and z2.
// vec = 1 takes the 16-byte instantiation and requires nx % 4 == 0 and every base
// 16-byte aligned (else cudaErrorMisalignedAddress); vec = 0 the 4-byte one. Sizes
// that do not fit the grid are refused with cudaErrorInvalidConfiguration before
// launching.
int admm_split_update_f32(const void* x, void* z1, void* u1, void* z2, void* u2, const void* lam, int nb,
                          int nz, int ny, int nx, float eps, float eps2, float alpha, float one_minus_alpha,
                          int relax, int positivity, int vec, float rz, float ry, float rx, void* stream) {
    return split_update(x, x, (int64_t)nz * ny * nx, z1, u1, z2, u2, lam, nb, nz, ny, nx, 0, nz, eps, eps2, alpha,
                        one_minus_alpha, relax, positivity, vec, rz, ry, rx, false, stream);
}

// The split update of z-slabs (nb, nz, ny, nx) of a volume of nz_glob planes, the
// slab's first plane at z_off: xnext is x's plane after each slab's last (nb
// contiguous (ny, nx) planes; around the ring after the volume's last plane), the
// other arguments those of admm_split_update_f32.
int admm_split_update_slab_f32(const void* x, const void* xnext, void* z1, void* u1, void* z2, void* u2,
                               const void* lam, int nb, int nz, int ny, int nx, int z_off, int nz_glob, float eps,
                               float eps2, float alpha, float one_minus_alpha, int relax, int positivity, int vec,
                               float rz, float ry, float rx, void* stream) {
    return split_update(x, xnext, (int64_t)ny * nx, z1, u1, z2, u2, lam, nb, nz, ny, nx, z_off, nz_glob, eps, eps2,
                        alpha, one_minus_alpha, relax, positivity, vec, rz, ry, rx, true, stream);
}

// out (nb, nz, ny, nx) = rho1 * D^T(z1 - u1) + rho2 * (z2 - u2) with the circular
// adjoint; rho1 and rho2 are nb floats on the device, rz, ry, rx the scales'
// reciprocals. out must not alias an input.
int admm_rhs_f32(const void* z1, const void* u1, const void* z2, const void* u2, const void* rho1,
                 const void* rho2, void* out, int nb, int nz, int ny, int nx, float rz, float ry, float rx,
                 void* stream) {
    // The whole volume is its own previous slab: before plane 0, the lane's last plane of z1_z, u1_z.
    const int64_t plane = (int64_t)ny * nx, last = (int64_t)(nz - 1) * plane;
    return rhs(z1, u1, z2, u2, (const float*)z1 + last, (const float*)u1 + last, 3 * nz * plane, rho1, rho2, out,
               nb, nz, ny, nx, rz, ry, rx, stream);
}

// The rhs of z-slabs (nb, nz, ny, nx): z1p and u1p are the z components (a = 0) of z1
// and u1 at the plane before each slab's first (nb contiguous (ny, nx) planes each;
// around the ring before the volume's first plane), the other arguments those of
// admm_rhs_f32.
int admm_rhs_slab_f32(const void* z1, const void* u1, const void* z2, const void* u2, const void* z1p,
                      const void* u1p, const void* rho1, const void* rho2, void* out, int nb, int nz, int ny, int nx,
                      float rz, float ry, float rx, void* stream) {
    return rhs(z1, u1, z2, u2, z1p, u1p, (int64_t)ny * nx, rho1, rho2, out, nb, nz, ny, nx, rz, ry, rx, stream);
}

}  // extern "C"
