// The ADMM object engine's data split (weighted Gaussian or Poisson data term), float32, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: in microtipi_tpu/jobs/admm.py the iteration is one lax.scan
// under jit, and XLA fuses these lines of `step_core` on the TPU. PyTorch runs eagerly,
// where the same lines are about fifteen elementwise launches and some 42 volume passes an
// iteration, so each of the split's two pointwise halves is one kernel here:
//   data_split_spectrum  the x-update's spectrum on the data-split path, per frequency of
//                        lane b (h shared by the lanes or one a lane), in place:
//                          p      = conj(h) X r0_b          X = rfftn(t), t = z0 - u0
//                          x_hat  = (x_hat + p) inv_den_b   x_hat holds rfftn(rhs) on entry
//                          X      = h x_hat                 the spectrum of H x
//   data_split_prox      everything after hx = irfftn(h x_hat), per voxel of lane b, in
//                        place on z0 and u0, writing t:
//                          hxr = alpha hx + (1 - alpha) z0  (alpha != 1 only, else hx)
//                          v   = hxr + u0
//                          z0' = (wd + r0 v) / (w + r0)     weighted Gaussian, or for Poisson
//                                the positive root of r0 z^2 + z (1 + r0 (bg - v)) + (bg - d -
//                                r0 v bg) = 0: (-b + sqrt(max(b^2 - 4 r0 c, 0))) / (2 r0)
//                          u0' = (u0 + hxr) - z0'
//                          t   = z0' - u0'                  the next iteration's rfftn input
//
// Layout: the spectra (x_hat, X, h) are complex64, (B, nz, ny, nx/2 + 1) interleaved; h has a
// lane stride of 0 when one PSF serves every lane. inv_den is float32 of the spectra's shape, a
// lane each; r0 is B floats on the device. The volumes (hx, z0, u0, t, wd, w or d) are float32
// (B, nz, ny, nx). Lanes are contiguous, one after another.
//
// What bounds them: bytes, a handful of operations an element. The spectrum step reads three
// spectra and inv_den and writes two spectra: 11 floats a frequency, 5.5 volumes of complex
// spectrum (1.10 GB at 104x712x337, 0.328 ms at 3.35 TB/s). The over-relaxed weighted prox
// reads hx, z0, u0, wd, w and writes z0, u0, t: 8 volumes (1.59 GB at 104x712x672, 0.475 ms);
// at alpha 1 it does not read z0 (7); Poisson reads d in place of wd and w (7, or 6 at alpha 1).
// The PyTorch lines they replace moved some 8.4 GB an iteration at that grid.
//
// Design: one block of 256 threads covers 1024 elements of one lane (blockIdx.y walks the
// lanes), four a thread. Where a lane's element count is a multiple of 4 and every base is
// 16-byte aligned (kVec), a thread's four are consecutive and every access is one 16-byte load
// or store (a complex array two), with the streaming hints, as nothing is read twice;
// otherwise the four are 256 apart (each access coalesced across the warp) with 4- or 8-byte
// accesses. No shared memory and no synchronisation: each element is independent. Offsets
// inside a lane are 32-bit (a lane holds fewer than 2^31 elements), the lane's base 64-bit.
//
// Rounding: every operation is an explicit round-to-nearest intrinsic in the order of the
// plain PyTorch version (ops/kernels/data_split.py), so nvcc contracts no multiply-add and the
// two agree bit for bit on the card. The prox keeps the order of the PyTorch expressions it
// replaces (jobs/admm.py before these kernels), max(., 0) lets a NaN through as
// torch.clamp_min does, and alpha and 1 - alpha arrive as the caller's doubles rounded to
// float, as PyTorch rounds a Python scalar. The spectrum step's plain version is real
// arithmetic on view_as_real: conj(h) X = (hr Xr + hi Xi) + i (hr Xi - hi Xr), each product
// and sum rounded, where PyTorch's complex multiplication may fuse a multiply-add.
//
// A plain C interface, loaded with ctypes. Each launch goes on the caller's stream and the
// function returns cudaGetLastError(). The kernels' names avoid the substrings by which
// benchmark/trace.py classifies device time.

#include <cuda_runtime.h>
#include <stdint.h>

#define SPLIT_THREADS 256
#define SPLIT_ITEMS 4  // elements a thread
#define SPLIT_GRID_Y 65535

namespace {

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// The element index of item k of this thread within its lane: consecutive (kVec) or
// SPLIT_THREADS apart.
template <bool kVec>
__device__ __forceinline__ int item(int k) {
    return kVec ? (blockIdx.x * SPLIT_THREADS + threadIdx.x) * SPLIT_ITEMS + k
                : blockIdx.x * SPLIT_THREADS * SPLIT_ITEMS + k * SPLIT_THREADS + threadIdx.x;
}

// Four floats at element i0 (kVec: one 16-byte load of i0..i0+3) or at each item's index.
template <bool kVec>
__device__ __forceinline__ void load_f(const float* p, const int (&i)[SPLIT_ITEMS], const bool (&ok)[SPLIT_ITEMS],
                                       float (&out)[SPLIT_ITEMS]) {
    if (kVec) {
        const float4 v = __ldcs(reinterpret_cast<const float4*>(p + i[0]));
        out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
    } else {
#pragma unroll
        for (int k = 0; k < SPLIT_ITEMS; ++k) out[k] = ok[k] ? __ldcs(p + i[k]) : 0.0f;
    }
}

template <bool kVec>
__device__ __forceinline__ void store_f(float* p, const int (&i)[SPLIT_ITEMS], const bool (&ok)[SPLIT_ITEMS],
                                        const float (&v)[SPLIT_ITEMS]) {
    if (kVec) {
        __stcs(reinterpret_cast<float4*>(p + i[0]), make_float4(v[0], v[1], v[2], v[3]));
    } else {
#pragma unroll
        for (int k = 0; k < SPLIT_ITEMS; ++k)
            if (ok[k]) __stcs(p + i[k], v[k]);
    }
}

// Four complex values (re, im) as interleaved floats: kVec two 16-byte loads.
template <bool kVec>
__device__ __forceinline__ void load_c(const float* p, const int (&i)[SPLIT_ITEMS], const bool (&ok)[SPLIT_ITEMS],
                                       float (&re)[SPLIT_ITEMS], float (&im)[SPLIT_ITEMS]) {
    if (kVec) {
        const float4* src = reinterpret_cast<const float4*>(p + 2 * (int64_t)i[0]);
        const float4 a = __ldcs(src), b = __ldcs(src + 1);
        re[0] = a.x, im[0] = a.y, re[1] = a.z, im[1] = a.w, re[2] = b.x, im[2] = b.y, re[3] = b.z, im[3] = b.w;
    } else {
#pragma unroll
        for (int k = 0; k < SPLIT_ITEMS; ++k) {
            const float2 v = ok[k] ? __ldcs(reinterpret_cast<const float2*>(p) + i[k]) : make_float2(0.0f, 0.0f);
            re[k] = v.x, im[k] = v.y;
        }
    }
}

template <bool kVec>
__device__ __forceinline__ void store_c(float* p, const int (&i)[SPLIT_ITEMS], const bool (&ok)[SPLIT_ITEMS],
                                        const float (&re)[SPLIT_ITEMS], const float (&im)[SPLIT_ITEMS]) {
    if (kVec) {
        float4* dst = reinterpret_cast<float4*>(p + 2 * (int64_t)i[0]);
        __stcs(dst, make_float4(re[0], im[0], re[1], im[1]));
        __stcs(dst + 1, make_float4(re[2], im[2], re[3], im[3]));
    } else {
#pragma unroll
        for (int k = 0; k < SPLIT_ITEMS; ++k)
            if (ok[k]) __stcs(reinterpret_cast<float2*>(p) + i[k], make_float2(re[k], im[k]));
    }
}

template <bool kVec>
__global__ void __launch_bounds__(SPLIT_THREADS)
data_split_spectrum_kernel(float* __restrict__ xh, float* __restrict__ sx, const float* __restrict__ h,
                           int64_t h_lane, const float* __restrict__ inv_den, const float* __restrict__ r0, int nb,
                           int n) {
    int i[SPLIT_ITEMS];
    bool ok[SPLIT_ITEMS];
#pragma unroll
    for (int k = 0; k < SPLIT_ITEMS; ++k) {
        i[k] = item<kVec>(k);
        ok[k] = i[k] < n;
    }
    if (!ok[0]) return;
    for (int b = blockIdx.y; b < nb; b += gridDim.y) {
        const int64_t lane = (int64_t)b * n;
        const float r = r0[b];
        float hr[SPLIT_ITEMS], hi[SPLIT_ITEMS], xr[SPLIT_ITEMS], xi[SPLIT_ITEMS], rr[SPLIT_ITEMS], ri[SPLIT_ITEMS],
            den[SPLIT_ITEMS];
        load_c<kVec>(h + 2 * (int64_t)b * h_lane, i, ok, hr, hi);
        load_c<kVec>(sx + 2 * lane, i, ok, xr, xi);
        load_c<kVec>(xh + 2 * lane, i, ok, rr, ri);
        load_f<kVec>(inv_den + lane, i, ok, den);
#pragma unroll
        for (int k = 0; k < SPLIT_ITEMS; ++k) {
            const float pre = mul(add(mul(hr[k], xr[k]), mul(hi[k], xi[k])), r);
            const float pim = mul(sub(mul(hr[k], xi[k]), mul(hi[k], xr[k])), r);
            rr[k] = mul(add(rr[k], pre), den[k]);
            ri[k] = mul(add(ri[k], pim), den[k]);
            xr[k] = sub(mul(hr[k], rr[k]), mul(hi[k], ri[k]));
            xi[k] = add(mul(hr[k], ri[k]), mul(hi[k], rr[k]));
        }
        store_c<kVec>(xh + 2 * lane, i, ok, rr, ri);
        store_c<kVec>(sx + 2 * lane, i, ok, xr, xi);
    }
}

// kPoisson: `a` is the data d and `w` unused; else `a` is w d and `w` the weights.
template <bool kVec, bool kRelax, bool kPoisson>
__global__ void __launch_bounds__(SPLIT_THREADS)
data_split_prox_kernel(const float* __restrict__ hx, float* __restrict__ z0, float* __restrict__ u0,
                       float* __restrict__ t, const float* __restrict__ a, const float* __restrict__ w,
                       const float* __restrict__ r0, int nb, int n, float alpha, float one_minus_alpha, float bg) {
    int i[SPLIT_ITEMS];
    bool ok[SPLIT_ITEMS];
#pragma unroll
    for (int k = 0; k < SPLIT_ITEMS; ++k) {
        i[k] = item<kVec>(k);
        ok[k] = i[k] < n;
    }
    if (!ok[0]) return;
    for (int b = blockIdx.y; b < nb; b += gridDim.y) {
        const int64_t lane = (int64_t)b * n;
        const float r = r0[b];
        float hv[SPLIT_ITEMS], zo[SPLIT_ITEMS], uo[SPLIT_ITEMS], av[SPLIT_ITEMS], wv[SPLIT_ITEMS];
        load_f<kVec>(hx + lane, i, ok, hv);
        if (kRelax) load_f<kVec>(z0 + lane, i, ok, zo);
        load_f<kVec>(u0 + lane, i, ok, uo);
        load_f<kVec>(a + lane, i, ok, av);
        if (!kPoisson) load_f<kVec>(w + lane, i, ok, wv);
        float zn[SPLIT_ITEMS], un[SPLIT_ITEMS], tn[SPLIT_ITEMS];
#pragma unroll
        for (int k = 0; k < SPLIT_ITEMS; ++k) {
            const float hxr = kRelax ? add(mul(alpha, hv[k]), mul(one_minus_alpha, zo[k])) : hv[k];
            const float v = add(hxr, uo[k]);
            if (kPoisson) {
                const float bc = add(mul(r, sub(bg, v)), 1.0f);
                const float cc = sub(sub(bg, av[k]), mul(mul(r, v), bg));
                float disc = sub(mul(bc, bc), mul(mul(4.0f, r), cc));
                disc = disc != disc ? disc : fmaxf(disc, 0.0f);  // NaN passes, as torch.clamp_min
                zn[k] = dvd(add(-bc, __fsqrt_rn(disc)), mul(2.0f, r));
            } else {
                zn[k] = dvd(add(av[k], mul(r, v)), add(wv[k], r));
            }
            un[k] = sub(add(uo[k], hxr), zn[k]);
            tn[k] = sub(zn[k], un[k]);
        }
        store_f<kVec>(z0 + lane, i, ok, zn);
        store_f<kVec>(u0 + lane, i, ok, un);
        store_f<kVec>(t + lane, i, ok, tn);
    }
}

// The grid: x over a lane's elements, SPLIT_ITEMS a thread, y over the lanes (strided above
// CUDA's limit on grid y).
bool lane_grid(int nb, int n, dim3* grid) {
    if (nb < 1 || n < 1 || n > INT32_MAX - SPLIT_THREADS * SPLIT_ITEMS) return false;
    const int tile = SPLIT_THREADS * SPLIT_ITEMS;
    *grid = dim3((unsigned)((n + tile - 1) / tile), nb < SPLIT_GRID_Y ? nb : SPLIT_GRID_Y, 1);
    return true;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" {

// The spectrum step over nb lanes of n complex64 frequencies, in place on x_hat (in: the
// spectrum of the rhs; out: the x-update's spectrum) and sx (in: rfftn(z0 - u0); out: h x_hat).
// h is one spectrum a lane (h_shared = 0) or one for every lane (h_shared = 1); inv_den is nb x n
// floats and r0 nb floats, all on the device. vec = 1 takes the 16-byte instantiation and
// requires n % 4 == 0 and every base 16-byte aligned (else cudaErrorMisalignedAddress); vec = 0
// the 4-byte one. Sizes that do not fit the grid are refused with cudaErrorInvalidConfiguration.
int data_split_spectrum_f32(void* x_hat, void* sx, const void* h, int h_shared, const void* inv_den, const void* r0,
                            int nb, int n, int vec, void* stream) {
    dim3 grid;
    if (!lane_grid(nb, n, &grid)) return (int)cudaErrorInvalidConfiguration;
    if (vec && (n % 4 != 0 || !aligned16(x_hat) || !aligned16(sx) || !aligned16(h) || !aligned16(inv_den)))
        return (int)cudaErrorMisalignedAddress;
    const int64_t h_lane = h_shared ? 0 : n;
#define SPLIT_SPECTRUM(V)                                                                                         \
    data_split_spectrum_kernel<V><<<grid, SPLIT_THREADS, 0, (cudaStream_t)stream>>>(                              \
        (float*)x_hat, (float*)sx, (const float*)h, h_lane, (const float*)inv_den, (const float*)r0, nb, n)
    if (vec) SPLIT_SPECTRUM(true); else SPLIT_SPECTRUM(false);
#undef SPLIT_SPECTRUM
    return (int)cudaGetLastError();
}

// The prox and dual update over nb lanes of n float32 voxels, in place on z0 and u0, writing t;
// hx and `a` (w d, or the data d when poisson = 1) and w (the weights; unread when poisson = 1)
// are nb x n floats, r0 nb floats, all on the device. alpha and one_minus_alpha = 1 - alpha are
// rounded from double by the caller; relax = 0 requires alpha == 1 and skips the read of z0. bg
// is the Poisson background. vec as in data_split_spectrum_f32 (every volume's base aligned).
int data_split_prox_f32(const void* hx, void* z0, void* u0, void* t, const void* a, const void* w, const void* r0,
                        int nb, int n, float alpha, float one_minus_alpha, float bg, int relax, int poisson, int vec,
                        void* stream) {
    dim3 grid;
    if (!lane_grid(nb, n, &grid)) return (int)cudaErrorInvalidConfiguration;
    if (!relax && alpha != 1.0f) return (int)cudaErrorInvalidValue;
    if (vec && (n % 4 != 0 || !aligned16(hx) || !aligned16(z0) || !aligned16(u0) || !aligned16(t) || !aligned16(a) ||
                (!poisson && !aligned16(w))))
        return (int)cudaErrorMisalignedAddress;
#define SPLIT_PROX(V, R, P)                                                                                       \
    data_split_prox_kernel<V, R, P><<<grid, SPLIT_THREADS, 0, (cudaStream_t)stream>>>(                           \
        (const float*)hx, (float*)z0, (float*)u0, (float*)t, (const float*)a, (const float*)w, (const float*)r0,  \
        nb, n, alpha, one_minus_alpha, bg)
#define SPLIT_PROX_VEC(R, P) \
    if (vec) { SPLIT_PROX(true, R, P); } else { SPLIT_PROX(false, R, P); }
    if (relax) {
        if (poisson) { SPLIT_PROX_VEC(true, true); } else { SPLIT_PROX_VEC(true, false); }
    } else {
        if (poisson) { SPLIT_PROX_VEC(false, true); } else { SPLIT_PROX_VEC(false, false); }
    }
#undef SPLIT_PROX_VEC
#undef SPLIT_PROX
    return (int)cudaGetLastError();
}

}  // extern "C"
