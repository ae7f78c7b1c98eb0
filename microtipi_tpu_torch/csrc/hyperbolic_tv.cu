// Fused hyperbolic-TV cost and gradient in one sweep, float32, for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of microtipi_tpu/ops/pallas/hyperbolic_tv.py:
// `_tv_kernel` (:80) and `_tv_kernel_blocked` (:111), reached through
// `_tv_pallas_impl` by `hyperbolic_tv_value` / `hyperbolic_tv_fused`, and the
// batched `_tv_kernel_flat` (:203), reached through `_tv_pallas_batched`, the
// `custom_vmap` rule of the batched and tiled object steps. One kernel covers
// any nz and any batch (B, nz, ny, nx); a single volume is the B = 1 launch.
//
// Math per voxel u, per axis a in (z, y, x) with scale s_a:
//   d_a(u)  = (x(u + e_a) - x(u)) / s_a, 0 at the trailing face (replicate boundary)
//   D(u)    = sqrt(sum_a d_a(u)^2 + eps^2)
//   cost    = sum_u (D(u) - eps)
//   w_a(u)  = d_a(u) / (s_a D(u))
//   grad(u) = sum_a (w_a(u - e_a) - w_a(u)), incoming terms 0 at the leading faces
//
// What bounds it: bytes. Per voxel it needs 4 B read and 4 B written and about
// 30 flops, one sqrt and one divide, so at 256^3 an evaluation moves at least
// 64 MiB in and 64 MiB out of device memory (0.040 ms at 3.35 TB/s), far below
// the card's arithmetic rate. The design keeps the traffic at that floor and
// enough of it in flight:
//   - Tile. A block of 256 threads owns a TV_TY x TV_TX = 16 x 64 (y, x) tile
//     and walks a range of TV_ZR = 32 z planes in a loop, the TPU's
//     sequential z grid turned into a loop inside the block: long enough
//     that the two planes it re-reads (below) cost 6%, short enough that 256^3
//     still gives 512 blocks, all resident at once on 132 SMs. Each thread
//     owns 4 consecutive x of one row, so its shared loads and its gradient
//     stores are 16 bytes.
//   - Staging. Each x plane's footprint of the tile, rows y0-1 .. y0+TY and
//     columns x0-4 .. x0+TX+3 (18 x 72 floats, rows 16-byte aligned), goes
//     into a ring of TV_STAGES stages in shared memory. One thread keeps the
//     ring full with TMA (cp.async.bulk.tensor over a 3D map of
//     (B*nz, ny, nx), mbarrier completion), so up to TV_STAGES - 1 planes are
//     in flight while the block computes; out-of-range elements arrive as 0,
//     and the face masks below make their values irrelevant. Every x plane
//     is read from device memory once, plus two planes per z range: the one
//     before it, to rebuild the incoming w_z, and the one after it, for the
//     last plane's d_z.
//   - Compute. On each plane, D, w_z, w_y and w_x are computed once per point
//     of the tile and of its halo row (y0-1) and halo column (x0-1), from
//     shared memory only. The 80 halo points are spread over the 8 warps,
//     10 lanes each. w_z of the plane below stays in registers; w_y and the
//     left neighbour's w_x go through a double-buffered exchange in shared
//     memory, so one __syncthreads a plane orders both the exchange and the
//     ring's reuse.
//   - Cost. Each thread sums its D - eps in double, the block reduces in
//     double in a fixed order and writes one partial. The last block of each
//     volume (an atomic ticket after __threadfence) sums that volume's
//     partials in index order and writes its float32 cost, then resets the
//     ticket for the next launch on the stream. No result depends on which
//     block finishes last, so two launches give bitwise-equal outputs, a
//     lane of a batch gives the single-volume launch's cost and gradient bit
//     for bit, and 256 planes stay at float32 round-off of float64.
//   - Unaligned inputs. TMA needs a 16-byte-aligned base and row stride
//     (nx % 4 == 0). Otherwise (nx % 4 != 0, or a view such as x[b] of an
//     odd-shaped batch) the same kernel, instantiated with kTma = false,
//     stages the same footprint through 4-byte cp.async copies (zero-filled
//     outside the volume) that arrive on the same mbarriers, and stores the
//     gradient 4 bytes at a time.
//   - Slabs. A z-slab of a volume sharded over devices (microtipi_tpu_torch/parallel)
//     takes the same kernel with its neighbours' boundary planes: `prev`, the
//     plane before the slab, and `next`, the plane after it, each (B, ny, nx),
//     staged from two more tensor maps (or by the 4-byte copies) into the same
//     ring. A missing halo is the volume's face: no incoming w_z before the
//     first plane, d_z = 0 at the last. The slab's cost sums its own planes and
//     its gradient is written for them only, so the costs of the slabs add up
//     to the volume's and their gradients are the volume's gradient, bit for
//     bit (every per-voxel term comes from the same inputs in the same order).
//     A whole volume is the slab with no halos. This replaces the halo
//     exchanges that GSPMD inserts around the Pallas kernel on a TPU mesh.
// The per-voxel arithmetic keeps the operation order of the kernel's first
// version, so the gradient is the same bit for bit.
//
// A plain C interface, loaded with ctypes. The tensor map is encoded with
// cuTensorMapEncodeTiled, obtained through cudaGetDriverEntryPoint, so the
// library needs no -lcuda. The launch goes on the caller's stream and the
// function returns cudaGetLastError().

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define TV_TX 64
#define TV_TY 16
#define TV_VEC 4
#define TV_TPR (TV_TX / TV_VEC)        // threads per tile row: 16
#define TV_THREADS (TV_TPR * TV_TY)    // 256
#define TV_WARPS (TV_THREADS / 32)
#define TV_ZR 32                       // z planes a block walks
#define TV_STAGES 4                    // ring depth: 3 planes in flight
#define TV_SW (TV_TX + 2 * TV_VEC)     // staged columns x0-4 .. x0+TX+3: 72
#define TV_SH (TV_TY + 2)              // staged rows y0-1 .. y0+TY: 18
#define TV_STAGE_FLOATS (TV_SH * TV_SW)
#define TV_STAGE_BYTES (TV_STAGE_FLOATS * 4)
#define TV_STAGE_STRIDE ((TV_STAGE_BYTES + 127) / 128 * 32)  // floats; stages 128-byte aligned
#define TV_HALO (TV_TX + TV_TY)        // halo row + halo column points: 80
#define TV_HALO_LANES (TV_HALO / TV_WARPS)

static_assert(TV_HALO % TV_WARPS == 0, "halo points must spread evenly over the warps");
static_assert(TV_HALO_LANES <= 32, "one halo point per lane");
static_assert(TV_STAGES >= 2, "the ring holds a plane and the one above it");

// CUresult cuTensorMapEncodeTiled(...), the signature of <cudaTypedefs.h>'
// PFN_cuTensorMapEncodeTiled (v12000).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// Wait for the completion of the mbarrier's phase of the given parity. A
// phase that never completes (a lost arrival) traps after about 2^24 polls,
// so a fault shows as a launch error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    for (uint32_t tries = 0;; ++tries) {
        uint32_t done;
        asm volatile(
            "{\n\t.reg .pred P1;\n\t"
            "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n\t"
            "selp.u32 %0, 1, 0, P1;\n\t}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
        if (done) return;
        if (tries == (1u << 24)) __trap();
    }
}

// d_a, D and w_a of one voxel from its value and its three forward
// neighbours; hz / hy / hx say whether each neighbour is inside the volume.
// The operation order is that of the kernel's first version.
__device__ __forceinline__ void tv_point(float x0, float xz, float xy, float xx, bool hz, bool hy, bool hx,
                                         float inv_sz, float inv_sy, float inv_sx, float eps2, float& denom,
                                         float& wz, float& wy, float& wx) {
    const float dz = hz ? (xz - x0) * inv_sz : 0.0f;
    const float dy = hy ? (xy - x0) * inv_sy : 0.0f;
    const float dx = hx ? (xx - x0) * inv_sx : 0.0f;
    denom = sqrtf(dz * dz + dy * dy + dx * dx + eps2);
    const float inv_d = 1.0f / denom;
    wz = dz * inv_d * inv_sz;
    wy = dy * inv_d * inv_sy;
    wx = dx * inv_d * inv_sx;
}

// Fixed-order block sum in double: warp shuffles, then warp 0. Every thread
// gets the result.
__device__ __forceinline__ double block_sum(double v, double* s_red) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    __syncthreads();  // s_red may still be read from a previous call
    if (lane == 0) s_red[warp] = v;
    __syncthreads();
    double t = 0.0;
    if (warp == 0) {
        t = (lane < TV_WARPS) ? s_red[lane] : 0.0;
        for (int off = 16; off > 0; off >>= 1) t += __shfl_down_sync(0xffffffffu, t, off);
        if (lane == 0) s_red[TV_WARPS] = t;
    }
    __syncthreads();
    return s_red[TV_WARPS];
}

// Grid: (x tiles, y tiles, B * z ranges); blockIdx.z = volume * nranges + range.
template <bool kTma>
__global__ void __launch_bounds__(TV_THREADS)
hyperbolic_tv_kernel(const __grid_constant__ CUtensorMap tmap, const __grid_constant__ CUtensorMap tmap_prev,
                     const __grid_constant__ CUtensorMap tmap_next, const float* __restrict__ x,
                     const float* __restrict__ prev, const float* __restrict__ next,
                     float* __restrict__ grad, double* __restrict__ partials, float* __restrict__ costs,
                     unsigned int* __restrict__ tickets, int nz, int ny, int nx, int nranges, int has_prev,
                     int has_next, float eps, float inv_sz, float inv_sy, float inv_sx) {
    __shared__ __align__(128) float s_ring[TV_STAGES][TV_STAGE_STRIDE];
    __shared__ __align__(16) float s_wy[2][TV_TY + 1][TV_TX];  // w_y at rows y0-1 .. y0+TY-1
    __shared__ float s_wxl[2][TV_TY][TV_TPR + 1];  // [0]: w_x at x0-1; [c+1]: thread c's last w_x
    __shared__ __align__(8) uint64_t s_full[TV_STAGES];
    __shared__ double s_red[TV_WARPS + 1];
    __shared__ int s_last;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int r = tid / TV_TPR, c = tid - r * TV_TPR;  // tile row, 4-column group
    const int x0 = blockIdx.x * TV_TX, y0 = blockIdx.y * TV_TY;
    const int y = y0 + r, xs = x0 + TV_VEC * c;
    const int vol = blockIdx.z / nranges, range = blockIdx.z - vol * nranges;
    const int z0 = range * TV_ZR, z1 = min(z0 + TV_ZR, nz);
    // Planes staged: the one before the range (to rebuild its incoming w_z),
    // the range, and the one after it (for the last plane's d_z). Plane -1 is
    // the `prev` halo and plane nz the `next` one; [lo, hi) are those there are.
    const int lo = has_prev ? -1 : 0, hi = has_next ? nz + 1 : nz;
    const int pstart = max(z0 - 1, lo), pend = min(z1 + 1, hi);
    const float eps2 = eps * eps;
    const size_t plane = (size_t)ny * nx;
    const float* xv = x + (size_t)vol * nz * plane;
    float* gv = grad + (size_t)vol * nz * plane;

    if (tid == 0) {
        for (int s = 0; s < TV_STAGES; ++s)
            asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(&s_full[s])),
                         "r"(kTma ? 1 : TV_THREADS) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    // Stage plane p into its ring slot (called by thread 0 with TMA, by all
    // threads with cp.async).
    auto stage = [&](int p) {
        const int k = p - pstart;
        float* dst = s_ring[k % TV_STAGES];
        const uint32_t bar = smem_addr(&s_full[k % TV_STAGES]);
        if constexpr (kTma) {
            // A halo plane is plane `vol` of its own (B, ny, nx) map.
            const CUtensorMap* map = p < 0 ? &tmap_prev : p >= nz ? &tmap_next : &tmap;
            const int zc = p < 0 || p >= nz ? vol : vol * nz + p;
            asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
                         "r"(TV_STAGE_BYTES) : "memory");
            asm volatile(
                "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
                "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_addr(dst)),
                "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x0 - TV_VEC), "r"(y0 - 1),
                "r"(zc) : "memory");
        } else {
            const float* src_plane = p < 0     ? prev + (size_t)vol * plane
                                     : p >= nz ? next + (size_t)vol * plane
                                               : xv + (size_t)p * plane;
            for (int i = tid; i < TV_STAGE_FLOATS; i += TV_THREADS) {
                const int row = i / TV_SW, col = i - row * TV_SW;
                const int gy = y0 - 1 + row, gx = x0 - TV_VEC + col;
                const bool ok = gy >= 0 && gy < ny && gx >= 0 && gx < nx;
                const float* src = ok ? src_plane + (size_t)gy * nx + gx : xv;
                asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_addr(dst + i)),
                             "l"(src), "r"(ok ? 4 : 0) : "memory");
            }
            asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(bar) : "memory");
        }
    };
    auto wait = [&](int p) {
        const int k = p - pstart;
        mbar_wait(smem_addr(&s_full[k % TV_STAGES]), (uint32_t)((k / TV_STAGES) & 1));
    };

    if (!kTma || tid == 0)
        for (int p = pstart; p < min(pstart + TV_STAGES, pend); ++p) stage(p);

    // The halo point this lane computes, if any: h < TV_TX is the halo row
    // (y0-1, x0+h), else the halo column (y0+h-TV_TX, x0-1).
    const int h = warp * TV_HALO_LANES + lane;
    const bool has_halo = lane < TV_HALO_LANES;

    float wz_prev[TV_VEC] = {0.0f, 0.0f, 0.0f, 0.0f};
    double acc = 0.0;
    wait(pstart);
    for (int z = pstart; z < z1; ++z) {
        const int k = z - pstart, b = k & 1;
        const bool hz = z + 1 < hi;
        if (hz) wait(z + 1);
        const float* cur = s_ring[k % TV_STAGES];
        const float* nxt = hz ? s_ring[(k + 1) % TV_STAGES] : cur;

        // The thread's 4 points: stage row r+1, columns 4+4c .. 7+4c.
        const int o = (r + 1) * TV_SW + TV_VEC + TV_VEC * c;
        const float4 a = *reinterpret_cast<const float4*>(cur + o);
        const float4 an = *reinterpret_cast<const float4*>(nxt + o);
        const float4 ay = *reinterpret_cast<const float4*>(cur + o + TV_SW);
        const float ax = cur[o + TV_VEC];
        const float v0[4] = {a.x, a.y, a.z, a.w}, vz[4] = {an.x, an.y, an.z, an.w};
        const float vy[4] = {ay.x, ay.y, ay.z, ay.w}, vx[4] = {a.y, a.z, a.w, ax};
        const bool hy = y + 1 < ny;
        float den[TV_VEC], wz[TV_VEC], wy[TV_VEC], wx[TV_VEC];
#pragma unroll
        for (int j = 0; j < TV_VEC; ++j)
            tv_point(v0[j], vz[j], vy[j], vx[j], hz, hy, xs + j + 1 < nx, inv_sz, inv_sy, inv_sx, eps2, den[j],
                     wz[j], wy[j], wx[j]);
        *reinterpret_cast<float4*>(&s_wy[b][r + 1][TV_VEC * c]) = make_float4(wy[0], wy[1], wy[2], wy[3]);
        s_wxl[b][r][c + 1] = wx[TV_VEC - 1];
        if (has_halo) {
            float hd, hwz, hwy, hwx;
            if (h < TV_TX) {  // w_y at (y0-1, x0+h): stage row 0, column 4+h; 0 at the leading face
                const int q = TV_VEC + h;
                tv_point(cur[q], nxt[q], cur[q + TV_SW], cur[q + 1], hz, true, x0 + h + 1 < nx, inv_sz, inv_sy,
                         inv_sx, eps2, hd, hwz, hwy, hwx);
                s_wy[b][0][h] = y0 > 0 ? hwy : 0.0f;
            } else {  // w_x at (y0+i, x0-1): stage row i+1, column 3; 0 at the leading face
                const int i = h - TV_TX, q = (i + 1) * TV_SW + TV_VEC - 1;
                tv_point(cur[q], nxt[q], cur[q + TV_SW], cur[q + 1], hz, y0 + i + 1 < ny, true, inv_sz, inv_sy,
                         inv_sx, eps2, hd, hwz, hwy, hwx);
                s_wxl[b][i][0] = x0 > 0 ? hwx : 0.0f;
            }
        }
        __syncthreads();  // the exchange is written; nobody reads stage z again
        if (z + TV_STAGES < pend && (!kTma || tid == 0)) stage(z + TV_STAGES);

        if (z >= z0) {
            const float4 up = *reinterpret_cast<const float4*>(&s_wy[b][r][TV_VEC * c]);
            const float wyu[4] = {up.x, up.y, up.z, up.w};
            const float wxl[4] = {s_wxl[b][r][c], wx[0], wx[1], wx[2]};
            float g[TV_VEC];
#pragma unroll
            for (int j = 0; j < TV_VEC; ++j) g[j] = wz_prev[j] - wz[j] + wyu[j] - wy[j] + wxl[j] - wx[j];
            if (y < ny) {
                float* dst = gv + (size_t)z * plane + (size_t)y * nx + xs;
                if (kTma) {
                    if (xs < nx) {
                        *reinterpret_cast<float4*>(dst) = make_float4(g[0], g[1], g[2], g[3]);
#pragma unroll
                        for (int j = 0; j < TV_VEC; ++j) acc += (double)(den[j] - eps);
                    }
                } else {
#pragma unroll
                    for (int j = 0; j < TV_VEC; ++j)
                        if (xs + j < nx) {
                            dst[j] = g[j];
                            acc += (double)(den[j] - eps);
                        }
                }
            }
        }
#pragma unroll
        for (int j = 0; j < TV_VEC; ++j) wz_prev[j] = wz[j];
    }

    // The block's partial, then the volume's cost from the last block to finish.
    const double part = block_sum(acc, s_red);
    const int per_vol = gridDim.x * gridDim.y * nranges;
    double* pv = partials + (size_t)vol * per_vol;
    if (tid == 0) {
        pv[(range * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = part;
        __threadfence();
        s_last = atomicAdd(&tickets[vol], 1u) == (unsigned)per_vol - 1;
    }
    __syncthreads();
    if (s_last) {
        __threadfence();
        double t = 0.0;
        for (int i = tid; i < per_vol; i += TV_THREADS) t += __ldcg(pv + i);
        t = block_sum(t, s_red);
        if (tid == 0) {
            costs[vol] = (float)t;
            tickets[vol] = 0u;
        }
    }
}

static EncodeTiledFn encode_tiled() {
    static EncodeTiledFn fn = nullptr;
    if (!fn) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) == cudaSuccess &&
            q == cudaDriverEntryPointSuccess)
            fn = (EncodeTiledFn)p;
    }
    return fn;
}

// A 3D map of `depth` planes (ny, nx) of float32 with TV_SW x TV_SH x 1 boxes.
static bool encode_planes(CUtensorMap* map, const void* base, int nx, int ny, int64_t depth) {
    EncodeTiledFn encode = encode_tiled();
    if (!encode) return false;
    const cuuint64_t dims[3] = {(cuuint64_t)nx, (cuuint64_t)ny, (cuuint64_t)depth};
    const cuuint64_t strides[2] = {(cuuint64_t)nx * 4, (cuuint64_t)nx * ny * 4};
    const cuuint32_t box[3] = {TV_SW, TV_SH, 1};
    const cuuint32_t estr[3] = {1, 1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base), dims, strides, box, estr,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

static bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

extern "C" {

// One evaluation over z-slabs of a batch of nb volumes: x is nb contiguous
// float32 slabs (nz, ny, nx), prev and next the planes before and after each
// slab (nb contiguous (ny, nx) planes each), NULL where the slab starts or
// ends the volume; a whole volume (or batch of them) is the slab with both
// NULL. The costs are the slabs' own planes' and the gradient is
// the volume's at the slab's planes (see the note at the top). The geometry
// comes from the caller, which computed it with the same tile: grid (gx, gy, nb * nranges) with
// gx = ceil(nx / 64), gy = ceil(ny / 16), nranges = ceil(nz / 32);
// anything else, or a grid above 65535 in y or z, is refused with
// cudaErrorInvalidConfiguration before launching. aligned = 1 takes the TMA
// instantiation, which needs nx % 4 == 0 and x, grad and the halos 16-byte
// aligned (else cudaErrorInvalidValue); aligned = 0 the 4-byte-copy one.
// partials: float64, nb * gx * gy * nranges; costs: float32, nb; tickets:
// uint32, nb, zero before the first launch (each launch leaves them zero).
int hyperbolic_tv_slab_f32(const void* x, const void* prev, const void* next, void* grad, void* partials,
                           void* costs, void* tickets, int nb, int nz, int ny, int nx, int gx, int gy, int nranges,
                           int aligned, float eps, float inv_sz, float inv_sy, float inv_sx, void* stream) {
    if (nb < 1 || nz < 1 || ny < 1 || nx < 1 || gx != (nx + TV_TX - 1) / TV_TX ||
        gy != (ny + TV_TY - 1) / TV_TY || nranges != (nz + TV_ZR - 1) / TV_ZR || gy > 65535 ||
        (int64_t)nb * nranges > 65535)
        return (int)cudaErrorInvalidConfiguration;
    const dim3 grid(gx, gy, nb * nranges);
    CUtensorMap tmap = {}, tmap_prev = {}, tmap_next = {};
    const int has_prev = prev != nullptr, has_next = next != nullptr;
    if (aligned) {
        if (nx % 4 != 0 || !aligned16(x) || !aligned16(grad) || (has_prev && !aligned16(prev)) ||
            (has_next && !aligned16(next)))
            return (int)cudaErrorInvalidValue;
        if (!encode_tiled()) return (int)cudaErrorSymbolNotFound;
        if (!encode_planes(&tmap, x, nx, ny, (int64_t)nb * nz) ||
            (has_prev && !encode_planes(&tmap_prev, prev, nx, ny, nb)) ||
            (has_next && !encode_planes(&tmap_next, next, nx, ny, nb)))
            return (int)cudaErrorInvalidValue;
        hyperbolic_tv_kernel<true><<<grid, TV_THREADS, 0, (cudaStream_t)stream>>>(
            tmap, tmap_prev, tmap_next, (const float*)x, (const float*)prev, (const float*)next, (float*)grad,
            (double*)partials, (float*)costs, (unsigned int*)tickets, nz, ny, nx, nranges, has_prev, has_next, eps,
            inv_sz, inv_sy, inv_sx);
    } else {
        hyperbolic_tv_kernel<false><<<grid, TV_THREADS, 0, (cudaStream_t)stream>>>(
            tmap, tmap_prev, tmap_next, (const float*)x, (const float*)prev, (const float*)next, (float*)grad,
            (double*)partials, (float*)costs, (unsigned int*)tickets, nz, ny, nx, nranges, has_prev, has_next, eps,
            inv_sz, inv_sy, inv_sx);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
