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
//     still gives 512 blocks (3 resident an SM at its 72 registers). Each thread
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
//     takes the same walk with its neighbours' boundary planes: `prev`, the
//     plane before the slab, and `next`, the plane after it. A missing one is
//     the volume's face: no incoming w_z before the first plane, d_z = 0 at
//     the last. The slab's cost sums its own planes and its gradient is
//     written for them only, so the costs of the slabs add up to the volume's
//     and their gradients are the volume's gradient, bit for bit (every
//     per-voxel term comes from the same inputs in the same order). This
//     replaces the halo exchanges that GSPMD inserts around the Pallas kernel
//     on a TPU mesh.
//   - Grouped slab launch. Slabs have an entry of their own: one grid whose
//     blockIdx.z runs over the z ranges of up to TV_GROUP_SLABS slabs of one
//     device, with a __grid_constant__ table of each slab's tensor map (its
//     base pointer for the 4-byte copies), outputs and z range, and of where
//     its prev and next planes lie: plane z0 + volume * zstep of any map of
//     the table. So a neighbouring slab of the same launch is read in place
//     through its own map, and only a neighbour on another device needs a
//     halo buffer (a map of its own). Each slab keeps its own partials and
//     tickets, so its cost and gradient do not depend on the group.
//   - Slab geometry. The grouped launch's z range is a launch parameter that
//     the wrapper chooses from all its slabs' shapes: the longest of 32, 16,
//     8 and 4 planes that still gives the launch about 4 blocks an SM (512).
//     A 64-plane slab of 256^2 walked 32 planes in 128 blocks, one block an
//     SM, and took the latency of one block's walk (25% of its bound); alone
//     it walks 8 planes in 512 blocks, and four such slabs in one launch walk
//     32, as the whole volume does. Each slab's cost is summed in chunks of
//     TV_COST_PLANES planes (a partial a tile and chunk), so neither its cost
//     nor its gradient depends on the z range or on the group it is in.
//     Short ranges make the work beside a block's own voxels count: the plane
//     before each range, walked for its w_z, and the halo points. Three or
//     four resident blocks an SM time the same, so the grouped walk cuts
//     that work instead (see tv_walk), in its own instantiation; the
//     whole-volume launch keeps its own: TV_ZR planes, its halo spread.
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
#define TV_ZR 32                       // z planes a block of the whole-volume launch walks
#define TV_STAGES 4                    // ring depth: 3 planes in flight
#define TV_GROUP_BLOCKS_PER_SM 4       // its resident blocks (a register cap)
#define TV_GROUP_SLABS 8               // slabs a grouped launch covers
#define TV_GROUP_MAPS 24               // maps in its table: the slabs' and up to two halo buffers each
#define TV_COST_PLANES 4               // planes of a grouped launch's cost partial; its z ranges are multiples
#define TV_GROUP_CHUNKS 8              // cost partials a block of it writes at most: z ranges up to 32 planes
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
static_assert(TV_GROUP_MAPS >= 3 * TV_GROUP_SLABS, "every slab of a group may have two halo buffers");

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

// One block's walk: the (y, x) tile (blockIdx.y, blockIdx.x) of planes
// [z0, z1) of a volume of nz planes, of which planes lo .. hi-1 exist (plane
// -1 is `prev`, plane nz is `next`). `locate(p, map, zc, src)` says where
// plane p lies: its tensor map and coordinate there (TMA), its first element
// (4-byte copies). The gradient goes to gv, the volume's planes; returns the
// thread's sum of D - eps. kGroup is the grouped slab launch's walk, whose
// ranges are short, so it spends fewer instructions on what is not a voxel
// of its own: the 80 halo points go to 2.5 warps (lanes 0-31 of warps 0-1,
// 0-15 of warp 2) instead of 10 lanes of each of the 8, so 5 warps skip the
// halo branch, and the plane before the range, walked for its w_z alone,
// computes no halo point. It sums the cost by chunks of TV_COST_PLANES
// planes instead (z0 is a multiple): each warp's sum of a chunk goes to
// s_chunk[chunk - z0 / TV_COST_PLANES][warp], so a chunk's sum does not
// depend on the z range that walked it.
template <bool kTma, bool kGroup, typename Locate>
__device__ __forceinline__ double tv_walk(const Locate& locate, float* __restrict__ gv, int nz, int ny, int nx,
                                          int z0, int z1, int lo, int hi, float eps, float inv_sz, float inv_sy,
                                          float inv_sx, double (*s_chunk)[TV_WARPS] = nullptr) {
    constexpr int kHaloLanes = kGroup ? 32 : TV_HALO_LANES;
    __shared__ __align__(128) float s_ring[TV_STAGES][TV_STAGE_STRIDE];
    __shared__ __align__(16) float s_wy[2][TV_TY + 1][TV_TX];  // w_y at rows y0-1 .. y0+TY-1
    __shared__ float s_wxl[2][TV_TY][TV_TPR + 1];  // [0]: w_x at x0-1; [c+1]: thread c's last w_x
    __shared__ __align__(8) uint64_t s_full[TV_STAGES];

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int r = tid / TV_TPR, c = tid - r * TV_TPR;  // tile row, 4-column group
    const int x0 = blockIdx.x * TV_TX, y0 = blockIdx.y * TV_TY;
    const int y = y0 + r, xs = x0 + TV_VEC * c;
    // Planes staged: the one before the range (to rebuild its incoming w_z),
    // the range, and the one after it (for the last plane's d_z).
    const int pstart = max(z0 - 1, lo), pend = min(z1 + 1, hi);
    const float eps2 = eps * eps;
    const size_t plane = (size_t)ny * nx;

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
        const CUtensorMap* map;
        int zc;
        const float* src_plane;
        locate(p, map, zc, src_plane);
        if constexpr (kTma) {
            asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
                         "r"(TV_STAGE_BYTES) : "memory");
            asm volatile(
                "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
                "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_addr(dst)),
                "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x0 - TV_VEC), "r"(y0 - 1),
                "r"(zc) : "memory");
        } else {
            for (int i = tid; i < TV_STAGE_FLOATS; i += TV_THREADS) {
                const int row = i / TV_SW, col = i - row * TV_SW;
                const int gy = y0 - 1 + row, gx = x0 - TV_VEC + col;
                const bool ok = gy >= 0 && gy < ny && gx >= 0 && gx < nx;
                const float* src = ok ? src_plane + (size_t)gy * nx + gx : src_plane;
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
    const int h = warp * kHaloLanes + lane;
    const bool has_halo = lane < kHaloLanes && (!kGroup || h < TV_HALO);

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
        if (has_halo && (!kGroup || z >= z0)) {
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
        if constexpr (kGroup) {
            if (z >= z0 && ((z + 1) % TV_COST_PLANES == 0 || z + 1 == z1)) {
                for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
                if (lane == 0) s_chunk[(z - z0) / TV_COST_PLANES][warp] = acc;
                acc = 0.0;
            }
        }
    }
    return acc;
}

// The volume's cost, by the last of its blocks to take a ticket (`last`):
// its n partials summed in index order. That block leaves the ticket 0 for
// the next launch on the stream.
__device__ __forceinline__ void tv_cost(bool last, const double* __restrict__ pv, int n,
                                        unsigned int* __restrict__ ticket, float* __restrict__ cost, double* s_red) {
    if (last) {
        __threadfence();
        double t = 0.0;
        for (int i = threadIdx.x; i < n; i += TV_THREADS) t += __ldcg(pv + i);
        t = block_sum(t, s_red);
        if (threadIdx.x == 0) {
            *cost = (float)t;
            *ticket = 0u;
        }
    }
}

// The block's partial into slot `slot` of its volume's `per_vol` partials,
// then an atomic ticket after __threadfence: the last block to finish sums
// the volume's cost.
__device__ __forceinline__ void tv_finish(double acc, double* __restrict__ pv, int slot, int per_vol,
                                          unsigned int* __restrict__ ticket, float* __restrict__ cost) {
    __shared__ double s_red[TV_WARPS + 1];
    __shared__ int s_last;
    const double part = block_sum(acc, s_red);
    if (threadIdx.x == 0) {
        pv[slot] = part;
        __threadfence();
        s_last = atomicAdd(ticket, 1u) == (unsigned)per_vol - 1;
    }
    __syncthreads();
    tv_cost(s_last, pv, per_vol, ticket, cost, s_red);
}

// Whole volumes: grid (x tiles, y tiles, B * z ranges of TV_ZR planes);
// blockIdx.z = volume * nranges + range.
template <bool kTma>
__global__ void __launch_bounds__(TV_THREADS)
hyperbolic_tv_kernel(const __grid_constant__ CUtensorMap tmap, const float* __restrict__ x,
                     float* __restrict__ grad, double* __restrict__ partials, float* __restrict__ costs,
                     unsigned int* __restrict__ tickets, int nz, int ny, int nx, int nranges, float eps,
                     float inv_sz, float inv_sy, float inv_sx) {
    const int vol = blockIdx.z / nranges, range = blockIdx.z - vol * nranges;
    const int z0 = range * TV_ZR, z1 = min(z0 + TV_ZR, nz);
    const size_t plane = (size_t)ny * nx;
    auto locate = [&](int p, const CUtensorMap*& map, int& zc, const float*& src) {
        map = &tmap;
        zc = vol * nz + p;
        src = x + (size_t)zc * plane;
    };
    const double acc = tv_walk<kTma, false>(locate, grad + (size_t)vol * nz * plane, nz, ny, nx, z0, z1, 0, nz, eps,
                                            inv_sz, inv_sy, inv_sx);
    const int per_vol = gridDim.x * gridDim.y * nranges;
    tv_finish(acc, partials + (size_t)vol * per_vol, (range * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x,
              per_vol, tickets + vol, costs + vol);
}

// Where a slab's prev or next plane of volume v lies: plane z0 + v * zstep
// of the table's map `map`; map < 0: none (the volume's face).
struct TvSource {
    int map, z0, zstep;
};

struct TvSlab {
    float* grad;             // (nb, nz, ny, nx)
    double* partials;        // nb * gx * gy * ceil(nz / TV_COST_PLANES)
    float* costs;            // nb
    unsigned int* tickets;   // nb
    int nz, ranges, block0;  // block0: the slab's first blockIdx.z
    TvSource prev, next;
};

// A grouped launch's table: map s < nslabs holds slab s's nb * nz planes,
// the maps after them the halo buffers.
struct TvGroup {
    CUtensorMap maps[TV_GROUP_MAPS];
    const float* planes[TV_GROUP_MAPS];  // each map's first element, for the 4-byte copies
    TvSlab slabs[TV_GROUP_SLABS];
    int nslabs, ny, nx, z_range;
    float eps, inv_sz, inv_sy, inv_sx;
};
static_assert(sizeof(TvGroup) <= 4096, "a launch's parameters stay within 4 KB");

// Grouped slabs: grid (x tiles, y tiles, the slabs' B * z ranges in table
// order); blockIdx.z - block0 = volume * ranges + range within its slab.
// Each slab's volume has a cost partial per tile and chunk of TV_COST_PLANES
// planes, index (chunk, y tile, x tile); its last block sums them in index
// order, so the cost does not depend on the z range either.
template <bool kTma>
__global__ void __launch_bounds__(TV_THREADS, TV_GROUP_BLOCKS_PER_SM)
hyperbolic_tv_group_kernel(const __grid_constant__ TvGroup g) {
    __shared__ double s_chunk[TV_GROUP_CHUNKS][TV_WARPS];
    __shared__ double s_red[TV_WARPS + 1];
    __shared__ int s_last;
    int s = 0;
    while (s + 1 < g.nslabs && (int)blockIdx.z >= g.slabs[s + 1].block0) ++s;
    const TvSlab& sl = g.slabs[s];
    const int local = blockIdx.z - sl.block0, nz = sl.nz;
    const int vol = local / sl.ranges, range = local - vol * sl.ranges;
    const int z0 = range * g.z_range, z1 = min(z0 + g.z_range, nz);
    const size_t plane = (size_t)g.ny * g.nx;
    auto locate = [&](int p, const CUtensorMap*& map, int& zc, const float*& src) {
        int m = s;
        zc = vol * nz + p;
        if (p < 0) {
            m = sl.prev.map;
            zc = sl.prev.z0 + vol * sl.prev.zstep;
        } else if (p >= nz) {
            m = sl.next.map;
            zc = sl.next.z0 + vol * sl.next.zstep;
        }
        map = &g.maps[m];
        src = g.planes[m] + (size_t)zc * plane;
    };
    tv_walk<kTma, true>(locate, sl.grad + (size_t)vol * nz * plane, nz, g.ny, g.nx, z0, z1,
                        sl.prev.map >= 0 ? -1 : 0, sl.next.map >= 0 ? nz + 1 : nz, g.eps, g.inv_sz, g.inv_sy,
                        g.inv_sx, s_chunk);
    __syncthreads();  // every warp's chunk sums are in s_chunk
    const int tid = threadIdx.x, tiles = gridDim.x * gridDim.y, chunks = (nz + TV_COST_PLANES - 1) / TV_COST_PLANES;
    double* pv = sl.partials + (size_t)vol * tiles * chunks;
    if (tid < (z1 - z0 + TV_COST_PLANES - 1) / TV_COST_PLANES) {
        double t = 0.0;
        for (int w = 0; w < TV_WARPS; ++w) t += s_chunk[tid][w];
        pv[(z0 / TV_COST_PLANES + tid) * tiles + blockIdx.y * gridDim.x + blockIdx.x] = t;
        __threadfence();
    }
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(&sl.tickets[vol], 1u) == (unsigned)(tiles * sl.ranges) - 1;
    __syncthreads();
    tv_cost(s_last, pv, tiles * chunks, &sl.tickets[vol], &sl.costs[vol], s_red);
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

static int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

extern "C" {

// One evaluation of a batch of nb whole volumes: x is nb contiguous float32
// volumes (nz, ny, nx). The geometry comes from the caller, which computed
// it with the same tile: grid (gx, gy, nb * nranges) with gx = ceil(nx / 64),
// gy = ceil(ny / 16), nranges = ceil(nz / TV_ZR); anything else, or a grid
// above 65535 in y or z, is refused with cudaErrorInvalidConfiguration
// before launching. aligned = 1 takes the TMA instantiation, which needs
// nx % 4 == 0 and x and grad 16-byte aligned (else cudaErrorInvalidValue);
// aligned = 0 the 4-byte-copy one. partials: float64, nb * gx * gy *
// nranges; costs: float32, nb; tickets: uint32, nb, zero before the first
// launch (each launch leaves them zero).
int hyperbolic_tv_f32(const void* x, void* grad, void* partials, void* costs, void* tickets, int nb, int nz, int ny,
                      int nx, int gx, int gy, int nranges, int aligned, float eps, float inv_sz, float inv_sy,
                      float inv_sx, void* stream) {
    if (nb < 1 || nz < 1 || ny < 1 || nx < 1 || gx != ceil_div(nx, TV_TX) || gy != ceil_div(ny, TV_TY) ||
        nranges != ceil_div(nz, TV_ZR) || gy > 65535 || (int64_t)nb * nranges > 65535)
        return (int)cudaErrorInvalidConfiguration;
    const dim3 grid(gx, gy, nb * nranges);
    CUtensorMap tmap = {};
    if (aligned) {
        if (nx % 4 != 0 || !aligned16(x) || !aligned16(grad)) return (int)cudaErrorInvalidValue;
        if (!encode_tiled()) return (int)cudaErrorSymbolNotFound;
        if (!encode_planes(&tmap, x, nx, ny, (int64_t)nb * nz)) return (int)cudaErrorInvalidValue;
        hyperbolic_tv_kernel<true><<<grid, TV_THREADS, 0, (cudaStream_t)stream>>>(
            tmap, (const float*)x, (float*)grad, (double*)partials, (float*)costs, (unsigned int*)tickets, nz, ny,
            nx, nranges, eps, inv_sz, inv_sy, inv_sx);
    } else {
        hyperbolic_tv_kernel<false><<<grid, TV_THREADS, 0, (cudaStream_t)stream>>>(
            tmap, (const float*)x, (float*)grad, (double*)partials, (float*)costs, (unsigned int*)tickets, nz, ny,
            nx, nranges, eps, inv_sz, inv_sy, inv_sx);
    }
    return (int)cudaGetLastError();
}

// One grouped launch over nslabs z-slabs of one device (1 .. TV_GROUP_SLABS),
// each nb contiguous float32 slabs (nz[s], ny, nx): planes[s] (s < nslabs)
// is slab s, of depths[s] = nb * nz[s] planes; planes[s] for nslabs <= s <
// nmaps (<= TV_GROUP_MAPS) are further sources of halo planes, of depths[s]
// planes (ny, nx) each. sources holds 6 ints a slab, (map, z0, zstep) of its
// prev plane and of its next one: volume v's plane is plane z0 + v * zstep
// of map `map`, map = -1 where the slab starts or ends the volume. The costs
// are each slab's own planes' and the gradients the volume's at the slab's
// planes (see the note at the top). The geometry comes from the caller: a
// block walks z_range planes (a multiple of TV_COST_PLANES, at most
// TV_COST_PLANES * TV_GROUP_CHUNKS), so slab s has ceil(nz[s] / z_range) z
// ranges; grid (gx, gy, gz) with gx = ceil(nx / 64), gy = ceil(ny / 16), gz
// the sum over the slabs of nb * their z ranges; anything else, or a grid
// above 65535 in y or z, is refused with cudaErrorInvalidConfiguration before
// launching, as is a source outside its map (cudaErrorInvalidValue).
// aligned = 1 takes the TMA instantiation, which needs nx % 4 == 0 and every
// map and gradient 16-byte aligned; aligned = 0 the 4-byte-copy one.
// partials: float64, nb * gx * gy * ceil(nz[s] / TV_COST_PLANES), slab after slab;
// costs: float32, nslabs * nb, slab-major; tickets: uint32, nslabs * nb,
// zero before the first launch (each launch leaves them zero).
int hyperbolic_tv_group_f32(int nslabs, int nmaps, const void* const* planes, const long long* depths,
                            void* const* grads, const int* nz, const int* sources, void* partials, void* costs,
                            void* tickets, int nb, int ny, int nx, int z_range, int gx, int gy, int gz, int aligned,
                            float eps, float inv_sz, float inv_sy, float inv_sx, void* stream) {
    if (nslabs < 1 || nslabs > TV_GROUP_SLABS || nmaps < nslabs || nmaps > TV_GROUP_MAPS || nb < 1 || ny < 1 ||
        nx < 1 || z_range < 1 || z_range % TV_COST_PLANES != 0 || z_range > TV_COST_PLANES * TV_GROUP_CHUNKS ||
        gx != ceil_div(nx, TV_TX) || gy != ceil_div(ny, TV_TY) || gy > 65535 || gz > 65535)
        return (int)cudaErrorInvalidConfiguration;
    TvGroup g = {};
    g.nslabs = nslabs;
    g.ny = ny;
    g.nx = nx;
    g.z_range = z_range;
    g.eps = eps;
    g.inv_sz = inv_sz;
    g.inv_sy = inv_sy;
    g.inv_sx = inv_sx;
    int64_t block0 = 0, partial0 = 0;
    for (int s = 0; s < nslabs; ++s) {
        if (nz[s] < 1 || depths[s] != (int64_t)nb * nz[s]) return (int)cudaErrorInvalidConfiguration;
        TvSlab& sl = g.slabs[s];
        sl.nz = nz[s];
        sl.ranges = (int)ceil_div(nz[s], z_range);
        sl.block0 = (int)block0;
        sl.grad = (float*)grads[s];
        sl.partials = (double*)partials + partial0;
        sl.costs = (float*)costs + (int64_t)s * nb;
        sl.tickets = (unsigned int*)tickets + (int64_t)s * nb;
        block0 += (int64_t)nb * sl.ranges;
        partial0 += (int64_t)nb * gx * gy * ceil_div(nz[s], TV_COST_PLANES);
        if (block0 > gz) return (int)cudaErrorInvalidConfiguration;
        TvSource* src[2] = {&sl.prev, &sl.next};
        for (int i = 0; i < 2; ++i) {
            const int* q = sources + 6 * s + 3 * i;
            *src[i] = TvSource{q[0], q[1], q[2]};
            if (q[0] == -1) continue;
            if (q[0] < 0 || q[0] >= nmaps || q[1] < 0 || q[2] < 0 || q[1] + (int64_t)(nb - 1) * q[2] >= depths[q[0]])
                return (int)cudaErrorInvalidValue;
        }
    }
    if (block0 != gz) return (int)cudaErrorInvalidConfiguration;
    for (int m = 0; m < nmaps; ++m) g.planes[m] = (const float*)planes[m];
    const dim3 grid(gx, gy, gz);
    if (aligned) {
        if (nx % 4 != 0) return (int)cudaErrorInvalidValue;
        for (int m = 0; m < nmaps; ++m)
            if (!aligned16(planes[m])) return (int)cudaErrorInvalidValue;
        for (int s = 0; s < nslabs; ++s)
            if (!aligned16(grads[s])) return (int)cudaErrorInvalidValue;
        if (!encode_tiled()) return (int)cudaErrorSymbolNotFound;
        for (int m = 0; m < nmaps; ++m)
            if (!encode_planes(&g.maps[m], planes[m], nx, ny, depths[m])) return (int)cudaErrorInvalidValue;
        hyperbolic_tv_group_kernel<true><<<grid, TV_THREADS, 0, (cudaStream_t)stream>>>(g);
    } else {
        hyperbolic_tv_group_kernel<false><<<grid, TV_THREADS, 0, (cudaStream_t)stream>>>(g);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
