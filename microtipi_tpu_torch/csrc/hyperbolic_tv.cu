// Fused hyperbolic-TV cost and gradient in one sweep, float32, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_tv_kernel_blocked` and `_tv_kernel`
// (microtipi_tpu/ops/pallas/hyperbolic_tv.py, reached through
// `_tv_pallas_impl` by `hyperbolic_tv_value` / `hyperbolic_tv_fused`) and the
// batched `_tv_kernel_flat` (reached through `_tv_pallas_batched`, the
// `custom_vmap` rule of the batched and tiled object steps). One kernel covers
// any nz, so the TPU's K-plane / one-plane split is not needed, and a batch
// (B, nz, ny, nx) is one more grid axis: blockIdx.z runs over B x ceil(nz/16)
// chunks, each chunk's z walk stays inside its volume, so no difference
// crosses a volume boundary. A single volume is the B = 1 launch, with the
// same blocks and the same bitwise outputs as before the batch axis existed.
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
// 64 MiB in and 64 MiB out of device memory, far below the card's arithmetic
// rate. The design keeps device-memory traffic near that floor:
//   - A block is a 32 x 8 (x, y) tile that walks a chunk of TV_ZCHUNK planes
//     in z, the TPU's sequential z grid turned into a loop inside the block.
//     The plane below's w_z is carried in a register, so each x plane is read
//     from device memory about once (plus one halo plane per chunk); the
//     y+1 / x+1 neighbour reads hit L1/L2.
//   - The w_y(u - e_y) and w_x(u - e_x) terms of the tile's first row and
//     column belong to the neighbouring tiles: the edge threads recompute
//     them from x, and the tile exchanges w_y / w_x through shared memory.
//   - Nothing carries between blocks, which run in any order: a chunk's
//     incoming w_z is recomputed from the plane before it.
//   - Cost: each thread sums its D - eps in double, the block reduces in
//     double in a fixed order, and each block writes one partial to a buffer
//     the caller allocated and sums (torch.sum; per volume for a batch, the
//     partials being laid out volume-major). No atomics, so two launches
//     on the same input give bitwise-equal outputs, and 256 planes stay at
//     float32 round-off (a sequential float32 accumulator would not).
// A plain C interface, loaded with ctypes; the launch goes on the caller's
// stream and the function returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#define TV_TX 32
#define TV_TY 8
#define TV_ZCHUNK 16
#define TV_THREADS (TV_TX * TV_TY)

struct TvWeights {
    float denom, wz, wy, wx;
};

// d_a, D and w_a at voxel (z, y, xi); the caller guarantees it is inside the volume.
__device__ __forceinline__ TvWeights tv_weights(const float* __restrict__ x, int nz, int ny, int nx,
                                                int z, int y, int xi, float inv_sz, float inv_sy,
                                                float inv_sx, float eps2) {
    const size_t plane = (size_t)ny * nx;
    const size_t i = (size_t)z * plane + (size_t)y * nx + xi;
    const float x0 = __ldg(x + i);
    const float dz = (z + 1 < nz) ? (__ldg(x + i + plane) - x0) * inv_sz : 0.0f;
    const float dy = (y + 1 < ny) ? (__ldg(x + i + nx) - x0) * inv_sy : 0.0f;
    const float dx = (xi + 1 < nx) ? (__ldg(x + i + 1) - x0) * inv_sx : 0.0f;
    TvWeights w;
    w.denom = sqrtf(dz * dz + dy * dy + dx * dx + eps2);
    const float inv_d = 1.0f / w.denom;
    w.wz = dz * inv_d * inv_sz;
    w.wy = dy * inv_d * inv_sy;
    w.wx = dx * inv_d * inv_sx;
    return w;
}

__global__ void __launch_bounds__(TV_THREADS)
hyperbolic_tv_kernel(const float* __restrict__ x, float* __restrict__ grad,
                     double* __restrict__ partials, int nz, int ny, int nx, int nchunks,
                     float eps, float inv_sz, float inv_sy, float inv_sx) {
    // s_wy[r][c]: w_y at (y0 - 1 + r, x0 + c - 1); s_wx the same for w_x.
    __shared__ float s_wy[TV_TY + 1][TV_TX + 1];
    __shared__ float s_wx[TV_TY + 1][TV_TX + 1];
    __shared__ double s_red[TV_THREADS / 32];

    const int tx = threadIdx.x, ty = threadIdx.y;
    const int x0 = blockIdx.x * TV_TX, y0 = blockIdx.y * TV_TY;
    const int xi = x0 + tx, y = y0 + ty;
    // blockIdx.z = volume * nchunks + chunk: the block sees only its volume.
    const int vol = blockIdx.z / nchunks;
    const int z0 = (blockIdx.z - vol * nchunks) * TV_ZCHUNK;
    const int z1 = min(z0 + TV_ZCHUNK, nz);
    const bool inside = (xi < nx) && (y < ny);
    const float eps2 = eps * eps;
    const size_t plane = (size_t)ny * nx;
    x += (size_t)vol * nz * plane;
    grad += (size_t)vol * nz * plane;

    // Incoming w_z of the chunk's first plane: recomputed from plane z0 - 1.
    float wz_prev = 0.0f;
    if (inside && z0 > 0)
        wz_prev = tv_weights(x, nz, ny, nx, z0 - 1, y, xi, inv_sz, inv_sy, inv_sx, eps2).wz;

    double acc = 0.0;
    for (int z = z0; z < z1; ++z) {
        TvWeights w = {0.0f, 0.0f, 0.0f, 0.0f};
        if (inside) w = tv_weights(x, nz, ny, nx, z, y, xi, inv_sz, inv_sy, inv_sx, eps2);
        s_wy[ty + 1][tx + 1] = w.wy;
        s_wx[ty + 1][tx + 1] = w.wx;
        // Halo row / column: w_y one row above the tile and w_x one column to
        // its left, 0 at the volume's leading faces.
        if (ty == 0) {
            float h = 0.0f;
            if (y0 > 0 && xi < nx)
                h = tv_weights(x, nz, ny, nx, z, y0 - 1, xi, inv_sz, inv_sy, inv_sx, eps2).wy;
            s_wy[0][tx + 1] = h;
        }
        if (tx == 0) {
            float h = 0.0f;
            if (x0 > 0 && y < ny)
                h = tv_weights(x, nz, ny, nx, z, y, x0 - 1, inv_sz, inv_sy, inv_sx, eps2).wx;
            s_wx[ty + 1][0] = h;
        }
        __syncthreads();
        if (inside) {
            const float g = wz_prev - w.wz + s_wy[ty][tx + 1] - w.wy + s_wx[ty + 1][tx] - w.wx;
            grad[(size_t)z * plane + (size_t)y * nx + xi] = g;
            acc += (double)(w.denom - eps);
        }
        wz_prev = w.wz;
        __syncthreads();
    }

    // Fixed-order block reduction in double: warp shuffles, then warp 0.
    const int lane = (ty * TV_TX + tx) & 31, warp = (ty * TV_TX + tx) >> 5;
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) s_red[warp] = acc;
    __syncthreads();
    if (warp == 0) {
        double v = (lane < TV_THREADS / 32) ? s_red[lane] : 0.0;
        for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
        if (lane == 0) {
            const size_t b = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
            partials[b] = v;
        }
    }
}

// Blocks per volume in z; gridDim.z = nb * tv_chunks(nz) must stay <= 65535.
static int tv_chunks(int nz) { return (nz + TV_ZCHUNK - 1) / TV_ZCHUNK; }

static bool tv_grid(int nb, int nz, int ny, int nx, dim3* g) {
    const int64_t gz = (int64_t)nb * tv_chunks(nz);
    const int64_t gy = (ny + TV_TY - 1) / TV_TY;
    if (nb < 1 || nz < 1 || ny < 1 || nx < 1 || gz > 65535 || gy > 65535) return false;
    *g = dim3((nx + TV_TX - 1) / TV_TX, (unsigned)gy, (unsigned)gz);
    return true;
}

extern "C" {

// Number of float64 cost partials (one per block) the caller must allocate
// for a batch of nb volumes, volume-major (nb rows of equal length); -1 if
// the grid does not fit (gridDim.z = nb * ceil(nz / 16) above 65535). A
// single volume is nb = 1.
int64_t hyperbolic_tv_num_partials(int nb, int nz, int ny, int nx) {
    dim3 g;
    if (!tv_grid(nb, nz, ny, nx, &g)) return -1;
    return (int64_t)g.x * g.y * g.z;
}

// x, grad: contiguous float32 (nb, nz, ny, nx) on the device; partials:
// float64 of hyperbolic_tv_num_partials(nb, nz, ny, nx). Returns
// cudaErrorInvalidConfiguration without launching if the grid does not fit,
// else cudaGetLastError().
int hyperbolic_tv_f32(const void* x, void* grad, void* partials, int nb, int nz, int ny,
                              int nx, float eps, float inv_sz, float inv_sy, float inv_sx,
                              void* stream) {
    dim3 g;
    if (!tv_grid(nb, nz, ny, nx, &g)) return (int)cudaErrorInvalidConfiguration;
    hyperbolic_tv_kernel<<<g, dim3(TV_TX, TV_TY), 0, (cudaStream_t)stream>>>(
        (const float*)x, (float*)grad, (double*)partials, nz, ny, nx, tv_chunks(nz), eps, inv_sz,
        inv_sy, inv_sx);
    return (int)cudaGetLastError();
}

}  // extern "C"
