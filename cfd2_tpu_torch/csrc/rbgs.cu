// Red-black Gauss-Seidel smoothers of the 5-point stencil, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernels in
// cfd2_tpu/ops/pallas_stencil.py:
//   * rbgs_leg        <- _fused_rbgs_kernel via fused_rbgs2 (one V-cycle leg:
//                        2*sweeps coloured half-sweeps, optionally followed by
//                        the residual b - A x, in one launch);
//   * rbgs_half_sweep <- _rbgs_half_sweep_kernel via rbgs_half_sweep (one
//                        coloured half-sweep on the flat (n,) layout).
//
// The update of a cell of the active colour is
//     x <- dinv * (b - (oE*xE + oW*xW + oN*xN + oS*xS)),
//     dinv = 1/diag where |diag| > 1e-30, else 0,
// with a cell's colour (row + col + parity) % 2 == 0, parity 0 then 1.  At the
// global grid edges a neighbour read takes the cell's own value (the
// edge-clamped shifts of _GridOps.shifts2).
//
// What bounds it on this card: bytes.  A leg reads 7 planes (x, diag, 4 off,
// b) and writes 1 or 2, i.e. about 36 B per cell, against a handful of flops
// per cell and half-sweep; at 589x1765 that is ~37 MB, ~11 us at 3.35 TB/s.
// What the design does about it: each thread block stages its 32x32 output
// tile plus a halo of H = 2*sweeps+1 cells on all four sides in shared memory,
// runs every half-sweep and the residual there (barriers between half-sweeps),
// and writes only the interior.  Every plane is read from device memory once
// per leg (plus the halo overlap, 38^2/32^2 = 1.41x at sweeps=1), which is what
// the TPU kernel bought with its row slabs.  Blocks never read a neighbour
// block's output: each recomputes its halo redundantly, one ring of validity
// being used up per half-sweep and one by the residual.
//
// Both functions have a plain C interface (loaded with ctypes), launch on the
// caller's stream, allocate nothing, and return cudaGetLastError() after the
// launch so that the caller can raise on a refused launch.

#include <cuda_runtime.h>

namespace {

constexpr int TILE_Y = 32;
constexpr int TILE_X = 32;
constexpr int THREADS_X = 32;
constexpr int THREADS_Y = 8;
constexpr int PLANES = 7;   // x, diag, oE, oW, oN, oS, b

__device__ __forceinline__ float safe_inv(float d) {
    return fabsf(d) > 1e-30f ? 1.0f / d : 0.0f;
}

__global__ void __launch_bounds__(THREADS_X * THREADS_Y)
rbgs_leg_kernel(const float* __restrict__ x, const float* __restrict__ diag,
                const float* __restrict__ off, const float* __restrict__ b,
                float* __restrict__ x_out, float* __restrict__ r_out,
                int ny, int nx, int sweeps, int halo) {
    extern __shared__ float smem[];
    const int sy = TILE_Y + 2 * halo;
    const int sx = TILE_X + 2 * halo;
    const int plane = sy * sx;
    float* s_x = smem;
    float* s_d = smem + plane;
    float* s_e = smem + 2 * plane;
    float* s_w = smem + 3 * plane;
    float* s_n = smem + 4 * plane;
    float* s_s = smem + 5 * plane;
    float* s_b = smem + 6 * plane;

    const long long n_cells = (long long)ny * nx;
    const int r0 = blockIdx.y * TILE_Y - halo;   // global row of staged row 0
    const int c0 = blockIdx.x * TILE_X - halo;   // global col of staged col 0
    const int tid = threadIdx.y * THREADS_X + threadIdx.x;
    const int nthreads = THREADS_X * THREADS_Y;

    // Stage the tile and its halo.  Cells outside the grid hold zeros: they
    // are never updated and never read by a cell inside the grid.
    for (int k = tid; k < plane; k += nthreads) {
        const int ly = k / sx;
        const int lx = k - ly * sx;
        const int gr = r0 + ly;
        const int gc = c0 + lx;
        if (gr >= 0 && gr < ny && gc >= 0 && gc < nx) {
            const long long g = (long long)gr * nx + gc;
            s_x[k] = x[g];
            s_d[k] = diag[g];
            s_e[k] = off[g];
            s_w[k] = off[n_cells + g];
            s_n[k] = off[2 * n_cells + g];
            s_s[k] = off[3 * n_cells + g];
            s_b[k] = b[g];
        } else {
            s_x[k] = 0.0f;
            s_d[k] = 0.0f;
            s_e[k] = 0.0f;
            s_w[k] = 0.0f;
            s_n[k] = 0.0f;
            s_s[k] = 0.0f;
            s_b[k] = 0.0f;
        }
    }
    __syncthreads();

    // Coloured half-sweeps in place.  A cell of the active colour reads only
    // cells of the other colour (and itself at a clamped edge), so no two
    // threads touch the same value within one half-sweep.
    for (int hs = 0; hs < 2 * sweeps; ++hs) {
        const int par = hs & 1;
        for (int k = tid; k < plane; k += nthreads) {
            const int ly = k / sx;
            const int lx = k - ly * sx;
            const int gr = r0 + ly;
            const int gc = c0 + lx;
            if (gr < 0 || gr >= ny || gc < 0 || gc >= nx) continue;
            if (((gr + gc + par) & 1) != 0) continue;
            // A neighbour beyond the staged region (not a global edge) is
            // unknown here; such cells lie in the ring already used up.
            const bool e_edge = gc == nx - 1, w_edge = gc == 0;
            const bool n_edge = gr == ny - 1, s_edge = gr == 0;
            if ((!e_edge && lx == sx - 1) || (!w_edge && lx == 0) ||
                (!n_edge && ly == sy - 1) || (!s_edge && ly == 0)) continue;
            const float xc = s_x[k];
            const float xe = e_edge ? xc : s_x[k + 1];
            const float xw = w_edge ? xc : s_x[k - 1];
            const float xn = n_edge ? xc : s_x[k + sx];
            const float xs = s_edge ? xc : s_x[k - sx];
            const float sigma = s_e[k] * xe + s_w[k] * xw + s_n[k] * xn
                + s_s[k] * xs;
            s_x[k] = safe_inv(s_d[k]) * (s_b[k] - sigma);
        }
        __syncthreads();
    }

    // Write the interior (and its residual) back.
    for (int k = tid; k < TILE_Y * TILE_X; k += nthreads) {
        const int ty = k / TILE_X;
        const int tx = k - ty * TILE_X;
        const int ly = ty + halo;
        const int lx = tx + halo;
        const int gr = r0 + ly;
        const int gc = c0 + lx;
        if (gr >= ny || gc >= nx) continue;
        const int s = ly * sx + lx;
        const long long g = (long long)gr * nx + gc;
        const float xc = s_x[s];
        x_out[g] = xc;
        if (r_out != nullptr) {
            const float xe = gc == nx - 1 ? xc : s_x[s + 1];
            const float xw = gc == 0 ? xc : s_x[s - 1];
            const float xn = gr == ny - 1 ? xc : s_x[s + sx];
            const float xs = gr == 0 ? xc : s_x[s - sx];
            const float sigma = s_e[s] * xe + s_w[s] * xw + s_n[s] * xn
                + s_s[s] * xs;
            r_out[g] = s_b[s] - (s_d[s] * xc + sigma);
        }
    }
}

__global__ void rbgs_half_sweep_kernel(
        const float* __restrict__ x, const float* __restrict__ diag,
        const float* __restrict__ off, const float* __restrict__ b,
        float* __restrict__ x_out, int ny, int nx, int parity) {
    const long long n_cells = (long long)ny * nx;
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n_cells) return;
    const int gr = (int)(i / nx);
    const int gc = (int)(i - (long long)gr * nx);
    const float xc = x[i];
    if (((gr + gc + parity) & 1) != 0) {
        x_out[i] = xc;   // the other colour is copied through
        return;
    }
    const float xe = gc == nx - 1 ? xc : x[i + 1];
    const float xw = gc == 0 ? xc : x[i - 1];
    const float xn = gr == ny - 1 ? xc : x[i + nx];
    const float xs = gr == 0 ? xc : x[i - nx];
    const float4 o = reinterpret_cast<const float4*>(off)[i];   // [E, W, N, S]
    const float sigma = o.x * xe + o.y * xw + o.z * xn + o.w * xs;
    x_out[i] = safe_inv(diag[i]) * (b[i] - sigma);
}

}  // namespace

extern "C" {

// x, diag, b, x_out, r_out: (ny, nx) float32; off: (4, ny, nx) float32 planes
// [E, W, N, S].  r_out may be null (no residual).  Returns a cudaError_t.
int rbgs_leg(const float* x, const float* diag, const float* off,
             const float* b, float* x_out, float* r_out, int ny, int nx,
             int sweeps, void* stream) {
    const int halo = 2 * sweeps + 1;
    const size_t smem = (size_t)PLANES * (TILE_Y + 2 * halo)
        * (TILE_X + 2 * halo) * sizeof(float);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            rbgs_leg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const dim3 block(THREADS_X, THREADS_Y);
    const dim3 grid((nx + TILE_X - 1) / TILE_X, (ny + TILE_Y - 1) / TILE_Y);
    rbgs_leg_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
        x, diag, off, b, x_out, r_out, ny, nx, sweeps, halo);
    return (int)cudaGetLastError();
}

// x, diag, b, x_out: (n,) float32 with n = ny*nx; off: (n, 4) float32 slots
// [E, W, N, S], 16-byte aligned.  Returns a cudaError_t.
int rbgs_half_sweep(const float* x, const float* diag, const float* off,
                    const float* b, float* x_out, int ny, int nx, int parity,
                    void* stream) {
    const long long n = (long long)ny * nx;
    const int threads = 256;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    rbgs_half_sweep_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        x, diag, off, b, x_out, ny, nx, parity);
    return (int)cudaGetLastError();
}

// Human-readable text of a cudaError_t returned above.
const char* rbgs_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
