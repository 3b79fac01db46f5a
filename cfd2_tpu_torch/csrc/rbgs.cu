// Red-black Gauss-Seidel smoothers of the 5-point stencil, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernels in
// cfd2_tpu/ops/pallas_stencil.py (and adds rbgs_residual, see below):
//   * rbgs_leg        <- _fused_rbgs_kernel via fused_rbgs2 (one V-cycle leg:
//                        2*sweeps coloured half-sweeps, optionally followed by
//                        the residual b - A x, in one launch);
//   * rbgs_half_sweep <- _rbgs_half_sweep_kernel via rbgs_half_sweep (one
//                        coloured half-sweep).
//
// The update of a cell of the active colour is
//     x <- dinv * (b - (oE*xE + oW*xW + oN*xN + oS*xS)),
//     dinv = 1/diag where |diag| > 1e-30, else 0,
// with a cell's colour (row + col + parity) % 2 == 0, parity 0 then 1.  At the
// global grid edges a neighbour read takes the cell's own value (the
// edge-clamped shifts of _GridOps.shifts2).  The arithmetic is XLA's for the
// JAX package's _GridOps on the main path's grids (it contracts the
// multiply-adds): sigma = fma(oS, xS, fma(oN, xN, fma(oE, xE, oW*xW))),
// x <- dinv * (b - sigma), r = b - fma(diag, x, sigma).  It is pinned with
// explicit intrinsics (stencil_sigma, relaxed, residual below): left to
// nvcc, the contraction differed from cell to cell (the second residual of a
// pair came out as b - (diag*x + sigma), rounded twice).  The plain versions
// (ops/stencil_kernels.py smoother_sigma) compute the same, and the kernels
// equal them bit for bit.
//
// rbgs_leg at sweeps = 1 (the V-cycle's only value).  What bounds it on this
// card: bytes.  A leg reads 7 planes (x, diag, 4 off, b) and writes 1 or 2,
// about 36 B per cell against some twenty flops; at 589x1765 that is 37 MB,
// 11 us at 3.35 TB/s.  Only x is read at neighbouring cells; diag, off and b
// are read at the cell's own position.  What the design does about it:
//   * only x is staged in shared memory, the tile plus a halo of 3 cells (2
//     without the residual).  Blocks never read a neighbour block's output:
//     each recomputes its halo, one ring of validity being used up per
//     half-sweep and one by the residual;
//   * the six coefficient planes go from device memory straight into
//     registers.  A thread owns vertical pairs of cells (r, c), (r + 1, c)
//     with r even: one cell of each colour, so every lane works in both
//     half-sweeps, and a warp's loads and stores cover 32 adjacent columns
//     of one row.  The pair's coefficients serve its half-sweep and the
//     residual from the same registers.  The ring of cells around the tile
//     that must be relaxed too (2 deep with the residual, 1 without) is
//     dealt out over the threads, one load of each coefficient per cell;
//   * every global load of a block (the x stage, the pairs' coefficients,
//     the ring's) is issued before the first barrier, so a thread has tens of
//     independent loads in flight.  The loads are plain 4-byte coalesced
//     loads: the rows of a 589x1765 plane are 7,060 B apart, not a multiple
//     of 16, which rules out 16-byte copies and TMA tensor maps at level 0,
//     and a tensor map encoded per call would cost the host more than the
//     kernel runs.  cp.async would only add a second wait for data that the
//     registers hold anyway;
//   * tile shapes are compile-time (no division by a run-time width) and are
//     chosen per grid so that coarse levels still give the card's 132 SMs a
//     block each: see the choice in rbgs_leg();
//   * two fused forms save the V-cycle a pass over a plane each and its eager
//     launches: MODE_RESTRICT returns the 2x2 block sums of the residual (the
//     next level's right-hand side; tile origins are even, so a block of four
//     lies in one warp: the pair sums its two rows and two shuffles add the
//     neighbouring column's cells, in restrict2's order) and never writes r; MODE_PROLONG adds the
//     piecewise-constant prolongation of the coarse x while x is staged.
// For sweeps > 1 the kernel of the first port stays (rbgs_leg_staged_kernel):
// all 7 planes staged with a halo of 2*sweeps+1 around a 32x32 tile.
//
// rbgs_half_sweep is bound by bytes too: 7 planes read (x, diag, 4 off, b)
// and x written, 8 planes at 589x1765 = 33 MB, 9.9 us at 3.35 TB/s.  The TPU
// kernel takes off as (n, 4) and splits it into four planes itself, and its
// V-cycle moved the level's planes to that layout before every smooth; here
// the kernel takes the (4, ny, nx) planes the level values are kept in, so
// the V-cycle passes them as they are (the first port transposed them on
// every smooth: a launch and 8 planes of traffic, as much as the half-sweep
// itself).  What the design does:
//   * a 2D launch of 128 x 2 threads, one per cell: the row comes from
//     blockIdx.y and the column from blockIdx.x, so there is no division by
//     a run-time width (the first port divided a 64-bit flat index by nx in
//     every thread), and a warp's loads and stores cover 32 adjacent cells
//     of one row, a block's 512-byte runs of two rows (square 32 x 8 blocks,
//     eight rows of 128 bytes, were no faster and slower under a write
//     flush of the L2).  Cells of the other colour load no coefficients,
//     but their neighbours of the active colour share every sector, so all
//     7 planes are read in full whatever the colour pattern;
//   * in place (x_out == x): the second half-sweep of a pair writes into the
//     first one's fresh output.  A cell of the active colour reads only
//     cells of the other colour, and itself at a clamped edge, so nothing
//     races; the other colour is not copied.  That saves the host one
//     allocation per pair and half the store instructions, and no device
//     bytes: the stores of alternate cells dirty every sector of x, which
//     is written back whole, as a copy would write it.
//
// rbgs_residual replaces no TPU kernel: the JAX package leaves the V-cycle's
// residual and restriction around its per-half-sweep kernels
// (pallas_level() == 1) to XLA.  Its port took them as eager PyTorch, a chain
// of elementwise launches per level; this kernel gives the half-sweep path
// (CFD2_PALLAS=1, and the row-sharded down leg at that level) the fused leg
// kernel's MODE_RESTRICT without the smoothing: restrict2(b - A x), the
// residual never reaching device memory.  Bound by bytes: 7 planes read (x,
// diag, 4 off, b) and a quarter plane written, 29 B per fine cell; at
// 589x1765 that is 30 MB, 9.0 us at 3.35 TB/s.  What the design does: a
// thread takes one fine column of a pair of rows, so a warp's loads cover 32
// adjacent columns (the first form, a thread per coarse cell reading its
// four cells, loaded every plane at a stride of two and ran at 38% of the
// bound); the pair shares its x values, computes both residuals with the
// leg kernel's pinned arithmetic (stencil_sigma, residual), and two
// shuffles add the neighbouring column's in restrict2's order, ((r00 + r10)
// + r01) + r11, cells beyond the fine grid adding zero as restrict2's zero
// padding does.
//
// All functions have a plain C interface (loaded with ctypes), launch on the
// caller's stream, allocate nothing, and return cudaGetLastError() after the
// launch so that the caller can raise on a refused launch.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float safe_inv(float d) {
    return fabsf(d) > 1e-30f ? 1.0f / d : 0.0f;
}

// oE*xE + oW*xW + oN*xN + oS*xS, in the order XLA contracts it.
__device__ __forceinline__ float stencil_sigma(float oe, float xe, float ow,
                                              float xw, float on, float xn,
                                              float os, float xs) {
    return __fmaf_rn(os, xs, __fmaf_rn(on, xn, __fmaf_rn(oe, xe,
                                                          __fmul_rn(ow, xw))));
}

// A relaxed cell: dinv * (b - sigma).
__device__ __forceinline__ float relaxed(float d, float b, float sigma) {
    return __fmul_rn(safe_inv(d), __fsub_rn(b, sigma));
}

// The residual b - (diag*x + sigma), the multiply-add fused.
__device__ __forceinline__ float residual(float b, float d, float x,
                                          float sigma) {
    return __fsub_rn(b, __fmaf_rn(d, x, sigma));
}

// ---------------------------------------------------------------------
// rbgs_leg, sweeps = 1.

constexpr int MODE_SMOOTH = 0;     // x
constexpr int MODE_RESIDUAL = 1;   // x, r = b - A x
constexpr int MODE_RESTRICT = 2;   // x, 2x2 block sums of r
constexpr int MODE_PROLONG = 3;    // smooth x + prolong(x_coarse); x

// diag, oE, oW, oN, oS, b of one cell.
struct Coef {
    float d, e, w, n, s, b;
};

__device__ __forceinline__ Coef load_coef(
        const float* __restrict__ diag, const float* __restrict__ off,
        const float* __restrict__ b, long long n_cells, long long g,
        bool take) {
    Coef c = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (take) {
        c.d = diag[g];
        c.e = off[g];
        c.w = off[n_cells + g];
        c.n = off[2 * n_cells + g];
        c.s = off[3 * n_cells + g];
        c.b = b[g];
    }
    return c;
}

// oE*xE + oW*xW + oN*xN + oS*xS at staged position k of global cell
// (gr, gc), a neighbour beyond a grid edge taking the cell's own value.
template <int SX>
__device__ __forceinline__ float sigma_at(const float* s_x, int k, int gr,
                                          int gc, int ny, int nx,
                                          const Coef& c, float xc) {
    const float xe = gc == nx - 1 ? xc : s_x[k + 1];
    const float xw = gc == 0 ? xc : s_x[k - 1];
    const float xn = gr == ny - 1 ? xc : s_x[k + SX];
    const float xs = gr == 0 ? xc : s_x[k - SX];
    return stencil_sigma(c.e, xe, c.w, xw, c.n, xn, c.s, xs);
}

template <int SX>
__device__ __forceinline__ void relax_at(float* s_x, int k, int gr, int gc,
                                         int ny, int nx, const Coef& c) {
    const float sigma = sigma_at<SX>(s_x, k, gr, gc, ny, nx, c, s_x[k]);
    s_x[k] = relaxed(c.d, c.b, sigma);
}

// One block smooths a tile of TY = 2*PR*NP rows by TX columns with TX*PR
// threads: thread (tx, ty) owns the pairs of rows 2*(ty + p*PR), +1 in
// column tx, p < NP.  Tile origins are even, so in an even column the upper
// cell of a pair has colour 0 and in an odd column the lower one.
template <int TX, int PR, int NP, int MODE>
__global__ void __launch_bounds__(TX * PR)
rbgs_leg_kernel(const float* __restrict__ x, const float* __restrict__ diag,
                const float* __restrict__ off, const float* __restrict__ b,
                const float* __restrict__ x_coarse, float* __restrict__ x_out,
                float* __restrict__ r_out, int ny, int nx, int nxc) {
    constexpr bool RESID = MODE == MODE_RESIDUAL || MODE == MODE_RESTRICT;
    constexpr int H = RESID ? 3 : 2;    // halo of x
    constexpr int R = H - 1;            // ring of cells relaxed around the tile
    constexpr int TY = 2 * PR * NP;
    constexpr int NT = TX * PR;
    constexpr int SX = TX + 2 * H;
    constexpr int SY = TY + 2 * H;
    constexpr int NS = (SY * SX + NT - 1) / NT;     // staged values per thread
    constexpr int RW = TX + 2 * R;                  // ring: width of the tile + R
    constexpr int RTOP = R * RW;                    // cells above (below) the tile
    constexpr int NRING = 2 * RTOP + TY * 2 * R;
    constexpr int NR = (NRING + NT - 1) / NT;       // ring cells per thread
    __shared__ float s_x[SY * SX];

    const long long n_cells = (long long)ny * nx;
    const int r0 = blockIdx.y * TY;
    const int c0 = blockIdx.x * TX;
    const int tx = threadIdx.x;
    const int tid = threadIdx.y * TX + tx;

    // The x stage: loads first, stores once everything is in flight.
    float xv[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
        const int k = tid + i * NT;
        const int ly = k / SX;
        const int gr = r0 - H + ly;
        const int gc = c0 - H + (k - ly * SX);
        float v = 0.0f;   // outside the grid: never relaxed, never read
        if (k < SY * SX && gr >= 0 && gr < ny && gc >= 0 && gc < nx) {
            v = x[(long long)gr * nx + gc];
            if (MODE == MODE_PROLONG)
                v += x_coarse[(long long)(gr >> 1) * nxc + (gc >> 1)];
        }
        xv[i] = v;
    }

    // The pairs' coefficients, loaded row by row (coalesced), then ordered
    // by colour: c0v is the colour-0 cell's, c1v the colour-1 cell's.
    const int gc = c0 + tx;
    const bool odd = (tx & 1) != 0;
    Coef c0v[NP], c1v[NP];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
        const int ra = r0 + 2 * (threadIdx.y + p * PR);
        const long long g = (long long)ra * nx + gc;
        const Coef ca = load_coef(diag, off, b, n_cells, g,
                                  ra < ny && gc < nx);
        const Coef cb = load_coef(diag, off, b, n_cells, g + nx,
                                  ra + 1 < ny && gc < nx);
        c0v[p] = odd ? cb : ca;
        c1v[p] = odd ? ca : cb;
    }

    // The ring cells of this thread: position, and coefficients where the
    // cell is relaxed at all (colour 0 anywhere in the ring, colour 1 only
    // in its inner R - 1 cells).
    Coef cr[NR];
    int ring_k[NR], ring_r[NR], ring_c[NR];
    bool ring_on[NR];
#pragma unroll
    for (int j = 0; j < NR; ++j) {
        const int k = tid + j * NT;
        int ly, lx;   // in the tile + R frame
        if (k < RTOP) {
            ly = k / RW;
            lx = k - ly * RW;
        } else if (k < 2 * RTOP) {
            const int k2 = k - RTOP;
            ly = k2 / RW;
            lx = k2 - ly * RW;
            ly += TY + R;
        } else {
            const int k2 = k - 2 * RTOP;
            const int rr = k2 / (2 * R);
            const int jj = k2 - rr * (2 * R);
            ly = R + rr;
            lx = jj < R ? jj : TX + jj;
        }
        const int gr = r0 - R + ly;
        const int gcr = c0 - R + lx;
        const bool inner = ly >= 1 && ly < TY + 2 * R - 1 && lx >= 1
            && lx < RW - 1;
        const bool colour1 = ((gr + gcr) & 1) != 0;
        ring_on[j] = k < NRING && gr >= 0 && gr < ny && gcr >= 0 && gcr < nx
            && (!colour1 || (R > 1 && inner));
        ring_k[j] = (ly + 1) * SX + lx + 1;
        ring_r[j] = gr;
        ring_c[j] = gcr;
        cr[j] = load_coef(diag, off, b, n_cells, (long long)gr * nx + gcr,
                          ring_on[j]);
    }

#pragma unroll
    for (int i = 0; i < NS; ++i) {
        const int k = tid + i * NT;
        if (k < SY * SX) s_x[k] = xv[i];
    }
    __syncthreads();

    // Two coloured half-sweeps in place.  A cell of the active colour reads
    // only cells of the other colour (and itself at a clamped edge), so no
    // two threads touch the same value within one half-sweep.
#pragma unroll
    for (int colour = 0; colour < 2; ++colour) {
#pragma unroll
        for (int p = 0; p < NP; ++p) {
            const int lr = 2 * (threadIdx.y + p * PR)
                + ((colour == 1) != odd ? 1 : 0);
            const int gr = r0 + lr;
            if (gr < ny && gc < nx)
                relax_at<SX>(s_x, (lr + H) * SX + tx + H, gr, gc, ny, nx,
                             colour == 0 ? c0v[p] : c1v[p]);
        }
#pragma unroll
        for (int j = 0; j < NR; ++j) {
            if (ring_on[j] && ((ring_r[j] + ring_c[j]) & 1) == colour)
                relax_at<SX>(s_x, ring_k[j], ring_r[j], ring_c[j], ny, nx,
                             cr[j]);
        }
        __syncthreads();
    }

    // Write the tile (and its residual, or the residual's 2x2 block sums).
#pragma unroll
    for (int p = 0; p < NP; ++p) {
        const int la = 2 * (threadIdx.y + p * PR);
        const int ra = r0 + la;
        const int ka = (la + H) * SX + tx + H;
        const bool in_a = ra < ny && gc < nx;
        const bool in_b = ra + 1 < ny && gc < nx;
        const long long g = (long long)ra * nx + gc;
        const float xa = s_x[ka];
        const float xb = s_x[ka + SX];
        if (in_a) x_out[g] = xa;
        if (in_b) x_out[g + nx] = xb;
        if (RESID) {
            const Coef ca = odd ? c1v[p] : c0v[p];
            const Coef cb = odd ? c0v[p] : c1v[p];
            float res_a = 0.0f, res_b = 0.0f;
            if (in_a)
                res_a = residual(ca.b, ca.d, xa, sigma_at<SX>(
                    s_x, ka, ra, gc, ny, nx, ca, xa));
            if (in_b)
                res_b = residual(cb.b, cb.d, xb, sigma_at<SX>(
                    s_x, ka + SX, ra + 1, gc, ny, nx, cb, xb));
            if (MODE == MODE_RESIDUAL) {
                if (in_a) r_out[g] = res_a;
                if (in_b) r_out[g + nx] = res_b;
            } else {
                // Cells outside the grid add zero, as the zero padding of
                // restrict2 does, in the order of XLA's reduce_window:
                // ((r00 + r10) + r01) + r11.
                const float r01 = __shfl_xor_sync(0xffffffffu, res_a, 1);
                const float r11 = __shfl_xor_sync(0xffffffffu, res_b, 1);
                const float sum = ((res_a + res_b) + r01) + r11;
                if (!odd && in_a)
                    r_out[(long long)(ra >> 1) * nxc + (gc >> 1)] = sum;
            }
        }
    }
}

template <int TX, int PR, int NP>
cudaError_t launch_leg(const float* x, const float* diag, const float* off,
                       const float* b, const float* x_coarse, float* x_out,
                       float* r_out, int ny, int nx, int mode,
                       cudaStream_t stream) {
    constexpr int TY = 2 * PR * NP;
    const dim3 block(TX, PR);
    const dim3 grid((nx + TX - 1) / TX, (ny + TY - 1) / TY);
    const int nxc = (nx + 1) / 2;
    switch (mode) {
        case MODE_SMOOTH:
            rbgs_leg_kernel<TX, PR, NP, MODE_SMOOTH><<<grid, block, 0, stream>>>(
                x, diag, off, b, x_coarse, x_out, r_out, ny, nx, nxc);
            break;
        case MODE_RESIDUAL:
            rbgs_leg_kernel<TX, PR, NP, MODE_RESIDUAL><<<grid, block, 0, stream>>>(
                x, diag, off, b, x_coarse, x_out, r_out, ny, nx, nxc);
            break;
        case MODE_RESTRICT:
            rbgs_leg_kernel<TX, PR, NP, MODE_RESTRICT><<<grid, block, 0, stream>>>(
                x, diag, off, b, x_coarse, x_out, r_out, ny, nx, nxc);
            break;
        case MODE_PROLONG:
            rbgs_leg_kernel<TX, PR, NP, MODE_PROLONG><<<grid, block, 0, stream>>>(
                x, diag, off, b, x_coarse, x_out, r_out, ny, nx, nxc);
            break;
        default:
            return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
}

// Blocks of ty x tx cells that cover the grid.
int tile_blocks(int ty, int tx, int ny, int nx) {
    return ((ny + ty - 1) / ty) * ((nx + tx - 1) / tx);
}

// A grid gets the largest tile that still gives each SM this many blocks.
constexpr int MIN_BLOCKS = 4 * 132;

// ---------------------------------------------------------------------
// rbgs_leg, sweeps > 1: every plane staged around a 32x32 tile.

constexpr int TILE_Y = 32;
constexpr int TILE_X = 32;
constexpr int THREADS_X = 32;
constexpr int THREADS_Y = 8;
constexpr int PLANES = 7;   // x, diag, oE, oW, oN, oS, b

__global__ void __launch_bounds__(THREADS_X * THREADS_Y)
rbgs_leg_staged_kernel(const float* __restrict__ x,
                       const float* __restrict__ diag,
                       const float* __restrict__ off,
                       const float* __restrict__ b,
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

    // Coloured half-sweeps in place.
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
            const float sigma = stencil_sigma(s_e[k], xe, s_w[k], xw,
                                              s_n[k], xn, s_s[k], xs);
            s_x[k] = relaxed(s_d[k], s_b[k], sigma);
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
            const float sigma = stencil_sigma(s_e[s], xe, s_w[s], xw,
                                              s_n[s], xn, s_s[s], xs);
            r_out[g] = residual(s_b[s], s_d[s], xc, sigma);
        }
    }
}

// ---------------------------------------------------------------------

constexpr int HS_X = 128;  // columns per half-sweep block (four warps)
constexpr int HS_Y = 2;    // rows per half-sweep block

// IN_PLACE: x_out is x, and the other colour is left as it is.
template <bool IN_PLACE>
__device__ __forceinline__ float load_x(const float* p) {
    if constexpr (IN_PLACE) return *p;
    else return __ldg(p);
}

template <bool IN_PLACE>
__global__ void __launch_bounds__(HS_X * HS_Y)
rbgs_half_sweep_kernel(const float* x, const float* __restrict__ diag,
                       const float* __restrict__ off,
                       const float* __restrict__ b, float* x_out, int ny,
                       int nx, int parity) {
    const int gc = blockIdx.x * HS_X + threadIdx.x;
    const int gr = blockIdx.y * HS_Y + threadIdx.y;
    if (gr >= ny || gc >= nx) return;
    const long long n_cells = (long long)ny * nx;
    const long long g = (long long)gr * nx + gc;
    const float xc = load_x<IN_PLACE>(x + g);
    if (((gr + gc + parity) & 1) != 0) {
        if (!IN_PLACE) x_out[g] = xc;   // the other colour is copied through
        return;
    }
    const float xe = gc == nx - 1 ? xc : load_x<IN_PLACE>(x + g + 1);
    const float xw = gc == 0 ? xc : load_x<IN_PLACE>(x + g - 1);
    const float xn = gr == ny - 1 ? xc : load_x<IN_PLACE>(x + g + nx);
    const float xs = gr == 0 ? xc : load_x<IN_PLACE>(x + g - nx);
    const float sigma = stencil_sigma(
        __ldg(off + g), xe, __ldg(off + n_cells + g), xw,
        __ldg(off + 2 * n_cells + g), xn, __ldg(off + 3 * n_cells + g), xs);
    x_out[g] = relaxed(__ldg(diag + g), __ldg(b + g), sigma);
}

// ---------------------------------------------------------------------
// rbgs_residual: the 2x2 block sums of b - A x.

constexpr int RR_X = 64;   // fine columns per block (two warps)
constexpr int RR_Y = 4;    // pairs of fine rows per block

// b - A x at fine cell (gr, gc), xc its x, xn / xs its north and south x
// (the caller's, which already holds them); zero beyond the fine grid.
__device__ __forceinline__ float cell_residual(
        const float* __restrict__ x, const float* __restrict__ diag,
        const float* __restrict__ off, const float* __restrict__ b,
        long long n_cells, long long g, int gc, int nx, float xc, float xn,
        float xs) {
    const float xe = gc == nx - 1 ? xc : __ldg(x + g + 1);
    const float xw = gc == 0 ? xc : __ldg(x + g - 1);
    const float sigma = stencil_sigma(
        __ldg(off + g), xe, __ldg(off + n_cells + g), xw,
        __ldg(off + 2 * n_cells + g), xn, __ldg(off + 3 * n_cells + g), xs);
    return residual(__ldg(b + g), __ldg(diag + g), xc, sigma);
}

// Thread (tx, ty) takes fine column c0 + tx of the row pair 2 * (r0 + ty),
// +1: a warp's loads cover 32 adjacent columns of one row.  The pair's sum
// meets its neighbour column's through two shuffles (c0 is even, so lanes
// 2k and 2k + 1 hold one coarse cell), as the leg kernel's MODE_RESTRICT.
__global__ void __launch_bounds__(RR_X * RR_Y)
rbgs_residual_kernel(const float* __restrict__ x,
                     const float* __restrict__ diag,
                     const float* __restrict__ off,
                     const float* __restrict__ b, float* __restrict__ r_out,
                     int ny, int nx, int nyc, int nxc) {
    const int gc = blockIdx.x * RR_X + threadIdx.x;
    const int cr = blockIdx.y * RR_Y + threadIdx.y;
    const int ra = 2 * cr;
    const long long n_cells = (long long)ny * nx;
    const bool in_a = cr < nyc && ra < ny && gc < nx;
    const bool in_b = cr < nyc && ra + 1 < ny && gc < nx;
    const long long g = (long long)ra * nx + gc;
    float res_a = 0.0f, res_b = 0.0f;
    if (in_a) {
        const float xa = __ldg(x + g);
        const float xb = in_b ? __ldg(x + g + nx) : xa;
        const float xs = ra == 0 ? xa : __ldg(x + g - nx);
        // Row ra + 1 lies in the grid iff in_b; beyond it the north
        // neighbour of row ra is itself (the clamped edge).
        res_a = cell_residual(x, diag, off, b, n_cells, g, gc, nx, xa, xb,
                              xs);
        if (in_b) {
            const float xn = ra + 2 >= ny ? xb : __ldg(x + g + 2 * nx);
            res_b = cell_residual(x, diag, off, b, n_cells, g + nx, gc, nx,
                                  xb, xn, xa);
        }
    }
    // Cells outside the grid add zero, as restrict2's zero padding does, in
    // the order of XLA's reduce_window: ((r00 + r10) + r01) + r11.
    const float r01 = __shfl_xor_sync(0xffffffffu, res_a, 1);
    const float r11 = __shfl_xor_sync(0xffffffffu, res_b, 1);
    const int cc = gc >> 1;
    if ((gc & 1) == 0 && cr < nyc && cc < nxc)
        r_out[(long long)cr * nxc + cc] =
            __fadd_rn(__fadd_rn(__fadd_rn(res_a, res_b), r01), r11);
}

}  // namespace

extern "C" {

// x, diag, b, x_out: (ny, nx) float32; off: (4, ny, nx) float32 planes
// [E, W, N, S].  mode (see MODE_* above):
//   0  x_out = smoothed x;
//   1  also r_out (ny, nx) = b - A x_out;
//   2  also r_out ((ny+1)/2, (nx+1)/2) = 2x2 block sums of b - A x_out;
//   3  x_out = smoothed (x + x_coarse[row/2, col/2]), x_coarse of the shape
//      of mode 2's r_out.
// Modes 2 and 3 need sweeps == 1.  Returns a cudaError_t.
int rbgs_leg(const float* x, const float* diag, const float* off,
             const float* b, const float* x_coarse, float* x_out,
             float* r_out, int ny, int nx, int sweeps, int mode,
             void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    if (mode < 0 || mode > 3 || sweeps < 1
        || (mode >= MODE_RESTRICT && sweeps != 1))
        return (int)cudaErrorInvalidValue;
    if (sweeps == 1) {
        // Tiles of 16 x 64 cells (256 threads), 16 x 32 (128) or 4 x 32 (64):
        // big tiles re-read the least halo, small ones keep the coarse
        // levels from running on a handful of SMs and hide the latency of
        // their few loads behind one another.  Of the 589x1765 hierarchy the
        // finest grid takes the first, 295x883 the second, the rest the
        // third (74x221 still gives 133 blocks).  Tiles of 32 x 64 and
        // 16 x 128 were tried too: no faster than 16 x 64 at 589x1765,
        // slower in the form that adds the prolongation, and taken out.
        if (tile_blocks(16, 64, ny, nx) >= MIN_BLOCKS)
            return (int)launch_leg<64, 4, 2>(
                x, diag, off, b, x_coarse, x_out, r_out, ny, nx, mode, st);
        if (tile_blocks(16, 32, ny, nx) >= MIN_BLOCKS)
            return (int)launch_leg<32, 4, 2>(
                x, diag, off, b, x_coarse, x_out, r_out, ny, nx, mode, st);
        return (int)launch_leg<32, 2, 1>(
            x, diag, off, b, x_coarse, x_out, r_out, ny, nx, mode, st);
    }
    const int halo = 2 * sweeps + 1;
    const size_t smem = (size_t)PLANES * (TILE_Y + 2 * halo)
        * (TILE_X + 2 * halo) * sizeof(float);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            rbgs_leg_staged_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const dim3 block(THREADS_X, THREADS_Y);
    const dim3 grid((nx + TILE_X - 1) / TILE_X, (ny + TILE_Y - 1) / TILE_Y);
    rbgs_leg_staged_kernel<<<grid, block, smem, st>>>(
        x, diag, off, b, x_out, mode == MODE_RESIDUAL ? r_out : nullptr,
        ny, nx, sweeps, halo);
    return (int)cudaGetLastError();
}

// x, diag, b, x_out: (ny, nx) float32; off: (4, ny, nx) float32 planes
// [E, W, N, S].  Relaxes the cells with (row + col + parity) % 2 == 0 into
// x_out and copies the others; with x_out == x it updates x in place and
// leaves the others as they are.  Returns a cudaError_t.
int rbgs_half_sweep(const float* x, const float* diag, const float* off,
                    const float* b, float* x_out, int ny, int nx, int parity,
                    void* stream) {
    if (ny < 1 || nx < 1) return (int)cudaErrorInvalidValue;
    const dim3 block(HS_X, HS_Y);
    const dim3 grid((nx + HS_X - 1) / HS_X, (ny + HS_Y - 1) / HS_Y);
    const cudaStream_t st = (cudaStream_t)stream;
    if (x_out == x)
        rbgs_half_sweep_kernel<true><<<grid, block, 0, st>>>(
            x, diag, off, b, x_out, ny, nx, parity);
    else
        rbgs_half_sweep_kernel<false><<<grid, block, 0, st>>>(
            x, diag, off, b, x_out, ny, nx, parity);
    return (int)cudaGetLastError();
}

// x, diag, b: (ny, nx) float32; off: (4, ny, nx) float32 planes [E, W, N,
// S]; r_out: (nyc, nxc) float32, the 2x2 block sums of b - A x over the fine
// cells (2i + a, 2j + c) that lie in the grid (restrict2: nyc = (ny+1)/2
// zero-pads an odd grid, a smaller nyc crops it).  Returns a cudaError_t.
int rbgs_residual(const float* x, const float* diag, const float* off,
                  const float* b, float* r_out, int ny, int nx, int nyc,
                  int nxc, void* stream) {
    if (ny < 1 || nx < 1 || nyc < 1 || nxc < 1 || nyc > (ny + 1) / 2
        || nxc > (nx + 1) / 2)
        return (int)cudaErrorInvalidValue;
    const dim3 block(RR_X, RR_Y);
    const dim3 grid((2 * nxc + RR_X - 1) / RR_X, (nyc + RR_Y - 1) / RR_Y);
    rbgs_residual_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        x, diag, off, b, r_out, ny, nx, nyc, nxc);
    return (int)cudaGetLastError();
}

// Human-readable text of a cudaError_t returned above.
const char* rbgs_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
