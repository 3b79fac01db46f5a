// The structured coupled system's stencils, for Hopper (sm_90a).
//
// The JAX package leaves these to XLA, which fuses each edge-clamped shift
// (cfd2_tpu/ops/stencil_system.py:_shifts2) and its multiply-adds into a few
// fusions per operator inside the jitted step; no Pallas kernel replaces
// them.  Run as eager PyTorch they cost the port one launch per shift
// (torch.cat) and per elementwise op, some 450 per FGMRES iteration.  Each
// kernel here is one operator of cfd2_tpu_torch/ops/stencil_system.py:
//   * coupled_spmv      <- spmv_planar (JAX stencil_system.py:196): y = A x
//                          of the coupled (u, v, p) 5-point operator, 6
//                          off-diagonal blocks of 4 slots and 6 diagonals;
//   * momentum_jacobi   <- the Jacobi branch of _momentum_solve (JAX :213):
//                          z = D^-1 r, then sweeps - 1 sweeps
//                          z <- D^-1 (r - sum_s off_mom[s] * shift_s(z))
//                          for u and v;
//   * schur_rhs         <- _schur_rhs (JAX :337-338): r_p - D_u z_u - D_v z_v;
//   * pressure_gradient <- _gradient (JAX :345-347): G z_p for the u and v
//                          rows.
//
// Exactness.  Each kernel is bit-equal to its plain version, which runs one
// PyTorch op per product and per sum: every product and every sum is rounded
// on its own (__fmul_rn / __fadd_rn / __fsub_rn, never contracted into a
// fused multiply-add), in the plain code's order: _dot4's
// ((o0*s0 + o1*s1) + o2*s2) + o3*s3, then the terms of each line from left
// to right.  A neighbour is multiplied by its coefficient even where the
// coefficient is 0 (as the shifted planes are), so NaN, inf and signed
// zeros come out as they do there.  Slots are [E, W, N, S]: E reads column
// + 1, W column - 1, N row + 1, S row - 1, each clamped to the cell itself
// at the grid's edges.  On a row-sharded system the rows beyond the block
// come from the neighbouring ranks as two explicit halo rows (below, above;
// the exchange stays with the caller): the S neighbour of the block's first
// row is below[col], the N neighbour of its last row above[col].
//
// What bounds them on this card: bytes.  Each cell of coupled_spmv reads 33
// coefficient values and 3 x values and writes 3 values against 67 flops;
// at 589x1765 that is 36 planes, 149.7 MB, 44.7 us at 3.35 TB/s.  Only x
// (z, z_p) is read at neighbouring cells.  What the design does about it:
//   * one thread per cell of a 128 x 2 block (the half-sweep's shape in
//     csrc/rbgs.cu): a warp's loads and stores cover 32 adjacent cells of
//     one row, and there is no division by a run-time width;
//   * the coefficients are read once, straight into registers, and the
//     neighbour values through the read-only path (__ldg): a row's
//     neighbours are the next warps' own loads, so they come from L1/L2;
//   * no intermediate reaches device memory: the shifted planes, the
//     products and the partial sums of the eager version stay in registers;
//   * the momentum predict (an iterate is read at neighbours, so a sweep
//     needs the previous one around it) runs all its sweeps, up to 12 (the
//     solver's 8, and 12 from 1.5M cells), in one launch of temporal tiles:
//     a block keeps the seed and the iterates of its 32 x 32 tile plus a
//     halo of one cell per later sweep (46 x 46 at 8 sweeps) in shared
//     memory and recomputes the halo's cells that its neighbours own, about
//     twice the cell-updates for one pass over the coefficients instead of
//     one per sweep.  A row-sharded system, where each sweep waits for the
//     neighbouring ranks' rows of the previous iterate, and more sweeps
//     than a tile runs take one launch per sweep (the seed, then the
//     sweeps; the caller loops).  PERF.md has the times of both, and of a
//     first design that made the seed inside the first of 7 launches.
//
// All functions have a plain C interface (loaded with ctypes), launch on the
// caller's stream, allocate nothing, and return cudaGetLastError() after
// each launch so that the caller can raise on a refused launch.

#include <cuda_runtime.h>

namespace {

constexpr int BX = 128;   // columns per block (four warps)
constexpr int BY = 2;     // rows per block

// A cell's value and its four edge-clamped neighbours in one plane.
struct Nbr {
    float c, e, w, n, s;
};

// x: one (ny, nx) plane; below, above: that plane's halo rows (nx values)
// or null, where the block's own edge row stands in (the unsharded clamp).
__device__ __forceinline__ Nbr load_nbr(
        const float* __restrict__ x, const float* __restrict__ below,
        const float* __restrict__ above, int gr, int gc, int ny, int nx,
        long long g) {
    Nbr v;
    v.c = __ldg(x + g);
    v.e = gc == nx - 1 ? v.c : __ldg(x + g + 1);
    v.w = gc == 0 ? v.c : __ldg(x + g - 1);
    if (gr == ny - 1)
        v.n = above != nullptr ? __ldg(above + gc) : v.c;
    else
        v.n = __ldg(x + g + nx);
    if (gr == 0)
        v.s = below != nullptr ? __ldg(below + gc) : v.c;
    else
        v.s = __ldg(x + g - nx);
    return v;
}

// One cell's 4 slot coefficients of a (4, ny, nx) block.
struct Off4 {
    float e, w, n, s;
};

__device__ __forceinline__ Off4 load_off(const float* __restrict__ off,
                                         long long n_cells, long long g) {
    Off4 o;
    o.e = __ldg(off + g);
    o.w = __ldg(off + n_cells + g);
    o.n = __ldg(off + 2 * n_cells + g);
    o.s = __ldg(off + 3 * n_cells + g);
    return o;
}

// _dot4: ((oE*xE + oW*xW) + oN*xN) + oS*xS, each step rounded.
__device__ __forceinline__ float dot4(const Off4& o, const Nbr& v) {
    float acc = __fadd_rn(__fmul_rn(o.e, v.e), __fmul_rn(o.w, v.w));
    acc = __fadd_rn(acc, __fmul_rn(o.n, v.n));
    return __fadd_rn(acc, __fmul_rn(o.s, v.s));
}

// ---------------------------------------------------------------------
// coupled_spmv

struct SpmvArgs {
    const float* x;        // (3, ny, nx)
    const float* off_mom;  // (4, ny, nx) each
    const float* off_up;
    const float* off_vp;
    const float* off_pu;
    const float* off_pv;
    const float* off_pp;
    const float* d_u;      // (ny, nx) each
    const float* d_up;
    const float* d_vp;
    const float* d_pu;
    const float* d_pv;
    const float* d_pp;
    const float* below;    // (3, 1, nx) or null
    const float* above;
    float* y;              // (3, ny, nx)
    int ny, nx;
};

__global__ void __launch_bounds__(BX * BY) coupled_spmv_kernel(SpmvArgs a) {
    const int gc = blockIdx.x * BX + threadIdx.x;
    const int gr = blockIdx.y * BY + threadIdx.y;
    if (gr >= a.ny || gc >= a.nx) return;
    const long long n = (long long)a.ny * a.nx;
    const long long g = (long long)gr * a.nx + gc;
    const bool halo = a.below != nullptr;
    const Nbr su = load_nbr(a.x, halo ? a.below : nullptr,
                            halo ? a.above : nullptr, gr, gc, a.ny, a.nx, g);
    const Nbr sv = load_nbr(a.x + n, halo ? a.below + a.nx : nullptr,
                            halo ? a.above + a.nx : nullptr, gr, gc, a.ny,
                            a.nx, g);
    const Nbr sp = load_nbr(a.x + 2 * n, halo ? a.below + 2 * a.nx : nullptr,
                            halo ? a.above + 2 * a.nx : nullptr, gr, gc, a.ny,
                            a.nx, g);
    const Off4 mom = load_off(a.off_mom, n, g);
    const Off4 up = load_off(a.off_up, n, g);
    const Off4 vp = load_off(a.off_vp, n, g);
    const Off4 pu = load_off(a.off_pu, n, g);
    const Off4 pv = load_off(a.off_pv, n, g);
    const Off4 pp = load_off(a.off_pp, n, g);
    const float du = __ldg(a.d_u + g);
    // yu = diag_u xu + diag_up xp + <off_mom, su> + <off_up, sp>
    float yu = __fadd_rn(__fmul_rn(du, su.c),
                         __fmul_rn(__ldg(a.d_up + g), sp.c));
    yu = __fadd_rn(yu, dot4(mom, su));
    yu = __fadd_rn(yu, dot4(up, sp));
    // yv = diag_u xv + diag_vp xp + <off_mom, sv> + <off_vp, sp>
    float yv = __fadd_rn(__fmul_rn(du, sv.c),
                         __fmul_rn(__ldg(a.d_vp + g), sp.c));
    yv = __fadd_rn(yv, dot4(mom, sv));
    yv = __fadd_rn(yv, dot4(vp, sp));
    // yp = diag_pu xu + diag_pv xv + diag_pp xp + <off_pu, su> + <off_pv, sv>
    //      + <off_pp, sp>
    float yp = __fadd_rn(__fmul_rn(__ldg(a.d_pu + g), su.c),
                         __fmul_rn(__ldg(a.d_pv + g), sv.c));
    yp = __fadd_rn(yp, __fmul_rn(__ldg(a.d_pp + g), sp.c));
    yp = __fadd_rn(yp, dot4(pu, su));
    yp = __fadd_rn(yp, dot4(pv, sv));
    yp = __fadd_rn(yp, dot4(pp, sp));
    a.y[g] = yu;
    a.y[n + g] = yv;
    a.y[2 * n + g] = yp;
}

// ---------------------------------------------------------------------
// momentum_jacobi

constexpr int FROM_NONE = 0;   // z = D^-1 r (the seed)
constexpr int FROM_Z = 1;      // one sweep from the iterate z

struct MomArgs {
    const float* r;        // (2, ny, nx): r_u, r_v
    const float* dinv;     // (ny, nx): diag_u_inv2
    const float* off;      // (4, ny, nx): off_mom
    const float* z;        // (2, ny, nx): the iterate (FROM_Z)
    const float* below;    // (2, 1, nx) halo rows of z, or null
    const float* above;
    float* out;            // (2, ny, nx)
    int ny, nx;
};

template <int FROM>
__global__ void __launch_bounds__(BX * BY) momentum_kernel(MomArgs a) {
    const int gc = blockIdx.x * BX + threadIdx.x;
    const int gr = blockIdx.y * BY + threadIdx.y;
    if (gr >= a.ny || gc >= a.nx) return;
    const long long n = (long long)a.ny * a.nx;
    const long long g = (long long)gr * a.nx + gc;
    const float di = __ldg(a.dinv + g);
    Off4 o = {0.0f, 0.0f, 0.0f, 0.0f};
    if (FROM != FROM_NONE) o = load_off(a.off, n, g);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
        const float* rc = a.r + c * n;
        float z;
        if (FROM == FROM_NONE) {
            z = __fmul_rn(di, __ldg(rc + g));
        } else {
            const bool halo = a.below != nullptr;
            const Nbr v = load_nbr(
                a.z + c * n, halo ? a.below + c * a.nx : nullptr,
                halo ? a.above + c * a.nx : nullptr, gr, gc, a.ny, a.nx, g);
            z = __fmul_rn(di, __fsub_rn(__ldg(rc + g), dot4(o, v)));
        }
        a.out[c * n + g] = z;
    }
}

template <int FROM>
cudaError_t launch_momentum(const MomArgs& a, cudaStream_t st) {
    const dim3 block(BX, BY);
    const dim3 grid((a.nx + BX - 1) / BX, (a.ny + BY - 1) / BY);
    momentum_kernel<FROM><<<grid, block, 0, st>>>(a);
    return cudaGetLastError();
}


// The whole predict of an unsharded grid in one launch: temporal tiles.
// A block owns a TILE x TILE tile of the result and runs every sweep on the
// tile plus a halo of (sweeps - 1) cells, whose iterates it recomputes
// rather than reads from its neighbours: sweep k is valid on the region
// shrunk by k from the halo's outer edge (a region clipped at the grid's
// edges keeps its edge rows and columns, where the neighbour is the cell
// itself).  The seed and the iterates of both components live in shared
// memory, two buffers of the halo region; the coefficients are read
// through L1/L2 at each sweep.  The same operations in the same order as
// one launch per sweep: the bits are the same.
constexpr int TILE = 32;
constexpr int TILE_THREADS = 256;
constexpr int TILE_MAX_SWEEPS = 12;   // the solver's 8, and 12 from 1.5M cells

__global__ void __launch_bounds__(TILE_THREADS)
momentum_tiled_kernel(MomArgs a, int sweeps) {
    extern __shared__ float sm[];
    const int h = sweeps - 1;                 // halo: one cell per sweep
    const int ex = TILE + 2 * h;              // the halo region's width
    const int e = ex * ex;
    const int r0 = blockIdx.y * TILE, c0 = blockIdx.x * TILE;
    const int er0 = r0 - h, ec0 = c0 - h;     // its origin (may lie outside)
    const int ny = a.ny, nx = a.nx;
    const long long n = (long long)ny * nx;
    float* zin = sm;                          // [2 components][e]
    float* zout = sm + 2 * e;
    // The seed on the region's cells that lie in the grid.
    {
        const int rlo = max(0, er0), rhi = min(ny, r0 + TILE + h);
        const int clo = max(0, ec0), chi = min(nx, c0 + TILE + h);
        const int rw = chi - clo, cells = rw * (rhi - rlo);
        for (int i = threadIdx.x; i < cells; i += TILE_THREADS) {
            const int yy = i / rw;
            const int gr = rlo + yy, gc = clo + (i - yy * rw);
            const int li = (gr - er0) * ex + (gc - ec0);
            const long long g = (long long)gr * nx + gc;
            const float di = __ldg(a.dinv + g);
            zin[li] = __fmul_rn(di, __ldg(a.r + g));
            zin[e + li] = __fmul_rn(di, __ldg(a.r + n + g));
        }
    }
    __syncthreads();
    for (int k = 1; k < sweeps; ++k) {
        const bool last = k == sweeps - 1;
        const int rlo = max(0, er0 + k), rhi = min(ny, r0 + TILE + h - k);
        const int clo = max(0, ec0 + k), chi = min(nx, c0 + TILE + h - k);
        const int rw = chi - clo, cells = rw * (rhi - rlo);
        for (int i = threadIdx.x; i < cells; i += TILE_THREADS) {
            const int yy = i / rw;
            const int gr = rlo + yy, gc = clo + (i - yy * rw);
            const int li = (gr - er0) * ex + (gc - ec0);
            const int le = gc == nx - 1 ? li : li + 1;
            const int lw = gc == 0 ? li : li - 1;
            const int ln = gr == ny - 1 ? li : li + ex;
            const int ls = gr == 0 ? li : li - ex;
            const long long g = (long long)gr * nx + gc;
            const Off4 o = load_off(a.off, n, g);
            const float di = __ldg(a.dinv + g);
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                const float* zc = zin + c * e;
                const Nbr v = {zc[li], zc[le], zc[lw], zc[ln], zc[ls]};
                const float z = __fmul_rn(
                    di, __fsub_rn(__ldg(a.r + c * n + g), dot4(o, v)));
                if (last)
                    a.out[c * n + g] = z;
                else
                    zout[c * e + li] = z;
            }
        }
        __syncthreads();
        float* t = zin;
        zin = zout;
        zout = t;
    }
}

// Two buffers of both components of the halo region: 33,856 bytes at 8
// sweeps, 46,656 at 12, under the 48 KB a launch takes without opting in.
constexpr int tile_smem(int sweeps) {
    return 4 * (TILE + 2 * (sweeps - 1)) * (TILE + 2 * (sweeps - 1))
        * (int)sizeof(float);
}
static_assert(tile_smem(TILE_MAX_SWEEPS) <= 48 * 1024,
              "the temporal tiles' shared memory needs no opt-in");

cudaError_t launch_tiled(const MomArgs& a, int sweeps, cudaStream_t st) {
    const size_t smem = (size_t)tile_smem(sweeps);
    const dim3 grid((a.nx + TILE - 1) / TILE, (a.ny + TILE - 1) / TILE);
    momentum_tiled_kernel<<<grid, TILE_THREADS, smem, st>>>(a, sweeps);
    return cudaGetLastError();
}

// ---------------------------------------------------------------------
// schur_rhs

__global__ void __launch_bounds__(BX * BY) schur_rhs_kernel(
        const float* __restrict__ rp, const float* __restrict__ z,
        const float* __restrict__ d_pu, const float* __restrict__ d_pv,
        const float* __restrict__ off_pu, const float* __restrict__ off_pv,
        const float* __restrict__ below, const float* __restrict__ above,
        float* __restrict__ out, int ny, int nx) {
    const int gc = blockIdx.x * BX + threadIdx.x;
    const int gr = blockIdx.y * BY + threadIdx.y;
    if (gr >= ny || gc >= nx) return;
    const long long n = (long long)ny * nx;
    const long long g = (long long)gr * nx + gc;
    const bool halo = below != nullptr;
    const Nbr su = load_nbr(z, halo ? below : nullptr, halo ? above : nullptr,
                            gr, gc, ny, nx, g);
    const Nbr sv = load_nbr(z + n, halo ? below + nx : nullptr,
                            halo ? above + nx : nullptr, gr, gc, ny, nx, g);
    // r_p - diag_pu z_u - diag_pv z_v - <off_pu, su> - <off_pv, sv>
    float acc = __fsub_rn(__ldg(rp + g), __fmul_rn(__ldg(d_pu + g), su.c));
    acc = __fsub_rn(acc, __fmul_rn(__ldg(d_pv + g), sv.c));
    acc = __fsub_rn(acc, dot4(load_off(off_pu, n, g), su));
    out[g] = __fsub_rn(acc, dot4(load_off(off_pv, n, g), sv));
}

// ---------------------------------------------------------------------
// pressure_gradient

__global__ void __launch_bounds__(BX * BY) pressure_gradient_kernel(
        const float* __restrict__ zp, const float* __restrict__ d_up,
        const float* __restrict__ d_vp, const float* __restrict__ off_up,
        const float* __restrict__ off_vp, const float* __restrict__ below,
        const float* __restrict__ above, float* __restrict__ out, int ny,
        int nx) {
    const int gc = blockIdx.x * BX + threadIdx.x;
    const int gr = blockIdx.y * BY + threadIdx.y;
    if (gr >= ny || gc >= nx) return;
    const long long n = (long long)ny * nx;
    const long long g = (long long)gr * nx + gc;
    const Nbr sp = load_nbr(zp, below, above, gr, gc, ny, nx, g);
    // (diag_up z_p + <off_up, sp>, diag_vp z_p + <off_vp, sp>)
    out[g] = __fadd_rn(__fmul_rn(__ldg(d_up + g), sp.c),
                       dot4(load_off(off_up, n, g), sp));
    out[n + g] = __fadd_rn(__fmul_rn(__ldg(d_vp + g), sp.c),
                           dot4(load_off(off_vp, n, g), sp));
}

dim3 grid_of(int ny, int nx) {
    return dim3((nx + BX - 1) / BX, (ny + BY - 1) / BY);
}

}  // namespace

extern "C" {

// x, y: (3, ny, nx) float32 planes (u, v, p); off_*: (4, ny, nx) float32
// [E, W, N, S]; d_*: (ny, nx) float32; below, above: (3, 1, nx) halo rows,
// both null on an unsharded grid.  y = A x.  Returns a cudaError_t.
int coupled_spmv(const float* x, const float* off_mom, const float* off_up,
                 const float* off_vp, const float* off_pu,
                 const float* off_pv, const float* off_pp, const float* d_u,
                 const float* d_up, const float* d_vp, const float* d_pu,
                 const float* d_pv, const float* d_pp, const float* below,
                 const float* above, float* y, int ny, int nx, void* stream) {
    if (ny < 1 || nx < 1 || (below == nullptr) != (above == nullptr))
        return (int)cudaErrorInvalidValue;
    const SpmvArgs a = {x, off_mom, off_up, off_vp, off_pu, off_pv, off_pp,
                        d_u, d_up, d_vp, d_pu, d_pv, d_pp, below, above, y,
                        ny, nx};
    coupled_spmv_kernel<<<grid_of(ny, nx), dim3(BX, BY), 0,
                          (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

// The momentum predict on an unsharded grid in one launch: 1 <= sweeps <=
// TILE_MAX_SWEEPS Jacobi sweeps from the seed D^-1 r (the seed alone, or
// the temporal tiles).  r: (2, ny, nx); dinv: (ny, nx); off: (4, ny, nx);
// out (2, ny, nx) = z.  More sweeps take momentum_sweep, one launch each.
// Returns a cudaError_t.
int momentum_jacobi(const float* r, const float* dinv, const float* off,
                    float* out, int ny, int nx, int sweeps, void* stream) {
    if (ny < 1 || nx < 1 || sweeps < 1 || sweeps > TILE_MAX_SWEEPS)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const MomArgs a = {r, dinv, off, nullptr, nullptr, nullptr, out, ny, nx};
    if (sweeps == 1) return (int)launch_momentum<FROM_NONE>(a, st);
    return (int)launch_tiled(a, sweeps, st);
}

// One launch of a predict run one sweep at a time (a row-sharded grid, or
// more than TILE_MAX_SWEEPS sweeps): with z null the seed (out = D^-1 r),
// else one sweep from the iterate z (2, ny, nx) with its halo rows below,
// above (2, 1, nx), or both null on an unsharded grid; out (2, ny, nx).
// Returns a cudaError_t.
int momentum_sweep(const float* r, const float* dinv, const float* off,
                   const float* z, const float* below, const float* above,
                   float* out, int ny, int nx, void* stream) {
    if (ny < 1 || nx < 1 || (below == nullptr) != (above == nullptr))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const MomArgs a = {r, dinv, off, z, below, above, out, ny, nx};
    return (int)(z == nullptr ? launch_momentum<FROM_NONE>(a, st)
                              : launch_momentum<FROM_Z>(a, st));
}

// rp, out: (ny, nx); z: (2, ny, nx) (z_u, z_v); d_pu, d_pv: (ny, nx);
// off_pu, off_pv: (4, ny, nx); below, above: (2, 1, nx) halo rows of z or
// both null.  out = r_p - D z.  Returns a cudaError_t.
int schur_rhs(const float* rp, const float* z, const float* d_pu,
              const float* d_pv, const float* off_pu, const float* off_pv,
              const float* below, const float* above, float* out, int ny,
              int nx, void* stream) {
    if (ny < 1 || nx < 1 || (below == nullptr) != (above == nullptr))
        return (int)cudaErrorInvalidValue;
    schur_rhs_kernel<<<grid_of(ny, nx), dim3(BX, BY), 0,
                       (cudaStream_t)stream>>>(
        rp, z, d_pu, d_pv, off_pu, off_pv, below, above, out, ny, nx);
    return (int)cudaGetLastError();
}

// zp: (ny, nx); d_up, d_vp: (ny, nx); off_up, off_vp: (4, ny, nx); below,
// above: (1, nx) halo rows of zp or both null; out: (2, ny, nx) = G z_p.
// Returns a cudaError_t.
int pressure_gradient(const float* zp, const float* d_up, const float* d_vp,
                      const float* off_up, const float* off_vp,
                      const float* below, const float* above, float* out,
                      int ny, int nx, void* stream) {
    if (ny < 1 || nx < 1 || (below == nullptr) != (above == nullptr))
        return (int)cudaErrorInvalidValue;
    pressure_gradient_kernel<<<grid_of(ny, nx), dim3(BX, BY), 0,
                               (cudaStream_t)stream>>>(
        zp, d_up, d_vp, off_up, off_vp, below, above, out, ny, nx);
    return (int)cudaGetLastError();
}

// The most sweeps momentum_jacobi runs in one launch (TILE_MAX_SWEEPS):
// ops/stencil_kernels.py checks its own constant against it at load.
int stencil_tile_max_sweeps() { return TILE_MAX_SWEEPS; }

// Human-readable text of a cudaError_t returned above.
const char* stencil_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
