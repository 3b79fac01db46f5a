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
//     solver's 8, and 12 from 1.5M cells), in one launch that streams each
//     band of columns down its rows with every sweep one row behind the one
//     before (below): each coefficient is read from device memory once per
//     block, and the cells of the halos, recomputed, add 57% at 8 sweeps on
//     589x1765 and 72% at 12 on 834x2500.  A row-sharded system, where each
//     sweep waits for the neighbouring ranks' rows of the previous iterate,
//     and more sweeps than a launch runs take one launch per sweep (the
//     seed, then the sweeps; the caller loops).  PERF.md has the times of
//     each design so far.
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


// The whole predict of an unsharded grid in one launch: temporal blocking
// streamed down the rows.  A block of MOM_THREADS threads owns a band of
// the grid's columns, one column per thread (a warp: 32 consecutive columns
// of a row), and walks down its rows one row per step.  At step t the seed
// takes row t and sweep k row t - k, so every sweep advances one row per
// step behind the one before it:
//   * a row's 7 coefficients (dinv, r_u, r_v, off E/W/N/S) are read from
//     device memory once per block and held in a ring of rows in each
//     thread's registers, where all S levels use them;
//   * each level keeps its last two rows of the column in registers (its S
//     and centre neighbours for the next level; the N neighbour is the row
//     the level below computed in this step), and publishes its row in
//     shared memory, where the neighbouring columns read their E and W
//     values in the next step (two buffers, one __syncthreads a step);
//   * a band carries a halo of S - 1 columns on either side and a block
//     starts S - 1 rows above its rows and ends S - 1 below them, cells
//     whose iterates it recomputes rather than reads from its neighbours;
//     the plan (stencil_kernels.momentum_plan) cuts the rows so that the
//     blocks fill the card once at the occupancy the card reports;
//   * the edge clamp costs nothing inside: a thread at the grid's first
//     or last column reads its own slot for W or E, and the rows' clamp
//     (S or N taken from the centre) is compiled only into the steps that
//     reach row 0 or row ny - 1.  Loads past the grid's or the band's edge
//     read a clamped address: those cells' values reach no cell that the
//     block writes.
// Two forms, picked by the sweeps (measured on the H100, PERF.md):
//   * up to 8 sweeps the step loop is unrolled over the ring's period, so
//     that its slots are compile-time registers, and each row is loaded
//     into its slot MOM_REG_AHEAD rows ahead of the seed;
//   * above 8 the unrolled loop outgrows the registers and the instruction
//     cache: one step per iteration, the ring shifted by register moves,
//     and the rows copied MOM_STAGE_AHEAD rows ahead by cp.async into a
//     ring of shared memory.
// A Jacobi sweep reads only the previous iterate, so the same operations in
// the same order give the bits of one launch per sweep.
constexpr int MOM_THREADS = 128;
constexpr int TILE_MAX_SWEEPS = 12;   // the solver's 8, and 12 from 1.5M cells
constexpr int MOM_ROLLED_ABOVE = 8;   // more sweeps take the rolled form
constexpr int MOM_REG_AHEAD = 3;      // unrolled form: rows loaded ahead
constexpr int MOM_STAGE_AHEAD = 8;    // rolled form: rows in flight
constexpr int MOM_STAGE = MOM_STAGE_AHEAD + 1;   // their shared slots

// Asynchronous 4-byte copies from device to shared memory (sm_80+), one
// group per row.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src) : "memory");
#else
    *dst = *src;
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#if defined(__CUDA_ARCH__)
    asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
#if defined(__CUDA_ARCH__)
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
#endif
}

struct MomBand {
    const float* __restrict__ r;
    const float* __restrict__ dinv;
    const float* __restrict__ off;
    float* __restrict__ out;
    float* stage;      // rolled form: [MOM_STAGE][7][MOM_THREADS]
    long long n;       // cells of a plane
    int ny, nx;
    int gc;            // this thread's column
    int gcl;           // the column it loads (clamped into the grid)
    bool writes;       // an output column of this block
    int ei, wi;        // the shared-memory slots of its E and W neighbours
    int ra;            // first streamed row
    int r0, r1;        // the block's output rows
    int rb;            // end of its streamed rows
};

// The address of row ``row``'s cell in this thread's column, clamped to
// the streamed rows.
__device__ __forceinline__ long long mom_cell(const MomBand& b, int row) {
    return (long long)min(row, b.rb - 1) * b.nx + b.gcl;
}

__device__ __forceinline__ void mom_load(float (&c)[7], const MomBand& b,
                                         int row) {
    const long long g = mom_cell(b, row);
    c[0] = __ldg(b.dinv + g);
    c[1] = __ldg(b.r + g);
    c[2] = __ldg(b.r + b.n + g);
#pragma unroll
    for (int s = 0; s < 4; ++s) c[3 + s] = __ldg(b.off + s * b.n + g);
}

__device__ __forceinline__ void mom_issue(const MomBand& b, int row) {
    const long long g = mom_cell(b, row);
    float* st = b.stage + ((row - b.ra) % MOM_STAGE) * 7 * MOM_THREADS
        + threadIdx.x;
    cp_async4(st, b.dinv + g);
    cp_async4(st + MOM_THREADS, b.r + g);
    cp_async4(st + 2 * MOM_THREADS, b.r + b.n + g);
#pragma unroll
    for (int s = 0; s < 4; ++s)
        cp_async4(st + (3 + s) * MOM_THREADS, b.off + s * b.n + g);
    cp_async_commit();
}

// A level's last two rows of the column, both components.
template <int S>
struct MomRows {
    float p1[S - 1][2];   // each level 0..S-2: its last row
    float p2[S - 1][2];   // and the row before it
};

// Step t: the seed from ck[0] and levels 1..S-1 (level k on row t - k with
// the coefficients ck[k]); E and W from rd; publish into wr, write the last
// level's row, and move the rows along.  YC: the rows' clamp.
template <int S, bool YC>
__device__ __forceinline__ void mom_levels(const float* (&ck)[S],
                                           MomRows<S>& m, const MomBand& b,
                                           int t, const float2* rd,
                                           float2* wr) {
    constexpr int H = S - 1;
    float z[S][2];
    z[0][0] = __fmul_rn(ck[0][0], ck[0][1]);
    z[0][1] = __fmul_rn(ck[0][0], ck[0][2]);
#pragma unroll
    for (int k = 1; k < S; ++k) {
        const float* c = ck[k];
        const float2 e = rd[(k - 1) * MOM_THREADS + b.ei];
        const float2 w = rd[(k - 1) * MOM_THREADS + b.wi];
        const int j = t - k;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            const float zc = m.p1[k - 1][q];
            float zs = m.p2[k - 1][q], zn = z[k - 1][q];
            if (YC) {
                if (j == 0) zs = zc;
                if (j == b.ny - 1) zn = zc;
            }
            // _dot4's order: ((oE zE + oW zW) + oN zN) + oS zS.
            float acc = __fadd_rn(__fmul_rn(c[3], q ? e.y : e.x),
                                  __fmul_rn(c[4], q ? w.y : w.x));
            acc = __fadd_rn(acc, __fmul_rn(c[5], zn));
            acc = __fadd_rn(acc, __fmul_rn(c[6], zs));
            z[k][q] = __fmul_rn(c[0], __fsub_rn(c[1 + q], acc));
        }
    }
#pragma unroll
    for (int k = 0; k < H; ++k)
        wr[k * MOM_THREADS + threadIdx.x] = make_float2(z[k][0], z[k][1]);
    const int jo = t - H;
    if (b.writes && jo >= b.r0 && jo < b.r1) {
        const long long g = (long long)jo * b.nx + b.gc;
        b.out[g] = z[H][0];
        b.out[b.n + g] = z[H][1];
    }
#pragma unroll
    for (int k = 0; k < H; ++k) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            m.p2[k][q] = m.p1[k][q];
            m.p1[k][q] = z[k][q];
        }
    }
}

// Does a run of ``len`` steps from t0 reach row 0 (a level takes it at
// steps 1 .. S - 1) or row ny - 1 (steps ny .. ny + S - 2)?
__device__ __forceinline__ bool mom_clamps(const MomBand& b, int t0, int len,
                                           int h) {
    return (b.ra == 0 && t0 <= h)
        || (b.rb == b.ny && t0 + len > b.ny && t0 <= b.ny + h - 1);
}

// The unrolled form: steps t0 .. t0 + L - 1 (up to t_end), the ring's slot
// of row t being (t - ra) % L.
template <int S, bool YC>
__device__ __forceinline__ void mom_chunk(
        float (&cf)[S + MOM_REG_AHEAD][7], MomRows<S>& m, const MomBand& b,
        int t0, int t_end, float2*& rd, float2*& wr) {
    constexpr int P = MOM_REG_AHEAD, L = S + P;
#pragma unroll
    for (int u = 0; u < L; ++u) {
        const int t = t0 + u;
        if (t >= t_end) break;
        mom_load(cf[(u + P) % L], b, t + P);
        const float* ck[S];
#pragma unroll
        for (int k = 0; k < S; ++k) ck[k] = cf[(u - k + L) % L];
        mom_levels<S, YC>(ck, m, b, t, rd, wr);
        __syncthreads();
        float2* s = rd;
        rd = wr;
        wr = s;
    }
}

// The rolled form's step t: the ring moves down one row and takes row t
// from the stage.
template <int S, bool YC>
__device__ __forceinline__ void mom_rolled_step(float (&cf)[S][7],
                                                MomRows<S>& m,
                                                const MomBand& b, int t,
                                                const float2* rd,
                                                float2* wr) {
    mom_issue(b, t + MOM_STAGE_AHEAD);
    cp_async_wait<MOM_STAGE_AHEAD>();            // row t has landed
#pragma unroll
    for (int k = S - 1; k > 0; --k) {
#pragma unroll
        for (int s = 0; s < 7; ++s) cf[k][s] = cf[k - 1][s];
    }
    const float* st = b.stage + ((t - b.ra) % MOM_STAGE) * 7 * MOM_THREADS
        + threadIdx.x;
#pragma unroll
    for (int s = 0; s < 7; ++s) cf[0][s] = st[s * MOM_THREADS];
    const float* ck[S];
#pragma unroll
    for (int k = 0; k < S; ++k) ck[k] = cf[k];
    mom_levels<S, YC>(ck, m, b, t, rd, wr);
}

template <int S>
__host__ __device__ constexpr bool mom_rolled() {
    return S > MOM_ROLLED_ABOVE;
}

template <int S>
__global__ void __launch_bounds__(MOM_THREADS, 2)
momentum_stream_kernel(MomArgs a, int tile_rows) {
    constexpr int H = S - 1;
    constexpr int TW = MOM_THREADS - 2 * H;   // output columns of a band
    extern __shared__ float2 zsm[];   // [2][H][MOM_THREADS], then the stage
    const int tid = threadIdx.x;
    MomBand b;
    b.r = a.r;
    b.dinv = a.dinv;
    b.off = a.off;
    b.out = a.out;
    b.stage = reinterpret_cast<float*>(zsm + 2 * H * MOM_THREADS);
    b.ny = a.ny;
    b.nx = a.nx;
    b.n = (long long)a.ny * a.nx;
    b.gc = blockIdx.x * TW - H + tid;
    b.gcl = min(max(b.gc, 0), a.nx - 1);
    b.writes = b.gc >= 0 && b.gc < a.nx && tid >= H && tid < H + TW;
    b.ei = b.gc == a.nx - 1 ? tid : min(tid + 1, MOM_THREADS - 1);
    b.wi = b.gc == 0 ? tid : max(tid - 1, 0);
    b.r0 = blockIdx.y * tile_rows;
    b.r1 = min(a.ny, b.r0 + tile_rows);
    b.ra = max(0, b.r0 - H);
    b.rb = min(a.ny, b.r1 + H);
    const int t_end = b.r1 + H;               // the last output row's step + 1
    if constexpr (mom_rolled<S>()) {
        for (int i = 0; i < MOM_STAGE_AHEAD; ++i) mom_issue(b, b.ra + i);
    }
    for (int i = tid; i < 2 * H * MOM_THREADS; i += MOM_THREADS)
        zsm[i] = make_float2(0.0f, 0.0f);
    MomRows<S> m;
#pragma unroll
    for (int k = 0; k < H; ++k) {
#pragma unroll
        for (int q = 0; q < 2; ++q) m.p1[k][q] = m.p2[k][q] = 0.0f;
    }
    __syncthreads();
    float2* rd = zsm;
    float2* wr = zsm + H * MOM_THREADS;
    if constexpr (mom_rolled<S>()) {
        float cf[S][7];
#pragma unroll
        for (int k = 0; k < S; ++k) {
#pragma unroll
            for (int s = 0; s < 7; ++s) cf[k][s] = 0.0f;
        }
        for (int t = b.ra; t < t_end; ++t) {
            if (mom_clamps(b, t, 1, H))
                mom_rolled_step<S, true>(cf, m, b, t, rd, wr);
            else
                mom_rolled_step<S, false>(cf, m, b, t, rd, wr);
            __syncthreads();
            float2* s = rd;
            rd = wr;
            wr = s;
        }
        cp_async_wait<0>();
    } else {
        constexpr int L = S + MOM_REG_AHEAD;
        float cf[L][7];
#pragma unroll
        for (int i = 0; i < MOM_REG_AHEAD; ++i) mom_load(cf[i], b, b.ra + i);
        for (int t0 = b.ra; t0 < t_end; t0 += L) {
            if (mom_clamps(b, t0, L, H))
                mom_chunk<S, true>(cf, m, b, t0, t_end, rd, wr);
            else
                mom_chunk<S, false>(cf, m, b, t0, t_end, rd, wr);
        }
    }
}

// The levels' two buffers and, in the rolled form, the staged rows: 22,528
// and 32,256 bytes at 12 sweeps, above the 48 KB a launch takes without
// opting in.
template <int S>
constexpr int mom_smem() {
    return 2 * (S - 1) * MOM_THREADS * (int)sizeof(float2)
        + (mom_rolled<S>() ? MOM_STAGE * 7 * MOM_THREADS * (int)sizeof(float)
                           : 0);
}
static_assert(mom_smem<TILE_MAX_SWEEPS>() <= 232448,
              "the streamed predict's shared memory fits a block");

// The opt-in above 48 KB, once per kernel and device (the attribute is a
// device's).
template <int S>
cudaError_t opt_in_smem() {
    constexpr int MAX_DEVICES = 64;
    static bool done[MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
    e = cudaFuncSetAttribute(momentum_stream_kernel<S>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             mom_smem<S>());
    if (e == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
    return e;
}

template <int S>
cudaError_t launch_stream_s(const MomArgs& a, int tile_rows,
                            cudaStream_t st) {
    constexpr int TW = MOM_THREADS - 2 * (S - 1);
    const cudaError_t opted = opt_in_smem<S>();
    if (opted != cudaSuccess) return opted;
    const dim3 grid((a.nx + TW - 1) / TW, (a.ny + tile_rows - 1) / tile_rows);
    momentum_stream_kernel<S><<<grid, MOM_THREADS, mom_smem<S>(), st>>>(
        a, tile_rows);
    return cudaGetLastError();
}

template <int S>
cudaError_t blocks_per_sm_s(int* out) {
    const cudaError_t opted = opt_in_smem<S>();
    if (opted != cudaSuccess) return opted;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, momentum_stream_kernel<S>, MOM_THREADS, mom_smem<S>());
}

// One case per sweep count of the streamed kernel, 2..TILE_MAX_SWEEPS.
#define MOM_SWEEPS_CASES(CALL)                                              \
    case 2: return CALL(2);                                                 \
    case 3: return CALL(3);                                                 \
    case 4: return CALL(4);                                                 \
    case 5: return CALL(5);                                                 \
    case 6: return CALL(6);                                                 \
    case 7: return CALL(7);                                                 \
    case 8: return CALL(8);                                                 \
    case 9: return CALL(9);                                                 \
    case 10: return CALL(10);                                               \
    case 11: return CALL(11);                                               \
    case 12: return CALL(12);
static_assert(TILE_MAX_SWEEPS == 12, "MOM_SWEEPS_CASES lists 2..12");

cudaError_t launch_stream(const MomArgs& a, int sweeps, int tile_rows,
                          cudaStream_t st) {
#define MOM_LAUNCH(S) launch_stream_s<S>(a, tile_rows, st)
    switch (sweeps) {
        MOM_SWEEPS_CASES(MOM_LAUNCH)
        default: return cudaErrorInvalidValue;
    }
#undef MOM_LAUNCH
}

cudaError_t blocks_per_sm(int sweeps, int* out) {
#define MOM_OCCUPANCY(S) blocks_per_sm_s<S>(out)
    switch (sweeps) {
        MOM_SWEEPS_CASES(MOM_OCCUPANCY)
        default: return cudaErrorInvalidValue;
    }
#undef MOM_OCCUPANCY
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
// the streamed bands of tile_rows output rows each; the plan is
// stencil_kernels.momentum_plan).  r: (2, ny, nx); dinv: (ny, nx); off:
// (4, ny, nx); out (2, ny, nx) = z.  More sweeps take momentum_sweep, one
// launch each.  Returns a cudaError_t.
int momentum_jacobi(const float* r, const float* dinv, const float* off,
                    float* out, int ny, int nx, int sweeps, int tile_rows,
                    void* stream) {
    if (ny < 1 || nx < 1 || sweeps < 1 || sweeps > TILE_MAX_SWEEPS
            || tile_rows < 1)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const MomArgs a = {r, dinv, off, nullptr, nullptr, nullptr, out, ny, nx};
    if (sweeps == 1) return (int)launch_momentum<FROM_NONE>(a, st);
    return (int)launch_stream(a, sweeps, tile_rows, st);
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

// The most sweeps momentum_jacobi runs in one launch (TILE_MAX_SWEEPS) and
// its threads a block (MOM_THREADS): ops/stencil_kernels.py checks its own
// constants against them at load.
int stencil_tile_max_sweeps() { return TILE_MAX_SWEEPS; }
int stencil_mom_threads() { return MOM_THREADS; }

// The streamed predict's resident blocks per SM on the current device at
// ``sweeps`` (2..TILE_MAX_SWEEPS) into *out, for the plan.  Returns a
// cudaError_t.
int stencil_mom_blocks_per_sm(int sweeps, int* out) {
    if (out == nullptr) return (int)cudaErrorInvalidValue;
    return (int)blocks_per_sm(sweeps, out);
}

// Human-readable text of a cudaError_t returned above.
const char* stencil_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
