// Indexed gather, fused gather-dot and multi-sweep Jacobi over an (M, K) int32
// neighbour map, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernels in
// cfd2_tpu/ops/banded_gather.py:
//   * banded_gather        <- _kernel via _banded_raw with prods=None
//                             (banded_gather_nk / banded_gather2_nk):
//                             out[i, k, c] = x[idx[i, k], c]; and its use in
//                             the V-cycle's prolongation, fused with the
//                             update: banded_prolong_add;
//   * banded_dot           <- _kernel via _banded_raw with prods (banded_dot):
//                             out_j[i] = sum over (p, c) in prods[j] of
//                             sum_k off_p[i, k] * x_c[idx[i, k]], with no
//                             (M, K) intermediate in device memory;
//   * banded_jacobi_sweeps <- _sweeps_kernel (banded_jacobi_sweeps):
//                             z_0 = dinv*r, z_s = dinv*(r - A_off z_{s-1}) for
//                             C right-hand sides sharing off (n, K) and dinv.
//
// The TPU kernels gather along 128 lanes from an operand resident in VMEM and
// therefore compile the index map into lane/sel/base planes and walk source
// windows.  None of that is needed here: a thread loads idx[i, k] and reads
// the operand from device memory (through L2/L1) directly, so the kernels take
// the (M, K) map as it is, for square maps (mesh neighbours, coarse-level
// adjacencies) and rectangular ones (restriction member lists, the K = 1
// prolongation map) alike.
//
// What bounds them on this card: bytes.  Each does one multiply-add per index
// it loads.
//   gather: 4*(M*K + M*K*C + n_src*C) bytes  (index map, output, operand);
//   dot:    4*(M*K + n_planes*M*K + n_operands*n_src + n_out*M) bytes;
//   sweeps: 4*(n*k_cap idx + n*k_cap off + n dinv + C*n r + C*n z), each
//           input read once and the result written once: at n = 403,584,
//           K = 3, C = 2 that is 17.76 MB, 5.3 us at 3.35 TB/s (the 7
//           products of 8 sweeps are 0.7 us of float32 arithmetic).
// What the design does about it:
//   * gather runs one thread per (row, slot): the thread loads the slot's
//     index once and copies the neighbour's C values.  C is compile-time for
//     the widths the solver uses (1: scalars, 2: velocities and gradients,
//     6: the packed assembly operands); any other C takes a run-time loop.
//     Even C reads the neighbour's row as C/2 8-byte float2 loads (rows of
//     4*C bytes are 8-byte aligned when the base is, which the wrapper
//     checks).  C = 1 takes four slots per thread: one 16-byte index load,
//     four gathers in flight, one 16-byte store (with one slot per thread
//     each thread waits on a single dependent index-operand pair, and the
//     kernel ran at under half the byte rate).  C = 1 and 2 store straight
//     from registers, a warp's store covering 32*4*C contiguous bytes or
//     more.  C = 6 would store 24-byte rows at a 24-byte stride, three
//     instructions each touching every sector of the warp's 768 bytes; so a
//     block first puts its 256 rows in shared memory and then writes its
//     6 KB span as contiguous float2, 256 bytes per warp instruction (24-byte
//     stores straight from registers were slower).  The first port ran one
//     thread per output element with a 64-bit division by a run-time C in
//     every thread and C loads of the same index: at C = 6 it took over
//     three times the bound;
//   * the fused prolongation of the aggregation V-cycle, out[i] = base[i] +
//     alpha * x[idx[i]] (K = 1, C = 1): one thread per row, the product and
//     the sum rounded separately (__fmul_rn, __fadd_rn, never contracted to
//     an FMA), so that it equals the eager `base + alpha * x[idx]` bit for
//     bit.  It replaces a gather and two elementwise launches per level;
//   * dot.  With one thread per row a warp reads idx and every plane at a
//     stride of 4*K bytes, so each 128-byte line is requested K times per
//     stream and the load/store units, not device memory, set the pace.  So
//     a block owns 256 rows, which are 256*K contiguous elements of idx and
//     of each (M, K) plane, and its threads read them element-parallel:
//     thread t takes the elements t, t + 256, ..., a warp reading 128
//     contiguous bytes per stream and instruction (plain 4-byte loads: 16-byte
//     loads would need every plane's base 16-byte aligned, which views of
//     stacked level values are not, and would not change the bytes moved).
//     The thread gathers its element's operands through the read-only path,
//     forms the element's products and puts one partial per output into
//     shared memory; after a barrier thread t adds row t's K partials in
//     ascending k and writes the outputs.  That is the summation order of
//     the plain version (products of one slot first, slots in order last), so
//     the results do not depend on the block shape.  The gathered (M, K)
//     values never reach device memory.  Operand reads of neighbouring rows
//     hit nearby addresses because cells are ordered so that neighbours fall
//     in narrow index bands.
//     The product list is compile-time: each of the solver's five forms
//     (scalar, mom2, schur_rhs, grad, spmv) is an instantiation with its
//     products written out and its pointers read from the parameter space at
//     constant offsets; any other list takes the generic instantiation, which
//     indexes the list at run time.  K = 3 (triangles) and K = 9 (polygons,
//     coarse levels) are compile-time too, so the element loop unrolls and a
//     thread has all its loads in flight at once.  Other K (coarse levels of
//     10-13 slots, restriction lists up to 26 wide) are run-time values: a
//     block then owns 64 rows and a thread takes its elements four at a
//     time, the four index loads and the gathers behind them in flight
//     together.  (One dependent index-gather pair after another costs a
//     level of a hundred rows ten microseconds, three times its launch.)
//     Levels of a few thousand rows are bound by launch latency whatever the
//     body does;
//   * sweeps replaces _sweeps_kernel (cfd2_tpu/ops/banded_gather.py), which
//     keeps z, r and dinv in VMEM across all sweeps inside one pallas_call
//     whose grid runs in order.  Blocks on a GPU run in no order, so sweep
//     s must not start before sweep s-1 is complete everywhere.  An order of
//     launches (a seed and sweeps-1 sweep kernels) reads idx, off, dinv and
//     r again on every sweep; here one cooperative launch
//     (cudaLaunchCooperativeKernel: every block resident at once) runs all
//     sweeps, with cooperative_groups' grid barrier between them (about
//     1.35 us each on an H100; no -rdc needed).  In the resident form each
//     of at most one block per SM owns a contiguous range of rows (the
//     banded order keeps most neighbours in it or next to it), stages its
//     rows' first k_cap slots of idx and off in shared memory in the seed
//     pass, slot-major so that a warp's reads fall on 32 banks, and holds
//     dinv and the C values of r in registers (RPT rows per thread,
//     compile-time): the coefficients cross device memory once.  The
//     iterate ping-pongs between za and zb (6.5 MB at 403,584 x 2, in the
//     50 MB L2).  Its gathers are plain loads through L1 (__ldca), which
//     keeps the neighbours a block shares within a sweep: through L2 alone
//     (__ldcg) every gather moves a 32-byte sector and the launch took 2.7x
//     as long at 403,584 x 3.  They never take the read-only path (__ldg,
//     ld.global.nc), which is not coherent with stores made in the same
//     launch; plain loads are, after the barrier's acquire.  Where a
//     block's rows do not fit shared memory or RPT registers, the streamed
//     form of the same launch reads idx, off, dinv and r again per sweep
//     (from L2 where they fit).  The wrapper plans the form, grid and
//     shared memory (banded_kernels.sweeps_plan) from the card's limits,
//     which banded_sweeps_limits reports once per device and C.  A grid the
//     card cannot hold at once is refused (cudaErrorCooperativeLaunchTooLarge)
//     and returned, never retried as a plain launch.  Each product and sum
//     of A_off z is rounded on its own (__fmul_rn, __fadd_rn) in ascending
//     slots from zero, as banded_dot's products of one slot are summed, so
//     the launch equals the per-sweep loop of banded_dot calls bit for bit.
//     What holds it above its bound: the seed pass's reads from device
//     memory, the 7 barriers, and each sweep's gathers, bound by the
//     latency of L1 and L2 with one block of 32 warps per SM.
//
// All functions have a plain C interface (loaded with ctypes), launch on the
// caller's stream, allocate nothing, and return cudaGetLastError() after the
// launch so that the caller can raise on a refused launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_X = 3;       // operands of one dot
constexpr int MAX_OFF = 6;     // coefficient planes of one dot
constexpr int MAX_OUT = 3;     // outputs of one dot
constexpr int MAX_PAIRS = 8;   // (plane, operand) products of one dot
constexpr int MAX_RHS = 4;     // right-hand sides of one sweeps call

struct DotArgs {
    const float* x[MAX_X];
    const float* off[MAX_OFF];
    float* out;                // (n_out, M)
    // The generic form's product list (unused by the named forms).
    int pair_off[MAX_PAIRS];   // coefficient plane of product p
    int pair_x[MAX_PAIRS];     // operand of product p
    int pair_start[MAX_OUT + 1];   // products of output j: [start[j], start[j+1])
    int n_x;
    int n_out;
};

// One sweeps launch.  za and zb are written inside it, so they are read
// with plain loads (__ldca), never through the read-only path.
struct SweepArgs {
    const float* r[MAX_RHS];
    const float* dinv;
    const float* off;          // (n, K)
    const int* idx;            // (n, K)
    float* za;                 // (C, n): z_s for even s
    float* zb;                 // (C, n): z_s for odd s
    int n, K, k_cap, sweeps;
    int rows;                  // rows per block
};

// One thread per flat slot s = row * K + k; for C == 1 per four slots
// (idx and out 16-byte aligned).  C == 0: C is the run-time c_rt.
template <int C>
__global__ void __launch_bounds__(THREADS)
banded_gather_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                     float* __restrict__ out, long long n_slots, int c_rt) {
    const long long s = (long long)blockIdx.x * THREADS + threadIdx.x;
    if constexpr (C == 1) {
        // One 16-byte index load, four operand loads in flight, one 16-byte
        // store.
        if (4 * s + 4 <= n_slots) {
            const int4 j = __ldg(reinterpret_cast<const int4*>(idx) + s);
            float4 v;
            v.x = __ldg(x + j.x);
            v.y = __ldg(x + j.y);
            v.z = __ldg(x + j.z);
            v.w = __ldg(x + j.w);
            reinterpret_cast<float4*>(out)[s] = v;
        } else {
            for (long long t = 4 * s; t < n_slots; ++t)
                out[t] = __ldg(x + __ldg(idx + t));
        }
    } else if constexpr (C == 2) {
        if (s < n_slots)
            reinterpret_cast<float2*>(out)[s] =
                __ldg(reinterpret_cast<const float2*>(x) + __ldg(idx + s));
    } else if constexpr (C == 0) {
        if (s >= n_slots) return;
        const float* src = x + (long long)__ldg(idx + s) * c_rt;
        float* dst = out + s * c_rt;
        for (int c = 0; c < c_rt; ++c) dst[c] = __ldg(src + c);
    } else {
        static_assert(C % 2 == 0, "odd widths take the run-time path");
        // Rows staged in shared memory, then the block's span written out
        // contiguously.  H is odd for C = 6, so the staging stores (a stride
        // of H float2) fall on distinct banks within each half-warp.
        constexpr int H = C / 2;
        __shared__ float2 s_rows[THREADS * H];
        if (s < n_slots) {
            const float2* src = reinterpret_cast<const float2*>(x)
                + (long long)__ldg(idx + s) * H;
#pragma unroll
            for (int j = 0; j < H; ++j)
                s_rows[threadIdx.x * H + j] = __ldg(src + j);
        }
        __syncthreads();
        const long long s0 = (long long)blockIdx.x * THREADS;
        const int n_here = (int)(n_slots - s0 < THREADS ? n_slots - s0
                                                         : THREADS) * H;
        float2* dst = reinterpret_cast<float2*>(out) + s0 * H;
#pragma unroll
        for (int j = 0; j < H; ++j) {
            const int k = threadIdx.x + j * THREADS;
            if (k < n_here) dst[k] = s_rows[k];
        }
    }
}

template <int C>
cudaError_t launch_gather(const float* x, const int* idx, float* out,
                          long long n_slots, int c_rt, cudaStream_t stream) {
    const long long n_threads = C == 1 ? (n_slots + 3) / 4 : n_slots;
    const unsigned blocks = (unsigned)((n_threads + THREADS - 1) / THREADS);
    banded_gather_kernel<C><<<blocks, THREADS, 0, stream>>>(x, idx, out,
                                                            n_slots, c_rt);
    return cudaGetLastError();
}

__global__ void __launch_bounds__(THREADS)
banded_prolong_add_kernel(const float* __restrict__ base,
                          const float* __restrict__ x,
                          const int* __restrict__ idx, float alpha,
                          float* __restrict__ out, int M) {
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= M) return;
    out[i] = __fadd_rn(__ldg(base + i),
                       __fmul_rn(alpha, __ldg(x + __ldg(idx + i))));
}

// The product forms of banded_dot (ops/banded_kernels.py names them the
// same): prods of
//   scalar     (((0,0),),)                         1 operand, 1 plane
//   mom2       (((0,0),), ((0,1),))                2 operands, 1 plane
//   schur_rhs  (((0,0), (1,1)),)                   2 operands, 2 planes
//   grad       (((0,0),), ((1,0),))                1 operand, 2 planes
//   spmv       (((0,0), (1,2)), ((0,1), (2,2)),
//               ((3,0), (4,1), (5,2)))             3 operands, 6 planes
constexpr int F_GENERIC = 0;
constexpr int F_SCALAR = 1;
constexpr int F_MOM2 = 2;
constexpr int F_SCHUR_RHS = 3;
constexpr int F_GRAD = 4;
constexpr int F_SPMV = 5;

template <int FORM>
__device__ __forceinline__ int form_n_out(const DotArgs& a) {
    if constexpr (FORM == F_SCALAR || FORM == F_SCHUR_RHS) return 1;
    else if constexpr (FORM == F_MOM2 || FORM == F_GRAD) return 2;
    else if constexpr (FORM == F_SPMV) return 3;
    else return a.n_out;
}

// The products of element e (slot k of a row) whose source row is src: one
// partial per output, the products of a slot added in list order from zero.
template <int FORM>
__device__ __forceinline__ void slot_products(const DotArgs& a, long long e,
                                              int src, float (&s)[MAX_OUT]) {
    if constexpr (FORM == F_SCALAR) {
        s[0] = 0.0f;
        s[0] += __ldg(a.off[0] + e) * __ldg(a.x[0] + src);
    } else if constexpr (FORM == F_MOM2) {
        const float o = __ldg(a.off[0] + e);
        s[0] = 0.0f;
        s[0] += o * __ldg(a.x[0] + src);
        s[1] = 0.0f;
        s[1] += o * __ldg(a.x[1] + src);
    } else if constexpr (FORM == F_SCHUR_RHS) {
        s[0] = 0.0f;
        s[0] += __ldg(a.off[0] + e) * __ldg(a.x[0] + src);
        s[0] += __ldg(a.off[1] + e) * __ldg(a.x[1] + src);
    } else if constexpr (FORM == F_GRAD) {
        const float x0 = __ldg(a.x[0] + src);
        s[0] = 0.0f;
        s[0] += __ldg(a.off[0] + e) * x0;
        s[1] = 0.0f;
        s[1] += __ldg(a.off[1] + e) * x0;
    } else if constexpr (FORM == F_SPMV) {
        const float x0 = __ldg(a.x[0] + src);
        const float x1 = __ldg(a.x[1] + src);
        const float x2 = __ldg(a.x[2] + src);
        const float o_mom = __ldg(a.off[0] + e);
        s[0] = 0.0f;
        s[0] += o_mom * x0;
        s[0] += __ldg(a.off[1] + e) * x2;
        s[1] = 0.0f;
        s[1] += o_mom * x1;
        s[1] += __ldg(a.off[2] + e) * x2;
        s[2] = 0.0f;
        s[2] += __ldg(a.off[3] + e) * x0;
        s[2] += __ldg(a.off[4] + e) * x1;
        s[2] += __ldg(a.off[5] + e) * x2;
    } else {
        float xv[MAX_X];
#pragma unroll
        for (int c = 0; c < MAX_X; ++c)
            xv[c] = c < a.n_x ? __ldg(a.x[c] + src) : 0.0f;
#pragma unroll
        for (int j = 0; j < MAX_OUT; ++j) {
            s[j] = 0.0f;
            if (j < a.n_out) {
                for (int p = a.pair_start[j]; p < a.pair_start[j + 1]; ++p) {
                    const int px = a.pair_x[p];
                    const float v = px == 0 ? xv[0] : (px == 1 ? xv[1] : xv[2]);
                    s[j] += __ldg(a.off[a.pair_off[p]] + e) * v;
                }
            }
        }
    }
}

// A block owns RB rows = RB*K contiguous elements.  KT > 0: K is the
// compile-time KT; KT == 0: K is k_rt.  Shared memory: one partial per output
// and element, a row's partials KP floats apart: KP = K made odd, so that the
// threads of a warp, each adding its own row, fall on 32 different banks
// (n_out * RB * KP floats).
template <int FORM, int KT, int RB>
__global__ void __launch_bounds__(THREADS)
banded_dot_kernel(DotArgs a, const int* __restrict__ idx, int M, int k_rt) {
    static_assert(KT == 0 || RB == THREADS, "one element per thread and k");
    extern __shared__ float s_part[];
    const int K = KT > 0 ? KT : k_rt;
    const int KP = K | 1;
    const int n_out = form_n_out<FORM>(a);
    const int span = RB * K;
    const int plane = RB * KP;
    const long long e0 = (long long)blockIdx.x * span;
    const long long n_el = (long long)M * K;
    if (KT > 0) {
#pragma unroll
        for (int i = 0; i < (KT > 0 ? KT : 1); ++i) {
            const int le = threadIdx.x + i * THREADS;
            const long long e = e0 + le;
            if (e < n_el) {
                float s[MAX_OUT];
                slot_products<FORM>(a, e, __ldg(idx + e), s);
#pragma unroll
                for (int j = 0; j < MAX_OUT; ++j)
                    if (j < n_out) s_part[j * plane + le] = s[j];
            }
        }
    } else {
        // Batches of UNROLL elements per thread.  Every load of a batch is
        // unconditional (an element past the end reads the last one, and its
        // products are dropped), so the UNROLL index loads, and then the
        // gathers behind them, are in flight together instead of one
        // dependent pair after another.
        constexpr int UNROLL = 4;
        for (int base = threadIdx.x; base < span; base += UNROLL * THREADS) {
            int src[UNROLL];
            long long el[UNROLL];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                const long long e = e0 + base + u * THREADS;
                el[u] = e < n_el ? e : n_el - 1;
                src[u] = __ldg(idx + el[u]);
            }
            float s[UNROLL][MAX_OUT];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u)
                slot_products<FORM>(a, el[u], src[u], s[u]);
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                const int le = base + u * THREADS;
                if (le < span && e0 + le < n_el) {
                    const int row = le / K;
                    const int at = row * KP + (le - row * K);
#pragma unroll
                    for (int j = 0; j < MAX_OUT; ++j)
                        if (j < n_out) s_part[j * plane + at] = s[u][j];
                }
            }
        }
    }
    __syncthreads();
    const int row = blockIdx.x * RB + threadIdx.x;
    if (threadIdx.x >= RB || row >= M) return;
#pragma unroll
    for (int j = 0; j < MAX_OUT; ++j) {
        if (j < n_out) {
            const float* part = s_part + j * plane + threadIdx.x * KP;
            float acc = 0.0f;
            if (KT > 0) {
#pragma unroll
                for (int k = 0; k < (KT > 0 ? KT : 1); ++k) acc += part[k];
            } else {
                for (int k = 0; k < K; ++k) acc += part[k];
            }
            a.out[(long long)j * M + row] = acc;
        }
    }
}

// Rows per block where K is a run-time value: the restriction lists and the
// coarse levels, a few thousand rows or fewer but for the first.  Small
// blocks of rows spread them over the card's SMs and leave each thread one
// or two batches.
constexpr int ROWS_RT = 64;

// One launch with K compile-time (KC = K) or run-time (KC = 0) and ROWS rows
// per block.
template <int FORM, int KC, int ROWS>
cudaError_t launch_dot_rows(const DotArgs& a, const int* idx, int M, int K,
                            int n_out, cudaStream_t stream) {
    const unsigned blocks = (unsigned)((M + ROWS - 1) / ROWS);
    const size_t smem = (size_t)n_out * ROWS * (K | 1) * sizeof(float);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            banded_dot_kernel<FORM, KC, ROWS>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    banded_dot_kernel<FORM, KC, ROWS><<<blocks, THREADS, smem, stream>>>(
        a, idx, M, K);
    return cudaGetLastError();
}

template <int FORM>
cudaError_t launch_dot(const DotArgs& a, const int* idx, int M, int K,
                       int n_out, cudaStream_t stream) {
    if (K < 1) return cudaErrorInvalidValue;
    if (M == 0) return cudaSuccess;
    if (K == 3)
        return launch_dot_rows<FORM, 3, THREADS>(a, idx, M, K, n_out, stream);
    if (K == 9)
        return launch_dot_rows<FORM, 9, THREADS>(a, idx, M, K, n_out, stream);
    return launch_dot_rows<FORM, 0, ROWS_RT>(a, idx, M, K, n_out, stream);
}

constexpr int SW_THREADS = 1024;    // threads of a sweeps block

// Row i's A_off z_src for C components over its first k_cap slots; the
// products and sums rounded one by one, slots in ascending order.
template <int C>
__device__ __forceinline__ void sweep_row(const SweepArgs& a,
                                          const float* z_src,
                                          const int* s_idx,
                                          const float* s_off, int stride,
                                          float (&sig)[C]) {
#pragma unroll
    for (int c = 0; c < C; ++c) sig[c] = 0.0f;
    for (int k = 0; k < a.k_cap; ++k) {
        const int src = s_idx[k * stride];
        const float o = s_off[k * stride];
#pragma unroll
        for (int c = 0; c < C; ++c)
            sig[c] = __fadd_rn(sig[c], __fmul_rn(
                o, __ldca(z_src + (long long)c * a.n + src)));
    }
}

// Resident form: one block per SM at most, a.rows <= RPT * SW_THREADS rows
// each; dynamic shared memory 8 * k_cap * a.rows bytes.
template <int C, int RPT>
__global__ void __launch_bounds__(SW_THREADS, 1)
jacobi_sweeps_resident(SweepArgs a) {
    extern __shared__ int s_map[];
    const int RB = a.rows, K = a.K, kc = a.k_cap;
    int* s_idx = s_map;
    float* s_off = reinterpret_cast<float*>(s_map + (long long)kc * RB);
    const int row0 = blockIdx.x * RB;
    const int rows = max(0, min(RB, a.n - row0));
    // Seed pass: the block's slots k < k_cap, slot-major, read coalesced
    // from the (n, K) planes.
    const long long e0 = (long long)row0 * K;
    for (int e = threadIdx.x; e < rows * K; e += SW_THREADS) {
        const int l = e / K, k = e - l * K;
        if (k < kc) {
            s_idx[k * RB + l] = __ldg(a.idx + e0 + e);
            s_off[k * RB + l] = __ldg(a.off + e0 + e);
        }
    }
    float d[RPT], rv[RPT][C];
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
        const int l = threadIdx.x + j * SW_THREADS;
        d[j] = 0.0f;
#pragma unroll
        for (int c = 0; c < C; ++c) rv[j][c] = 0.0f;
        if (l < rows) {
            d[j] = __ldg(a.dinv + row0 + l);
#pragma unroll
            for (int c = 0; c < C; ++c) {
                rv[j][c] = __ldg(a.r[c] + row0 + l);
                a.za[(long long)c * a.n + row0 + l] = __fmul_rn(d[j],
                                                                rv[j][c]);
            }
        }
    }
    cooperative_groups::grid_group grid = cooperative_groups::this_grid();
    for (int s = 1; s < a.sweeps; ++s) {
        grid.sync();
        const float* z_src = (s & 1) ? a.za : a.zb;
        float* z_dst = (s & 1) ? a.zb : a.za;
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
            const int l = threadIdx.x + j * SW_THREADS;
            if (l < rows) {
                float sig[C];
                sweep_row<C>(a, z_src, s_idx + l, s_off + l, RB, sig);
#pragma unroll
                for (int c = 0; c < C; ++c)
                    z_dst[(long long)c * a.n + row0 + l] = __fmul_rn(
                        d[j], __fsub_rn(rv[j][c], sig[c]));
            }
        }
    }
}

// Streamed form: the same launch with idx, off, dinv and r read again on
// every sweep (through L2), for maps whose rows do not fit on chip.
template <int C>
__global__ void __launch_bounds__(SW_THREADS, 2)
jacobi_sweeps_streamed(SweepArgs a) {
    const int row0 = blockIdx.x * a.rows;
    const int row1 = min(a.n, row0 + a.rows);
    for (int i = row0 + threadIdx.x; i < row1; i += SW_THREADS) {
        const float d = __ldg(a.dinv + i);
#pragma unroll
        for (int c = 0; c < C; ++c)
            a.za[(long long)c * a.n + i] = __fmul_rn(d, __ldg(a.r[c] + i));
    }
    cooperative_groups::grid_group grid = cooperative_groups::this_grid();
    for (int s = 1; s < a.sweeps; ++s) {
        grid.sync();
        const float* z_src = (s & 1) ? a.za : a.zb;
        float* z_dst = (s & 1) ? a.zb : a.za;
        for (int i = row0 + threadIdx.x; i < row1; i += SW_THREADS) {
            float sig[C];
            const long long row = (long long)i * a.K;
            sweep_row<C>(a, z_src, a.idx + row, a.off + row, 1, sig);
            const float d = __ldg(a.dinv + i);
#pragma unroll
            for (int c = 0; c < C; ++c)
                z_dst[(long long)c * a.n + i] = __fmul_rn(
                    d, __fsub_rn(__ldg(a.r[c] + i), sig[c]));
        }
    }
}

// The kernel of (C, form): form 0 is the streamed form, 1, 2, 4 or 8 the
// resident form with that many rows per thread; nullptr for any other.
template <int C>
const void* sweeps_kernel(int form) {
    switch (form) {
        case 0: return (const void*)jacobi_sweeps_streamed<C>;
        case 1: return (const void*)jacobi_sweeps_resident<C, 1>;
        case 2: return (const void*)jacobi_sweeps_resident<C, 2>;
        case 4: return (const void*)jacobi_sweeps_resident<C, 4>;
        case 8: return (const void*)jacobi_sweeps_resident<C, 8>;
        default: return nullptr;
    }
}

const void* sweeps_kernel_of(int C, int form) {
    switch (C) {
        case 1: return sweeps_kernel<1>(form);
        case 2: return sweeps_kernel<2>(form);
        case 3: return sweeps_kernel<3>(form);
        case 4: return sweeps_kernel<4>(form);
        default: return nullptr;
    }
}

constexpr int SW_FORMS[] = {0, 1, 2, 4, 8};

}  // namespace

extern "C" {

// x: (n_src, C) float32; idx: (M, K) int32 with values in [0, n_src);
// out: (M, K, C) float32.  For even C, x and out must be 8-byte aligned.
// Returns a cudaError_t.
int banded_gather(const float* x, const int* idx, float* out, int M, int K,
                  int C, void* stream) {
    const long long n_slots = (long long)M * K;
    if (C < 1) return (int)cudaErrorInvalidValue;
    if (n_slots == 0) return (int)cudaSuccess;
    const cudaStream_t st = (cudaStream_t)stream;
    switch (C) {
        case 1:   // a view of idx at an odd int4 takes the run-time path
            if (((unsigned long long)idx | (unsigned long long)out) % 16)
                return (int)launch_gather<0>(x, idx, out, n_slots, C, st);
            return (int)launch_gather<1>(x, idx, out, n_slots, C, st);
        case 2: return (int)launch_gather<2>(x, idx, out, n_slots, C, st);
        case 6: return (int)launch_gather<6>(x, idx, out, n_slots, C, st);
        default: return (int)launch_gather<0>(x, idx, out, n_slots, C, st);
    }
}

// out[i] = base[i] + alpha * x[idx[i]], the product and the sum each rounded
// to float32.  base, out: (M,) float32; x: (n_src,) float32; idx: (M, 1)
// int32 with values in [0, n_src).  Returns a cudaError_t.
int banded_prolong_add(const float* base, const float* x, const int* idx,
                       float alpha, float* out, int M, void* stream) {
    if (M == 0) return (int)cudaSuccess;
    const unsigned blocks = (unsigned)((M + THREADS - 1) / THREADS);
    banded_prolong_add_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        base, x, idx, alpha, out, M);
    return (int)cudaGetLastError();
}

// The named forms of banded_dot, one entry point each, so that a call passes
// just that form's pointers.  x*: (n_src,) float32 operands; o*: (M, K)
// float32 coefficient planes; out: (n_out, M) float32; idx: (M, K) int32.
// Each returns a cudaError_t.
int banded_dot_scalar(const float* x0, const float* o0, float* out,
                      const int* idx, int M, int K, void* stream) {
    DotArgs a = {};
    a.x[0] = x0;
    a.off[0] = o0;
    a.out = out;
    return (int)launch_dot<F_SCALAR>(a, idx, M, K, 1, (cudaStream_t)stream);
}

int banded_dot_mom2(const float* x0, const float* x1, const float* o0,
                    float* out, const int* idx, int M, int K, void* stream) {
    DotArgs a = {};
    a.x[0] = x0; a.x[1] = x1;
    a.off[0] = o0;
    a.out = out;
    return (int)launch_dot<F_MOM2>(a, idx, M, K, 2, (cudaStream_t)stream);
}

int banded_dot_schur_rhs(const float* x0, const float* x1, const float* o0,
                         const float* o1, float* out, const int* idx, int M,
                         int K, void* stream) {
    DotArgs a = {};
    a.x[0] = x0; a.x[1] = x1;
    a.off[0] = o0; a.off[1] = o1;
    a.out = out;
    return (int)launch_dot<F_SCHUR_RHS>(a, idx, M, K, 1, (cudaStream_t)stream);
}

int banded_dot_grad(const float* x0, const float* o0, const float* o1,
                    float* out, const int* idx, int M, int K, void* stream) {
    DotArgs a = {};
    a.x[0] = x0;
    a.off[0] = o0; a.off[1] = o1;
    a.out = out;
    return (int)launch_dot<F_GRAD>(a, idx, M, K, 2, (cudaStream_t)stream);
}

int banded_dot_spmv(const float* x0, const float* x1, const float* x2,
                    const float* o0, const float* o1, const float* o2,
                    const float* o3, const float* o4, const float* o5,
                    float* out, const int* idx, int M, int K, void* stream) {
    DotArgs a = {};
    a.x[0] = x0; a.x[1] = x1; a.x[2] = x2;
    a.off[0] = o0; a.off[1] = o1; a.off[2] = o2;
    a.off[3] = o3; a.off[4] = o4; a.off[5] = o5;
    a.out = out;
    return (int)launch_dot<F_SPMV>(a, idx, M, K, 3, (cudaStream_t)stream);
}

// Any other product list.  xs: n_x pointers to (n_src,) float32 operands;
// offs: n_off pointers to (M, K) float32 coefficient planes; out: (n_out, M)
// float32; idx: (M, K) int32.  Output j sums the products p in
// [pair_start[j], pair_start[j+1]): offs[pair_off[p]][i, k] *
// xs[pair_x[p]][idx[i, k]] over k.  Returns a cudaError_t, or
// cudaErrorInvalidValue when a count exceeds the kernel's limits.
int banded_dot(const float* const* xs, int n_x, const float* const* offs,
               int n_off, float* out, int n_out, const int* pair_off,
               const int* pair_x, const int* pair_start, const int* idx,
               int M, int K, void* stream) {
    if (n_x < 1 || n_x > MAX_X || n_off < 1 || n_off > MAX_OFF || n_out < 1
        || n_out > MAX_OUT || pair_start[n_out] > MAX_PAIRS)
        return (int)cudaErrorInvalidValue;
    DotArgs a = {};
    for (int c = 0; c < n_x; ++c) a.x[c] = xs[c];
    for (int p = 0; p < n_off; ++p) a.off[p] = offs[p];
    a.out = out;
    for (int j = 0; j <= n_out; ++j) a.pair_start[j] = pair_start[j];
    for (int p = 0; p < pair_start[n_out]; ++p) {
        if (pair_off[p] < 0 || pair_off[p] >= n_off || pair_x[p] < 0
            || pair_x[p] >= n_x)
            return (int)cudaErrorInvalidValue;
        a.pair_off[p] = pair_off[p];
        a.pair_x[p] = pair_x[p];
    }
    a.n_x = n_x;
    a.n_out = n_out;
    return (int)launch_dot<F_GENERIC>(a, idx, M, K, n_out,
                                      (cudaStream_t)stream);
}

// What the wrapper plans a sweeps launch with, for C right-hand sides on
// the current device: out[0] the SM count, out[1] the shared memory a
// block may opt in to, out[2] the blocks of the resident form an SM holds
// at that much shared memory (the least over its instantiations), out[3]
// the blocks of the streamed form an SM holds.  Lets every resident
// instantiation of C use that much shared memory.  Returns a cudaError_t.
int banded_sweeps_limits(int C, int* out) {
    if (C < 1 || C > MAX_RHS) return (int)cudaErrorInvalidValue;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&out[0], cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &out[1], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    out[2] = 1 << 30;
    for (int form : SW_FORMS) {
        if (err != cudaSuccess) break;
        const void* kernel = sweeps_kernel_of(C, form);
        const int smem = form == 0 ? 0 : out[1];
        int per_sm = 0;
        if (form != 0)
            err = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, kernel, SW_THREADS, smem);
        if (form == 0) out[3] = per_sm;
        else out[2] = per_sm < out[2] ? per_sm : out[2];
    }
    return (int)err;
}

// rs: C pointers to (n,) float32 right-hand sides; dinv: (n,) float32;
// off: (n, K) float32; idx: (n, K) int32; za, zb: (C, n) float32 scratch.
// Runs z_0 = dinv*r and sweeps-1 iterations z_s = dinv*(r - A_off z_{s-1})
// that walk only the slots k < k_cap, in one cooperative launch of `blocks`
// blocks of `rows` rows each: form 0 streamed, form 1, 2, 4 or 8 resident
// with that many rows per thread and `smem` bytes of shared memory
// (>= 8 * k_cap * rows).  The result z_{sweeps-1} is left in za when sweeps
// is odd and in zb when it is even.  Returns a cudaError_t; a grid the card
// cannot hold at once returns cudaErrorCooperativeLaunchTooLarge.
int banded_jacobi_sweeps(const float* const* rs, int C, const float* dinv,
                         const float* off, const int* idx, float* za,
                         float* zb, int n, int K, int k_cap, int sweeps,
                         int form, int blocks, int rows, int smem,
                         void* stream) {
    const void* kernel = sweeps_kernel_of(C, form);
    if (kernel == nullptr || sweeps < 1 || k_cap < 0 || k_cap > K
        || blocks < 1 || rows < 1 || (long long)blocks * rows < n
        || (form > 0 && (rows > form * SW_THREADS
                         || smem < 8LL * k_cap * rows)))
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaSuccess;
    SweepArgs a = {};
    for (int c = 0; c < C; ++c) a.r[c] = rs[c];
    a.dinv = dinv;
    a.off = off;
    a.idx = idx;
    a.za = za;
    a.zb = zb;
    a.n = n;
    a.K = K;
    a.k_cap = k_cap;
    a.sweeps = sweeps;
    a.rows = rows;
    void* args[] = {&a};
    const cudaError_t err = cudaLaunchCooperativeKernel(
        kernel, dim3(blocks), dim3(SW_THREADS), args,
        form == 0 ? 0 : smem, (cudaStream_t)stream);
    // A refused launch leaves its error for the next check in the process
    // (PyTorch's own after its next kernel): take it back here.
    const cudaError_t last = cudaGetLastError();
    return (int)(err != cudaSuccess ? err : last);
}

// Human-readable text of a cudaError_t returned above.
const char* banded_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
