// Indexed gather, fused gather-dot and multi-sweep Jacobi over an (M, K) int32
// neighbour map, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernels in
// cfd2_tpu/ops/banded_gather.py:
//   * banded_gather        <- _kernel via _banded_raw with prods=None
//                             (banded_gather_nk / banded_gather2_nk):
//                             out[i, k, c] = x[idx[i, k], c];
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
//   sweeps: per sweep 4*(n*K idx + n*K off + (2C + 1)*n) bytes; nothing stays
//           resident between sweeps (design (a) below), so the bound is
//           (sweeps - 1) times that plus the seed pass 4*(2C + 1)*n.
// What the design does about it:
//   * gather runs one thread per output element, so stores are fully coalesced
//     and the C components of one neighbour are read from adjacent addresses;
//   * dot runs one thread per row, loads idx[i, k] once per slot, gathers each
//     operand once per slot into registers, accumulates every output in an f32
//     register and writes n_out values per row: the gathered (M, K) values
//     never reach device memory.  Operand reads of neighbouring rows hit
//     nearby addresses because cells are ordered so that neighbours fall in
//     narrow index bands;
//   * sweeps: on the TPU the grid runs in order, so phase s can follow phase
//     s-1 inside one kernel with the iterate in VMEM scratch.  Blocks on a GPU
//     run in no order, so phase s must not start before phase s-1 is complete
//     everywhere.  Design (a): the one exported function enqueues the seed
//     kernel and then sweeps-1 sweep kernels on the caller's stream,
//     ping-ponging between two scratch buffers that the wrapper allocates;
//     stream order is the grid-wide barrier.  (A cooperative launch with
//     grid.sync() is the alternative; it is left for a later change.)
//
// All functions have a plain C interface (loaded with ctypes), launch on the
// caller's stream, allocate nothing, and return cudaGetLastError() after the
// launch so that the caller can raise on a refused launch.

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
    float* out[MAX_OUT];
    int pair_off[MAX_PAIRS];   // coefficient plane of product p
    int pair_x[MAX_PAIRS];     // operand of product p
    int pair_start[MAX_OUT + 1];   // products of output j: [start[j], start[j+1])
    int n_out;
};

struct SweepArgs {
    const float* r[MAX_RHS];
};

__global__ void banded_gather_kernel(const float* __restrict__ x,
                                     const int* __restrict__ idx,
                                     float* __restrict__ out,
                                     long long n_elems, int C) {
    const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= n_elems) return;
    const long long slot = e / C;            // flat (row, k)
    const int c = (int)(e - slot * C);
    out[e] = x[(long long)idx[slot] * C + c];
}

template <int NX>
__global__ void banded_dot_kernel(DotArgs a, const int* __restrict__ idx,
                                  int M, int K) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= M) return;
    float acc[MAX_OUT];
#pragma unroll
    for (int j = 0; j < MAX_OUT; ++j) acc[j] = 0.0f;
    const long long row = (long long)i * K;
    for (int k = 0; k < K; ++k) {
        const long long e = row + k;
        const int src = idx[e];
        float xv[NX];
#pragma unroll
        for (int c = 0; c < NX; ++c) xv[c] = a.x[c][src];
#pragma unroll
        for (int j = 0; j < MAX_OUT; ++j) {
            if (j < a.n_out) {
                float s = 0.0f;
                for (int p = a.pair_start[j]; p < a.pair_start[j + 1]; ++p) {
                    const int px = a.pair_x[p];
                    float v = xv[0];
                    if (NX > 1 && px == 1) v = xv[NX > 1 ? 1 : 0];
                    if (NX > 2 && px == 2) v = xv[NX > 2 ? 2 : 0];
                    s += a.off[a.pair_off[p]][e] * v;
                }
                acc[j] += s;
            }
        }
    }
#pragma unroll
    for (int j = 0; j < MAX_OUT; ++j) {
        if (j < a.n_out) a.out[j][i] = acc[j];
    }
}

template <int C>
__global__ void jacobi_seed_kernel(SweepArgs a, const float* __restrict__ dinv,
                                   float* __restrict__ z, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float d = dinv[i];
#pragma unroll
    for (int c = 0; c < C; ++c) z[(long long)c * n + i] = d * a.r[c][i];
}

template <int C>
__global__ void jacobi_sweep_kernel(SweepArgs a, const float* __restrict__ dinv,
                                    const float* __restrict__ off,
                                    const int* __restrict__ idx,
                                    const float* __restrict__ z_src,
                                    float* __restrict__ z_dst,
                                    int n, int K, int k_cap) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float sig[C];
#pragma unroll
    for (int c = 0; c < C; ++c) sig[c] = 0.0f;
    const long long row = (long long)i * K;
    for (int k = 0; k < k_cap; ++k) {
        const int src = idx[row + k];
        const float o = off[row + k];
#pragma unroll
        for (int c = 0; c < C; ++c) sig[c] += o * z_src[(long long)c * n + src];
    }
    const float d = dinv[i];
#pragma unroll
    for (int c = 0; c < C; ++c)
        z_dst[(long long)c * n + i] = d * (a.r[c][i] - sig[c]);
}

template <int C>
int launch_sweeps(SweepArgs a, const float* dinv, const float* off,
                  const int* idx, float* za, float* zb, int n, int K,
                  int k_cap, int sweeps, cudaStream_t stream) {
    const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
    jacobi_seed_kernel<C><<<blocks, THREADS, 0, stream>>>(a, dinv, za, n);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    // z_s lives in za for even s and in zb for odd s.
    for (int s = 1; s < sweeps; ++s) {
        const float* src = (s & 1) ? za : zb;
        float* dst = (s & 1) ? zb : za;
        jacobi_sweep_kernel<C><<<blocks, THREADS, 0, stream>>>(
            a, dinv, off, idx, src, dst, n, K, k_cap);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaSuccess;
}

}  // namespace

extern "C" {

// x: (n_src, C) float32; idx: (M, K) int32 with values in [0, n_src);
// out: (M, K, C) float32.  Returns a cudaError_t.
int banded_gather(const float* x, const int* idx, float* out, int M, int K,
                  int C, void* stream) {
    const long long n_elems = (long long)M * K * C;
    if (n_elems == 0) return (int)cudaSuccess;
    const unsigned blocks = (unsigned)((n_elems + THREADS - 1) / THREADS);
    banded_gather_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        x, idx, out, n_elems, C);
    return (int)cudaGetLastError();
}

// xs: n_x pointers to (n_src,) float32 operands; offs: n_off pointers to
// (M, K) float32 coefficient planes; outs: n_out pointers to (M,) float32;
// idx: (M, K) int32.  Output j sums the products p in
// [pair_start[j], pair_start[j+1]): offs[pair_off[p]][i, k] *
// xs[pair_x[p]][idx[i, k]] over k.  Returns a cudaError_t, or
// cudaErrorInvalidValue when a count exceeds the kernel's limits.
int banded_dot(const float* const* xs, int n_x, const float* const* offs,
               int n_off, float* const* outs, int n_out, const int* pair_off,
               const int* pair_x, const int* pair_start, const int* idx,
               int M, int K, void* stream) {
    if (n_x < 1 || n_x > MAX_X || n_off < 1 || n_off > MAX_OFF || n_out < 1
        || n_out > MAX_OUT || pair_start[n_out] > MAX_PAIRS)
        return (int)cudaErrorInvalidValue;
    DotArgs a = {};
    for (int c = 0; c < n_x; ++c) a.x[c] = xs[c];
    for (int p = 0; p < n_off; ++p) a.off[p] = offs[p];
    for (int j = 0; j < n_out; ++j) a.out[j] = outs[j];
    for (int j = 0; j <= n_out; ++j) a.pair_start[j] = pair_start[j];
    for (int p = 0; p < pair_start[n_out]; ++p) {
        if (pair_off[p] < 0 || pair_off[p] >= n_off || pair_x[p] < 0
            || pair_x[p] >= n_x)
            return (int)cudaErrorInvalidValue;
        a.pair_off[p] = pair_off[p];
        a.pair_x[p] = pair_x[p];
    }
    a.n_out = n_out;
    if (M == 0) return (int)cudaSuccess;
    const unsigned blocks = (unsigned)((M + THREADS - 1) / THREADS);
    const cudaStream_t st = (cudaStream_t)stream;
    switch (n_x) {
        case 1: banded_dot_kernel<1><<<blocks, THREADS, 0, st>>>(a, idx, M, K); break;
        case 2: banded_dot_kernel<2><<<blocks, THREADS, 0, st>>>(a, idx, M, K); break;
        default: banded_dot_kernel<3><<<blocks, THREADS, 0, st>>>(a, idx, M, K); break;
    }
    return (int)cudaGetLastError();
}

// rs: C pointers to (n,) float32 right-hand sides; dinv: (n,) float32;
// off: (n, K) float32; idx: (n, K) int32; za, zb: (C, n) float32 scratch.
// Runs z_0 = dinv*r and sweeps-1 iterations z_s = dinv*(r - A_off z_{s-1})
// that walk only the slots k < k_cap.  The result z_{sweeps-1} is left in za
// when sweeps is odd and in zb when it is even.  Returns a cudaError_t.
int banded_jacobi_sweeps(const float* const* rs, int C, const float* dinv,
                         const float* off, const int* idx, float* za,
                         float* zb, int n, int K, int k_cap, int sweeps,
                         void* stream) {
    if (C < 1 || C > MAX_RHS || sweeps < 1 || k_cap < 0 || k_cap > K)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaSuccess;
    SweepArgs a = {};
    for (int c = 0; c < C; ++c) a.r[c] = rs[c];
    const cudaStream_t st = (cudaStream_t)stream;
    switch (C) {
        case 1: return launch_sweeps<1>(a, dinv, off, idx, za, zb, n, K, k_cap, sweeps, st);
        case 2: return launch_sweeps<2>(a, dinv, off, idx, za, zb, n, K, k_cap, sweeps, st);
        case 3: return launch_sweeps<3>(a, dinv, off, idx, za, zb, n, K, k_cap, sweeps, st);
        default: return launch_sweeps<4>(a, dinv, off, idx, za, zb, n, K, k_cap, sweeps, st);
    }
}

// Human-readable text of a cudaError_t returned above.
const char* banded_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
