// The forms of the streamed momentum predict that csrc/stencil.cu chose
// between, for tools/momentum_forms.py to time side by side: threads per
// block (128 or 256), how a row's coefficients arrive (loaded into a
// register ring 3 rows ahead, or copied by cp.async into a shared ring
// AHEAD rows ahead), and the step loop (unrolled over the
// ring's period, or rolled with the ring shifted by moves).  The diagnostic
// bits DROP take parts out of the cp.async form to see what each costs
// (the results are then wrong): 1 the barrier, 2 the shared-memory E/W
// exchange, 4 the loads.  Every kept form is bit-equal to
// stencil_kernels.momentum_jacobi_ref; none is used by the solver.
#include <cuda_runtime.h>
namespace {
struct MomArgs { const float* r; const float* dinv; const float* off; float* out; int ny, nx; };

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory"); }

constexpr int AHEAD = 8, STAGE = AHEAD + 1;

struct Band {
    const float* r; const float* dinv; const float* off; float* out; float* stage;
    long long n; int ny, nx, gc, gcl; bool writes; int ei, wi, ra, r0, r1, rb;
};

template <int NT> __device__ __forceinline__ void load_row(float (&c)[7], const Band& b, int row) {
    const long long g = (long long)min(row, b.rb - 1) * b.nx + b.gcl;
    c[0] = __ldg(b.dinv + g); c[1] = __ldg(b.r + g); c[2] = __ldg(b.r + b.n + g);
#pragma unroll
    for (int s = 0; s < 4; ++s) c[3 + s] = __ldg(b.off + s * b.n + g);
}
template <int NT> __device__ __forceinline__ void issue_row(const Band& b, int row) {
    const long long g = (long long)min(row, b.rb - 1) * b.nx + b.gcl;
    float* st = b.stage + ((row - b.ra) % STAGE) * 7 * NT + threadIdx.x;
    cp_async4(st, b.dinv + g); cp_async4(st + NT, b.r + g); cp_async4(st + 2 * NT, b.r + b.n + g);
#pragma unroll
    for (int s = 0; s < 4; ++s) cp_async4(st + (3 + s) * NT, b.off + s * b.n + g);
    cp_async_commit();
}

// One level update of both components for level k: coefficients ck, E/W from rd.
template <int S, int NT, bool YC, int DROP>
__device__ __forceinline__ void levels(float (&z)[S][2], const float* (&ck)[S], float (&p1)[S - 1][2],
                                       float (&p2)[S - 1][2], const Band& b, int t, const float2* rd) {
#pragma unroll
    for (int k = 1; k < S; ++k) {
        const float2 e = (DROP & 2) ? make_float2(p1[k - 1][0], p1[k - 1][1]) : rd[(k - 1) * NT + b.ei];
        const float2 w = (DROP & 2) ? make_float2(p2[k - 1][0], p2[k - 1][1]) : rd[(k - 1) * NT + b.wi];
        const int j = t - k;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            const float zc = p1[k - 1][q];
            float zs = p2[k - 1][q], zn = z[k - 1][q];
            if (YC) { if (j == 0) zs = zc; if (j == b.ny - 1) zn = zc; }
            const float* c = ck[k];
            float acc = __fadd_rn(__fmul_rn(c[3], q ? e.y : e.x), __fmul_rn(c[4], q ? w.y : w.x));
            acc = __fadd_rn(acc, __fmul_rn(c[5], zn));
            acc = __fadd_rn(acc, __fmul_rn(c[6], zs));
            z[k][q] = __fmul_rn(c[0], __fsub_rn(c[1 + q], acc));
        }
    }
}

template <int S, int NT, int DROP>
__device__ __forceinline__ void finish(float (&z)[S][2], float (&p1)[S - 1][2], float (&p2)[S - 1][2],
                                       const Band& b, int t, float2* wr) {
    constexpr int H = S - 1;
#pragma unroll
    for (int k = 0; k < H; ++k)
        if (!(DROP & 2)) wr[k * NT + threadIdx.x] = make_float2(z[k][0], z[k][1]);
    const int jo = t - H;
    if (b.writes && jo >= b.r0 && jo < b.r1) {
        const long long g = (long long)jo * b.nx + b.gc;
        b.out[g] = z[H][0]; b.out[b.n + g] = z[H][1];
    }
#pragma unroll
    for (int k = 0; k < H; ++k)
#pragma unroll
        for (int q = 0; q < 2; ++q) { p2[k][q] = p1[k][q]; p1[k][q] = z[k][q]; }
}

template <int S, int NT>
__device__ __forceinline__ Band setup(const MomArgs& a, int tile_rows, float* stage) {
    constexpr int H = S - 1, TW = NT - 2 * H;
    Band b; const int tid = threadIdx.x;
    b.r = a.r; b.dinv = a.dinv; b.off = a.off; b.out = a.out; b.stage = stage;
    b.ny = a.ny; b.nx = a.nx; b.n = (long long)a.ny * a.nx;
    b.gc = blockIdx.x * TW - H + tid; b.gcl = min(max(b.gc, 0), a.nx - 1);
    b.writes = b.gc >= 0 && b.gc < a.nx && tid >= H && tid < H + TW;
    b.ei = b.gc == a.nx - 1 ? tid : min(tid + 1, NT - 1);
    b.wi = b.gc == 0 ? tid : max(tid - 1, 0);
    b.r0 = blockIdx.y * tile_rows; b.r1 = min(a.ny, b.r0 + tile_rows);
    b.ra = max(0, b.r0 - H); b.rb = min(a.ny, b.r1 + H);
    return b;
}

__device__ __forceinline__ bool need_yc(const Band& b, int t0, int len, int H) {
    return (b.ra == 0 && t0 <= H) || (b.rb == b.ny && t0 + len > b.ny && t0 <= b.ny + H - 1);
}

// MODE 0: register prefetch (P rows), ring of S + P rows, chunk unrolled.
template <int S, int NT, bool YC>
__device__ __forceinline__ void chunk_reg(float (&cf)[S + 3][7], float (&p1)[S - 1][2], float (&p2)[S - 1][2],
                                          const Band& b, int t0, int t_end, float2*& rd, float2*& wr) {
    constexpr int P = 3, L = S + P;
#pragma unroll
    for (int u = 0; u < L; ++u) {
        const int t = t0 + u;
        if (t >= t_end) break;
        load_row<NT>(cf[(u + P) % L], b, t + P);
        float z[S][2];
        z[0][0] = __fmul_rn(cf[u][0], cf[u][1]); z[0][1] = __fmul_rn(cf[u][0], cf[u][2]);
        const float* ck[S];
#pragma unroll
        for (int k = 0; k < S; ++k) ck[k] = cf[(u - k + L) % L];
        levels<S, NT, YC, 0>(z, ck, p1, p2, b, t, rd);
        finish<S, NT, 0>(z, p1, p2, b, t, wr);
        __syncthreads();
        float2* s = rd; rd = wr; wr = s;
    }
}

// MODE 1: cp.async staging, ring of S rows, chunk unrolled.
template <int S, int NT, bool YC, int DROP>
__device__ __forceinline__ void chunk_cp(float (&cf)[S][7], float (&p1)[S - 1][2], float (&p2)[S - 1][2],
                                         const Band& b, int t0, int t_end, float2*& rd, float2*& wr) {
#pragma unroll
    for (int u = 0; u < S; ++u) {
        const int t = t0 + u;
        if (t >= t_end) break;
        if (!(DROP & 4)) {
            issue_row<NT>(b, t + AHEAD);
            cp_async_wait<AHEAD>();
        }
        const float* st = b.stage + ((t - b.ra) % STAGE) * 7 * NT + threadIdx.x;
#pragma unroll
        for (int s = 0; s < 7; ++s) cf[u][s] = st[s * NT];
        float z[S][2];
        z[0][0] = __fmul_rn(cf[u][0], cf[u][1]); z[0][1] = __fmul_rn(cf[u][0], cf[u][2]);
        const float* ck[S];
#pragma unroll
        for (int k = 0; k < S; ++k) ck[k] = cf[(u - k + S) % S];
        levels<S, NT, YC, DROP>(z, ck, p1, p2, b, t, rd);
        finish<S, NT, DROP>(z, p1, p2, b, t, wr);
        if (!(DROP & 1)) __syncthreads();
        float2* s = rd; rd = wr; wr = s;
    }
}

// MODE 2: cp.async staging, rolled: the ring shifted by moves each step.
template <int S, int NT, bool YC>
__device__ __forceinline__ void step_roll(float (&cf)[S][7], float (&p1)[S - 1][2], float (&p2)[S - 1][2],
                                          const Band& b, int t, float2* rd, float2* wr) {
    issue_row<NT>(b, t + AHEAD);
    cp_async_wait<AHEAD>();
#pragma unroll
    for (int k = S - 1; k > 0; --k)
#pragma unroll
        for (int s = 0; s < 7; ++s) cf[k][s] = cf[k - 1][s];
    const float* st = b.stage + ((t - b.ra) % STAGE) * 7 * NT + threadIdx.x;
#pragma unroll
    for (int s = 0; s < 7; ++s) cf[0][s] = st[s * NT];
    float z[S][2];
    z[0][0] = __fmul_rn(cf[0][0], cf[0][1]); z[0][1] = __fmul_rn(cf[0][0], cf[0][2]);
    const float* ck[S];
#pragma unroll
    for (int k = 0; k < S; ++k) ck[k] = cf[k];
    levels<S, NT, YC, 0>(z, ck, p1, p2, b, t, rd);
    finish<S, NT, 0>(z, p1, p2, b, t, wr);
}

template <int S, int NT, int MODE, int MINB, int DROP>
__global__ void __launch_bounds__(NT, MINB) kern(MomArgs a, int tile_rows) {
    constexpr int H = S - 1;
    extern __shared__ float2 zsm[];
    Band b = setup<S, NT>(a, tile_rows, reinterpret_cast<float*>(zsm + 2 * H * NT));
    const int tid = threadIdx.x;
    const int t_end = b.r1 + H;
    if constexpr (MODE != 0) {
        for (int i = 0; i < AHEAD; ++i) issue_row<NT>(b, b.ra + i);
    }
    for (int i = tid; i < 2 * H * NT; i += NT) zsm[i] = make_float2(0.0f, 0.0f);
    float p1[H][2], p2[H][2];
#pragma unroll
    for (int k = 0; k < H; ++k) { p1[k][0] = p1[k][1] = p2[k][0] = p2[k][1] = 0.0f; }
    __syncthreads();
    float2* rd = zsm; float2* wr = zsm + H * NT;
    if constexpr (MODE == 0) {
        float cf[S + 3][7];
#pragma unroll
        for (int i = 0; i < 3; ++i) load_row<NT>(cf[i], b, b.ra + i);
        for (int t0 = b.ra; t0 < t_end; t0 += S + 3) {
            if (need_yc(b, t0, S + 3, H)) chunk_reg<S, NT, true>(cf, p1, p2, b, t0, t_end, rd, wr);
            else chunk_reg<S, NT, false>(cf, p1, p2, b, t0, t_end, rd, wr);
        }
    } else if constexpr (MODE == 1) {
        float cf[S][7];
        for (int t0 = b.ra; t0 < t_end; t0 += S) {
            if (need_yc(b, t0, S, H)) chunk_cp<S, NT, true, DROP>(cf, p1, p2, b, t0, t_end, rd, wr);
            else chunk_cp<S, NT, false, DROP>(cf, p1, p2, b, t0, t_end, rd, wr);
        }
    } else {
        float cf[S][7];
#pragma unroll
        for (int k = 0; k < S; ++k)
#pragma unroll
            for (int s = 0; s < 7; ++s) cf[k][s] = 0.0f;
        for (int t = b.ra; t < t_end; ++t) {
            if (need_yc(b, t, 1, H)) step_roll<S, NT, true>(cf, p1, p2, b, t, rd, wr);
            else step_roll<S, NT, false>(cf, p1, p2, b, t, rd, wr);
            __syncthreads();
            float2* s = rd; rd = wr; wr = s;
        }
    }
    if constexpr (MODE != 0) cp_async_wait<0>();
}

template <int S, int NT, int MODE>
constexpr int smem_of() { return 2 * (S - 1) * NT * 8 + (MODE != 0 ? STAGE * 7 * NT * 4 : 0); }

template <int S, int NT, int MODE, int MINB, int DROP>
cudaError_t run(const MomArgs* a, int tile_rows, cudaStream_t st, int* occupancy) {
    constexpr int TW = NT - 2 * (S - 1);
    constexpr int sm = smem_of<S, NT, MODE>();
    auto k = kern<S, NT, MODE, MINB, DROP>;
    cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, sm);
    if (e != cudaSuccess) return e;
    if (occupancy != nullptr) return cudaOccupancyMaxActiveBlocksPerMultiprocessor(occupancy, k, NT, sm);
    const dim3 grid((a->nx + TW - 1) / TW, (a->ny + tile_rows - 1) / tile_rows);
    k<<<grid, NT, sm, st>>>(*a, tile_rows);
    return cudaGetLastError();
}
}  // namespace

// form: 0 register ring unrolled, 1 cp.async unrolled, 2 cp.async rolled;
// threads 128 or 256; drop: the diagnostic bits (form 1 only).  With
// ``occupancy`` not null, only the resident blocks per SM are written
// there.  Sweeps 8 or 12.  Returns a cudaError_t (1 for a form not built).
extern "C" int momentum_form(int form, int threads, int drop, int sweeps, const float* r, const float* dinv,
                             const float* off, float* out, int ny, int nx, int tile_rows, void* stream,
                             int* occupancy) {
    const MomArgs a = {r, dinv, off, out, ny, nx};
    cudaStream_t st = (cudaStream_t)stream;
#define F(S, NT, M, B, D) \
    if (sweeps == S && threads == NT && form == M && drop == D) return (int)run<S, NT, M, B, D>(&a, tile_rows, st, occupancy);
#define FORMS(S) F(S, 256, 0, 1, 0) F(S, 256, 1, 1, 0) F(S, 256, 2, 1, 0) F(S, 128, 0, 2, 0) F(S, 128, 1, 2, 0) \
    F(S, 128, 2, 2, 0) F(S, 256, 1, 1, 1) F(S, 256, 1, 1, 2) F(S, 256, 1, 1, 4) F(S, 256, 1, 1, 7)
    FORMS(8) FORMS(12)
    return 1;
}
