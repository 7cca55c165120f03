// fused_choice: one pass over every (task, node) pair of an admission round.
//
// Replaces the Pallas TPU kernel volcano_tpu/ops/pallas_kernels.py::fused_choice
// (pallas_call at :201, body _kernel at :80-172). For each pair it computes
//   feasibility  sig != 0 & eligible & pods_ok & le_fits(init_req, avail)
//                with the positional thresholds cpu 10 / mem 1 / scalar 10,
//                scalar dims ignored when the request is <= 10, and the
//                scale-aware REL_FIT_TOL term;
//   score        binpack + kube (least / most / balanced over cpu, mem)
//                + node_static, in the exact float-op order of the plain
//                version (volcano_tpu_torch/ops/fused_choice.py::_score);
// and reduces it to
//   best_score[t], best_idx[t]  masked max over nodes, FIRST index on ties;
//   node_max[n]                 masked max over tasks.
//
// What bounds it on the H100: every launch reads the int8 [T,N] signature
// mask once (T*N bytes; 21 MB at T=10240, N=2048, 6.3 us at 3.35 TB/s) and
// issues 16-50 fp32 instructions per pair, depending on R and the score
// families (chip_smoke.py's fused_choice_cost counts them, charging
// per-node and per-task terms once: 0.34-1.05 G instructions per launch
// there). With --fmad=false each add, multiply and compare is its own
// instruction, at 33.5 T/s (half the data sheet's 67 TFLOP/s, which counts
// an FMA as two): 10-31 us, so the instructions bound it. The [T,N]
// feasibility and score matrices of the plain version never reach device
// memory: only [T] and [N] results do.
//
// Design (a simple, correct first version; making it fast is later work):
//  - Layout: [T,R] / [N,R] row-major, as the public function takes them (the
//    TPU version's transposes only put the long axis on lanes).
//  - A block owns BT = WARPS * ROWS task rows and walks ALL nodes in chunks of
//    32, so each task's argmax is a loop inside the block, not a sequential
//    grid. Lanes of a warp take consecutive nodes, so reads of a mask row are
//    coalesced; a warp owns ROWS task rows, each lane keeps a running
//    (best, idx) per row with strict '>' (first max wins along its nodes),
//    and a warp-shuffle reduce picks the max, taking the lower index on equal
//    scores.
//  - node_max crosses blocks: per chunk the block reduces its rows' column
//    maxima in shared memory and issues one atomicMax per node on an
//    order-preserving int encoding of the float. Max is exact, so the result
//    does not depend on block order. A third small pass decodes it in place.
//  - Float order: built with --fmad=false (never fast-math) so every add and
//    multiply rounds on its own, as the plain PyTorch version's do; the
//    grouping below is the plain version's term for term.
//  - Ragged edges are masked here: any T >= 1 and N >= 1 and R <= MAX_R.

#include <cuda_runtime.h>
#include <stdint.h>
#include <climits>
#include <cmath>

namespace {

constexpr int WARPS = 8;
constexpr int ROWS = 4;               // task rows per warp
constexpr int BT = WARPS * ROWS;      // task rows per block
constexpr int MAX_R = 8;
constexpr float NEG = -1e30f;
constexpr float REL_FIT_TOL = 5e-7f;
constexpr float THR_CPU = 10.0f;
constexpr float THR_MEM = 1.0f;
constexpr float THR_SCALAR = 10.0f;

__device__ __forceinline__ int float_to_ordered(float f) {
    int i = __float_as_int(f);
    return i >= 0 ? i : (i ^ 0x7fffffff);
}

__device__ __forceinline__ float ordered_to_float(int i) {
    return __int_as_float(i >= 0 ? i : (i ^ 0x7fffffff));
}

__device__ __forceinline__ float clip01(float x) {
    return fminf(fmaxf(x, 0.0f), 1.0f);
}

__global__ void fill_int_min(int* __restrict__ p, int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) p[i] = INT_MIN;
}

__global__ void decode_ordered(int* __restrict__ p, int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) reinterpret_cast<float*>(p)[i] = ordered_to_float(p[i]);
}

template <bool BINPACK, bool KUBE>
__global__ void __launch_bounds__(WARPS * 32)
fused_choice_kernel(const float* __restrict__ req,       // [T,R]
                    const float* __restrict__ elig,      // [T]
                    const int8_t* __restrict__ sig,      // [T,N]
                    const float* __restrict__ avail,     // [N,R]
                    const float* __restrict__ used,      // [N,R]
                    const float* __restrict__ inv,       // [N,R]
                    const float* __restrict__ nstat,     // [N]
                    const float* __restrict__ podsok,    // [N]
                    const float* __restrict__ pars,      // [5+R]
                    float* __restrict__ best_s,          // [T]
                    int* __restrict__ best_i,            // [T]
                    int* __restrict__ node_max_bits,     // [N]
                    int T, int N, int R) {
    __shared__ float s_req[BT][MAX_R];
    __shared__ float s_elig[BT];
    __shared__ int s_colmax[WARPS][32];

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int t0 = blockIdx.x * BT;

    for (int k = threadIdx.x; k < BT * MAX_R; k += blockDim.x) {
        const int row = k / MAX_R, r = k % MAX_R;
        const int t = t0 + row;
        s_req[row][r] = (t < T && r < R) ? req[(size_t)t * R + r] : 0.0f;
    }
    for (int k = threadIdx.x; k < BT; k += blockDim.x) {
        const int t = t0 + k;
        s_elig[k] = t < T ? elig[t] : 0.0f;
    }
    __syncthreads();

    const float p_bw = pars[0], p_least = pars[1], p_most = pars[2];
    const float p_bal = pars[3], p_scale = pars[4];

    float best[ROWS];
    int bidx[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
        best[i] = -INFINITY;
        bidx[i] = INT_MAX;
    }

    for (int n0 = 0; n0 < N; n0 += 32) {
        const int j = n0 + lane;
        float colmax = -INFINITY;
        if (j < N) {
            float av[MAX_R], us[MAX_R], iv[MAX_R], wial[MAX_R];
            float bpn = 0.0f;
#pragma unroll
            for (int r = 0; r < MAX_R; ++r) {
                if (r < R) {
                    av[r] = avail[(size_t)j * R + r];
                    us[r] = used[(size_t)j * R + r];
                    iv[r] = inv[(size_t)j * R + r];
                    if (BINPACK) {
                        const float w = pars[5 + r];
                        wial[r] = w * iv[r];
                        bpn = bpn + (us[r] * w) * iv[r];
                    }
                }
            }
            const float ns = nstat[j];
            const bool pok = podsok[j] != 0.0f;

#pragma unroll
            for (int i = 0; i < ROWS; ++i) {
                const int row = warp * ROWS + i;
                const int t = t0 + row;
                if (t >= T) continue;
                const float* rq = s_req[row];
                bool f = pok && (s_elig[row] != 0.0f)
                         && (sig[(size_t)t * N + j] != 0);
#pragma unroll
                for (int r = 0; r < MAX_R; ++r) {
                    if (r < R) {
                        const float thr = r == 0 ? THR_CPU
                                          : (r == 1 ? THR_MEM : THR_SCALAR);
                        bool ok = (rq[r] < av[r] + (thr + REL_FIT_TOL * fabsf(av[r])))
                                  || (rq[r] <= av[r]);
                        if (r >= 2) ok = ok || (rq[r] <= 10.0f);
                        f = f && ok;
                    }
                }
                float score = 0.0f;
                if (BINPACK) {
                    float bpt = 0.0f;
#pragma unroll
                    for (int r = 0; r < MAX_R; ++r)
                        if (r < R) bpt = bpt + rq[r] * wial[r];
                    score = score + (p_bw * (bpt + bpn)) * p_scale;
                }
                if (KUBE) {
                    const float f0 = (us[0] + rq[0]) * iv[0];
                    const float f1 = (us[1] + rq[1]) * iv[1];
                    const float least =
                        ((clip01(1.0f - f0) + clip01(1.0f - f1)) / 2.0f) * 100.0f;
                    const float most = ((clip01(f0) + clip01(f1)) / 2.0f) * 100.0f;
                    const float bal = (1.0f - fabsf(f0 - f1)) * 100.0f;
                    score = score + ((p_least * least + p_most * most) + p_bal * bal);
                }
                score = score + ns;
                const float m = f ? score : NEG;
                if (m > best[i]) {
                    best[i] = m;
                    bidx[i] = j;
                }
                colmax = fmaxf(colmax, m);
            }
        }
        s_colmax[warp][lane] = float_to_ordered(colmax);
        __syncthreads();
        if (warp == 0 && j < N) {
            int m = s_colmax[0][lane];
#pragma unroll
            for (int w = 1; w < WARPS; ++w) m = max(m, s_colmax[w][lane]);
            atomicMax(&node_max_bits[j], m);
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
        float b = best[i];
        int ix = bidx[i];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const float ob = __shfl_xor_sync(0xffffffffu, b, off);
            const int oi = __shfl_xor_sync(0xffffffffu, ix, off);
            if (ob > b || (ob == b && oi < ix)) {
                b = ob;
                ix = oi;
            }
        }
        const int t = t0 + warp * ROWS + i;
        if (lane == 0 && t < T) {
            best_s[t] = b;
            best_i[t] = ix;
        }
    }
}

}  // namespace

// All pointers are device pointers of contiguous tensors; the caller checks
// shapes and dtypes. families: bit 0 = binpack, bit 1 = kube. Returns the
// cudaError_t of the launches (0 on success).
extern "C" int fused_choice_launch(const float* req, const float* elig,
                                   const int8_t* sig, const float* avail,
                                   const float* used, const float* inv,
                                   const float* nstat, const float* podsok,
                                   const float* pars, float* best_s,
                                   int* best_i, float* node_max, int T, int N,
                                   int R, int families, void* stream) {
    if (T < 1 || N < 1 || R < 2 || R > MAX_R) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    int* bits = reinterpret_cast<int*>(node_max);
    const int fill_blocks = (N + 255) / 256;
    fill_int_min<<<fill_blocks, 256, 0, s>>>(bits, N);
    const dim3 grid((T + BT - 1) / BT);
    const dim3 block(WARPS * 32);
    const bool bp = families & 1, kube = families & 2;
    if (bp && kube)
        fused_choice_kernel<true, true><<<grid, block, 0, s>>>(
            req, elig, sig, avail, used, inv, nstat, podsok, pars, best_s,
            best_i, bits, T, N, R);
    else if (bp)
        fused_choice_kernel<true, false><<<grid, block, 0, s>>>(
            req, elig, sig, avail, used, inv, nstat, podsok, pars, best_s,
            best_i, bits, T, N, R);
    else if (kube)
        fused_choice_kernel<false, true><<<grid, block, 0, s>>>(
            req, elig, sig, avail, used, inv, nstat, podsok, pars, best_s,
            best_i, bits, T, N, R);
    else
        fused_choice_kernel<false, false><<<grid, block, 0, s>>>(
            req, elig, sig, avail, used, inv, nstat, podsok, pars, best_s,
            best_i, bits, T, N, R);
    decode_ordered<<<fill_blocks, 256, 0, s>>>(bits, N);
    return (int)cudaGetLastError();
}
