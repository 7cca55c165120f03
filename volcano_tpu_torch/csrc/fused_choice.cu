// fused_choice: one pass over every (eligible task, node) pair of an
// admission round.
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
// The results equal the plain version's bit for bit. Scores are taken to
// be numbers: the flatten gives every node allocatable > 0, so inv_alloc is
// finite. On a NaN score torch.argmax picks the NaN and this kernel does
// not.
//
// What bounds it on the H100: the fp32 instruction rate. Each eligible pair
// needs 12-45 fp32 instructions at R = 2-3 (fused_choice_cost in
// ops/fused_choice.py counts them), one per lane per clock (33.5 T/s: built with
// --fmad=false, never fast-math, so every add and multiply rounds on its
// own as the plain version's do). The int8 [T,N] mask (21 MB at T=10240,
// N=2048) stays in the 50 MB L2 across the solve's rounds, and reading it
// takes less time than the instructions. The [T,N] feasibility and score
// matrices never reach device memory.
//
// Design, against the five costs of the first version (a warp per four
// task rows walking all nodes 32 at a time, two block barriers a chunk):
//  1. Node terms once per block, held in registers. A block owns BN
//     consecutive nodes (32 lanes x RN nodes; RN = 4 up to R = 3, else 2)
//     and a range of task rows. Each lane computes its RN nodes' terms
//     (fit thresholds, binpack's w*inv and node sum, kube's used and inv,
//     node_static, pods_ok) once and keeps them in registers while it walks
//     the rows. G blocks (16 at the headline) compute a node's terms; a
//     prologue kernel would cost more than that, as a launch and a round
//     trip through device memory.
//  2. Register micro-tiles: a lane scores RN consecutive nodes of a row
//     from ONE 4-byte (RN=4) or 2-byte load of the mask, so a warp reads
//     one 128-byte line a row. Loads of the warp's next U rows start
//     before the current U rows are scored: double buffering in registers.
//     A lane's share of a row is one word, so a cp.async ring in shared
//     memory would add a store and a load per word and buy nothing.
//  3. No barrier in the row loop. A warp scores its U rows, then reduces
//     each row's best across the lanes with one redux.sync on the ordered
//     key, a ballot for the first lane holding it and one shuffle for its
//     index. Column maxima stay in registers over all of a block's rows and
//     cross the warps once, at the block's end, through shared memory.
//  4. Even grid: S node tiles x G row ranges, G = resident block slots
//     (occupancy x SMs) / S, so the grid is one full wave.
//  5. Ineligible rows skipped: a block compacts its rows' eligible indices
//     (and their requests) into shared memory, a ballot and one shared
//     atomicAdd per warp, and scores only those. An ineligible row's answer
//     is the plain version's (NEG, 0), written by the epilogue. Rows are
//     independent, so their order in the compacted list changes nothing.
//  Exact rewrites of the per-pair work (each equal to the plain version's
//  decision on every input, infinities and NaN included):
//  - fit: plain asks (rq < a + (thr + tol*|a|)) | (rq <= a) per dim. For
//    finite a the threshold exceeds a, so this is rq <= the next float
//    below the threshold: one compare, the bound computed per node. A
//    scalar dim's request <= 10 always fits: the row's request is turned
//    into -inf there, a per-row select;
//  - the plain version adds each first term to a zero score; 0 + x == x
//    but for the sign of a zero, so the add is left out. No compare sees
//    the sign (the packed key turns -0.0 into +0.0, and so does the
//    epilogue for node_max), so every output keeps the plain bits;
//  - a node past N repeats node N-1 (terms and mask byte): it scores what
//    N-1 scores and, later in the lane, never wins a strict '>'.
//  Merges across blocks are exact and order-free, with no atomics:
//  - a row's best in a node tile goes to scratch as a packed 64-bit key:
//    high word the order-preserving encoding of the score (-0.0 turned
//    into +0.0 first), low word 0xFFFFFFFF - idx. The largest key is the
//    highest score and, among equal scores, the lowest index: the first-
//    index rule in any order. The epilogue takes the max over the S tiles
//    and decodes it. Writing the S keys costs no more than S 64-bit
//    atomicMax calls, and needs no launch to initialise the keys;
//  - a block's column maxima go to scratch [G, N]; the epilogue takes the
//    max over G. A block whose rows include an ineligible one floors its
//    maxima at NEG, which is what those rows contribute.
//  Two launches per call: the main kernel and the epilogue.
//  - Layout: [T,R] / [N,R] row-major, as the public function takes them.
//  - Ragged edges: any T >= 1, N >= 1 and 2 <= R <= MAX_R; the mask is read
//    by words only where N is a multiple of RN, bytes elsewhere.

#include <cuda_runtime.h>
#include <stdint.h>
#include <cmath>
#include <type_traits>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int CHUNK = 1024;            // task rows compacted at a time
constexpr int U = 4;                   // rows a warp scores per step
constexpr int MAX_R = 8;
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -1e30f;
constexpr float REL_FIT_TOL = 5e-7f;
constexpr float THR_CPU = 10.0f;
constexpr float THR_MEM = 1.0f;
constexpr float THR_SCALAR = 10.0f;

// nodes per lane: R <= 3 keeps every node term in registers at 4 nodes.
// (8 nodes a lane at R = 2 measured no faster on the H100: more row ranges
// per node tile cost more set-up than the shorter row reductions saved.)
template <int R>
struct Tile {
    static constexpr int RN = R <= 3 ? 4 : 2;
    static constexpr int BN = 32 * RN;
};

__device__ __forceinline__ float clip01(float x) {
    return fminf(fmaxf(x, 0.0f), 1.0f);
}

// order-preserving: a > b (as floats, -0 == +0) iff key(a) > key(b)
__device__ __forceinline__ uint32_t score_key(float f) {
    const uint32_t u = __float_as_uint(f + 0.0f);   // -0.0 -> +0.0
    return u ^ ((uint32_t)((int32_t)u >> 31) | 0x80000000u);
}

__device__ __forceinline__ float key_score(uint32_t k) {
    return __uint_as_float((k & 0x80000000u) ? (k ^ 0x80000000u) : ~k);
}

// scratch: keys [S,T] u64 at byte 0, then column maxima [G,N] f32
struct Plan {
    int S, G;               // node tiles, row ranges
    long long col_off, bytes;
};

template <int R, bool BINPACK, bool KUBE>
__global__ void __launch_bounds__(THREADS, 2)
fused_choice_main(const float* __restrict__ req,       // [T,R]
                  const float* __restrict__ elig,      // [T]
                  const int8_t* __restrict__ sig,      // [T,N]
                  const float* __restrict__ avail,     // [N,R]
                  const float* __restrict__ used,      // [N,R]
                  const float* __restrict__ inv,       // [N,R]
                  const float* __restrict__ nstat,     // [N]
                  const float* __restrict__ podsok,    // [N]
                  const float* __restrict__ pars,      // [5+R]
                  unsigned long long* __restrict__ keys,  // [S,T] scratch
                  float* __restrict__ colpart,            // [G,N] scratch
                  int T, int N) {
    constexpr int RN = Tile<R>::RN;
    constexpr int BN = Tile<R>::BN;
    __shared__ int s_rows[CHUNK];
    __shared__ float s_req[CHUNK * R];
    __shared__ float s_col[WARPS][BN];
    __shared__ int s_cnt;

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int split = blockIdx.x;
    const int j0 = split * BN + lane * RN;
    // Where N is a multiple of RN the mask is read by words, else by bytes.
    // A lane wholly past N reads (terms and mask) the last RN nodes again,
    // a partial lane repeats node N-1: either scores what a lower lane (or
    // an earlier node of its own) scores, and never wins a first-index tie.
    const bool words = (N % RN) == 0
                       && reinterpret_cast<uintptr_t>(sig) % RN == 0;
    const int jb = words ? min(j0, N - RN) : j0;

    const int per = (T + gridDim.y - 1) / gridDim.y;
    const int r0 = blockIdx.y * per;
    const int r1 = min(T, r0 + per);
    bool any_inel = false;

    // a chunk's eligible flags; the first chunk's load before the node
    // terms, so the two round trips overlap
    constexpr int PER = CHUNK / THREADS;
    bool e[PER];
    auto load_elig = [&](int c0) {
        const int c1 = min(r1, c0 + CHUNK);
#pragma unroll
        for (int u = 0; u < PER; ++u) {
            const int t = c0 + u * THREADS + threadIdx.x;
            e[u] = t < c1 && elig[t] != 0.0f;
            any_inel |= t < c1 && !e[u];
        }
    };
    if (r0 < r1) load_elig(r0);

    // -- per-node terms of this lane's RN nodes, in the plain float order
    const float p_bw = pars[0], p_least = pars[1], p_most = pars[2];
    const float p_bal = pars[3], p_scale = pars[4];
    float fit_le[RN][R], wial[RN][R], bpn[RN];
    float us0[RN], us1[RN], iv0[RN], iv1[RN], ns[RN];
    uint32_t pok_bytes = 0;                      // 0xff in byte k where pods_ok
#pragma unroll
    for (int k = 0; k < RN; ++k) {
        const int jj = min(jb + k, N - 1);
        bpn[k] = 0.0f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const float a = avail[(size_t)jj * R + r];
            const float u = used[(size_t)jj * R + r];
            const float iv = inv[(size_t)jj * R + r];
            const float th = r == 0 ? THR_CPU : (r == 1 ? THR_MEM : THR_SCALAR);
            // plain: (rq < a + (th + tol*|a|)) | (rq <= a). For finite a the
            // threshold is > a (th >= 1 and tol*|a| both exceed half an ulp
            // of a), so the test is rq <= the next float below it. At a =
            // +-inf it is rq <= a, at a = NaN it is false; a scalar dim's
            // small-request rule turns rq into -inf (see fit_rq), so there
            // a NaN threshold becomes -inf. One compare per dim.
            const float thr = a + (th + REL_FIT_TOL * fabsf(a));
            fit_le[k][r] = a != a ? (r >= 2 ? -INFINITY : a)         // NaN
                           : fabsf(a) == INFINITY ? a : nextafterf(thr, -INFINITY);
            if (BINPACK) {
                const float w = pars[5 + r];
                wial[k][r] = w * iv;
                bpn[k] = bpn[k] + (u * w) * iv;
            }
            if (r == 0) { us0[k] = u; iv0[k] = iv; }
            if (r == 1) { us1[k] = u; iv1[k] = iv; }
        }
        ns[k] = nstat[jj];
        if (podsok[jj] != 0.0f) pok_bytes |= (uint32_t)0xff << (8 * k);
    }
    float colmax[RN];
#pragma unroll
    for (int k = 0; k < RN; ++k) colmax[k] = -INFINITY;

    // this lane's RN mask bytes of row t, byte k for node k (one load on
    // the word path)
    auto load_word = [&](int t, auto words_tag) -> uint32_t {
        const int8_t* p = sig + (size_t)t * N;
        if (decltype(words_tag)::value)
            return RN == 4 ? __ldg(reinterpret_cast<const uint32_t*>(p + jb))
                           : (uint32_t)__ldg(reinterpret_cast<const uint16_t*>(p + jb));
        uint32_t w = 0;
#pragma unroll
        for (int k = 0; k < RN; ++k)
            w |= (uint32_t)(uint8_t)__ldg(p + min(jb + k, N - 1)) << (8 * k);
        return w;
    };

    // U rows of the warp's row group g: score all U, then reduce all U (the
    // rows are independent, so their pair work and their reductions
    // overlap). GUARD: the group runs past the compacted count.
    auto score_group = [&](int g, int cnt, const int* t_of, const uint32_t* w_of,
                           auto guard) {
        constexpr bool GUARD = decltype(guard)::value;
        float best[U];
        int bidx[U];
#pragma unroll
        for (int q = 0; q < U; ++q) {
            const int p = g * U + q;                 // < CHUNK: cnt <= CHUNK
            float rq[R], fit_rq[R];
#pragma unroll
            for (int r = 0; r < R; ++r) {
                rq[r] = s_req[p * R + r];
                // a scalar dim's request <= 10 always fits: test -inf
                fit_rq[r] = r >= 2 && rq[r] <= 10.0f ? -INFINITY : rq[r];
            }
            const uint32_t wm = w_of[q] & pok_bytes;
            best[q] = -INFINITY;
            bidx[q] = j0;
#pragma unroll
            for (int k = 0; k < RN; ++k) {
                bool f = ((uint32_t)(wm >> (8 * k)) & 0xffu) != 0u;
#pragma unroll
                for (int r = 0; r < R; ++r) f = f & (fit_rq[r] <= fit_le[k][r]);
                // plain adds each first term to a zero score: 0 + x == x but
                // for the sign of a zero, which no compare below can see
                float score = 0.0f;
                if (BINPACK) {
                    float bpt = rq[0] * wial[k][0];
#pragma unroll
                    for (int r = 1; r < R; ++r) bpt = bpt + rq[r] * wial[k][r];
                    score = (p_bw * (bpt + bpn[k])) * p_scale;
                }
                if (KUBE) {
                    const float f0 = (us0[k] + rq[0]) * iv0[k];
                    const float f1 = (us1[k] + rq[1]) * iv1[k];
                    const float least =
                        ((clip01(1.0f - f0) + clip01(1.0f - f1)) / 2.0f) * 100.0f;
                    const float most = ((clip01(f0) + clip01(f1)) / 2.0f) * 100.0f;
                    const float bal = (1.0f - fabsf(f0 - f1)) * 100.0f;
                    const float kube = (p_least * least + p_most * most) + p_bal * bal;
                    score = BINPACK ? score + kube : kube;
                }
                score = (BINPACK || KUBE) ? score + ns[k] : ns[k];
                float m = f ? score : NEG;
                if (GUARD && p >= cnt) m = -INFINITY;   // no row: no value
                if (m > best[q]) {                   // strict: first index wins
                    best[q] = m;
                    bidx[q] = j0 + k;
                }
                colmax[k] = fmaxf(colmax[k], m);
            }
        }
#pragma unroll
        for (int q = 0; q < U; ++q) {
            // the row's best over this tile: highest key, lowest lane
            const uint32_t key = score_key(best[q]);
            const uint32_t kmax = __reduce_max_sync(FULL, key);
            const int src = __ffs(__ballot_sync(FULL, key == kmax)) - 1;
            const int idx = __shfl_sync(FULL, bidx[q], src);
            if (lane == 0 && (!GUARD || g * U + q < cnt))
                keys[(size_t)split * T + t_of[q]] =
                    ((unsigned long long)kmax << 32) | (0xffffffffu - (uint32_t)idx);
        }
    };

    // -- score a compacted chunk: warp w takes row groups w, w + WARPS, ...
    //    of U rows; the next group's mask words load while this one scores
    auto scan = [&](int cnt, auto words_tag) {
        int cur_t[U];
        uint32_t cur_w[U];
#pragma unroll
        for (int q = 0; q < U; ++q) {
            const int p = warp * U + q;
            cur_t[q] = p < cnt ? s_rows[p] : -1;
            cur_w[q] = p < cnt ? load_word(cur_t[q], words_tag) : 0;
        }
        for (int g = warp; g * U < cnt; g += WARPS) {
            int nxt_t[U];
            uint32_t nxt_w[U];
#pragma unroll
            for (int q = 0; q < U; ++q) {
                const int p = (g + WARPS) * U + q;
                nxt_t[q] = p < cnt ? s_rows[p] : -1;
                nxt_w[q] = p < cnt ? load_word(nxt_t[q], words_tag) : 0;
            }
            if ((g + 1) * U <= cnt)
                score_group(g, cnt, cur_t, cur_w, std::false_type{});
            else
                score_group(g, cnt, cur_t, cur_w, std::true_type{});
#pragma unroll
            for (int q = 0; q < U; ++q) {
                cur_t[q] = nxt_t[q];
                cur_w[q] = nxt_w[q];
            }
        }
    };

    for (int c0 = r0; c0 < r1; c0 += CHUNK) {
        // -- compact this chunk's eligible rows (and their requests)
        if (c0 != r0) load_elig(c0);
        float rv[PER][R];                    // every load before the ballots
#pragma unroll
        for (int u = 0; u < PER; ++u)
#pragma unroll
            for (int r = 0; r < R; ++r)
                rv[u][r] = e[u] ? req[(size_t)(c0 + u * THREADS + threadIdx.x) * R + r]
                                : 0.0f;
        if (threadIdx.x == 0) s_cnt = 0;
        __syncthreads();
#pragma unroll
        for (int u = 0; u < PER; ++u) {
            const unsigned bal = __ballot_sync(FULL, e[u]);
            int base = 0;
            if (lane == 0 && bal) base = atomicAdd(&s_cnt, __popc(bal));
            base = __shfl_sync(FULL, base, 0);
            if (e[u]) {
                const int pos = base + __popc(bal & ((1u << lane) - 1u));
                s_rows[pos] = c0 + u * THREADS + threadIdx.x;
#pragma unroll
                for (int r = 0; r < R; ++r) s_req[pos * R + r] = rv[u][r];
            }
        }
        __syncthreads();
        const int cnt = s_cnt;
        if (words)
            scan(cnt, std::true_type{});
        else
            scan(cnt, std::false_type{});
        __syncthreads();    // s_rows / s_req are rewritten by the next chunk
    }

    // -- column maxima: across the warps once, then one write per node
#pragma unroll
    for (int k = 0; k < RN; ++k) s_col[warp][lane * RN + k] = colmax[k];
    const bool floor_neg = __syncthreads_or(any_inel);
    for (int i = threadIdx.x; i < BN; i += THREADS) {
        const int n = split * BN + i;
        if (n >= N) continue;
        float m = floor_neg ? NEG : -INFINITY;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) m = fmaxf(m, s_col[w][i]);
        colpart[(size_t)blockIdx.y * N + n] = m;
    }
}

// Blocks [0, row_blocks) decode the rows, the rest reduce the node maxima.
__global__ void fused_choice_epilogue(const float* __restrict__ elig,
                                      const unsigned long long* __restrict__ keys,
                                      const float* __restrict__ colpart,
                                      float* __restrict__ best_s,
                                      int* __restrict__ best_i,
                                      float* __restrict__ node_max,
                                      int T, int N, int S, int G,
                                      int row_blocks) {
    if ((int)blockIdx.x < row_blocks) {
        const int i = blockIdx.x * blockDim.x + threadIdx.x;
        if (i >= T) return;
        if (elig[i] == 0.0f) {          // every pair NEG: argmax is index 0
            best_s[i] = NEG;
            best_i[i] = 0;
            return;
        }
        unsigned long long k = 0;
#pragma unroll 16
        for (int s = 0; s < S; ++s) {
            const unsigned long long v = keys[(size_t)s * T + i];
            k = v > k ? v : k;
        }
        best_s[i] = key_score((uint32_t)(k >> 32));
        best_i[i] = (int)(0xffffffffu - (uint32_t)k);
    } else {
        const int n = (blockIdx.x - row_blocks) * blockDim.x + threadIdx.x;
        if (n >= N) return;
        float m = -INFINITY;
#pragma unroll 16
        for (int g = 0; g < G; ++g) m = fmaxf(m, colpart[(size_t)g * N + n]);
        node_max[n] = m + 0.0f;         // -0.0 -> +0.0, as the plain 0 + x
    }
}

template <int R, bool BP, bool KU>
cudaError_t plan_for(int T, int N, Plan* plan) {
    static int blocks_per_sm = 0;       // occupancy of this instantiation
    if (blocks_per_sm == 0) {
        cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks_per_sm, fused_choice_main<R, BP, KU>, THREADS, 0);
        if (e != cudaSuccess) return e;
        if (blocks_per_sm < 1) blocks_per_sm = 1;
    }
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    const int S = (N + Tile<R>::BN - 1) / Tile<R>::BN;
    int G = blocks_per_sm * sms / S;
    G = G < 1 ? 1 : (G > T ? T : G);
    plan->S = S;
    plan->G = G;
    plan->col_off = (long long)S * T * 8;
    plan->bytes = plan->col_off + (long long)G * N * 4;
    return cudaSuccess;
}

template <int R, bool BP, bool KU>
cudaError_t run(const float* req, const float* elig, const int8_t* sig,
                const float* avail, const float* used, const float* inv,
                const float* nstat, const float* podsok, const float* pars,
                float* best_s, int* best_i, float* node_max, char* scratch,
                long long scratch_bytes, int T, int N, cudaStream_t s,
                long long* need) {
    Plan p;
    cudaError_t e = plan_for<R, BP, KU>(T, N, &p);
    if (e != cudaSuccess) return e;
    if (need) {                         // size query only
        *need = p.bytes;
        return cudaSuccess;
    }
    if (scratch_bytes < p.bytes) return cudaErrorInvalidValue;
    auto* keys = reinterpret_cast<unsigned long long*>(scratch);
    auto* colpart = reinterpret_cast<float*>(scratch + p.col_off);
    fused_choice_main<R, BP, KU><<<dim3(p.S, p.G), THREADS, 0, s>>>(
        req, elig, sig, avail, used, inv, nstat, podsok, pars, keys, colpart,
        T, N);
    const int row_blocks = (T + 255) / 256;
    fused_choice_epilogue<<<row_blocks + (N + 255) / 256, 256, 0, s>>>(
        elig, keys, colpart, best_s, best_i, node_max, T, N, p.S, p.G,
        row_blocks);
    return cudaGetLastError();
}

template <int R>
cudaError_t run_families(int families, const float* req, const float* elig,
                         const int8_t* sig, const float* avail,
                         const float* used, const float* inv,
                         const float* nstat, const float* podsok,
                         const float* pars, float* best_s, int* best_i,
                         float* node_max, char* scratch,
                         long long scratch_bytes, int T, int N,
                         cudaStream_t s, long long* need) {
#define FC_RUN(BP, KU)                                                      \
    return run<R, BP, KU>(req, elig, sig, avail, used, inv, nstat, podsok, \
                          pars, best_s, best_i, node_max, scratch,         \
                          scratch_bytes, T, N, s, need)
    switch (families & 3) {
        case 3: FC_RUN(true, true);
        case 1: FC_RUN(true, false);
        case 2: FC_RUN(false, true);
        default: FC_RUN(false, false);
    }
#undef FC_RUN
}

cudaError_t dispatch(int R, int families, const float* req, const float* elig,
                     const int8_t* sig, const float* avail, const float* used,
                     const float* inv, const float* nstat,
                     const float* podsok, const float* pars, float* best_s,
                     int* best_i, float* node_max, char* scratch,
                     long long scratch_bytes, int T, int N, cudaStream_t s,
                     long long* need) {
#define FC_R(RR)                                                              \
    case RR:                                                                  \
        return run_families<RR>(families, req, elig, sig, avail, used, inv,  \
                                nstat, podsok, pars, best_s, best_i,         \
                                node_max, scratch, scratch_bytes, T, N, s,   \
                                need)
    switch (R) {
        FC_R(2); FC_R(3); FC_R(4); FC_R(5); FC_R(6); FC_R(7); FC_R(8);
        default: return cudaErrorInvalidValue;
    }
#undef FC_R
}

}  // namespace

// Bytes of device scratch one call at this shape needs (0 on error); the
// caller allocates it and passes it to fused_choice_launch.
extern "C" long long fused_choice_scratch_bytes(int T, int N, int R,
                                                int families) {
    if (T < 1 || N < 1 || R < 2 || R > MAX_R) return 0;
    long long need = 0;
    if (dispatch(R, families, nullptr, nullptr, nullptr, nullptr, nullptr,
                 nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                 nullptr, nullptr, 0, T, N, nullptr, &need) != cudaSuccess)
        return 0;
    return need;
}

// All pointers are device pointers of contiguous tensors; the caller checks
// shapes and dtypes. families: bit 0 = binpack, bit 1 = kube. Returns the
// cudaError_t of the launches (0 on success).
extern "C" int fused_choice_launch(const float* req, const float* elig,
                                   const int8_t* sig, const float* avail,
                                   const float* used, const float* inv,
                                   const float* nstat, const float* podsok,
                                   const float* pars, float* best_s,
                                   int* best_i, float* node_max,
                                   void* scratch, long long scratch_bytes,
                                   int T, int N, int R, int families,
                                   void* stream) {
    if (T < 1 || N < 1 || R < 2 || R > MAX_R) return (int)cudaErrorInvalidValue;
    return (int)dispatch(R, families, req, elig, sig, avail, used, inv, nstat,
                         podsok, pars, best_s, best_i, node_max,
                         static_cast<char*>(scratch), scratch_bytes, T, N,
                         static_cast<cudaStream_t>(stream), nullptr);
}
