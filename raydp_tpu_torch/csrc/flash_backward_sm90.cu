// The bf16 flash attention backward for Hopper (sm_90a): tensor cores
// through wgmma, Q/K/V/dO through TMA, a warp-specialised pipeline.
//
// Replaces, in raydp_tpu/ops/flash_attention.py (flash_backward_blocks),
// for bf16 q/k/v:
//   flash_bwd_dq   <- _bwd_dq_kernel, launched by the pallas_call for dq
//   flash_bwd_dkv  <- _bwd_dkv_kernel, launched by the pallas_call for dk/dv
// rtt_flash_bwd_dq / rtt_flash_bwd_dkv (flash_backward.cu) send bf16 here
// and f32 to the CUDA-core bodies there, which stay as they were.
//
// With s = scale * q.k, p = exp(s - lse) (exactly 0 where masked: k_pos >
// q_pos or past either ragged edge), dp = do.v and ds = p * (dp - dsum) *
// scale: dq = sum_k ds * k, dk = sum_q ds * q, dv = sum_q p * do.
//
// What bounds them on an H100: operations. Each live (query, key) pair
// costs dq 6 * D operations (s, dp, ds.k) and dk/dv 8 * D (s, dp, p.do,
// ds.q) against 2 bytes per element of q, k, v, do and the outputs: at the
// training shape ([2, 8, 8192, 128] causal) 0.42 + 0.56 ms of bf16 tensor-
// core time for the pair, about 0.97 ms, against ~0.05 ms of HBM traffic.
//
// The design: two kernels, as in the JAX package, each output owned by one
// block, so no atomics and a fixed order of sums (the same bits on every
// launch); both recompute s and dp, the work the bound above counts.
// - flash_bwd_dkv_sm90_kernel: one block per (bh, 128-key tile), tile 0
//   (the most causal work) first; two consumer warpgroups of 64 keys and a
//   producer warpgroup whose first thread issues every load (setmaxnreg
//   24/240). K and V come once; Q, dO and the tile's lse and dsum come in
//   64-query tiles through a two-stage mbarrier ring (lse and dsum through
//   a 1-D tensor map). Per q-tile: S^T = K Q^T and dP^T = V dO^T (wgmma
//   m64n64k16, both operands K-major); P^T = exp(S^T scale - lse[col]) and
//   dS^T = P^T (dP^T - dsum[col]) scale in f32, each rounded to bf16 A
//   fragments in registers; dV += P^T dO and dK += dS^T Q, with dO and Q
//   read MN-major (the transpose bit) from the same swizzled tiles the
//   first products read K-major. dK and dV (2 x 64 f32 a thread at D 128)
//   stay in registers until the end.
// - flash_bwd_dq_sm90_kernel: one block per (bh, 128-query tile), the
//   longest causal rows first, the same warpgroups (64 queries each). Q
//   and dO come once, K and V in 64-key tiles through the ring; a row's
//   lse and dsum stay in registers. Per key tile: S = Q K^T and dP = dO V^T;
//   dS to bf16 fragments; dQ += dS K, K read MN-major.
// - Causal: a block walks only the tiles that can see its rows or keys; a
//   warpgroup skips a tile where none of its pairs is live, and only tiles
//   that cross the diagonal, the offsets or a ragged edge are masked
//   (live ? exp(...) : 0, never exp of NEG_INF, so rows with no live key,
//   lse = NEG_INF, get exactly 0). The 3-D tensor maps [BH, T, D] read
//   rows past T as zeros, not the next head's.
// - Rounding p and ds to bf16 before their products is this port's
//   declared difference from the reference, which feeds them in f32
//   (chip_smoke.bf16_bwd_limit is the bound it is held to).
//
// What it leaves for later: a single kernel with a fixed-order dq
// reduction in place of recomputing s and dp twice, persistent blocks,
// overlap of one tile's softmax with the next tile's products (each tile
// waits for its own), and TMA stores of the outputs.

#include "sm90_common.cuh"

namespace {

constexpr int kOwnRows = 128;  // own tile: keys (dk/dv), queries (dq)
constexpr int kStep = 64;      // a ring tile: queries (dk/dv), keys (dq)
constexpr int kStages = 2;     // ring depth
constexpr int kConsumers = 2;  // warpgroups of 64 own rows
constexpr int kThreads = (kConsumers + 1) * 128;

// Shared-memory layout in bytes from a 1024-aligned base: two own tiles
// (K, V or Q, dO), two ring tiles per stage (Q, dO or K, V), the ring's
// lse and dsum (dk/dv only), then the barriers (own, full[], empty[]).
template <int D>
struct BwdLayout {
  static constexpr int kSub = D / 64;
  static constexpr int kOwnSub = kOwnRows * 128;  // 64 bf16 columns
  static constexpr int kStepSub = kStep * 128;
  static constexpr int kOwn = kSub * kOwnSub;
  static constexpr int kRing = kSub * kStepSub;
  static constexpr int kA = 0;
  static constexpr int kB = kA + kOwn;
  static constexpr int kX = kB + kOwn;
  static constexpr int kY = kX + kStages * kRing;
  static constexpr int kStats = kY + kStages * kRing;  // lse[], dsum[]
  static constexpr int kBar = kStats + 2 * kStages * kStep * 4;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

struct Bars {
  uint32_t own, full, empty;  // full / empty: + 8 * stage
};

__device__ __forceinline__ Bars init_bars(uint32_t at) {
  const Bars bars{at, at + 8, at + 8 + 8 * kStages};
  if (threadIdx.x == 0) {
    mbar_init(bars.own, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars.full + 8 * s, 1);
      mbar_init(bars.empty + 8 * s, kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return bars;
}

// The own tiles a and b (kOwnRows rows at row0) onto bars.own.
template <int D>
__device__ __forceinline__ void load_own(uint32_t s_a, const CUtensorMap* a,
                                         uint32_t s_b, const CUtensorMap* b,
                                         const Bars& bars, int row0, int bh) {
  using L = BwdLayout<D>;
  mbar_expect_tx(bars.own, 2 * L::kOwn);
#pragma unroll
  for (int j = 0; j < L::kSub; ++j) {
    tma_load(s_a + j * L::kOwnSub, a, bars.own, 64 * j, row0, bh);
    tma_load(s_b + j * L::kOwnSub, b, bars.own, 64 * j, row0, bh);
  }
}

// S = A B^T into acc (m64n64), A 64 rows of an own tile from byte `a_row`
// on, B a ring tile: both K-major, D / 16 steps of k16.
template <int D>
__device__ __forceinline__ void product_ss(float (&acc)[32], uint32_t s_a,
                                           uint32_t a_row, uint32_t s_b) {
  using L = BwdLayout<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t along = (kk % 4) * 32;
    const uint32_t a = s_a + (kk / 4) * L::kOwnSub + along + a_row;
    const uint32_t b = s_b + (kk / 4) * L::kStepSub + along;
    wgmma_ss_n64(acc, sw128_desc(a, 16, 1024), sw128_desc(b, 16, 1024),
                 kk > 0);
  }
}

// q/do [BH, T, D], k/v [BH, Tk, D] bf16 (through the tensor maps), lse and
// dsum [BH * T] f32 (1-D maps) -> dk, dv [BH, Tk, D] bf16.
// grid (BH, ceil(Tk / kOwnRows)), kThreads threads.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_lse,
                          const __grid_constant__ CUtensorMap tm_dsum,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int t, int tk,
                          int q_off, int k_off, int causal, float scale) {
  using L = BwdLayout<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t s_k = base + L::kA;
  const uint32_t s_v = base + L::kB;
  const uint32_t s_q = base + L::kX;   // + stage * L::kRing
  const uint32_t s_do = base + L::kY;  // + stage * L::kRing
  const uint32_t s_lse = base + L::kStats;              // + 4 kStep stage
  const uint32_t s_dsum = s_lse + 4 * kStep * kStages;  // + 4 kStep stage
  const float* stats =
      reinterpret_cast<const float*>(smem_raw + (base - raw) + L::kStats);
  const Bars bars = init_bars(base + L::kBar);

  const int bh = blockIdx.x;
  const int key0 = blockIdx.y * kOwnRows;
  const int q_tiles = (t + kStep - 1) / kStep;
  int first = 0;  // causal: the first q-tile with a query at or after key0
  if (causal) first = min(q_tiles, max(0, k_off + key0 - q_off) / kStep);
  const int n_tiles = q_tiles - first;

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kConsumers * 128 && n_tiles > 0) {
      load_own<D>(s_k, &tm_k, s_v, &tm_v, bars, key0, bh);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const int q0 = (first + it) * kStep;
        const uint32_t full = bars.full + 8 * s;
        mbar_wait(bars.empty + 8 * s, ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full, 2 * L::kRing + 2 * 4 * kStep);
#pragma unroll
        for (int j = 0; j < L::kSub; ++j) {
          const uint32_t at = s * L::kRing + j * L::kStepSub;
          tma_load(s_q + at, &tm_q, full, 64 * j, q0, bh);
          tma_load(s_do + at, &tm_do, full, 64 * j, q0, bh);
        }
        tma_load_1d(s_lse + 4 * kStep * s, &tm_lse, full, bh * t + q0);
        tma_load_1d(s_dsum + 4 * kStep * s, &tm_dsum, full, bh * t + q0);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wkey0 = key0 + 64 * wg;       // first key of the warpgroup
  const int r_in = 16 * warp + lane / 4;  // + 8 * half: key in the warpgroup

  float dk_acc[D / 2];
  float dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }
  float st[32];   // S^T, then P^T
  float dpt[32];  // dP^T, then dS^T
  uint32_t pa[16];
  uint32_t da[16];

  if (n_tiles > 0) mbar_wait(bars.own, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const int q0 = (first + it) * kStep;
    const uint32_t ring_q = s_q + s * L::kRing;
    const uint32_t ring_do = s_do + s * L::kRing;
    mbar_wait(bars.full + 8 * s, (it / kStages) & 1);
    // no live pair for this warpgroup: its keys past Tk, or after every query
    const bool dead =
        wkey0 >= tk || (causal && q_off + q0 + kStep - 1 < k_off + wkey0);
    if (!dead) {
      wgmma_fence();
      product_ss<D>(st, s_k, 64 * 128 * wg, ring_q);
      product_ss<D>(dpt, s_v, 64 * 128 * wg, ring_do);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(dpt);

      const float* lse = stats + kStep * s;
      const float* dsum = stats + kStep * (kStages + s);
      const bool edge = q0 + kStep > t || wkey0 + 64 > tk ||
                        (causal && q_off + q0 < k_off + wkey0 + 63);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = col_of(i, lane);
        bool live = true;
        if (edge) {
          const int key = wkey0 + r_in + 8 * half_of(i);
          const int q = q0 + col;
          live = q < t && key < tk && (!causal || q_off + q >= k_off + key);
        }
        const float p =
            live ? __expf(__fsub_rn(__fmul_rn(st[i], scale), lse[col])) : 0.f;
        dpt[i] = __fmul_rn(__fmul_rn(p, __fsub_rn(dpt[i], dsum[col])), scale);
        st[i] = p;
      }
      to_a_fragments(st, pa);
      to_a_fragments(dpt, da);

      // dV += P^T dO and dK += dS^T Q over the tile's queries in steps of
      // 16 (16 rows of 128 bytes), dO and Q MN-major
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(pa);
      fence_regs(da);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kStep / 16; ++kk) {
        wgmma_pv<D>(dv_acc, pa + 4 * kk,
                    sw128_desc(ring_do + kk * 16 * 128, L::kStepSub, 1024));
      }
#pragma unroll
      for (int kk = 0; kk < kStep / 16; ++kk) {
        wgmma_pv<D>(dk_acc, da + 4 * kk,
                    sw128_desc(ring_q + kk * 16 * 128, L::kStepSub, 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(pa);
      fence_regs(da);
    }
    mbar_arrive(bars.empty + 8 * s);  // this thread is done with the stage
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = wkey0 + r_in + 8 * h;
    if (key >= tk) continue;
    const size_t grow = static_cast<size_t>(bh) * tk + key;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
      const size_t idx = grow * D + 8 * nb + 2 * (lane & 3);
      const int i = 4 * nb + 2 * h;
      *reinterpret_cast<__nv_bfloat162*>(dk + idx) =
          __floats2bfloat162_rn(dk_acc[i], dk_acc[i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + idx) =
          __floats2bfloat162_rn(dv_acc[i], dv_acc[i + 1]);
    }
  }
}

// The same inputs (lse and dsum as plain pointers) -> dq [BH, T, D] bf16.
// grid (BH, ceil(T / kOwnRows)), kThreads threads.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const float* __restrict__ lse,
                         const float* __restrict__ dsum,
                         __nv_bfloat16* __restrict__ dq, int t, int tk,
                         int q_off, int k_off, int causal, float scale) {
  using L = BwdLayout<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base + L::kA;
  const uint32_t s_do = base + L::kB;
  const uint32_t s_k = base + L::kX;  // + stage * L::kRing
  const uint32_t s_v = base + L::kY;  // + stage * L::kRing
  const Bars bars = init_bars(base + L::kBar);

  const int bh = blockIdx.x;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * kOwnRows;
  const int rows = min(kOwnRows, t - row0);
  int k_end = tk;  // keys [0, k_end) can be live for some row of the block
  if (causal) k_end = max(0, min(tk, q_off + row0 + rows - k_off));
  const int n_tiles = (k_end + kStep - 1) / kStep;

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kConsumers * 128 && n_tiles > 0) {
      load_own<D>(s_q, &tm_q, s_do, &tm_do, bars, row0, bh);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const uint32_t full = bars.full + 8 * s;
        mbar_wait(bars.empty + 8 * s, ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full, 2 * L::kRing);
#pragma unroll
        for (int j = 0; j < L::kSub; ++j) {
          const uint32_t at = s * L::kRing + j * L::kStepSub;
          tma_load(s_k + at, &tm_k, full, 64 * j, it * kStep, bh);
          tma_load(s_v + at, &tm_v, full, 64 * j, it * kStep, bh);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wrow0 = row0 + 64 * wg;       // first query row of the warpgroup
  const int r_in = 16 * warp + lane / 4;  // + 8 * half: row in the warpgroup

  float row_lse[2];
  float row_dsum[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wrow0 + r_in + 8 * h;
    const size_t grow = static_cast<size_t>(bh) * t + row;
    row_lse[h] = row < t ? lse[grow] : 0.f;
    row_dsum[h] = row < t ? dsum[grow] : 0.f;
  }
  float dq_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
  float sc[32];  // S
  float dp[32];  // dP, then dS
  uint32_t da[16];

  if (n_tiles > 0) mbar_wait(bars.own, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const int kt0 = it * kStep;
    const uint32_t ring_k = s_k + s * L::kRing;
    mbar_wait(bars.full + 8 * s, (it / kStages) & 1);
    // no live pair for this warpgroup: its rows past T, or before every key
    const bool dead =
        wrow0 >= t || (causal && q_off + wrow0 + 63 < k_off + kt0);
    if (!dead) {
      wgmma_fence();
      product_ss<D>(sc, s_q, 64 * 128 * wg, ring_k);
      product_ss<D>(dp, s_do, 64 * 128 * wg, s_v + s * L::kRing);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      const bool edge = kt0 + kStep > tk ||
                        (causal && q_off + wrow0 < k_off + kt0 + kStep - 1);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = half_of(i);
        bool live = true;
        if (edge) {
          const int key = kt0 + col_of(i, lane);
          const int row = wrow0 + r_in + 8 * h;
          live = key < tk && (!causal || q_off + row >= k_off + key);
        }
        const float e = __fsub_rn(__fmul_rn(sc[i], scale), row_lse[h]);
        const float p = live ? __expf(e) : 0.f;
        dp[i] = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[i], row_dsum[h])), scale);
      }
      to_a_fragments(dp, da);

      // dQ += dS K over the tile's keys in steps of 16, K MN-major
      fence_regs(dq_acc);
      fence_regs(da);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kStep / 16; ++kk) {
        wgmma_pv<D>(dq_acc, da + 4 * kk,
                    sw128_desc(ring_k + kk * 16 * 128, L::kStepSub, 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dq_acc);
      fence_regs(da);
    }
    mbar_arrive(bars.empty + 8 * s);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wrow0 + r_in + 8 * h;
    if (row >= t) continue;
    const size_t grow = static_cast<size_t>(bh) * t + row;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
      const size_t idx = grow * D + 8 * nb + 2 * (lane & 3);
      const int i = 4 * nb + 2 * h;
      *reinterpret_cast<__nv_bfloat162*>(dq + idx) =
          __floats2bfloat162_rn(dq_acc[i], dq_acc[i + 1]);
    }
  }
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* dsum, void* dq, int bh, int t,
              int tk, int q_off, int k_off, int causal, float scale,
              cudaStream_t stream) {
  if (tk == 0) {  // no key: dq is 0
    return static_cast<int>(cudaMemsetAsync(
        dq, 0, sizeof(__nv_bfloat16) * bh * t * D, stream));
  }
  CUtensorMap map_q, map_k, map_v, map_do;
  if (!make_map(&map_q, q, bh, t, D, kOwnRows) ||
      !make_map(&map_do, dout, bh, t, D, kOwnRows) ||
      !make_map(&map_k, k, bh, tk, D, kStep) ||
      !make_map(&map_v, v, bh, tk, D, kStep)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = flash_bwd_dq_sm90_kernel<D>;
  const size_t smem = BwdLayout<D>::kBytes;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (t + kOwnRows - 1) / kOwnRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      map_q, map_k, map_v, map_do, lse, dsum, static_cast<__nv_bfloat16*>(dq),
      t, tk, q_off, k_off, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* dsum, void* dk, void* dv,
               int bh, int t, int tk, int q_off, int k_off, int causal,
               float scale, cudaStream_t stream) {
  if (t == 0) {  // no query: dk and dv are 0
    const size_t bytes = sizeof(__nv_bfloat16) * bh * tk * D;
    cudaError_t err = cudaMemsetAsync(dk, 0, bytes, stream);
    if (err == cudaSuccess) err = cudaMemsetAsync(dv, 0, bytes, stream);
    return static_cast<int>(err);
  }
  CUtensorMap map_q, map_k, map_v, map_do, map_lse, map_dsum;
  if (!make_map(&map_q, q, bh, t, D, kStep) ||
      !make_map(&map_do, dout, bh, t, D, kStep) ||
      !make_map(&map_k, k, bh, tk, D, kOwnRows) ||
      !make_map(&map_v, v, bh, tk, D, kOwnRows) ||
      !make_rows_map(&map_lse, lse, bh * t, kStep) ||
      !make_rows_map(&map_dsum, dsum, bh * t, kStep)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = flash_bwd_dkv_sm90_kernel<D>;
  const size_t smem = BwdLayout<D>::kBytes;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (tk + kOwnRows - 1) / kOwnRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      map_q, map_k, map_v, map_do, map_lse, map_dsum,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), t, tk,
      q_off, k_off, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Called by rtt_flash_bwd_dq / rtt_flash_bwd_dkv for bf16 q/k/v; each
// returns cudaGetLastError() after its launch, or cudaErrorInvalidValue for
// a head dim it does not take or tensors TMA cannot address (a base not
// 16-byte aligned).
int flash_bwd_dq_sm90(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* dsum,
                      void* dq, int bh, int t, int tk, int d, int q_off,
                      int k_off, int causal, float scale, cudaStream_t stream) {
  if (bh == 0 || t == 0) return static_cast<int>(cudaSuccess);
  if (d == 64) {
    return launch_dq<64>(q, k, v, dout, lse, dsum, dq, bh, t, tk, q_off, k_off,
                         causal, scale, stream);
  }
  if (d == 128) {
    return launch_dq<128>(q, k, v, dout, lse, dsum, dq, bh, t, tk, q_off,
                          k_off, causal, scale, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int flash_bwd_dkv_sm90(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* dsum,
                       void* dk, void* dv, int bh, int t, int tk, int d,
                       int q_off, int k_off, int causal, float scale,
                       cudaStream_t stream) {
  if (bh == 0 || tk == 0) return static_cast<int>(cudaSuccess);
  if (d == 64) {
    return launch_dkv<64>(q, k, v, dout, lse, dsum, dk, dv, bh, t, tk, q_off,
                          k_off, causal, scale, stream);
  }
  if (d == 128) {
    return launch_dkv<128>(q, k, v, dout, lse, dsum, dk, dv, bh, t, tk, q_off,
                           k_off, causal, scale, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
