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
// - flash_bwd_dkv_sm90_kernel at D 64 and 128: one block per (bh, 128-key
//   tile), tile 0 (the most causal work) first; two consumer warpgroups of 64
//   keys and a producer warpgroup whose first thread issues every load
//   (setmaxnreg 24/240). K and V come once; Q, dO and the tile's lse and dsum
//   come in 64-query tiles through a two-stage mbarrier ring (lse and dsum
//   through a 1-D tensor map). Per q-tile: S^T = K Q^T and dP^T = V dO^T (wgmma
//   m64n64k16, both operands K-major); P^T = exp(S^T scale - lse[col]) and dS^T
//   = P^T (dP^T - dsum[col]) scale in f32, each rounded to bf16 A fragments in
//   registers; dV += P^T dO and dK += dS^T Q, with dO and Q read MN-major (the
//   transpose bit) from the same swizzled tiles the first products read
//   K-major. dK and dV (2 x 64 f32 a thread at D 128) stay in registers until
//   the end.
// - flash_bwd_dq_sm90_kernel at D 64 and 128: one block per (bh, 128-query
//   tile), the longest causal rows first, the same warpgroups (64 queries
//   each). Q and dO come once, K and V in 64-key tiles through the ring; a
//   row's lse and dsum stay in registers. Per key tile: S = Q K^T and dP =
//   dO V^T; dS to bf16 fragments; dQ += dS K, K read MN-major.
// - Causal: a block walks only the tiles that can see its rows or keys; a
//   warpgroup skips a tile where none of its pairs is live (D 256 dq masks
//   it), and only tiles that cross the diagonal, the offsets or a ragged
//   edge are masked (live ? exp(...) : 0; at D 256 exp of kNegInf, also
//   exactly 0; never exp of NEG_INF, so rows with no live key, lse =
//   NEG_INF, get exactly 0). The 3-D tensor maps [BH, T, D] read rows past
//   T as zeros, not the next head's.
// - Rounding p and ds to bf16 before their products is this port's
//   declared difference from the reference, which feeds them in f32
//   (chip_smoke.bf16_bwd_limit is the bound it is held to).
// - Head dim 256 has bodies of its own (explicit specialisations <256>),
//   since neither design above fits a block's 227 KB of shared memory and
//   a consumer thread's 240 registers there (a m64n256 accumulator is 128
//   registers a thread).
//   dk/dv: one block per (bh, 64 keys); K and V 64 KB, the ring 2 x (32 +
//   32) KB of Q and dO tiles of 64 queries, two P^T buffers of 16 KB: 224
//   KB. dK and dV together would be 256 registers a thread, so each
//   warpgroup keeps one over the block's 64 keys and computes one of the
//   products that feed both: warpgroup 0 S^T and P^T (exp, masking, lse),
//   which it writes in f32 to a buffer, then dV += P^T dO; warpgroup 1
//   dP^T, then, once that tile's P^T is written (named barriers, one pair
//   a buffer), dS^T = P^T (dP^T - dsum) scale and dK += dS^T Q. S^T is
//   computed once, 8 D operations a live pair, and each warpgroup issues
//   two products a tile; with two buffers warpgroup 0 writes the next
//   tile's P^T while warpgroup 1 reads this one's. p crosses in f32, so
//   dS^T and dK see the bits that a warpgroup computing p itself would.
//   dq: one block per (bh, 128 queries), 64 a warpgroup; Q and dO 128 KB,
//   K and V in 32-key tiles (S, dP and dQ fit 240 registers only so)
//   through a ring of three stages, 3 x (16 + 16) KB: 224 KB. A warpgroup
//   issues key tile i's S and dP and then tile i - 1's dQ += dS K, forms
//   tile i's dS while that product runs, and hands tile i - 1's stage back
//   once it is done: the third stage holds tile i + 1 meanwhile. dq masks
//   a tile where a warpgroup has no live pair rather than skip it.
//   In both, each warpgroup issues the next tile's first product before it
//   waits for this tile's last, so its products run back to back; every
//   group is waited for within the loop's body, since ptxas serialises
//   wgmma (C7515, C7520) whose registers are in flight across a branch or
//   the back edge. A live key is a column up to each row's last (dq) or
//   within each key's first and last query (dk/dv): two registers a row,
//   not a flag an element, so the softmax of a tile fits beside the
//   accumulator in flight.
// - Head dims below 64 (8, 16 and 32) run the D 64 bodies, as the forward
//   does (flash_forward_sm90.cu): tensor maps over the true d columns, the
//   TMA's zero fill past them, so s and dp are exact, and dq, dk and dv
//   store only their first d columns, at pitch d. Any other D up to 256
//   arrives zero-padded by the wrapper to the next width built.
// - Head dims past 256 (bench.py's LM at d_model 4096: 8 heads of 512)
//   arrive zero-padded by the wrapper to a multiple of kHeadChunk (256) and
//   run flash_bwd_dq_sm90_chunked_kernel / flash_bwd_dkv_sm90_chunked_kernel.
//   Q and dO over all of D would not fit (256 KB at D 512), and the
//   gradients over all of D would take 256 registers a thread, so the
//   design is cut by the gradient's columns: a grid axis over 256-column
//   chunks, the block's own chunk a m64n256 accumulator (dq: 128 queries,
//   64 a warpgroup; dk/dv: 64 keys, warpgroup 0 dV, warpgroup 1 dK, each
//   computing S^T itself, warpgroup 1 also dP^T). S and dP are summed over
//   all of D from a ring
//   of (A, B) 64-column sub-tile pairs (dq: Q or dO of its queries with K
//   or V of a 32-key tile; dk/dv: K or V of its keys with Q or dO of a
//   32-query tile; 20 / 12 KB a stage, 8 / 12 stages), the tensor cores
//   summing each 256-column chunk and the chunks added in f32 on the CUDA
//   cores (as the chunked forward does: one tensor-core sum over D 1536 put
//   its l 1e-5 off). The walked tile's own 256 columns of the product's
//   operand (dq: K; dk/dv: Q and dO, with the tile's lse and dsum) come
//   through a second ring of two stages: 194 KB (dq), 210 KB (dk/dv). Tiles
//   of 32 keys or queries keep S, dP and a chunk's partial sum (16
//   registers each) beside the m64n256 accumulator within 240 registers.
//   Every chunk's block recomputes S and dP over all of D, and re-reads its
//   own rows' operands (Q and dO, or K and V) for every 32-row tile.
//
// What it leaves for later: a single kernel with a fixed-order dq
// reduction in place of recomputing s and dp twice, persistent blocks,
// below D 256 and past it overlap of one tile's softmax with the next
// tile's products (each tile waits for its own), and TMA stores of the
// outputs.

#include "sm90_common.cuh"

namespace {

constexpr int kStages = 2;     // ring depth (D 256 dq: DqTiles<256>)
constexpr int kConsumers = 2;  // warpgroups
constexpr int kThreads = (kConsumers + 1) * 128;

// Shared-memory layout in bytes from a 1024-aligned base: two own tiles
// (K, V or Q, dO), two ring tiles per stage of kS (Q, dO or K, V), the
// ring's lse and dsum (dk/dv only), kHandoff bytes of buffers between the
// warpgroups (D 256 dk/dv: P^T), then the barriers (own, full[], empty[]).
template <int D, int kOwnRows, int kStep, int kS = kStages, int kHandoff = 0>
struct BwdLayout {
  static constexpr int kRingStages = kS;
  static constexpr int kSub = D / 64;
  static constexpr int kOwnSub = kOwnRows * 128;  // 64 bf16 columns
  static constexpr int kStepSub = kStep * 128;
  static constexpr int kOwn = kSub * kOwnSub;
  static constexpr int kRing = kSub * kStepSub;
  static constexpr int kA = 0;
  static constexpr int kB = kA + kOwn;
  static constexpr int kX = kB + kOwn;
  static constexpr int kY = kX + kS * kRing;
  static constexpr int kStats = kY + kS * kRing;  // lse[], dsum[]
  static constexpr int kHand = kStats + 2 * kS * kStep * 4;
  static constexpr int kBar = kHand + kHandoff;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kS) + 1024;
};

// Each kernel's tiles at head dim D: its own rows (dk/dv: keys, dq:
// queries), a ring tile's rows (dk/dv: queries, dq: keys) and its layout.
// At D 256 the dk/dv warpgroups share the block's 64 keys (one computing
// dV, the other dK) with two 64 x 64 f32 P^T buffers between them, and dq
// rings 32-key tiles through three stages; otherwise each warpgroup owns
// 64 of the rows and computes every output.
template <int D>
struct DkvTiles {
  static constexpr int kOwnRows = D > 128 ? 64 : 128;
  static constexpr int kStep = 64;
  using Layout = BwdLayout<D, kOwnRows, kStep, kStages,
                           (D > 128 ? 2 * kStep * 64 * 4 : 0)>;
};
template <int D>
struct DqTiles {
  static constexpr int kOwnRows = 128;
  static constexpr int kStep = D > 128 ? 32 : 64;
  using Layout = BwdLayout<D, kOwnRows, kStep, (D > 128 ? 3 : kStages)>;
};

struct Bars {
  uint32_t own, full, empty;  // full / empty: + 8 * stage
};

template <int kS>
__device__ __forceinline__ Bars init_bars(uint32_t at) {
  const Bars bars{at, at + 8, at + 8 + 8 * kS};
  if (threadIdx.x == 0) {
    mbar_init(bars.own, 1);
    for (int s = 0; s < kS; ++s) {
      mbar_init(bars.full + 8 * s, 1);
      mbar_init(bars.empty + 8 * s, kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return bars;
}

// The own tiles a and b (the layout's own rows at row0) onto bars.own.
template <class L>
__device__ __forceinline__ void load_own(uint32_t s_a, const CUtensorMap* a,
                                         uint32_t s_b, const CUtensorMap* b,
                                         const Bars& bars, int row0, int bh) {
  mbar_expect_tx(bars.own, 2 * L::kOwn);
#pragma unroll
  for (int j = 0; j < L::kSub; ++j) {
    tma_load(s_a + j * L::kOwnSub, a, bars.own, 64 * j, row0, bh);
    tma_load(s_b + j * L::kOwnSub, b, bars.own, 64 * j, row0, bh);
  }
}

// S = A B^T into acc (m64nN, N the ring tile's rows), A 64 rows of an own
// tile from byte `a_row` on, B a ring tile: both K-major, D / 16 steps of
// k16.
template <int D, class L, int N>
__device__ __forceinline__ void product_ss(float (&acc)[N / 2], uint32_t s_a,
                                           uint32_t a_row, uint32_t s_b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t along = (kk % 4) * 32;
    const uint32_t a = s_a + (kk / 4) * L::kOwnSub + along + a_row;
    const uint32_t b = s_b + (kk / 4) * L::kStepSub + along;
    wgmma_ss<N>(acc, sw128_desc(a, 16, 1024), sw128_desc(b, 16, 1024),
                kk > 0);
  }
}

// The dk/dv producer (one thread): K and V of the block's keys from key0
// once, then for each of n_tiles query tiles from `first` on its Q and dO
// and their lse and dsum (q, do, lse, dsum: the maps).
template <class L, int kStep>
__device__ __forceinline__ void produce_dkv(
    const Bars& bars, uint32_t s_k, uint32_t s_v, uint32_t s_q, uint32_t s_do,
    uint32_t s_lse, uint32_t s_dsum, const CUtensorMap* k,
    const CUtensorMap* v, const CUtensorMap* q, const CUtensorMap* dout,
    const CUtensorMap* lse, const CUtensorMap* dsum, int key0, int first,
    int n_tiles, int t, int bh) {
  constexpr int kS = L::kRingStages;
  load_own<L>(s_k, k, s_v, v, bars, key0, bh);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kS;
    const int q0 = (first + it) * kStep;
    const uint32_t full = bars.full + 8 * s;
    mbar_wait(bars.empty + 8 * s, ((it / kS) & 1) ^ 1);
    mbar_expect_tx(full, 2 * L::kRing + 2 * 4 * kStep);
#pragma unroll
    for (int j = 0; j < L::kSub; ++j) {
      const uint32_t at = s * L::kRing + j * L::kStepSub;
      tma_load(s_q + at, q, full, 64 * j, q0, bh);
      tma_load(s_do + at, dout, full, 64 * j, q0, bh);
    }
    tma_load_1d(s_lse + 4 * kStep * s, lse, full, bh * t + q0);
    tma_load_1d(s_dsum + 4 * kStep * s, dsum, full, bh * t + q0);
  }
}

// The dq producer (one thread): Q and dO of the block's queries from row0
// once, then K and V of each of n_tiles key tiles from key 0 on.
template <class L, int kStep>
__device__ __forceinline__ void produce_dq(
    const Bars& bars, uint32_t s_q, uint32_t s_do, uint32_t s_k, uint32_t s_v,
    const CUtensorMap* q, const CUtensorMap* dout, const CUtensorMap* k,
    const CUtensorMap* v, int row0, int n_tiles, int bh) {
  constexpr int kS = L::kRingStages;
  load_own<L>(s_q, q, s_do, dout, bars, row0, bh);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kS;
    const uint32_t full = bars.full + 8 * s;
    mbar_wait(bars.empty + 8 * s, ((it / kS) & 1) ^ 1);
    mbar_expect_tx(full, 2 * L::kRing);
#pragma unroll
    for (int j = 0; j < L::kSub; ++j) {
      const uint32_t at = s * L::kRing + j * L::kStepSub;
      tma_load(s_k + at, k, full, 64 * j, it * kStep, bh);
      tma_load(s_v + at, v, full, 64 * j, it * kStep, bh);
    }
  }
}

// q/do [BH, T, D], k/v [BH, Tk, D] bf16 (through the tensor maps), lse and
// dsum [BH * T] f32 (1-D maps) -> dk, dv [BH, Tk, D] bf16, D 64 or 128
// (D 256: the specialisation below).
// grid (BH, ceil(Tk / DkvTiles<D>::kOwnRows)), kThreads threads.
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
                          int d, int q_off, int k_off, int causal,
                          float scale) {
  static_assert(D <= 128, "D 256 has its own body");
  using T = DkvTiles<D>;
  constexpr int kOwnRows = T::kOwnRows;
  constexpr int kStep = T::kStep;
  using L = typename T::Layout;
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
  const Bars bars = init_bars<kStages>(base + L::kBar);

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
      produce_dkv<L, kStep>(bars, s_k, s_v, s_q, s_do, s_lse, s_dsum, &tm_k,
                            &tm_v, &tm_q, &tm_do, &tm_lse, &tm_dsum, key0,
                            first, n_tiles, t, bh);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // the warpgroup's 64 keys, from byte own_row of the own tiles on
  const uint32_t own_row = 64 * 128 * wg;
  const int wkey0 = key0 + 64 * wg;
  const int r_in = 16 * warp + lane / 4;  // + 8 * half: key in the warpgroup

  float dk_acc[D / 2];
  float dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dv_acc[i] = 0.f;
  float st[kStep / 2];   // S^T, then P^T
  float dpt[kStep / 2];  // dP^T, then dS^T
  uint32_t pa[kStep / 4];
  uint32_t da[kStep / 4];

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
      product_ss<D, L, kStep>(st, s_k, own_row, ring_q);
      product_ss<D, L, kStep>(dpt, s_v, own_row, ring_do);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(dpt);

      const float* lse = stats + kStep * s;
      const float* dsum = stats + kStep * (kStages + s);
      const bool edge = q0 + kStep > t || wkey0 + 64 > tk ||
                        (causal && q_off + q0 < k_off + wkey0 + 63);
#pragma unroll
      for (int i = 0; i < kStep / 2; ++i) {
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
      if (8 * nb >= d) break;  // the zero-filled columns past d
      const size_t idx = grow * d + 8 * nb + 2 * (lane & 3);
      const int i = 4 * nb + 2 * h;
      *reinterpret_cast<__nv_bfloat162*>(dk + idx) =
          __floats2bfloat162_rn(dk_acc[i], dk_acc[i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + idx) =
          __floats2bfloat162_rn(dv_acc[i], dv_acc[i + 1]);
    }
  }
}

// The same inputs (lse and dsum as plain pointers) -> dq [BH, T, D] bf16,
// D 64 or 128 (D 256: the specialisation below).
// grid (BH, ceil(T / DqTiles<D>::kOwnRows)), kThreads threads.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const float* __restrict__ lse,
                         const float* __restrict__ dsum,
                         __nv_bfloat16* __restrict__ dq, int t, int tk,
                         int d, int q_off, int k_off, int causal,
                         float scale) {
  static_assert(D <= 128, "D 256 has its own body");
  constexpr int kOwnRows = DqTiles<D>::kOwnRows;
  constexpr int kStep = DqTiles<D>::kStep;
  using L = typename DqTiles<D>::Layout;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base + L::kA;
  const uint32_t s_do = base + L::kB;
  const uint32_t s_k = base + L::kX;  // + stage * L::kRing
  const uint32_t s_v = base + L::kY;  // + stage * L::kRing
  const Bars bars = init_bars<kStages>(base + L::kBar);

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
      produce_dq<L, kStep>(bars, s_q, s_do, s_k, s_v, &tm_q, &tm_do, &tm_k,
                           &tm_v, row0, n_tiles, bh);
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
  float sc[kStep / 2];  // S
  float dp[kStep / 2];  // dP, then dS
  uint32_t da[kStep / 4];

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
      product_ss<D, L, kStep>(sc, s_q, 64 * 128 * wg, ring_k);
      product_ss<D, L, kStep>(dp, s_do, 64 * 128 * wg, s_v + s * L::kRing);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      const bool edge = kt0 + kStep > tk ||
                        (causal && q_off + wrow0 < k_off + kt0 + kStep - 1);
#pragma unroll
      for (int i = 0; i < kStep / 2; ++i) {
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
      if (8 * nb >= d) break;  // the zero-filled columns past d
      const size_t idx = grow * d + 8 * nb + 2 * (lane & 3);
      const int i = 4 * nb + 2 * h;
      *reinterpret_cast<__nv_bfloat162*>(dq + idx) =
          __floats2bfloat162_rn(dq_acc[i], dq_acc[i + 1]);
    }
  }
}

// Named barriers between the D 256 dk/dv warpgroups (0 is
// __syncthreads'), each joining both consumer warpgroups: kPtFull + b,
// warpgroup 0 has written P^T buffer b; kPtFree + b, warpgroup 1 has read
// it.
constexpr int kPtFull = 1;
constexpr int kPtFree = 3;

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(kConsumers * 128)
               : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(kConsumers * 128)
               : "memory");
}

// A warpgroup's m64n256 f32 accumulator as bf16 into rows [row0, row0 +
// 64) of out [BH, rows, d] (head bh): rows past `rows` and the zero-filled
// columns past d left out.
__device__ __forceinline__ void store_rows_256(__nv_bfloat16* out,
                                               const float (&acc)[128],
                                               int bh, int rows, int d,
                                               int row0, int r_in, int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + r_in + 8 * h;
    if (row >= rows) continue;
    const size_t grow = static_cast<size_t>(bh) * rows + row;
#pragma unroll
    for (int nb = 0; nb < 32; ++nb) {
      if (8 * nb >= d) break;
      const size_t idx = grow * d + 8 * nb + 2 * (lane & 3);
      const int i = 4 * nb + 2 * h;
      *reinterpret_cast<__nv_bfloat162*>(out + idx) =
          __floats2bfloat162_rn(acc[i], acc[i + 1]);
    }
  }
}

// Column i of a thread's m64nN accumulator less the lane's share,
// col_of(i, lane) - 2 (lane & 3): a constant once the loop is unrolled.
__device__ __forceinline__ constexpr int col_in_quad(int i) {
  return 8 * (i >> 2) + (i & 1);
}

// Wait until ring tile j (of kS stages) has arrived.
template <int kS>
__device__ __forceinline__ void wait_tile(const Bars& bars, int j) {
  mbar_wait(bars.full + 8 * (j % kS), (j / kS) & 1);
}

// acc (m64n256) += A B over kStep rows: A bf16 fragments in registers (a
// tile's 64 rows by kStep), B the kStep x 256 ring tile from `tile` on,
// read MN-major, in k16 steps (one sub-tile row block of 16 a step).
template <class L, int kStep>
__device__ __forceinline__ void product_rs(float (&acc)[128],
                                           const uint32_t (&a)[kStep / 4],
                                           uint32_t tile) {
#pragma unroll
  for (int kk = 0; kk < kStep / 16; ++kk) {
    wgmma_pv<256>(acc, a + 4 * kk,
                  sw128_desc(tile + kk * 16 * 128, L::kStepSub, 1024));
  }
}

// dk/dv at D 256 (d 129-256 arrives zero-padded to 256): one block per
// (bh, 64 keys), key tile 0 first, K and V once, Q, dO, lse and dsum in
// 64-query tiles through the two-stage ring. Both warpgroups take the
// block's 64 keys, warpgroup 0 for dV and warpgroup 1 for dK, and share
// the products that feed both: per tile warpgroup 0 computes S^T = K Q^T
// and P^T = exp(S^T scale - lse) (0 where masked), writes P^T in f32 to
// buffer tile % 2 and does dV += P^T dO; warpgroup 1 computes dP^T = V
// dO^T, reads that tile's P^T, forms dS^T = P^T (dP^T - dsum) scale and
// does dK += dS^T Q. The walk starts at the first query tile that sees a
// key of the block, so every tile has a live pair for both warpgroups.
template <>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_sm90_kernel<256>(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_do,
                               const __grid_constant__ CUtensorMap tm_lse,
                               const __grid_constant__ CUtensorMap tm_dsum,
                               __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, int t, int tk,
                               int d, int q_off, int k_off, int causal,
                               float scale) {
  using T = DkvTiles<256>;
  using L = T::Layout;
  constexpr int kStep = T::kStep;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t s_k = base + L::kA;
  const uint32_t s_v = base + L::kB;
  const uint32_t s_q = base + L::kX;   // + stage * L::kRing
  const uint32_t s_do = base + L::kY;  // + stage * L::kRing
  const uint32_t s_lse = base + L::kStats;              // + 4 kStep stage
  const uint32_t s_dsum = s_lse + 4 * kStep * kStages;  // + 4 kStep stage
  uint8_t* const at = smem_raw + (base - raw);
  const float* stats = reinterpret_cast<const float*>(at + L::kStats);
  const Bars bars = init_bars<kStages>(base + L::kBar);

  const int bh = blockIdx.x;
  const int key0 = blockIdx.y * T::kOwnRows;
  const int q_tiles = (t + kStep - 1) / kStep;
  int first = 0;  // causal: the first q-tile with a query at or after key0
  if (causal) first = min(q_tiles, max(0, k_off + key0 - q_off) / kStep);
  const int n_tiles = q_tiles - first;

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kConsumers * 128 && n_tiles > 0) {
      produce_dkv<L, kStep>(bars, s_k, s_v, s_q, s_do, s_lse, s_dsum, &tm_k,
                            &tm_v, &tm_q, &tm_do, &tm_lse, &tm_dsum, key0,
                            first, n_tiles, t, bh);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r_in = 16 * warp + lane / 4;  // + 8 * half: key in the block
  // warpgroup 0: S^T from K and the Q tile, dV from the dO tile;
  // warpgroup 1: dP^T from V and the dO tile, dK from the Q tile
  const uint32_t first_a = wg == 0 ? s_k : s_v;
  const uint32_t first_b = wg == 0 ? s_q : s_do;
  const uint32_t grad_b = wg == 0 ? s_do : s_q;
  // P^T buffer b: 64 x 64 f32 in the accumulator's register order, float4
  // j of thread tid at [(8 b + j) 128 + tid] (the same slot in both
  // warpgroups, whose accumulators map registers to (key, query) alike)
  float4* const handoff = reinterpret_cast<float4*>(at + L::kHand) + tid;

  float acc[128];  // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  float x[kStep / 2];  // S^T, then P^T (wg 0); dP^T, then dS^T (wg 1)
  uint32_t xa[kStep / 4];

  // Each tile: the softmax (wg 0) or dS^T (wg 1) of the first product,
  // then the second product, then the next tile's first product before the
  // second is waited for. Every group is waited for inside the body, so no
  // product is in flight across a branch or the loop's back edge (ptxas
  // serialises wgmma whose registers are live there).
  if (n_tiles > 0) {  // tile 0's first product
    mbar_wait(bars.own, 0);
    wait_tile<kStages>(bars, 0);
    wgmma_fence();
    product_ss<256, L, kStep>(x, first_a, 0, first_b);
    wgmma_commit();
    wgmma_wait_all();
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const int q0 = (first + it) * kStep;
    const int buf = it % 2;
    fence_regs(x);
    if (wg == 0) {
      const float* lse = stats + kStep * s;
      // a key's live queries, columns [first_q, last_q] less the lane's
      // share: from the causal diagonal to t - 1, none past tk
      const int last_q = t - 1 - q0 - 2 * (lane & 3);
      int first_q[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key = key0 + r_in + 8 * h;
        first_q[h] = key >= tk ? kStep
                     : causal  ? k_off + key - q_off - q0 - 2 * (lane & 3)
                               : -kStep;
      }
#pragma unroll
      for (int i = 0; i < kStep / 2; ++i) {
        const int c = col_in_quad(i);
        const bool live = c >= first_q[half_of(i)] && c <= last_q;
        // masked: exp of kNegInf, exactly 0
        const float e =
            __fsub_rn(__fmul_rn(x[i], scale), lse[col_of(i, lane)]);
        x[i] = __expf(live ? e : kNegInf);
      }
      if (it >= 2) named_sync(kPtFree + buf);  // tile it - 2's P^T was read
#pragma unroll
      for (int j = 0; j < kStep / 8; ++j) {
        handoff[(kStep / 8 * buf + j) * 128] =
            make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
      }
      named_arrive(kPtFull + buf);
    } else {
      const float* dsum = stats + kStep * (kStages + s);
      named_sync(kPtFull + buf);
#pragma unroll
      for (int j = 0; j < kStep / 8; ++j) {
        const float4 p4 = handoff[(kStep / 8 * buf + j) * 128];
        const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = 4 * j + c;
          x[i] = __fmul_rn(
              __fmul_rn(p[c], __fsub_rn(x[i], dsum[col_of(i, lane)])), scale);
        }
      }
      if (it + 2 < n_tiles) named_arrive(kPtFree + buf);
    }
    to_a_fragments(x, xa);

    // dV += P^T dO or dK += dS^T Q (the tile's dO or Q MN-major), then the
    // next tile's first product
    const uint32_t grad_tile = grad_b + s * L::kRing;
    if (it + 1 < n_tiles) {
      wgmma_fence();
      product_rs<L, kStep>(acc, xa, grad_tile);
      wgmma_commit();
      wait_tile<kStages>(bars, it + 1);
      wgmma_fence();
      product_ss<256, L, kStep>(x, first_a, 0,
                                first_b + ((it + 1) % kStages) * L::kRing);
      wgmma_commit();
      wgmma_wait_one();  // the second product
      mbar_arrive(bars.empty + 8 * s);  // this thread is done with the stage
      wgmma_wait_all();
    } else {
      wgmma_fence();
      product_rs<L, kStep>(acc, xa, grad_tile);
      wgmma_commit();
      wgmma_wait_all();
      mbar_arrive(bars.empty + 8 * s);
    }
  }
  fence_regs(acc);

  store_rows_256(wg == 0 ? dv : dk, acc, bh, tk, d, key0, r_in, lane);
}

// One D 256 dq tile's dS in place of its dP (m64nN accumulators of the
// warpgroup's 64 rows from wrow0 against keys from kt0): p = exp(s scale -
// lse), exactly 0 where masked (exp of kNegInf), dS = p (dP - dsum) scale.
// A key is live up to its row's last: the causal diagonal, and tk - 1.
template <int N>
__device__ __forceinline__ void dq_tile_ds(const float (&sc)[N / 2],
                                           float (&dp)[N / 2], int kt0,
                                           int wrow0, int r_in, int lane,
                                           int tk, int q_off, int k_off,
                                           int causal, float scale,
                                           const float (&row_lse)[2],
                                           const float (&row_dsum)[2]) {
  int last[2];  // each row's last live column, less the lane's share
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int key = tk - 1;
    if (causal) key = min(key, q_off + wrow0 + r_in + 8 * h - k_off);
    last[h] = key - kt0 - 2 * (lane & 3);
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int h = half_of(i);
    const float e = __fsub_rn(__fmul_rn(sc[i], scale), row_lse[h]);
    const float p = __expf(col_in_quad(i) <= last[h] ? e : kNegInf);
    dp[i] = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[i], row_dsum[h])), scale);
  }
}

// dq at D 256 (d 129-256 arrives zero-padded to 256): one block per (bh,
// 128 queries), the longest causal rows first, 64 a warpgroup; Q and dO
// once, K and V in 32-key tiles through a three-stage ring (tile i - 1's K
// is still read while tile i is in use and tile i + 1 loads). Per key tile
// S = Q K^T and dP = dO V^T, dS to bf16 fragments, dQ += dS K.
template <>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_sm90_kernel<256>(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_do,
                              const float* __restrict__ lse,
                              const float* __restrict__ dsum,
                              __nv_bfloat16* __restrict__ dq, int t, int tk,
                              int d, int q_off, int k_off, int causal,
                              float scale) {
  using T = DqTiles<256>;
  using L = T::Layout;
  constexpr int kStep = T::kStep;
  constexpr int kS = L::kRingStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base + L::kA;
  const uint32_t s_do = base + L::kB;
  const uint32_t s_k = base + L::kX;  // + stage * L::kRing
  const uint32_t s_v = base + L::kY;  // + stage * L::kRing
  const Bars bars = init_bars<kS>(base + L::kBar);

  const int bh = blockIdx.x;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * T::kOwnRows;
  const int rows = min(T::kOwnRows, t - row0);
  int k_end = tk;  // keys [0, k_end) can be live for some row of the block
  if (causal) k_end = max(0, min(tk, q_off + row0 + rows - k_off));
  const int n_tiles = (k_end + kStep - 1) / kStep;

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kConsumers * 128 && n_tiles > 0) {
      produce_dq<L, kStep>(bars, s_q, s_do, s_k, s_v, &tm_q, &tm_do, &tm_k,
                           &tm_v, row0, n_tiles, bh);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wrow0 = row0 + 64 * wg;       // first query row of the warpgroup
  const int r_in = 16 * warp + lane / 4;  // + 8 * half: row in the warpgroup
  const uint32_t own_row = 64 * 128 * wg;

  float row_lse[2];
  float row_dsum[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wrow0 + r_in + 8 * h;
    const size_t grow = static_cast<size_t>(bh) * t + row;
    row_lse[h] = row < t ? lse[grow] : 0.f;
    row_dsum[h] = row < t ? dsum[grow] : 0.f;
  }
  float dq_acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) dq_acc[i] = 0.f;
  float sc[kStep / 2];  // S
  float dp[kStep / 2];  // dP, then dS
  uint32_t da[kStep / 4];

  // Tile i's S and dP are issued with tile i - 1's dQ += dS K behind them;
  // tile i's dS is formed while that product runs, then it is waited for
  // and tile i - 1's stage goes back. Every tile of the block is computed in
  // both warpgroups (where one has no live pair, its rows past T or before
  // every key, the mask makes p and dS exactly 0), so that no product sits
  // in a branch, and every group is waited for inside the loop's body
  // (ptxas serialises wgmma whose registers are live across either).
  if (n_tiles > 0) {
    mbar_wait(bars.own, 0);
    wait_tile<kS>(bars, 0);
    wgmma_fence();
    product_ss<256, L, kStep>(sc, s_q, own_row, s_k);
    product_ss<256, L, kStep>(dp, s_do, own_row, s_v);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);
    dq_tile_ds<kStep>(sc, dp, 0, wrow0, r_in, lane, tk, q_off, k_off, causal,
                      scale, row_lse, row_dsum);
    to_a_fragments(dp, da);
    for (int it = 1; it < n_tiles; ++it) {
      const int s = it % kS;
      wait_tile<kS>(bars, it);
      wgmma_fence();
      product_ss<256, L, kStep>(sc, s_q, own_row, s_k + s * L::kRing);
      product_ss<256, L, kStep>(dp, s_do, own_row, s_v + s * L::kRing);
      wgmma_commit();
      product_rs<L, kStep>(dq_acc, da, s_k + ((it - 1) % kS) * L::kRing);
      wgmma_commit();
      wgmma_wait_one();  // this tile's S and dP
      fence_regs(sc);
      fence_regs(dp);
      dq_tile_ds<kStep>(sc, dp, it * kStep, wrow0, r_in, lane, tk, q_off,
                        k_off, causal, scale, row_lse, row_dsum);
      wgmma_wait_all();  // the last tile's dQ product
      mbar_arrive(bars.empty + 8 * ((it - 1) % kS));
      to_a_fragments(dp, da);
    }
    wgmma_fence();
    product_rs<L, kStep>(dq_acc, da, s_k + ((n_tiles - 1) % kS) * L::kRing);
    wgmma_commit();
    wgmma_wait_all();
    mbar_arrive(bars.empty + 8 * ((n_tiles - 1) % kS));
  }
  fence_regs(dq_acc);

  store_rows_256(dq, dq_acc, bh, t, d, wrow0, r_in, lane);
}

// The chunked bodies (head dims past 256, d a multiple of kHeadChunk): a grid
// axis over the gradient's 256-column chunks, a warpgroup's chunk of it in one
// m64n256 accumulator. S (S^T) and dP (dP^T) are summed over all of D through a
// ring of kSStages (A, B) sub-tile pairs of 64 columns, which the producer
// streams in the consumers' order (for each walked tile: S's sub-tiles over D,
// then dP's), and the tile's operand of the gradient's product, the block's own
// 256 columns (dq: K; dk/dv: Q and dO, with the tile's lse and dsum), comes
// through a ring of kGStages. kARows: the A sub-tiles' rows (dq: its 128
// queries of Q or dO; dk/dv: its 64 keys of K or V); kN the walked tile's rows
// (32, so that S, dP and a chunk's partial sum fit beside the m64n256
// accumulator in 240 registers); kGTiles the operand tiles a G stage holds.
template <int kARows, int kN, int kSStagesT, int kGTiles>
struct ChunkedLayout {
  static constexpr int kSStages = kSStagesT;
  static constexpr int kGStages = 2;
  static constexpr int kASub = kARows * 128;
  static constexpr int kBSub = kN * 128;
  static constexpr int kSStage = kASub + kBSub;
  static constexpr int kGSub = kN * 128;  // a G tile's 64-column sub-tile
  static constexpr int kGTile = (kHeadChunk / 64) * kGSub;
  static constexpr int kS = 0;
  static constexpr int kG = kS + kSStages * kSStage;  // + stage * kGTiles kGTile
  static constexpr int kStats = kG + kGStages * kGTiles * kGTile;
  // full and empty barriers of each S stage, then of each G stage
  static constexpr int kBar = kStats + kGStages * 2 * kN * 4;
  static constexpr int kBytes = kBar + 16 * (kSStages + kGStages) + 1024;
};
using DqChunked = ChunkedLayout<128, 32, 8, 1>;
using DkvChunked = ChunkedLayout<64, 32, 12, 2>;

// The chunked bodies' barriers: full and empty of each S stage, then of
// each G stage (+ 8 * stage).
struct ChunkedBars {
  uint32_t full_s, empty_s, full_g, empty_g;
};

template <class L>
__device__ __forceinline__ ChunkedBars init_chunked_bars(uint32_t at) {
  const ChunkedBars bars{at, at + 8 * L::kSStages, at + 16 * L::kSStages,
                         at + 16 * L::kSStages + 8 * L::kGStages};
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kSStages; ++s) {
      mbar_init(bars.full_s + 8 * s, 1);
      mbar_init(bars.empty_s + 8 * s, kConsumers * 128);
    }
    for (int s = 0; s < L::kGStages; ++s) {
      mbar_init(bars.full_g + 8 * s, 1);
      mbar_init(bars.empty_g + 8 * s, kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return bars;
}

// The producer's next S stage (the g-th): A's sub-tile at (col, a_row) and
// B's at (col, b_row) of head bh.
template <class L>
__device__ __forceinline__ void load_s_stage(uint32_t ring,
                                             const ChunkedBars& bars, int g,
                                             const CUtensorMap* a, int a_row,
                                             const CUtensorMap* b, int b_row,
                                             int col, int bh) {
  const int s = g % L::kSStages;
  const uint32_t full = bars.full_s + 8 * s;
  mbar_wait(bars.empty_s + 8 * s, ((g / L::kSStages) & 1) ^ 1);
  mbar_expect_tx(full, L::kSStage);
  const uint32_t stage = ring + s * L::kSStage;
  tma_load(stage, a, full, col, a_row, bh);
  tma_load(stage + L::kASub, b, full, col, b_row, bh);
}

// total = the product over all of D of the ring's next n_sub (A, B)
// sub-tile pairs from the g-th on (A's rows from byte a_row of its
// sub-tile, both K-major): the tensor cores sum each 256-column chunk (4
// sub-tiles) into `part`, and the chunks' sums are added into `total` in
// f32 on the CUDA cores (one tensor-core sum over D 1536 put the forward's
// l 1e-5 off). A stage goes back to the producer once the next sub-tile's
// products are issued and its own have finished, or at its chunk's end.
// `skip`: the warpgroup has no live pair here; it only passes the stages
// on.
template <int N, class L>
__device__ __forceinline__ void chunked_product(float (&total)[N / 2],
                                                float (&part)[N / 2],
                                                uint32_t ring,
                                                const ChunkedBars& bars,
                                                uint32_t a_row, int n_sub,
                                                int& g, bool skip) {
  if (skip) {
    for (int j = 0; j < n_sub; ++j, ++g) {
      const int s = g % L::kSStages;
      mbar_wait(bars.full_s + 8 * s, (g / L::kSStages) & 1);
      mbar_arrive(bars.empty_s + 8 * s);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) total[i] = 0.f;
  wgmma_fence();
  for (int j = 0; j < n_sub; ++j, ++g) {
    const int s = g % L::kSStages;
    mbar_wait(bars.full_s + 8 * s, (g / L::kSStages) & 1);
    const uint32_t stage = ring + s * L::kSStage;
    const int in_chunk = j % (kHeadChunk / 64);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_ss<N>(part, sw128_desc(stage + kk * 32 + a_row, 16, 1024),
                  sw128_desc(stage + L::kASub + kk * 32, 16, 1024),
                  in_chunk > 0 || kk > 0);
    }
    wgmma_commit();
    if (in_chunk == kHeadChunk / 64 - 1) {  // the chunk's sum is done
      wgmma_wait_all();
      fence_regs(part);
      mbar_arrive(bars.empty_s + 8 * ((g - 1) % L::kSStages));
      mbar_arrive(bars.empty_s + 8 * s);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) total[i] = __fadd_rn(total[i], part[i]);
      wgmma_fence();  // the next chunk's products overwrite part
    } else if (in_chunk > 0) {
      wgmma_wait_one();
      mbar_arrive(bars.empty_s + 8 * ((g - 1) % L::kSStages));
    }
  }
}

// q/do [BH, T, d], k/v [BH, Tk, d] bf16 (through the tensor maps), lse and
// dsum [BH * T] f32 -> dq [BH, T, d] bf16, d a multiple of kHeadChunk past
// it. grid (BH * d / kHeadChunk, ceil(T / 128)): block x takes head x /
// n_out and columns [(x % n_out) * 256, + 256) of its 128 queries, the
// longest causal rows first.
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_sm90_chunked_kernel(const __grid_constant__ CUtensorMap tm_q,
                                 const __grid_constant__ CUtensorMap tm_k,
                                 const __grid_constant__ CUtensorMap tm_v,
                                 const __grid_constant__ CUtensorMap tm_do,
                                 const float* __restrict__ lse,
                                 const float* __restrict__ dsum,
                                 __nv_bfloat16* __restrict__ dq, int t, int tk,
                                 int d, int q_off, int k_off, int causal,
                                 float scale) {
  using L = DqChunked;
  constexpr int kN = 32;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_ring = base + L::kS;
  const uint32_t s_g = base + L::kG;  // + stage * L::kGTile: K's own columns
  const ChunkedBars bars = init_chunked_bars<L>(base + L::kBar);

  const int n_out = d / kHeadChunk;
  const int bh = blockIdx.x / n_out;
  const int col0 = (blockIdx.x % n_out) * kHeadChunk;
  const int n_sub = d / 64;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * 128;
  const int rows = min(128, t - row0);
  int k_end = tk;  // keys [0, k_end) can be live for some row of the block
  if (causal) k_end = max(0, min(tk, q_off + row0 + rows - k_off));
  const int n_tiles = (k_end + kN - 1) / kN;

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // producer: one thread issues every TMA load, in the consumers' order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kConsumers * 128) {
      int g = 0;  // S stages issued
      for (int it = 0; it < n_tiles; ++it) {
        for (int j = 0; j < n_sub; ++j, ++g) {
          load_s_stage<L>(s_ring, bars, g, &tm_q, row0, &tm_k, it * kN, 64 * j,
                          bh);
        }
        for (int j = 0; j < n_sub; ++j, ++g) {
          load_s_stage<L>(s_ring, bars, g, &tm_do, row0, &tm_v, it * kN,
                          64 * j, bh);
        }
        const int sg = it % L::kGStages;
        const uint32_t full = bars.full_g + 8 * sg;
        mbar_wait(bars.empty_g + 8 * sg, ((it / L::kGStages) & 1) ^ 1);
        mbar_expect_tx(full, L::kGTile);
#pragma unroll
        for (int j = 0; j < kHeadChunk / 64; ++j) {
          tma_load(s_g + sg * L::kGTile + j * L::kGSub, &tm_k, full,
                   col0 + 64 * j, it * kN, bh);
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
  float dq_acc[kHeadChunk / 2];
#pragma unroll
  for (int i = 0; i < kHeadChunk / 2; ++i) dq_acc[i] = 0.f;
  float sc[kN / 2];    // S
  float dp[kN / 2];    // dP, then dS
  float part[kN / 2];  // one 256-column chunk's share of S or dP
  uint32_t da[kN / 4];

  int g = 0;  // S stages consumed
  for (int it = 0; it < n_tiles; ++it) {
    const int kt0 = it * kN;
    // no live pair for this warpgroup: its rows past T, or before every key
    const bool dead =
        wrow0 >= t || (causal && q_off + wrow0 + 63 < k_off + kt0);
    chunked_product<kN, L>(sc, part, s_ring, bars, 64 * 128 * wg, n_sub, g,
                           dead);
    chunked_product<kN, L>(dp, part, s_ring, bars, 64 * 128 * wg, n_sub, g,
                           dead);
    const int sg = it % L::kGStages;
    mbar_wait(bars.full_g + 8 * sg, (it / L::kGStages) & 1);
    if (!dead) {
      const bool edge = kt0 + kN > tk ||
                        (causal && q_off + wrow0 < k_off + kt0 + kN - 1);
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) {
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

      // dQ += dS K over the tile's keys in steps of 16, K's own columns
      // MN-major
      const uint32_t kc = s_g + sg * L::kGTile;
      fence_regs(dq_acc);
      fence_regs(da);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) {
        wgmma_pv<kHeadChunk>(dq_acc, da + 4 * kk,
                             sw128_desc(kc + kk * 16 * 128, L::kGSub, 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dq_acc);
      fence_regs(da);
    }
    mbar_arrive(bars.empty_g + 8 * sg);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wrow0 + r_in + 8 * h;
    if (row >= t) continue;
    const size_t grow = static_cast<size_t>(bh) * t + row;
#pragma unroll
    for (int nb = 0; nb < kHeadChunk / 8; ++nb) {
      const size_t idx = grow * d + col0 + 8 * nb + 2 * (lane & 3);
      const int i = 4 * nb + 2 * h;
      *reinterpret_cast<__nv_bfloat162*>(dq + idx) =
          __floats2bfloat162_rn(dq_acc[i], dq_acc[i + 1]);
    }
  }
}

// The same inputs (lse and dsum through 1-D maps) -> dk, dv [BH, Tk, d]
// bf16, d a multiple of kHeadChunk past it. grid (BH * d / kHeadChunk,
// ceil(Tk / 64)): block x takes head x / n_out and columns [(x % n_out) *
// 256, + 256) of its 64 keys, key tile 0 (the most causal work) first. The
// warpgroups split the gradient, each over the block's 64 keys, and each
// computes S^T itself: warpgroup 0 then dV += P^T dO, warpgroup 1 dP^T,
// dS^T and dK += dS^T Q (warpgroup 0 passes the dP^T stages on).
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_sm90_chunked_kernel(const __grid_constant__ CUtensorMap tm_q,
                                  const __grid_constant__ CUtensorMap tm_k,
                                  const __grid_constant__ CUtensorMap tm_v,
                                  const __grid_constant__ CUtensorMap tm_do,
                                  const __grid_constant__ CUtensorMap tm_lse,
                                  const __grid_constant__ CUtensorMap tm_dsum,
                                  __nv_bfloat16* __restrict__ dk,
                                  __nv_bfloat16* __restrict__ dv, int t,
                                  int tk, int d, int q_off, int k_off,
                                  int causal, float scale) {
  using L = DkvChunked;
  constexpr int kStep = 32;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t s_ring = base + L::kS;
  // a G stage: Q's own columns, then dO's (+ stage * 2 L::kGTile)
  const uint32_t s_g = base + L::kG;
  const uint32_t s_lse = base + L::kStats;              // + 4 kStep stage
  const uint32_t s_dsum = s_lse + 4 * kStep * L::kGStages;
  const float* stats =
      reinterpret_cast<const float*>(smem_raw + (base - raw) + L::kStats);
  const ChunkedBars bars = init_chunked_bars<L>(base + L::kBar);

  const int n_out = d / kHeadChunk;
  const int bh = blockIdx.x / n_out;
  const int col0 = (blockIdx.x % n_out) * kHeadChunk;
  const int n_sub = d / 64;
  const int key0 = blockIdx.y * 64;
  const int q_tiles = (t + kStep - 1) / kStep;
  int first = 0;  // causal: the first q-tile with a query at or after key0
  if (causal) first = min(q_tiles, max(0, k_off + key0 - q_off) / kStep);
  const int n_tiles = q_tiles - first;

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // producer: one thread issues every TMA load, in the consumers' order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kConsumers * 128) {
      int g = 0;  // S stages issued
      for (int it = 0; it < n_tiles; ++it) {
        const int q0 = (first + it) * kStep;
        for (int j = 0; j < n_sub; ++j, ++g) {
          load_s_stage<L>(s_ring, bars, g, &tm_k, key0, &tm_q, q0, 64 * j, bh);
        }
        for (int j = 0; j < n_sub; ++j, ++g) {
          load_s_stage<L>(s_ring, bars, g, &tm_v, key0, &tm_do, q0, 64 * j,
                          bh);
        }
        const int sg = it % L::kGStages;
        const uint32_t full = bars.full_g + 8 * sg;
        mbar_wait(bars.empty_g + 8 * sg, ((it / L::kGStages) & 1) ^ 1);
        mbar_expect_tx(full, 2 * L::kGTile + 2 * 4 * kStep);
        const uint32_t stage = s_g + sg * 2 * L::kGTile;
#pragma unroll
        for (int j = 0; j < kHeadChunk / 64; ++j) {
          tma_load(stage + j * L::kGSub, &tm_q, full, col0 + 64 * j, q0, bh);
          tma_load(stage + L::kGTile + j * L::kGSub, &tm_do, full,
                   col0 + 64 * j, q0, bh);
        }
        tma_load_1d(s_lse + 4 * kStep * sg, &tm_lse, full, bh * t + q0);
        tma_load_1d(s_dsum + 4 * kStep * sg, &tm_dsum, full, bh * t + q0);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r_in = 16 * warp + lane / 4;  // + 8 * half: key in the block
  const bool with_dk = wg == 1;           // dP^T and dS^T needed

  float acc[kHeadChunk / 2];  // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
  for (int i = 0; i < kHeadChunk / 2; ++i) acc[i] = 0.f;
  float st[kStep / 2];    // S^T, then P^T
  float dpt[kStep / 2];   // dP^T, then dS^T
  float part[kStep / 2];  // one 256-column chunk's share of S^T or dP^T
  uint32_t pa[kStep / 4];

  int g = 0;  // S stages consumed
  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = (first + it) * kStep;
    // no live pair: the block's keys past Tk, or after every query
    const bool dead =
        key0 >= tk || (causal && q_off + q0 + kStep - 1 < k_off + key0);
    chunked_product<kStep, L>(st, part, s_ring, bars, 0, n_sub, g, dead);
    chunked_product<kStep, L>(dpt, part, s_ring, bars, 0, n_sub, g,
                              dead || !with_dk);
    const int sg = it % L::kGStages;
    mbar_wait(bars.full_g + 8 * sg, (it / L::kGStages) & 1);
    if (!dead) {
      const float* lse_t = stats + kStep * sg;
      const float* dsum_t = stats + kStep * (L::kGStages + sg);
      const bool edge = q0 + kStep > t || key0 + 64 > tk ||
                        (causal && q_off + q0 < k_off + key0 + 63);
#pragma unroll
      for (int i = 0; i < kStep / 2; ++i) {
        const int col = col_of(i, lane);
        bool live = true;
        if (edge) {
          const int key = key0 + r_in + 8 * half_of(i);
          const int q = q0 + col;
          live = q < t && key < tk && (!causal || q_off + q >= k_off + key);
        }
        const float p =
            live ? __expf(__fsub_rn(__fmul_rn(st[i], scale), lse_t[col]))
                 : 0.f;
        if (with_dk) {
          dpt[i] =
              __fmul_rn(__fmul_rn(p, __fsub_rn(dpt[i], dsum_t[col])), scale);
        }
        st[i] = p;
      }
      if (wg == 0) {  // pa: warpgroup 0's P^T, warpgroup 1's dS^T
        to_a_fragments(st, pa);
      } else {
        to_a_fragments(dpt, pa);
      }

      // dV += P^T dO (warpgroup 0) or dK += dS^T Q (warpgroup 1) over the
      // tile's queries in steps of 16, the own columns MN-major
      const uint32_t ring = s_g + sg * 2 * L::kGTile + (wg == 0 ? L::kGTile : 0);
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kStep / 16; ++kk) {
        wgmma_pv<kHeadChunk>(acc, pa + 4 * kk,
                             sw128_desc(ring + kk * 16 * 128, L::kGSub, 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(pa);
    }
    mbar_arrive(bars.empty_g + 8 * sg);
  }

  __nv_bfloat16* out = wg == 0 ? dv : dk;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + r_in + 8 * h;
    if (key >= tk) continue;
    const size_t grow = static_cast<size_t>(bh) * tk + key;
#pragma unroll
    for (int nb = 0; nb < kHeadChunk / 8; ++nb) {
      const size_t idx = grow * d + col0 + 8 * nb + 2 * (lane & 3);
      const int i = 4 * nb + 2 * h;
      *reinterpret_cast<__nv_bfloat162*>(out + idx) =
          __floats2bfloat162_rn(acc[i], acc[i + 1]);
    }
  }
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* dsum, void* dq, int bh, int t,
              int tk, int d, int q_off, int k_off, int causal, float scale,
              cudaStream_t stream) {
  if (tk == 0) {  // no key: dq is 0
    return static_cast<int>(cudaMemsetAsync(
        dq, 0, sizeof(__nv_bfloat16) * bh * t * d, stream));
  }
  using T = DqTiles<D>;
  CUtensorMap map_q, map_k, map_v, map_do;
  if (!make_map(&map_q, q, bh, t, d, T::kOwnRows) ||
      !make_map(&map_do, dout, bh, t, d, T::kOwnRows) ||
      !make_map(&map_k, k, bh, tk, d, T::kStep) ||
      !make_map(&map_v, v, bh, tk, d, T::kStep)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = flash_bwd_dq_sm90_kernel<D>;
  const size_t smem = T::Layout::kBytes;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (t + T::kOwnRows - 1) / T::kOwnRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      map_q, map_k, map_v, map_do, lse, dsum, static_cast<__nv_bfloat16*>(dq),
      t, tk, d, q_off, k_off, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* dsum, void* dk, void* dv,
               int bh, int t, int tk, int d, int q_off, int k_off, int causal,
               float scale, cudaStream_t stream) {
  if (t == 0) {  // no query: dk and dv are 0
    const size_t bytes = sizeof(__nv_bfloat16) * bh * tk * d;
    cudaError_t err = cudaMemsetAsync(dk, 0, bytes, stream);
    if (err == cudaSuccess) err = cudaMemsetAsync(dv, 0, bytes, stream);
    return static_cast<int>(err);
  }
  using T = DkvTiles<D>;
  CUtensorMap map_q, map_k, map_v, map_do, map_lse, map_dsum;
  if (!make_map(&map_q, q, bh, t, d, T::kStep) ||
      !make_map(&map_do, dout, bh, t, d, T::kStep) ||
      !make_map(&map_k, k, bh, tk, d, T::kOwnRows) ||
      !make_map(&map_v, v, bh, tk, d, T::kOwnRows) ||
      !make_rows_map(&map_lse, lse, bh * t, T::kStep) ||
      !make_rows_map(&map_dsum, dsum, bh * t, T::kStep)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = flash_bwd_dkv_sm90_kernel<D>;
  const size_t smem = T::Layout::kBytes;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (tk + T::kOwnRows - 1) / T::kOwnRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      map_q, map_k, map_v, map_do, map_lse, map_dsum,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), t, tk,
      d, q_off, k_off, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// d: a multiple of kHeadChunk past it.
int launch_dq_chunked(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* dsum,
                      void* dq, int bh, int t, int tk, int d, int q_off,
                      int k_off, int causal, float scale,
                      cudaStream_t stream) {
  if (tk == 0) {  // no key: dq is 0
    return static_cast<int>(cudaMemsetAsync(
        dq, 0, sizeof(__nv_bfloat16) * bh * t * d, stream));
  }
  CUtensorMap map_q, map_k, map_v, map_do;
  if (!make_map(&map_q, q, bh, t, d, 128) ||
      !make_map(&map_do, dout, bh, t, d, 128) ||
      !make_map(&map_k, k, bh, tk, d, 32) ||
      !make_map(&map_v, v, bh, tk, d, 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = flash_bwd_dq_sm90_chunked_kernel;
  cudaError_t err = prepare(kernel, DqChunked::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh * (d / kHeadChunk), (t + 127) / 128);
  kernel<<<grid, kThreads, DqChunked::kBytes, stream>>>(
      map_q, map_k, map_v, map_do, lse, dsum, static_cast<__nv_bfloat16*>(dq),
      t, tk, d, q_off, k_off, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// d: a multiple of kHeadChunk past it.
int launch_dkv_chunked(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* dsum,
                       void* dk, void* dv, int bh, int t, int tk, int d,
                       int q_off, int k_off, int causal, float scale,
                       cudaStream_t stream) {
  if (t == 0) {  // no query: dk and dv are 0
    const size_t bytes = sizeof(__nv_bfloat16) * bh * tk * d;
    cudaError_t err = cudaMemsetAsync(dk, 0, bytes, stream);
    if (err == cudaSuccess) err = cudaMemsetAsync(dv, 0, bytes, stream);
    return static_cast<int>(err);
  }
  CUtensorMap map_q, map_k, map_v, map_do, map_lse, map_dsum;
  if (!make_map(&map_q, q, bh, t, d, 32) ||
      !make_map(&map_do, dout, bh, t, d, 32) ||
      !make_map(&map_k, k, bh, tk, d, 64) ||
      !make_map(&map_v, v, bh, tk, d, 64) ||
      !make_rows_map(&map_lse, lse, bh * t, 32) ||
      !make_rows_map(&map_dsum, dsum, bh * t, 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = flash_bwd_dkv_sm90_chunked_kernel;
  cudaError_t err = prepare(kernel, DkvChunked::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh * (d / kHeadChunk), (tk + 63) / 64);
  kernel<<<grid, kThreads, DkvChunked::kBytes, stream>>>(
      map_q, map_k, map_v, map_do, map_lse, map_dsum,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), t, tk,
      d, q_off, k_off, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Called by rtt_flash_bwd_dq / rtt_flash_bwd_dkv for bf16 q/k/v; each
// returns cudaGetLastError() after its launch, or cudaErrorInvalidValue for
// a head dim it does not take (the `case`s below: 8, 16 and 32 through the
// D 64 bodies, 64, 128 and 256; a multiple of kHeadChunk past 256 through
// the chunked bodies) or tensors TMA cannot address (a base not 16-byte
// aligned).
int flash_bwd_dq_sm90(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* dsum,
                      void* dq, int bh, int t, int tk, int d, int q_off,
                      int k_off, int causal, float scale, cudaStream_t stream) {
  if (bh == 0 || t == 0) return static_cast<int>(cudaSuccess);
#define RTT_DQ(D)                                                            \
  return launch_dq<D>(q, k, v, dout, lse, dsum, dq, bh, t, tk, d, q_off,     \
                      k_off, causal, scale, stream)
  switch (d) {
    case 8:
    case 16:
    case 32:
    case 64: RTT_DQ(64);
    case 128: RTT_DQ(128);
    case 256: RTT_DQ(256);
  }
#undef RTT_DQ
  if (d > kHeadChunk && d % kHeadChunk == 0) {
    return launch_dq_chunked(q, k, v, dout, lse, dsum, dq, bh, t, tk, d, q_off,
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
#define RTT_DKV(D)                                                           \
  return launch_dkv<D>(q, k, v, dout, lse, dsum, dk, dv, bh, t, tk, d,       \
                       q_off, k_off, causal, scale, stream)
  switch (d) {
    case 8:
    case 16:
    case 32:
    case 64: RTT_DKV(64);
    case 128: RTT_DKV(128);
    case 256: RTT_DKV(256);
  }
#undef RTT_DKV
  if (d > kHeadChunk && d % kHeadChunk == 0) {
    return launch_dkv_chunked(q, k, v, dout, lse, dsum, dk, dv, bh, t, tk, d,
                              q_off, k_off, causal, scale, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
