// The bf16 prefill/training forward of flash attention for Hopper (sm_90a):
// tensor cores through wgmma, K/V through TMA, a warp-specialised pipeline.
//
// Replaces, in raydp_tpu/ops/flash_attention.py, for bf16 q/k/v:
//   flash_fwd          <- _flash_kernel_onepass (pallas_call in _flash_call)
//   flash_fwd_twoterm  <- _flash_kernel, the same call with onepass=False
// rtt_flash_fwd (flash_attention.cu) sends bf16 here and f32 to the CUDA-core
// body there, which stays as it was.
//
// What bounds it on an H100: 4 * D operations per live (query, key) pair
// against 2 bytes per element of q, k, v and o, about 500 operations per
// byte at T 2048: the bf16 tensor cores (989 TFLOP/s), not HBM.
//
// The design (its mbarrier, TMA and wgmma helpers are sm90_common.cuh's,
// shared with the backward in flash_backward_sm90.cu).
// - One block per (bh, 128-query tile), 384 threads: two consumer
//   warpgroups of 64 query rows each and one producer warpgroup, whose
//   first thread issues every load. setmaxnreg moves registers from the
//   producer (24) to the consumers (240). blockIdx.y runs over the query
//   tiles from the last one, so that the longest causal rows start first.
// - TMA loads Q once, then K and V in tiles of kN keys into a two-stage
//   ring in shared memory (full/empty mbarriers per stage). A tile is kN
//   (Q: 128) rows x D bf16, stored as D / 64 sub-tiles of 128-byte rows
//   with the 128-byte swizzle; at D 128 (kN 128): Q 32 KB + 2 x (32 + 32)
//   KB = 160 KB. The tensor maps are 3-D [BH, T, D], so a ragged last tile
//   reads zeros, not the next head's rows; they are built on the host per
//   launch.
// - S = Q K^T: wgmma m64nNk16 (N = kN), Q and K from shared memory, both
//   K-major.
//   The scale is applied after the product (s * scale, as _online_update
//   does), and only tiles that touch the causal diagonal, the offsets or
//   the ragged edge are masked (NEG_INF; p = 0 where s <= NEG_INF / 2).
//   The row max needs two shuffles across a thread quad; l sums the f32 p
//   per thread, and the quad's partial sums are added once at the end.
// - O += P V: P rounded to bf16 in registers (the accumulator layout of S
//   is the A-fragment layout of the product) and fed to wgmma as A from
//   registers; V from shared memory as B with the transpose bit, since it
//   is stored [keys, D] and the product contracts over keys. Rounding P to
//   bf16 is what the TPU's MXU does at its default precision.
// - The two-term body multiplies the accumulator and l by alpha =
//   exp(m - m_new) on every tile; the one-pass body skips the multiply
//   where no row of the warp moved its max. There alpha is exactly 1, so
//   the two bodies give the same bits.
// - Epilogue: o = acc / max(l, 1e-30) (IEEE division) in bf16, or the
//   unnormalised acc in f32; m and l per row; rows past T are not stored.
//   No atomics: the same bits on every launch.
// - Head dim 256 (bench.py's LM at d_model 2048, 8 heads; Gemma's heads)
//   keeps this design with key tiles of kN 64: Q 64 KB + 2 x (32 + 32) KB =
//   192 KB of shared memory, S a m64n64 accumulator (32 registers a
//   thread), O a m64n256 one (128 registers a thread), P.V one m64n256k16
//   wgmma a k16 step. With 128-key tiles the ring alone would be 256 KB,
//   more than the 227 KB a block has, and S would take 64 more registers.
// - Head dims below 64 (8, 16 and 32: the small LMs' heads) run the D 64
//   body. Its tensor maps are [BH, T, d] over the true d columns, so the
//   TMA fills each 64-column box past d with zeros: a zero column adds an
//   exact 0 to every q.k product, the scale is the true d's (the caller's),
//   and p.v's columns past d come out 0 and are not stored (the epilogue
//   writes a row's first d columns at pitch d). Such a launch costs what D
//   64 does (81 KB of shared memory, 64-column products). The TMA needs a
//   row pitch that is a multiple of 16 bytes: d * 2 is one for every d the
//   entry takes. Any other D up to 256 arrives zero-padded by the wrapper
//   to the next width built.
//
// - Head dims past 256 (bench.py's LM at d_model 4096: 8 heads of 512)
//   arrive zero-padded by the wrapper to a multiple of kHeadChunk (256) and
//   run flash_fwd_sm90_chunked_kernel. There O alone over all of D would
//   take 256 registers a consumer thread, and Q and a K tile over all of D
//   more shared memory than a block has, so the design is cut by columns:
//   a grid axis over the output's 256-column chunks (O a m64n256
//   accumulator, as at D 256), and S = Q K^T a K-loop over D in 64-column
//   sub-tiles that the producer streams through a four-stage ring of (Q
//   sub-tile, K sub-tile) pairs, 24 KB each, while the tile's V rows of the
//   block's columns (32 KB) come through a two-stage ring: 161 KB in all.
//   The tensor cores sum S over a 256-column chunk (4 sub-tiles), as at D
//   256, and the chunks' partial sums are added in f32 on the CUDA cores:
//   one tensor-core sum over all of D lost bits (l 1e-5 off the plain
//   version's at D 1536). A stage is released as soon as the next
//   sub-tile's wgmmas are issued and its own have finished
//   (wgmma.wait_group 1), or at its chunk's end. Q is read again for every
//   key tile (from L2), and every column chunk's block computes the same S,
//   so the operations rise by (D / 256 + 1) / 2 over one pass: 1.5 at D
//   512. Every chunk's block computes the same m and l; the chunk-0 block
//   writes them. The softmax and the epilogue are the helpers above.
//
// What this design leaves out, for a later PR: overlapping one warpgroup's
// softmax with the next Q K^T inside the warpgroup (each tile waits for its
// own products), persistent blocks, a TMA store of o, and clusters that
// multicast K/V to neighbouring query tiles.
//
// The decode kernel (flash_decode.cu) keeps the CUDA-core row update's
// steps in f32, so for bf16 q/k/v a decode row matches this kernel's
// prefill row to within bf16 rounding, not bit for bit; for f32 q/k/v the
// decode and the CUDA-core prefill (flash_attention.cu) run the same steps
// and match bit for bit.

#include "sm90_common.cuh"

namespace {

constexpr int kM = 128;        // query rows per block
constexpr int kStages = 2;     // K/V ring depth
constexpr int kConsumers = 2;  // warpgroups of 64 query rows
constexpr int kThreads = (kConsumers + 1) * 128;

// Shared-memory layout in bytes from a 1024-aligned base (the 128-byte
// swizzle repeats every 1024 bytes, and wgmma's descriptors assume that
// each sub-tile starts on such a boundary). A sub-tile is a tile's rows x
// 64 bf16 columns.
template <int D>
struct Layout {
  static constexpr int kN = D > 128 ? 64 : 128;  // keys per K/V tile
  static constexpr int kSub = D / 64;
  static constexpr int kQSub = kM * 128;
  static constexpr int kKVSub = kN * 128;
  static constexpr int kQTile = kSub * kQSub;
  static constexpr int kTile = kSub * kKVSub;  // a K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;  // q, full[], empty[]
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

// The tile's raw scores `sc` (the m64nN accumulator of S = Q K^T) scaled
// and masked where the tile touches the causal diagonal, the offsets or the
// ragged edge (NEG_INF; p = 0 where s <= NEG_INF / 2), then the online
// softmax: p in place of sc, the rows' m and this thread's share of l
// updated, and the O accumulator rescaled by alpha = exp(m - m_new) where a
// row of the warp moved its max (always in the two-term body). r_in: the
// thread's first row in the warpgroup, wrow0 the warpgroup's first row.
template <int kN, bool kTwoTerm, int kAcc>
__device__ __forceinline__ void softmax_tile(float (&sc)[kN / 2],
                                             float (&acc)[kAcc], float (&m)[2],
                                             float (&l)[2], int kt0, int tk,
                                             int causal, int q_off, int k_off,
                                             int wrow0, int r_in, int lane,
                                             float scale) {
  const bool edge = kt0 + kN > tk ||
                    (causal && k_off + kt0 + kN - 1 > q_off + wrow0);
  if (edge) {
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) {
      const int key = kt0 + col_of(i, lane);
      const int q_pos = q_off + wrow0 + r_in + 8 * half_of(i);
      const bool live = key < tk && (!causal || q_pos >= k_off + key);
      sc[i] = live ? __fmul_rn(sc[i], scale) : kNegInf;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) sc[i] = __fmul_rn(sc[i], scale);
  }

  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) {
    mx[half_of(i)] = fmaxf(mx[half_of(i)], sc[i]);
  }
  float m_new[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = quad_max(mx[h]);
    m_new[h] = fmaxf(m[h], mx[h]);
  }

  float ps[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) {
    float p = __expf(__fsub_rn(sc[i], m_new[half_of(i)]));
    if (edge) p = sc[i] > kNegInf * 0.5f ? p : 0.f;
    ps[half_of(i)] = __fadd_rn(ps[half_of(i)], p);
    sc[i] = p;
  }

  const bool moved = __any_sync(kFull, mx[0] > m[0] || mx[1] > m[1]);
  if (kTwoTerm || moved) {
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      alpha[h] = m[h] == m_new[h] ? 1.f : __expf(__fsub_rn(m[h], m_new[h]));
      l[h] = __fmaf_rn(alpha[h], l[h], ps[h]);
    }
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      acc[i] = __fmul_rn(acc[i], alpha[half_of(i)]);
    }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = __fadd_rn(l[h], ps[h]);
  }
  m[0] = m_new[0];
  m[1] = m_new[1];
}

// Epilogue: o = acc / max(l, 1e-30) (IEEE division) in bf16, or the
// unnormalised acc in f32, into columns [col0, col0 + 2 kAcc) of rows `d`
// apart (the columns past d, zero-filled by the TMA, are not stored);
// m and l per row where `write_ml`; rows past T are not stored. row_in:
// the thread's first row of the block's warpgroup (wrow0 + r_in).
template <int kAcc>
__device__ __forceinline__ void write_out(const float (&acc)[kAcc],
                                          const float (&m)[2], float (&l)[2],
                                          void* __restrict__ o,
                                          float* __restrict__ m_out,
                                          float* __restrict__ l_out, int bh,
                                          int t, int d, int col0, bool write_ml,
                                          int row_in, int lane, int normalize,
                                          int out_f32) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = quad_sum(l[h]);
    const int row = row_in + 8 * h;
    if (row >= t) continue;
    const size_t grow = static_cast<size_t>(bh) * t + row;
    const float denom = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int nb = 0; nb < kAcc / 4; ++nb) {
      if (col0 + 8 * nb >= d) break;  // the zero-filled columns past d
      float x0 = acc[4 * nb + 2 * h];
      float x1 = acc[4 * nb + 2 * h + 1];
      if (normalize) {
        x0 = __fdiv_rn(x0, denom);
        x1 = __fdiv_rn(x1, denom);
      }
      const size_t idx = grow * d + col0 + 8 * nb + 2 * (lane & 3);
      if (out_f32) {
        *reinterpret_cast<float2*>(static_cast<float*>(o) + idx) =
            make_float2(x0, x1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(o) +
                                           idx) = __floats2bfloat162_rn(x0, x1);
      }
    }
    if (write_ml && (lane & 3) == 0) {
      m_out[grow] = m[h];
      l_out[grow] = l[h];
    }
  }
}

// q [BH, T, d], k/v [BH, Tk, d] bf16 (through the tensor maps; d <= D, the
// body's width) -> o [BH, T, d] (bf16, or f32 when out_f32), m/l [BH, T]
// f32. grid (BH, ceil(T / kM)), kThreads threads.
template <int D, bool kTwoTerm>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      void* __restrict__ o, float* __restrict__ m_out,
                      float* __restrict__ l_out, int t, int tk, int d,
                      int q_off, int k_off, int causal, int normalize,
                      int out_f32, float scale) {
  using L = Layout<D>;
  constexpr int kN = L::kN;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base + L::kQ;
  const uint32_t s_k = base + L::kK;
  const uint32_t s_v = base + L::kV;
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_full = bar_q + 8;                // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * kStages;  // + 8 * stage

  const int bh = blockIdx.x;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * kM;
  const int rows = min(kM, t - row0);
  int k_end = tk;  // keys [0, k_end) can be live for some row of the block
  if (causal) k_end = max(0, min(tk, q_off + row0 + rows - k_off));
  const int n_tiles = (k_end + kN - 1) / kN;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kConsumers * 128 && n_tiles > 0) {
      mbar_expect_tx(bar_q, L::kQTile);
#pragma unroll
      for (int j = 0; j < L::kSub; ++j) {
        tma_load(s_q + j * L::kQSub, &tm_q, bar_q, 64 * j, row0, bh);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        mbar_wait(bar_empty + 8 * s, ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * s, 2 * L::kTile);
#pragma unroll
        for (int j = 0; j < L::kSub; ++j) {
          tma_load(s_k + s * L::kTile + j * L::kKVSub, &tm_k,
                   bar_full + 8 * s, 64 * j, it * kN, bh);
          tma_load(s_v + s * L::kTile + j * L::kKVSub, &tm_v,
                   bar_full + 8 * s, 64 * j, it * kN, bh);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int wrow0 = row0 + 64 * wg;     // first query row of the warpgroup
    const int r_in = 16 * warp + lane / 4;  // + 8 * half: row in the warpgroup

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};  // this thread's share of the row sums
    float sc[kN / 2];
    uint32_t pa[kN / 4];

    if (n_tiles > 0) mbar_wait(bar_q, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const int kt0 = it * kN;
      mbar_wait(bar_full + 8 * s, (it / kStages) & 1);

      // S = Q K^T over D in steps of 16: within a 64-column sub-tile the
      // step moves 32 bytes along the (swizzled) row
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t along = (kk % 4) * 32;
        wgmma_ss<kN>(
            sc,
            sw128_desc(s_q + (kk / 4) * L::kQSub + along + 64 * 128 * wg, 16,
                       1024),
            sw128_desc(s_k + s * L::kTile + (kk / 4) * L::kKVSub + along, 16,
                       1024),
            kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      softmax_tile<kN, kTwoTerm>(sc, acc, m, l, kt0, tk, causal, q_off,
                                 k_off, wrow0, r_in, lane, scale);

      to_a_fragments(sc, pa);  // P to bf16 A fragments

      // O += P V over the tile's keys in steps of 16 (16 rows of 128 bytes)
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) {
        wgmma_pv<D>(acc, pa + 4 * kk,
                    sw128_desc(s_v + s * L::kTile + kk * 16 * 128, L::kKVSub,
                               1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(pa);
      mbar_arrive(bar_empty + 8 * s);  // this thread is done with the stage
    }

    write_out(acc, m, l, o, m_out, l_out, bh, t, d, 0, true, wrow0 + r_in,
              lane, normalize, out_f32);
  }
}

// The chunked body's shared memory (head dims past 256), in bytes from a
// 1024-aligned base: a ring of kSStages (Q, K) sub-tile pairs (kM and kN
// rows of 64 bf16 columns) and a ring of kVStages V tiles (kN rows of the
// block's kHeadChunk columns, kHeadChunk / 64 sub-tiles).
struct ChunkedLayout {
  static constexpr int kN = 64;  // keys per K/V tile
  static constexpr int kSStages = 4;
  static constexpr int kVStages = 2;
  static constexpr int kQSub = kM * 128;
  static constexpr int kKSub = kN * 128;
  static constexpr int kSStage = kQSub + kKSub;
  static constexpr int kVTile = (kHeadChunk / 64) * kKSub;
  static constexpr int kS = 0;
  static constexpr int kV = kS + kSStages * kSStage;
  // full and empty barriers of each S stage, then of each V stage
  static constexpr int kBar = kV + kVStages * kVTile;
  static constexpr int kBytes = kBar + 16 * (kSStages + kVStages) + 1024;
};

// q [BH, T, d], k/v [BH, Tk, d] bf16 through the tensor maps, d a multiple
// of kHeadChunk past it -> o [BH, T, d] (bf16, or f32 when out_f32), m/l
// [BH, T] f32. grid (BH * d / kHeadChunk, ceil(T / kM)): block x takes
// head x / n_out and output columns [(x % n_out) * 256, + 256).
template <bool kTwoTerm>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_chunked_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              void* __restrict__ o, float* __restrict__ m_out,
                              float* __restrict__ l_out, int t, int tk, int d,
                              int q_off, int k_off, int causal, int normalize,
                              int out_f32, float scale) {
  using L = ChunkedLayout;
  constexpr int kN = L::kN;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_s = base + L::kS;
  const uint32_t s_v = base + L::kV;
  const uint32_t full_s = base + L::kBar;            // + 8 * stage
  const uint32_t empty_s = full_s + 8 * L::kSStages;
  const uint32_t full_v = empty_s + 8 * L::kSStages;
  const uint32_t empty_v = full_v + 8 * L::kVStages;

  const int n_out = d / kHeadChunk;
  const int bh = blockIdx.x / n_out;
  const int col0 = (blockIdx.x % n_out) * kHeadChunk;
  const int n_sub = d / 64;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * kM;
  const int rows = min(kM, t - row0);
  int k_end = tk;  // keys [0, k_end) can be live for some row of the block
  if (causal) k_end = max(0, min(tk, q_off + row0 + rows - k_off));
  const int n_tiles = (k_end + kN - 1) / kN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kSStages; ++s) {
      mbar_init(full_s + 8 * s, 1);
      mbar_init(empty_s + 8 * s, kConsumers * 128);
    }
    for (int s = 0; s < L::kVStages; ++s) {
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_v + 8 * s, kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // producer: one thread issues every TMA load, in the consumers' order:
    // a key tile's (Q, K) sub-tiles over D, then its V tile
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kConsumers * 128) {
      int g = 0;  // (Q, K) sub-tiles issued
      for (int it = 0; it < n_tiles; ++it) {
        for (int j = 0; j < n_sub; ++j, ++g) {
          const int s = g % L::kSStages;
          mbar_wait(empty_s + 8 * s, ((g / L::kSStages) & 1) ^ 1);
          mbar_expect_tx(full_s + 8 * s, L::kSStage);
          const uint32_t stage = s_s + s * L::kSStage;
          tma_load(stage, &tm_q, full_s + 8 * s, 64 * j, row0, bh);
          tma_load(stage + L::kQSub, &tm_k, full_s + 8 * s, 64 * j, it * kN,
                   bh);
        }
        const int sv = it % L::kVStages;
        mbar_wait(empty_v + 8 * sv, ((it / L::kVStages) & 1) ^ 1);
        mbar_expect_tx(full_v + 8 * sv, L::kVTile);
#pragma unroll
        for (int j = 0; j < kHeadChunk / 64; ++j) {
          tma_load(s_v + sv * L::kVTile + j * L::kKSub, &tm_v, full_v + 8 * sv,
                   col0 + 64 * j, it * kN, bh);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int wrow0 = row0 + 64 * wg;     // first query row of the warpgroup
    const int r_in = 16 * warp + lane / 4;  // + 8 * half: row in the warpgroup

    float acc[kHeadChunk / 2];
#pragma unroll
    for (int i = 0; i < kHeadChunk / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};  // this thread's share of the row sums
    float sc[kN / 2];
    float sp[kN / 2];  // one 256-column chunk's share of S
    uint32_t pa[kN / 4];

    int g = 0;  // (Q, K) sub-tiles consumed
    for (int it = 0; it < n_tiles; ++it) {
      const int kt0 = it * kN;
      // S = Q K^T over D: each sub-tile's four k16 steps, 32 bytes along
      // its (swizzled) rows, summed by the tensor cores over a 256-column
      // chunk (4 sub-tiles), as at D 256; the chunks' partial sums are then
      // added in f32 on the CUDA cores. (One tensor-core sum over all of D
      // 1536 put l 1e-5 off the plain version's.) A stage goes back to the
      // producer once the next sub-tile's products are issued and its own
      // have finished, or at the chunk's end.
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) sc[i] = 0.f;
      wgmma_fence();
      for (int j = 0; j < n_sub; ++j, ++g) {
        const int s = g % L::kSStages;
        mbar_wait(full_s + 8 * s, (g / L::kSStages) & 1);
        const uint32_t stage = s_s + s * L::kSStage;
        const int in_chunk = j % (kHeadChunk / 64);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_ss<kN>(sp,
                       sw128_desc(stage + kk * 32 + 64 * 128 * wg, 16, 1024),
                       sw128_desc(stage + L::kQSub + kk * 32, 16, 1024),
                       in_chunk > 0 || kk > 0);
        }
        wgmma_commit();
        if (in_chunk == kHeadChunk / 64 - 1) {  // the chunk's sum is done
          wgmma_wait_all();
          fence_regs(sp);
          mbar_arrive(empty_s + 8 * ((g - 1) % L::kSStages));
          mbar_arrive(empty_s + 8 * s);
#pragma unroll
          for (int i = 0; i < kN / 2; ++i) sc[i] = __fadd_rn(sc[i], sp[i]);
          wgmma_fence();  // the next chunk's products overwrite sp
        } else if (in_chunk > 0) {
          wgmma_wait_one();
          mbar_arrive(empty_s + 8 * ((g - 1) % L::kSStages));
        }
      }

      softmax_tile<kN, kTwoTerm>(sc, acc, m, l, kt0, tk, causal, q_off,
                                 k_off, wrow0, r_in, lane, scale);
      to_a_fragments(sc, pa);  // P to bf16 A fragments

      // O += P V over the tile's keys in steps of 16 (16 rows of 128 bytes)
      const int sv = it % L::kVStages;
      mbar_wait(full_v + 8 * sv, (it / L::kVStages) & 1);
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) {
        wgmma_pv<kHeadChunk>(acc, pa + 4 * kk,
                             sw128_desc(s_v + sv * L::kVTile + kk * 16 * 128,
                                        L::kKSub, 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(pa);
      mbar_arrive(empty_v + 8 * sv);  // this thread is done with the stage
    }

    write_out(acc, m, l, o, m_out, l_out, bh, t, d, col0, col0 == 0,
              wrow0 + r_in, lane, normalize, out_f32);
  }
}

template <int D, bool kTwoTerm>
int launch(const void* q, const void* k, const void* v, void* o, float* m,
           float* l, int bh, int t, int tk, int d, int q_off, int k_off,
           int causal, int normalize, int out_f32, float scale,
           cudaStream_t stream) {
  CUtensorMap map_q, map_k, map_v;
  if (!make_map(&map_q, q, bh, t, d, kM) ||
      !make_map(&map_k, k, bh, tk, d, Layout<D>::kN) ||
      !make_map(&map_v, v, bh, tk, d, Layout<D>::kN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = flash_fwd_sm90_kernel<D, kTwoTerm>;
  const size_t smem = Layout<D>::kBytes;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (t + kM - 1) / kM);
  kernel<<<grid, kThreads, smem, stream>>>(map_q, map_k, map_v, o, m, l, t, tk,
                                           d, q_off, k_off, causal,
                                           normalize, out_f32, scale);
  return static_cast<int>(cudaGetLastError());
}

// d: a multiple of kHeadChunk past it.
template <bool kTwoTerm>
int launch_chunked(const void* q, const void* k, const void* v, void* o,
                   float* m, float* l, int bh, int t, int tk, int d, int q_off,
                   int k_off, int causal, int normalize, int out_f32,
                   float scale, cudaStream_t stream) {
  using L = ChunkedLayout;
  CUtensorMap map_q, map_k, map_v;
  if (!make_map(&map_q, q, bh, t, d, kM) ||
      !make_map(&map_k, k, bh, tk, d, L::kN) ||
      !make_map(&map_v, v, bh, tk, d, L::kN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = flash_fwd_sm90_chunked_kernel<kTwoTerm>;
  cudaError_t err = prepare(kernel, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh * (d / kHeadChunk), (t + kM - 1) / kM);
  kernel<<<grid, kThreads, L::kBytes, stream>>>(map_q, map_k, map_v, o, m, l,
                                                t, tk, d, q_off, k_off, causal,
                                                normalize, out_f32, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Called by rtt_flash_fwd for bf16 q/k/v; returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a head dim it does not take (the
// `case`s below: 8, 16 and 32 through the D 64 body, 64, 128 and 256; a
// multiple of kHeadChunk past 256 through the chunked body) or tensors TMA
// cannot address (a base not 16-byte aligned).
int flash_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                   float* m, float* l, int bh, int t, int tk, int d, int q_off,
                   int k_off, int causal, int normalize, int out_f32,
                   int onepass, float scale, cudaStream_t stream) {
  if (bh == 0 || t == 0) return static_cast<int>(cudaSuccess);
#define RTT_SM90(D)                                                          \
  return onepass ? launch<D, false>(q, k, v, o, m, l, bh, t, tk, d, q_off,   \
                                    k_off, causal, normalize, out_f32, scale, \
                                    stream)                                   \
                 : launch<D, true>(q, k, v, o, m, l, bh, t, tk, d, q_off,    \
                                   k_off, causal, normalize, out_f32, scale,  \
                                   stream)
  switch (d) {
    case 8:
    case 16:
    case 32:
    case 64: RTT_SM90(64);
    case 128: RTT_SM90(128);
    case 256: RTT_SM90(256);
  }
#undef RTT_SM90
  if (d > kHeadChunk && d % kHeadChunk == 0) {
    return onepass ? launch_chunked<false>(q, k, v, o, m, l, bh, t, tk, d,
                                           q_off, k_off, causal, normalize,
                                           out_f32, scale, stream)
                   : launch_chunked<true>(q, k, v, o, m, l, bh, t, tk, d,
                                          q_off, k_off, causal, normalize,
                                          out_f32, scale, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
