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
// - TMA loads Q once, then K and V in tiles of 128 keys into a two-stage
//   ring in shared memory (full/empty mbarriers per stage). A tile is 128
//   rows x D bf16, stored as D / 64 sub-tiles of 128-byte rows with the
//   128-byte swizzle; at D 128: Q 32 KB + 2 x (32 + 32) KB = 160 KB. The
//   tensor maps are 3-D [BH, T, D], so a ragged last tile reads zeros, not
//   the next head's rows; they are built on the host per launch.
// - S = Q K^T: wgmma m64n128k16, Q and K from shared memory, both K-major.
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
constexpr int kN = 128;        // keys per K/V tile
constexpr int kStages = 2;     // K/V ring depth
constexpr int kConsumers = 2;  // warpgroups of 64 query rows
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kSubBytes = 128 * 128;  // 128 rows x 64 bf16 columns

// Shared-memory layout in bytes from a 1024-aligned base (the 128-byte
// swizzle repeats every 1024 bytes, and wgmma's descriptors assume that
// each sub-tile starts on such a boundary).
template <int D>
struct Layout {
  static constexpr int kSub = D / 64;
  static constexpr int kTile = kSub * kSubBytes;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;  // q, full[], empty[]
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

// q [BH, T, D], k/v [BH, Tk, D] bf16 (through the tensor maps) -> o
// [BH, T, D] (bf16, or f32 when out_f32), m/l [BH, T] f32.
// grid (BH, ceil(T / kM)), kThreads threads.
template <int D, bool kTwoTerm>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      void* __restrict__ o, float* __restrict__ m_out,
                      float* __restrict__ l_out, int t, int tk, int q_off,
                      int k_off, int causal, int normalize, int out_f32,
                      float scale) {
  using L = Layout<D>;
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
      mbar_expect_tx(bar_q, L::kTile);
#pragma unroll
      for (int j = 0; j < L::kSub; ++j) {
        tma_load(s_q + j * kSubBytes, &tm_q, bar_q, 64 * j, row0, bh);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        mbar_wait(bar_empty + 8 * s, ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * s, 2 * L::kTile);
#pragma unroll
        for (int j = 0; j < L::kSub; ++j) {
          tma_load(s_k + s * L::kTile + j * kSubBytes, &tm_k, bar_full + 8 * s,
                   64 * j, it * kN, bh);
          tma_load(s_v + s * L::kTile + j * kSubBytes, &tm_v, bar_full + 8 * s,
                   64 * j, it * kN, bh);
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
    float sc[64];
    uint32_t pa[32];

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
        const uint32_t off = (kk / 4) * kSubBytes + (kk % 4) * 32;
        wgmma_ss_n128(sc, sw128_desc(s_q + off + 64 * 128 * wg, 16, 1024),
                      sw128_desc(s_k + s * L::kTile + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      const bool edge = kt0 + kN > tk ||
                        (causal && k_off + kt0 + kN - 1 > q_off + wrow0);
      if (edge) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int key = kt0 + col_of(i, lane);
          const int q_pos = q_off + wrow0 + r_in + 8 * half_of(i);
          const bool live = key < tk && (!causal || q_pos >= k_off + key);
          sc[i] = live ? __fmul_rn(sc[i], scale) : kNegInf;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 64; ++i) sc[i] = __fmul_rn(sc[i], scale);
      }

      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < 64; ++i) mx[half_of(i)] = fmaxf(mx[half_of(i)], sc[i]);
      float m_new[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = quad_max(mx[h]);
        m_new[h] = fmaxf(m[h], mx[h]);
      }

      float ps[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 64; ++i) {
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
        for (int i = 0; i < D / 2; ++i) {
          acc[i] = __fmul_rn(acc[i], alpha[half_of(i)]);
        }
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) l[h] = __fadd_rn(l[h], ps[h]);
      }
      m[0] = m_new[0];
      m[1] = m_new[1];

      to_a_fragments(sc, pa);  // P to bf16 A fragments

      // O += P V over the tile's keys in steps of 16 (16 rows of 128 bytes)
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) {
        wgmma_pv<D>(acc, pa + 4 * kk,
                    sw128_desc(s_v + s * L::kTile + kk * 16 * 128, kSubBytes,
                               1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(pa);
      mbar_arrive(bar_empty + 8 * s);  // this thread is done with the stage
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] = quad_sum(l[h]);
      const int row = wrow0 + r_in + 8 * h;
      if (row >= t) continue;
      const size_t grow = static_cast<size_t>(bh) * t + row;
      const float denom = fmaxf(l[h], 1e-30f);
#pragma unroll
      for (int nb = 0; nb < D / 8; ++nb) {
        float x0 = acc[4 * nb + 2 * h];
        float x1 = acc[4 * nb + 2 * h + 1];
        if (normalize) {
          x0 = __fdiv_rn(x0, denom);
          x1 = __fdiv_rn(x1, denom);
        }
        const size_t idx = grow * D + 8 * nb + 2 * (lane & 3);
        if (out_f32) {
          *reinterpret_cast<float2*>(static_cast<float*>(o) + idx) =
              make_float2(x0, x1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(o) +
                                             idx) = __floats2bfloat162_rn(x0, x1);
        }
      }
      if ((lane & 3) == 0) {
        m_out[grow] = m[h];
        l_out[grow] = l[h];
      }
    }
  }
}

template <int D, bool kTwoTerm>
int launch(const void* q, const void* k, const void* v, void* o, float* m,
           float* l, int bh, int t, int tk, int q_off, int k_off, int causal,
           int normalize, int out_f32, float scale, cudaStream_t stream) {
  CUtensorMap map_q, map_k, map_v;
  if (!make_map(&map_q, q, bh, t, D, kM) ||
      !make_map(&map_k, k, bh, tk, D, kN) ||
      !make_map(&map_v, v, bh, tk, D, kN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = flash_fwd_sm90_kernel<D, kTwoTerm>;
  const size_t smem = Layout<D>::kBytes;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (t + kM - 1) / kM);
  kernel<<<grid, kThreads, smem, stream>>>(map_q, map_k, map_v, o, m, l, t, tk,
                                           q_off, k_off, causal, normalize,
                                           out_f32, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Called by rtt_flash_fwd for bf16 q/k/v; returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a head dim it does not take or
// tensors TMA cannot address (a base not 16-byte aligned).
int flash_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                   float* m, float* l, int bh, int t, int tk, int d, int q_off,
                   int k_off, int causal, int normalize, int out_f32,
                   int onepass, float scale, cudaStream_t stream) {
  if (bh == 0 || t == 0) return static_cast<int>(cudaSuccess);
#define RTT_SM90(D, TWO)                                                    \
  return launch<D, TWO>(q, k, v, o, m, l, bh, t, tk, q_off, k_off, causal, \
                        normalize, out_f32, scale, stream)
  if (d == 64 && onepass) RTT_SM90(64, false);
  if (d == 64) RTT_SM90(64, true);
  if (d == 128 && onepass) RTT_SM90(128, false);
  if (d == 128) RTT_SM90(128, true);
#undef RTT_SM90
  return static_cast<int>(cudaErrorInvalidValue);
}
