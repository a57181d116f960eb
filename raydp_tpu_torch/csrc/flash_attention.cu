// Flash attention for Hopper (sm_90a): the f32 prefill forward, with a
// plain C interface for ctypes. rtt_flash_fwd sends bf16 q/k/v to the
// tensor-core forward in flash_forward_sm90.cu and f32 to flash_fwd_kernel
// here. The f32/bf16-cache decode is flash_decode.cu, the int8-cache decode
// flash_decode_int8.cu.
//
// Replaces, in raydp_tpu/ops/flash_attention.py (pallas_call at :305, in
// _flash_call: flash_attention / flash_attention_stats), for f32 q/k/v:
//   flash_fwd          <- _flash_kernel_onepass (:146)
//   flash_fwd_twoterm  <- _flash_kernel (:83), the same call with
//                         onepass=False (RAYDP_TPU_FLASH_ONEPASS=0): the
//                         two-term update, which always rescales
//
// What bounds it on an H100. Prefill over T positions does 2*B*H*T^2*D
// operations (causal) on 4*B*H*T*D f32 elements: at T = 2048, D = 128 about
// 500 operations a byte, far above the card's ridge, so it is bound by
// operations: the FP32 pipes of the CUDA cores (67 TFLOP/s). Tensor cores
// stay out: TF32 wgmma rounds the operands and would break the bits below.
//
// What holds it back, and what the design does about it. The FP32 pipes
// take 128 FMAs a clock on an SM; shared memory gives 128 bytes a clock, and
// a warp's 16-byte load (LDS.128) takes four of those clocks whatever
// addresses its lanes share. A thread therefore needs about 4 FMAs for
// every float it loads from shared memory before the FP32 pipes, not shared
// memory, are the limit: a register tile of 8 x 8 outputs. The previous
// body (one warp a row, one key a lane) loaded one or two floats a FMA.
// This one stages a group of kGroup = 4 k-tiles (128 keys) at a time, so
// that a phase has enough outputs for register tiles of 8 x 4:
// - scores: threads 64t .. 64t + 63 take tile t, a thread 8 rows x 4 keys,
//   walking d ascending; per 4 d it loads 8 q and 4 k float4s for 128 FMAs;
// - softmax: four threads a row, each 8 of a tile's keys, the group's tiles
//   in order, in place in a [64][128] tile (scores in, p out); the row's m
//   and l stay in these threads' registers;
// - p.v: a thread holds 8 rows x 4 columns (4 x 4 at D 64) and walks each
//   tile's keys ascending; per 4 keys it loads 8 p and 4 V float4s for 128
//   FMAs; its running o stays in registers.
// That is 128 FMAs for 48 floats, 2.7 a float, short of 4: the scores and
// p.v still wait on shared memory (phase 1 of chip_smoke.py reports the
// SASS LDS:FFMA ratio), and 8 x 8 score tiles would need 256 keys of K
// staged, more shared memory than a block has.
// Row pitches of Q, K and the scores are padded by 16 bytes, so that the
// 8 keys (or rows) a quarter-warp reads at once fall in distinct banks.
// K and V arrive by 16-byte cp.async copies from every thread (zero-filled
// past Tk): the next group's K while this group's softmax and p.v run, a
// group's V while its scores run. cp.async fits this layout where TMA does
// not: TMA writes dense or 128-byte-swizzled boxes, not a padded pitch, and
// it would need a producer warp and mbarriers for tiles each thread copies
// in a few moves. A block's 197 KB (D 128) hold an SM alone; the grid runs
// the longest row blocks (the last ones, under a causal mask) first, so the
// card, which starts each next block on the SM that frees first, spreads
// the row blocks' unequal work evenly. A block stops at its last live tile
// and masks element by element only on tiles that some row of it does not
// see whole.
//
// Head dims. D 64 and 128 are the widths above. D 256 (bench.py's LM at
// d_model 2048, 8 heads) stages groups of kGroup = 2 tiles (64 keys): Q,
// K and V of 64 rows at the padded pitch and the [64][68] scores are 212
// KB, where four tiles would be 365 KB; a score tile of 32 keys then has
// 128 threads, each 4 rows x 4 keys, and p.v holds 16 rows x 4 columns a
// thread (64 accumulators), loading p 2 keys at a time. The rounding chain
// is the same. D 8, 16 and 32 (the small
// LMs' heads: d_model 32 over 4 or 2 heads, or 64 over 2) run the same
// body: a score tile's 128 FMAs then load 8 q and 4 k float4s per 4 d as
// before, p.v holds 1 (D 8, D 16) or 2 (D 32) rows x 4 columns a thread
// (at D 8 only the first 128 threads: 64 rows of 2 column quads), and a K
// tile is fewer 16-byte copies than the block has threads (copy_rows skips
// the rest). A block's 47 KB (D 8), 57 KB (D 16) or 77 KB (D 32) let
// several share an SM. Any other D up to 256 reaches this kernel
// zero-padded by the wrapper to the next of these widths (a zero column
// adds an exact 0 to each score's chain). The rounding chain below does
// not depend on D.
//
// Head dims past 256 (bench.py's LM at d_model 4096: 8 heads of 512) arrive
// zero-padded by the wrapper to a multiple of kHeadChunk (256), n = D / 256
// chunks, and run flash_fwd_chunked_kernel. A block of 256 threads owns 64
// query rows and two 256-column chunks of their o (m = ceil(n / 2) blocks a
// row block; an odd n leaves the last block one chunk), so it computes the
// scores once for 512 output columns: at D 512 once in all, at D 1024 and
// 1536 (m + 1) / 2 = 1.5 and 2 times one pass's operations. It walks the
// keys in groups of 64 (2 k-tiles, D 256's softmax and score tile), each
// group as n_pieces = D / 128 score steps and then one p.v step for each
// 128-column piece of its own columns (2 or 4), one step after another
// through a ring of two shared-memory stages: step f reads stage f & 1
// while step f + 1's copies (16-byte cp.async from every thread) fill the
// other, one barrier a step, so no step waits for its own loads once the
// ring runs. The budget that shapes it:
// - Shared memory, 227 KB a block. At D 512, Q at the padded pitch is 64 x
//   516 x 4 = 132,096 bytes and is staged once a block; a stage holds one
//   128-column piece of the group's 64 keys, K at [64][132] (33,792 bytes)
//   or V at [64][128]; the [64][68] scores 17,408, row_a and l 768: 217,856
//   bytes. Past 512, Q does not fit: each score step stages Q's piece too,
//   into Q's place (two stages of [64][132]), and K's into the ring.
// - Registers. o of 64 rows x 512 columns over 256 threads is 128
//   accumulators a thread: in a p.v step thread (pr, cq) holds rows pr + 8r
//   (r < 8) x columns 4cq .. 4cq + 3 of the piece (D 128's p.v tile), its
//   tile's chains beside them (32), loading p 4 keys at a time; the score
//   steps carry D 256's 4 x 4 chains a thread through the pieces in
//   registers. 512 threads (64 accumulators each under a 128-register cap)
//   spilled in the f32 backward's dk/dv and ran slower; 32 rows a block
//   would double the blocks and their K and V reads from L2.
// - Shared-memory loads. Scores: per 4 d a thread loads 4 q and 4 k float4s
//   for 64 FMAs, 2 FMAs a float; p.v: per 4 keys 8 p and 4 V float4s for 128
//   FMAs, 2.7 a float (the FP32 pipes want 4). A warp's q loads are 4 rows
//   and its k loads 8 keys at a pitch of 4 mod 32 words, its p loads one
//   row (a broadcast) and its V loads 512 contiguous bytes.
// The copies stay loops (copy_rows' kUnroll false): unrolled with a source
// pitch known only at run time, their row offsets held registers and
// ptxas spilled. The body takes 248 registers, no spill.
// What the H100 showed (80GB HBM3, 700 W; PERF.md, timed by
// prefill_f32_turns.py --case past256): at [1,8,2048,512] f32 causal
// ~1.18 ms of device time, 2.3x its bound, where one block a chunk took
// ~1.88; at D 1024 ~3.7 against ~6.2. A variant with D 128's groups of 128
// keys and 8 x 4 score tiles (2.7 FMAs a float, K's 64-column pieces
// unpadded with their quads swizzled by key to fit 227 KB) spilled at 255
// registers and was no faster at D 512 (~1.19), 6% faster at D 1024.
// Throwaway builds: without the copies past the first two steps ~1.05 (the
// ring's copies and waits ~11%); p loaded 2 keys at a time (float2, 8 more
// loads per 4 keys) ~1.52, so the p.v steps are bound by shared-memory
// load instructions, not by the FP32 pipes.
//
// Why the bits are kept. The split decode (flash_decode.cu) runs the steps
// of flash_common.cuh over the same 32-key tiles, merged in tile order, and
// an f32 decode row must equal the prefill row at its position bit for bit
// (the failover contract of docs/serving.md, "Determinism and failover").
// Which thread computes what is free; for every (row, tile) the rounding
// chain is the one of those steps:
// - each score one __fmaf_rn chain over d ascending, then __fmul_rn(s,
//   scale), or kNegInf where masked (tile_score);
// - the tile max by fmaxf (exact in any order);
// - p = expf(s - m_new) (tile_prob, the same expf);
// - p_sum in warp_sum's butterfly: keys j and j^16, then ^8, ^4 (inside a
//   thread: its keys of a tile are c + 4i), then ^2, ^1 (across the row's
//   four threads);
// - each p.v element one __fmaf_rn chain over keys 0..31 ascending
//   (tile_pv);
// - the merges by merge_term (rescale where the max moved, always in the
//   two-term body, else add; rows whose tile lies wholly in their future
//   skip it); tiles from key 0 in steps of kBlockK;
// - o = __fdiv_rn(acc, max(l, 1e-30)).
// The two-term body computes alpha = exp(m - m_new) and fma(alpha, acc, pv)
// on every tile; where the max did not move alpha is exp(0) == 1 exactly
// and fma(1, a, b) rounds like a + b, so it equals the one-pass body bit for
// bit. For bf16 q/k/v the prefill runs on the tensor cores with p rounded
// to bf16, so the decode row is within bf16 rounding of it, not bitwise.

#include "flash_common.cuh"

namespace {

constexpr int kRows = 64;      // query rows per block
constexpr int kThreads = 256;  // 8 warps
// A row's entry in row_a for each tile of a group: alpha (>= 0) where the
// row max moved, kAdd where it did not, kSkip where the tile lies wholly in
// the row's future or the row is past T (no update).
constexpr float kAdd = -1.f;
constexpr float kSkip = -2.f;

// Shared memory of one block, in floats: Q, a group of K tiles, a group of
// V tiles, the group's scores (then p), row_a of each tile, and the final l
// of each row. Row pitches of Q, K and the scores are padded by 16 bytes.
template <int D>
struct Layout {
  static constexpr int kGroup = D > 128 ? 2 : 4;  // k-tiles staged together
  static constexpr int kGroupKeys = kGroup * kBlockK;
  static constexpr int kPitch = D + 4;            // Q and K rows
  static constexpr int kSPitch = kGroupKeys + 4;  // score / p rows
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kRows * kPitch;
  static constexpr int kV = kK + kGroupKeys * kPitch;
  static constexpr int kS = kV + kGroupKeys * D;
  static constexpr int kA = kS + kRows * kSPitch;
  static constexpr int kL = kA + kGroup * kRows;
  static constexpr size_t kBytes = sizeof(float) * (kL + kRows);
  // p.v: a thread holds kPvRows rows (kPvGroups apart) x 4 columns; the
  // first kPvThreads threads take part (all of them from D 16)
  static constexpr int kColQuads = D / 4;
  static constexpr int kPvGroups =
      kThreads / kColQuads < kRows ? kThreads / kColQuads : kRows;
  static constexpr int kPvRows = kRows / kPvGroups;
  static constexpr int kPvThreads = kPvGroups * kColQuads;
  // scores: kTileThreads threads a tile, kScoreRows rows x 4 keys each
  static constexpr int kTileThreads = kThreads / kGroup;
  static constexpr int kRowGroups = kTileThreads / 8;
  static constexpr int kScoreRows = kRows / kRowGroups;
};

// N rows of D floats from `src` (row pitch `src_pitch` floats: D, or the
// padded head dim of the chunked body) into `dst` (row pitch `pitch`
// floats), 16 bytes a copy spread over the block; rows at or past `valid`
// are zeros. kUnroll false (the chunked body, whose source pitch is known
// only at run time) keeps the copies a loop.
template <int D, int N, bool kUnroll = true>
__device__ __forceinline__ void copy_rows(const float* src, int src_pitch,
                                          int valid, float* dst, int pitch) {
  constexpr int kPieces = D / 4;
  constexpr int kCopies = N * kPieces;  // fewer than the threads at D 16
  constexpr int kRounds = (kCopies + kThreads - 1) / kThreads;
  const auto copy = [&](int u) {
    const int i = threadIdx.x + u * kThreads;
    if (kCopies % kThreads != 0 && i >= kCopies) return;
    const int r = i / kPieces;
    const int c = (i % kPieces) * 4;
    const bool ok = r < valid;
    cp_async16(dst + r * pitch + c,
               src + static_cast<size_t>(ok ? r : 0) * src_pitch + c, ok);
  };
  if constexpr (kUnroll) {
#pragma unroll
    for (int u = 0; u < kRounds; ++u) copy(u);
  } else {
#pragma unroll 1
    for (int u = 0; u < kRounds; ++u) copy(u);
  }
}

// Starts copying `n` tiles of rows from key kt0 of `src` (K or V, rows of
// `src_pitch` floats) into a group buffer at `dst` (row pitch `pitch`), as
// one cp.async group.
template <int D>
__device__ __forceinline__ void load_group(const float* src, int src_pitch,
                                           size_t kbase, int kt0, int n, int tk,
                                           float* dst, int pitch) {
  for (int t = 0; t < n; ++t) {
    const int key = kt0 + t * kBlockK;
    copy_rows<D, kBlockK>(src + (kbase + key) * src_pitch, src_pitch,
                          tk - key, dst + t * kBlockK * pitch, pitch);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The kernel's arguments, as rtt_flash_fwd gives them.
struct FwdArgs {
  const float* q;  // [BH, T, D]
  const float* k;  // [BH, Tk, D]
  const float* v;
  float* o;        // [BH, T, D]
  float* m;        // [BH, T]
  float* l;
  int n_bh, t, tk, q_off, k_off, causal, normalize;
  float scale;
  int d_total;     // the chunked body's head dim (rows of q, k, v and o)
};

// Whether every key of the tile at kt0 is live for every row of the block.
__device__ __forceinline__ bool tile_full(const FwdArgs& a, int row0, int kt0) {
  return kt0 + kBlockK <= a.tk &&
         (!a.causal || a.q_off + row0 >= a.k_off + kt0 + kBlockK - 1);
}

// Scores of the group's live tiles: the kTileThreads threads from
// kTileThreads t on take tile t, thread (rg, g) rows rg + kRowGroups r (r <
// kScoreRows) x keys g + 8i (i < 4) of it (8 x 4 up to D 128, 4 x 4 at D
// 256). Each is one __fmaf_rn chain over d ascending, then the scale, or
// kNegInf where masked. Per 4 d a thread loads kScoreRows q and 4 k
// float4s for 16 kScoreRows FMAs. score_chains carries the chains `s` over
// the D staged columns of the group starting at key kt0; store_scores
// finishes them.
template <int D>
__device__ __forceinline__ void score_chains(
    const float* qs, const float* ks, int kt0,
    float (&s)[Layout<D>::kScoreRows][4]) {
  using L = Layout<D>;
  constexpr int kR = L::kScoreRows;
  const int tile = threadIdx.x / L::kTileThreads;
  const int rg = (threadIdx.x / 8) % L::kRowGroups;
  const int g = threadIdx.x % 8;
  const float* qr = qs + rg * L::kPitch;
  const float* kr = ks + (tile * kBlockK + g) * L::kPitch;
#pragma unroll
  for (int c = 0; c < D; c += 4) {
    float4 qa[kR], kb[4];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      qa[r] = *reinterpret_cast<const float4*>(
          qr + L::kRowGroups * r * L::kPitch + c);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      kb[i] = *reinterpret_cast<const float4*>(kr + 8 * i * L::kPitch + c);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[r][i] = __fmaf_rn(part(qa[r], e), part(kb[i], e), s[r][i]);
        }
      }
    }
  }
}

// The finished chains of score_chains: scaled, or kNegInf where masked,
// into the group's score tile.
template <int D>
__device__ __forceinline__ void store_scores(
    const FwdArgs& a, const float (&s)[Layout<D>::kScoreRows][4], float* ss,
    int row0, int kt0) {
  using L = Layout<D>;
  constexpr int kR = L::kScoreRows;
  const int tile = threadIdx.x / L::kTileThreads;
  const int rg = (threadIdx.x / 8) % L::kRowGroups;
  const int g = threadIdx.x % 8;
  const int tk0 = kt0 + tile * kBlockK;
  const bool full = tile_full(a, row0, tk0);
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int row = rg + L::kRowGroups * r;
    const int q_pos = a.q_off + row0 + row;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = g + 8 * i;
      const bool live = full || (tk0 + j < a.tk &&
                                 (!a.causal || q_pos >= a.k_off + tk0 + j));
      ss[row * L::kSPitch + tile * kBlockK + j] =
          live ? __fmul_rn(s[r][i], a.scale) : kNegInf;
    }
  }
}

template <int D>
__device__ __forceinline__ void group_scores(const FwdArgs& a, const float* qs,
                                             const float* ks, float* ss,
                                             int row0, int kt0, int n_live) {
  using L = Layout<D>;
  if (threadIdx.x / L::kTileThreads >= n_live) return;
  float s[L::kScoreRows][4];
#pragma unroll
  for (int r = 0; r < L::kScoreRows; ++r) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[r][i] = 0.f;
  }
  score_chains<D>(qs, ks, kt0, s);
  store_scores<D>(a, s, ss, row0, kt0);
}

// The softmax of the group's live tiles, in order, for row threadIdx.x / 4,
// whose four threads hold keys c + 4i (c = threadIdx.x % 4, i < 8) of each
// tile: the tile max, p in place of the scores, p_sum in warp_sum's order,
// and the row's (m, l) merged; row_a tells the p.v threads how to merge o.
template <int D, bool kTwoTerm>
__device__ __forceinline__ void group_softmax(const FwdArgs& a, float* ss,
                                              float* row_a, int row0, int rows,
                                              int kt0, int n_live, float& m,
                                              float& l) {
  using L = Layout<D>;
  const int r = threadIdx.x / 4;
  for (int tile = 0; tile < n_live; ++tile) {
    const bool skip = r >= rows ||
        (a.causal && a.q_off + row0 + r < a.k_off + kt0 + tile * kBlockK);
    float* sr = ss + r * L::kSPitch + tile * kBlockK + threadIdx.x % 4;
    float x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = sr[4 * i];
    float tile_max = x[0];
#pragma unroll
    for (int i = 1; i < 8; ++i) tile_max = fmaxf(tile_max, x[i]);
    tile_max = fmaxf(tile_max, __shfl_xor_sync(kFull, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(kFull, tile_max, 2));
    const float m_new = fmaxf(m, tile_max);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      x[i] = tile_prob(x[i], m_new);
      sr[4 * i] = x[i];
    }
    // keys j and j^16 (x[i], x[i + 4]), then j^8, then j^4 in the thread
#pragma unroll
    for (int w = 4; w > 0; w >>= 1) {
#pragma unroll
      for (int i = 0; i < w; ++i) x[i] = __fadd_rn(x[i], x[i + w]);
    }
    // then j^2 and j^1: the row's threads are lanes 4 * (r % 8) + c
    x[0] = __fadd_rn(x[0], __shfl_xor_sync(kFull, x[0], 2));
    x[0] = __fadd_rn(x[0], __shfl_xor_sync(kFull, x[0], 1));
    const bool moved = kTwoTerm || tile_max > m;
    const float alpha = moved ? tile_alpha(m, m_new) : 1.f;
    if (!skip) {
      l = merge_term(moved, alpha, l, x[0]);
      m = m_new;
    }
    if (threadIdx.x % 4 == 0) {
      row_a[tile * kRows + r] = skip ? kSkip : moved ? alpha : kAdd;
    }
  }
}

// p.v of the group's live tiles, in order, merged into the thread's running
// o: thread (rg, cq) holds rows rg + kPvGroups * r (r < kPvRows) x columns
// 4cq .. 4cq + 3. Each element is one __fmaf_rn chain over a tile's keys
// ascending, then merge_term. Per 4 keys a thread loads kPvRows p and 4 V
// float4s for 16 * kPvRows FMAs (at D 256, per 2 keys kPvRows p float2s
// and 2 V float4s, which keeps p in 32 registers).
template <int D>
__device__ __forceinline__ void group_pv(const float* ps, const float* vs,
                                         const float* row_a, int n_live,
                                         float (&acc)[Layout<D>::kPvRows][4]) {
  using L = Layout<D>;
  constexpr int kR = L::kPvRows;
  if (threadIdx.x >= L::kPvThreads) return;  // D 8: rows past the block's
  const int rg = threadIdx.x / L::kColQuads;
  const int cq = threadIdx.x % L::kColQuads;
  for (int tile = 0; tile < n_live; ++tile) {
    const float* pt = ps + rg * L::kSPitch + tile * kBlockK;
    const float* vt = vs + tile * kBlockK * D + 4 * cq;
    constexpr int kJ = kR > 8 ? 2 : 4;  // keys of p loaded at once
    float pv[kR][4];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[r][e] = 0.f;
    }
#pragma unroll
    for (int jb = 0; jb < kBlockK; jb += kJ) {
      float pj[kR][kJ];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float* src = pt + L::kPvGroups * r * L::kSPitch + jb;
        if constexpr (kJ == 4) {
          const float4 x = *reinterpret_cast<const float4*>(src);
          pj[r][0] = x.x, pj[r][1] = x.y, pj[r][2] = x.z, pj[r][3] = x.w;
        } else {
          const float2 x = *reinterpret_cast<const float2*>(src);
          pj[r][0] = x.x, pj[r][1] = x.y;
        }
      }
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) {
        const float4 vv = *reinterpret_cast<const float4*>(vt + (jb + jj) * D);
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const float p = pj[r][jj];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pv[r][e] = __fmaf_rn(p, part(vv, e), pv[r][e]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float alpha = row_a[tile * kRows + rg + L::kPvGroups * r];
      if (alpha == kSkip) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[r][e] = merge_term(alpha >= 0.f, alpha, acc[r][e], pv[r][e]);
      }
    }
  }
}

// The block's rows out: m and l (where `write_ml`) and o, normalized or
// not, into columns [col0, col0 + D) of rows `pitch` floats apart.
template <int D>
__device__ __forceinline__ void write_rows(const FwdArgs& a, float* smem,
                                           size_t qbase, int row0, int rows,
                                           float m, float l,
                                           const float (&acc)[Layout<D>::kPvRows][4],
                                           int pitch, int col0, bool write_ml) {
  using L = Layout<D>;
  if (threadIdx.x % 4 == 0) {
    const int r = threadIdx.x / 4;
    smem[L::kL + r] = l;
    if (r < rows && write_ml) {
      a.m[qbase + row0 + r] = m;
      a.l[qbase + row0 + r] = l;
    }
  }
  __syncthreads();
  const int rg = threadIdx.x / L::kColQuads;
  const int cq = threadIdx.x % L::kColQuads;
#pragma unroll
  for (int r = 0; r < L::kPvRows; ++r) {
    const int row = rg + L::kPvGroups * r;
    if (row >= rows) continue;
    const float denom = fmaxf(smem[L::kL + row], 1e-30f);
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[e] = a.normalize ? __fdiv_rn(acc[r][e], denom) : acc[r][e];
    }
    *reinterpret_cast<float4*>(a.o + (qbase + row0 + row) * pitch + col0 +
                               4 * cq) = make_float4(x[0], x[1], x[2], x[3]);
  }
}

// Rows [row0, row0 + 64) of bh: Q staged once, then the K/V tiles that any
// of its rows sees, kGroup at a time: scores, softmax tile after tile, p.v
// tile after tile; then m, l and o. K of the next group loads while this
// group's softmax and p.v run, V of a group while its scores run.
template <int D, bool kTwoTerm>
__device__ __forceinline__ void row_block(const FwdArgs& a, size_t bh,
                                          int row0, float* smem) {
  using L = Layout<D>;
  const int rows = min(kRows, a.t - row0);
  const size_t qbase = bh * a.t;
  const size_t kbase = bh * a.tk;
  int k_end = a.tk;  // keys [0, k_end) can be live for some row of the block
  if (a.causal) k_end = max(0, min(a.tk, a.q_off + row0 + rows - a.k_off));
  constexpr int kGroup = L::kGroup;
  constexpr int kGroupKeys = L::kGroupKeys;
  const int n_tiles = (k_end + kBlockK - 1) / kBlockK;
  const int n_groups = (n_tiles + kGroup - 1) / kGroup;

  float m = kNegInf;  // the softmax threads' row
  float l = 0.f;
  float acc[L::kPvRows][4];  // the p.v threads' rows and columns
#pragma unroll
  for (int r = 0; r < L::kPvRows; ++r) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;
  }

  if (n_tiles > 0) {  // Q joins group 0's K
    copy_rows<D, kRows>(a.q + (qbase + row0) * D, D, rows, smem + L::kQ,
                        L::kPitch);
    load_group<D>(a.k, D, kbase, 0, min(kGroup, n_tiles), a.tk, smem + L::kK,
                  L::kPitch);
  }
  for (int gi = 0; gi < n_groups; ++gi) {
    const int kt0 = gi * kGroupKeys;
    const int n_live = min(kGroup, n_tiles - gi * kGroup);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // this group's K is in; the last group's p.v is done
    load_group<D>(a.v, D, kbase, kt0, n_live, a.tk, smem + L::kV, D);
    group_scores<D>(a, smem + L::kQ, smem + L::kK, smem + L::kS, row0, kt0,
                    n_live);
    __syncthreads();  // the scores are in; K is free
    const bool more = gi + 1 < n_groups;
    if (more) {
      load_group<D>(a.k, D, kbase, kt0 + kGroupKeys,
                    min(kGroup, n_tiles - (gi + 1) * kGroup), a.tk,
                    smem + L::kK, L::kPitch);
    }
    group_softmax<D, kTwoTerm>(a, smem + L::kS, smem + L::kA, row0, rows, kt0,
                               n_live, m, l);
    if (more) {  // the next K may stay in flight
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();  // p, row_a and this group's V are in
    group_pv<D>(smem + L::kS, smem + L::kV, smem + L::kA, n_live, acc);
  }

  write_rows<D>(a, smem, qbase, row0, rows, m, l, acc, D, 0, true);
}

// Prefill: one block per (bh, 64 query rows), the longest row blocks first:
// block b takes row block n_row_blocks - 1 - b / n_bh of bh b % n_bh. One
// block holds an SM, so the card starts each next block on the SM that
// frees first: the longest-first order then spreads the causal row blocks'
// unequal work evenly.
template <int D, bool kTwoTerm>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const FwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int n_row_blocks = (a.t + kRows - 1) / kRows;
  const int row_block_index =
      n_row_blocks - 1 - static_cast<int>(blockIdx.x / a.n_bh);
  row_block<D, kTwoTerm>(a, blockIdx.x % a.n_bh, row_block_index * kRows,
                         smem);
}

// The chunked body (head dims past 256, d_total = n * kHeadChunk; the
// header's "Head dims past 256"). A ring step stages one kPiece-column
// piece: a score step K's (and past D 512 Q's) at kPiecePitch, a p.v step
// V's at kPiece.
constexpr int kPiece = 128;              // columns a ring step stages
constexpr int kPiecePitch = kPiece + 4;  // K and Q pieces, padded by 16 bytes

// Shared memory of a chunked block, in floats: Q (whole at D 512, at
// kQPitch; past 512 the two stages of its pieces), the ring's two stages,
// the group's scores (then p) at D 256's pitch, row_a of its two tiles and
// the final l of each row.
struct ChunkedLayout {
  using L = Layout<kHeadChunk>;
  static constexpr int kQPitch = 2 * kHeadChunk + 4;
  static constexpr int kStage = kRows * kPiecePitch;
  static constexpr int kQ = 0;
  static constexpr int kRing = kQ + kRows * kQPitch;
  static constexpr int kS = kRing + 2 * kStage;
  static constexpr int kA = kS + kRows * L::kSPitch;
  static constexpr int kL = kA + L::kGroup * kRows;
  static constexpr size_t kBytes = sizeof(float) * (kL + kRows);
};
static_assert(2 * ChunkedLayout::kStage <= kRows * ChunkedLayout::kQPitch,
              "Q's pieces fit Q's place");
static_assert(ChunkedLayout::kBytes <= 232448, "a block's shared memory");

// s[r][i] carried on over one piece of the group's scores: q at the block's
// row 0 (rows q_pitch floats apart), k at the piece's key 0. Thread (tile,
// rg, g) sits where store_scores<256> expects it: rows rg + 16r x keys g +
// 8i of its tile, one __fmaf_rn a d ascending; per 4 d it loads 4 q and 4 k
// float4s for 64 FMAs, each k float4 used as it arrives.
__device__ __forceinline__ void piece_scores(
    const float* q, int q_pitch, const float* k,
    float (&s)[Layout<kHeadChunk>::kScoreRows][4]) {
  using L = Layout<kHeadChunk>;
  const int tile = threadIdx.x / L::kTileThreads;
  const int rg = (threadIdx.x / 8) % L::kRowGroups;
  const int key = tile * kBlockK + threadIdx.x % 8;
  const float* qr = q + rg * q_pitch;
  const float* kr = k + key * kPiecePitch;
#pragma unroll
  for (int c = 0; c < kPiece; c += 4) {
    float4 x[L::kScoreRows];
#pragma unroll
    for (int r = 0; r < L::kScoreRows; ++r) {
      x[r] = *reinterpret_cast<const float4*>(
          qr + r * L::kRowGroups * q_pitch + c);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 y =
          *reinterpret_cast<const float4*>(kr + 8 * i * kPiecePitch + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int r = 0; r < L::kScoreRows; ++r) {
          s[r][i] = __fmaf_rn(part(x[r], e), part(y, e), s[r][i]);
        }
      }
    }
  }
}

// p.v of the group's live tiles over one piece of V (vs: [64 keys][kPiece]),
// merged into the thread's o there: thread (pr, cq) holds rows pr + 8r (r <
// 8) x columns 4cq .. 4cq + 3 of the piece. Each element is one __fmaf_rn
// chain over a tile's keys ascending, then merge_term, tile after tile, as
// group_pv; per 4 keys a thread loads 8 p and 4 V float4s for 128 FMAs.
__device__ __forceinline__ void piece_pv(const float* ps, const float* vs,
                                         const float* row_a, int n_live,
                                         float (&acc)[8][4]) {
  constexpr int kSPitch = Layout<kHeadChunk>::kSPitch;
  const int pr = threadIdx.x / 32;
  const int cq = threadIdx.x % 32;
  for (int tile = 0; tile < n_live; ++tile) {
    const float* pt = ps + pr * kSPitch + tile * kBlockK;
    const float* vt = vs + tile * kBlockK * kPiece + 4 * cq;
    float pv[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[r][e] = 0.f;
    }
#pragma unroll
    for (int jb = 0; jb < kBlockK; jb += 4) {
      float4 pj[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        pj[r] = *reinterpret_cast<const float4*>(pt + 8 * r * kSPitch + jb);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float4 vv =
            *reinterpret_cast<const float4*>(vt + (jb + jj) * kPiece);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pv[r][e] = __fmaf_rn(part(pj[r], jj), part(vv, e), pv[r][e]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float alpha = row_a[tile * kRows + pr + 8 * r];
      if (alpha == kSkip) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[r][e] = merge_term(alpha >= 0.f, alpha, acc[r][e], pv[r][e]);
      }
    }
  }
}

// Rows [row0, row0 + 64) of one bh at o's chunks own0 and own0 + 1 (one, at
// the end of an odd n): block x takes row block n_row_blocks - 1 - x / (n_bh
// m) (the longest rows first, as flash_fwd_kernel orders them), then bh x %
// n_bh and chunk pair (x % (n_bh m)) / n_bh. For each group of 2 k-tiles:
// the score steps carry every live score thread's chains through the
// pieces of Q and K, the scores and the softmax run as at D 256, and a p.v
// step for each piece of the block's columns of V merges into o. The block
// of chunk 0 writes m and l.
template <bool kTwoTerm>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_chunked_kernel(const FwdArgs a) {
  using L = Layout<kHeadChunk>;
  using C = ChunkedLayout;
  constexpr int kMaxPv = 2 * kHeadChunk / kPiece;  // p.v steps a group
  extern __shared__ __align__(16) float smem[];
  const int dt = a.d_total;
  const int n_dc = dt / kHeadChunk;
  const int n_pieces = dt / kPiece;           // score steps a group
  const bool q_once = dt <= 2 * kHeadChunk;  // Q fits: staged once a block
  const int n_row_blocks = (a.t + kRows - 1) / kRows;
  const int per_row_block = a.n_bh * ((n_dc + 1) / 2);
  const int rest = static_cast<int>(blockIdx.x % per_row_block);
  const size_t bh = rest % a.n_bh;
  const int own0 = 2 * (rest / a.n_bh);  // the block's first chunk
  const int n_pv = (n_dc - own0 < 2 ? 1 : 2) * kHeadChunk / kPiece;
  const int row0 =
      (n_row_blocks - 1 - static_cast<int>(blockIdx.x / per_row_block)) * kRows;
  const int rows = min(kRows, a.t - row0);
  const size_t qbase = bh * a.t;
  const size_t kbase = bh * a.tk;
  int k_end = a.tk;  // keys [0, k_end) can be live for some row of the block
  if (a.causal) k_end = max(0, min(a.tk, a.q_off + row0 + rows - a.k_off));
  const int n_tiles = (k_end + kBlockK - 1) / kBlockK;
  const int n_groups = (n_tiles + L::kGroup - 1) / L::kGroup;
  const int per_group = n_pieces + n_pv;
  const int n_steps = n_groups * per_group;
  const float* q_rows = a.q + (qbase + row0) * dt;
  float* ring = smem + C::kRing;

  // step f's copies into its stage, as one cp.async group: a score step's
  // piece of K (past D 512 also Q's, into Q's place), or a p.v step's piece
  // of V at the block's columns; keys past the group's live tiles or Tk
  // are zeros
  auto issue = [&](int f) {
    const int gi = f / per_group;
    const int s = f - gi * per_group;
    const int kt0 = gi * L::kGroupKeys;
    const int keys =
        min(min(L::kGroup, n_tiles - gi * L::kGroup) * kBlockK, a.tk - kt0);
    float* st = ring + (f & 1) * C::kStage;
    if (s < n_pieces) {
      if (!q_once) {
        copy_rows<kPiece, kRows, false>(q_rows + s * kPiece, dt, rows,
                                        smem + C::kQ + (f & 1) * C::kStage,
                                        kPiecePitch);
      }
      copy_rows<kPiece, kRows, false>(a.k + (kbase + kt0) * dt + s * kPiece,
                                      dt, keys, st, kPiecePitch);
    } else {
      copy_rows<kPiece, kRows, false>(
          a.v + (kbase + kt0) * dt + own0 * kHeadChunk +
              (s - n_pieces) * kPiece,
          dt, keys, st, kPiece);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // step f begins: its stage is in, and step f - 1's is read, so step f +
  // 1's copies may fill that one behind step f's arithmetic
  auto begin_step = [&](int f) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    if (f + 1 < n_steps) issue(f + 1);
  };

  float m = kNegInf;  // the softmax threads' row
  float l = 0.f;
  float acc[kMaxPv][8][4];  // the p.v threads' o at the block's pieces
#pragma unroll
  for (int p = 0; p < kMaxPv; ++p) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][r][e] = 0.f;
    }
  }
  if (n_steps > 0) {  // Q joins step 0's copies
    if (q_once) {
      copy_rows<2 * kHeadChunk, kRows, false>(q_rows, dt, rows, smem + C::kQ,
                                              C::kQPitch);
    }
    issue(0);
  }
  int f = 0;
  for (int gi = 0; gi < n_groups; ++gi) {
    const int kt0 = gi * L::kGroupKeys;
    const int n_live = min(L::kGroup, n_tiles - gi * L::kGroup);
    const bool live_tile = threadIdx.x / L::kTileThreads < n_live;
    float s[L::kScoreRows][4];
#pragma unroll
    for (int r = 0; r < L::kScoreRows; ++r) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[r][i] = 0.f;
    }
    for (int piece = 0; piece < n_pieces; ++piece, ++f) {
      begin_step(f);
      const float* qp = smem + C::kQ + (q_once ? piece * kPiece
                                               : (f & 1) * C::kStage);
      if (live_tile) {
        piece_scores(qp, q_once ? C::kQPitch : kPiecePitch,
                     ring + (f & 1) * C::kStage, s);
      }
    }
    if (live_tile) store_scores<kHeadChunk>(a, s, smem + C::kS, row0, kt0);
    __syncthreads();  // the scores are in
    group_softmax<kHeadChunk, kTwoTerm>(a, smem + C::kS, smem + C::kA, row0,
                                        rows, kt0, n_live, m, l);
#pragma unroll
    for (int p = 0; p < kMaxPv; ++p) {
      if (p == n_pv) break;
      begin_step(f);  // and p and row_a are in
      piece_pv(smem + C::kS, ring + (f & 1) * C::kStage, smem + C::kA,
               n_live, acc[p]);
      ++f;
    }
  }

  if (threadIdx.x % 4 == 0) {
    const int r = threadIdx.x / 4;
    smem[C::kL + r] = l;
    if (r < rows && own0 == 0) {
      a.m[qbase + row0 + r] = m;
      a.l[qbase + row0 + r] = l;
    }
  }
  __syncthreads();
  const int pr = threadIdx.x / 32;
  const int cq = threadIdx.x % 32;
#pragma unroll
  for (int p = 0; p < kMaxPv; ++p) {
    if (p == n_pv) break;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = pr + 8 * r;
      if (row >= rows) continue;
      const float denom = fmaxf(smem[C::kL + row], 1e-30f);
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[e] = a.normalize ? __fdiv_rn(acc[p][r][e], denom) : acc[p][r][e];
      }
      *reinterpret_cast<float4*>(a.o + (qbase + row0 + row) * dt +
                                 own0 * kHeadChunk + p * kPiece + 4 * cq) =
          make_float4(x[0], x[1], x[2], x[3]);
    }
  }
}

// d: a multiple of kHeadChunk past it.
int launch_fwd_chunked(const void* q, const void* k, const void* v, void* o,
                       float* m, float* l, int bh, int t, int tk, int d,
                       int q_off, int k_off, int causal, int normalize,
                       int onepass, float scale, cudaStream_t stream) {
  using C = ChunkedLayout;
  auto kernel = onepass ? flash_fwd_chunked_kernel<false>
                        : flash_fwd_chunked_kernel<true>;
  cudaError_t err = prepare(kernel, C::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>((t + kRows - 1) / kRows) *
                           bh * ((d / kHeadChunk + 1) / 2);
  if (blocks <= 0 || blocks > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const FwdArgs args{static_cast<const float*>(q), static_cast<const float*>(k),
                     static_cast<const float*>(v), static_cast<float*>(o),
                     m, l, bh, t, tk, q_off, k_off, causal, normalize, scale,
                     d};
  kernel<<<static_cast<unsigned>(blocks), kThreads, C::kBytes, stream>>>(
      args);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* m,
               float* l, int bh, int t, int tk, int q_off, int k_off,
               int causal, int normalize, int onepass, float scale,
               cudaStream_t stream) {
  using L = Layout<D>;
  // one block an SM from D 64: more than half of an H100 SM's 228 KB (at D
  // 8, 16 and 32, 47, 57 and 77 KB, several blocks share an SM; at D 256,
  // 212 KB)
  static_assert(D < 64 || L::kBytes > 116 * 1024,
                "a second block would fit an SM");
  auto kernel =
      onepass ? flash_fwd_kernel<D, false> : flash_fwd_kernel<D, true>;
  cudaError_t err = prepare(kernel, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>((t + kRows - 1) / kRows) * bh;
  if (blocks <= 0 || blocks > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const FwdArgs args{static_cast<const float*>(q), static_cast<const float*>(k),
                     static_cast<const float*>(v), static_cast<float*>(o),
                     m, l, bh, t, tk, q_off, k_off, causal, normalize, scale};
  kernel<<<static_cast<unsigned>(blocks), kThreads, L::kBytes, stream>>>(
      args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The bf16 forward on tensor cores (flash_forward_sm90.cu).
int flash_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                   float* m, float* l, int bh, int t, int tk, int d, int q_off,
                   int k_off, int causal, int normalize, int out_f32,
                   int onepass, float scale, cudaStream_t stream);

extern "C" {

const char* rtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Returns cudaGetLastError() after the launch (0 on success); an unsupported
// head dim or dtype returns cudaErrorInvalidValue without launching. The
// head dims built (each entry's `case`s, which
// ops/flash_attention.py KERNEL_HEAD_DIMS lists): 8, 16, 32, 64, 128 and
// 256; a multiple of kHeadChunk past 256 runs the chunked body.
// onepass = 0 launches the two-term body (flash_fwd_twoterm). bf16 goes to
// the tensor-core forward, f32 to flash_fwd_kernel (o is f32 either way, so
// out_f32 changes nothing there). q, k and v must be 16-byte aligned.
int rtt_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  float* m, float* l, int bh, int t, int tk, int d, int dtype,
                  int q_off, int k_off, int causal, int normalize, int out_f32,
                  int onepass, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    return flash_fwd_sm90(q, k, v, o, m, l, bh, t, tk, d, q_off, k_off, causal,
                          normalize, out_f32, onepass, scale, s);
  }
  if (dtype != kF32) return static_cast<int>(cudaErrorInvalidValue);
#define RTT_FWD(D)                                                         \
  return launch_fwd<D>(q, k, v, o, m, l, bh, t, tk, q_off, k_off, causal, \
                       normalize, onepass, scale, s)
  switch (d) {
    case 8: RTT_FWD(8);
    case 16: RTT_FWD(16);
    case 32: RTT_FWD(32);
    case 64: RTT_FWD(64);
    case 128: RTT_FWD(128);
    case 256: RTT_FWD(256);
  }
#undef RTT_FWD
  if (d > kHeadChunk && d % kHeadChunk == 0) {
    return launch_fwd_chunked(q, k, v, o, m, l, bh, t, tk, d, q_off, k_off,
                              causal, normalize, onepass, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
