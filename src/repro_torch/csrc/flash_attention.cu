// Flash attention for Hopper (sm_90a).
//
// The counterpart of the reference's Pallas kernel flash_attention_pallas
// (src/repro/kernels/flash_attention/kernel.py:55): causal or non-causal
// attention with an online softmax, GQA by kv row.
//
// What it computes.  o[b, i, h] = sum_j softmax_j(s_ij) v[b, j, h / G] with
// s_ij = (q[b, i, h] . k[b, j, h / G]) * hd^-1/2 in fp32, where causal masks
// keys j > i to -1e30 (query and key positions both counted from 0, as the
// Pallas kernel's iota origin).  Per query row the running max m, running
// sum l and the accumulator live in fp32; each tile's probabilities
// p = exp(s - m) are rounded to bf16 before P.V (the Pallas kernel's
// p.astype(v.dtype)); the output is acc / max(l, 1e-30) rounded to bf16.
// q (B, Sq, H, hd), k/v (B, Sk, KV, hd) and o (B, Sq, H, hd) are read and
// written in the model's own layout through strides: the head axis must
// be contiguous and rows 16-byte aligned.  Two instances, each at hd 16,
// 32, 64, 128 and 160 (the reference's test grid and every served or
// listed config): bf16 and fp32, both on the tensor cores.
//
// What bounds it on an H100.  At prefill lengths it is bound by
// operations: two products of 2 * B * H * Sq * Sk * hd flop each (half of
// that when causal) against 989 TFLOP/s dense bf16 (fp32: 67 TFLOP/s
// FFMA, or three TF32 products at 495 TFLOP/s on the route below), while
// it moves only q, k, v and o once (the score matrix never reaches device
// memory).
//
// What the design does about it (bf16).  Both products run on wgmma (bf16
// in, fp32 accumulate), fed by TMA, in a warp-specialised block of three
// warpgroups.  One block owns 128 query rows of one (batch, head): two
// consumer warpgroups of 64 rows each, and a producer warpgroup (one warp
// of it issues every load) whose registers setmaxnreg hands to the
// consumers (24 and 240 a thread).  The producer TMA-loads the block's Q
// once, then K and V tiles of 128 keys into a ring of two stages (three at
// hd <= 64), straight from the model's strided (B, S, heads, hd) layout
// through 4D tensor maps; rows past the sequence arrive as zeros.  Each
// tile is cut along hd into swizzle atoms of 16, 32 or 64 elements (32-,
// 64- or 128-byte swizzle; hd 160 is five 32-element atoms), so one map
// box fills one atom.  A consumer warpgroup waits for a stage, computes
// S = Q Kᵀ (64 x 128, Q and K K-major in shared memory), masks and scales
// it, runs the online softmax on its registers, rounds P to bf16 straight
// into wgmma's A-register fragments (the accumulator layout maps onto
// them), computes O += P V (V MN-major: the transpose bit), and releases
// the stage to the producer.  The two consumers interleave, so one's
// softmax overlaps the other's products.  A causal block stops at its
// diagonal tile, blocks are issued longest rows first, and the output
// is acc / max(l, 1e-30) written through o's strides.  Ping-pong
// scheduling of the two consumers and softmax/GEMM overlap inside one
// consumer (FA3's) are later work.
//
// The fp32 instance keeps the same online-softmax structure on the tensor
// cores in split TF32 ("3xTF32"): plain TF32 keeps a 10-bit mantissa and
// would miss the reference's 1e-4 gate, so each fp32 operand x is split
// into hi = tf32(x) and lo = tf32(x - hi) (round to nearest, ties away,
// in integer operations: a conversion instruction issues at a quarter of
// their rate; hi + lo is x within 2^-22 |x|), and both products run as
// hi.hi + hi.lo + lo.hi on warp-level mma.sync m16n8k8 with fp32
// accumulate: three products at 495 TFLOP/s dense TF32, 2.5x FFMA's 67.  wgmma's tf32 form
// takes K-major operands only, so P.V would need V transposed in shared
// memory; mma.sync reads V as stored.  One block owns 64 query rows of one
// (batch, head), 16 a warp; at hd <= 64 two groups of four warps take
// alternate K/V tiles and merge their running max, sums and outputs at the
// end (a causal block's longest rows need every tile; the split halves
// that path), above one group; blocks are issued longest rows first over
// all heads, so the short ones fill in behind them.  Q and 64-key K/V tiles sit in shared
// memory (rows padded by 4 floats: conflict-free fragment reads), K and V
// staged by cp.async into a ring of two stages, rows past the sequence
// zero-filled.  Operands are split as their fragments are
// read.  Each pair of k-steps' six products (and each tile's P.V, every
// 8-column block of hd in flight at once) are summed in a fresh
// accumulator, then added to the running fp32 sums, so the tensor cores'
// own summation sees few terms.  Scores are kept in base 2 (scaled by
// hd^-1/2 log2(e), exp2).  The score accumulator's (row, key
// 2t / 2t + 1) is read as P's A fragment (columns t / t + 4) with no
// shuffle by taking V's rows in the matching order; P stays unrounded
// (the Pallas p.astype(v.dtype) is the identity in fp32).  Causal blocks
// stop at the diagonal tile (a warp above it skips the tile).
//
// The backward (the gradient of either instance, from the rows'
// log-sum-exp the forward saves) follows the forward; its note is there.
//
// Interface: plain C entry points, bf16 and fp32, forward and backward
// (loaded with ctypes); each launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError() (or the error of encoding a
// tensor map).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

// ---- bf16: wgmma, TMA, warp specialisation ---------------------------------

constexpr int kRows = 128;              // query rows per block: two consumer warpgroups
constexpr int kKeys = 128;              // keys per K/V tile
constexpr int kThreads = 384;           // warpgroups 0-1 consume, 2 produces
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

template <int HD>
struct Flash {
  static constexpr int kAtom = HD == 16 ? 16 : (HD == 32 || HD == 160) ? 32 : 64;
  static constexpr int kSw = 2 * kAtom;           // swizzle width, bytes
  static constexpr int kAtoms = HD / kAtom;
  static constexpr int kStages = HD <= 64 ? 3 : 2;
  static constexpr int kQBytes = kRows * HD * 2;
  static constexpr int kTileBytes = kKeys * HD * 2;   // one K or V tile
  static constexpr int kBarBytes = 8 * (1 + 2 * kStages);
  static constexpr int kSmem = 1024 + kQBytes + 2 * kStages * kTileBytes + kBarBytes;
};

struct Params {
  bf16* o;
  float* lse;                           // (B, H, Sq) natural-log lse, or null
  int B, Sq, Sk, H, KV, causal;
  long long o_sb, o_ss, o_sh;           // strides in elements
  float scale_log2;                     // hd^-1/2 * log2(e)
};

// the log-sum-exp of two query rows from their base-2 running max m and
// sum l (scores scaled by hd^-1/2 log2(e)): ln(sum_j exp(s_ij hd^-1/2))
// = ln(2) (m + log2 l), written to (B, H, Sq) for the backward
__device__ __forceinline__ void write_lse(float* lse, int b, int h, int H, int Sq, int qpos0,
                                          int qpos1, float m0, float m1, float l0, float l1) {
  constexpr float kLn2 = 0.6931471805599453f;
  float* row = lse + ((long long)b * H + h) * Sq;
  if (qpos0 < Sq) row[qpos0] = (m0 + log2f(l0)) * kLn2;
  if (qpos1 < Sq) row[qpos1] = (m1 + log2f(l1)) * kLn2;
}

// two fp32 values -> a bf16 pair, `lo` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, const Params p) {
  using C = Flash<HD>;
  constexpr int kAtom = C::kAtom, kSw = C::kSw, kAtoms = C::kAtoms, kStages = C::kStages;
  extern __shared__ __align__(1024) unsigned char smem_tiles[];
  unsigned char* smem = align1024(smem_tiles);
  // Q [warpgroup][atom][64 rows][kAtom]; K and V [stage][atom][128 keys][kAtom]
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kRows * HD;
  bf16* vs = ks + kStages * kKeys * HD;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + kStages * kKeys * HD);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int nq = (p.Sq + kRows - 1) / kRows;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kRows;    // longest rows first
  const int b = blockIdx.y / p.H, h = blockIdx.y - b * p.H;
  const int kvh = h / (p.H / p.KV);
  int n_tiles = (p.Sk + kKeys - 1) / kKeys;
  if (p.causal) n_tiles = min(n_tiles, (min(q0 + kRows, p.Sq) - 1) / kKeys + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);          // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every TMA load -------------------------
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 256) {
      mbar_arrive_expect_tx(q_full, C::kQBytes);
#pragma unroll 1
      for (int w = 0; w < 2; ++w)
#pragma unroll 1
        for (int a = 0; a < kAtoms; ++a)
          tma_load_4d(qs + (w * kAtoms + a) * 64 * kAtom, &tq, q_full, a * kAtom, h,
                      q0 + 64 * w, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages, use = j / kStages;
        if (use > 0) mbar_wait(&empty[st], (use - 1) & 1);
        mbar_arrive_expect_tx(&full[st], 2 * C::kTileBytes);
#pragma unroll 1
        for (int a = 0; a < kAtoms; ++a) {
          tma_load_4d(ks + (st * kAtoms + a) * kKeys * kAtom, &tk, &full[st], a * kAtom, kvh,
                      j * kKeys, b);
          tma_load_4d(vs + (st * kAtoms + a) * kKeys * kAtom, &tv, &full[st], a * kAtom, kvh,
                      j * kKeys, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each --------------------------------------
    reg_alloc<kConsumerRegs>();
    const int t = threadIdx.x % 128, warp = t >> 5, lane = t & 31;
    const int g = lane >> 2, tq4 = lane & 3;
    const int r0 = q0 + 64 * wg;                    // this warpgroup's first row
    const int qpos0 = r0 + 16 * warp + g, qpos1 = qpos0 + 8;
    const uint32_t q_base = smem_u32(qs + wg * kAtoms * 64 * kAtom);

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
    mbar_wait(q_full, 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % kStages;
      mbar_wait(&full[st], (j / kStages) & 1);
      const uint32_t k_base = smem_u32(ks + st * kAtoms * kKeys * kAtom);
      const uint32_t v_base = smem_u32(vs + st * kAtoms * kKeys * kAtom);

      // S = Q Kᵀ: 64 rows x 128 keys, hd / 16 k-steps
      float s[kKeys / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int a = kk * 16 / kAtom, off = (kk * 16 % kAtom) * 2;
        const uint64_t da = make_desc(q_base + a * 64 * kSw + off, 16, 8 * kSw, kSw);
        const uint64_t db = make_desc(k_base + a * kKeys * kSw + off, 16, 8 * kSw, kSw);
        if (kk == 0)
          wgmma_ss_n128_first<0>(s, da, db);   // the last tile's s is dead
        else
          wgmma_ss_n128<0>(s, da, db);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      const int k0 = j * kKeys;
      const bool edge = k0 + kKeys > p.Sk || (p.causal && k0 + kKeys - 1 > r0);
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) {
        float x = s[i] * p.scale_log2;
        if (edge) {
          const int kp = k0 + 8 * (i >> 2) + 2 * tq4 + (i & 1);
          const int qp = (i & 2) ? qpos1 : qpos0;
          if (kp >= p.Sk || (p.causal && kp > qp)) x = kNegInf;
        }
        s[i] = x;
        if (i & 2) mx1 = fmaxf(mx1, x); else mx0 = fmaxf(mx0, x);
      }
      // a row's 128 scores are spread over the 4 lanes of its quad
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float corr0 = exp2f(m0 - mn0), corr1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) {
        const float e = exp2f(s[i] - ((i & 2) ? mn1 : mn0));
        s[i] = e;
        if (i & 2) ps1 += e; else ps0 += e;
      }
      // per-lane partial sums; the quad's lanes are added at the end
      l0 = l0 * corr0 + ps0;
      l1 = l1 * corr1 + ps1;
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= (i & 2) ? corr1 : corr0;

      // bf16(P) as A fragments: keys 16 kk .. 16 kk + 15 are the score
      // accumulator's 8-column blocks 2 kk and 2 kk + 1
      uint32_t pa[kKeys / 16][4];
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
      // O += P V: V MN-major, hd in atoms kKeys * kSw bytes apart
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
        wgmma_rs<HD, 1>(o, pa[kk],
                        make_desc(v_base + kk * 16 * kSw, kKeys * kSw, 8 * kSw, kSw));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }

    l0 += __shfl_xor_sync(kFull, l0, 1);
    l0 += __shfl_xor_sync(kFull, l0, 2);
    l1 += __shfl_xor_sync(kFull, l1, 1);
    l1 += __shfl_xor_sync(kFull, l1, 2);
    if (p.lse != nullptr && tq4 == 0) write_lse(p.lse, b, h, p.H, p.Sq, qpos0, qpos1, m0, m1, l0, l1);
    const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
    bf16* o0 = p.o + b * p.o_sb + (long long)qpos0 * p.o_ss + h * p.o_sh + 2 * tq4;
    bf16* o1 = o0 + 8 * p.o_ss;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      if (qpos0 < p.Sq)
        *reinterpret_cast<uint32_t*>(o0 + c * 8) = pack_bf16(o[4 * c] / den0, o[4 * c + 1] / den0);
      if (qpos1 < p.Sq)
        *reinterpret_cast<uint32_t*>(o1 + c * 8) =
            pack_bf16(o[4 * c + 2] / den1, o[4 * c + 3] / den1);
    }
  }
}

// the 4D tile map of q, k or v: (hd, heads, S, B) with the tensor's
// strides, one kAtom x rows box a load
template <int HD>
int encode_qkv(CUtensorMap* map, const void* base, int B, int S, int heads, long long sb,
               long long ss, long long sh, int rows) {
  const uint64_t dims[4] = {(uint64_t)HD, (uint64_t)heads, (uint64_t)S, (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)sh * 2, (uint64_t)ss * 2, (uint64_t)sb * 2};
  const uint32_t box[4] = {(uint32_t)Flash<HD>::kAtom, 1, (uint32_t)rows, 1};
  return hopper_host::encode_bf16(map, base, 4, dims, strides, box, Flash<HD>::kSw);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const Params& p, long long q_sb,
           long long q_ss, long long q_sh, long long k_sb, long long k_ss, long long k_sh,
           long long v_sb, long long v_ss, long long v_sh, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int e = encode_qkv<HD>(&tq, q, p.B, p.Sq, p.H, q_sb, q_ss, q_sh, 64);
  if (e == 0) e = encode_qkv<HD>(&tk, k, p.B, p.Sk, p.KV, k_sb, k_ss, k_sh, kKeys);
  if (e == 0) e = encode_qkv<HD>(&tv, v, p.B, p.Sk, p.KV, v_sb, v_ss, v_sh, kKeys);
  if (e != 0) return e;
  const int smem = Flash<HD>::kSmem;
  cudaError_t ce = cudaFuncSetAttribute(flash_attention_kernel<HD>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (ce != cudaSuccess) return (int)ce;
  const dim3 grid((p.Sq + kRows - 1) / kRows, p.B * p.H);
  flash_attention_kernel<HD><<<grid, kThreads, smem, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

// ---- fp32: split TF32 on mma.sync -------------------------------------------

constexpr int kRowsF = 64;              // query rows per block: 4 warps of 16 a key group
constexpr int kKeysF = 64;              // keys per K/V tile

struct ParamsF {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;                           // (B, H, Sq) natural-log lse, or null
  int B, Sq, Sk, H, KV, causal;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale_log2;                     // hd^-1/2 * log2(e): scores in base 2
};

template <int HD>
struct FlashF {
  // key groups: at hd <= 64 two sets of 4 warps over the block's rows, each
  // taking alternate K/V tiles, merged at the end (a causal block's longest
  // rows need every tile: the split halves that path); above, one (two
  // groups' tiles would not fit in shared memory)
  static constexpr int kGroups = HD <= 64 ? 2 : 1;
  static constexpr int kThreads = 128 * kGroups;
  static constexpr int kS = HD + 4;     // shared row stride, floats: conflict-free fragments
  static constexpr int kTile = kKeysF * kS;
  // Q, then K and V tiles [stage][group] in a ring of two stages
  static constexpr int kSmem = (kRowsF * kS + 4 * kGroups * kTile) * (int)sizeof(float);
};

// 64 rows x HD of a strided fp32 source into a shared tile of row stride
// HD + 4 by cp.async; rows at or past `valid` are zero-filled
template <int HD>
__device__ __forceinline__ void stage_rows_f32(float* dst, const float* src,
                                               long long row_stride, int valid) {
  constexpr int kV = HD / 4;            // 16-byte chunks a row
  for (int i = threadIdx.x; i < kKeysF * kV; i += FlashF<HD>::kThreads) {
    const int r = i / kV, c = i - r * kV;
    const bool ok = r < valid;
    cp_async16_zfill(dst + r * FlashF<HD>::kS + 4 * c, ok ? src + r * row_stride + 4 * c : src,
                     ok);
  }
}

// x = x1 + x2 + x3 exactly: three tf32 terms, each rounded to nearest
// from what the earlier ones leave (33 bits hold fp32's 24)
__device__ __forceinline__ void split3_tf32(float x, uint32_t& x1, uint32_t& x2, uint32_t& x3) {
  x1 = tf32_rna(x);
  const float r = x - __uint_as_float(x1);
  x2 = tf32_rna(r);
  x3 = tf32_rna(r - __uint_as_float(x2));
}

// d += a b as the six tf32 products of three-term splits down to 2^-22
// of the leading one, the small first: x3 y1, x2 y2, x1 y3, x2 y1, x1 y2,
// x1 y1; b's fragment (b0, b1) split here
__device__ __forceinline__ void mma_6xtf32(float (&d)[4], const uint32_t (&a1)[4],
                                           const uint32_t (&a2)[4], const uint32_t (&a3)[4],
                                           float b0, float b1) {
  uint32_t b10, b20, b30, b11, b21, b31;
  split3_tf32(b0, b10, b20, b30);
  split3_tf32(b1, b11, b21, b31);
  mma_tf32(d, a3, b10, b11);
  mma_tf32(d, a2, b20, b21);
  mma_tf32(d, a1, b30, b31);
  mma_tf32(d, a2, b10, b11);
  mma_tf32(d, a1, b20, b21);
  mma_tf32(d, a1, b10, b11);
}

template <int HD>
__global__ void __launch_bounds__(FlashF<HD>::kThreads)
    flash_attention_f32_kernel(const ParamsF p) {
  using C = FlashF<HD>;
  constexpr int kS = C::kS, kG = C::kGroups;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + kRowsF * kS;         // [stage][group][key][kS]
  float* vs = ks + 2 * kG * C::kTile;

  // grid (B H, row blocks): every head's longest rows are issued first
  const int nq = (p.Sq + kRowsF - 1) / kRowsF;
  const int q0 = (nq - 1 - (int)blockIdx.y) * kRowsF;
  const int b = blockIdx.x / p.H, h = blockIdx.x - b * p.H;
  const int kvh = h / (p.H / p.KV);
  const float* kg = p.k + b * p.k_sb + kvh * p.k_sh;
  const float* vg = p.v + b * p.v_sb + kvh * p.v_sh;
  int n_tiles = (p.Sk + kKeysF - 1) / kKeysF;
  if (p.causal) n_tiles = min(n_tiles, (min(q0 + kRowsF, p.Sq) - 1) / kKeysF + 1);
  const int n_iter = (n_tiles + kG - 1) / kG;     // tiles it kG + group

  // iteration it's tiles into stage it & 1
  auto stage = [&](int it) {
#pragma unroll
    for (int gi = 0; gi < kG; ++gi) {
      const int k0 = (it * kG + gi) * kKeysF;
      if (k0 < n_tiles * kKeysF) {
        stage_rows_f32<HD>(ks + ((it & 1) * kG + gi) * C::kTile, kg + k0 * p.k_ss, p.k_ss,
                           p.Sk - k0);
        stage_rows_f32<HD>(vs + ((it & 1) * kG + gi) * C::kTile, vg + k0 * p.v_ss, p.v_ss,
                           p.Sk - k0);
      }
    }
  };
  stage_rows_f32<HD>(qs, p.q + b * p.q_sb + q0 * p.q_ss + h * p.q_sh, p.q_ss, p.Sq - q0);
  stage(0);
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int grp = warp >> 2;                      // the warp's key group
  const int r0 = 16 * (warp & 3);                 // the warp's first row in the block
  const int qpos0 = q0 + r0 + g, qpos1 = qpos0 + 8;
  float o[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    const int st = it & 1, k0 = (it * kG + grp) * kKeysF;
    if (it + 1 < n_iter) stage(it + 1);  // stage it + 1 was last read in iteration it - 1
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    // past the block's tiles, or a causal warp whose rows all precede the
    // tile, the warp skips it (p = 0, corr = 1)
    if (k0 < n_tiles * kKeysF && !(p.causal && k0 > q0 + r0 + 15)) {
      const float* kt = ks + (st * kG + grp) * C::kTile;
      const float* vt = vs + (st * kG + grp) * C::kTile;

      // S = Q Kᵀ: 16 rows x 64 keys, HD / 8 k-steps
      float s[kKeysF / 8][4];
#pragma unroll
      for (int nb = 0; nb < kKeysF / 8; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
      // two k-steps' products at a time summed apart, then added in fp32:
      // the tensor cores' own sums keep no more than fp32's bits
#pragma unroll 2
      for (int kk = 0; kk < HD / 8; kk += 2) {
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float* qr = qs + (r0 + g) * kS + 8 * (kk + u) + t;
          split_tf32(qr[0], ah[u][0], al[u][0]);
          split_tf32(qr[8 * kS], ah[u][1], al[u][1]);
          split_tf32(qr[4], ah[u][2], al[u][2]);
          split_tf32(qr[8 * kS + 4], ah[u][3], al[u][3]);
        }
#pragma unroll
        for (int nb = 0; nb < kKeysF / 8; ++nb) {
          const float* kr = kt + (8 * nb + g) * kS + 8 * kk + t;
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          mma_3xtf32(d, ah[0], al[0], kr[0], kr[4]);
          mma_3xtf32(d, ah[1], al[1], kr[8], kr[12]);
#pragma unroll
          for (int i = 0; i < 4; ++i) s[nb][i] += d[i];
        }
      }

      // mask, scale, online softmax; a row's 64 scores lie in its quad
      const bool edge = k0 + kKeysF > p.Sk || (p.causal && k0 + kKeysF - 1 > q0 + r0);
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int nb = 0; nb < kKeysF / 8; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float x = s[nb][i] * p.scale_log2;
          if (edge) {
            const int kp = k0 + 8 * nb + 2 * t + (i & 1);
            if (kp >= p.Sk || (p.causal && kp > ((i & 2) ? qpos1 : qpos0))) x = kNegInf;
          }
          s[nb][i] = x;
          if (i & 2) mx1 = fmaxf(mx1, x); else mx0 = fmaxf(mx0, x);
        }
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float corr0 = exp2f(m0 - mn0), corr1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKeysF / 8; ++kk) {
        s[kk][0] = exp2f(s[kk][0] - mn0);
        s[kk][1] = exp2f(s[kk][1] - mn0);
        s[kk][2] = exp2f(s[kk][2] - mn1);
        s[kk][3] = exp2f(s[kk][3] - mn1);
        ps0 += s[kk][0] + s[kk][1];
        ps1 += s[kk][2] + s[kk][3];
      }
      l0 = l0 * corr0 + ps0;            // per-lane partial; the quad's lanes added at the end
      l1 = l1 * corr1 + ps1;

      // O = O corr + P V, the tile's product summed apart in acc, every
      // 8-column block of hd in flight at once.  P, unrounded, as A
      // fragments of key steps of 8: the accumulator's (row, key 2t /
      // 2t + 1) read as A's columns t / t + 4, so V's rows are taken in
      // the order 2t, 2t + 1 (the sum over keys allows it)
      float acc[HD / 8][4];
#pragma unroll
      for (int nb = 0; nb < HD / 8; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKeysF / 8; ++kk) {
        uint32_t ph[4], pl[4];
        split_tf32(s[kk][0], ph[0], pl[0]);
        split_tf32(s[kk][2], ph[1], pl[1]);
        split_tf32(s[kk][1], ph[2], pl[2]);
        split_tf32(s[kk][3], ph[3], pl[3]);
        const float* vr = vt + (8 * kk + 2 * t) * kS + g;
#pragma unroll
        for (int nb = 0; nb < HD / 8; ++nb)
          mma_3xtf32(acc[nb], ph, pl, vr[8 * nb], vr[kS + 8 * nb]);
      }
#pragma unroll
      for (int nb = 0; nb < HD / 8; ++nb) {
        o[nb][0] = fmaf(o[nb][0], corr0, acc[nb][0]);
        o[nb][1] = fmaf(o[nb][1], corr0, acc[nb][1]);
        o[nb][2] = fmaf(o[nb][2], corr1, acc[nb][2]);
        o[nb][3] = fmaf(o[nb][3], corr1, acc[nb][3]);
      }
    }
    __syncthreads();                    // stage st is refilled in iteration it + 1
  }

  if constexpr (kG == 2) {
    // group 1's running max, sums and output merged into group 0's, the
    // exchange in the K tiles' shared memory
    constexpr int kX = HD / 2 + 4;
    cp_async_wait<0>();
    float* xs = ks + ((warp & 3) * 32 + lane) * kX;
    if (grp == 1) {
#pragma unroll
      for (int nb = 0; nb < HD / 8; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) xs[4 * nb + i] = o[nb][i];
      xs[HD / 2] = m0;
      xs[HD / 2 + 1] = m1;
      xs[HD / 2 + 2] = l0;
      xs[HD / 2 + 3] = l1;
    }
    __syncthreads();
    if (grp == 1) return;
    const float mb0 = xs[HD / 2], mb1 = xs[HD / 2 + 1];
    const float mn0 = fmaxf(m0, mb0), mn1 = fmaxf(m1, mb1);
    const float ca0 = exp2f(m0 - mn0), cb0 = exp2f(mb0 - mn0);
    const float ca1 = exp2f(m1 - mn1), cb1 = exp2f(mb1 - mn1);
    l0 = l0 * ca0 + xs[HD / 2 + 2] * cb0;
    l1 = l1 * ca1 + xs[HD / 2 + 3] * cb1;
    m0 = mn0;                           // the merged sums' max (for the lse)
    m1 = mn1;
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb) {
      o[nb][0] = o[nb][0] * ca0 + xs[4 * nb] * cb0;
      o[nb][1] = o[nb][1] * ca0 + xs[4 * nb + 1] * cb0;
      o[nb][2] = o[nb][2] * ca1 + xs[4 * nb + 2] * cb1;
      o[nb][3] = o[nb][3] * ca1 + xs[4 * nb + 3] * cb1;
    }
  }

  l0 += __shfl_xor_sync(kFull, l0, 1);
  l0 += __shfl_xor_sync(kFull, l0, 2);
  l1 += __shfl_xor_sync(kFull, l1, 1);
  l1 += __shfl_xor_sync(kFull, l1, 2);
  if (p.lse != nullptr && t == 0) write_lse(p.lse, b, h, p.H, p.Sq, qpos0, qpos1, m0, m1, l0, l1);
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  float* o0 = p.o + b * p.o_sb + (long long)qpos0 * p.o_ss + h * p.o_sh + 2 * t;
  float* o1 = o0 + 8 * p.o_ss;
#pragma unroll
  for (int nb = 0; nb < HD / 8; ++nb) {
    if (qpos0 < p.Sq)
      *reinterpret_cast<float2*>(o0 + 8 * nb) = make_float2(o[nb][0] / den0, o[nb][1] / den0);
    if (qpos1 < p.Sq)
      *reinterpret_cast<float2*>(o1 + 8 * nb) = make_float2(o[nb][2] / den1, o[nb][3] / den1);
  }
}

template <int HD>
int launch_f32(const ParamsF& p, cudaStream_t stream) {
  const int smem = FlashF<HD>::kSmem;
  cudaError_t e = cudaFuncSetAttribute(flash_attention_f32_kernel<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(p.B * p.H, (p.Sq + kRowsF - 1) / kRowsF);
  flash_attention_f32_kernel<HD><<<grid, FlashF<HD>::kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}
// ---- backward: dq, dk, dv on the tensor cores --------------------------------
//
// The gradient of the forward above, from the rows' log-sum-exp it saved:
// P = exp(s - lse) recomputed from q.k (scaled, and 0 where the forward
// masked: -1e30, causal counted from position 0), dV = Pᵀ dO with P rounded
// to v's dtype (the forward's rounding before P.V), dP = dO Vᵀ, D =
// rowsum(dO * O), dS = P (dP - D), dQ = dS K hd^-1/2 and dK = dSᵀ Q
// hd^-1/2; a kv head's dK and dV sum over its G query heads.
//
// What bounds it on an H100.  The function's work is five products of
// 2 B H hd (causal pairs) flop (S, dP, dV, dQ, dK: 0.076 ms at 989 TFLOP/s
// at the training shape B 4, S 2048, H 14, KV 2, hd 64); it moves q, k, v,
// o, dO and the three gradients once.  Without atomics S and dP are formed
// twice, once for dK/dV and once for dQ.  The FFMA kernel this replaces ran
// its products at FFMA's 67 TFLOP/s on fp32 copies of the tiles, and its
// dK/dV grid of (batch, kv head, key block) blocks lasted as long as its
// longest block (causal key block 0 walked G heads' row blocks, twice the
// mean).
//
// What the design does about it.
//  - Every product on the tensor cores.  bf16: wgmma (bf16 in, fp32
//    accumulate), one warpgroup a block.  Tiles of 64 rows arrive by TMA
//    from the model's (B, S, heads, hd) layout into swizzled shared memory
//    cut along hd into atoms, as the forward's (rows past the sequence
//    arrive as zeros).  S-like products read both operands K-major from
//    shared memory; the products over rows (dV, dK, dQ) take their A
//    operand from registers and read B MN-major (the transpose bit), so
//    nothing is transposed in memory.  fp32: split TF32 on mma.sync
//    m16n8k8, as the fp32 forward: each operand x split into hi = tf32(x)
//    and lo = tf32(x - hi), lo.hi + hi.lo + hi.hi, each k-step's products
//    summed in a fresh accumulator and then added to the running fp32
//    sums; fragments are read from tiles of rows of hd + 4 floats
//    (conflict-free), filled by cp.async.  S takes three terms (x1 + x2
//    + x3 = x exactly, six products).  dP - D is formed in double: dS =
//    P (dP - D) cancels to a few parts in 10^4 of dP or less in a causal
//    row that one key dominates, where rounding dP and D to fp32 apart
//    (as the plain version does) leaves errors past the 1e-4 row gate
//    against the float64 backward on some random draws
//    (scripts/flash_bwd_accuracy_sweep.py).  So dP runs on the FP64
//    tensor cores (mma.sync m8n8k4: fp32 operands exact in double, the
//    sum over hd in double), D is summed and kept in double, and only
//    dP - D is rounded to fp32 (rows_x_rows_dp).
//  - Keys as rows in dK/dV.  The block's 64 keys are the M of Sᵀ = K Qᵀ
//    and dPᵀ = V dOᵀ, so Pᵀ and dSᵀ come out in the accumulator layout,
//    which rounded to bf16 pairs is the A fragment layout of dV += Pᵀ dO
//    and dK += dSᵀ Q (the forward does the same with P): no trip through
//    shared memory (fp32: the accumulator's columns 2t, 2t + 1 read as A's
//    columns t, t + 4 and B's rows taken in the matching order, as the
//    forward's P.V).  The dQ block's 64 rows feed dS to dQ += dS K the
//    same way.
//  - dS in two bf16 terms.  dS is the one value that the bf16 route would
//    round where the plain version keeps fp32.  Its rows sum to zero;
//    rounded once to bf16 it takes dq and dk past the card checks' 2x of
//    the plain version's error against float64 (2.37x and 2.02x in the
//    CPU emulation, scripts/flash_bwd_ds_rounding.py).  So dS = hi + lo,
//    both bf16, and dQ and dK run two products each (nine in all): about
//    16 bits of dS.
//  - A balanced, deterministic grid.  dK/dV: one block a (batch, query
//    head, 64-key block) walking that head's row blocks from the one
//    holding its first key (causal).  It writes the head's dK and dV as
//    fp32 partials to a scratch (B, Sk, H, hd); with G > 1 `bwd_sum` adds
//    each kv head's G partials in a fixed order (g = 0, 1, ...) into dk and
//    dv, with G = 1 the block writes dk and dv itself.  dQ: one block a
//    (batch, head, 64-row block) walking the key blocks up to its diagonal
//    (causal).  Both grids are issued longest first (blockIdx.x the
//    (batch, head), the fastest; blockIdx.y the key block ascending for
//    dK/dV, the row block descending for dQ), so the short blocks fill in
//    behind the long ones.  At the training shape each grid is 1792
//    blocks, the longest walking 32 tile pairs of 64 x 64 against a mean of
//    16.5 (kernel.bwd_geometry mirrors the mapping).  No atomics: two
//    launches are bit-equal.
//  - Loads overlap the products: the walked tiles (Q, dO, lse and D in
//    dK/dV; K and V in dQ) fill a ring of three stages (bf16 at hd <= 64),
//    two, or one (fp32 at hd 160, whose tiles would not fit twice), one
//    tile ahead of the products or more.  A causal block skips a chunk that
//    the mask hides from all its rows.
//  - Registers: a thread keeps its share of the block's dK and dV (dQ) in
//    fp32 and of the scores and dP of a chunk of N queries (keys) of the
//    tile, N = 64 at hd <= 64 and 32 above (bf16 hd 160: 160 + 32
//    accumulators a thread, 224 registers, no spill).
//
// Four device kernels: `bwd_dot` (D from the output as stored, eight
// lanes a row), `bwd_dkdv`, `bwd_dq`, and `bwd_sum` when G > 1.

constexpr int kBT = 64;                // rows (queries or keys) of a backward tile
constexpr int kBwdThreads = 128;       // a warpgroup; four warps of 16 rows (fp32)
constexpr int kDotThreads = 256;

__device__ __forceinline__ void store_pair(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(bf16* dst, float a, float b) {
  *reinterpret_cast<uint32_t*>(dst) = pack_bf16(a, b);
}

// D's type: fp32 for the bf16 route, double for the fp32 route, whose
// dP - D is taken in double (see rows_x_rows_dp)
template <typename T>
using DSum = typename std::conditional<sizeof(T) == 2, float, double>::type;

// 64 lse and D values of a tile's rows (threads 0-63 and 64-127) by
// cp.async; past `valid` zeros
template <typename D>
__device__ __forceinline__ void stage_lse_d(float* lse_dst, D* d_dst, const float* lse_src,
                                            const D* d_src, int valid) {
  const int i = threadIdx.x & (kBT - 1);
  const bool ok = i < valid;
  if (threadIdx.x < kBT)
    cp_async4_zfill(lse_dst + i, ok ? lse_src + i : lse_src, ok);
  else if constexpr (sizeof(D) == 4)
    cp_async4_zfill(d_dst + i, ok ? d_src + i : d_src, ok);
  else
    cp_async8_zfill(d_dst + i, ok ? d_src + i : d_src, ok);
}

// the backward's operands and shape; the bf16 route reads q, k, v and dO
// through tensor maps instead
template <typename T>
struct BwdArgs {
  const T *q, *k, *v, *dO;
  const float* lse;                     // (B, H, Sq), natural log
  DSum<T>* dsum;                        // (B, H, Sq): D (written by bwd_dot)
  T *dq, *dk, *dv;
  float* part;                          // (2, B, Sk, H, hd), or null when H == KV
  int B, Sq, Sk, H, KV, causal;
  float scale, scale_log2;              // hd^-1/2, and times log2(e)
};

// the dot product of 16 bytes of o and dO in double (each fp32 or bf16
// product exact), in a fixed order
__device__ __forceinline__ double dot16(const float* a, const float* b) {
  const float4 x = *reinterpret_cast<const float4*>(a), y = *reinterpret_cast<const float4*>(b);
  double s = (double)x.x * y.x;
  s = fma((double)x.y, (double)y.y, s);
  s = fma((double)x.z, (double)y.z, s);
  return fma((double)x.w, (double)y.w, s);
}
__device__ __forceinline__ double dot16(const bf16* a, const bf16* b) {
  const uint4 x = *reinterpret_cast<const uint4*>(a), y = *reinterpret_cast<const uint4*>(b);
  const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
  double s = 0.0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(xp[i]), w = __bfloat1622float2(yp[i]);
    s = fma((double)u.x, (double)w.x, s);
    s = fma((double)u.y, (double)w.y, s);
  }
  return s;
}

// D[b, h, i] = sum_d dO[b, i, h, d] O[b, i, h, d]: eight lanes a row, 16
// bytes a lane a step (a warp's loads are four whole rows), the lanes'
// sums added in a fixed tree, in double (D is subtracted from dP, which
// nearly cancels it in a row that one key dominates); kept in double for
// the fp32 route, rounded once to fp32 for the bf16 route
template <typename T>
__global__ void __launch_bounds__(kDotThreads)
    flash_bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dO,
                         DSum<T>* __restrict__ dsum, int B, int Sq, int H, int hd) {
  constexpr int kE = 16 / (int)sizeof(T);           // elements a 16-byte load
  const long long row = ((long long)blockIdx.x * kDotThreads + threadIdx.x) / 8;
  const int part = threadIdx.x & 7;
  const bool ok = row < (long long)B * Sq * H;
  double acc = 0.0;
  if (ok)
    for (int c = part * kE; c < hd; c += 8 * kE) acc += dot16(o + row * hd + c, dO + row * hd + c);
  acc += __shfl_xor_sync(kFull, acc, 4);
  acc += __shfl_xor_sync(kFull, acc, 2);
  acc += __shfl_xor_sync(kFull, acc, 1);
  if (ok && part == 0) {
    const int h = (int)(row % H);
    const long long bi = row / H;
    const int i = (int)(bi % Sq), b = (int)(bi / Sq);
    dsum[((long long)b * H + h) * Sq + i] = (DSum<T>)acc;
  }
}

// dk, dv (B, Sk, KV, hd) from the partials (2, B, Sk, H, hd): each kv head's
// G query heads added in order, four columns a thread
template <typename T>
__global__ void __launch_bounds__(256)
    flash_bwd_sum_kernel(const float* __restrict__ part, T* __restrict__ dk, T* __restrict__ dv,
                         long long n4, long long part_n, int KV, int G, int hd4) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= 2 * n4) return;
  const int which = i >= n4;                      // 0: dk, 1: dv
  const long long e = which ? i - n4 : i;         // float4 index of (B, Sk, KV, hd)
  const long long row = e / ((long long)KV * hd4);   // b * Sk + key
  const int rem = (int)(e - row * KV * hd4), kvh = rem / hd4, c4 = rem - kvh * hd4;
  const float4* src = reinterpret_cast<const float4*>(part + which * part_n) +
                      (row * KV + kvh) * G * (long long)hd4 + c4;
  float4 s = src[0];
  for (int gi = 1; gi < G; ++gi) {
    const float4 x = src[(long long)gi * hd4];
    s.x += x.x;
    s.y += x.y;
    s.z += x.z;
    s.w += x.w;
  }
  T* dst = (which ? dv : dk) + e * 4;
  store_pair(dst, s.x, s.y);
  store_pair(dst + 2, s.z, s.w);
}

// a kernel's dK, dV rows `key0` and `key0 + 8` of an m16 accumulator tile
// (pairs of columns 8 nb + 2 t4): G = 1 into dk, dv (B, Sk, KV, hd) as T,
// else this query head's fp32 partials into part (2, B, Sk, H, hd)
template <typename T, int HD>
__device__ __forceinline__ void store_dkdv(const float (&acc_k)[HD / 2], const float (&acc_v)[HD / 2],
                                           const BwdArgs<T>& p, int b, int h, int kvh, int key0,
                                           int t4) {
  const bool direct = p.H == p.KV;
  const long long stride = (long long)(direct ? p.KV : p.H) * HD;
  const long long base = (long long)b * p.Sk * stride + (long long)(direct ? kvh : h) * HD + 2 * t4;
  const long long part_n = (long long)p.B * p.Sk * p.H * HD;
#pragma unroll
  for (int nb = 0; nb < HD / 8; ++nb)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int key = key0 + 8 * hf;
      if (key >= p.Sk) continue;
      const long long at = base + key * stride + 8 * nb;
      const float k0 = acc_k[4 * nb + 2 * hf] * p.scale, k1 = acc_k[4 * nb + 2 * hf + 1] * p.scale;
      const float v0 = acc_v[4 * nb + 2 * hf], v1 = acc_v[4 * nb + 2 * hf + 1];
      if (direct) {
        store_pair(p.dk + at, k0, k1);
        store_pair(p.dv + at, v0, v1);
      } else {
        store_pair(p.part + at, k0, k1);
        store_pair(p.part + part_n + at, v0, v1);
      }
    }
}

// P from a scaled score's s and its row's natural-log lse, 0 where the
// caller masks.  bf16: in base 2 (exp2 of s hd^-1/2 log2(e) - lse
// log2(e)), its error far below bf16's; fp32: expf(s hd^-1/2 - lse) with
// one rounding of the exponent, which is small where P is large (base 2
// would round lse log2(e), the same for a whole row, and scale the row's
// P by it)
__device__ __forceinline__ float prob(float s, float lse, const BwdArgs<bf16>& p) {
  return exp2f(s * p.scale_log2 - lse * kLog2e);
}
__device__ __forceinline__ float prob(float s, float lse, const BwdArgs<float>& p) {
  return expf(fmaf(s, p.scale, -lse));
}

// dK/dV's elementwise step over a chunk of N queries at tile row c0 (the
// accumulator layout: element 4 nb + i at key key0 + 8 (i >> 1), query row
// c0 + 8 nb + 2 t4 + (i & 1) of the tile starting at q0): sp (Sᵀ) becomes
// Pᵀ (``prob``) and ds (dPᵀ) dSᵀ = Pᵀ (dPᵀ - D), 0 where masked.  lt, dt:
// the tile's lse (natural log) and D by row (bf16; the fp32 route's ds
// arrives as dPᵀ - D, and dt is unused)
template <typename T, int N>
__device__ __forceinline__ void dkdv_probs(float (&sp)[N / 2], float (&ds)[N / 2], const float* lt,
                                           const float* dt, int c0, int q0, int key0, int t4,
                                           bool edge, const BwdArgs<T>& p) {
#pragma unroll
  for (int nb = 0; nb < N / 8; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + 8 * nb + 2 * t4 + (i & 1);
      float pr = prob(sp[4 * nb + i], lt[c], p);
      if (edge) {
        const int key = key0 + 4 * (i & 2), qi = q0 + c;
        if (key >= p.Sk || qi >= p.Sq || (p.causal && key > qi)) pr = 0.f;
      }
      sp[4 * nb + i] = pr;
      if constexpr (sizeof(T) == 2)
        ds[4 * nb + i] = pr * (ds[4 * nb + i] - dt[c]);
      else
        ds[4 * nb + i] = pr * ds[4 * nb + i];
    }
}

// dQ's: s (S, element 4 nb + i at row qpos0 + 8 (i >> 1), key kc + 8 nb +
// 2 t4 + (i & 1)) becomes dS = P (dP - D) with dp (dP); l0 / l1 the two
// rows' lse (natural log), d0 / d1 their D (bf16; the fp32 route's dp
// arrives as dP - D, and d0 / d1 are unused)
template <typename T, int N>
__device__ __forceinline__ void dq_probs(float (&s)[N / 2], const float (&dp)[N / 2], float l0,
                                         float l1, float d0, float d1, int kc, int qpos0, int t4,
                                         bool edge, const BwdArgs<T>& p) {
#pragma unroll
  for (int nb = 0; nb < N / 8; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float pr = prob(s[4 * nb + i], (i & 2) ? l1 : l0, p);
      if (edge) {
        const int key = kc + 8 * nb + 2 * t4 + (i & 1), qi = qpos0 + 4 * (i & 2);
        if (key >= p.Sk || qi >= p.Sq || (p.causal && key > qi)) pr = 0.f;
      }
      if constexpr (sizeof(T) == 2)
        s[4 * nb + i] = pr * (dp[4 * nb + i] - ((i & 2) ? d1 : d0));
      else
        s[4 * nb + i] = pr * dp[4 * nb + i];
    }
}

// ---- bf16: wgmma, TMA ------------------------------------------------------------

template <int HD>
struct BwdWg {
  static constexpr int kAtom = Flash<HD>::kAtom, kSw = Flash<HD>::kSw, kAtoms = Flash<HD>::kAtoms;
  static constexpr int kN = HD <= 64 ? 64 : 32;     // queries (keys) of a chunk of S and dP
  static constexpr int kStages = HD <= 64 ? 3 : 2;
  static constexpr int kTile = kBT * HD;            // elements of a tile
  static constexpr int kTileBytes = kTile * 2;
  // two fixed tiles, two a stage, a stage's 64 lse and 64 D (dK/dV), then
  // the barriers
  static constexpr int kBarOff = (2 + 2 * kStages) * kTileBytes + kStages * 2 * kBT * 4;
  static constexpr int kSmem = 1024 + kBarOff + 8 * (1 + kStages);
};

// descriptor of a tile's k16 step kk along hd, rows row0.. (K-major)
template <int HD>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int row0, int kk) {
  using C = BwdWg<HD>;
  const int a = kk * 16 / C::kAtom, off = (kk * 16 % C::kAtom) * 2;
  return make_desc(tile + a * kBT * C::kSw + row0 * C::kSw + off, 16, 8 * C::kSw, C::kSw);
}

// descriptor of a tile's rows row0 .. row0 + 15 as the k16 step of a
// product over rows, all HD columns (MN-major)
template <int HD>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int row0) {
  using C = BwdWg<HD>;
  return make_desc(tile + row0 * C::kSw, kBT * C::kSw, 8 * C::kSw, C::kSw);
}

// a 64-row tile of q, dO, k or v (rows row0.., head `head`) into `dst`, one
// box an atom; rows past the sequence arrive as zeros
template <int HD>
__device__ __forceinline__ void tma_tile(bf16* dst, const CUtensorMap* map, uint64_t* bar,
                                         int head, int row0, int b) {
  using C = BwdWg<HD>;
#pragma unroll 1
  for (int a = 0; a < C::kAtoms; ++a)
    tma_load_4d(dst + a * kBT * C::kAtom, map, bar, a * C::kAtom, head, row0, b);
}

// a pair of fp32 values as bf16 terms: hi rounded to nearest even, lo the
// rest rounded (x0 the lower column)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  const float2 hf = __bfloat1622float2(h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// x (fp32, an m64nN accumulator) as wgmma A fragments, rounded to bf16:
// fragment kk holds the 8-column blocks 2kk and 2kk + 1
template <int N>
__device__ __forceinline__ void round_frags(const float (&x)[N / 2], uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// the same in two terms, x = hi + lo
template <int N>
__device__ __forceinline__ void split_frags(const float (&x)[N / 2], uint32_t (&hi)[N / 16][4],
                                            uint32_t (&lo)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1], hi[kk][r], lo[kk][r]);
}

// dK and dV of one block of 64 keys of one (batch, query head): one
// warpgroup, the keys the rows of every product
template <int HD>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_dkdv_wg_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tdo,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv, const BwdArgs<bf16> p) {
  using C = BwdWg<HD>;
  constexpr int kN = C::kN, kSt = C::kStages;
  extern __shared__ __align__(1024) unsigned char smem_tiles[];
  unsigned char* smem = align1024(smem_tiles);
  bf16* ks = reinterpret_cast<bf16*>(smem);       // [atom][64][kAtom], swizzled
  bf16* vs = ks + C::kTile;
  bf16* qs = vs + C::kTile;                       // [stage]
  bf16* os = qs + kSt * C::kTile;                 // [stage] dO
  float* lse_s = reinterpret_cast<float*>(os + kSt * C::kTile);   // [stage][64]
  float* d_s = lse_s + kSt * kBT;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + C::kBarOff);
  uint64_t* full = kv_full + 1;                   // [stage]

  const int k0 = blockIdx.y * kBT;                // key block 0, the longest when causal, first
  const int b = blockIdx.x / p.H, h = blockIdx.x - b * p.H;
  const int kvh = h / (p.H / p.KV);
  const long long bh = (long long)b * p.H + h;
  const float* lse_h = p.lse + bh * p.Sq;
  const float* d_h = p.dsum + bh * p.Sq;
  const int q_first = p.causal ? k0 : 0;          // causal: rows before k0 see none of these keys
  const int n_tiles = q_first < p.Sq ? (p.Sq - q_first + kBT - 1) / kBT : 0;
  const int t = threadIdx.x;

  if (t == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kSt; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
  }
  __syncthreads();
  // tile j: Q and dO by TMA (one thread), lse and D by cp.async (all)
  auto load_qo = [&](int j) {
    const int st = j % kSt, q0 = q_first + j * kBT;
    mbar_arrive_expect_tx(&full[st], 2 * C::kTileBytes);
    tma_tile<HD>(qs + st * C::kTile, &tq, &full[st], h, q0, b);
    tma_tile<HD>(os + st * C::kTile, &tdo, &full[st], h, q0, b);
  };
  auto load_ld = [&](int j) {
    const int st = j % kSt, q0 = q_first + j * kBT;
    stage_lse_d(lse_s + st * kBT, d_s + st * kBT, lse_h + q0, d_h + q0, p.Sq - q0);
  };
  if (t == 0) {
    mbar_arrive_expect_tx(kv_full, 2 * C::kTileBytes);
    tma_tile<HD>(ks, &tk, kv_full, kvh, k0, b);
    tma_tile<HD>(vs, &tv, kv_full, kvh, k0, b);
    for (int j = 0; j < kSt - 1 && j < n_tiles; ++j) load_qo(j);
  }
#pragma unroll
  for (int j = 0; j < kSt - 1; ++j) {
    if (j < n_tiles) load_ld(j);
    cp_async_commit();
  }

  const int lane = t & 31, t4 = lane & 3;
  const int key0 = k0 + 16 * (t >> 5) + (lane >> 2);
  const uint32_t k_base = smem_u32(ks), v_base = smem_u32(vs);
  float acc_k[HD / 2], acc_v[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  mbar_wait(kv_full, 0);

  for (int j = 0; j < n_tiles; ++j) {
    // the stage refilled here was read in iteration j - 1
    if (j + kSt - 1 < n_tiles) {
      if (t == 0) load_qo(j + kSt - 1);
      load_ld(j + kSt - 1);
    }
    cp_async_commit();
    cp_async_wait<kSt - 1>();
    __syncthreads();
    const int st = j % kSt, q0 = q_first + j * kBT;
    mbar_wait(&full[st], (j / kSt) & 1);
    const uint32_t q_base = smem_u32(qs + st * C::kTile), o_base = smem_u32(os + st * C::kTile);
#pragma unroll 1
    for (int c0 = 0; c0 < kBT; c0 += kN) {
      const int qc = q0 + c0;                     // the chunk's first query
      // past the sequence, or (causal) every key after the chunk's last
      // query: nothing to add
      if (qc >= p.Sq || (p.causal && k0 > qc + kN - 1)) continue;
      float sp[kN / 2], ds[kN / 2];               // Sᵀ then Pᵀ; dPᵀ then dSᵀ
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) sp[i] = ds[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<kN, 0>(sp, desc_k<HD>(k_base, 0, kk), desc_k<HD>(q_base, c0, kk));
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<kN, 0>(ds, desc_k<HD>(v_base, 0, kk), desc_k<HD>(o_base, c0, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sp);
      fence_regs(ds);
      const bool edge = k0 + kBT > p.Sk || qc + kN > p.Sq || (p.causal && k0 + kBT - 1 > qc);
      dkdv_probs<bf16, kN>(sp, ds, lse_s + st * kBT, d_s + st * kBT, c0, q0, key0, t4, edge, p);
      uint32_t pa[kN / 16][4], dh[kN / 16][4], dl[kN / 16][4];
      round_frags<kN>(sp, pa);                    // P rounded as the forward's P.V
      split_frags<kN>(ds, dh, dl);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk)        // dV += Pᵀ dO
        wgmma_rs<HD, 1>(acc_v, pa[kk], desc_mn<HD>(o_base, c0 + 16 * kk));
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) {      // dK += dSᵀ Q, dS = hi + lo
        wgmma_rs<HD, 1>(acc_k, dh[kk], desc_mn<HD>(q_base, c0 + 16 * kk));
        wgmma_rs<HD, 1>(acc_k, dl[kk], desc_mn<HD>(q_base, c0 + 16 * kk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_v);
      fence_regs(acc_k);
      fence_regs(pa);
      fence_regs(dh);
      fence_regs(dl);
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  store_dkdv<bf16, HD>(acc_k, acc_v, p, b, h, kvh, key0, t4);
}

// dQ of one block of 64 rows of one (batch, head): one warpgroup
template <int HD>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_dq_wg_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tdo,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, const BwdArgs<bf16> p) {
  using C = BwdWg<HD>;
  constexpr int kN = C::kN, kSt = C::kStages;
  extern __shared__ __align__(1024) unsigned char smem_tiles[];
  unsigned char* smem = align1024(smem_tiles);
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* os = qs + C::kTile;                       // dO
  bf16* ks = os + C::kTile;                       // [stage]
  bf16* vs = ks + kSt * C::kTile;                 // [stage]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::kBarOff);
  uint64_t* full = q_full + 1;                    // [stage]

  const int nq = (p.Sq + kBT - 1) / kBT;
  const int q0 = (nq - 1 - (int)blockIdx.y) * kBT;    // longest rows first
  const int b = blockIdx.x / p.H, h = blockIdx.x - b * p.H;
  const int kvh = h / (p.H / p.KV);
  int n_tiles = (p.Sk + kBT - 1) / kBT;
  if (p.causal) n_tiles = min(n_tiles, (min(q0 + kBT, p.Sq) - 1) / kBT + 1);
  const int t = threadIdx.x;

  if (t == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kSt; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
  }
  __syncthreads();
  auto load_kv = [&](int j) {
    const int st = j % kSt;
    mbar_arrive_expect_tx(&full[st], 2 * C::kTileBytes);
    tma_tile<HD>(ks + st * C::kTile, &tk, &full[st], kvh, j * kBT, b);
    tma_tile<HD>(vs + st * C::kTile, &tv, &full[st], kvh, j * kBT, b);
  };
  if (t == 0) {
    mbar_arrive_expect_tx(q_full, 2 * C::kTileBytes);
    tma_tile<HD>(qs, &tq, q_full, h, q0, b);
    tma_tile<HD>(os, &tdo, q_full, h, q0, b);
    for (int j = 0; j < kSt - 1 && j < n_tiles; ++j) load_kv(j);
  }

  const int lane = t & 31, t4 = lane & 3;
  const int qpos0 = q0 + 16 * (t >> 5) + (lane >> 2), qpos1 = qpos0 + 8;
  const long long row = ((long long)b * p.H + h) * p.Sq;
  // the thread's two rows' lse and D; rows past the sequence are masked
  const float l0 = qpos0 < p.Sq ? p.lse[row + qpos0] : 0.f;
  const float l1 = qpos1 < p.Sq ? p.lse[row + qpos1] : 0.f;
  const float d0 = qpos0 < p.Sq ? p.dsum[row + qpos0] : 0.f;
  const float d1 = qpos1 < p.Sq ? p.dsum[row + qpos1] : 0.f;
  const uint32_t q_base = smem_u32(qs), o_base = smem_u32(os);
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  mbar_wait(q_full, 0);

  for (int j = 0; j < n_tiles; ++j) {
    // the stage refilled here was read in iteration j - 1
    if (t == 0 && j + kSt - 1 < n_tiles) load_kv(j + kSt - 1);
    const int st = j % kSt, k0 = j * kBT;
    mbar_wait(&full[st], (j / kSt) & 1);
    const uint32_t k_base = smem_u32(ks + st * C::kTile), v_base = smem_u32(vs + st * C::kTile);
#pragma unroll 1
    for (int c0 = 0; c0 < kBT; c0 += kN) {
      const int kc = k0 + c0;                     // the chunk's first key
      if (kc >= p.Sk || (p.causal && kc > q0 + kBT - 1)) continue;
      float s[kN / 2], dp[kN / 2];                // S then dS; dP
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) s[i] = dp[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<kN, 0>(s, desc_k<HD>(q_base, 0, kk), desc_k<HD>(k_base, c0, kk));
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<kN, 0>(dp, desc_k<HD>(o_base, 0, kk), desc_k<HD>(v_base, c0, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      const bool edge = kc + kN > p.Sk || q0 + kBT > p.Sq || (p.causal && kc + kN - 1 > q0);
      dq_probs<bf16, kN>(s, dp, l0, l1, d0, d1, kc, qpos0, t4, edge, p);
      uint32_t dh[kN / 16][4], dl[kN / 16][4];
      split_frags<kN>(s, dh, dl);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) {      // dQ += dS K, dS = hi + lo
        wgmma_rs<HD, 1>(acc, dh[kk], desc_mn<HD>(k_base, c0 + 16 * kk));
        wgmma_rs<HD, 1>(acc, dl[kk], desc_mn<HD>(k_base, c0 + 16 * kk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(dh);
      fence_regs(dl);
    }
    __syncthreads();
  }

  const long long q_stride = (long long)p.H * HD;
  bf16* o0 = p.dq + ((long long)b * p.Sq + qpos0) * q_stride + (long long)h * HD + 2 * t4;
  bf16* o1 = o0 + 8 * q_stride;
#pragma unroll
  for (int nb = 0; nb < HD / 8; ++nb) {
    if (qpos0 < p.Sq) store_pair(o0 + 8 * nb, acc[4 * nb] * p.scale, acc[4 * nb + 1] * p.scale);
    if (qpos1 < p.Sq) store_pair(o1 + 8 * nb, acc[4 * nb + 2] * p.scale, acc[4 * nb + 3] * p.scale);
  }
}

// ---- fp32: split TF32 on mma.sync --------------------------------------------------

template <int HD>
struct BwdF {
  static constexpr int kS = HD + 4;                 // shared row stride, floats: conflict-free fragments
  static constexpr int kTile = kBT * kS;
  static constexpr int kN = HD <= 64 ? 64 : 32;     // queries (keys) of a chunk of S and dP
  static constexpr int kStages = HD > 128 ? 1 : 2;
  // two fixed tiles, two a stage, a stage's 64 lse and 64 D in double (dK/dV)
  static constexpr int kSmem = ((2 + 2 * kStages) * kTile + kStages * 3 * kBT) * (int)sizeof(float);
};

// rows [0, 64) of a (.., rows, .., HD) fp32 tensor, `stride` elements
// apart, into a shared tile by cp.async; rows at or past `valid` zero
template <int HD>
__device__ __forceinline__ void stage_tile_f32(float* dst, const float* src, long long stride,
                                               int valid) {
  constexpr int kC = HD / 4;                        // 16-byte chunks a row
  for (int i = threadIdx.x; i < kBT * kC; i += kBwdThreads) {
    const int r = i / kC, c = i - r * kC;
    const bool ok = r < valid;
    cp_async16_zfill(dst + r * BwdF<HD>::kS + 4 * c, ok ? src + r * stride + 4 * c : src, ok);
  }
}

// a warp's products.  rows_x_rows: acc (16 x N) += A Bᵀ, A the warp's 16
// rows of a shared tile and B N rows of another (both rows of HD): Sᵀ =
// K Qᵀ and S = Q Kᵀ, in three-term splits (six TF32 products).
// rows_x_rows_dp: the same product in double on the FP64 tensor cores
// (dPᵀ = V dOᵀ, dP = dO Vᵀ), D subtracted in double and the difference
// rounded once to fp32.  frag_x_rows: acc (16 x HD) += X B, X (16 x N) in the
// accumulator layout of a rows_x_rows product and B N rows of a shared
// tile: dV += Pᵀ dO, dK += dSᵀ Q, dQ += dS K, in two-term splits (three
// products).  Each k-step's products are summed apart; element 4 nb + i of
// an accumulator is (row g + 8 (i >> 1), column 8 nb + 2 t + (i & 1))
template <int HD, int N>
__device__ __forceinline__ void rows_x_rows(float (&acc)[N / 2], const float* a, const float* b) {
  constexpr int kS = HD + 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* ar = a + g * kS + t;
  const float* br = b + g * kS + t;
#pragma unroll 2
  for (int kk = 0; kk < HD / 8; ++kk) {
    uint32_t a1[4], a2[4], a3[4];
    split3_tf32(ar[8 * kk], a1[0], a2[0], a3[0]);
    split3_tf32(ar[8 * kS + 8 * kk], a1[1], a2[1], a3[1]);
    split3_tf32(ar[8 * kk + 4], a1[2], a2[2], a3[2]);
    split3_tf32(ar[8 * kS + 8 * kk + 4], a1[3], a2[3], a3[3]);
#pragma unroll
    for (int nb = 0; nb < N / 8; ++nb) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      mma_6xtf32(d, a1, a2, a3, br[8 * nb * kS + 8 * kk], br[8 * nb * kS + 8 * kk + 4]);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[4 * nb + i] += d[i];
    }
  }
}

// d (8 x 8: row g, columns 2t, 2t + 1) += a (8 x 4: row g, column t) b
// (4 x 8: row t, column g), double in and out
__device__ __forceinline__ void mma_f64(double& d0, double& d1, double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};\n"
               : "+d"(d0), "+d"(d1)
               : "d"(a), "d"(b));
}

// dP - D where it cancels.  In a causal row that one key dominates, dP -
// D is a few parts in 10^4 of dP or less, so one fp32 rounding of dP and
// one of D (the plain version's, and a TF32 split's at best) leave
// errors of 1e-4 of the row's dq; the sweep of random draws
// (scripts/flash_bwd_accuracy_sweep.py) found such rows past the 1e-4
// gate against the float64 backward.  Here each fp32 product is exact in
// double, the sum over hd runs in double on mma.sync m8n8k4 (a k-step
// of eight is two of its k = 4 steps; A's and B's fragments are the
// m16n8k8 ones above, the accumulator's rows g and g + 8 two m8n8
// products), D (double, from bwd_dot) is subtracted in double, and
// only the difference is rounded.  by_row: D of the accumulator's row
// (d0 / d1 for rows g / g + 8: dP), else of its column (dt[c0 + column]:
// dPᵀ)
template <int HD, int N, bool by_row>
__device__ __forceinline__ void rows_x_rows_dp(float (&out)[N / 2], const float* a, const float* b,
                                               double d0, double d1, const double* dt) {
  constexpr int kS = HD + 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* ar = a + g * kS + t;
  const float* br = b + g * kS + t;
  double acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0;
#pragma unroll 2
  for (int kk = 0; kk < HD / 8; ++kk)
#pragma unroll
    for (int u = 0; u < 2; ++u) {                   // columns 8 kk + 4 u + t
      const double a0 = ar[8 * kk + 4 * u], a1 = ar[8 * kS + 8 * kk + 4 * u];
#pragma unroll
      for (int nb = 0; nb < N / 8; ++nb) {
        const double bv = br[8 * nb * kS + 8 * kk + 4 * u];
        mma_f64(acc[4 * nb], acc[4 * nb + 1], a0, bv);
        mma_f64(acc[4 * nb + 2], acc[4 * nb + 3], a1, bv);
      }
    }
#pragma unroll
  for (int nb = 0; nb < N / 8; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const double d = by_row ? ((i & 2) ? d1 : d0) : dt[8 * nb + 2 * t + (i & 1)];
      out[4 * nb + i] = (float)(acc[4 * nb + i] - d);
    }
}

// X's (row, column 2t / 2t + 1) read as A's columns t / t + 4, so B's rows
// are taken in the order 2t, 2t + 1 (the sum over k allows it); X
// unrounded
template <int HD, int N>
__device__ __forceinline__ void frag_x_rows(float (&acc)[HD / 2], const float (&x)[N / 2],
                                            const float* b) {
  constexpr int kS = HD + 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* br = b + 2 * t * kS + g;
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
    uint32_t ah[4], al[4];
    split_tf32(x[4 * kk], ah[0], al[0]);
    split_tf32(x[4 * kk + 2], ah[1], al[1]);
    split_tf32(x[4 * kk + 1], ah[2], al[2]);
    split_tf32(x[4 * kk + 3], ah[3], al[3]);
    const float* bk = br + 8 * kk * kS;
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      mma_3xtf32(d, ah, al, bk[8 * nb], bk[kS + 8 * nb]);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[4 * nb + i] += d[i];
    }
  }
}

// dK and dV of one block of 64 keys of one (batch, query head): four warps
// of 16 keys
template <int HD>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_dkdv_f32_kernel(const BwdArgs<float> p) {
  using C = BwdF<HD>;
  constexpr int kS = C::kS, kN = C::kN, kSt = C::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + C::kTile;
  float* qs = vs + C::kTile;                      // [stage]
  float* os = qs + kSt * C::kTile;                // [stage] dO
  float* lse_s = os + kSt * C::kTile;             // [stage][64], natural log
  double* d_s = reinterpret_cast<double*>(lse_s + kSt * kBT);   // [stage][64]

  const int k0 = blockIdx.y * kBT;                // key block 0, the longest when causal, first
  const int b = blockIdx.x / p.H, h = blockIdx.x - b * p.H;
  const int kvh = h / (p.H / p.KV);
  const long long kv_stride = (long long)p.KV * HD, q_stride = (long long)p.H * HD;
  const long long bh = (long long)b * p.H + h;
  const float* lse_h = p.lse + bh * p.Sq;
  const double* d_h = p.dsum + bh * p.Sq;
  const int q_first = p.causal ? k0 : 0;          // causal: rows before k0 see none of these keys
  const int n_tiles = q_first < p.Sq ? (p.Sq - q_first + kBT - 1) / kBT : 0;

  auto stage = [&](int j) {
    const int st = j % kSt, q0 = q_first + j * kBT;
    const long long off = ((long long)b * p.Sq + q0) * q_stride + (long long)h * HD;
    stage_tile_f32<HD>(qs + st * C::kTile, p.q + off, q_stride, p.Sq - q0);
    stage_tile_f32<HD>(os + st * C::kTile, p.dO + off, q_stride, p.Sq - q0);
    stage_lse_d(lse_s + st * kBT, d_s + st * kBT, lse_h + q0, d_h + q0, p.Sq - q0);
  };
  const long long kv_off = ((long long)b * p.Sk + k0) * kv_stride + (long long)kvh * HD;
  stage_tile_f32<HD>(ks, p.k + kv_off, kv_stride, p.Sk - k0);
  stage_tile_f32<HD>(vs, p.v + kv_off, kv_stride, p.Sk - k0);
  // K and V land with the first group; tiles 0 .. kSt - 2 in flight
#pragma unroll
  for (int j = 0; j < kSt - 1; ++j) {
    if (j < n_tiles) stage(j);
    cp_async_commit();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t4 = lane & 3;
  const int r0 = 16 * warp;                       // the warp's first key in the block
  const int key0 = k0 + r0 + (lane >> 2);
  float acc_k[HD / 2], acc_v[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    // the stage refilled here was read in iteration j - 1
    if (j + kSt - 1 < n_tiles) stage(j + kSt - 1);
    cp_async_commit();
    cp_async_wait<kSt - 1>();
    __syncthreads();
    const int st = j % kSt, q0 = q_first + j * kBT;
    const float* qt = qs + st * C::kTile;
    const float* ot = os + st * C::kTile;
#pragma unroll 1
    for (int c0 = 0; c0 < kBT; c0 += kN) {
      const int qc = q0 + c0;                     // the chunk's first query
      // past the sequence, or (causal) all the warp's keys after the
      // chunk's last query: nothing to add
      if (qc >= p.Sq || (p.causal && k0 + r0 > qc + kN - 1)) continue;
      float sp[kN / 2], ds[kN / 2];               // Sᵀ then Pᵀ; dPᵀ then dSᵀ
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) sp[i] = ds[i] = 0.f;
      rows_x_rows<HD, kN>(sp, ks + r0 * kS, qt + c0 * kS);
      rows_x_rows_dp<HD, kN, false>(ds, vs + r0 * kS, ot + c0 * kS, 0.0, 0.0,
                                    d_s + st * kBT + c0);   // dPᵀ - D
      const bool edge =
          k0 + r0 + 16 > p.Sk || qc + kN > p.Sq || (p.causal && k0 + r0 + 15 > qc);
      dkdv_probs<float, kN>(sp, ds, lse_s + st * kBT, nullptr, c0, q0, key0, t4, edge, p);
      frag_x_rows<HD, kN>(acc_v, sp, ot + c0 * kS);   // dV += Pᵀ dO
      frag_x_rows<HD, kN>(acc_k, ds, qt + c0 * kS);   // dK += dSᵀ Q
    }
    __syncthreads();
  }
  cp_async_wait<0>();                             // (K and V of a block with no rows)
  store_dkdv<float, HD>(acc_k, acc_v, p, b, h, kvh, key0, t4);
}

// dQ of one block of 64 rows of one (batch, head): four warps of 16 rows
template <int HD>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_dq_f32_kernel(const BwdArgs<float> p) {
  using C = BwdF<HD>;
  constexpr int kS = C::kS, kN = C::kN, kSt = C::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* os = qs + C::kTile;                      // dO
  float* ks = os + C::kTile;                      // [stage]
  float* vs = ks + kSt * C::kTile;                // [stage]

  const int nq = (p.Sq + kBT - 1) / kBT;
  const int q0 = (nq - 1 - (int)blockIdx.y) * kBT;    // longest rows first
  const int b = blockIdx.x / p.H, h = blockIdx.x - b * p.H;
  const int kvh = h / (p.H / p.KV);
  const long long kv_stride = (long long)p.KV * HD, q_stride = (long long)p.H * HD;
  int n_tiles = (p.Sk + kBT - 1) / kBT;
  if (p.causal) n_tiles = min(n_tiles, (min(q0 + kBT, p.Sq) - 1) / kBT + 1);

  const long long q_off = ((long long)b * p.Sq + q0) * q_stride + (long long)h * HD;
  stage_tile_f32<HD>(qs, p.q + q_off, q_stride, p.Sq - q0);
  stage_tile_f32<HD>(os, p.dO + q_off, q_stride, p.Sq - q0);
  auto stage = [&](int j) {
    const int st = j % kSt, k0 = j * kBT;
    const long long off = ((long long)b * p.Sk + k0) * kv_stride + (long long)kvh * HD;
    stage_tile_f32<HD>(ks + st * C::kTile, p.k + off, kv_stride, p.Sk - k0);
    stage_tile_f32<HD>(vs + st * C::kTile, p.v + off, kv_stride, p.Sk - k0);
  };
#pragma unroll
  for (int j = 0; j < kSt - 1; ++j) {
    if (j < n_tiles) stage(j);
    cp_async_commit();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t4 = lane & 3;
  const int r0 = 16 * warp;                       // the warp's first row in the block
  const int qpos0 = q0 + r0 + (lane >> 2), qpos1 = qpos0 + 8;
  const long long row = ((long long)b * p.H + h) * p.Sq;
  const float l0 = qpos0 < p.Sq ? p.lse[row + qpos0] : 0.f;
  const float l1 = qpos1 < p.Sq ? p.lse[row + qpos1] : 0.f;
  const double d0 = qpos0 < p.Sq ? p.dsum[row + qpos0] : 0.0;
  const double d1 = qpos1 < p.Sq ? p.dsum[row + qpos1] : 0.0;
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + kSt - 1 < n_tiles) stage(j + kSt - 1);
    cp_async_commit();
    cp_async_wait<kSt - 1>();
    __syncthreads();
    const int st = j % kSt, k0 = j * kBT;
    const float* kt = ks + st * C::kTile;
    const float* vt = vs + st * C::kTile;
#pragma unroll 1
    for (int c0 = 0; c0 < kBT; c0 += kN) {
      const int kc = k0 + c0;                     // the chunk's first key
      if (kc >= p.Sk || (p.causal && kc > q0 + r0 + 15)) continue;
      float s[kN / 2], dp[kN / 2];                // S then dS; dP
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) s[i] = dp[i] = 0.f;
      rows_x_rows<HD, kN>(s, qs + r0 * kS, kt + c0 * kS);
      rows_x_rows_dp<HD, kN, true>(dp, os + r0 * kS, vt + c0 * kS, d0, d1, nullptr);  // dP - D
      const bool edge =
          kc + kN > p.Sk || q0 + r0 + 16 > p.Sq || (p.causal && kc + kN - 1 > q0 + r0);
      dq_probs<float, kN>(s, dp, l0, l1, 0.f, 0.f, kc, qpos0, t4, edge, p);
      frag_x_rows<HD, kN>(acc, s, kt + c0 * kS);  // dQ += dS K
    }
    __syncthreads();
  }

  float* o0 = p.dq + ((long long)b * p.Sq + qpos0) * q_stride + (long long)h * HD + 2 * t4;
  float* o1 = o0 + 8 * q_stride;
#pragma unroll
  for (int nb = 0; nb < HD / 8; ++nb) {
    if (qpos0 < p.Sq) store_pair(o0 + 8 * nb, acc[4 * nb] * p.scale, acc[4 * nb + 1] * p.scale);
    if (qpos1 < p.Sq) store_pair(o1 + 8 * nb, acc[4 * nb + 2] * p.scale, acc[4 * nb + 3] * p.scale);
  }
}

// ---- launch --------------------------------------------------------------------------

template <typename K>
int set_smem(K kernel, int smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// blocks an SM (the occupancy API), registers and local (spill) bytes a
// thread of `kernel` with `smem` bytes of dynamic shared memory
template <typename K>
int kernel_occupancy(K kernel, int smem, int* blocks, int* regs, int* local) {
  int e = set_smem(kernel, smem);
  if (e == 0)
    e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kBwdThreads, smem);
  cudaFuncAttributes a;
  if (e == 0) e = (int)cudaFuncGetAttributes(&a, kernel);
  if (e == 0) {
    *regs = a.numRegs;
    *local = (int)a.localSizeBytes;
  }
  return e;
}

template <typename T, int HD>
int launch_bwd(const BwdArgs<T>& p, const T* o, cudaStream_t stream) {
  if (p.H != p.KV && p.part == nullptr) return (int)cudaErrorInvalidValue;
  constexpr bool kBf16 = sizeof(T) == 2;
  const dim3 grid_k(p.B * p.H, (p.Sk + kBT - 1) / kBT), grid_q(p.B * p.H, (p.Sq + kBT - 1) / kBT);
  CUtensorMap tq, tdo, tk, tv;
  int e;
  if constexpr (kBf16) {
    const long long qr = (long long)p.H * HD, kr = (long long)p.KV * HD;
    e = encode_qkv<HD>(&tq, p.q, p.B, p.Sq, p.H, p.Sq * qr, qr, HD, kBT);
    if (e == 0) e = encode_qkv<HD>(&tdo, p.dO, p.B, p.Sq, p.H, p.Sq * qr, qr, HD, kBT);
    if (e == 0) e = encode_qkv<HD>(&tk, p.k, p.B, p.Sk, p.KV, p.Sk * kr, kr, HD, kBT);
    if (e == 0) e = encode_qkv<HD>(&tv, p.v, p.B, p.Sk, p.KV, p.Sk * kr, kr, HD, kBT);
    if (e == 0) e = set_smem(flash_bwd_dkdv_wg_kernel<HD>, BwdWg<HD>::kSmem);
    if (e == 0) e = set_smem(flash_bwd_dq_wg_kernel<HD>, BwdWg<HD>::kSmem);
  } else {
    e = set_smem(flash_bwd_dkdv_f32_kernel<HD>, BwdF<HD>::kSmem);
    if (e == 0) e = set_smem(flash_bwd_dq_f32_kernel<HD>, BwdF<HD>::kSmem);
  }
  if (e != 0) return e;
  const long long rows = (long long)p.B * p.Sq * p.H;
  constexpr int kRowsABlock = kDotThreads / 8;
  flash_bwd_dot_kernel<T><<<(unsigned)((rows + kRowsABlock - 1) / kRowsABlock), kDotThreads, 0,
                            stream>>>(o, p.dO, p.dsum, p.B, p.Sq, p.H, HD);
  if constexpr (kBf16) {
    constexpr int smem = BwdWg<HD>::kSmem;
    flash_bwd_dkdv_wg_kernel<HD><<<grid_k, kBwdThreads, smem, stream>>>(tq, tdo, tk, tv, p);
    flash_bwd_dq_wg_kernel<HD><<<grid_q, kBwdThreads, smem, stream>>>(tq, tdo, tk, tv, p);
  } else {
    constexpr int smem = BwdF<HD>::kSmem;
    flash_bwd_dkdv_f32_kernel<HD><<<grid_k, kBwdThreads, smem, stream>>>(p);
    flash_bwd_dq_f32_kernel<HD><<<grid_q, kBwdThreads, smem, stream>>>(p);
  }
  if (p.H != p.KV) {
    const long long n4 = (long long)p.B * p.Sk * p.KV * HD / 4;
    flash_bwd_sum_kernel<T><<<(unsigned)((2 * n4 + 255) / 256), 256, 0, stream>>>(
        p.part, p.dk, p.dv, n4, (long long)p.B * p.Sk * p.H * HD, p.KV, p.H / p.KV, HD / 4);
  }
  return (int)cudaGetLastError();
}

// out[0], out[1]: blocks an SM of the dK/dV and dQ kernels; out[2..5]
// their registers and local bytes a thread; out[6] their dynamic shared
// memory
template <typename T, int HD>
int bwd_occupancy(int* out) {
  int e;
  if constexpr (sizeof(T) == 2) {
    out[6] = BwdWg<HD>::kSmem;
    e = kernel_occupancy(flash_bwd_dkdv_wg_kernel<HD>, out[6], &out[0], &out[2], &out[3]);
    if (e == 0) e = kernel_occupancy(flash_bwd_dq_wg_kernel<HD>, out[6], &out[1], &out[4], &out[5]);
  } else {
    out[6] = BwdF<HD>::kSmem;
    e = kernel_occupancy(flash_bwd_dkdv_f32_kernel<HD>, out[6], &out[0], &out[2], &out[3]);
    if (e == 0) e = kernel_occupancy(flash_bwd_dq_f32_kernel<HD>, out[6], &out[1], &out[4], &out[5]);
  }
  return e;
}

template <typename T>
int bwd_entry(const void* q, const void* k, const void* v, const void* o, const void* dO,
              const void* lse, void* dq, void* dk, void* dv, void* dsum, void* part, int B,
              int Sq, int Sk, int H, int KV, int hd, int causal, float scale, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H < KV || H % KV != 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const BwdArgs<T> p{static_cast<const T*>(q), static_cast<const T*>(k),
                     static_cast<const T*>(v), static_cast<const T*>(dO),
                     static_cast<const float*>(lse), static_cast<DSum<T>*>(dsum),
                     static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv),
                     static_cast<float*>(part), B, Sq, Sk, H, KV, causal, scale,
                     scale * kLog2e};
  const T* to = static_cast<const T*>(o);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_bwd<T, 16>(p, to, s);
    case 32: return launch_bwd<T, 32>(p, to, s);
    case 64: return launch_bwd<T, 64>(p, to, s);
    case 128: return launch_bwd<T, 128>(p, to, s);
    case 160: return launch_bwd<T, 160>(p, to, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int occupancy_entry(int hd, int* out) {
  switch (hd) {
    case 16: return bwd_occupancy<T, 16>(out);
    case 32: return bwd_occupancy<T, 32>(out);
    case 64: return bwd_occupancy<T, 64>(out);
    case 128: return bwd_occupancy<T, 128>(out);
    case 160: return bwd_occupancy<T, 160>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, Sq, H, hd), k/v (B, Sk, KV, hd), o (B, Sq, H, hd), all bf16, with
// (batch, seq, head) strides in elements (head axis contiguous, strides
// multiples of 8, q/k/v 16-byte aligned: TMA's conditions).  hd is 16, 32,
// 64, 128 or 160; H % KV == 0.  `lse`: null, or an fp32 (B, H, Sq) buffer
// that receives each row's log-sum-exp of the scaled scores (the
// backward's input); o is the same bits either way.
int rt_flash_attention(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                       int Sk, int H, int KV, int hd, int causal, long long q_sb,
                       long long q_ss, long long q_sh, long long k_sb, long long k_ss,
                       long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                       long long o_sb, long long o_ss, long long o_sh, float scale,
                       void* lse, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H < KV || H % KV != 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const Params p{static_cast<bf16*>(o), static_cast<float*>(lse), B, Sq, Sk, H, KV, causal,
                 o_sb, o_ss, o_sh, scale * kLog2e};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(q, k, v, p, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, s);
    case 32: return launch<32>(q, k, v, p, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, s);
    case 64: return launch<64>(q, k, v, p, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, s);
    case 128: return launch<128>(q, k, v, p, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, s);
    case 160: return launch<160>(q, k, v, p, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The same in fp32: strides multiples of 4, pointers 16-byte aligned.
int rt_flash_attention_f32(const void* q, const void* k, const void* v, void* o, int B,
                           int Sq, int Sk, int H, int KV, int hd, int causal,
                           long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                           long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                           long long v_sh, long long o_sb, long long o_ss, long long o_sh,
                           float scale, void* lse, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H < KV || H % KV != 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const ParamsF p{static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<float*>(o),
                  static_cast<float*>(lse), B, Sq, Sk, H, KV, causal,
                  q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
                  scale * kLog2e};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_f32<16>(p, s);
    case 32: return launch_f32<32>(p, s);
    case 64: return launch_f32<64>(p, s);
    case 128: return launch_f32<128>(p, s);
    case 160: return launch_f32<160>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The backward of either instance: q, o, dO, dq (B, Sq, H, hd), k, v, dk,
// dv (B, Sk, KV, hd), all contiguous and 16-byte aligned, bf16
// (rt_flash_attention_bwd) or fp32 (rt_flash_attention_bwd_f32); lse (B,
// H, Sq) fp32 as the forward wrote it; dsum a (B, H, Sq) scratch for D,
// fp32 (bf16 route) or double (fp32 route); part an fp32 (2, B, Sk, H, hd) scratch (each query head's dK and
// dV), or null when H == KV.  Three or four device kernels on the
// caller's stream; allocates nothing.
int rt_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                           const void* dO, const void* lse, void* dq, void* dk, void* dv,
                           void* dsum, void* part, int B, int Sq, int Sk, int H, int KV, int hd,
                           int causal, float scale, void* stream) {
  return bwd_entry<bf16>(q, k, v, o, dO, lse, dq, dk, dv, dsum, part, B, Sq, Sk, H, KV, hd,
                         causal, scale, stream);
}

int rt_flash_attention_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                               const void* dO, const void* lse, void* dq, void* dk, void* dv,
                               void* dsum, void* part, int B, int Sq, int Sk, int H, int KV,
                               int hd, int causal, float scale, void* stream) {
  return bwd_entry<float>(q, k, v, o, dO, lse, dq, dk, dv, dsum, part, B, Sq, Sk, H, KV, hd,
                          causal, scale, stream);
}

// The backward kernels' residency at head dim hd (f32: the fp32 instance):
// out[0], out[1] blocks an SM of the dK/dV and dQ kernels (the occupancy
// API), out[2..5] their registers and local bytes a thread, out[6] their
// dynamic shared memory.
int rt_flash_attention_bwd_occupancy(int f32, int hd, int* out) {
  return f32 ? occupancy_entry<float>(hd, out) : occupancy_entry<bf16>(hd, out);
}

}  // extern "C"
