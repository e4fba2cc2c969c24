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
// Interface: two plain C entry points, bf16 and fp32 (loaded with ctypes);
// each launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() (or the error of encoding a tensor map).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
  int B, Sq, Sk, H, KV, causal;
  long long o_sb, o_ss, o_sh;           // strides in elements
  float scale_log2;                     // hd^-1/2 * log2(e)
};

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

// d += a b as lo.hi + hi.lo + hi.hi of tf32 terms, the small products
// first; b's fragment (b0, b1) split here
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
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
}  // namespace

extern "C" {

// q (B, Sq, H, hd), k/v (B, Sk, KV, hd), o (B, Sq, H, hd), all bf16, with
// (batch, seq, head) strides in elements (head axis contiguous, strides
// multiples of 8, q/k/v 16-byte aligned: TMA's conditions).  hd is 16, 32,
// 64, 128 or 160; H % KV == 0.
int rt_flash_attention(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                       int Sk, int H, int KV, int hd, int causal, long long q_sb,
                       long long q_ss, long long q_sh, long long k_sb, long long k_ss,
                       long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                       long long o_sb, long long o_ss, long long o_sh, float scale,
                       void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H < KV || H % KV != 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const Params p{static_cast<bf16*>(o), B, Sq, Sk, H, KV, causal, o_sb, o_ss, o_sh,
                 scale * kLog2e};
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
                           float scale, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H < KV || H % KV != 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const ParamsF p{static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<float*>(o),
                  B, Sq, Sk, H, KV, causal,
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

}  // extern "C"
