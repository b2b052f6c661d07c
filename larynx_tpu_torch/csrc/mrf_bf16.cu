// The HiFi-GAN multi-receptive-field (MRF) section in bf16 for Hopper
// (sm_90a): wgmma from shared memory, activations and weights by TMA, every
// conv's output kept in shared memory for the next.
//
// Replaces, in bf16, both TPU kernels of larynx_tpu/ops/mrf_block.py:
//   K1  fused_mrf, dense branch      (_make_kernel,        pallas_call at :272)
//   K2  _fused_mrf_packed, C < 128   (_make_packed_kernel, pallas_call at :382)
// (csrc/mrf_section.cu is the f32 kernel.)  One kernel template, on C in
// {8, 16, 32, 64, 128} and convs_per_unit in {1, 2}, computes
//   ResBlock1 (convs_per_unit=2): h_new = h + conv_k(lrelu(conv_{k,d}(lrelu(h))))
//   ResBlock2 (convs_per_unit=1): h_new = h + conv_{k,d}(lrelu(h))
// over a chain's units, and the section's output, the chains' mean, for
// h [B, T, C] bf16 (channels-last, contiguous), every conv zero-padded
// 'same'.  It rounds where the Pallas kernel does (mrf_block.py:105-148):
// each conv sums in f32, adds its bias, is zeroed outside [0, T) and rounded
// to bf16; the leaky-ReLU multiplies by bf16(0.1) and rounds; h + conv is
// rounded; the chains' sum stays f32 until total / n_chains is rounded once.
//
// What bounds it: operations (2 * C^2 * 126 FLOPs a time step for
// universal_large's ResBlock1 section against 4 * C bytes of input and
// output), once the intermediates stay on chip.  On an H100 the design
// measures 24-43% of that bound: with both wgmma operands in shared memory
// its products are bound by shared-memory bandwidth (192 bytes a clock of
// operands at C=32 against the SM's 128), and they overlap poorly with the
// block's serial phases (the loads, the weight ring, each conv's drain and
// epilogue), which only two blocks per SM (C <= 32) run side by side.
// Two plans, chosen by C (ops/mrf_block.py::bf16_plan):
//
//   * C <= 64: the whole section in one launch.  A block takes R output
//     rows (256 where the section's halo S is at most 64) and loads the
//     input's R + 2 S rows once per chain by TMA (L2 serves the second and
//     third).  Each conv computes only the rows that later convs still
//     need, as 64-row wgmma blocks (the last one shifted back to end on
//     the last row needed; its first rows belong to the block before), so a
//     chain recomputes 1.1-1.3x its halo-free work.  Intermediates stay in
//     shared memory in bf16: H, the unit's input h, and A, the next conv's
//     operand (lrelu of h, or of the first conv's output), each conv zeroed
//     outside [0, T) as the Pallas kernel does.  The chains' f32 sum stays
//     in shared memory; the last chain's epilogue stages the mean in bf16
//     and TMA stores it.  HBM traffic: the input once and the output once.
//   * C = 128: one launch per resblock unit (a whole section at C = 128
//     fits 128 output rows a block, and its 1.6x recompute measured slower).
//     A block computes 256 first-conv rows, two m64n128 accumulators per
//     consumer, so each weight stage from L2 feeds twice the rows of a
//     128-row block; it yields 256 - (k - 1) output rows.  The residual
//     comes from shared memory; a unit's output goes to a scratch buffer or
//     the output by TMA store, the f32 chains' sum in HBM by 16-byte
//     accesses (a lane exchange turns two rows' channel pairs into four
//     channels of one row).
//
// Layout: a buffer of P rows holds each 16-byte channel group (8 bf16) as a
// plane [P][8], so a row is 16 bytes and tap j's A operand, the rows shifted
// by (j - half) * d, is a wgmma descriptor 16 * (j - half) * d bytes further
// (K-major, no swizzle, core matrices of 8 contiguous rows, the two K halves
// of a k-step one plane apart).  TMA loads each plane as two boxes of P/2
// rows; its zero fill outside the tensor is the convs' padding at both ends.
// Weights are the stages of ops/mrf_block.py::pack_stages (16-channel
// k-steps of a tap, wgmma core-matrix order), streamed by one producer
// thread through an mbarrier ring in stages of up to 8 KB (fewer, larger
// stages measured faster; multicasting them to clusters of 2 measured no
// change); two consumer warpgroups run the products, one group in flight
// while the next is issued.  The producer is two warps, not a warpgroup:
// ten warps leave each thread 168 registers at one block per SM and 96 at
// two (80 with a producer warpgroup).
// The epilogues work on packed bf16 pairs: for
// bf16 inputs h + y rounded once equals the f32 sum rounded, and the
// leaky-ReLU is max(x, x * bf16(0.1)).

#include "sm90.cuh"

namespace {

constexpr int kConsumers = 2;       // consumer warpgroups: threads [0, 256)
constexpr int kProducerWarps = 2;   // after them: one streams the weights, one loads the tiles
constexpr int kThreads = 128 * kConsumers + 32 * kProducerWarps;
constexpr int kMaxStages = 16;
constexpr int kBars = 2 + 2 * kMaxStages;  // x_full, h_free, the ring's full and empty
constexpr int kChainsBytes = 128;          // the launch's Chains, after the barriers
constexpr int kMaxChains = 4;
constexpr int kMaxUnits = 4;
constexpr int kTileRows = 256;        // a section tile's output rows at most; a unit block's first-conv rows
constexpr int kMaxBox = 256;          // TMA box rows at most
constexpr size_t kMaxSmem = 232448;   // dynamic shared memory a block can have
constexpr size_t kPairSmem = 115712;  // ... two blocks of an SM can have each
constexpr float kSlope = 0.10009765625f;  // bf16(0.1), JAX's slope in bf16

enum Mode { kToScratch = 0, kOutStore = 1, kOutAdd = 2 };

using bf16 = __nv_bfloat16;

// the chains of one launch: a whole section (C <= 64) or one unit (C = 128)
struct Chains {  // at most kChainsBytes
  int n;                        // chains
  int k[kMaxChains];            // kernel size
  int units[kMaxChains];        // units per chain
  int d[kMaxChains][kMaxUnits]; // each unit's dilation
  int halo[kMaxChains];         // rows each chain reads beyond its output on each side
};
static_assert(sizeof(Chains) <= kChainsBytes, "the chains' slot in shared memory");

constexpr int kSectionC = 64;  // the section plan's widest C; wider ones run the unit plan

template <int C>
struct Geo {
  static constexpr bool kSection = C <= kSectionC;  // the plan: whole section, or one unit
  static constexpr int kCK = C < 16 ? 16 : C;       // input channels of the k-steps (C=8: 16)
  static constexpr int kKSteps = kCK / 16;          // k-steps per tap
  static constexpr int kKps = kKSteps < 256 / C ? kKSteps : 256 / C;  // k-steps per weight stage
  static constexpr int kStage = kKps * 32 * C;      // bytes of one weight stage (<= 8 KB)
  static constexpr int kMB = C < 128 ? 3 : 2;       // 64-row blocks per consumer per conv
  static constexpr int kHG = C / 8;                 // channel-group planes of H
  static constexpr int kAG = kCK / 8;               // ... of A
  static constexpr bool kPair = C <= 32;            // two blocks per SM
  static constexpr int kMaxConvs = kSection ? 2 * kMaxChains * kMaxUnits : 2;  // biases in shared memory
};

__host__ __device__ constexpr int pad16(int rows) { return (rows + 15) & ~15; }

// the block's header, first in its shared memory: the barriers, the
// launch's Chains and its biases, padded to 128 bytes (TMA's alignment)
template <int C>
__host__ __device__ constexpr uint32_t header_bytes() {
  return (8 * kBars + kChainsBytes + Geo<C>::kMaxConvs * C * 2 + 127) & ~127u;
}

template <int C>
constexpr size_t fixed_bytes(int R, int P) {
  using G = Geo<C>;
  return 1024 + header_bytes<C>() + (size_t)(G::kHG + G::kAG) * P * 16 +
         (G::kSection ? (size_t)R * C * 4 : 0);
}

// weight ring depth: as deep as the block's shared memory allows (at C <= 32
// within half an SM where 4 stages still fit), at most kMaxStages
template <int C>
constexpr int ring_stages(int R, int P) {
  const size_t fixed = fixed_bytes<C>(R, P);
  const size_t stage = Geo<C>::kStage;
  const size_t budget = Geo<C>::kPair && fixed + 4 * stage <= kPairSmem ? kPairSmem : kMaxSmem;
  if (fixed > budget) return 0;
  const size_t n = (budget - fixed) / stage;
  return n < kMaxStages ? (int)n : kMaxStages;
}

template <int C>
constexpr size_t smem_bytes(int R, int P) {
  return fixed_bytes<C>(R, P) + (size_t)ring_stages<C>(R, P) * Geo<C>::kStage;
}

// wgmma descriptor of a K-major operand without swizzle whose 8-row core
// matrices are contiguous (stride byte offset 128) and whose two K halves
// of a k-step lie `lbo` bytes apart (leading byte offset)
__device__ __forceinline__ uint64_t desc_rows(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(128 >> 4) << 32);
}

__device__ __forceinline__ void named_sync_consumers() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kConsumers) : "memory");
}

// shared memory -> the box of a 3-D tensor map at (c0, c1, c2), rows outside
// the tensor dropped
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\ncp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float2 f2add(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }

// s / n for a small integer n, rounded once: the quotient by the
// reciprocal, corrected by its exact remainder (no division subroutine)
__device__ __forceinline__ float2 div_n(float2 s, float n, float inv) {
  float qx = s.x * inv, qy = s.y * inv;
  qx = fmaf(fmaf(-qx, n, s.x), inv, qx);
  qy = fmaf(fmaf(-qy, n, s.y), inv, qy);
  return make_float2(qx, qy);
}

// Ring state of a consumer: the next weight stage's slot and parity.  The
// barriers lead the block's shared memory at `bars`: full i at 8 (2 + i),
// empty i after them; `depth` stages of kStage bytes start at `stages`.
struct Ring {
  int slot;
  uint32_t parity;
};

// One conv's products for NB of a consumer's blocks, block m's rows
// starting at `first` + 128 m (clamped to end at `last_start` + 64):
// `steps` weight stages, each kKps k-steps of a tap, A shifted by (tap -
// half) * dd rows; each stage released once its group is done.  No branch
// around a wgmma, so ptxas keeps one group in flight while the next is
// issued.
template <int C, int NB, int MB>
__device__ __forceinline__ void products(float (&acc)[MB][C / 2], uint32_t a_s, uint32_t plane,
                                         int first, int last_start, int steps, int half, int dd,
                                         bool leader, uint32_t bars, uint32_t stages,
                                         int depth, Ring& ring) {
  using G = Geo<C>;
  uint32_t rows[NB];
#pragma unroll
  for (int m = 0; m < NB; ++m) rows[m] = a_s + min(first + 128 * m, last_start) * 16;
  auto release = [&](int slot) {
    if (leader) mbar_arrive(bars + 8 * (2 + kMaxStages + slot));
  };
  int prev = 0;
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    const int tap = s / (G::kKSteps / G::kKps);
    const int ks0 = (s * G::kKps) % G::kKSteps;
    const int shift = (tap - half) * dd * 16 + 2 * ks0 * plane;
    mbar_wait(bars + 8 * (2 + ring.slot), ring.parity);
    const uint32_t b = stages + ring.slot * G::kStage;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < G::kKps; ++kk)
#pragma unroll
      for (int m = 0; m < NB; ++m)
        wgmma_bf16<C>(acc[m], desc_rows(rows[m] + shift + 2 * kk * plane, plane),
                      desc_kmajor(b + kk * 32 * C));
    wgmma_commit();
    wgmma_wait<1>();
    if (s > 0) release(prev);
    prev = ring.slot;
    if (++ring.slot == depth) { ring.slot = 0; ring.parity ^= 1; }
  }
  wgmma_wait<0>();
  release(prev);
}

// v, opaque to the compiler: a running offset it cannot replace by
// precomputed multiples (which it would keep in registers, or spill)
__device__ __forceinline__ uint32_t opaque(uint32_t v) {
  asm volatile("" : "+r"(v));
  return v;
}

__device__ __forceinline__ float2 unpack2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// (a, b) rounded to bf16 (nearest even), packed
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack_bf16(float2 v) { return pack_bf16(v.x, v.y); }

// a + b of bf16 pairs, rounded once: for bf16 inputs the f32 sum is exact
// wherever its rounding to bf16 could differ, so this is f32 add-and-round
__device__ __forceinline__ uint32_t add_x2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 v = __hadd2_rn(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                      *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// JAX's bf16 leaky-ReLU of a bf16 pair: max(x, x * bf16(0.1)), the product
// exact before its rounding (as x * bf16(0.1) rounded in f32)
__device__ __forceinline__ uint32_t lrelu_x2(uint32_t x) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162 r = __hmax2(v, __hmul2_rn(v, __float2bfloat162_rn(kSlope)));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// One block: output rows [t0, t0 + R) of batch row blockIdx.y.  Section plan
// (C <= 64): every chain of `chains`, out = mean of the chains.  Unit plan
// (C = 128): the one unit of `chains`, h_new to dst (mode kToScratch), or
// into the f32 chains' sum `total` (kOutStore, kOutAdd), or, when `last`,
// (total + h_new) / n_div to dst.  tmap_in loads h [B, T, C] in boxes of 8
// channels x P/2 rows; tmap_out stores 8 channels x R rows of dst.  Buffer
// row b holds position t0 - S + b.
template <int C, int CPU>
__global__ void __launch_bounds__(kThreads, Geo<C>::kPair ? 2 : 1)
mrf_bf16_kernel(const __grid_constant__ CUtensorMap tmap_in,
                const __grid_constant__ CUtensorMap tmap_out, const bf16* __restrict__ wpack,
                const bf16* __restrict__ bias, float* __restrict__ total, const Chains chains,
                int T, int R, int S, int P, int depth, int mode, int last, float n_div,
                float inv_n) {
  using G = Geo<C>;
  constexpr int MB = G::kMB;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_s = smem_u32(smem_raw);
  const uint32_t base = (raw_s + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw_s);
  const uint32_t plane = P * 16;                      // bytes of one channel-group plane
  const uint32_t bars = base;                         // the header: barriers, Chains, biases
  const uint32_t h_s = base + header_bytes<C>();      // H: kHG planes
  const uint32_t a_s = h_s + G::kHG * plane;          // A: kAG planes; the output's staging
  const uint32_t tot_s = a_s + G::kAG * plane;        // section: the chains' f32 sum
  const uint32_t ring = tot_s + (G::kSection ? R * C * 4 : 0);
  const uint32_t x_full = bars, h_free = bars + 8;
  auto full_b = [&](int i) { return bars + 8 * (2 + i); };
  auto empty_b = [&](int i) { return bars + 8 * (2 + kMaxStages + i); };
  Chains& g = *reinterpret_cast<Chains*>(smem + 8 * kBars);
  const bf16* bias_sm = reinterpret_cast<const bf16*>(smem + 8 * kBars + kChainsBytes);
  constexpr uint32_t spitch = kTileRows * 16;         // a staged output plane: [R <= 256][8]

  const int t0 = blockIdx.x * R;
  const int pos0 = t0 - S;                            // the position of buffer row 0
  const int batch = blockIdx.y;

  if (threadIdx.x == 0) {
    g = chains;
    mbar_init(x_full, 1);
    mbar_init(h_free, 1);
    for (int i = 0; i < depth; ++i) {
      mbar_init(full_b(i), 1);
      mbar_init(empty_b(i), kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * kConsumers) {
    // ---- producer: the first warp's lane 0 streams the weight stages, the
    // second warp's loads each chain's input tile into H once the chain
    // before is done with it
    const int p = threadIdx.x - 128 * kConsumers;
    if (p == 0) {
      int n_stages = 0;
      for (int r = 0; r < g.n; ++r) n_stages += CPU * g.k[r] * g.units[r];
      n_stages *= G::kKSteps / G::kKps;
      int slot = 0;
      uint32_t phase = 0;
      for (int s = 0; s < n_stages; ++s) {
        mbar_wait(empty_b(slot), phase ^ 1);
        mbar_expect_tx(full_b(slot), G::kStage);
        bulk_load(ring + slot * G::kStage, wpack + static_cast<size_t>(s) * (G::kStage / 2),
                  G::kStage, full_b(slot));
        if (++slot == depth) { slot = 0; phase ^= 1; }
      }
    } else if (p == 32) {
      for (int r = 0; r < g.n; ++r) {
        if (r > 0) mbar_wait(h_free, (r - 1) & 1);
        mbar_expect_tx(x_full, P * C * 2);
        for (int q = 0; q < G::kHG; ++q)
          for (int part = 0; part < 2; ++part)
            tma_load_3d(h_s + q * plane + part * (P / 2) * 16, &tmap_in, x_full, 8 * q,
                        t0 - S + part * (P / 2), batch);
      }
    }
    return;
  }

  // ---- consumers: consumer w computes blocks w, w + 2, w + 4 of every conv
  const int w = threadIdx.x / 128;
  const int lt = threadIdx.x;                         // 0..255 over both consumers
  const int lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int r0 = 16 * ((threadIdx.x / 32) % 4) + gq;  // this thread's rows r0, r0 + 8 of a block
  const bool leader = threadIdx.x % 128 == 0;
  Ring rs{0, 0};
  {  // the launch's biases, [convs][C], into shared memory
    int n_convs = 0;
    for (int r = 0; r < g.n; ++r) n_convs += CPU * g.units[r];
    const uint4* src = reinterpret_cast<const uint4*>(bias);
    uint4* dst = reinterpret_cast<uint4*>(const_cast<bf16*>(bias_sm));
    for (int u = lt; u < n_convs * C / 8; u += 128 * kConsumers) dst[u] = __ldg(src + u);
  }
  int conv_row = 0;  // the conv's bias row (the unit plan's: ci)
  float acc[MB][C / 2];  // acc[m][4i + 2hr + e]: row r0 + 8hr, channel 8i + 2tq + e

#pragma unroll 1
  for (int r = 0; r < g.n; ++r) {
    // the chain's input: A = lrelu(H), the padded channels (C=8) zero
    mbar_wait(x_full, r & 1);
    {
      const uint4* h4 = reinterpret_cast<const uint4*>(smem + header_bytes<C>());
      uint4* a4 = reinterpret_cast<uint4*>(smem + (a_s - base));
#pragma unroll 4
      for (int u = lt; u < G::kAG * P; u += 128 * kConsumers) {
        uint4 v = make_uint4(0, 0, 0, 0);
        if (u < G::kHG * P) {
          v = h4[u];
          v = make_uint4(lrelu_x2(v.x), lrelu_x2(v.y), lrelu_x2(v.z), lrelu_x2(v.w));
        }
        a4[u] = v;
      }
    }
    fence_proxy_async();
    named_sync_consumers();

    const int k = g.k[r], half = (k - 1) / 2;
    int rem = g.halo[r];  // rows still needed beyond the output after this conv
#pragma unroll 1
    for (int u = 0; u < g.units[r]; ++u) {
#pragma unroll 1
      for (int ci = 0; ci < CPU; ++ci, ++conv_row) {
        const int dd = ci == 0 ? g.d[r][u] : 1;
        rem -= half * dd;
        const int lo = S - rem, hi = S + R + rem;  // the buffer rows this conv computes
        // 64-row blocks, the last one ending on hi; consumer w's are blocks
        // w, w + 2, ... (the unit plan's convs have four, two each)
        const int mine = G::kSection ? ((hi - lo + 63) / 64 - w + 1) / 2 : MB;
#pragma unroll
        for (int i = 0; i < C / 8; ++i) {
          const float2 bv = load2(bias_sm + (G::kSection ? conv_row : ci) * C + 8 * i + 2 * tq);
#pragma unroll
          for (int m = 0; m < MB; ++m) {
            acc[m][4 * i] = bv.x; acc[m][4 * i + 1] = bv.y;
            acc[m][4 * i + 2] = bv.x; acc[m][4 * i + 3] = bv.y;
          }
        }
#pragma unroll
        for (int m = 0; m < MB; ++m) fence_acc(acc[m]);
        const int steps = k * (G::kKSteps / G::kKps);
        const int first = lo + 64 * w;
        if (!G::kSection || mine >= MB)
          products<C, MB>(acc, a_s, plane, first, hi - 64, steps, half, dd, leader, bars, ring, depth, rs);
        else if (MB > 2 && mine == 2)
          products<C, (MB > 2 ? 2 : 1)>(acc, a_s, plane, first, hi - 64, steps, half, dd, leader,
                                        bars, ring, depth, rs);
        else
          products<C, 1>(acc, a_s, plane, first, hi - 64, steps, half, dd, leader, bars, ring, depth, rs);
#pragma unroll
        for (int m = 0; m < MB; ++m) fence_acc(acc[m]);
        named_sync_consumers();  // both consumers are done reading A

        const bool residual = ci == CPU - 1;
        const bool chain_last = residual && u == g.units[r] - 1;
        const bool section_out = G::kSection && chain_last && r == g.n - 1;
        const bool unit_out = !G::kSection && chain_last;
        // each epilogue kind is its own loop over the fragment, so a thread
        // runs short straight-line code: the conv's output y, rounded to
        // bf16 and zero outside [0, T), packed as bf16x2
        auto y_of = [&](int m, int i, int hr, int row) {
          const int pos = pos0 + row;
          return pos >= 0 && pos < T ? pack_bf16(acc[m][4 * i + 2 * hr], acc[m][4 * i + 2 * hr + 1])
                                     : 0u;
        };
        if (!residual) {  // the first conv's output -> the second conv's operand
#pragma unroll
          for (int m = 0; m < MB; ++m) {
            if (m >= mine) continue;
            // rows before own0 are the block before's (the unit plan's first
            // conv has four whole blocks)
            const int own0 = lo + 64 * (w + 2 * m);
            const int start = G::kSection ? min(own0, hi - 64) : own0;
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const int row = start + r0 + 8 * hr;
              if (G::kSection && row < own0) continue;
              uint32_t off = (a_s - base) + row * 16 + tq * 4;
#pragma unroll
              for (int i = 0; i < C / 8; ++i, off = opaque(off + plane))
                *reinterpret_cast<uint32_t*>(smem + off) = lrelu_x2(y_of(m, i, hr, row));
            }
          }
        } else if (!chain_last) {  // h + y: the next unit's input and operand (section plan)
#pragma unroll
          for (int m = 0; m < (G::kSection ? MB : 0); ++m) {
            if (m >= mine) continue;
            const int own0 = lo + 64 * (w + 2 * m);
            const int start = min(own0, hi - 64);
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const int row = start + r0 + 8 * hr;
              uint32_t hv[C / 8];  // every load before any store (the compiler cannot tell
              uint32_t off = (h_s - base) + row * 16 + tq * 4;  // that they do not alias)
#pragma unroll
              for (int i = 0; i < C / 8; ++i, off = opaque(off + plane))
                hv[i] = *reinterpret_cast<const uint32_t*>(smem + off);
              if (row < own0) continue;
              off = (h_s - base) + row * 16 + tq * 4;
#pragma unroll
              for (int i = 0; i < C / 8; ++i, off = opaque(off + plane)) {
                const uint32_t hn = add_x2(hv[i], y_of(m, i, hr, row));
                *reinterpret_cast<uint32_t*>(smem + off) = hn;
                *reinterpret_cast<uint32_t*>(smem + (a_s - h_s) + off) = lrelu_x2(hn);
              }
            }
          }
        } else if constexpr (G::kSection) {
          // the chain's output into the chains' f32 sum, in each thread's
          // fragment order (the last conv's blocks are the R output rows,
          // no overlap); the last chain stages the mean for the output
#pragma unroll
          for (int m = 0; m < MB; ++m) {
            if (m >= mine) continue;
            const int start = lo + 64 * (w + 2 * m);
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const int row = start + r0 + 8 * hr;
              float2* tot = reinterpret_cast<float2*>(smem + (tot_s - base)) +
                            ((m * kConsumers + w) * (C / 8) * 2 + hr) * 128 + threadIdx.x % 128;
              uint32_t* staged = reinterpret_cast<uint32_t*>(
                  smem + (a_s - base) + (row - S) * 16 + tq * 4);
              uint32_t hv[C / 8];
              float2 tv[C / 8];
              uint32_t off = (h_s - base) + row * 16 + tq * 4;
#pragma unroll
              for (int i = 0; i < C / 8; ++i, off = opaque(off + plane)) {
                hv[i] = *reinterpret_cast<const uint32_t*>(smem + off);
                tv[i] = r > 0 ? tot[i * 2 * 128] : make_float2(0.0f, 0.0f);
              }
#pragma unroll
              for (int i = 0; i < C / 8; ++i) {
                const float2 hn = unpack2(add_x2(hv[i], y_of(m, i, hr, row)));
                const float2 s2 = r > 0 ? f2add(tv[i], hn) : hn;
                if (section_out)
                  staged[i * spitch / 4] = pack_bf16(div_n(s2, n_div, inv_n));
                else
                  tot[i * 2 * 128] = s2;
              }
            }
          }
        } else {
          // unit plan: h_new to dst (staged), or into the f32 chains' sum
          // in HBM, 16 bytes a thread: a lane exchange gives even lanes row
          // r0, channels 8i + 2tq .. + 3, and odd lanes row r0 + 8, channels
          // 8i + 2tq - 2 .. + 1
          const bool odd = tq & 1;
#pragma unroll
          for (int m = 0; m < MB; ++m) {
            if (m >= mine) continue;
            const int own0 = lo + 64 * (w + 2 * m);
            const int start = min(own0, hi - 64);
            uint32_t off = (h_s - base) + (start + r0) * 16 + tq * 4;  // channel group i, row r0
            const int row = start + r0 + (odd ? 8 : 0);  // the row of this lane's f32 sums
            const bool keep = row >= own0 && pos0 + row < T;
            float4* tp = reinterpret_cast<float4*>(
                total + (static_cast<size_t>(batch) * T + pos0 + row) * C + 2 * (tq & ~1));
#pragma unroll
            for (int i = 0; i < C / 8; ++i, off = opaque(off + plane)) {
              uint32_t hn[2];
#pragma unroll
              for (int hr = 0; hr < 2; ++hr) {
                const int row = start + r0 + 8 * hr;
                hn[hr] = add_x2(*reinterpret_cast<const uint32_t*>(smem + off + 128 * hr),
                                y_of(m, i, hr, row));
                if (mode == kToScratch && row >= own0)
                  *reinterpret_cast<uint32_t*>(smem + (a_s - base) + i * spitch + (row - S) * 16 +
                                               tq * 4) = hn[hr];
              }
              if (mode == kToScratch) continue;
              const uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? hn[0] : hn[1], 1);
              const float2 lo2 = unpack2(odd ? got : hn[0]), hi2 = unpack2(odd ? hn[1] : got);
              if (!keep) continue;
              float4 s4 = make_float4(lo2.x, lo2.y, hi2.x, hi2.y);
              if (mode == kOutAdd) {
                const float4 o = __ldg(tp + 2 * i);  // read once, before this thread's store
                s4 = make_float4(o.x + s4.x, o.y + s4.y, o.z + s4.z, o.w + s4.w);
              }
              if (!last) {
                tp[2 * i] = s4;
              } else {
                uint32_t* so = reinterpret_cast<uint32_t*>(
                    smem + (a_s - base) + i * spitch + (row - S) * 16 + (tq & ~1) * 4);
                so[0] = pack_bf16(div_n(make_float2(s4.x, s4.y), n_div, inv_n));
                so[1] = pack_bf16(div_n(make_float2(s4.z, s4.w), n_div, inv_n));
              }
            }
          }
        }
        fence_proxy_async();
        named_sync_consumers();
        if ((section_out || (unit_out && (mode == kToScratch || last))) && lt == 0) {
          // the staged output, R rows of every channel group (rows past T dropped)
          for (int q = 0; q < G::kHG; ++q)
            tma_store_3d(&tmap_out, a_s + q * spitch, 8 * q, t0, batch);
          tma_store_wait();
        }
      }
    }
    if (r + 1 < g.n && lt == 0) mbar_arrive(h_free);  // H may take the next chain's input
  }
}

// ---- host side

// [B, T, C] bf16 -> a map whose box is 8 channels x `rows` steps of one batch
// row (rows x 16 bytes in shared memory), zero outside the tensor
bool encode_map(CUtensorMap* map, const void* base, int C, int T, int B, int rows) {
  auto encode = tensor_map_encoder();
  if (!encode) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)C * 2, (cuuint64_t)C * 2 * T};
  const cuuint32_t box[3] = {8, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A launch's tile: R output rows, S halo rows on each side, P buffer rows.
struct Tile {
  int R, S, P;
};

// section plan: the most 64-row multiples, at most 256, for which R + 2 S
// fits both consumers' 64-row blocks (R = 256 at C <= 64 where S <= 64);
// unit plan: 256 first-conv rows
template <int C>
Tile tile_of(int cpu, const Chains& g) {
  int S = 0;
  for (int r = 0; r < g.n; ++r) S = g.halo[r] > S ? g.halo[r] : S;
  int R;
  if (Geo<C>::kSection) {
    R = (kConsumers * Geo<C>::kMB * 64 - 2 * S) / 64 * 64;
    R = R > kTileRows ? kTileRows : R;
  } else {
    R = cpu == 2 ? kTileRows - (g.k[0] - 1) : kTileRows;
  }
  return {R, S, pad16(R + 2 * S)};
}

template <int C>
bool fits(const Tile& t) {
  return t.R >= 64 && t.P / 2 <= kMaxBox && t.R <= kMaxBox && ring_stages<C>(t.R, t.P) >= 2;
}

struct Args {
  const void* h_in;
  const void* wpack;
  const void* bias;
  void* dst;
  float* total;
  int B, T, mode, last;
  float n_div;
  Chains g;
  cudaStream_t stream;
};

template <int C, int CPU>
int launch(const Args& a) {
  const Tile t = tile_of<C>(CPU, a.g);
  if (!fits<C>(t)) return (int)cudaErrorInvalidValue;
  const int depth = ring_stages<C>(t.R, t.P);
  const size_t smem = smem_bytes<C>(t.R, t.P);
  CUtensorMap in_map, out_map;
  if (!encode_map(&in_map, a.h_in, C, a.T, a.B, t.P / 2) ||
      !encode_map(&out_map, a.dst, C, a.T, a.B, t.R))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(mrf_bf16_kernel<C, CPU>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.T + t.R - 1) / t.R, a.B);
  mrf_bf16_kernel<C, CPU><<<grid, kThreads, smem, a.stream>>>(
      in_map, out_map, static_cast<const bf16*>(a.wpack), static_cast<const bf16*>(a.bias),
      a.total, a.g, a.T, t.R, t.S, t.P, depth, a.mode, a.last, a.n_div, 1.0f / a.n_div);
  return (int)cudaGetLastError();
}

template <int CPU>
int dispatch_c(int C, const Args& a) {
  switch (C) {
    case 8: return launch<8, CPU>(a);
    case 16: return launch<16, CPU>(a);
    case 32: return launch<32, CPU>(a);
    case 64: return launch<64, CPU>(a);
    case 128: return launch<128, CPU>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// chains from (k, units, dilations [n][kMaxUnits]), each chain's halo
bool make_chains(Chains* g, int n, const int* ks, const int* units, const int* dils, int cpu) {
  if (n < 1 || n > kMaxChains) return false;
  g->n = n;
  for (int r = 0; r < n; ++r) {
    if (ks[r] < 1 || ks[r] % 2 == 0 || units[r] < 1 || units[r] > kMaxUnits) return false;
    g->k[r] = ks[r];
    g->units[r] = units[r];
    const int half = (ks[r] - 1) / 2;
    g->halo[r] = 0;
    for (int u = 0; u < units[r]; ++u) {
      const int d = dils[r * kMaxUnits + u];
      if (d < 1) return false;
      g->d[r][u] = d;
      g->halo[r] += half * d + (cpu == 2 ? half : 0);
    }
  }
  return true;
}

int run(const Args& a, int C, int cpu) {
  if (a.B < 1 || a.B > 65535 || a.T < 1 || !(a.n_div > 0.0f)) return (int)cudaErrorInvalidValue;
  if (cpu == 2) return dispatch_c<2>(C, a);
  if (cpu == 1) return dispatch_c<1>(C, a);
  return (int)cudaErrorInvalidValue;
}

template <int C>
void geometry_of(const Chains& g, int cpu, long long* out) {
  const Tile t = tile_of<C>(cpu, g);
  out[0] = t.R;
  out[1] = t.S;
  out[2] = t.P;
  out[3] = ring_stages<C>(t.R, t.P);
  out[4] = (long long)smem_bytes<C>(t.R, t.P);
  out[5] = fits<C>(t);
}

}  // namespace

extern "C" {

// The launch's tile and shared memory for (C, convs_per_unit) and the
// chains (k, units, dilations as [n][4]; C = 128: the one unit): out = R,
// S, P, ring depth, dynamic shared memory, whether the kernel takes it.
// Returns 0, or an error code for an unsupported C or chain list.
int mrf_bf16_geometry(int C, int convs_per_unit, int n, const int* ks, const int* units,
                      const int* dils, long long* out) {
  Chains g;
  if (!make_chains(&g, n, ks, units, dils, convs_per_unit)) return (int)cudaErrorInvalidValue;
  switch (C) {
    case 8: geometry_of<8>(g, convs_per_unit, out); return 0;
    case 16: geometry_of<16>(g, convs_per_unit, out); return 0;
    case 32: geometry_of<32>(g, convs_per_unit, out); return 0;
    case 64: geometry_of<64>(g, convs_per_unit, out); return 0;
    case 128: geometry_of<128>(g, convs_per_unit, out); return 0;
    default: return (int)cudaErrorInvalidValue;
  }
}

// The whole section, C <= 64: x, out [B, T, C] bf16; wpack: the section's
// bf16 weight stages (ops/mrf_block.py::pack_stages); bias [convs, C]; the
// chains as in mrf_bf16_geometry.  out must not alias x.  Returns the CUDA
// error code of the launch (0 on success).
int mrf_section_bf16(const void* x, const void* wpack, const void* bias, void* out, int B, int T,
                     int C, int convs_per_unit, int n, const int* ks, const int* units,
                     const int* dils, void* stream) {
  Args a{x, wpack, bias, out, nullptr, B, T, kToScratch, 0, (float)n, {}, static_cast<cudaStream_t>(stream)};
  if (C > kSectionC || !make_chains(&a.g, n, ks, units, dils, convs_per_unit))
    return (int)cudaErrorInvalidValue;
  return run(a, C, convs_per_unit);
}

// One resblock unit (k, d), C = 128: h_in, dst [B, T, C] bf16; wpack: the
// unit's weight stages; bias [convs, C]; total [B, T, C] f32, the chains'
// sum.  mode 0 writes h_new to dst; mode 1 stores h_new and mode 2 adds it
// into total, or, when `last`, writes (h_new or total + h_new) / n_chains to
// dst, rounded once.  dst must not alias h_in.  Returns the CUDA error code
// of the launch (0 on success).
int mrf_unit_bf16(const void* h_in, const void* wpack, const void* bias, void* dst, float* total,
                  int B, int T, int C, int convs_per_unit, int k, int d, int mode, int last,
                  int n_chains, void* stream) {
  Args a{h_in, wpack, bias, dst, total, B, T, mode, last, (float)n_chains, {},
         static_cast<cudaStream_t>(stream)};
  const int units = 1;
  const int dils[kMaxUnits] = {d};
  if (C <= kSectionC || mode < kToScratch || mode > kOutAdd || n_chains < 1 ||
      (mode != kToScratch && !total && !(mode == kOutStore && last)) ||
      !make_chains(&a.g, 1, &k, &units, dils, convs_per_unit))
    return (int)cudaErrorInvalidValue;
  return run(a, C, convs_per_unit);
}

const char* mrf_bf16_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
