// Fused WaveGlow WN layer in f32 for Hopper (sm_90a): wgmma, TMA, mbarriers,
// clusters.
//
// Replaces, in f32, both TPU kernels of larynx_tpu/ops/wn_layer.py:
//   K3  fused_wn_layer_state  (_kernel_state, pallas_call at :258)
//   K4  fused_wn_layer        (_kernel,       pallas_call at :332)
// (csrc/wn_bf16.cu is the bf16 kernel.)  One kernel, templated on the mode:
// the layer alone (K4, writes rs), or the layer with its state update on
// the first, a middle or the last layer of a WN stack (K3).
//
// What it computes, for h [B, T, 256], cond [B, T, CC] (channels-last,
// contiguous), ch = 256:
//   a  = h[t-d] @ W0 + h[t] @ W1 + h[t+d] @ W2 + cond[t] @ Wc + bias_a
//        (h zero outside [0, T); bias_a = b_in + b_cond)        [2ch]
//   g  = tanh(a[:ch]) * sigmoid(a[ch:])                          [ch]
//   rs = g @ Wrs + b_rs                                          [RS]
//   K4:    out = rs
//   K3:    h_out = h + rs[:ch], skip_out = skip + rs[ch:]  (middle)
//          h_out = h + rs[:ch], skip_out = rs[ch:]         (first)
//          skip_out = skip + rs, h untouched (RS = ch)     (last)
//          skip_out = rs, h untouched                      (first and last)
// h_out must not alias h: neighbouring tiles read h's halo.
//
// What bounds it: operations.  A time step costs 2 * (2ch * (3ch + CC) +
// ch * RS) = 1.70 MFLOP at ch=256, CC=640, RS=512 against ~(3 * 256 + 640)
// * 4 bytes of activation I/O (~300 FLOP/byte), and the weights (3.4 MB)
// are shared by every time step.  Each product runs as three TF32
// tensor-core products (3xTF32: a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, f32
// accumulate), so the bound is 3 TF32 operations per FLOP at the dense TF32
// peak.  The design keeps the tensor cores fed from shared memory:
//
//   * one block per 64-step time tile of one batch row (wgmma M = 64): a
//     producer warpgroup and two consumer warpgroups; setmaxnreg moves the
//     producer's registers to the consumers.  Consumer c owns channels
//     [128c, 128c + 128): the first product's tanh and sigmoid columns of
//     those channels (N = 256, wgmma m64n256k8 TF32, 128 f32 accumulators a
//     thread), so the gate is formed in registers.
//   * every wgmma reads both operands from shared memory as exact TF32
//     values (hardware TF32 drops the low 13 bits, so hi is rounded to
//     nearest and lo is the rounded remainder).
//   * A (activations): one producer thread brings each K chunk of 128 bytes
//     a row (32 columns) by TMA, a box of 64 rows of h at
//     offset -d, 0 or +d (or of cond) from a 3-D tensor map [B, T, C],
//     128-byte swizzled, into a 4-deep ring.  A box row outside [0, T) is
//     zero-filled by the hardware, which is exactly the conv's zero
//     padding, for any dilation (no halo is held), and never reads the
//     neighbouring batch row.  Two producer warps split each chunk in place
//     into its TF32 hi plane and a lo plane beside it; the swizzled layout
//     is already the canonical K-major wgmma layout, and a k-step is 32
//     bytes of it.
//   * B (weights) is packed once at load (ops/wn_layer.py::pack_weights),
//     K-major in the wgmma core-matrix order, one stage per k-step of the
//     first product: exact TF32 hi and lo planes (32 KB), so each stage is
//     one bulk TMA copy into a 4-deep mbarrier ring.  Blocks run as clusters of 2 neighbouring time tiles; each
//     block copies half of every stage and multicasts it to both, so every
//     weight byte leaves L2 once per pair of tiles.  A block whose tile
//     lies past T (odd tile counts) runs the same protocol on zero-filled
//     rows and stores nothing.
//   * the second product, g @ Wrs, streams through the same weight ring and
//     accumulates in the first product's registers; its A operand, the
//     gated tile, goes through the idle A region one channel half at a time
//     as TF32 planes (consumer 1 parks its half meanwhile).  Its
//     accumulators feed the state update straight from registers.
//   * one accumulator set, no register-held A fragments and no calls keep
//     the consumers within their registers, so ptxas keeps the wgmma
//     pipeline asynchronous: two groups of products in flight per
//     warpgroup, the stages released as they drain.

#include "sm90.cuh"

namespace {

constexpr int kCh = 256;                      // WN channels
constexpr int kTile = 64;                     // time steps per block (wgmma M)
constexpr int kConsumers = 2;                 // consumer warpgroups
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kCluster = 2;                   // blocks sharing each weight stage
constexpr int kAStages = 4;
constexpr int kSplitWarps = 2;                // producer warps that split A chunks into TF32 planes
constexpr int kAChunkBytes = kTile * 128;     // one A chunk: 64 rows of one 128-byte swizzle row
constexpr int kBStages = 4;
constexpr int kNW1 = 2 * kCh / kConsumers;    // first-product columns per consumer (256)

enum Mode { kRs = 0, kMid = 1, kFirst = 2, kLast = 3, kFirstLast = 4 };

// the layout
struct Geom {
  static constexpr int kPlanes = 2;   // TF32 hi and lo
  static constexpr int kKStep = 8;    // K per wgmma k-step
  static constexpr int kKC = 32;      // K columns per A chunk
  static constexpr int kARegion = kPlanes * kAStages * kAChunkBytes;  // A rings, later the gated tile
  static constexpr int kBStageBytes = kConsumers * kPlanes * kNW1 * 32;  // one first-product k-step
  // product 2 passes over the A region, which holds one channel half of the
  // gated tile (hi and lo)
  static constexpr int kPasses = kCh * 4 * kTile * kPlanes / kARegion;
  static constexpr int kStashBytes = kTile * kCh / kConsumers * 4;
  static constexpr size_t kSmemBytes = 1024 + kARegion + kStashBytes + kBStages * kBStageBytes +
                                       (3 * kAStages + 2 * kBStages) * 8;
  static_assert(kSmemBytes <= 232448, "over the shared memory a block can have");
  static_assert(kKC / kKStep == 4, "an A chunk is four k-steps");
  static_assert(kCh / kPasses / kKStep == 16, "a product-2 pass is sixteen k-steps");
};
static_assert(Geom::kPasses == 2, "passes");
static_assert(2 * Geom::kStashBytes <= Geom::kARegion,
              "a half of the gated tile, hi and lo, must fit over the A rings");
static_assert(Geom::kBStageBytes == 32768 && Geom::kSmemBytes == 230560, "f32 plan");

// ---- wrappers only this kernel uses (the rest: sm90.cuh)

// bulk TMA copy of `bytes` contiguous bytes -> dst in every block of the
// cluster, completing on the barrier at the same offset in each
__device__ __forceinline__ void bulk_load_multicast(uint32_t dst, const void* src, uint32_t bytes,
                                                    uint32_t bar) {
  const uint16_t mask = (1u << kCluster) - 1;
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
      " [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(mask)
      : "memory");
}

__device__ __forceinline__ void named_sync_consumers() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kConsumers) : "memory");
}

// wgmma descriptor of an A operand in the canonical K-major 128-byte
// swizzled layout (what TMA writes for a box 128 bytes wide): 8-row groups
// 1024 bytes apart; a k-step of 32 bytes starts 32 bytes further in the
// same swizzle atom
__device__ __forceinline__ uint64_t desc_a_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// acc += a * b for one k-step, as (a_hi + a_lo) * (b_hi + b_lo) less the
// a_lo * b_lo term
template <int N>
__device__ __forceinline__ void mma_step(float (&d)[N / 2], uint32_t a_hi, uint32_t a_lo,
                                         uint32_t b_hi, uint32_t b_lo) {
  wgmma_tf32<N>(d, desc_a_sw128(a_lo), desc_kmajor(b_hi));
  wgmma_tf32<N>(d, desc_a_sw128(a_hi), desc_kmajor(b_lo));
  wgmma_tf32<N>(d, desc_a_sw128(a_hi), desc_kmajor(b_hi));
}

// byte offset of channel pc (of the A region's channels) in row `row` of
// the A chunks' swizzled layout
__device__ __forceinline__ int swizzled(int pc, int row) {
  const int in_row = (pc % Geom::kKC) * 4;
  return (pc / Geom::kKC) * kAChunkBytes + row * 128 + (((in_row / 16) ^ (row % 8)) * 16) +
         in_row % 16;
}

// no division subroutine (a call would serialize the wgmma pipeline); a few
// ulp, far below the 3xTF32 products' error
__device__ __forceinline__ float sigmoid(float x) { return __fdividef(1.0f, 1.0f + __expf(-x)); }

template <int MODE, int RS>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
wn_layer_kernel(const __grid_constant__ CUtensorMap tmap_h,
                const __grid_constant__ CUtensorMap tmap_cond, const float* __restrict__ h,
                const float* __restrict__ skip, const float* __restrict__ wpack,
                const float* __restrict__ bias_a, const float* __restrict__ b_rs,
                float* __restrict__ h_out, float* __restrict__ skip_out,
                float* __restrict__ rs_out, int T, int CC, int dil) {
  using G = Geom;
  constexpr int kPlanes = G::kPlanes;
  constexpr int kKC = G::kKC;
  constexpr int kBStageBytes = G::kBStageBytes;
  constexpr int kNW2 = RS / kConsumers;                       // second-product columns per consumer
  constexpr int kKps2 = kBStageBytes / (kConsumers * kPlanes * kNW2 * 32);  // its k-steps per stage
  constexpr bool kFirstMode = MODE == kFirst || MODE == kFirstLast;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // 128-byte swizzle atoms want 1 KB alignment
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t a_hi = base;                             // kAStages chunks: raw, then hi
  const uint32_t a_lo = base + kAStages * kAChunkBytes;   // kAStages chunks of lo
  const uint32_t b_ring = base + G::kARegion + G::kStashBytes;
  const uint32_t bars = b_ring + kBStages * kBStageBytes;
  auto full_b = [&](int i) { return bars + 8 * i; };
  auto empty_b = [&](int i) { return bars + 8 * (kBStages + i); };
  auto full_a = [&](int i) { return bars + 8 * (2 * kBStages + i); };
  auto ready_a = [&](int i) { return bars + 8 * (2 * kBStages + kAStages + i); };
  auto empty_a = [&](int i) { return bars + 8 * (2 * kBStages + 2 * kAStages + i); };

  const int n_chunks = (3 * kCh + CC) / kKC;
  const int steps1 = n_chunks * (kKC / G::kKStep);    // k-steps (and weight stages) of product 1
  const int n_stages = steps1 + kCh / G::kKStep / kKps2;
  const int t0 = blockIdx.x * kTile;
  const int batch = blockIdx.y;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kBStages; ++i) {
      mbar_init(full_b(i), 1);
      mbar_init(empty_b(i), kConsumers * kCluster);
    }
    for (int i = 0; i < kAStages; ++i) {
      mbar_init(full_a(i), 1);
      mbar_init(ready_a(i), kSplitWarps);
      mbar_init(empty_a(i), kConsumers);
    }
    mbar_init_fence();
  }
  cluster_sync();  // every barrier of the cluster exists before any copy or remote arrive

  if (wg == 0) {
    // ---- producer warpgroup: warp 0 streams the weights, warp 1 the
    // activations, warps 2-3 split each activation chunk into TF32 planes
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int warp = threadIdx.x / 32;
    if (threadIdx.x == 0) {  // the weight stages, multicast over the cluster
      const uint32_t rank = cluster_rank();
      constexpr int kPart = kBStageBytes / kCluster;
      const char* src = reinterpret_cast<const char*>(wpack) + rank * kPart;
      int b_stage = 0;
      uint32_t b_phase = 0;
      for (int s = 0; s < n_stages; ++s) {
        mbar_wait(empty_b(b_stage), b_phase ^ 1);
        mbar_expect_tx(full_b(b_stage), kBStageBytes);
        bulk_load_multicast(b_ring + b_stage * kBStageBytes + rank * kPart,
                            src + static_cast<size_t>(s) * kBStageBytes, kPart, full_b(b_stage));
        if (++b_stage == kBStages) { b_stage = 0; b_phase ^= 1; }
      }
      // stay until every consumer of the cluster has released every stage:
      // no block leaves while a peer may still multicast into it or arrive
      // on its barriers
      for (int i = 0; i < kBStages; ++i) {
        mbar_wait(empty_b(b_stage), b_phase ^ 1);
        if (++b_stage == kBStages) { b_stage = 0; b_phase ^= 1; }
      }
    } else if (threadIdx.x == 32) {  // the A chunks: k columns [kKC c, kKC (c + 1))
      int a_stage = 0;
      uint32_t a_phase = 0;
      for (int chunk = 0; chunk < n_chunks; ++chunk) {
        const int k0 = kKC * chunk;
        mbar_wait(empty_a(a_stage), a_phase ^ 1);
        mbar_expect_tx(full_a(a_stage), kAChunkBytes);
        const uint32_t dst = a_hi + a_stage * kAChunkBytes;
        if (k0 < 3 * kCh) {
          tma_load_3d(dst, &tmap_h, full_a(a_stage), k0 % kCh, t0 + (k0 / kCh - 1) * dil, batch);
        } else {
          tma_load_3d(dst, &tmap_cond, full_a(a_stage), k0 - 3 * kCh, t0, batch);
        }
        if (++a_stage == kAStages) { a_stage = 0; a_phase ^= 1; }
      }
    } else if (warp >= 4 - kSplitWarps) {
      // each chunk, in place: raw -> TF32 hi, and its lo into the lo ring
      // at the same offset (the layout is elementwise, swizzle and all)
      const int lane = threadIdx.x - 32 * (4 - kSplitWarps);
      int a_stage = 0;
      uint32_t a_phase = 0;
      for (int chunk = 0; chunk < n_chunks; ++chunk) {
        mbar_wait(full_a(a_stage), a_phase);
        float4* hi = reinterpret_cast<float4*>(smem + a_stage * kAChunkBytes);
        float4* lo = reinterpret_cast<float4*>(smem + kAStages * kAChunkBytes + a_stage * kAChunkBytes);
#pragma unroll 2
        for (int u = lane; u < kAChunkBytes / 16; u += 32 * kSplitWarps) {
          const float4 x = hi[u];
          const float4 xh = make_float4(to_tf32(x.x), to_tf32(x.y), to_tf32(x.z), to_tf32(x.w));
          hi[u] = xh;
          lo[u] = make_float4(to_tf32(x.x - xh.x), to_tf32(x.y - xh.y), to_tf32(x.z - xh.z),
                              to_tf32(x.w - xh.w));
        }
        fence_proxy_async();
        __syncwarp();
        if (threadIdx.x % 32 == 0) mbar_arrive(ready_a(a_stage));
        if (++a_stage == kAStages) { a_stage = 0; a_phase ^= 1; }
      }
    }
  } else {
    // ---- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = 16 * ((threadIdx.x / 32) % 4) + g;  // this thread's rows r0 and r0 + 8
    const bool leader = threadIdx.x % 128 == 0;
    int a_stage = 0, b_stage = 0;
    uint32_t a_phase = 0, b_phase = 0;
    auto release_b = [&](int stage) {
      if (leader) {
#pragma unroll
        for (int r = 0; r < kCluster; ++r) mbar_arrive_cluster(empty_b(stage), r);
      }
    };
    auto prev = [](int stage, int n) { return stage == 0 ? n - 1 : stage - 1; };

    // ---- first product: a = [h taps | cond] @ [W0; W1; W2; Wc] + bias_a.
    // Accumulator chunk i < 16 holds tanh columns 128c + 8i + ..., chunk
    // i + 16 their sigmoid partners, at the same fragment positions.
    float acc[kNW1 / 2];
#pragma unroll
    for (int i = 0; i < kNW1 / 8; ++i) {
      const int col = (i < 16 ? 0 : kCh - 128) + 128 * c + 8 * i + 2 * t;
      const float2 bv = ldg2(bias_a + col);
      acc[4 * i] = bv.x; acc[4 * i + 1] = bv.y; acc[4 * i + 2] = bv.x; acc[4 * i + 3] = bv.y;
    }
    fence_acc(acc);
    // Up to two wgmma groups in flight per warpgroup; a weight stage is
    // released once the group after it has been issued and it is done, an
    // A chunk once its last group is done.
    for (int chunk = 0; chunk < n_chunks; ++chunk) {
      // the split warps' planes
      mbar_wait(ready_a(a_stage), a_phase);
#pragma unroll
      for (int kk = 0; kk < kKC / G::kKStep; ++kk) {
        mbar_wait(full_b(b_stage), b_phase);
        const uint32_t blk = b_ring + b_stage * kBStageBytes + c * kPlanes * (kNW1 * 32);
        const uint32_t aoff = a_stage * kAChunkBytes + 32 * kk;
        wgmma_fence();
        mma_step<kNW1>(acc, a_hi + aoff, a_lo + aoff, blk, blk + kNW1 * 32);
        wgmma_commit();
        wgmma_wait<1>();
        if (chunk > 0 || kk > 0) release_b(prev(b_stage, kBStages));
        if (kk == 0 && chunk > 0 && leader) mbar_arrive(empty_a(prev(a_stage, kAStages)));
        if (++b_stage == kBStages) { b_stage = 0; b_phase ^= 1; }
      }
      if (++a_stage == kAStages) { a_stage = 0; a_phase ^= 1; }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    release_b(prev(b_stage, kBStages));
    if (leader) mbar_arrive(empty_a(prev(a_stage, kAStages)));

    // ---- gate, in registers: gv[4i + 2hr + e] is channel 128c + 8i + 2t + e
    // of row r0 + 8hr
    float gv[64];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        gv[4 * i + e] = tanhf(acc[4 * i + e]) * sigmoid(acc[4 * (i + 16) + e]);
    }

    // ---- second product: rs = g @ Wrs + b_rs, consumer c owning rs
    // columns [c * kNW2, (c + 1) * kNW2), accumulated in the registers of
    // the first product's accumulators.  Its A operand, the gated tile,
    // goes through the A region (idle by now) in the A chunks' swizzled
    // layout, one channel half at a time as TF32 hi and lo planes (4 chunks
    // of 32 channels; consumer 1 parks its half, raw, in the stash
    // meanwhile).
    named_sync_consumers();  // the A region is no longer read
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int cl = 8 * i + 2 * t;  // channel within the half
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = r0 + 8 * hr;
        const float x0 = gv[4 * i + 2 * hr], x1 = gv[4 * i + 2 * hr + 1];
        const int off = swizzled(cl, row);
        if (c == 0) {
          const float h0 = to_tf32(x0), h1 = to_tf32(x1);
          *reinterpret_cast<float2*>(smem + off) = make_float2(h0, h1);
          *reinterpret_cast<float2*>(smem + kAStages * kAChunkBytes + off) =
              make_float2(to_tf32(x0 - h0), to_tf32(x1 - h1));
        } else {
          *reinterpret_cast<float2*>(smem + G::kARegion + off) = make_float2(x0, x1);
        }
      }
    }
    fence_proxy_async();
    named_sync_consumers();
    float (&acc2)[kNW2 / 2] = *reinterpret_cast<float (*)[kNW2 / 2]>(&acc[0]);
#pragma unroll
    for (int i = 0; i < kNW2 / 8; ++i) {
      const float2 bv = ldg2(b_rs + c * kNW2 + 8 * i + 2 * t);
      acc2[4 * i] = bv.x; acc2[4 * i + 1] = bv.y; acc2[4 * i + 2] = bv.x; acc2[4 * i + 3] = bv.y;
    }
    fence_acc(acc2);
    int ks = 0;
#pragma unroll 1
    for (int pass = 0; pass < G::kPasses; ++pass) {
      if (pass > 0) {
        named_sync_consumers();  // both are done with the previous half
        if (c == pass) {
          const float4* src = reinterpret_cast<const float4*>(smem + G::kARegion);
          float4* hi = reinterpret_cast<float4*>(smem);
          float4* lo = reinterpret_cast<float4*>(smem + kAStages * kAChunkBytes);
#pragma unroll 4
          for (int u = threadIdx.x % 128; u < G::kStashBytes / 16; u += 128) {
            const float4 x = src[u];
            const float4 xh = make_float4(to_tf32(x.x), to_tf32(x.y), to_tf32(x.z), to_tf32(x.w));
            hi[u] = xh;
            lo[u] = make_float4(to_tf32(x.x - xh.x), to_tf32(x.y - xh.y), to_tf32(x.z - xh.z),
                                to_tf32(x.w - xh.w));
          }
          fence_proxy_async();
        }
        named_sync_consumers();
      }
#pragma unroll 2
      for (int kh = 0; kh < kCh / G::kPasses / G::kKStep; ++kh, ++ks) {
        const int j = ks % kKps2;  // k-step within the stage
        if (j == 0) mbar_wait(full_b(b_stage), b_phase);
        const uint32_t blk =
            b_ring + b_stage * kBStageBytes + ((j * kConsumers + c) * kPlanes) * (kNW2 * 32);
        const uint32_t aoff = (kh / 4) * kAChunkBytes + 32 * (kh % 4);
        wgmma_fence();
        mma_step<kNW2>(acc2, a_hi + aoff, a_lo + aoff, blk, blk + kNW2 * 32);
        wgmma_commit();
        wgmma_wait<0>();
        if (j == kKps2 - 1) {
          release_b(b_stage);
          if (++b_stage == kBStages) { b_stage = 0; b_phase ^= 1; }
        }
      }
    }
    fence_acc(acc2);

    // ---- epilogue: each thread owns (row, column pair) elements of rs
    const size_t row0 = static_cast<size_t>(batch) * T;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int pos = t0 + r0 + 8 * hr;
      if (pos >= T) continue;
      const size_t step = row0 + pos;
#pragma unroll
      for (int i = 0; i < kNW2 / 8; ++i) {
        const float2 v = make_float2(acc2[4 * i + 2 * hr], acc2[4 * i + 2 * hr + 1]);
        const int col = c * kNW2 + 8 * i + 2 * t;  // rs column
        if (MODE == kRs) {
          store2(rs_out + step * RS + col, v);
        } else if (RS == 2 * kCh && c == 0) {  // residual half
          const float2 hv = load2(h + step * kCh + col);
          store2(h_out + step * kCh + col, make_float2(hv.x + v.x, hv.y + v.y));
        } else {  // skip half, or all of rs on the last layer
          const int ch = RS == 2 * kCh ? col - kCh : col;
          float2 sv = v;
          if (!kFirstMode) {
            const float2 old = load2(skip + step * kCh + ch);
            sv = make_float2(old.x + v.x, old.y + v.y);
          }
          store2(skip_out + step * kCh + ch, sv);
        }
      }
    }
  }
}

// ---- host side

// [B, T, C] -> a map whose box is 128 bytes of channels x kTile steps of
// one batch row, 128-byte swizzled, zero outside the tensor
bool encode_activations(CUtensorMap* map, const float* base, int C, int T, int B) {
  auto encode = tensor_map_encoder();
  if (!encode) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)C * sizeof(float), (cuuint64_t)C * sizeof(float) * T};
  const cuuint32_t box[3] = {(cuuint32_t)Geom::kKC, kTile, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, tensor_map_type<float>(), 3, const_cast<float*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct LayerArgs {
  const void *h, *cond, *skip, *wpack, *bias_a, *b_rs;
  void *h_out, *skip_out, *rs;
  int B, T, CC, dil;
  cudaStream_t stream;
};

template <int MODE, int RS>
int launch(const LayerArgs& a) {
  const float* h = static_cast<const float*>(a.h);
  const float* cond = static_cast<const float*>(a.cond);
  CUtensorMap map_h, map_cond;
  if (!encode_activations(&map_h, h, kCh, a.T, a.B) ||
      !encode_activations(&map_cond, cond, a.CC, a.T, a.B))
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = Geom::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(wn_layer_kernel<MODE, RS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (a.T + kTile - 1) / kTile;
  const dim3 grid((tiles + kCluster - 1) / kCluster * kCluster, a.B);
  wn_layer_kernel<MODE, RS><<<grid, kThreads, smem, a.stream>>>(
      map_h, map_cond, h, static_cast<const float*>(a.skip), static_cast<const float*>(a.wpack),
      static_cast<const float*>(a.bias_a), static_cast<const float*>(a.b_rs),
      static_cast<float*>(a.h_out), static_cast<float*>(a.skip_out), static_cast<float*>(a.rs),
      a.T, a.CC, a.dil);
  return (int)cudaGetLastError();
}

int layer(const LayerArgs& a, int rs_out, int mode) {
  if (a.B < 1 || a.B > 65535 || a.T < 1 || a.CC < Geom::kKC || a.CC % Geom::kKC != 0 ||
      a.dil < 1)
    return (int)cudaErrorInvalidValue;
  const bool wide = rs_out == 2 * kCh;
  if (!wide && rs_out != kCh) return (int)cudaErrorInvalidValue;
  switch (mode) {
    case kRs:
      if (!a.rs) return (int)cudaErrorInvalidValue;
      return wide ? launch<kRs, 2 * kCh>(a) : launch<kRs, kCh>(a);
    case kMid:
      if (!wide || !a.skip || !a.h_out || !a.skip_out) return (int)cudaErrorInvalidValue;
      return launch<kMid, 2 * kCh>(a);
    case kFirst:
      if (!wide || !a.h_out || !a.skip_out) return (int)cudaErrorInvalidValue;
      return launch<kFirst, 2 * kCh>(a);
    case kLast:
      if (wide || !a.skip || !a.skip_out) return (int)cudaErrorInvalidValue;
      return launch<kLast, kCh>(a);
    case kFirstLast:
      if (wide || !a.skip_out) return (int)cudaErrorInvalidValue;
      return launch<kFirstLast, kCh>(a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// h [B, T, 256], cond [B, T, CC]; wpack: the layer's weights as TF32 hi/lo
// stages (see ops/wn_layer.py::pack_weights); bias_a [512], b_rs [rs_out].
// mode 0 (K4) writes rs [B, T, rs_out]; modes 1-4 (K3: middle, first,
// last, first and last) read skip (not on a first layer) and write skip_out
// [B, T, 256] and, unless last, h_out [B, T, 256].
// Returns the CUDA error code of the launch (0 on success).
int wn_layer_f32(const float* h, const float* cond, const float* skip, const float* wpack,
                 const float* bias_a, const float* b_rs, float* h_out, float* skip_out, float* rs,
                 int B, int T, int CC, int rs_out, int dil, int mode, void* stream) {
  const LayerArgs a{h, cond, skip, wpack, bias_a, b_rs, h_out, skip_out, rs, B, T, CC, dil,
                    static_cast<cudaStream_t>(stream)};
  return layer(a, rs_out, mode);
}

// dynamic shared memory of a block, bytes
int wn_layer_smem_bytes() { return (int)Geom::kSmemBytes; }

const char* wn_layer_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
