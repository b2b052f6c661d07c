// Fused WaveGlow WN layer in bf16 for Hopper (sm_90a): persistent clusters,
// wgmma, TMA, mbarriers.
//
// Replaces, in bf16, both TPU kernels of larynx_tpu/ops/wn_layer.py:
//   K3  fused_wn_layer_state  (_kernel_state, pallas_call at :258)
//   K4  fused_wn_layer        (_kernel,       pallas_call at :332)
// (csrc/wn_layer.cu is the f32 kernel.)  One kernel, templated on the mode:
// the layer alone (K4, writes rs), or the layer with its state update on the
// first, a middle or the last layer of a WN stack (K3).
//
// What it computes, for h [B, T, 256], cond [B, T, CC] (bf16, channels-last,
// contiguous), ch = 256:
//   a  = h[t-d] @ W0 + h[t] @ W1 + h[t+d] @ W2 + cond[t] @ Wc + bias_a
//        (h zero outside [0, T); bias_a = bf16(b_in + b_cond))   [2ch]
//   g  = tanh(a[:ch]) * sigmoid(a[ch:])                          [ch]
//   rs = g @ Wrs + b_rs                                          [RS]
//   K4:    out = rs
//   K3:    h_out = h + rs[:ch], skip_out = skip + rs[ch:]  (middle)
//          h_out = h + rs[:ch], skip_out = rs[ch:]         (first)
//          skip_out = skip + rs, h untouched (RS = ch)     (last)
//          skip_out = rs, h untouched                      (first and last)
// h_out must not alias h: neighbouring tiles read h's halo.  It rounds where
// the Pallas kernel does (wn_layer.py:155-195): every product sums in f32;
// the gate is formed in f32 and rounded to bf16 before the res/skip product;
// rs + b_rs is rounded to bf16; h + rs[:ch] and skip + rs[ch:] are each
// rounded to bf16.
//
// What bounds it: operations.  A time step costs 2 * (2ch * (3ch + CC) +
// ch * RS) = 1.70 MFLOP at CC = 640, RS = 512, one bf16 operation each at
// the dense bf16 peak, against ~5 * 512 bytes of activation I/O; the weights
// (1.7 MB) are shared by every time step.  At that peak a 64-row tile's
// products take 14.6 us of one SM's tensor cores.  The design before this
// one (the f32 plan instantiated in bf16) spent ~41 us a tile on an H100:
// its 4-stage weight ring held 0.56 us of products, one block an SM ran its
// set-up, gate, second product and epilogue one after another with nothing
// to overlap them, and its epilogue loaded h and skip from HBM after the
// products.  So:
//
//   * persistent clusters of 2 blocks, one block an SM: a launch has as many
//     clusters as fit at once (cudaOccupancyMaxActiveClusters: 66 on an
//     H100, every SM; at most one per 2 tiles), and cluster k takes items k,
//     k + clusters, ...; an item is 2 consecutive 64-row time tiles (of the
//     B * ceil(T / 64) tiles, row major), one a block.  Barriers are set up once a launch, and the
//     producer runs into the next tile's activations and weight stages while
//     the consumers form the gate, run the second product and store.  A tile
//     past the last one (batch row >= B) runs on zero-filled rows and stores
//     nothing.
//   * 384 threads: a producer warpgroup (thread 0 streams the weights,
//     thread 32 the activations) and two consumer warpgroups; setmaxnreg
//     moves the producer's registers to the consumers.  Consumer c owns
//     channels [128c, 128c + 128): their tanh and sigmoid columns of the
//     first product (wgmma m64n256k16, 128 f32 accumulators a thread), so the
//     gate is formed in registers, and rs columns [c RS/2, (c + 1) RS/2) of
//     the second, accumulated in the same registers.
//   * weights (ops/wn_layer.py::pack_weights): one 16 KB stage per k-step of
//     the first product (16 K rows, all 512 columns), 8 stages in an
//     mbarrier ring (1.1 us of products in flight).  Each block of a cluster
//     copies half of every stage by bulk TMA and multicasts it to both, so a
//     weight byte leaves L2 once per 2 tiles (4.1 TB/s at the main path's
//     middle layer; every block loading its own stages needs 5.9 TB/s of L2
//     and is slower).  The ring's refill latency (a stage is free once all
//     four consumers of the cluster release it, and then crosses L2 again)
//     bounds it with the serial phases: without the products the main
//     path's middle layer keeps 84% of its time, and 4 stages instead of 8
//     cost 21%; clusters of 4 halve the L2 bytes but only 30 of them fit
//     (120 SMs), which costs more than it saves
//     (scripts/ablate_torch_wn_bf16.py, PERF.md).
//   * activations: TMA boxes of 64 rows x 64 channels, 128-byte swizzled
//     (the canonical K-major wgmma layout): the taps at -d and +d and cond
//     through a 4-chunk ring; the centre tap of h and the skip tile into
//     buffers of their own, which the epilogue reads back for the state
//     update, so no global load follows the products.  A box row outside
//     [0, T), or past the last batch row, is zero-filled by the hardware:
//     the conv's zero padding for any dilation, never the neighbouring batch
//     row.
//   * the gate from two ex2 and one reciprocal (the MUFU unit, 16 a clock an
//     SM, bounds it), written as bf16 into the activation ring, which the
//     consumers hold back from the producer for it; the second product reads
//     it from there with two wgmma groups in flight.
//   * no calls and one accumulator set in the consumers keep ptxas from
//     serialising the wgmma pipeline (C7510/C7512).

#include "sm90.cuh"

namespace {

using E = __nv_bfloat16;

constexpr int kCh = 256;                      // WN channels
constexpr int kTile = 64;                     // time steps per tile (wgmma M)
constexpr int kConsumers = 2;                 // consumer warpgroups
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kCluster = 2;                   // blocks sharing each weight stage
constexpr int kKStep = 16;                    // K of a bf16 wgmma k-step (32 bytes)
constexpr int kKC = 64;                       // K columns of an activation chunk (128 bytes)
constexpr int kChunkBytes = kTile * 128;      // one chunk: 64 rows of one 128-byte swizzle row
constexpr int kTileChunks = kCh / kKC;        // chunks of a [64, 256] tile: h, skip, the gate
constexpr int kAStages = kTileChunks;         // activation ring; after product 1, the gated tile
constexpr int kNW1 = 2 * kCh / kConsumers;    // first-product columns per consumer (256)
constexpr int kStepBytes = kConsumers * kNW1 * 32;  // the weights of one first-product k-step
constexpr int kStageSteps = 1;                // first-product k-steps a weight stage
constexpr int kBStageBytes = kStageSteps * kStepBytes;
constexpr int kBStages = 8;                   // weight ring depth
constexpr int kP2InFlight = 1;                // wgmma groups product 2 leaves in flight

// shared memory, from a 1 KB aligned base (128-byte swizzle atoms want it)
constexpr int kHOff = kAStages * kChunkBytes;             // the centre tap of h
constexpr int kSOff = kHOff + kTileChunks * kChunkBytes;  // skip
constexpr int kBOff = kSOff + kTileChunks * kChunkBytes;  // the weight ring
constexpr int kBarOff = kBOff + kBStages * kBStageBytes;
constexpr int kBars = 2 * kBStages + 2 * kAStages + 3;
constexpr size_t kSmemBytes = 1024 + kBarOff + kBars * 8;
static_assert(kSmemBytes <= 232448, "over the shared memory a block can have");
static_assert(kBStageBytes % (16 * kCluster) == 0, "a stage splits into 16-byte parts");

enum Mode { kRs = 0, kMid = 1, kFirst = 2, kLast = 3, kFirstLast = 4 };

// a slot of an mbarrier ring and the parity of its current phase
struct Ring {
  int slot = 0;
  uint32_t parity = 0;
};

template <int N>
__device__ __forceinline__ void advance(Ring& r) {
  if (++r.slot == N) {
    r.slot = 0;
    r.parity ^= 1;
  }
}

template <int N>
__device__ __forceinline__ int prev(int slot) { return slot == 0 ? N - 1 : slot - 1; }

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

// acc += a * b for one k-step, a group of its own
template <int N>
__device__ __forceinline__ void mma(float (&acc)[N / 2], uint32_t a, uint32_t b) {
  wgmma_fence();
  wgmma_bf16<N>(acc, desc_a_sw128(a), desc_kmajor(b));
  wgmma_commit();
}

// byte offset of channel ch of row `row` in a [64, 256] tile held as four
// swizzled chunks of 64 channels (the layout TMA writes for the boxes)
__device__ __forceinline__ int swizzled(int ch, int row) {
  const int in_row = (ch % kKC) * 2;
  return (ch / kKC) * kChunkBytes + row * 128 + (((in_row / 16) ^ (row % 8)) * 16) + in_row % 16;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// tanh(a) * sigmoid(b) = (1 - e^-2a) / ((1 + e^-2a) (1 + e^-b)): two ex2 and
// one reciprocal.  a is clamped to [-9, 9], where tanh is within 3e-8 of +-1,
// so e^-2a stays finite; a large negative b makes e^-b infinite and the
// result 0.  ex2.approx and rcp.approx are within 2^-22 relative, so the
// result is within ~1e-6 relative of the f32 value where |tanh a| > 0.25,
// and within ~3e-7 absolute below (1 - e^-2a cancels), far under the bf16
// rounding of g (2^-9 relative).  No call and no IEEE division, which would
// serialise the wgmma pipeline.
__device__ __forceinline__ float gate(float a, float b) {
  constexpr float kLog2e = 1.4426950408889634f;
  a = fminf(fmaxf(a, -9.0f), 9.0f);
  const float ea = ex2(-2.0f * kLog2e * a);
  const float eb = ex2(-kLog2e * b);
  return (1.0f - ea) * rcp((1.0f + ea) * (1.0f + eb));
}

template <int MODE, int RS>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
wn_bf16_kernel(const __grid_constant__ CUtensorMap tmap_h,
               const __grid_constant__ CUtensorMap tmap_cond,
               const __grid_constant__ CUtensorMap tmap_skip, const E* __restrict__ wpack,
               const E* __restrict__ bias_a, const E* __restrict__ b_rs, E* __restrict__ h_out,
               E* __restrict__ skip_out, E* __restrict__ rs_out, int B, int T, int CC, int dil,
               int tiles_per_row, int n_items) {
  constexpr int kNW2 = RS / kConsumers;                                // second-product columns per consumer
  constexpr int kP2Steps = kBStageBytes / (kConsumers * kNW2 * 32);    // its k-steps a stage
  constexpr bool kReadsSkip = MODE == kMid || MODE == kLast;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t b_ring = base + kBOff;
  const uint32_t bars = base + kBarOff;
  auto full_b = [&](int i) { return bars + 8 * i; };
  auto empty_b = [&](int i) { return bars + 8 * (kBStages + i); };
  auto full_a = [&](int i) { return bars + 8 * (2 * kBStages + i); };
  auto empty_a = [&](int i) { return bars + 8 * (2 * kBStages + kAStages + i); };
  const uint32_t full_h = bars + 8 * (2 * kBStages + 2 * kAStages);  // the centre tap landed
  const uint32_t full_s = full_h + 8;                                // the skip tile landed
  const uint32_t free_hs = full_h + 16;                              // both read back

  const int n_chunks = (3 * kCh + CC) / kKC;  // the first product's activation chunks
  const int n_ring = n_chunks - kTileChunks;  // ... that come through the ring
  const int n_stages = (n_chunks * (kKC / kKStep) + kCh / kKStep * kStageSteps / kP2Steps) /
                       kStageSteps;  // weight stages a tile
  const int first_item = blockIdx.x / kCluster;
  const int item_stride = gridDim.x / kCluster;
  const int rank = static_cast<int>(cluster_rank());
  const int wg = threadIdx.x / 128;
  // this block's tile of an item: batch row (>= B past the last tile) and first step
  auto tile_of = [&](int item, int& batch, int& t0) {
    const int tile = item * kCluster + rank;
    batch = tile / tiles_per_row;
    t0 = (tile - batch * tiles_per_row) * kTile;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < kBStages; ++i) {
      mbar_init(full_b(i), 1);
      mbar_init(empty_b(i), kConsumers * kCluster);
    }
    for (int i = 0; i < kAStages; ++i) {
      mbar_init(full_a(i), 1);
      mbar_init(empty_a(i), kConsumers);
    }
    mbar_init(full_h, 1);
    mbar_init(full_s, 1);
    mbar_init(free_hs, 128 * kConsumers);
    mbar_init_fence();
  }
  cluster_sync();  // every barrier of the cluster exists before any copy or remote arrive

  if (wg == 0) {
    // ---- producer warpgroup: thread 0 the weights, thread 32 the activations
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      constexpr int kPart = kBStageBytes / kCluster;
      const char* src = reinterpret_cast<const char*>(wpack) + rank * kPart;
      Ring ring;
      for (int item = first_item; item < n_items; item += item_stride) {
        for (int s = 0; s < n_stages; ++s) {
          mbar_wait(empty_b(ring.slot), ring.parity ^ 1);
          mbar_expect_tx(full_b(ring.slot), kBStageBytes);
          bulk_load_multicast(b_ring + ring.slot * kBStageBytes + rank * kPart,
                              src + static_cast<size_t>(s) * kBStageBytes, kPart,
                              full_b(ring.slot));
          advance<kBStages>(ring);
        }
      }
      // stay until every consumer of the cluster has released every stage:
      // no block leaves while a peer may still arrive on its barriers
      for (int i = 0; i < kBStages; ++i) {
        mbar_wait(empty_b(ring.slot), ring.parity ^ 1);
        advance<kBStages>(ring);
      }
    } else if (threadIdx.x == 32) {
      // in the consumers' order: the taps at -d through the ring, the
      // centre tap and skip into their buffers (once the last tile's
      // epilogue has read them), the taps at +d and cond through the ring
      Ring ring;
      uint32_t hs_parity = 0;
      for (int item = first_item; item < n_items; item += item_stride) {
        int batch, t0;
        tile_of(item, batch, t0);
        auto ring_load = [&](const CUtensorMap* map, int c0, int row) {
          mbar_wait(empty_a(ring.slot), ring.parity ^ 1);
          mbar_expect_tx(full_a(ring.slot), kChunkBytes);
          tma_load_3d(base + ring.slot * kChunkBytes, map, full_a(ring.slot), c0, row, batch);
          advance<kAStages>(ring);
        };
        for (int j = 0; j < kTileChunks; ++j) ring_load(&tmap_h, kKC * j, t0 - dil);
        mbar_wait(free_hs, hs_parity ^ 1);
        hs_parity ^= 1;
        mbar_expect_tx(full_h, kTileChunks * kChunkBytes);
        for (int j = 0; j < kTileChunks; ++j)
          tma_load_3d(base + kHOff + j * kChunkBytes, &tmap_h, full_h, kKC * j, t0, batch);
        if (kReadsSkip) {
          mbar_expect_tx(full_s, kTileChunks * kChunkBytes);
          for (int j = 0; j < kTileChunks; ++j)
            tma_load_3d(base + kSOff + j * kChunkBytes, &tmap_skip, full_s, kKC * j, t0, batch);
        }
        for (int j = 0; j < kTileChunks; ++j) ring_load(&tmap_h, kKC * j, t0 + dil);
        for (int j = 0; j < CC / kKC; ++j) ring_load(&tmap_cond, kKC * j, t0);
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
    const uint8_t* res_buf = smem + (RS == 2 * kCh && c == 0 ? kHOff : kSOff);  // epilogue's addend
    Ring bq, aq;  // the weight ring, the activation ring
    uint32_t hs_parity = 0;
    auto wait_b = [&]() { mbar_wait(full_b(bq.slot), bq.parity); };  // the stage landed
    // a stage is free once every consumer of the cluster has released it:
    // thread r of each consumer arrives on block r's barrier, all at once
    auto release_b = [&](int slot) {
      const int r = threadIdx.x % 128;
      if (r < kCluster) mbar_arrive_cluster(empty_b(slot), r);
    };
    float acc[kNW1 / 2];

    for (int item = first_item; item < n_items; item += item_stride) {
      int batch, t0;
      tile_of(item, batch, t0);

      // ---- first product: a = [h taps | cond] @ [W0; W1; W2; Wc] + bias_a.
      // Accumulator chunk i < 16 holds tanh columns 128c + 8i + ..., chunk
      // i + 16 their sigmoid partners, at the same fragment positions.
#pragma unroll
      for (int i = 0; i < kNW1 / 8; ++i) {
        const int col = (i < 16 ? 0 : kCh - 128) + 128 * c + 8 * i + 2 * t;
        const float2 bv = ldg2(bias_a + col);
        acc[4 * i] = bv.x; acc[4 * i + 1] = bv.y; acc[4 * i + 2] = bv.x; acc[4 * i + 3] = bv.y;
      }
      fence_acc(acc);
      // Two wgmma groups in flight: a weight stage is released once the
      // first group of the next stage has been issued and the stage's are
      // done, a ring chunk once the first group of the next chunk has been.
      // The last kAStages ring chunks are held: the gated tile goes where
      // they are.
      int pending = -1;  // the previous chunk's ring slot, to release
      for (int chunk = 0; chunk < n_chunks; ++chunk) {
        const bool centre = chunk >= kTileChunks && chunk < 2 * kTileChunks;
        uint32_t a;
        if (centre) {
          if (chunk == kTileChunks) mbar_wait(full_h, hs_parity);
          a = base + kHOff + (chunk - kTileChunks) * kChunkBytes;
        } else {
          mbar_wait(full_a(aq.slot), aq.parity);
          a = base + aq.slot * kChunkBytes;
        }
#pragma unroll
        for (int kk = 0; kk < kKC / kKStep; ++kk) {
          const int j = kk % kStageSteps;  // k-step within the stage
          if (j == 0) wait_b();
          mma<kNW1>(acc, a + 32 * kk,
                    b_ring + bq.slot * kBStageBytes + j * kStepBytes + c * (kNW1 * 32));
          wgmma_wait<1>();
          if (j == 0 && (chunk > 0 || kk > 0)) release_b(prev<kBStages>(bq.slot));
          if (kk == 0 && pending >= 0 && leader) mbar_arrive(empty_a(pending));
          if (j == kStageSteps - 1) advance<kBStages>(bq);
        }
        pending = -1;
        if (!centre) {
          const int r = chunk < kTileChunks ? chunk : chunk - kTileChunks;  // index in the ring
          if (r < n_ring - kAStages) pending = aq.slot;
          advance<kAStages>(aq);
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      release_b(prev<kBStages>(bq.slot));
      if (pending >= 0 && leader) mbar_arrive(empty_a(pending));

      // ---- gate, in registers, rounded to bf16 into the held ring in the
      // chunks' swizzled layout (consumer c writes channels [128c, 128c + 128))
      named_sync_consumers();  // neither consumer reads the ring any more
#pragma unroll
      for (int i = 0; i < 16; ++i) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float gv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            gv[e] = gate(acc[4 * i + 2 * hr + e], acc[4 * (i + 16) + 2 * hr + e]);
          store2(reinterpret_cast<E*>(smem + swizzled(128 * c + 8 * i + 2 * t, r0 + 8 * hr)),
                 make_float2(gv[0], gv[1]));
        }
      }
      fence_proxy_async();
      named_sync_consumers();

      // ---- second product: rs = g @ Wrs + b_rs in the first product's
      // registers, kP2Steps k-steps a weight stage
      float (&acc2)[kNW2 / 2] = *reinterpret_cast<float (*)[kNW2 / 2]>(&acc[0]);
#pragma unroll
      for (int i = 0; i < kNW2 / 8; ++i) {
        const float2 bv = ldg2(b_rs + c * kNW2 + 8 * i + 2 * t);
        acc2[4 * i] = bv.x; acc2[4 * i + 1] = bv.y; acc2[4 * i + 2] = bv.x; acc2[4 * i + 3] = bv.y;
      }
      fence_acc(acc2);
#pragma unroll
      for (int ks = 0; ks < kCh / kKStep; ++ks) {
        const int j = ks % kP2Steps;  // k-step within the stage
        if (j == 0) wait_b();
        mma<kNW2>(acc2, base + (ks / 4) * kChunkBytes + 32 * (ks % 4),
                  b_ring + bq.slot * kBStageBytes + (j * kConsumers + c) * (kNW2 * 32));
        wgmma_wait<kP2InFlight>();
        if (j == kP2Steps - 1) {
          if (kP2InFlight == 0) release_b(bq.slot);
          else if (ks >= kP2Steps) release_b(prev<kBStages>(bq.slot));
          advance<kBStages>(bq);
        }
      }
      wgmma_wait<0>();
      fence_acc(acc2);
      if (kP2InFlight > 0) release_b(prev<kBStages>(bq.slot));
      if (leader) {  // the gated tile is read: the ring is the producer's again
#pragma unroll
        for (int i = 0; i < kAStages; ++i) mbar_arrive(empty_a(i));
      }

      // ---- epilogue: each thread owns (row, column pair) elements of rs;
      // the state's addends come from the h and skip buffers
      if (kReadsSkip && (RS == kCh || c == 1)) mbar_wait(full_s, hs_parity);
      const size_t row0 = static_cast<size_t>(batch) * T;
      const bool res = RS == 2 * kCh && c == 0;  // the residual half (h_out), else skip_out
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = r0 + 8 * hr;
        const bool store = batch < B && t0 + row < T;
        const size_t step = row0 + t0 + row;
        // eight column pairs at a time: their addends loaded, then added and
        // stored, so the loads stay few registers ahead of the stores
#pragma unroll
        for (int i0 = 0; i0 < kNW2 / 8; i0 += 8) {
          float2 old[8];
#pragma unroll
          for (int i = i0; i < i0 + 8; ++i) {
            // rs column 8i + 2t of this consumer's; the state's channel
            const int ch = (MODE == kRs || res || RS == kCh ? 0 : -kCh) + c * kNW2 + 8 * i + 2 * t;
            old[i - i0] = make_float2(0.f, 0.f);  // a first layer's skip half is rs alone
            if (MODE != kRs && (res || kReadsSkip))
              old[i - i0] = load2(reinterpret_cast<const E*>(res_buf + swizzled(ch, row)));
          }
#pragma unroll
          for (int i = i0; i < i0 + 8; ++i) {
            const int ch = (MODE == kRs || res || RS == kCh ? 0 : -kCh) + c * kNW2 + 8 * i + 2 * t;
            const float2 v =
                round_to<E>(make_float2(acc2[4 * i + 2 * hr], acc2[4 * i + 2 * hr + 1]));
            const float2 sv = make_float2(old[i - i0].x + v.x, old[i - i0].y + v.y);
            if (!store) continue;
            if (MODE == kRs) store2(rs_out + step * RS + ch, v);
            else store2((res ? h_out : skip_out) + step * kCh + ch, sv);
          }
          asm volatile("" ::: "memory");
        }
      }
      mbar_arrive(free_hs);
      hs_parity ^= 1;
    }
  }
}

// ---- host side

// [B, T, C] -> a map whose box is 64 channels (128 bytes) x kTile steps of
// one batch row, 128-byte swizzled, zero outside the tensor
bool encode_activations(CUtensorMap* map, const void* base, int C, int T, int B) {
  auto encode = tensor_map_encoder();
  if (!encode) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)C * sizeof(E), (cuuint64_t)C * sizeof(E) * T};
  const cuuint32_t box[3] = {(cuuint32_t)kKC, kTile, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, tensor_map_type<E>(), 3, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// clusters of this kernel that fit on the current device at once, with its
// shared memory set (a negative CUDA error code on failure)
template <int MODE, int RS>
int active_clusters() {
  auto kernel = wn_bf16_kernel<MODE, RS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  if (err != cudaSuccess) return -(int)err;
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return -(int)err;
  static int fit[64] = {};
  if (dev < 64 && fit[dev] > 0) return fit[dev];
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kSmemBytes;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  if ((err = cudaOccupancyMaxActiveClusters(&n, (const void*)kernel, &cfg)) != cudaSuccess)
    return -(int)err;
  if (n < 1) return -(int)cudaErrorInvalidConfiguration;
  if (dev < 64) fit[dev] = n;
  return n;
}

// the launch's plan: items of kCluster tiles, clusters, tiles a block
struct Plan {
  int tiles_per_row, items, clusters, tiles_per_block;
};

Plan plan_of(int B, int T, int fit) {
  Plan p;
  p.tiles_per_row = (T + kTile - 1) / kTile;
  const long long tiles = static_cast<long long>(B) * p.tiles_per_row;
  p.items = static_cast<int>((tiles + kCluster - 1) / kCluster);
  p.clusters = p.items < fit ? p.items : fit;
  p.tiles_per_block = (p.items + p.clusters - 1) / p.clusters;
  return p;
}

struct LayerArgs {
  const void *h, *cond, *skip, *wpack, *bias_a, *b_rs;
  void *h_out, *skip_out, *rs;
  int B, T, CC, dil;
  cudaStream_t stream;
};

template <int MODE, int RS>
int launch(const LayerArgs& a) {
  CUtensorMap map_h, map_cond, map_skip;
  if (!encode_activations(&map_h, a.h, kCh, a.T, a.B) ||
      !encode_activations(&map_cond, a.cond, a.CC, a.T, a.B) ||
      !encode_activations(&map_skip, a.skip ? a.skip : a.h, kCh, a.T, a.B))
    return (int)cudaErrorInvalidValue;
  const int fit = active_clusters<MODE, RS>();
  if (fit < 0) return -fit;
  const Plan p = plan_of(a.B, a.T, fit);
  wn_bf16_kernel<MODE, RS><<<p.clusters * kCluster, kThreads, kSmemBytes, a.stream>>>(
      map_h, map_cond, map_skip, static_cast<const E*>(a.wpack), static_cast<const E*>(a.bias_a),
      static_cast<const E*>(a.b_rs), static_cast<E*>(a.h_out), static_cast<E*>(a.skip_out),
      static_cast<E*>(a.rs), a.B, a.T, a.CC, a.dil, p.tiles_per_row, p.items);
  return (int)cudaGetLastError();
}

bool geometry_ok(int B, int T, int CC, int rs_out) {
  return B >= 1 && B <= 65535 && T >= 1 && CC >= kKC && CC % kKC == 0 &&
         (rs_out == kCh || rs_out == 2 * kCh);
}

}  // namespace

extern "C" {

// h [B, T, 256], cond [B, T, CC] with CC a multiple of 64, every tensor
// bf16; wpack: the layer's weight stages (ops/wn_layer.py::pack_weights);
// bias_a [512], b_rs [rs_out].  mode 0 (K4) writes rs [B, T, rs_out]; modes
// 1-4 (K3: middle, first, last, first and last) read skip (not on a first
// layer) and write skip_out [B, T, 256] and, unless last, h_out [B, T, 256].
// Returns the CUDA error code of the launch (0 on success).
int wn_bf16(const void* h, const void* cond, const void* skip, const void* wpack,
            const void* bias_a, const void* b_rs, void* h_out, void* skip_out, void* rs, int B,
            int T, int CC, int rs_out, int dil, int mode, void* stream) {
  if (!geometry_ok(B, T, CC, rs_out) || dil < 1) return (int)cudaErrorInvalidValue;
  const LayerArgs a{h, cond, skip, wpack, bias_a, b_rs, h_out, skip_out, rs, B, T, CC, dil,
                    static_cast<cudaStream_t>(stream)};
  const bool wide = rs_out == 2 * kCh;
  switch (mode) {
    case kRs:
      if (!rs) return (int)cudaErrorInvalidValue;
      return wide ? launch<kRs, 2 * kCh>(a) : launch<kRs, kCh>(a);
    case kMid:
      if (!wide || !skip || !h_out || !skip_out) return (int)cudaErrorInvalidValue;
      return launch<kMid, 2 * kCh>(a);
    case kFirst:
      if (!wide || !h_out || !skip_out) return (int)cudaErrorInvalidValue;
      return launch<kFirst, 2 * kCh>(a);
    case kLast:
      if (wide || !skip || !skip_out) return (int)cudaErrorInvalidValue;
      return launch<kLast, kCh>(a);
    case kFirstLast:
      if (wide || !skip_out) return (int)cudaErrorInvalidValue;
      return launch<kFirstLast, kCh>(a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The launch plan of a layer on the current device, for its mirror
// ops/wn_layer.py::bf16_launch_plan: out = [grid blocks, cluster size,
// clusters that fit at once, tiles a block (at most), weight stage bytes,
// weight stages a tile, ring stages, dynamic shared memory bytes].
int wn_bf16_geometry(int B, int T, int CC, int rs_out, int* out) {
  if (!geometry_ok(B, T, CC, rs_out)) return (int)cudaErrorInvalidValue;
  const int fit = active_clusters<kMid, 2 * kCh>();
  if (fit < 0) return -fit;
  const Plan p = plan_of(B, T, fit);
  const int p2_steps = kBStageBytes / (kConsumers * rs_out / kConsumers * 32);
  out[0] = p.clusters * kCluster;
  out[1] = kCluster;
  out[2] = fit;
  out[3] = p.tiles_per_block;
  out[4] = kBStageBytes;
  out[5] = ((3 * kCh + CC) / kKStep + kCh / kKStep * kStageSteps / p2_steps) / kStageSteps;
  out[6] = kBStages;
  out[7] = (int)kSmemBytes;
  return 0;
}

const char* wn_bf16_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
