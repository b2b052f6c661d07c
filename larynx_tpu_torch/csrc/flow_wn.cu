// GlowTTS's flow WaveNet layer in f32 for Hopper (sm_90a): wgmma, TMA,
// mbarriers, clusters.
//
// Replaces no Pallas kernel: larynx_tpu/models/glow_tts/flows.py::wavenet
// leaves the coupling's WaveNet to XLA.  Added because, eagerly or as a
// CUDA graph, each of the reverse flow's 48 WN layers (12 couplings x 4
// layers at hidden 192, k 5) ran as ~9 kernels: a transposed copy, cuDNN's
// f32 implicit-GEMM conv on CUDA cores (TF32 off), the gate's elementwise
// kernels, an f32 GEMM and the masked state adds; the flow decode took
// ~12.5 ms of a batch of 8 rows against a bound of ~0.74 ms.
//
// What it computes, for x [B, T, 192] (channels-last, contiguous, zero
// where mask is 0), mask [B, T] (any strides), K taps (odd, <= 5),
// dilation d, h = 192:
//   a   = sum_j x[t + (j - (K-1)/2) d] @ Wj + b_in (+ g[b], the row's speaker bias)
//         (x zero outside [0, T))                                    [2h]
//   act = tanh(a[:h]) * sigmoid(a[h:])                               [h]
//   rs  = act @ Wrs + b_rs                                           [2h]
//   x_out = (x + rs[:h]) * mask          (not on the last layer)
//   skip_out = skip + rs[h:]             (first layer: rs[h:]; last: times mask)
// x_out must not alias x (neighbouring tiles read x's halo); skip_out may
// alias skip.  A pair of time tiles whose mask is zero on every row writes
// zeros to x_out and skip_out and does no products: the masked arithmetic
// gives x_out = 0 there, and the stack's output, skip * mask, is 0 there
// whatever skip holds.  Padded columns are ~half of a batch's bucket.
//
// What bounds it: operations.  A time step costs 2 * (2h * K h + h * 2h) =
// 0.88 MFLOP at K=5 against 1.5 KB of activation I/O (~580 FLOP/byte); the
// weights (1.77 MB) are shared by every time step.  Each product runs as
// three TF32 tensor-core products (3xTF32: a_lo*b_hi + a_hi*b_lo +
// a_hi*b_hi, f32 accumulate, the port's float32 rule), so the bound is 3
// TF32 operations a FLOP at the dense TF32 peak: ~15 us a layer for a
// batch's ~2,800 valid squeezed steps.  One 64-step tile costs an SM ~45
// us at its share of the peak, so a layer at B=8 is one wave of ~50 tiles:
// the tile, not the card, is the limit at this batch.  The weights come
// next: as TF32 hi and lo planes a layer is 3.5 MB, which each tile must
// stream from L2.  The design:
//
//   * one block per 64-step time tile of one batch row (wgmma M = 64): a
//     producer warpgroup and two consumer warpgroups; setmaxnreg moves the
//     producer's registers to the consumers.  In the first product consumer
//     c owns channels [96c, 96c + 96): their tanh and sigmoid columns (N =
//     192, wgmma m64n192k8 TF32, 96 f32 accumulators a thread), so the gate
//     is formed in registers.  In the second, consumer 0 owns the 192 res
//     columns and consumer 1 the 192 skip columns, so each writes one
//     state.
//   * A (activations): one producer thread brings each K chunk of 32
//     channels, a box of 64 steps of x at offset (j - (K-1)/2) d, by TMA
//     from a 3-D tensor map [B, T, 192], 128-byte swizzled, into a 6-deep
//     ring; a box row outside [0, T) is zero-filled by the hardware, which
//     is the conv's zero padding, for any dilation.  Two producer warps
//     split each chunk in place into its TF32 hi plane and a lo plane
//     beside it.
//   * B (weights) is packed once at load (ops/flow_wn.py::pack_stack, in
//     ops/wn_layer.py::pack_weights's layout): one 24 KB stage per k-step,
//     exact TF32 hi and lo planes.  Blocks run as clusters of 2 neighbouring
//     time tiles; each block copies half of every stage and multicasts it
//     to both, so every weight byte leaves L2 once per pair of tiles.  A
//     block whose tile lies past T runs the same protocol on zero-filled
//     rows and stores nothing.
//   * the gated tile (64 x 192, hi and lo: 96 KB) is written over the A
//     ring, which is exactly its size, and the second product streams its
//     weights through the same ring; its sums feed the masked state update
//     from registers.
//   * the tensor cores' float32 accumulation truncates, so 3 x 120 products
//     into one accumulator drift toward zero (15x the error of float32
//     FFMA against float64, measured on an H100): each chunk of 4 k-steps
//     (12 products) starts a fresh partial, which is added into a float32
//     sum with rounding to nearest, so the drift of one partial is not
//     carried into the next.

#include "sm90.cuh"

namespace {

constexpr int kCh = 192;                      // WN channels (h)
constexpr int kTile = 64;                     // time steps per block (wgmma M)
constexpr int kConsumers = 2;                 // consumer warpgroups
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kCluster = 2;                   // blocks sharing each weight stage
constexpr int kPlanes = 2;                    // TF32 hi and lo
constexpr int kKStep = 8;                     // K per wgmma k-step
constexpr int kKC = 32;                       // K columns per A chunk (128 bytes)
constexpr int kChunksPerTap = kCh / kKC;      // 6
constexpr int kAStages = kChunksPerTap;       // A ring: as many chunks as the gated tile has
constexpr int kAChunkBytes = kTile * 128;     // one A chunk: 64 rows of one 128-byte swizzle row
constexpr int kARegion = kPlanes * kAStages * kAChunkBytes;  // A rings, later the gated tile
constexpr int kSplitWarps = 2;                // producer warps that split A chunks into TF32 planes
constexpr int kNW = kCh;                      // columns per consumer, both products
constexpr int kBStageBytes = kConsumers * kPlanes * kNW * 32;  // one k-step of either product
constexpr int kBStages = 5;
constexpr size_t kSmemBytes =
    1024 + kARegion + kBStages * kBStageBytes + (3 * kAStages + 2 * kBStages) * 8;
constexpr int kMaxTaps = 5;
static_assert(kSmemBytes <= 232448, "over the shared memory a block can have");
static_assert(kBStageBytes == 24576 && kSmemBytes == 222432, "f32 plan");
static_assert(kKC / kKStep == 4, "an A chunk is four k-steps");

enum Mode { kMid = 0, kFirst = 1, kLast = 2, kFirstLast = 3 };

// ---- wgmma m64n192k8 TF32 (sm90.cuh has the other widths), d = a * b
// when `accumulate` is 0, d += a * b otherwise

__device__ __forceinline__ void wgmma_n192(float (&d)[96], uint64_t desc_a, uint64_t desc_b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95},"
      " %96, %97, p, 1, 1;\n}\n"
      : WG_D64(0), WG_D16(64), WG_D16(80)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

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

// acc (+)= a * b for one k-step, as (a_hi + a_lo) * (b_hi + b_lo) less the
// a_lo * b_lo term; `fresh` starts acc over
__device__ __forceinline__ void mma_step(float (&d)[kNW / 2], uint32_t a_hi, uint32_t a_lo,
                                         uint32_t b_hi, uint32_t b_lo, bool fresh) {
  wgmma_n192(d, desc_a_sw128(a_lo), desc_kmajor(b_hi), fresh ? 0 : 1);
  wgmma_n192(d, desc_a_sw128(a_hi), desc_kmajor(b_lo), 1);
  wgmma_n192(d, desc_a_sw128(a_hi), desc_kmajor(b_hi), 1);
}

// sum += part, in float32 with rounding to nearest
__device__ __forceinline__ void add_into(float (&sum)[kNW / 2], const float (&part)[kNW / 2]) {
#pragma unroll
  for (int i = 0; i < kNW / 2; ++i) sum[i] += part[i];
}

// byte offset of channel pc in row `row` of the A chunks' swizzled layout
__device__ __forceinline__ int swizzled(int pc, int row) {
  const int in_row = (pc % kKC) * 4;
  return (pc / kKC) * kAChunkBytes + row * 128 + (((in_row / 16) ^ (row % 8)) * 16) +
         in_row % 16;
}

// no division subroutine (a call would serialize the wgmma pipeline); a few
// ulp, far below the 3xTF32 products' error
__device__ __forceinline__ float sigmoid(float x) { return __fdividef(1.0f, 1.0f + __expf(-x)); }

struct Args {
  const float* x;
  const float* skip;
  const float* wpack;
  const float* b_in;
  const float* b_rs;
  const float* g;  // the row's speaker bias [2h] at g + b * g_stride, or null
  long long g_stride;
  const float* mask;
  long long mask_sb, mask_st;
  float* x_out;
  float* skip_out;
  int T, taps, dil;
};

template <int MODE>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
flow_wn_kernel(const __grid_constant__ CUtensorMap tmap_x, const __grid_constant__ Args args) {
  constexpr bool kFirstMode = MODE == kFirst || MODE == kFirstLast;
  constexpr bool kLastMode = MODE == kLast || MODE == kFirstLast;
  const int T = args.T;
  const int t0 = blockIdx.x * kTile;
  const int batch = blockIdx.y;
  const size_t row0 = static_cast<size_t>(batch) * T;

  // ---- a pair of tiles masked on every row: zeros, no products (both
  // blocks of the cluster read the same 2 * kTile rows, so both leave)
  {
    const int pos = (blockIdx.x / kCluster) * kCluster * kTile + threadIdx.x;
    const bool valid = threadIdx.x < kCluster * kTile && pos < T &&
                       args.mask[batch * args.mask_sb + pos * args.mask_st] != 0.0f;
    if (!__syncthreads_or(valid)) {
      const int rows = min(kTile, T - t0);
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int u = threadIdx.x; u < rows * kCh / 4; u += kThreads) {
        const size_t at = (row0 + t0) * kCh + 4 * static_cast<size_t>(u);
        if (!kLastMode) *reinterpret_cast<float4*>(args.x_out + at) = zero;
        *reinterpret_cast<float4*>(args.skip_out + at) = zero;
      }
      return;
    }
  }

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // 128-byte swizzle atoms want 1 KB alignment
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t a_hi = base;                             // kAStages chunks: raw, then hi
  const uint32_t a_lo = base + kAStages * kAChunkBytes;   // kAStages chunks of lo
  const uint32_t b_ring = base + kARegion;
  const uint32_t bars = b_ring + kBStages * kBStageBytes;
  auto full_b = [&](int i) { return bars + 8 * i; };
  auto empty_b = [&](int i) { return bars + 8 * (kBStages + i); };
  auto full_a = [&](int i) { return bars + 8 * (2 * kBStages + i); };
  auto ready_a = [&](int i) { return bars + 8 * (2 * kBStages + kAStages + i); };
  auto empty_a = [&](int i) { return bars + 8 * (2 * kBStages + 2 * kAStages + i); };

  const int n_chunks = args.taps * kChunksPerTap;
  const int steps1 = n_chunks * (kKC / kKStep);  // k-steps (and weight stages) of product 1
  const int n_stages = steps1 + kCh / kKStep;
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
    // ---- producer warpgroup: thread 0 streams the weights, thread 32 the
    // activations, warps 2-3 split each activation chunk into TF32 planes
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int warp = threadIdx.x / 32;
    if (threadIdx.x == 0) {  // the weight stages, multicast over the cluster
      const uint32_t rank = cluster_rank();
      constexpr int kPart = kBStageBytes / kCluster;
      const char* src = reinterpret_cast<const char*>(args.wpack) + rank * kPart;
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
    } else if (threadIdx.x == 32) {  // the A chunks: tap j, channels [32 q, 32 q + 32)
      const int half = (args.taps - 1) / 2;
      int a_stage = 0;
      uint32_t a_phase = 0;
      for (int chunk = 0; chunk < n_chunks; ++chunk) {
        const int tap = chunk / kChunksPerTap;
        mbar_wait(empty_a(a_stage), a_phase ^ 1);
        mbar_expect_tx(full_a(a_stage), kAChunkBytes);
        tma_load_3d(a_hi + a_stage * kAChunkBytes, &tmap_x, full_a(a_stage),
                    kKC * (chunk % kChunksPerTap), t0 + (tap - half) * args.dil, batch);
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
        float4* lo = reinterpret_cast<float4*>(smem + (kAStages + a_stage) * kAChunkBytes);
#pragma unroll 2
        for (int u = lane; u < kAChunkBytes / 16; u += 32 * kSplitWarps) {
          const float4 v = hi[u];
          const float4 vh = make_float4(to_tf32(v.x), to_tf32(v.y), to_tf32(v.z), to_tf32(v.w));
          hi[u] = vh;
          lo[u] = make_float4(to_tf32(v.x - vh.x), to_tf32(v.y - vh.y), to_tf32(v.z - vh.z),
                              to_tf32(v.w - vh.w));
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

    // ---- first product: a = sum_j x_j @ Wj + b_in (+ g).  Accumulator
    // chunk i < 12 holds tanh columns 96c + 8i + ..., chunk i + 12 their
    // sigmoid partners (h + the same channel), at the same fragment
    // positions.  The tensor cores' float32 accumulation truncates, so a
    // long chain of products into one accumulator drifts toward zero: each
    // A chunk's 12 products start a fresh partial (acc), which is added
    // into the sum in float32 with rounding to nearest.
    float acc[kNW / 2], sum[kNW / 2];
    const float* gb = args.g ? args.g + batch * args.g_stride : nullptr;
#pragma unroll
    for (int i = 0; i < kNW / 8; ++i) {
      const int col = (i < 12 ? 0 : kCh - 96) + 96 * c + 8 * i + 2 * t;
      float2 bv = ldg2(args.b_in + col);
      if (gb) {
        const float2 gv = ldg2(gb + col);
        bv = make_float2(bv.x + gv.x, bv.y + gv.y);
      }
      sum[4 * i] = bv.x; sum[4 * i + 1] = bv.y; sum[4 * i + 2] = bv.x; sum[4 * i + 3] = bv.y;
    }
#pragma unroll
    for (int i = 0; i < kNW / 2; ++i) acc[i] = 0.0f;  // each chunk's first product overwrites it
    fence_acc(acc);
    // Up to two wgmma groups in flight per warpgroup within an A chunk; a
    // weight stage is released once the group after it has been issued and
    // it is done, an A chunk once its last group is done.
    for (int chunk = 0; chunk < n_chunks; ++chunk) {
      mbar_wait(ready_a(a_stage), a_phase);  // the split warps' planes
#pragma unroll
      for (int kk = 0; kk < kKC / kKStep; ++kk) {
        mbar_wait(full_b(b_stage), b_phase);
        const uint32_t blk = b_ring + b_stage * kBStageBytes + c * kPlanes * (kNW * 32);
        const uint32_t aoff = a_stage * kAChunkBytes + 32 * kk;
        wgmma_fence();
        mma_step(acc, a_hi + aoff, a_lo + aoff, blk, blk + kNW * 32, kk == 0);
        wgmma_commit();
        if (kk < kKC / kKStep - 1) {
          wgmma_wait<1>();
          if (kk > 0) release_b(prev(b_stage, kBStages));
        } else {
          wgmma_wait<0>();
          release_b(prev(b_stage, kBStages));
          release_b(b_stage);
          if (leader) mbar_arrive(empty_a(a_stage));
        }
        if (++b_stage == kBStages) { b_stage = 0; b_phase ^= 1; }
      }
      fence_acc(acc);
      add_into(sum, acc);
      if (++a_stage == kAStages) { a_stage = 0; a_phase ^= 1; }
    }

    // ---- gate, in registers: gv[4i + 2hr + e] is channel 96c + 8i + 2t + e
    // of row r0 + 8hr
    float gv[kNW / 4];
#pragma unroll
    for (int i = 0; i < 12; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        gv[4 * i + e] = tanhf(sum[4 * i + e]) * sigmoid(sum[4 * (i + 12) + e]);
    }

    // ---- the gated tile over the A ring (idle now) in the A chunks'
    // swizzled layout, as TF32 hi and lo planes: each consumer its 96
    // channels, chunks 3c to 3c + 2
    named_sync_consumers();  // the A ring is no longer read
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      const int pc = 96 * c + 8 * i + 2 * t;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float v0 = gv[4 * i + 2 * hr], v1 = gv[4 * i + 2 * hr + 1];
        const int off = swizzled(pc, r0 + 8 * hr);
        const float h0 = to_tf32(v0), h1 = to_tf32(v1);
        *reinterpret_cast<float2*>(smem + off) = make_float2(h0, h1);
        *reinterpret_cast<float2*>(smem + kAStages * kAChunkBytes + off) =
            make_float2(to_tf32(v0 - h0), to_tf32(v1 - h1));
      }
    }
    fence_proxy_async();
    named_sync_consumers();

    // ---- second product: rs = act @ Wrs + b_rs, consumer c owning rs
    // columns [192c, 192c + 192): the res half or the skip half; each gated
    // chunk's 12 products a fresh partial, as in the first
#pragma unroll
    for (int i = 0; i < kNW / 8; ++i) {
      const float2 bv = ldg2(args.b_rs + c * kNW + 8 * i + 2 * t);
      sum[4 * i] = bv.x; sum[4 * i + 1] = bv.y; sum[4 * i + 2] = bv.x; sum[4 * i + 3] = bv.y;
    }
#pragma unroll 1
    for (int q = 0; q < kChunksPerTap; ++q) {
#pragma unroll
      for (int kk = 0; kk < kKC / kKStep; ++kk) {
        mbar_wait(full_b(b_stage), b_phase);
        const uint32_t blk = b_ring + b_stage * kBStageBytes + c * kPlanes * (kNW * 32);
        const uint32_t aoff = q * kAChunkBytes + 32 * kk;
        wgmma_fence();
        mma_step(acc, a_hi + aoff, a_lo + aoff, blk, blk + kNW * 32, kk == 0);
        wgmma_commit();
        if (kk < kKC / kKStep - 1) {
          wgmma_wait<1>();
          if (kk > 0) release_b(prev(b_stage, kBStages));
        } else {
          wgmma_wait<0>();
          release_b(prev(b_stage, kBStages));
          release_b(b_stage);
        }
        if (++b_stage == kBStages) { b_stage = 0; b_phase ^= 1; }
      }
      fence_acc(acc);
      add_into(sum, acc);
    }

    // ---- epilogue: each thread owns (row, column pair) elements of rs
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int pos = t0 + r0 + 8 * hr;
      if (pos >= T) continue;
      const float m = args.mask[batch * args.mask_sb + pos * args.mask_st];
      const size_t at = (row0 + pos) * kCh;
#pragma unroll
      for (int i = 0; i < kNW / 8; ++i) {
        const float2 v = make_float2(sum[4 * i + 2 * hr], sum[4 * i + 2 * hr + 1]);
        const int ch = 8 * i + 2 * t;
        if (c == 0) {  // res half: the masked residual update
          if (!kLastMode) {
            const float2 xv = load2(args.x + at + ch);
            store2(args.x_out + at + ch, make_float2((xv.x + v.x) * m, (xv.y + v.y) * m));
          }
        } else {  // skip half
          float2 s = v;
          if (!kFirstMode) {
            const float2 old = load2(args.skip + at + ch);
            s = make_float2(old.x + v.x, old.y + v.y);
          }
          if (kLastMode) s = make_float2(s.x * m, s.y * m);
          store2(args.skip_out + at + ch, s);
        }
      }
    }
  }
}

// ---- host side

// [B, T, 192] -> a map whose box is 128 bytes of channels x kTile steps of
// one batch row, 128-byte swizzled, zero outside the tensor
bool encode_activations(CUtensorMap* map, const float* base, int T, int B) {
  auto encode = tensor_map_encoder();
  if (!encode) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)kCh, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)kCh * sizeof(float),
                                 (cuuint64_t)kCh * sizeof(float) * T};
  const cuuint32_t box[3] = {(cuuint32_t)kKC, kTile, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, tensor_map_type<float>(), 3, const_cast<float*>(base), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int MODE>
int launch(const Args& a, int B, cudaStream_t stream) {
  CUtensorMap map_x;
  if (!encode_activations(&map_x, a.x, a.T, B)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flow_wn_kernel<MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (a.T + kTile - 1) / kTile;
  const dim3 grid((tiles + kCluster - 1) / kCluster * kCluster, B);
  flow_wn_kernel<MODE><<<grid, kThreads, kSmemBytes, stream>>>(map_x, a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [B, T, 192], skip [B, T, 192] (not read on a first layer), mask [B, T]
// at mask + b * mask_sb + t * mask_st; wpack: the layer's weights as TF32
// hi/lo stages (ops/flow_wn.py::pack_stack); b_in [384], b_rs [384]; g: the
// rows' speaker biases [384] at g + b * g_stride, or null.  mode 0-3:
// middle, first, last, first and last.  Writes skip_out [B, T, 192] and,
// unless last, x_out [B, T, 192].  Returns the CUDA error code of the
// launch (0 on success).
int flow_wn_f32(const float* x, const float* skip, const float* wpack, const float* b_in,
                const float* b_rs, const float* g, long long g_stride, const float* mask,
                long long mask_sb, long long mask_st, float* x_out, float* skip_out, int B, int T,
                int taps, int dil, int mode, void* stream) {
  const bool last = mode == kLast || mode == kFirstLast;
  const bool first = mode == kFirst || mode == kFirstLast;
  if (B < 1 || B > 65535 || T < 1 || taps < 1 || taps > kMaxTaps || taps % 2 == 0 || dil < 1 ||
      mode < 0 || mode > kFirstLast || !x || !wpack || !b_in || !b_rs || !mask || !skip_out ||
      (!last && !x_out) || (!first && !skip))
    return (int)cudaErrorInvalidValue;
  const Args a{x, skip, wpack, b_in, b_rs, g, g_stride, mask, mask_sb, mask_st, x_out, skip_out,
               T, taps, dil};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kMid: return launch<kMid>(a, B, s);
    case kFirst: return launch<kFirst>(a, B, s);
    case kLast: return launch<kLast>(a, B, s);
    default: return launch<kFirstLast>(a, B, s);
  }
}

// dynamic shared memory of a block, bytes
int flow_wn_smem_bytes() { return (int)kSmemBytes; }

const char* flow_wn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
