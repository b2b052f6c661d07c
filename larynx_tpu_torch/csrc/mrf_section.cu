// One resblock unit of a HiFi-GAN multi-receptive-field (MRF) section for
// Hopper (sm_90a) in f32: wgmma from shared memory, weights by TMA.  (The
// bf16 section is csrc/mrf_bf16.cu.)
//
// Replaces both TPU kernels of larynx_tpu/ops/mrf_block.py:
//   K1  fused_mrf, dense branch      (_make_kernel,        pallas_call at :272)
//   K2  _fused_mrf_packed, C < 128   (_make_packed_kernel, pallas_call at :382)
// K2's time packing only fills the TPU's 128 lanes; here one kernel,
// templated on C in {8, 16, 32, 64, 128} and on convs_per_unit in {1, 2},
// takes every width.  The section runs as
// one launch per resblock unit (ops/mrf_block.py::mrf_section, 9 per
// universal_large stage):
//   ResBlock1 (convs_per_unit=2): h_new = h + conv_k(lrelu(conv_{k,d}(lrelu(h))))
//   ResBlock2 (convs_per_unit=1): h_new = h + conv_{k,d}(lrelu(h))
// for h [B, T, C] (channels-last, contiguous), lrelu slope 0.1, every conv
// zero-padded 'same' (the first conv's output is zero outside [0, T) before
// the second conv reads it).  h_new goes to a scratch buffer, or, on a
// chain's last unit, into the section's output: out = h_new (first chain),
// out = out + h_new (later chains), times 1/n_chains on the last chain.
//
// What bounds it: operations.  A unit costs 2 * C^2 * k * convs FLOPs per
// time step against 2-3 * C * 4 bytes of activation I/O (~700 FLOP/byte at
// C=128, k=11).  Each product runs as three TF32 tensor-core products
// (3xTF32: a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, f32 accumulate).  The design:
//
//   * one block per (time tile, batch row): a producer warpgroup and two
//     consumer warpgroups.  The first conv computes M = 128 rows (64 per
//     consumer, wgmma m64nC, N = C); the second conv's useful rows are
//     M - (k - 1), so the tile stride is 126, 122 or 118 at k = 3, 7, 11
//     (M at convs_per_unit=1): ~1.05x recompute where the fused section
//     carried a 60-row halo on a 96-row tile (~1.5x).
//   * A operands: the raw input tile, M + (k - 1) * d rows, arrives once by
//     TMA from a 3-D tensor map [B, T, C], one box of 16 bytes of channels
//     (4 f32) x all rows per channel group, so shared memory
//     holds it channel-group-major ([C/g][rows][g]): the hardware's zero
//     fill is the conv's padding at both ends, never reading the
//     neighbouring batch row.  All 384 threads then apply lrelu once, in
//     place, and split it into exact TF32 hi and lo planes (lrelu(0)
//     = 0, so no mask).  In that layout a row is 16 bytes, so tap j's A
//     operand, the tile shifted by j * d rows, is a wgmma descriptor 16 * j
//     * d bytes further (K-major, no swizzle, core matrices of 8 contiguous
//     rows, the two 16-byte K halves of a k-step one channel-group plane
//     apart): no copy and no split per tap.  A k-step is 32 bytes of K
//     (8 TF32 values).
//   * B operands (weights) are packed once at load (ops/mrf_block.py::
//     pack_stages) in wgmma core-matrix order, one stage per k-step, i.e.
//     per (tap, 8 input channels) as exact TF32 hi and lo planes (8 KB at
//     C=128).  One
//     producer thread streams them by bulk TMA into an mbarrier ring as deep
//     as the shared memory left allows (5 stages at C=128, k=11, d=5).
//   * the first conv's output goes from registers, zeroed outside [0, T),
//     through lrelu and the TF32 split into the same layout over
//     the raw tile's (both consumers are done reading it by then): the
//     second conv's A operand.  Its residual is read back from global
//     memory (L2) in the epilogue.
//   * one accumulator array, operands only from shared memory and no calls
//     in the consumers, so ptxas keeps the wgmma pipeline asynchronous: one
//     group of products in flight while the next is issued.
//   * at C <= 64 two blocks share an SM where their shared memory allows,
//     so one block's prologue and epilogue overlap the other's products.
//
// Shared memory at C=128, (k, d) = (11, 5), f32: tile planes 2 x 184 x 512
// B = 184 KB, weight ring 5 x 8 KB: 226 KB of the 227 KB a block can have;
// ResBlock2's widest unit, (7, 12), has 200 rows and a 3-stage ring.

#include "sm90.cuh"

namespace {

constexpr int kM = 128;               // first-conv rows per block (two wgmma M = 64)
constexpr int kConsumers = 2;         // consumer warpgroups
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kMaxBStages = 16;
constexpr int kBars = 1 + 2 * kMaxBStages;
constexpr int kMaxRows = 256;         // raw tile rows: the TMA box limit
constexpr size_t kMaxSmem = 232448;   // dynamic shared memory a block can have
constexpr size_t kPairSmem = 115712;  // ... two blocks of an SM can have each
constexpr float kSlope = 0.1f;
constexpr int kStep = 8;              // K per wgmma k-step: 32 bytes of TF32
constexpr int kGroup = 4;             // channels per 16-byte channel group of the tile

enum Mode { kToScratch = 0, kOutStore = 1, kOutAdd = 2 };

__host__ __device__ constexpr int pad8(int rows) { return (rows + 7) & ~7; }

// one weight stage: (tap, one k-step of input channels) x C outputs, TF32
// hi and lo planes
template <int C>
__host__ __device__ constexpr int b_bytes() { return 2 * kStep * C * 4; }

// the tile's TF32 hi and lo planes, [C/4][pad8(rows)][4] each
template <int C>
__host__ __device__ constexpr size_t a_bytes(int rows) {
  return (size_t)2 * pad8(rows) * C * 4;
}

// weight ring depth: as deep as the block's shared memory allows (at
// C <= 64 within half an SM where 4 stages still fit), at most kMaxBStages
template <int C>
constexpr int b_stages(int rows) {
  const size_t fixed = 1024 + a_bytes<C>(rows) + 8 * kBars;
  const size_t budget = C <= 64 && fixed + 4 * b_bytes<C>() <= kPairSmem ? kPairSmem : kMaxSmem;
  if (fixed > budget) return 0;
  const size_t n = (budget - fixed) / b_bytes<C>();
  return n < kMaxBStages ? (int)n : kMaxBStages;
}

template <int C>
constexpr size_t smem_bytes(int rows) {
  return 1024 + a_bytes<C>(rows) + 8 * kBars + (size_t)b_stages<C>(rows) * b_bytes<C>();
}

__device__ __forceinline__ float lrelu(float a) { return fmaxf(a, kSlope * a); }

// wgmma descriptor of a K-major operand without swizzle whose 8-row core
// matrices are contiguous (stride byte offset 128) and whose two K halves
// of a k-step lie `lbo` bytes apart (leading byte offset)
__device__ __forceinline__ uint64_t desc_rows(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(128 >> 4) << 32);
}

// acc += a * b for one k-step, as (a_hi + a_lo) * (b_hi + b_lo) less the
// a_lo * b_lo term
template <int N>
__device__ __forceinline__ void mma_step(float (&d)[N / 2], uint32_t a_hi, uint32_t a_lo,
                                         uint32_t lbo, uint32_t b_hi, uint32_t b_lo) {
  wgmma_tf32<N>(d, desc_rows(a_lo, lbo), desc_kmajor(b_hi));
  wgmma_tf32<N>(d, desc_rows(a_hi, lbo), desc_kmajor(b_lo));
  wgmma_tf32<N>(d, desc_rows(a_hi, lbo), desc_kmajor(b_hi));
}

__device__ __forceinline__ void named_sync_consumers() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kConsumers) : "memory");
}

template <int C, int CPU>
__global__ void __launch_bounds__(kThreads, C <= 64 ? 2 : 1)
mrf_unit_kernel(const __grid_constant__ CUtensorMap tmap_in, const float* __restrict__ h_in,
                const float* __restrict__ wpack, const float* __restrict__ bias,
                float* __restrict__ dst, int T, int k, int d, int rows, int depth, int mode,
                float scale) {
  constexpr int B_BYTES = b_bytes<C>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_s = smem_u32(smem_raw);
  const uint32_t base = (raw_s + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw_s);
  const int rp = pad8(rows);                        // row pitch of a channel-group plane
  const uint32_t plane = rp * 16;                   // bytes of one channel-group plane
  const uint32_t a_hi = base, a_lo = base + (C / kGroup) * plane;
  const uint32_t b_ring = base + static_cast<uint32_t>(a_bytes<C>(rows));
  const uint32_t bars = b_ring + depth * B_BYTES;
  const uint32_t raw_full = bars;
  auto full_b = [&](int i) { return bars + 8 * (1 + i); };
  auto empty_b = [&](int i) { return bars + 8 * (1 + kMaxBStages + i); };

  const int half = (k - 1) / 2;
  const int stride = CPU == 2 ? kM - (k - 1) : kM;  // output rows per block
  const int t0 = blockIdx.x * stride;
  const int o0 = CPU == 2 ? t0 - half : t0;         // position of the first conv's row 0
  const int batch = blockIdx.y;
  const int steps = k * (C / kStep);                // k-steps (and weight stages) per conv
  const int total_steps = CPU * steps;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(raw_full, 1);
    for (int i = 0; i < depth; ++i) {
      mbar_init(full_b(i), 1);
      mbar_init(empty_b(i), kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  int bs = 0;  // thread 0: the next weight stage's slot and parity
  uint32_t bp = 0;
  auto load_b = [&](int s) {
    mbar_expect_tx(full_b(bs), B_BYTES);
    bulk_load(b_ring + bs * B_BYTES, wpack + static_cast<size_t>(s) * (B_BYTES / 4), B_BYTES,
              full_b(bs));
    if (++bs == depth) { bs = 0; bp ^= 1; }
  };
  const int first = depth < total_steps ? depth : total_steps;
  if (threadIdx.x == 0) {
    // the raw tile, input rows from o0 - half * d, one box per channel group
    mbar_expect_tx(raw_full, rows * C * 4);
    for (int q = 0; q < C / kGroup; ++q)
      tma_load_3d(a_hi + q * plane, &tmap_in, raw_full, kGroup * q, o0 - half * d, batch);
    for (int s = 0; s < first; ++s) load_b(s);  // the ring is empty: no waits
  }

  // every thread: the raw tile -> lrelu, TF32 hi in place and a lo plane
  mbar_wait(raw_full, 0);
  {
    float4* hi = reinterpret_cast<float4*>(smem);
    float4* lo = reinterpret_cast<float4*>(smem + (a_lo - base));
#pragma unroll 4
    for (int u = threadIdx.x; u < (C / 4) * rp; u += kThreads) {
      const float4 x = hi[u];
      const float4 a = make_float4(lrelu(x.x), lrelu(x.y), lrelu(x.z), lrelu(x.w));
      const float4 ah = make_float4(to_tf32(a.x), to_tf32(a.y), to_tf32(a.z), to_tf32(a.w));
      hi[u] = ah;
      lo[u] = make_float4(to_tf32(a.x - ah.x), to_tf32(a.y - ah.y), to_tf32(a.z - ah.z),
                          to_tf32(a.w - ah.w));
    }
  }
  fence_proxy_async();
  __syncthreads();

  if (wg == 0) {
    if (threadIdx.x == 0) {  // the rest of the weight stages of both convs
      for (int s = first; s < total_steps; ++s) {
        mbar_wait(empty_b(bs), bp ^ 1);
        load_b(s);
      }
    }
    return;
  }

  // ---- consumers: consumer c owns rows [64c, 64c + 64) of every conv
  const int c = wg - 1;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 64 * c + 16 * ((threadIdx.x / 32) % 4) + g;  // this thread's rows r0, r0 + 8
  const bool leader = threadIdx.x % 128 == 0;
  int cs = 0;  // the next weight stage's slot and parity
  uint32_t cp = 0;
  float acc[C / 2];  // acc[4i + 2hr + e]: row r0 + 8hr, channel 8i + 2t + e

#pragma unroll 1
  for (int conv = 0; conv < CPU; ++conv) {
    const int dd = conv == 0 ? d : 1;
#pragma unroll
    for (int i = 0; i < C / 8; ++i) {
      const float2 bv = ldg2(bias + conv * C + 8 * i + 2 * t);
      acc[4 * i] = bv.x; acc[4 * i + 1] = bv.y; acc[4 * i + 2] = bv.x; acc[4 * i + 3] = bv.y;
    }
    fence_acc(acc);
    // k-step s: tap s / (C/8), channels [8 * (s % (C/8)), +8); one group of
    // products in flight while the next is issued, a weight stage released
    // once its group is done
    int prev = 0;
    for (int s = 0; s < steps; ++s) {
      const int tap = s / (C / kStep), ks = s % (C / kStep);
      mbar_wait(full_b(cs), cp);
      const uint32_t a = 2 * ks * plane + (tap * dd + 64 * c) * 16;
      const uint32_t b = b_ring + cs * B_BYTES;
      wgmma_fence();
      mma_step<C>(acc, a_hi + a, a_lo + a, plane, b, b + B_BYTES / 2);
      wgmma_commit();
      wgmma_wait<1>();
      if (s > 0 && leader) mbar_arrive(empty_b(prev));
      prev = cs;
      if (++cs == depth) { cs = 0; cp ^= 1; }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (leader) mbar_arrive(empty_b(prev));
    if (CPU == 2 && conv == 0) {
      // the first conv's rows, zero outside [0, T), lrelu, in the tile's
      // layout over it once both consumers are done reading it
      named_sync_consumers();
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = r0 + 8 * hr;
        const int pos = o0 + row;
        const bool inside = pos >= 0 && pos < T;
#pragma unroll
        for (int i = 0; i < C / 8; ++i) {
          const int ch = 8 * i + 2 * t;
          const uint32_t off = (ch / kGroup) * plane + row * 16 + (ch % kGroup) * 4;
          const float x0 = inside ? lrelu(acc[4 * i + 2 * hr]) : 0.0f;
          const float x1 = inside ? lrelu(acc[4 * i + 2 * hr + 1]) : 0.0f;
          const float h0 = to_tf32(x0), h1 = to_tf32(x1);
          *reinterpret_cast<float2*>(smem + off) = make_float2(h0, h1);
          *reinterpret_cast<float2*>(smem + (a_lo - base) + off) =
              make_float2(to_tf32(x0 - h0), to_tf32(x1 - h1));
        }
      }
      fence_proxy_async();
      named_sync_consumers();
    }
  }

  // ---- epilogue: h_new = h + conv output on rows [0, stride) of the tile
  const size_t row0 = static_cast<size_t>(batch) * T;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + 8 * hr;
    const int pos = t0 + row;
    if (row >= stride || pos >= T) continue;
    const size_t e0 = (row0 + pos) * C;
#pragma unroll
    for (int i = 0; i < C / 8; ++i) {
      const size_t e = e0 + 8 * i + 2 * t;
      const float2 hv = ldg2(h_in + e);
      const float2 v = make_float2(hv.x + acc[4 * i + 2 * hr], hv.y + acc[4 * i + 2 * hr + 1]);
      if (mode == kToScratch) {
        store2(dst + e, v);
      } else {
        float2 o = v;
        if (mode == kOutAdd) {
          const float2 old = load2(dst + e);
          o = make_float2(old.x + v.x, old.y + v.y);
        }
        store2(dst + e, make_float2(o.x * scale, o.y * scale));
      }
    }
  }
}

// ---- host side

// [B, T, C] -> a map whose box is 16 bytes of channels x `rows` steps of one
// batch row (rows x 16 bytes in shared memory), zero outside the tensor
bool encode_input(CUtensorMap* map, const float* base, int C, int T, int B, int rows) {
  auto encode = tensor_map_encoder();
  if (!encode) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)C * 4, (cuuint64_t)C * 4 * T};
  const cuuint32_t box[3] = {(cuuint32_t)kGroup, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct UnitArgs {
  const float* h_in;
  const float* wpack;
  const float* bias;
  float* dst;
  int B, T, k, d, mode;
  float scale;
  cudaStream_t stream;
};

template <int C, int CPU>
int launch(const UnitArgs& a) {
  const int rows = kM + (a.k - 1) * a.d;
  const int depth = b_stages<C>(rows);
  const size_t smem = smem_bytes<C>(rows);
  if (rows > kMaxRows || depth < 2 || smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  if (!encode_input(&map, a.h_in, C, a.T, a.B, rows)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(mrf_unit_kernel<C, CPU>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int stride = CPU == 2 ? kM - (a.k - 1) : kM;
  const dim3 grid((a.T + stride - 1) / stride, a.B);
  mrf_unit_kernel<C, CPU><<<grid, kThreads, smem, a.stream>>>(
      map, a.h_in, a.wpack, a.bias, a.dst, a.T, a.k, a.d, rows, depth, a.mode, a.scale);
  return (int)cudaGetLastError();
}

template <int CPU>
int dispatch_c(int C, const UnitArgs& a) {
  switch (C) {
    case 8: return launch<8, CPU>(a);
    case 16: return launch<16, CPU>(a);
    case 32: return launch<32, CPU>(a);
    case 64: return launch<64, CPU>(a);
    case 128: return launch<128, CPU>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

long long smem_of(int C, int rows) {
  switch (C) {
    case 8: return (long long)smem_bytes<8>(rows);
    case 16: return (long long)smem_bytes<16>(rows);
    case 32: return (long long)smem_bytes<32>(rows);
    case 64: return (long long)smem_bytes<64>(rows);
    case 128: return (long long)smem_bytes<128>(rows);
    default: return 0;
  }
}

int stages_of(int C, int rows) {
  switch (C) {
    case 8: return b_stages<8>(rows);
    case 16: return b_stages<16>(rows);
    case 32: return b_stages<32>(rows);
    case 64: return b_stages<64>(rows);
    case 128: return b_stages<128>(rows);
    default: return 0;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of a block whose raw tile holds `rows` steps, and
// its weight ring's depth; 0 for an unsupported C.
long long mrf_unit_smem_bytes(int C, int rows) { return smem_of(C, rows); }
int mrf_unit_b_stages(int C, int rows) { return stages_of(C, rows); }

// One resblock unit: h_in, dst [B, T, C]; wpack: the unit's convs as TF32
// hi/lo weight stages (ops/mrf_block.py::pack_stages); bias [convs, C].
// mode 0 writes h_new to dst; mode 1 writes h_new * scale; mode 2 writes
// (dst + h_new) * scale.  dst must not alias h_in.
// Returns the CUDA error code of the launch (0 on success).
int mrf_unit_f32(const float* h_in, const float* wpack, const float* bias, float* dst, int B,
                 int T, int C, int convs_per_unit, int k, int d, int mode, float scale,
                 void* stream) {
  const UnitArgs a{h_in, wpack, bias, dst, B, T, k, d, mode, scale,
                   static_cast<cudaStream_t>(stream)};
  if (a.B < 1 || a.B > 65535 || a.T < 1 || a.k < 1 || a.k % 2 == 0 || a.d < 1 ||
      a.mode < kToScratch || a.mode > kOutAdd || !(a.scale > 0.0f))
    return (int)cudaErrorInvalidValue;
  if (convs_per_unit == 2) {
    if (a.k - 1 >= kM) return (int)cudaErrorInvalidValue;
    return dispatch_c<2>(C, a);
  }
  if (convs_per_unit == 1) return dispatch_c<1>(C, a);
  return (int)cudaErrorInvalidValue;
}

const char* mrf_section_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
