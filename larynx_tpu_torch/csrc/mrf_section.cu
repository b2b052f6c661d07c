// Fused HiFi-GAN multi-receptive-field (MRF) section for Hopper (sm_90a), f32.
//
// Replaces both TPU kernels of larynx_tpu/ops/mrf_block.py:
//   K1  fused_mrf, dense branch      (_make_kernel,        pallas_call at :272)
//   K2  _fused_mrf_packed, C < 128   (_make_packed_kernel, pallas_call at :382)
// K2's time packing only fills the TPU's 128 lanes; here one kernel,
// templated on C in {8, 16, 32, 64, 128} and on convs_per_unit in {1, 2},
// computes the whole averaged section of one generator stage in one launch.
//
// What it computes, for x [B, T, C] (channels-last, contiguous):
//   for each resblock (chain) r with kernel k_r and dilations d_r[u]:
//     h = x
//     for each unit u:
//       ResBlock1 (convs_per_unit=2): h += conv(lrelu(conv(lrelu(h), d)), 1)
//       ResBlock2 (convs_per_unit=1): h += conv(lrelu(h), d)
//     total += h
//   out = total / n_chains
// with lrelu slope 0.1 and every conv zero-padded 'same'.  Positions outside
// [0, T) are re-zeroed after every conv, so a haloed tile reproduces the
// per-conv zero padding exactly.
//
// What bounds it: operations.  A time step costs about 2 * C^2 * 126 FLOPs
// (ResBlock1 (3,7,11)) against 2 * C * 4 bytes of activation I/O, i.e.
// ~4000 FLOP/byte at C=128, far above the H100's ridge.  So the design
// keeps every intermediate on chip and feeds the tensor cores:
//
//   * one block per (time tile, batch row) holds the tile plus the
//     section's halo (60 samples at (3,7,11)x(1,3,5)) in shared memory, in
//     two buffers: h (the chain's residual stream) and t (a conv's output);
//     the buffers are anchored at the tile origin and each conv shrinks the
//     valid range by its own halo.  The wrapper picks the longest tile the
//     shared memory holds (96 at C=128).  Per tile, x is read once per chain
//     (from L2) and out written once; the halo is recomputed (~1.5x the
//     useful work at C=128; less at narrower C).
//   * each conv is k shifted [rows, C] x [C, C] products, run as
//     mma.sync m16n8k8 TF32 with a 3xTF32 split (a*b ~ a_hi*b_hi + a_hi*b_lo
//     + a_lo*b_hi, f32 accumulate), which keeps f32-level accuracy at three
//     tensor-core products per FMA -- 495/3 TFLOP/s of TF32 peak against
//     67 TFLOP/s on the CUDA cores.
//   * the weights (126 taps x C^2, 8.3 MB at C=128) cannot live in shared
//     memory as the TPU kernel keeps them in VMEM.  They are split into
//     hi/lo TF32 and arranged in mma fragment order once, when the weights
//     are loaded (ops/mrf_block.py::pack_mrf_stage), stay
//     resident in the 50 MB L2, and go straight into registers, one step
//     (tap, 8 input channels) ahead, with no barrier inside a conv: the warps
//     that share a column group read the same addresses, so L1 serves most.
//     (Staging them through shared memory cost the tile length and a barrier
//     per step, and measured slower.)
// wgmma and TMA are the next step (later work).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxChains = 4;
constexpr int kMaxUnits = 4;
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kNWMax = 64;     // output columns per warp at C >= 64
constexpr float kSlope = 0.1f;

struct MrfConfig {
  int n_chains;
  int ksize[kMaxChains];
  int n_units[kMaxChains];
  int dil[kMaxChains][kMaxUnits];
};

template <int C>
struct Geo {
  static constexpr int NW = C < kNWMax ? C : kNWMax;  // output columns per warp
  static constexpr int NC = NW / 8;               // n-chunks per warp
  static constexpr int MC = 24 / NC;              // 16-row m-chunks per warp per pass (96 accumulators)
  static constexpr int CGW = C / NW;              // column groups of warps
  static constexpr int RGW = kWarps / CGW;        // row groups of warps
  static constexpr int KC = C / 8;                // k-chunks per tap
  static constexpr int RPP = RGW * MC * 16;      // rows per pass
  static constexpr int S = C + 4;                 // row stride: A fragment loads hit distinct banks
  static constexpr int SLICE = 16 * C;            // floats of one (tap, k-chunk) weight step
};

enum Mode { kStoreLrelu = 0, kAdd = 1, kStore = 2 };

__device__ __forceinline__ float lrelu(float a) { return fmaxf(a, kSlope * a); }

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One conv over output rows [lo, hi) of the tile (local rows: row i is global
// position origin + i in every buffer).  wfrag: this conv's weights in
// fragment order [tap][k-chunk][n-chunk][lane][b0_hi, b1_hi, b0_lo, b1_lo].
template <int C, bool IN_LRELU, int MODE>
__device__ void conv_rows(const float* __restrict__ src, float* dst, int lo, int hi, int k, int d,
                          const float* __restrict__ wfrag, const float* __restrict__ bias,
                          int origin, int T) {
  using Gm = Geo<C>;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // mma groupID
  const int t = lane & 3;   // mma threadID_in_group
  const int cgw = warp % Gm::CGW;
  const int rgw = warp / Gm::CGW;
  const int half = (k - 1) / 2;
  const int steps = k * Gm::KC;

  for (int base = lo; base < hi; base += Gm::RPP) {
    const int n_chunks = min((hi - base + 15) / 16, Gm::RGW * Gm::MC);
    const int nj = n_chunks > rgw ? min(Gm::MC, (n_chunks - rgw + Gm::RGW - 1) / Gm::RGW) : 0;

    float acc[Gm::MC][Gm::NC][4];
#pragma unroll
    for (int nc = 0; nc < Gm::NC; ++nc) {
      const int col = (cgw * Gm::NC + nc) * 8 + 2 * t;
      const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
#pragma unroll
      for (int j = 0; j < Gm::MC; ++j) {
        acc[j][nc][0] = b0; acc[j][nc][1] = b1; acc[j][nc][2] = b0; acc[j][nc][3] = b1;
      }
    }

    // B fragments: from L2 into registers, one step ahead
    const float4* bsrc = reinterpret_cast<const float4*>(wfrag) + cgw * Gm::NC * 32 + lane;
    float4 bnext[Gm::NC];
#pragma unroll
    for (int nc = 0; nc < Gm::NC; ++nc) bnext[nc] = __ldg(bsrc + nc * 32);
    for (int s = 0; s < steps; ++s) {
      float4 bf[Gm::NC];
#pragma unroll
      for (int nc = 0; nc < Gm::NC; ++nc) bf[nc] = bnext[nc];
      if (s + 1 < steps) {
#pragma unroll
        for (int nc = 0; nc < Gm::NC; ++nc)
          bnext[nc] = __ldg(bsrc + (size_t)(s + 1) * (Gm::SLICE / 4) + nc * 32);
      }
      const int tap = s / Gm::KC;
      const int k0 = (s % Gm::KC) * 8;
      const int off = (tap - half) * d;
#pragma unroll
      for (int j = 0; j < Gm::MC; ++j) {
        if (j < nj) {
          // output rows past hi (a partial chunk) recompute row hi - 1 and
          // are not stored, so every read stays in the conv's input range
          const int row = base + 16 * (j * Gm::RGW + rgw) + g;
          const float* p0 = src + (min(row, hi - 1) + off) * Gm::S + k0 + t;
          const float* p1 = src + (min(row + 8, hi - 1) + off) * Gm::S + k0 + t;
          float av[4] = {p0[0], p1[0], p0[4], p1[4]};
          uint32_t ahi[4], alo[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float a = IN_LRELU ? lrelu(av[q]) : av[q];
            ahi[q] = to_tf32(a);
            alo[q] = to_tf32(a - __uint_as_float(ahi[q]));
          }
#pragma unroll
          for (int nc = 0; nc < Gm::NC; ++nc) {
            const uint32_t bh0 = __float_as_uint(bf[nc].x), bh1 = __float_as_uint(bf[nc].y);
            const uint32_t bl0 = __float_as_uint(bf[nc].z), bl1 = __float_as_uint(bf[nc].w);
            mma_tf32(acc[j][nc], alo, bh0, bh1);
            mma_tf32(acc[j][nc], ahi, bl0, bl1);
            mma_tf32(acc[j][nc], ahi, bh0, bh1);
          }
        }
      }
    }

#pragma unroll
    for (int j = 0; j < Gm::MC; ++j) {
      if (j >= nj) continue;
#pragma unroll
      for (int half_row = 0; half_row < 2; ++half_row) {
        const int row = base + 16 * (j * Gm::RGW + rgw) + g + 8 * half_row;
        if (row >= hi) continue;
        const int gpos = origin + row;
        const bool inside = gpos >= 0 && gpos < T;
#pragma unroll
        for (int nc = 0; nc < Gm::NC; ++nc) {
          float* o = dst + row * Gm::S + (cgw * Gm::NC + nc) * 8 + 2 * t;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = inside ? acc[j][nc][2 * half_row + e] : 0.0f;
            if (MODE == kStoreLrelu) o[e] = lrelu(v);
            else if (MODE == kAdd) o[e] += v;
            else o[e] = v;
          }
        }
      }
    }
  }
}

template <int C>
constexpr size_t smem_bytes(int halo, int tile) {
  return sizeof(float) * 2u * (size_t)(tile + 2 * halo) * Geo<C>::S;
}

template <int C, int CPU>
__global__ void __launch_bounds__(kThreads)
mrf_section_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ b, float* __restrict__ out, int T, int halo,
                   int tile, MrfConfig cfg) {
  using Gm = Geo<C>;
  extern __shared__ __align__(16) float smem[];
  const int rows = tile + 2 * halo;
  float* hbuf = smem;
  float* tbuf = smem + rows * Gm::S;

  const int t0 = blockIdx.x * tile;
  const int origin = t0 - halo;  // global position of local row 0
  const float* xb = x + (size_t)blockIdx.y * T * C;
  float* ob = out + (size_t)blockIdx.y * T * C;
  const int n_out = min(tile, T - t0);
  const float n_chains = (float)cfg.n_chains;

  const float* wc = w;  // weights and biases walk in execution order
  const float* bc = b;
  for (int r = 0; r < cfg.n_chains; ++r) {
    const int k = cfg.ksize[r];
    const int half = (k - 1) / 2;
    const size_t conv_floats = (size_t)2 * k * C * C;  // hi + lo
    int chain_halo = 0;
    for (int u = 0; u < cfg.n_units[r]; ++u)
      chain_halo += half * cfg.dil[r][u] + (CPU == 2 ? half : 0);
    int lo = halo - chain_halo;
    int hi = halo + tile + chain_halo;

    for (int idx = threadIdx.x; idx < (hi - lo) * C; idx += kThreads) {
      const int row = lo + idx / C;
      const int c = idx % C;
      const int gpos = origin + row;
      hbuf[row * Gm::S + c] = (gpos >= 0 && gpos < T) ? xb[(size_t)gpos * C + c] : 0.0f;
    }
    __syncthreads();

    for (int u = 0; u < cfg.n_units[r]; ++u) {
      const int d = cfg.dil[r][u];
      const int e1 = half * d;
      if (CPU == 2) {
        // t = lrelu(conv_d(lrelu(h))); h += conv_1(t)
        conv_rows<C, true, kStoreLrelu>(hbuf, tbuf, lo + e1, hi - e1, k, d, wc, bc, origin, T);
        wc += conv_floats;
        bc += C;
        __syncthreads();
        conv_rows<C, false, kAdd>(tbuf, hbuf, lo + e1 + half, hi - e1 - half, k, 1, wc, bc,
                                  origin, T);
        wc += conv_floats;
        bc += C;
        __syncthreads();
        lo += e1 + half;
        hi -= e1 + half;
      } else {
        // t = conv_d(lrelu(h)); h += t
        conv_rows<C, true, kStore>(hbuf, tbuf, lo + e1, hi - e1, k, d, wc, bc, origin, T);
        wc += conv_floats;
        bc += C;
        __syncthreads();
        lo += e1;
        hi -= e1;
        for (int idx = threadIdx.x; idx < (hi - lo) * C; idx += kThreads) {
          const int row = lo + idx / C;
          const int c = idx % C;
          hbuf[row * Gm::S + c] += tbuf[row * Gm::S + c];
        }
        __syncthreads();
      }
    }

    // h now holds this chain's output on rows [halo, halo + tile); every
    // output element is read and written by the same thread in each chain
    const bool first = r == 0;
    const bool last = r == cfg.n_chains - 1;
    for (int idx = threadIdx.x; idx < n_out * C; idx += kThreads) {
      const int q = idx / C;
      const int c = idx % C;
      const float v = hbuf[(halo + q) * Gm::S + c];
      const size_t gi = (size_t)(t0 + q) * C + c;
      const float sum = first ? v : ob[gi] + v;
      ob[gi] = last ? sum / n_chains : sum;
    }
    __syncthreads();
  }
}

template <int C, int CPU>
int launch(const float* x, const float* w, const float* b, float* out, int B, int T, int halo,
           int tile, const MrfConfig& cfg, cudaStream_t stream) {
  const size_t smem = smem_bytes<C>(halo, tile);
  cudaError_t err = cudaFuncSetAttribute(mrf_section_kernel<C, CPU>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + tile - 1) / tile, B);
  mrf_section_kernel<C, CPU><<<grid, kThreads, smem, stream>>>(x, w, b, out, T, halo, tile, cfg);
  return (int)cudaGetLastError();
}

template <int CPU>
int dispatch_c(int C, const float* x, const float* w, const float* b, float* out, int B, int T,
               int halo, int tile, const MrfConfig& cfg, cudaStream_t stream) {
  switch (C) {
    case 8: return launch<8, CPU>(x, w, b, out, B, T, halo, tile, cfg, stream);
    case 16: return launch<16, CPU>(x, w, b, out, B, T, halo, tile, cfg, stream);
    case 32: return launch<32, CPU>(x, w, b, out, B, T, halo, tile, cfg, stream);
    case 64: return launch<64, CPU>(x, w, b, out, B, T, halo, tile, cfg, stream);
    case 128: return launch<128, CPU>(x, w, b, out, B, T, halo, tile, cfg, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs; 0 for an unsupported C.
long long mrf_section_smem_bytes(int C, int halo, int tile) {
  switch (C) {
    case 8: return (long long)smem_bytes<8>(halo, tile);
    case 16: return (long long)smem_bytes<16>(halo, tile);
    case 32: return (long long)smem_bytes<32>(halo, tile);
    case 64: return (long long)smem_bytes<64>(halo, tile);
    case 128: return (long long)smem_bytes<128>(halo, tile);
    default: return 0;
  }
}

// x, out [B, T, C]; w: per conv in execution order, weights in mma fragment
// order (see conv_rows); b [n_convs, C]; dil is n_chains rows of kMaxUnits.
// Returns the CUDA error code of the launch (0 on success).
int mrf_section_f32(const float* x, const float* w, const float* b, float* out, int B, int T,
                    int C, int convs_per_unit, int n_chains, const int* ksize, const int* n_units,
                    const int* dil, int halo, int tile, void* stream) {
  if (n_chains < 1 || n_chains > kMaxChains) return (int)cudaErrorInvalidValue;
  MrfConfig cfg{};
  cfg.n_chains = n_chains;
  for (int r = 0; r < n_chains; ++r) {
    if (n_units[r] < 1 || n_units[r] > kMaxUnits) return (int)cudaErrorInvalidValue;
    cfg.ksize[r] = ksize[r];
    cfg.n_units[r] = n_units[r];
    for (int u = 0; u < n_units[r]; ++u) cfg.dil[r][u] = dil[r * kMaxUnits + u];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (convs_per_unit == 2) return dispatch_c<2>(C, x, w, b, out, B, T, halo, tile, cfg, s);
  if (convs_per_unit == 1) return dispatch_c<1>(C, x, w, b, out, B, T, halo, tile, cfg, s);
  return (int)cudaErrorInvalidValue;
}

const char* mrf_section_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
