// Bilinear ROI crop for Hopper (sm_90a), tf.image.crop_and_resize semantics,
// and its gradient with respect to the feature map.
//
// Replaces the TPU kernel mask_yolo_tpu/ops/pallas_crop.py::crop_rois (body
// _crop_kernel, weights pallas_mask._interp_weights). Its plain PyTorch twin
// is mask_yolo_tpu_torch/ops/roi_align.py::crop_and_resize; the wrapper is
// mask_yolo_tpu_torch/ops/roi_crop.py::crop_rois.
//
//   fmap  [B, H, W, C]  float32 or bfloat16, NHWC contiguous
//   boxes [B, K, 4]     float32 normalized (x1, y1, x2, y2)
//   out   [B, K, P, P, C] in the fmap's dtype
//
// The TPU kernel computed the crop as two GEMMs (wy @ fmap, then wx @ tmp^T)
// because the MXU only does matrix products. Here every output sample
// (b, k, py, px) is a 4-tap gather over C contiguous channels: the rows y0, y1
// and columns x0, x1 around the sample point, weighted by the tent weights,
// summed in f32 (y first, then x: the order of the twin's two contractions)
// and rounded once to the output dtype. Samples off the map are 0.
//
// Sample coordinates reproduce interp_matrix (ops/roi_align.py) bit for bit
// in f32: the explicit _rn intrinsics stop nvcc from contracting the
// multiply-adds into FMAs, which would round differently.
//
// Bounds below are against the H100 SXM's 3.35 TB/s; the kernels' device
// times on the card, beside those bounds and the designs they replaced, are
// in PERF.md section 6 (chip_smoke.py phases 3 and T1).
//
// Forward. Bound: memory, one read of the fmap pixels the ROIs touch and one
// write of the crops (bf16, B=16, K=10, 28x28x256, P=14: 6.0 us; the design
// this replaced had one block per sample row). Each output vector takes 4
// tap loads, served by L1 and L2, its arithmetic and a 16-byte store, so
// what holds it back is how many loads are in flight and how evenly the
// blocks fill the card. Design: one block of 256 threads per
// ROI, or per band of its sample rows, split until there are about
// kFwdBlocksPerSm blocks an SM; at most 51 registers a thread, so 5 blocks
// (40 warps) run on an SM. The block computes the ROI's P x taps and its
// rows' y taps once into shared memory. Thread t owns one 16-byte channel
// vector (8 bf16 or 4 f32 channels; a warp covers 512 contiguous bytes of
// one sample) of every spp-th sample, stepping (py, px) without divisions.
// (Tried and measured slower: four samples' loads in flight a thread, which
// took so many registers that fewer blocks fit an SM; a persistent grid of
// equal sample ranges; a separable form that interpolates each row of the
// ROI's columns into shared memory first.)
//
// Backward (crop_rois_backward_f32): the gradient with respect to the fmap,
// which the TPU package left to XLA's autodiff of the separable crop. Output
// sample (b, k, py, px) adds wy*wx*g[b, k, py, px, :] into its four taps of
// d_fmap; the boxes get no gradient. Twin: crop_and_resize_backward.
//
//   g      [B, K, P, P, C]  float32, C % 4 == 0
//   d_fmap [B, H, W, C]     float32, fully written (no zeroing needed)
//
// Bound: memory. At the training shape (B=16, K=32, P=14, C=256) g is
// 102.8 MB and d_fmap 12.8 MB: 34.5 us. Design: a gather, not an atomic
// scatter, so two runs give the same bits, as XLA's gradient does.
//  1. crop_index_kernel, one block per (image, band of kBandRows fmap rows):
//     the list of the sample rows i = k*P + py whose y taps touch the band
//     with a non-zero weight, in ascending i (a ballot and block prefix over
//     chunks of 256 rows, so the order never depends on timing), each with
//     its ROI, its y weights on the band's rows and whether the next listed
//     row is another ROI's (the end of a run); and for the ROIs it is given,
//     their P x taps and, for every column x, the first px and the count of
//     the samples whose x taps touch x (contiguous, as the sample points are
//     monotone in px). All of it goes to scratch the wrapper allocates.
//  2. crop_rois_backward_kernel, one block per (band, 128 channels and 32
//     columns, or 64 and 64, so that a thread's cells fit its registers):
//     it walks only its band's list, so no block scans rows that miss it. A
//     4-stage cp.async ring brings each listed g row's [P, channels] slice
//     (16-byte copies), the ROI's x taps and column ranges into shared
//     memory, three rows ahead of use; each thread copies the g slots it
//     sums itself, so rows need no barrier, only the ends of runs do.
//     Separably: for each listed row the thread of slot (px, 4 channels)
//     adds wy * g into its sums for the band's rows (registers); at the end
//     of a run of one ROI's rows the sums go to shared memory once, and the
//     thread of (column x, 4 channels) adds wx * sum over the px of its
//     column range into its cells (registers). No cell is updated by two
//     threads, so there is no read-modify-write chain, and each sum runs in
//     one fixed order (list order, then px). Each cell is stored once as a
//     16-byte vector. A row that straddles two bands is copied by both
//     bands' blocks. (The design this replaced scanned every sample row of
//     its image for each fmap row. Tried and measured slower: splitting
//     long lists over several blocks whose partial sums a last pass adds in
//     order.)
//  Any map width works: wider than one chunk, the columns are split across
//  blocks. P is limited by the ring's shared memory (P <= 64 here).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// N channels moved as one aligned load/store (16 bytes when vectorized).
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

// The two input taps of one sample point and their tent weights.
struct Taps {
  int i0, i1;
  float w0, w1;
  bool valid;  // false: the sample lies outside the map and reads as 0
};

// Sample i of P along an axis of in_size pixels for the span [lo, hi]:
//   c = lo*n + (i/(P-1)) * ((hi-lo)*n)   (P > 1),   c = 0.5*(lo+hi)*n   (P == 1)
// with n = in_size - 1; weight of pixel g is max(0, 1 - |c - g|); the sample
// is zero when c < 0 or c > n.
__device__ __forceinline__ Taps sample(float lo, float hi, int in_size, int i, int P) {
  const float n = static_cast<float>(in_size - 1);
  float c;
  if (P > 1) {
    const float step = __fdiv_rn(static_cast<float>(i), static_cast<float>(P - 1));
    c = __fadd_rn(__fmul_rn(lo, n), __fmul_rn(step, __fmul_rn(__fsub_rn(hi, lo), n)));
  } else {
    c = __fmul_rn(__fmul_rn(0.5f, __fadd_rn(lo, hi)), n);
  }
  Taps t;
  t.valid = (c >= 0.f) && (c <= n);
  if (!t.valid) {
    t.i0 = t.i1 = 0;
    t.w0 = t.w1 = 0.f;
    return t;
  }
  const float g0 = floorf(c);
  t.i0 = static_cast<int>(g0);
  t.i1 = t.i0 + 1;
  t.w0 = fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(c, g0))));
  t.w1 = fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(c, __fadd_rn(g0, 1.f)))));
  if (t.i1 > in_size - 1) {  // c == n exactly: the second tap has weight 0
    t.i1 = t.i0;
    t.w1 = 0.f;
  }
  return t;
}

// The taps of one sample along one axis; i0 = i1 = -1 and w0 = w1 = 0 for a
// sample off the map.
struct alignas(16) TapRec {
  int i0, i1;
  float w0, w1;
};

__device__ __forceinline__ TapRec tap_rec(const Taps& t) {
  TapRec r;
  r.i0 = t.valid ? t.i0 : -1;
  r.i1 = t.valid ? t.i1 : -1;
  r.w0 = t.valid ? t.w0 : 0.f;
  r.w1 = t.valid ? t.w1 : 0.f;
  return r;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The current device's SM count, queried once a device.
int sm_count() {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> cached[kMaxDevices];
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 || device >= kMaxDevices) return 132;
  int sms = cached[device].load(std::memory_order_relaxed);
  if (sms == 0) {
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
      sms = 132;
    cached[device].store(sms, std::memory_order_relaxed);
  }
  return sms;
}

// ---- forward ----------------------------------------------------------------

constexpr int kFwdThreads = 256;
constexpr int kFwdMinBlocks = 5;    // blocks an SM the registers must allow (51 a thread)
constexpr int kFwdBlocksPerSm = 4;  // the band split aims at this many blocks an SM

// Block: ROI bk = blockIdx.x / splits, its sample rows [py0, py0 + rows).
// Thread t owns channel vectors cv = t % lanes (+ lanes, ...) of the samples
// s = t / lanes (+ spp, ...), s = pyl * P + px over the block's rows.
template <typename T, int VEC>
__global__ void __launch_bounds__(kFwdThreads, kFwdMinBlocks)
    crop_rois_kernel(const T* __restrict__ fmap, const float* __restrict__ boxes,
                     T* __restrict__ out, int H, int W, int C, int K, int P, int band,
                     int splits) {
  using PackT = Pack<T, VEC>;
  extern __shared__ TapRec fwd_taps[];  // [P] x taps, then [rows] y taps
  const int bk = blockIdx.x / splits;   // b * K + k
  const int py0 = (blockIdx.x % splits) * band;
  const int rows = min(band, P - py0);
  const int b = bk / K;
  const float* bx = boxes + 4 * static_cast<size_t>(bk);
  const TapRec* tx = fwd_taps;
  const TapRec* ty = fwd_taps + P;
  for (int j = threadIdx.x; j < P + rows; j += kFwdThreads)
    fwd_taps[j] = tap_rec(j < P ? sample(bx[0], bx[2], W, j, P)
                                : sample(bx[1], bx[3], H, py0 + j - P, P));
  __syncthreads();

  const int cvecs = C / VEC;
  const int lanes = min(cvecs, kFwdThreads);
  const int spp = kFwdThreads / lanes;  // samples a pass of the block covers
  if (static_cast<int>(threadIdx.x) >= spp * lanes) return;
  const int ns = rows * P;
  const PackT* img = reinterpret_cast<const PackT*>(fmap + static_cast<size_t>(b) * H * W * C);
  PackT* dst = reinterpret_cast<PackT*>(out + (static_cast<size_t>(bk) * P + py0) * P * C);
  for (int cv = threadIdx.x % lanes; cv < cvecs; cv += lanes) {
    int s = threadIdx.x / lanes;
    int pyl = s / P, px = s - pyl * P;
    for (; s < ns; s += spp) {
      const TapRec rx = tx[px], ry = ty[pyl];
      PackT r;
      if (rx.i0 >= 0 && ry.i0 >= 0) {
        const PackT* r0 = img + static_cast<size_t>(ry.i0) * W * cvecs + cv;
        const PackT* r1 = img + static_cast<size_t>(ry.i1) * W * cvecs + cv;
        const PackT a = r0[rx.i0 * cvecs], bq = r0[rx.i1 * cvecs];
        const PackT cq = r1[rx.i0 * cvecs], d = r1[rx.i1 * cvecs];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          // y first, then x: the order of the twin's two contractions
          const float t0 = ry.w0 * to_float(a.v[j]) + ry.w1 * to_float(cq.v[j]);
          const float t1 = ry.w0 * to_float(bq.v[j]) + ry.w1 * to_float(d.v[j]);
          r.v[j] = from_float<T>(rx.w0 * t0 + rx.w1 * t1);
        }
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) r.v[j] = from_float<T>(0.f);
      }
      dst[static_cast<size_t>(s) * cvecs + cv] = r;
      for (px += spp; px >= P; px -= P) ++pyl;
    }
  }
}

template <typename T, int VEC>
int launch(const void* fmap, const void* boxes, void* out, int B, int H, int W, int C, int K,
           int P, cudaStream_t stream) {
  // split each ROI's sample rows into bands until there are about
  // kFwdBlocksPerSm blocks an SM
  const int rois = B * K;
  int splits = (kFwdBlocksPerSm * sm_count() + rois - 1) / rois;
  splits = splits < 1 ? 1 : (splits > P ? P : splits);
  const int band = (P + splits - 1) / splits;
  splits = (P + band - 1) / band;
  const size_t smem = sizeof(TapRec) * static_cast<size_t>(P + band);
  crop_rois_kernel<T, VEC><<<static_cast<unsigned>(rois) * splits, kFwdThreads, smem, stream>>>(
      static_cast<const T*>(fmap), static_cast<const float*>(boxes), static_cast<T*>(out), H, W,
      C, K, P, band, splits);
  return static_cast<int>(cudaGetLastError());
}

// 16-byte vectors when the channel count and both pointers allow them,
// one channel per thread otherwise.
template <typename T>
int dispatch(const void* fmap, const void* boxes, void* out, int B, int H, int W, int C, int K,
             int P, void* stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec_ok = C % VEC == 0 && reinterpret_cast<uintptr_t>(fmap) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec_ok ? launch<T, VEC>(fmap, boxes, out, B, H, W, C, K, P, s)
                : launch<T, 1>(fmap, boxes, out, B, H, W, C, K, P, s);
}

// ---- backward ---------------------------------------------------------------

constexpr int kBandRows = 2;    // fmap rows a backward block owns (roi_crop.BWD_BAND_ROWS)
constexpr int kBwdThreads = 256;
constexpr int kBwdCols = 4;        // columns a backward thread owns
// A backward block of XC columns: XC / kBwdCols threads along the columns,
// the rest along the channels, 4 channels each (128 for 32 columns, 64 for
// 64, so that the cells a thread owns fit its registers)
__host__ __device__ constexpr int bwd_channels(int xc) { return 4 * kBwdThreads / (xc / kBwdCols); }
constexpr int kBwdStages = 4;      // cp.async ring depth, in listed g rows
constexpr int kListChunk = 256;    // list entries held in shared memory at a time
constexpr int kIndexThreads = 256;
constexpr int kMaxPool = 64;

// A listed sample row of one image.
struct alignas(16) RowEntry {
  int i;                // the sample row k*P + py
  int k;                // its ROI k, | kRunEnd where the next listed row is not k's
  float wy[kBandRows];  // its y weights on the band's rows
};
constexpr int kRunEnd = 1 << 30;

// The scratch the wrapper allocates, carved into four 16-byte aligned parts.
struct Scratch {
  RowEntry* lists;  // [B * nbands][K * P]
  int* counts;      // [B * nbands]
  TapRec* xtaps;    // [B * K][P]
  int* xrange;      // [B * K][WP]: first px | count << 16 of the samples touching x
  size_t bytes;
};

size_t align16(size_t n) { return (n + 15) / 16 * 16; }

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) / 4 * 4; }

Scratch carve(void* base, int B, int H, int W, int K, int P) {
  const size_t nbands = (H + kBandRows - 1) / kBandRows;
  const size_t rois = static_cast<size_t>(B) * K;
  const size_t parts[4] = {align16(sizeof(RowEntry) * B * nbands * K * P),
                           align16(sizeof(int) * B * nbands), align16(sizeof(TapRec) * rois * P),
                           align16(sizeof(int) * rois * round4(W))};
  const uintptr_t p = reinterpret_cast<uintptr_t>(base);  // 0: sizes only
  Scratch s;
  s.lists = reinterpret_cast<RowEntry*>(p);
  s.counts = reinterpret_cast<int*>(p + parts[0]);
  s.xtaps = reinterpret_cast<TapRec*>(p + parts[0] + parts[1]);
  s.xrange = reinterpret_cast<int*>(p + parts[0] + parts[1] + parts[2]);
  s.bytes = parts[0] + parts[1] + parts[2] + parts[3];
  return s;
}

// Block (b, band). Dynamic shared memory: the image's K boxes, then P x taps.
__global__ void __launch_bounds__(kIndexThreads)
    crop_index_kernel(const float* __restrict__ boxes, RowEntry* __restrict__ lists,
                      int* __restrict__ counts, TapRec* __restrict__ xtaps,
                      int* __restrict__ xrange, int H, int W, int K, int P, int nbands) {
  extern __shared__ float4 idx_smem[];
  float4* bxs = idx_smem;                                // [K]
  TapRec* txs = reinterpret_cast<TapRec*>(idx_smem + K);  // [P]
  __shared__ int warp_hits[kIndexThreads / 32];
  const int b = blockIdx.x / nbands;
  const int band = blockIdx.x % nbands;
  const int y_lo = band * kBandRows;
  const int y_hi = min(H, y_lo + kBandRows);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float4* bimg = reinterpret_cast<const float4*>(boxes) + static_cast<size_t>(b) * K;
  for (int k = threadIdx.x; k < K; k += kIndexThreads) bxs[k] = bimg[k];
  __syncthreads();

  // the band's list, in ascending sample row
  const int KP = K * P;
  RowEntry* list = lists + static_cast<size_t>(blockIdx.x) * KP;
  // whether sample row i's y taps touch the band with a non-zero weight
  auto touches = [&](int i, Taps& t) {
    const float4 bx = bxs[i / P];
    t = sample(bx.y, bx.w, H, i % P, P);
    return t.valid && ((t.i0 >= y_lo && t.i0 < y_hi && t.w0 != 0.f) ||
                       (t.i1 >= y_lo && t.i1 < y_hi && t.w1 != 0.f));
  };
  int total = 0;
  for (int base = 0; base < KP; base += kIndexThreads) {
    const int i = base + threadIdx.x;
    bool hit = false;
    RowEntry e;
    if (i < KP) {
      Taps t, next;
      hit = touches(i, t);
      const bool run_on = (i + 1) % P != 0 && touches(i + 1, next);
      e.i = i;
      e.k = i / P | (run_on ? 0 : kRunEnd);
#pragma unroll
      for (int r = 0; r < kBandRows; ++r)  // w1 = 0 where i1 == i0
        e.wy[r] = (y_lo + r == t.i0 ? t.w0 : 0.f) + (y_lo + r == t.i1 ? t.w1 : 0.f);
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_hits[warp] = __popc(ballot);
    __syncthreads();
    int offset = total;
    for (int j = 0; j < kIndexThreads / 32; ++j) {
      offset += j < warp ? warp_hits[j] : 0;
      total += warp_hits[j];
    }
    if (hit) list[offset + __popc(ballot & ((1u << lane) - 1u))] = e;
    __syncthreads();
  }
  if (threadIdx.x == 0) counts[blockIdx.x] = total;

  // x taps and column ranges of the ROIs k = band, band + nbands, ...
  const int WP = round4(W);
  for (int k = band; k < K; k += nbands) {
    const size_t roi = static_cast<size_t>(b) * K + k;
    const float4 bx = bxs[k];
    for (int j = threadIdx.x; j < P; j += kIndexThreads) {
      txs[j] = tap_rec(sample(bx.x, bx.z, W, j, P));
      xtaps[roi * P + j] = txs[j];
    }
    __syncthreads();
    for (int x = threadIdx.x; x < WP; x += kIndexThreads) {
      int first = -1, last = -1;
      for (int px = 0; px < P; ++px) {
        const TapRec t = txs[px];
        if ((t.i0 == x && t.w0 != 0.f) || (t.i1 == x && t.w1 != 0.f)) {
          first = first < 0 ? px : first;
          last = px;
        }
      }
      xrange[roi * WP + x] = first < 0 ? 0 : (first | ((last - first + 1) << 16));
    }
    __syncthreads();
  }
}

// Block (b, band) = blockIdx.x, channels [CH * blockIdx.y, +CH), CH =
// bwd_channels(XC), columns [XC * blockIdx.z, +XC). NSLOT >= P * CH / 4 /
// kBwdThreads.
template <int XC, int NSLOT>
__global__ void __launch_bounds__(kBwdThreads, XC == 32 ? 2 : 3)
    crop_rois_backward_kernel(const float* __restrict__ g, const RowEntry* __restrict__ lists,
                              const int* __restrict__ counts, const TapRec* __restrict__ xtaps,
                              const int* __restrict__ xrange, float* __restrict__ dfmap, int H,
                              int W, int C, int K, int P, int nbands) {
  constexpr int kBwdChannels = bwd_channels(XC);
  constexpr int kBwdQuads = kBwdChannels / 4;  // threads along the channels
  constexpr int kColGroups = XC / kBwdCols;    // ... and along the columns
  constexpr int NXW = kBwdCols;
  extern __shared__ float4 bwd_smem[];
  RowEntry* ents = reinterpret_cast<RowEntry*>(bwd_smem);  // [kListChunk]
  float4* hs = reinterpret_cast<float4*>(ents + kListChunk);  // [kBandRows][P][kBwdQuads]
  char* ring = reinterpret_cast<char*>(hs + kBandRows * P * kBwdQuads);
  // a stage: g slice [P][kBwdChannels] f32, x taps [P], column ranges [XC]
  const int g_bytes = P * kBwdChannels * 4;
  const int stage_bytes = g_bytes + P * static_cast<int>(sizeof(TapRec)) + XC * 4;
  const int b = blockIdx.x / nbands;
  const int y_lo = (blockIdx.x % nbands) * kBandRows;
  const int c0 = blockIdx.y * kBwdChannels;
  const int x_lo = blockIdx.z * XC;
  const int WP = round4(W);
  const int ncols4 = min(XC, WP - x_lo) / 4;  // 16-byte pieces of the column ranges
  const int quad = threadIdx.x % kBwdQuads;
  const int cg = threadIdx.x / kBwdQuads;
  const bool c_ok = c0 + 4 * quad < C;
  const int n = counts[blockIdx.x];
  const RowEntry* list = lists + static_cast<size_t>(blockIdx.x) * K * P;
  const float* gimg = g + static_cast<size_t>(b) * K * P * P * C + c0;

  // acc: the block's d_fmap cells (row r, column cg + kColGroups * j, channels
  // 4 quad..4 quad + 3); h: the y-weighted sums over the current run of rows
  // of one ROI, per slot q = threadIdx.x + j * kBwdThreads = px * kBwdQuads + quad
  float4 acc[kBandRows][NXW], h[NSLOT][kBandRows];
#pragma unroll
  for (int r = 0; r < kBandRows; ++r) {
#pragma unroll
    for (int j = 0; j < NXW; ++j) acc[r][j] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < NSLOT; ++j) h[j][r] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // copies of listed row e (of the chunk in ents) into stage s
  auto fetch = [&](int e, int s) {
    const int i = ents[e].i;
    const size_t roi = static_cast<size_t>(b) * K + (ents[e].k & ~kRunEnd);
    char* st = ring + s * stage_bytes;
    const float* grow = gimg + static_cast<size_t>(i) * P * C;
    for (int q = threadIdx.x; q < P * kBwdQuads; q += kBwdThreads) {
      const int px = q / kBwdQuads, l = q % kBwdQuads;
      if (c0 + 4 * l < C)
        cp_async16(st + (px * kBwdChannels + 4 * l) * 4, grow + static_cast<size_t>(px) * C + 4 * l);
    }
    // taps and ranges from the top thread down, beside the g copies
    const int t = kBwdThreads - 1 - threadIdx.x;
    if (t < P) cp_async16(st + g_bytes + t * sizeof(TapRec), xtaps + roi * P + t);
    else if (t - P < ncols4)
      cp_async16(st + g_bytes + P * sizeof(TapRec) + (t - P) * 16,
                 xrange + roi * WP + x_lo + 4 * (t - P));
  };

  for (int base = 0; base < n; base += kListChunk) {
    const int m = min(kListChunk, n - base);
    __syncthreads();  // every thread is done with the previous chunk
    for (int j = threadIdx.x; j < m; j += kBwdThreads) ents[j] = list[base + j];
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kBwdStages - 1; ++e) {
      if (e < m) fetch(e, e);
      cp_async_commit();
    }
    // A thread copies the g slots it sums itself, so between the ends of
    // runs the warps need no barrier: each waits for its own copies only.
    for (int e = 0; e < m; ++e) {
      cp_async_wait<kBwdStages - 2>();  // row e has landed (this thread's copies)
      if (e + kBwdStages - 1 < m) fetch(e + kBwdStages - 1, (e + kBwdStages - 1) % kBwdStages);
      cp_async_commit();

      const char* st = ring + (e % kBwdStages) * stage_bytes;
      const float4* gs = reinterpret_cast<const float4*>(st);
      const RowEntry en = ents[e];
      // y: the row's g slice into the slots' sums
#pragma unroll
      for (int j = 0; j < NSLOT; ++j) {
        const int q = threadIdx.x + j * kBwdThreads;
        if (q < P * kBwdQuads && c0 + 4 * (q % kBwdQuads) < C) {
          const float4 v = gs[q];
#pragma unroll
          for (int r = 0; r < kBandRows; ++r) {
            h[j][r].x += en.wy[r] * v.x;
            h[j][r].y += en.wy[r] * v.y;
            h[j][r].z += en.wy[r] * v.z;
            h[j][r].w += en.wy[r] * v.w;
          }
        }
      }
      // the last listed row of its ROI: x, the run's sums into the cells
      if (!(en.k & kRunEnd)) continue;  // uniform in the block
#pragma unroll
      for (int j = 0; j < NSLOT; ++j) {
        const int q = threadIdx.x + j * kBwdThreads;
        if (q < P * kBwdQuads) {
#pragma unroll
          for (int r = 0; r < kBandRows; ++r) {
            hs[r * P * kBwdQuads + q] = h[j][r];
            h[j][r] = make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
      }
      __syncthreads();  // the sums, and every thread's copies of the taps and ranges
      const TapRec* ts = reinterpret_cast<const TapRec*>(st + g_bytes);
      const int* rs = reinterpret_cast<const int*>(st + g_bytes + P * sizeof(TapRec));
#pragma unroll
      for (int j = 0; j < NXW; ++j) {
        const int xl = cg + kColGroups * j;
        const int x = x_lo + xl;
        if (x >= W || !c_ok) continue;
        const int range = rs[xl];
        const int first = range & 0xffff;
        const int end = first + (range >> 16);
#pragma unroll 2
        for (int px = first; px < end; ++px) {
          const TapRec t = ts[px];
          const float wx = (t.i0 == x ? t.w0 : 0.f) + (t.i1 == x ? t.w1 : 0.f);
#pragma unroll
          for (int r = 0; r < kBandRows; ++r) {
            const float4 v = hs[(r * P + px) * kBwdQuads + quad];
            acc[r][j].x += wx * v.x;
            acc[r][j].y += wx * v.y;
            acc[r][j].z += wx * v.z;
            acc[r][j].w += wx * v.w;
          }
        }
      }
      __syncthreads();  // before the sums and this stage's taps are overwritten
    }
    cp_async_wait<0>();
  }

  if (!c_ok) return;
#pragma unroll
  for (int r = 0; r < kBandRows; ++r) {
    const int y = y_lo + r;
    if (y >= H) break;
#pragma unroll
    for (int j = 0; j < NXW; ++j) {
      const int x = x_lo + cg + kColGroups * j;
      if (x < W)
        *reinterpret_cast<float4*>(dfmap + ((static_cast<size_t>(b) * H + y) * W + x) * C + c0 +
                                   4 * quad) = acc[r][j];
    }
  }
}

template <int XC, int NSLOT>
int launch_backward(const float* g, const Scratch& s, float* dfmap, int B, int H, int W, int C,
                    int K, int P, int nbands, cudaStream_t stream) {
  constexpr int kBwdChannels = bwd_channels(XC);
  const size_t stage = static_cast<size_t>(P) * (kBwdChannels * 4 + sizeof(TapRec)) + XC * 4;
  const size_t smem = kListChunk * sizeof(RowEntry) + kBandRows * P * kBwdChannels * 4 +
                      kBwdStages * stage;
  cudaError_t err = cudaFuncSetAttribute(crop_rois_backward_kernel<XC, NSLOT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(B) * nbands, (C + kBwdChannels - 1) / kBwdChannels,
                  (W + XC - 1) / XC);
  crop_rois_backward_kernel<XC, NSLOT><<<grid, kBwdThreads, smem, stream>>>(
      g, s.lists, s.counts, s.xtaps, s.xrange, dfmap, H, W, C, K, P, nbands);
  return static_cast<int>(cudaGetLastError());
}

// the slots of a g slice a thread sums: P * CH / 4 over kBwdThreads
template <int XC>
int launch_backward_p(const float* g, const Scratch& s, float* dfmap, int B, int H, int W, int C,
                      int K, int P, int nbands, cudaStream_t stream) {
  const int slots = (P * bwd_channels(XC) / 4 + kBwdThreads - 1) / kBwdThreads;
  return slots <= 1   ? launch_backward<XC, 1>(g, s, dfmap, B, H, W, C, K, P, nbands, stream)
         : slots <= 2 ? launch_backward<XC, 2>(g, s, dfmap, B, H, W, C, K, P, nbands, stream)
         : slots <= 4 ? launch_backward<XC, 4>(g, s, dfmap, B, H, W, C, K, P, nbands, stream)
                      : launch_backward<XC, 8>(g, s, dfmap, B, H, W, C, K, P, nbands, stream);
}

}  // namespace

// Plain C interface for ctypes. Returns cudaGetLastError() after the launch.

// Bytes of scratch crop_rois_backward_f32 needs (16-byte aligned).
extern "C" size_t crop_rois_backward_scratch_bytes(int B, int H, int W, int K, int P) {
  return carve(nullptr, B, H, W, K, P).bytes;  // pointers unused
}

// g, dfmap, scratch 16-byte aligned; C % 4 == 0; 1 <= P <= kMaxPool.
// Returns cudaErrorInvalidValue, launching nothing, otherwise.
extern "C" int crop_rois_backward_f32(const void* g, const void* boxes, void* scratch,
                                      void* dfmap, int B, int H, int W, int C, int K, int P,
                                      void* stream) {
  const bool aligned = reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(dfmap) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(scratch) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(boxes) % 16 == 0;
  if (!aligned || C % 4 != 0 || P < 1 || P > kMaxPool)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Scratch sc = carve(scratch, B, H, W, K, P);
  const int nbands = (H + kBandRows - 1) / kBandRows;
  const size_t idx_smem = sizeof(float4) * K + sizeof(TapRec) * P;
  if (idx_smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        crop_index_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(idx_smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  crop_index_kernel<<<static_cast<unsigned>(B) * nbands, kIndexThreads, idx_smem, s>>>(
      static_cast<const float*>(boxes), sc.lists, sc.counts, sc.xtaps, sc.xrange, H, W, K, P,
      nbands);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const float* gp = static_cast<const float*>(g);
  float* dp = static_cast<float*>(dfmap);
  return W <= 32 ? launch_backward_p<32>(gp, sc, dp, B, H, W, C, K, P, nbands, s)
                 : launch_backward_p<64>(gp, sc, dp, B, H, W, C, K, P, nbands, s);
}

extern "C" int crop_rois_f32(const void* fmap, const void* boxes, void* out, int B, int H, int W,
                             int C, int K, int P, void* stream) {
  return dispatch<float>(fmap, boxes, out, B, H, W, C, K, P, stream);
}

extern "C" int crop_rois_bf16(const void* fmap, const void* boxes, void* out, int B, int H,
                              int W, int C, int K, int P, void* stream) {
  return dispatch<__nv_bfloat16>(fmap, boxes, out, B, H, W, C, K, P, stream);
}
