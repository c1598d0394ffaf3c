// Fused spatial-transformer decoder forward for Hopper (sm_90a).
//
// Replaces the TPU kernel paig_reproduction_tpu/ops/pallas/st_decoder.py:115
// (st_decode_pallas, body _decode_kernel). Per frame and object it places
// the object's template and contents at the object's (x, y) with an
// axis-aligned bilinear warp (translation t = (img/2 - p)/T * sigma, scale
// sigma, align_corners=False, zero padding), shifts the warped mask logit
// back by -5, takes a softmax over the objects plus a constant background
// logit of 1 and composites the contents over the background. The output is
// written channels-last, [N, img, img, ch].
//
// What bounds it. By the roofline it is bound by the bytes it writes: the
// inputs are a few KB, the output N*img*img*ch*4 bytes (12.3 MB at the main
// path's N=1000, 32/16/2/3), 3.7 us at the H100's 3.35 TB/s, against 1.5 us
// for the ~96 f32 operations a pixel needs at 67 TFLOP/s. On the card it is
// bound by instruction issue: a pixel costs about 110 instructions (two
// taps and the walk below per object, three exact expf, one IEEE
// division, the composite, three stores), some 3.9 M warp instructions at
// N=1000. Measured on an H100 80GB HBM3 at 700 W with variants of this
// kernel (PERF.md): the launch alone takes about 2 us, the prologue 1.8 us
// more; the stores are hidden (without them it is no faster); exact expf
// and division cost 0.4 us over the intrinsics.
//
// No tensor cores, on purpose: the Pallas kernel's two dense [img, T]
// matmuls per plane do 4x the needed arithmetic (each interpolation row has
// two non-zeros), and the work is issue-bound scalar arithmetic whose
// largest part, the softmax, a matrix unit cannot do.
//
// Design:
// - One block of 32 warps per SM. The prologue stages the object planes
//   (template + 5 and sigmoid(contents), one float4 per texel, so a tap is
//   one 16-byte load for all planes) and the background in shared memory,
//   once per SM, with one round of asynchronous copies.
// - The unit of work is a slab of 8 output rows of one frame, decoded by
//   one warp; slabs go to the blocks in turn, so every SM gets its share.
//   Each lane owns a column. Per slab a warp builds a table of the y rows
//   (w0, w1, j0) of every object's interpolation matrix, and each lane its
//   x rows, in registers: pixels do no division.
// - The walk. Warping is separable, val = Wy (P Wx^T). Each lane keeps, per
//   object, the last two template rows interpolated at its column's x taps
//   in registers; moving down one output row moves the source half a
//   template row, so a new row is interpolated about every second output
//   row. The rows a step needs are the same for every lane of the warp, so
//   the walk's branches never diverge. Per pixel and object that is one
//   table load and 8 multiply-adds, and 2 plane loads and 8 more every
//   second row, instead of 4 plane loads and 24 operations.
// - Stores go straight from registers, three floats a pixel. No block
//   barrier follows the prologue, so one warp's stores overlap the others'
//   arithmetic; staging slabs in shared memory for a bulk copy (TMA) or for
//   16-byte stores measured about 2 us slower, as the tile costs
//   shared-memory bandwidth and a warp barrier per slab.
//
// All arithmetic is f32 with expf and IEEE division. The source coordinates
// take the plain decoder's operations in its order
// (models/decoder.py::_warp_weights); the two contractions run x first,
// then y, so the result differs from the plain one only in rounding, well
// within the 2e-5 tolerance.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

// One block of 32 warps an SM: the prologue (2048 sigmoids at 32/16/2/3)
// is paid once per SM, and 64 registers a thread fill the register file.
constexpr int kWarps = 32;
constexpr int kThreads = 32 * kWarps;
constexpr int kSlabRows = 8;

struct Params {
  const float* pos;         // [N, 2*o]
  const float* tmpl_raw;    // [o, T, T]
  const float* cont_raw;    // [o, T, T, ch]
  const float* background;  // [img, img, ch]
  float* out;               // [N, img, img, ch]
  int n, img, tmpl;
  int rows;                 // rows of a slab, the unit of one warp
  float sigma;
};

// Rows of a slab: at most one y-table row per lane and object.
int slab_rows(int img, int n_objs) {
  const int rows = kSlabRows < 32 / n_objs ? kSlabRows : 32 / n_objs;
  return img < rows ? img : rows;
}

// The background's floats, rounded up so the float4 tables after it stay
// aligned.
__host__ __device__ inline int bg_floats(int img, int ch) {
  return (img * img * ch + 3) / 4 * 4;
}

// Dynamic shared memory: the planes as one float4 per texel, the
// background, each warp's 32-row y table, the raw planes as the prologue
// copies them and base_coord of every row.
int shared_bytes(int img, int tmpl, int n_objs, int ch) {
  return (int)sizeof(float) *
         (4 * n_objs * tmpl * tmpl + bg_floats(img, ch) + kWarps * 32 * 4 +
          n_objs * tmpl * tmpl * (1 + ch) + img);
}

// The source coordinate of output pixel i along one axis, in template
// pixels, takes the same operations, in the same order, as the plain
// PyTorch decoder (models/decoder.py::_warp_weights): base(i) below, then
// source_coord. base depends on the pixel only, so it is computed once.
__device__ __forceinline__ float base_coord(int i, int img) {
  return (2.0f * (float)i + 1.0f) / (float)img - 1.0f;
}

__device__ __forceinline__ float source_coord(float base, float p, int img,
                                              int tmpl, float sigma) {
  float t = ((float)img / 2.0f - p) / (float)tmpl * sigma;
  float grid = sigma * base + t;
  return ((grid + 1.0f) * (float)tmpl - 1.0f) / 2.0f;
}

// One row of an interpolation matrix: weights max(0, 1 - |src - j|) of
// taps j0 = floor(src) and j0 + 1 in x and y, zero for a tap outside the
// template, and j0 (int bits) in z.
__device__ __forceinline__ float4 tap_row(float base, float p, int img,
                                          int tmpl, float sigma) {
  const float src = source_coord(base, p, img, tmpl, sigma);
  const int j0 = (int)floorf(src);
  float w[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int jk = j0 + k;
    w[k] = jk >= 0 && jk < tmpl ? fmaxf(0.0f, 1.0f - fabsf(src - (float)jk))
                                : 0.0f;
  }
  return make_float4(w[0], w[1], __int_as_float(j0), 0.0f);
}

__device__ __forceinline__ float4 axpby(float a, float4 x, float b,
                                        float4 y) {
  return make_float4(a * x.x + b * y.x, a * x.y + b * y.y, a * x.z + b * y.z,
                     a * x.w + b * y.w);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// 4-byte asynchronous copy from global to shared memory (cp.async).
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(d), "l"(src) : "memory");
}

template <int kObjs, int kCh>
__global__ void __launch_bounds__(kThreads, 1)
st_decode_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int img = p.img, tmpl = p.tmpl, rows = p.rows;
  const int plane = tmpl * tmpl;
  const int frame = img * img * kCh;
  const int slabs = (img + rows - 1) / rows;

  float4* planes = reinterpret_cast<float4*>(smem);  // [o][T][T]
  float* bg = reinterpret_cast<float*>(planes + kObjs * plane);
  float4* ytabs = reinterpret_cast<float4*>(bg + bg_floats(img, kCh));
  float* raw = reinterpret_cast<float*>(ytabs + kWarps * 32);
  float* bases = raw + kObjs * plane * (1 + kCh);  // base_coord of each row

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  float4* ytab = ytabs + warp * 32;  // [o][rows]

  // Each warp decodes slabs of `rows` output rows: unit u is frame
  // u / slabs, rows (u % slabs) * rows onwards, and goes to block
  // u % gridDim.x, so every SM gets its share. A unit's positions are
  // loaded one unit ahead (the first while the prologue's copies fly):
  // the x position of each object, and the y position of this lane's
  // y-table row.
  const int units = p.n * slabs;
  const int stride = gridDim.x * kWarps;
  float pos_x[kObjs], pos_y = 0.0f;
  auto load_pos = [&](int u) {
    if (u >= units) return;
    const float* fp = p.pos + (size_t)(u / slabs) * 2 * kObjs;
#pragma unroll
    for (int o = 0; o < kObjs; ++o) pos_x[o] = fp[2 * o];
    if (lane < kObjs * rows) pos_y = fp[2 * (lane / rows) + 1];
  };
  int u = warp * gridDim.x + blockIdx.x;
  load_pos(u);

  // Prologue, once per block: the raw planes and the background in one
  // round of asynchronous copies, all in flight together, then
  // template + 5 and sigmoid(contents) as float4 planes.
  const int n_tmpl = kObjs * plane;
  for (int i = tid; i < n_tmpl * (1 + kCh); i += kThreads)
    copy_async(raw + i, i < n_tmpl ? p.tmpl_raw + i
                                   : p.cont_raw + (i - n_tmpl));
  for (int i = tid; i < frame; i += kThreads)
    copy_async(bg + i, p.background + i);
  for (int i = tid; i < img; i += kThreads) bases[i] = base_coord(i, img);
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  for (int i = tid; i < n_tmpl; i += kThreads) {
    const float* c = raw + n_tmpl + i * kCh;
    planes[i] = make_float4(raw[i] + 5.0f, sigmoid(c[0]),
                            kCh > 1 ? sigmoid(c[1]) : 0.0f,
                            kCh > 2 ? sigmoid(c[2]) : 0.0f);
  }
  __syncthreads();

  // Each lane walks down its columns; consecutive rows mostly reuse the
  // same two template rows, so each object keeps its last two
  // x-interpolated template rows (P[j] Wx[w]^T, j = j0 and j0 + 1) in
  // registers. j0 is the same for every lane of the warp, so the walk's
  // branches do not diverge.
  for (; u < units; u += stride) {
    const int f = u / slabs;
    const int h0 = (u - f * slabs) * rows;
    const int h1 = min(img, h0 + rows);
    float* out = p.out + (size_t)f * frame;
    float px[kObjs];
#pragma unroll
    for (int o = 0; o < kObjs; ++o) px[o] = pos_x[o];
    const float py = pos_y;
    load_pos(u + stride);

    __syncwarp();
    if (lane < kObjs * rows) {
      const int h = h0 + lane % rows;
      if (h < img) ytab[lane] = tap_row(bases[h], py, img, tmpl, p.sigma);
    }
    __syncwarp();

    for (int w = lane; w < img; w += 32) {
      float4 tx[kObjs], c0[kObjs], c1[kObjs];
      int jw[kObjs];
#pragma unroll
      for (int o = 0; o < kObjs; ++o) {
        tx[o] = tap_row(bases[w], px[o], img, tmpl, p.sigma);
        jw[o] = -0x40000000;
      }
      const float* bg_px = bg + (h0 * img + w) * kCh;
      float* dst = out + (h0 * img + w) * kCh;
      for (int h = h0; h < h1; ++h, bg_px += img * kCh, dst += img * kCh) {
        float4 val[kObjs];
        float logit[kObjs];
        float m = 1.0f;  // the background's logit
#pragma unroll
        for (int o = 0; o < kObjs; ++o) {
          const float4 y = ytab[o * rows + h - h0];
          const int j0 = __float_as_int(y.z);
          // x-interpolated template row j; zero outside the template.
          const float4* pl = planes + o * plane;
          const int jx0 = __float_as_int(tx[o].z);
          const int x0 = jx0 >= 0 && jx0 < tmpl ? jx0 : 0;
          const int x1 = jx0 + 1 >= 0 && jx0 + 1 < tmpl ? jx0 + 1 : 0;
          auto xrow = [&](int j) {
            return j >= 0 && j < tmpl
                       ? axpby(tx[o].x, pl[j * tmpl + x0], tx[o].y,
                               pl[j * tmpl + x1])
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          };
          if (j0 != jw[o]) {
            c0[o] = j0 == jw[o] + 1 ? c1[o] : xrow(j0);
            c1[o] = xrow(j0 + 1);
            jw[o] = j0;
          }
          // Wx first, then Wy: both weights of a tap outside the
          // template are zero, as are its rows.
          val[o] = axpby(y.x, c0[o], y.y, c1[o]);
          logit[o] = val[o].x - 5.0f;
          m = fmaxf(m, logit[o]);
        }
        const float e_bg = expf(1.0f - m);
        float s = e_bg;
        float res[kCh];
#pragma unroll
        for (int c = 0; c < kCh; ++c) res[c] = e_bg * bg_px[c];
#pragma unroll
        for (int o = 0; o < kObjs; ++o) {
          const float e = expf(logit[o] - m);
          s += e;
          res[0] += e * val[o].y;
          if constexpr (kCh > 1) res[1] += e * val[o].z;
          if constexpr (kCh > 2) res[2] += e * val[o].w;
        }
        const float inv = 1.0f / s;
#pragma unroll
        for (int c = 0; c < kCh; ++c) dst[c] = res[c] * inv;
      }
    }
  }
}

using Kernel = void (*)(Params);

// The instantiation for n_objs objects and ch channels, or null.
Kernel kernel_for(int n_objs, int ch) {
  static const Kernel kernels[4][3] = {
      {st_decode_kernel<1, 1>, st_decode_kernel<1, 2>, st_decode_kernel<1, 3>},
      {st_decode_kernel<2, 1>, st_decode_kernel<2, 2>, st_decode_kernel<2, 3>},
      {st_decode_kernel<3, 1>, st_decode_kernel<3, 2>, st_decode_kernel<3, 3>},
      {st_decode_kernel<4, 1>, st_decode_kernel<4, 2>, st_decode_kernel<4, 3>},
  };
  if (n_objs < 1 || n_objs > 4 || ch < 1 || ch > 3) return nullptr;
  return kernels[n_objs - 1][ch - 1];
}

}  // namespace

// Sets the kernel up for one shape on the current device: raises its
// dynamic shared-memory limit to what the shape needs, if it is lower (a
// shape set up earlier may need more), and writes to *slots how many of its
// blocks the device runs at once. Called once per device and shape, before
// st_decode_forward. Returns a CUDA error code, 0 on success.
extern "C" int st_decode_configure(int img, int tmpl, int n_objs, int ch,
                                   int* slots) {
  const Kernel kernel = kernel_for(n_objs, ch);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const int smem = shared_bytes(img, tmpl, n_objs, ch);
  cudaFuncAttributes attr;
  int device, sms, per_sm;
  cudaError_t err;
  if ((err = cudaFuncGetAttributes(&attr, (const void*)kernel)) !=
      cudaSuccess)
    return (int)err;
  if (attr.maxDynamicSharedSizeBytes < smem &&
      (err = cudaFuncSetAttribute(
           (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
           smem)) != cudaSuccess)
    return (int)err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, (const void*)kernel, kThreads, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *slots = per_sm * sms;
  return 0;
}

// Launches the decoder on `stream`: a grid of at most `slots` blocks (from
// st_decode_configure for this shape), each warp walking its share of the
// slabs. Returns a CUDA error code, 0 on success. The caller checks shapes,
// types and limits (1 <= n_objs <= 4, 1 <= ch <= 3, shared memory within
// the card's).
extern "C" int st_decode_forward(const float* pos, const float* tmpl_raw,
                                 const float* cont_raw,
                                 const float* background, float* out, int n,
                                 int img, int tmpl, int n_objs, int ch,
                                 float sigma, int slots, void* stream) {
  if (n == 0) return 0;
  const Kernel kernel = kernel_for(n_objs, ch);
  if (kernel == nullptr || slots < 1) return (int)cudaErrorInvalidValue;
  Params p{pos, tmpl_raw, cont_raw, background, out,
           n, img, tmpl, slab_rows(img, n_objs), sigma};
  const long units = (long)n * ((img + p.rows - 1) / p.rows);
  const int grid = units < slots ? (int)units : slots;
  void* args[] = {&p};
  return (int)cudaLaunchKernel((const void*)kernel, dim3(grid),
                               dim3(kThreads), args,
                               shared_bytes(img, tmpl, n_objs, ch),
                               (cudaStream_t)stream);
}
