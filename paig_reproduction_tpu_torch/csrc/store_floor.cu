// Store-only floor of the ST-decoder kernel (st_decoder.cu), a measurement
// and nothing else: no module of the training path builds or launches it.
//
// It runs the decoder's grid (one block of 32 warps per SM) over the same
// units (slabs of `rows` output rows of one frame, one warp each), computes
// nothing and writes the constant 0.5 over each slab, which is contiguous
// in the output, in 16-byte stores that fill whole lines. Its time is what
// the launch and the output's bytes cost at the least on this grid.
//
// It does not store as the decoder does. The decoder's lanes each write
// their pixel's ch floats, a third of a line per warp instruction at ch=3:
// spread between its arithmetic, these stores cost it nothing measurable,
// but issued back to back with nothing between them they took longer than
// the whole decoder (on an H100, PERF.md), so they bound nothing.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads, 1)
store_floor_kernel(float* out, int n, int img, int ch, int rows) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slabs = (img + rows - 1) / rows;
  const int units = n * slabs;
  const float4 c = make_float4(0.5f, 0.5f, 0.5f, 0.5f);
  for (int u = warp * gridDim.x + blockIdx.x; u < units;
       u += gridDim.x * (kThreads / 32)) {
    const int f = u / slabs;
    const int h0 = (u - f * slabs) * rows;
    const int h1 = min(img, h0 + rows);
    float4* dst = reinterpret_cast<float4*>(
        out + ((size_t)f * img + h0) * img * ch);
    const int quads = (h1 - h0) * img * ch / 4;
    for (int i = lane; i < quads; i += 32) dst[i] = c;
  }
}

}  // namespace

// Writes 0.5 into every element of out [n, img, img, ch] on `stream`, as
// above, with slabs of `rows` rows. A row of img * ch floats must fill
// whole 16-byte stores, and out must be 16-byte aligned. Returns a CUDA
// error code, 0 on success.
extern "C" int store_floor(float* out, int n, int img, int ch, int rows,
                           void* stream) {
  if (n == 0) return 0;
  if (rows < 1 || (img * ch) % 4 || reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  int device, sms;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return (int)err;
  const long units = (long)n * ((img + rows - 1) / rows);
  const int grid = units < sms ? (int)units : sms;
  store_floor_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      out, n, img, ch, rows);
  return (int)cudaGetLastError();
}
