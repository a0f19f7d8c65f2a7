// probe_window: which offsets a window copy accepts on Hopper (sm_90a), and
// at what price.
//
// Replaces: bench/granule_probe.py:run -- N = 4096 windows [8, 128] of a
// [1088, 2048] fp32 canvas in device memory, in order: fetch the window,
// add 1, write it back, at offsets whose y is 8-aligned and whose x is
// aligned to 128, 16 or 8 elements.  On the TPU it asked whether the DMA
// engine takes a lane offset finer than the 128-lane tile.  The card's
// version: kernels B and D read-modify-write canvas tiles, and a tile copied
// with 16-byte cp.async (or a TMA box) may start at any multiple of 4 fp32
// elements; what does a window cost when its rows no longer start on a
// 128-byte line?
//
// Design.  Windows overlap, so the order of fetch and write-back is part of
// what is computed: one block of 256 threads walks the windows in order.  A
// window is 8 rows of 512 bytes: thread t copies the 16 bytes at row t / 32,
// column 4 * (t % 32) with cp.async into its own slot of a shared-memory
// buffer, waits, adds 1, stores the 16 bytes back, and a __syncthreads()
// orders the write-back before the next window's fetch (.cg copies read L2,
// where the stores have landed).  Nothing is prefetched across windows: a
// window that overlaps the previous one must see its write-back, so one
// buffer is enough (the reference's pair of buffers has no use here).  The
// ``align`` arm changes only the offsets; the smallest one, 4 elements, is
// the edge of what a 16-byte copy accepts.
//
// Bound on this card: bytes -- the windows overlap, so each canvas cell they
// cover is read once and written once (and the offsets read once); the timed
// walk is two L2 round trips per window, some two orders of magnitude above
// it.
//
// Adding 1.0f to an fp32 count is exact: bit-equal to the numpy loop.

#include "probe_common.cuh"

constexpr int kThreads = 256;
constexpr int kWH = 8, kWW = 128;
static_assert(kThreads * 4 == kWH * kWW, "one float4 of the window a thread");

__global__ void __launch_bounds__(kThreads)
probe_window_kernel(float* __restrict__ canvas, const int* __restrict__ off,
                    int n, int W) {
  __shared__ float4 win[kThreads];
  const int tid = threadIdx.x;
  const int r = tid / (kWW / 4), c = (tid % (kWW / 4)) * 4;
  for (int i = 0; i < n; ++i) {
    const int y = __ldg(off + 2 * i), x = __ldg(off + 2 * i + 1);
    float* g = canvas + (size_t)(y + r) * W + x + c;
    float4* s = &win[tid];
    cp_async16(s, g);
    cp_async_commit();
    cp_async_wait_all();
    float4 v = *s;
    v.x += 1.f;
    v.y += 1.f;
    v.z += 1.f;
    v.w += 1.f;
    *reinterpret_cast<float4*>(g) = v;
    __syncthreads();
  }
}

extern "C" int probe_window_launch(float* canvas, const int* off, int n,
                                   int W, void* stream) {
  if (n == 0) return 0;
  probe_window_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(canvas, off,
                                                                n, W);
  return (int)cudaGetLastError();
}
