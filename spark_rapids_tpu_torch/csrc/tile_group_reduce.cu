// Grouped SUM over bucket ids: the Hopper kernel behind
// spark_rapids_tpu_torch.ops.device_kernels.tile_group_reduce.
//
// Replaces the TPU kernel spark_rapids_tpu/ops/pallas_kernels.py:152
// (tile_group_reduce), which contracts a (tile x 1024) one-hot against
// the (tile x V) value block on the MXU and carries the sum in a scan.
//
// Bound on the H100: bytes. Each row is read once (4 B of bucket id and
// 8 B per value lane); the arithmetic is one add per lane and row. The
// design keeps the accumulator out of device memory: every block holds
// [lane_chunk][num_buckets] float64 sums in shared memory and adds into
// them with shared-memory atomics, so device memory sees one streaming
// read of the inputs, one [blocks][V][buckets] partial per block and a
// second pass that sums the partials over blocks in a fixed order (the
// result does not depend on the order in which blocks ran). Counts are
// 0/1 lanes summed in float64, exact up to 2^53.
//
// Known cost: with few live groups (TPC-H q1 has at most 6) the shared
// atomics of one block contend on a handful of addresses.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libtile_group_reduce.so tile_group_reduce.cu

#include <cuda_runtime.h>
#include <stdint.h>

#define TGR_MAX_LANES 128
#define TGR_LANE_CHUNK 16
#define TGR_THREADS 512

struct LanePtrs {
  const double* p[TGR_MAX_LANES];
};

__global__ void tgr_partial(const int32_t* __restrict__ gid, LanePtrs vals,
                            int64_t n, int num_lanes, int num_buckets,
                            double* __restrict__ partial) {
  extern __shared__ double acc[];
  const int lane0 = blockIdx.y * TGR_LANE_CHUNK;
  const int lc = min(TGR_LANE_CHUNK, num_lanes - lane0);
  for (int i = threadIdx.x; i < lc * num_buckets; i += blockDim.x) acc[i] = 0.0;
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; row < n;
       row += stride) {
    const int g = gid[row];
    if (g < 0 || g >= num_buckets) continue;
    for (int l = 0; l < lc; ++l) {
      const double v = vals.p[lane0 + l][row];
      // adding 0.0 never changes a sum that starts at +0.0
      if (v != 0.0) atomicAdd(&acc[l * num_buckets + g], v);
    }
  }
  __syncthreads();
  // partial layout: [blocks][num_lanes][num_buckets]
  double* out = partial + ((int64_t)blockIdx.x * num_lanes + lane0) * num_buckets;
  for (int i = threadIdx.x; i < lc * num_buckets; i += blockDim.x) out[i] = acc[i];
}

__global__ void tgr_combine(const double* __restrict__ partial, int blocks,
                            int total, double* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  double s = 0.0;
  for (int b = 0; b < blocks; ++b) s += partial[(int64_t)b * total + i];
  out[i] = s;
}

// gid: int32[n]; lane_ptrs: host array of num_lanes device pointers to
// float64[n]; partial: float64[blocks * num_lanes * num_buckets] scratch;
// out: float64[num_lanes * num_buckets]. Returns a cudaError_t (0 = ok).
extern "C" int tile_group_reduce_f64(const int32_t* gid, const uint64_t* lane_ptrs,
                                     int64_t n, int num_lanes, int num_buckets,
                                     int blocks, double* partial, double* out,
                                     void* stream) {
  if (num_lanes < 1 || num_lanes > TGR_MAX_LANES || num_buckets < 1 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  LanePtrs lp;
  for (int i = 0; i < num_lanes; ++i) lp.p[i] = (const double*)lane_ptrs[i];
  const int chunk = num_lanes < TGR_LANE_CHUNK ? num_lanes : TGR_LANE_CHUNK;
  const int smem = chunk * num_buckets * (int)sizeof(double);
  cudaError_t e = cudaFuncSetAttribute(
      tgr_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = (cudaStream_t)stream;
  dim3 grid(blocks, (num_lanes + TGR_LANE_CHUNK - 1) / TGR_LANE_CHUNK);
  tgr_partial<<<grid, TGR_THREADS, smem, s>>>(gid, lp, n, num_lanes, num_buckets,
                                              partial);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int total = num_lanes * num_buckets;
  tgr_combine<<<(total + 255) / 256, 256, 0, s>>>(partial, blocks, total, out);
  return (int)cudaGetLastError();
}
