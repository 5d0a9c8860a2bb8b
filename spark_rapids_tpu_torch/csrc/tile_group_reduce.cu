// Grouped SUM over bucket ids: the Hopper kernel behind
// spark_rapids_tpu_torch.ops.device_kernels.tile_group_reduce.
//
// Replaces the TPU kernel spark_rapids_tpu/ops/pallas_kernels.py:152
// (tile_group_reduce), which contracts a (tile x 1024) one-hot against
// the (tile x V) value block on the MXU and carries the sum in a scan.
//
// Bound on the H100: bytes. Each row is read once (4 B of bucket id and
// 8 B per value lane); the arithmetic is one add per lane and row.
//
// Design. Only the first `num_groups` buckets are accumulated: the
// caller knows how many groups the batch has, and rows at or above that
// id carry zero values by contract (dead rows sit on the scratch id), so
// they are skipped, and a warp tile of them loads no values. A warp tile
// is 128 rows; each thread loads its 4 consecutive ids with one 16-byte
// load (the next tile's ids while it works on this one) and, per lane,
// its 4 values with two 16-byte loads, all lanes' loads at once. No
// atomics anywhere (a shared float64 atomicAdd is a CAS loop on sm_90a).
// Two paths:
//
// - Few groups (num_groups <= 8, as in TPC-H q1): every thread
//   keeps [lanes][groups] float64 sums in registers and adds each row
//   into the sum of its id with a select per group, so no row waits on
//   another. Lanes are cut into chunks (grid.y) that fit the registers.
//   At the end a fixed shuffle tree reduces the sums across the warp.
// - More groups: every warp owns a private [lanes][num_groups] float64
//   copy in shared memory (at most TGR_MAX_CHUNK lanes per block; the
//   block's copies stay under a shared-memory target so that several
//   blocks fit on an SM). Each thread folds its 4 rows into runs of equal
//   live ids (items); rows arrive sorted by key after a join, so one item
//   is common. Round k takes every thread's k-th item: the threads that
//   hold the same id (all of them when the round has one id, else
//   __match_any_sync) are summed by a shuffle tree into the lowest of
//   them, which alone adds the sum into the warp's copy.
//
// Each block sums its warps' results in warp order into a per-block
// partial. A second kernel (tgr_combine) sums the partials: 32 warps
// split the blocks by block index mod 32, each sums its share in block
// order, and the 32 warp sums are added in warp order; it also writes
// zeros past num_groups. Rows go to warps by a fixed rule and every sum
// is taken in an order fixed by the grid size, so the same input on the
// same card (same grid) gives the same bits in every run. Counts are 0/1
// lanes summed in float64, exact up to 2^53.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libtile_group_reduce.so tile_group_reduce.cu

#include <cuda_runtime.h>
#include <stdint.h>

#define TGR_MAX_LANES 128
#define TGR_MAX_CHUNK 4
#define TGR_THREADS 256
#define TGR_WARPS (TGR_THREADS / 32)
#define TGR_ROWS 4
#define TGR_TILE (32 * TGR_ROWS)
#define TGR_COMBINE_THREADS 1024
#define FULL_MASK 0xffffffffu

struct LanePtrs {
  const double* p[TGR_MAX_LANES];
};

// ids of rows r..r+3; rows at or past n get -1
__device__ __forceinline__ void load_ids(const int32_t* __restrict__ gid, int64_t r,
                                         int64_t n, bool vec, int g[TGR_ROWS]) {
  if (vec && r + TGR_ROWS <= n) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(gid + r));
    g[0] = q.x; g[1] = q.y; g[2] = q.z; g[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < TGR_ROWS; ++j) g[j] = r + j < n ? __ldg(gid + r + j) : -1;
  }
}

__device__ __forceinline__ void load_vals(const double* __restrict__ p, int64_t r,
                                          int64_t n, bool vec, double v[TGR_ROWS]) {
  if (vec && r + TGR_ROWS <= n) {
    const double2 a = __ldg(reinterpret_cast<const double2*>(p + r));
    const double2 b = __ldg(reinterpret_cast<const double2*>(p + r + 2));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else {
#pragma unroll
    for (int j = 0; j < TGR_ROWS; ++j) v[j] = r + j < n ? __ldg(p + r + j) : 0.0;
  }
}

// the k-th of four values, without indexing an array by a variable
// (which would put the array in local memory)
template <typename T>
__device__ __forceinline__ T pick(const T a[TGR_ROWS], int k) {
  return k == 0 ? a[0] : k == 1 ? a[1] : k == 2 ? a[2] : a[3];
}

__global__ void __launch_bounds__(TGR_THREADS)
tgr_partial(const int32_t* __restrict__ gid, LanePtrs vals, int64_t n, int num_lanes,
            int chunk, int ng, int vec, double* __restrict__ partial) {
  extern __shared__ double acc[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int lane0 = blockIdx.y * chunk;
  const int lc = min(chunk, num_lanes - lane0);
  const int copy = lc * ng;  // doubles in one warp's copy
  for (int i = threadIdx.x; i < TGR_WARPS * copy; i += TGR_THREADS) acc[i] = 0.0;
  __syncthreads();
  double* mine = acc + warp * copy;
  const unsigned below = (1u << lane) - 1u;
  const unsigned above = ~((2u << lane) - 1u);

  const int64_t tiles = (n + TGR_TILE - 1) / TGR_TILE;
  const int64_t step = (int64_t)gridDim.x * TGR_WARPS;
  int64_t t = (int64_t)blockIdx.x * TGR_WARPS + warp;
  int g[TGR_ROWS];
  if (t < tiles) load_ids(gid, t * TGR_TILE + lane * TGR_ROWS, n, vec, g);
  for (; t < tiles; t += step) {
    const int64_t r = t * TGR_TILE + lane * TGR_ROWS;
    int gn[TGR_ROWS];
    if (t + step < tiles) load_ids(gid, (t + step) * TGR_TILE + lane * TGR_ROWS, n, vec, gn);

    // runs of equal live ids: item[j] is row j's item (-1: dead row),
    // key[k] the id of item k (-1: no such item)
    int item[TGR_ROWS], key[TGR_ROWS];
    int m = 0;
#pragma unroll
    for (int j = 0; j < TGR_ROWS; ++j) {
      const bool live = g[j] >= 0 && g[j] < ng;
      const bool start = live && (j == 0 || g[j > 0 ? j - 1 : 0] != g[j]);
      m += start;
      item[j] = live ? m - 1 : -1;
      key[j] = -1;
    }
#pragma unroll
    for (int j = 0; j < TGR_ROWS; ++j) {
#pragma unroll
      for (int k = 0; k <= j; ++k)
        if (item[j] == k && (j == 0 || item[j > 0 ? j - 1 : 0] != k)) key[k] = g[j];
    }
    const int rounds = __reduce_max_sync(FULL_MASK, m);
    if (rounds > 0) {  // else the whole warp tile is dead: load no values
      // every lane's values of this thread's rows, all loads in flight
      double v[TGR_MAX_CHUNK][TGR_ROWS];
#pragma unroll
      for (int l = 0; l < TGR_MAX_CHUNK; ++l) {
#pragma unroll
        for (int j = 0; j < TGR_ROWS; ++j) v[l][j] = 0.0;
        if (l < lc && m > 0) load_vals(vals.p[lane0 + l], r, n, vec, v[l]);
      }
      for (int k = 0; k < rounds; ++k) {
        // round k: every thread's k-th item. Threads holding the same id
        // are peers; a shuffle tree sums each peer group into its lowest
        // thread, which adds the sum into the warp's copy.
        const int kk = pick(key, k);
        const bool same = __all_sync(FULL_MASK, kk == __shfl_sync(FULL_MASK, kk, 0));
        const unsigned peers = same ? FULL_MASK : __match_any_sync(FULL_MASK, kk);
        unsigned up = peers & above;
        unsigned rel = __popc(peers & below);
        const bool lead = rel == 0 && kk >= 0;
        double x[TGR_MAX_CHUNK];
#pragma unroll
        for (int l = 0; l < TGR_MAX_CHUNK; ++l) {
          x[l] = 0.0;
#pragma unroll
          for (int j = 0; j < TGR_ROWS; ++j)
            if (item[j] == k) x[l] += v[l][j];
        }
        while (__any_sync(FULL_MASK, up != 0u)) {
          const int next = __ffs(up);  // lowest peer still above, + 1
#pragma unroll
          for (int l = 0; l < TGR_MAX_CHUNK; ++l) {
            if (l < lc) {  // lc is the same for the whole block
              const double y = __shfl_sync(FULL_MASK, x[l], next ? next - 1 : lane);
              if (next) x[l] += y;
            }
          }
          up &= ~__ballot_sync(FULL_MASK, rel & 1u);
          rel >>= 1;
        }
        if (lead) {
#pragma unroll
          for (int l = 0; l < TGR_MAX_CHUNK; ++l)
            if (l < lc) mine[l * ng + kk] += x[l];
        }
        __syncwarp();
      }
    }
#pragma unroll
    for (int j = 0; j < TGR_ROWS; ++j) g[j] = gn[j];
  }
  __syncthreads();
  // partial layout: [blocks][num_lanes][ng]
  double* out = partial + ((int64_t)blockIdx.x * num_lanes + lane0) * ng;
  for (int i = threadIdx.x; i < copy; i += TGR_THREADS) {
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < TGR_WARPS; ++w) s += acc[w * copy + i];
    out[i] = s;
  }
}

// The few-groups path (num_groups <= 8, as in TPC-H q1): every
// thread keeps [LC][NG] float64 sums in registers and adds each of its
// rows into the sum of its id with a select per group, so no row waits
// on another; the loads of a tile's LC lanes are all in flight at once.
// At the end the threads' sums are reduced across the warp by a fixed
// shuffle tree and across the block's warps in warp order.
template <int NG>
struct Few {
  static constexpr int LC = 32 / NG < 16 ? 32 / NG : 16;
};

template <int NG, int LC>
__global__ void __launch_bounds__(TGR_THREADS)
tgr_few(const int32_t* __restrict__ gid, LanePtrs vals, int64_t n, int num_lanes,
        int chunk, int vec, double* __restrict__ partial) {
  __shared__ double red[TGR_WARPS][LC * NG];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int lane0 = blockIdx.y * chunk;
  const int lc = min(chunk, num_lanes - lane0);
  double acc[LC][NG];
#pragma unroll
  for (int l = 0; l < LC; ++l)
#pragma unroll
    for (int k = 0; k < NG; ++k) acc[l][k] = 0.0;

  const int64_t tiles = (n + TGR_TILE - 1) / TGR_TILE;
  const int64_t step = (int64_t)gridDim.x * TGR_WARPS;
  int64_t t = (int64_t)blockIdx.x * TGR_WARPS + warp;
  int g[TGR_ROWS];
  if (t < tiles) load_ids(gid, t * TGR_TILE + lane * TGR_ROWS, n, vec, g);
  for (; t < tiles; t += step) {
    const int64_t r = t * TGR_TILE + lane * TGR_ROWS;
    int gn[TGR_ROWS];
    if (t + step < tiles) load_ids(gid, (t + step) * TGR_TILE + lane * TGR_ROWS, n, vec, gn);
    bool live = false;
#pragma unroll
    for (int j = 0; j < TGR_ROWS; ++j) live |= g[j] >= 0 && g[j] < NG;
    if (__any_sync(FULL_MASK, live)) {
      double v[LC][TGR_ROWS];
#pragma unroll
      for (int l = 0; l < LC; ++l)
        if (l < lc) load_vals(vals.p[lane0 + l], r, n, vec, v[l]);
#pragma unroll
      for (int l = 0; l < LC; ++l)
        if (l < lc)
#pragma unroll
          for (int j = 0; j < TGR_ROWS; ++j)
#pragma unroll
            for (int k = 0; k < NG; ++k) acc[l][k] += g[j] == k ? v[l][j] : 0.0;
    }
#pragma unroll
    for (int j = 0; j < TGR_ROWS; ++j) g[j] = gn[j];
  }
#pragma unroll
  for (int l = 0; l < LC; ++l)
#pragma unroll
    for (int k = 0; k < NG; ++k) {
      double x = acc[l][k];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL_MASK, x, o);
      if (lane == 0) red[warp][l * NG + k] = x;
    }
  __syncthreads();
  double* out = partial + ((int64_t)blockIdx.x * num_lanes + lane0) * NG;
  for (int i = threadIdx.x; i < lc * NG; i += TGR_THREADS) {
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < TGR_WARPS; ++w) s += red[w][i];
    out[i] = s;
  }
}

typedef void (*FewKernel)(const int32_t*, LanePtrs, int64_t, int, int, int, double*);

// the few-groups kernel for ng groups and its lanes per block, or null
// (more than 8 groups)
static FewKernel few_kernel(int ng, int* most) {
  switch (ng) {
#define TGR_FEW_CASE(G) \
  case G:               \
    *most = Few<G>::LC; \
    return tgr_few<G, Few<G>::LC>;
    TGR_FEW_CASE(1)
    TGR_FEW_CASE(2)
    TGR_FEW_CASE(3)
    TGR_FEW_CASE(4)
    TGR_FEW_CASE(5)
    TGR_FEW_CASE(6)
    TGR_FEW_CASE(7)
    TGR_FEW_CASE(8)
#undef TGR_FEW_CASE
  }
  return nullptr;
}

// out[l][g] = sum over blocks b, in order, of partial[b][l][g] for g <
// ng; 0 for ng <= g < num_buckets. A block takes 32 columns (l, g); its
// 32 warps split the blocks b by b mod 32, each summing in order, and the
// 32 warp sums are added in warp order.
__global__ void __launch_bounds__(TGR_COMBINE_THREADS)
tgr_combine(const double* __restrict__ partial, int blocks, int num_lanes, int ng,
            int num_buckets, double* __restrict__ out) {
  __shared__ double red[TGR_COMBINE_THREADS / 32][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int live_cols = num_lanes * ng;
  const int col = blockIdx.x * 32 + lane;
  double s = 0.0;
  if (col < live_cols) {
    const int64_t stride = (int64_t)live_cols;
    const double* p = partial + col;
#pragma unroll 8
    for (int b = warp; b < blocks; b += TGR_COMBINE_THREADS / 32) s += p[b * stride];
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && col < live_cols) {
    double t = 0.0;
#pragma unroll
    for (int w = 0; w < TGR_COMBINE_THREADS / 32; ++w) t += red[w][lane];
    const int l = col / ng;
    out[(int64_t)l * num_buckets + (col - l * ng)] = t;
  }
  // zeros past ng, spread over the grid
  const int dead = num_buckets - ng;
  for (int64_t z = (int64_t)blockIdx.x * TGR_COMBINE_THREADS + threadIdx.x;
       z < (int64_t)num_lanes * dead; z += (int64_t)gridDim.x * TGR_COMBINE_THREADS) {
    const int l = (int)(z / dead);
    out[(int64_t)l * num_buckets + ng + (z - (int64_t)l * dead)] = 0.0;
  }
}

// Launch shape for num_lanes lanes over ng groups on the current device:
// *chunk lanes per block (grid.y = ceil(num_lanes / chunk)) so that a
// block's shared copies stay within smem_target bytes, and *resident
// blocks along grid.x that fill the card once. Raises the kernel's
// dynamic shared-memory limit to the device's. Returns a cudaError_t.
extern "C" int tile_group_reduce_shape(int num_lanes, int ng, int smem_target,
                                       int* chunk, int* resident) {
  if (num_lanes < 1 || num_lanes > TGR_MAX_LANES || ng < 1) return (int)cudaErrorInvalidValue;
  const int per_lane = TGR_WARPS * ng * (int)sizeof(double);
  int most = 0;
  const FewKernel few = few_kernel(ng, &most);
  if (few == nullptr) {
    most = smem_target / per_lane;
    most = most < 1 ? 1 : (most > TGR_MAX_CHUNK ? TGR_MAX_CHUNK : most);
  }
  const int chunks = (num_lanes + most - 1) / most;
  *chunk = (num_lanes + chunks - 1) / chunks;
  const int smem = few == nullptr ? *chunk * per_lane : 0;
  int dev = 0, optin = 0, per_sm = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  if (smem > optin) return (int)cudaErrorInvalidValue;
  if (few != nullptr) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, few, TGR_THREADS, 0);
  } else {
    // the largest limit, so that a shape computed earlier stays launchable
    e = cudaFuncSetAttribute(tgr_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tgr_partial, TGR_THREADS, smem);
  }
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *resident = per_sm * sms / chunks > 0 ? per_sm * sms / chunks : 1;
  return 0;
}

// gid: int32[n]; lane_ptrs: host array of num_lanes device pointers to
// float64[n]; num_groups: buckets accumulated (rows with ids at or above
// it are skipped); chunk, resident: from tile_group_reduce_shape; vec:
// every pointer is 16-byte aligned; partial: float64[resident *
// num_lanes * num_groups] scratch; out: float64[num_lanes *
// num_buckets]. Returns a cudaError_t (0 = ok).
extern "C" int tile_group_reduce_f64(const int32_t* gid, const uint64_t* lane_ptrs,
                                     int64_t n, int num_lanes, int num_buckets,
                                     int num_groups, int chunk, int resident, int vec,
                                     double* partial, double* out, void* stream) {
  if (num_lanes < 1 || num_lanes > TGR_MAX_LANES || num_buckets < 1 || num_groups < 1 ||
      num_groups > num_buckets || chunk < 1 || resident < 1)
    return (int)cudaErrorInvalidValue;
  // one warp tile per warp at least; the card filled once at most
  const int64_t tiles = (n + TGR_TILE - 1) / TGR_TILE;
  const int64_t need = (tiles + TGR_WARPS - 1) / TGR_WARPS;
  const int blocks = need < 1 ? 1 : (need < resident ? (int)need : resident);
  LanePtrs lp;
  for (int i = 0; i < num_lanes; ++i) lp.p[i] = (const double*)lane_ptrs[i];
  const cudaStream_t s = (cudaStream_t)stream;
  dim3 grid(blocks, (num_lanes + chunk - 1) / chunk);
  int most = 0;
  const FewKernel few = few_kernel(num_groups, &most);
  if (few != nullptr) {
    if (chunk > most) return (int)cudaErrorInvalidValue;
    few<<<grid, TGR_THREADS, 0, s>>>(gid, lp, n, num_lanes, chunk, vec, partial);
  } else {
    const int smem = TGR_WARPS * chunk * num_groups * (int)sizeof(double);
    tgr_partial<<<grid, TGR_THREADS, smem, s>>>(gid, lp, n, num_lanes, chunk, num_groups,
                                                vec, partial);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int cols = (num_lanes * num_groups + 31) / 32;
  tgr_combine<<<cols, TGR_COMBINE_THREADS, 0, s>>>(partial, blocks, num_lanes, num_groups,
                                                   num_buckets, out);
  return (int)cudaGetLastError();
}
