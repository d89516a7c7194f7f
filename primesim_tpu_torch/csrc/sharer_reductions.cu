// sharer_reductions: the invalidation and back-invalidation reductions.
//
// Replaces the Pallas kernel primesim_tpu/kernels/reductions.py:
// sharer_reductions (_reduce_kernel). For every core it expands the packed
// sharer words of the accessed line (shw) and of the LLC victim (vic_shw)
// to one bit per target core, computes each target tile's mesh hop count
// to the home tile, and reduces: inv_lat = max over recorded non-self
// targets of 2*(h*link + (h+1)*router), inv_cnt and inv_hops (sums of 1
// and 2h over them), back_cnt and back_hops over the victim's sharers
// plus its owner. Plain version: kernels/reductions.py.
//
// Bound on the H100: integer operations, and in practice launch latency:
// the inputs are a few hundred KB and the dense work is C x 32*NW target
// pairs, ~1M at 1024 cores, of which only the rows of invalidating
// writers and evicting misses contribute anything.
// Design: one block per core; a row that neither invalidates nor evicts
// writes zeros at once (the work counted by the bound is the rows this
// run's data needs). Otherwise the threads stride over the targets and
// combine one max and four sums with warp shuffles and shared memory.

#include "common.cuh"

using namespace psim;

namespace {

constexpr int THREADS = 256;

__global__ void sharer_reductions_kernel(
    const int* __restrict__ shw, const int* __restrict__ vic_shw,
    const int* __restrict__ btile, const int* __restrict__ vic_owner,
    const int* __restrict__ inv_row, const int* __restrict__ vic_valid,
    const int* __restrict__ cid_v, const int* __restrict__ link_p,
    const int* __restrict__ router_p, int* __restrict__ inv_lat,
    int* __restrict__ inv_cnt, int* __restrict__ inv_hops,
    int* __restrict__ back_cnt, int* __restrict__ back_hops, int C, int NW,
    int n_tiles, int mesh_x) {
  const int c = blockIdx.x;
  const bool irow = inv_row[c] != 0;
  const bool vv = vic_valid[c] != 0;
  if (!irow && !vv) {
    if (threadIdx.x == 0) {
      inv_lat[c] = inv_cnt[c] = inv_hops[c] = 0;
      back_cnt[c] = back_hops[c] = 0;
    }
    return;
  }
  const int bt = btile[c];
  const int bx = floor_mod(bt, mesh_x), by = floor_div(bt, mesh_x);
  const int link = *link_p, router = *router_p;
  const int self = cid_v[c], vo = vic_owner[c];
  const int* sw = shw + (size_t)c * NW;
  const int* vw = vic_shw + (size_t)c * NW;

  int mlat = 0, icnt = 0, ihops = 0, bcnt = 0, bhops = 0;
  const int T = min(NW * 32, C);  // targets t >= C are padding bits
  for (int t = threadIdx.x; t < T; t += THREADS) {
    const int tt = floor_mod(t, n_tiles);
    const int h = abs(bx - floor_mod(tt, mesh_x)) + abs(by - floor_div(tt, mesh_x));
    if (irow && t != self && bit_at(sw[t >> 5], t & 31)) {
      mlat = max(mlat, 2 * (h * link + (h + 1) * router));
      icnt += 1;
      ihops += 2 * h;
    }
    if (vv && (bit_at(vw[t >> 5], t & 31) || (t == vo && vo >= 0))) {
      bcnt += 1;
      bhops += 2 * h;
    }
  }

  for (int off = 16; off > 0; off >>= 1) {
    mlat = max(mlat, __shfl_down_sync(0xffffffffu, mlat, off));
    icnt += __shfl_down_sync(0xffffffffu, icnt, off);
    ihops += __shfl_down_sync(0xffffffffu, ihops, off);
    bcnt += __shfl_down_sync(0xffffffffu, bcnt, off);
    bhops += __shfl_down_sync(0xffffffffu, bhops, off);
  }
  __shared__ int part[5][THREADS / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    part[0][warp] = mlat;
    part[1][warp] = icnt;
    part[2][warp] = ihops;
    part[3][warp] = bcnt;
    part[4][warp] = bhops;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < THREADS / 32; ++w) {
      mlat = max(mlat, part[0][w]);
      icnt += part[1][w];
      ihops += part[2][w];
      bcnt += part[3][w];
      bhops += part[4][w];
    }
    inv_lat[c] = mlat;
    inv_cnt[c] = icnt;
    inv_hops[c] = ihops;
    back_cnt[c] = bcnt;
    back_hops[c] = bhops;
  }
}

}  // namespace

extern "C" int sharer_reductions_launch(
    const int* shw, const int* vic_shw, const int* btile,
    const int* vic_owner, const int* inv_row, const int* vic_valid,
    const int* cid, const int* link, const int* router, int* inv_lat,
    int* inv_cnt, int* inv_hops, int* back_cnt, int* back_hops, int C, int NW,
    int n_tiles, int mesh_x, cudaStream_t stream) {
  sharer_reductions_kernel<<<C, THREADS, 0, stream>>>(
      shw, vic_shw, btile, vic_owner, inv_row, vic_valid, cid, link, router,
      inv_lat, inv_cnt, inv_hops, back_cnt, back_hops, C, NW, n_tiles,
      mesh_x);
  return (int)cudaGetLastError();
}
