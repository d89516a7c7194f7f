// sharer_reductions: the invalidation and back-invalidation reductions.
//
// Replaces the Pallas kernel primesim_tpu/kernels/reductions.py:
// sharer_reductions (_reduce_kernel). For every core it takes the packed
// sharer words of the accessed line (shw) and of the LLC victim (vic_shw)
// as sets of target cores, computes each target tile's mesh hop count h
// to the home tile, and reduces: inv_lat = max over recorded non-self
// targets of 2*(h*link + (h+1)*router), inv_cnt and inv_hops (sums of 1
// and 2h over them), back_cnt and back_hops over the victim's sharers
// plus its owner (counted once when it is also a recorded sharer).
// Plain version: kernels/reductions.py.
//
// Bound on the H100: bytes, and in practice launch latency. The function
// needs both flags of every row, the lanes and sharer words of the rows
// that invalidate or evict (about 70 of 1024 on a headline step) and the
// five outputs: about 32 KB. Its integer work is a few operations per set
// bit of those rows' words.
// Design: one warp per core, 8 cores per 256-thread block (128 blocks at
// 1024 cores). The flags are read as the bytes of the engine's bool
// tensors and vic_owner through its stride (a column of the probe's
// lanes), so the wrapper launches this kernel and nothing else. A row
// that neither invalidates nor evicts writes its five zeros and leaves.
// Otherwise lane l takes the sharer words w = l (mod 32): it masks off
// the padding bits of targets >= C, clears the self bit of the
// invalidation set, ORs the victim owner's bit into the back-invalidation
// set, counts each set with __popc and walks its set bits with __ffs for
// the hop sums and the latency max. One __reduce_max_sync and four
// __reduce_add_sync combine the lanes: no shared memory, no barrier.
// The latency is computed bit by bit, not from the row's largest h: the
// two agree only while 2*(h*link + (h+1)*router) does not wrap, and the
// configuration bounds the latencies from below only. Sums and products
// go through uint32_t (common.cuh), as int32 wraps in JAX.

#include "common.cuh"

using namespace psim;

namespace {

constexpr int WARPS = 8;  // cores per block
constexpr unsigned FULL = 0xffffffffu;

// the bits of word w that name targets below C
__device__ __forceinline__ uint32_t valid_bits(int w, int C) {
  const int n = C - 32 * w;
  return n >= 32 ? FULL : (n <= 0 ? 0u : (1u << n) - 1u);
}

__global__ void __launch_bounds__(WARPS * 32) sharer_reductions_kernel(
    const int* __restrict__ shw, const int* __restrict__ vic_shw,
    const int* __restrict__ btile, const int* __restrict__ vic_owner,
    const uint8_t* __restrict__ inv_row, const uint8_t* __restrict__ vic_valid,
    const int* __restrict__ cid_v, const int* __restrict__ link_p,
    const int* __restrict__ router_p, int* __restrict__ inv_lat,
    int* __restrict__ inv_cnt, int* __restrict__ inv_hops,
    int* __restrict__ back_cnt, int* __restrict__ back_hops, int C, int NW,
    int n_tiles, int mesh_x, int vo_ld) {
  const int c = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (c >= C) return;  // the whole warp leaves together
  const bool irow = inv_row[c] != 0;
  const bool vv = vic_valid[c] != 0;
  if (!irow && !vv) {
    if (lane == 0) {
      inv_lat[c] = inv_cnt[c] = inv_hops[c] = 0;
      back_cnt[c] = back_hops[c] = 0;
    }
    return;
  }
  const int bt = btile[c];
  const int bx = floor_mod(bt, mesh_x), by = floor_div(bt, mesh_x);
  const uint32_t link = (uint32_t)*link_p, router = (uint32_t)*router_p;
  const int self = cid_v[c], vo = vic_owner[(size_t)c * vo_ld];
  const int* sw = shw + (size_t)c * NW;
  const int* vw = vic_shw + (size_t)c * NW;

  int mlat = 0;
  uint32_t icnt = 0, ihops = 0, bcnt = 0, bhops = 0;
  for (int w = lane; w < NW; w += 32) {
    const uint32_t valid = valid_bits(w, C);
    if (irow) {
      uint32_t m = (uint32_t)sw[w] & valid;
      if (self >= 0 && (self >> 5) == w) m &= ~(1u << (self & 31));
      icnt += __popc(m);
      while (m) {
        const int t = 32 * w + __ffs(m) - 1;
        m &= m - 1;
        const int tt = t % n_tiles;
        const uint32_t h = abs(bx - tt % mesh_x) + abs(by - tt / mesh_x);
        ihops += 2u * h;
        mlat = max(mlat, (int)(2u * (h * link + (h + 1u) * router)));
      }
    }
    if (vv) {
      uint32_t m = (uint32_t)vw[w];
      if (vo >= 0 && (vo >> 5) == w) m |= 1u << (vo & 31);
      m &= valid;
      bcnt += __popc(m);
      while (m) {
        const int t = 32 * w + __ffs(m) - 1;
        m &= m - 1;
        const int tt = t % n_tiles;
        bhops += 2u * (abs(bx - tt % mesh_x) + abs(by - tt / mesh_x));
      }
    }
  }
  mlat = __reduce_max_sync(FULL, mlat);
  icnt = __reduce_add_sync(FULL, icnt);
  ihops = __reduce_add_sync(FULL, ihops);
  bcnt = __reduce_add_sync(FULL, bcnt);
  bhops = __reduce_add_sync(FULL, bhops);
  if (lane == 0) {
    inv_lat[c] = mlat;
    inv_cnt[c] = (int)icnt;
    inv_hops[c] = (int)ihops;
    back_cnt[c] = (int)bcnt;
    back_hops[c] = (int)bhops;
  }
}

}  // namespace

extern "C" int sharer_reductions_launch(
    const int* shw, const int* vic_shw, const int* btile,
    const int* vic_owner, const uint8_t* inv_row, const uint8_t* vic_valid,
    const int* cid, const int* link, const int* router, int* inv_lat,
    int* inv_cnt, int* inv_hops, int* back_cnt, int* back_hops, int C, int NW,
    int n_tiles, int mesh_x, int vo_ld, cudaStream_t stream) {
  const int blocks = (C + WARPS - 1) / WARPS;
  sharer_reductions_kernel<<<blocks, WARPS * 32, 0, stream>>>(
      shw, vic_shw, btile, vic_owner, inv_row, vic_valid, cid, link, router,
      inv_lat, inv_cnt, inv_hops, back_cnt, back_hops, C, NW, n_tiles,
      mesh_x, vo_ld);
  return (int)cudaGetLastError();
}
