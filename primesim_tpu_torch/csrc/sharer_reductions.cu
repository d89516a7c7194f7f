// sharer_reductions: the invalidation and back-invalidation reductions.
//
// Replaces the Pallas kernel primesim_tpu/kernels/reductions.py:
// sharer_reductions (_reduce_kernel). For every core it takes the packed
// sharer words of the accessed line (shw) and of the LLC victim (vic_shw)
// as sets of target cores, computes each target tile's hop count h to
// the home tile under the NoC topology, and reduces: inv_lat = max over
// recorded non-self targets of 2*(h*link + (h+1)*router), inv_cnt and
// inv_hops (sums of 1 and 2h over them), back_cnt and back_hops over the
// victim's sharers plus its owner (counted once when it is also a
// recorded sharer).
// Under the coarse sharer vector (logG > 0, each bit one group of 2^logG
// cores) it computes instead what the JAX engine computes in XLA for that
// case (primesim_tpu/sim/engine.py, the sharer_group > 1 branch of the
// target reductions): each set group bit g of a row stands for memb[g]
// cores, whose largest and summed round-trip hop counts from the home
// tile are max2hops[btile, g] and sum2hops[btile, g] (static tables).
// inv_lat is the max over the flagged groups, the requester's own
// included, of 2*(mh*link + (mh+1)*router) from each group's max hops;
// inv_cnt and inv_hops sum memb and sum2hops less the requester (one
// count and 2*its hops) when its group is flagged; back_cnt and
// back_hops sum the victim's groups plus its owner (one count, 2*its
// hops) when the owner's group bit is not set.
// The hop count follows the Pallas kernel's static `topology` mode,
// here the launch argument `topology`, the same for every thread: 0 the
// mesh's |dx| + |dy|; 1 the torus, the shorter way around each axis's
// ring, ring_dist(a, b, m) = min(|a - b|, m - |a - b|); 2 the rings, direct
// along the row when home and target share it, else via the column-0
// spine, ring_dist(ax, 0) + ring_dist(ay, by) + ring_dist(0, bx). The
// group mode's tables already hold the topology's hops (group_tables);
// its self and owner corrections take the same hop count.
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
// The coarse mode is the same warp per core over the set GROUP bits (8
// words at 16384 cores and 64-core groups: lanes 0-7 hold a word each):
// per set bit three table words (memb[g] and the home tile's two table
// entries) instead of a hop count, so the function needs the set bits'
// table words, not the [C, n_groups] expansion that the JAX engine
// builds. The requester's and the owner's group bits are tested by the
// lane that holds their word and OR-reduced. Which mode runs is the
// launch argument logG, the same for every thread.
// Lanes and targets: the launch's C lanes may be a block of the CT cores
// of the machine (a core shard of a tile mesh, cid[] their global ids);
// the sharer bits name targets below CT.
// Batch: one launch serves B simulations of one geometry (the fleet's).
// Warp g is core c = g % C of element b = g / C: its rows, flags, lanes
// and outputs sit at g, its link and router latencies at link[b] and
// router[b] (the fleet's elements may differ in both); the core ids
// cid[C] and the group tables are shared. A solo call is B = 1.

#include "common.cuh"

using namespace psim;

namespace {

constexpr int WARPS = 8;  // cores per block
constexpr unsigned FULL = 0xffffffffu;

// the bits of word w that name targets below n
__device__ __forceinline__ uint32_t valid_bits(int w, int n_targets) {
  const int n = n_targets - 32 * w;
  return n >= 32 ? FULL : (n <= 0 ? 0u : (1u << n) - 1u);
}

__device__ __forceinline__ int ring_dist(int a, int b, int m) {
  const int d = abs(a - b);
  return min(d, m - d);
}

__global__ void __launch_bounds__(WARPS * 32) sharer_reductions_kernel(
    const int* __restrict__ shw, const int* __restrict__ vic_shw,
    const int* __restrict__ btile, const int* __restrict__ vic_owner,
    const uint8_t* __restrict__ inv_row, const uint8_t* __restrict__ vic_valid,
    const int* __restrict__ cid_v, const int* __restrict__ link_p,
    const int* __restrict__ router_p, int* __restrict__ inv_lat,
    int* __restrict__ inv_cnt, int* __restrict__ inv_hops,
    int* __restrict__ back_cnt, int* __restrict__ back_hops,
    const int* __restrict__ memb, const int* __restrict__ max2hops,
    const int* __restrict__ sum2hops, int B, int C, int CT, int NW,
    int n_tiles, int mesh_x, int mesh_y, int topology, int vo_ld, int logG,
    int n_grp) {
  const int c = blockIdx.x * WARPS + (threadIdx.x >> 5);  // over B*C
  const int lane = threadIdx.x & 31;
  if (c >= B * C) return;  // the whole warp leaves together
  const int b = c / C;  // the element
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
  const uint32_t link = (uint32_t)link_p[b], router = (uint32_t)router_p[b];
  const int self = cid_v[c - b * C], vo = vic_owner[(size_t)c * vo_ld];
  const int* sw = shw + (size_t)c * NW;
  const int* vw = vic_shw + (size_t)c * NW;

  auto hops_to = [&](int t) {  // hops from the home tile to core t's tile
    const int tt = t % n_tiles;
    const int tx = tt % mesh_x, ty = tt / mesh_x;
    int h;
    if (topology == 1) {
      h = ring_dist(bx, tx, mesh_x) + ring_dist(by, ty, mesh_y);
    } else if (topology == 2) {
      h = by == ty ? ring_dist(bx, tx, mesh_x)
                   : ring_dist(bx, 0, mesh_x) + ring_dist(by, ty, mesh_y) +
                         ring_dist(0, tx, mesh_x);
    } else {
      h = abs(bx - tx) + abs(by - ty);
    }
    return (uint32_t)h;
  };

  int mlat = 0;
  uint32_t icnt = 0, ihops = 0, bcnt = 0, bhops = 0;
  if (logG > 0) {
    const int* mh_row = max2hops + (size_t)bt * n_grp;
    const int* sh_row = sum2hops + (size_t)bt * n_grp;
    const int gs = self >> logG, og = max(vo, 0) >> logG;
    unsigned self_rec = 0, own_rec = 0;
    for (int w = lane; w < NW; w += 32) {
      const uint32_t valid = valid_bits(w, n_grp);
      if (irow) {
        uint32_t m = (uint32_t)sw[w] & valid;
        if ((gs >> 5) == w) self_rec = (m >> (gs & 31)) & 1u;
        while (m) {
          const int g = 32 * w + __ffs(m) - 1;
          m &= m - 1;
          const uint32_t mh = (uint32_t)mh_row[g];
          icnt += (uint32_t)memb[g];
          ihops += (uint32_t)sh_row[g];
          mlat = max(mlat, (int)(2u * (mh * link + (mh + 1u) * router)));
        }
      }
      if (vv) {
        uint32_t m = (uint32_t)vw[w] & valid;
        if ((og >> 5) == w) own_rec = (m >> (og & 31)) & 1u;
        while (m) {
          const int g = 32 * w + __ffs(m) - 1;
          m &= m - 1;
          bcnt += (uint32_t)memb[g];
          bhops += (uint32_t)sh_row[g];
        }
      }
    }
    mlat = __reduce_max_sync(FULL, mlat);
    icnt = __reduce_add_sync(FULL, icnt);
    ihops = __reduce_add_sync(FULL, ihops);
    bcnt = __reduce_add_sync(FULL, bcnt);
    bhops = __reduce_add_sync(FULL, bhops);
    self_rec = __reduce_or_sync(FULL, self_rec);
    own_rec = __reduce_or_sync(FULL, own_rec);
    if (lane == 0) {
      if (self_rec) {  // the requester is no message (set only when irow)
        icnt -= 1u;
        ihops -= 2u * hops_to(self);
      }
      if (vv && vo >= 0 && !own_rec) {  // the owner outside its group bit
        bcnt += 1u;
        bhops += 2u * hops_to(vo);
      }
      inv_lat[c] = mlat;
      inv_cnt[c] = (int)icnt;
      inv_hops[c] = (int)ihops;
      back_cnt[c] = (int)bcnt;
      back_hops[c] = (int)bhops;
    }
    return;
  }
  for (int w = lane; w < NW; w += 32) {
    const uint32_t valid = valid_bits(w, CT);
    if (irow) {
      uint32_t m = (uint32_t)sw[w] & valid;
      if (self >= 0 && (self >> 5) == w) m &= ~(1u << (self & 31));
      icnt += __popc(m);
      while (m) {
        const int t = 32 * w + __ffs(m) - 1;
        m &= m - 1;
        const uint32_t h = hops_to(t);
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
        bhops += 2u * hops_to(t);
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
    int* inv_cnt, int* inv_hops, int* back_cnt, int* back_hops,
    const int* memb, const int* max2hops, const int* sum2hops, int B, int C,
    int CT, int NW, int n_tiles, int mesh_x, int mesh_y, int topology,
    int vo_ld, int logG, int n_grp, cudaStream_t stream) {
  const int blocks = (B * C + WARPS - 1) / WARPS;
  sharer_reductions_kernel<<<blocks, WARPS * 32, 0, stream>>>(
      shw, vic_shw, btile, vic_owner, inv_row, vic_valid, cid, link, router,
      inv_lat, inv_cnt, inv_hops, back_cnt, back_hops, memb, max2hops,
      sum2hops, B, C, CT, NW, n_tiles, mesh_x, mesh_y, topology, vo_ld,
      logG, n_grp);
  return (int)cudaGetLastError();
}
