// commit_step: phase 4.A of the step plus the counter fold, in place.
//
// Replaces the Pallas kernel primesim_tpu/kernels/step_kernels.py:
// commit_step (_commit_kernel) together with the engine's row scatter
// after it, dirm.at[upd_slot].add(delta_row, mode="drop"). For every core
// it makes the 7 + 2*rl ordered L1 plane writes (stale-duplicate clear,
// LRU stamp, state, fill tag / way pointer / epoch, then the local run's
// LRU and E->M writes) straight into the core's own L1 row; a winner adds
// its directory delta (tag/owner pair, LRU, epoch and NW sharer words of
// the updated way) and a joiner its LRU delta and self bit to row `slot`
// of dirm; other lanes add nothing. Then counters += delta. The old
// home-row words come from probe_classify's lanes and sharer words, so
// the kernel never reads dirm. The adds are atomicAdd on unsigned int:
// wraparound is the int32 arithmetic of the JAX package, and the sum of
// the winner's and the joiners' deltas on one slot does not depend on the
// order of the atomics. Under the coarse sharer vector (logG > 0) the
// self and owner bits are the cores' groups, cid >> logG and
// oclamp >> logG; the engine never joins there (same-group joiners'
// bits would not commit independently), so the join branch is not taken.
// Under MOESI (moesi = 1, the Pallas kernel's static `moesi` mode) a GETS
// probe keeps the probed owner recorded (its line derives to Owned) and
// the sharer word becomes the old word OR the requester OR the owner:
// the winner's owner delta is oclamp - old and each word's delta
// (shw | self | owner) - shw, an unsigned add that wraps like int32, so
// the bits already set, bit 31 among them, stay as they were. MOESI runs
// only on the full map (the wrapper checks sharer_group == 1).
// Plain version: kernels/step_kernels.py.
//
// Bound on the H100: device-memory bytes. In place, the function moves
// only the L1 and directory words it changes, the [NC, C] counters in and
// out with the delta, the lanes and the probe outputs it reads: about
// 0.5 MB at 1024 cores, some 0.2 us at 3.35 TB/s (chip_smoke.py computes
// it from a staged step). The functional contract of the Pallas kernel
// copied the whole 10.5 MB L1 each step; this one does not.
// Design: one warp per core, 8 cores per 256-thread block. Lane k loads
// lane word k of the core's commit and probe lanes (coalesced) and the
// warp shares them by __shfl_sync. Lane 0 makes the ordered L1 writes, in
// the Pallas kernel's order (later writes win; rows of different cores
// are disjoint); lanes 0-3 add the winner's pair, LRU and epoch words and
// lane n < NW (in strides of 32) sharer word n. The block folds the
// counters of its 8 cores, each of the NC rows as 8 contiguous words.
// Batch: one launch serves B simulations of one geometry (the fleet's).
// Warp g is core c = g % C of element b = g / C: its L1 row, lanes and
// probe outputs sit at g, its directory at dirm + b*NS*DW (a 64-bit
// offset), so every atomicAdd stays inside its element's directory, its
// counters at counters[b][k][c] and its step number at step[b]; the core
// ids cid[C] are shared. A solo call is B = 1.

#include "common.cuh"

using namespace psim;

namespace {

constexpr int WARPS = 8;  // cores per block
constexpr unsigned FULL = 0xffffffffu;

// commit lane columns (kernels/step_kernels.py CL_*)
enum {
  CL_LINE, CL_HIT_WAY, CL_L1_VWAY, CL_HIT, CL_WRITE_HIT, CL_UPG_IN_PLACE,
  CL_WINNER, CL_JOIN, CL_LLC_HIT, CL_ST_VAL, CL_SLOT, CL_LLC_HWAY,
  CL_LLC_VWAY, CL_JREP, CL_TAKES_OWN, CL_GETS_PROBE, CL_GETS_SHARED,
  CL_OCLAMP, COMMIT_LANES
};

// probe lane columns read here (kernels/step_kernels.py PL_*)
enum {
  PL_OWNER = 5, PL_VIC_TAG = 8, PL_VIC_OWNER = 9, PL_HOME_TAG = 11,
  PL_HOME_LRU, PL_HOME_EPOCH, PL_VIC_LRU, PL_VIC_EPOCH, PROBE_LANES
};

__device__ __forceinline__ void add_word(int* dirm, size_t i, int d) {
  if (d != 0) atomicAdd(reinterpret_cast<unsigned*>(dirm) + i, (unsigned)d);
}

__global__ void __launch_bounds__(WARPS * 32) commit_step_kernel(
    int* __restrict__ l1, int* __restrict__ dirm,
    const int* __restrict__ tag_rows, const int* __restrict__ shw,
    const int* __restrict__ vshw, const int* __restrict__ lanes,
    const int* __restrict__ pc_lanes, const int* __restrict__ cid_v,
    const int* __restrict__ step_p, int* __restrict__ counters,
    const int* __restrict__ delta, const uint8_t* __restrict__ hm,
    const uint8_t* __restrict__ wm, const int* __restrict__ cm, int B,
    int C, int NS, int S1, int W1, int W2, int NW, int MW, int DW, int NC,
    int rl, int cm_ld, int logG, int moesi) {
  const int c0 = blockIdx.x * WARPS;  // warps run over B*C
  for (int t = threadIdx.x; t < NC * WARPS; t += blockDim.x) {
    const int g = c0 + t % WARPS;
    if (g < B * C) {
      const int gb = g / C;
      const size_t i = ((size_t)gb * NC + t / WARPS) * C + (g - gb * C);
      counters[i] = wrap_add(counters[i], delta[i]);
    }
  }
  const int lane = threadIdx.x & 31;
  const int c = c0 + (threadIdx.x >> 5);
  if (c >= B * C) return;  // the whole warp
  const int b = c / C;  // the element

  const int lv = lane < COMMIT_LANES ? lanes[(size_t)c * COMMIT_LANES + lane] : 0;
  const int pv = lane < PROBE_LANES ? pc_lanes[(size_t)c * PROBE_LANES + lane] : 0;
  const int tr = lane < W1 ? tag_rows[(size_t)c * W1 + lane] : 0;
  int hk = 0, wk = 0, ck = 0;  // run slot `lane`
  if (lane < rl) {
    hk = hm[(size_t)c * rl + lane];
    wk = wm[(size_t)c * rl + lane];
    ck = cm[(size_t)c * cm_ld + lane];
  }
  const int cid = cid_v[c - b * C];
  const int step = step_p[b];
  auto cl = [&](int k) { return __shfl_sync(FULL, lv, k); };
  auto pl = [&](int k) { return __shfl_sync(FULL, pv, k); };

  const int line = cl(CL_LINE);
  const int hit_way = cl(CL_HIT_WAY);
  const int l1_vway = cl(CL_L1_VWAY);
  const bool hit = cl(CL_HIT) != 0;
  const bool write_hit = cl(CL_WRITE_HIT) != 0;
  const bool upg = cl(CL_UPG_IN_PLACE) != 0;
  const bool winner = cl(CL_WINNER) != 0;
  const bool join = cl(CL_JOIN) != 0;
  const bool llc_hit = cl(CL_LLC_HIT) != 0;
  const int st_val = cl(CL_ST_VAL);
  const int slot = cl(CL_SLOT);
  const int hway = cl(CL_LLC_HWAY);
  const int vway = cl(CL_LLC_VWAY);
  const bool jrep = cl(CL_JREP) != 0;
  const bool takes_own = cl(CL_TAKES_OWN) != 0;
  const bool gets_probe = cl(CL_GETS_PROBE) != 0;
  const bool gets_shared = cl(CL_GETS_SHARED) != 0;
  const int oclamp = cl(CL_OCLAMP);
  // the old home-row words at the updated way (hit way on an LLC hit,
  // victim otherwise) and the hit way's LRU and epoch
  const int o_tag = llc_hit ? pl(PL_HOME_TAG) : pl(PL_VIC_TAG);
  const int o_own = llc_hit ? pl(PL_OWNER) : pl(PL_VIC_OWNER);
  const int o_lru = llc_hit ? pl(PL_HOME_LRU) : pl(PL_VIC_LRU);
  const int o_eph = llc_hit ? pl(PL_HOME_EPOCH) : pl(PL_VIC_EPOCH);
  const int h_lru = pl(PL_HOME_LRU);
  const int h_eph = pl(PL_HOME_EPOCH);
  const int uway = llc_hit ? hway : vway;
  // the fill epoch's way is join ? hway : uway
  const int new_eph = wrap_add(join ? h_eph : o_eph, takes_own ? 1 : 0);
  const unsigned tmatch = __ballot_sync(FULL, lane < W1 && tr == line);

  // ---- ordered L1 plane writes (step_kernels.py _commit_kernel order)
  const int FS = W1 * S1;
  const int L1W = 5 * FS;
  int* row = l1 + (size_t)c * L1W;
  const int l1s = line & (S1 - 1);
  const int upd_way = upg ? hit_way : l1_vway;
  const int hit_col = hit_way * S1 + l1s;
  const int upd_col = upd_way * S1 + l1s;
  const bool wj = winner || join;
  const bool st_m = write_hit || wj;
  const int st_col = write_hit ? hit_col : upd_col;
  auto wr = [&](bool m, int col, int val) {
    if (m && col >= 0 && col < L1W) row[col] = val;
  };
  if (lane == 0) {
    const bool fill = (winner && !upg) || join;
    const int t_way = tmatch ? __ffs(tmatch) - 1 : 0;
    const bool dup = fill && tmatch != 0 && t_way != upd_way;
    const int dup_col = t_way * S1 + l1s;
    const int fill_ptr = slot * W2 + ((join || llc_hit) ? hway : vway);
    wr(dup, dup_col, -1);
    wr(dup, dup_col + FS, I);
    wr(hit || wj, (hit ? hit_col : upd_col) + 2 * FS, step);
    wr(st_m, st_col + FS, st_val);
    wr(wj, upd_col, line);
    wr(wj, upd_col + 3 * FS, fill_ptr);
    wr(wj, upd_col + 4 * FS, new_eph);
  }
  for (int k = 0; k < rl; ++k) {
    const int cmk = __shfl_sync(FULL, ck, k);
    const int h = __shfl_sync(FULL, hk, k);
    const int w = __shfl_sync(FULL, wk, k);
    if (lane == 0) {
      wr(h != 0, cmk + 2 * FS, step);
      wr(w != 0 && !(st_m && st_col == cmk), cmk + FS, M);
    }
  }

  // ---- directory deltas, added to row `slot`
  if (!wj) return;
  int* drow = dirm + ((size_t)b * NS + slot) * DW;
  const int grp = cid >> logG;  // the core's sharer bit: itself or its group
  const int self_w = grp >> 5, self_b = grp & 31;
  if (winner) {
    if (lane < 4) {
      const int col = lane < 2 ? 2 * uway + lane : (lane == 2 ? 2 * W2 : 3 * W2) + uway;
      const int new_owner = (moesi && gets_probe) ? oclamp : (takes_own ? cid : -1);
      const int nv = lane == 0 ? line
                   : lane == 1 ? new_owner
                   : lane == 2 ? step : new_eph;
      const int ov = lane == 0 ? o_tag : lane == 1 ? o_own : lane == 2 ? o_lru : o_eph;
      add_word(drow, col, wrap_sub(nv, ov));
    }
    const int ogrp = oclamp >> logG;
    const int own_w = ogrp >> 5, own_b = ogrp & 31;
    const int* old_sh = (llc_hit ? shw : vshw) + (size_t)c * NW;
    for (int n = lane; n < NW; n += 32) {
      const int self_word = n == self_w ? bit_word(self_b) : 0;
      const int owner_word = n == own_w ? bit_word(own_b) : 0;
      const int old_w = moesi ? shw[(size_t)c * NW + n] : 0;  // MESI: replaced
      const int nv = gets_probe ? (old_w | self_word | owner_word)
                   : gets_shared ? (shw[(size_t)c * NW + n] | self_word) : 0;
      add_word(drow, MW + uway * NW + n, wrap_sub(nv, old_sh[n]));
    }
  } else {
    if (lane == 0 && jrep) add_word(drow, 2 * W2 + hway, wrap_sub(step, h_lru));
    if (lane == (self_w & 31)) {  // the self bit, unless already a sharer
      const int sw = shw[(size_t)c * NW + self_w];
      add_word(drow, MW + hway * NW + self_w, bit_word(self_b) & ~sw);
    }
  }
}

}  // namespace

extern "C" int commit_step_launch(
    int* l1, int* dirm, const int* tag_rows, const int* shw, const int* vshw,
    const int* lanes, const int* pc_lanes, const int* cid, const int* step,
    int* counters, const int* delta, const uint8_t* hm, const uint8_t* wm,
    const int* cm, int B, int C, int NS, int S1, int W1, int W2, int NW,
    int MW, int DW, int NC, int rl, int cm_ld, int logG, int moesi,
    cudaStream_t stream) {
  commit_step_kernel<<<(B * C + WARPS - 1) / WARPS, WARPS * 32, 0, stream>>>(
      l1, dirm, tag_rows, shw, vshw, lanes, pc_lanes, cid, step, counters,
      delta, hm, wm, cm, B, C, NS, S1, W1, W2, NW, MW, DW, NC, rl, cm_ld,
      logG, moesi);
  return (int)cudaGetLastError();
}
