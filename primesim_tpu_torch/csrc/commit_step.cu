// commit_step: phase 4.A of the step plus the counter fold.
//
// Replaces the Pallas kernel primesim_tpu/kernels/step_kernels.py:
// commit_step (_commit_kernel). For every core it makes the 7 + 2*rl
// ordered L1 plane writes (stale-duplicate clear, LRU stamp, state, fill
// tag / way pointer / epoch, then the local run's LRU and E->M writes),
// computes the winner's full directory-row delta and a joiner's LRU /
// sharer-bit delta, and folds `counters + delta`. The engine then applies
// the one data-dependent row scatter: dirm[upd_slot] += delta_row. Plain
// version: kernels/step_kernels.py.
//
// Bound on the H100: device-memory bytes. As defined (same contract as
// the Pallas kernel) the function returns a new L1, so it reads and
// writes the whole [C, 5*W1*S1] array (2 x 10.5 MB at 1024 cores) besides
// the [C, DW] home rows and deltas. An in-place L1 update would move only
// the few written words; that is a later design change.
// Design: one block per core. Its threads copy the L1 row with coalesced
// loads and compute the DW-wide row delta column by column; after a
// barrier, thread 0 applies the ordered writes in exactly the Pallas
// kernel's order (later writes win). Wrapping arithmetic goes through
// uint32_t (common.cuh).

#include "common.cuh"

using namespace psim;

namespace {

// commit lane columns (kernels/step_kernels.py CL_*)
enum {
  CL_LINE, CL_HIT_WAY, CL_L1_VWAY, CL_HIT, CL_WRITE_HIT, CL_UPG_IN_PLACE,
  CL_WINNER, CL_JOIN, CL_LLC_HIT, CL_ST_VAL, CL_SLOT, CL_LLC_HWAY,
  CL_LLC_VWAY, CL_JREP, CL_TAKES_OWN, CL_GETS_PROBE, CL_GETS_SHARED,
  CL_OCLAMP, COMMIT_LANES
};

__global__ void commit_step_kernel(
    const int* __restrict__ l1, const int* __restrict__ mrows,
    const int* __restrict__ tag_rows, const int* __restrict__ shw,
    const int* __restrict__ lanes, const int* __restrict__ cid_v,
    const int* __restrict__ step_p, const int* __restrict__ counters,
    const int* __restrict__ delta, const int* __restrict__ hm,
    const int* __restrict__ wm, const int* __restrict__ cm,
    int* __restrict__ l1_out, int* __restrict__ drow_out,
    int* __restrict__ cnt_out, int C, int S1, int W1, int W2, int NW, int MW,
    int DW, int NC, int rl) {
  const int c = blockIdx.x;
  const int FS = W1 * S1;
  const int L1W = 5 * FS;
  const int* row = l1 + (size_t)c * L1W;
  int* orow = l1_out + (size_t)c * L1W;
  const int* mr = mrows + (size_t)c * DW;
  const int* ln = lanes + (size_t)c * COMMIT_LANES;
  const int* sh = shw + (size_t)c * NW;
  const int cid = cid_v[c];
  const int step = *step_p;

  for (int j = threadIdx.x; j < L1W; j += blockDim.x) orow[j] = row[j];
  for (int k = threadIdx.x; k < NC; k += blockDim.x) {
    const size_t i = (size_t)k * C + c;
    cnt_out[i] = wrap_add(counters[i], delta[i]);
  }

  const int line = ln[CL_LINE];
  const int slot = ln[CL_SLOT];
  const int hway = ln[CL_LLC_HWAY];
  const int vway = ln[CL_LLC_VWAY];
  const int oclamp = ln[CL_OCLAMP];
  const bool winner = ln[CL_WINNER] != 0;
  const bool join = ln[CL_JOIN] != 0;
  const bool llc_hit = ln[CL_LLC_HIT] != 0;
  const bool jrep = ln[CL_JREP] != 0;
  const bool takes_own = ln[CL_TAKES_OWN] != 0;
  const bool gets_probe = ln[CL_GETS_PROBE] != 0;
  const bool gets_shared = ln[CL_GETS_SHARED] != 0;
  const int uway = llc_hit ? hway : vway;
  const int eph_way = join ? hway : uway;
  const int new_eph = wrap_add(mr[3 * W2 + eph_way], takes_own ? 1 : 0);
  const int new_owner = takes_own ? cid : -1;

  // ---- directory row delta, one column per thread
  const int self_w = cid >> 5, self_b = cid & 31;
  const int own_w = oclamp >> 5, own_b = oclamp & 31;
  const int jdelta = jrep ? wrap_sub(step, mr[2 * W2 + hway]) : 0;
  for (int j = threadIdx.x; j < DW; j += blockDim.x) {
    const int old = mr[j];
    int nv = old, jv = 0;
    if (j < 2 * W2) {
      if ((j >> 1) == uway) nv = (j & 1) == 0 ? line : new_owner;
    } else if (j < 3 * W2) {
      if (j - 2 * W2 == uway) nv = step;
      if (j - 2 * W2 == hway) jv = jdelta;
    } else if (j < 4 * W2) {
      if (j - 3 * W2 == uway) nv = new_eph;
    } else if (j >= MW) {
      const int w_sh = (j - MW) / NW, n = (j - MW) % NW;
      const int sw = sh[n];
      const int self_word = n == self_w ? bit_word(self_b) : 0;
      const int owner_word = n == own_w ? bit_word(own_b) : 0;
      if (w_sh == uway)
        nv = gets_probe ? (self_word | owner_word)
                        : (gets_shared ? (sw | self_word) : 0);
      if (w_sh == hway) jv = self_word & ~sw;
    }
    drow_out[(size_t)c * DW + j] = winner ? wrap_sub(nv, old) : (join ? jv : 0);
  }

  __syncthreads();
  if (threadIdx.x != 0) return;

  // ---- ordered L1 plane writes (step_kernels.py _commit_kernel order)
  const int hit_way = ln[CL_HIT_WAY];
  const bool hit = ln[CL_HIT] != 0;
  const bool write_hit = ln[CL_WRITE_HIT] != 0;
  const bool upg = ln[CL_UPG_IN_PLACE] != 0;
  const int l1s = line & (S1 - 1);
  const int upd_way = upg ? hit_way : ln[CL_L1_VWAY];
  const int hit_col = hit_way * S1 + l1s;
  const int upd_col = upd_way * S1 + l1s;
  const bool fill = (winner && !upg) || join;
  int t_way = 0;
  bool any_tagm = false;
  for (int w = W1 - 1; w >= 0; --w) {
    if (tag_rows[(size_t)c * W1 + w] == line) {
      t_way = w;
      any_tagm = true;
    }
  }
  const bool dup = fill && any_tagm && t_way != upd_way;
  const int dup_col = t_way * S1 + l1s;
  const bool wj = winner || join;
  const bool st_m = write_hit || wj;
  const int st_col = write_hit ? hit_col : upd_col;
  const int fill_ptr = slot * W2 + ((join || llc_hit) ? hway : vway);
  auto wr = [&](bool m, int col, int val) {
    if (m && col >= 0 && col < L1W) orow[col] = val;
  };
  wr(dup, dup_col, -1);
  wr(dup, dup_col + FS, I);
  wr(hit || wj, (hit ? hit_col : upd_col) + 2 * FS, step);
  wr(st_m, st_col + FS, ln[CL_ST_VAL]);
  wr(wj, upd_col, line);
  wr(wj, upd_col + 3 * FS, fill_ptr);
  wr(wj, upd_col + 4 * FS, new_eph);
  for (int k = 0; k < rl; ++k) {
    const size_t i = (size_t)c * rl + k;
    const int cmk = cm[i];
    wr(hm[i] != 0, cmk + 2 * FS, step);
    wr(wm[i] != 0 && !(st_m && st_col == cmk), cmk + FS, M);
  }
}

}  // namespace

extern "C" int commit_step_launch(
    const int* l1, const int* mrows, const int* tag_rows, const int* shw,
    const int* lanes, const int* cid, const int* step, const int* counters,
    const int* delta, const int* hm, const int* wm, const int* cm,
    int* l1_out, int* drow_out, int* cnt_out, int C, int S1, int W1, int W2,
    int NW, int MW, int DW, int NC, int rl, cudaStream_t stream) {
  commit_step_kernel<<<C, 256, 0, stream>>>(
      l1, mrows, tag_rows, shw, lanes, cid, step, counters, delta, hm, wm, cm,
      l1_out, drow_out, cnt_out, C, S1, W1, W2, NW, MW, DW, NC, rl);
  return (int)cudaGetLastError();
}
