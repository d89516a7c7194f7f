"""The hop-by-hop router's wait floors, contention cascade and departures.

`router_cascade` replaces the JAX package's Pallas kernel
`kernels/router_kernels.py::router_cascade` (`_cascade_kernel`): on CUDA
tensors it launches `csrc/router_cascade.cu`; on CPU tensors it runs the
plain version below. Per leg of every core (request, reply, and the
barrier-arrival leg when the trace has sync events) over the H hops of
its -1-padded XY route:

    F_k = ok_k ? max(link_free_k, base_k) + rank_k * link_lat : SENT
    t_k = max(t_start + router_lat, cummax_{k' <= k}(F_k' - k'c)) + k c,
    c = link_lat + router_lat,

the leg's end time max(t_start + router_lat, cummax over the whole row)
+ hops * c, and each hop's departure max(t_start + router_lat, cummax)
+ k c + link_lat. The request and arrival legs start at t0; the reply
leg at the request leg's end plus the service time.

The boundary is the JAX package's: the engine gathers `link_free` and
`base` at every hop before the call and scatters the departures into
`link_free` after it; the inputs are the staged [C, legs*H] rows.
All arithmetic is int32 and wraps, as in JAX.
"""

from __future__ import annotations

import torch

from . import build
from .layouts import check_tensor

#: masked-hop wait floor, below any real one and still representable
#: after the - k*c offsets of every hop
SENT = -(1 << 30) - (1 << 21)
_i32 = torch.int32


def router_cascade_plain(
    lf_all, bs_all, r_all, ok_all, t0, service, req_hops, rep_hops,
    arr_hops, link_lat, router_lat, *, has_sync: bool,
):
    """Plain torch version: returns (t_rep_end [C], t_arr_end [C] or
    None, departs [C, legs*H]), all int32."""
    legs = 3 if has_sync else 2
    H = lf_all.shape[1] // legs
    L, R = link_lat, router_lat
    c = L + R
    hidx = torch.arange(H, dtype=_i32, device=lf_all.device)[None, :]
    F = torch.where(ok_all, torch.maximum(lf_all, bs_all) + r_all * L, SENT)

    def leg(k, t_start, nh):
        cum = (F[:, k * H : (k + 1) * H] - hidx * c).cummax(1).values
        t1 = t_start + R
        t_end = torch.maximum(t1, cum[:, -1]) + nh * c
        return t_end, torch.maximum(t1[:, None], cum) + hidx * c + L

    t_req_end, d_req = leg(0, t0, req_hops)
    t_rep_end, d_rep = leg(1, t_req_end + service, rep_hops)
    deps = [d_req, d_rep]
    t_arr_end = None
    if has_sync:
        t_arr_end, d_arr = leg(2, t0, arr_hops)
        deps.append(d_arr)
    return t_rep_end, t_arr_end, torch.cat(deps, 1)


def router_cascade(
    lf_all, bs_all, r_all, ok_all, t0, service, req_hops, rep_hops,
    arr_hops, link_lat, router_lat, *, has_sync: bool,
):
    """The kernel on CUDA tensors, its plain version on CPU tensors.
    `ok_all` is bool, everything else int32; `link_lat`/`router_lat` are
    0-d tensors on the same device, and `arr_hops` is read only when
    `has_sync` (pass None otherwise)."""
    dev = lf_all.device
    if dev.type == "cpu":
        return router_cascade_plain(
            lf_all, bs_all, r_all, ok_all, t0, service, req_hops, rep_hops,
            arr_hops, link_lat, router_lat, has_sync=has_sync,
        )
    if dev.type != "cuda":
        raise ValueError(f"router_cascade: unsupported device {dev}")
    legs = 3 if has_sync else 2
    C, LH = lf_all.shape
    if LH % legs:
        raise ValueError(f"router_cascade: {LH} hop columns are not {legs} legs")
    for name, x in (("lf_all", lf_all), ("bs_all", bs_all), ("r_all", r_all)):
        check_tensor(name, x, (C, LH), dev)
    check_tensor("ok_all", ok_all, (C, LH), dev, torch.bool)  # read as bytes
    lanes = [t0, service, req_hops, rep_hops] + ([arr_hops] if has_sync else [])
    for name, x in zip(("t0", "service", "req_hops", "rep_hops", "arr_hops"), lanes):
        check_tensor(name, x, (C,), dev)
    for name, x in (("link_lat", link_lat), ("router_lat", router_lat)):
        check_tensor(name, x, (), dev)
    t_rep = torch.empty(C, dtype=_i32, device=dev)
    t_arr = torch.empty(C, dtype=_i32, device=dev) if has_sync else None
    departs = torch.empty(C, LH, dtype=_i32, device=dev)
    build.launch(
        "router_cascade",
        [lf_all, bs_all, r_all, ok_all, *lanes[:4],
         arr_hops if has_sync else t0,  # never read without the arrival leg
         link_lat, router_lat, t_rep, t_arr if has_sync else t_rep, departs],
        [C, LH // legs, legs],
        torch.cuda.current_stream(dev),
    )
    return t_rep, t_arr, departs
