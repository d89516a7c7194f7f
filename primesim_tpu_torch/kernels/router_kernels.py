"""The hop-by-hop router's wait floors, contention cascade and departures.

`router_cascade` replaces the JAX package's Pallas kernel
`kernels/router_kernels.py::router_cascade` (`_cascade_kernel`) together
with the gathers and the scatter-max that the JAX engine stages around
it: on CUDA tensors it launches `csrc/router_cascade.cu`; on CPU tensors
it runs the plain version below. Per leg of every core (request, reply,
and the barrier-arrival leg when the trace has sync events) over the H
hops of its -1-padded XY route p:

    F_k = ok_k ? max(link_free[p_k], base[p_k]) + rank_k * link_lat : SENT
    t_k = max(t_start + router_lat, cummax_{k' <= k}(F_k' - k'c)) + k c,
    c = link_lat + router_lat,

the leg's end time max(t_start + router_lat, cummax over the whole row)
+ hops * c, and each hop's departure max(t_start + router_lat, cummax)
+ k c + link_lat, scatter-maxed into `link_free_out[p_k]` at the live
hops (masked hops are dropped). The request and arrival legs start at
t0; the reply leg at the request leg's end plus the service time.

At most MAX_HOPS = 256 hops per leg. `link_free_out` is a separate
buffer that the caller fills with a copy of `link_free` beforehand: the
floors read `link_free`, never a clock another core's departure has
already raised. `ok_all` must imply 0 <= `pth_all` < len(link_free), as
the engine's mask does (lane mask and pth >= 0). All arithmetic is int32
and wraps, as in JAX.

Batched, one launch serves the B simulations of a fleet: `link_free`,
`base` and `link_free_out` are [B, NL] (each element's own link clocks),
the hop rows [B, C, legs*H], the lanes [B, C] and the latencies [B].
Solo shapes are a batch of one.
"""

from __future__ import annotations

import torch

from . import build
from .layouts import check_tensor, squeeze_all, unsqueeze_all

#: masked-hop wait floor, below any real one and still representable
#: after the - k*c offsets of every hop
SENT = -(1 << 30) - (1 << 21)
#: hops per leg that the kernel holds in registers (8 chunks of 32 lanes:
#: meshes up to mesh_x + mesh_y = 258); the wrapper raises above, on any
#: device, so the CPU path never runs what the card would refuse
MAX_HOPS = 256
_i32 = torch.int32


def router_cascade_plain(
    link_free, base, pth_all, ok_all, r_all, t0, service, req_hops,
    rep_hops, arr_hops, link_lat, router_lat, link_free_out, *,
    has_sync: bool,
):
    """Plain torch version: returns (t_rep_end [B, C], t_arr_end [B, C]
    or None), int32 (without the B for solo inputs), and scatter-maxes
    the live departures into `link_free_out` in place."""
    if link_free.dim() == 1:
        return squeeze_all(router_cascade_plain(
            *unsqueeze_all(link_free, base, pth_all, ok_all, r_all, t0, service,
                           req_hops, rep_hops, arr_hops, link_lat, router_lat,
                           link_free_out),
            has_sync=has_sync,
        ))
    legs = 3 if has_sync else 2
    Bn, NL = link_free.shape
    H = pth_all.shape[-1] // legs
    L, R = link_lat[:, None, None], router_lat[:, None, None]
    c = L + R
    hidx = torch.arange(H, dtype=_i32, device=pth_all.device)
    pc = torch.where(pth_all >= 0, pth_all, 0).long()

    def at_hops(tab):  # tab[b, pc[b, ...]]
        return tab.gather(1, pc.view(Bn, -1)).view(pc.shape)

    F = torch.where(ok_all, torch.maximum(at_hops(link_free), at_hops(base)) + r_all * L, SENT)

    def leg(k, t_start, nh):
        cum = (F[..., k * H : (k + 1) * H] - hidx * c).cummax(-1).values
        t1 = t_start + R[..., 0]
        t_end = torch.maximum(t1, cum[..., -1]) + nh * c[..., 0]
        return t_end, torch.maximum(t1[..., None], cum) + hidx * c + L

    t_req_end, d_req = leg(0, t0, req_hops)
    t_rep_end, d_rep = leg(1, t_req_end + service, rep_hops)
    deps = [d_req, d_rep]
    t_arr_end = None
    if has_sync:
        t_arr_end, d_arr = leg(2, t0, arr_hops)
        deps.append(d_arr)
    departs = torch.cat(deps, -1)
    # each element's departures go to its own row of link_free_out
    row = torch.arange(Bn, device=pc.device)[:, None, None] * NL
    link_free_out.view(-1).scatter_reduce_(
        0, (pc + row)[ok_all], departs[ok_all], "amax"
    )
    return t_rep_end, t_arr_end


def router_cascade(
    link_free, base, pth_all, ok_all, r_all, t0, service, req_hops,
    rep_hops, arr_hops, link_lat, router_lat, link_free_out, *,
    has_sync: bool,
):
    """The kernel on CUDA tensors, its plain version on CPU tensors.
    Returns (t_rep_end, t_arr_end or None) and updates `link_free_out`
    IN PLACE. Batched: `link_free`, `base` and `link_free_out` are int32
    [B, NL], `pth_all`/`r_all` int32 and `ok_all` bool [B, C, legs*H], the
    lanes int32 [B, C]; `link_lat`/`router_lat` are [B] tensors on the
    same device, and `arr_hops` is read only when `has_sync` (pass None
    otherwise). Solo shapes (no B, 0-d latencies) are a batch of one."""
    legs = 3 if has_sync else 2
    LH = pth_all.shape[-1]
    if LH % legs:
        raise ValueError(f"router_cascade: {LH} hop columns are not {legs} legs")
    if LH // legs > MAX_HOPS:
        raise ValueError(f"router_cascade: {LH // legs} hops per leg is above {MAX_HOPS}")
    dev = pth_all.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"router_cascade: unsupported device {dev}")
    if link_free_out.data_ptr() == link_free.data_ptr():
        raise ValueError("router_cascade: link_free_out must be a copy, not link_free")
    if dev.type == "cpu":
        return router_cascade_plain(
            link_free, base, pth_all, ok_all, r_all, t0, service, req_hops,
            rep_hops, arr_hops, link_lat, router_lat, link_free_out,
            has_sync=has_sync,
        )
    if link_free.dim() == 1:
        return squeeze_all(router_cascade(
            *unsqueeze_all(link_free, base, pth_all, ok_all, r_all, t0, service,
                           req_hops, rep_hops, arr_hops, link_lat, router_lat,
                           link_free_out),
            has_sync=has_sync,
        ))
    Bn, NL = link_free.shape
    C = pth_all.shape[1]
    for name, x in (("link_free", link_free), ("base", base),
                    ("link_free_out", link_free_out)):
        check_tensor(name, x, (Bn, NL), dev)
    check_tensor("pth_all", pth_all, (Bn, C, LH), dev)
    check_tensor("r_all", r_all, (Bn, C, LH), dev)
    check_tensor("ok_all", ok_all, (Bn, C, LH), dev, torch.bool)  # read as bytes
    lanes = [t0, service, req_hops, rep_hops] + ([arr_hops] if has_sync else [])
    for name, x in zip(("t0", "service", "req_hops", "rep_hops", "arr_hops"), lanes):
        check_tensor(name, x, (Bn, C), dev)
    for name, x in (("link_lat", link_lat), ("router_lat", router_lat)):
        check_tensor(name, x, (Bn,), dev)
    t_rep = torch.empty(Bn, C, dtype=_i32, device=dev)
    t_arr = torch.empty(Bn, C, dtype=_i32, device=dev) if has_sync else None
    build.launch(
        "router_cascade",
        [link_free, base, pth_all, ok_all, r_all, *lanes[:4],
         arr_hops if has_sync else t0,  # never read without the arrival leg
         link_lat, router_lat, t_rep, t_arr if has_sync else t_rep,
         link_free_out],
        [Bn, C, NL, LH // legs, legs],
        torch.cuda.current_stream(dev),
    )
    return t_rep, t_arr
