"""The wavefront traversal: cull -> compact -> Möller–Trumbore (port of
rust_raytracer_tpu/ops/pallas_wavefront.py), the `kernel="wavefront"` choice.

Rays go in 8-lane packets (packet p is lanes 8p..8p+7, in caller order);
the pipeline finds each packet's candidate clusters, then tests the
packet's rays against every triangle of those clusters.  The two-level
pipeline (`pipeline2`, the reference's `_pipeline2`):

  L1    torch ops        slab keys of each packet against the S supernode
                         boxes, then the k1 nearest supernodes
                         (`nearest_boxes`)
  A+L2  wf_cull_compact  per packet, over its supernode slots in slot order:
                         any-hit of the 8 rays on the supernode's 128 cluster
                         boxes -> the slot's hit count, and its first KC hit
                         cluster ids appended to one row of
                         k = min(cap, k1 * KC)
  MT    wf_mt            per packet: closest hit of its 8 rays over the row

A+L2 is the reference's kernels A and L2 fused into one walk
(`cull_compact`); each also stands alone (`cull`: the (n_pk, k1, KC) key
buffer and the counts; `compact`: the row from them), which the parity
checks hold the fused kernel against.

The dense `pipeline` (the reference's `_pipeline`) culls every cluster box
in torch ops, keeps the k nearest and reaches the same MT kernel; it runs
when the scene has 2^14 or more clusters or no supernode tables.

Each kernel is a hand-written CUDA kernel (csrc/wf_*.cu, built by
ops/_cuda.py) with a plain PyTorch version beside its wrapper here.  A
wrapper launches the kernel for CUDA tensors and runs the plain version
for CPU tensors; nothing falls back.  `launches` and `plain_calls` count
each, by kernel name.

Like the reference, the pipeline is APPROXIMATE when a packet overflows a
cap: more than k1 supernodes hit, more than KC clusters hit in one
supernode block, or more than k candidates in all.  Such a packet may miss
its true closest hit (never report a nearer one); the pipelines return a
per-packet overflow mask and the wrapper the count, which the pool sums.

Ties: the reference's `lax.top_k` puts the lower index first among equal
keys, and slot order decides which candidates survive a cap and which
triangle wins at equal t, so the top k here is a stable descending sort.
"""
from __future__ import annotations

import os
import sys

import torch
import torch.nn.functional as F

from . import _cuda
from . import threaded

R = 8                       # rays per packet
SN = 128                    # cluster lanes per supernode block
CLUSTER = 128               # triangles per cluster
K1 = 40                     # supernode slots per packet (L1 top k)
KC = 32                     # cluster ids kept per (packet, supernode slot)
PAIRS_PER_PACKET_CAP = 128  # candidate clusters per packet
ID_BITS = 14                # the two-level pipeline needs nc < 2^ID_BITS
BIG = 3.4e38
T_MIN_STATIC = 1e-3         # reference: camera.rs:294 interval lower bound
_INT_MAX = 0x7FFFFFFF

KERNELS = ("wf_cull_compact", "wf_cull", "wf_compact", "wf_mt")
launches = dict.fromkeys(KERNELS, 0)
plain_calls = dict.fromkeys(KERNELS, 0)

# elements of the largest intermediate of one chunk in the plain versions:
# bounds their memory at full width on the card
_CHUNK = 1 << 22
# elements of one chunk's (rays, boxes) slab intermediates in the L1 and the
# dense cull (torch ops on the main path): the pool's 2^18 rays against
# ~100 supernodes fit one chunk (~120 MB a temporary), so the L1 is one
# pass of a few dozen launches; the dense cull's ~10^4 cluster boxes take
# a few hundred packets a chunk
_KEY_CHUNK = 1 << 25


# ---------------------------------------------------------------- L1 / cull

def packet_keys(lo, hi, org, dirn, t_max):
    """(P*8 rays) x (B boxes lo/hi (B, 3)) -> (P, B) int32 keys:
    0x7FFFFFFF - bits(packet-minimum slab entry t) where some ray of the
    packet hits the box, -1 where none does (reference :495-522, :634-652,
    in its operation order).  Larger key = nearer box."""
    n, nb = org.shape[0], lo.shape[0]
    inv = 1.0 / dirn
    near = torch.full((n, nb), T_MIN_STATIC, dtype=torch.float32, device=org.device)
    far = t_max[:, None].expand(n, nb)
    for ax in range(3):
        t0 = (lo[None, :, ax] - org[:, ax, None]) * inv[:, ax, None]
        t1 = (hi[None, :, ax] - org[:, ax, None]) * inv[:, ax, None]
        near = torch.maximum(near, torch.minimum(t0, t1))
        far = torch.minimum(far, torch.maximum(t0, t1))
    tent = torch.where(near <= far, near, float("inf")).view(-1, R, nb).amin(dim=1)
    return torch.where(torch.isfinite(tent), _INT_MAX - tent.view(torch.int32), -1)


def nearest_boxes(lo, hi, org, dirn, t_max, k):
    """Per packet, the k boxes of largest key in key order, lower index
    first among equal keys (0 past the hit boxes), and the number of boxes
    hit.  Returns (slots (P, k) int32, hit count (P,) int32)."""
    n_pk, nb = org.shape[0] // R, lo.shape[0]
    step = max(1, _KEY_CHUNK // (R * max(nb, k)))
    slots, counts = [], []
    for s in range(0, n_pk, step):
        rays = slice(s * R, (s + step) * R)
        key = packet_keys(lo, hi, org[rays], dirn[rays], t_max[rays])
        if nb < k:
            key = F.pad(key, (0, k - nb), value=-1)
        top, idx = torch.sort(key, dim=1, descending=True, stable=True)
        slots.append(torch.where(top[:, :k] >= 0, idx[:, :k], 0).to(torch.int32))
        counts.append((key >= 0).sum(dim=1, dtype=torch.int32))
    return torch.cat(slots), torch.cat(counts)


def cull_plain(sn_slot, n1, sn_start, sn_bounds, org, dirn, tm, kc):
    """Kernel A's plain version: keys (n_pk, k1, kc) int32 (the first kc
    hit lanes' global cluster ids in lane order, -1 after) and counts
    (n_pk, k1) int32 (all hit lanes); slots >= n1 get -1 and 0."""
    n_pk, k1 = sn_slot.shape
    dev = org.device
    keys = torch.full((n_pk, k1, kc), -1, dtype=torch.int32, device=dev)
    counts = torch.zeros((n_pk, k1), dtype=torch.int32, device=dev)
    o = org.view(n_pk, 1, R, 3, 1)
    inv = (1.0 / dirn).view(n_pk, 1, R, 3, 1)
    t = tm.view(n_pk, 1, R, 1)
    lane = torch.arange(SN, dtype=torch.int32, device=dev)
    live = torch.arange(k1, device=dev)[None, :] < n1[:, None]
    step = max(1, _CHUNK // (k1 * R * SN))
    for s in range(0, n_pk, step):
        p = slice(s, s + step)
        sn = sn_slot[p].long()
        blk = sn_bounds[sn][:, :, None]                      # (P, k1, 1, 6, SN)
        tx0 = (blk[..., 0, :] - o[p][..., 0, :]) * inv[p][..., 0, :]
        tx1 = (blk[..., 3, :] - o[p][..., 0, :]) * inv[p][..., 0, :]
        ty0 = (blk[..., 1, :] - o[p][..., 1, :]) * inv[p][..., 1, :]
        ty1 = (blk[..., 4, :] - o[p][..., 1, :]) * inv[p][..., 1, :]
        tz0 = (blk[..., 2, :] - o[p][..., 2, :]) * inv[p][..., 2, :]
        tz1 = (blk[..., 5, :] - o[p][..., 2, :]) * inv[p][..., 2, :]
        near = torch.maximum(
            torch.maximum(torch.minimum(tx0, tx1), torch.minimum(ty0, ty1)),
            torch.clamp(torch.minimum(tz0, tz1), min=T_MIN_STATIC))
        far = torch.minimum(
            torch.minimum(torch.maximum(tx0, tx1), torch.maximum(ty0, ty1)),
            torch.minimum(torch.maximum(tz0, tz1), t[p]))
        hit = (near <= far).any(dim=2) & live[p, :, None]    # (P, k1, SN)
        counts[p] = hit.sum(dim=2, dtype=torch.int32)
        rank = hit.cumsum(dim=2) - 1
        pos = torch.where(hit & (rank < kc), rank, kc)
        ids = sn_start[sn][..., None] + lane
        buf = torch.full((*hit.shape[:2], kc + 1), -1, dtype=torch.int32, device=dev)
        keys[p] = buf.scatter_(2, pos, ids)[..., :kc]
    return keys, counts


# ---------------------------------------------------------------- L2

def compact_plain(keys, counts, n1, k):
    """Kernel L2's plain version: (out (n_pk, k) int32, total (n_pk,)
    int32) — the first min(counts, kc) keys of each live slot in slot
    order, -1 after; the total is not clamped to k."""
    n_pk, k1, kc = keys.shape
    dev = keys.device
    live = torch.arange(k1, device=dev)[None, :] < n1[:, None]
    c = torch.where(live, torch.clamp(counts, max=kc), 0)
    total = c.sum(dim=1, dtype=torch.int32)
    off = torch.cumsum(c, dim=1) - c
    q = torch.arange(kc, device=dev)
    out = torch.full((n_pk, k + 1), -1, dtype=torch.int32, device=dev)
    step = max(1, _CHUNK // (k1 * kc))
    for s in range(0, n_pk, step):
        p = slice(s, s + step)
        dest = off[p, :, None] + q
        dest = torch.where((q < c[p, :, None]) & (dest < k), dest, k)
        out[p].scatter_(1, dest.flatten(1), keys[p].flatten(1))
    return out[:, :k], total


def cull_compact_plain(sn_slot, n1, sn_start, sn_bounds, org, dirn, tm, kc, k):
    """Kernels A and L2 fused, plain version: (row (n_pk, k) int32, total
    (n_pk,) int32, counts (n_pk, k1) int32) — compact_plain's row and
    total over cull_plain's keys, and cull_plain's counts."""
    keys, counts = cull_plain(sn_slot, n1, sn_start, sn_bounds, org, dirn, tm, kc)
    row, total = compact_plain(keys, counts, n1, k)
    return row, total, counts


# ---------------------------------------------------------------- MT

def mt_plain(cl, cnt, org, dirn, tm, tri_rows):
    """Kernel MT's plain version: (t (N,) f32, slot (N,) int32) — per ray
    the closest hit over the first cnt[p] clusters of its packet's row,
    t = tm and slot -1 where none.  Slot by slot, as the kernel: a strict
    `<` per (ray, lane), then the minimum t and the lowest id there."""
    n_pk = cl.shape[0]
    dev = org.device
    o, d = org.view(n_pk, R, 3), dirn.view(n_pk, R, 3)
    bt = tm.view(n_pk, R, 1).expand(n_pk, R, CLUSTER).contiguous()
    bi = torch.full((n_pk, R, CLUSTER), -1, dtype=torch.int32, device=dev)
    rows = tri_rows.view(-1, CLUSTER, 12)
    lane = torch.arange(CLUSTER, dtype=torch.int32, device=dev)
    step = max(1, _CHUNK // (R * CLUSTER))
    no_best = torch.full((step * R,), float("inf"), device=dev)
    for j in range(int(cnt.max()) if n_pk else 0):
        act = torch.nonzero(cnt > j).squeeze(1)
        for s in range(0, act.numel(), step):
            p = act[s:s + step]
            c = cl[p, j]
            tri = rows[c.long()].repeat_interleave(R, dim=0)  # (P*R, 128, 12)
            tt = threaded.mt_rows(o[p].reshape(-1, 3), d[p].reshape(-1, 3), tri,
                              no_best[:tri.shape[0]]).view(-1, R, CLUSTER)
            better = tt < bt[p]
            bt[p] = torch.where(better, tt, bt[p])
            bi[p] = torch.where(better, (c[:, None, None] * CLUSTER + lane), bi[p])
    m = bt.amin(dim=2)
    idm = torch.where((bt == m[..., None]) & (bi >= 0), bi, _INT_MAX).amin(dim=2)
    return m.reshape(-1), torch.where(idm == _INT_MAX, -1, idm).reshape(-1)


# ---------------------------------------------------------------- wrappers

def _launch(name, ins, outs, ints):
    """Launch kernel `name` on ins + outs (dtype, device and contiguity
    checked against ins[0]'s device) with the int arguments."""
    dev = ins[0].device
    for a in (*ins, *outs):
        if a.device != dev:
            raise ValueError(f"{name}: tensors on {a.device} and {dev}")
        if not a.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors only")
    if min(ints) <= 0:
        return  # an empty wavefront: nothing to launch
    _cuda.launch("rrt_" + name, (*ins, *outs), ints, dev)
    launches[name] += 1


def _route(name, ref, *dtypes_of):
    """'cuda' or 'cpu' for a wrapper whose inputs lie on ref's device;
    checks each (tensor, dtype) pair."""
    for a, dtype in dtypes_of:
        if a.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {a.dtype}")
    if ref.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: no kernel for device {ref.device}")
    if ref.device.type == "cpu":
        plain_calls[name] += 1
    return ref.device.type


def cull(sn_slot, n1, sn_start, sn_bounds, org, dirn, tm, kc):
    """Kernel A (csrc/wf_cull.cu; reference pallas_wavefront.py:302):
    see cull_plain for the contract."""
    i32, f32 = torch.int32, torch.float32
    if not 0 < kc <= SN:
        raise ValueError(f"kc must be in 1..{SN}, got {kc}")
    route = _route("wf_cull", org, (sn_slot, i32), (n1, i32), (sn_start, i32),
                   (sn_bounds, f32), (org, f32), (dirn, f32), (tm, f32))
    if route == "cpu":
        return cull_plain(sn_slot, n1, sn_start, sn_bounds, org, dirn, tm, kc)
    n_pk, k1 = sn_slot.shape
    keys = torch.empty((n_pk, k1, kc), dtype=i32, device=org.device)
    counts = torch.empty((n_pk, k1), dtype=i32, device=org.device)
    _launch("wf_cull", (sn_slot, n1, sn_start, sn_bounds, org, dirn, tm),
            (keys, counts), (n_pk, k1, kc))
    return keys, counts


def cull_compact(sn_slot, n1, sn_start, sn_bounds, org, dirn, tm, kc, k):
    """Kernels A and L2 fused (csrc/wf_cull.cu:wf_cull_compact_kernel;
    reference pallas_wavefront.py:302 and :386): see cull_compact_plain
    for the contract."""
    i32, f32 = torch.int32, torch.float32
    if not 0 < kc <= SN:
        raise ValueError(f"kc must be in 1..{SN}, got {kc}")
    if not 0 < k:
        raise ValueError(f"k must be positive, got {k}")
    route = _route("wf_cull_compact", org, (sn_slot, i32), (n1, i32), (sn_start, i32),
                   (sn_bounds, f32), (org, f32), (dirn, f32), (tm, f32))
    if route == "cpu":
        return cull_compact_plain(sn_slot, n1, sn_start, sn_bounds, org, dirn, tm, kc, k)
    n_pk, k1 = sn_slot.shape
    row = torch.empty((n_pk, k), dtype=i32, device=org.device)
    total = torch.empty((n_pk,), dtype=i32, device=org.device)
    counts = torch.empty((n_pk, k1), dtype=i32, device=org.device)
    _launch("wf_cull_compact", (sn_slot, n1, sn_start, sn_bounds, org, dirn, tm),
            (row, total, counts), (n_pk, k1, kc, k))
    return row, total, counts


def compact(keys, counts, n1, k):
    """Kernel L2 (csrc/wf_compact.cu; reference pallas_wavefront.py:386):
    see compact_plain for the contract."""
    i32 = torch.int32
    route = _route("wf_compact", keys, (keys, i32), (counts, i32), (n1, i32))
    if route == "cpu":
        return compact_plain(keys, counts, n1, k)
    n_pk, k1, kc = keys.shape
    out = torch.empty((n_pk, k), dtype=i32, device=keys.device)
    total = torch.empty((n_pk,), dtype=i32, device=keys.device)
    _launch("wf_compact", (keys, counts, n1), (out, total), (n_pk, k1, kc, k))
    return out, total


def mt(cl, cnt, org, dirn, tm, tri_rows):
    """Kernel MT (csrc/wf_mt.cu; reference pallas_wavefront.py:108): see
    mt_plain for the contract."""
    i32, f32 = torch.int32, torch.float32
    route = _route("wf_mt", org, (cl, i32), (cnt, i32), (org, f32), (dirn, f32),
                   (tm, f32), (tri_rows, f32))
    if route == "cpu":
        return mt_plain(cl, cnt, org, dirn, tm, tri_rows)
    n = org.shape[0]
    t = torch.empty((n,), dtype=f32, device=org.device)
    slot = torch.empty((n,), dtype=i32, device=org.device)
    _launch("wf_mt", (cl, cnt, org, dirn, tm, tri_rows), (t, slot),
            (n // R, cl.shape[1]))
    return t, slot


# ---------------------------------------------------------------- pipelines

def pipeline2(sn_lo, sn_hi, sn_start, sn_bounds, tri_rows, org, dirn, t_max, *,
              k1=K1, kc=KC, cap=PAIRS_PER_PACKET_CAP):
    """Two-level pipeline (reference `_pipeline2`) on N = 8 * n_pk rays.
    Returns (t, slot, dropped): t the MT flush (min(t_max, 3.4e38) on a
    miss), slot -1 on a miss, dropped (n_pk,) bool — the packets that
    overflowed a cap (reference :722-727)."""
    S = sn_lo.shape[0]
    k1 = min(k1, -(-S // 8) * 8)
    sn_slot, l1_cnt = nearest_boxes(sn_lo, sn_hi, org, dirn, t_max, k1)
    n1 = torch.clamp(l1_cnt, max=k1)
    tm = torch.clamp(t_max, max=BIG)
    k = min(cap, k1 * kc)
    cl, real, counts = cull_compact(sn_slot, n1, sn_start, sn_bounds, org, dirn, tm, kc, k)
    t, slot = mt(cl, torch.clamp(real, max=k), org, dirn, tm, tri_rows)
    return t, slot, overflowed(l1_cnt, counts, real, k1, kc, k)


def overflowed(l1_cnt, counts, real, k1, kc, k):
    """(n_pk,) bool: the packets of the two-level pipeline that overflowed
    a cap — more than k1 supernodes hit, more than kc clusters hit in a
    live supernode slot, or more than k candidates (reference :722-727)."""
    n1 = torch.clamp(l1_cnt, max=k1)
    live = torch.arange(k1, device=counts.device)[None, :] < n1[:, None]
    return (l1_cnt > k1) | (real > k) | ((counts > kc) & live).any(dim=1)


def pipeline(cl_lo, cl_hi, tri_rows, org, dirn, t_max, *, cap=PAIRS_PER_PACKET_CAP):
    """Dense single-level pipeline (reference `_pipeline`): every cluster
    box culled in torch ops, the k = min(cap, nc) nearest kept, then the MT
    kernel.  Returns (t, slot, dropped) as pipeline2; a packet is dropped
    when it hit more than k clusters (reference :541)."""
    k = min(cap, cl_lo.shape[0])
    cl, pk_cnt = nearest_boxes(cl_lo, cl_hi, org, dirn, t_max, k)
    tm = torch.clamp(t_max, max=BIG)
    t, slot = mt(cl, torch.clamp(pk_cnt, max=k), org, dirn, tm, tri_rows)
    return t, slot, pk_cnt > k


def intersect_triangles_wavefront(pack, org, dirn, t_min, t_max, *,
                                  return_overflow=False, k1=K1, kc=KC,
                                  cap=PAIRS_PER_PACKET_CAP):
    """Closest triangle hit through the wavefront pipeline, with the BVH8
    traversal's contract: (t, slot), t == t_max where nothing was hit, t_min
    the static T_MIN_STATIC.  With return_overflow=True also the number of
    packets that overflowed a cap, a 0-d int64 tensor on the rays' device.
    The two-level pipeline runs when nc < 2^ID_BITS and the scene has
    supernode tables, the dense one otherwise (reference :733-795).  With
    RRT_WF_CHECK set, each call prints its overflowed packets to stderr,
    as the reference's debug print (reference :784-788)."""
    del t_min
    n = org.shape[0]
    threaded.check_rays(org, dirn, t_max)
    slot = torch.full((n,), -1, dtype=torch.int32, device=org.device)
    ov = torch.zeros((), dtype=torch.int64, device=org.device)
    if pack.tri_rows.shape[0] == 0 or pack.wf_cl_lo.shape[0] == 0 or n == 0:
        return (t_max, slot, ov) if return_overflow else (t_max, slot)
    # pad to whole packets with lanes that cannot hit (t_max = 0)
    pad = -n % R
    o, d, tmax = org, dirn, t_max
    if pad:
        ones = torch.ones((pad, 3), dtype=org.dtype, device=org.device)
        o, d = torch.cat([org, ones]), torch.cat([dirn, ones])
        tmax = torch.cat([t_max, torch.zeros((pad,), dtype=t_max.dtype, device=org.device)])
    o, d, tmax = o.contiguous(), d.contiguous(), tmax.contiguous()
    if pack.wf_cl_lo.shape[0] < (1 << ID_BITS) and pack.wf_sn_lo.shape[0] > 0:
        t, slot, dropped = pipeline2(
            pack.wf_sn_lo, pack.wf_sn_hi, pack.wf_sn_start, pack.wf_sn_bounds,
            pack.tri_rows, o, d, tmax, k1=k1, kc=kc, cap=cap)
    else:
        t, slot, dropped = pipeline(pack.wf_cl_lo, pack.wf_cl_hi, pack.tri_rows,
                                    o, d, tmax, cap=cap)
    t, slot = t[:n], slot[:n]
    t = torch.where(slot < 0, t_max, t)
    if os.environ.get("RRT_WF_CHECK"):
        # reads the device back each call: render/graphs.py:applies runs
        # nothing graphed while it is set
        print(f"wavefront: {int(dropped.sum())} packet(s) overflowed PAIRS_PER_PACKET_CAP "
              "(farthest clusters dropped)", file=sys.stderr)
    if return_overflow:
        return t, slot, dropped.sum(dtype=torch.int64)
    return t, slot
