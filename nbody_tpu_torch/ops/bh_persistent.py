"""Persistent Morton order: integrate in the group layout, resort every k
steps — counterpart of ``nbody_tpu/ops/bh_persistent.py``.

A one-shot fused evaluation (``ops/bh_fused.py``) sorts the bodies,
builds the dense grid and the groups, and scatters the forces back, every
step.  Between small steps the bodies move a tiny fraction of a cell, so
this module keeps the integrator state in K6's own layout across steps:

* the state is the group layout itself: G groups of B slots, one
  row-major (G·B, 4) f32 array [x y z G·m] that is K6's source array as
  it stands, so kick and drift are elementwise updates of it and the
  kernel's (G·B, 3) output feeds the next kick;
* only the grid's float half (centres of mass, G·m) is rebuilt each step,
  by one segmented sum over the stored (stale) terminal cells; its int
  half (each cell's first slot and span) is frozen between resorts;
* every `resort_every` steps the state is sorted again from scratch.

Between resorts the MAC compares the current group boxes and centres of
mass against the stale partition, so a cell's nominal size under-reports
its extent by at most the drift since the last resort; the drift guard of
``simulate_persistent`` falls back to a resort every step where that
drift would exceed a fraction of a terminal cell.

Pad slots (past a group's count) repeat the group's last real body with
G·m = 0, so the flattened cell ids stay non-decreasing, and they are
inert: K6 never takes them as targets (it reads [gstart, gstart + gcount)
and boxes the real bodies only), their G·m of 0 adds nothing where a
cell's span covers them, and nothing emits them.  K6 writes them no
acceleration, so they drift off their twin; the JAX kernel evaluates them,
which keeps them on it.  Nothing reads a pad's position: the drift guard,
the resort and the frames read real slots only.

TPU mechanics not carried over: the planar (G, 4, B) layout (for the
128-lane tile), the rounding of the slot count to a multiple of 128 (the
near-field DMA window), the four-pass rebuild above 20M slots (the tiled
layout's padding), the donated stepper, and the watchdog-sized force
slices (``prime_chunked``, ``kdk_steps_chunked``): a 100M-body state is a
few GB of the card's memory and one kernel launch has no time limit.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from nbody_tpu_torch.core import constants
from nbody_tpu_torch.core.types import Bodies
from nbody_tpu_torch.diag.timing import host_sync, span, spanned
from nbody_tpu_torch.integrate.adaptive import (
    check_adaptive,
    host_time,
    run_chunk,
    stagnated,
    step_size,
)
from nbody_tpu_torch.ops.barneshut import CapacityError, group_ranges
from nbody_tpu_torch.ops.bh_fused import (
    FRONTIER_CAP,
    MAX_LD,
    MORTON_DEPTH,
    S_OVF,
    _median,
    _round_cap,
    auto_ld,
    auto_split_level,
    fused_group_forces,
    outlier_rect,
)
from nbody_tpu_torch.ops.bh_grid import GridTree, grid_from_terminal, grid_offsets
from nbody_tpu_torch.ops.collisions import merge_pass
from nbody_tpu_torch.ops.cuda_exhaustive import cuda_rect_accelerations
from nbody_tpu_torch.ops.morton import bounding_border, morton_encode

_INT_MAX = 2**31 - 1


class GroupState(NamedTuple):
    """The persistent integrator state: G groups of B slots, M = G·B.

    The float arrays are updated in place by the steppers; `acc` is
    replaced by each force evaluation."""

    src: torch.Tensor  # (M, 4) f32 [x y z G·m], K6's sources; pads: their group's
    # last real body with G·m 0; robust outliers: G·m 0 (true value in out_gm)
    vel: torch.Tensor  # (M, 3) f32
    acc: torch.Tensor  # (M, 3) f32 force at the current positions (the KDK carry)
    valid: torch.Tensor  # (M,) bool, real slots
    gcount: torch.Tensor  # (G,) int32 real bodies per group
    orig: torch.Tensor  # (M,) int32 input index of each slot; n for pads
    real: torch.Tensor  # (n,) int64 the real slots, in slot order
    nid: torch.Tensor  # (M,) int64 stale terminal cell, non-decreasing; 8^ld
    # for the slots of empty groups
    bounds: torch.Tensor  # (8^ld + 1,) int64 [0, cumsum of each terminal cell's
    # real bodies]: cell c's bodies are real[bounds[c]:bounds[c + 1]]
    start: torch.Tensor  # (T,) int32 each cell's first real slot
    cnt: torch.Tensor  # (T,) int32 each cell's span of slots, pads included
    bsq: torch.Tensor  # (16,) f32 (border / 2^l)^2
    border: torch.Tensor  # 0-dim f32
    ld: int
    out_slots: Optional[torch.Tensor] = None  # (K,) int64 robust mode's outliers
    out_gm: Optional[torch.Tensor] = None  # (K,) f32 their G·m

    @property
    def group_size(self) -> int:
        return self.src.shape[0] // self.gcount.shape[0]

    @property
    def n(self) -> int:
        return self.real.shape[0]


def _layout(n: int, group_size: int, ld: int | None = None):
    """(B, ld, split level, G): G = n // B + min(8^sl, n) + 1, the exact
    bound of ``group_ranges``: every split-level cell adds at most one
    partial group."""
    b = group_size
    ld = ld or auto_ld(n)
    sl = auto_split_level(n, b)
    return b, ld, sl, n // b + min(8**sl, n) + 1


def _resort(pos, vel, acc, gm, orig, *, group_size: int, robust_slots: int = 0,
            ld: int | None = None) -> GroupState:
    """A fresh state from the n real bodies (f32 pos, vel, acc (n, 3) or
    None for zeros, gm (n,), int orig (n,)) in any order.  Used for the
    initial build and for the periodic resort, where the rows come from
    the state's real slots in slot order: a resort is a pure relabelling,
    so the KDK carry rides the permutation.

    `robust_slots` K > 0 is the robust scheme of
    ``bh_fused.barneshut_fused_robust`` on this layout: the root cube is
    centred at the median and sized by the (K+1)-th largest distance from
    it, and the K most distant bodies ride the layout with G·m 0, their
    G·m kept in out_gm (``state_forces`` adds their pull exactly)."""
    n = pos.shape[0]
    dev = pos.device
    b, ld, sl, g_cap = _layout(n, group_size, ld)
    k_terminal = 8**ld
    center = None
    if robust_slots > 0:
        k_out = min(int(robust_slots), n - 1)
        center = _median(pos)
        d = (pos - center).abs().amax(dim=1)
        border = 2.0 * torch.topk(d, k_out + 1).values[k_out] * 1.0001
        # keys in the centred frame (the cube is sized around the median);
        # the layout keeps absolute positions
        keys = morton_encode(pos - center, border, MORTON_DEPTH)
    else:
        border = bounding_border(pos)
        keys = morton_encode(pos, border, MORTON_DEPTH)
    order = torch.argsort(keys, stable=True)
    keys_s = keys[order]
    gstart, gcount = group_ranges(keys_s, n, MORTON_DEPTH, b, sl)

    slots = torch.arange(b, device=dev)
    valid = slots[None, :] < gcount[:, None]  # (G, B)
    # pads take their group's last real body, as JAX's do: the flattened
    # cell ids stay non-decreasing
    last = gstart.long() + (gcount.long() - 1).clamp_min(0)
    sidx = torch.where(valid, gstart.long()[:, None] + slots, last[:, None]).reshape(-1)
    valid = valid.reshape(-1)
    idx = order[sidx]
    src = torch.cat([pos[idx], torch.where(valid, gm[idx], 0.0)[:, None]], dim=1)
    vel_g = vel[idx].contiguous()
    acc_g = torch.zeros_like(vel_g) if acc is None else acc[idx].contiguous()
    orig_g = torch.where(valid, orig[idx].int(), n).int()
    occupied = (gcount > 0).repeat_interleave(b)
    nid = torch.where(occupied, (keys_s[sidx] >> (3 * (MORTON_DEPTH - ld))).long(),
                      k_terminal)
    real = _real_slots(gcount, b, n)

    # the int half of the grid, in slot space over the real slots
    slot = torch.arange(g_cap * b, device=dev)
    st = torch.full((k_terminal + 1,), _INT_MAX, dtype=torch.int64, device=dev)
    st = st.scatter_reduce(0, nid, torch.where(valid, slot, _INT_MAX), "amin")
    en = torch.full((k_terminal + 1,), -1, dtype=torch.int64, device=dev)
    en = en.scatter_reduce(0, nid, torch.where(valid, slot + 1, -1), "amax")
    cnt = torch.zeros(k_terminal + 1, dtype=torch.int64, device=dev)
    cnt.index_add_(0, nid, valid.long())
    bounds = torch.cat([cnt.new_zeros(1), torch.cumsum(cnt[:k_terminal], 0)])
    zf = torch.zeros(k_terminal, dtype=torch.float32, device=dev)
    tree = grid_from_terminal(zf[:, None].expand(-1, 3), zf, cnt[:k_terminal],
                              st[:k_terminal], en[:k_terminal], ld)
    lev = torch.arange(16, dtype=torch.float32, device=dev)
    bsq = (border / torch.exp2(lev)) ** 2

    out_slots = out_gm = None
    if robust_slots > 0:
        # the K most distant real slots are the K most distant bodies
        d_slot = torch.where(valid, (src[:, :3] - center).abs().amax(dim=1), -1.0)
        out_slots = torch.topk(d_slot, k_out).indices
        out_gm = src[out_slots, 3].clone()
        src[out_slots, 3] = 0.0
    return GroupState(
        src=src.contiguous(), vel=vel_g, acc=acc_g, valid=valid,
        gcount=gcount.int(), orig=orig_g, real=real, nid=nid, bounds=bounds,
        start=tree.start, cnt=tree.cnt, bsq=bsq, border=border, ld=ld,
        out_slots=out_slots, out_gm=out_gm,
    )


def _real_slots(gcount: torch.Tensor, b: int, n: int) -> torch.Tensor:
    """The slots [g·B, g·B + gcount[g]) of every group, in order (n of
    them), without a host sync."""
    groups = torch.arange(gcount.shape[0], device=gcount.device)
    g = torch.repeat_interleave(groups, gcount.long(), output_size=n)
    first = torch.cumsum(gcount.long(), 0) - gcount.long()
    return g * b + torch.arange(n, device=gcount.device) - first[g]


@spanned("bh.init_state")
def init_state(pos: torch.Tensor, vel: torch.Tensor, mass: torch.Tensor, *,
               G: float = constants.BIG_G, group_size: int = 1024,
               robust_slots: int = 0, ld: int | None = None) -> GroupState:
    """The persistent state of (N, 3)/(N,) bodies, in f32, with zero acc
    (``prime`` fills it)."""
    n = pos.shape[0]
    f32 = torch.float32
    gm = mass.to(f32) * G  # G rounded to f32 times the masses, as JAX's
    orig = torch.arange(n, dtype=torch.int32, device=pos.device)
    return _resort(pos.to(f32), vel.to(f32), None, gm, orig, group_size=group_size,
                   robust_slots=robust_slots, ld=ld)


@spanned("bh.resort")
def resort(state: GroupState, robust_slots: int = 0) -> GroupState:
    """The periodic resort: the real slots, in slot order, sorted and
    grouped again at the state's depth.  Robust mode's outliers get their
    G·m back first, and the K most distant bodies are picked again."""
    gm = state.src[:, 3]
    if state.out_gm is not None:
        gm = gm.index_put((state.out_slots,), state.out_gm)
    r = state.real
    return _resort(state.src[r, :3], state.vel[r], state.acc[r], gm[r], state.orig[r],
                   group_size=state.group_size, robust_slots=robust_slots, ld=state.ld)


def _cell_sums(vals: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """(k, C) f32 sums of the row runs vals[bounds[c]:bounds[c + 1]] of
    `vals` (n, C) f32, as differences of one integer prefix sum: each
    column is scaled by a power of two to 60-bit fixed point (n times its
    largest magnitude stays below 2^60, so no prefix overflows) and summed
    exactly, so the result does not depend on the order of the scan.
    Deterministic on the card (no atomics, and a scan of integers), each
    sum within ~n·max|v|·2^-60 before its one rounding to f32, and no
    slower for a dense cell than for any other.  A column holding a
    non-finite value sums to NaN in every run, as a float sum would
    somewhere."""
    n, c = vals.shape
    v = vals.t().double()
    vmax = v.abs().amax(dim=1, keepdim=True)
    _, e = torch.frexp(vmax * n)  # n·max|v| < 2^e
    scale = torch.ldexp(torch.ones_like(vmax), 60 - e)
    q = torch.round(v * scale).long().reshape(-1)
    prefix = torch.cat([q.new_zeros(1), torch.cumsum(q, 0)])
    base = torch.arange(c, device=vals.device)[:, None] * n
    sums = (prefix[base + bounds[1:]] - prefix[base + bounds[:-1]]).double() / scale
    return torch.where(torch.isfinite(vmax), sums, float("nan")).float().t()


@spanned("bh.rebuild")
def _ft_from_state(state: GroupState) -> GridTree:
    """The grid for the state's current positions: the float half rebuilt,
    the int half the state's own.  The real slots, in slot order, hold each
    terminal cell's bodies as one run (the stale cell ids are
    non-decreasing), so the terminal level is one ``_cell_sums`` of
    [G·m·x, G·m·y, G·m·z, G·m] over them; the coarser levels are (-1, 8)
    reshape-sums in f32, as in JAX."""
    ld = state.ld
    rows = state.src[state.real]
    gm = rows[:, 3:4]
    s = _cell_sums(torch.cat([gm * rows[:, :3], gm], dim=1), state.bounds)
    levels = [s]
    for _ in range(ld):
        levels.append(levels[-1].reshape(-1, 8, 4).sum(dim=1))
    levels.reverse()  # level 0 first
    w = torch.cat(levels)
    com = w[:, :3] / torch.clamp_min(w[:, 3], 1e-30)[:, None]
    return GridTree(
        cx=com[:, 0].contiguous(), cy=com[:, 1].contiguous(), cz=com[:, 2].contiguous(),
        gm=w[:, 3].contiguous(), cnt=state.cnt, start=state.start,
    )


@spanned("force.eval")
def state_forces(state: GroupState, *, theta: float = constants.THETA,
                 softening_sq: float = constants.SOFTENING_SQ, leaf_cap: int = 64,
                 frontier_cap: int = FRONTIER_CAP, group_forces=fused_group_forces,
                 rect_forces=cuda_rect_accelerations, groups: Optional[torch.Tensor] = None):
    """(accelerations (M, 3) f32 at the state's current positions, K6's
    stats).  `group_forces` is K6's wrapper (its pricing pass and
    heaviest-first launch: two launches) or its plain version; pads get
    zero from it.  In robust mode the outliers' pull is added by one exact
    rectangle through `rect_forces` (K1, or its plain version), at their
    current positions; G is folded into out_gm already.

    `groups` (int64 (P,), or None for all G) evaluates those groups only,
    as the target side: K6 takes their (gstart, gcount) and writes their
    slots, the rest of the output stays zero, and the stats are (P,
    N_STATS); the sources, and the tables rebuilt from them, stay the
    whole layout, and the robust rectangle shrinks to the groups' slots."""
    tree = _ft_from_state(state)
    b = state.group_size
    gstart = torch.arange(0, state.src.shape[0], b, dtype=torch.int32,
                          device=state.src.device)
    gcount = state.gcount
    if groups is not None:
        gstart, gcount = gstart[groups], gcount[groups]
    acc, stats = group_forces(tree, gstart, gcount, state.src, state.bsq, theta=theta,
                              eps2=softening_sq, leaf_cap=leaf_cap, ld=state.ld,
                              group_size=b, frontier_cap=frontier_cap)
    if state.out_gm is not None:
        src = state.src[state.out_slots, :3]
        if groups is None:
            targets = state.src[:, :3].contiguous()
            acc = acc + outlier_rect(targets, src, state.out_gm, G=1.0,
                                     softening_sq=softening_sq, rect_forces=rect_forces)
        else:
            rows = (groups[:, None] * b + torch.arange(b, device=groups.device)).reshape(-1)
            side = outlier_rect(state.src[rows, :3].contiguous(), src, state.out_gm, G=1.0,
                                softening_sq=softening_sq, rect_forces=rect_forces)
            acc[rows] = acc[rows] + side
    return acc, stats


def subset_state_forces(state: GroupState, idx: torch.Tensor, **force_kw):
    """(accelerations (M, 3) with the slots of the target groups `idx`
    written, stats (P, N_STATS)): ``state_forces`` over a prefix of the
    tier order (``bh_persistent.py:914-954``).  K6 reads each group's
    slots where they lie, so no target row is gathered; only the robust
    rectangle gathers its targets."""
    return state_forces(state, groups=idx, **force_kw)


def prime(state: GroupState, **force_kw):
    """(state with acc = the force at its current positions, stats): the
    reference's initial acceleration call (serial/exhaustive.c:206)."""
    acc, stats = state_forces(state, **force_kw)
    return state._replace(acc=acc), stats


def _check_finite(what: str, t: torch.Tensor) -> None:
    if not bool(torch.isfinite(t).all()):
        raise FloatingPointError(f"non-finite {what}")


def kdk_steps(state: GroupState, n_steps: int, dt: float, *, with_history: bool = False,
              ovf: Optional[torch.Tensor] = None, debug_nans: bool = False, **force_kw):
    """`n_steps` KDK steps in the group layout, updating the state's
    arrays in place (no sort, no scatter).  state.acc must hold the force
    at the current positions (``prime``).  Returns (state, ovf, history):
    `ovf` the largest frontier overflow lane of K6's stats seen (a 0-dim
    device tensor, folded into the one given), `history` with
    `with_history` the (n_steps, n, 3) post-drift positions in input
    order, else None.  `debug_nans` stops at a non-finite position or
    force with FloatingPointError (a host sync a step)."""
    half = dt * 0.5
    src, vel = state.src, state.vel
    dev = src.device
    ovf = torch.zeros((), dtype=torch.int32, device=dev) if ovf is None else ovf
    hist = []
    dest = state.orig[state.real].long() if with_history else None
    for _ in range(n_steps):
        with span("integrate.step"):
            with span("bh.kick_drift"):
                vel += state.acc * half
                src[:, :3] += vel * dt
            if debug_nans:
                _check_finite("position", src[state.real, :3])
            acc, stats = state_forces(state, **force_kw)
            if debug_nans:
                _check_finite("force", acc[state.real])
            ovf = torch.maximum(ovf, stats[:, S_OVF].max())
            with span("bh.kick_drift"):
                vel += acc * half
            state = state._replace(acc=acc)
            if with_history:
                frame = torch.empty((state.n, 3), dtype=src.dtype, device=dev)
                frame[dest] = src[state.real, :3]
                hist.append(frame)
    return state, ovf, (torch.stack(hist) if with_history and hist else None)


def emit(state: GroupState):
    """(pos, vel) (n, 3) f32 back in the input order."""
    dest = state.orig[state.real].long()
    pos = torch.empty((state.n, 3), dtype=state.src.dtype, device=state.src.device)
    vel = torch.empty_like(pos)
    pos[dest] = state.src[state.real, :3]
    vel[dest] = state.vel[state.real]
    return pos, vel


def _raise_overflow(ovf: int) -> None:
    """CapacityError where K6's frontier overflowed, naming the cap that
    fits, as ``bh_fused.check_fused`` does."""
    if ovf > 0:
        need = _round_cap(max(ovf + 1, FRONTIER_CAP))
        raise CapacityError(
            "persistent fused Barnes-Hut capacity overflow: frontier overflow "
            f"(a level needed >= {ovf} octets): pass --bh-frontier-cap {need}")


def _valid_amax(acc: torch.Tensor, valid: torch.Tensor, b: int | None = None):
    """max |a| over the real slots, of all (0-dim) or of each group of `b`
    slots ((G,)): pads, which the robust rectangle reaches, are left out."""
    a2 = torch.where(valid, (acc * acc).sum(-1), 0.0)
    return torch.sqrt(a2.max() if b is None else a2.reshape(-1, b).amax(dim=1))


def kdk_adaptive_steps(state: GroupState, k_steps: int, t, t_end: float, *, eta: float,
                       eps: float, dt_min: float, dt_max: float, with_history: bool = False,
                       ovf: Optional[torch.Tensor] = None,
                       debug_nans: bool = False, **force_kw):
    """Adaptive-dt KDK on the persistent layout (``bh_persistent.py:
    691-765``): each step's dt from the real slots' |a|_max by the
    criterion of ``integrate/adaptive.py`` (``step_size``), t and dt f32
    0-dim tensors on the device, the landing snapped to f32(t_end); at
    most `k_steps`, stopping at arrival (``run_chunk``).  The state's
    arrays are updated in place.  Returns (state, ovf, t, (ts, dts),
    history) as ``kdk_steps`` and ``adaptive_steps``."""
    f32 = torch.float32
    dev = state.src.device
    src, vel = state.src, state.vel
    two_eta_eps = torch.tensor(2.0 * eta * eps, dtype=f32, device=dev)
    t_end_t = torch.tensor(t_end, dtype=f32, device=dev)
    ovf = torch.zeros((), dtype=torch.int32, device=dev) if ovf is None else ovf
    dest = state.orig[state.real].long() if with_history else None
    ts, dts, hist = [], [], []
    box = [state, ovf, torch.as_tensor(t, dtype=f32).to(dev)]

    def run(s: int) -> torch.Tensor:
        state, ovf, t = box
        for _ in range(s):
            dt, rem = step_size(_valid_amax(state.acc, state.valid), t, t_end_t,
                                two_eta_eps=two_eta_eps, dt_min=dt_min, dt_max=dt_max)
            half = dt * 0.5
            vel.add_(state.acc * half)
            src[:, :3] += vel * dt
            if debug_nans:
                _check_finite("position", src[state.real, :3])
            acc, stats = state_forces(state, **force_kw)
            if debug_nans:
                _check_finite("force", acc[state.real])
            ovf = torch.maximum(ovf, stats[:, S_OVF].max())
            vel.add_(acc * half)
            state = state._replace(acc=acc)
            t = torch.where(dt >= rem, t_end_t, t + dt)
            ts.append(t)
            dts.append(dt)
            if with_history:
                frame = torch.empty((state.n, 3), dtype=f32, device=dev)
                frame[dest] = src[state.real, :3]
                hist.append(frame)
        box[:] = [state, ovf, t]
        return t

    run_chunk(k_steps, float(box[2]), float(np.float32(t_end)), dt_max, f32, run)
    state, ovf, t = box
    steps = (torch.stack(ts), torch.stack(dts)) if ts else (t.new_empty(0), t.new_empty(0))
    return state, ovf, t, steps, (torch.stack(hist) if with_history and hist else None)


# ---------------------------------------------------------------------------
# Block (tiered) time steps: per-group step tiers on the persistent layout
# (``bh_persistent.py:768-1060``).  Morton groups are spatially coherent, so
# a group's acceleration scale is too: a hot core takes dt / 2^k while the
# field takes dt.  Tier k of T has L = 2^(T-1-k) finest sub-steps
# h = dt / 2^(T-1) a step of its own: it kicks dt_k / 2 at the start of its
# step, drifts with that velocity, and kicks dt_k / 2 at its end with a force
# evaluated there.  The tables rebuild every sub-step, so every force sees
# sub-step-current sources.
#
# A group's position within its own step is its position at the opening
# kick plus its velocity times the time since (j h, j the sub-steps taken);
# JAX adds v h every sub-step, the same sum in exact arithmetic.  At the
# group's closing j h = dt_k exactly, so the step is the KDK step at dt_k
# to the bit: a uniform coarse tier is ``kdk_steps`` at dt, a uniform finest
# tier ``kdk_steps`` at h.
# ---------------------------------------------------------------------------


def assign_tiers(state: GroupState, dt: float, *, eta: float, eps: float,
                 n_tiers: int) -> torch.Tensor:
    """(G,) int32 tier a group: the least k with dt / 2^k within the
    criterion sqrt(2 eta eps / |a|_max) of the group's real slots, clipped
    to [0, n_tiers - 1] (``bh_persistent.py:793-805``)."""
    f32 = torch.float32
    amax = _valid_amax(state.acc, state.valid, state.group_size)
    dt_req = torch.sqrt(torch.tensor(2.0 * eta * eps, dtype=f32, device=amax.device)
                        / torch.clamp_min(amax, 1e-30))
    k = torch.ceil(torch.log2(torch.clamp_min(torch.tensor(dt, dtype=f32) / dt_req, 1e-30)))
    return torch.clamp(k, 0, n_tiers - 1).to(torch.int32)


def _val2(x: int) -> int:
    """2-adic valuation of x > 0 (trailing zero bits)."""
    return (x & -x).bit_length() - 1


def tier_order_sizes(tiers, n_tiers: int, quant: int = 64):
    """The prefix plan of ``kdk_block_prefix_steps``, on the host, as JAX's
    (``bh_persistent.py:875-898``): (order, sizes), `order` the (G,)
    int32 group permutation in descending tier order (stable), so the
    groups closing at any sub-step are a prefix of it; `sizes[v]`, for the
    sub-steps s + 1 of 2-adic valuation v, the groups of tier >= T-1-v
    rounded up to `quant` and capped at G, sizes[T-1] exactly G.  Returns
    numpy and a tuple of ints."""
    t = np.asarray(tiers.cpu() if hasattr(tiers, "cpu") else tiers)
    g = t.shape[0]
    order = np.argsort(-t, kind="stable").astype(np.int32)
    suffix = np.cumsum(np.bincount(t, minlength=n_tiers)[::-1])
    sizes = tuple(g if v == n_tiers - 1 else int(min(g, -(-int(suffix[v]) // quant) * quant))
                  for v in range(n_tiers))
    return order, sizes


def _block_steps(state: GroupState, tiers: torch.Tensor, n_macro: int, dt: float, *,
                 n_tiers: int, evaluate, with_history: bool, ovf, debug_nans: bool,
                 **force_kw):
    """The synchronized block-KDK schedule shared by the masked and the
    prefix steppers; `evaluate(state, s, closing)` gives sub-step s's
    (accelerations, stats) or None where no group closes.  Updates the
    state's arrays in place; returns (state, ovf, macro-boundary history)."""
    f32 = torch.float32
    s_per = 1 << (n_tiers - 1)
    h = float(np.float32(dt)) / s_per
    b = state.group_size
    src, vel = state.src, state.vel
    dev = src.device
    big_l = (s_per >> tiers.long()).repeat_interleave(b)  # (M,) sub-steps a step
    half_own = (big_l.to(f32) * (h * 0.5))[:, None]
    anchor = src[:, :3].clone()
    ovf = torch.zeros((), dtype=torch.int32, device=dev) if ovf is None else ovf
    dest = state.orig[state.real].long() if with_history else None
    hist = []
    for _ in range(n_macro):
        for s in range(s_per):
            j = s % big_l
            opening = (j == 0)[:, None]
            vel.copy_(torch.where(opening, vel + state.acc * half_own, vel))
            anchor.copy_(torch.where(opening, src[:, :3], anchor))
            src[:, :3] = anchor + vel * ((j + 1).to(f32) * h)[:, None]
            if debug_nans:
                _check_finite("position", src[state.real, :3])
            closing = ((s + 1) % big_l == 0)[:, None]
            got = evaluate(state, s, closing)
            if got is None:
                continue
            acc_new, stats = got
            ovf = torch.maximum(ovf, stats[:, S_OVF].max()) if stats.numel() else ovf
            acc = torch.where(closing, acc_new, state.acc)
            if debug_nans:
                _check_finite("force", acc[state.real])
            vel.copy_(torch.where(closing, vel + acc * half_own, vel))
            state = state._replace(acc=acc)
        if with_history:
            frame = torch.empty((state.n, 3), dtype=f32, device=dev)
            frame[dest] = src[state.real, :3]
            hist.append(frame)
    return state, ovf, (torch.stack(hist) if with_history and hist else None)


def kdk_block_steps(state: GroupState, tiers: torch.Tensor, n_macro: int, dt: float, *,
                    n_tiers: int, with_history: bool = False,
                    ovf: Optional[torch.Tensor] = None, debug_nans: bool = False,
                    **force_kw):
    """`n_macro` macro steps of dt with per-group tiers, the masked form
    (``bh_persistent.py:808-871``, JAX's CLI default): every sub-step is one
    evaluation of all G group slots with the groups that do not close
    there given gcount 0, which K6's pricing pass gives no cost and its
    full kernel skips.  state.acc must hold the force at the current
    positions.  Returns (state, ovf, history): with `with_history` the
    (n_macro, n, 3) positions at the macro boundaries, in input order."""
    gcount = state.gcount

    def evaluate(st, s, closing):
        masked = torch.where(closing[::st.group_size, 0], gcount, 0)
        return state_forces(st._replace(gcount=masked), **force_kw)

    return _block_steps(state, tiers, n_macro, dt, n_tiers=n_tiers, evaluate=evaluate,
                        with_history=with_history, ovf=ovf, debug_nans=debug_nans)


def kdk_block_prefix_steps(state: GroupState, tiers: torch.Tensor, order, n_macro: int,
                           dt: float, *, sizes: tuple, n_tiers: int,
                           with_history: bool = False, ovf: Optional[torch.Tensor] = None,
                           debug_nans: bool = False, **force_kw):
    """``kdk_block_steps`` with per-tier prefixes (``bh_persistent.py:
    957-1053``): sub-step s evaluates only the groups order[:sizes[v]],
    v = val2(s + 1), and the last sub-step of a macro step, where every
    tier closes, all G.  The prefix's quantization extras are evaluated and
    dropped, never kicked.  The physics and the bits are the masked
    form's; a prefix of size 0 launches nothing."""
    s_per = 1 << (n_tiers - 1)
    order = torch.as_tensor(np.asarray(order), dtype=torch.int64).to(state.src.device)

    def evaluate(st, s, closing):
        if s == s_per - 1:
            return state_forces(st, **force_kw)
        size = sizes[min(_val2(s + 1), n_tiers - 1)]
        if size == 0:
            return None
        return subset_state_forces(st, order[:size], **force_kw)

    return _block_steps(state, tiers, n_macro, dt, n_tiers=n_tiers, evaluate=evaluate,
                        with_history=with_history, ovf=ovf, debug_nans=debug_nans)


@spanned("integrate.run")
def simulate_persistent(
    pos: torch.Tensor,
    vel: torch.Tensor,
    mass: torch.Tensor,
    n_steps: int,
    dt: float,
    *,
    G: float = constants.BIG_G,
    softening_sq: float = constants.SOFTENING_SQ,
    theta: float = constants.THETA,
    group_size: int = 1024,
    leaf_cap: int = 64,
    frontier_cap: int = FRONTIER_CAP,
    resort_every: int = 8,
    max_drift_frac: float = 0.25,
    frame_writer: Optional[Callable[[np.ndarray], None]] = None,
    checkpoint_every: int = 0,
    checkpoint_fn: Optional[Callable[[Bodies, int], None]] = None,
    progress_every: int = 0,
    progress_fn: Optional[Callable[..., None]] = None,
    block_tiers: int = 1,
    block_eta: float = 0.025,
    block_prefix: bool = False,
    robust_slots: int = 0,
    ld: int = 0,
    merge_radius: float = 0.0,
    merge_every: int = 1,
    merge_report: Optional[Callable[[int], None]] = None,
    mass_update: Optional[Callable[[np.ndarray], None]] = None,
    debug_nans: bool = False,
    group_forces=fused_group_forces,
    rect_forces=cuda_rect_accelerations,
):
    """Run `n_steps` KDK steps with a resort every `resort_every` steps;
    returns (pos, vel) f32 in the input order, and (pos, vel, mass) with
    merging.  `robust_slots` > 0 turns on the robust scheme (``_resort``),
    with the grid at auto_ld + 2 (at most 8) unless `ld` is given.

    The steps run in chunks that end on resorts, checkpoints, progress
    beats and merge passes (``bh_persistent.py:1233-1340``).
    `frame_writer` receives the initial frame, then each chunk's (T, N, 3)
    post-drift positions in the input order; `checkpoint_fn(Bodies,
    step)` fires every `checkpoint_every` steps with the state emitted to
    the input order; `progress_fn(done, note)` every `progress_every`
    steps after a device fence.

    `merge_radius > 0` runs ``collisions.merge_pass`` every `merge_every`
    steps on the state emitted to the input order; where it merged, the
    layout is rebuilt from the merged bodies (``init_state`` + ``prime``,
    so the tables, the robust outliers' G·m and the KDK carry follow the
    new masses) and that boundary's resort is skipped.  `merge_report`
    gets the number absorbed at the end, `mass_update` the running masses
    after each merging boundary.

    `block_tiers` T > 1 runs block time steps (``kdk_block_steps``, or
    ``kdk_block_prefix_steps`` with `block_prefix`): `n_steps` counts
    macro steps of dt, and the tiers are assigned from the acceleration
    scale (`block_eta`) at the start and at every resort.  Both refuse
    softening_sq <= 0, and merging refuses tiers.

    Drift guard: before each chunk the fastest real body's speed is read;
    if a full chunk would move it more than `max_drift_frac` of a terminal
    cell, the chunk is one step (a resort every step, the reference's
    rebuild-per-step) until the system calms down; 0 turns it off.  The
    same host read takes the largest frontier overflow of K6's stats since
    the last one, and an overflow raises CapacityError naming the cap that
    fits: forces are never returned with sources dropped."""
    n = pos.shape[0]
    block = block_tiers > 1
    merging = merge_radius > 0
    if block and softening_sq <= 0:
        raise ValueError("block tiers need softening_sq > 0 (the eps scale)")
    if merging and block:
        raise ValueError("merging and block tiers cannot combine (a merge invalidates the "
                         "tier assignment mid-macro-step); pick one")
    if robust_slots > 0 and not ld:
        ld = min(MAX_LD, auto_ld(n) + 2)
    fkw = dict(theta=theta, softening_sq=softening_sq, leaf_cap=leaf_cap,
               frontier_cap=frontier_cap, group_forces=group_forces, rect_forces=rect_forces)
    skw = dict(G=G, group_size=group_size, robust_slots=robust_slots, ld=ld or None)
    state = init_state(pos, vel, mass, **skw)
    state, stats = prime(state, **fkw)
    ovf = stats[:, S_OVF].max()
    if debug_nans:
        _check_finite("force", state.acc[state.real])
    mass_cur = mass.to(torch.float32)
    merged_total = 0
    eps = math.sqrt(softening_sq) if block else 0.0

    def plan(state):
        tiers = assign_tiers(state, dt, eta=block_eta, eps=eps, n_tiers=block_tiers)
        return (tiers, *tier_order_sizes(tiers, block_tiers)) if block_prefix else (tiers,)

    tier_plan = plan(state) if block else None
    if frame_writer is not None:
        frame_writer(pos.to(torch.float32).cpu().numpy()[None])
    done = 0
    while done < n_steps:
        t = min(resort_every, n_steps - done)
        # one host read a chunk: the fastest real body, the overflow so far
        with host_sync("persistent.guard"):
            vmax, ovf_seen, border = torch.stack(
                [state.vel[state.real].abs().max(), ovf.float(), state.border]).tolist()
        _raise_overflow(int(ovf_seen))
        guarded = False
        if max_drift_frac > 0 and t > 1 and dt != 0:
            if vmax * abs(dt) * t > max_drift_frac * border / (1 << state.ld):
                t, guarded = 1, True
        for every in (checkpoint_every, progress_every, merge_every if merging else 0):
            if every > 0:
                t = min(t, ((done // every) + 1) * every - done)
        step_kw = dict(with_history=frame_writer is not None, ovf=ovf,
                       debug_nans=debug_nans, **fkw)
        if block and block_prefix:
            tiers, order, sizes = tier_plan
            state, ovf, hist = kdk_block_prefix_steps(state, tiers, order, t, dt, sizes=sizes,
                                                      n_tiers=block_tiers, **step_kw)
        elif block:
            state, ovf, hist = kdk_block_steps(state, tier_plan[0], t, dt,
                                               n_tiers=block_tiers, **step_kw)
        else:
            state, ovf, hist = kdk_steps(state, t, dt, **step_kw)
        if hist is not None:
            frame_writer(hist.cpu().numpy())
        done += t
        rebuilt = False
        if merging and done % merge_every == 0:
            p_o, v_o = emit(state)
            p_m, v_m, m_m, nm = merge_pass(p_o, v_o, mass_cur, merge_radius)
            nm = int(nm)  # one host read a merge boundary
            if nm > 0:
                merged_total += nm
                mass_cur = m_m
                state = init_state(p_m, v_m, m_m, **skw)
                state, stats = prime(state, **fkw)
                ovf = torch.maximum(ovf, stats[:, S_OVF].max())
                rebuilt = True
                if mass_update is not None:
                    mass_update(mass_cur.cpu().numpy())
        if checkpoint_every > 0 and checkpoint_fn is not None and done % checkpoint_every == 0:
            p_c, v_c = emit(state)
            checkpoint_fn(Bodies(p_c, v_c, mass_cur), done)
        if progress_every > 0 and progress_fn is not None and done % progress_every == 0:
            if state.src.is_cuda:
                with host_sync("persistent.fence"):
                    torch.cuda.synchronize(state.src.device)
            progress_fn(done, "drift-guard: per-step resorts" if guarded else "")
        if done < n_steps and not rebuilt:
            state = resort(state, robust_slots)
            if block:
                tier_plan = plan(state)
    with host_sync("persistent.overflow"):
        ovf = int(ovf)
    _raise_overflow(ovf)
    p_out, v_out = emit(state)
    if p_out.is_cuda:
        with host_sync("persistent.fence"):
            torch.cuda.synchronize(p_out.device)
    if merging:
        if merge_report is not None:
            merge_report(merged_total)
        return p_out, v_out, mass_cur
    return p_out, v_out


@spanned("integrate.run")
def simulate_persistent_adaptive(
    pos: torch.Tensor,
    vel: torch.Tensor,
    mass: torch.Tensor,
    t_start: float,
    t_end: float,
    *,
    G: float = constants.BIG_G,
    softening_sq: float = constants.SOFTENING_SQ,
    theta: float = constants.THETA,
    eta: float = 0.025,
    dt_min: float = 0.0,
    dt_max: float,
    group_size: int = 1024,
    leaf_cap: int = 64,
    frontier_cap: int = FRONTIER_CAP,
    resort_every: int = 8,
    max_drift_frac: float = 0.25,
    frame_writer: Optional[Callable[[np.ndarray], None]] = None,
    checkpoint_every: int = 0,
    checkpoint_fn: Optional[Callable[[Bodies, int, float], None]] = None,
    progress_every: int = 0,
    progress_fn: Optional[Callable[..., None]] = None,
    robust_slots: int = 0,
    ld: int = 0,
    max_steps: int = 10_000_000,
    debug_nans: bool = False,
    group_forces=fused_group_forces,
    rect_forces=cuda_rect_accelerations,
):
    """Adaptive global dt on the persistent layout (``bh_persistent.py:
    1344-1482``): from t_start to t_end, chunks of `resort_every` steps
    (``kdk_adaptive_steps``, stopping at arrival) with a resort between.
    Returns (pos, vel, steps taken) in the input order.  The drift guard
    prices a chunk with dt_max (the adaptive dt is no larger);
    checkpoints and progress beats fire on real step counts, where the
    count crossed a multiple of theirs in the chunk, as JAX's;
    `checkpoint_fn(Bodies, steps taken, t)` also gets the run's time t,
    which a fixed step cannot give (JAX's CLI writes t0 + steps · dt_max);
    frames are the initial one and one row a real step."""
    eps = check_adaptive(softening_sq, dt_max)
    n = pos.shape[0]
    if robust_slots > 0 and not ld:
        ld = min(MAX_LD, auto_ld(n) + 2)
    fkw = dict(theta=theta, softening_sq=softening_sq, leaf_cap=leaf_cap,
               frontier_cap=frontier_cap, group_forces=group_forces, rect_forces=rect_forces)
    state = init_state(pos, vel, mass, G=G, group_size=group_size,
                       robust_slots=robust_slots, ld=ld or None)
    state, stats = prime(state, **fkw)
    ovf = stats[:, S_OVF].max()
    if frame_writer is not None:
        frame_writer(pos.to(torch.float32).cpu().numpy()[None])
    f32 = torch.float32
    t_end_cmp = host_time(t_end, f32)
    t = torch.tensor(t_start, dtype=f32, device=state.src.device)
    t_host = float(t)
    taken = 0
    t_prev = float("-inf")
    while t_host < t_end_cmp and taken < max_steps:
        if t_host <= t_prev:
            raise stagnated(t_host, t_end, dt_max)
        t_prev = t_host
        k = resort_every
        with host_sync("persistent.guard"):
            vmax, ovf_seen, border = torch.stack(
                [state.vel[state.real].abs().max(), ovf.float(), state.border]).tolist()
        _raise_overflow(int(ovf_seen))
        guarded = False
        if max_drift_frac > 0 and k > 1:
            if vmax * dt_max * k > max_drift_frac * border / (1 << state.ld):
                k, guarded = 1, True
        state, ovf, t, (_, dts), hist = kdk_adaptive_steps(
            state, k, t, t_end, eta=eta, eps=eps, dt_min=dt_min, dt_max=dt_max,
            with_history=frame_writer is not None, ovf=ovf,
            debug_nans=debug_nans, **fkw)
        real = (dts > 0).cpu().numpy()
        if frame_writer is not None and real.any():
            frame_writer(hist.cpu().numpy()[real])
        taken += int(real.sum())
        t_host = float(t)
        if checkpoint_every > 0 and checkpoint_fn is not None and taken > 0 \
                and taken % checkpoint_every < k:
            p_c, v_c = emit(state)
            checkpoint_fn(Bodies(p_c, v_c, mass), taken, t_host)
        if progress_every > 0 and progress_fn is not None and taken % progress_every < k:
            if state.src.is_cuda:
                with host_sync("persistent.fence"):
                    torch.cuda.synchronize(state.src.device)
            progress_fn(taken, "drift-guard: per-step resorts" if guarded else "")
        if t_host < t_end_cmp:
            state = resort(state, robust_slots)
    with host_sync("persistent.overflow"):
        ovf = int(ovf)
    _raise_overflow(ovf)
    p_out, v_out = emit(state)
    if p_out.is_cuda:
        with host_sync("persistent.fence"):
            torch.cuda.synchronize(p_out.device)
    return p_out, v_out, taken


def state_from_numpy(*, pg, vel, valid, gcount, orig, nid, it, bsq, border, acc,
                     ld: int, out_slots=None, out_gm=None, device=None) -> GroupState:
    """The port's state from a JAX ``GroupState``'s arrays as numpy: the
    planar (G, 4, B) and (G, 3, B) arrays become row-major (G·B, 4) and
    (G·B, 3), and the `it` octet table of ``pack_it``
    (``nbody_tpu/ops/bh_fused.py:109-118``: per 128-lane row, octets of
    start then span) is unpacked into `start` and `cnt`.  The cell ids of
    empty groups' slots become 8^ld, as the port's."""
    pg, gcount = np.asarray(pg, np.float32), np.asarray(gcount).astype(np.int32)
    g, _, b = pg.shape
    k = 8**ld
    def rows(a):
        return torch.as_tensor(np.ascontiguousarray(np.transpose(np.asarray(a, np.float32),
                                                                 (0, 2, 1)).reshape(g * b, -1)),
                               device=device)

    def ints(a, dtype=torch.int64):
        return torch.as_tensor(np.array(a).reshape(-1), device=device).to(dtype)

    start, cnt = unpack_it(it, ld)
    occupied = np.repeat(gcount > 0, b)
    nid_np = np.where(occupied, np.asarray(nid).reshape(-1), k).astype(np.int64)
    valid_np = np.array(valid).reshape(-1)
    bounds = np.concatenate([[0], np.cumsum(np.bincount(nid_np[valid_np], minlength=k)[:k])])
    gct = torch.as_tensor(gcount, device=device)
    return GroupState(
        src=rows(pg), vel=rows(vel), acc=rows(acc),
        valid=torch.as_tensor(valid_np, device=device),
        gcount=gct, orig=ints(orig, torch.int32),
        real=_real_slots(gct, b, int(gcount.sum())),
        nid=ints(nid_np), bounds=ints(bounds),
        start=ints(start, torch.int32), cnt=ints(cnt, torch.int32),
        bsq=torch.as_tensor(np.array(bsq, np.float32), device=device),
        border=torch.as_tensor(np.float32(border), device=device), ld=ld,
        out_slots=None if out_slots is None else ints(out_slots),
        out_gm=None if out_gm is None else torch.as_tensor(np.array(out_gm, np.float32),
                                                           device=device),
    )


def unpack_it(it: np.ndarray, ld: int):
    """(start, cnt) (T,) int32 from ``pack_it``'s (RI, 128) int32 table,
    which holds, octet by octet, the 8 children's starts then their spans
    for the cells of levels 1..ld; the root's range is the union of its
    children's."""
    n_oct = grid_offsets(ld)[ld]
    octs = np.asarray(it, np.int32).reshape(-1, 2, 8)[:n_oct]
    start, cnt = octs[:, 0].reshape(-1), octs[:, 1].reshape(-1)
    occ = cnt[:8] > 0
    s0 = int(start[:8][occ].min()) if occ.any() else 0
    e0 = int((start[:8] + cnt[:8])[occ].max()) if occ.any() else 0
    return np.concatenate([[s0], start]), np.concatenate([[e0 - s0], cnt])
