"""The plain reference: what a job must produce, worked out from its input
alone, in plain PyTorch.

It imports nothing of the program and takes nothing the program made.  A
job is `steps` KDK leapfrog steps (the reference simulator's
``propagation``: a force before the loop, then kick, drift, force, kick)
from the input bodies, and its answer is the final positions and
velocities in the input order.  The forces are the configuration's:

* ``allpairs``: every softened pair, a_i = sum_j G m_j d / (|d|^2 + eps2)^1.5;
* ``barnes_hut``: the grouped Barnes-Hut of the fused traversal (Morton
  order at depth 10, a dense grid of depth `ld`, cell-aligned groups of at
  most `group_size` bodies, the group MAC theta^2 |c - box|^2 > size^2 in
  f32, near cells of at most `leaf_cap` bodies or at the terminal level
  taken body by body), one-shot (sorted and grouped at every evaluation)
  or on the persistent layout (``layout`` "persistent": groups of
  `group_size` slots kept between resorts every `resort_every` steps, the
  centres of mass rebuilt from the current positions over the stale
  cells, and the drift guard's per-step resorts).  Barnes-Hut's answer is
  an approximation defined by these rules: a program that opened other
  cells would give another answer, so the rules are the reference's.

`mode` is the precision the reference computes in: "f64" or "f32" (state,
tables and forces in that dtype; the MAC always in f32), or "tf32", the
f32 reference with every multiplication's operands of the force rounded to
TF32 (10 mantissa bits), the precision below f32, for the control.
Centres of mass are summed in f64 and rounded to the state's dtype.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MORTON_DEPTH = 10
PAIR_BLOCK = 1 << 26  # pairs evaluated at once


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 `x` rounded to TF32's 10 mantissa bits, to nearest, ties even."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def _pair_sum(targets: torch.Tensor, rows: torch.Tensor, eps2: float,
              mode: str) -> torch.Tensor:
    """(..., T, 3) accelerations of `targets` (..., T, 3) from source `rows`
    (..., S, 4) [x y z G·m]: sum_j gm_j d / (|d|^2 + eps2)^1.5."""
    r = tf32 if mode == "tf32" else (lambda t: t)
    d = r(rows[..., None, :, :3] - targets[..., :, None, :])  # (..., T, S, 3)
    r2 = (d * d).sum(-1) + eps2
    inv = r(torch.rsqrt(r2))
    w = r(r(rows[..., None, :, 3]) * r(r(inv * inv) * inv))
    return (w[..., None] * d).sum(-2)


def allpairs_acc(pos: torch.Tensor, mass: torch.Tensor, *, G: float, eps2: float,
                 mode: str) -> torch.Tensor:
    """(n, 3) softened all-pairs accelerations, in blocks of targets."""
    rows = torch.cat([pos, (mass * G)[:, None]], dim=1)
    n = pos.shape[0]
    step = max(1, PAIR_BLOCK // n)
    return torch.cat([_pair_sum(pos[i:i + step], rows, eps2, mode)
                      for i in range(0, n, step)])


# --- Barnes-Hut: Morton order, dense grid, groups, group MAC ---------------


def morton_keys(pos: torch.Tensor, border: torch.Tensor) -> torch.Tensor:
    """int64 Morton keys at depth 10 over the cube of side `border` centred
    at the origin: each f32-rounded coordinate scaled in the border's dtype,
    truncated and clipped to [0, 1023], bits interleaved z·4 + y·2 + x."""
    p = pos.float().to(border.dtype)
    cell = ((p / border + 0.5) * float(1 << MORTON_DEPTH)).to(torch.int64)
    cell = cell.clamp(0, (1 << MORTON_DEPTH) - 1)
    key = torch.zeros(pos.shape[0], dtype=torch.int64, device=pos.device)
    for bit in range(MORTON_DEPTH):
        for axis in range(3):
            key |= ((cell[:, axis] >> bit) & 1) << (3 * bit + axis)
    return key


def split_level(n: int, group_size: int) -> int:
    """The level whose cells no group crosses: cells of ~2 groups' bodies."""
    return max(0, round(math.log(max(n / (2.0 * group_size), 1.0), 8)))


def group_ranges(keys_s: torch.Tensor, group_size: int, n_groups: int):
    """(gstart, gcount) int64 (n_groups,): the sorted bodies cut into runs
    of at most `group_size` that never cross a split-level cell, in sorted
    order; the unused tail of the arrays is empty groups."""
    n = keys_s.shape[0]
    sl = min(split_level(n, group_size), MORTON_DEPTH)
    cell = keys_s >> (3 * (MORTON_DEPTH - sl))
    idx = torch.arange(n, device=keys_s.device)
    first = torch.searchsorted(cell, cell)
    gid = torch.cumsum((idx - first) % group_size == 0, 0) - 1
    gcount = torch.zeros(n_groups, dtype=torch.int64, device=keys_s.device)
    gcount.index_add_(0, gid, torch.ones_like(gid))
    gstart = torch.where(gcount > 0, torch.cumsum(gcount, 0) - gcount, 0)
    return gstart, gcount


def n_group_slots(n: int, group_size: int) -> int:
    """Groups a cut can make: n // B full ones plus one partial one for
    each split-level cell, plus one."""
    return n // group_size + min(8 ** split_level(n, group_size), n) + 1


def level_sums(terminal: torch.Tensor, ld: int) -> list[torch.Tensor]:
    """[level 0, ..., level ld] of (8^d, C) sums of the terminal (8^ld, C)."""
    levels = [terminal]
    for _ in range(ld):
        levels.append(levels[-1].reshape(-1, 8, terminal.shape[1]).sum(dim=1))
    return levels[::-1]


def classify(tables, gstart, gcount, src, bsq, *, theta: float, leaf_cap: int, ld: int):
    """The group MAC over every occupied group at once: returns (g, far
    rows (F, 4), near (g, first, count) of each near cell) where g indexes
    the groups, and the per-group counts (n_far, n_near).  `tables` is a
    list over levels 0..ld of (com (8^d, 3), gm (8^d,), cnt (8^d,), start
    (8^d,)); `src` (M, 4) the rows [x y z G·m] the groups and the cells'
    [start, start + cnt) index.  The test runs in f32 on the f32-rounded
    centres and group boxes: theta^2 |com - clamp(com, lo, hi)|^2 >
    bsq[d + 1] accepts a child of level d + 1 as far; a child that is not
    far is near when it holds at most `leaf_cap` rows or is terminal, and
    is opened otherwise."""
    device = src.device
    f32 = torch.float32
    live = torch.nonzero(gcount > 0).flatten()
    gs, gc = gstart[live], gcount[live]
    n_live = live.shape[0]
    bmax = int(gc.max())
    slots = torch.arange(bmax, device=device)
    valid = slots[None, :] < gc[:, None]
    body = src[(gs[:, None] + slots).clamp(max=src.shape[0] - 1), :3].to(f32)
    inf = torch.tensor(float("inf"), dtype=f32, device=device)
    lo = torch.where(valid[..., None], body, inf).amin(dim=1)
    hi = torch.where(valid[..., None], body, -inf).amax(dim=1)
    theta_sq = torch.tensor(float(np.float32(theta * theta)), dtype=f32, device=device)
    bsq = bsq.to(f32)
    fl = torch.arange(n_live, device=device)
    fc = torch.zeros(n_live, dtype=torch.int64, device=device)
    j8 = torch.arange(8, device=device)
    far_g, far_rows, near_g, near_first, near_cnt = [], [], [], [], []
    for d in range(ld):
        com, gm, cnt, start = tables[d + 1]
        child = fc[:, None] * 8 + j8
        ccnt = cnt[child]
        c32 = com[child].to(f32)
        dd = c32 - torch.minimum(torch.maximum(c32, lo[fl][:, None]), hi[fl][:, None])
        sq = dd * dd
        d2 = sq[..., 0] + sq[..., 1] + sq[..., 2]
        exists = ccnt > 0
        far = exists & (theta_sq * d2 > bsq[d + 1])
        near = exists & ~far & ((ccnt <= leaf_cap) | (d + 1 >= ld))
        opn = exists & ~far & ~near
        g8 = fl[:, None].expand_as(child)
        far_g.append(g8[far])
        far_rows.append(torch.cat([com[child][far], gm[child][far][:, None]], 1))
        near_g.append(g8[near])
        near_first.append(start[child][near])
        near_cnt.append(ccnt[near])
        fl, fc = g8[opn], child[opn]
    far_g, far_rows = torch.cat(far_g), torch.cat(far_rows)
    near_g, near_first, near_cnt = torch.cat(near_g), torch.cat(near_first), torch.cat(near_cnt)
    n_far = torch.bincount(far_g, minlength=n_live)
    n_near = torch.zeros(n_live, dtype=torch.int64, device=device)
    n_near.index_add_(0, near_g, near_cnt)
    return live, (far_g, far_rows), (near_g, near_first, near_cnt), (n_far, n_near)


def group_forces(gstart, gcount, src, tables, bsq, *, theta, eps2, leaf_cap, ld, mode):
    """(M, 3) accelerations of the groups' rows of `src`, zero elsewhere:
    each group's bodies against its far rows and its near cells' rows, the
    groups batched by their count of sources."""
    live, (far_g, far_rows), (near_g, near_first, near_cnt), (n_far, n_near) = classify(
        tables, gstart, gcount, src, bsq, theta=theta, leaf_cap=leaf_cap, ld=ld)
    device = src.device
    nb_g = torch.repeat_interleave(near_g, near_cnt)
    first = torch.cumsum(near_cnt, 0) - near_cnt
    nb_idx = (torch.repeat_interleave(near_first - first, near_cnt)
              + torch.arange(nb_g.shape[0], device=device))
    rows = torch.cat([far_rows.to(src.dtype), src[nb_idx]])
    order = torch.argsort(torch.cat([far_g, nb_g]), stable=True)
    rows = rows[order]
    n_src = (n_far + n_near).tolist()
    bounds = [0] + np.cumsum(n_src).tolist()
    gs, gc = gstart[live].tolist(), gcount[live].tolist()
    out = torch.zeros((src.shape[0], 3), dtype=src.dtype, device=device)
    by_size = sorted(range(len(gs)), key=lambda i: n_src[i])
    bmax = max(gc)
    i = 0
    while i < len(by_size):
        # a batch of groups with their sources padded to the batch's most
        smax = n_src[by_size[i]]
        k = 1
        while (i + k < len(by_size)
               and (k + 1) * bmax * n_src[by_size[i + k]] <= PAIR_BLOCK):
            k += 1
        batch = by_size[i:i + k]
        smax = max(n_src[g] for g in batch)
        tgt = torch.zeros((k, bmax, 3), dtype=src.dtype, device=device)
        srows = torch.zeros((k, max(smax, 1), 4), dtype=src.dtype, device=device)
        for j, g in enumerate(batch):
            tgt[j, :gc[g]] = src[gs[g]:gs[g] + gc[g], :3]
            srows[j, :n_src[g]] = rows[bounds[g]:bounds[g + 1]]
        acc = _pair_sum(tgt, srows, eps2, mode)
        for j, g in enumerate(batch):
            out[gs[g]:gs[g] + gc[g]] = acc[j, :gc[g]]
        i += k
    return out


def _mass_sums(pos: torch.Tensor, gm: torch.Tensor, seg: torch.Tensor,
               n_seg: int) -> torch.Tensor:
    """(n_seg, 4) f64 sums of [G·m·x, G·m·y, G·m·z, G·m] by segment `seg`."""
    g = gm.double()[:, None]
    vals = torch.cat([g * pos.double(), g], dim=1)
    out = torch.zeros((n_seg, 4), dtype=torch.float64, device=pos.device)
    return out.index_add_(0, seg, vals)


def _com_tables(w: list[torch.Tensor], dtype, cnt: list, start: list):
    """Per-level (com, gm, cnt, start) from f64 [G·m·x, G·m·y, G·m·z, G·m]
    level sums, the centres and G·m rounded to `dtype`."""
    out = []
    for wl, cl, sl in zip(w, cnt, start):
        com = wl[:, :3] / torch.clamp_min(wl[:, 3], 1e-300)[:, None]
        out.append((com.to(dtype), wl[:, 3].to(dtype), cl, sl))
    return out


def _bsq(border: torch.Tensor, levels: int) -> torch.Tensor:
    lev = torch.arange(levels, dtype=torch.float32, device=border.device)
    return (border.to(torch.float32) / torch.exp2(lev)) ** 2


def oneshot_layout(pos, mass, *, G, ld, group_size):
    """(perm, src, tables, gstart, gcount, bsq) of the one-shot traversal:
    the bodies in Morton order as rows [x y z G·m], the dense grid's
    per-level tables, the groups and the MAC's squared cell sizes."""
    n, device = pos.shape[0], pos.device
    border = 2.0 * pos.abs().max()
    keys = morton_keys(pos, border)
    perm = torch.argsort(keys, stable=True)
    keys_s, pos_s = keys[perm], pos[perm]
    gm_s = mass[perm] * G
    src = torch.cat([pos_s, gm_s[:, None]], dim=1)
    nid = keys_s >> (3 * (MORTON_DEPTH - ld))
    terminal = _mass_sums(pos_s, gm_s, nid, 8**ld)
    cnt_t = torch.zeros(8**ld, dtype=torch.int64, device=device)
    cnt_t.index_add_(0, nid, torch.ones_like(nid))
    starts = [torch.cumsum(cnt_t, 0) - cnt_t]
    for _ in range(ld):
        starts.append(starts[-1].reshape(-1, 8)[:, 0])
    tables = _com_tables(level_sums(terminal, ld), pos.dtype,
                         [c[:, 0] for c in level_sums(cnt_t[:, None], ld)], starts[::-1])
    gstart, gcount = group_ranges(keys_s, group_size, n_group_slots(n, group_size))
    return perm, src, tables, gstart, gcount, _bsq(border, ld + 2)


def oneshot_bh_acc(pos, mass, *, G, eps2, theta, ld, group_size, leaf_cap, mode):
    """(n, 3) Barnes-Hut accelerations of the one-shot fused traversal:
    sort, grid and groups made afresh from `pos`."""
    perm, src, tables, gstart, gcount, bsq = oneshot_layout(
        pos, mass, G=G, ld=ld, group_size=group_size)
    acc_s = group_forces(gstart, gcount, src, tables, bsq, theta=theta, eps2=eps2,
                         leaf_cap=leaf_cap, ld=ld, mode=mode)
    acc = torch.empty_like(acc_s)
    acc[perm] = acc_s
    return acc


def kdk(pos, vel, mass, steps: int, dt: float, force):
    """`steps` KDK steps; force(pos, mass) -> acc."""
    half = dt * 0.5
    acc = force(pos, mass)
    for _ in range(steps):
        vel = vel + acc * half
        pos = pos + vel * dt
        acc = force(pos, mass)
        vel = vel + acc * half
    return pos, vel


# --- the persistent layout -------------------------------------------------


class _Layout:
    """G groups of B slots [x y z G·m] with vel and acc, the real slots in
    slot order, each slot's stale terminal cell, and the cells' slot spans:
    the persistent layout's state."""

    def __init__(self, pos, vel, acc, gm, orig, *, group_size: int, ld: int):
        n, dev = pos.shape[0], pos.device
        b = group_size
        g_cap = n_group_slots(n, b)
        k_t = 8**ld
        self.border = 2.0 * pos.abs().max()
        keys = morton_keys(pos, self.border)
        order = torch.argsort(keys, stable=True)
        keys_s = keys[order]
        gstart, gcount = group_ranges(keys_s, b, g_cap)
        slots = torch.arange(b, device=dev)
        valid = slots[None, :] < gcount[:, None]
        last = gstart + (gcount - 1).clamp_min(0)
        sidx = torch.where(valid, gstart[:, None] + slots, last[:, None]).reshape(-1)
        valid = valid.reshape(-1)
        idx = order[sidx]
        self.src = torch.cat([pos[idx], torch.where(valid, gm[idx], 0.0)[:, None]], 1)
        self.vel = vel[idx].clone()
        self.acc = torch.zeros_like(self.vel) if acc is None else acc[idx].clone()
        self.valid = valid
        self.orig = torch.where(valid, orig[idx], n)
        self.gcount = gcount
        self.gstart = torch.arange(0, g_cap * b, b, device=dev)
        self.real = torch.nonzero(valid).flatten()
        occupied = (gcount > 0).repeat_interleave(b)
        nid = torch.where(occupied, keys_s[sidx] >> (3 * (MORTON_DEPTH - ld)), k_t)
        self.nid_real = nid[self.real]
        slot = torch.arange(g_cap * b, device=dev)
        big = torch.iinfo(torch.int64).max
        st = torch.full((k_t + 1,), big, dtype=torch.int64, device=dev)
        st = st.scatter_reduce(0, nid, torch.where(valid, slot, big), "amin")[:k_t]
        en = torch.full((k_t + 1,), -1, dtype=torch.int64, device=dev)
        en = en.scatter_reduce(0, nid, torch.where(valid, slot + 1, -1), "amax")[:k_t]
        cnt = torch.zeros(k_t + 1, dtype=torch.int64, device=dev)
        cnt.index_add_(0, nid, valid.long())
        cnt = cnt[:k_t]
        counts, spans, firsts = [cnt], [], []
        sts, ens = [st], [en]
        for _ in range(ld):
            counts.append(counts[-1].reshape(-1, 8).sum(1))
            sts.append(sts[-1].reshape(-1, 8).amin(1))
            ens.append(ens[-1].reshape(-1, 8).amax(1))
        for c, s, e in zip(counts, sts, ens):
            spans.append(torch.where(c > 0, e - s, 0))
            firsts.append(torch.where(c > 0, s, 0))
        self.spans, self.firsts = spans[::-1], firsts[::-1]
        self.ld, self.b, self.n = ld, b, n

    def forces(self, *, theta, eps2, leaf_cap, mode):
        rows = self.src[self.real]
        terminal = _mass_sums(rows[:, :3], rows[:, 3], self.nid_real, 8**self.ld)
        tables = _com_tables(level_sums(terminal, self.ld), self.src.dtype, self.spans,
                             self.firsts)
        return group_forces(self.gstart, self.gcount, self.src, tables,
                            _bsq(self.border, self.ld + 2), theta=theta, eps2=eps2,
                            leaf_cap=leaf_cap, ld=self.ld, mode=mode)

    def resorted(self):
        r = self.real
        return _Layout(self.src[r, :3], self.vel[r], self.acc[r], self.src[r, 3],
                       self.orig[r], group_size=self.b, ld=self.ld)

    def emit(self):
        dest = self.orig[self.real]
        pos = torch.empty((self.n, 3), dtype=self.src.dtype, device=self.src.device)
        vel = torch.empty_like(pos)
        pos[dest] = self.src[self.real, :3]
        vel[dest] = self.vel[self.real]
        return pos, vel


def persistent_bh(pos, vel, mass, steps: int, dt: float, *, G, eps2, theta, ld,
                  group_size, leaf_cap, resort_every: int, max_drift_frac: float, mode):
    """`steps` KDK steps on the persistent layout: resorted after every
    chunk of `resort_every` steps, and after every step while the fastest
    body would cross more than `max_drift_frac` of a terminal cell in a
    chunk."""
    orig = torch.arange(pos.shape[0], device=pos.device)
    st = _Layout(pos, vel, None, mass * G, orig, group_size=group_size, ld=ld)
    fkw = dict(theta=theta, eps2=eps2, leaf_cap=leaf_cap, mode=mode)
    st.acc = st.forces(**fkw)
    half = dt * 0.5
    done = 0
    while done < steps:
        t = min(resort_every, steps - done)
        vmax = float(st.vel[st.real].abs().max())
        if t > 1 and vmax * abs(dt) * t > max_drift_frac * float(st.border) / (1 << ld):
            t = 1
        for _ in range(t):
            st.vel += st.acc * half
            st.src[:, :3] += st.vel * dt
            st.acc = st.forces(**fkw)
            st.vel += st.acc * half
        done += t
        if done < steps:
            st = st.resorted()
    return st.emit()


MODES = {"f64": torch.float64, "f32": torch.float32, "tf32": torch.float32}


def job(config: dict, cell: dict, pos, vel, mass, mode: str):
    """(pos, vel) after the cell's job on the bodies, computed in `mode`."""
    dtype = MODES[mode]
    pos, vel, mass = (t.to(dtype) for t in (pos, vel, mass))
    G, eps2 = config["G"], config["softening2"]
    steps, dt = cell["steps_per_job"], float(np.float32(cell["dt"]))
    if config["force"] == "allpairs":
        return kdk(pos, vel, mass, steps, dt,
                   lambda p, m: allpairs_acc(p, m, G=G, eps2=eps2, mode=mode))
    bh = dict(G=G, eps2=eps2, theta=config["theta"], ld=config["ld"],
              group_size=config["group_size"], leaf_cap=config["leaf_cap"], mode=mode)
    if cell.get("layout", "oneshot") == "persistent":
        return persistent_bh(pos, vel, mass, steps, dt, resort_every=cell["resort_every"],
                             max_drift_frac=config["max_drift_frac"], **bh)
    return kdk(pos, vel, mass, steps, dt, lambda p, m: oneshot_bh_acc(p, m, **bh))
